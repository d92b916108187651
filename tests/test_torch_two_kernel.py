"""The two-kernel route (jsvx_torch.kernels.mc / recon) vs jsvx's
``impl="pallas"`` route.

The same frames, parsed by the shared parser and packed by jsvx's
``frame_to_device``, go through jsvx's Pallas kernels in interpret mode
(as jsvx's own tests run them on the CPU) and through the port's plain
versions.  Tolerances:

* sideband expansion, dequantisation and motion compensation are
  integer: bit-equal;
* a reconstructed plane rounds an f32 IDCT that the two packages sum in
  different orders (jsvx's MXU matmuls vs the port's fixed u = 0..7
  order), so a value within 1e-3 of an exact .5 tie can round the other
  way: <= 1 LSB, on at most 0.1 % of a plane's pixels (the count is
  printed), and <= 1 LSB of the float64 oracle;
* the port's two routes share one dequantisation and one IDCT order, so
  the two-kernel route is bit-equal to the fused route.

The kernels themselves (CUDA C++ for sm_90a) run only on a card, in the
``cuda``-marked test and in ``chip_smoke.py``:
``python -m pytest tests/test_torch_two_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

try:                                     # the card's machine has no JAX
    import jax.numpy as jnp

    from jsvx.kernels import decode as jdec
    from jsvx.kernels.pallas_decode import decode_frame_planes_pallas
    from jsvx.kernels.pallas_decode import expand_sideband as j_expand
    from jsvx.kernels.pallas_decode import fused_recon_plane as j_recon
    from jsvx.kernels.pallas_mc import predict_plane_mvset_pallas
except ImportError:
    jnp = None

from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx_torch.kernels import mc, recon
from jsvx_torch.kernels import decode as tdec
from jsvx_torch.kernels.carry import (constants_from_jax, frame_from_jax,
                                      refs_from_numpy)
from jsvx_torch.kernels.fused import decode_frame_planes_fused

from test_torch_fused import _on, _plane_inputs

torch.set_num_threads(1)

CLIPS = ("tiny_clip", "small_clip", "tiny_clip_yuva")
needs_jax = pytest.mark.skipif(jnp is None, reason="needs jax")


def _walk(data, emit_sideband=False):
    from test_kernels import _walk as walk

    return list(walk(data, emit_sideband))


def _frames(clip, emit_sideband=False, **cfg):
    h, w = clip[0][0].shape
    data = JsvEncoder(w, h, EncoderConfig(**cfg)).encode(clip)
    return _walk(data, emit_sideband)


def _port_consts(jc):
    return constants_from_jax(np.asarray(jc.c_basis), jc.intra_q_key,
                              jc.non_intra_q_key, "cpu")


def _cap(ft):
    return jdec.mv_bucket(len(np.unique(ft.mb_mv.reshape(-1, 2),
                                        axis=0)) + 1)


def _zero_refs(seq, n_comps):
    ch, cw = seq.coded_height, seq.coded_width
    return [np.zeros((ch, cw), np.uint8), np.zeros((ch // 2, cw // 2),
                                                   np.uint8),
            np.zeros((ch // 2, cw // 2), np.uint8),
            np.zeros((ch, cw), np.uint8)][:n_comps]


def _close(got, want, oracle, label):
    """<= 1 LSB of jsvx on <= 0.1 % of pixels; <= 1 LSB of the oracle."""
    for ci, (g, w, o) in enumerate(zip(got, want, oracle)):
        diff = np.abs(g.astype(int) - w.astype(int))
        n_diff = int((diff > 0).sum())
        print(f"{label} plane {ci}: {n_diff} of {diff.size} pixels differ "
              f"from jsvx (max {diff.max()})")
        assert diff.max() <= 1
        assert n_diff <= 1e-3 * diff.size
        assert np.abs(g.astype(int) - o.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# (a) sideband expansion and its dequantisation


@needs_jax
@pytest.mark.parametrize("clip_name", CLIPS)
def test_expand_sideband_bit_equal(clip_name, request):
    clip = request.getfixturevalue(clip_name)
    frames = _frames(clip, gop_size=3, quantizer_scale=4, me_range=4)
    for ft, seq in frames:
        jc = jdec.make_constants(seq)
        tc = _port_consts(jc)
        d = jdec.frame_to_device(ft)
        td = frame_from_jax(d, "cpu")
        for key in jdec.frame_comp_keys(d):
            wm, wf = (np.asarray(a) for a in j_expand(d[key], jc,
                                                      d["is_p"]))
            gm, gf = recon.expand_sideband(td[key], tc)
            assert gm.dtype == torch.int16 and gf.dtype == torch.uint8
            assert np.array_equal(gm.numpy(), wm), key
            assert np.array_equal(gf.numpy(), wf), key
            # the dequantisation from the sideband is the spec's, exactly
            for quirk in (False, True):
                want = tdec.dequant_plane(
                    td[key]["levels"], td[key]["q"], td[key]["intra"],
                    td[key]["lnz"], tc, quirk)
                got = recon.dequant_sideband(td[key]["levels"], gm, gf,
                                             quirk)
                assert torch.equal(got.to(torch.float32), want), key


@needs_jax
@pytest.mark.parametrize("clip_name", CLIPS)
def test_frame_to_device_bit_equal(clip_name, request):
    """The port's numpy copy of ``frame_to_device`` (mv_capacity=0)."""
    clip = request.getfixturevalue(clip_name)
    for ft, _ in _frames(clip, emit_sideband=True, gop_size=3,
                         quantizer_scale=4, me_range=4):
        want = jdec.frame_to_device(ft)
        got = tdec.frame_to_device(ft)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if not isinstance(v, dict):
                assert got[k] == v and got[k].dtype == v.dtype
                continue
            assert got[k].keys() == v.keys()
            assert "mult" in v and "flags" in v
            for f, a in v.items():
                assert got[k][f].dtype == a.dtype, (k, f)
                assert np.array_equal(got[k][f], a), (k, f)


@needs_jax
def test_frame_from_jax_resolves_the_mvset(tiny_clip):
    frames = _frames(tiny_clip[:3], gop_size=3, quantizer_scale=4,
                     me_range=4)
    n_moving = 0
    for ft, _ in frames:
        d = jdec.frame_to_device(ft, mv_capacity=_cap(ft))
        full = frame_from_jax(d, "cpu")
        for key in jdec.frame_comp_keys(d):
            d[key] = {f: a for f, a in d[key].items() if f != "mv"}
        table_only = frame_from_jax(d, "cpu")
        for key in jdec.frame_comp_keys(d):
            assert set(table_only[key]) == {"levels", "lnz", "q", "intra",
                                            "mv", "rep_add"}
            assert torch.equal(table_only[key]["mv"], full[key]["mv"])
            assert table_only[key]["mv"].dtype == torch.int16
            n_moving += int(full[key]["mv"].abs().sum() > 0)
        assert table_only["is_p"].dtype == torch.int32
    assert n_moving > 0


# ---------------------------------------------------------------------------
# (b) motion compensation


MC_CASES = {
    # tests/test_fast_paths.py: the tall-pad / small-tile case (th = 8)
    "tall_pad": ((24, 128), [[0, 0], [141, 3], [-140, -95]]),
    # tests/test_fast_paths.py: the out-of-bounds clamp case
    "clamp": ((32, 32), [[0, 0], [-13, -9], [15, 21]]),
}


@needs_jax
@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("case", sorted(MC_CASES))
def test_plain_mc_matches_pallas_mc(case, chroma, rng):
    (h, w), vectors = MC_CASES[case]
    ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    table = np.vstack([np.array(vectors, np.int32),
                       np.zeros((5, 2), np.int32)])
    idx = rng.integers(0, len(vectors), (h // 8, w // 8)).astype(np.int32)
    rep = (rng.random((h // 8, w // 8)) < 0.2).astype(np.uint8)
    want = np.asarray(predict_plane_mvset_pallas(
        jnp.asarray(ref), jnp.asarray(table), jnp.asarray(idx),
        jnp.asarray(rep.astype(np.int32)), chroma, pad=72, interpret=True))
    before = mc.launches
    got = mc.predict_plane_mc(torch.from_numpy(ref),
                              torch.from_numpy(table[idx].astype(np.int16)),
                              torch.from_numpy(rep), chroma)
    assert mc.launches == before
    assert got.dtype == torch.int16 and got.shape == (h, w)
    assert np.array_equal(got.numpy().astype(np.int32), want)


# ---------------------------------------------------------------------------
# (c) reconstruction


def _recon_inputs(h, w, seed):
    """Random levels and per-pixel sideband: intra and non-intra blocks
    with the default matrices' q * M (where the two mismatch-control rules
    agree), random coded-scan masks, the intra DC position."""
    rng = np.random.default_rng(seed)
    hb, wb = h // 8, w // 8

    def up(a):
        return np.repeat(np.repeat(a, 8, 0), 8, 1)

    qtab = tdec.make_constants(None, "cpu").qtab.numpy()
    intra = up(rng.random((hb, wb)) < 0.3)
    m = np.where(intra, np.tile(qtab[0].reshape(8, 8), (hb, wb)),
                 np.tile(qtab[1].reshape(8, 8), (hb, wb)))
    q = up(rng.integers(1, 32, (hb, wb)))
    dc = np.zeros((h, w), bool)
    dc[::8, ::8] = True
    flags = ((~intra) * 1 + (rng.random((h, w)) < 0.7) * 2
             + (dc & intra) * 4)
    lv = rng.integers(-300, 300, (h, w)) * (rng.random((h, w)) < 0.3)
    pred = rng.integers(0, 256, (h, w))
    return (lv.astype(np.int16), (q * m).astype(np.int16),
            flags.astype(np.uint8), pred)


@needs_jax
@pytest.mark.parametrize("quirk", [False, True])
def test_plain_recon_matches_pallas_recon(quirk):
    h, w = 48, 72                        # jsvx pads the width to 128
    consts = _port_consts(jdec.make_constants(None))
    n_diff = n_pix = 0
    for seed, is_p in ((1, 1), (2, 0)):
        lv, mult, flags, pred = _recon_inputs(h, w, seed)
        want = np.asarray(j_recon(
            jnp.asarray(lv), jnp.asarray(mult), jnp.asarray(flags),
            jnp.asarray((pred * is_p).astype(np.int32)), quirk=quirk,
            interpret=True))
        before = recon.launches
        got = recon.fused_recon_plane(
            torch.from_numpy(lv), torch.from_numpy(mult),
            torch.from_numpy(flags),
            torch.from_numpy(pred.astype(np.int16)),
            torch.tensor(is_p, dtype=torch.int32), consts, quirk).numpy()
        assert recon.launches == before
        assert got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        n_diff += int((diff > 0).sum())
        n_pix += diff.size
    print(f"recon quirk={quirk}: {n_diff} of {n_pix} pixels differ")
    assert n_diff <= 1e-3 * n_pix


# ---------------------------------------------------------------------------
# (d), (e) the frame driver against jsvx's two-kernel frame driver


def _two_kernel_vs_jsvx(frames, quirk, label, sideband_from_port=False):
    """Frame at a time, each package fed jsvx's previous output."""
    jc = tc = refs_j = ref_o = None
    from jsvx.tools.oracle import reconstruct_frame

    for fi, (ft, seq) in enumerate(frames):
        if jc is None:
            jc = jdec.make_constants(seq)
            tc = _port_consts(jc)
            refs_j = _zero_refs(seq, ft.n_comps)
        d = jdec.frame_to_device(ft, mv_capacity=_cap(ft))
        want = [np.asarray(p) for p in decode_frame_planes_pallas(
            d, tuple(refs_j), jc, quirk, interpret=True, mc_impl="pallas")]
        frame = (frame_from_jax(tdec.frame_to_device(ft), "cpu")
                 if sideband_from_port else frame_from_jax(d, "cpu"))
        got = [p.numpy() for p in recon.decode_frame_planes_two_kernel(
            frame, refs_from_numpy(refs_j, "cpu"), tc, quirk)]
        oracle = (reconstruct_frame(ft, seq, ref_o) if not quirk
                  else want)
        _close(got, want, oracle, f"{label} frame {fi}")
        refs_j, ref_o = want, oracle


@needs_jax
@pytest.mark.parametrize("quirk", [False, True])
def test_two_kernel_frames_vs_jsvx_pallas(tiny_clip, quirk):
    frames = _frames(tiny_clip[:4], gop_size=3, quantizer_scale=4,
                     me_range=4, half_pel_refine=True)
    _two_kernel_vs_jsvx(frames, quirk, f"quirk={quirk}")


@needs_jax
def test_parser_sideband_vs_jsvx_and_oracle(tiny_clip):
    frames = _frames(tiny_clip[:4], emit_sideband=True, gop_size=3,
                     quantizer_scale=4, me_range=4, half_pel_refine=True)
    assert all(ft.mult is not None for ft, _ in frames)
    _two_kernel_vs_jsvx(frames, False, "parser sideband",
                        sideband_from_port=True)


# ---------------------------------------------------------------------------
# (f), (g) the two-kernel route is the fused route, bit for bit


def _routes_bit_equal(frames, quirk):
    tc = refs = None
    n_pix = 0
    for ft, seq in frames:
        if tc is None:
            tc = tdec.make_constants(seq, "cpu")
            refs = refs_from_numpy(_zero_refs(seq, ft.n_comps), "cpu")
        frame = frame_from_jax(tdec.frame_to_device(ft), "cpu")
        a = decode_frame_planes_fused(frame, refs, tc, quirk)
        b = recon.decode_frame_planes_two_kernel(frame, refs, tc, quirk)
        for pa, pb in zip(a, b):
            assert torch.equal(pa, pb)
            n_pix += pa.numel()
        refs = b
    return n_pix


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("clip_name", CLIPS)
def test_two_kernel_route_bit_equal_to_fused(clip_name, quirk, request):
    clip = request.getfixturevalue(clip_name)
    assert _routes_bit_equal(_frames(clip, gop_size=3, quantizer_scale=4,
                                     me_range=4, half_pel_refine=True),
                             quirk) > 0


def test_custom_small_quant_matrices(tiny_clip):
    """Entries <= 5 at quantiser scale 1 reach d == 0 for a positive level,
    where jsvx's ``_recon_kernel`` (``d - sign(lv)``) and the spec
    (``d - sign(d)``) disagree; the port's two-kernel route follows the
    spec: within 1 LSB of the oracle and equal to the fused route."""
    from jsvx.tools.oracle import reconstruct_frame

    rng = np.random.default_rng(9)
    iq = rng.integers(1, 6, 64).astype(np.uint8)
    nq = rng.integers(1, 6, 64).astype(np.uint8)
    frames = _frames(tiny_clip[:3], gop_size=3, quantizer_scale=1,
                     custom_intra_q=iq, custom_non_intra_q=nq)
    assert _routes_bit_equal(frames, False) > 0
    tc = refs = ref_o = None
    zero_from_positive = 0
    for ft, seq in frames:
        if tc is None:
            tc = tdec.make_constants(seq, "cpu")
            refs = refs_from_numpy(_zero_refs(seq, ft.n_comps), "cpu")
        frame = frame_from_jax(tdec.frame_to_device(ft), "cpu")
        for key in tdec.frame_comp_keys(frame):
            c = frame[key]
            mult, flags = recon.expand_sideband(c, tc)
            d = recon.dequant_sideband(c["levels"], mult, flags)
            zero_from_positive += int(((d == 0) & (c["levels"] > 0)
                                       & ((flags & 2) > 0)).sum())
        got = recon.decode_frame_planes_two_kernel(frame, refs, tc)
        oracle = reconstruct_frame(ft, seq, ref_o)
        for g, o in zip(got, oracle):
            assert np.abs(g.numpy().astype(int) - o.astype(int)).max() <= 1
        refs, ref_o = got, oracle
    assert zero_from_positive > 0


# ---------------------------------------------------------------------------
# (h) the wrappers on the CPU and elsewhere


def _plane_case(h, w, seed, device="cpu"):
    return _on(*_plane_inputs(h, w, seed), device)


@pytest.mark.parametrize("chroma", [False, True])
def test_wrappers_on_cpu_are_the_plain_versions(chroma):
    c, ref = _plane_case(24, 40, 3 + chroma)
    consts = tdec.make_constants(None, "cpu")
    is_p = torch.tensor(1, dtype=torch.int32)
    mc0, rc0 = mc.launches, recon.launches
    pred = mc.predict_plane_mc(ref, c["mv"], c["rep_add"], chroma)
    out16 = torch.full((24, 40), 7, dtype=torch.int16)
    assert mc.predict_plane_mc(ref, c["mv"], c["rep_add"], chroma,
                               out=out16) is out16
    want = tdec.predict_plane(ref, c["mv"], c["rep_add"], chroma)
    assert pred.dtype == torch.int16 and torch.equal(pred.int(), want)
    assert torch.equal(out16, pred)
    mult, flags = recon.expand_sideband(c, consts)
    got = recon.fused_recon_plane(c["levels"], mult, flags, pred, is_p,
                                  consts)
    out8 = torch.zeros((24, 40), dtype=torch.uint8)
    assert recon.fused_recon_plane(c["levels"], mult, flags, pred, is_p,
                                   consts, out=out8) is out8
    assert torch.equal(got, recon.recon_plane(c["levels"], mult, flags,
                                              pred, is_p, consts))
    assert torch.equal(out8, got)
    assert torch.equal(got, tdec.decode_frame_plane(c, ref, is_p, consts,
                                                    chroma))
    assert (mc.launches, recon.launches) == (mc0, rc0)


def test_wrappers_reject_other_devices():
    c, ref = _plane_case(16, 16, 4, "meta")
    with pytest.raises(ValueError, match="no motion-compensation kernel"):
        mc.predict_plane_mc(ref, c["mv"], c["rep_add"], False)
    lv = c["levels"]
    with pytest.raises(ValueError, match="no reconstruction kernel"):
        recon.fused_recon_plane(lv, lv, c["lnz"], lv,
                                torch.zeros((), dtype=torch.int32,
                                            device="meta"),
                                tdec.make_constants(None, "meta"))


# ---------------------------------------------------------------------------
# (i) the kernels on the card


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    consts = tdec.make_constants(None, dev)
    for h, w, chroma in ((48, 64, False), (24, 40, True), (1088, 1920, False),
                         (544, 960, True)):
        for quirk, is_p in ((False, 1), (True, 1), (False, 0)):
            c, ref = _plane_case(h, w, h * w + quirk, dev)
            ip = torch.tensor(is_p, dtype=torch.int32, device=dev)
            mc0, rc0 = mc.launches, recon.launches
            pred = mc.predict_plane_mc(ref, c["mv"], c["rep_add"], chroma)
            want_pred = tdec.predict_plane(ref, c["mv"], c["rep_add"],
                                           chroma).to(torch.int16)
            mult, flags = recon.expand_sideband(c, consts)
            got = recon.fused_recon_plane(c["levels"], mult, flags, pred,
                                          ip, consts, quirk)
            want = recon.recon_plane(c["levels"], mult, flags, want_pred,
                                     ip, consts, quirk)
            torch.cuda.synchronize()
            assert (mc.launches, recon.launches) == (mc0 + 1, rc0 + 1)
            assert torch.equal(pred, want_pred), (h, w, chroma)
            assert torch.equal(got, want), (h, w, chroma, quirk, is_p)
