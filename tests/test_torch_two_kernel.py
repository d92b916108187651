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
``cuda``-marked test (random planes and pictures, the MC edge cases, the
encoded GOPs of ``tests/torch_card.py``):
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

import torch_card
from test_torch_fused import PICTURES, _on, _plane_inputs

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
        got = recon.recon_plane(
            torch.from_numpy(lv), torch.from_numpy(mult),
            torch.from_numpy(flags),
            torch.from_numpy(pred.astype(np.int16)),
            torch.tensor(is_p, dtype=torch.int32), consts, quirk).numpy()
        assert got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        n_diff += int((diff > 0).sum())
        n_pix += diff.size
    print(f"recon quirk={quirk}: {n_diff} of {n_pix} pixels differ")
    assert n_diff <= 1e-3 * n_pix


@needs_jax
@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("clip_name", CLIPS)
def test_per_block_form_matches_per_pixel_and_jsvx(clip_name, quirk,
                                                   request):
    """The per-block form's plain version (``recon_plane_blocks``) equals
    the per-pixel form's (``recon_plane``) on the parser's own sideband,
    and is within the IDCT-order tolerance of jsvx's ``expand_sideband`` +
    ``fused_recon_plane`` in interpret mode."""
    clip = request.getfixturevalue(clip_name)
    frames = _frames(clip[:3], emit_sideband=True, gop_size=3,
                     quantizer_scale=4, me_range=4)
    rng = np.random.default_rng(17)
    n_diff = n_pix = 0
    before = recon.launches
    for ft, seq in frames:
        jc = jdec.make_constants(seq)
        tc = _port_consts(jc)
        d = jdec.frame_to_device(ft)
        td = frame_from_jax(d, "cpu")
        is_p = td["is_p"]
        for key in jdec.frame_comp_keys(d):
            c = td[key]
            assert "mult" in c                   # the parser's sideband
            pred = rng.integers(0, 256, c["levels"].shape)
            tpred = torch.from_numpy(pred.astype(np.int16))
            got = recon.recon_plane_blocks(c, tpred, is_p, tc, quirk)
            assert got.dtype == torch.uint8
            assert torch.equal(got, recon.recon_plane(
                c["levels"], c["mult"], c["flags"], tpred, is_p, tc, quirk))
            wm, wf = j_expand(d[key], jc, d["is_p"])
            want = np.asarray(j_recon(
                jnp.asarray(d[key]["levels"]), wm, wf,
                jnp.asarray((pred * int(d["is_p"])).astype(np.int32)),
                quirk=quirk, interpret=True))
            diff = np.abs(got.numpy().astype(int) - want.astype(int))
            assert diff.max() <= 1
            n_diff += int((diff > 0).sum())
            n_pix += diff.size
    print(f"{clip_name} quirk={quirk}: {n_diff} of {n_pix} pixels differ "
          f"from jsvx")
    assert n_diff <= 1e-3 * n_pix and recon.launches == before


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


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("clip_name", CLIPS)
def test_two_kernel_route_with_parser_sideband_bit_equal_to_fused(
        clip_name, quirk, request):
    """Pictures that carry the parser's per-pixel sideband as well as the
    per-block grids decode from the grids, bit-equal to the fused
    route."""
    clip = request.getfixturevalue(clip_name)
    frames = _frames(clip, emit_sideband=True, gop_size=3,
                     quantizer_scale=4, me_range=4, half_pel_refine=True)
    assert all(ft.mult is not None for ft, _ in frames)
    assert _routes_bit_equal(frames, quirk) > 0


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
    got, = recon.recon_picture({"y": c}, (pred,), is_p, consts)
    out8 = torch.zeros((24, 40), dtype=torch.uint8)
    assert recon.recon_picture({"y": c}, (pred,), is_p, consts,
                               outs=(out8,))[0] is out8
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
    pred = torch.empty((16, 16), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no reconstruction kernel"):
        recon.recon_picture({"y": c}, (pred,),
                            torch.zeros((), dtype=torch.int32,
                                        device="meta"),
                            tdec.make_constants(None, "meta"))


def _picture(name, seed, device="cpu", per_pixel=False, sparse=False):
    """A picture of the plane shapes ``PICTURES[name]`` from random
    per-block grids (carrying the per-pixel sideband expanded from them
    too, as the parser's, when ``per_pixel``; with 90 % of the blocks
    uncoded when ``sparse``), its reference planes and constants."""
    consts = tdec.make_constants(None, device)
    frame = {"is_p": torch.tensor(1, dtype=torch.int32, device=device)}
    refs = []
    for i, (key, (h, w)) in enumerate(zip(tdec.COMP_KEYS, PICTURES[name])):
        c, ref = _plane_inputs(h, w, seed + i)
        if sparse:
            rng = np.random.default_rng(seed + 100 + i)
            keep = rng.random(c["lnz"].shape) < 0.1
            c["lnz"] = c["lnz"] * keep
            c["intra"] = c["intra"] * keep
        c, ref = _on(c, ref, device)
        if per_pixel:
            c["mult"], c["flags"] = recon.expand_sideband(c, consts)
        frame[key] = c
        refs.append(ref)
    return frame, tuple(refs), consts


@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("name", ["48x64", "odd_chroma", "yuva_96x128"])
def test_picture_wrappers_on_cpu_are_the_plain_versions(name, per_pixel):
    """``predict_picture_mc`` and ``recon_picture`` on the CPU: the
    per-plane plain versions, into ``outs`` when given, with the launch
    counters unchanged, whether or not the picture also carries per-pixel
    sideband; the route equals the fused route."""
    frame, refs, consts = _picture(name, 11, per_pixel=per_pixel)
    is_p = frame["is_p"]
    keys = tdec.frame_comp_keys(frame)
    counts = (mc.launches, recon.launches)
    preds = mc.predict_picture_mc(frame, refs)
    outs16 = tuple(torch.full(r.shape, 7, dtype=torch.int16) for r in refs)
    assert all(a is b for a, b in zip(
        mc.predict_picture_mc(frame, refs, outs=outs16), outs16))
    got = recon.recon_picture(frame, preds, is_p, consts, True)
    outs8 = tuple(torch.zeros(r.shape, dtype=torch.uint8) for r in refs)
    assert all(a is b for a, b in zip(
        recon.recon_picture(frame, preds, is_p, consts, True, outs=outs8),
        outs8))
    assert len(preds) == len(got) == len(keys) == len(PICTURES[name])
    for i, key in enumerate(keys):
        c, chroma = frame[key], tdec.comp_is_chroma(i)
        want_pred = tdec.predict_plane(refs[i], c["mv"], c["rep_add"],
                                       chroma).to(torch.int16)
        assert preds[i].dtype == torch.int16
        assert torch.equal(preds[i], want_pred)
        assert torch.equal(outs16[i], want_pred)
        want = recon.recon_plane_blocks(c, want_pred, is_p, consts, True)
        assert torch.equal(got[i], want) and torch.equal(outs8[i], want)
        if per_pixel:
            assert torch.equal(want, recon.recon_plane(
                c["levels"], c["mult"], c["flags"], want_pred, is_p, consts,
                True))
    route = recon.decode_frame_planes_two_kernel(frame, refs, consts, True)
    fused = decode_frame_planes_fused(frame, refs, consts, True)
    assert all(torch.equal(a, b) for a, b in zip(route, fused))
    assert (mc.launches, recon.launches) == counts


def _misaligned(t):
    """A contiguous copy of ``t`` one element past an aligned start."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def _bad(case):
    """(check, kwargs, exception, message) for one rejected input."""
    cpu = torch.device("cpu")
    c, ref = _plane_case(24, 40, 5)
    consts = tdec.make_constants(None, "cpu")
    pred = torch.zeros((24, 40), dtype=torch.int16)

    def mc_check(**kw):
        args = dict(ref=ref, mv_blk=c["mv"], rep_add_blk=c["rep_add"],
                    out=None, device=cpu)
        args.update(kw)
        return mc.check_mc_plane(**args)

    def recon_check(**kw):
        args = dict(c=c, pred=pred, out=None, device=cpu)
        args.update(kw)
        return recon.check_recon_plane(**args)

    cases = {
        "mc_ref_dtype": (mc_check, dict(ref=ref.to(torch.int16)),
                         TypeError, "ref is torch.int16"),
        "mc_mv_shape": (mc_check, dict(mv_blk=c["mv"][:, :, :1]),
                        ValueError, "mv has shape"),
        "mc_out_dtype": (mc_check, dict(out=torch.empty((24, 40),
                                                        dtype=torch.uint8)),
                         TypeError, "out is torch.uint8"),
        "mc_out_misaligned": (mc_check, dict(out=_misaligned(pred)),
                              ValueError, "out is not 16-byte aligned"),
        "mc_ref_misaligned": (mc_check, dict(ref=_misaligned(ref)),
                              ValueError, "ref is not 8-byte aligned"),
        "mc_ragged_plane": (mc_check, dict(
            ref=torch.zeros((20, 40), dtype=torch.uint8)),
            ValueError, "not a multiple of 8"),
        "mc_other_device": (mc_check, dict(device=torch.device("meta")),
                            ValueError, "ref is on cpu"),
        "recon_levels_dtype": (recon_check, dict(c=dict(
            c, levels=c["levels"].to(torch.int32))),
            TypeError, "levels is torch.int32"),
        "recon_q_shape": (recon_check, dict(c=dict(
            c, q=c["q"][:2])), ValueError, "q has shape"),
        "recon_lnz_dtype": (recon_check, dict(c=dict(
            c, lnz=c["lnz"].to(torch.int16))), TypeError, "lnz is"),
        "recon_pred_misaligned": (recon_check, dict(pred=_misaligned(pred)),
                                  ValueError, "pred is not 16-byte aligned"),
        "recon_levels_misaligned": (recon_check, dict(c=dict(
            c, levels=_misaligned(c["levels"]))), ValueError,
            "levels is not 16-byte aligned"),
        "recon_out_misaligned": (recon_check, dict(
            out=_misaligned(torch.zeros((24, 40), dtype=torch.uint8))),
            ValueError, "out is not 8-byte aligned"),
        "recon_other_device": (recon_check, dict(device=torch.device("meta")),
                               ValueError, "levels is on cpu"),
        "recon_intra_device": (recon_check, dict(c=dict(
            c, intra=c["intra"].to("meta"))), ValueError, "intra is on meta"),
    }
    return cases[case]


@pytest.mark.parametrize("case", [
    "mc_ref_dtype", "mc_mv_shape", "mc_out_dtype", "mc_out_misaligned",
    "mc_ref_misaligned", "mc_ragged_plane", "mc_other_device",
    "recon_levels_dtype", "recon_q_shape", "recon_lnz_dtype",
    "recon_pred_misaligned", "recon_levels_misaligned",
    "recon_out_misaligned", "recon_other_device", "recon_intra_device"])
def test_picture_wrappers_reject_bad_inputs(case):
    """What the picture launches check before a launch: dtype, shape,
    device and the alignment of the vector loads."""
    check, kwargs, exc, message = _bad(case)
    with pytest.raises(exc, match=message):
        check(**kwargs)


def test_picture_wrappers_check_inputs_that_are_right():
    """The same checks pass on the inputs the route gives them (and
    allocate the outputs)."""
    cpu = torch.device("cpu")
    frame, refs, consts = _picture("48x64", 3)
    for i, key in enumerate(tdec.frame_comp_keys(frame)):
        c = frame[key]
        pred = mc.check_mc_plane(refs[i], c["mv"], c["rep_add"], None, cpu)
        assert pred.dtype == torch.int16 and pred.shape == refs[i].shape
        out = recon.check_recon_plane(c, pred, None, cpu)
        assert out.dtype == torch.uint8 and out.shape == refs[i].shape


def test_picture_wrappers_reject_other_devices():
    frame, refs, consts = _picture("48x64", 4, "meta")
    with pytest.raises(ValueError, match="no motion-compensation kernel"):
        mc.predict_picture_mc(frame, refs)
    preds = tuple(torch.empty(r.shape, dtype=torch.int16, device="meta")
                  for r in refs)
    with pytest.raises(ValueError, match="no reconstruction kernel"):
        recon.recon_picture(frame, preds, frame["is_p"], consts)


# ---------------------------------------------------------------------------
# (i) the kernels on the card


#: the MC cases of tests/test_fast_paths.py: (plane shape, the vectors)
MC_EDGES = {"mc_tall_pad": ((24, 128), [[0, 0], [141, 3], [-140, -95]]),
            "mc_clamp": ((32, 32), [[0, 0], [-13, -9], [15, 21]])}


def _mc_edge_case(name, dev):
    """The MC kernel against its plain version on a plane with vectors
    far past its edge (the tall-pad case) or out of the picture (the
    clamp case): luma and chroma one-plane launches, and the plane as Y,
    Cb and Cr of one picture launch."""
    (h, w), vectors = MC_EDGES[name]
    rng = np.random.default_rng(1234)
    ref = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.uint8))
    idx = rng.integers(0, len(vectors), (h // 8, w // 8))
    mv = torch.from_numpy(np.array(vectors, np.int16)[idx])
    rep = torch.from_numpy((rng.random((h // 8, w // 8)) < 0.2)
                           .astype(np.uint8))
    ref, mv, rep = ref.to(dev), mv.to(dev), rep.to(dev)
    before = mc.launches
    picture = mc.predict_picture_mc(
        {k: {"mv": mv, "rep_add": rep} for k in ("y", "cb", "cr")},
        (ref, ref, ref))
    for chroma in (False, True):
        got = mc.predict_plane_mc(ref, mv, rep, chroma)
        want = tdec.predict_plane(ref, mv, rep, chroma).to(torch.int16)
        torch.cuda.synchronize()
        assert torch.equal(got, want), chroma
        for p in picture[1:] if chroma else picture[:1]:
            assert torch.equal(p, want), chroma
    assert mc.launches == before + 3


def _encoded_gop(name, dev):
    """Every picture of an encoded GOP (``tests/torch_card.py``): one MC
    and one reconstruction launch each, equal to the plain versions and
    to the plain decode (the fused route's plain version)."""
    for i, frame, refs, consts, quirk in torch_card.pictures(name, dev):
        mc0, rc0 = mc.launches, recon.launches
        preds = mc.predict_picture_mc(frame, refs)
        got = recon.recon_picture(frame, preds, frame["is_p"], consts, quirk)
        route = tdec.decode_frame_planes(frame, refs, consts, quirk)
        torch.cuda.synchronize()
        assert (mc.launches, recon.launches) == (mc0 + 1, rc0 + 1)
        for ci, key in enumerate(tdec.frame_comp_keys(frame)):
            c = frame[key]
            want_pred = tdec.predict_plane(refs[ci], c["mv"], c["rep_add"],
                                           tdec.comp_is_chroma(ci)) \
                .to(torch.int16)
            want = recon.recon_plane_blocks(c, want_pred, frame["is_p"],
                                            consts, quirk)
            assert torch.equal(preds[ci], want_pred), (i, key)
            assert torch.equal(got[ci], want), (i, key, quirk)
            assert torch.equal(got[ci], route[ci]), (i, key, quirk)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["random", *MC_EDGES, *torch_card.GOPS])
def test_kernels_match_plain_on_the_card(source):
    dev = torch_card.card()
    if source in MC_EDGES:
        return _mc_edge_case(source, dev)
    if source in torch_card.GOPS:
        return _encoded_gop(source, dev)
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
            got, = recon.recon_picture({"y": c}, (pred,), ip, consts, quirk)
            want = recon.recon_plane_blocks(c, want_pred, ip, consts, quirk)
            torch.cuda.synchronize()
            assert (mc.launches, recon.launches) == (mc0 + 1, rc0 + 1)
            assert torch.equal(pred, want_pred), (h, w, chroma)
            assert torch.equal(got, want), (h, w, chroma, quirk, is_p)
    # whole pictures, dense and 90 % uncoded, with and without the
    # per-pixel sideband: one launch each per picture, equal to the plain
    # versions and to the fused route
    for name in sorted(PICTURES):
        for sparse, quirk in ((False, False), (True, False), (True, True)):
            frames = [_picture(name, 7, dev, per_pixel, sparse)
                      for per_pixel in (False, True)]
            refs = frames[0][1]
            mc0, rc0 = mc.launches, recon.launches
            preds = mc.predict_picture_mc(frames[0][0], refs)
            got = [recon.recon_picture(f, preds, f["is_p"], consts, quirk)
                   for f, _, _ in frames]
            fused = decode_frame_planes_fused(frames[0][0], refs, consts,
                                              quirk)
            torch.cuda.synchronize()
            assert (mc.launches, recon.launches) == (mc0 + 1, rc0 + 2), name
            frame = frames[1][0]
            for i, key in enumerate(tdec.frame_comp_keys(frame)):
                c = frame[key]
                want_pred = tdec.predict_plane(
                    refs[i], c["mv"], c["rep_add"],
                    tdec.comp_is_chroma(i)).to(torch.int16)
                assert torch.equal(preds[i], want_pred), (name, key)
                want = recon.recon_plane_blocks(c, want_pred, frame["is_p"],
                                                consts, quirk)
                assert torch.equal(want, recon.recon_plane(
                    c["levels"], c["mult"], c["flags"], want_pred,
                    frame["is_p"], consts, quirk)), (name, key)
                for sideband in got:
                    assert torch.equal(sideband[i], want), (name, key,
                                                            sparse)
                assert torch.equal(fused[i], want), (name, key, sparse)
