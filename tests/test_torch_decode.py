"""The port's plain decode spec (jsvx_torch.kernels.decode) vs jsvx.

The same frames, parsed by the shared parser and packed by jsvx's
``frame_to_device``, go through the JAX functions and their torch
counterparts on the CPU.  Tolerances:

* dequantisation and motion compensation are integer: bit-equal;
* the IDCT is f32 and the two packages sum in different orders (XLA's
  einsum vs the port's fixed u = 0..7 order), so it agrees within 1e-3;
* a reconstructed plane rounds that IDCT, so a value within 1e-3 of an
  exact .5 tie can round the other way: <= 1 LSB, on at most 0.1 % of a
  plane's pixels (the count is printed), and <= 1 LSB of the float64
  oracle, as jsvx's own tests require.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jsvx.kernels import decode as jdec
from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx.tools.oracle import reconstruct_frame
from jsvx_torch.kernels import decode as tdec
from jsvx_torch.kernels.carry import constants_from_jax, refs_from_numpy

from test_kernels import _walk

torch.set_num_threads(1)

CLIPS = ("tiny_clip", "small_clip", "tiny_clip_yuva")


def _frames(clip, **cfg):
    h, w = clip[0][0].shape
    return list(_walk(JsvEncoder(w, h, EncoderConfig(**cfg)).encode(clip)))


def _port_consts(jc):
    return constants_from_jax(np.asarray(jc.c_basis), jc.intra_q_key,
                              jc.non_intra_q_key, "cpu")


def _to_torch(frame: dict) -> dict:
    """A ``frame_to_device`` dict (numpy) -> CPU tensors, same dtypes."""
    out = {}
    for k, v in frame.items():
        if isinstance(v, dict):
            out[k] = {f: torch.from_numpy(np.ascontiguousarray(a))
                      for f, a in v.items()}
        else:
            out[k] = torch.from_numpy(np.asarray(v))
    return out


def _dequant_pair(c, tc_comp, jc, tc, quirk):
    want = np.asarray(jdec.dequant_plane(c["levels"], c["q"], c["intra"],
                                         c["lnz"], jc, quirk))
    got = tdec.dequant_plane(tc_comp["levels"], tc_comp["q"],
                             tc_comp["intra"], tc_comp["lnz"], tc,
                             quirk).numpy()
    return want, got


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("clip_name", CLIPS)
def test_dequant_and_predict_bit_equal(clip_name, quirk, request):
    clip = request.getfixturevalue(clip_name)
    frames = _frames(clip, gop_size=3, quantizer_scale=4, me_range=4,
                     half_pel_refine=True)
    rng = np.random.default_rng(3)
    n_p = 0
    for ft, seq in frames:
        jc = jdec.make_constants(seq)
        tc = _port_consts(jc)
        d = jdec.frame_to_device(ft)
        td = _to_torch(d)
        n_p += int(d["is_p"])
        for i, key in enumerate(jdec.frame_comp_keys(d)):
            c = d[key]
            want, got = _dequant_pair(c, td[key], jc, tc, quirk)
            assert got.dtype == np.float32
            assert np.array_equal(want, got), (key, quirk)
            ref = rng.integers(0, 256, c["levels"].shape).astype(np.uint8)
            chroma = jdec.comp_is_chroma(i)
            want = np.asarray(jdec.predict_plane(
                jnp.asarray(ref), c["mv"], c["rep_add"], chroma))
            got = tdec.predict_plane(torch.from_numpy(ref), td[key]["mv"],
                                     td[key]["rep_add"], chroma).numpy()
            assert np.array_equal(want, got), key
    assert n_p > 0


@pytest.mark.parametrize("chroma", [False, True])
def test_predict_out_of_bounds_clamp(rng, chroma):
    """Vectors pointing out of the picture clamp to its edge exactly as
    jsvx does (CLAMP_TO_EDGE), for luma and halved chroma vectors."""
    h, w = 32, 40
    ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    mv_tbl = np.array([[0, 0], [-13, -9], [15, 21], [-63, 61], [7, -80]],
                      np.int16)
    idx = rng.integers(0, len(mv_tbl), (h // 8, w // 8))
    mv_blk = mv_tbl[idx]
    rep = (rng.random((h // 8, w // 8)) < 0.2).astype(np.uint8)
    want = np.asarray(jdec.predict_plane(jnp.asarray(ref),
                                         jnp.asarray(mv_blk),
                                         jnp.asarray(rep), chroma))
    got = tdec.predict_plane(torch.from_numpy(ref), torch.from_numpy(mv_blk),
                             torch.from_numpy(rep), chroma).numpy()
    assert np.array_equal(want, got)
    assert (got[np.repeat(np.repeat(rep, 8, 0), 8, 1) > 0] == 0).all()


def test_idct_plane_within_f32_order_tolerance():
    rng = np.random.default_rng(5)
    h, w = 64, 96
    d = (rng.integers(-2048, 2048, (h, w))
         * (rng.random((h, w)) < 0.3)).astype(np.float32)
    jc = jdec.make_constants(None)
    want = np.asarray(jdec.idct_plane(jnp.asarray(d), jc))
    got = tdec.idct_plane(torch.from_numpy(d), _port_consts(jc)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    # and the port's order is the float64 blockwise C @ F @ C.T up to f32
    c = np.asarray(jc.c_basis, np.float64)
    blocks = d.astype(np.float64).reshape(h // 8, 8, w // 8, 8)
    exact = np.einsum("xu,aubv,yv->axby", c, blocks, c).reshape(h, w)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-3)


def _decode_vs_jsvx_and_oracle(frames, label):
    """Frame at a time: the port is fed jsvx's previous output as its
    reference, so every frame compares like with like."""
    jc = tc = refs_j = ref_o = None
    worst = 0.0
    for fi, (ft, seq) in enumerate(frames):
        if jc is None:
            jc = jdec.make_constants(seq)
            tc = _port_consts(jc)
            ch, cw = seq.coded_height, seq.coded_width
            refs_j = [np.zeros((ch, cw), np.uint8),
                      np.zeros((ch // 2, cw // 2), np.uint8),
                      np.zeros((ch // 2, cw // 2), np.uint8),
                      np.zeros((ch, cw), np.uint8)][:ft.n_comps]
        d = jdec.frame_to_device(ft)
        want = [np.asarray(p) for p in jdec.decode_frame_planes(
            d, tuple(refs_j), jc, mc_impl="gather")]
        got = [p.numpy() for p in tdec.decode_frame_planes(
            _to_torch(d), refs_from_numpy(refs_j, "cpu"), tc)]
        oracle = reconstruct_frame(ft, seq, ref_o)
        for ci, (g, wnt, o) in enumerate(zip(got, want, oracle)):
            diff = np.abs(g.astype(int) - wnt.astype(int))
            n_diff = int((diff > 0).sum())
            print(f"{label} frame {fi} plane {ci}: {n_diff} of {diff.size} "
                  f"pixels differ from jsvx (max {diff.max()})")
            assert diff.max() <= 1
            assert n_diff <= 1e-3 * diff.size
            assert np.abs(g.astype(int) - o.astype(int)).max() <= 1
            worst = max(worst, n_diff / diff.size)
        refs_j, ref_o = want, oracle
    return worst


@pytest.mark.parametrize("clip_name", CLIPS)
def test_decode_frame_planes_vs_jsvx_and_oracle(clip_name, request):
    clip = request.getfixturevalue(clip_name)
    frames = _frames(clip, gop_size=3, quantizer_scale=4, me_range=4,
                     half_pel_refine=True)
    _decode_vs_jsvx_and_oracle(frames, clip_name)


def test_custom_small_quant_matrices(tiny_clip):
    """Entries <= 5 at quantiser scale 1 reach d == 0 for a non-zero
    level, where the mismatch-control spec (``d - sign(d)``, refmath and
    jsvx's dequant_plane) and the Pallas kernels (``d - sign(lv)``)
    disagree; the port follows the spec."""
    rng = np.random.default_rng(9)
    iq = rng.integers(1, 6, 64).astype(np.uint8)
    nq = rng.integers(1, 6, 64).astype(np.uint8)
    frames = _frames(tiny_clip[:3], gop_size=3, quantizer_scale=1,
                     custom_intra_q=iq, custom_non_intra_q=nq)
    assert np.array_equal(frames[0][1].intra_q, iq)
    zero_from_nonzero = 0
    for ft, seq in frames:
        jc = jdec.make_constants(seq)
        tc = _port_consts(jc)
        d = jdec.frame_to_device(ft)
        td = _to_torch(d)
        for key in jdec.frame_comp_keys(d):
            want, got = _dequant_pair(d[key], td[key], jc, tc, False)
            assert np.array_equal(want, got), key
            zero_from_nonzero += int(((got == 0)
                                      & (d[key]["levels"] != 0)).sum())
    assert zero_from_nonzero > 0
    _decode_vs_jsvx_and_oracle(frames, "custom-q")


def test_constants_from_jax_round_trip(tiny_clip):
    rng = np.random.default_rng(2)
    iq = rng.integers(1, 64, 64).astype(np.uint8)
    (ft, seq), = _frames(tiny_clip[:1], gop_size=1, custom_intra_q=iq)
    jc = jdec.make_constants(seq)
    tc = _port_consts(jc)
    own = tdec.make_constants(seq, "cpu")
    assert tc.intra_q_key == own.intra_q_key == jc.intra_q_key
    assert tc.non_intra_q_key == own.non_intra_q_key == jc.non_intra_q_key
    assert tc.c_basis.dtype == torch.float32
    assert np.array_equal(tc.c_basis.numpy().view(np.uint32),
                          np.asarray(jc.c_basis).view(np.uint32))
    assert torch.equal(tc.c_basis, own.c_basis)
    assert torch.equal(tc.qtab, own.qtab)
    assert tc.qtab[0].tolist() == list(jc.intra_q_key)
    with pytest.raises(ValueError):
        constants_from_jax(np.zeros((8, 8)), jc.intra_q_key,
                           jc.non_intra_q_key, "cpu")
