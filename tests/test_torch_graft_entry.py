"""The port's driver entry points (jsvx_torch.graft_entry) against jsvx's
``__graft_entry__.py``.

* ``entry(device="cpu")``: the fused kernel's plain version on jsvx's
  synthetic P picture, against jsvx's ``entry()`` run through
  ``jax.jit`` on the CPU: <= 1 LSB on at most 0.1 % of pixels (the f32
  IDCT's summation order differs between the packages; ROADMAP C).
* ``dryrun_multichip(n, device="cpu")``: n gloo ranks on the CPU (the
  band route's plain versions), which must pass its own checks (the
  sharded planes bit-identical to a (gop 1, rows 1) mesh, GOP 0 within 1
  LSB on at most 0.1 % of pixels of the fused GOP decode) and print jsvx's
  closing line; its GOP 0 planes are then held, in this process, within
  1 LSB of jsvx's ``decode_gop_scan(..., mc_impl="mvset")`` on the same
  stream.  jsvx's own 8-device dry run is not run here.

The ``cuda``-marked tests run ``entry()`` on a card, bit-equal to its
plain version and to the CPU with one fused launch, and
``dryrun_multichip(8)`` with its ranks on the card:
``python -m pytest tests/test_torch_graft_entry.py -m cuda --noconftest``.
"""

import inspect

import numpy as np
import pytest
import torch

from jsvx_torch import graft_entry
from jsvx_torch.kernels.decode import decode_frame_planes
from jsvx_torch.shard.launch import run_ranks

import torch_card

try:                                     # the card's machine has no JAX
    import jax

    import __graft_entry__ as jentry
    from jsvx.kernels.decode import make_constants as j_make_constants
    from jsvx.pipeline.gop import decode_gop_scan
    from jsvx.pipeline.gop import zero_refs as j_zero_refs
    from jsvx.pipeline.packed_parse import BufferPool as JBufferPool
    from jsvx.pipeline.packed_parse import \
        parse_gop_packed as j_parse_gop_packed
    from jsvx.pipeline.packed_parse import walk_stream as j_walk_stream
except ImportError:
    jax = None

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax is None, reason="needs jax")


def _close(got, want):
    """<= 1 LSB, on at most 0.1 % of the pixels."""
    n_diff = n_pix = 0
    for g, w in zip(got, want, strict=True):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == np.uint8 and g.shape == w.shape
        d = np.abs(g.astype(int) - w.astype(int))
        assert d.max() <= 1
        n_diff += int((d > 0).sum())
        n_pix += d.size
    assert n_diff <= 1e-3 * n_pix, (n_diff, n_pix)


# ---------------------------------------------------------------------------
# entry()


@needs_jax
def test_entry_equals_jsvx():
    fn, args = graft_entry.entry(device="cpu")
    frame, refs, consts = args
    assert all(r.device.type == "cpu" for r in refs)
    got = fn(*args)
    assert [tuple(p.shape) for p in got] == [(128, 128), (64, 64), (64, 64)]
    jfn, jargs = jentry.entry()
    want = jax.jit(jfn)(*jargs)
    _close([p.numpy() for p in got], [np.asarray(p) for p in want])
    # the same synthetic inputs, field by field
    jframe = jargs[0]
    for key in ("y", "cb", "cr"):
        for f, v in frame[key].items():
            assert np.array_equal(v.numpy(), jframe[key][f]), (key, f)
    assert int(frame["is_p"]) == int(jframe["is_p"]) == 1


def test_entry_decodes_through_the_fused_wrapper(monkeypatch):
    seen = []
    real = graft_entry.decode_frame_planes_fused

    def spy(*a, **kw):
        seen.append(a[1][0].device)
        return real(*a, **kw)

    monkeypatch.setattr(graft_entry, "decode_frame_planes_fused", spy)
    fn, args = graft_entry.entry(device="cpu")
    fn(*args)
    assert seen == [torch.device("cpu")]


def test_entry_points_default_to_the_card():
    for f in (graft_entry.entry, graft_entry.dryrun_multichip):
        assert inspect.signature(f).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return                           # the check below needs no card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(8)
    with pytest.raises(SystemExit):
        graft_entry.main(["8"])


@pytest.mark.parametrize("n,axes", [(8, {"gop": 2, "rows": 4}),
                                    (4, {"gop": 2, "rows": 2}),
                                    (6, {"gop": 2, "rows": 3}),
                                    (3, {"gop": 1, "rows": 3}),
                                    (2, {"gop": 1, "rows": 2}),
                                    (1, {"gop": 1, "rows": 1})])
def test_mesh_axes_are_jsvx(n, axes):
    assert graft_entry.mesh_axes(n) == axes
    n_gop = 2 if n % 2 == 0 and n >= 4 else 1     # __graft_entry__.py
    assert axes == {"gop": n_gop, "rows": n // n_gop}


def test_dryrun_stream_is_jsvx():
    """The clip and its encode are jsvx's: the same bytes as the stream
    of ``MULTICHIP_r05.json``'s run (303357 at 8 devices)."""
    data = graft_entry.encode_dryrun_stream(2, 4)
    assert len(data) == 303357
    clip = graft_entry.dryrun_clip(2, 4)
    assert len(clip) == 6 and clip[0][0].shape == (1088, 256)
    assert clip[0][1].shape == (544, 128)


# ---------------------------------------------------------------------------
# dryrun_multichip(8) on the CPU


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = graft_entry.dryrun_multichip(
            8, device="cpu", workdir=str(tmp_path_factory.mktemp("dryrun")))
    return report, out.getvalue()


def test_dryrun_multichip_8_passes_and_prints_jsvx_line(dryrun):
    report, printed = dryrun
    line = printed.strip().splitlines()[-1]
    assert line == (
        "dryrun_multichip OK: mesh {'gop': 2, 'rows': 4}, stream-driven: "
        "encoded 303357 bytes, native-parsed, CPU shard-decoded 2x3 frames "
        "of 1088x256, BIT-IDENTICAL to the single-device (1x1 mesh) decode")
    assert report["mesh"] == {"gop": 2, "rows": 4}
    assert (report["height"], report["width"]) == (1088, 256)
    assert [p.shape for p in report["planes"]] == [
        (2, 3, 1088, 256), (2, 3, 544, 128), (2, 3, 544, 128)]
    assert report["max_abs_diff"] <= 1
    assert report["n_diff"] <= 1e-3 * sum(p[0].size
                                          for p in report["planes"])


def test_dryrun_ranks_cover_the_mesh_by_exchange(dryrun):
    """Eight ranks, a GOP per row of the mesh, bands of 272 luma rows;
    the clip's motion keeps the halo under a band, so each frame's halo
    moves by the neighbour exchange, not the all-gather."""
    report, _ = dryrun
    ranks = report["ranks"]
    assert [r["rank"] for r in ranks] == list(range(8))
    assert [r["coords"] for r in ranks] == [
        {"gop": g, "rows": r} for g in range(2) for r in range(4)]
    assert [r["gops"] for r in ranks] == [[0]] * 4 + [[1]] * 4
    assert {r["band_rows"] for r in ranks} == {272}
    assert report["halo_y"] == 48 and report["halo_route"] == "exchange"
    assert all(r["halo_route"] == "exchange" for r in ranks)
    # the CPU runs the plain versions: no launch is counted
    assert all(r["launches"]["mc"] == r["launches"]["recon"] == 0
               for r in ranks)
    assert report["fused_launches"] == 0


@needs_jax
def test_dryrun_gop0_close_to_jsvx_mvset_scan(dryrun):
    report, _ = dryrun
    data = report["data"]
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = j_walk_stream(data)
    gop = j_parse_gop_packed(arr, groups[0], seq, meta, 128,
                             pool=JBufferPool())
    ref, _ = decode_gop_scan(gop.stacked, j_zero_refs(1088, 256),
                             j_make_constants(seq), mc_impl="mvset")
    _close([p[0] for p in report["planes"]], [np.asarray(r) for r in ref])


def test_a_failing_rank_raises_with_its_error(tmp_path):
    with pytest.raises(RuntimeError, match="No such file"):
        run_ranks("jsvx_torch.graft_entry:dryrun_rank", 2, str(tmp_path),
                  str(tmp_path / "missing.jsv"), "cpu", str(tmp_path),
                  timeout_s=120)


# ---------------------------------------------------------------------------
# On a card


@pytest.mark.cuda
def test_entry_on_the_card_is_its_plain_version():
    """``entry()`` on the card: one fused launch, bit-equal to the plain
    version on the same card tensors and to the CPU; and the same picture
    from random reference planes (its vectors of up to 12 half-pels read
    real taps), kernel against plain."""
    dev = torch_card.card()
    fn, args = graft_entry.entry()
    frame, refs, consts = args

    def plain(refs):
        return decode_frame_planes(frame, refs, consts)

    gen = torch.Generator().manual_seed(12)
    rand = tuple(torch.randint(0, 256, tuple(r.shape), generator=gen,
                               dtype=torch.uint8).to(dev) for r in refs)
    cfn, cargs = graft_entry.entry(device="cpu")
    for refs_in, cpu in ((refs, cfn(*cargs)), (rand, None)):
        got, n = torch_card.counted(lambda: fn(frame, refs_in, consts))
        assert n == torch_card.want_counts(fused=1)
        for i, (g, w) in enumerate(zip(got, plain(refs_in), strict=True)):
            assert torch.equal(g, w)
            assert cpu is None or torch.equal(g.cpu(), cpu[i])


@pytest.mark.cuda
def test_dryrun_multichip_8_on_the_card(tmp_path):
    """``dryrun_multichip(8)``: eight gloo ranks sharing the card pass its
    own checks, each rank's bands through the MC and reconstruction
    kernels once a picture and the caller's GOP through the fused kernel
    once a picture."""
    torch_card.card()
    rep = graft_entry.dryrun_multichip(8, workdir=str(tmp_path))
    assert len(rep["ranks"]) == 8 and rep["max_abs_diff"] <= 1
    for r in rep["ranks"]:
        assert torch_card.want_counts(**r["launches"]) == \
            torch_card.want_counts(mc=3, recon=3), r["rank"]
    assert rep["fused_launches"] == 3
