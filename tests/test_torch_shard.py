"""The port's row-band and GOP sharding (jsvx_torch.shard) against the
single-device decode and against jsvx's sharded decode.

The multi-rank cases run in one gloo world of 8 processes on the CPU,
started by ``jsvx_torch.shard.launch.run_ranks`` (a ``file://``
rendezvous in ``tmp_path``, so no port is raced for; a collective timeout
of 60 s and a deadline for the world, so a deadlock fails).  Meshes of 4,
8 and 2 ranks and a (gop 2, rows 2) mesh are built in it; the rank bodies
are in ``tests/torch_shard_worker.py``.  jsvx runs in this process on the
8-device virtual CPU mesh of ``tests/conftest.py``.

Tolerances:

* the port's sharded decodes against its single-device decode: bit for
  bit, 0 differing pixels (the IDCT sums each 8x8 block in one order
  whatever the band);
* against jsvx's sharded decode: <= 1 LSB on <= 0.1 % of pixels (the f32
  IDCT's summation order differs between the packages; ROADMAP C).

On the CPU the wrappers run their plain versions.  On a card
(``cuda``-marked), the same decodes run through the kernels, in one
process and in four gloo ranks and one NCCL rank sharing the card (rank
bodies: ``torch_shard_worker.card_checks``).
"""

import json
import pickle

import numpy as np
import pytest
import torch

try:                                     # the card's machine has no JAX
    import jax

    from jsvx.kernels import decode as jdec
    from jsvx.pipeline.gop import stack_device_frames as j_stack
    from jsvx.shard import build_mesh as j_build_mesh
    from jsvx.shard import decode_gop_rows_sharded as j_rows_sharded
    from jsvx.shard import slice_rows as j_slice_rows

    from conftest import synthetic_frames, synthetic_frames_yuva
except ImportError:
    jax = None

from jsvx.tools.encoder import EncoderConfig, JsvEncoder
from jsvx_torch.kernels.decode import frame_to_device, make_constants
from jsvx_torch.pipeline.gop import (decode_gop, frame_at,
                                     stack_device_frames, zero_refs)
from jsvx_torch.pipeline.stream import StreamDecoder
from jsvx_torch.shard import (build_mesh, decode_gop_rows_sharded,
                              decode_gops_2d_sharded, decode_gops_parallel)
from jsvx_torch.shard import slice_rows
from jsvx_torch.shard.launch import run_ranks
from jsvx_torch.tools.synthetic import synthetic_gop

import torch_card

torch.set_num_threads(1)

WORLD = 8
TESTS = __import__("os").path.dirname(__file__)


def _encode(clip, **cfg):
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(**cfg)).encode(clip)


def _parse(data):
    """The port's parse: (FrameTensors, SequenceInfo)."""
    d = StreamDecoder(data, device="cpu")
    return d.parse_all(), d.parser.seq


def _stack(fts):
    return stack_device_frames([frame_to_device(ft) for ft in fts])


def _np_refs(seq, n_comps=3):
    return tuple(r.numpy() for r in zero_refs(
        seq.coded_height, seq.coded_width, n_comps, "cpu"))


def _single(stacked, seq, impl="two_kernel"):
    """The port's single-device decode of a GOP, as numpy."""
    dense = slice_rows.cut_band(stacked, 0, 1, "cpu")
    n_comps = len(jdec.frame_comp_keys(stacked))
    outs, _ = decode_gop(dense, zero_refs(seq.coded_height, seq.coded_width,
                                          n_comps, "cpu"),
                         make_constants(seq, "cpu"), impl=impl)
    return [o.numpy() for o in outs]


def _tall():
    """128x64 clip (8 MB rows) with motion, 2 GOPs of 3 frames
    (tests/test_sharding.py's ``tall_stream``)."""
    return _encode(synthetic_frames(6, 128, 64, seed=11), gop_size=3,
                   quantizer_scale=4, me_range=4)


def _rolled():
    """f_code 3 motion beyond a 16-row halo (tests/test_sharding.py's
    derived-halo stream)."""
    clip = synthetic_frames(3, 128, 64, seed=23)
    rolled = [tuple(np.roll(p, 20 * t, axis=0) for p in f)
              for t, f in enumerate(clip)]
    return _encode(rolled, gop_size=3, quantizer_scale=4, me_range=24,
                   f_code=3)


def _yuva():
    return _encode(synthetic_frames_yuva(3, 128, 64, seed=31), gop_size=3,
                   quantizer_scale=4, me_range=4)


ROWS_CASES = {                  # name: (ranks, halo_y)
    "2_two_kernel_halo32": (2, 32),
    "4_two_kernel_halo32": (4, 32),
    "4_two_kernel_halo16": (4, 16),
    "8_two_kernel_halo16": (8, 16),        # halo = band height: all-gather
}
#: ranks of the rolled stream's derived-halo and undersized-halo cases
ROLLED_RANKS = (4, 8)


@pytest.fixture(scope="module")
def streams():
    out = {}
    for name, data in (("tall", _tall()), ("rolled", _rolled()),
                       ("yuva", _yuva())):
        fts, seq = _parse(data)
        out[name] = dict(data=data, fts=fts, seq=seq)
    tall = out["tall"]
    tall["gops"] = [_stack(tall["fts"][:3]), _stack(tall["fts"][3:])]
    out["rolled"]["gop"] = _stack(out["rolled"]["fts"])
    out["yuva"]["gop"] = _stack(out["yuva"]["fts"])
    return out


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(5)
    return {"exchange": rng.integers(0, 256, (4 * 8, 16)).astype(np.uint8),
            "gather": rng.integers(0, 256, (4 * 16, 24)).astype(np.uint8)}


@pytest.fixture(scope="module")
def world(streams, planes, tmp_path_factory):
    """Every multi-rank case, run once in one world of 8 gloo ranks;
    returns each rank's results."""
    tall, rolled, yuva = streams["tall"], streams["rolled"], streams["yuva"]
    seq = tall["seq"]
    g0 = tall["gops"][0]
    batch = {k: ({f: np.stack([g[k][f] for g in tall["gops"]])
                  for f in v} if isinstance(v, dict)
                 else np.stack([g[k] for g in tall["gops"]]))
             for k, v in g0.items()}
    jobs = {
        "exchange": ({"rows": 4}, "exchange",
                     dict(full=planes["exchange"], halo=2)),
        "gather": ({"rows": 4}, "gather",
                   dict(full=planes["gather"], halo=20)),
    }
    for name, (n, halo) in ROWS_CASES.items():
        jobs[name] = ({"rows": n}, "rows", dict(
            stacked=g0, refs=_np_refs(seq), seq=seq, halo_y=halo))
    for n in ROLLED_RANKS:
        for halo, tag in ((None, "derived"), (16, "halo16")):
            jobs[f"rolled_{tag}_{n}"] = ({"rows": n}, "rows", dict(
                stacked=rolled["gop"], refs=_np_refs(rolled["seq"]),
                seq=rolled["seq"], halo_y=halo))
    jobs["yuva"] = ({"rows": 4}, "rows", dict(
        stacked=yuva["gop"], refs=_np_refs(yuva["seq"], 4),
        seq=yuva["seq"], halo_y=32))
    jobs["gops_2d"] = ({"gop": 2, "rows": 2}, "gops_2d", dict(
        batch=batch, refs=tuple(np.stack([r, r]) for r in _np_refs(seq)),
        seq=seq, halo_y=None))
    jobs["gop_parallel"] = ({"gop": 2}, "gop_parallel",
                            dict(batch=batch, seq=seq))
    work = tmp_path_factory.mktemp("shard_world")
    job_path = str(work / "jobs.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(jobs, f)
    run_ranks("torch_shard_worker:run_jobs", WORLD, str(work), job_path,
              timeout_s=240, group_timeout_s=60, path=[TESTS])
    out = []
    for rank in range(WORLD):
        with open(f"{job_path}.rank{rank}", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# Halo sizing


@pytest.mark.parametrize("f_code", range(8))
def test_halo_sizing_equals_jsvx(f_code):
    assert slice_rows.halo_for_f_code(f_code) == \
        j_slice_rows.halo_for_f_code(f_code)
    fc = np.array([0, f_code, 1], np.int32)
    want = j_slice_rows.derive_halo_y({"f_code": fc})
    assert slice_rows.derive_halo_y({"f_code": fc}) == want
    assert slice_rows.derive_halo_y({"f_code": torch.from_numpy(fc)}) == want
    assert want % 16 == 0
    assert slice_rows.derive_halo_y({}) == j_slice_rows.derive_halo_y({})


# ---------------------------------------------------------------------------
# The mesh


def test_build_mesh_raises_past_the_world_size(world):
    with pytest.raises(ValueError, match="mesh needs 2 ranks, have 1"):
        build_mesh({"rows": 2})
    for rank in range(WORLD):
        assert world[rank]["too_big"] == "mesh needs 16 ranks, have 8"


def test_mesh_lays_ranks_out_as_jsvx_lays_devices(world):
    """(gop 2, rows 2) over ranks 0-3 is jsvx's device grid; rank r sits
    at (r // 2, r % 2), and ranks past the mesh are not on it."""
    j = j_build_mesh({"gop": 2, "rows": 2})
    for rank in range(WORLD):
        got = world[rank].get("gops_2d")
        if rank >= 4:
            assert got is None
            continue
        m = got["mesh"]
        assert m["names"] == j.axis_names
        assert m["shape"] == dict(j.shape)
        assert np.array_equal(np.array(m["ranks"]),
                              np.vectorize(lambda d: d.id)(j.devices))
        assert m["coords"] == (rank // 2, rank % 2)


def test_mesh_of_one_needs_no_process_group(streams):
    """jsvx's 1x1 mesh: no group, the exchange only replicates edge rows,
    and each decode equals the single-device decode."""
    tall = streams["tall"]
    seq, g0 = tall["seq"], tall["gops"][0]
    consts = make_constants(seq, "cpu")
    want = _single(g0, seq)
    mesh = build_mesh({"gop": 1, "rows": 1})
    assert mesh.groups == {"gop": None, "rows": None}
    assert mesh.coords == (0, 0)
    outs, final = decode_gop_rows_sharded(g0, _np_refs(seq), consts, mesh,
                                          device="cpu")
    assert all(np.array_equal(o.numpy(), w) for o, w in zip(outs, want))
    assert all(np.array_equal(f.numpy(), w[-1]) for f, w in zip(final, want))
    batch = {k: ({f: a[None] for f, a in v.items()} if isinstance(v, dict)
                 else v[None]) for k, v in g0.items()}
    outs, _, gops = decode_gops_2d_sharded(
        batch, tuple(r[None] for r in _np_refs(seq)), consts, mesh,
        device="cpu")
    assert list(gops) == [0]
    assert all(np.array_equal(o[0].numpy(), w) for o, w in zip(outs, want))
    outs, _, gops = decode_gops_parallel(batch, seq.coded_height,
                                         seq.coded_width, consts, mesh,
                                         device="cpu")
    assert all(np.array_equal(o[0].numpy(), w) for o, w in zip(outs, want))


def test_routes_and_halos_are_checked(streams):
    tall = streams["tall"]
    seq, g0 = tall["seq"], tall["gops"][0]
    consts = make_constants(seq, "cpu")
    mesh = build_mesh({"rows": 1})
    with pytest.raises(ValueError, match="multiple of 16, got 8"):
        decode_gop_rows_sharded(g0, _np_refs(seq), consts, mesh, halo_y=8,
                                impl="two_kernel", device="cpu")
    for impl in ("mvset", "fused", "gather"):
        with pytest.raises(ValueError, match="impl must be 'two_kernel'"):
            decode_gop_rows_sharded(g0, _np_refs(seq), consts, mesh,
                                    halo_y=32, impl=impl, device="cpu")
    with pytest.raises(ValueError, match="do not split over the 1 ranks"):
        decode_gops_parallel({"is_p": np.zeros((0, 3))}, 16, 16, consts,
                             build_mesh({"gop": 1}), device="cpu")
    with pytest.raises(ValueError, match="whole 8-row blocks"):
        slice_rows.band_rows(128, 3)


# ---------------------------------------------------------------------------
# The halo


def _jsvx_on_rows(fn, full, n):
    mesh = j_build_mesh({"rows": n})
    spec = jax.sharding.PartitionSpec("rows", None)
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=spec, out_specs=spec,
        check_vma=False))(full))


def test_exchange_row_halo_on_4_ranks(world, planes):
    """The properties tests/test_sharding.py checks of jsvx's exchange,
    the edge replication, and jsvx's own result."""
    full, h_local, halo = planes["exchange"], 8, 2
    want = _jsvx_on_rows(lambda x: j_slice_rows.exchange_row_halo(
        x, halo, "rows"), full, 4).reshape(4, h_local + 2 * halo, -1)
    for rank in range(4):
        ext = world[rank]["exchange"]
        lo = rank * h_local
        assert ext.shape == (h_local + 2 * halo, 16)
        if rank > 0:
            assert np.array_equal(ext[:halo], full[lo - halo:lo])
        else:
            assert (ext[:halo] == full[0]).all()
        if rank < 3:
            assert np.array_equal(ext[-halo:],
                                  full[lo + h_local:lo + h_local + halo])
        else:
            assert (ext[-halo:] == full[-1]).all()
        assert np.array_equal(ext[halo:halo + h_local],
                              full[lo:lo + h_local])
        assert np.array_equal(ext, want[rank])


def test_gather_row_halo_window_equals_jsvx(world, planes):
    full, halo = planes["gather"], 20
    h_local = full.shape[0] // 4
    want = _jsvx_on_rows(lambda x: j_slice_rows.gather_row_halo(
        x, halo, "rows"), full, 4).reshape(4, h_local + 2 * halo, -1)
    for rank in range(4):
        assert np.array_equal(world[rank]["gather"], want[rank])
        assert np.array_equal(
            world[rank]["gather"],
            slice_rows.edge_window(torch.from_numpy(full), rank * h_local,
                                   h_local, halo).numpy())


# ---------------------------------------------------------------------------
# Row-band decodes


def _whole_equal(world, name, n, want):
    """Every rank's gathered planes, and its own band, equal ``want``;
    returns the gathered planes."""
    for rank in range(n):
        got = world[rank][name]
        for c, w in enumerate(want):
            rows = w.shape[1] // n
            assert np.array_equal(got["whole"][c], w), (name, rank, c)
            assert np.array_equal(got["band"][c],
                                  w[:, rank * rows:(rank + 1) * rows])
            assert np.array_equal(got["final"][c], got["band"][c][-1])
    return world[0][name]["whole"]


@pytest.mark.parametrize("case", sorted(ROWS_CASES))
def test_rows_sharded_equals_single_device(world, streams, case):
    n, _ = ROWS_CASES[case]
    tall = streams["tall"]
    want = _single(tall["gops"][0], tall["seq"])
    assert all(np.array_equal(a, b) for a, b in zip(
        want, _single(tall["gops"][0], tall["seq"], "fused")))
    _whole_equal(world, case, n, want)


def _jsvx_rows(fts, seq, n, halo_y, n_comps=3, mc_impl="gather"):
    stacked = j_stack([jdec.frame_to_device(ft) for ft in fts])
    refs = tuple(np.zeros(r.shape, np.uint8) for r in _np_refs(seq,
                                                                n_comps))
    outs, _ = j_rows_sharded(stacked, refs, jdec.make_constants(seq),
                             j_build_mesh({"rows": n}), halo_y=halo_y,
                             mc_impl=mc_impl)
    return [np.asarray(o) for o in outs]


def _close(got, want, label):
    for c, (g, w) in enumerate(zip(got, want)):
        diff = np.abs(g.astype(int) - w.astype(int))
        n_diff = int((diff > 0).sum())
        print(f"{label} plane {c}: {n_diff} of {diff.size} pixels differ "
              f"from jsvx (max {diff.max()})")
        assert diff.max() <= 1
        assert n_diff <= 1e-3 * diff.size


@pytest.mark.parametrize("case", sorted(ROWS_CASES))
def test_rows_sharded_close_to_jsvx_sharded(world, streams, case):
    n, halo = ROWS_CASES[case]
    tall = streams["tall"]
    want = _jsvx_rows(tall["fts"][:3], tall["seq"], n, halo)
    _close(world[0][case]["whole"], want, case)


@pytest.mark.parametrize("ranks", ROLLED_RANKS)
def test_derived_halo_engages_the_all_gather(world, streams, ranks):
    """f_code 3 gives a 48-row halo, past the 32-row bands of a four-way
    split and the 16-row bands of an eight-way one: the all-gather is
    taken, bit-exact, and close to jsvx."""
    rolled = streams["rolled"]
    assert max(ft.f_code for ft in rolled["fts"]) == 3
    assert max(abs(int(v)) >> 1 for ft in rolled["fts"]
               for v in ft.mb_mv.reshape(-1)) > 16
    assert slice_rows.derive_halo_y(rolled["gop"]) == 48 > 128 // ranks
    want = _single(rolled["gop"], rolled["seq"])
    got = _whole_equal(world, f"rolled_derived_{ranks}", ranks, want)
    _close(got, _jsvx_rows(rolled["fts"], rolled["seq"], ranks, None),
           f"rolled {ranks} ranks")


@pytest.mark.parametrize("ranks", ROLLED_RANKS)
def test_undersized_halo_corrupts(world, streams, ranks):
    """The negative control: a 16-row halo misses this stream's motion."""
    rolled = streams["rolled"]
    want = _single(rolled["gop"], rolled["seq"])
    got = world[0][f"rolled_halo16_{ranks}"]["whole"]
    assert any(not np.array_equal(g, w) for g, w in zip(got, want))


def test_yuva_rows_sharded(world, streams):
    yuva = streams["yuva"]
    assert yuva["fts"][0].n_comps == 4
    want = _single(yuva["gop"], yuva["seq"])
    got = _whole_equal(world, "yuva", 4, want)
    assert len(got) == 4
    _close(got, _jsvx_rows(yuva["fts"], yuva["seq"], 4, 32, n_comps=4),
           "yuva")


def test_two_axis_mesh_equals_per_gop_decode(world, streams):
    tall = streams["tall"]
    wants = [_single(g, tall["seq"]) for g in tall["gops"]]
    for rank in range(4):
        got = world[rank]["gops_2d"]
        assert got["gops"] == [rank // 2]
        for c, w in enumerate(wants[rank // 2]):
            assert np.array_equal(got["whole"][c][0], w), (rank, c)


def test_gop_parallel_on_2_ranks_equals_sequential(world, streams):
    tall = streams["tall"]
    wants = [_single(g, tall["seq"], "fused") for g in tall["gops"]]
    for rank in range(2):
        got = world[rank]["gop_parallel"]
        assert got["gops"] == [rank]
        for c, w in enumerate(wants[rank]):
            assert np.array_equal(got["outs"][c][0], w)
            assert np.array_equal(got["final"][c][0], w[-1])


# ---------------------------------------------------------------------------
# 1080p: four bands cut by slicing, in one process


@pytest.mark.parametrize("case", ["p_frame", "f_code_6_all_gather"])
def test_1080p_four_bands_equal_the_whole_plane(case):
    """The synthetic 1920x1088 GOP (an I and a P picture) in four bands
    of 272 luma rows, each decoded from its reference window cut from the
    whole previous picture (what the exchange or the all-gather gives)
    through the two-kernel route's plain versions: bit-equal to the
    whole-plane decode.  The f_code 6 GOP's halo (272) reaches the bands'
    height, the all-gather's regime."""
    gop = (synthetic_gop() if case == "p_frame"
           else synthetic_gop(max_mv=200, seed=60))
    halo_y = slice_rows.derive_halo_y(gop)
    assert (halo_y >= 1088 // 4) == (case != "p_frame")
    consts = make_constants(None, "cpu")
    whole, _ = decode_gop(slice_rows.cut_band(gop, 0, 1, "cpu"),
                          zero_refs(1088, 1920, 3, "cpu"), consts,
                          impl="two_kernel")
    bands = [slice_rows.cut_band(gop, b, 4, "cpu") for b in range(4)]
    refs = zero_refs(1088, 1920, 3, "cpu")
    for i in range(2):
        parts = []
        for b in range(4):
            ext = []
            for c, r in enumerate(refs):
                halo = halo_y // 2 if c else halo_y
                rows = r.shape[0] // 4
                ext.append(slice_rows.edge_window(r, b * rows, rows, halo))
            parts.append(slice_rows.decode_band_picture(
                frame_at(bands[b], i), tuple(ext), halo_y, consts))
        refs = tuple(torch.cat([p[c] for p in parts]) for c in range(3))
        for c in range(3):
            assert torch.equal(refs[c], whole[c][i]), (case, i, c)


# ---------------------------------------------------------------------------
# The card


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("gloo", 4), ("nccl", 1)])
def test_shards_on_the_card_equal_the_plain_decode(backend, world,
                                                   tmp_path):
    """``torch_shard_worker.card_checks`` on the 1080p fixture: in this
    process (a mesh of one rank, no process group), then in ``world``
    ranks sharing the card (NCCL needs a card per rank, so it runs one);
    a failing check fails its rank, and the rank's error this test."""
    from jsvx_torch.kernels import build
    from torch_shard_worker import card_checks

    dev = torch_card.card()
    build.load()                         # the ranks only load the kernels
    data = torch_card.stream("1080p")
    card_checks(data, 1, dev)
    path = tmp_path / "1080p.jsv"
    path.write_bytes(data)
    outs = run_ranks("torch_shard_worker:card_rank", world, str(tmp_path),
                     str(path), str(dev), backend=backend, timeout_s=420,
                     group_timeout_s=120, path=[TESTS])
    assert [json.loads(o.strip().splitlines()[-1]) for o in outs] == [
        {"rank": r, "backend": backend} for r in range(world)]
