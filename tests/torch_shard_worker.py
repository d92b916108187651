"""Rank bodies of tests/test_torch_shard.py and tests/test_torch_multihost.py.

Each function runs on every rank of a world that
``jsvx_torch.shard.launch.run_ranks`` starts as processes: gloo ranks on
the CPU, or on a card (:func:`card_rank`).  This module imports
``jsvx_torch`` only, and the tests' ``torch_card`` on a card (no JAX, no
``jsvx``); pytest does not collect it, since its name does not start with
``test_`` (the tests' ``conftest.py`` imports JAX).
"""

import json
import pickle

import torch
import torch.distributed as dist

from jsvx_torch.kernels.decode import decode_frame_planes, make_constants
from jsvx_torch.pipeline import program
from jsvx_torch.pipeline.gop import frame_at, zero_refs
from jsvx_torch.pipeline.program import GopProgram
from jsvx_torch.runtime.profiler import Metrics
from jsvx_torch.shard import (build_mesh, decode_gop_rows_sharded,
                              decode_gops_2d_sharded, decode_gops_parallel,
                              exchange_row_halo, gather_row_halo, gather_rows,
                              slice_rows)
from jsvx_torch.tools.synthetic import synthetic_gop


def _np(planes):
    return [p.cpu().numpy() for p in planes]


def _band_of(mesh, full):
    n, i = mesh.axis_size("rows"), mesh.index("rows")
    h = full.shape[0] // n
    return torch.from_numpy(full[i * h:(i + 1) * h].copy())


def _mesh_facts(mesh):
    return {"names": mesh.axis_names, "shape": mesh.shape,
            "ranks": mesh.ranks.tolist(), "coords": mesh.coords}


def _exchange(mesh, full, halo):
    return exchange_row_halo(_band_of(mesh, full), halo, mesh).numpy()


def _gather(mesh, full, halo):
    return gather_row_halo(_band_of(mesh, full), halo, mesh).numpy()


def _rows(mesh, stacked, refs, seq, halo_y):
    outs, final = decode_gop_rows_sharded(
        stacked, refs, make_constants(seq, "cpu"), mesh, halo_y=halo_y,
        device="cpu")
    return {"band": _np(outs), "final": _np(final),
            "whole": _np(gather_rows(o, mesh) for o in outs),
            "mesh": _mesh_facts(mesh)}


def _gops_2d(mesh, batch, refs, seq, halo_y):
    outs, final, gops = decode_gops_2d_sharded(
        batch, refs, make_constants(seq, "cpu"), mesh, halo_y=halo_y,
        device="cpu")
    return {"gops": list(gops), "whole": _np(gather_rows(o, mesh, "rows")
                                             for o in outs),
            "mesh": _mesh_facts(mesh)}


def _gop_parallel(mesh, batch, seq):
    outs, final, gops = decode_gops_parallel(
        batch, seq.coded_height, seq.coded_width, make_constants(seq, "cpu"),
        mesh, device="cpu")
    return {"gops": list(gops), "outs": _np(outs), "final": _np(final)}


KINDS = {"exchange": _exchange, "gather": _gather, "rows": _rows,
         "gops_2d": _gops_2d, "gop_parallel": _gop_parallel}


def run_jobs(rank, world, job_path):
    """Every job of the pickled ``{name: (mesh axes, kind, kwargs)}`` at
    ``job_path`` that this rank is on; the results go to
    ``job_path.rank<rank>``.  Every rank builds every mesh, in the jobs'
    order, since making a group is collective."""
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        jobs = pickle.load(f)
    meshes, results = {}, {}
    try:
        build_mesh({"gop": 2 * world})
    except ValueError as e:
        results["too_big"] = str(e)
    for name, (axes, kind, kw) in jobs.items():
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = build_mesh(axes)
        if meshes[key].coords is not None:
            results[name] = KINDS[kind](meshes[key], **kw)
    with open(f"{job_path}.rank{rank}", "wb") as f:
        pickle.dump(results, f)


def report(rank, world):
    """This rank's place, as ``initialize`` returned it and as the group
    has it."""
    print(json.dumps({"rank": rank, "world": world,
                      "group_rank": dist.get_rank(),
                      "group_world": dist.get_world_size(),
                      "backend": str(dist.get_backend())}))


def transcode_share(rank, world, stream_path, journal_dir):
    """This rank's round-robin GOP share of the stream through
    ``transcode`` on the CPU, journaled; prints the per-GOP plane sums."""
    from jsvx_torch.pipeline.transcode import transcode
    from jsvx_torch.runtime.multihost import GopManifest

    torch.set_num_threads(1)
    with open(stream_path, "rb") as f:
        data = f.read()
    m = GopManifest.from_stream(
        data, journal_path=f"{journal_dir}/journal_{rank}.jsonl")
    sums = {}

    def sink(gi, outs):
        sums[gi] = [int(p.to(torch.int64).sum()) for p in outs]

    res = transcode(data, sink=sink, manifest=m, process_id=rank,
                    process_count=world, device="cpu")
    print(json.dumps({"pid": rank, "gops": res.n_gops,
                      "frames": res.n_frames, "sums": sums,
                      "done": sorted(m._done)}))


def _plain_gop(dense, refs, consts):
    """A GOP through the kernels' plain versions (torch ops on the
    tensors' device): a stack per plane, frames leading."""
    frames = []
    for i in range(int(dense["is_p"].shape[0])):
        refs = decode_frame_planes(frame_at(dense, i), refs, consts)
        frames.append(refs)
    return [torch.stack(p) for p in zip(*frames)]


def _equal(planes, want):
    for p, w in zip(planes, want, strict=True):
        assert torch.equal(p, w)


def card_checks(data: bytes, world: int, dev: torch.device) -> None:
    """On card ``dev``, in a world of ``world`` ranks (one: no process
    group), each decode against the plain decode, the kernels counted:
    the stream's GOP 0 in row bands; its first GOPs on a (gop, rows)
    mesh, in row bands and through ``decode_gops_parallel`` (its program
    captured once, then replayed, equal to the eager loop); the synthetic
    f_code 6 GOP in row bands (with four, its halo reaches a band's
    height: the all-gather); ``gather_row_halo``'s window of a band."""
    import torch_card

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    meta, seq, gops = torch_card.dense_gops(data, dev)
    gops = gops[:2]
    consts = make_constants(seq, dev)

    def refs():
        return zero_refs(seq.coded_height, seq.coded_width,
                         meta.n_components, dev)

    want = [_plain_gop(g, refs(), consts) for g in gops]
    n_f = int(gops[0]["is_p"].shape[0])
    n_gop = 2 if world % 2 == 0 else 1
    rows = build_mesh({"rows": world})
    mesh_2d = build_mesh({"gop": n_gop, "rows": world // n_gop})

    (bands, _), n = torch_card.counted(lambda: decode_gop_rows_sharded(
        gops[0], refs(), consts, rows, device=dev))
    whole = [gather_rows(b, rows) for b in bands]
    _equal(whole, want[0])
    assert n == torch_card.want_counts(mc=n_f, recon=n_f)
    h = bands[0].shape[1]
    window = gather_row_halo(bands[0][-1], 64, rows)
    assert torch.equal(window, slice_rows.edge_window(
        whole[0][-1], rows.index("rows") * h, h, 64))

    batch = {k: ({f: torch.stack([g[k][f] for g in gops]) for f in v}
                 if isinstance(v, dict) else torch.stack([g[k] for g in gops]))
             for k, v in gops[0].items()}
    init = tuple(torch.stack([r, r]) for r in refs())
    (outs, _, ids), n = torch_card.counted(lambda: decode_gops_2d_sharded(
        batch, init, consts, mesh_2d, device=dev))
    for j, g in enumerate(ids):
        _equal([gather_rows(o[j], mesh_2d) for o in outs], want[g])
    assert n == torch_card.want_counts(mc=n_f * len(ids), recon=n_f * len(ids))

    program.CACHE.clear()
    runs = []
    for name in ("first", "again", "eager"):
        m, real = Metrics(), GopProgram.run
        if name == "eager":
            GopProgram.run = torch_card.eager_run
        try:
            (outs, _, ids), n = torch_card.counted(
                lambda: decode_gops_parallel(
                    batch, seq.coded_height, seq.coded_width, consts,
                    mesh_2d, device=dev, metrics=m))
        finally:
            GopProgram.run = real
        for j, g in enumerate(ids):
            _equal([o[j] for o in outs], want[g])
        assert n == torch_card.want_counts(fused=n_f * len(ids)), name
        runs.append((m.counters.get("gop_program.captures", 0),
                     m.counters.get("gop_program.replays", 0)))
    assert runs == [(1, 0), (0, 1), (0, 0)], runs

    syn = synthetic_gop(max_mv=200, seed=60)
    sc = make_constants(None, dev)
    (sb, _), n = torch_card.counted(lambda: decode_gop_rows_sharded(
        syn, zero_refs(1088, 1920, 3, dev), sc, rows, device=dev))
    _equal([gather_rows(b, rows) for b in sb], _plain_gop(
        slice_rows.cut_band(syn, 0, 1, dev), zero_refs(1088, 1920, 3, dev),
        sc))
    assert n == torch_card.want_counts(mc=2, recon=2)
    assert (slice_rows.derive_halo_y(syn) >= sb[0].shape[1]) == (world == 4)


def card_rank(rank, world, stream_path, device):
    """:func:`card_checks` on one rank of a world sharing the card."""
    with open(stream_path, "rb") as f:
        card_checks(f.read(), world, torch.device(device))
    print(json.dumps({"rank": rank, "backend": str(dist.get_backend())}))
