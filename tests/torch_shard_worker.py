"""Rank bodies of tests/test_torch_shard.py and tests/test_torch_multihost.py.

Each function runs on every rank of a gloo world that
``jsvx_torch.shard.launch.run_ranks`` starts as processes on the CPU.  This
module imports ``jsvx_torch`` only (no JAX, no ``jsvx``); pytest does not
collect it, since its name does not start with ``test_`` (the tests'
``conftest.py`` imports JAX).
"""

import json
import pickle

import torch
import torch.distributed as dist

from jsvx_torch.kernels.decode import make_constants
from jsvx_torch.shard import (build_mesh, decode_gop_rows_sharded,
                              decode_gops_2d_sharded, decode_gops_parallel,
                              exchange_row_halo, gather_row_halo, gather_rows)


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
