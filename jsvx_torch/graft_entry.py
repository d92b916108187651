"""The port's driver entry points: the counterpart of ``__graft_entry__.py``.

* :func:`entry` returns ``(fn, example_args)``: one P picture of 128x128
  synthetic inputs (:mod:`jsvx_torch.tools.synthetic`, jsvx's seed and
  draws) through the fused decode kernel (``csrc/fused_decode.cu``, one
  launch for the three planes; its plain version when the tensors are on
  the CPU).
* :func:`dryrun_multichip` runs jsvx's multi-device dry run over ``n``
  ranks: a ``(gop 2, rows n/2)`` mesh (``(gop 1, rows n)`` when ``n`` is
  odd or below 4), a clip of two 3-frame GOPs at 17 macroblock rows per
  band (1088x256 at ``n = 8``) encoded in this process, parsed by the C++
  parser, decoded in row bands by :func:`~jsvx_torch.shard.slice_rows.
  decode_gops_2d_sharded` (every band through ``csrc/mc.cu`` and
  ``csrc/recon.cu``, the counterpart of jsvx's ``mc_impl="pallas"``), and
  checked: bit-identical to the same call on a ``(gop 1, rows 1)`` mesh,
  and GOP 0 within 1 LSB on at most 0.1 % of pixels of the single-device
  GOP decode through the fused kernel.

The ranks are processes of this host in a gloo world
(:func:`~jsvx_torch.shard.launch.run_ranks`); on one card they share it,
so the dry run is a correctness path, not a speed path (each frame's halo
goes through the host).  Both run on the card unless the caller passes
``device="cpu"``::

    python -m jsvx_torch.graft_entry [N] [--device cpu]

runs :func:`entry`'s step, then ``dryrun_multichip(N)`` (N defaults to 8).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .bitstream.native import get_native_parser
from .kernels import build, counters
from .kernels.carry import frame_from_jax
from .kernels.decode import make_constants
from .kernels.fused import decode_frame_planes_fused
from .pipeline.gop import decode_gop, stack_device_frames, zero_refs
from .pipeline.packed_parse import BufferPool, parse_gop_packed, walk_stream
from .pipeline.transcode import synchronize
from .shard.launch import run_ranks
from .shard.mesh import build_mesh
from .shard.slice_rows import (band_rows, decode_gops_2d_sharded,
                               derive_halo_y, gather_rows)
from .tools.encoder import EncoderConfig, JsvEncoder
from .tools.synthetic import synthetic_frame_inputs

#: frames per GOP of the dry run's clip (I, P, P)
DRYRUN_FRAMES = 3
#: seconds the dry run's ranks may take, from their start to their exit
RANKS_TIMEOUT_S = 600.0


def entry(device="cuda"):
    """(fn, example_args): one P picture of the flagship path.

    ``fn(frame, refs, consts)`` decodes the three planes of ``frame``
    from ``refs`` with :func:`~jsvx_torch.kernels.fused.
    decode_frame_planes_fused`: on a card one launch of the fused decode
    kernel, on the CPU its plain version.  The arguments are jsvx's:
    ``synthetic_frame_inputs(8, 8, is_p=True, seed=1)`` (128x128), zero
    reference planes and the default quant matrices, on ``device``."""
    device = torch.device(device)
    mb_h, mb_w = 8, 8                     # 128x128 frame
    frame = frame_from_jax(synthetic_frame_inputs(mb_h, mb_w, is_p=True,
                                                  seed=1), device)
    refs = zero_refs(mb_h * 16, mb_w * 16, 3, device)
    consts = make_constants(None, device)

    def fn(frame, refs, consts):
        return decode_frame_planes_fused(frame, refs, consts)

    return fn, (frame, refs, consts)


def mesh_axes(n_devices: int) -> dict:
    """jsvx's dry-run mesh: ``{"gop": 2, "rows": n/2}`` for an even ``n``
    of at least 4, else ``{"gop": 1, "rows": n}``."""
    n_gop = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return {"gop": n_gop, "rows": n_devices // n_gop}


def dryrun_clip(n_gop: int, n_rows: int) -> list:
    """jsvx's dry-run clip: ``n_gop`` GOPs of :data:`DRYRUN_FRAMES`
    frames, 16 macroblock columns and 17 macroblock rows per band (a
    panning sine/cosine pattern with noise from ``default_rng(5)``)."""
    h, w = 17 * n_rows * 16, 16 * 16
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    clip = []
    for t in range(n_gop * DRYRUN_FRAMES):
        y = np.clip(120 + 60 * np.sin(2 * np.pi * (xx + 2.5 * t) / w)
                    + 40 * np.cos(2 * np.pi * (yy - 1.5 * t) / h)
                    + rng.normal(0, 4, (h, w)), 0, 255)
        cb = np.clip(128 + 24 * np.sin(2 * np.pi * xx[::2, ::2] / w),
                     0, 255)
        cr = np.clip(128 + 24 * np.cos(2 * np.pi * yy[::2, ::2] / h),
                     0, 255)
        clip.append(tuple(p.astype(np.uint8) for p in (y, cb, cr)))
    return clip


def encode_dryrun_stream(n_gop: int, n_rows: int) -> bytes:
    """The dry-run clip encoded as jsvx encodes it (GOP 3, q 4, motion
    search radius 4 with half-pel refinement)."""
    clip = dryrun_clip(n_gop, n_rows)
    h, w = clip[0][0].shape
    return JsvEncoder(w, h, EncoderConfig(
        gop_size=DRYRUN_FRAMES, quantizer_scale=4, me_range=4,
        half_pel_refine=True)).encode(clip)


def parse_dryrun_stream(data: bytes, n_gop: int) -> tuple:
    """The C++ parser's dense GOPs of the stream: (its sequence header,
    the first ``n_gop`` GOPs' stacked dicts, those stacked on a leading
    GOP axis)."""
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    if len(groups) < n_gop:
        raise ValueError(f"the stream has {len(groups)} GOPs, the mesh "
                         f"needs {n_gop}")
    pool = BufferPool()
    gops = [parse_gop_packed(arr, groups[g], seq, meta, pool=pool).stacked
            for g in range(n_gop)]
    return seq, gops, stack_device_frames(gops)


def dryrun_rank(rank: int, world: int, stream_path: str, device: str,
                out_dir: str) -> None:
    """One rank of :func:`dryrun_multichip`: its share of the GOPs on the
    ``world``-rank mesh, in row bands; the rank at band 0 of each GOP
    writes the GOP's whole planes (gathered from the bands) to
    ``out_dir``, rank 0 also the same call on a ``(gop 1, rows 1)``
    mesh.  Prints one JSON line: its coordinates, GOPs, halo, the launch
    counts of its banded decode and that decode's wall seconds."""
    torch.set_num_threads(1)
    # on one card every rank shares it
    dev = (torch.device("cpu") if device == "cpu" else
           torch.device("cuda", rank % torch.cuda.device_count()))
    with open(stream_path, "rb") as f:
        data = f.read()
    axes = mesh_axes(world)
    seq, _, batch = parse_dryrun_stream(data, axes["gop"])
    # every rank builds both meshes: making a group is collective
    mesh = build_mesh(axes)
    mesh1 = build_mesh({"gop": 1, "rows": 1})
    halo_y = derive_halo_y(batch)
    consts = make_constants(seq, dev)
    h, w = seq.coded_height, seq.coded_width
    init_refs = (np.zeros((axes["gop"], h, w), np.uint8),
                 np.zeros((axes["gop"], h // 2, w // 2), np.uint8),
                 np.zeros((axes["gop"], h // 2, w // 2), np.uint8))

    def decode(on):
        return decode_gops_2d_sharded(batch, init_refs, consts, on,
                                      halo_y=halo_y, impl="two_kernel",
                                      device=dev)

    counters.reset()
    synchronize(dev)
    t0 = time.perf_counter()
    outs, final, gops = decode(mesh)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = counters.snapshot()
    if outs[0].shape[1:] != (DRYRUN_FRAMES, h // axes["rows"], w) \
            or final[0].shape[1:] != (h // axes["rows"], w):
        raise RuntimeError(f"band stacks {tuple(outs[0].shape)}, final "
                           f"{tuple(final[0].shape)} for a {h}x{w} clip")
    whole = [gather_rows(o, mesh, "rows").cpu().numpy() for o in outs]
    if mesh.index("rows") == 0:
        for i, g in enumerate(gops):
            np.savez(os.path.join(out_dir, f"mesh_gop{g}.npz"),
                     *[p[i] for p in whole])
    if mesh1.coords is not None:
        single, _, _ = decode(mesh1)
        np.savez(os.path.join(out_dir, "single.npz"),
                 *[p.cpu().numpy() for p in single])
    luma_band = band_rows(h, axes["rows"])
    print(json.dumps({
        "rank": rank, "coords": dict(zip(mesh.axis_names, mesh.coords)),
        "device": str(dev), "gops": list(gops), "halo_y": halo_y,
        "band_rows": luma_band,
        "halo_route": "exchange" if halo_y < luma_band else "all_gather",
        "launches": launches, "seconds": seconds}), flush=True)


def dryrun_multichip(n_devices: int = 8, device="cuda",
                     workdir: str | None = None) -> dict:
    """jsvx's ``dryrun_multichip(n)`` on ``n_devices`` gloo ranks of this
    host, each on ``device`` (a CUDA card unless the caller asks for
    ``"cpu"``; on one card the ranks share it).

    In this process: the clip is encoded once and written to the run's
    work directory (``workdir``, else a temporary one), and the C++
    parser and, on a card, the kernels' library are built before the
    ranks start (so they only load them).  The ranks run
    :func:`dryrun_rank`.  Back here the GOPs' whole planes are held
    bit-identical to the ``(gop 1, rows 1)`` mesh's, and GOP 0 within 1
    LSB on at most 0.1 % of pixels of :func:`~jsvx_torch.pipeline.gop.
    decode_gop` through the fused kernel on ``device``; then jsvx's closing
    line is printed.  A failing rank (its error output in the message), a
    world still running after :data:`RANKS_TIMEOUT_S`, a build or a check
    raises.

    Returns the run: ``mesh``, ``bytes``, ``height``, ``width``, the
    ``halo_y`` and its ``halo_route`` (``"exchange"`` or
    ``"all_gather"``), ``planes`` (the (GOPs, frames, H, W) uint8 array
    of each plane, as the mesh decoded them), ``ranks`` (each rank's
    report: GOPs, launch counts, seconds of its banded decode),
    ``fused_launches`` (the single-device decode's), ``max_abs_diff`` and
    ``n_diff`` against it, ``seconds`` (the ranks' wall time, from their
    start to their exit) and ``data`` (the stream)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device is available "
                           "(pass device='cpu' for the CPU)")
    get_native_parser()                  # built here: the ranks load it
    if device.type == "cuda":
        build.load()
    axes = mesh_axes(n_devices)
    n_gop = axes["gop"]
    data = encode_dryrun_stream(n_gop, axes["rows"])
    seq, gops, _ = parse_dryrun_stream(data, n_gop)
    h, w = seq.coded_height, seq.coded_width

    with tempfile.TemporaryDirectory(prefix="jsvx_dryrun_") as tmp:
        work = workdir or tmp
        os.makedirs(work, exist_ok=True)
        stream_path = os.path.join(work, "dryrun.jsv")
        with open(stream_path, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        outs = run_ranks("jsvx_torch.graft_entry:dryrun_rank", n_devices,
                         work, stream_path, device.type, work,
                         backend="gloo", timeout_s=RANKS_TIMEOUT_S,
                         group_timeout_s=RANKS_TIMEOUT_S / 2)
        seconds = time.perf_counter() - t0
        ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]

        def planes(name):
            with np.load(os.path.join(work, name)) as z:
                return [z[f"arr_{c}"] for c in range(len(z.files))]

        sharded = [np.stack(p) for p in zip(
            *[planes(f"mesh_gop{g}.npz") for g in range(n_gop)])]
        single = planes("single.npz")

    want_shape = (n_gop, DRYRUN_FRAMES, h, w)
    if sharded[0].shape != want_shape:
        raise RuntimeError(f"sharded luma {sharded[0].shape}, expected "
                           f"{want_shape}")
    for g in range(n_gop):
        for c in range(3):
            if not np.array_equal(sharded[c][g], single[c][g]):
                raise RuntimeError(f"sharded decode != single-device (gop "
                                   f"{g} comp {c})")

    # the other route on one device: GOP 0 through the fused kernel
    before = counters.snapshot()["fused"]
    ref, _ = decode_gop(frame_from_jax(gops[0], device),
                        zero_refs(h, w, 3, device),
                        make_constants(seq, device))
    fused_launches = counters.snapshot()["fused"] - before
    max_diff = n_diff = n_pix = 0
    for c in range(3):
        d = np.abs(sharded[c][0].astype(int) - ref[c].cpu().numpy())
        max_diff = max(max_diff, int(d.max()))
        n_diff += int((d > 0).sum())
        n_pix += d.size
    if max_diff > 1 or n_diff > 1e-3 * n_pix:
        raise RuntimeError(f"sharded decode vs the fused GOP decode: max "
                           f"diff {max_diff}, {n_diff} of {n_pix} pixels")

    route = "CUDA" if device.type == "cuda" else "CPU"
    print(f"dryrun_multichip OK: mesh {axes}, stream-driven: encoded "
          f"{len(data)} bytes, native-parsed, {route} shard-decoded "
          f"{n_gop}x{DRYRUN_FRAMES} frames of {h}x{w}, BIT-IDENTICAL to the "
          f"single-device (1x1 mesh) decode", flush=True)
    return {"mesh": axes, "bytes": len(data), "height": h, "width": w,
            "halo_y": ranks[0]["halo_y"], "halo_route": ranks[0]["halo_route"],
            "planes": sharded, "ranks": ranks,
            "fused_launches": fused_launches, "max_abs_diff": max_diff,
            "n_diff": n_diff, "seconds": seconds, "data": data}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m jsvx_torch.graft_entry")
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="ranks of the dry run (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (--device cpu for "
                         "the CPU)")
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry OK:", [tuple(p.shape) for p in out], flush=True)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
