"""GOP-parallel decode: independent GOPs split across ranks.

The port of ``jsvx/shard/gop_parallel.py``.  GOPs are closed decode units
(I-led, per-slice predictor resets), so a batch of GOPs splits on its
leading axis with no communication inside a step.  Each rank packs its
share of the batch into one dense wire and decodes it through one GOP
program (:mod:`jsvx_torch.pipeline.program`), the counterpart of jsvx's
jitted ``run``: the program's body decodes the share's GOPs one after
the other, each from zero reference planes, through the fused kernel
(one launch per picture on a card), where jsvx vmaps them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.decode import DecodeConstants, frame_comp_keys
from ..pipeline.program import CACHE, GopProgram, ProgramSet, program_key
from ..pipeline.wire import flatten_wire, wire_spec
from ..runtime.profiler import Metrics
from .mesh import Mesh
from .slice_rows import BLOCK_FIELDS


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rank_share(batch: dict, gops: range) -> dict:
    """GOPs ``gops`` of ``batch`` as host arrays ``(G, F, ...)``, with the
    fields the decode reads only."""
    share = slice(gops.start, gops.stop)
    out = {"is_p": _host(batch["is_p"][share])}
    for key in frame_comp_keys(batch):
        out[key] = {f: _host(batch[key][f][share])
                    for f in ("levels",) + BLOCK_FIELDS}
    return out


def decode_gops_parallel(batch: dict, coded_h: int, coded_w: int,
                         consts: DecodeConstants, mesh: Mesh,
                         axis: str = "gop",
                         quirk_oddify_zeros: bool = False,
                         device="cuda",
                         metrics: Metrics | None = None) -> tuple:
    """Decode this rank's share of a batch of GOPs split over ``axis``.

    ``batch`` leaves lead with ``(n_gops, n_frames, ...)`` (numpy or
    tensors; tensors on a card are copied to the host for the pack);
    ``n_gops`` must divide by the axis's size (pad a short batch with
    repeated GOPs and drop the extras).  The rank's G GOPs are packed into
    one dense wire, copied once into the static wire of the program of
    its key (the layout, which holds G and the frame count, the picture
    size, the planes, ``"fused"``, the quirk, the quant matrices and
    ``device``), and decoded by it, each GOP from zero reference planes.
    Returns (stacked planes (GOPs, frames, H, W) per plane, final planes
    (GOPs, H, W) per plane, views of the former; the GOPs' indices in the
    batch).  The counters ``gop_program.captures`` and ``.replays`` go to
    ``metrics``.
    """
    device = torch.device(device)
    gops = mesh.shard_range(batch["is_p"].shape[0], axis)
    share = _rank_share(batch, gops)
    spec = wire_spec(share)
    key = program_key(spec, coded_h // 16, coded_w // 16,
                      len(frame_comp_keys(share)), "fused",
                      quirk_oddify_zeros, consts, device, gops=len(gops))
    programs = ProgramSet(CACHE)
    try:
        prog = programs.get(key, lambda: GopProgram(key, consts))
        prog.fill(torch.from_numpy(flatten_wire(share, spec)))
        outs, _ = prog.run(None, metrics or Metrics())
    finally:
        programs.close()
    return outs, tuple(o[:, -1] for o in outs), gops
