"""State carried into the port from outside it.

The JAX package's ``DecodeConstants`` pytree and its reconstructed
reference planes cross into the port as numpy arrays and plain tuples, so
that both packages can be run on the same inputs (the port never imports
JAX; the caller converts with ``np.asarray``).
"""

from __future__ import annotations

import numpy as np
import torch

from .decode import COMP_KEYS, DecodeConstants

#: the per-plane fields the port's decode reads (jsvx's mvset sideband,
#: ``mv_idx``/``mv_lo``/``mv_hi``, is resolved or dropped)
_PLANE_FIELDS = ("levels", "lnz", "q", "intra", "mv", "rep_add", "mult",
                 "flags")


def constants_from_jax(c_basis: np.ndarray, intra_q_key, non_intra_q_key,
                       device) -> DecodeConstants:
    """The fields of a JAX ``DecodeConstants`` -> the port's, on ``device``.

    ``c_basis`` must already be the f32 basis the JAX package computes
    with; it is copied bit for bit.
    """
    c = np.asarray(c_basis)
    if c.shape != (8, 8) or c.dtype != np.float32:
        raise ValueError(f"c_basis must be f32 (8, 8), got {c.dtype} "
                         f"{c.shape}")
    return DecodeConstants(
        c_basis=torch.from_numpy(c.copy()).to(device),
        intra_q_key=tuple(int(x) for x in intra_q_key),
        non_intra_q_key=tuple(int(x) for x in non_intra_q_key),
    )


def refs_from_numpy(planes, device) -> tuple:
    """Reference planes (uint8 arrays, Y/Cb/Cr[/A]) -> tensors on
    ``device``."""
    out = []
    for p in planes:
        a = np.asarray(p)
        if a.dtype != np.uint8 or a.ndim != 2:
            raise ValueError(f"reference plane must be uint8 2-D, got "
                             f"{a.dtype} {a.shape}")
        out.append(torch.from_numpy(np.ascontiguousarray(a).copy())
                   .to(device))
    return tuple(out)


def frame_from_jax(d: dict, device) -> dict:
    """A jsvx ``frame_to_device`` dict, given as numpy, -> the port's frame
    dict on ``device``, the same dtypes.

    Where a plane has only the mvset sideband (``mv_idx`` into the frame's
    ``mv_table``), its per-block vectors are resolved as
    ``mv_table[mv_idx]``; the table, its count and the row bounds are
    dropped, since the port reads per-block vectors.
    """
    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)

    out = {"is_p": on(np.asarray(d["is_p"], np.int32))}
    for key in COMP_KEYS:
        if key not in d:
            continue
        c = dict(d[key])
        if "mv" not in c:
            c["mv"] = np.asarray(d["mv_table"])[np.asarray(c["mv_idx"])] \
                .astype(np.int16)
        out[key] = {f: on(c[f]) for f in _PLANE_FIELDS if f in c}
    return out
