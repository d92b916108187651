"""Single-buffer host->device wire packing.

The host packs every leaf of a GOP's dict into one uint8 array (one copy to
the device); the device side rebuilds the dict with slices and dtype views
of that one buffer, which copy nothing.  ``wire_spec`` and
``flatten_wire`` are numpy and produce the same bytes as
``jsvx/pipeline/wire.py`` (whose package imports JAX, so they are carried
here rather than imported).
"""

from __future__ import annotations

import numpy as np
import torch

#: alignment of each packed leaf; keeps every leaf's byte offset a
#: multiple of any itemsize, so ``Tensor.view(dtype)`` is legal on it
_ALIGN = 128

#: the leaf dtypes of the compact wire
_TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int32): torch.int32,
}


def _walk(tree: dict, path: tuple = ()):  # deterministic dict order
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def wire_spec(tree: dict) -> tuple:
    """Static layout for ``tree``: ((path, dtype, shape, offset), total)."""
    entries = []
    off = 0
    for path, leaf in _walk(tree):
        a = np.asarray(leaf)
        entries.append((path, a.dtype.str, a.shape, off))
        off += a.nbytes
        off = -(-off // _ALIGN) * _ALIGN
    return tuple(entries), off


def flatten_wire(tree: dict, spec: tuple, out: np.ndarray | None = None
                 ) -> np.ndarray:
    """Pack every leaf of ``tree`` into one uint8 buffer per ``spec``."""
    entries, total = spec
    if out is None:
        out = np.empty((total,), np.uint8)
    if out.nbytes < total:
        raise ValueError(f"wire buffer of {out.nbytes} B < {total} B")
    for path, dtype, shape, off in entries:
        node = tree
        for k in path:
            node = node[k]
        a = np.asarray(node)
        if a.dtype.str != dtype or a.shape != tuple(shape):
            raise ValueError(f"leaf {path} changed layout: "
                             f"{a.dtype}/{a.shape}")
        a = np.ascontiguousarray(a).reshape(-1)   # 0-d -> 1-d too
        out[off:off + a.nbytes] = a.view(np.uint8)
    return out


def unflatten_wire(buf: torch.Tensor, spec: tuple) -> dict:
    """Rebuild the dict from a uint8 tensor (on any device).

    Every leaf is a view of ``buf``: a slice, ``view(dtype)`` and
    ``reshape``; 0-d leaves come back with shape ``()``.
    """
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("wire must be a 1-D uint8 tensor")
    entries, total = spec
    if buf.numel() < total:
        raise ValueError(f"wire of {buf.numel()} B < {total} B")
    out: dict = {}
    for path, dtype, shape, off in entries:
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        raw = buf[off:off + n * dt.itemsize]
        leaf = raw.view(_TORCH_DTYPES[dt]).reshape(tuple(shape))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
