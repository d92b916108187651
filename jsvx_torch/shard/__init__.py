"""Multi-rank decode over ``torch.distributed``: the port of ``jsvx.shard``.

* :func:`build_mesh` — named axes (``gop``, ``rows``) over the ranks, one
  process group per axis;
* :func:`decode_gops_parallel` — GOPs split over ranks, each decoded by
  the fused kernel;
* :func:`decode_gop_rows_sharded`, :func:`decode_gops_2d_sharded` — each
  frame's rows in bands over ranks, a halo exchange per frame and plane,
  every band decoded by the MC and reconstruction kernels;
* :mod:`jsvx_torch.shard.launch` — the ranks of a world started as
  processes of this host, with a deadline.
"""

from .gop_parallel import decode_gops_parallel
from .mesh import Mesh, build_mesh
from .slice_rows import (decode_gop_rows_sharded, decode_gops_2d_sharded,
                         exchange_row_halo, gather_row_halo, gather_rows)

__all__ = [
    "Mesh",
    "build_mesh",
    "decode_gops_parallel",
    "decode_gop_rows_sharded",
    "decode_gops_2d_sharded",
    "exchange_row_halo",
    "gather_row_halo",
    "gather_rows",
]
