"""The rank mesh: named axes over the processes of a ``torch.distributed``
world.

The decode problem has two natural parallel axes (SURVEY.md section 2.6):

* ``gop``  — GOPs are closed (I-frame led, predictors reset per slice), so
  they are embarrassingly data-parallel units; the GOP key map provides
  random access.  This is the DP axis.
* ``rows`` — within one frame, slice rows are independent after parse; the
  only cross-band coupling is P-frame motion reads across the boundary,
  handled by halo exchange (point-to-point sends) or a reference
  all-gather.  This is the SP axis.

The port of ``jsvx/shard/mesh.py``: where jsvx lays devices out in a JAX
``Mesh``, the port lays ranks out in the same grid (rank ``r`` of the
first ``prod(sizes)`` ranks at the row-major coordinate of ``r``) and
makes one process group per axis, over the ranks that share the other
coordinates.  ``torch.distributed.device_mesh.init_device_mesh`` is not
used: it binds each rank to a card of its own (``rank % device_count``)
and needs the mesh to span the whole world, where this decode runs
several ranks on one card and, as jsvx's ``devices[:n]``, a mesh on the
first ranks of a larger world.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Mesh:
    """Named axes over ranks.

    ``ranks`` is the grid of global ranks (shape = the axis sizes);
    ``coords`` this rank's coordinate on each axis (None for a rank past
    the mesh, which has no place in it); ``groups`` the process group of
    each axis that this rank belongs to, None when no process group is
    initialised (a mesh of size 1 needs none).
    """

    axis_names: tuple
    ranks: np.ndarray
    coords: tuple | None
    groups: dict

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    def _axis(self, axis: str) -> int:
        try:
            return self.axis_names.index(axis)
        except ValueError:
            raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                             f"{self.axis_names}") from None

    def axis_size(self, axis: str) -> int:
        return int(self.ranks.shape[self._axis(axis)])

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        if self.coords is None:
            raise ValueError("this rank is not on the mesh")
        return self.coords[self._axis(axis)]

    def group(self, axis: str):
        """The process group along ``axis`` through this rank (None
        without an initialised process group)."""
        self._axis(axis)
        return self.groups[axis]

    def shard_range(self, n: int, axis: str) -> range:
        """The indices of ``n`` items that this rank's coordinate on
        ``axis`` holds: contiguous blocks of ``n / size``, as a JAX mesh
        shards a leading axis.  Raises unless ``n`` divides by the axis's
        size (pad a short batch with repeated items and drop the
        extras)."""
        size = self.axis_size(axis)
        if n <= 0 or n % size:
            raise ValueError(f"{n} items do not split over the {size} "
                             f"ranks of axis {axis!r}")
        per = n // size
        return range(self.index(axis) * per, (self.index(axis) + 1) * per)

    def peer(self, axis: str, index: int) -> int:
        """The global rank at ``index`` on ``axis`` with this rank's other
        coordinates (the point-to-point peer)."""
        at = list(self.coords)
        at[self._axis(axis)] = index
        return int(self.ranks[tuple(at)])


def build_mesh(axis_sizes: dict[str, int]) -> Mesh:
    """Build a named mesh over the first ranks of the world, e.g.
    ``build_mesh({'gop': 2, 'rows': 4})`` on a world of 8.

    Raises ``ValueError`` when the mesh needs more ranks than the world
    has.  Without an initialised process group the world is this one
    process, so only a mesh of size 1 can be built; it has no groups.
    With one, every rank of the world must call this in the same order
    (making a group is collective), ranks past the mesh included.
    """
    import torch.distributed as dist

    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = int(np.prod(sizes))
    live = dist.is_available() and dist.is_initialized()
    world, rank = ((dist.get_world_size(), dist.get_rank()) if live
                   else (1, 0))
    if n > world:
        raise ValueError(f"mesh needs {n} ranks, have {world}")
    ranks = np.arange(n).reshape(sizes)
    coords = (tuple(int(c) for c in np.unravel_index(rank, sizes))
              if rank < n else None)
    groups = {}
    for a, name in enumerate(names):
        groups[name] = None
        if not live:
            continue
        others = [range(s) for i, s in enumerate(sizes) if i != a]
        for at in itertools.product(*others):
            idx = list(at)
            idx.insert(a, slice(None))
            members = [int(r) for r in ranks[tuple(idx)]]
            group = dist.new_group(members)    # collective: every rank
            if rank in members:
                groups[name] = group
    return Mesh(axis_names=names, ranks=ranks, coords=coords, groups=groups)
