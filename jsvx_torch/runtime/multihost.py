"""Multi-host decoding: the process bootstrap and the GOP work manifest.

The port's copy of ``jsvx/runtime/multihost.py``.  GOPs are closed decode
units keyed by the container's seek index, so the cross-host protocol
degenerates to a *work manifest* — no tensor traffic crosses hosts, only
byte ranges and completion records.  This module provides:

* :func:`initialize` — the ``torch.distributed`` bootstrap (jsvx's
  ``jax.distributed`` one): the process group that the row-band and GOP
  sharding (:mod:`jsvx_torch.shard`) builds its mesh on;
* :class:`GopManifest` — GOP byte spans from the key map (or a start-code
  scan), static round-robin assignment per process, and durable
  completion tracking (JSON journal) giving GOP-granular
  checkpoint/resume — the analog of the reference's key-map
  restartability (``decoders/jsv.js:282-350``; SURVEY.md section 5).
"""

from __future__ import annotations

import datetime
import json
import os
from dataclasses import dataclass, field

from ..bitstream.bitio import BitReader
from ..bitstream.container import (StartCodeIndex, parse_container_header)
from ..coding import tables as T

#: the environment ``torchrun`` and ``init_method="env://"`` read
_DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str = "nccl",
               timeout_s: float | None = None) -> tuple[int, int]:
    """Join the process group; returns (this process's rank, world size).

    ``coordinator_address`` is the rendezvous, ``tcp://host:port`` (a bare
    ``host:port`` as jsvx takes it) or ``file://path`` (a file no other
    world uses), with ``num_processes`` ranks of which this is
    ``process_id``.  Without an address the ``torch.distributed``
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, as ``torchrun`` sets it) is used when present; with neither,
    the process is alone: (0, 1), and no group is started.  ``backend`` is
    ``"nccl"`` for a card per rank, ``"gloo"`` for ranks on the CPU or
    sharing one card.  ``timeout_s`` bounds every collective of the group
    (a deadlocked exchange raises instead of waiting).  A process already
    in a group returns its place in it.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None:
        if not all(k in os.environ for k in _DIST_ENV):
            return 0, 1
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=(-1 if num_processes is None
                                        else num_processes),
                            rank=-1 if process_id is None else process_id,
                            **kw)
    return dist.get_rank(), dist.get_world_size()


@dataclass
class GopSpan:
    index: int
    byte_start: int
    byte_end: int           # exclusive
    time_s: float = 0.0


@dataclass
class GopManifest:
    spans: list = field(default_factory=list)
    journal_path: str | None = None
    _done: set = field(default_factory=set)

    # ------------------------------------------------------------------
    @classmethod
    def from_stream(cls, data: bytes,
                    journal_path: str | None = None) -> "GopManifest":
        """Build from the container key map, else scan for sequence
        headers (every GOP is preceded by one in JSV streams)."""
        r = BitReader(bytes(data))
        meta = parse_container_header(r)
        if meta.key_map is not None and meta.key_map.count > 0:
            offsets = [int(o) for o in meta.key_map.offsets]
        else:
            idx = StartCodeIndex.scan(bytes(data))
            offsets = [int(off) for off, code in idx.entries
                       if code == T.START_SEQUENCE]
        spans = []
        for i, off in enumerate(offsets):
            end = offsets[i + 1] if i + 1 < len(offsets) else len(data)
            spans.append(GopSpan(index=i, byte_start=off, byte_end=end))
        m = cls(spans=spans, journal_path=journal_path)
        m._load_journal()
        return m

    # ------------------------------------------------------------------
    # assignment

    def assigned(self, process_id: int, process_count: int) -> list:
        """Static round-robin shard of GOPs for one host."""
        return [s for s in self.spans if s.index % process_count
                == process_id]

    def pending(self, process_id: int = 0, process_count: int = 1) -> list:
        return [s for s in self.assigned(process_id, process_count)
                if s.index not in self._done]

    # ------------------------------------------------------------------
    # durable completion journal (checkpoint/resume)

    def _load_journal(self) -> None:
        if self.journal_path and os.path.exists(self.journal_path):
            with open(self.journal_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._done.add(json.loads(line)["gop"])

    def mark_done(self, gop_index: int, **info) -> None:
        self._done.add(gop_index)
        if self.journal_path:
            with open(self.journal_path, "a") as f:
                f.write(json.dumps({"gop": gop_index, **info}) + "\n")

    def is_done(self, gop_index: int) -> bool:
        return gop_index in self._done

    @property
    def n_done(self) -> int:
        return len(self._done)

    @property
    def complete(self) -> bool:
        return len(self._done) >= len(self.spans)
