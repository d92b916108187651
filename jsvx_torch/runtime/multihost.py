"""Multi-host decoding: the GOP work manifest.

The port's copy of ``jsvx/runtime/multihost.py`` without ``initialize``
(its process bootstrap, which waits for the port's sharding).  GOPs are
closed decode units keyed by the container's seek index, so the
cross-host protocol degenerates to a *work manifest* — no tensor traffic
crosses hosts, only byte ranges and completion records.
:class:`GopManifest` holds GOP byte spans from the key map (or a
start-code scan), static round-robin assignment per process, and durable
completion tracking (JSON journal) giving GOP-granular checkpoint/resume
— the analog of the reference's key-map restartability
(``decoders/jsv.js:282-350``; SURVEY.md section 5).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from ..bitstream.bitio import BitReader
from ..bitstream.container import (StartCodeIndex, parse_container_header)
from ..coding import tables as T


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
