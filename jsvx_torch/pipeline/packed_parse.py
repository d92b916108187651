"""Host front end: header walk and per-GOP parse, compact and dense.

Copies of what the port needs from ``jsvx/pipeline/packed_parse.py`` (the
picture-header helpers live in :mod:`.parallel_parse`, as in jsvx).  The
C++ parser (``jsvx_torch.bitstream.native``) writes each picture's coded
coefficients, one uint16 entry each, and the per-macroblock sideband;
:func:`parse_gop_compact` concatenates a GOP's entries into one
bucket-padded array per component.
:func:`parse_gop_packed` parses a GOP into dense stacked planes instead:
the wire of the oddify-zeros quirk and of GOPs the compact wire cannot
express; :func:`parse_stream_packed` does so for every GOP of a stream.
A GOP's pictures parse on the process's parse pool (:mod:`.parse_pool`):
:func:`start_gop_compact` and :func:`start_gop_packed` queue them, so a
caller can queue the next GOP before it waits on this one.
The port's kernels read per-block motion vectors directly, so no
distinct-vector table is built (the JAX package's ``mv_capacity=0``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from ..bitstream.bitio import BitReader
from ..bitstream.container import StartCodeIndex, parse_container_header
from ..bitstream.native import get_native_parser
from ..bitstream.parser import FrameTensors, StreamParser
from ..coding import tables as T
from ..kernels.decode import COMP_KEYS, comp_is_chroma
from .parallel_parse import (_parse_picture_header, _picture_end,
                             _picture_stops)
from .parse_pool import Batch, Lane, picture_bytes


class BufferPool:
    """Reusable host-array pool keyed by (shape, dtype).

    Release a buffer only once nothing reads it any more: after its
    device copy is complete, or, on the CPU device, after a clone.

    ``pin=True`` (for copies to a CUDA card) backs each buffer with a
    page-locked torch tensor (``pin_memory=True``) and hands out its numpy
    view, so a copy from it can run asynchronously;
    :meth:`host_tensor` gives that tensor back.  CPU-only torch cannot
    pin memory.
    """

    def __init__(self, pin: bool = False):
        self.pin = pin
        self._free: dict = {}
        self._pinned: dict = {}          # buffer address -> its tensor
        self._lock = threading.Lock()

    def acquire(self, shape: tuple, dtype) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            lst = self._free.get(key)
            if lst:
                return lst.pop()
        if not self.pin:
            return np.empty(shape, dtype)
        import torch

        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        t = torch.empty((n,), dtype=torch.uint8, pin_memory=True)
        arr = t.numpy().view(dt).reshape(shape)
        with self._lock:
            self._pinned[arr.ctypes.data] = t
        return arr

    def release(self, arr: np.ndarray) -> None:
        key = (arr.shape, arr.dtype.str)
        with self._lock:
            self._free.setdefault(key, []).append(arr)

    def host_tensor(self, arr: np.ndarray):
        """A uint8 1-D buffer of this pool as a torch tensor: the pinned
        tensor behind it, or (unpinned) ``torch.from_numpy``."""
        import torch

        if arr.dtype != np.uint8 or arr.ndim != 1:
            raise ValueError("host_tensor takes a 1-D uint8 buffer")
        with self._lock:
            t = self._pinned.get(arr.ctypes.data)
        return torch.from_numpy(arr) if t is None else t[:arr.size]


def walk_stream(data: bytes):
    """Serial header walk: (meta, seq, groups) where ``groups[g]`` is the
    list of (PictureHeader, start_bit) of GOP g and ``seq`` the stream's
    last sequence header."""
    meta, seq, groups, _ = _walk(data)
    return meta, seq, groups


def walk_stream_seqs(data: bytes):
    """The header walk of :func:`walk_stream`, with each group's own
    sequence header: (meta, seqs, groups) where ``seqs[g]`` is the
    ``SequenceInfo`` current at GOP g's first picture (the one whose
    quant matrices decode it)."""
    meta, _, groups, seqs = _walk(data)
    return meta, seqs, groups


def _walk(data: bytes):
    """(meta, the last sequence header, groups, the sequence header
    current at each group's first picture).  It reads headers only: a
    picture is its header's fields, and the walk goes from its header
    straight to the next code that can end it."""
    data = bytes(data)
    r = BitReader(data)
    meta = parse_container_header(r)
    index = StartCodeIndex.scan(data)
    stops = _picture_stops(index)
    parser = StreamParser(use_native=False)
    parser.yuva = meta.yuva
    groups: list[list] = []
    seqs: list = []
    pos = r.byte_pos
    while True:
        nxt = index.next_code(pos)
        if nxt is None:
            break
        off, code = nxt
        rr = BitReader(data, pos_bits=(off + 4) << 3)
        if code == T.START_SEQUENCE:
            parser.parse_sequence_header(rr)
            pos = rr.byte_pos
        elif code == T.START_GOP:
            parser.parse_gop_header(rr)
            groups.append([])
            seqs.append(None)
            pos = rr.byte_pos
        elif code == T.START_PICTURE:
            hdr, start_bit = _parse_picture_header(parser, rr)
            if hdr is None:
                pos = rr.byte_pos
                continue
            if not groups:
                groups.append([])
                seqs.append(None)
            if not groups[-1]:
                seqs[-1] = parser.seq
            groups[-1].append((hdr, start_bit))
            pos = _picture_end(stops, rr.byte_pos, len(data))
        else:
            pos = off + 4
    kept = [(g, s) for g, s in zip(groups, seqs) if g]
    return (meta, parser.seq, [g for g, _ in kept], [s for _, s in kept])


@dataclass
class CompactGop:
    """One GOP in the compact coefficient wire format: ``stacked`` is the
    dict that goes to the device, ``pooled`` the pool buffers it holds,
    ``dirty`` whether the stream emitted blocks out of order (the compact
    wire cannot express that GOP)."""

    stacked: dict
    hdrs: list
    index: int = 0
    pooled: list = field(default_factory=list)
    dirty: bool = False


def coef_bucket(n: int) -> int:
    """Entry-capacity bucket for the compact wire: 1.25x geometric steps,
    8192-entry aligned, so a stream sees a handful of wire layouts."""
    b = 1 << 14
    while b < n:
        b = -(-(b + b // 4) // 8192) * 8192
    return b


@dataclass
class CompactParse:
    """A GOP's compact parse queued on the parse pool
    (:func:`start_gop_compact`): the arrays its tasks fill;
    :func:`parse_gop_compact` waits for it and packs."""

    batch: Batch
    counts: list
    mb: dict
    scratch: list
    ns: list
    dirty: list


def start_gop_compact(arr: np.ndarray, group: list, seq, meta,
                      pool: BufferPool, lane: Lane) -> CompactParse:
    """Allocate a GOP's compact parse and queue its pictures on ``lane``."""
    native = get_native_parser()
    n_comps = meta.n_components
    mb_h, mb_w = seq.mb_height, seq.mb_width
    n = len(group)
    nblk = [mb_h * mb_w * 4, mb_h * mb_w, mb_h * mb_w,
            mb_h * mb_w * 4][:n_comps]

    counts = [np.zeros((n, nblk[c]), np.uint8) for c in range(n_comps)]
    mb_quant = np.ones((n, mb_h, mb_w), np.uint8)
    mb_intra = np.zeros((n, mb_h, mb_w), np.uint8)
    mb_mv = np.zeros((n, mb_h, mb_w, 2), np.int16)
    mb_rep_add = np.zeros((n, mb_h, mb_w), np.uint8)

    # per-frame scratch is worst-case sized (nblk * 64 entries) but
    # pooled; only the bucket-padded concatenation crosses the wire
    scratch = [[pool.acquire((nblk[c] * 64,), np.uint16)
                for c in range(n_comps)] for _ in range(n)]
    ns = [None] * n
    dirty = [False] * n

    def run(i):
        hdr, start_bit = group[i]
        ns[i], dirty[i] = native.parse_picture_compact(
            arr, start_bit, hdr, mb_w, mb_h, n_comps == 4,
            tuple(scratch[i]) + (None,) * (4 - n_comps),
            tuple(counts[c][i] for c in range(n_comps))
            + (None,) * (4 - n_comps),
            mb_quant[i], mb_intra[i], mb_mv[i], mb_rep_add[i],
            n_threads=1)

    batch = lane.submit(run, picture_bytes([sb for _, sb in group]))
    return CompactParse(batch=batch, counts=counts,
                        mb=dict(q=mb_quant, intra=mb_intra,
                                rep_add=mb_rep_add, mv=mb_mv),
                        scratch=scratch, ns=ns, dirty=dirty)


def parse_gop_compact(arr: np.ndarray, group: list, seq, meta,
                      pool: BufferPool, buckets: dict,
                      n_threads: int | None = None,
                      index: int = 0,
                      started: CompactParse | None = None) -> CompactGop:
    """Parse one GOP (GOP ``index`` of its stream) into the compact wire
    format.

    ``buckets`` maps component key -> sticky entry-capacity bucket; it is
    grown in place so successive GOPs keep stable shapes.  ``started`` is
    the GOP's parse already queued by :func:`start_gop_compact`; without
    it the parse is queued here, on a lane of ``n_threads``
    (:class:`~jsvx_torch.pipeline.parse_pool.Lane`).
    """
    if started is None:
        started = start_gop_compact(arr, group, seq, meta, pool,
                                    Lane(n_threads))
    started.batch.wait()
    n_comps = meta.n_components
    n = len(group)
    counts, scratch, ns = started.counts, started.scratch, started.ns

    hdrs = [hdr for hdr, _ in group]
    out = dict(
        is_p=np.array([0 if h.picture_type == 1 else 1 for h in hdrs],
                      np.int32),
        f_code=np.array([h.f_code for h in hdrs], np.int32),
    )
    out["mb"] = started.mb

    coef = {}
    pooled = []
    for c in range(n_comps):
        key = COMP_KEYS[c]
        total = sum(int(ns[i][c]) for i in range(n))
        bucket = max(buckets.get(key, 0), coef_bucket(total))
        buckets[key] = bucket
        wire = pool.acquire((bucket,), np.uint16)
        off = 0
        for i in range(n):
            cnt = int(ns[i][c])
            wire[off:off + cnt] = scratch[i][c][:cnt]
            off += cnt
        coef[key] = dict(cpk=wire, n=np.int32(total), counts=counts[c])
        pooled.append(wire)
    out["coef"] = coef
    # scratch is host-side only (already concatenated): recycle now; the
    # wire buffers in `pooled` recycle once the device copy is complete
    for row in scratch:
        for s in row:
            pool.release(s)
    return CompactGop(stacked=out, hdrs=hdrs, index=index, pooled=pooled,
                      dirty=any(started.dirty))


@dataclass
class PackedGop:
    """One GOP as dense stacked planes: ``stacked`` is the dict that goes
    to the device, ``fts`` the pictures' FrameTensors (views of its rows),
    ``pooled`` the pool buffers it holds."""

    stacked: dict
    fts: list
    index: int = 0
    pooled: list = field(default_factory=list)


def _mb_to_blocks(a: np.ndarray, comp: int) -> np.ndarray:
    """Per-MB grid (stacked on a leading axis, or one 2-D frame) -> the
    per-block grid of plane ``comp``."""
    if comp_is_chroma(comp):
        return a
    return np.repeat(np.repeat(a, 2, axis=-2 if a.ndim == 2 else 1),
                     2, axis=-1 if a.ndim == 2 else 2)


@dataclass
class PackedParse:
    """A GOP's dense parse queued on the parse pool
    (:func:`start_gop_packed`): the arrays its tasks fill;
    :func:`parse_gop_packed` waits for it and stacks them."""

    batch: Batch
    levels: list
    lnzs: list
    mb: tuple                    # (quant, intra, mv, rep_add)
    fts: list


def start_gop_packed(arr: np.ndarray, group: list, seq, meta,
                     pool: BufferPool, lane: Lane,
                     slice_threads: int = 1) -> PackedParse:
    """Allocate a GOP's dense parse and queue its pictures on ``lane``.

    Small per-MB arrays are zeroed; coefficient planes are NOT cleared:
    the dequantiser masks every position at or after a block's ``lnz``,
    coded blocks are fully written by the parser, and intra blocks (the
    only readers of the DC override) are always coded.
    """
    native = get_native_parser()
    n_comps = meta.n_components
    mb_h, mb_w = seq.mb_height, seq.mb_width
    ch, cw = seq.coded_height, seq.coded_width
    plane_shapes = [(ch, cw), (ch >> 1, cw >> 1), (ch >> 1, cw >> 1),
                    (ch, cw)][:n_comps]
    lnz_shapes = [(2 * mb_h, 2 * mb_w), (mb_h, mb_w), (mb_h, mb_w),
                  (2 * mb_h, 2 * mb_w)][:n_comps]

    n = len(group)
    levels = [pool.acquire((n,) + plane_shapes[c], np.int16)
              for c in range(n_comps)]
    lnzs = [np.zeros((n,) + lnz_shapes[c], np.uint8)
            for c in range(n_comps)]
    mb_quant = np.ones((n, mb_h, mb_w), np.uint8)
    mb_intra = np.zeros((n, mb_h, mb_w), np.uint8)
    mb_mv = np.zeros((n, mb_h, mb_w, 2), np.int16)
    mb_rep_add = np.zeros((n, mb_h, mb_w), np.uint8)
    fts = []
    for i, (hdr, _) in enumerate(group):
        fts.append(FrameTensors(
            picture_type=hdr.picture_type,
            temporal_ref=hdr.temporal_ref,
            full_pel=hdr.full_pel, f_code=hdr.f_code,
            gop_time_ms=hdr.gop_time_ms,
            levels=tuple(lv[i] for lv in levels),
            lnz=tuple(lz[i] for lz in lnzs),
            mb_quant=mb_quant[i], mb_intra=mb_intra[i],
            mb_mv=mb_mv[i], mb_rep_add=mb_rep_add[i]))

    def run(i):
        native.parse_picture_slices(arr, group[i][1], fts[i], mb_w, mb_h,
                                    None, n_threads=slice_threads)

    batch = lane.submit(run, picture_bytes([sb for _, sb in group]))
    return PackedParse(batch=batch, levels=levels, lnzs=lnzs,
                       mb=(mb_quant, mb_intra, mb_mv, mb_rep_add), fts=fts)


def parse_gop_packed(arr: np.ndarray, group: list, seq, meta,
                     pool: BufferPool | None = None,
                     n_threads: int | None = None,
                     slice_threads: int = 1, index: int = 0,
                     started: PackedParse | None = None) -> PackedGop:
    """Parse one GOP's pictures (GOP ``index`` of its stream) into
    freshly-acquired stacked arrays.

    ``started`` is the GOP's parse already queued by
    :func:`start_gop_packed`; without it the parse is queued here, on a
    lane of ``n_threads`` (:class:`~jsvx_torch.pipeline.parse_pool.Lane`).
    """
    if started is None:
        started = start_gop_packed(arr, group, seq, meta,
                                   pool or BufferPool(), Lane(n_threads),
                                   slice_threads)
    started.batch.wait()
    n_comps = meta.n_components
    levels, lnzs, fts = started.levels, started.lnzs, started.fts
    mb_quant, mb_intra, mb_mv, mb_rep_add = started.mb

    out = dict(
        is_p=np.array([0 if ft.is_intra_picture else 1 for ft in fts],
                      np.int32),
        f_code=np.array([ft.f_code for ft in fts], np.int32),
    )
    for c in range(n_comps):
        out[COMP_KEYS[c]] = dict(
            levels=levels[c],
            lnz=lnzs[c],
            q=np.ascontiguousarray(_mb_to_blocks(mb_quant, c)),
            intra=np.ascontiguousarray(_mb_to_blocks(mb_intra, c)),
            mv=np.ascontiguousarray(_mb_to_blocks(mb_mv, c)),
            rep_add=np.ascontiguousarray(_mb_to_blocks(mb_rep_add, c)),
        )
    return PackedGop(stacked=out, fts=fts, index=index, pooled=levels)


@dataclass
class PackedStream:
    meta: object
    seq: object
    gops: list                   # list[PackedGop]

    @property
    def n_frames(self) -> int:
        return sum(len(g.fts) for g in self.gops)


def parse_stream_packed(data: bytes, n_threads: int | None = None,
                        pool: BufferPool | None = None,
                        slice_threads: int = 1) -> PackedStream:
    """Parse a complete stream into stacked dense GOPs (the C++ parser).

    jsvx's function without the distinct-vector sideband: its
    ``mv_capacity=0``.  Each GOP's ``pooled`` buffers belong to ``pool``
    until the caller releases them.
    """
    data = bytes(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    meta, seq, groups = walk_stream(data)
    pool = pool or BufferPool()
    gops = [parse_gop_packed(arr, g, seq, meta, pool=pool,
                             n_threads=n_threads,
                             slice_threads=slice_threads, index=gi)
            for gi, g in enumerate(groups)]
    return PackedStream(meta=meta, seq=seq, gops=gops)
