"""Smoke run of the PyTorch / H100 port (``jsvx_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(the kernels are built for sm_90a with ``nvcc`` at first use).  Phases,
each printing its own lines:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. the build of ``jsvx_torch/csrc/`` into ``build/jsvx_torch/`` (with the
   ptxas register and spill report): the kernels' library and, at the
   same time, that of their first designs (``csrc/*_baseline.cu``: the
   picture kernels' one launch per plane, and the colour kernel's),
   which only this script loads;
3. each kernel against its plain PyTorch version on the same CUDA
   tensors, required bit-equal (0 differing pixels), and against its
   first design: the fused decode kernel, the MC kernel and the
   reconstruction kernel, one launch per picture each, the
   reconstruction also equal to the fused kernel's output; on every frame
   and plane of GOP 0 of the 1080p fixture, one frame with the
   oddify-zeros quirk, both GOPs of a 320x320 stream with 256 distinct
   motion vectors in one P frame, a 48x64 stream whose first GOP only the
   dense wire can carry, a CIF stream and a 4-plane YUVA stream; the MC
   kernel also on the tall-pad and out-of-bounds clamp cases of
   ``tests/test_fast_paths.py``, one plane and whole pictures; the compact
   wire's expansion kernel (one launch per GOP, and its one-component
   case) against its plain version on every compact GOP of the 1080p
   fixture, the 320x320, CIF and YUVA streams, 0 differing elements on
   every leaf; the colour kernel (one launch a frame) against its plain
   version on the card, against the CPU and against its first design
   (``csrc/color_baseline.cu``), 0 differing bytes: every
   (Y, Cb, Cr) triple (512x32768, without alpha, opaque and with an alpha
   plane; also within 1 LSB of ``refmath``), every frame of the 1080p
   fixture, the YUVA and CIF streams at its display crop (views), with
   its alpha plane where it has one and opaque, the fixture's also at a
   1920x1080 crop, and odd crops;
4. the paths end to end on the card, each kernel counted (and no plain
   expansion of the compact wire on any of them):
   ``jsvx_torch.transcode`` of the 1080p fixture (the fused kernel once
   per picture, the expansion kernel once per GOP), bit-equal to the same
   call on the CPU;
   ``StreamDecoder(...).decode(impl="two_kernel")`` (the MC and
   reconstruction kernels once per picture each, no torch sideband
   expansion), bit-equal to the CPU and to ``impl="fused"`` on the card;
   the same three checks for
   ``transcode`` with the quirk, with ``impl="two_kernel"`` and on a
   stream whose GOP falls back to the dense wire; CIF and YUVA streams
   through both routes within 1 LSB of the float64 oracle;
   playback: the streaming ``Decoder`` (GOP batch and picture by
   picture; the fused kernel once per picture in each) bit-equal to
   ``StreamDecoder`` on the card and to the CPU, with a seek and with the
   quirk; the ``Player`` with RGB output driven to ``ended`` by a virtual
   clock (the colour kernel once per frame shown, its plain version
   never), its RGB contiguous, of display size, bit-equal to the CPU's
   and to the plain version of the coded frame cropped, and within 1 LSB
   of ``refmath``;
   the YUVA stream's alpha through the Player, the 256-vector stream
   through the Decoder, and ``python -m jsvx_torch play`` in a subprocess;
5. timings (CUDA events, median of 30 after warm-up; host clock for the
   end-to-end runs), each with the card's name and power limit (the
   resident GOP timed on the eager loop, ``transcode`` on the GOP
   programs but for its A/B with the plain expansion): each
   kernel per 1080p picture, warm in L2 and with L2 flushed between
   calls, in turns with its first design, beside the bytes it must move
   and its bound; the expansion kernel per 1080p GOP, warm and cold, in
   turns with its plain version, beside its bytes and bound; the GOP
   decode of both routes (the fused route also with the plain expansion,
   the two-kernel route also with its first designs and the torch
   sideband expansion), ``transcode`` in turns with the same loop on the
   plain expansion,
   ``transcode``, ``StreamDecoder``, the Decoder, the Player (the
   colour kernel once per frame in every run); the colour kernel per
   1080p frame at a 1920x1080 display crop (views) and at the coded
   size, warm and cold, in turns with its first design and its plain
   version, beside its bytes, its bound and both kernels' ptxas
   report;
6. row-band and GOP sharding (``jsvx_torch.shard``): a (gop 1, rows 1)
   mesh without a process group over both GOPs of the 1080p fixture; the
   MC and reconstruction launches of a P picture in four row bands, on
   the fixture and on the synthetic f_code 6 GOP (halo 272: the
   all-gather's regime), each band held bit-equal to the kernels' plain
   versions on its extended planes and to the whole picture's launch
   (the fixture's then timed); four gloo ranks on this card, each: the
   fixture's GOP 0 in four bands (MC and reconstruction once per picture,
   no torch sideband expansion), gathered bit-equal to the plain decode
   (the kernels' plain versions, torch ops on the card), both GOPs on a
   (gop 2, rows 2) mesh, in bands and through ``decode_gops_parallel``
   (the fused kernel once per picture), the synthetic f_code 6 GOP
   through the all-gather, each bit-equal to the plain decode, the
   exchange per plane and the banded GOP's wall time (host clock); the
   same in one NCCL rank; ``tools/bench_scaling.py`` with two processes
   on the card;
7. the pipelined ``transcode`` (parse of GOP g+1 while GOP g decodes, the
   wire copied from pinned memory on a copy stream, delivery one GOP
   behind), each route, the quirk, the dirty stream and the fixture's
   GOPs repeated to 8: bit-equal to the CPU and to ``StreamDecoder`` on
   the card, one launch per picture per kernel and one expansion launch
   per compact GOP, the sink's planes kept on
   the card and intact after the run, every pooled buffer pinned, no
   sync warning (``torch.cuda.set_sync_debug_mode``) after GOP 0's
   dispatch outside the deliberate waits, the stage split per GOP; its
   frames/s with a sink that keeps the planes and one that copies them;
   ``probe_expand``'s gauge beside phase 5's expansion time; ``python -m
   jsvx_torch bench --trace`` (both routes) on the 8-GOP stream, whose
   GOPs are mostly replays of a GOP program: its traces hold one event of
   each kernel per launch; ``warm`` on the fixture and ``warm --shape
   1920x1088`` (jsvx's synthesised warm stream): each captures programs,
   its second run none; ``tools/bench_mc.py`` (the MC kernel
   against its plain version at up to 300 distinct vectors); the fixture
   truncated and bit-flipped through the Decoder and ``transcode``, the
   card's outcome and frames equal to the CPU's;
8. the GOP programs (``jsvx_torch.pipeline.program``: a CUDA graph per
   wire layout, replayed once per GOP): on every stream above (the
   fixture, the dirty, YUVA, CIF, 320x320 and 8-GOP streams, the quirk,
   the truncated and bit-flipped copies, and a stream whose GOP lengths
   vary, cut from the fixture's GOPs) and both routes, ``transcode``
   on a cold cache, again and on the eager loop (the same uploads, no
   graph): the same outcome, 0 differing pixels, captures = distinct
   keys, replays = GOPs minus first sights and then every GOP, the launch
   counters equal; the 8-GOP stream on a cold cache watched as in phase 7
   (no sync warning after GOP 0, captures included); two threads at
   once; the bytes the cache holds; ``device_dispatch`` per GOP and the
   resident GOP with the host in the loop, graph against eager in turns
   (min, quartiles, max), each with its device time; ``device_dispatch``
   per GOP where first sights dominate (the varied stream, the fixture,
   the damaged copies): on a cold cache, on the cache it left, and
   eager, in turns;
9. the GOP programs on the other GOP paths (``decode_group``'s, with the
   reference planes as inputs, and ``decode_gops_parallel``'s): on the
   fixture, the fixture with the quirk, the YUVA, CIF and dirty streams,
   through ``StreamDecoder`` (GOP scan and per picture, both routes),
   the Decoder (GOP batch and picture by picture), the Player with RGB
   and ``decode_gops_parallel`` on a mesh of one rank, each on a cold
   cache, again and on the eager loop: the same outcome, 0 differing
   pixels among them and against the CPU, captures = distinct keys,
   replays = units minus first sights, then every unit, the launch
   counters equal, the bytes the cache holds; what each kind of program
   holds at 1080p; each path of the fixture on the programs against the
   eager loop in turns (frames/s and ``device_decode`` per GOP or
   picture, min, quartiles and max).  Phase 6's ranks also hold their
   ``decode_gops_parallel`` share's program (a capture, then a replay)
   to the eager loop;
10. each GOP with its own sequence header's quant matrices, and the
   driver entry points (``jsvx_torch.graft_entry``): a rendition-switch
   stream (``tools/fixture.switch_stream``: GOP 0 with the default
   matrices, GOP 1 with others; with and without a key map) through
   ``transcode`` (both routes, compact and quirk), ``StreamDecoder``
   (scan and per picture, both routes), the Decoder (GOP batch and
   picture by picture, and after a seek into GOP 1) and the Player with
   RGB, each on a cold program cache: per GOP within 1 LSB of the
   float64 oracle, bit-equal to the CPU, the kernels counted, captures =
   the distinct (layout, matrices) keys, two sets of matrices among them;
   ``entry()`` on the card, one fused launch, bit-equal to its plain
   version and to the CPU (also from random reference planes);
   ``dryrun_multichip(8)``, 8 gloo ranks sharing this card on a (gop 2,
   rows 4) mesh at 1088x256: its own checks, the MC and reconstruction
   kernels once per picture in each rank, the halo's route and the
   call's wall seconds.

Since phase 9's paths run on their programs, so do phase 4's
``StreamDecoder``, Decoder and Player checks and phase 5's timings of
them (phase 5's first designs run on the eager loop).

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises (non-zero
exit, no result line); without a CUDA card it exits non-zero at once.
Nothing of JAX, of the ``jsvx`` package or of ``bench.py`` is imported:
the port's own encoder, oracle and fixture make and check the streams.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from jsvx_torch import graft_entry
from jsvx_torch.api import Decoder, Player, PlayerConfig
from jsvx_torch.bitstream.bitio import BitReader
from jsvx_torch.bitstream.container import parse_container_header
from jsvx_torch.coding.tables import START_PICTURE, START_SEQUENCE
from jsvx_torch.kernels import (build, color, counters, expand, fused, mc,
                               recon)
from jsvx_torch.kernels.color import ycbcr_to_rgb, ycbcr_to_rgb_plain
from jsvx_torch.kernels.decode import (comp_is_chroma, decode_frame_plane,
                                       decode_frame_planes, frame_comp_keys,
                                       frame_to_device, make_constants,
                                       predict_plane)
from jsvx_torch.kernels.expand import expand_compact_gop
from jsvx_torch.pipeline import gop as gop_module
from jsvx_torch.pipeline import packed_parse, program
from jsvx_torch.pipeline.gop import (FRAME_DECODERS, decode_gop,
                                     decode_gop_wire, frame_at, zero_refs)
from jsvx_torch.pipeline.packed_parse import (BufferPool, parse_gop_compact,
                                              parse_gop_packed, walk_stream)
from jsvx_torch.pipeline.program import program_key
from jsvx_torch.pipeline.stream import StreamDecoder
from jsvx_torch.pipeline.transcode import transcode
from jsvx_torch.pipeline.wire import flatten_wire, unflatten_wire, wire_spec
from jsvx_torch.runtime.profiler import TRACE_FILE, Metrics, StageTimer
from jsvx_torch.shard import (build_mesh, decode_gop_rows_sharded,
                              decode_gops_2d_sharded, decode_gops_parallel,
                              gather_row_halo, gather_rows, slice_rows)
from jsvx_torch.shard.launch import run_ranks
from jsvx_torch.tools import (EncoderConfig, JsvEncoder, bench_mc,
                              decode_stream_oracle, psnr)
from jsvx_torch.tools.fixture import ensure_fixture, switch_stream, zoom_clip
from jsvx_torch.tools.refmath import ycbcr_to_rgb as ref_rgb
from jsvx_torch.tools.synthetic import (TRIPLES_LUMA, colour_triples,
                                        synthetic_gop)

KERNEL_SOURCE = "jsvx_torch/csrc/fused_decode.cu"
KERNEL_REPLACES = "jsvx/kernels/pallas_fused.py:51"
MC_SOURCE = "jsvx_torch/csrc/mc.cu"
MC_REPLACES = "jsvx/kernels/pallas_mc.py:35"
RECON_SOURCE = "jsvx_torch/csrc/recon.cu"
RECON_REPLACES = "jsvx/kernels/pallas_decode.py:78"
EXPAND_SOURCE = "jsvx_torch/csrc/expand.cu"
EXPAND_REPLACES = "jsvx/kernels/expand.py:49"
COLOUR_SOURCE = "jsvx_torch/csrc/color.cu"
COLOUR_REPLACES = "jsvx/kernels/color.py:21"
N_TIMED = 30
N_E2E = 10
SLEEP_MS = 25.0
#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 FLOP/s outside
#: the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: f32 operations per pixel of the IDCT (two passes of 8 multiplies and 7
#: adds) and the prediction add
FLOP_PER_CODED_PIXEL = 31
#: f32 operations per pixel of the colour conversion: per channel three
#: multiplies and three adds, the multiply by 255, the rounding and two
#: clamps (the scaling, one division per sample, is counted apart)
COLOUR_FLOP_PER_PIXEL = 30
#: bytes written between two calls of a cold timing: past the 50 MB L2
FLUSH_BYTES = 64 << 20
#: a 1920x1080 stream's display crop of its 1920x1088 coded planes (the
#: fixture itself is coded and shown at 1920x1088)
CROP_1080 = (1080, 1920)
NO_LIBRARY = ("no PyTorch call computes it: F.grid_sample does not round "
              "the half-pel taps as MPEG-1 does, and a matmul IDCT sums in "
              "its own order, possibly in TF32")


#: the script's start, for the seconds each line carries
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T0}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


# ---------------------------------------------------------------------------
# Streams

def yuva_clip(n: int, h: int, w: int) -> list:
    """The fixture's zooming pattern plus a moving alpha plane."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t, (y, cb, cr) in enumerate(zoom_clip(h, w, n, seed=5)):
        a = np.clip(128 + 80 * np.sin(2 * np.pi * (xx + 5 * t) / w)
                    + 40 * (yy > 4 * t), 0, 255).astype(np.uint8)
        out.append((y, cb, cr, a))
    return out


def high_motion_stream() -> bytes:
    """20x20 macroblocks, GOP 2: the first P frame moves its interior by
    (2, 2), the second carries 256 distinct vectors (the stream of
    tests/test_high_motion.py, on the fixture's pattern)."""
    mbs = 20
    enc = JsvEncoder(mbs * 16, mbs * 16, EncoderConfig(
        gop_size=2, quantizer_scale=8, f_code=3, intra_sad_threshold=1e9,
        key_map=True))
    calls = []

    def forced(y, ref_y):
        mv = np.zeros((mbs, mbs, 2), np.int64)
        if not calls:
            mv[2:18, 2:18] = (2, 2)
        else:
            idx = np.arange(256)
            mv[2:18, 2:18, 0] = (2 * (idx // 16 - 8)).reshape(16, 16)
            mv[2:18, 2:18, 1] = (2 * (idx % 16 - 8)).reshape(16, 16)
        calls.append(1)
        return mv

    enc._motion_search = forced
    return enc.encode(zoom_clip(mbs * 16, mbs * 16, 4, seed=11))


def dirty_stream() -> bytes:
    """Three 48x64 frames whose first picture carries its first slice
    twice: overlapping slices, a GOP the compact wire cannot express (the
    stream of tests/test_compact_wire.py, on the fixture's pattern)."""
    raw = JsvEncoder(64, 48, EncoderConfig(gop_size=3, quantizer_scale=4)) \
        .encode(zoom_clip(48, 64, 3, seed=13))
    pic = raw.find(b"\x00\x00\x01\x00")
    s0 = raw.find(b"\x00\x00\x01\x01", pic)
    check(pic >= 0 and s0 > 0, "no first slice found")
    nxt = s0 + 4
    while True:
        n = raw.find(b"\x00\x00\x01", nxt)
        check(n > 0, "no start code after the first slice")
        if 0x01 <= raw[n + 3] <= 0xAF or raw[n + 3] in (0x00, 0xB8):
            break
        nxt = n + 4
    data = raw[:n] + raw[s0:n] + raw[n:]
    meta, seq, groups = walk_stream(data)
    g = parse_gop_compact(np.frombuffer(data, np.uint8), groups[0], seq,
                          meta, BufferPool(), {})
    check(g.dirty, "the duplicated slice did not make GOP 0 dirty")
    return data


def gop_on_card(data: bytes, gi: int, device):
    """GOP ``gi`` on ``device`` as the decode takes it: parsed to the
    compact wire and expanded, or, for a GOP only the dense wire can
    carry, parsed to the dense wire.  Returns (meta, seq, the parsed GOP,
    the wire on the card, its spec, the stacked dense GOP)."""
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    g = parse_gop_compact(arr, groups[gi], seq, meta, BufferPool(), {})
    if g.dirty:
        g = parse_gop_packed(arr, groups[gi], seq, meta)
    spec = wire_spec(g.stacked)
    wire = torch.from_numpy(flatten_wire(g.stacked, spec)).to(device)
    dense = unflatten_wire(wire, spec)
    if "coef" in dense:
        dense = expand_compact_gop(dense, seq.mb_height, seq.mb_width)
    return meta, seq, g, wire, spec, dense


# ---------------------------------------------------------------------------
# Phase 3: kernel vs plain

def baseline_plane(c: dict, ref: torch.Tensor, is_p: torch.Tensor, consts,
                   chroma: bool, quirk: bool = False,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """One plane through the fused kernel's first design
    (``csrc/fused_decode_baseline.cu``), which nothing else launches."""
    h, w = ref.shape
    out = torch.empty_like(ref) if out is None else out
    rc = build.load("baselines").lib.jsvx_fused_decode_plane_baseline(
        c["levels"].data_ptr(), c["lnz"].data_ptr(), c["q"].data_ptr(),
        c["intra"].data_ptr(), c["mv"].data_ptr(), c["rep_add"].data_ptr(),
        ref.data_ptr(), is_p.data_ptr(), consts.qtab.data_ptr(),
        consts.c_basis.data_ptr(), out.data_ptr(), h, w, int(chroma),
        int(quirk), ref.device.index or 0,
        torch.cuda.current_stream(ref.device).cuda_stream)
    check(rc == 0, f"baseline fused kernel launch failed: cudaError_t {rc}")
    return out


def mc_first_design(ref: torch.Tensor, mv: torch.Tensor,
                    rep_add: torch.Tensor, chroma: bool,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One plane through the MC kernel's first design
    (``csrc/mc_baseline.cu``), which nothing else launches."""
    h, w = ref.shape
    out = (torch.empty((h, w), dtype=torch.int16, device=ref.device)
           if out is None else out)
    rc = build.load("baselines").lib.jsvx_mc_plane_baseline(
        ref.data_ptr(), mv.data_ptr(), rep_add.data_ptr(), out.data_ptr(),
        h, w, int(chroma), ref.device.index or 0,
        torch.cuda.current_stream(ref.device).cuda_stream)
    check(rc == 0, f"first-design MC launch failed: cudaError_t {rc}")
    return out


def recon_first_design(levels: torch.Tensor, mult: torch.Tensor,
                       flags: torch.Tensor, pred: torch.Tensor,
                       is_p: torch.Tensor, consts, quirk: bool = False,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """One plane through the reconstruction kernel's first design
    (``csrc/recon_baseline.cu``), which nothing else launches.  It takes
    the per-pixel sideband (``mult``/``flags``, from
    :func:`recon.expand_sideband`), as jsvx's ``_recon_kernel`` does."""
    h, w = levels.shape
    out = (torch.empty((h, w), dtype=torch.uint8, device=levels.device)
           if out is None else out)
    rc = build.load("baselines").lib.jsvx_recon_plane_baseline(
        levels.data_ptr(), mult.data_ptr(), flags.data_ptr(),
        pred.data_ptr(), is_p.data_ptr(), consts.c_basis.data_ptr(),
        out.data_ptr(), h, w, int(quirk), levels.device.index or 0,
        torch.cuda.current_stream(levels.device).cuda_stream)
    check(rc == 0, f"first-design recon launch failed: cudaError_t {rc}")
    return out


def colour_first_design(y: torch.Tensor, cb: torch.Tensor,
                        cr: torch.Tensor, alpha) -> torch.Tensor:
    """One frame through the colour kernel's first design
    (``csrc/color_baseline.cu``), which nothing else launches: the
    arguments and output of ``ycbcr_to_rgb`` on uint8 planes on a card,
    not counted."""
    a = None if isinstance(alpha, bool) else alpha
    mode = (color.NO_ALPHA if alpha is False else
            color.OPAQUE if alpha is True else color.ALPHA_PLANE)
    planes = [color._rows(p) for p in (y, cb, cr)] + (
        [color._rows(a)] if a is not None else [])
    h, w = y.shape
    out = torch.empty((h, w, 3 if mode == color.NO_ALPHA else 4),
                      dtype=torch.uint8, device=y.device)
    ptrs = [p.data_ptr() for p in planes] + [None] * (4 - len(planes))
    strides = [p.stride(0) for p in planes] + [0] * (4 - len(planes))
    rc = build.load("baselines").lib.jsvx_colour_frame_baseline(
        (ctypes.c_void_p * 4)(*ptrs), (ctypes.c_longlong * 4)(*strides),
        h, w, mode, color._COEFFS.ctypes.data, out.data_ptr(),
        y.device.index or 0, torch.cuda.current_stream(y.device).cuda_stream)
    check(rc == 0, f"first-design colour launch failed: cudaError_t {rc}")
    return out


def ptxas_report(log: str, fragment: str) -> list:
    """Registers, shared memory and spills of each kernel whose (mangled)
    name holds ``fragment``, from a library's ``-Xptxas -v`` log."""
    out, cur, spill = [], None, (None, None)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1) if fragment in m.group(1) else None
            spill = (None, None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(dict(function=cur, registers=int(m.group(1)),
                            static_smem_bytes=int(smem.group(1)) if smem
                            else 0, spill_store_bytes=spill[0],
                            spill_load_bytes=spill[1]))
            cur = None
    return out


def first_design_frame(frame: dict, refs: tuple, consts,
                       quirk: bool = False, outs: tuple | None = None
                       ) -> tuple:
    """The two-kernel route with the first designs, for timing: per plane
    the torch sideband expansion and one launch of each first-design
    kernel; registered as ``impl="two_kernel_first_design"`` by
    :func:`first_design_route`."""
    planes = []
    for ci, key in enumerate(frame_comp_keys(frame)):
        c = frame[key]
        mult, flags = recon.expand_sideband(c, consts)
        pred = mc_first_design(refs[ci], c["mv"], c["rep_add"],
                               comp_is_chroma(ci))
        planes.append(recon_first_design(
            c["levels"], mult, flags, pred, frame["is_p"], consts, quirk,
            None if outs is None else outs[ci]))
    return tuple(planes)


@contextlib.contextmanager
def first_design_route():
    """``impl="two_kernel_first_design"`` (:func:`first_design_frame`)
    registered in the GOP loop's routes inside the block, for the timings
    of the route with its first designs, and removed after it, whatever
    happens."""
    FRAME_DECODERS["two_kernel_first_design"] = first_design_frame
    try:
        yield
    finally:
        del FRAME_DECODERS["two_kernel_first_design"]


def kernels_vs_plain(label: str, data: bytes, gi: int, device,
                     quirk_frames=()) -> dict:
    """Every frame and plane of GOP ``gi`` through each kernel and its
    plain version on the same CUDA tensors: the fused decode kernel (one
    launch for the picture), against the plain version and against its
    first design plane by plane; the two-kernel route's MC kernel (one
    launch for the picture) against its plain version and its first
    design; its reconstruction kernel (one launch for the picture)
    against its plain version and its first design (on the expanded
    sideband), and equal to the fused kernel's output.  The fused
    kernel's output carries as the next frame's reference.  Returns the
    max |kernel - plain| of each kernel."""
    meta, seq, _, _, _, dense = gop_on_card(data, gi, device)
    n_frames = int(dense["is_p"].shape[0])
    consts = make_constants(seq, device)
    refs = zero_refs(seq.coded_height, seq.coded_width, meta.n_components,
                     device)
    worst = {"fused": 0, "mc": 0, "recon": 0}
    for i in range(n_frames):
        frame = frame_at(dense, i)
        is_p = frame["is_p"]
        for quirk in sorted({False, i in quirk_frames}):
            before = (fused.launches, mc.launches, recon.launches)
            picture = fused.decode_frame_planes_fused(frame, refs, consts,
                                                      quirk)
            preds = mc.predict_picture_mc(frame, refs)
            rk = recon.recon_picture(frame, preds, is_p, consts, quirk)
            after = (fused.launches, mc.launches, recon.launches)
            check(tuple(a - b for a, b in zip(after, before)) == (1, 1, 1),
                  f"{label}: launches {before} -> {after} for one picture "
                  f"(fused, MC, recon)")
            for ci, key in enumerate(frame_comp_keys(frame)):
                c, chroma, fk = frame[key], comp_is_chroma(ci), picture[ci]
                pk = preds[ci]
                fp = decode_frame_plane(c, refs[ci], is_p, consts, chroma,
                                        quirk)
                fb = baseline_plane(c, refs[ci], is_p, consts, chroma, quirk)
                pp = predict_plane(refs[ci], c["mv"], c["rep_add"],
                                   chroma).to(torch.int16)
                pb = mc_first_design(refs[ci], c["mv"], c["rep_add"], chroma)
                rp = recon.recon_plane_blocks(c, pp, is_p, consts, quirk)
                rb = recon_first_design(c["levels"],
                                        *recon.expand_sideband(c, consts),
                                        pk, is_p, consts, quirk)
                sync(device)
                n_diff = {name: int((k != p).sum()) for name, k, p in (
                    ("fused", fk, fp), ("baseline", fk, fb), ("mc", pk, pp),
                    ("mc_first_design", pk, pb), ("recon", rk[ci], rp),
                    ("recon_first_design", rk[ci], rb),
                    ("route", rk[ci], fk))}
                err = {name: int((k.int() - p.int()).abs().max())
                       for name, k, p in (("fused", fk, fp), ("mc", pk, pp),
                                          ("recon", rk[ci], rp))}
                where = dict(stream=label, gop=gi, frame=i, plane=key,
                             quirk=quirk, shape=list(fk.shape),
                             is_p=int(is_p))
                emit("kernel_vs_plain", **where,
                     mismatching_pixels=n_diff["fused"],
                     vs_first_design_mismatching_pixels=n_diff["baseline"],
                     max_abs_err=err["fused"])
                emit("two_kernel_vs_plain", **where,
                     mc_mismatching_pixels=n_diff["mc"],
                     mc_vs_first_design_mismatching_pixels=n_diff[
                         "mc_first_design"],
                     mc_max_abs_err=err["mc"],
                     recon_mismatching_pixels=n_diff["recon"],
                     recon_vs_first_design_mismatching_pixels=n_diff[
                         "recon_first_design"],
                     recon_max_abs_err=err["recon"],
                     vs_fused_kernel_mismatching_pixels=n_diff["route"])
                check(not any(n_diff.values()),
                      f"{label} frame {i} plane {key} quirk={quirk}: "
                      f"pixels differ {n_diff}")
                worst = {k: max(v, err[k]) for k, v in worst.items()}
            if not quirk:
                decoded = picture
        refs = decoded
    return worst


def expand_vs_plain(label: str, data: bytes, device) -> int:
    """Every GOP of ``data`` that the compact wire carries, on the card:
    the expansion kernel (one launch for the GOP) against its plain
    version on the same wire, and each component's one-component launch
    (``expand_levels``) against the plain levels; every leaf of the same
    dtype and shape and 0 differing elements.  Returns the max |kernel -
    plain| over the leaves."""
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    mb_h, mb_w = seq.mb_height, seq.mb_width
    worst, n_compact = 0, 0
    for gi, group in enumerate(groups):
        g = parse_gop_compact(arr, group, seq, meta, BufferPool(), {})
        if g.dirty:
            continue
        n_compact += 1
        spec = wire_spec(g.stacked)
        tree = unflatten_wire(torch.from_numpy(
            flatten_wire(g.stacked, spec)).to(device), spec)
        before = expand.launches
        got = expand.expand_compact_gop(tree, mb_h, mb_w)
        check(expand.launches == before + 1, f"{label} GOP {gi}: "
                                             f"{expand.launches - before} "
                                             f"expansion launches")
        want = expand.expand_compact_gop_plain(tree, mb_h, mb_w)
        levels = {k: expand.expand_levels(c["cpk"], c["n"], c["counts"],
                                          mb_h, mb_w, k in ("y", "a"))
                  for k, c in tree["coef"].items()}
        sync(device)
        pairs = [((k, f), got[k][f], want[k][f]) for k in tree["coef"]
                 for f in got[k]]
        pairs += [((k, "levels_one_component"), v, want[k]["levels"])
                  for k, v in levels.items()]
        check(set(got) == set(want) and all(
            set(got[k]) == set(want[k]) for k in tree["coef"]),
              f"{label} GOP {gi}: keys differ")
        n_diff, err = {}, 0
        for (k, f), a, b in pairs:
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"{label} GOP {gi} {k}.{f}: {a.dtype} {tuple(a.shape)} "
                  f"vs {b.dtype} {tuple(b.shape)}")
            n_diff[f"{k}.{f}"] = int((a != b).sum())
            if a.numel():
                err = max(err, int((a.int() - b.int()).abs().max()))
        emit("expand_vs_plain", stream=label, gop=gi,
             frames=int(tree["is_p"].shape[0]),
             components=list(tree["coef"]),
             entries={k: int(c["n"].cpu()) for k, c in tree["coef"].items()},
             mismatching_elements=sum(n_diff.values()),
             leaves=len(n_diff), max_abs_err=err)
        check(not any(n_diff.values()),
              f"{label} GOP {gi}: elements differ {n_diff}")
        worst = max(worst, err)
    check(n_compact > 0 or label.endswith("dirty"),
          f"{label}: no GOP on the compact wire")
    return worst


def mc_edge_cases(device) -> int:
    """The MC kernel vs its plain version and its first design on the
    cases of tests/test_fast_paths.py: a 24x128 plane with vectors (141,
    3) and (-140, -95) (the tall-pad case), and a 32x32 plane with vectors
    pointing out of the picture (the clamp case); luma and chroma, each
    as a one-plane launch and as planes of one picture launch (the plane
    as Y, Cb and Cr: one luma and two chroma predictions)."""
    rng = np.random.default_rng(1234)
    worst = 0
    for case, (h, w), vectors in (
            ("tall_pad", (24, 128), [[0, 0], [141, 3], [-140, -95]]),
            ("clamp", (32, 32), [[0, 0], [-13, -9], [15, 21]])):
        ref = torch.from_numpy(rng.integers(0, 256, (h, w))
                               .astype(np.uint8)).to(device)
        idx = rng.integers(0, len(vectors), (h // 8, w // 8))
        mv = torch.from_numpy(np.array(vectors, np.int16)[idx]).to(device)
        rep = torch.from_numpy((rng.random((h // 8, w // 8)) < 0.2)
                               .astype(np.uint8)).to(device)
        before = mc.launches
        picture = mc.predict_picture_mc(
            {k: {"mv": mv, "rep_add": rep} for k in ("y", "cb", "cr")},
            (ref, ref, ref))
        check(mc.launches == before + 1, f"MC {case}: picture launches")
        for chroma in (False, True):
            k = mc.predict_plane_mc(ref, mv, rep, chroma)
            p = predict_plane(ref, mv, rep, chroma).to(torch.int16)
            b = mc_first_design(ref, mv, rep, chroma)
            sync(device)
            n_diff = int((k != p).sum())
            n_pic = sum(int((q != p).sum())
                        for q in (picture[1:] if chroma else picture[:1]))
            n_first = int((k != b).sum())
            err = int((k.int() - p.int()).abs().max())
            emit("mc_edge_case", case=case, shape=[h, w], chroma=chroma,
                 mismatching_pixels=n_diff,
                 picture_launch_mismatching_pixels=n_pic,
                 vs_first_design_mismatching_pixels=n_first,
                 max_abs_err=err)
            check(n_diff == n_pic == n_first == 0,
                  f"MC {case} chroma={chroma}: {n_diff} pixels differ "
                  f"between kernel and plain, {n_pic} in the picture "
                  f"launch, {n_first} from the first design")
            worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the slice

def display_crop(planes, h: int, w: int) -> tuple:
    """Views of a frame's planes cropped to ``h`` x ``w`` (the chroma to
    ceil(h/2) x ceil(w/2)), as the Player's ``_to_rgb`` cuts them."""
    hc, wc = -(-h // 2), -(-w // 2)
    return (planes[0][:h, :w], planes[1][:hc, :wc], planes[2][:hc, :wc],
            *(a[:h, :w] for a in planes[3:]))


def colour_cases(streams: dict, dev) -> list:
    """(label, Y, Cb, Cr, alpha) on the card for the colour kernel: every
    (Y, Cb, Cr) triple (``tools/synthetic.colour_triples``: 512x32768)
    without alpha, opaque and with a random alpha plane; every frame of
    each stream in ``streams`` (label -> bytes) at its display crop
    (views of the decoded planes), without alpha and opaque, and with its
    alpha plane where it has one, and the 1080p frames also at CROP_1080;
    odd crops of each stream's first frame."""
    tri = [torch.from_numpy(p).to(dev) for p in colour_triples()]
    rand_a = torch.from_numpy(np.random.default_rng(12).integers(
        0, 256, tri[0].shape).astype(np.uint8)).to(dev)
    cases = [("triples", *tri, m) for m in (False, True, rand_a)]
    for label, data in streams.items():
        meta, _, _ = walk_stream(data)
        frames = [[torch.from_numpy(p).to(dev) for p in f]
                  for f in stream_frames(data, dev, "fused")]
        for i, f in enumerate(frames):
            v = display_crop(f, meta.height, meta.width)
            for m in (False, True) + tuple(v[3:]):
                cases.append((f"{label}#{i}", *v[:3], m))
            if f[0].shape[0] > CROP_1080[0]:
                cases.append((f"{label}#{i} {CROP_1080}",
                              *display_crop(f, *CROP_1080)[:3], False))
        f = frames[0]
        for h, w in ((f[0].shape[0] - 1, f[0].shape[1] - 3), (1, 1),
                     (37, 5)):
            v = display_crop(f, h, w)
            cases.append((f"{label}#0 {h}x{w}", *v[:3], v[3] if len(v) > 3
                          else True))
    return cases


def colour_vs_plain(streams: dict, dev) -> int:
    """The colour kernel (one launch a call) against its plain version on
    the same card tensors, against the CPU and against its first design
    (``csrc/color_baseline.cu``), on :func:`colour_cases`: 0 differing
    bytes required, contiguous (h, w, 3|4) output; on every triple also
    within 1 LSB of ``refmath.ycbcr_to_rgb``.  Returns the largest
    difference from the plain version."""
    cases = colour_cases(streams, dev)
    worst = d_plain = d_cpu = d_first = worst_ref = 0
    before = color.launches
    for label, y, cb, cr, m in cases:
        got = ycbcr_to_rgb(y, cb, cr, m)
        want = ycbcr_to_rgb_plain(y, cb, cr, m)
        first = colour_first_design(y, cb, cr, m)
        cpu = ycbcr_to_rgb(*(p.cpu() for p in (y, cb, cr)),
                           m if isinstance(m, bool) else m.cpu())
        sync(dev)
        check(got.is_contiguous() and tuple(got.shape) == (
            *y.shape, 3 if m is False else 4), f"colour {label}: output "
            f"{tuple(got.shape)}, contiguous {got.is_contiguous()}")
        worst = max(worst, int((got.int() - want.int()).abs().max()))
        d_plain += int((got != want).sum())
        d_first += int((got != first).sum())
        d_cpu += int((got.cpu() != cpu).sum())
        if label == "triples" and m is False:
            worst_ref = int(np.abs(got.cpu().numpy().astype(int) - ref_rgb(
                *(p.cpu().numpy() for p in (y, cb, cr))).astype(int)).max())
    n = color.launches - before
    emit("colour_vs_plain", cases=len(cases), launches=n,
         values=sum(y.numel() * (3 if m is False else 4)
                    for _, y, _, _, m in cases),
         triples_values=3 * TRIPLES_LUMA[0] * TRIPLES_LUMA[1],
         vs_plain_differing_bytes=d_plain, vs_plain_max_abs_err=worst,
         vs_cpu_differing_bytes=d_cpu,
         vs_first_design_differing_bytes=d_first,
         triples_vs_refmath_max=worst_ref, streams=list(streams))
    check(n == len(cases), f"colour: {n} launches for {len(cases)} calls")
    check(d_plain == 0 and d_cpu == 0 and d_first == 0,
          f"colour kernel differs from its plain version in {d_plain} "
          f"bytes, from the CPU in {d_cpu}, from its first design in "
          f"{d_first}")
    check(worst_ref <= 1, f"colour: {worst_ref} LSB from refmath")
    return worst


def collect(data: bytes, device, impl: str = "fused",
            quirk: bool = False,
            metrics: Metrics | None = None) -> tuple[list, object]:
    got = {}
    res = transcode(data, lambda gi, outs: got.__setitem__(
        gi, [o.cpu() for o in outs]), device=device, impl=impl,
        quirk_oddify_zeros=quirk, metrics=metrics)
    frames = [tuple(s[i].numpy() for s in got[g]) for g in sorted(got)
              for i in range(got[g][0].shape[0])]
    return frames, res


def check_vs_oracle(label: str, data: bytes, device,
                    impl: str = "fused") -> float:
    frames, res = collect(data, device, impl)
    oracle = decode_stream_oracle(data)
    check(len(frames) == len(oracle) == res.n_frames,
          f"{label}: {len(frames)} frames, oracle {len(oracle)}")
    worst, min_psnr = 0, float("inf")
    for f, o in zip(frames, oracle):
        check(len(f) == len(o.planes), f"{label}: plane count")
        for p, q in zip(f, o.planes):
            worst = max(worst, int(np.abs(p.astype(int)
                                          - q.astype(int)).max()))
            min_psnr = min(min_psnr, psnr(p, q))
    emit("oracle", stream=label, impl=impl, frames=len(frames),
         planes=len(frames[0]), max_abs_err_vs_oracle=worst,
         min_psnr_db=min_psnr)
    check(worst <= 1, f"{label}: {worst} LSB from the oracle")
    return min_psnr


def stream_frames(data: bytes, device, impl: str) -> list:
    """Every frame through ``StreamDecoder``."""
    res = StreamDecoder(data, device=device).decode(impl=impl)
    return [tuple(p.cpu().numpy() for p in f) for f in res.frames]


def counted(run):
    """``run()`` with every count of the kernels' counter registry (each
    kernel's launches, the torch sideband expansions and the plain (torch)
    coefficient expansions) set to 0 just before it; returns (its result,
    the counts just after)."""
    counters.reset()
    out = run()
    return out, counters.snapshot()


def want_counts(fused: int = 0, mc: int = 0, recon: int = 0,
                expand: int = 0, color: int = 0) -> dict:
    """The counts :func:`counted` must give for a run on the card: the
    launches of each kernel as given, and never a torch sideband
    expansion, a plain coefficient expansion or a plain colour
    conversion."""
    return {"fused": fused, "mc": mc, "recon": recon, "expansions": 0,
            "expand": expand, "expand_plain": 0, "color": color,
            "color_plain": 0}


def with_unloaded(counts: dict) -> dict:
    """``counts`` from another process, with 0 for every counter of this
    one that it lacks: a wrapper module that process never imported
    registered no counter there, and launched nothing."""
    return {**dict.fromkeys(counters.snapshot(), 0), **counts}


def compact_gops(data: bytes) -> int:
    """The GOPs of ``data`` that the compact wire carries (the others fall
    back to the dense wire): the expansion kernel's launches in a
    ``transcode`` of it."""
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    return sum(not parse_gop_compact(arr, g, seq, meta, BufferPool(),
                                     {}).dirty for g in groups)


def mismatching_pixels(a: list, b: list) -> int:
    check(len(a) == len(b) > 0, f"{len(a)} frames against {len(b)}")
    n = 0
    for fa, fb in zip(a, b):
        check(len(fa) == len(fb), "plane count")
        for pa, pb in zip(fa, fb):
            check(pa.dtype == pb.dtype == np.uint8 and pa.shape == pb.shape,
                  f"plane {pa.dtype} {pa.shape} vs {pb.dtype} {pb.shape}")
            n += int((pa != pb).sum())
    return n


def check_path(label: str, run, device, n_planes: int,
               n_compact: int) -> dict:
    """One path through ``impl="two_kernel"`` on the card (the MC and the
    reconstruction kernel once per picture each, the fused kernel never,
    and no torch sideband expansion), through ``impl="fused"`` on the
    card (the fused kernel once per picture), and through ``"two_kernel"``
    on the CPU: all three bit-equal; on both routes the expansion kernel
    once per GOP of the ``n_compact`` the compact wire carries, and no
    plain expansion.  ``run(device, impl)`` returns the decoded frames as
    numpy.  Returns the two-kernel run's launch counts."""
    two, n_two = counted(lambda: run(device, "two_kernel"))
    n_f = len(two)
    fz, n_fz = counted(lambda: run(device, "fused"))
    cpu = run(torch.device("cpu"), "two_kernel")
    d_fused, d_cpu = mismatching_pixels(two, fz), mismatching_pixels(two,
                                                                     cpu)
    emit("path", path=label, frames=n_f, planes=n_planes,
         two_kernel_launches=n_two, fused_launches=n_fz,
         expected_launches={"two_kernel": {"mc": n_f, "recon": n_f},
                            "fused": n_f, "expand": n_compact,
                            "expansions": 0, "expand_plain": 0},
         vs_fused_on_card_mismatching_pixels=d_fused,
         vs_cpu_mismatching_pixels=d_cpu)
    check(n_two == want_counts(mc=n_f, recon=n_f, expand=n_compact)
          and n_f > 0, f"{label}: launches {n_two} for {n_f} frames")
    check(n_fz == want_counts(fused=n_f, expand=n_compact),
          f"{label}: fused route launches {n_fz}")
    check(d_fused == 0, f"{label}: two-kernel and fused routes differ on "
                        f"the card in {d_fused} pixels")
    check(d_cpu == 0, f"{label}: card and CPU differ in {d_cpu} pixels")
    return n_two


# ---------------------------------------------------------------------------
# Phase 4, playback: the Decoder and the Player

PLAYER_EVENTS = ("loadstart", "durationchange", "loadedmetadata",
                 "loadeddata", "progress", "canplay", "canplaythrough",
                 "play", "playing", "waiting", "stalled", "seeking",
                 "seeked", "ended", "error", "resize", "suspend", "frameout")


def decoder_frames(data: bytes, device, scan: bool, quirk: bool = False,
                   seek_gop: int | None = None) -> list:
    """Every frame of ``data`` through the port's streaming Decoder, as
    numpy; with ``seek_gop``, the frames after a seek to that key-map
    GOP's time (made once the first frame is out)."""
    d = Decoder(PlayerConfig(use_gop_scan=scan, quirk_oddify_zeros=quirk),
                device=device)
    d.feed(0, data, total=len(data))
    if seek_gop is not None:
        check(d.decode_frame() is not None, "no first frame")
        km = d.meta.key_map
        check(d.seek(km.time_of(seek_gop, d.sequence.picture_rate) * 1e3),
              f"seek to GOP {seek_gop} failed")
    frames = [tuple(p.cpu().numpy() for p in f.planes)
              for f in d.iter_frames()]
    check(d.ended, "the Decoder did not reach the end")
    return frames


def play(data: bytes, player) -> tuple[list, list, list]:
    """Drive ``player`` (RGB output) with a virtual 30 Hz clock to
    ``ended``; returns (its events, the RGB frames and the decoded planes
    of each displayed frame, as numpy)."""
    events, rgb, planes = [], [], []
    for name in PLAYER_EVENTS:
        player.on(name, lambda *a, n=name: events.append(
            (n, int(player.ready_state))))
    def sink(f, t):
        check(not isinstance(f, torch.Tensor) or f.is_contiguous(),
              "the Player's sink got a strided RGB frame")
        rgb.append(f.cpu().numpy() if isinstance(f, torch.Tensor) else None)

    player.set_frame_sink(sink)
    player.on("frameout", lambda f, t: planes.append(
        tuple(np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)
              for p in f.planes)))
    player.src = data
    player.play()
    t = 0.0
    while not player.ended and t < 60.0:
        t += 1 / 30.0
        player.tick(t)
    check(player.ended, "the Player did not reach ended")
    return events, rgb, planes


def check_decoder(label: str, data: bytes, dev, n_planes: int,
                  straight: list | None) -> None:
    """The Decoder on the card, GOP batch and picture by picture: the
    fused kernel once per picture, bit-equal to ``straight``
    (``StreamDecoder`` on the card) and to the Decoder on the CPU; then
    with a seek to GOP 1 and with the quirk, each bit-equal to the CPU."""
    cpu = decoder_frames(data, torch.device("cpu"), True)
    for scan in (True, False):
        got, n = counted(lambda: decoder_frames(data, dev, scan))
        n_f = len(got)
        d_stream = (mismatching_pixels(got, straight)
                    if straight is not None else None)
        d_cpu = mismatching_pixels(got, cpu)
        emit("decoder", stream=label, gop_batch=scan, frames=n_f,
             planes=n_planes, launches=n, expected_fused=n_f,
             vs_stream_decoder_mismatching_pixels=d_stream,
             vs_cpu_mismatching_pixels=d_cpu)
        check(n == want_counts(fused=n_f),
              f"{label} Decoder gop_batch={scan}: launches {n}")
        check(not d_stream and d_cpu == 0,
              f"{label} Decoder gop_batch={scan}: differs from the stream "
              f"decoder in {d_stream} pixels, from the CPU in {d_cpu}")
        tail, n = counted(lambda: decoder_frames(data, dev, scan,
                                                 seek_gop=1))
        d_tail = mismatching_pixels(tail, cpu[len(cpu) - len(tail):])
        emit("decoder_seek", stream=label, gop_batch=scan, to_gop=1,
             frames_after=len(tail), launches=n,
             vs_straight_tail_mismatching_pixels=d_tail)
        check(0 < len(tail) < n_f and d_tail == 0,
              f"{label} seek: {len(tail)} frames, {d_tail} pixels differ")
    quirk_cpu = decoder_frames(data, torch.device("cpu"), True, quirk=True)
    for scan in (True, False):
        got, n = counted(lambda: decoder_frames(data, dev, scan, quirk=True))
        d_cpu = mismatching_pixels(got, quirk_cpu)
        emit("decoder_quirk", stream=label, gop_batch=scan, launches=n,
             vs_cpu_mismatching_pixels=d_cpu,
             vs_plain_decode_mismatching_pixels=mismatching_pixels(got,
                                                                   cpu))
        check(n["fused"] == len(got) and d_cpu == 0,
              f"{label} quirk gop_batch={scan}: launches {n}, {d_cpu} "
              f"pixels differ from the CPU")


def plain_rgb_crop(planes, h: int, w: int, dev) -> np.ndarray:
    """The plain colour version of a coded frame's planes (numpy) on
    ``dev``, cropped to ``h`` x ``w`` afterwards: jsvx's
    convert-then-crop."""
    t = [torch.from_numpy(q).to(dev) for q in planes]
    rgb = ycbcr_to_rgb_plain(t[0], t[1], t[2], t[3] if len(t) > 3 else False)
    return rgb[:h, :w].cpu().numpy()


def check_player(label: str, data: bytes, dev, n_planes: int) -> dict:
    """The Player with RGB output on the card, against the same Player on
    the CPU: the same events, every RGB frame bit-equal, and within 1 LSB
    of ``refmath.ycbcr_to_rgb`` on the displayed planes; a YUVA stream's
    alpha channel equals its decoded alpha plane; each RGB frame (the
    colour kernel once a frame, the plain version never) of display size,
    contiguous, and bit-equal to the plain version of the coded frame on
    the card, cropped.  Returns the launch counts of the card's run."""
    (ev, rgb, planes), n = counted(lambda: play(
        data, Player(PlayerConfig(emit_rgb=True), device=dev)))
    ev_c, rgb_c, _ = play(data, Player(PlayerConfig(emit_rgb=True),
                                       device="cpu"))
    n_f = len(rgb)
    d_cpu = mismatching_pixels([(x,) for x in rgb], [(x,) for x in rgb_c])
    worst = 0
    for x, p in zip(rgb, planes):
        h, w = x.shape[:2]
        worst = max(worst, int(np.abs(
            x[..., :3].astype(int)
            - ref_rgb(*p[:3])[:h, :w].astype(int)).max()))
        if n_planes == 4:
            check(np.array_equal(x[..., 3], p[3][:h, :w]),
                  f"{label}: RGBA alpha is not the decoded alpha plane")
    meta, _, _ = walk_stream(data)
    d_crop = sum(int((plain_rgb_crop(p, meta.height, meta.width, dev)
                      != x).sum()) for x, p in zip(rgb, planes))
    names = [e for e, _ in ev if e != "frameout"]
    emit("player", stream=label, frames_shown=n_f, rgb_shape=list(
        rgb[0].shape), launches=n, vs_cpu_mismatching_values=d_cpu,
         vs_plain_of_coded_frame_cropped_differing_values=d_crop,
         max_abs_err_vs_refmath=worst, events_equal_cpu=ev == ev_c,
         first_event=names[0], last_event=names[-1])
    check(n["fused"] == n_f and n_f > 0,
          f"{label} Player: launches {n} for {n_f} frames")
    check(n["color"] == n_f and n["color_plain"] == 0,
          f"{label} Player: colour launches {n['color']}, plain "
          f"{n['color_plain']} for {n_f} frames")
    check(d_crop == 0 and all(x.shape[:2] == (meta.height, meta.width)
                              for x in rgb),
          f"{label} Player: RGB differs from the plain version's crop of "
          f"the coded frame in {d_crop} values, or is not of display size")
    check(ev == ev_c and names[0] == "loadstart" and names[-1] == "ended",
          f"{label} Player: events differ from the CPU's or out of order")
    check(d_cpu == 0 and worst <= 1,
          f"{label} Player: RGB differs from the CPU in {d_cpu} values, "
          f"{worst} LSB from refmath")
    check(rgb[0].shape[-1] == (4 if n_planes == 4 else 3),
          f"{label} Player: RGB shape {rgb[0].shape}")
    return {"events": ev, "frames": n_f, "launches": n}


def check_decoder_vs_oracle(label: str, data: bytes, dev) -> None:
    oracle = [f.planes for f in decode_stream_oracle(data)]
    for scan in (True, False):
        got = decoder_frames(data, dev, scan)
        check(len(got) == len(oracle), f"{label}: frame count")
        worst = max(int(np.abs(p.astype(int) - q.astype(int)).max())
                    for f, o in zip(got, oracle) for p, q in zip(f, o))
        emit("decoder_oracle", stream=label, gop_batch=scan,
             frames=len(got), max_abs_err_vs_oracle=worst)
        check(worst <= 1, f"{label} Decoder: {worst} LSB from the oracle")


def check_play_cli(path: str, n_frames: int, dev) -> dict:
    """``python -m jsvx_torch play`` in a subprocess: exit 0, every frame
    shown, ``ended``."""
    out = subprocess.run(
        [sys.executable, "-m", "jsvx_torch", "play", path, "--rgb",
         "--rate", "8", "--device", str(dev)],
        capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"play exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    report = json.loads(out.stdout.strip().splitlines()[-1])
    emit("play_cli", **{k: report[k] for k in (
        "frames_shown", "ended", "wall_seconds", "display_fps", "device",
        "error", "event_order")})
    check(report["ended"] is True and report["frames_shown"] == n_frames,
          f"play: {report}")
    return report


# ---------------------------------------------------------------------------
# Phase 5: timing

def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def call_ms(fn, device) -> list[float]:
    """Per call with the host in the loop: CUDA events around one call,
    so the device's idle time while Python launches is included."""
    for _ in range(3):
        fn()
    sync(device)
    times = []
    for _ in range(N_TIMED):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def device_ms(fn, device, k: int) -> tuple[list[float], float, float]:
    """Device time per call, the host's launch cost hidden: a spin kernel
    (``torch.cuda._sleep``) holds the stream for about SLEEP_MS while
    ``k`` calls are enqueued behind it, so they run back to back.
    Returns the per-call times, the share of repetitions whose enqueueing
    ended before the spin did (1.0: every time is pure device time), and
    the median host time to enqueue the ``k`` calls."""
    for _ in range(3):
        fn()
    sync(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    cycles = 1_000_000
    for _ in range(2):                     # calibrate, then measure it
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        e1.synchronize()
        spin_ms = e0.elapsed_time(e1)
        cycles = int(cycles * SLEEP_MS / spin_ms)
    times, host, covered = [], [], 0
    for _ in range(N_TIMED):
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        e0.record()
        for _ in range(k):
            fn()
        e1.record()
        host.append((time.perf_counter() - t0) * 1e3)
        covered += host[-1] < 0.9 * spin_ms
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / k)
    return times, covered / N_TIMED, statistics.median(host)


def cold_ms(fn, device) -> list[float]:
    """Device time per call with L2 cold: before each call a FLUSH_BYTES
    write evicts the 50 MB L2, and CUDA events bracket the call alone.
    A spin kernel ahead of each flush holds the stream while the host
    enqueues flush, events and call, so no host gap falls between the
    events."""
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    for _ in range(3):
        fn()
    sync(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    cycles = 1_000_000
    for _ in range(2):                     # calibrate a 2 ms spin
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        e1.synchronize()
        cycles = int(cycles * 2.0 / e0.elapsed_time(e1))
    times = []
    for rep in range(N_TIMED):
        torch.cuda._sleep(cycles)
        scratch.fill_(rep & 0xFF)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def tap_footprint(c: dict, h: int, w: int, chroma: bool) -> int:
    """Distinct reference bytes the half-pel taps of a plane's predicted
    blocks read (each tap clamped to the plane): the union of the blocks'
    windows, counted with a 2-D difference array."""
    mv = c["mv"].cpu().numpy().astype(np.int64)
    pred = c["rep_add"].cpu().numpy() == 0
    mvy, mvx = mv[..., 0], mv[..., 1]
    if chroma:                               # truncation toward zero
        mvy, mvx = np.fix(mvy / 2).astype(np.int64), \
            np.fix(mvx / 2).astype(np.int64)
    by, bx = np.nonzero(pred)
    if by.size == 0:
        return 0
    vy, vx = mvy[by, bx], mvx[by, bx]
    y0 = np.clip(by * 8 + (vy >> 1), 0, h - 1)
    y1 = np.clip(by * 8 + 7 + (vy >> 1) + (vy & 1), 0, h - 1)
    x0 = np.clip(bx * 8 + (vx >> 1), 0, w - 1)
    x1 = np.clip(bx * 8 + 7 + (vx >> 1) + (vx & 1), 0, w - 1)
    diff = np.zeros((h + 1, w + 1), np.int32)
    np.add.at(diff, (y0, x0), 1)
    np.add.at(diff, (y0, x1 + 1), -1)
    np.add.at(diff, (y1 + 1, x0), -1)
    np.add.at(diff, (y1 + 1, x1 + 1), 1)
    return int((diff.cumsum(0).cumsum(1)[:h, :w] > 0).sum())


def picture_work(frame: dict) -> dict:
    """What one picture's fused decode must move and compute, from this
    picture's data: output 1 B and levels 2 B per pixel, 8 B of sideband
    per block (lnz, q, intra, rep_add, two int16 vector components), and
    the reference bytes the taps read; levels only for coded blocks (lnz
    > 0 or intra) in ``bytes``, for every block in ``bytes_all_levels``;
    31 f32 operations per pixel of a coded block."""
    is_p = int(frame["is_p"]) != 0
    out = dict(bytes=0, bytes_all_levels=0, flop=0, pixels=0)
    for ci, key in enumerate(frame_comp_keys(frame)):
        c = frame[key]
        h, w = c["levels"].shape
        coded = int(((c["lnz"] > 0) | (c["intra"] > 0)).sum()) * 64
        ref = tap_footprint(c, h, w, comp_is_chroma(ci)) if is_p else 0
        fixed = h * w + (h // 8) * (w // 8) * 8 + ref
        out["bytes"] += fixed + 2 * coded
        out["bytes_all_levels"] += fixed + 2 * h * w
        out["flop"] += FLOP_PER_CODED_PIXEL * coded
        out["pixels"] += h * w
    return out


def bound(work_bytes: int, flop: int) -> tuple[float, str]:
    """The least time (ms) the card could take, and what sets it."""
    t_bytes = work_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fused_picture_times(label: str, data: bytes, dev, card: str) -> list:
    """The fused kernel per picture of GOP 0 of ``data``: warm in L2
    (back to back behind a spin) and with L2 flushed between calls, in
    turns with its first design (three launches per picture): first
    design, new, new, first design; the plain version; the bytes and
    operations the picture needs and the bound.  One ``kernel_time`` line
    per picture."""
    meta, seq, _, _, _, dense = gop_on_card(data, 0, dev)
    n_frames = int(dense["is_p"].shape[0])
    consts = make_constants(seq, dev)
    refs = zero_refs(seq.coded_height, seq.coded_width, meta.n_components,
                     dev)
    rows = []
    for i in range(n_frames):
        frame = frame_at(dense, i)
        keys = frame_comp_keys(frame)
        outs = tuple(torch.empty_like(r) for r in refs)

        def new():
            fused.decode_frame_planes_fused(frame, refs, consts, outs=outs)

        def first():
            for ci, key in enumerate(keys):
                baseline_plane(frame[key], refs[ci], frame["is_p"], consts,
                               comp_is_chroma(ci), out=outs[ci])

        def plain():
            for ci, key in enumerate(keys):
                decode_frame_plane(frame[key], refs[ci], frame["is_p"],
                                   consts, comp_is_chroma(ci))

        f1, fc1 = device_ms(first, dev, 20)[0], cold_ms(first, dev)
        n1, nc1 = device_ms(new, dev, 20)[0], cold_ms(new, dev)
        n2, nc2 = device_ms(new, dev, 20)[0], cold_ms(new, dev)
        f2, fc2 = device_ms(first, dev, 20)[0], cold_ms(first, dev)
        pl = device_ms(plain, dev, 1)[0]
        work = picture_work(frame)
        b_ms, b_by = bound(work["bytes"], work["flop"])
        b_all, _ = bound(work["bytes_all_levels"], work["flop"])
        row = dict(ms=statistics.median(n1 + n2),
                   cold_ms=statistics.median(nc1 + nc2),
                   first_design_ms=statistics.median(f1 + f2),
                   first_design_cold_ms=statistics.median(fc1 + fc2),
                   plain_ms=statistics.median(pl), bound_ms=b_ms,
                   bound_by=b_by, is_p=int(frame["is_p"]))
        emit("kernel_time", kernel="fused_decode_picture", stream=label,
             card=card, frame=i, is_p=row["is_p"],
             shapes=[list(r.shape) for r in refs], launches_per_picture=1,
             kernel_ms=row["ms"], kernel_cold_ms=row["cold_ms"],
             kernel_ms_runs=[statistics.median(n1), statistics.median(n2)],
             kernel_cold_ms_runs=[statistics.median(nc1),
                                  statistics.median(nc2)],
             first_design_ms=row["first_design_ms"],
             first_design_cold_ms=row["first_design_cold_ms"],
             first_design_ms_runs=[statistics.median(f1),
                                   statistics.median(f2)],
             first_design_launches_per_picture=len(keys),
             plain_ms=row["plain_ms"], speedup_vs_first_design=(
                 row["first_design_ms"] / row["ms"]),
             bytes=work["bytes"], bytes_all_levels=work["bytes_all_levels"],
             flop=work["flop"], bound_ms=b_ms,
             bound_ms_all_levels=b_all, bound_by=b_by,
             bound_share=b_ms / row["ms"],
             bound_share_cold=b_ms / row["cold_ms"],
             achieved_gb_s=work["bytes"] / (row["ms"] * 1e-3) / 1e9,
             achieved_gb_s_cold=work["bytes"] / (row["cold_ms"] * 1e-3) / 1e9,
             library_ms=None, library=NO_LIBRARY, reps=2 * N_TIMED,
             l2="warm: back to back behind a spin; cold: a 64 MB write "
                "before each call")
        rows.append(row)
        refs = fused.decode_frame_planes_fused(frame, refs, consts)
    sync(dev)
    return rows


def two_kernel_work(frame: dict) -> dict:
    """What one picture's MC and reconstruction launches must move, from
    this picture's data.  MC: 2 B out per pixel, the reference bytes the
    taps of predicted blocks read (their union) and 5 B per block (vector,
    rep_add).  Reconstruction: 1 B out per pixel, 2 B of levels per pixel
    of a coded block (lnz > 0 or intra), 2 B of prediction per pixel of a
    P picture, 3 B per block (lnz, q, intra); 31 f32 operations per pixel
    of a coded block."""
    is_p = int(frame["is_p"]) != 0
    out = dict(mc=0, recon=0, flop=0)
    for ci, key in enumerate(frame_comp_keys(frame)):
        c = frame[key]
        h, w = c["levels"].shape
        px, blocks = h * w, (h // 8) * (w // 8)
        coded = int(((c["lnz"] > 0) | (c["intra"] > 0)).sum()) * 64
        pred = 2 * px if is_p else 0
        out["mc"] += (2 * px + tap_footprint(c, h, w, comp_is_chroma(ci))
                      + 5 * blocks)
        out["recon"] += px + 2 * coded + pred + 3 * blocks
        out["flop"] += FLOP_PER_CODED_PIXEL * coded
    return out


def turns(fns: dict, order: list, dev) -> dict:
    """Each function's device time, warm in L2 (20 calls back to back
    behind a spin) and cold (a 64 MB write before each call), in the
    ``order`` given (a function named twice runs twice, apart); returns
    per name the median of all its runs and the median of each run."""
    runs = {}
    for name in order:
        warm = device_ms(fns[name], dev, 20)[0]
        runs.setdefault(name, []).append((warm, cold_ms(fns[name], dev)))
    return {name: dict(
        ms=statistics.median([t for w, _ in r for t in w]),
        cold_ms=statistics.median([t for _, c in r for t in c]),
        ms_runs=[statistics.median(w) for w, _ in r],
        cold_ms_runs=[statistics.median(c) for _, c in r])
        for name, r in runs.items()}


def two_kernel_picture_times(label: str, data: bytes, dev,
                             card: str) -> list:
    """The MC and reconstruction kernels per picture of GOP 0 of
    ``data``: warm and cold, in turns with their first designs (three
    launches per picture each), first design, new, new, first design
    (the reconstruction's first design on the expanded sideband); the
    torch sideband expansion the first designs' route ran per picture;
    the plain versions; the bytes and operations and the bounds.  Two
    ``kernel_time`` lines per picture."""
    meta, seq, _, _, _, dense = gop_on_card(data, 0, dev)
    consts = make_constants(seq, dev)
    refs = zero_refs(seq.coded_height, seq.coded_width, meta.n_components,
                     dev)
    rows = []
    for i in range(int(dense["is_p"].shape[0])):
        frame = frame_at(dense, i)
        keys, is_p = frame_comp_keys(frame), frame["is_p"]
        preds = tuple(torch.empty(r.shape, dtype=torch.int16, device=dev)
                      for r in refs)
        outs = tuple(torch.empty_like(r) for r in refs)
        mc.predict_picture_mc(frame, refs, outs=preds)
        planes = [(ci, frame[k], recon.expand_sideband(frame[k], consts),
                   comp_is_chroma(ci)) for ci, k in enumerate(keys)]
        fns = {
            "mc": lambda: mc.predict_picture_mc(frame, refs, outs=preds),
            "mc_first": lambda: [mc_first_design(
                refs[ci], c["mv"], c["rep_add"], ch, out=preds[ci])
                for ci, c, _, ch in planes],
            "mc_plain": lambda: [predict_plane(
                refs[ci], c["mv"], c["rep_add"], ch).to(torch.int16)
                for ci, c, _, ch in planes],
            "recon": lambda: recon.recon_picture(frame, preds, is_p, consts,
                                                 outs=outs),
            "recon_first": lambda: [recon_first_design(
                c["levels"], *sb, preds[ci], is_p, consts, out=outs[ci])
                for ci, c, sb, _ in planes],
            "expand": lambda: [recon.expand_sideband(c, consts)
                               for _, c, _, _ in planes],
            "recon_plain": lambda: [recon.recon_plane_blocks(
                c, preds[ci], is_p, consts) for ci, c, _, _ in planes],
        }
        t = turns(fns, ["mc_first", "mc", "mc", "mc_first", "recon_first",
                        "recon", "recon", "recon_first"], dev)
        plain = {name: statistics.median(device_ms(fns[name], dev, 1)[0])
                 for name in ("mc_plain", "recon_plain")}
        expand_ms = statistics.median(device_ms(fns["expand"], dev, 4)[0])
        work = two_kernel_work(frame)
        b = {k: bound(work[k], work["flop"] if k != "mc" else 0)
             for k in ("mc", "recon")}
        common = dict(stream=label, card=card, frame=i, is_p=int(is_p),
                      shapes=[list(r.shape) for r in refs],
                      launches_per_picture=1,
                      first_design_launches_per_picture=len(keys),
                      library_ms=None, library=NO_LIBRARY, reps=2 * N_TIMED,
                      l2="warm: back to back behind a spin; cold: a 64 MB "
                         "write before each call")

        def timed(name, first, work_bytes, bnd):
            return dict(
                kernel_ms=t[name]["ms"], kernel_cold_ms=t[name]["cold_ms"],
                kernel_ms_runs=t[name]["ms_runs"],
                kernel_cold_ms_runs=t[name]["cold_ms_runs"],
                first_design_ms=t[first]["ms"],
                first_design_cold_ms=t[first]["cold_ms"],
                speedup_vs_first_design=t[first]["ms"] / t[name]["ms"],
                bytes=work_bytes, bound_ms=bnd[0], bound_by=bnd[1],
                bound_share=bnd[0] / t[name]["ms"],
                bound_share_cold=bnd[0] / t[name]["cold_ms"],
                achieved_gb_s=work_bytes / (t[name]["ms"] * 1e-3) / 1e9)

        mc_row = timed("mc", "mc_first", work["mc"], b["mc"])
        emit("kernel_time", kernel="mc_picture", **common, **mc_row,
             first_design_ms_runs=t["mc_first"]["ms_runs"],
             plain_ms=plain["mc_plain"])
        recon_row = timed("recon", "recon_first", work["recon"], b["recon"])
        emit("kernel_time", kernel="recon_picture", **common, **recon_row,
             first_design_ms_runs=t["recon_first"]["ms_runs"],
             plain_ms=plain["recon_plain"], flop=work["flop"],
             torch_sideband_expansion_ms=expand_ms,
             first_design_route_ms=t["recon_first"]["ms"] + expand_ms)
        rows.append(dict(is_p=int(is_p),
                         mc=dict(mc_row, plain_ms=plain["mc_plain"]),
                         recon=dict(recon_row,
                                    plain_ms=plain["recon_plain"])))
        refs = fused.decode_frame_planes_fused(frame, refs, consts)
    sync(dev)
    return rows


@contextlib.contextmanager
def plain_expansion_route():
    """Inside the block the GOP loop expands a compact wire with the plain
    version (torch ops on the card), as the port did before the expansion
    kernel, for the timings of that route; restored after it, whatever
    happens."""
    real = gop_module.expand_compact_gop
    gop_module.expand_compact_gop = expand.expand_compact_gop_plain
    try:
        yield
    finally:
        gop_module.expand_compact_gop = real


def eager_program_run(prog, copied, metrics) -> tuple:
    """What ``GopProgram.run`` does without its graph: the body (the eager
    GOP loop on the static wire) on every GOP, no capture, no replay."""
    if copied is not None:
        torch.cuda.current_stream(prog.device).wait_event(copied)
    outs = prog.body()
    prog.consumed = program._record(prog.device)
    prog.loaded = False
    return outs, prog.consumed


@contextlib.contextmanager
def eager_route():
    """Inside the block every GOP program runs the eager loop
    (:func:`eager_program_run`): ``transcode`` uploads into the programs'
    static wires as on the graph route and dispatches as it did before
    the programs; restored after it, whatever happens."""
    real = program.GopProgram.run
    program.GopProgram.run = eager_program_run
    try:
        yield
    finally:
        program.GopProgram.run = real


def transcode_vs_plain_expansion(data: bytes, dev, card: str) -> dict:
    """``transcode`` of ``data`` (the ``.cpu()`` sink) with the expansion
    kernel and with the plain expansion, in turns in this call: plain,
    kernel, kernel, plain, N_E2E runs each after a warm-up (host clock);
    frames/s and the stages per GOP of each route, and the share of
    same-position run pairs the kernel's route wins."""
    runs: dict = {"plain": [], "kernel": []}
    stages: dict = {"plain": {}, "kernel": {}}
    n_gops = n_frames = 0
    for route in ("plain", "kernel", "kernel", "plain"):
        ctx = (plain_expansion_route() if route == "plain"
               else contextlib.nullcontext())
        with eager_route(), ctx:
            for rep in range(N_E2E + 1):
                m = Metrics()
                sync(dev)
                t0 = time.perf_counter()
                r = transcode(data, lambda gi, outs: [o.cpu() for o in outs],
                              device=dev, metrics=m)
                sync(dev)
                if rep:                    # rep 0 is the warm-up
                    runs[route].append(time.perf_counter() - t0)
                    for k, v in m.timers.totals.items():
                        stages[route][k] = stages[route].get(k, 0.0) + v
        n_gops, n_frames = r.n_gops, r.n_frames
    out = {route: dict(
        frames_per_s=n_frames / statistics.median(w),
        median_s=statistics.median(w), wall_s_runs=[min(w), max(w)],
        stage_s_per_gop={k: v / len(w) / n_gops
                         for k, v in stages[route].items()})
        for route, w in runs.items()}
    wins = sum(k < p for k, p in zip(runs["kernel"], runs["plain"]))
    emit("end_to_end_vs_plain_expansion", card=card, frames=n_frames,
         gops=n_gops, **out, kernel_wins=wins, pairs=len(runs["kernel"]),
         reps=2 * N_E2E, what="transcode with the expansion kernel against "
         "the same loop with the plain (torch) expansion, in turns: plain, "
         "kernel, kernel, plain; .cpu() sink; both on the eager loop "
         "(eager_route), as before the GOP programs")
    return out


def expand_work(tree: dict, mb_h: int, mb_w: int) -> int:
    """The bytes one GOP's expansion must move, from this wire: read, each
    entry below n once (2 B), n (4 B) and the counts (1 B a block) of each
    component, and the per-MB sideband once (3 B and a 4 B vector per MB
    and frame) when a luma-like component repeats it; written, 2 B of
    levels per pixel, 1 B of lnz per block, and per block of a luma-like
    component 7 B of grids (q, intra, rep_add, vector)."""
    n = int(tree["is_p"].shape[0])
    total, luma_seen = 0, False
    for key, c in tree["coef"].items():
        luma = key in ("y", "a")
        blocks = n * expand.comp_blocks(mb_h, mb_w, luma)
        entries = max(0, min(int(c["n"].cpu()), c["cpk"].shape[0]))
        total += 2 * entries + 4 + blocks + 2 * 64 * blocks + blocks
        if luma:
            total += 7 * blocks
            luma_seen = True
    return total + (7 * n * mb_h * mb_w if luma_seen else 0)


def expand_times(tree: dict, mb_h: int, mb_w: int, dev, card: str) -> dict:
    """The expansion kernel per GOP of a resident wire: warm in L2 (20
    launches back to back behind a spin) and with L2 flushed before each
    launch, in turns with its plain version (torch ops, 4 calls behind a
    spin; ``plain_host_ahead_share`` says whether the host kept ahead):
    plain, kernel, kernel, plain; the bytes it must move and the bound.
    One ``kernel_time`` line."""
    fns = {"kernel": lambda: expand.expand_compact_gop(tree, mb_h, mb_w),
           "plain": lambda: expand.expand_compact_gop_plain(tree, mb_h,
                                                            mb_w)}
    t = {name: dict(warm=[], cold=[], runs=[], cold_runs=[], ahead=1.0)
         for name in fns}
    for name in ("plain", "kernel", "kernel", "plain"):
        warm, ahead, _ = device_ms(fns[name], dev,
                                   20 if name == "kernel" else 4)
        r = t[name]
        r["warm"] += warm
        r["runs"].append(statistics.median(warm))
        r["ahead"] = min(r["ahead"], ahead)
        if name == "kernel":
            cold = cold_ms(fns[name], dev)
            r["cold"] += cold
            r["cold_runs"].append(statistics.median(cold))
    work = expand_work(tree, mb_h, mb_w)
    b_ms, b_by = bound(work, 0)
    row = dict(ms=statistics.median(t["kernel"]["warm"]),
               cold_ms=statistics.median(t["kernel"]["cold"]),
               plain_ms=statistics.median(t["plain"]["warm"]),
               bound_ms=b_ms, bound_by=b_by, bytes=work)
    emit("kernel_time", kernel="expand_gop", stream="1080p", card=card,
         frames=int(tree["is_p"].shape[0]), components=list(tree["coef"]),
         entries={k: int(c["n"].cpu()) for k, c in tree["coef"].items()},
         launches_per_gop=1, kernel_ms=row["ms"],
         kernel_cold_ms=row["cold_ms"], kernel_ms_runs=t["kernel"]["runs"],
         kernel_cold_ms_runs=t["kernel"]["cold_runs"],
         kernel_host_ahead_share=t["kernel"]["ahead"],
         plain_ms=row["plain_ms"], plain_ms_runs=t["plain"]["runs"],
         plain_host_ahead_share=t["plain"]["ahead"],
         speedup_vs_plain=row["plain_ms"] / row["ms"], bytes=work,
         bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / row["ms"],
         bound_share_cold=b_ms / row["cold_ms"],
         achieved_gb_s=work / (row["ms"] * 1e-3) / 1e9,
         achieved_gb_s_cold=work / (row["cold_ms"] * 1e-3) / 1e9,
         library_ms=None, library="no PyTorch call computes it: the plain "
         "version is some 20 torch ops a component", reps=2 * N_TIMED,
         l2="warm: back to back behind a spin; cold: a 64 MB write before "
            "each call")
    return row


def decoder_rate(data: bytes, dev, scan: bool, card: str) -> dict:
    """The streaming Decoder's frames/s over a whole buffered stream
    (host clock, a run ends in a synchronise; median of N_E2E after a
    warm-up) and its stages per run.  Parse is a stage of the GOP batch
    only; picture by picture it is inside the rest of the run."""
    wall, totals = [], {}
    for rep in range(N_E2E + 1):
        sync(dev)
        t0 = time.perf_counter()
        d = Decoder(PlayerConfig(use_gop_scan=scan), device=dev)
        d.feed(0, data, total=len(data))
        n_f = sum(1 for _ in d.iter_frames())
        sync(dev)
        if rep:
            wall.append(time.perf_counter() - t0)
            for k, v in d.metrics.timers.totals.items():
                totals[k] = totals.get(k, 0.0) + v / N_E2E
    med = statistics.median(wall)
    out = dict(card=card, gop_batch=scan, frames=n_f, median_s=med,
               frames_per_s=n_f / med, reps=N_E2E,
               wall_s_runs=[min(wall), max(wall)], stage_s_per_run=totals,
               rest_s_per_run=med - sum(totals.values()))
    emit("decoder_end_to_end", **out,
         what="feed the whole stream, iter_frames; frames stay on the card")
    return out


def decoder_view_copies(data: bytes, dev, card: str) -> dict:
    """The Decoder builds a ``BitReader`` over ``view.tobytes()`` of the
    buffered view once per start code it handles (as jsvx's does), copying
    the view each time.  Counts the copies and their bytes in one run of
    each path, and times a copy the size of the stream (host clock, median
    of N_TIMED)."""
    import jsvx_torch.api.decoder as port_decoder

    real = port_decoder.BitReader
    out = {}
    for scan in (True, False):
        sizes = []

        def counting(buf, *a, **k):
            sizes.append(len(buf))
            return real(buf, *a, **k)

        port_decoder.BitReader = counting
        try:
            decoder_frames(data, dev, scan)
        finally:
            port_decoder.BitReader = real
        out["gop_batch" if scan else "per_picture"] = dict(
            copies=len(sizes), bytes=sum(sizes))
    view = np.frombuffer(data, np.uint8)
    times = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        view.tobytes()
        times.append(time.perf_counter() - t0)
    rate = len(data) / statistics.median(times)
    for v in out.values():
        v["est_copy_ms"] = v["bytes"] / rate * 1e3
    emit("decoder_view_copies", card=card, stream_bytes=len(data),
         copy_ms_whole_stream=statistics.median(times) * 1e3,
         copy_gb_s=rate / 1e9, **out)
    return out


def player_rate(data: bytes, dev, card: str) -> dict:
    """The Player with RGB output from ``src`` to ``ended`` under a
    virtual clock, each RGB frame copied to the host by the sink (host
    clock; median of N_E2E after a warm-up); in every run the colour
    kernel once per frame shown and the plain version never."""
    wall = []
    for rep in range(N_E2E + 1):
        shown = []
        sync(dev)
        counters.reset()
        t0 = time.perf_counter()
        p = Player(PlayerConfig(emit_rgb=True), device=dev)
        p.set_frame_sink(lambda rgb, t: shown.append(rgb.cpu()))
        p.src = data
        p.play()
        t = 0.0
        while not p.ended and t < 60.0:
            t += 1 / 30.0
            p.tick(t)
        sync(dev)
        if rep:
            wall.append(time.perf_counter() - t0)
        n = counters.snapshot()
        check(p.ended, "the Player did not reach ended")
        check(n["color"] == len(shown) > 0 and n["color_plain"] == 0,
              f"Player run {rep}: colour launches {n['color']}, plain "
              f"{n['color_plain']} for {len(shown)} frames")
    med = statistics.median(wall)
    out = dict(card=card, frames=len(shown), median_s=med,
               frames_per_s=len(shown) / med, reps=N_E2E,
               wall_s_runs=[min(wall), max(wall)],
               rgb_bytes_per_frame=shown[0].numel(),
               colour_launches_per_frame=n["color"] / len(shown))
    emit("player_end_to_end", **out,
         what="src -> ended, virtual clock, emit_rgb, RGB to host per frame")
    return out


def colour_work(h: int, w: int) -> tuple[int, int]:
    """What one (h, w) frame's RGB conversion must move and compute: luma
    and the chroma (ceil(h/2) x ceil(w/2) each) read once, the 3-channel
    image written once; COLOUR_FLOP_PER_PIXEL operations a pixel and one
    division a sample read (the scaling)."""
    chroma = 2 * (-(-h // 2)) * (-(-w // 2))
    return 4 * h * w + chroma, COLOUR_FLOP_PER_PIXEL * h * w + h * w + chroma


def colour_plan(y, cb, cr) -> dict:
    """The launch plan of ``ycbcr_to_rgb(y, cb, cr)`` on the card."""
    plan = color.launch_plan(
        *y.shape, 3, [p.stride(0) for p in (y, cb, cr)],
        [p.data_ptr() for p in (y, cb, cr)], 0)
    return dict(grid=plan.grid, seg_w=plan.seg_w, n_segs=plan.n_segs,
                flags=plan.flags, threads=plan.threads)


def colour_kernel_times(planes, dev, card: str) -> dict:
    """Colour of one 1080p frame's (Y, Cb, Cr) planes on the card, at a
    1920x1080 stream's display crop (CROP_1080: views of the coded
    planes, as the Player's ``_to_rgb`` passes them) and at the coded
    size: the kernel against its first design (``csrc/color_baseline.cu``)
    and its plain version, device time warm (calls back to back behind a
    spin, median of N_TIMED) and cold (a 64 MB write before each call), in
    turns (plain, first design, kernel, kernel, first design, plain),
    beside the bytes it must move, its bound and both kernels' ptxas
    report.  One ``kernel_time`` line per shape."""
    ptxas = {name: ptxas_report(build.load(lib).log, "colour_frame_kernel")
             for name, lib in (("kernel", "kernels"),
                               ("first_design", "baselines"))}
    h, w = CROP_1080
    rows = {}
    order = ("plain", "first_design", "kernel", "kernel", "first_design",
             "plain")
    for shape, (y, cb, cr) in (("display", display_crop(planes[:3], h, w)),
                               ("coded", tuple(planes[:3]))):
        fns = {"kernel": lambda: ycbcr_to_rgb(y, cb, cr),
               "first_design": lambda: colour_first_design(y, cb, cr, False),
               "plain": lambda: ycbcr_to_rgb_plain(y, cb, cr)}
        t = {name: dict(warm=[], cold=[], runs=[], cold_runs=[], ahead=1.0)
             for name in fns}
        for name in order:
            warm, ahead, _ = device_ms(fns[name], dev,
                                       4 if name == "plain" else 20)
            cold = cold_ms(fns[name], dev)
            r = t[name]
            r["warm"] += warm
            r["cold"] += cold
            r["runs"].append(statistics.median(warm))
            r["cold_runs"].append(statistics.median(cold))
            r["ahead"] = min(r["ahead"], ahead)
        work, flop = colour_work(*y.shape)
        b_ms, b_by = bound(work, flop)
        ms = {name: statistics.median(r["warm"]) for name, r in t.items()}
        cold = {name: statistics.median(r["cold"]) for name, r in t.items()}
        row = dict(ms=ms["kernel"], cold_ms=cold["kernel"],
                   first_design_ms=ms["first_design"],
                   first_design_cold_ms=cold["first_design"],
                   plain_ms=ms["plain"], plain_cold_ms=cold["plain"],
                   bound_ms=b_ms, bound_by=b_by, bytes=work, flop=flop)
        emit("kernel_time", kernel="ycbcr_to_rgb", stream="1080p",
             shape=shape, card=card, frame=list(y.shape),
             launches_per_frame=1, kernel_ms=row["ms"],
             kernel_cold_ms=row["cold_ms"],
             kernel_ms_runs=t["kernel"]["runs"],
             kernel_cold_ms_runs=t["kernel"]["cold_runs"],
             kernel_host_ahead_share=t["kernel"]["ahead"],
             first_design_ms=row["first_design_ms"],
             first_design_cold_ms=row["first_design_cold_ms"],
             first_design_ms_runs=t["first_design"]["runs"],
             first_design_cold_ms_runs=t["first_design"]["cold_runs"],
             first_design_host_ahead_share=t["first_design"]["ahead"],
             plain_ms=row["plain_ms"], plain_cold_ms=row["plain_cold_ms"],
             plain_ms_runs=t["plain"]["runs"],
             plain_cold_ms_runs=t["plain"]["cold_runs"],
             plain_host_ahead_share=t["plain"]["ahead"],
             speedup_vs_plain=row["plain_ms"] / row["ms"],
             speedup_vs_first_design=row["first_design_ms"] / row["ms"],
             bytes=work, flop=flop, bound_ms=b_ms, bound_by=b_by,
             bound_share=b_ms / row["ms"],
             bound_share_cold=b_ms / row["cold_ms"],
             first_design_bound_share=b_ms / row["first_design_ms"],
             first_design_bound_share_cold=b_ms
             / row["first_design_cold_ms"],
             achieved_gb_s=work / (row["ms"] * 1e-3) / 1e9,
             first_design_achieved_gb_s=work
             / (row["first_design_ms"] * 1e-3) / 1e9,
             plan=colour_plan(y, cb, cr), ptxas=ptxas,
             library_ms=None, library="no PyTorch call computes it: the "
             "plain version is some 25 torch ops", reps=2 * N_TIMED,
             order=list(order),
             l2="warm: back to back behind a spin; cold: a 64 MB write "
                "before each call")
        rows[shape] = row
    return rows


def colour_time(data: bytes, dev, card: str) -> dict:
    """Colour of one 1080p frame of ``data`` on the card
    (:func:`colour_kernel_times`), then the kernel per call at the display
    crop with the host in the loop, and with the RGB frame copied to the
    host as the Player's sink does (host clock, median of N_TIMED)."""
    d = Decoder(PlayerConfig(), device=dev)
    d.feed(0, data, total=len(data))
    planes = d.decode_frame().planes[:3]
    rows = colour_kernel_times(planes, dev, card)
    y, cb, cr = display_crop(planes, *CROP_1080)

    def colour():
        return ycbcr_to_rgb(y, cb, cr)

    call = call_ms(colour, dev)
    to_host = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        colour().cpu()
        to_host.append((time.perf_counter() - t0) * 1e3)
    out = dict(rows["display"], card=card, coded=rows["coded"],
               call_ms=statistics.median(call),
               with_copy_to_host_ms=statistics.median(to_host))
    emit("colour_time", card=card, shape=list(y.shape),
         device_ms=out["ms"], device_cold_ms=out["cold_ms"],
         first_design_device_ms=out["first_design_ms"],
         plain_device_ms=out["plain_ms"], call_ms=out["call_ms"],
         with_copy_to_host_ms=out["with_copy_to_host_ms"], reps=N_TIMED,
         what="ycbcr_to_rgb at the display crop: the colour kernel, one "
              "launch (plain: the torch ops before it, about 25 kernels)")
    return out


def two_kernel_gop_times(wire, spec, n_f: int, seq, meta, consts, dev,
                         card: str, fused_dev_ms: float,
                         fused_gop_ms: float) -> dict:
    """The two-kernel GOP decode of a resident wire against the same route
    with its first designs (per plane: torch sideband expansion,
    first-design MC, first-design reconstruction), in turns: first
    designs, new, new, first designs; device busy time and per call with
    the host in the loop, for the ``n_f`` frames of the GOP.  Needs
    :func:`first_design_route`."""

    def gop_two(impl):
        zr = zero_refs(seq.coded_height, seq.coded_width, meta.n_components,
                       dev)
        return decode_gop_wire(wire, spec, zr, consts, seq.mb_height,
                               seq.mb_width, impl=impl)

    routes = {}
    for impl in ("two_kernel_first_design", "two_kernel", "two_kernel",
                 "two_kernel_first_design"):
        d, cov, _ = device_ms(lambda: gop_two(impl), dev, 2)
        c = call_ms(lambda: gop_two(impl), dev)
        prev = routes.setdefault(impl, dict(dev=[], call=[], cov=1.0))
        prev["dev"] += d
        prev["call"] += c
        prev["cov"] = min(prev["cov"], cov)
    routes = {impl: dict(device_busy_ms=statistics.median(v["dev"]),
                         gop_ms=statistics.median(v["call"]),
                         host_ahead_share=v["cov"])
              for impl, v in routes.items()}
    for v in routes.values():
        v["frames_per_s"] = n_f / (v["gop_ms"] * 1e-3)
        v["device_idle_share"] = 1 - v["device_busy_ms"] / v["gop_ms"]
    emit("device_gop_decode_two_kernel", card=card, frames=n_f,
         **routes["two_kernel"],
         first_designs=routes["two_kernel_first_design"],
         fused_frames_per_s=n_f / (fused_gop_ms * 1e-3),
         fused_device_busy_ms=fused_dev_ms,
         reps=2 * N_TIMED, what="unflatten + expand + GOP loop (MC, "
                                "reconstruction), resident wire; the first "
                                "designs' route also expands the sideband "
                                "per plane")
    return routes


def stream_decoder_times(data: bytes, dev, card: str) -> None:
    """``StreamDecoder`` end to end (host clock, median of N_E2E after a
    warm-up) and its stages, through the two-kernel route with its first
    designs (on the eager loop, as before the GOP programs), the
    two-kernel route and the fused route (on their programs).  Needs
    :func:`first_design_route`."""
    for impl in ("two_kernel_first_design", "two_kernel", "fused"):
        m, wall = Metrics(), []
        for rep in range(N_E2E + 1):
            mm = Metrics() if rep == 0 else m  # rep 0 is the warm-up
            sync(dev)
            t0 = time.perf_counter()
            with (eager_route() if impl == "two_kernel_first_design"
                  else contextlib.nullcontext()):
                r = StreamDecoder(data, device=dev).decode(impl=impl,
                                                           metrics=mm)
            sync(dev)
            if rep:
                wall.append(time.perf_counter() - t0)
        n_fr = len(r.frames)
        emit("stream_decoder_end_to_end", card=card, impl=impl, frames=n_fr,
             median_s=statistics.median(wall),
             frames_per_s=n_fr / statistics.median(wall), reps=N_E2E,
             stage_s_per_run={k: v / N_E2E
                              for k, v in m.timers.totals.items()},
             what="parse_all + pack + one copy per GOP + GOP decode; "
                  "frames stay on the card")


# ---------------------------------------------------------------------------
# Phase 6: row-band and GOP sharding

#: ranks of the gloo world (all on one card) and repetitions of its timings
SHARD_RANKS = 4
SHARD_REPS = 5
#: the worlds the rank phase starts: the ranks share this card under gloo;
#: NCCL needs a card per rank, so it runs one
SHARD_WORLDS = (("gloo", SHARD_RANKS), ("nccl", 1))
SHARD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "jsvx_torch", "shard")


def gop_batch(gops: list) -> dict:
    """Stacked GOPs (dicts of tensors) -> one batch on a leading GOP
    axis."""
    return {k: ({f: torch.stack([g[k][f] for g in gops]) for f in v}
                if isinstance(v, dict) else torch.stack([g[k] for g in gops]))
            for k, v in gops[0].items()}


def plain_gop(dense: dict, refs: tuple, consts) -> list:
    """A GOP decoded by the kernels' plain versions (torch ops, no kernel
    launch) on the tensors' device: (Y, Cb, Cr[, A]) stacks, frames
    leading."""
    frames = []
    for i in range(int(dense["is_p"].shape[0])):
        refs = decode_frame_planes(frame_at(dense, i), refs, consts)
        frames.append(refs)
    return [torch.stack(p) for p in zip(*frames)]


def shard_inputs(data: bytes, dev) -> tuple:
    """Both GOPs of the 1080p fixture on the card as the decode takes them
    (compact wire, expanded), their constants, a maker of zero reference
    planes, and each GOP's plain decode (:func:`plain_gop`)."""
    meta, seq, _, _, _, d0 = gop_on_card(data, 0, dev)
    d1 = gop_on_card(data, 1, dev)[5]
    consts = make_constants(seq, dev)

    def zr():
        return zero_refs(seq.coded_height, seq.coded_width,
                         meta.n_components, dev)

    refs = [plain_gop(d, zr(), consts) for d in (d0, d1)]
    return seq, consts, [d0, d1], zr, refs


def differing(planes, want) -> int:
    return sum(int((p != w).sum()) for p, w in zip(planes, want, strict=True))


def shard_rank(rank: int, world: int, fixture: str, device: str) -> None:
    """One rank of the shard phase, on ``device`` (started by
    ``jsvx_torch.shard.launch.run_ranks``; gloo when ranks share the
    card).  Each decode runs with the launch counts set to 0 just before
    it and read just after: the fixture's GOP 0 in ``world`` row bands;
    both GOPs on a (gop, rows) mesh, in bands and through
    ``decode_gops_parallel``; the synthetic f_code 6 GOP (its halo reaches
    a four-way band's height: the all-gather), each held against the
    plain decode (:func:`plain_gop`); then ``gather_row_halo``'s window,
    the exchange per plane (host clock) and the banded GOP's wall time.
    Prints one JSON line."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with open(fixture, "rb") as f:
        data = f.read()
    n_gop = 2 if world % 2 == 0 else 1
    mesh_rows = build_mesh({"rows": world})
    mesh_2d = build_mesh({"gop": n_gop, "rows": world // n_gop})
    seq, consts, gops, zr, refs = shard_inputs(data, dev)
    n_f = int(gops[0]["is_p"].shape[0])
    halo_y = slice_rows.derive_halo_y(gops[0])
    out = {"rank": rank, "world": world, "backend": str(dist.get_backend()),
           "halo_y": halo_y}

    (bands, _), n = counted(lambda: decode_gop_rows_sharded(
        gops[0], zr(), consts, mesh_rows, device=dev))
    whole = [gather_rows(b, mesh_rows) for b in bands]
    out["rows"] = dict(launches=n, frames=n_f,
                       band_shape=list(bands[0].shape[1:]),
                       mismatching_pixels=differing(whole, refs[0]))

    batch = gop_batch(gops)
    init = tuple(torch.stack([r, r]) for r in zr())
    (o2, _, g2), n = counted(lambda: decode_gops_2d_sharded(
        batch, init, consts, mesh_2d, device=dev))
    out["gops_2d"] = dict(
        gops=list(g2), launches=n, frames=n_f * len(g2),
        mismatching_pixels=sum(differing(
            [gather_rows(o[j], mesh_2d) for o in o2], refs[g])
            for j, g in enumerate(g2)))
    # the rank's share through its GOP program: the first sight captures,
    # the second call replays, the eager loop gives the same planes
    calls = {}
    for name in ("first", "again", "eager"):
        m = Metrics()
        with eager_route() if name == "eager" else contextlib.nullcontext():
            (op, _, gp), n = counted(lambda: decode_gops_parallel(
                batch, seq.coded_height, seq.coded_width, consts, mesh_2d,
                device=dev, metrics=m))
        calls[name] = dict(planes=[[o[j] for o in op]
                                   for j in range(len(gp))], launches=n,
                           captures=m.counters.get("gop_program.captures",
                                                   0),
                           replays=m.counters.get("gop_program.replays", 0))
    first = calls["first"]
    out["gop_parallel"] = dict(
        gops=list(gp), launches=first["launches"], frames=n_f * len(gp),
        mismatching_pixels=sum(differing(p, refs[g]) for p, g in zip(
            first["planes"], gp)),
        program={name: dict(captures=c["captures"], replays=c["replays"],
                            launches=c["launches"])
                 for name, c in calls.items()},
        vs_eager_mismatching_pixels=sum(
            differing(a, b) for name in ("first", "again")
            for a, b in zip(calls[name]["planes"], calls["eager"]["planes"])))

    syn = synthetic_gop(max_mv=200, seed=60)
    sc = make_constants(None, dev)
    szr = zero_refs(1088, 1920, 3, dev)
    (sb, _), n = counted(lambda: decode_gop_rows_sharded(
        syn, szr, sc, mesh_rows, device=dev))
    want = plain_gop(slice_rows.cut_band(syn, 0, 1, dev), szr, sc)
    syn_halo = slice_rows.derive_halo_y(syn)
    out["all_gather"] = dict(
        halo_y=syn_halo, band_rows=int(sb[0].shape[1]),
        all_gather=syn_halo >= sb[0].shape[1], launches=n,
        frames=int(syn["is_p"].shape[0]),
        mismatching_pixels=differing([gather_rows(b, mesh_rows)
                                      for b in sb], want))

    plane = bands[0][-1]
    h_local = plane.shape[0]
    win = gather_row_halo(plane, 64, mesh_rows)
    out["gather_window_mismatching_pixels"] = int((win != slice_rows
        .edge_window(whole[0][-1], mesh_rows.index("rows") * h_local,
                     h_local, 64)).sum())

    ex = []
    for b, halo in zip(bands, slice_rows.plane_halos(gops[0], halo_y)):
        ts = []
        for _ in range(4 * SHARD_REPS):
            sync(dev)
            t0 = time.perf_counter()
            slice_rows.extend_band(b[-1], halo, mesh_rows)
            sync(dev)
            ts.append((time.perf_counter() - t0) * 1e3)
        ex.append(statistics.median(ts))
    out["exchange_ms_per_plane"] = ex
    walls = []
    for _ in range(SHARD_REPS):
        dist.barrier()
        sync(dev)
        t0 = time.perf_counter()
        decode_gop_rows_sharded(gops[0], zr(), consts, mesh_rows, device=dev)
        sync(dev)
        walls.append(time.perf_counter() - t0)
    out["rows_gop_wall_s"] = walls
    print(json.dumps(out), flush=True)


def band_launches(dense: dict, decoded: list, halo_y: int, consts, dev,
                  n: int = SHARD_RANKS) -> tuple:
    """The MC and reconstruction launches of the P picture (frame 1) of a
    GOP, for the whole picture and for ``n`` row bands, each band's
    extended planes (``halo_y`` luma rows each side) cut from frame 0 of
    ``decoded`` (what the exchange or the all-gather gives).  Runs each once, then holds every band's
    prediction and planes against the kernels' plain versions on the same
    card tensors (``predict_plane`` over the extended plane cast to int16,
    ``recon_plane_blocks`` on the band), and the bands against the whole
    picture's launch and the whole picture against frame 1 of ``decoded``
    (a plain decode): 0 differing pixels.  Returns (the launches by name,
    the check's row, the max |kernel - plain| of each kernel)."""
    frame = frame_at(dense, 1)
    refs = tuple(p[0] for p in decoded)
    preds = tuple(torch.empty(r.shape, dtype=torch.int16, device=dev)
                  for r in refs)
    outs = tuple(torch.empty_like(r) for r in refs)
    bands = []
    for b in range(n):
        bf = frame_at(slice_rows.cut_band(dense, b, n, dev), 1)
        halos = slice_rows.plane_halos(bf, halo_y)
        ext = tuple(slice_rows.edge_window(r, b * (r.shape[0] // n),
                                           r.shape[0] // n, h)
                    for r, h in zip(refs, halos))
        ep = tuple(torch.empty(e.shape, dtype=torch.int16, device=dev)
                   for e in ext)
        pp = tuple(p[h:p.shape[0] - h] for p, h in zip(ep, halos))
        bands.append(dict(
            frame=bf, side=slice_rows.halo_sideband(bf, halo_y),
            halos=halos, ext=ext, ep=ep, pp=pp,
            bo=tuple(torch.empty(p.shape, dtype=torch.uint8, device=dev)
                     for p in pp)))
    fns = {
        "mc_whole": lambda: mc.predict_picture_mc(frame, refs, outs=preds),
        "mc_bands": lambda: [mc.predict_picture_mc(bd["side"], bd["ext"],
                                                   outs=bd["ep"])
                             for bd in bands],
        "recon_whole": lambda: recon.recon_picture(
            frame, preds, frame["is_p"], consts, outs=outs),
        "recon_bands": lambda: [recon.recon_picture(
            bd["frame"], bd["pp"], bd["frame"]["is_p"], consts,
            outs=bd["bo"]) for bd in bands]}
    for fn in fns.values():
        fn()
    sync(dev)
    n_diff = {"mc_vs_plain": 0, "recon_vs_plain": 0}
    err = {"mc": 0, "recon": 0}
    for bd in bands:
        bf = bd["frame"]
        for c, key in enumerate(frame_comp_keys(bf)):
            h = bd["halos"][c]
            p = predict_plane(bd["ext"][c], bd["side"][key]["mv"],
                              bd["side"][key]["rep_add"],
                              comp_is_chroma(c)).to(torch.int16)
            r = recon.recon_plane_blocks(bf[key], p[h:p.shape[0] - h],
                                         bf["is_p"], consts)
            for k, got, want in (("mc", bd["ep"][c], p),
                                 ("recon", bd["bo"][c], r)):
                n_diff[f"{k}_vs_plain"] += int((got != want).sum())
                err[k] = max(err[k], int((got.int() - want.int())
                                         .abs().max()))
    n_diff.update(
        prediction_vs_whole=sum(int((torch.cat([bd["pp"][c] for bd in bands])
                                     != preds[c]).sum())
                                for c in range(len(refs))),
        planes_vs_whole=sum(int((torch.cat([bd["bo"][c] for bd in bands])
                                 != outs[c]).sum())
                            for c in range(len(refs))),
        whole_vs_plain_gop_decode=differing(outs, tuple(p[1]
                                                        for p in decoded)))
    check(not any(n_diff.values()),
          f"band launches differ from their plain versions or the whole "
          f"picture's: {n_diff}")
    row = dict(bands=n, halo_y=halo_y, frame=1, is_p=int(frame["is_p"]),
               band_shapes=[list(p.shape) for p in bands[0]["pp"]],
               extended_shapes=[list(e.shape) for e in bands[0]["ext"]],
               all_gather=halo_y >= bands[0]["pp"][0].shape[0],
               mismatching_pixels=n_diff, max_abs_err=err)
    return fns, row, err


def band_kernel_times(dense: dict, decoded: list, consts, dev, card: str,
                      n: int = SHARD_RANKS) -> tuple:
    """:func:`band_launches` on a GOP, then device time in turns (whole,
    bands, bands, whole), warm and cold.  Returns (the timing row, the
    max |kernel - plain| of each kernel)."""
    fns, row, err = band_launches(dense, decoded,
                                  slice_rows.derive_halo_y(dense), consts,
                                  dev, n)
    t = turns(fns, ["mc_whole", "mc_bands", "mc_bands", "mc_whole",
                    "recon_whole", "recon_bands", "recon_bands",
                    "recon_whole"], dev)
    row.update(card=card, reps=2 * N_TIMED,
               launches_per_band_and_picture={"mc": 1, "recon": 1})
    for k in ("mc", "recon"):
        whole, banded = t[f"{k}_whole"], t[f"{k}_bands"]
        row[k] = dict(whole_ms=whole["ms"], whole_cold_ms=whole["cold_ms"],
                      bands_ms=banded["ms"], bands_cold_ms=banded["cold_ms"],
                      per_band_ms=banded["ms"] / n,
                      per_band_cold_ms=banded["cold_ms"] / n,
                      bands_over_whole=banded["ms"] / whole["ms"],
                      whole_ms_runs=whole["ms_runs"],
                      bands_ms_runs=banded["ms_runs"])
    emit("shard_band_kernel_time", **row,
         what="MC and reconstruction launches of one P picture: the whole "
              "picture, against n bands launched one after another "
              "(per_band_ms = bands_ms / n)")
    return row, err


def check_shard_rank(r: dict, backend: str, n_f: int) -> None:
    """The checks of one rank's report: bit-equal everywhere, each kernel
    launched once per picture on its route, no torch sideband
    expansion."""
    emit("shard_rank", **r)
    check(r["backend"] == backend, f"rank {r['rank']}: backend "
                                   f"{r['backend']}, expected {backend}")

    def want(route, frames):
        if route == "fused":
            return want_counts(fused=frames)
        return want_counts(mc=frames, recon=frames)

    for key, route in (("rows", "two_kernel"), ("gops_2d", "two_kernel"),
                       ("gop_parallel", "fused"), ("all_gather",
                                                    "two_kernel")):
        got = r[key]
        check(got["frames"] > 0 and got["launches"] == want(
            route, got["frames"]),
              f"rank {r['rank']} {key}: launches {got['launches']} for "
              f"{got['frames']} pictures")
        check(got["mismatching_pixels"] == 0,
              f"rank {r['rank']} {key}: {got['mismatching_pixels']} pixels "
              f"differ from the plain decode")
    gp = r["gop_parallel"]
    check(gp["program"] == {
        "first": dict(captures=1, replays=0, launches=gp["launches"]),
        "again": dict(captures=0, replays=1, launches=gp["launches"]),
        "eager": dict(captures=0, replays=0, launches=gp["launches"])}
        and gp["vs_eager_mismatching_pixels"] == 0,
        f"rank {r['rank']} gop_parallel's program: {gp['program']}, "
        f"{gp['vs_eager_mismatching_pixels']} pixels differ from eager")
    check(r["rows"]["frames"] == n_f, f"rank {r['rank']}: frames")
    check(r["gather_window_mismatching_pixels"] == 0,
          f"rank {r['rank']}: gather_row_halo's window differs")
    if r["world"] == SHARD_RANKS:
        check(r["all_gather"]["all_gather"],
              f"rank {r['rank']}: the synthetic GOP did not take the "
              f"all-gather")


def shard_phase(data: bytes, fix: str, dev, card: str) -> dict:
    """Phase 6: a (gop 1, rows 1) mesh without a process group; the band
    launches against their plain versions and the whole picture's, on the
    fixture (timed) and on the synthetic f_code 6 GOP; SHARD_RANKS gloo
    ranks on this card, then one NCCL rank (:func:`shard_rank`); the
    one-process GOP wall time beside the banded one; ``bench_scaling``
    with 2 processes on the card.  Returns the timings and the max
    |kernel - plain| of the band launches."""
    seq, consts, gops, zr, refs = shard_inputs(data, dev)
    n_f = int(gops[0]["is_p"].shape[0])
    check(not dist.is_initialized(), "a process group is initialised")
    mesh1 = build_mesh({"gop": 1, "rows": 1})
    (o1, _, g1), n = counted(lambda: decode_gops_2d_sharded(
        gop_batch(gops), tuple(torch.stack([r, r]) for r in zr()), consts,
        mesh1, device=dev))
    d1 = sum(differing([o[j] for o in o1], refs[g]) for j, g in
             enumerate(g1))
    emit("shard_mesh_of_one", groups=[g is None for g in
                                      mesh1.groups.values()],
         gops=list(g1), launches=n, mismatching_pixels=d1)
    check(n == want_counts(mc=2 * n_f, recon=2 * n_f) and d1 == 0,
          f"1x1 mesh: launches {n}, {d1} pixels differ")

    bands, err = band_kernel_times(gops[0], refs[0], consts, dev, card)
    syn = synthetic_gop(max_mv=200, seed=60)
    sc = make_constants(None, dev)
    syn_dense = slice_rows.cut_band(syn, 0, 1, dev)
    _, syn_row, syn_err = band_launches(
        syn_dense, plain_gop(syn_dense, zero_refs(1088, 1920, 3, dev), sc),
        slice_rows.derive_halo_y(syn), sc, dev)
    emit("shard_band_vs_plain", stream="synthetic-f_code-6", **syn_row)
    check(syn_row["all_gather"], "the synthetic GOP's halo does not reach "
                                 "the band height")
    err = {k: max(v, syn_err[k]) for k, v in err.items()}

    walls = []
    for _ in range(SHARD_REPS + 1):
        sync(dev)
        t0 = time.perf_counter()
        decode_gop(gops[0], zr(), consts, impl="two_kernel")
        sync(dev)
        walls.append(time.perf_counter() - t0)
    one_s = statistics.median(walls[1:])

    reports = []
    for backend, world in SHARD_WORLDS:
        t0 = time.perf_counter()
        outs = run_ranks("chip_smoke:shard_rank", world, SHARD_DIR, fix,
                         str(dev), backend=backend, timeout_s=420,
                         group_timeout_s=120)
        reports.append([json.loads(o.strip().splitlines()[-1])
                        for o in outs])
        for r in reports[-1]:
            check_shard_rank(r, backend, n_f)
        emit("shard_world", backend=backend, ranks=world,
             seconds=time.perf_counter() - t0)

    gloo = reports[0]
    rows_s = statistics.median([max(r["rows_gop_wall_s"][i] for r in gloo)
                                for i in range(SHARD_REPS)])
    exch = [statistics.median([r["exchange_ms_per_plane"][c] for r in gloo])
            for c in range(len(gloo[0]["exchange_ms_per_plane"]))]
    timing = dict(card=card, ranks=SHARD_RANKS, frames=n_f,
                  halo_y=gloo[0]["halo_y"],
                  rows_gop_wall_s=rows_s, one_process_gop_wall_s=one_s,
                  rows_over_one_process=rows_s / one_s,
                  exchange_ms_per_frame_and_plane=exch,
                  exchange_ms_per_frame=sum(exch),
                  exchange_ms_per_plane_by_rank=[
                      r["exchange_ms_per_plane"] for r in gloo],
                  nccl_rows_gop_wall_s=statistics.median(
                      reports[1][0]["rows_gop_wall_s"]),
                  reps=SHARD_REPS)
    emit("shard_time", **timing,
         what="host clock: the fixture's GOP 0 in 4 gloo ranks on one card "
              "(the slowest rank per repetition, median) against one "
              "process's two-kernel decode; each exchange_row_halo of a "
              "band's last frame, synchronised on both sides, median over "
              "reps and ranks")

    proc = subprocess.run(
        [sys.executable, "-m", "jsvx_torch.tools.bench_scaling", "2", fix,
         "--device", str(dev)], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"bench_scaling exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    scaling = json.loads(proc.stdout.strip().splitlines()[-1])
    emit("bench_scaling", card=card, **scaling)
    return dict(bands=bands, timing=timing, scaling=scaling, max_abs_err=err)


# ---------------------------------------------------------------------------
# Phase 7: the pipelined transcode, the tools and damaged input

#: GOPs of the long stream (the fixture's two, repeated)
LONG_GOPS = 8
#: the shape of ``python -m jsvx_torch warm --shape`` (jsvx's synthesised
#: warm stream, its own GOP length and buckets) and of ``tools/bench_mc.py``'s
#: luma plane
WARM_SHAPE = "1920x1088"
#: bit-flipped copies of the fixture (4 flips each, as test_corrupt_streams)
N_FLIPPED = 6
#: the kernels' symbols a ``bench --trace`` must name
KERNEL_SYMBOLS = ("fused_decode_picture_kernel", "mc_picture_kernel",
                  "recon_picture_kernel", "expand_gop_kernel")
#: the stages in which the host waits on purpose (an event's synchronise)
WAIT_STAGES = ("wire_wait", "device_wait")
#: where the bench subprocesses write their traces
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "jsvx_torch", "trace")


def long_stream(data: bytes, copies: int) -> bytes:
    """``data`` with its GOPs repeated ``copies`` times: the container
    header once, then the elementary stream (each GOP opens with a
    sequence header) over and over.  GOP g decodes as GOP g mod (the GOPs
    of ``data``)."""
    meta = parse_container_header(BitReader(data))
    body = data[meta.header_bytes:]
    check(body[:4] == b"\x00\x00\x01" + bytes([START_SEQUENCE]),
          "no sequence header after the container header")
    return data + body * (copies - 1)


class StageWatch(StageTimer):
    """A stage timer that notes which of the warnings in ``caught`` each
    stage raised: ``spans`` holds (stage, first warning, past the last),
    ``gop0_end`` the count of warnings when GOP 0's dispatch ended."""

    def __init__(self, caught: list):
        super().__init__()
        self.caught = caught
        self.spans: list = []
        self.gop0_end = None

    @contextlib.contextmanager
    def stage(self, name: str, **attrs):
        n0 = len(self.caught)
        with super().stage(name, **attrs) as s:
            yield s
        self.spans.append((name, n0, len(self.caught)))
        if name == "device_dispatch" and self.gop0_end is None:
            self.gop0_end = len(self.caught)


@contextlib.contextmanager
def pinned_buffers(record: list):
    """Record, for every buffer a ``BufferPool`` hands out, whether it is
    page-locked."""
    real = packed_parse.BufferPool.acquire

    def acquire(self, shape, dtype):
        arr = real(self, shape, dtype)
        record.append(bool(torch.from_numpy(arr).is_pinned()))
        return arr

    packed_parse.BufferPool.acquire = acquire
    try:
        yield
    finally:
        packed_parse.BufferPool.acquire = real


def watched_transcode(data: bytes, dev, impl: str = "fused",
                      quirk: bool = False) -> dict:
    """One ``transcode`` with CUDA's sync debug mode on ("warn"), each
    warning placed in its stage; a sink that keeps each GOP's planes on
    the card as given; the launches counted; the pooled buffers' pinning
    recorded."""
    kept, pins = {}, []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        timer = StageWatch(caught)
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with pinned_buffers(pins):
                res, n = counted(lambda: transcode(
                    data, lambda gi, outs: kept.__setitem__(gi, outs),
                    device=dev, impl=impl, quirk_oddify_zeros=quirk,
                    metrics=Metrics(timers=timer)))
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    after = set(range(timer.gop0_end or 0, len(caught)))
    in_waits = set()
    for name, a, b in timer.spans:
        if name in WAIT_STAGES:
            in_waits |= set(range(a, b))
    by_stage: dict = {}
    for name, a, b in timer.spans:
        if b > a:
            by_stage[name] = by_stage.get(name, 0) + b - a
    ptrs = [o.data_ptr() for outs in kept.values() for o in outs]
    frames = [tuple(s[i].cpu().numpy() for s in kept[g]) for g in sorted(kept)
              for i in range(kept[g][0].shape[0])]
    return dict(res=res, launches=n, frames=frames, pins=pins,
                warnings=len(caught), warnings_by_stage=by_stage,
                after_gop0_outside_waits=len(after - in_waits),
                after_gop0_in_waits=len(after & in_waits),
                distinct_planes=len(set(ptrs)) == len(ptrs),
                stages=timer.report(), gops=sorted(kept))


def check_pipelined(label: str, data: bytes, dev, impl: str, quirk: bool,
                    want: list, card: str) -> dict:
    """The pipelined ``transcode`` on the card against ``want`` (the CPU's
    planes) and against ``StreamDecoder`` on the card: 0 differing pixels,
    the planes the sink kept still equal after the run, the launches of the
    route once per picture and the expansion kernel's once per compact GOP
    (none with the quirk, whose route is the dense wire), no plain
    expansion, every pooled buffer pinned, no sync warning after GOP 0's
    dispatch outside the deliberate waits; its stage split per GOP."""
    w = watched_transcode(data, dev, impl, quirk)
    res, n = w["res"], w["launches"]
    n_f = res.n_frames
    stream = stream_frames_quirk(data, dev, impl, quirk)
    d_cpu = mismatching_pixels(w["frames"], want)
    d_stream = mismatching_pixels(w["frames"], stream)
    n_compact = 0 if quirk else compact_gops(data)
    expected = (want_counts(fused=n_f, expand=n_compact) if impl == "fused"
                else want_counts(mc=n_f, recon=n_f, expand=n_compact))
    per_gop = {k: v["total_s"] / res.n_gops for k, v in w["stages"].items()}
    emit("pipelined_transcode", stream=label, impl=impl, quirk=quirk,
         card=card, frames=n_f, gops=res.n_gops, launches=n,
         expected_launches=expected, vs_cpu_mismatching_pixels=d_cpu,
         vs_stream_decoder_mismatching_pixels=d_stream,
         sink_planes_distinct=w["distinct_planes"],
         pooled_buffers=len(w["pins"]), pinned=sum(w["pins"]),
         sync_warnings=w["warnings"],
         sync_warnings_by_stage=w["warnings_by_stage"],
         sync_warnings_after_gop0_outside_waits=w[
             "after_gop0_outside_waits"],
         sync_warnings_after_gop0_in_waits=w["after_gop0_in_waits"],
         stage_s_per_gop=per_gop,
         stage_counts={k: v["count"] for k, v in w["stages"].items()})
    check(d_cpu == 0 and d_stream == 0 and len(w["frames"]) == n_f > 0,
          f"{label} {impl}: {d_cpu} pixels differ from the CPU, {d_stream} "
          f"from StreamDecoder")
    check(n == expected, f"{label} {impl}: launches {n}")
    check(w["distinct_planes"], f"{label}: a sink plane was reused")
    if dev.type == "cuda":
        check(w["pins"] and all(w["pins"]),
              f"{label}: {w['pins'].count(False)} pooled buffers unpinned")
    check(w["after_gop0_outside_waits"] == 0,
          f"{label} {impl}: {w['after_gop0_outside_waits']} sync warnings "
          f"after GOP 0's dispatch: {w['warnings_by_stage']}")
    return w


def stream_frames_quirk(data: bytes, device, impl: str, quirk: bool) -> list:
    res = StreamDecoder(data, quirk, device=device).decode(impl=impl)
    return [tuple(p.cpu().numpy() for p in f) for f in res.frames]


def transcode_rate(data: bytes, dev, keep: bool, card: str,
                   gop_dev_ms: float, label: str) -> dict:
    """``transcode`` end to end (host clock, median of N_E2E after a
    warm-up) with a sink that keeps the planes on the card or copies them
    to the host; the stage split per GOP and the device idle share (the
    resident GOP decode's device time, once per GOP, against the run)."""
    def sink(gi, outs):
        return outs if keep else [o.cpu() for o in outs]

    m, wall = Metrics(), []
    for rep in range(N_E2E + 1):
        mm = Metrics() if rep == 0 else m  # rep 0 is the warm-up
        sync(dev)
        t0 = time.perf_counter()
        r = transcode(data, sink, device=dev, metrics=mm)
        sync(dev)
        if rep:
            wall.append(time.perf_counter() - t0)
    med = statistics.median(wall)
    out = dict(card=card, stream=label, sink="keep on card" if keep
               else "copy to host", frames=r.n_frames, gops=r.n_gops,
               median_s=med, frames_per_s=r.n_frames / med,
               wall_s_runs=[min(wall), max(wall)], reps=N_E2E,
               stage_s_per_gop={k: v / N_E2E / r.n_gops
                                for k, v in m.timers.totals.items()},
               device_idle_share=1 - r.n_gops * gop_dev_ms * 1e-3 / med,
               wire_bytes_per_run=m.gauges["wire_bytes"])
    emit("pipelined_end_to_end", **out)
    return out


def trace_symbols(path: str, dev, impl: str) -> dict:
    """``python -m jsvx_torch bench PATH --trace DIR --impl IMPL`` in a
    subprocess: its report and, per kernel symbol, the kernel events of
    its trace that name it."""
    trace_dir = os.path.join(TRACE_DIR, impl)
    proc = subprocess.run(
        [sys.executable, "-m", "jsvx_torch", "bench", path, "--trace",
         trace_dir, "--impl", impl, "--device", str(dev)],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"bench exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    out = proc.stdout
    report = json.loads(out[out.index("{"):])
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = [str(e.get("name", "")) for e in events
             if e.get("cat") == "kernel"]
    found = {s: sum(s in nm for nm in names) for s in KERNEL_SYMBOLS}
    return dict(report=report, found=found, events=len(events))


def damaged_inputs(data: bytes) -> list:
    """(label, bytes, total) of test_corrupt_streams' damage on ``data``:
    three truncations fed with the true total, one that is the whole
    stream, and N_FLIPPED copies with 4 flipped bits each past the
    container header."""
    out = [(f"truncated_{c}", data[:c], len(data))
           for c in (len(data) // 3, len(data) // 2, len(data) - 5)]
    cut = int(len(data) * 0.7)
    out.append((f"truncated_final_{cut}", data[:cut], cut))
    rng = np.random.default_rng(42)
    for trial in range(N_FLIPPED):
        buf = bytearray(data)
        for _ in range(4):
            pos = int(rng.integers(60, len(buf)))
            buf[pos] ^= 1 << int(rng.integers(0, 8))
        out.append((f"bit_flips_{trial}", bytes(buf), len(buf)))
    return out


def decoder_outcome(data: bytes, total: int, device) -> tuple:
    """The Decoder (GOP batch) fed ``data`` with ``total`` declared,
    decoded until it stalls, ends or raises: (frames, stalls, error)."""
    d = Decoder(PlayerConfig(), device=device)
    stalls, frames = [], []
    d.on("stalled", stalls.append)
    try:
        d.feed(0, data, total=total)
        for _ in range(100):
            f = d.decode_frame()
            if f is None:
                break
            frames.append(tuple(p.cpu().numpy() for p in f.planes))
    except ValueError as e:
        return frames, stalls, type(e).__name__
    return frames, stalls, None


def transcode_outcome(data: bytes, device, impl: str, quirk: bool = False,
                      metrics: Metrics | None = None) -> tuple:
    """``transcode`` of ``data``: (GOPs delivered, frames, error)."""
    got = {}
    try:
        transcode(data, lambda gi, outs: got.__setitem__(
            gi, [o.cpu() for o in outs]), device=device, impl=impl,
            quirk_oddify_zeros=quirk, metrics=metrics)
        err = None
    except ValueError as e:
        err = type(e).__name__
    frames = [tuple(s[i].numpy() for s in got[g]) for g in sorted(got)
              for i in range(got[g][0].shape[0])]
    return sorted(got), frames, err


def check_damaged(data: bytes, dev, card: str) -> dict:
    """Each damaged input through the Decoder and through ``transcode``
    (both routes) on the card and on the CPU: the same outcome, the same
    stalls or GOPs delivered, and the card's frames equal to the CPU's."""
    totals = dict(inputs=0, frames_on_card=0, errors=0)
    cpu = torch.device("cpu")
    for label, bad, total in damaged_inputs(data):
        (fd, sd, ed), n = counted(lambda: decoder_outcome(bad, total, dev))
        fc, sc, ec = decoder_outcome(bad, total, cpu)
        d_dec = mismatching_pixels(fd, fc) if fd or fc else 0
        row = dict(input=label, bytes=len(bad), decoder_frames=len(fd),
                   decoder_stalls=len(sd), decoder_error=ed,
                   decoder_launches=n["fused"],
                   decoder_vs_cpu_mismatching_pixels=d_dec)
        check(sd == sc and ed == ec and len(fd) == len(fc) and d_dec == 0,
              f"{label}: the Decoder on the card ({len(fd)} frames, "
              f"{ed}) differs from the CPU ({len(fc)} frames, {ec})")
        # the CPU's two routes agree bit for bit (tests/test_torch_*.py)
        want = transcode_outcome(bad, cpu, "fused")
        for impl in ("fused", "two_kernel"):
            gd, ft, et = transcode_outcome(bad, dev, impl)
            d_tr = mismatching_pixels(ft, want[1]) if ft or want[1] else 0
            row[f"transcode_{impl}"] = dict(gops=gd, frames=len(ft),
                                            error=et,
                                            vs_cpu_mismatching_pixels=d_tr)
            check(gd == want[0] and et == want[2] and d_tr == 0,
                  f"{label} transcode {impl}: GOPs {gd} {et} on the card, "
                  f"{want[0]} {want[2]} on the CPU, {d_tr} pixels differ")
            totals["frames_on_card"] += len(ft)
        totals["inputs"] += 1
        totals["frames_on_card"] += len(fd)
        totals["errors"] += (ed is not None) + (row["transcode_fused"]
                                                ["error"] is not None)
        emit("damaged_input", card=card, **row)
    return totals


def pipeline_phase(data: bytes, fix: str, dev, card: str, cpu_frames: list,
                   gop_dev_ms: float, expand_dev_ms: float) -> dict:
    """Phase 7.  ``cpu_frames`` is the fixture's transcode on the CPU,
    ``gop_dev_ms`` the device time of its resident GOP decode and
    ``expand_dev_ms`` that of its expansion (phase 5)."""
    n_gops = len(walk_stream(data)[2])
    dirty = dirty_stream()
    dirty_cpu = collect(dirty, torch.device("cpu"))[0]
    for impl in ("fused", "two_kernel"):
        check_pipelined("1080p", data, dev, impl, False, cpu_frames, card)
        check_pipelined("48x64-dirty", dirty, dev, impl, False, dirty_cpu,
                        card)
    quirk_cpu = collect(data, torch.device("cpu"), "two_kernel",
                        quirk=True)[0]
    for impl in ("fused", "two_kernel"):
        check_pipelined("1080p-quirk", data, dev, impl, True, quirk_cpu,
                        card)
    longer = long_stream(data, LONG_GOPS // n_gops)
    long_cpu = cpu_frames * (LONG_GOPS // n_gops)
    for impl in ("fused", "two_kernel"):
        w = check_pipelined(f"1080p-{LONG_GOPS}-gops", longer, dev, impl,
                            False, long_cpu, card)
        check(w["res"].n_gops == LONG_GOPS, f"{w['res'].n_gops} GOPs")

    rates = [transcode_rate(d, dev, keep, card, gop_dev_ms, label)
             for d, label in ((data, "1080p"),
                              (longer, f"1080p-{LONG_GOPS}-gops"))
             for keep in (True, False)]

    probe = transcode(data, device=dev, probe_expand=True)
    gauge = probe.metrics.gauges["expand_probe_s_per_gop"]
    emit("expand_probe", card=card, expand_probe_s_per_gop=gauge,
         expand_probe_compile_s=probe.metrics.timers.totals[
             "expand_probe_compile"],
         cuda_event_expand_ms=expand_dev_ms,
         probe_over_events=gauge * 1e3 / expand_dev_ms,
         what="probe: host clock around unflatten + expand + synchronise, "
              "best of 3; events: device time per expansion, median of "
              f"{N_TIMED} (phase 5)")

    # the 8-GOP stream, whose keys repeat: most of its GOPs are replays of
    # a GOP program, and the trace must still name every kernel they run
    long_path = os.path.join(TRACE_DIR, f"long_{LONG_GOPS}.jsv")
    os.makedirs(TRACE_DIR, exist_ok=True)
    with open(long_path, "wb") as f:
        f.write(longer)
    traces = {impl: trace_symbols(long_path, dev, impl)
              for impl in ("fused", "two_kernel")}
    found = {s: sum(t["found"][s] for t in traces.values())
             for s in KERNEL_SYMBOLS}
    n_f = len(long_cpu)
    want = dict(zip(KERNEL_SYMBOLS, (n_f, n_f, n_f, 2 * LONG_GOPS)))
    counters = {i: t["report"]["counters"] for i, t in traces.items()}
    emit("bench_trace", card=card, stream=f"1080p-{LONG_GOPS}-gops",
         kernel_events=found, expected_kernel_events=want,
         counters=counters,
         fps_end_to_end={i: t["report"]["fps_end_to_end"]
                         for i, t in traces.items()},
         trace_events={i: t["events"] for i, t in traces.items()})
    if dev.type == "cuda":
        check(found == want and all(
            c.get("gop_program.replays", 0) > 0 for c in counters.values()),
            f"the traces name {found} kernel events, expected {want}; "
            f"{counters}")

    # warm on the fixture, and on jsvx's synthesised warm stream (host
    # encoded here, its own GOP length and buckets, so its own programs)
    for label, args in (("fixture", [fix]), ("shape", ["--shape",
                                                       WARM_SHAPE])):
        proc = subprocess.run(
            [sys.executable, "-m", "jsvx_torch", "warm", *args, "--device",
             str(dev)], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0, f"warm {label} exited "
                                    f"{proc.returncode}: "
                                    f"{proc.stderr[-2000:]}")
        warm = json.loads(proc.stdout.strip().splitlines()[-1])
        emit("warm", card=card, warmed=label, **warm)
        check(warm["frames"] > 0 and (warm["kernels"] is not None)
              == (dev.type == "cuda"), f"warm {label}: {warm}")
        if dev.type == "cuda":
            check(warm["programs"] > 0 and warm["second_run_captures"] == 0,
                  f"warm {label} captured {warm['programs']} programs, "
                  f"then {warm['second_run_captures']}")

    w, h = (int(x) for x in WARM_SHAPE.split("x"))
    mc_rows = bench_mc.rows(dev, h, w)
    emit("bench_mc", card=card, plane=f"{w}x{h} luma", rows=mc_rows,
         what="device time per call: 30 calls queued behind a spin "
              "kernel, CUDA events around them (host_hidden: the host "
              "finished enqueueing before the spin ended)")
    bad = [r for r in mc_rows if r.get("mismatching_pixels")]
    check(not bad and all(r["distinct"] == r["k"] for r in mc_rows),
          f"bench_mc: the MC kernel differs from its plain version: {bad}")

    damaged = check_damaged(data, dev, card)
    emit("damaged_inputs", card=card, **damaged)
    return dict(rates=rates, probe_s=gauge, mc_rows=mc_rows,
                damaged=damaged)


# ---------------------------------------------------------------------------
# Phase 8: the GOP programs

#: runs of each route in the dispatch and resident-GOP turns
N_TURNS = 20


@contextlib.contextmanager
def requested_keys(keys: list):
    """Record the key of every GOP program a call asks for."""
    real = program.ProgramSet.get

    def get(self, key, build):
        keys.append(key)
        return real(self, key, build)

    program.ProgramSet.get = get
    try:
        yield
    finally:
        program.ProgramSet.get = real


def quartiles(xs: list) -> dict:
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return dict(min=min(xs), q1=q[0], median=q[1], q3=q[2], max=max(xs))


def graph_vs_eager(label: str, data: bytes, dev, impl: str,
                   quirk: bool = False, want: list | None = None) -> dict:
    """``transcode`` of ``data`` on a cold program cache (first sights
    captured), again (every GOP a replay, but for the programs the cache's
    bound closed after the first call) and on the eager loop: the same
    outcome and 0 differing pixels (and 0 against ``want`` if given);
    captures = the distinct keys asked for, replays = GOPs dispatched
    minus first sights, then all of them less the recaptures; the launch
    counters of all three runs equal."""
    program.CACHE.clear()
    keys: list = []
    runs = {}
    for name in ("first", "again", "eager"):
        m = Metrics()
        ctx = eager_route() if name == "eager" else requested_keys(keys)
        with ctx:
            out, n = counted(lambda: transcode_outcome(data, dev, impl,
                                                       quirk, m))
        runs[name] = dict(out=out, counts=n, metrics=m,
                          gops=m.timers.counts["device_dispatch"])
    first, again, eager = (runs[k] for k in ("first", "again", "eager"))
    n_keys = len(set(keys))
    diff = sum(mismatching_pixels(r["out"][1], eager["out"][1])
               if r["out"][1] else 0 for r in (first, again))
    if want is not None:
        diff += mismatching_pixels(eager["out"][1], want)
    # a call holds every program it asked for until it ends; then the
    # cache keeps its bound, and the next call captures what it closed
    recaptures = max(0, n_keys - program.CACHE.capacity)
    c1, c2 = first["metrics"].counters, again["metrics"].counters
    row = dict(stream=label, impl=impl, quirk=quirk,
               gops=again["gops"], frames=len(again["out"][1]),
               error=again["out"][2], distinct_keys=n_keys,
               first_call=dict(captures=c1["gop_program.captures"],
                               replays=c1["gop_program.replays"]),
               second_call=dict(captures=c2["gop_program.captures"],
                                replays=c2["gop_program.replays"]),
               capture_s=first["metrics"].gauges.get(
                   "gop_program.capture_s"),
               launches=again["counts"],
               vs_eager_mismatching_pixels=diff)
    emit("gop_program_vs_eager", **row)
    check(first["out"][0] == again["out"][0] == eager["out"][0]
          and first["out"][2] == again["out"][2] == eager["out"][2]
          and diff == 0, f"{label} {impl}: graph and eager routes differ "
                         f"({diff} pixels, {first['out'][0]} "
                         f"{again['out'][0]} {eager['out'][0]} GOPs)")
    check(c1["gop_program.captures"] == n_keys
          and c1["gop_program.replays"] == first["gops"] - n_keys
          and c2["gop_program.captures"] == recaptures
          and c2["gop_program.replays"] == again["gops"] - recaptures,
          f"{label} {impl}: captures and replays {row}")
    check(first["counts"] == again["counts"] == eager["counts"],
          f"{label} {impl}: launch counts {first['counts']} "
          f"{again['counts']} {eager['counts']}")
    return row


#: the GOPs of the varied stream: (GOP of the fixture, pictures kept)
VARIED_GOPS = ((0, 4), (1, 1), (0, 2), (1, 3), (0, 1), (1, 4), (0, 3),
               (1, 2), (0, 4), (1, 4), (0, 2), (1, 1))
#: runs of each route per stream in the first-sight turns
N_FIRST_SIGHT = 4


def varied_stream(data: bytes, cuts) -> tuple:
    """A stream whose GOP lengths vary: GOP i is GOP ``g`` of ``data``
    with its first ``k`` pictures only, for (g, k) in ``cuts``; a P
    picture predicts from earlier pictures only, so it decodes as those
    pictures of GOP g.  Returns (the stream, the (first, last) frame of
    ``data``'s frames that each of its GOPs decodes as)."""
    meta = parse_container_header(BitReader(data))
    head, body = data[:meta.header_bytes], data[meta.header_bytes:]
    seq_code = b"\x00\x00\x01" + bytes([START_SEQUENCE])
    pic_code = b"\x00\x00\x01" + bytes([START_PICTURE])
    gops = [seq_code + g for g in body.split(seq_code)[1:]]
    sizes = [g.count(pic_code) for g in gops]
    out, spans = [head], []
    for g, k in cuts:
        pos = -1
        for _ in range(k + 1):       # the (k+1)-th picture's start code
            pos = gops[g].find(pic_code, pos + 1)
            if pos < 0:
                break
        out.append(gops[g] if pos < 0 else gops[g][:pos])
        first = sum(sizes[:g])
        spans.append((first, first + k))
    varied = b"".join(out)
    got = [len(grp) for grp in walk_stream(varied)[2]]
    check(got == [k for _, k in cuts], f"varied stream: GOP lengths {got}")
    return varied, spans


def first_sight_turns(streams: dict, dev, card: str) -> dict:
    """``device_dispatch`` per GOP when first sights dominate: each stream
    in ``streams`` through ``transcode`` (the fused route, the planes
    copied to the host) on a cold program cache (``CACHE.clear()`` just
    before: every key captured on its first GOP), right after that on the
    cache it left (``warm``), and on the eager loop, N_FIRST_SIGHT runs
    each in turns after a warm-up run of each; min, quartiles and max of
    the dispatch per GOP, the captures per run and the capture seconds."""
    out = {}
    for label, data in streams.items():
        routes = ("cold", "warm", "eager")
        ms: dict = {r: [] for r in routes}
        caps: dict = {r: [] for r in routes}
        cap_s = []
        gops = None
        for rnd in range(N_FIRST_SIGHT + 1):
            order = routes if rnd % 2 == 0 else ("eager", "cold", "warm")
            for route in order:
                if route == "cold":
                    program.CACHE.clear()
                m = Metrics()
                ctx = (eager_route() if route == "eager"
                       else contextlib.nullcontext())
                with ctx:
                    transcode_outcome(data, dev, "fused", metrics=m)
                n = m.timers.counts.get("device_dispatch", 0)
                if rnd == 0 or n == 0:         # rep 0 is the warm-up
                    continue
                gops = n
                ms[route].append(1e3 * m.timers.totals["device_dispatch"]
                                 / n)
                caps[route].append(m.counters.get("gop_program.captures", 0))
                if route == "cold":
                    cap_s.append(m.gauges.get("gop_program.capture_s", 0.0))
        if gops is None:
            continue
        out[label] = dict(
            gops=gops,
            device_dispatch_ms_per_gop={r: quartiles(v) if len(v) > 1
                                        else v for r, v in ms.items()},
            captures_per_run={r: sorted(set(v)) for r, v in caps.items()},
            cold_capture_s=quartiles(cap_s) if len(cap_s) > 1 else cap_s,
            cold_over_eager_median=statistics.median(ms["cold"])
            / statistics.median(ms["eager"]))
    emit("gop_program_first_sight", card=card, streams=out,
         runs=N_FIRST_SIGHT,
         what="transcode (fused, .cpu() sink): device_dispatch per GOP "
              "dispatched; cold: CACHE.clear() just before, so every key "
              "is captured on its first GOP (capture seconds inside the "
              "dispatch); warm: the next run, on what the cold run left "
              "in the cache; eager: the eager loop on every GOP; in turns")
    return out


def dispatch_turns(data: bytes, dev, card: str) -> dict:
    """``transcode`` of ``data`` (the planes kept on the card) on the
    programs and on the eager loop in turns, N_TURNS runs each after a
    warm-up, the first route alternating: ``device_dispatch`` per GOP and
    frames/s, min, quartiles and max."""
    def sink(gi, outs):
        return outs

    transcode(data, sink, device=dev)                # captures
    runs: dict = {"graph": [], "eager": []}
    fps: dict = {"graph": [], "eager": []}
    for rnd in range(N_TURNS):
        for route in (("graph", "eager") if rnd % 2 == 0
                      else ("eager", "graph")):
            ctx = (eager_route() if route == "eager"
                   else contextlib.nullcontext())
            m = Metrics()
            with ctx:
                sync(dev)
                t0 = time.perf_counter()
                r = transcode(data, sink, device=dev, metrics=m)
                sync(dev)
            fps[route].append(r.n_frames / (time.perf_counter() - t0))
            runs[route].append(
                1e3 * m.timers.totals["device_dispatch"] / r.n_gops)
    wins = sum(g < e for g, e in zip(runs["graph"], runs["eager"]))
    out = dict(card=card, gops=r.n_gops, frames=r.n_frames,
               device_dispatch_ms_per_gop={k: quartiles(v)
                                           for k, v in runs.items()},
               frames_per_s={k: quartiles(v) for k, v in fps.items()},
               graph_dispatch_shorter=wins, pairs=N_TURNS,
               what="transcode, planes kept on the card; graph: the GOP "
                    "programs (every GOP a replay); eager: the same "
                    "uploads, the eager loop per GOP; in turns")
    emit("gop_program_dispatch", **out)
    return out


def resident_turns(data: bytes, dev, card: str, impl: str) -> dict:
    """GOP 0 of ``data`` resident in a program's static wire: one replay
    plus its output copies against the eager loop, with the host in the
    loop (CUDA events around one call), N_TURNS calls each in turns, and
    the device busy time of each (queued behind a spin); the two routes'
    planes bit-equal."""
    meta, seq, g, wire, spec, dense = gop_on_card(data, 0, dev)
    consts = make_constants(seq, dev)
    key = program_key(spec, seq.mb_height, seq.mb_width, meta.n_components,
                      impl, False, consts, dev)
    prog = program.GopProgram(key, consts)
    prog.wire.copy_(wire)
    m = Metrics()

    def graph():
        prog.load()
        return prog.run(None, m)[0]

    def eager():
        prog.load()
        return eager_program_run(prog, None, m)[0]

    first = graph()                                  # eager + capture
    got, want = graph(), eager()
    diff = mismatching_pixels(
        [tuple(s[i].cpu().numpy() for s in got) for i in range(len(g.hdrs))],
        [tuple(s[i].cpu().numpy() for s in want)
         for i in range(len(g.hdrs))])
    diff += sum(int((a != b).sum()) for a, b in zip(first, want))
    for fn in (graph, eager):
        for _ in range(3):
            fn()
    sync(dev)
    loop: dict = {"graph": [], "eager": []}
    for rnd in range(N_TURNS):
        for route in (("graph", "eager") if rnd % 2 == 0
                      else ("eager", "graph")):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            (graph if route == "graph" else eager)()
            e1.record()
            e1.synchronize()
            loop[route].append(e0.elapsed_time(e1))
    busy = {route: statistics.median(device_ms(fn, dev, 2)[0])
            for route, fn in (("graph", graph), ("eager", eager))}
    out = dict(card=card, impl=impl, frames=len(g.hdrs),
               host_in_loop_ms={k: quartiles(v) for k, v in loop.items()},
               device_busy_ms=busy,
               graph_over_device_ms=statistics.median(loop["graph"])
               - busy["graph"],
               capture_s=prog.capture_s, pool_bytes=prog.pool_bytes,
               wire_bytes=spec[1], graph_vs_eager_mismatching_pixels=diff,
               what="host in the loop: CUDA events around one call (graph: "
                    "load + replay + a copy per plane stack; eager: load + "
                    "the eager loop), in turns; device busy: calls queued "
                    f"behind a spin, median of {N_TIMED}")
    emit("gop_program_resident", **out)
    check(diff == 0, f"resident GOP {impl}: graph and eager differ in "
                     f"{diff} pixels")
    prog.close()
    return out


def threaded_transcodes(data: bytes, dev, want: list) -> dict:
    """Two threads run ``transcode`` of ``data`` at once on a cold cache,
    each keeping its planes on the card: both get ``want``; the cache then
    holds a second instance of a key both used at once."""
    program.CACHE.clear()

    def one(impl):
        kept = {}
        transcode(data, lambda gi, outs: kept.__setitem__(gi, outs),
                  device=dev, impl=impl)
        return [tuple(s[i].cpu().numpy() for s in kept[g])
                for g in sorted(kept) for i in range(kept[g][0].shape[0])]

    with ThreadPoolExecutor(2) as pool:
        got = list(pool.map(one, ("fused", "fused")))
    diffs = [mismatching_pixels(f, want) for f in got]
    per_key: dict = {}
    for p in program.CACHE.programs():
        per_key[p.key] = per_key.get(p.key, 0) + 1
    out = dict(threads=2, mismatching_pixels=diffs,
               programs=len(program.CACHE.programs()),
               most_instances_of_a_key=max(per_key.values()))
    emit("gop_program_threads", **out)
    check(diffs == [0, 0], f"two threads: {diffs} pixels differ")
    return out


def program_phase(data: bytes, dev, card: str, cpu_frames: list,
                  streams: dict) -> dict:
    """Phase 8.  ``streams`` maps a label to the bytes of a stream whose
    keys are reported (each through both routes, graph against eager)."""
    n_gops = len(walk_stream(data)[2])
    longer = long_stream(data, LONG_GOPS // n_gops)
    rows = []
    for impl in ("fused", "two_kernel"):
        for label, d in streams.items():
            rows.append(graph_vs_eager(label, d, dev, impl))
        rows.append(graph_vs_eager(f"1080p-{LONG_GOPS}-gops", longer, dev,
                                   impl))
        rows.append(graph_vs_eager("1080p", data, dev, impl, True))
    # GOP lengths that vary from GOP to GOP: a key per length and bucket
    n_per_gop = len(cpu_frames) // n_gops
    varied, spans = varied_stream(data, VARIED_GOPS)
    varied_cpu = [f for a, b in spans for f in cpu_frames[a:b]]
    check(all(b - a <= n_per_gop for a, b in spans), "varied spans")
    for impl in ("fused", "two_kernel"):
        rows.append(graph_vs_eager("1080p-varied", varied, dev, impl,
                                   want=varied_cpu))
    damaged = [graph_vs_eager(label, bad, dev, impl)
               for label, bad, _ in damaged_inputs(data)
               for impl in ("fused", "two_kernel")]
    emit("gop_program_keys", streams={
        f"{r['stream']}{'-quirk' if r['quirk'] else ''}":
            dict(gops=r["gops"], distinct_keys=r["distinct_keys"])
        for r in rows + damaged if r["impl"] == "fused"})

    # captures after GOP 0 raise no sync warning
    long_cpu = cpu_frames * (LONG_GOPS // n_gops)
    for impl in ("fused", "two_kernel"):
        program.CACHE.clear()
        w = check_pipelined(f"1080p-{LONG_GOPS}-gops-cold-cache", longer,
                            dev, impl, False, long_cpu, card)
        check(w["res"].metrics.counters["gop_program.captures"] > 0,
              "the cold-cache run captured nothing")
    threads = threaded_transcodes(longer, dev, long_cpu)

    program.CACHE.clear()
    for impl in ("fused", "two_kernel"):
        transcode(data, device=dev, impl=impl)
    held = [dict(impl=p.key.impl, wire_bytes=p.key.spec[1],
                 pool_bytes=p.pool_bytes, capture_s=p.capture_s,
                 launches=p.launches)
            for p in program.CACHE.programs()]
    emit("gop_program_cache", card=card, programs=held,
         held_bytes=program.CACHE.held_bytes(),
         capacity=program.CACHE.capacity,
         what="the 1080p fixture on both routes, a cold cache: what each "
              "program holds (pool: what the card's allocator reserved "
              "during its capture)")

    dispatch = dispatch_turns(data, dev, card)
    resident = {impl: resident_turns(data, dev, card, impl)
                for impl in ("fused", "two_kernel")}
    first_sight = first_sight_turns(
        {"1080p-varied": varied, "1080p": data,
         **{label: bad for label, bad, _ in damaged_inputs(data)}},
        dev, card)
    return dict(rows=rows, damaged=damaged, threads=threads,
                dispatch=dispatch, resident=resident,
                first_sight=first_sight)


# ---------------------------------------------------------------------------
# Phase 9: the GOP programs on decode_group and decode_gops_parallel

#: rounds of phase 9's turns (each route once a round, the first
#: alternating)
N_GROUP_TURNS = 6


def group_frames(frames) -> list:
    return [tuple(p.cpu().numpy() for p in f) for f in frames]


def stream_decoder_path(data: bytes, scan: bool, impl: str,
                        quirk: bool = False):
    """``StreamDecoder(data).decode`` as ``run(device, metrics)``."""
    def run(device, m):
        res = StreamDecoder(data, quirk, device=device).decode(
            use_gop_scan=scan, impl=impl, metrics=m)
        return group_frames(res.frames)
    return run


def decoder_path(data: bytes, scan: bool, quirk: bool = False):
    """The streaming Decoder over the whole buffered stream as
    ``run(device, metrics)``."""
    def run(device, m):
        d = Decoder(PlayerConfig(use_gop_scan=scan,
                                 quirk_oddify_zeros=quirk), device=device)
        d.metrics = m
        d.feed(0, data, total=len(data))
        frames = group_frames(f.planes for f in d.iter_frames())
        check(d.ended, "the Decoder did not reach the end")
        return frames
    return run


def player_path(data: bytes, quirk: bool = False):
    """The Player with RGB output to ``ended`` as ``run(device,
    metrics)``: each shown frame's planes and its RGB frame; its
    Decoder's counters go to ``metrics``."""
    def run(device, m):
        p = Player(PlayerConfig(emit_rgb=True, quirk_oddify_zeros=quirk),
                   device=device)
        _, rgb, planes = play(data, p)
        for k, v in p.decoder.metrics.counters.items():
            m.count(k, v)
        return [f + (x,) for f, x in zip(planes, rgb, strict=True)]
    return run


def gop_batch_host(data: bytes) -> tuple:
    """Every GOP of ``data`` densely packed and stacked on a GOP axis
    (numpy), or None when its GOPs differ in length; and the sequence
    header."""
    d = StreamDecoder(data, device="cpu")
    gops = []
    for ft in d.parse_all():
        if ft.is_intra_picture or not gops:
            gops.append([])
        gops[-1].append(ft)
    if len({len(g) for g in gops}) != 1:
        return None, d.parser.seq
    stacked = [gop_module.stack_device_frames([frame_to_device(ft)
                                               for ft in g]) for g in gops]
    batch = {k: ({f: np.stack([g[k][f] for g in stacked]) for f in v}
                 if isinstance(v, dict)
                 else np.stack([g[k] for g in stacked]))
             for k, v in stacked[0].items()}
    return batch, d.parser.seq


def gops_parallel_path(batch: dict, seq, quirk: bool = False):
    """``decode_gops_parallel`` of ``batch`` on a mesh of one rank (no
    process group) as ``run(device, metrics)``: every GOP's frames in
    stream order (the final planes are views of the last ones)."""
    def run(device, m):
        outs, _, gops = decode_gops_parallel(
            batch, seq.coded_height, seq.coded_width,
            make_constants(seq, device), build_mesh({"gop": 1}),
            quirk_oddify_zeros=quirk, device=device, metrics=m)
        return group_frames([tuple(o[g][i] for o in outs)
                             for g in range(len(gops))
                             for i in range(int(outs[0].shape[1]))])
    return run


def path_outcome(run, device, m) -> tuple:
    """``run(device, m)``: (its frames, the error's name or None)."""
    try:
        return run(device, m), None
    except ValueError as e:
        return [], type(e).__name__


def group_vs_eager(label: str, path: str, run, dev, want: list,
                   n_planes: int) -> dict:
    """``run`` on a cold program cache (first sights captured), again
    (every unit a replay) and on the eager loop (:func:`eager_route`):
    the same outcome, 0 differing pixels among the three and against
    ``want`` (the CPU's frames, held to the first ``n_planes`` planes of
    each frame); captures = the distinct keys asked for, replays = units
    minus first sights, then every unit; the launch counters of the three
    runs equal; the bytes the cache then holds."""
    program.CACHE.clear()
    runs = {}
    for name in ("first", "again", "eager"):
        keys, m = [], Metrics()
        ctx = eager_route() if name == "eager" else requested_keys(keys)
        with ctx:
            out, n = counted(lambda: path_outcome(run, dev, m))
        runs[name] = dict(out=out, counts=n, metrics=m, keys=keys)
    first, again, eager = (runs[k] for k in ("first", "again", "eager"))
    n_keys = len(set(first["keys"]))
    diff = sum(mismatching_pixels(r["out"][0], eager["out"][0])
               for r in (first, again))
    d_cpu = mismatching_pixels([f[:n_planes] for f in eager["out"][0]],
                               want)
    c1, c2 = first["metrics"].counters, again["metrics"].counters
    row = dict(stream=label, path=path, frames=len(want),
               units=len(first["keys"]), distinct_keys=n_keys,
               error=again["out"][1],
               first_call=dict(captures=c1.get("gop_program.captures", 0),
                               replays=c1.get("gop_program.replays", 0)),
               second_call=dict(captures=c2.get("gop_program.captures", 0),
                                replays=c2.get("gop_program.replays", 0)),
               launches=again["counts"], vs_eager_mismatching_pixels=diff,
               vs_cpu_mismatching_pixels=d_cpu,
               programs=len(program.CACHE.programs()),
               held_bytes=program.CACHE.held_bytes())
    emit("group_program_vs_eager", **row)
    check(first["out"][1] is None and again["out"][1] is None
          and eager["out"][1] is None and diff == 0 and d_cpu == 0,
          f"{label} {path}: graph, eager and CPU differ ({diff} and "
          f"{d_cpu} pixels, errors {first['out'][1]} {again['out'][1]} "
          f"{eager['out'][1]})")
    check(n_keys > 0 and row["first_call"] == dict(
        captures=n_keys, replays=len(first["keys"]) - n_keys)
        and row["second_call"] == dict(captures=0,
                                       replays=len(again["keys"])),
        f"{label} {path}: captures and replays {row}")
    check(first["counts"] == again["counts"] == eager["counts"]
          and sum(first["counts"].values()) > 0,
          f"{label} {path}: launch counts {first['counts']} "
          f"{again['counts']} {eager['counts']}")
    return row


def group_paths(data: bytes, quirk: bool = False) -> dict:
    """Every ``decode_group`` path and the GOP-parallel path of ``data``
    (where its GOPs share a length), by name."""
    paths = {f"stream_decoder_{'scan' if scan else 'picture'}_{impl}":
             stream_decoder_path(data, scan, impl, quirk)
             for scan in (True, False) for impl in ("fused", "two_kernel")}
    paths["decoder_gop_batch"] = decoder_path(data, True, quirk)
    paths["decoder_picture"] = decoder_path(data, False, quirk)
    paths["player_rgb"] = player_path(data, quirk)
    batch, seq = gop_batch_host(data)
    if batch is not None:
        paths["gops_parallel"] = gops_parallel_path(batch, seq, quirk)
    return paths


def group_turns(data: bytes, dev, card: str) -> dict:
    """Each path of the 1080p fixture on the programs and on the eager
    loop in turns, N_GROUP_TURNS runs of each after a warm-up that
    captures: frames/s (host clock around a run that ends in a
    synchronise) and, where the path has the stage, ``device_decode`` per
    unit (a GOP or a picture); min, quartiles and max."""
    out = {}
    for name, run in group_paths(data).items():
        run(dev, Metrics())
        fps: dict = {"graph": [], "eager": []}
        dd: dict = {"graph": [], "eager": []}
        n_f = 0
        for rnd in range(N_GROUP_TURNS):
            for route in (("graph", "eager") if rnd % 2 == 0
                          else ("eager", "graph")):
                ctx = (eager_route() if route == "eager"
                       else contextlib.nullcontext())
                m = Metrics()
                with ctx:
                    sync(dev)
                    t0 = time.perf_counter()
                    n_f = len(run(dev, m))
                    sync(dev)
                fps[route].append(n_f / (time.perf_counter() - t0))
                n = m.timers.counts.get("device_decode", 0)
                if n:
                    dd[route].append(
                        1e3 * m.timers.totals["device_decode"] / n)
        out[name] = dict(frames=n_f, frames_per_s={k: quartiles(v)
                                                  for k, v in fps.items()})
        if dd["graph"]:
            out[name]["device_decode_ms_per_unit"] = {
                k: quartiles(v) for k, v in dd.items()}
    emit("group_program_turns", card=card, paths=out, rounds=N_GROUP_TURNS,
         what="1080p fixture; graph: the GOP programs (a replay per GOP "
              "or picture); eager: the same uploads, the eager loop; in "
              "turns; device_decode per unit (a GOP on the scan and "
              "GOP-batch paths, a picture on the picture paths)")
    return out


def group_cache_bytes(data: bytes, dev, card: str) -> list:
    """What each kind of program holds at 1080p: the fixture once through
    each path on a cold cache."""
    program.CACHE.clear()
    for run in group_paths(data).values():
        run(dev, Metrics())
    held = [dict(impl=p.key.impl, refs_in=p.key.refs_in, gops=p.key.gops,
                 wire_bytes=p.key.spec[1],
                 slot_bytes=sum(s.numel() for s in p.slots or ()),
                 pool_bytes=p.pool_bytes, held_bytes=p.held_bytes,
                 capture_s=p.capture_s)
            for p in program.CACHE.programs()]
    emit("group_program_cache", card=card, programs=held,
         held_bytes=program.CACHE.held_bytes(),
         capacity=program.CACHE.capacity,
         what="the 1080p fixture through every decode_group and "
              "GOP-parallel path on a cold cache: each program's static "
              "wire, reference slots and the pool its capture reserved")
    return held


def group_phase(streams: dict, dev, card: str, data_1080: bytes) -> dict:
    """Phase 9.  ``streams`` maps a label to (the stream's bytes, the
    quirk, its frames on the CPU, its plane count)."""
    rows = []
    for label, (data, quirk, want, n_planes) in streams.items():
        for path, run in group_paths(data, quirk).items():
            rows.append(group_vs_eager(label, path, run, dev, want,
                                       n_planes))
    held = group_cache_bytes(data_1080, dev, card)
    turns = group_turns(data_1080, dev, card)
    return dict(rows=rows, held=held, turns=turns)


# ---------------------------------------------------------------------------
# Phase 10: each GOP with its own sequence header's quant matrices; the
# driver entry points (jsvx_torch.graft_entry)

#: ranks of the dry run, all on this card under gloo
DRYRUN_RANKS = 8
DRYRUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "jsvx_torch", "dryrun")
#: pictures per GOP of the rendition-switch stream
SWITCH_GOP = 3


def gop_errors(frames: list, want: list) -> list:
    """(differing pixels, largest difference) of each GOP of ``frames``
    against ``want`` (the first planes of each frame)."""
    check(len(frames) == len(want) > 0,
          f"{len(frames)} frames against {len(want)}")
    out = []
    for g in range(0, len(want), SWITCH_GOP):
        n = mx = 0
        for fa, fb in zip(frames[g:g + SWITCH_GOP], want[g:g + SWITCH_GOP]):
            for a, b in zip(fa, fb):
                check(a.shape == b.shape and a.dtype == np.uint8,
                      f"plane {a.dtype} {a.shape} vs {b.shape}")
                d = np.abs(a.astype(int) - b.astype(int))
                n += int((d > 0).sum())
                mx = max(mx, int(d.max()))
        out.append((n, mx))
    return out


def switch_paths(data: bytes) -> dict:
    """Every device entry point of ``data`` (6 pictures, 2 GOPs), by name:
    (``run(device, metrics)``, the launch counts of a run on the card,
    whether the oracle decodes it with the oddify-zeros quirk)."""
    n_f, n_g = 6, 2
    paths = {}
    for impl in ("fused", "two_kernel"):
        per = (dict(fused=n_f) if impl == "fused"
               else dict(mc=n_f, recon=n_f))
        for quirk in (False, True):
            paths[f"transcode_{impl}{'_quirk' if quirk else ''}"] = (
                lambda d, m, impl=impl, quirk=quirk: collect(
                    data, d, impl, quirk, m)[0],
                want_counts(**per, expand=0 if quirk else n_g), quirk)
        for scan in (True, False):
            paths[f"stream_decoder_{'scan' if scan else 'picture'}_{impl}"] \
                = (stream_decoder_path(data, scan, impl), want_counts(**per),
                   False)
    paths["decoder_gop_batch"] = (decoder_path(data, True),
                                  want_counts(fused=n_f), False)
    paths["decoder_picture"] = (decoder_path(data, False),
                                want_counts(fused=n_f), False)
    paths["player_rgb"] = (player_path(data),
                           want_counts(fused=n_f, color=n_f), False)
    return paths


def switch_phase(dev, card: str) -> list:
    """The rendition-switch stream (``tools/fixture.switch_stream``: GOP
    0 with the default matrices, GOP 1 with others, each after its own
    sequence header; with and without a key map) through every device
    entry point on a cold program cache: per GOP within 1 LSB of the
    float64 oracle, bit-equal to the same call on the CPU, the kernels
    counted, captures = the distinct (layout, matrices) keys asked for,
    and two sets of matrices among them; the Player's RGB within 1 LSB of
    ``refmath`` on the oracle's planes; the Decoder after a seek into
    GOP 1, GOP batch and picture by picture."""
    rows = []
    for km in (False, True):
        data = switch_stream(km)
        oracle = {q: [f.planes for f in decode_stream_oracle(data, q)]
                  for q in (False, True)}
        for name, (run, want, quirk) in switch_paths(data).items():
            program.CACHE.clear()
            keys, m = [], Metrics()
            with requested_keys(keys):
                frames, n = counted(lambda: run(dev, m))
            cpu = run(torch.device("cpu"), Metrics())
            errs = gop_errors([f[:3] for f in frames], oracle[quirk])
            d_cpu = mismatching_pixels(frames, cpu)
            captures = m.counters.get("gop_program.captures", 0)
            row = dict(stream="switch" + ("-key-map" if km else ""),
                       path=name, frames=len(frames),
                       per_gop_vs_oracle=errs, vs_cpu_mismatching_pixels=d_cpu,
                       launches=n, distinct_keys=len(set(keys)),
                       distinct_matrices=len({k.quant for k in keys}),
                       captures=captures)
            if name == "player_rgb":
                row["rgb_vs_refmath_max"] = max(
                    int(np.abs(f[-1].astype(int) - ref_rgb(*o)[
                        :f[-1].shape[0], :f[-1].shape[1]].astype(int)).max())
                    for f, o in zip(frames, oracle[False]))
                check(row["rgb_vs_refmath_max"] <= 1,
                      f"switch {name}: RGB {row['rgb_vs_refmath_max']} LSB "
                      f"from refmath")
            emit("switch_path", card=card, **row)
            check(all(mx <= 1 for _, mx in errs) and d_cpu == 0,
                  f"switch {name}: per GOP {errs} from the oracle, {d_cpu} "
                  f"pixels from the CPU")
            check(n == want, f"switch {name}: launches {n}, want {want}")
            check(captures == row["distinct_keys"] > 0
                  and row["distinct_matrices"] == 2,
                  f"switch {name}: {captures} captures, "
                  f"{row['distinct_keys']} keys, "
                  f"{row['distinct_matrices']} sets of matrices")
            rows.append(row)
        if km:
            for scan in (True, False):
                got, n = counted(lambda: decoder_frames(data, dev, scan,
                                                        seek_gop=1))
                cpu = decoder_frames(data, torch.device("cpu"), scan,
                                     seek_gop=1)
                errs = gop_errors(got, oracle[False][SWITCH_GOP:])
                d_cpu = mismatching_pixels(got, cpu)
                emit("switch_path", card=card, stream="switch-key-map",
                     path="decoder_seek_gop1_" + ("batch" if scan
                                                  else "picture"),
                     frames=len(got), per_gop_vs_oracle=errs,
                     vs_cpu_mismatching_pixels=d_cpu, launches=n)
                check(all(mx <= 1 for _, mx in errs) and d_cpu == 0
                      and n == want_counts(fused=SWITCH_GOP + (
                          SWITCH_GOP if scan else 1)),
                      f"switch: seek into GOP 1 ({errs}, {d_cpu} pixels "
                      f"from the CPU, launches {n})")
    return rows


def entry_phase(dev) -> dict:
    """``graft_entry.entry()`` on the card: one fused launch, bit-equal to
    the plain version on the same card tensors and to the CPU; and the
    same synthetic picture predicted from random reference planes (so its
    vectors of up to 12 half-pels read real taps), kernel against plain."""
    fn, args = graft_entry.entry(dev)
    frame, refs, consts = args

    def plain(refs):
        return [decode_frame_plane(frame[k], refs[i], frame["is_p"], consts,
                                   comp_is_chroma(i))
                for i, k in enumerate(frame_comp_keys(frame))]

    out, n = counted(lambda: fn(*args))
    sync(dev)
    cfn, cargs = graft_entry.entry("cpu")
    d_plain = differing(out, plain(refs))
    d_cpu = differing([o.cpu() for o in out], cfn(*cargs))
    gen = torch.Generator().manual_seed(12)
    rand = tuple(torch.randint(0, 256, tuple(r.shape), generator=gen,
                               dtype=torch.uint8).to(dev) for r in refs)
    out_r, n_r = counted(lambda: fn(frame, rand, consts))
    sync(dev)
    d_rand = differing(out_r, plain(rand))
    row = dict(shapes=[tuple(o.shape) for o in out], launches=n,
               vs_plain_mismatching_pixels=d_plain,
               vs_cpu_mismatching_pixels=d_cpu,
               random_refs=dict(launches=n_r,
                                vs_plain_mismatching_pixels=d_rand),
               lnz=[int(frame["y"]["lnz"].min()),
                    int(frame["y"]["lnz"].max())],
               max_abs_mv=int(frame["y"]["mv"].abs().max()))
    emit("entry", **row)
    check(n == n_r == want_counts(fused=1), f"entry: launches {n}, {n_r}")
    check(d_plain == d_cpu == d_rand == 0,
          f"entry: {d_plain}, {d_cpu}, {d_rand} pixels from the plain "
          f"version")
    return row


def dryrun_phase(dev, card: str) -> dict:
    """``graft_entry.dryrun_multichip(8)``: 8 gloo ranks sharing this
    card, a (gop 2, rows 4) mesh at 1088x256; its own checks (bit-identical
    to a 1x1 mesh, GOP 0 within 1 LSB of the fused decode), then each
    rank's bands through the MC and reconstruction kernels (once per
    picture each, no torch sideband expansion) and the fused decode once
    per picture; its wall seconds and the halo's route."""
    t0 = time.perf_counter()
    rep = graft_entry.dryrun_multichip(DRYRUN_RANKS, dev,
                                       workdir=DRYRUN_DIR)
    wall = time.perf_counter() - t0
    ranks = rep["ranks"]
    row = dict(card=card, mesh=rep["mesh"], bytes=rep["bytes"],
               height=rep["height"], width=rep["width"],
               halo_y=rep["halo_y"], halo_route=rep["halo_route"],
               call_s=wall, ranks_s=rep["seconds"],
               band_decode_s=[r["seconds"] for r in ranks],
               devices=sorted({r["device"] for r in ranks}),
               launches_per_rank=[r["launches"] for r in ranks],
               fused_launches=rep["fused_launches"],
               vs_fused_max_abs_diff=rep["max_abs_diff"],
               vs_fused_differing_pixels=rep["n_diff"],
               what="call_s: the whole call (encode, parse, ranks, checks); "
                    "ranks_s: the ranks from their start to their exit; "
                    "band_decode_s: each rank's banded GOP decode (host "
                    "clock, ends in a synchronise); a correctness path: "
                    "the ranks share one card and each frame's halo goes "
                    "through the host (gloo)")
    emit("dryrun_multichip", **row)
    check(len(ranks) == DRYRUN_RANKS
          and all(with_unloaded(r["launches"]) == want_counts(mc=3, recon=3)
                  for r in ranks)
          and rep["fused_launches"] == 3 and rep["max_abs_diff"] <= 1,
          f"dryrun: launches {row['launches_per_rank']}, fused "
          f"{rep['fused_launches']}, {rep['max_abs_diff']} LSB")
    return row


def smoke(dev: torch.device) -> None:
    t_start = time.perf_counter()

    # ---- 1. the card --------------------------------------------------------
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card, flush=True)
    nvcc = run([build.nvcc_path(), "--version"]).splitlines()[-1]
    kind = torch.cuda.get_device_name(0)
    emit("device", card=card, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0])

    # ---- 2. build -----------------------------------------------------------
    # both libraries at once: each starts one nvcc per source
    with ThreadPoolExecutor(len(build.LIBRARIES)) as pool:
        libs = dict(zip(build.LIBRARIES, pool.map(build.load,
                                                  build.LIBRARIES)))
    for name, built in libs.items():
        emit("build", library=name, path=built.path,
             nvcc_seconds=built.seconds,
             ptxas=[ln.strip() for ln in built.log.splitlines()
                    if "Used" in ln or "spill" in ln])

    # ---- 3. kernel vs plain -------------------------------------------------
    t0 = time.perf_counter()
    fix = ensure_fixture()
    with open(fix, "rb") as f:
        data_1080 = f.read()
    emit("fixture", path=fix, bytes=len(data_1080),
         seconds=time.perf_counter() - t0)
    hm = high_motion_stream()
    _, _, g, _, _, _ = gop_on_card(hm, 1, dev)
    n_mv = len(np.unique(g.stacked["mb"]["mv"][1].reshape(-1, 2), axis=0))
    emit("high_motion", distinct_mvs=n_mv)
    check(n_mv >= 256, f"{n_mv} distinct vectors, expected >= 256")
    dirty = dirty_stream()
    cif = JsvEncoder(352, 288, EncoderConfig(
        gop_size=6, quantizer_scale=6, me_range=8,
        half_pel_refine=True)).encode(zoom_clip(288, 352, 12, seed=7))
    yuva = JsvEncoder(128, 96, EncoderConfig(
        gop_size=4, quantizer_scale=5, me_range=6,
        half_pel_refine=True)).encode(yuva_clip(8, 96, 128))
    worst = {"fused": 0, "mc": 0, "recon": 0}
    for label, data, gi, quirk_frames in (
            ("1080p", data_1080, 0, (1,)), ("320x320-256mv", hm, 0, ()),
            ("320x320-256mv", hm, 1, ()), ("48x64-dirty", dirty, 0, ()),
            ("cif-352x288", cif, 0, ()), ("yuva-128x96", yuva, 0, (1,))):
        w = kernels_vs_plain(label, data, gi, dev, quirk_frames)
        worst = {k: max(v, w[k]) for k, v in worst.items()}
    worst["mc"] = max(worst["mc"], mc_edge_cases(dev))
    worst["expand"] = max(expand_vs_plain(label, data, dev)
                          for label, data in (
                              ("1080p", data_1080), ("320x320-256mv", hm),
                              ("48x64-dirty", dirty), ("cif-352x288", cif),
                              ("yuva-128x96", yuva)))
    worst["color"] = colour_vs_plain({"1080p": data_1080, "yuva-128x96": yuva,
                                      "cif-352x288": cif}, dev)

    # ---- 4. the slice -------------------------------------------------------
    n_compact = compact_gops(data_1080)
    (cuda_frames, res), main = counted(lambda: collect(data_1080, dev))
    launches = main["fused"]
    meta, seq, _ = walk_stream(data_1080)
    n_planes = meta.n_components
    emit("transcode", device=str(dev), frames=res.n_frames, gops=res.n_gops,
         planes=n_planes, launches=main,
         expected_launches=want_counts(fused=res.n_frames,
                                       expand=n_compact))
    check(main == want_counts(fused=res.n_frames, expand=n_compact)
          and launches > 0 and n_compact == res.n_gops,
          f"{main} launches for {res.n_frames} pictures, {n_compact} of "
          f"{res.n_gops} GOPs compact")
    cpu_frames, _ = collect(data_1080, "cpu")
    n_diff = 0
    for fc, fh in zip(cuda_frames, cpu_frames):
        check(fc[0].shape == (seq.coded_height, seq.coded_width),
              f"luma shape {fc[0].shape}")
        for a, b in zip(fc, fh):
            check(a.dtype == np.uint8, f"plane dtype {a.dtype}")
            n_diff += int((a != b).sum())
    emit("cuda_vs_cpu", frames=len(cuda_frames), mismatching_pixels=n_diff)
    check(n_diff == 0 and len(cuda_frames) == len(cpu_frames) == res.n_frames,
          f"CUDA and CPU transcode differ: {n_diff} pixels")
    check_vs_oracle("cif-352x288", cif, dev)
    check_vs_oracle("yuva-128x96", yuva, dev)

    # the two-kernel route: the stream decoder is its main path
    n_two = check_path(
        "stream_decoder", lambda d, impl: stream_frames(data_1080, d, impl),
        dev, n_planes, 0)
    check_path("transcode_quirk",
               lambda d, impl: collect(data_1080, d, impl, quirk=True)[0],
               dev, n_planes, 0)
    check_path("transcode_two_kernel",
               lambda d, impl: collect(data_1080, d, impl)[0], dev, n_planes,
               n_compact)
    check_path("transcode_dirty_gop",
               lambda d, impl: collect(dirty, d, impl)[0], dev, 3,
               compact_gops(dirty))
    check_vs_oracle("cif-352x288", cif, dev, "two_kernel")
    check_vs_oracle("yuva-128x96", yuva, dev, "two_kernel")

    # playback: the streaming Decoder and the Player
    check_decoder("1080p", data_1080, dev, n_planes,
                  stream_frames(data_1080, dev, "fused"))
    # the display path: the Player with RGB (the colour kernel's main path)
    player_main = check_player("1080p", data_1080, dev, n_planes)
    check_player("yuva-128x96", yuva, dev, 4)
    check_decoder_vs_oracle("320x320-256mv", hm, dev)
    check_play_cli(fix, res.n_frames, dev)

    # ---- 5. timing ----------------------------------------------------------
    pictures = fused_picture_times("1080p", data_1080, dev, card)
    fused_t = pictures[1]                  # the first P picture
    check(fused_t["is_p"] == 1, "frame 1 of GOP 0 is not a P frame")
    two = two_kernel_picture_times("1080p", data_1080, dev, card)
    two_t = two[1]                         # the first P picture
    check(two_t["is_p"] == 1, "frame 1 of GOP 0 is not a P frame")
    meta, seq, g, wire, spec, dense = gop_on_card(data_1080, 0, dev)
    consts = make_constants(seq, dev)

    n_f = len(g.hdrs)

    def gop():
        zr = zero_refs(seq.coded_height, seq.coded_width, meta.n_components,
                       dev)
        return decode_gop_wire(wire, spec, zr, consts, seq.mb_height,
                               seq.mb_width)

    def expand_wire():
        return expand_compact_gop(unflatten_wire(wire, spec), seq.mb_height,
                                  seq.mb_width)

    def gop_plain_expansion():
        zr = zero_refs(seq.coded_height, seq.coded_width, meta.n_components,
                       dev)
        dense = expand.expand_compact_gop_plain(
            unflatten_wire(wire, spec), seq.mb_height, seq.mb_width)
        return decode_gop(dense, zr, consts)

    gop_dev, gop_cov, _ = device_ms(gop, dev, 2)
    exp_dev, exp_cov, _ = device_ms(expand_wire, dev, 4)
    gop_call = call_ms(gop, dev)
    old_dev, old_cov, _ = device_ms(gop_plain_expansion, dev, 2)
    old_call = call_ms(gop_plain_expansion, dev)
    emit("device_gop_decode", card=card, frames=n_f,
         gop_ms=statistics.median(gop_call),
         frames_per_s=n_f / (statistics.median(gop_call) * 1e-3),
         device_busy_ms=statistics.median(gop_dev),
         expand_device_ms=statistics.median(exp_dev),
         host_ahead_share=min(gop_cov, exp_cov),
         device_idle_share=1 - statistics.median(gop_dev)
         / statistics.median(gop_call),
         plain_expansion=dict(
             device_busy_ms=statistics.median(old_dev),
             gop_ms=statistics.median(old_call),
             host_ahead_share=old_cov),
         reps=N_TIMED, what="unflatten + expand (the kernel; "
                            "plain_expansion: its plain version, the route "
                            "before the kernel) + GOP loop, resident wire")
    expand_t = expand_times(unflatten_wire(wire, spec), seq.mb_height,
                            seq.mb_width, dev, card)

    m = Metrics()
    wall = []
    for rep in range(N_TIMED + 1):
        mm = Metrics() if rep == 0 else m  # rep 0 is the warm-up
        sync(dev)
        t0 = time.perf_counter()
        r = transcode(data_1080, lambda gi, outs: [o.cpu() for o in outs],
                      device=dev, metrics=mm)
        sync(dev)
        if rep:
            wall.append(time.perf_counter() - t0)
    stages = {k: v / N_TIMED / r.n_gops for k, v in m.timers.totals.items()}
    emit("end_to_end", card=card, frames=r.n_frames, gops=r.n_gops,
         median_s=statistics.median(wall),
         frames_per_s=r.n_frames / statistics.median(wall),
         # device busy: the GOP decode's device time, once per GOP
         device_idle_share=1 - r.n_gops * statistics.median(gop_dev) * 1e-3
         / statistics.median(wall),
         reps=N_TIMED, stage_s_per_gop=stages,
         wire_bytes_per_run=m.gauges["wire_bytes"],
         what="the pipelined loop, jsvx's stages: parse (walk, then per "
              "GOP parse + pack + copy start), wire_wait (the copy's tail), "
              "device_dispatch, device_wait (one GOP behind), sink (copies "
              "the planes to the host, so it also waits for the next GOP)")

    transcode_vs_plain_expansion(data_1080, dev, card)
    with first_design_route():
        two_kernel_gop_times(wire, spec, n_f, seq, meta, consts, dev, card,
                             statistics.median(gop_dev),
                             statistics.median(gop_call))
        stream_decoder_times(data_1080, dev, card)

    for scan in (True, False):
        decoder_rate(data_1080, dev, scan, card)
    decoder_view_copies(data_1080, dev, card)
    player_rate(data_1080, dev, card)
    colour_t = colour_time(data_1080, dev, card)

    # ---- 6. row-band and GOP sharding ---------------------------------------
    shard = shard_phase(data_1080, fix, dev, card)
    worst = {k: max(v, shard["max_abs_err"].get(k, 0))
             for k, v in worst.items()}

    # ---- 7. the pipelined transcode, the tools, damaged input ---------------
    t7 = time.perf_counter()
    pipeline_phase(data_1080, fix, dev, card, cpu_frames,
                   statistics.median(gop_dev), statistics.median(exp_dev))
    emit("phase7", seconds=time.perf_counter() - t7)

    # ---- 8. the GOP programs --------------------------------------------
    t8 = time.perf_counter()
    program_phase(data_1080, dev, card, cpu_frames, {
        "1080p": data_1080, "48x64-dirty": dirty, "yuva-128x96": yuva,
        "cif-352x288": cif, "320x320-256mv": hm})
    emit("phase8", seconds=time.perf_counter() - t8)

    # ---- 9. the GOP programs on the other GOP paths -------------------------
    t9 = time.perf_counter()
    group_phase({
        "1080p": (data_1080, False, cpu_frames, n_planes),
        "1080p-quirk": (data_1080, True, stream_frames_quirk(
            data_1080, "cpu", "fused", True), n_planes),
        "yuva-128x96": (yuva, False, stream_frames(yuva, "cpu", "fused"), 4),
        "cif-352x288": (cif, False, stream_frames(cif, "cpu", "fused"), 3),
        "48x64-dirty": (dirty, False, stream_frames(dirty, "cpu", "fused"),
                        3)}, dev, card, data_1080)
    emit("phase9", seconds=time.perf_counter() - t9)

    # ---- 10. per-GOP quant matrices; the driver entry points -------------
    t10 = time.perf_counter()
    switch_phase(dev, card)
    entry_phase(dev)
    dryrun_phase(dev, card)
    emit("phase10", seconds=time.perf_counter() - t10)

    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jsvx", "bench")]
    check(not loaded, f"imported {loaded}")
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [
        {"name": "fused_decode_picture", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
         "launches": launches, "max_abs_err": worst["fused"],
         "ms": fused_t["ms"], "plain_ms": fused_t["plain_ms"],
         "bound_ms": fused_t["bound_ms"], "bound_by": fused_t["bound_by"],
         "library_ms": None},
        {"name": "predict_picture_mc", "route": "cuda",
         "source": MC_SOURCE, "replaces": MC_REPLACES,
         "launches": n_two["mc"], "max_abs_err": worst["mc"],
         "ms": two_t["mc"]["kernel_ms"], "plain_ms": two_t["mc"]["plain_ms"],
         "bound_ms": two_t["mc"]["bound_ms"],
         "bound_by": two_t["mc"]["bound_by"], "library_ms": None},
        {"name": "recon_picture", "route": "cuda",
         "source": RECON_SOURCE, "replaces": RECON_REPLACES,
         "launches": n_two["recon"], "max_abs_err": worst["recon"],
         "ms": two_t["recon"]["kernel_ms"],
         "plain_ms": two_t["recon"]["plain_ms"],
         "bound_ms": two_t["recon"]["bound_ms"],
         "bound_by": two_t["recon"]["bound_by"],
         "library_ms": None},
        {"name": "expand_gop", "route": "cuda",
         "source": EXPAND_SOURCE, "replaces": EXPAND_REPLACES,
         "launches": main["expand"], "max_abs_err": worst["expand"],
         "ms": expand_t["ms"], "plain_ms": expand_t["plain_ms"],
         "bound_ms": expand_t["bound_ms"],
         "bound_by": expand_t["bound_by"], "library_ms": None},
        {"name": "ycbcr_to_rgb", "route": "cuda",
         "source": COLOUR_SOURCE, "replaces": COLOUR_REPLACES,
         "launches": player_main["launches"]["color"],
         "max_abs_err": worst["color"], "ms": colour_t["ms"],
         "plain_ms": colour_t["plain_ms"], "bound_ms": colour_t["bound_ms"],
         "bound_by": colour_t["bound_by"], "library_ms": None}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smoke(torch.device("cuda", 0))


if __name__ == "__main__":
    main()
