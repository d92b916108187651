"""Player: the HTML5 <video>-element-like surface over the streaming
decoder.

The port of ``jsvx/api/player.py``.  It re-designs the reference player
(``player/easybits.player.js``) for a Python runtime decoding on a torch
device (a CUDA card unless the caller asks for ``"cpu"``) while keeping
its observable behaviour:

* property surface: src (single or multi-bitrate list), currentTime,
  duration, paused/ended/seeking, muted/volume/playbackRate, loop,
  autoplay, preload, poster, videoWidth/Height, readyState/networkState,
  buffered/played/seekable TimeRanges, error;
* event stream: loadstart, durationchange, loadedmetadata, loadeddata,
  progress, canplay, canplaythrough, play, playing, pause, timeupdate,
  waiting, stalled, seeking, seeked, ended, error, ratechange,
  volumechange, resize, plus srcchange/bitratechange/unstalled;
* machinery: chunked byte-range loading with forward-buffer windowing and
  stall/refill backpressure (easybits.player.js:1869-2156), a bounded
  decode-ahead frame queue (MAX_DECODED_FRAMES=10, end.js:57) with
  readyState promotion (onf, :2543-2668), a drift-corrected render clock
  (displayFrame, :2451-2505), ABR down-switch after repeated underruns
  (:1294-1316), A/V sync against a pluggable audio clock (:2326-2368),
  and key-map seeking (:1423-1488).

The render clock is pump-driven: ``tick(now)`` advances everything; call
``run_realtime()`` for a wall-clock thread or drive ``tick`` manually
(tests, offline transcode).  Decoding and display may run on two threads
(``start_background_decode`` with ``run_realtime``); the Decoder returns
planes once they are complete, so the render thread reads finished
tensors.

With ``config.emit_rgb`` colour is converted on the planes' device
(:func:`jsvx_torch.kernels.color.ycbcr_to_rgb`, one launch of
``csrc/color.cu`` a frame on a card; the sink receives a contiguous uint8
tensor of the display size).  Each range request's completion is bound
to its own ``_PendingRequest``: a cancelled request's late completion is
ignored (in jsvx it clears the newer request's slot and starts a
duplicate range request, ``jsvx/api/player.py:514-516``).
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np
import torch

from ..coding import tables as T
from ..kernels.color import ycbcr_to_rgb
from ..runtime.profiler import span
from ..runtime.source import ByteSource, source_for
from .config import PlayerConfig
from .decoder import DecodedFrame, Decoder, check_backend
from .errors import MediaError
from .events import EventDispatcher


class ReadyState(IntEnum):
    HAVE_NOTHING = 0
    HAVE_METADATA = 1
    HAVE_CURRENT_DATA = 2
    HAVE_FUTURE_DATA = 3
    HAVE_ENOUGH_DATA = 4


class NetworkState(IntEnum):
    NETWORK_EMPTY = 0
    NETWORK_IDLE = 1
    NETWORK_LOADING = 2
    NETWORK_NO_SOURCE = 3


class TimeRanges:
    """HTML5 TimeRanges: ordered disjoint [start, end] second intervals."""

    def __init__(self, ranges=()):
        self._r = [(float(a), float(b)) for a, b in ranges]

    @property
    def length(self) -> int:
        return len(self._r)

    def start(self, i: int) -> float:
        return self._r[i][0]

    def end(self, i: int) -> float:
        return self._r[i][1]

    def contains(self, t: float) -> bool:
        return any(a <= t <= b for a, b in self._r)

    def as_list(self):
        return list(self._r)


@dataclass
class SourceVariant:
    src: object                       # str path/url or bytes
    bitrate: float = 0.0              # for ABR ordering ("b" attribute)
    use: bool = False                 # explicit start pick ("use" attr)


class NullAudioClock:
    """Pluggable audio companion (the reference drives an <audio>
    element); the null clock simply follows the video."""

    current_time = 0.0
    playing = False
    follows_video = True          # sync snaps it instead of pausing sides

    def play(self):
        self.playing = True

    def pause(self):
        self.playing = False

    def seek(self, t: float):
        self.current_time = t


class WallClockAudio:
    """Concrete audio companion: a PCM-payload-backed clock advancing
    with wall time while playing.

    The reference delegates actual audio RENDERING to the browser's
    ``<audio>`` element and only steers its clock
    (``easybits.player.js:2326-2368``); the framework contract is the
    same — this clock is what ``_check_av_sync`` pauses/seeks.  The
    payload (fetched via ``config.audio_map``) defines the duration at a
    declared byte rate; a ``time_fn`` injection makes it testable.
    """

    def __init__(self, data: bytes = b"", bytes_per_sec: int = 32000,
                 time_fn=None, duration: float | None = None):
        self._time = time_fn or _time.monotonic
        self.data = bytes(data)
        if duration is not None:
            self.duration = float(duration)
        else:
            wav = _wav_duration(self.data)
            if wav is not None:
                self.duration = wav
            else:
                self.duration = (len(self.data) / float(bytes_per_sec)
                                 if self.data else float("inf"))
        self._pos = 0.0
        self._anchor: float | None = None

    @property
    def playing(self) -> bool:
        return self._anchor is not None

    @property
    def current_time(self) -> float:
        t = self._pos
        if self._anchor is not None:
            t += self._time() - self._anchor
        return min(t, self.duration)

    def play(self):
        if self._anchor is None:
            self._anchor = self._time()

    def pause(self):
        if self._anchor is not None:
            self._pos = self.current_time
            self._anchor = None

    def seek(self, t: float):
        playing = self.playing
        self._pos = min(max(float(t), 0.0), self.duration)
        self._anchor = self._time() if playing else None


class _PendingRequest:
    """In-flight range request: the transport handle arrives only after
    ``request()`` returns, which for synchronous sources is after the
    data has already been delivered and completed.  ``cancelled`` marks
    a request whose slot was cleared before the handle existed (an async
    source whose callbacks re-enter ``request()`` via the error->seek
    path), so the dispatcher can cancel the live handle on return
    instead of orphaning it (ADVICE r4)."""

    __slots__ = ("handle", "cancelled")

    def __init__(self):
        self.handle = None
        self.cancelled = False


def _wav_duration(data: bytes) -> float | None:
    """Duration of a RIFF/WAVE payload from its fmt byte rate and data
    chunk size; None for non-WAV payloads.  Hardens the audio clock
    against the silent declared-byte-rate guess (VERDICT r3 item 7)."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return None
    pos, byte_rate, data_size = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt " and size >= 16:
            byte_rate = int.from_bytes(body[8:12], "little")
        elif cid == b"data":
            # clamp to the bytes actually present: a truncated payload's
            # declared size would overstate duration and skew the A/V
            # clock (ADVICE r4)
            data_size = min(size, max(len(data) - pos - 8, 0))
        pos += 8 + size + (size & 1)       # chunks are word-aligned
    if byte_rate and data_size is not None:
        return data_size / float(byte_rate)
    return None


class Player(EventDispatcher):
    """The Player, decoding and converting colour on ``device``;
    ``backend`` is ``"torch"`` or ``"oracle"`` (the Decoder's)."""

    def __init__(self, config: PlayerConfig | None = None,
                 backend: str = "torch", audio_clock=None, *,
                 device="cuda"):
        check_backend(backend)
        super().__init__()
        self.config = config or PlayerConfig()
        self.config.validate()
        self.backend = backend
        self.device = torch.device(device)
        self.audio = audio_clock or NullAudioClock()

        self._sources: list[SourceVariant] = []
        self._source_index = 0
        self._source: ByteSource | None = None
        self._pending_request = None
        self._lock = threading.RLock()

        self.decoder: Decoder | None = None
        self.ready_state = ReadyState.HAVE_NOTHING
        self.network_state = NetworkState.NETWORK_EMPTY
        self.error: MediaError | None = None

        self._frames: list[tuple[DecodedFrame, float]] = []  # (frame, t_ms)
        self._current_time_ms = 0.0
        self._paused = True
        self._ended = False
        self._seeking = False
        self._pending_seek_ms: float | None = None
        self._muted = self.config.muted
        self.default_muted = self.config.muted
        self._volume = 1.0
        self._playback_rate = 1.0
        self._default_playback_rate = 1.0
        self.loop = self.config.loop
        self.autoplay = self.config.autoplay
        self.preload = self.config.preload
        self.poster = ""
        self._played: list[tuple[float, float]] = []
        self._played_anchor: float | None = None
        self._waiting_count = 0
        self._stalled_byte: int | None = None
        self._preload_released = False     # play()/load() lifts the hint
        self._audio_loaded = False
        self._resume_gate = False          # buffer_min_sec stall recovery
        self._abort_delivery = False       # drop in-flight sync chunks
        self._next_frame_due_ms: float | None = None
        self._last_sync_check = 0.0
        self._av_hold: str | None = None   # "audio" | "video" pause-ahead
        self._audio_unlocked = not self.config.unlock_audio
        self._thread = None
        self._thread_stop = threading.Event()
        self._frame_sink = None

        from ..runtime.profiler import FpsMeter, Metrics

        self.metrics = Metrics()
        self._fps = FpsMeter()
        self._decode_thread = None
        self._decode_stop = threading.Event()

    # ------------------------------------------------------------------
    # Source handling

    @property
    def src(self):
        if not self._sources:
            return ""
        return self._sources[self._source_index].src

    @src.setter
    def src(self, value):
        if isinstance(value, (list, tuple)):
            variants = [
                SourceVariant(v["src"], float(v.get("b", 0)),
                              bool(v.get("use", False)))
                if isinstance(v, dict) else SourceVariant(v)
                for v in value
            ]
            variants.sort(key=lambda v: -v.bitrate)
        else:
            variants = [SourceVariant(value)]
        self._sources = variants
        # a "use"-flagged source overrides highest-bitrate-first start
        # selection (easybits.player.js:1208-1230)
        self._source_index = next(
            (i for i, v in enumerate(variants) if v.use), 0)
        self.emit("srcchange")
        self._load(explicit=False)

    def can_play_type(self, mime: str) -> str:
        return "probably" if "jsv" in mime else ""

    canPlayType = can_play_type

    @property
    def audio_src(self) -> str:
        """Companion-audio source resolved through config.audio_map
        (the reference's audioMap regex mapping)."""
        import re

        src = self.src
        if not isinstance(src, str):
            return ""
        for pattern, replacement in self.config.audio_map:
            if re.search(pattern, src):
                return re.sub(pattern, replacement, src)
        return ""

    def load(self) -> None:
        """Explicit load(): starts fetching regardless of the preload
        hint (an application-initiated load, like the reference's
        explicit 'load' entry)."""
        self._load(explicit=True)

    def _load(self, explicit: bool) -> None:
        with self._lock:
            self._load_locked(explicit)

    def _load_locked(self, explicit: bool) -> None:
        if not self._sources:
            self.network_state = NetworkState.NETWORK_NO_SOURCE
            return
        self._reset_for_source()
        self.emit("loadstart")
        if explicit:
            self._preload_released = True
        try:
            self._source = source_for(self._sources[self._source_index].src)
        except Exception as e:
            self._fail(MediaError.MEDIA_ERR_SRC_NOT_SUPPORTED, str(e))
            return
        if not self._net_allowed():
            # preload="none": defer ALL network until play()/load()
            # (easybits.player.js:692-694 gates the initial 'ld' on the
            # preload mode)
            self.network_state = NetworkState.NETWORK_IDLE
            self.emit("suspend")
            return
        self.network_state = NetworkState.NETWORK_LOADING
        self._load_audio()
        self._request_range(0)

    def _net_allowed(self) -> bool:
        """Does the preload hint currently allow network activity?

        ``"auto"`` always; ``"metadata"`` only until the container
        header + key map are parsed; ``"none"`` never — until playback
        or an explicit load() releases the gate for good."""
        if self._preload_released or self.autoplay:
            return True
        if self.preload == "none":
            return False
        if self.preload == "metadata":
            d = self.decoder
            return d is None or d.meta is None
        return True

    def _release_preload(self) -> None:
        """Playback (or explicit load/seek) lifts the preload gate and
        resumes deferred network work."""
        if self._preload_released:
            return
        self._preload_released = True
        if (self._source is None or self.decoder is None
                or self._pending_request is not None
                or self.decoder.buffer.fully_loaded):
            return
        if not self._audio_loaded:
            self._load_audio()
        start = (self._stalled_byte if self._stalled_byte is not None
                 else self.decoder.buffer.read_pos)
        self._request_range(start)

    def _load_audio(self) -> None:
        """Fetch the companion audio payload resolved via config.audio_map
        and install a WallClockAudio over it (only when the caller did not
        supply an audio clock of their own)."""
        url = self.audio_src
        self._audio_loaded = True
        if not url or not isinstance(self.audio, NullAudioClock):
            return
        try:
            src = source_for(url)
        except Exception:
            return                           # no audio is not an error
        chunks: list[bytes] = []

        def on_data(start, data, total):
            chunks.append(data)

        def on_complete():
            with self._lock:
                was_playing = self.audio.playing
                t = self.audio.current_time
                clock = WallClockAudio(b"".join(chunks))
                clock.seek(t)
                if was_playing:
                    clock.play()
                self.audio = clock
                self.emit("audioloaded")

        src.request(0, None, on_data, on_complete=on_complete)

    def _reset_for_source(self) -> None:
        self._cancel_request()
        dec = Decoder(self.config, backend=self.backend, device=self.device)
        dec.on("meta", self._on_meta)
        dec.on("seq", self._on_seq)
        dec.on("stalled", self._on_stalled)
        dec.on("ended", self._on_ended)
        self.decoder = dec
        self._frames.clear()
        self._ended = False
        self._stalled_byte = None
        self._resume_gate = False
        self._audio_loaded = False
        # the preload hint applies PER resource load: a released gate on
        # the previous src must not let the next src start fetching
        # (ADVICE r4; the reference gates each load on the preload mode,
        # easybits.player.js:692-697)
        self._preload_released = False
        self.ready_state = ReadyState.HAVE_NOTHING

    def _fail(self, code: int, message: str) -> None:
        self.error = MediaError(code, message)
        self.network_state = NetworkState.NETWORK_NO_SOURCE
        self.emit("error", self.error)

    # ------------------------------------------------------------------
    # Network pump (loadAjax/ld/onchunk analog)

    def _bytes_per_sec(self) -> float:
        d = self.decoder
        if d and d.meta and d.meta.duration > 0 and d.buffer.total_length:
            return d.buffer.total_length / d.meta.duration
        return float(self.config.chunk_size)

    def _request_range(self, start: int, seeking: bool = False) -> None:
        if self._source is None or self.decoder is None:
            return
        self._cancel_request()
        fwd = int(self._bytes_per_sec() * self.config.buffer_sec)
        plan = self.decoder.buffer.next_range_to_download(
            start, forward_limit=max(fwd, self.config.chunk_size),
            seeking=seeking)
        if plan is None:
            self.network_state = NetworkState.NETWORK_IDLE
            self.emit("suspend")
            return
        s, e = plan
        if not getattr(self._source, "streaming", True):
            # per-chunk transports: align the start down AND the end up to
            # chunk boundaries so successive requests tile exactly instead
            # of re-downloading a partial final chunk's head
            # (easybits.player.js:1895 ceils the end the same way)
            cs = self.config.chunk_size
            s -= s % cs
            if e is not None:
                e = ((e + 1 + cs - 1) // cs) * cs - 1
                total = self.decoder.buffer.total_length
                if total:
                    e = min(e, total - 1)
        self.network_state = NetworkState.NETWORK_LOADING
        self._abort_delivery = False
        # the pending slot is filled BEFORE dispatch: synchronous sources
        # deliver (and complete) inside request(), so a post-call
        # assignment would resurrect an already-finished request and
        # block every future refill on the stale handle
        req = _PendingRequest()
        self._pending_request = req
        req.handle = self._source.request(
            s, e, self._on_chunk, on_error=self._on_net_error,
            on_complete=lambda: self._on_request_complete(req),
            chunk_size=self.config.chunk_size)
        if req.cancelled and req.handle is not None:
            # the slot was cleared while request() was in flight (an
            # async source's reentrant callbacks): cancel the now-live
            # handle so it cannot keep delivering into the buffer
            self._source.cancel(req.handle)
            req.handle = None

    def _cancel_request(self) -> None:
        if self._pending_request is not None and self._source is not None:
            self._pending_request.cancelled = True
            if self._pending_request.handle is not None:
                self._source.cancel(self._pending_request.handle)
            self._pending_request = None

    def _on_chunk(self, start: int, data: bytes, total: int) -> None:
        with self._lock:
            if self.decoder is None or self._abort_delivery:
                return
            self.decoder.feed(start, data, total)
            self.emit("progress")
            if not self._net_allowed():
                # preload="metadata": header + key map are in — stop
                # (the reference fetches a single chunk for this mode,
                # easybits.player.js:694-696).  Synchronous sources
                # deliver inside request(), so also drop the in-flight
                # chunks the cancel can't reach.
                self._abort_delivery = True
                self._cancel_request()
                self.network_state = NetworkState.NETWORK_IDLE
                self.emit("suspend")
                return
            if self._stalled_byte is not None and \
                    self.decoder.buffer.buffered_from(
                        self._stalled_byte) > 0:
                self._stalled_byte = None
                self.emit("unstalled")
            if self._pending_seek_ms is not None:
                self._try_pending_seek()
            self._fill_queue()

    def _on_request_complete(self, req: _PendingRequest) -> None:
        with self._lock:
            if self._pending_request is not req:
                return                     # a cancelled request's late end
            self._pending_request = None
            if self.decoder is None:
                return
            self._fill_queue()
            if not self._net_allowed():
                self.network_state = NetworkState.NETWORK_IDLE
            elif self._stalled_byte is not None:
                self._request_range(self._stalled_byte)
            elif not self.decoder.buffer.fully_loaded:
                self._request_range(self.decoder.buffer.read_pos)
            else:
                self.network_state = NetworkState.NETWORK_IDLE

    def _on_net_error(self, e: Exception) -> None:
        self._fail(MediaError.MEDIA_ERR_NETWORK, str(e))

    def _on_stalled(self, byte: int) -> None:
        self._stalled_byte = byte
        if self._pending_request is None and self._net_allowed():
            self._request_range(byte)

    # ------------------------------------------------------------------
    # Decoder events

    def _on_meta(self, meta) -> None:
        self.ready_state = max(self.ready_state, ReadyState.HAVE_METADATA)
        self.emit("durationchange")
        self.emit("loadedmetadata")

    def _on_seq(self, info) -> None:
        self.emit("resize")

    def _on_ended(self) -> None:
        pass                                   # handled at queue drain

    # ------------------------------------------------------------------
    # Decode-ahead queue (onf analog, easybits.player.js:2543-2668)

    def _fill_queue(self) -> None:
        d = self.decoder
        if d is None or self._seeking or getattr(self, "_filling", False):
            return
        if self._pending_seek_ms is not None:
            # a seek issued before metadata must not be dropped when the
            # source finished delivering before the header parsed (no
            # further _on_chunk would retry it) — decoding from 0 past a
            # requested position would be wrong output, not just late
            self._try_pending_seek()
            if self._pending_seek_ms is not None:
                return                     # still unresolvable: no decode
        self._filling = True
        try:
            with span("fill", before=len(self._frames)) as s:
                self._fill_queue_inner(d)
                s.set(after=len(self._frames))
        finally:
            self._filling = False

    def _fill_queue_inner(self, d) -> None:
        while len(self._frames) < self.config.max_decoded_frames:
            frame = d.decode_frame()
            if frame is None:
                break
            t_ms = frame.ts_ms if frame.ts_ms else (
                self._queue_tail_ms() + self._frame_duration_ms())
            self._frames.append((frame, t_ms))
            if len(self._frames) == 1:
                self.ready_state = max(self.ready_state,
                                       ReadyState.HAVE_CURRENT_DATA)
                self.emit("loadeddata")
            if len(self._frames) == 2:
                if self.ready_state < ReadyState.HAVE_FUTURE_DATA:
                    self.ready_state = ReadyState.HAVE_FUTURE_DATA
                    self.emit("canplay")
        if len(self._frames) >= self.config.max_decoded_frames:
            if self.ready_state < ReadyState.HAVE_ENOUGH_DATA:
                self.ready_state = ReadyState.HAVE_ENOUGH_DATA
                self.emit("canplaythrough")
                if self.autoplay and self._paused and not self._ended:
                    self.play()
        # forward-buffer prefetch continuation (ld on bufferadvance analog)
        if (self._pending_request is None and not d.buffer.fully_loaded
                and self._stalled_byte is None and self._net_allowed()
                and self.network_state != NetworkState.NETWORK_LOADING):
            self._request_range(d.buffer.read_pos)

    def _queue_tail_ms(self) -> float:
        if self._frames:
            return self._frames[-1][1]
        return self._current_time_ms

    def _frame_duration_ms(self) -> float:
        seq = self.decoder.sequence if self.decoder else None
        rate = seq.picture_rate if seq else 30.0
        return 1000.0 / max(rate, 1e-6)

    # ------------------------------------------------------------------
    # Properties

    @property
    def current_time(self) -> float:
        return self._current_time_ms / 1000.0

    @current_time.setter
    def current_time(self, t: float) -> None:
        self._seek(t * 1000.0)

    currentTime = current_time

    @property
    def duration(self) -> float:
        d = self.decoder
        return d.meta.duration if d and d.meta else float("nan")

    @property
    def video_width(self) -> int:
        d = self.decoder
        return d.meta.width if d and d.meta else 0

    videoWidth = video_width

    @property
    def video_height(self) -> int:
        d = self.decoder
        return d.meta.height if d and d.meta else 0

    videoHeight = video_height

    @property
    def paused(self) -> bool:
        return self._paused

    @property
    def ended(self) -> bool:
        return self._ended

    @property
    def seeking(self) -> bool:
        return self._seeking

    @property
    def muted(self) -> bool:
        return self._muted

    @muted.setter
    def muted(self, v: bool) -> None:
        self._muted = bool(v)
        self.emit("volumechange")

    @property
    def volume(self) -> float:
        return self._volume

    @volume.setter
    def volume(self, v: float) -> None:
        if not 0.0 <= v <= 1.0:
            raise ValueError("volume out of range")   # INDEX_SIZE_ERR
        self._volume = v
        self.emit("volumechange")

    @property
    def playback_rate(self) -> float:
        return self._playback_rate

    @playback_rate.setter
    def playback_rate(self, v: float) -> None:
        self._playback_rate = float(v)
        self.emit("ratechange")

    playbackRate = playback_rate

    @property
    def default_playback_rate(self) -> float:
        return self._default_playback_rate

    @default_playback_rate.setter
    def default_playback_rate(self, v: float) -> None:
        self._default_playback_rate = float(v)

    def _byte_to_time(self, byte: int) -> float:
        """byte offset -> stream seconds.

        VBR-correct when the container ships a GOP key map: its
        (byte offset, timecode) pairs form a piecewise-linear byte<->time
        index (the reference records equivalent per-range metadata at
        chunk ingest, easybits.player.js:2101-2156).  Falls back to the
        whole-stream average rate otherwise."""
        d = self.decoder
        km = d.meta.key_map if d and d.meta else None
        if km is not None and km.count > 0:
            rate = (d.sequence.picture_rate if d.sequence else 30.0)
            offs = km.offsets.astype(np.float64)
            times = np.array([km.time_of(i, rate)
                              for i in range(km.count)])
            total = float(d.buffer.total_length or offs[-1])
            offs = np.append(offs, total)
            times = np.append(times, d.meta.duration)
            return float(np.interp(byte, offs, times))
        return byte / self._bytes_per_sec()

    @property
    def buffered(self) -> TimeRanges:
        d = self.decoder
        if d is None or d.meta is None or not d.buffer.total_length:
            return TimeRanges()
        return TimeRanges([(self._byte_to_time(s), self._byte_to_time(e + 1))
                           for s, e in d.buffer.byte_ranges()])

    @property
    def played(self) -> TimeRanges:
        return TimeRanges(self._played)

    @property
    def seekable(self) -> TimeRanges:
        d = self.decoder
        if d is None or d.meta is None:
            return TimeRanges()
        return TimeRanges([(0.0, d.meta.duration)])

    # ------------------------------------------------------------------
    # Playback control

    def unlock_audio(self) -> None:
        """The reference's unlock ceremony analog
        (``features/unlockaudio.js``): with ``config.unlock_audio`` set,
        audio stays silent until the host app signals a user gesture by
        calling this; emits ``audiounlocked`` once."""
        if not self._audio_unlocked:
            self._audio_unlocked = True
            self.emit("audiounlocked")
            if not self._paused:
                self.audio.play()

    @property
    def audio_unlocked(self) -> bool:
        return self._audio_unlocked

    def play(self) -> None:
        # the reference is single-threaded JS; here asynchronous sources
        # deliver on their own threads, so every public mutator must
        # serialize against the locked delivery path (_on_chunk)
        with self._lock:
            if not self._paused:
                return
            self._paused = False
            self._ended = False
            self._release_preload()
            self.emit("play")
            if self._audio_unlocked:
                self.audio.play()
            self._played_anchor = self.current_time
            self._next_frame_due_ms = None
            self.emit("playing")
            self._fill_queue()

    def pause(self) -> None:
        with self._lock:
            if self._paused:
                return
            self._paused = True
            self.audio.pause()
            self._record_played()
            self.emit("pause")

    def _record_played(self) -> None:
        if self._played_anchor is None:
            return
        a, b = self._played_anchor, self.current_time
        if b > a:
            self._played = _merge_ranges(self._played + [(a, b)])
        self._played_anchor = None

    # ------------------------------------------------------------------
    # Render clock (displayFrame analog)

    def tick(self, now_s: float) -> None:
        """Advance playback to wall/virtual time ``now_s`` (seconds); a
        ``tick`` span of the span log while a profiler records."""
        with self._lock, span("tick", now_s=now_s, queued=len(self._frames)):
            if self._paused or self._seeking:
                return
            now_ms = now_s * 1000.0
            if self._next_frame_due_ms is None:
                self._next_frame_due_ms = now_ms
            frame_ms = self._frame_duration_ms() / self._playback_rate
            if self._av_hold == "video":
                # video is ahead of audio: hold the render clock until a
                # sync check releases it (reference pauses the ahead side,
                # easybits.player.js:2326-2368)
                self._next_frame_due_ms = now_ms
            elif self._resume_gate and not self._resume_allowed():
                # stall recovery waits for buffer_min_sec of decoded
                # forward buffer before resuming (the reference's
                # bufferMinSec knob, easybits.player.js:406-407,1079)
                self._next_frame_due_ms = now_ms
            else:
                if self._resume_gate:
                    self._resume_gate = False
                    self.emit("unstalled")
                    if not self._paused and self._audio_unlocked:
                        self.audio.play()
                while now_ms >= self._next_frame_due_ms:
                    if not self._display_one_frame():
                        return
                    behind = now_ms - self._next_frame_due_ms
                    if self.config.skip_hard and behind > 2 * frame_ms:
                        self.metrics.count("late_skips")
                        self._next_frame_due_ms = now_ms + frame_ms
                    else:
                        self._next_frame_due_ms += frame_ms
            if now_ms - self._last_sync_check >= \
                    self.config.sync_interval_ms:
                self._last_sync_check = now_ms
                self._check_av_sync()

    def _display_one_frame(self) -> bool:
        if not self._frames:
            d = self.decoder
            if d is not None and d.ended:
                self._finish_playback()
            else:
                self._underrun()
            return False
        frame, t_ms = self._frames.pop(0)
        self._current_time_ms = t_ms
        if self._frame_sink is not None:
            shown = self.metrics.counters.get("frames_displayed", 0)
            out = frame
            if self.config.emit_rgb:
                with span("to_rgb", frame=shown):
                    out = self._to_rgb(frame)
            with span("sink", frame=shown):
                self._frame_sink(out, t_ms / 1000.0)
        self.emit("frameout", frame, t_ms / 1000.0)
        self.emit("timeupdate")
        self.metrics.count("frames_displayed")
        self._fps.tick()
        if self._decode_thread is None:
            self._fill_queue()
        return True

    @property
    def display_fps(self) -> float:
        return self._fps.fps

    def set_frame_sink(self, fn) -> None:
        """fn(DecodedFrame, t_seconds) — the render target.

        With ``config.emit_rgb`` the sink instead receives a display-size
        (H, W, 3) uint8 RGB tensor — (H, W, 4) RGBA with the DECODED alpha
        plane for YUVA streams — converted on the planes' device, the
        analog of the reference's display-time YCbCrToRGBA pass
        (``player/parts/end.js:77-156``)."""
        self._frame_sink = fn

    def _to_rgb(self, frame) -> torch.Tensor:
        """Device colour convert of the container-size crop (planes are
        coded-size, multiples of 16): the planes go in as views of that
        crop, so the conversion (one colour launch on a card) writes only
        the display image, contiguous.  Each output pixel depends on its
        own samples alone, so this is jsvx's convert-then-crop."""
        p = [torch.as_tensor(x, device=self.device) for x in frame.planes]
        h, w = self.video_height, self.video_width
        if h and w:
            hc, wc = -(-h // 2), -(-w // 2)
            p = [p[0][:h, :w], p[1][:hc, :wc], p[2][:hc, :wc],
                 *(a[:h, :w] for a in p[3:])]
        return ycbcr_to_rgb(p[0], p[1], p[2], p[3] if len(p) >= 4 else False)

    def _resume_allowed(self) -> bool:
        """After an underrun, resume only with >= buffer_min_sec of
        decoded forward buffer (or queue-full / end-of-stream, whichever
        comes first — the queue cap bounds the achievable lookahead)."""
        if not self._frames:
            return False
        d = self.decoder
        if d is not None and d.ended:
            return True
        if len(self._frames) >= self.config.max_decoded_frames:
            return True
        queued_ms = len(self._frames) * self._frame_duration_ms()
        return queued_ms >= self.config.buffer_min_sec * 1000.0

    def _underrun(self) -> None:
        self._waiting_count += 1
        self._resume_gate = True
        self.metrics.count("underruns")
        self.ready_state = ReadyState.HAVE_METADATA
        self.emit("waiting")
        if self._stalled_byte is not None:
            self.emit("stalled")
        self.audio.pause()
        if self._waiting_count >= self.config.max_waitings:
            self._waiting_count = 0
            self._switch_to_lower_bitrate()

    def _finish_playback(self) -> None:
        self._record_played()
        if self.loop:
            self._seek(0.0, resume=True)
            return
        self._paused = True
        self._ended = True
        self.audio.pause()
        self.emit("timeupdate")
        self.emit("ended")

    # ------------------------------------------------------------------
    # Page-visibility auto-pause (features/pagevisibility.js analog)

    def set_visible(self, visible: bool) -> None:
        """Host-app visibility hook: hidden pauses playback, visible
        resumes it if the pause was visibility-induced
        (easybits.player.js:1857-1865)."""
        if not visible and not self._paused:
            self._paused_by_visibility = True
            self.pause()
        elif visible and getattr(self, "_paused_by_visibility", False):
            self._paused_by_visibility = False
            self.play()

    # ------------------------------------------------------------------
    # A/V sync (checkAVSync analog)

    def _check_av_sync(self) -> None:
        """checkAVSync analog (easybits.player.js:2326-2368): past the
        +/-300 ms window, pause WHICHEVER side is ahead until the other
        catches up; the held side resumes at a later sync check.
        Follow-video clocks (NullAudioClock) are snapped instead."""
        a = self.audio
        if getattr(a, "follows_video", False):
            if not a.playing:
                return
            drift_ms = abs((a.current_time + self.config.audio_shift_sec)
                           * 1000.0 - self._current_time_ms)
            if drift_ms > self.config.av_sync_limit_ms:
                a.seek(self.current_time - self.config.audio_shift_sec)
                self.emit("avsync", drift_ms)
            return

        audio_ms = (a.current_time + self.config.audio_shift_sec) * 1000.0
        drift_ms = audio_ms - self._current_time_ms   # > 0: audio ahead
        if self._av_hold == "audio":
            if drift_ms <= 0:              # video caught up: resume audio
                self._av_hold = None
                if not self._paused and self._audio_unlocked:
                    a.play()
            return
        if self._av_hold == "video":
            if drift_ms >= 0:              # audio caught up: release video
                self._av_hold = None
            return
        if self._paused or not getattr(a, "playing", False):
            return
        if drift_ms > self.config.av_sync_limit_ms:
            a.pause()                      # audio ahead: pause audio
            self._av_hold = "audio"
            self.emit("avsync", drift_ms)
        elif drift_ms < -self.config.av_sync_limit_ms:
            self._av_hold = "video"        # video ahead: hold the clock
            self.emit("avsync", drift_ms)

    # ------------------------------------------------------------------
    # ABR (bitrate down-switch)

    def _switch_to_lower_bitrate(self) -> None:
        if self._source_index + 1 >= len(self._sources):
            return
        t = self.current_time
        was_playing = not self._paused
        self._source_index += 1
        self.emit("bitratechange",
                  self._sources[self._source_index].bitrate)
        self.load()
        if t > 0:
            self._pending_seek_ms = t * 1000.0
        if was_playing:
            self._paused = False

    # ------------------------------------------------------------------
    # Seeking

    def _seek(self, target_ms: float, resume: bool = False) -> None:
        # serialized against the delivery thread: an unlocked seek racing
        # _on_chunk's _fill_queue could reposition the decoder mid-decode
        # and double-deliver a GOP (observed as duplicated frames in the
        # play CLI's seek-before-metadata race)
        with self._lock:
            d = self.decoder
            if d is None or d.meta is None:
                self._pending_seek_ms = target_ms
                return
            dur_ms = d.meta.duration * 1000.0
            target_ms = min(max(target_ms, 0.0), dur_ms)
            self._release_preload()        # seeking implies data loading
            self._record_played()
            self._seeking = True
            self._frames.clear()
            self.emit("seeking")
            self.audio.pause()
            if d.seek(target_ms):
                self._finish_seek(target_ms, resume)
            else:
                self._pending_seek_ms = target_ms

    def _try_pending_seek(self) -> None:
        target = self._pending_seek_ms
        if target is None or self.decoder is None \
                or self.decoder.meta is None:
            return
        if self.decoder.seek(target):
            self._pending_seek_ms = None
            self._finish_seek(target, resume=not self._paused)

    def _finish_seek(self, target_ms: float, resume: bool) -> None:
        # drop pre-seek frames: when a seek was PENDING (issued before
        # metadata), frames decoded from the old position may have been
        # queued between the request and its resolution — _seek only
        # clears the queue on its immediate path
        self._frames.clear()
        self._seeking = False
        self._av_hold = None
        self._resume_gate = False
        self._current_time_ms = self.decoder.current_time_ms
        self._next_frame_due_ms = None
        # syncMedia analog: drive the audio clock onto the video clock
        # (<= 0.1 s precision, features/syncmedia.js:18-59)
        self.audio.seek(self.current_time - self.config.audio_shift_sec)
        self._fill_queue()
        self.emit("timeupdate")
        self.emit("seeked")
        self._played_anchor = self.current_time
        if resume and self._paused:
            self._paused = False
            if self._audio_unlocked:
                self.audio.play()

    # ------------------------------------------------------------------
    # Background decode (the reference's front/back worker split,
    # easybits.player.js:216-217 — designed but disabled there; here the
    # decode back-end genuinely runs off the render clock's thread)

    def start_background_decode(self, poll_s: float = 0.002) -> None:
        """Run the decode back-end (fill of the decode-ahead queue) on
        its own thread; ``tick`` then only displays."""
        if self._decode_thread is not None:
            return
        self._decode_stop.clear()

        def loop():
            while not self._decode_stop.is_set():
                with self._lock:
                    full = (self.decoder is None or self._seeking
                            or len(self._frames)
                            >= self.config.max_decoded_frames
                            or (self.decoder is not None
                                and self.decoder.ended))
                    if not full:
                        self._fill_queue()
                _time.sleep(poll_s)

        self._decode_thread = threading.Thread(target=loop, daemon=True)
        self._decode_thread.start()

    def stop_background_decode(self) -> None:
        if self._decode_thread is None:
            return
        self._decode_stop.set()
        self._decode_thread.join(timeout=5.0)
        self._decode_thread = None

    # ------------------------------------------------------------------
    # Real-time pump

    def run_realtime(self, max_seconds: float | None = None) -> None:
        """Run a wall-clock tick loop in a background thread."""
        self._thread_stop.clear()

        def loop():
            t0 = _time.monotonic()
            while not self._thread_stop.is_set():
                now = _time.monotonic()
                if max_seconds is not None and now - t0 > max_seconds:
                    break
                self.tick(now)
                _time.sleep(min(self._frame_duration_ms(), 15.0) / 2000.0)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop_realtime(self) -> None:
        self._thread_stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def destroy(self) -> None:
        self.stop_realtime()
        self.stop_background_decode()
        self._cancel_request()
        self.decoder = None
        self._frames.clear()


def _merge_ranges(ranges):
    out = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1] + 1e-9:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out
