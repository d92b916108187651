"""Byte-range sources: the network layer feeding the stream buffer.

The framework analog of the reference's ``ez_http`` loader
(``features/http.js:109-143``): ranged, chunked, cancellable requests with
``on_data(start, data, total)`` callbacks.  Three implementations:

* :class:`MemorySource` — in-memory bytes (tests, already-loaded files);
* :class:`FileSource`   — local file with optional thread-async delivery;
* :class:`HttpSource`   — HTTP(S) Range requests over urllib.
"""

from __future__ import annotations

import os
import threading
import urllib.request
from dataclasses import dataclass


class ByteSource:
    """Interface: ranged chunked loading with cancellation.

    ``streaming`` mirrors the reference loader's ``stream`` capability bit
    (``features/http.js:109-143``): True when one request can deliver an
    arbitrarily long range as a chunk stream; False when the transport
    fetches one chunk per request, in which case the caller should align
    request starts to chunk boundaries (``easybits.player.js:1872-1970``).
    """

    streaming: bool = True

    def total_length(self) -> int | None:
        raise NotImplementedError

    def request(self, start: int, end: int | None, on_data,
                on_error=None, on_complete=None, chunk_size: int = 300000):
        """Fetch [start, end] (inclusive; None = to EOS).  Delivers
        ``on_data(start, bytes, total)`` per chunk.  Returns a cancel
        handle."""
        raise NotImplementedError

    def cancel(self, handle) -> None:
        raise NotImplementedError


class _CancelFlag:
    def __init__(self):
        self.cancelled = False


class MemorySource(ByteSource):
    """Bytes already in memory; sync or async chunked delivery."""

    def __init__(self, data: bytes, async_delivery: bool = False,
                 latency_s: float = 0.0):
        self._data = bytes(data)
        self._async = async_delivery
        self._latency = latency_s

    def total_length(self) -> int | None:
        return len(self._data)

    def _pump(self, start, end, on_data, on_complete, chunk, flag):
        import time

        total = len(self._data)
        end = total - 1 if end is None else min(end, total - 1)
        pos = start
        while pos <= end and not flag.cancelled:
            if self._latency:
                time.sleep(self._latency)
            n = min(chunk, end - pos + 1)
            on_data(pos, self._data[pos:pos + n], total)
            pos += n
        if on_complete and not flag.cancelled:
            on_complete()

    def request(self, start, end, on_data, on_error=None, on_complete=None,
                chunk_size: int = 300000):
        flag = _CancelFlag()
        if self._async:
            t = threading.Thread(
                target=self._pump,
                args=(start, end, on_data, on_complete, chunk_size, flag),
                daemon=True)
            t.start()
        else:
            self._pump(start, end, on_data, on_complete, chunk_size, flag)
        return flag

    def cancel(self, handle) -> None:
        handle.cancelled = True


class FileSource(ByteSource):
    def __init__(self, path: str, async_delivery: bool = True):
        self._path = path
        self._size = os.path.getsize(path)
        self._async = async_delivery

    def total_length(self) -> int | None:
        return self._size

    def _pump(self, start, end, on_data, on_error, on_complete, chunk, flag):
        try:
            end = self._size - 1 if end is None else min(end, self._size - 1)
            with open(self._path, "rb") as f:
                f.seek(start)
                pos = start
                while pos <= end and not flag.cancelled:
                    n = min(chunk, end - pos + 1)
                    data = f.read(n)
                    if not data:
                        break
                    on_data(pos, data, self._size)
                    pos += len(data)
            if on_complete and not flag.cancelled:
                on_complete()
        except Exception as e:             # pragma: no cover
            if on_error:
                on_error(e)

    def request(self, start, end, on_data, on_error=None, on_complete=None,
                chunk_size: int = 300000):
        flag = _CancelFlag()
        args = (start, end, on_data, on_error, on_complete, chunk_size, flag)
        if self._async:
            threading.Thread(target=self._pump, args=args,
                             daemon=True).start()
        else:
            self._pump(*args)
        return flag

    def cancel(self, handle) -> None:
        handle.cancelled = True


class _HttpHandle(_CancelFlag):
    """Cancel handle that can abort an in-flight response.

    The reference loader aborts mid-request (``xhr.abort()`` /
    ``reader.cancel()``, ``features/http.js:116-124,203,343``); the urllib
    analog is closing the response object from the cancelling thread, which
    makes a blocked ``resp.read()`` raise immediately instead of waiting for
    the next chunk boundary.
    """

    def __init__(self):
        super().__init__()
        self._resp = None
        self._lock = threading.Lock()

    def attach(self, resp) -> bool:
        with self._lock:
            if self.cancelled:
                return False
            self._resp = resp
            return True

    def detach(self) -> None:
        with self._lock:
            self._resp = None

    def abort(self) -> None:
        with self._lock:
            self.cancelled = True
            resp, self._resp = self._resp, None
        if resp is not None:
            try:
                resp.close()
            except Exception:
                pass


class HttpSource(ByteSource):
    """Ranged HTTP fetches with the reference loader's robustness.

    Behaviors mirrored from ``features/http.js:145-424``:

    * **strategy probing** — a response tells us whether the server honors
      ``Range`` (206/Content-Range).  If it answers an explicit Range with
      200, ``ranged`` flips False and the body is pumped to EOF in
      whole-body mode (delivery starts at the requested offset): everything
      paid for is buffered, the clean EOF marks end-of-stream, and the
      player's hole planner never issues another windowed request — the
      reference loader's ``onFirstChunk`` switch (``features/http.js``).
    * **sequential-chunk fallback** — ``sequential=True`` (the xhrLoader
      non-streaming mode) issues one Range request per ``chunk_size`` chunk
      instead of streaming a single long response.
    * **retry with resume** — transient failures (timeouts, resets, 5xx)
      are retried up to ``retries`` times with exponential backoff,
      resuming from the last delivered byte, before ``on_error`` fires.
    * **mid-request abort** — ``cancel`` closes the live response so a
      blocked read returns immediately (see :class:`_HttpHandle`).
    * ``cache_buster`` appends ``?bytes=s-e`` like the reference's Safari
      workaround (``features/http.js:260-266``).
    """

    def __init__(self, url: str, timeout: float = 30.0, retries: int = 3,
                 backoff_s: float = 0.25, sequential: bool = False,
                 cache_buster: bool = False):
        self._url = url
        self._timeout = timeout
        self._retries = max(0, retries)
        self._backoff = backoff_s
        self._sequential = sequential
        self._cache_buster = cache_buster
        self._total: int | None = None
        self.ranged: bool | None = None     # None until probed
        self.streaming = not sequential

    def total_length(self) -> int | None:
        if self._total is None:
            req = urllib.request.Request(self._url, method="HEAD")
            try:
                with urllib.request.urlopen(req,
                                            timeout=self._timeout) as resp:
                    cl = resp.headers.get("Content-Length")
                    self._total = int(cl) if cl else None
            except Exception:
                self._total = None
        return self._total

    def _open(self, start: int, end: int | None):
        url = self._url
        if self._cache_buster:
            sep = "&" if "?" in url else "?"
            url = f"{url}{sep}bytes={start}-{'' if end is None else end}"
        headers = {}
        if start or end is not None:
            rng = f"bytes={start}-" + ("" if end is None else str(end))
            headers["Range"] = rng
        req = urllib.request.Request(url, headers=headers)
        return urllib.request.urlopen(req, timeout=self._timeout)

    def _note_response(self, resp, start: int, sent_range: bool):
        """Probe the range strategy from a live response; returns the byte
        offset the response body actually begins at.  ``ranged`` is only
        concluded False when a Range header was actually sent and the
        server answered 200 anyway."""
        total = self._total
        cr = resp.headers.get("Content-Range")
        if cr and "/" in cr:
            try:
                total = int(cr.rsplit("/", 1)[1])
                self._total = total
            except ValueError:
                pass
        code = getattr(resp, "status", None) or resp.getcode()
        if code == 206:
            self.ranged = True
            return start, False
        # 200: the server sent the whole body from byte 0.  That only
        # proves it ignores Range if we asked for one.
        if sent_range:
            self.ranged = False
        cl = resp.headers.get("Content-Length")
        if code == 200 and cl and self._total is None:
            try:
                self._total = int(cl)
            except ValueError:
                pass
        return (0, True) if code == 200 else (start, False)

    def _pump_body(self, resp, body_pos, start, end, on_data, chunk, flag,
                   prog=None):
        """Stream one response body, slicing off bytes before ``start``
        (the unranged-200 case).  Returns the next byte to deliver;
        ``prog`` (a one-element list) tracks it live so a mid-read
        exception still resumes from the last DELIVERED byte."""
        pos = start
        while not flag.cancelled:
            data = resp.read(chunk)
            if not data:
                break
            seg_end = body_pos + len(data)
            if seg_end > pos:
                payload = data[pos - body_pos:]
                if end is not None and pos + len(payload) > end + 1:
                    payload = payload[:end + 1 - pos]
                if payload:
                    on_data(pos, payload, self._total or 0)
                    pos += len(payload)
                    if prog is not None:
                        prog[0] = pos
            body_pos = seg_end
            if end is not None and pos > end:
                break
        return pos

    def _pump(self, start, end, on_data, on_error, on_complete, chunk, flag):
        import time

        pos = start
        attempts = 0
        while not flag.cancelled:
            req_end = end
            if self._sequential:
                req_end = pos + chunk - 1
                if end is not None:
                    req_end = min(req_end, end)
            try:
                resp = self._open(pos, req_end)
            except Exception as e:
                if flag.cancelled:
                    return
                if getattr(e, "code", None) == 416:
                    break               # requested past EOS: complete
                attempts += 1
                if attempts > self._retries:
                    if on_error:
                        on_error(e)
                    return
                time.sleep(self._backoff * (2 ** (attempts - 1)))
                continue
            if not flag.attach(resp):
                resp.close()
                return
            prog = [pos]
            clean_eof = False
            try:
                sent_range = bool(pos or req_end is not None)
                body_pos, whole = self._note_response(resp, pos, sent_range)
                pump_end = req_end
                if whole:
                    # A 200 body IS the whole resource: deliver all of it
                    # (the reference loader's whole-body switch,
                    # features/http.js onFirstChunk) instead of discarding
                    # the tail and re-downloading from byte 0 per window.
                    pump_end = None
                new_pos = self._pump_body(resp, body_pos, pos, pump_end,
                                          on_data, chunk, flag, prog)
                clean_eof = whole
            except Exception as e:
                flag.detach()
                if flag.cancelled:
                    return
                if prog[0] > pos:
                    # partial body delivered: resume from the last
                    # DELIVERED byte and reset the attempt budget
                    pos = prog[0]
                    attempts = 0
                attempts += 1
                if attempts > self._retries:
                    if on_error:
                        on_error(e)
                    return
                time.sleep(self._backoff * (2 ** (attempts - 1)))
                continue
            finally:
                flag.detach()
                try:
                    resp.close()
                except Exception:
                    pass
            made_progress = new_pos > pos
            pos = new_pos
            if made_progress:
                attempts = 0
            if flag.cancelled:
                return
            if clean_eof:
                # a 200 body is pumped to EOF: its clean EOF is
                # end-of-stream — never re-download to probe for more
                self._total = max(self._total or 0, pos)
                break
            done_to = end if end is not None else (
                None if self._total is None else self._total - 1)
            if done_to is not None and pos > done_to:
                break
            if not self._sequential:
                if made_progress and self._total is not None \
                        and pos >= self._total:
                    break
                # Short body: the connection closed early.  Retry/resume
                # from pos (streaming mode) unless we're at EOS.
                if not made_progress:
                    attempts += 1
                    if attempts > self._retries:
                        break           # treat persistent EOF as completion
                    time.sleep(self._backoff * (2 ** (attempts - 1)))
            elif not made_progress:
                break                   # sequential: empty chunk = EOS
        if on_complete and not flag.cancelled:
            on_complete()

    def request(self, start, end, on_data, on_error=None, on_complete=None,
                chunk_size: int = 300000):
        flag = _HttpHandle()
        threading.Thread(
            target=self._pump,
            args=(start, end, on_data, on_error, on_complete, chunk_size,
                  flag),
            daemon=True).start()
        return flag

    def cancel(self, handle) -> None:
        if isinstance(handle, _HttpHandle):
            handle.abort()
        else:
            handle.cancelled = True


class ChaosSource(ByteSource):
    """Fault-injection wrapper for resilience testing: drops a fraction
    of chunks, delays others, and can fail whole requests — exercising
    the stall/refill and error paths the way flaky networks do."""

    def __init__(self, inner: ByteSource, drop_rate: float = 0.0,
                 error_rate: float = 0.0, delay_s: float = 0.0, seed: int = 0):
        import random

        self._inner = inner
        self._rng = random.Random(seed)
        self.drop_rate = drop_rate
        self.error_rate = error_rate
        self.delay_s = delay_s

    @property
    def streaming(self):
        return self._inner.streaming

    def total_length(self):
        return self._inner.total_length()

    def request(self, start, end, on_data, on_error=None, on_complete=None,
                chunk_size: int = 300000):
        import time as _t

        if self._rng.random() < self.error_rate:
            if on_error:
                on_error(IOError("injected network error"))
            return _CancelFlag()

        def wrapped(s, d, t):
            if self._rng.random() < self.drop_rate:
                return                      # lost chunk -> future stall
            if self.delay_s:
                _t.sleep(self.delay_s)
            on_data(s, d, t)

        return self._inner.request(start, end, wrapped, on_error,
                                   on_complete, chunk_size)

    def cancel(self, handle):
        self._inner.cancel(handle)


def source_for(src: "str | bytes | ByteSource") -> ByteSource:
    """src string/bytes/ByteSource -> appropriate ByteSource."""
    if isinstance(src, ByteSource):
        return src
    if isinstance(src, (bytes, bytearray)):
        return MemorySource(bytes(src))
    if src.startswith("http://") or src.startswith("https://"):
        return HttpSource(src)
    return FileSource(src)
