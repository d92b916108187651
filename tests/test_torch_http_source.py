"""The port's ``HttpSource`` (``jsvx_torch.runtime.source``) against a
local HTTP server: each case of jsvx's ``tests/test_http_source.py``
(strategy probing, retry and resume, the sequential fallback, an abort
mid-request) on the port's copy."""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from jsvx_torch.runtime.source import HttpSource

PAYLOAD = bytes((i * 7 + (i >> 8)) & 0xFF for i in range(200_000))


def _parse_range(header, total):
    # "bytes=s-e" / "bytes=s-"
    spec = header.split("=", 1)[1]
    s, e = spec.split("-", 1)
    start = int(s)
    end = int(e) if e else total - 1
    return start, min(end, total - 1)


class _BaseHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):          # keep pytest output clean
        pass


def make_handler(mode, state):
    class Handler(_BaseHandler):
        def do_HEAD(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(PAYLOAD)))
            self.end_headers()

        def do_GET(self):
            state["requests"].append(self.headers.get("Range"))
            rng = self.headers.get("Range")
            if mode == "no-range" or rng is None:
                body = PAYLOAD
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            start, end = _parse_range(rng, len(PAYLOAD))
            if start >= len(PAYLOAD):
                self.send_response(416)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body = PAYLOAD[start:end + 1]
            if mode == "flaky" and len(state["requests"]) <= 2:
                # a 206 header and a truncated body, then the connection
                # is cut: a transient mid-body failure
                self.send_response(206)
                self.send_header("Content-Range",
                                 f"bytes {start}-{end}/{len(PAYLOAD)}")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body[:1000])
                self.wfile.flush()
                self.connection.close()
                return
            self.send_response(206)
            self.send_header("Content-Range",
                             f"bytes {start}-{end}/{len(PAYLOAD)}")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if mode == "slow":
                self.wfile.write(body[:1000])
                self.wfile.flush()
                # hold the connection open; an abort must not wait this out
                deadline = time.time() + 8.0
                while time.time() < deadline and not state.get("done"):
                    time.sleep(0.05)
                return
            self.wfile.write(body)

    return Handler


@pytest.fixture
def server_factory():
    servers = []

    def start(mode):
        state = {"requests": []}
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(mode, state))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}/stream.jsv", state

    yield start
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _collect(src, start, end, chunk=30_000, timeout=10.0):
    got = {}
    done = threading.Event()
    errs = []
    src.request(start, end,
                lambda s, d, t: got.setdefault(s, d),
                on_error=lambda e: (errs.append(e), done.set()),
                on_complete=done.set, chunk_size=chunk)
    assert done.wait(timeout), "request did not complete"
    assert not errs, errs
    buf = bytearray()
    pos = start
    for s in sorted(got):
        assert s == pos, f"gap at {pos} (chunk starts {s})"
        buf += got[s]
        pos += len(got[s])
    return bytes(buf)


def test_ranged_fetch(server_factory):
    url, state = server_factory("range")
    src = HttpSource(url, timeout=5.0)
    data = _collect(src, 5_000, 65_000)
    assert data == PAYLOAD[5_000:65_001]
    assert src.ranged is True
    assert src.total_length() == len(PAYLOAD)


def test_unranged_server_switches_to_whole_body(server_factory):
    """A server that ignores Range (200, whole body): ``ranged`` flips,
    the body is pumped to its end from the requested offset, the end of
    the stream is recorded, and no second request downloads it again."""
    url, state = server_factory("no-range")
    src = HttpSource(url, timeout=5.0)
    data = _collect(src, 100_000, 140_000)
    assert data == PAYLOAD[100_000:]       # tail delivered, not discarded
    assert src.ranged is False
    assert src._total == len(PAYLOAD)      # clean 200 EOF = end-of-stream
    assert len(state["requests"]) == 1     # one body, no re-download


def test_unranged_open_request_completes_without_retries(server_factory):
    """request(0, None) against a 200 server: a clean end of the body
    completes at once, with no retry loop."""
    url, state = server_factory("no-range")
    src = HttpSource(url, timeout=5.0, retries=3, backoff_s=0.2)
    t0 = time.time()
    data = _collect(src, 0, None)
    assert data == PAYLOAD
    assert len(state["requests"]) == 1
    assert time.time() - t0 < 3.0          # no backoff sleeps
    # no Range header was ever sent, so range support was never probed
    assert state["requests"] == [None]
    assert src.ranged is None


def test_retry_resumes_after_mid_body_failure(server_factory):
    url, state = server_factory("flaky")
    src = HttpSource(url, timeout=5.0, retries=4, backoff_s=0.01)
    data = _collect(src, 0, 99_999)
    assert data == PAYLOAD[:100_000]
    assert len(state["requests"]) >= 3      # 2 failures + resume(s)
    # resumed requests start where delivery stopped, not at 0
    later = [r for r in state["requests"][1:] if r]
    assert any(not r.startswith("bytes=0-") for r in later)


def test_sequential_chunk_fallback(server_factory):
    url, state = server_factory("range")
    src = HttpSource(url, timeout=5.0, sequential=True)
    assert src.streaming is False
    data = _collect(src, 0, 89_999, chunk=30_000)
    assert data == PAYLOAD[:90_000]
    # one Range request per chunk
    assert state["requests"] == [
        "bytes=0-29999", "bytes=30000-59999", "bytes=60000-89999"]


def test_cancel_aborts_mid_request(server_factory):
    url, state = server_factory("slow")
    src = HttpSource(url, timeout=20.0, retries=0)
    got = []
    handle = src.request(0, None, lambda s, d, t: got.append((s, len(d))),
                         chunk_size=500)
    deadline = time.time() + 5.0
    while not got and time.time() < deadline:
        time.sleep(0.01)
    assert got, "no data before cancel"
    t0 = time.time()
    src.cancel(handle)
    state["done"] = True
    assert time.time() - t0 < 2.0           # the abort does not wait out
    n = len(got)
    time.sleep(0.3)
    assert len(got) == n                    # nothing delivered after cancel
