"""Player on a torch device.

The port of ``jsvx/api/player.py``.  It subclasses jsvx's
:class:`jsvx.api.player.Player`: the HTML5 ``<video>`` surface, the range
loader, the decode-ahead queue, the render clock, A/V sync, ABR, seeking
and the background decode thread are jsvx's own code.  Replaced:

* ``_reset_for_source`` builds the port's :class:`Decoder` on ``device``;
* ``_to_rgb`` converts with :func:`jsvx_torch.kernels.color.ycbcr_to_rgb`
  on the planes' device (the sink then receives a uint8 tensor);
* ``_request_range`` binds each request's completion to its own
  ``_PendingRequest``, and ``_on_request_complete`` ignores a completion
  that is not the pending request's.  In jsvx an asynchronous source's
  late completion of a cancelled request clears the newer request's slot
  and starts a duplicate range request (``jsvx/api/player.py:514-516``).

Decoding and display may run on two threads (``start_background_decode``
with ``run_realtime``).  The Decoder returns planes once they are
complete, so the render thread reads finished tensors.
"""

from __future__ import annotations

import torch

from jsvx.api.player import NetworkState, ReadyState, _PendingRequest
from jsvx.api.player import Player as _JsvxPlayer

from ..kernels.color import ycbcr_to_rgb
from .decoder import BACKENDS, Decoder


class Player(_JsvxPlayer):
    """jsvx's Player, decoding and converting colour on ``device``;
    ``backend`` is ``"torch"`` or jsvx's ``"oracle"``."""

    def __init__(self, config=None, backend: str = "torch",
                 audio_clock=None, *, device):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        self.device = torch.device(device)
        super().__init__(config, backend=backend, audio_clock=audio_clock)

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
        self._preload_released = False     # the preload hint is per load
        self.ready_state = ReadyState.HAVE_NOTHING

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
            # per-chunk transports: tile requests on chunk boundaries
            cs = self.config.chunk_size
            s -= s % cs
            if e is not None:
                e = ((e + 1 + cs - 1) // cs) * cs - 1
                total = self.decoder.buffer.total_length
                if total:
                    e = min(e, total - 1)
        self.network_state = NetworkState.NETWORK_LOADING
        self._abort_delivery = False
        # filled before dispatch: a synchronous source completes inside
        # request()
        req = _PendingRequest()
        self._pending_request = req
        req.handle = self._source.request(
            s, e, self._on_chunk, on_error=self._on_net_error,
            on_complete=lambda: self._on_request_complete(req),
            chunk_size=self.config.chunk_size)
        if req.cancelled and req.handle is not None:
            self._source.cancel(req.handle)
            req.handle = None

    def _on_request_complete(self, req: _PendingRequest) -> None:
        with self._lock:
            if self._pending_request is not req:
                return                     # a cancelled request's late end
            super()._on_request_complete()

    def _to_rgb(self, frame) -> torch.Tensor:
        """Colour convert on the device + crop to the container size
        (planes are coded-size, multiples of 16)."""
        p = [torch.as_tensor(x, device=self.device) for x in frame.planes]
        rgb = ycbcr_to_rgb(p[0], p[1], p[2], p[3] if len(p) >= 4 else False)
        h, w = self.video_height, self.video_width
        if h and w and tuple(rgb.shape[:2]) != (h, w):
            rgb = rgb[:h, :w]
        return rgb
