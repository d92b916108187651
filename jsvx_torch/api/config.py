"""Player/decoder configuration.

The dataclass mirror of the reference's ``window['jsv_config']`` global
(``player/easybits.player.js:335-431``) plus TPU-framework options.
Validation matches the reference (buffer_min_sec must be < buffer_sec ->
MediaError)."""

from __future__ import annotations

from dataclasses import dataclass, field

from .errors import MediaError


@dataclass
class PlayerConfig:
    # reference options (easybits.player.js:349-377 defaults)
    buffer_sec: float = 30.0           # forward buffer window
    buffer_min_sec: float = 1.0        # minimum before resuming playback
    chunk_size: int = 300000           # bytes per ranged request
    sync_interval_ms: int = 1000       # A/V sync check period
    av_sync_limit_ms: int = 300        # max tolerated A/V drift
    audio_shift_sec: float = 0.0
    # regex -> replacement mapping from a video src to its companion
    # audio src (the reference's audioMap, easybits.player.js:1205)
    audio_map: list = field(default_factory=list)
    # gate audio behind an explicit unlock (the reference's unlockAudio
    # ceremony for mobile browsers, features/unlockaudio.js): audio will
    # not start until Player.unlock_audio() is called
    unlock_audio: bool = False
    skip_hard: bool = False            # drop late frames aggressively
    seconds_played_limit: float = 30.0  # backward-buffer seconds kept
    max_decoded_frames: int = 10       # decode-ahead queue cap
    max_waitings: int = 5              # underruns before ABR downswitch
    seek_precision_ms: float = 150.0
    loop: bool = False
    autoplay: bool = False
    muted: bool = False
    preload: str = "auto"

    # TPU framework options
    quirk_oddify_zeros: bool = False   # reproduce reference dequant quirk
    use_native_parser: bool | None = None
    use_gop_scan: bool = True
    emit_rgb: bool = False             # sink gets (H,W,3|4) uint8 RGB(A)
                                       # converted on device, not planes

    def validate(self) -> None:
        if self.buffer_min_sec >= self.buffer_sec:
            raise MediaError(MediaError.MEDIA_ERR_SRC_NOT_SUPPORTED,
                             "buffer_min_sec must be < buffer_sec")
        if self.chunk_size <= 0:
            raise MediaError(MediaError.MEDIA_ERR_SRC_NOT_SUPPORTED,
                             "chunk_size must be positive")
