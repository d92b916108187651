"""Media error codes (HTML5 MediaError surface; player/parts/end.js:20-26)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MediaError(Exception):
    MEDIA_ERR_ABORTED = 1
    MEDIA_ERR_NETWORK = 2
    MEDIA_ERR_DECODE = 3
    MEDIA_ERR_SRC_NOT_SUPPORTED = 4

    code: int = 0
    message: str = ""

    def __str__(self):
        return f"MediaError({self.code}): {self.message}"
