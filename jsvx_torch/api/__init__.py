"""Decoder and Player of the port: jsvx's streaming API on a torch device.

:class:`Decoder` and :class:`Player` subclass jsvx's and replace only
their device methods; the configuration, errors, states and audio clock
are jsvx's own classes, re-exported.
"""

from jsvx.api.config import PlayerConfig
from jsvx.api.decoder import DecodedFrame
from jsvx.api.errors import MediaError
from jsvx.api.player import NetworkState, ReadyState, WallClockAudio

from .decoder import Decoder
from .player import Player

__all__ = [
    "Decoder",
    "DecodedFrame",
    "MediaError",
    "NetworkState",
    "Player",
    "PlayerConfig",
    "ReadyState",
    "WallClockAudio",
]
