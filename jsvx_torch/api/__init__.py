"""The port's streaming API: :class:`Decoder` and :class:`Player` on a
torch device, with their configuration, errors, states and audio clock
(the port of ``jsvx/api``)."""

from .config import PlayerConfig
from .decoder import DecodedFrame, Decoder
from .errors import MediaError
from .events import EventDispatcher
from .player import NetworkState, Player, ReadyState, WallClockAudio

__all__ = [
    "Decoder",
    "DecodedFrame",
    "EventDispatcher",
    "MediaError",
    "NetworkState",
    "Player",
    "PlayerConfig",
    "ReadyState",
    "WallClockAudio",
]
