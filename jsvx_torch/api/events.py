"""Event dispatching (re-export; implementation in jsvx_torch.utils.events)."""

from ..utils.events import EventDispatcher

__all__ = ["EventDispatcher"]
