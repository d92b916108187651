from .events import EventDispatcher

__all__ = ["EventDispatcher"]
