"""Event dispatching (the ``ez_dis`` on/off/go mixin of the reference,
``features/eventdispatcher.js:21-59``, as a base class)."""

from __future__ import annotations

from collections import defaultdict


class EventDispatcher:
    def __init__(self):
        self._listeners: dict[str, list] = defaultdict(list)

    def on(self, event: str, fn) -> None:
        self._listeners[event].append(fn)

    def off(self, event: str, fn=None) -> None:
        if fn is None:
            self._listeners.pop(event, None)
        else:
            try:
                self._listeners[event].remove(fn)
            except ValueError:
                pass

    def once(self, event: str, fn) -> None:
        def wrapper(*args):
            self.off(event, wrapper)
            fn(*args)

        self.on(event, wrapper)

    def emit(self, event: str, *args) -> None:
        for fn in list(self._listeners.get(event, ())):
            fn(*args)

    # reference-flavored aliases ("go" dispatches)
    go = emit
