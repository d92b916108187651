"""The kernel wrappers' counters, in one registry.

Each wrapper module counts in its own module attributes
(``fused.launches``, ``mc.launches``, ``recon.launches``,
``recon.expansions``, ``expand.launches``, ``expand.plain_calls``): one
per launch of its kernel, or per call of a plain version a card's decode
path must not make.  It registers each of them here, under a short name,
where it defines it.  Whoever needs every count goes through this module
and names no wrapper: a GOP program, whose replays move no Python counter,
adds what its capture counted (:func:`snapshot`, :func:`add`), and a
script that counts a run resets and reads them (:func:`reset`,
:func:`snapshot`).
"""

from __future__ import annotations

import sys

#: short name -> (module, attribute)
_REGISTRY: dict = {}


def register(name: str, module_name: str, attribute: str) -> None:
    """Count ``module_name``'s ``attribute`` as ``name`` (a wrapper module
    calls this with ``__name__`` where it defines the attribute)."""
    _REGISTRY[name] = (sys.modules[module_name], attribute)


def snapshot() -> dict:
    """Every registered count, by name."""
    return {n: getattr(m, a) for n, (m, a) in _REGISTRY.items()}


def add(moves: dict) -> None:
    """Add ``moves`` (name -> count) to the counts."""
    for n, k in moves.items():
        m, a = _REGISTRY[n]
        setattr(m, a, getattr(m, a) + k)


def reset() -> None:
    """Set every count to 0."""
    for m, a in _REGISTRY.values():
        setattr(m, a, 0)
