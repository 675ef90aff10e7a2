"""Process-local spans (the ``span()`` part of ``repro.obs.telemetry``).

Off by default: a disabled ``span`` costs one attribute load and a
branch. When enabled, each finished span appends
``(name, start_ns, duration_ns, attrs)`` to the ``Telemetry`` it was
opened on; ``snapshot(reset=True)`` drains them. The spans observe the
monotonic wall clock only, never numerics. The cross-process merge
machinery of the reference is not ported.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Tuple

RING_CAP = 65536          # spans buffered between drains (oldest drop)

Span = Tuple[str, int, int, Dict[str, Any]]


class Telemetry:
    def __init__(self):
        self.enabled = False
        self.events: deque = deque(maxlen=RING_CAP)

    def span(self, name: str, **attrs):
        return _Span(self, name, attrs) if self.enabled else _NULL

    def snapshot(self, reset: bool = True) -> List[Span]:
        out = list(self.events)
        if reset:
            self.events.clear()
        return out


class _Span:
    __slots__ = ("tel", "name", "attrs", "t0")

    def __init__(self, tel: Telemetry, name: str, attrs: Dict[str, Any]):
        self.tel, self.name, self.attrs = tel, name, attrs

    def __enter__(self):
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        self.tel.events.append((self.name, self.t0, t1 - self.t0,
                                self.attrs))
        return False


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()

# the process's default recorder, used by the migration and
# serialization spans (``mig.*``)
DEFAULT = Telemetry()


def enable() -> None:
    DEFAULT.enabled = True


def disable() -> None:
    DEFAULT.enabled = False


def span(name: str, **attrs):
    return DEFAULT.span(name, **attrs)


def snapshot(reset: bool = True) -> List[Span]:
    return DEFAULT.snapshot(reset)
