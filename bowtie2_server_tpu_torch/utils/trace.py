"""Spans of the port's own layers, kept in memory (ref: the reference's
timer.h Timer blocks behind -t, grown into one recorder).

    from bowtie2_server_tpu_torch.utils import trace
    trace.enable()
    with trace.span("cg.fetch", launched=n) as sp:
        ...
        sp.set(valid=v)
    trace.spans(t0, t1)   # the finished spans inside [t0, t1], epoch s

A span records its name, start and end, the CPU time of its thread inside
it (`time.thread_time_ns`), its thread, the pack it belongs to (the
dispatcher's `set_pack`; None outside a pack) and its attributes, which
carry its counts. Finished spans go into one bounded ring
(`collections.deque(maxlen=capacity)`): an append is atomic under the GIL,
so the event loop and the workers take no lock. Spans sit at pack, batch
and stage level only, never per read.

Off is the default: `span()` then returns one shared no-op object (one
flag read, no clock read, nothing kept).

The clock is the profiler's: `enable()` takes one anchor pair
(`perf_counter_ns`, `time_ns`); spans are timed on the monotonic
`perf_counter_ns` and reported on the epoch through the anchor, the clock
on which a torch.profiler trace places its device events
(`kineto_results.trace_start_ns()`), so spans and kernels can be set side
by side.

Standard library only: no torch.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import NamedTuple

_perf = time.perf_counter_ns
_cpu = time.thread_time_ns
_tid = threading.get_ident
_local = threading.local()

_on = False
_ring: deque = deque(maxlen=1)
_anchor = (0, 0)    # (perf_counter_ns, time_ns) taken together at enable()


class Span(NamedTuple):
    name: str
    t0: float            # epoch seconds
    t1: float
    cpu_s: float | None  # the thread's CPU seconds inside; None if unknown
    thread: int
    pack: int | None
    attrs: dict

    @property
    def s(self) -> float:
        return self.t1 - self.t0


def enable(capacity: int = 1 << 16) -> None:
    """Start recording into a ring of `capacity` spans. Enabling an
    enabled recorder keeps its ring and anchor."""
    global _on, _ring, _anchor
    if _on:
        return
    _ring = deque(maxlen=capacity)
    _anchor = (_perf(), time.time_ns())
    _on = True


def disable() -> None:
    """Stop recording; the ring keeps what it holds."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def _epoch(ns: int) -> float:
    return (_anchor[1] + ns - _anchor[0]) / 1e9


class _Off:
    """The span of a recorder that is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Open:
    __slots__ = ("name", "attrs", "t0", "c0")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.c0 = _cpu()
        self.t0 = _perf()
        return self

    def __exit__(self, *exc):
        t1 = _perf()
        c1 = _cpu()
        _ring.append(Span(self.name, _epoch(self.t0), _epoch(t1),
                          (c1 - self.c0) / 1e9, _tid(),
                          getattr(_local, "pack", None), self.attrs))
        return False

    def set(self, **attrs):
        """Attributes known only at the span's end (its counts)."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager that records one span when it exits (while the
    recorder is on)."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


def now() -> int:
    """The recorder's clock (perf_counter_ns) while it is on, else 0: the
    start of a span that another thread closes (`record`)."""
    return _perf() if _on else 0


def record(name: str, start: int) -> None:
    """Record a span from `start` (a `now()` reading, maybe on another
    thread) to now, on this thread; its CPU time is unknown."""
    if _on and start:
        _ring.append(Span(name, _epoch(start), _epoch(_perf()), None,
                          _tid(), getattr(_local, "pack", None), {}))


def set_pack(pack: int | None) -> None:
    """The pack this thread works on from now (None: none); spans this
    thread records carry it."""
    _local.pack = pack


def spans(t0: float = float("-inf"), t1: float = float("inf")) -> list:
    """The finished spans that started at or after t0 and ended at or
    before t1 (epoch seconds), in the order they ended."""
    return [s for s in list(_ring) if s.t0 >= t0 and s.t1 <= t1]
