"""Wrappers the traced run puts around calls of one server instance, and
the per-layer metric readers that reduce what they record.

A reader is `portbench/metrics/<metric name>.py`. It declares:

  PROBES   {probe name: target}. A target is an attribute path from the
           served Bt2Server (`server._align_pack`, `server._dispatch.submit`),
           from each of its workers' aligners (`worker.up.align_batch`,
           `worker.pal._decide`, `worker.up.candgen.dispatch`: the
           dispatcher's `(up, pal)` contexts), or a module attribute
           (`module:bowtie2_server_tpu_torch.align.candgen:banded_dp`).
  CAPTURE  optional {probe name: fn(args, kwargs, result)}: what to keep of
           each call besides its times.
  read(calls, ctx) -> number or None. calls: {probe name: [Call]}, the calls
           that started while recording was on; ctx: the Trace of the slice
           (`ctx.trace`, None without one), the configuration, the number of
           cards. None means the reader found nothing to read, and the run
           leaves the metric out.

The run installs only the wrappers its cell's metrics name, once a target,
and records only while `Recorder.on` is set: during the traced slice.
"""
from __future__ import annotations

import importlib
import importlib.util
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

METRICS = Path(__file__).resolve().parent / "metrics"


@dataclass
class Call:
    t0: float            # time.time() at entry
    t1: float            # time.time() at return
    thread: int
    info: dict = field(default_factory=dict)   # probe name -> capture

    @property
    def s(self) -> float:
        return self.t1 - self.t0


def load_reader(name: str):
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Recorder:
    def __init__(self):
        self.on = False
        self.calls: dict[str, list[Call]] = {}   # target -> calls

    def wrap(self, fn, target: str, captures: dict):
        """fn wrapped: while `on`, each call is recorded under `target`,
        with each capture's result under its probe key."""
        rec = self.calls.setdefault(target, [])
        clock = time.time

        def wrapped(*a, **k):
            if not self.on:
                return fn(*a, **k)
            t0 = clock()
            out = fn(*a, **k)
            c = Call(t0, clock(), threading.get_ident())
            for key, cap in captures.items():
                c.info[key] = cap(a, k, out) if cap else None
            rec.append(c)
            return out
        return wrapped


def _owners(srv, path: str):
    """[(object, attribute)] that `path` names."""
    if path.startswith("module:"):
        _, mod, attr = path.split(":")
        return [(importlib.import_module(mod), attr)]
    head, *rest = path.split(".")
    if head == "server":
        roots = [srv]
    elif head == "worker":
        roots = [dict(up=w[0], pal=w[1]) for w in srv._dispatch._workers
                 if not (isinstance(w, tuple) and w and w[0] == "remote")]
    else:
        raise ValueError(f"probe target {path!r}: no root {head!r}")
    out = []
    for obj in roots:
        for part in rest[:-1]:
            obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
        out.append((obj, rest[-1]))
    return out


def install(srv, readers: dict) -> Recorder:
    """Wrap every target that `readers` ({metric name: module}) name."""
    rec = Recorder()
    by_target: dict[str, dict] = {}
    for name, mod in readers.items():
        caps = getattr(mod, "CAPTURE", {})
        for probe, target in mod.PROBES.items():
            by_target.setdefault(target, {})[f"{name}:{probe}"] = \
                caps.get(probe)
    for target, caps in by_target.items():
        for obj, attr in _owners(srv, target):
            setattr(obj, attr, rec.wrap(getattr(obj, attr), target, caps))
    return rec


def calls_for(rec: Recorder, name: str, mod) -> dict:
    """{probe: [Call]} of one reader, each call's info narrowed to its own
    capture (`call.info` becomes that value)."""
    out = {}
    for probe, target in mod.PROBES.items():
        key = f"{name}:{probe}"
        out[probe] = [Call(c.t0, c.t1, c.thread, c.info.get(key))
                      for c in rec.calls.get(target, [])]
    return out


def outermost(calls: list[Call], within: list[Call] | None = None):
    """The calls not nested inside another of `calls` (or of `within`) on
    the same thread."""
    pool = sorted(calls + (within or []), key=lambda c: (c.t0, -c.t1))
    own = {id(c) for c in calls}
    out, open_until = [], {}
    for c in pool:
        if open_until.get(c.thread, -1.0) >= c.t1:
            continue
        open_until[c.thread] = c.t1
        if id(c) in own:
            out.append(c)
    return out


# ---- helpers the readers share ----

def pack_reads(a, k, out) -> int:
    """CAPTURE of `server._align_pack(worker, rows, ref_names)`: the pack's
    reads, a mate counting as one."""
    return sum(1 if r[3] is None else 2 for r in a[1])


def batch_reads(a, k, out) -> int:
    """CAPTURE of `align_batch(b)` or `align_batch(b1, b2)`: its reads."""
    return sum(len(b.lens) for b in a)


def ended(calls: list[Call], ctx) -> list[Call]:
    """The calls that also returned before recording stopped, so that every
    call nested in them was recorded."""
    return [c for c in calls if c.t1 <= ctx.t_stop]


def inside(inner: list[Call], outer: list[Call]) -> list[Call]:
    """The calls of `inner` that lie inside one of `outer` on its thread."""
    spans = {}
    for c in outer:
        spans.setdefault(c.thread, []).append((c.t0, c.t1))
    return [c for c in inner
            if any(a <= c.t0 and c.t1 <= b for a, b in spans.get(c.thread, ()))]


def median(xs):
    xs = sorted(xs)
    if not xs:
        return None
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else (xs[m - 1] + xs[m]) / 2
