"""The frozen yardstick: peaks, the banded kernel's operation count, and
the reduction of a torch.profiler trace to device time.

Peaks of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit; a card
set below its limit reads low against them, so every run prints the card's
limit beside its numbers.

INT32_PEAK_OPS: int32 operations a second, counting a fused max-add (DPX)
as two, as the banded recurrence's count below does. Frozen from the ALU
probe of the port (`ops/csrc/alu_probe.cu`: a dependent chain of int32
adds and maxes over a [64, 32768] tile, 3000 steps), which read
3.18e13-3.21e13 ops/s on an NVIDIA H100 80GB HBM3 at 700 W over the runs
of four changes (PERF.md, the kernel table). The highest reading is taken,
so that no share reads high for a card's good day: 132 SMs x 64 int32
lanes x 1.98 GHz is 1.67e13 instructions a second, and the probe's 3.21e13
is that rate with a DPX max-add counted as two operations. It is never
measured again in a run.

HBM_BYTES_PER_S: NVIDIA's data sheet for the H100 SXM, 3.35 TB/s.
"""
from __future__ import annotations

import numpy as np

INT32_PEAK_OPS = 3.21e13
HBM_BYTES_PER_S = 3.35e12

def banded_ops_per_cell(local: bool) -> int:
    """int32 operations a cell of the banded recurrence, each add and each
    max one: F = max(H_up - rfg_open, F_up - rfg_ext), 3; max(H_diag + s,
    F), 2; E = max(E_left - rdg_ext, base_left - rdg_open), 3; H = max(base,
    E), 1; the score, one select from the row's table, 1. --local adds the
    clamp at 0 and the row's running max, 2. (The count of the port's
    scripts/bench_banded.py, frozen here.)"""
    return 10 + 2 * int(local)


def banded_least_s(lens: np.ndarray, lq: int, K: int, local: bool) -> float:
    """The least seconds the card could take for one banded DP call on
    these inputs: the larger of its operations over INT32_PEAK_OPS (each
    problem's rows below its read length, times the band K, times the
    count a cell) and its bytes over HBM_BYTES_PER_S (each input read once:
    read codes, penalties and the band of reference codes as int32, the
    lengths; each output written once: three int32 a problem)."""
    P = len(lens)
    cells = float(np.clip(lens, 0, lq).astype(np.int64).sum()) * K
    ops = cells * banded_ops_per_cell(local)
    nbytes = 4 * (2 * lq * P + (lq + K) * P + P + 3 * P)
    return max(ops / INT32_PEAK_OPS, nbytes / HBM_BYTES_PER_S)


class Trace:
    """A profiler trace over a slice of the window, reduced: each card's
    merged busy intervals (kernels, copies and fills), device seconds by
    operation name, and the slice's host wall-clock bounds."""

    def __init__(self, prof, t_start: float, t_stop: float):
        """prof: a finished torch.profiler.profile; t_start and t_stop:
        time.time() when the slice began and ended."""
        from torch.autograd import DeviceType
        kr = prof.profiler.kineto_results
        self.origin = kr.trace_start_ns() / 1e9     # wall clock of t = 0
        self.t_start, self.t_stop = t_start, t_stop
        per_dev: dict[int, list] = {}
        self.by_name: dict[str, list] = {}
        self.events = []        # (name, card, start us, end us)
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            a, b = e.time_range.start, e.time_range.end
            dev = int(e.device_index)
            self.events.append((e.name, dev, a, b))
            per_dev.setdefault(dev, []).append((a, b))
            c = self.by_name.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += (b - a) / 1e6
        lo = (t_start - self.origin) * 1e6
        hi = (t_stop - self.origin) * 1e6
        self.busy = {d: _merge(iv, lo, hi) for d, iv in per_dev.items()}

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def busy_s(self, n_devices: int) -> float:
        """Seconds some operation ran, averaged over the n cards used."""
        tot = sum(sum(b - a for a, b in iv) for iv in self.busy.values())
        return tot / 1e6 / max(n_devices, 1)

    def top_ops(self, k: int = 10):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name[:120], s] for name, (_, s) in top]

    def gaps(self, device: int):
        """(wall-clock start, seconds) of each idle gap on `device` inside
        the slice, the gap before its first operation and after its last
        included."""
        iv = self.busy.get(device, [])
        lo = (self.t_start - self.origin) * 1e6
        hi = (self.t_stop - self.origin) * 1e6
        edges = [lo] + [x for ab in iv for x in ab] + [hi]
        out = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                out.append((self.origin + a / 1e6, (b - a) / 1e6))
        return out


def _merge(iv, lo, hi):
    """The union of intervals (us), clipped to [lo, hi], sorted."""
    out = []
    for a, b in sorted(iv):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
