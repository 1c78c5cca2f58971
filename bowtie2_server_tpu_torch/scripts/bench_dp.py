"""DP microbench of the port: banded-DP cells/s on one card and their share
of a measured int32 ALU ceiling. Port of the reference's scripts/bench_dp.py.

    python -m bowtie2_server_tpu_torch.scripts.bench_dp [--P 32768]
        [--L 100] [--K 32] [--local] [--device cuda]

The last line of standard output is one JSON object: the reference bench's
keys (`metric` = dp_banded_cells_per_s_per_chip, `value`, `unit`,
`roofline_frac`), the measured ceiling `ceiling_ops_per_s`, and `card`, the
`nvidia-smi --query-gpu=name,power.limit` line of the card it ran on.

Timing (`device_ms`): the kernel's own device time under torch.profiler,
median of REPS launches after a warm-up launch. CUDA events around a call
would also bracket the wrapper's host work before its launch. (The
reference bench chains its calls inside one jit to work around its TPU host
link; the card needs no such trick.)

Roofline model: `ops_per_cell` is the reference bench's count of the TPU
kernel's int32 operations per cell, whose E scan is a Kogge-Stone scan of
2*ceil(log2 K) operations. It is kept for `roofline_frac`, so the work
counted is the same whatever implements it. The CUDA kernels replace the
scan with a sequential chain; their own instructions per cell, read from
the SASS of the built library (`kernels.loop_mix`), are printed beside it
as `kernel_ops_per_cell`. A kernel that needs fewer instructions a cell
than the model counts operations reads `roofline_frac` above 1: the
register kernel's fused max-adds do. The ceiling is measured by the probe
(`ops/alu_probe.py`): [64, 32768] int32 through 3000 dependent steps of 4
operations.

With --device cpu the script runs the plain torch versions (for the tests);
its numbers are then CPU numbers and its roofline share is not meaningful.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import kernels
from ..ops.alu_probe import OPS_PER_STEP, alu_chain
from ..ops.sw import SwConfig
from ..ops.sw_banded import (REGISTER_BAND_MAX, banded_dp, wide_cells,
                             wide_loop)

REPS = 10
# the register banded kernel's profiler name (not its general kernel, which
# banded_dp launches after it and which returns at once on these scores)
BANDED_SYMBOL = "::banded_kernel<"


def ops_per_cell(K: int, local: bool) -> float:
    """The reference bench's operations per DP cell (scripts/bench_dp.py
    `ops_per_cell`)."""
    return 14 + 2 * int(np.ceil(np.log2(K))) + (1 if local else 0)


def card_line(device) -> str:
    """`name, power.limit` of the card as nvidia-smi gives it; "cpu" for a
    CPU run."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def time_ms(fn, device, reps: int = REPS) -> float:
    """Median ms of fn() over `reps` back-to-back runs after one warm-up
    run: CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize(device)
    return statistics.median(a.elapsed_time(b) for a, b in zip(ev, ev[1:]))


def device_ms(fn, device, symbol: str, reps: int = REPS,
              sessions: int = 8) -> float:
    """Median device time (ms) of the one kernel whose profiler name
    contains `symbol` that each fn() launches, over the first `reps`
    launches that torch.profiler saw, after a warm-up call. Its tracer has
    missed launches of short kernels (0.01 ms) in short sessions, so each
    session starts with a 1 ms sleep kernel on the card, and it profiles
    up to `sessions` rounds of `reps` calls until it has seen `reps`. CUDA
    events around one call would also bracket the wrapper's host work
    before its launch, which is not small beside a kernel of 0.05 ms. On
    the CPU: time_ms."""
    if device.type != "cuda":
        return time_ms(fn, device, reps)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1 << 21)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        times += [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA and symbol in e.name]
        if len(times) >= reps:
            break
    if not times:
        raise RuntimeError(f"the profiler saw no launch of {symbol} in "
                           f"{sessions * reps} calls")
    return statistics.median(times[:reps]) / 1e3


# the probe's profiler time is trusted while it lies within this share of
# its CUDA-event time
PROBE_CLOCK_TOL = 0.10


def probe_ms(dev_ms: float, event_ms: float) -> tuple[float, str]:
    """(ms, which clock) of the ALU probe's launch, the time every bound's
    int32 ceiling divides by: its profiler time (`device_ms`, "device")
    unless that differs from the CUDA-event time of a call (`time_ms`) by
    more than PROBE_CLOCK_TOL of the latter, and then the event time
    ("events"). The profiler has misread the probe by a third; the probe
    is one long kernel, so the wrapper's host work inside its event time
    is small."""
    if abs(dev_ms - event_ms) > PROBE_CLOCK_TOL * event_ms:
        return event_ms, "events"
    return dev_ms, "device"


def measure_alu_ceiling(device, P: int = 32768, rows: int = 64,
                        nsteps: int = 3000, reps: int = 5):
    """(int32 ops/s, ms a launch) of the probe over a [rows, P] tile,
    counting OPS_PER_STEP operations a step and element; the launch's ms
    as `probe_ms` picks it."""
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 100, (rows, P)).astype(np.int32)).to(device)
    run = lambda: alu_chain(x, nsteps)
    ms, _ = probe_ms(device_ms(run, device, "alu_kernel", reps),
                     time_ms(run, device, reps))
    return OPS_PER_STEP * nsteps * rows * P / (ms / 1e3), ms


def banded_inputs(P: int, L: int, K: int, device):
    """The reference bench's inputs: random read and band codes, penalty 6,
    every read L long."""
    rng = np.random.default_rng(3)
    rd = rng.integers(0, 4, (L, P)).astype(np.int32)
    mm = np.full((L, P), 6, np.int32)
    band = rng.integers(0, 4, (L + K, P)).astype(np.int32)
    lens = np.full(P, L, np.int32)
    return [torch.from_numpy(a).to(device) for a in (rd, mm, lens, band)]


def kernel_ops_per_cell(K: int, local: bool) -> float:
    """SASS instructions a thread issues per DP cell in the largest loop of
    the CUDA kernel that serves band K: for the register kernel the loop
    over the gap rows, where nearly all cells are (rows with gaps barred
    issue fewer; the end-to-end arg-max of the one scored row runs after
    the loops), for the wide-band kernel its loop over the gap rows
    (sw_banded.wide_loop), over the cells a lane owns."""
    if K <= REGISTER_BAND_MAX:
        n, _ = kernels.loop_mix(f"banded_kernelILi{K}ELb{int(local)}E")
        return n / K
    n, _ = kernels.loop_mix(*wide_loop(K, local))
    return n / wide_cells(local)


def run(device="cuda", P: int = 32768, L: int = 100, K: int = 32,
        local: bool = False, ceiling=None) -> dict:
    """Time the banded DP at [L, P] with band K; `ceiling` (ops/s) is
    measured with the probe when not given. Returns the result dict."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu for the "
                           "plain versions")
    cfg = SwConfig(ma=2, local=True) if local else SwConfig()
    args = banded_inputs(P, L, K, device)
    ms = device_ms(lambda: banded_dp(cfg, K, *args), device,
                   BANDED_SYMBOL if K <= REGISTER_BAND_MAX
                   else "banded_wide_kernel")
    if ceiling is None:
        ceiling, _ = (measure_alu_ceiling(device) if device.type == "cuda"
                      else measure_alu_ceiling(device, P=256, rows=8,
                                               nsteps=50, reps=3))
    cps = P * L * K / (ms / 1e3)
    opc = ops_per_cell(K, local)
    out = {"metric": "dp_banded_cells_per_s_per_chip", "value": cps,
           "unit": "cells/s", "roofline_frac": cps * opc / ceiling,
           "ceiling_ops_per_s": ceiling, "card": card_line(device),
           "P": P, "L": L, "K": K, "local": local, "kernel_ms": ms,
           "ops_per_cell": opc}
    if device.type == "cuda":
        out["kernel_ops_per_cell"] = kernel_ops_per_cell(K, local)
    else:
        out["note"] = ("plain torch versions on the CPU: roofline_frac "
                       "not meaningful")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_dp", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--P", type=int, default=32768)
    ap.add_argument("--L", type=int, default=100)
    ap.add_argument("--K", type=int, default=32)
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    r = run(a.device, a.P, a.L, a.K, a.local)
    print(f"# {r['card']}: {r['value'] / 1e9:.3f} Gcells/s "
          f"({r['kernel_ms']:.4f} ms / {a.P * a.L * a.K / 1e6:.1f} Mcells), "
          f"{r['roofline_frac']:.4f} of the measured ALU ceiling "
          f"({r['ceiling_ops_per_s'] / 1e12:.3f} Tops/s; "
          f"{r['ops_per_cell']} ops/cell)", file=sys.stderr)
    print(json.dumps(r))


if __name__ == "__main__":
    main()
