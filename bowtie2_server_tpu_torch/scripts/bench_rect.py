"""Rectangle-DP kernel bench: the time of `sw_tile` (ops/sw.py, the CUDA
kernel ops/csrc/sw.cu on the card) at the shapes the port's paths give it,
beside the least time the card could take for the same work.

    python -m bowtie2_server_tpu_torch.scripts.bench_rect [--device cuda]
        [--reps 5]

The script imports the package by its absolute name, so it can also be run
as a file against another checkout of the package (for a comparison of two
commits in one run on one card):

    PYTHONPATH=<other checkout> python <this checkout>/bowtie2_server_tpu_torch/scripts/bench_rect.py

Shapes (`SHAPES`), each end-to-end and --local:
  - tile4096: P = 4096, Lq_pad = 128, Lc = 256, reads of 90-128 bases,
    windows of 128-256: the shape of the earlier kernel measurements;
  - unpaired: P = 210, Lq_pad = 128, Lc = 256, reads of 100 bases, windows
    of 100-256: one batch's run-boundary candidates on the unpaired path
    (32768 reads of 100 bp on a draft-assembly genome; rows padded to 64,
    windows to 128 by `UnpairedAligner._rect_dp`);
  - rescue: P = 330, Lq_pad = 192, Lc = 640, mates of 150 bases, windows of
    500-640: one 16384-pair batch's mate-rescue windows on the paired path
    (-X 500; `PairedAligner._run_rescue`).
Reads are cut from their windows with 0-3 substitutions; a third carry a
substitution every 16 bases (the seedless mates that rescue finds), and
every seventh is unrelated to its window.

The bound (`bound_ms`) is the larger of two times: the operations the
function needs over the card's int32 ceiling, and its bytes over the card's
memory rate. Operations: `dp_ops_per_cell` int32 operations a cell, times
the cells these inputs need: sum over problems of min(len, Lq_pad) x
min(reflens, Lc), since rows at or past len and columns at or past reflens
reach no scored cell. The ceiling is the one the ALU probe measures
(bench_dp.measure_alu_ceiling). Bytes: each input read once and each output
written once, over HBM3's 3.35 TB/s (H100 SXM data sheet).

The last line of standard output is one JSON object: the card line of
`nvidia-smi`, the ceiling, and per shape and mode the kernel's median ms,
its bound, the share of the bound, and max_abs_err against `sw_tile_torch`.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from bowtie2_server_tpu_torch.ops import sw as sw_mod
from bowtie2_server_tpu_torch.ops.sw import SwConfig, sw_tile, sw_tile_torch
from bowtie2_server_tpu_torch.scripts.bench_dp import (
    card_line, device_ms, measure_alu_ceiling, time_ms)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3 (NVIDIA data sheet)
# name -> (P, Lq_pad, Lc, read lengths (lo, hi), window lengths (lo, hi))
SHAPES = {
    "tile4096": (4096, 128, 256, (90, 128), (128, 256)),
    "unpaired": (210, 128, 256, (100, 100), (100, 256)),
    "rescue": (330, 192, 640, (150, 150), (500, 640)),
}
MODES = {"e2e": SwConfig(), "local": SwConfig(ma=2, local=True)}


def rect_inputs(P: int, lq_pad: int, lc: int, read_lens, win_lens,
                seed: int):
    """[rd, mm, lens, ref, reflens] int32 numpy arrays in the layout of
    `sw_tile` (rows x problems), padded as `sw_align_batch` pads them: read
    code 5 and penalty 0 past len, reference code 4 past reflens."""
    rng = np.random.default_rng(seed)
    cols = np.arange(P)
    lens = rng.integers(read_lens[0], read_lens[1] + 1, P)
    reflens = rng.integers(win_lens[0], win_lens[1] + 1, P)
    win = rng.integers(0, 4, (lc, P))
    ref = np.where(np.arange(lc)[:, None] < reflens[None, :], win, 4)
    rows = np.arange(lq_pad)[:, None]
    start = rng.integers(0, np.maximum(reflens - lens, 0) + 1)
    rd = win[np.minimum(start[None, :] + rows, lc - 1), cols]
    for _ in range(3):                       # 0-3 substitutions
        sel = rng.random(P) < 0.5
        at = rng.integers(0, lens)
        rd[at[sel], cols[sel]] = rng.integers(0, 4, P)[sel]
    seedless = cols % 3 == 1                 # a substitution every 16 bases
    every16 = (rows % 16 == cols % 16) & seedless[None, :]
    rd = np.where(every16, (rd + 1) % 4, rd)
    unrelated = cols % 7 == 3
    rd[:, unrelated] = rng.integers(0, 4, (lq_pad, int(unrelated.sum())))
    live = rows < lens[None, :]
    rd = np.where(live, rd, 5)
    mm = np.where(live, rng.integers(2, 7, (lq_pad, P)), 0)
    return [np.ascontiguousarray(a, np.int32)
            for a in (rd, mm, lens, ref, reflens)]


def dp_ops_per_cell(local: bool) -> int:
    """int32 operations an affine-gap DP cell is charged in the rect
    kernel's bound (the banded bound counts the recurrence's own,
    bench_banded.banded_ops_per_cell): the reference bench's op model
    (bench_dp.ops_per_cell, 14 + 2*ceil(log2 n)) with its log-depth gap
    scan replaced by what the sequential gap chain costs, one subtract and
    one max a cell: 16, +1 for the --local clamp. The chain is exact (the
    CUDA kernels run it), so the scan is no work the function needs."""
    return 16 + (1 if local else 0)


def bound(ops: float, nbytes: float, ceiling: float):
    """(bound ms, "operations" or "bytes"): the larger of ops over the int32
    ceiling (ops/s) and nbytes over the memory rate."""
    t_ops = ops / ceiling * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rect_bound(lens, reflens, lq_pad: int, lc: int, local: bool,
               ceiling: float):
    """bound() of one `sw_tile` call on these inputs (numpy lens, reflens)."""
    P = len(lens)
    cells = float(np.sum(np.clip(lens, 0, lq_pad).astype(np.int64)
                         * np.clip(reflens, 0, lc)))
    nbytes = 4 * (2 * lq_pad * P + lc * P + 2 * P + 3 * P)
    return bound(cells * dp_ops_per_cell(local), nbytes, ceiling)


def measure(device, ceiling: float, reps: int = 5, plain_reps: int = 0,
            seed: int = 6):
    """One row per shape and mode: the kernel's median device time
    (`ms`, bench_dp.device_ms) and CUDA-event time of a call (`event_ms`),
    the bound, and max_abs_err of the kernel against the plain version on
    the same tensors; `plain_ms` too when plain_reps > 0."""
    out = []
    for k, (name, (P, lq_pad, lc, rl, wl)) in enumerate(SHAPES.items()):
        arrs = rect_inputs(P, lq_pad, lc, rl, wl, seed + k)
        args = [torch.from_numpy(a).to(device) for a in arrs]
        for mode, cfg in MODES.items():
            got = sw_tile(cfg, *args)
            want = sw_tile_torch(cfg, *args)
            err = max(int((g - w).abs().max()) for g, w in zip(got, want))
            call = lambda: sw_tile(cfg, *args)
            ms = device_ms(call, device, "rect_warp_kernel", reps)
            b_ms, b_by = rect_bound(arrs[2], arrs[4], lq_pad, lc, cfg.local,
                                    ceiling)
            row = dict(shape=name, mode=mode, P=P, lq_pad=lq_pad, lc=lc,
                       ms=ms, event_ms=time_ms(call, device, reps),
                       bound_ms=b_ms, bound_by=b_by,
                       frac_of_bound=b_ms / ms, max_abs_err=err)
            if plain_reps:
                row["plain_ms"] = time_ms(lambda: sw_tile_torch(cfg, *args),
                                          device, plain_reps)
            out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_rect", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu for the "
                         "plain versions")
    if device.type == "cuda":
        ceiling, _ = measure_alu_ceiling(device)
    else:   # CPU numbers: only the control flow means anything
        ceiling, _ = measure_alu_ceiling(device, P=256, rows=8, nsteps=50,
                                         reps=3)
    rows = measure(device, ceiling, a.reps)
    for r in rows:
        print(f"# {r['shape']} {r['mode']}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['frac_of_bound']:.4f} of bound, max_abs_err "
              f"{r['max_abs_err']}")
    print(json.dumps({"card": card_line(device), "ceiling_ops_per_s": ceiling,
                      "package": str(Path(sw_mod.__file__).parent.parent),
                      "rows": rows}))
    if any(r["max_abs_err"] for r in rows):
        raise SystemExit("the kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
