"""Banded-DP kernel bench: the time of `banded_dp` (ops/sw_banded.py) at the
fused stage's shapes, beside the least time the card could take for the same
work. On the card `banded_dp` routes each call to one of three kernels: the
register kernel (ops/csrc/sw_banded.cu `banded_kernel`, K <= 128), its
general kernel (`banded_general_kernel`, the same file: scores outside a
byte) or the wide-band kernel (ops/csrc/sw_banded_wide.cu, K > 128);
`route_symbol` names the one a row times.

    python -m bowtie2_server_tpu_torch.scripts.bench_banded [--device cuda]
        [--reps 5] [--shapes k256,k512]

The script imports the package by its absolute name, so it can also be run
as a file against another checkout of the package (for a comparison of two
commits in one run on one card):

    PYTHONPATH=<other checkout> python <this checkout>/bowtie2_server_tpu_torch/scripts/bench_banded.py

Shapes (`SHAPES`), each end-to-end and --local, all at the fused stage's
P = C_max = 33792 candidates and Lq = 128 read rows:
  - k64: K = 64 (the main path's band, `band_for(15)`); 4 in 5 problems of
    length 128, the fifth of 60-128 (the shape of the earlier PRs'
    measurements);
  - k64_len100: K = 64, every length 100: the main path's own mix (100 bp
    reads in 128 rows; rows past the read hold code 5 and penalty 0);
  - k32 and k128: the k64 lengths at K = 32 and at K = 128 (--dpad 16-31);
  - k256, k256_len100 and k512: the wide-band kernel's bands, K = 256
    (--dpad 32-63) at the k64 and the k64_len100 lengths, K = 512 (--dpad
    64-127) at the k64 lengths.
One more row (`GENERAL`, mode `large_scores`) times the general kernel: the
k64 shape under ma = 150, --local (tests/torch_tiles.py LARGE_SCORE_CFG), a
match bonus past a byte, which sends every problem to it.
Half the bands are cut from a random chromosome around planted reads (0-3
substitutions, 1 in 16 problems with an N read code), half are random;
mismatch penalties are Phred-like, 2-6.

The bound (`bound_ms`, bench_rect.bound): the larger of the int32
operations (`banded_ops_per_cell` a cell, over the cells these inputs need:
rows below len times K) over the int32 ceiling the ALU probe measures
(bench_dp.measure_alu_ceiling) and the bytes (each input read once, each
output written once) over HBM3's 3.35 TB/s.

The last line of standard output is one JSON object: the card line of
`nvidia-smi`, the ceiling, the package timed, and per shape and mode the
kernel timed (`route_symbol`), its median ms, its bound, the share of the
bound, and max_abs_err against `banded_tile_torch`.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from bowtie2_server_tpu_torch.ops import sw_banded as sb_mod
from bowtie2_server_tpu_torch.ops.sw import SwConfig
from bowtie2_server_tpu_torch.ops.sw_banded import banded_dp, banded_tile_torch
from bowtie2_server_tpu_torch.scripts.bench_dp import (
    BANDED_SYMBOL, card_line, device_ms, measure_alu_ceiling, time_ms)
from bowtie2_server_tpu_torch.scripts.bench_rect import bound

P_FUSED, LQ = 33792, 128
# name -> (P, Lq, K, every length or None for the 4-in-5 mix)
SHAPES = {
    "k64": (P_FUSED, LQ, 64, None),
    "k64_len100": (P_FUSED, LQ, 64, 100),
    "k32": (P_FUSED, LQ, 32, None),
    "k128": (P_FUSED, LQ, 128, None),
    "k256": (P_FUSED, LQ, 256, None),
    "k256_len100": (P_FUSED, LQ, 256, 100),
    "k512": (P_FUSED, LQ, 512, None),
}
MODES = {"e2e": SwConfig(), "local": SwConfig(ma=2, local=True)}
# the general kernel's row: name -> shape as in SHAPES, under LARGE_SCORE
GENERAL = {"k64_large_scores": (P_FUSED, LQ, 64, None)}
LARGE_SCORE = SwConfig(ma=150, npen=2, local=True)   # LARGE_SCORE_CFG


def byte_scores(cfg: SwConfig, lq: int) -> bool:
    """Whether the register kernel takes `cfg` (bt2_sw_banded's `fast`):
    ma and -npen fit a signed byte and, in --local, no gap penalty is
    negative and lq <= 65536. Otherwise every problem goes to the general
    kernel."""
    def fits8(v):
        return -128 <= v <= 127
    gaps = (cfg.rdg_open, cfg.rdg_ext, cfg.rfg_open, cfg.rfg_ext)
    return (fits8(cfg.ma) and fits8(-cfg.npen)
            and (not cfg.local or (lq <= 65536 and min(gaps) >= 0)))


def route_symbol(K: int, cfg: SwConfig, lq: int) -> str:
    """The part of the profiler name of the kernel that `banded_dp` runs
    for band K under `cfg` (the one `device_ms` times)."""
    if K > sb_mod.REGISTER_BAND_MAX:
        return "banded_wide_kernel"
    if not byte_scores(cfg, lq):
        return "banded_general_kernel"
    return BANDED_SYMBOL


def banded_inputs(seed: int, P: int, K: int, lq: int, every=None,
                  chrom=None):
    """[rd, mm, lens, band] int32 numpy arrays, rows x problems: half the
    bands cut from `chrom` (a random 4 Mbp one when None) around planted
    reads, half random; lengths `every` or, when None, lq for 4 in 5
    problems and 15/32 lq..lq for the fifth."""
    rng = np.random.default_rng(seed)
    if chrom is None:
        chrom = rng.integers(0, 4, 4_000_000).astype(np.uint8)
    s = rng.integers(K, len(chrom) - lq - 2 * K, P)
    band = chrom[(s - K // 2)[None, :] + np.arange(lq + K)[:, None]]
    band = band.astype(np.int32)
    rd = band[K // 2 : K // 2 + lq].copy()
    for _ in range(3):
        rd[rng.integers(0, lq, P), np.arange(P)] = rng.integers(0, 4, P)
    rnd = np.arange(P) % 2 == 1
    band[:, rnd] = rng.integers(0, 4, (lq + K, int(rnd.sum())))
    rd[rng.integers(0, lq, P // 16), rng.integers(0, P, P // 16)] = 5
    mm = rng.integers(2, 7, (lq, P)).astype(np.int32)
    if every is None:
        short = rng.integers(lq * 15 // 32, lq + 1, P)   # 60..128 at 128
        lens = np.where(np.arange(P) % 5 == 0, short, lq)
    else:
        lens = np.full(P, every)
        live = np.arange(lq)[:, None] < lens[None, :]
        rd = np.where(live, rd, 5)
        mm = np.where(live, mm, 0)
    return [np.ascontiguousarray(a, np.int32) for a in (rd, mm, lens, band)]


def banded_ops_per_cell(local: bool) -> int:
    """int32 operations a cell of the banded recurrence, each add and each
    max one (the probe's count, which takes a fused max-add as two): F =
    max(H_up - rfg_open, F_up - rfg_ext), 3; max(H_diag + s, F), 2; E =
    max(E_left - rdg_ext, base_left - rdg_open), 3; H = max(base, E), 1;
    the score, one select from the row's table, 1. --local adds the clamp
    at 0 and the row's running max, 2. The end-to-end arg-max scans one
    row, not counted. bench_rect.dp_ops_per_cell (16 + local, the JAX op
    model less its scan) counts more than the recurrence needs; the rect
    kernel's bound keeps it."""
    return 10 + 2 * int(local)


def banded_bound(lens, lq: int, K: int, local: bool, ceiling: float):
    """bound() of one banded call on these inputs (numpy lens)."""
    P = len(lens)
    cells = float(np.clip(lens, 0, lq).astype(np.int64).sum()) * K
    nbytes = 4 * (2 * lq * P + (lq + K) * P + P + 3 * P)
    return bound(cells * banded_ops_per_cell(local), nbytes, ceiling)


def measure(device, ceiling: float, reps: int = 5, plain_reps: int = 0,
            chrom=None, shapes=None):
    """One row per shape and mode (the SHAPES in both MODES, then the
    GENERAL row; `shapes`, a list of names, keeps only those): the
    kernel's median device time (`ms`, bench_dp.device_ms of the kernel
    the route launches) and CUDA-event time of a call (`event_ms`), the
    bound, and max_abs_err of the kernel against the plain version on the
    same tensors; `plain_ms` too when plain_reps > 0. Each shape's inputs
    come from its own seed, by its place in SHAPES (GENERAL: k64's)."""
    rows = [(name, k, shape, MODES) for k, (name, shape)
            in enumerate(SHAPES.items())]
    rows += [(name, list(SHAPES).index("k64"), shape,
              {"large_scores": LARGE_SCORE})
             for name, shape in GENERAL.items()]
    out = []
    for name, k, (P, lq, K, every), modes in rows:
        if shapes is not None and name not in shapes:
            continue
        arrs = banded_inputs(5 + k, P, K, lq, every, chrom)
        args = [torch.from_numpy(a).to(device) for a in arrs]
        for mode, cfg in modes.items():
            got = banded_dp(cfg, K, *args)
            want = banded_tile_torch(cfg, K, *args)
            err = max(int((g - w).abs().max()) for g, w in zip(got, want))
            call = lambda: banded_dp(cfg, K, *args)
            kernel = route_symbol(K, cfg, lq)
            ms = device_ms(call, device, kernel, reps)
            b_ms, b_by = banded_bound(arrs[2], lq, K, cfg.local, ceiling)
            row = dict(shape=name, mode=mode, P=P, lq=lq, K=K, kernel=kernel,
                       ms=ms, event_ms=time_ms(call, device, reps),
                       bound_ms=b_ms,
                       bound_by=b_by, frac_of_bound=b_ms / ms,
                       max_abs_err=err)
            if plain_reps:
                row["plain_ms"] = time_ms(
                    lambda: banded_tile_torch(cfg, K, *args), device,
                    plain_reps)
            out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_banded", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", default=None,
                    help="comma-separated row names (default: all)")
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
    rows = measure(device, ceiling, a.reps,
                   shapes=a.shapes.split(",") if a.shapes else None)
    for r in rows:
        print(f"# {r['shape']} {r['mode']} ({r['kernel'].strip(':<')}): "
              f"{r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['frac_of_bound']:.4f} of bound, max_abs_err "
              f"{r['max_abs_err']}")
    print(json.dumps({"card": card_line(device), "ceiling_ops_per_s": ceiling,
                      "package": str(Path(sb_mod.__file__).parent.parent),
                      "rows": rows}))
    if any(r["max_abs_err"] for r in rows):
        raise SystemExit("the kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
