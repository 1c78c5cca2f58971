"""Mapping quality V2 (default `--mapq-v 2`) (ref: unique.h:171-416
BowtieMapq2::mapq).

The decision table maps (bestOver, bestdiff) — the best score above the
minimum valid score, and the gap to the second-best alignment — onto MAPQ
values, with separate tables for end-to-end (monotone) and local modes.
Thresholds are computed as diff * (double)(float)K to match the reference's
float32 constants promoted to double.
"""
from __future__ import annotations

import numpy as np


def _f32(x: float) -> float:
    return float(np.float32(x))


def mapq_v2(best: int, secbest: int | None, sc_min: int, sc_per: int,
            monotone: bool) -> int:
    """MAPQ for an aligned read. secbest=None when no second-best alignment
    was found. sc_min = minimum valid score, sc_per = perfect score."""
    diff = max(1, sc_per - sc_min)
    best_over = best - sc_min

    def ge(frac):  # bestOver >= diff * frac (float32 constant semantics)
        return best_over >= diff * _f32(frac)

    if monotone:  # end-to-end
        if secbest is None:
            if ge(0.8): return 42
            if ge(0.7): return 40
            if ge(0.6): return 24
            if ge(0.5): return 23
            if ge(0.4): return 8
            if ge(0.3): return 3
            return 0
        bestdiff = abs(abs(best) - abs(secbest))
        full = best_over == diff
        if bestdiff >= diff * _f32(0.9):
            return 39 if full else 33
        if bestdiff >= diff * _f32(0.8):
            return 38 if full else 27
        if bestdiff >= diff * _f32(0.7):
            return 37 if full else 26
        if bestdiff >= diff * _f32(0.6):
            return 36 if full else 22
        if bestdiff >= diff * _f32(0.5):
            if full: return 35
            if ge(0.84): return 25
            if ge(0.68): return 16
            return 5
        if bestdiff >= diff * _f32(0.4):
            if full: return 34
            if ge(0.84): return 21
            if ge(0.68): return 14
            return 4
        if bestdiff >= diff * _f32(0.3):
            if full: return 32
            if ge(0.88): return 18
            if ge(0.67): return 15
            return 3
        if bestdiff >= diff * _f32(0.2):
            if full: return 31
            if ge(0.88): return 17
            if ge(0.67): return 11
            return 0
        if bestdiff >= diff * _f32(0.1):
            if full: return 30
            if ge(0.88): return 12
            if ge(0.67): return 7
            return 0
        if bestdiff > 0:
            return 6 if ge(0.67) else 2
        return 1 if ge(0.67) else 0
    else:  # local
        if secbest is None:
            if ge(0.8): return 44
            if ge(0.7): return 42
            if ge(0.6): return 41
            if ge(0.5): return 36
            if ge(0.4): return 28
            if ge(0.3): return 24
            return 22
        bestdiff = abs(abs(best) - abs(secbest))
        full = best_over == diff
        if bestdiff >= diff * _f32(0.9): return 40
        if bestdiff >= diff * _f32(0.8): return 39
        if bestdiff >= diff * _f32(0.7): return 38
        if bestdiff >= diff * _f32(0.6): return 37
        if bestdiff >= diff * _f32(0.5):
            if full: return 35
            return 25 if ge(0.50) else 20
        if bestdiff >= diff * _f32(0.4):
            if full: return 34
            return 21 if ge(0.50) else 19
        if bestdiff >= diff * _f32(0.3):
            if full: return 33
            return 18 if ge(0.5) else 16
        if bestdiff >= diff * _f32(0.2):
            if full: return 32
            return 17 if ge(0.5) else 12
        if bestdiff >= diff * _f32(0.1):
            if full: return 31
            return 14 if ge(0.5) else 9
        if bestdiff > 0:
            return 11 if ge(0.5) else 2
        return 1 if ge(0.5) else 0


# ---------------------------------------------------------------- V1 / V3 -

# V3 decision tables (ref: unique.cpp:26-63 unp_nosec_perf/unp_nosec/
# unp_sec_perf/unp_sec). Constant tables reproduced verbatim — they ARE the
# published algorithm (same category as the preset table).
_V3_NOSEC_PERF = 44
_V3_NOSEC = (43, 42, 41, 36, 32, 27, 20, 11, 4, 1, 0)
_V3_SEC_PERF = (2, 16, 23, 30, 31, 32, 34, 36, 38, 40, 42)
_V3_SEC = (
    (2, 2, 2, 1, 1, 0, 0, 0, 0, 0, 0),
    (20, 14, 7, 3, 2, 1, 0, 0, 0, 0, 0),
    (20, 16, 10, 6, 3, 1, 0, 0, 0, 0, 0),
    (20, 17, 13, 9, 3, 1, 1, 0, 0, 0, 0),
    (21, 19, 15, 9, 5, 2, 2, 0, 0, 0, 0),
    (22, 21, 16, 11, 10, 5, 0, 0, 0, 0, 0),
    (23, 22, 19, 16, 11, 0, 0, 0, 0, 0, 0),
    (24, 25, 21, 30, 0, 0, 0, 0, 0, 0, 0),
    (30, 26, 29, 0, 0, 0, 0, 0, 0, 0, 0),
    (30, 27, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (30, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
)


def mapq_v3(best: int, secbest: int | None, sc_min: int, sc_per: int,
            monotone: bool) -> int:
    """MAPQ V3 (`--mapq-v 3`; ref: unique.h:96 BowtieMapq3::mapq): distance
    below the perfect score and the best/second-best gap, each binned into
    11 deciles of the valid score range, index the published tables."""
    rng = max(1, sc_per - sc_min)
    below = sc_per - best                      # lower = better
    best_bin = min(10, int(below * (10.0 / rng) + 0.5))
    # the reference's "perfect" test is literally `best == scMax`, i.e.
    # raw score 0 — equivalent to a perfect score only in end-to-end mode
    # (scMax == 0 there); reproduced verbatim (unique.h:133-155)
    is_perf = below == sc_per
    if secbest is not None:
        diff_bin = min(10, int((best - secbest) * (10.0 / rng) + 0.5))
        if is_perf:
            # verbatim: indexed by best_bin (unique.h:146), not diff_bin
            return _V3_SEC_PERF[best_bin]
        return _V3_SEC[diff_bin][best_bin]
    if is_perf:
        return _V3_NOSEC_PERF
    return _V3_NOSEC[best_bin]


def mapq_v1(best: int, secbest: int | None, sc_min: int, sc_per: int,
            monotone: bool) -> int:
    """Legacy MAPQ V1 (`--mapq-v 1`; ref: unique.h:417 BowtieMapq::mapq):
    thirds of the score range without a second-best, sixths of the
    best/second-best gap with one. float32 constant semantics preserved."""
    diff = sc_per - sc_min
    sixth_2 = float(np.float32(sc_per - diff * float(np.float32(0.1666)) * 2))
    sixth_3 = float(np.float32(sc_per - diff * float(np.float32(0.1666)) * 3))
    if secbest is None:
        if best >= sixth_2:
            return 37
        if best >= sixth_3:
            return 25
        return 10
    bestdiff = abs(abs(best) - abs(secbest))
    for mult, q in ((5, 6), (4, 5), (3, 4), (2, 3), (1, 2)):
        if bestdiff >= diff * 0.1666 * mult:
            return q
    return 1


def mapq_fn(version: int):
    """Per-version scalar MAPQ function (ref: unique.h:509 new_mapq)."""
    return {1: mapq_v1, 3: mapq_v3}.get(version, mapq_v2)


def mapq_batch(version: int, best, secbest, has_sec, sc_min, sc_per,
               monotone: bool) -> np.ndarray:
    """Vectorized MAPQ for any version (V2 has a dedicated fast path)."""
    if version == 2:
        return mapq_v2_batch(best, secbest, has_sec, sc_min, sc_per,
                             monotone)
    fn = mapq_fn(version)
    best = np.asarray(best)
    secbest = np.asarray(secbest)
    has_sec = np.asarray(has_sec, bool)
    sc_min = np.asarray(sc_min)
    sc_per = np.asarray(sc_per)
    return np.array([
        fn(int(best[i]), int(secbest[i]) if has_sec[i] else None,
           int(sc_min[i]), int(sc_per[i]), monotone)
        for i in range(len(best))], np.int64)


def mapq_v2_batch(best, secbest, has_sec, sc_min, sc_per,
                  monotone: bool) -> np.ndarray:
    """Vectorized mapq_v2 over arrays (same decision table; ref:
    unique.h:171-416). `secbest` is ignored where ~has_sec."""
    best = np.asarray(best, np.int64)
    secbest = np.asarray(secbest, np.int64)
    has_sec = np.asarray(has_sec, bool)
    sc_min = np.asarray(sc_min, np.int64)
    sc_per = np.asarray(sc_per, np.int64)
    diff = np.maximum(1, sc_per - sc_min).astype(np.float64)
    best_over = (best - sc_min).astype(np.float64)

    def ge(frac):
        return best_over >= diff * _f32(frac)

    def bd_ge(bd, frac):
        return bd >= diff * _f32(frac)

    bestdiff = np.abs(np.abs(best) - np.abs(secbest)).astype(np.float64)
    full = best_over == diff

    if monotone:
        no_sec = np.select(
            [ge(0.8), ge(0.7), ge(0.6), ge(0.5), ge(0.4), ge(0.3)],
            [42, 40, 24, 23, 8, 3], 0)
        w_sec = np.select(
            [bd_ge(bestdiff, 0.9), bd_ge(bestdiff, 0.8),
             bd_ge(bestdiff, 0.7), bd_ge(bestdiff, 0.6),
             bd_ge(bestdiff, 0.5), bd_ge(bestdiff, 0.4),
             bd_ge(bestdiff, 0.3), bd_ge(bestdiff, 0.2),
             bd_ge(bestdiff, 0.1), bestdiff > 0],
            [np.where(full, 39, 33), np.where(full, 38, 27),
             np.where(full, 37, 26), np.where(full, 36, 22),
             np.where(full, 35, np.select([ge(0.84), ge(0.68)],
                                          [25, 16], 5)),
             np.where(full, 34, np.select([ge(0.84), ge(0.68)],
                                          [21, 14], 4)),
             np.where(full, 32, np.select([ge(0.88), ge(0.67)],
                                          [18, 15], 3)),
             np.where(full, 31, np.select([ge(0.88), ge(0.67)],
                                          [17, 11], 0)),
             np.where(full, 30, np.select([ge(0.88), ge(0.67)],
                                          [12, 7], 0)),
             np.where(ge(0.67), 6, 2)],
            np.where(ge(0.67), 1, 0))
    else:
        no_sec = np.select(
            [ge(0.8), ge(0.7), ge(0.6), ge(0.5), ge(0.4), ge(0.3)],
            [44, 42, 41, 36, 28, 24], 22)
        w_sec = np.select(
            [bd_ge(bestdiff, 0.9), bd_ge(bestdiff, 0.8),
             bd_ge(bestdiff, 0.7), bd_ge(bestdiff, 0.6),
             bd_ge(bestdiff, 0.5), bd_ge(bestdiff, 0.4),
             bd_ge(bestdiff, 0.3), bd_ge(bestdiff, 0.2),
             bd_ge(bestdiff, 0.1), bestdiff > 0],
            [40, 39, 38, 37,
             np.where(full, 35, np.where(ge(0.50), 25, 20)),
             np.where(full, 34, np.where(ge(0.50), 21, 19)),
             np.where(full, 33, np.where(ge(0.5), 18, 16)),
             np.where(full, 32, np.where(ge(0.5), 17, 12)),
             np.where(full, 31, np.where(ge(0.5), 14, 9)),
             np.where(ge(0.5), 11, 2)],
            np.where(ge(0.5), 1, 0))
    return np.where(has_sec, w_sec, no_sec).astype(np.int64)
