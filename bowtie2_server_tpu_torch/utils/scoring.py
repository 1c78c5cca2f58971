"""Alignment scoring scheme (ref: scoring.h:96-420, scoring.cpp).

Reproduces Bowtie 2's scoring semantics:
- match bonus: constant (0 end-to-end, 2 local by default);
- mismatch penalty: quality-scaled MMP 'Q,6,2':
    pen(q) = MN + int(min(q,40)/40 * (MX-MN))   (ref: scoring.h initPens COST_MODEL_QUAL)
- N penalty: constant 1 (applies when read or ref char is ambiguous);
- affine gaps: a gap of length L costs const + linear*L, so the first gapped
  base costs (const+linear) = "open" and each additional base "linear" = extend
  (ref: scoring.h readGapOpen/readGapExtend);
- score minimum: SimpleFunc of read length (L,-0.6,-0.6 e2e / G,20,8 local);
- n ceiling: SimpleFunc (C,0,0.15) capped at read length.

`monotone` (end-to-end mode with match bonus 0) means all scores are <= 0,
which drives several policy decisions downstream, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from .simple_func import SimpleFunc, LINEAR, LOG

COST_CONST, COST_QUAL = 1, 2  # ref: scoring.h COST_MODEL_* (subset we support)


def _qual_pens(mn: int, mx: int) -> np.ndarray:
    q = np.minimum(np.arange(256), 40)
    frac = q.astype(np.float32) / np.float32(40.0)
    return (mn + (frac * (mx - mn)).astype(np.int32)).astype(np.int32)


@dataclass(frozen=True)
class Scoring:
    match_bonus: int = 0
    mm_cost_type: int = COST_QUAL
    mm_pen_max: int = 6
    mm_pen_min: int = 2
    np_pen: int = 1
    score_min: SimpleFunc = field(
        default_factory=lambda: SimpleFunc(type=LINEAR, C=-0.6, L=-0.6))
    n_ceil: SimpleFunc = field(
        default_factory=lambda: SimpleFunc(type=LINEAR, C=0.0, L=0.15))
    rd_gap_const: int = 5   # read gap = deletion from read (ref consumed)
    rd_gap_linear: int = 3
    rf_gap_const: int = 5   # ref gap = insertion in read
    rf_gap_linear: int = 3
    gapbar: int = 4         # rows at ends enterable only diagonally (ref: scoring.h gapbar)
    local: bool = False
    # --bwa-sw-like: min score = max(a*T, a*c*ln(len)) with a = match
    # bonus, T = 30, c = 5.5 (ref: bt2_search.cpp:3288-3295)
    bwa_sw_like: bool = False
    bwa_sw_T: float = 30.0
    bwa_sw_C: float = 5.5

    @property
    def monotone(self) -> bool:
        return self.match_bonus == 0

    # Gap costs in "open/extend" form used by the DP kernel: opening a gap
    # (first gapped base) costs open_total = const + linear.
    @property
    def read_gap_open(self) -> int:
        return self.rd_gap_const + self.rd_gap_linear

    @property
    def read_gap_extend(self) -> int:
        return self.rd_gap_linear

    @property
    def ref_gap_open(self) -> int:
        return self.rf_gap_const + self.rf_gap_linear

    @property
    def ref_gap_extend(self) -> int:
        return self.rf_gap_linear

    def mm_penalties(self) -> np.ndarray:
        """[256] per-quality mismatch penalty table (positive values)."""
        if self.mm_cost_type == COST_QUAL:
            return _qual_pens(self.mm_pen_min, self.mm_pen_max)
        return np.full(256, self.mm_pen_max, dtype=np.int32)

    def score_min_for(self, rdlen: int) -> int:
        """Minimum valid alignment score for a read of this length
        (ref: bt2_search.cpp:3285-3320): SimpleFunc interpolation; local
        mode clamps NEGATIVE minimums to 0, end-to-end clamps POSITIVE
        minimums to 0 (the reference prints a warning and clamps). A
        local minimum above the perfect score stays — the read is then
        score-filtered with YF:Z:SC, as in the reference."""
        if self.bwa_sw_like:
            a = np.float32(self.match_bonus)
            v = int(max(a * np.float32(self.bwa_sw_T),
                        a * np.float32(self.bwa_sw_C)
                        * np.float32(np.log(rdlen))))
        else:
            v = self.score_min.f_int(rdlen)
        if self.local and v < 0:
            v = 0
        elif not self.local and v > 0:
            v = 0
        return v

    def n_ceil_for(self, rdlen: int) -> int:
        return int(min(self.n_ceil.f_int(rdlen), rdlen))

    def perfect_score(self, rdlen: int) -> int:
        return 0 if self.monotone else rdlen * self.match_bonus

    def max_gaps(self, rdlen: int, which: str = "read") -> int:
        """Max # gaps that can occur while staying >= score min — bounds the
        DP band half-width (ref: scoring.h maxReadGaps/maxRefGaps)."""
        smin = self.score_min_for(rdlen)
        room = self.perfect_score(rdlen) - smin
        if which == "read":
            open_, ext = self.read_gap_open, self.read_gap_extend
        else:
            open_, ext = self.ref_gap_open, self.ref_gap_extend
        if room < open_:
            return 0
        return int((room - open_) // ext) + 1

    @staticmethod
    def default_e2e() -> "Scoring":
        return Scoring()

    @staticmethod
    def default_local() -> "Scoring":
        return Scoring(
            match_bonus=2,
            local=True,
            score_min=SimpleFunc(type=LOG, C=20.0, L=8.0),
        )

    def with_ignore_quals(self) -> "Scoring":
        return replace(self, mm_cost_type=COST_CONST)
