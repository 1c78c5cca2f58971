"""SimpleFunc — f(x) = max(I, min(X, C + L*g(x))) (ref: simple_func.h:44-120).

Used for score minimums, N ceilings, and seed interval functions. g is one of
const/linear/sqrt/log, selected by type. The reference rounds by adding 0.5
and truncating when an integer result is needed (ref: simple_func.h f<int>).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

CONST, LINEAR, SQRT, LOG = 1, 2, 3, 4

_TYPE_BY_CODE = {"C": CONST, "L": LINEAR, "S": SQRT, "G": LOG}


@dataclass(frozen=True)
class SimpleFunc:
    type: int = CONST
    I: float = -float("inf")
    X: float = float("inf")
    C: float = 0.0
    L: float = 0.0

    def f(self, x: float) -> float:
        if self.type == CONST:
            v = self.C
        elif self.type == LINEAR:
            v = self.C + self.L * x
        elif self.type == SQRT:
            v = self.C + self.L * math.sqrt(x)
        elif self.type == LOG:
            v = self.C + self.L * math.log(x)
        else:
            raise ValueError(f"bad SimpleFunc type {self.type}")
        return max(self.I, min(self.X, v))

    def f_int(self, x: float) -> int:
        """Integer evaluation with the reference's C-cast semantics:
        truncation toward zero (ref: simple_func.h:88-111 `return (T)ret` —
        NO rounding; e.g. interval(55) = (int)9.53 = 9, score_min(55) =
        (int)-33.6 = -33)."""
        return int(self.f(x))

    @staticmethod
    def parse(s: str) -> "SimpleFunc":
        """Parse 'F,C,L' policy syntax, e.g. 'S,1,1.15' or 'L,-0.6,-0.6'
        (ref: aligner_seed_policy.cpp parsing of MIN/IVAL/NCEIL tags)."""
        parts = s.split(",")
        t = _TYPE_BY_CODE[parts[0].upper()]
        c = float(parts[1]) if len(parts) > 1 else 0.0
        l = float(parts[2]) if len(parts) > 2 else 0.0
        return SimpleFunc(type=t, C=c, L=l)
