"""Run summary (ref: aln_sink.cpp:349-530 printAlSumm).

`AlnSummary` reproduces the reference's end-of-run stderr summary format
byte-for-byte for the common paths ("N reads; of these: ... overall
alignment rate"), which downstream tools parse.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass


def _pct(num: int, denom: int) -> str:
    pct = 100.0 * num / denom if denom else 0.0
    return f"{pct:.2f}%"


@dataclass
class AlnSummary:
    # unpaired
    nunpaired: int = 0
    nunp_0: int = 0
    nunp_uni1: int = 0   # aligned exactly 1 time
    nunp_uni2: int = 0   # aligned >1 times
    # paired
    npaired: int = 0
    nconcord_0: int = 0
    nconcord_uni1: int = 0
    nconcord_uni2: int = 0
    ndiscord: int = 0
    nunp_0_0: int = 0    # mates of non-concordant pairs aligned 0 times
    nunp_0_uni1: int = 0
    nunp_0_uni2: int = 0

    def add_unpaired(self, rec):
        self.nunpaired += 1
        if not rec.aligned:
            self.nunp_0 += 1
        elif rec.secbest is not None:
            self.nunp_uni2 += 1
        else:
            self.nunp_uni1 += 1

    def add_unpaired_soa(self, recs) -> int:
        """Batch update from a LazyRecs/FastSoA view without materializing
        records; returns the number aligned."""
        soa = recs.soa
        cached = set(i for i, _ in recs.cache_items())
        B = len(recs)
        import numpy as np
        mask_c = np.zeros(B, bool)
        for i in cached:
            mask_c[i] = True
        filled = soa.filled & ~mask_c
        n_filled = int(filled.sum())
        n_uni2 = int(soa.sec_has[soa.tidx[filled]].sum()) if n_filled else 0
        self.nunpaired += B - len(cached)
        self.nunp_uni2 += n_uni2
        self.nunp_uni1 += n_filled - n_uni2
        self.nunp_0 += (B - len(cached)) - n_filled
        na = n_filled
        for i in cached:
            r = recs[i]
            if not r.secondary:
                self.add_unpaired(r)
                na += bool(r.aligned)
        return na

    def add_pair(self, r1, r2):
        self.npaired += 1
        if r1.proper and r2.proper:
            if getattr(r1, "pair_multi", False):
                self.nconcord_uni2 += 1
            else:
                self.nconcord_uni1 += 1
            return
        self.nconcord_0 += 1
        if r1.yt == "DP":
            self.ndiscord += 1
            return
        for r in (r1, r2):
            if not r.aligned:
                self.nunp_0_0 += 1
            elif r.secbest is not None:
                self.nunp_0_uni2 += 1
            else:
                self.nunp_0_uni1 += 1

    def print_summary(self, out=sys.stderr):
        totread = self.nunpaired + self.npaired
        totpair = self.npaired
        totunpair = self.nunpaired
        p = lambda s: print(s, file=out)
        if totread > 0:
            p(f"{totread} reads; of these:")
        else:
            p(f"{totread} reads")
        if totpair > 0:
            p(f"  {totpair} ({_pct(totpair, totread)}) were paired; of "
              f"these:")
            p(f"    {self.nconcord_0} ({_pct(self.nconcord_0, totpair)}) "
              f"aligned concordantly 0 times")
            p(f"    {self.nconcord_uni1} "
              f"({_pct(self.nconcord_uni1, totpair)}) aligned concordantly "
              f"exactly 1 time")
            p(f"    {self.nconcord_uni2} "
              f"({_pct(self.nconcord_uni2, totpair)}) aligned concordantly "
              f">1 times")
            p("    ----")
            p(f"    {self.nconcord_0} pairs aligned concordantly 0 times; "
              f"of these:")
            p(f"      {self.ndiscord} ({_pct(self.ndiscord, self.nconcord_0)}"
              f") aligned discordantly 1 time")
            ncondiscord_0 = self.nconcord_0 - self.ndiscord
            p("    ----")
            p(f"    {ncondiscord_0} pairs aligned 0 times concordantly or "
              f"discordantly; of these:")
            p(f"      {ncondiscord_0 * 2} mates make up the pairs; of these:")
            p(f"        {self.nunp_0_0} ({_pct(self.nunp_0_0, ncondiscord_0 * 2)}"
              f") aligned 0 times")
            p(f"        {self.nunp_0_uni1} "
              f"({_pct(self.nunp_0_uni1, ncondiscord_0 * 2)}) aligned "
              f"exactly 1 time")
            p(f"        {self.nunp_0_uni2} "
              f"({_pct(self.nunp_0_uni2, ncondiscord_0 * 2)}) aligned "
              f">1 times")
        if totunpair > 0:
            p(f"  {totunpair} ({_pct(totunpair, totread)}) were unpaired; "
              f"of these:")
            p(f"    {self.nunp_0} ({_pct(self.nunp_0, totunpair)}) aligned "
              f"0 times")
            p(f"    {self.nunp_uni1} ({_pct(self.nunp_uni1, totunpair)}) "
              f"aligned exactly 1 time")
            p(f"    {self.nunp_uni2} ({_pct(self.nunp_uni2, totunpair)}) "
              f"aligned >1 times")
        tot_al_cand = totunpair + totpair * 2
        tot_al = ((self.nconcord_uni1 + self.nconcord_uni2) * 2
                  + self.ndiscord * 2
                  + self.nunp_0_uni1 + self.nunp_0_uni2
                  + self.nunp_uni1 + self.nunp_uni2)
        p(f"{_pct(tot_al, tot_al_cand)} overall alignment rate")
