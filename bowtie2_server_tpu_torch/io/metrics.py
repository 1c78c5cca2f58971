"""Run summary and metrics (ref: aln_sink.cpp:349-530 printAlSumm,
bt2_search.cpp:1923 PerfMetrics).

`AlnSummary` reproduces the reference's end-of-run stderr summary format
byte-for-byte for the common paths ("N reads; of these: ... overall
alignment rate"), which downstream tools parse.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field


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


# the reference's full 129-column header, in emission order
# (ref: bt2_search.cpp:1923-2070 PerfMetrics::reportInterval)
PERF_COLUMNS = (
    "Time Read Base SameRead SameReadBase UnfilteredRead UnfilteredBase "
    "Paired Unpaired AlConUni AlConRep AlConFail AlDis AlConFailUni "
    "AlConFailRep AlConFailFail AlConRepUni AlConRepRep AlConRepFail "
    "AlUnpUni AlUnpRep AlUnpFail SeedSearch NRange NElt IntraSCacheHit "
    "InterSCacheHit OutOfMemory AlBWOp AlBWBranch ResBWOp ResBWBranch "
    "ResResolve ResReport RedundantSHit BestMinEdit0 BestMinEdit1 "
    "BestMinEdit2 ExactAttempts ExactSucc ExactRanges ExactRows ExactOOMs "
    "1mmAttempts 1mmSucc 1mmRanges 1mmRows 1mmOOMs UngappedSucc "
    "UngappedFail UngappedNoDec DPExLt10Gaps DPExLt5Gaps DPExLt3Gaps "
    "DPMateLt10Gaps DPMateLt5Gaps DPMateLt3Gaps "
    + " ".join(f"DP16Ex{s}" for s in
               ("Dps DpSat DpFail DpSucc Col Cell Inner Fixup GathSol Bt "
                "BtFail BtSucc BtCell CoreRej NRej").split()) + " "
    + " ".join(f"DP8Ex{s}" for s in
               ("Dps DpSat DpFail DpSucc Col Cell Inner Fixup GathSol Bt "
                "BtFail BtSucc BtCell CoreRej NRej").split()) + " "
    + " ".join(f"DP16Mate{s}" for s in
               ("Dps DpSat DpFail DpSucc Col Cell Inner Fixup GathSol Bt "
                "BtFail BtSucc BtCell CoreRej NRej").split()) + " "
    + " ".join(f"DP8Mate{s}" for s in
               ("Dps DpSat DpFail DpSucc Col Cell Inner Fixup GathSol Bt "
                "BtFail BtSucc BtCell CoreRej NRej").split()) + " "
    "DPBtFiltStart DPBtFiltScore DpBtFiltDom MemPeak UncatMemPeak "
    "EbwtMemPeak CacheMemPeak ResolveMemPeak AlignMemPeak DPMemPeak "
    "MiscMemPeak DebugMemPeak").split()


@dataclass
class PerfMetrics:
    """The reference's --metrics TSV (ref: bt2_search.cpp:1923
    PerfMetrics): same 129-column header and cadence.

    Column mapping for the TPU design: all DP runs in ONE precision class
    (int32 banded Pallas / rect numpy), reported under the DP16Ex*/
    DP16Mate* family; DP8* stays 0 (no 8-bit class exists). DpSat stays 0
    (int32 cannot saturate). The cache columns (IntraSCacheHit/
    InterSCacheHit) stay 0 by design: batch dedup replaces the seed-hit
    cache. Tracked for real: Time/Read/Base, alignment outcomes, seed
    search volumes (SeedSearch/NRange/NElt), DP problem counts + gap-class
    split (DPExLt*, tallyGappedDp semantics), DP col/cell volumes,
    host-traceback counters (Bt/BtFail/BtSucc/BtCell via live_bt), and
    memory peaks (RSS + device index/DP buffer analogs)."""
    interval: float = 1.0
    out: object = sys.stderr
    per_read: bool = False
    start: float = field(default_factory=time.time)
    last: float = field(default_factory=time.time)
    header_done: bool = False
    # live references (set after aligner construction): the aligner's
    # cumulative host-traceback counter dict, and device buffer sizes
    live_bt: object = None      # dict bt/btfail/btsucc/btcell
    mem_index: int = 0          # device-resident index bytes (Ebwt analog)
    mem_dp: int = 0             # DP band/window buffer bytes
    mem_resolve: int = 0        # SA-resolution array bytes
    # cumulative counters
    nread: int = 0
    nbase: int = 0
    n_unfiltered_read: int = 0
    n_unfiltered_base: int = 0
    n_paired: int = 0
    n_unpaired: int = 0
    al_con_uni: int = 0
    al_con_rep: int = 0
    al_con_fail: int = 0
    al_dis: int = 0
    al_unp_uni: int = 0
    al_unp_rep: int = 0
    al_unp_fail: int = 0
    seed_searches: int = 0
    n_range: int = 0
    n_elt: int = 0
    exact_attempts: int = 0
    exact_succ: int = 0
    ungapped_succ: int = 0
    ungapped_fail: int = 0
    dp_ex: int = 0      # seed-extension DP problems
    dp_mate: int = 0    # mate-rescue DP problems
    dp_lt10: int = 0    # DP problems whose gap budget allows < 10 gaps
    dp_lt5: int = 0
    dp_lt3: int = 0
    dp_mate_lt10: int = 0
    dp_mate_lt5: int = 0
    dp_mate_lt3: int = 0
    dp_col: int = 0     # DP columns computed (sum of problem lengths)
    dp_cell: int = 0    # DP cells computed (columns x band width)
    dp_succ: int = 0    # DP problems reaching the score floor
    dp_fail: int = 0

    def add_batch(self, nread, nbase, unf_read, unf_base, paired,
                  seed_searches=0, n_range=0, n_elt=0, exact_attempts=0,
                  exact_succ=0, ungapped_succ=0, ungapped_fail=0,
                  dp_ex=0, dp_mate=0, dp_lt10=0, dp_lt5=0, dp_lt3=0,
                  dp_mate_lt10=0, dp_mate_lt5=0, dp_mate_lt3=0,
                  dp_col=0, dp_cell=0, dp_succ=0, dp_fail=0,
                  al_uni=0, al_rep=0, al_fail=0, con_uni=0, con_rep=0,
                  con_fail=0, dis=0):
        self.nread += nread
        self.nbase += nbase
        self.n_unfiltered_read += unf_read
        self.n_unfiltered_base += unf_base
        if paired:
            self.n_paired += nread
        else:
            self.n_unpaired += nread
        self.seed_searches += seed_searches
        self.n_range += n_range
        self.n_elt += n_elt
        self.exact_attempts += exact_attempts
        self.exact_succ += exact_succ
        self.ungapped_succ += ungapped_succ
        self.ungapped_fail += ungapped_fail
        self.dp_ex += dp_ex
        self.dp_mate += dp_mate
        self.dp_lt10 += dp_lt10
        self.dp_lt5 += dp_lt5
        self.dp_lt3 += dp_lt3
        self.dp_mate_lt10 += dp_mate_lt10
        self.dp_mate_lt5 += dp_mate_lt5
        self.dp_mate_lt3 += dp_mate_lt3
        self.dp_col += dp_col
        self.dp_cell += dp_cell
        self.dp_succ += dp_succ
        self.dp_fail += dp_fail
        self.al_unp_uni += al_uni
        self.al_unp_rep += al_rep
        self.al_unp_fail += al_fail
        self.al_con_uni += con_uni
        self.al_con_rep += con_rep
        self.al_con_fail += con_fail
        self.al_dis += dis
        now = time.time()
        if self.per_read or now - self.last >= self.interval:
            self.last = now
            self.emit()

    def emit(self):
        if not self.header_done:
            print("\t".join(PERF_COLUMNS), file=self.out)
            self.header_done = True
        import resource
        mem_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        bt = self.live_bt or {}
        vals = {c: 0 for c in PERF_COLUMNS}
        vals.update({
            "Time": int(time.time() - self.start),
            "Read": self.nread, "Base": self.nbase,
            "UnfilteredRead": self.n_unfiltered_read,
            "UnfilteredBase": self.n_unfiltered_base,
            "Paired": self.n_paired, "Unpaired": self.n_unpaired,
            "AlConUni": self.al_con_uni, "AlConRep": self.al_con_rep,
            "AlConFail": self.al_con_fail, "AlDis": self.al_dis,
            "AlUnpUni": self.al_unp_uni, "AlUnpRep": self.al_unp_rep,
            "AlUnpFail": self.al_unp_fail,
            "SeedSearch": self.seed_searches,
            "NRange": self.n_range, "NElt": self.n_elt,
            "ExactAttempts": self.exact_attempts,
            "ExactSucc": self.exact_succ,
            "UngappedSucc": self.ungapped_succ,
            "UngappedFail": self.ungapped_fail,
            "DPExLt10Gaps": self.dp_lt10, "DPExLt5Gaps": self.dp_lt5,
            "DPExLt3Gaps": self.dp_lt3,
            "DPMateLt10Gaps": self.dp_mate_lt10,
            "DPMateLt5Gaps": self.dp_mate_lt5,
            "DPMateLt3Gaps": self.dp_mate_lt3,
            "DP16ExDps": self.dp_ex, "DP16ExDpSucc": self.dp_succ,
            "DP16ExDpFail": self.dp_fail, "DP16ExCol": self.dp_col,
            "DP16ExCell": self.dp_cell,
            "DP16ExBt": bt.get("bt", 0),
            "DP16ExBtFail": bt.get("btfail", 0),
            "DP16ExBtSucc": bt.get("btsucc", 0),
            "DP16ExBtCell": bt.get("btcell", 0),
            "DP16MateDps": self.dp_mate,
            "MemPeak": mem_peak,
            "EbwtMemPeak": self.mem_index or mem_peak,
            "DPMemPeak": self.mem_dp,
            "ResolveMemPeak": self.mem_resolve,
        })
        print("\t".join(str(vals[c]) for c in PERF_COLUMNS), file=self.out)


@dataclass
class PerfTicker:
    """Periodic metrics line (a compact analog of --met-stderr's TSV,
    ref: PerfMetrics emission cadence bt2_search.cpp:3229-3248)."""
    interval: float = 1.0
    out: object = sys.stderr
    start: float = field(default_factory=time.time)
    last: float = field(default_factory=time.time)
    nread: int = 0
    naligned: int = 0
    header_done: bool = False

    def tick(self, nread: int, naligned: int):
        self.nread += nread
        self.naligned += naligned
        now = time.time()
        if now - self.last < self.interval:
            return
        self.last = now
        if not self.header_done:
            print("secs\treads\taligned\treads/s", file=self.out)
            self.header_done = True
        el = now - self.start
        print(f"{el:.1f}\t{self.nread}\t{self.naligned}\t"
              f"{self.nread/el:.0f}", file=self.out)
