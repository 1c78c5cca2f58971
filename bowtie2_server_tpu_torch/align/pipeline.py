"""The staged alignment pipeline (ref: bt2_search.cpp:3050
multiseedSearchWorker, aligner_sw_driver.cpp:756 SwDriver::extendSeeds).
Port of bowtie2_server_tpu/align/pipeline.py: the UnpairedAligner, which
runs the fused device pipeline of align/candgen.py on the device given at
construction (or over a 'dp' mesh of devices, parallel/mesh.py), and its
host path (`_collect_host`: -a, -k above 1024, an
index without its mirror direction, and a batch still overflowing after
the capacity escalation), which drives the FM ops of ops/fm.py and the DP
kernels batch-wise from the host. Both build the same per-batch state
(`BatchState`), which selection, the traceback (`trace_candidates`) and
the paired aligner (align/paired.py) read; mate rescue grows it through
`BatchState.add_rescued`, and packs its problems with `pack_rect`. A big
index (docs/BIGINDEX.md) takes the fused path only: a batch still
overflowing at 16x raises BigCapacityError, and `align_wait` splits it in
halves (`ConcatRecs`).

Where the reference advances one read at a time through
filters -> exact sweep -> 1mm -> seed rounds -> extend, this pipeline
advances a whole batch through fixed-shape stages:

  1. encode + filters                               (host, vectorized)
  2. seed rounds: seeds at the reference's offsets
     (ref: aligner_seed.cpp:498 instantiateSeeds; offset schedule
     bt2_search.cpp:3853) looked up in the k-mer table (device)
  3. position resolution, candidate dedup per (read, strand, diagonal),
     banded DP of every candidate, per-read selection
                                (device, align/candgen.py, ops/sw_banded.py)
  4. rectangle DP of run-boundary candidates        (host numpy, or the
                                                     device above 128 jobs)
  5. edits (ungapped fast path, or the traceback: the CUDA kernel on
     a card, the numpy oracle on the CPU), MAPQ v2, SAM fields (host)

Differences from the reference flagged for later parity work: no streak
early-stopping (we always search every stage — more sensitive, not less).
Equal-score ties break via the per-read generator (utils/rng.py): same seed
derivation and LCG as the reference, fresh stream at selection time (the
reference's stream position at selection depends on its sequential search
history).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..index.fm import FmIndex
from ..io.fastq import ReadBatch
from ..ops import fm as dfm
from ..ops.sw import NEG_INF, SwConfig, sw_align_batch
from ..ops.sw_banded import banded_traceback_batch, sw_banded_batch
from ..utils import dna, trace
from ..utils.scoring import Scoring
from ..utils.simple_func import SimpleFunc, SQRT
from .candgen import CandGen, per_len
from .edits import (cigar_md_stats, edits_from_ungapped, ungapped_score,
                    traceback as rect_traceback)
from .mapq import mapq_batch, mapq_fn
from ..utils.rng import RandomSource, gen_rand_seed, select_by_score_order

# Band width: the reference's seed-extension rectangle spans +-2*maxgap
# (maxgap <= maxhalf, default 15 = --dpad) around the anchor diagonal
# (ref: dp_framer.cpp:95-100 frameSeedExtensionRect), so +-32 covers its
# full reach at the default. Larger --dpad widens the band per policy
# (band_for), the long-read/sensitivity knob: memory stays O(L*K).
BAND = 64


def band_for(maxhalf: int) -> int:
    """Band width covering +-2*maxhalf diagonal excursion, pow2-bucketed
    (one compiled kernel shape per width)."""
    k = 64
    while k < 4 * maxhalf + 4:
        k *= 2
    return k

# -a sentinel: "report all" (ref: ReportingParams::allHits, aln_sink.h:288
# khits == max int). -a routes to the host path, which enumerates ranges
# UNBOUNDED in chunks of _RESOLVE_CHUNK (the reference's -a is unbounded,
# aln_sink.h:288); -k up to _FUSED_KMAX runs fused with the per-range
# element capacity E scaled to k.
ALL_HITS = 1 << 30
_RESOLVE_CHUNK = 65536      # per-device-call enumeration chunk
_FUSED_KMAX = 1024          # largest -k served by the fused device path


class BigCapacityError(RuntimeError):
    """A big index's fused capacities are exhausted at the largest
    escalation; the aligners degrade by splitting the batch (align_wait)
    instead of failing."""


@dataclass(frozen=True)
class SearchPolicy:
    """Multiseed parameters (ref: presets.cpp --sensitive defaults)."""
    seed_len: int = 22
    interval: SimpleFunc = field(
        default_factory=lambda: SimpleFunc(type=SQRT, C=1.0, L=1.15))
    n_seed_rounds: int = 2
    max_sa_elts: int = 16   # per-seed-range resolution cap (ref: RowSampler role)
    maxhalf: int = 15       # DP window half-width (ref: --dpad default)
    khits: int = 1
    mhits: int = 50         # -M: sample 1 of the best when > mhits distinct
    msample: bool = True    # alignments exist (ref: bt2_search.cpp:369-370)
    seed: int = 0           # --seed: global RNG seed (ref: Read::seed mix)
    n_seed_mms: int = 0     # -N: substitutions allowed inside a seed
                            # (ref: aligner_seed.cpp:668 searchSeedBi)
    non_deterministic: bool = False  # --non-deterministic: per-read seeds
                            # drawn from a time-seeded stream instead of
                            # read content (ref: bt2_search.cpp:3215-3218)
    boost_thresh: int = 300  # --seed-boost: reseed when avg hits per
                            # nonzero seed >= this (ref: seedBoostThresh,
                            # bt2_search.cpp:4086)
    no_exact_upfront: bool = False  # --no-exact-upfront (ref: doExactUpFront)
    no_1mm_upfront: bool = False    # --no-1mm-upfront (ref: do1mmUpFront)
    dp_streak: int = 15     # preset DPS (ref: presets.cpp:26 DPS=, the
                            # maxDpStreak policy): caps consecutive failed
                            # extend->commit attempts per read. Our DP is
                            # batched (no per-extend cost to save), so this
                            # bounds the sequential retry loop of the
                            # selection stage — the same worst-case-latency
                            # role it plays in SwDriver::extendSeeds.


@dataclass
class AlnRec:
    """One read's alignment outcome — the SAM-record precursor
    (ref: aligner_result.h:792 AlnRes)."""
    name: str
    aligned: bool
    filtered: bool = False
    fw: bool = True
    ref_id: int = -1
    pos: int = -1           # 0-based leftmost ref position
    score: int = NEG_INF
    secbest: int | None = None
    mapq: int = 0
    cigar: str = "*"
    md: str = ""
    nm: int = 0
    xm: int = 0
    xo: int = 0
    xg: int = 0
    xn: int = 0
    yt: str = "UU"
    secondary: bool = False  # SAM 0x100 (for -k/-a extra records)
    seq: bytes = b""        # aligned-strand sequence (SAM SEQ)
    qual: bytes = b""
    # original-orientation read, the source of truth for SEQ/QUAL: _commit
    # may run more than once on a record (paired combo retries), so it must
    # always re-derive rather than mutate seq/qual in place
    orig_seq: bytes = b""
    orig_qual: bytes = b""
    # paired-end fields (ref: aln_sink SAM flag/TLEN assembly)
    paired: bool = False
    mate1: bool = True
    proper: bool = False
    mate_aligned: bool = False
    mate_fw: bool = True
    mate_ref_id: int = -1
    mate_pos: int = -1
    tlen: int = 0
    ys: int | None = None
    pair_multi: bool = False  # pair had >1 concordant combo (summary stat)
    comment: bytes | None = None   # FASTQ header comment (--sam-append-comment)
    orig_rec: bytes | None = None  # original record text (--passthrough)
    preserved: str | None = None   # BAM input tags (--preserve-tags)
    yf: str = "NS"                 # filter reason when filtered (YF:Z:)
    ym: bool = False               # repetitive under -M (YM:i, maxed flag)


class ArrayCands:
    """(read, fw, diag) candidate list backed by flat arrays (from the fused
    device pipeline), with append support for rescue-added candidates."""

    __slots__ = ("_r", "_f", "_d", "extra")

    def __init__(self, read, fw, diag):
        self._r, self._f, self._d = read, fw, diag
        self.extra: list[tuple] = []

    def __len__(self):
        return len(self._r) + len(self.extra)

    def __getitem__(self, ci):
        n = len(self._r)
        if ci < n:
            return (int(self._r[ci]), bool(self._f[ci]), int(self._d[ci]))
        return self.extra[ci - n]

    def append(self, t):
        self.extra.append(t)


class LazyByRead(dict):
    """read -> [candidate indices] map materialized on first access
    (vectorized argsort grouping instead of a per-candidate Python loop)."""

    def __init__(self, c_read):
        super().__init__()
        self._c_read = c_read
        self._built = c_read is None or len(c_read) == 0

    def _build(self, k=None):
        """Materialize one key's candidate list (per-key, via a sorted
        index) — a full build costs ~100 ms at 64k candidates while the
        slow path typically touches a handful of reads per batch."""
        if self._built:
            return
        if k is None:     # full materialization (iteration fallback)
            self._built = True
            order = self._order()
            sr = self._c_read[order]
            cut = np.nonzero(np.diff(sr))[0] + 1
            for grp in np.split(order, cut):
                ki = int(self._c_read[grp[0]])
                if not dict.__contains__(self, ki):
                    super().setdefault(ki, []).extend(grp.tolist())
            return
        k = int(k)
        if dict.__contains__(self, k):
            return
        order = self._order()
        lo = np.searchsorted(self._sorted, k, "left")
        hi = np.searchsorted(self._sorted, k, "right")
        if hi > lo:
            super().setdefault(k, []).extend(order[lo:hi].tolist())

    def _order(self):
        o = getattr(self, "_ord", None)
        if o is None:
            o = np.argsort(self._c_read, kind="stable")
            self._ord = o
            self._sorted = self._c_read[o]
        return o

    def get(self, k, default=None):
        self._build(k)
        return super().get(k, default)

    def setdefault(self, k, default=None):
        self._build(k)
        return super().setdefault(k, default)

    def __getitem__(self, k):
        self._build(k)
        return super().__getitem__(k)

    def __contains__(self, k):
        self._build(k)
        return super().__contains__(k)

    def keys(self):
        self._build()
        return super().keys()

    def items(self):
        self._build()
        return super().items()

    def __iter__(self):
        self._build()
        return super().__iter__()

    def values(self):
        self._build()
        return super().values()

    def __len__(self):
        self._build()
        return super().__len__()

    def pop(self, k, *default):
        self._build(k)
        return super().pop(k, *default)

    # NOTE: only the overridden methods above are part of the supported
    # API; truthiness (`if by_read:`) reflects only what has materialized
    # so far — use len() or an explicit key probe instead.


class LazyFin:
    """fin_info list materializing band windows on demand (a slice of the
    joined text) instead of copying one window per candidate up front."""

    __slots__ = ("_res", "_lens", "_joined", "_K", "_over", "_n")

    def __init__(self, res, lens, joined, K):
        self._res, self._lens, self._joined, self._K = res, lens, joined, K
        self._over: dict[int, tuple | None] = {}
        self._n = len(res.c_read)

    def __len__(self):
        return self._n

    def __getitem__(self, ci):
        if ci in self._over:
            return self._over[ci]
        res = self._res
        if ci >= len(res.c_read) or not res.c_interior[ci]:
            return None
        rl = int(self._lens[res.c_read[ci]])
        ws = int(res.c_ws[ci])
        return ("band", int(res.c_bi[ci]), int(res.c_bk[ci]),
                self._joined[ws : ws + rl + self._K], ws)

    def set(self, ci, v):
        self._over[ci] = v

    def append(self, v):
        self._over[self._n] = v
        self._n += 1


class FastSoA:
    """Vectorized results of the ungapped fast-commit path (_finish_fast):
    everything needed to materialize an AlnRec — or emit a SAM line — with
    no per-read Python work at commit time (ref: the role of AlnRes +
    staged SAM flush, aligner_result.h:792, but array-of-columns instead
    of object-per-read)."""

    __slots__ = ("filled", "tidx", "fw", "ref_id", "pos", "score",
                 "sec_has", "sec", "mapq", "nm", "rl",
                 "mm_split", "mm_cols", "mm_ref", "_mm_builder", "pair")

    _BASES = "ACGTN"

    def __init__(self):
        self._mm_builder = None
        self.mm_split = None
        self.pair = None   # concordant-pair column dict (paired fast path)

    def _ensure_mm(self):
        """Mismatch detail is derived lazily (one vectorized pass) the
        first time an MD string is requested — count-only consumers
        (bench, summaries) never pay for it."""
        if self.mm_split is None:
            self.mm_split, self.mm_cols, self.mm_ref = self._mm_builder()

    def md(self, t: int) -> str:
        """MD:Z string of compact row t."""
        self._ensure_mm()
        rl = int(self.rl[t])
        lo, hi = int(self.mm_split[t]), int(self.mm_split[t + 1])
        if lo == hi:
            return str(rl)
        parts = []
        last = 0
        for k in range(lo, hi):
            p = int(self.mm_cols[k])
            parts.append(str(p - last))
            parts.append(self._BASES[min(int(self.mm_ref[k]), 4)])
            last = p + 1
        parts.append(str(rl - last))
        return "".join(parts)

    def fill(self, rec: "AlnRec", i: int):
        t = int(self.tidx[i])
        rl = int(self.rl[t])
        rec.aligned = True
        rec.fw = bool(self.fw[t])
        rec.ref_id = int(self.ref_id[t])
        rec.pos = int(self.pos[t])
        rec.score = int(self.score[t])
        rec.secbest = int(self.sec[t]) if self.sec_has[t] else None
        rec.mapq = int(self.mapq[t])
        rec.cigar = f"{rl}M"
        rec.nm = rec.xm = int(self.nm[t])
        rec.xo = rec.xg = rec.xn = 0
        rec.md = self.md(t)
        if rec.fw:
            rec.seq, rec.qual = rec.orig_seq, rec.orig_qual
        else:
            rec.seq = dna.revcomp_ascii(rec.orig_seq)
            rec.qual = rec.orig_qual[::-1]
        if self.pair is not None:
            p = self.pair
            rec.paired = True
            rec.mate1 = p["mate1"]
            rec.proper = True
            rec.yt = "CP"
            rec.mate_aligned = True
            rec.mate_fw = bool(p["mate_fw"][t])
            rec.mate_ref_id = int(p["mate_ref_id"][t])
            rec.mate_pos = int(p["mate_pos"][t])
            rec.tlen = int(p["tlen"][t])
            rec.ys = int(p["ys"][t])


class LazyRecs:
    """Per-read AlnRec sequence materialized on first access. The fused
    fast path keeps its results as arrays (FastSoA); an AlnRec object is
    built only for reads something actually touches (slow paths, the
    paired aligner, record-by-record SAM emission)."""

    __slots__ = ("batch", "filtered", "qc", "_cache", "soa", "B", "ym_mask",
                 "metrics", "yf_codes")

    def __init__(self, batch, filtered, qc_fail, yf_codes=None):
        self.B = len(batch.names)
        self.batch = batch
        self.filtered = filtered
        self.qc = qc_fail
        # per-read filter-reason code 0..3 = LN/NS/SC/QC (ref: AlnFlags::
        # printYF priority, aligner_result.cpp:1095-1100)
        self.yf_codes = yf_codes
        self._cache: dict[int, AlnRec] = {}
        self.soa: FastSoA | None = None
        self.ym_mask = None   # per-read repetitive flag under -M (YM:i)
        self.metrics = {}     # per-batch PerfMetrics counters (--met TSV)

    def cache_items(self):
        """(i, rec) pairs materialized so far (slow-path records)."""
        return self._cache.items()

    def __len__(self):
        return self.B

    def __getitem__(self, i):
        if not 0 <= i < self.B:
            raise IndexError(i)
        rec = self._cache.get(i)
        if rec is None:
            b = self.batch
            rec = AlnRec(name=b.names[i], aligned=False)
            rec.seq = rec.orig_seq = b.raw_seq[i]
            rec.qual = rec.orig_qual = b.raw_qual[i]
            if b.comments is not None:
                rec.comment = b.comments[i]
            if b.origs is not None:
                rec.orig_rec = b.origs[i]
            if getattr(b, "bam_tags", None):
                rec.preserved = b.bam_tags[i]
            if self.filtered[i]:
                rec.filtered = True
                if self.yf_codes is not None:
                    rec.yf = ("LN", "NS", "SC", "QC")[int(self.yf_codes[i])]
                elif self.qc is not None and self.qc[i]:
                    rec.yf = "QC"
            if self.soa is not None and self.soa.filled[i]:
                self.soa.fill(rec, i)
            if self.ym_mask is not None and self.ym_mask[i]:
                rec.ym = True
            self._cache[i] = rec
        return rec

    def n_aligned(self) -> int:
        n = 0
        if self.soa is not None:
            n += int(self.soa.filled.sum())
        for i, r in self._cache.items():
            in_soa = self.soa is not None and self.soa.filled[i]
            if r.aligned and not in_soa:
                n += 1
        return n


class ConcatRecs:
    """Concatenated view over the per-half results of a split batch (the
    big-index capacity degradation): behaves like the underlying record
    sequences."""

    __slots__ = ("parts", "_starts")

    def __init__(self, parts):
        self.parts = parts
        self._starts = []
        n = 0
        for p in parts:
            self._starts.append(n)
            n += len(p)

    def __len__(self):
        return self._starts[-1] + len(self.parts[-1]) if self.parts else 0

    def __getitem__(self, i):
        for k in range(len(self.parts) - 1, -1, -1):
            if i >= self._starts[k]:
                return self.parts[k][i - self._starts[k]]
        raise IndexError(i)

    def __iter__(self):
        for p in self.parts:
            yield from p

    def n_aligned(self) -> int:
        return sum(p.n_aligned() if hasattr(p, "n_aligned")
                   else sum(r.aligned for r in p) for p in self.parts)

    def n_concordant(self) -> int:
        return sum(p.n_concordant() for p in self.parts)


def revcomp_batch(seqs, quals, lens):
    """Vectorized per-row reverse complement respecting lengths."""
    B, L = seqs.shape
    j = np.arange(L)[None, :]
    src = lens[:, None] - 1 - j
    valid = src >= 0
    src_c = np.clip(src, 0, L - 1)
    rc = np.where(valid, dna.COMP[seqs[np.arange(B)[:, None], src_c]], 5)
    rq = np.where(valid, quals[np.arange(B)[:, None], src_c], 0)
    return rc.astype(np.uint8), rq.astype(np.int32)


def pack_rect(reads, refs, min_rows=1, min_cols=1):
    """Pad rectangle-DP problems into `sw_align_batch`'s arrays: problem t
    aligns reads[t], a (codes, mismatch penalties) pair, against the
    reference window refs[t]; a None read leaves its row empty. Rows pad
    to a multiple of 64 and windows to one of 128, at least min_rows and
    min_cols. -> (rd, mm, ref, read lengths, window lengths)."""
    lq = max([min_rows] + [len(r[0]) for r in reads if r is not None])
    wmax = max([min_cols] + [len(w) for r, w in zip(reads, refs)
                             if r is not None])
    lq = -(-lq // 64) * 64
    wmax = -(-wmax // 128) * 128
    n = len(reads)
    rd_m = np.full((n, lq), 5, np.uint8)
    mm_m = np.zeros((n, lq), np.int32)
    ref_m = np.full((n, wmax), 4, np.uint8)
    clens = np.zeros(n, np.int32)
    wlens = np.zeros(n, np.int32)
    for t, (r, w) in enumerate(zip(reads, refs)):
        if r is None:
            continue
        rl = len(r[0])
        rd_m[t, :rl], mm_m[t, :rl] = r
        clens[t] = rl
        ref_m[t, : len(w)] = w
        wlens[t] = len(w)
    return rd_m, mm_m, ref_m, clens, wlens


class Trace(NamedTuple):
    """A candidate's traceback (`UnpairedAligner.trace_candidates`): its
    edits, the window column and read row where it starts, the row after
    its end, whether a traceback pass ran (the --met Bt counters; not for
    a winner on the pure diagonal) and whether the CUDA kernel ran it."""
    edits: list
    start_col: int
    read_start: int
    read_end: int
    tb: bool
    card: bool = False


@dataclass(eq=False)
class BatchState:
    """One batch's search state from collect to selection, with the same
    fields on the fused path (`UnpairedAligner._build_state`) and the host
    path (`_collect_host`). Candidate ci is cands[ci] = (read, fw, diag),
    with its DP score best[ci] (NEG_INF: dropped), its end end_joined[ci]
    in joined space, fin_info[ci] = (kind, end row, end column, window,
    window start) or None where no DP ran (kind "band": a band of the
    joined text; "rectr": a reference-space window, its start (ref id,
    offset); "rect": a joined-text window of mate rescue), and once traced
    traces[ci], its Trace. Built without candidates, it has none."""
    B: int
    recs: object            # LazyRecs (fused path) or a list of AlnRec
    read_row: Callable      # (read, fw) -> (codes, mismatch penalties)
    lens: np.ndarray
    minsc: np.ndarray
    perfect: np.ndarray
    nceil: np.ndarray
    exact_mult: np.ndarray
    filtered: np.ndarray
    seeds_failed_r0: np.ndarray
    fw_seqs: np.ndarray
    cands: object = field(default_factory=list)   # or ArrayCands
    best: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    end_joined: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    fin_info: object = field(default_factory=list)  # or LazyFin
    by_read: dict = field(default_factory=dict)   # read -> its candidates
    res: object = None      # the fused path's BatchResult; None on the host
    metrics: dict = field(default_factory=dict)   # --met counters
    traces: dict = field(default_factory=dict)    # ci -> Trace

    def read_arrays(self, ci):
        """(codes, mismatch penalties, length) of candidate ci's read on
        its strand."""
        i, fw, _ = self.cands[ci]
        rd, mm = self.read_row(i, fw)
        return rd, mm, int(self.lens[i])

    def add_rescued(self, hits):
        """Append mate rescue's hits as candidates: each (read, fw, window
        start in joined space, score, end row, end column, window)."""
        if not hits:
            return
        for i, fw, wl, _, bi, bj, window in hits:
            self.by_read.setdefault(i, []).append(len(self.cands))
            self.cands.append((i, fw, wl + bj - int(self.lens[i]) + 1))
            self.fin_info.append(("rect", bi, bj, window, wl))
        self.best = np.append(self.best, [h[3] for h in hits])
        self.end_joined = np.append(self.end_joined,
                                    [h[2] + h[5] for h in hits])


class UnpairedAligner:
    def __init__(self, index: FmIndex, scoring: Scoring | None = None,
                 policy: SearchPolicy | None = None, *, device=None,
                 nofw: bool = False, norc: bool = False, mesh=None,
                 force_big: bool | None = None):
        """device: where the device work runs ('cpu' runs the plain torch
        versions of the kernels, 'cuda' the CUDA kernels). mesh: a 'dp'
        mesh (parallel/mesh.py) over which the fused pipeline runs, reads
        sharded and the index replicated on each of its devices; `device`
        is then its first device (the default), where the FM directions,
        the host path and the rect DP stay, as the JAX package leaves
        everything but the sharded call on its default device. A genome
        past ops/fm.BIG_THRESHOLD (~2.1 Gbp) takes the big-index device
        path (uint32 rows, sampled SA; ref: the wrapper's small/large
        index auto-pick, bowtie2-server:448-470); force_big=True takes it
        on a small genome too, where the small path on the same index is
        its oracle."""
        if mesh is not None and device is None:
            device = mesh.devices[0]
        if device is None:
            raise TypeError("UnpairedAligner needs a device or a mesh")
        self.nofw = nofw
        self.norc = norc
        self.idx = index
        self.device = torch.device(device)
        self.mesh = mesh
        self.sc = scoring or Scoring.default_e2e()
        self.pol = policy or SearchPolicy()
        self.band = band_for(self.pol.maxhalf)
        # run boundaries in joined space for window clipping
        self._run_starts = index.run_joined_start
        self._run_ends = np.append(index.run_joined_start[1:], index.n)
        self.sw_cfg = SwConfig(
            ma=self.sc.match_bonus, npen=self.sc.np_pen,
            rdg_open=self.sc.read_gap_open, rdg_ext=self.sc.read_gap_extend,
            rfg_open=self.sc.ref_gap_open, rfg_ext=self.sc.ref_gap_extend,
            gapbar=self.sc.gapbar, local=self.sc.local)
        self.big = (index.n + 1 >= dfm.BIG_THRESHOLD if force_big is None
                    else bool(force_big))
        self.dev = dfm.to_device(index.fw, self.device, big=self.big)
        self.dev_mirror = (dfm.to_device(index.mirror, self.device,
                                         big=self.big)
                           if index.mirror is not None else None)
        # fused device pipeline (align/candgen.py) — the fast path; an
        # index without its mirror direction takes the host path
        self.candgen = None
        if self.dev_mirror is not None:
            self.candgen = CandGen(self.dev, self.dev_mirror, index,
                                   self.pol, self.sw_cfg, self.band,
                                   self.device, mesh=mesh)
        self._rect_stream = None   # CUDA stream of the rect DPs (rect_stream)
        self.dp_log = None   # file handle: log DP problems (ref: --dp-log)
        # cumulative backtrace counters for the --met TSV (ref: SSEMetrics
        # bt/btfail/btsucc/btcell, aligner_sw_common.h:292-295; these count
        # the commits of traced candidates: attempts, rejects, commits, and
        # path cells walked). Only _commit changes them and tb_card.
        self.bt_ctr = {"bt": 0, "btfail": 0, "btsucc": 0, "btcell": 0}
        # of those attempts, the ones whose trace the CUDA kernel ran, for
        # the up.select and pe.decide spans' tb_card
        self.tb_card = 0
        # per-read-length gap budget (gap_budget)
        self._gapclass_cache: dict[int, int] = {}
        self.want_met = False   # --met consumer attached: collect the
        #                         DP-shape columns (host numpy, ~1 ms/batch)
        self.qc_filter = False  # --qc-filter: honor qseq QC flags
        self.mapq_v = 2      # --mapq-v (ref: bt2_search.cpp:513 mapqv=2)

    # ---- seed schedule (ref: bt2_search.cpp:3848-3870, aligner_seed.cpp:498)

    def seed_offsets(self, rdlen: int, roundi: int = 0,
                     boost: bool = False, nrounds: int | None = None
                     ) -> list[int]:
        """Seed depths for one reseeding round (ref: bt2_search.cpp:3848-3870:
        offset = interval*round/nrounds; aligner_seed.cpp:523-529: nseeds =
        1 + (len-off-L)/interval when len-off > L). With boost (paired mode,
        both mates unfiltered) the interval grows 20% (bt2_search.cpp:3394)."""
        pol = self.pol
        interval = max(1, pol.interval.f_int(rdlen))
        if boost:
            interval = max(1, int(interval * 1.2 + 0.5))
        L = pol.seed_len
        if interval <= roundi:
            return []
        nr = nrounds if nrounds is not None else pol.n_seed_rounds
        off = (interval * roundi) // nr
        if off > 0 and L + off > rdlen:
            return []
        nseeds = 1
        if rdlen - off > L:
            nseeds += (rdlen - off - L) // interval
        return [off + i * interval for i in range(nseeds)]

    # ---- the batch pipeline ----

    def _filters(self, batch: ReadBatch) -> dict:
        """Per-read length-derived limits and the three read filters
        (ref: bt2_search.cpp:3323-3352): length 0, too many Ns, perfect
        score below the minimum."""
        lens = batch.lens
        L = batch.seqs.shape[1]
        n_counts = ((batch.seqs > 3)
                    & (np.arange(L)[None, :] < lens[:, None])).sum(1)
        nceil = per_len(self.sc.n_ceil_for, lens)
        minsc = per_len(self.sc.score_min_for, lens)
        perfect = per_len(self.sc.perfect_score, lens)
        return dict(nceil=nceil, minsc=minsc, perfect=perfect,
                    len_bad=lens == 0, n_bad=n_counts > nceil,
                    sc_bad=perfect < minsc)

    def compute_filtered(self, batch: ReadBatch) -> np.ndarray:
        """Per-read filter mask without running the pipeline."""
        f = self._filters(batch)
        return f["len_bad"] | f["n_bad"] | f["sc_bad"]

    def align_batch(self, batch: ReadBatch) -> list[AlnRec]:
        return self.align_wait(self.align_async(batch))

    # -- async two-phase API: dispatch device work for batch i+1 while the
    # host finishes batch i (double-buffering; ref: the reference's
    # readahead/worker overlap, pat.h:1558) --

    def align_async(self, batch: ReadBatch):
        return (batch, self.collect_async(batch))

    def align_wait(self, handle):
        batch, chandle = handle
        try:
            st = self.collect_wait(chandle)
        except BigCapacityError:
            # big-index degradation: halve the batch and retry (a smaller
            # batch gets proportionally smaller capacities, but the demand
            # of the pathological reads stays, so the 16x escalation
            # succeeds at some width)
            B = len(batch)
            if B < 2:
                raise
            mid = B // 2
            return ConcatRecs([self.align_batch(batch.slice(0, mid)),
                               self.align_batch(batch.slice(mid, B))])
        B = st.B
        # khits == 1 never yields extra records: run the general path only
        # for the reads the fast commit leaves and return the lazy view —
        # readers that only need counts/arrays never build AlnRec objects
        out = None if self.pol.khits == 1 else []
        with trace.span("up.select", reads=B) as sp:
            bt0, card0 = self.bt_ctr["bt"], self.tb_card
            todo = range(B)
            if out is None and st.res is not None:
                todo = np.nonzero(~self._finish_fast(st))[0]
            for i in todo:
                extras = self.select_unpaired(st, i)
                if out is not None:
                    out.append(st.recs[i])
                    out.extend(extras)
            # tb: the band and rect tracebacks of the batch; tb_card:
            # those the CUDA kernel ran
            sp.set(slow=len(todo), tb=self.bt_ctr["bt"] - bt0,
                   tb_card=self.tb_card - card0)
        return st.recs if out is None else out

    # ---- collect: fused device path with host fallback ----

    def collect(self, batch: ReadBatch, boost=None, seed_skip=None):
        return self.collect_wait(self.collect_async(batch, boost, seed_skip))

    def collect_async(self, batch: ReadBatch, boost=None, seed_skip=None):
        """Dispatch the device-side search for a batch (non-blocking).
        Returns a handle tagged "fused" or "host"; the host path runs at
        collect_wait."""
        if self.candgen is None or self.pol.khits > _FUSED_KMAX:
            # -a (and -k beyond _FUSED_KMAX) needs unbounded per-range
            # enumeration — the host path chunks its resolves; -k up to
            # _FUSED_KMAX runs fused with E scaled to k (CandGen.dispatch)
            if self.big:
                raise NotImplementedError(
                    "a big index takes only the fused device path (the "
                    "host path needs the full SA on the device): -a, -k "
                    "above 1024 and a mirror-less index are small-index "
                    "only, as in the reference package")
            return ("host", batch, boost, seed_skip)
        lens = batch.lens
        f = self._filters(batch)
        nceil, minsc, perfect = f["nceil"], f["minsc"], f["perfect"]
        len_bad, n_bad, sc_bad = f["len_bad"], f["n_bad"], f["sc_bad"]
        filtered = len_bad | n_bad | sc_bad
        yf_codes = np.where(len_bad, 0,
                            np.where(n_bad, 1, np.where(sc_bad, 2, 3)))
        if self.qc_filter and batch.qc_fail is not None:
            filtered = filtered | batch.qc_fail
        active = ~filtered
        h = self.candgen.dispatch(
            batch.seqs, batch.quals, lens,
            active & (not self.nofw), active & (not self.norc),
            minsc, self.sc.mm_penalties(), perfect=perfect,
            boost=boost, seed_skip=seed_skip)
        meta = dict(lens=lens, filtered=filtered, minsc=minsc,
                    perfect=perfect, nceil=nceil, seed_skip=seed_skip,
                    yf_codes=yf_codes)
        return ("fused", batch, boost, seed_skip, h, meta)

    def collect_wait(self, handle):
        if handle[0] == "host":
            _, batch, boost, seed_skip = handle
            return self._collect_host(batch, boost, seed_skip)
        _, batch, boost, seed_skip, h, meta = handle
        res = self.candgen.fetch(h)
        if res.overflow:
            # capacity escalation: re-run the same batch with 2x, then
            # 4x set sizes (and 16x for a big index) before giving up to
            # the (much slower) host path, or for a big index to the batch
            # split of align_wait (ref: the reference's graceful
            # huge-range handling via RowSampler, aligner_sw_driver.h:179).
            # Successful escalations become STICKY (CandGen.fetch) so a
            # repetitive workload sizes itself once and stays there
            # instead of re-running every batch; a multiple at or below
            # the one the batch already ran at (the sticky one) is not
            # run again, since it overflows again. The `up.escalate`
            # span holds the re-runs and the host path: `mult`, the last
            # multiple run; `host`, the reads the host path took.
            tried = h[-1]
            with trace.span("up.escalate", reads=len(batch)) as sp:
                active = ~meta["filtered"]
                for mult in ((2, 4, 16) if self.big else (2, 4)):
                    if mult <= tried:
                        continue
                    tried = mult
                    res = self.candgen.fetch(self.candgen.dispatch(
                        batch.seqs, batch.quals, meta["lens"],
                        active & (not self.nofw), active & (not self.norc),
                        meta["minsc"], self.sc.mm_penalties(),
                        perfect=meta["perfect"], boost=boost,
                        seed_skip=seed_skip, size_mult=mult))
                    if not res.overflow:
                        break
                host = res.overflow and not self.big
                sp.set(mult=tried, host=len(batch) if host else 0)
                if host:
                    return self._collect_host(batch, boost, seed_skip)
            if res.overflow:
                raise BigCapacityError(
                    "big-index candidate capacity exceeded at 16x")
        st = self._build_state(batch, res, meta)
        if self.dp_log is not None:
            # --dp-log on the fused path: the DP problems are the banded
            # windows (ref: the --dp-log problem dump, bt2_search.cpp:3117
            # -> bt2_dp.cpp replay)
            for ci in range(len(st.cands)):
                fi = st.fin_info[ci]
                if fi is None:
                    continue
                rd, _, rl = st.read_arrays(ci)
                self.dp_log.write(dna.decode(rd[:rl]) + "\t"
                                  + dna.decode(fi[3]) + "\n")
        return st

    def _build_state(self, batch: ReadBatch, res, meta):
        """Package fused-pipeline outputs as the per-batch state consumed by
        selection/finish and the paired aligner (array-backed, lazy)."""
        B, L = batch.seqs.shape
        lens = meta["lens"]
        filtered = meta["filtered"]
        qc = (batch.qc_fail if self.qc_filter and batch.qc_fail is not None
              else None)
        recs = LazyRecs(batch, filtered, qc, meta.get("yf_codes"))

        fw_seqs, fw_quals = batch.seqs, batch.quals
        # rc/penalty rows are slow-path-only and PER-READ lazy: the whole-
        # batch [B, L] revcomp + penalty matrices cost ~200 ms at B=32k
        # while the slow path touches a handful of reads per batch
        mmtab_h = self.sc.mm_penalties()
        row_cache: dict = {}

        def _read_row(i, is_fw):
            key = (int(i), bool(is_fw))
            hit = row_cache.get(key)
            if hit is None:
                rl = int(lens[i])
                if is_fw:
                    s = fw_seqs[i, :rl]
                    q = fw_quals[i, :rl]
                else:
                    s = dna.COMP[fw_seqs[i, :rl]][::-1]
                    q = fw_quals[i, :rl][::-1]
                hit = (np.ascontiguousarray(s),
                       mmtab_h[np.clip(q, 0, 255)].astype(np.int32))
                row_cache[key] = hit
            return hit

        # -M repetitive flag (ref: ReportingState::areDone counting all
        # valid alignments, aln_sink.cpp:322-328). Candidate granularity is
        # (lane, diag) pre-(strand,end) suppression — a slight overcount in
        # rare multi-diagonal-same-end cases; the reference's own count is
        # discovery-order-truncated, so exact parity of the flag is
        # undefined anyway. Not printed in default SAM (print_ym is never
        # enabled by the reference CLI either, bt2_search.cpp:418).
        if self.pol.msample and self.pol.mhits > 0 and len(res.c_read):
            okc = res.c_interior & (
                res.c_score >= meta["minsc"][res.c_read])
            cnts = np.bincount(res.c_read[okc], minlength=B)
            recs.ym_mask = ((cnts > self.pol.mhits)
                            | (res.exact_mult > self.pol.mhits))

        # --met TSV counters from the packed output's counter row (ref: the
        # PerfMetrics merge, bt2_search.cpp:3229-3248): SeedSearch = seed
        # lookups, NRange = hit ranges, NElt = resolved elements, DPEx =
        # interior banded problems, Ungapped = device-certified winners
        ctr = res.counters.sum(axis=0)
        n_act = int((~filtered).sum())
        recs.metrics = metrics = dict(
            seed_searches=int(ctr[5]), n_range=int(ctr[4]),
            n_elt=int(ctr[1]), dp_ex=int(ctr[6]),
            ungapped_succ=int(ctr[7]),
            ungapped_fail=max(0, int(ctr[6]) - int(ctr[7])),
            exact_attempts=2 * n_act,
            exact_succ=int((res.exact_mult > 0).sum()))
        # DP problem-shape columns (ref: tallyGappedDp,
        # aligner_sw_common.h:246-251, classed by the most gaps the score
        # budget allows, and SSEMetrics col/cell and dpsucc/dpfail,
        # bt2_search.cpp:2440-2480): each interior candidate is one banded
        # problem of rl columns x band-width cells. Host numpy over the
        # candidate arrays, only when a --met consumer is attached
        if self.want_met and len(res.c_read):
            intc = res.c_interior
            dpl = lens[res.c_read[intc]].astype(np.int64)
            if dpl.size:
                uls, inv = np.unique(dpl, return_inverse=True)
                mx = np.array([self.gap_budget(int(u)) for u in uls],
                              np.int64)[inv]
                ncols = int(dpl.sum())
                succ = int((res.c_score[intc]
                            >= meta["minsc"][res.c_read[intc]]).sum())
                metrics.update(
                    dp_lt10=int((mx < 10).sum()), dp_lt5=int((mx < 5).sum()),
                    dp_lt3=int((mx < 3).sum()), dp_col=ncols,
                    dp_cell=ncols * self.band, dp_succ=succ,
                    dp_fail=int(dpl.size) - succ)

        cands = ArrayCands(res.c_read, res.c_fw, res.c_diag)
        best = np.where(res.c_interior, res.c_score, NEG_INF).astype(np.int64)
        end_joined = np.where(res.c_interior, res.c_end, -1).astype(np.int64)
        # by_read is only consulted on the slow path (khits>1, rect/gapped
        # fallbacks, paired aligner) — build it lazily to keep the common
        # khits==1 path free of the O(C) Python loop
        by_read = LazyByRead(res.c_read)
        fin_info = LazyFin(res, lens, self.idx.joined, self.band)
        st = BatchState(
            B=B, recs=recs, cands=cands, best=best, end_joined=end_joined,
            fin_info=fin_info, by_read=by_read, read_row=_read_row,
            lens=lens, minsc=meta["minsc"], perfect=meta["perfect"],
            nceil=meta["nceil"], exact_mult=res.exact_mult.astype(np.int64),
            filtered=filtered, seeds_failed_r0=res.seeds_failed_r0,
            fw_seqs=fw_seqs, res=res, metrics=metrics)
        # run host rectangle DP for candidates whose band window crosses an
        # unambiguous-run boundary (ref: dp_framer.cpp:81 trimming)
        rect_ids = np.nonzero(~res.c_interior)[0]
        if len(rect_ids):
            self._rect_dp(st, rect_ids)
        # exact-only (seed_skip) reads keep only perfect-score candidates —
        # the device applied this to its selection; mirror it for the host
        # slow paths (ref: seed_skip semantics, bt2_search.cpp:3888-3909)
        ss = meta.get("seed_skip")
        if ss is not None:
            ss = np.asarray(ss, bool)
            if ss.any():
                # keep perfect hits AND ungapped full-length <=1-sub hits
                # (the up-front exact + 1mm stages run seed-free in the
                # reference — see candgen stage 7)
                drop = (ss[res.c_read]
                        & (st.best != meta["perfect"][res.c_read])
                        & ~(res.c_ungapped & (res.c_nm <= 1)))
                st.best[drop] = NEG_INF
        return st

    def apply_seed_skip(self, st, mask) -> None:
        """Host-side application of the paired seed_skip rule for reads in
        `mask` (ref: bt2_search.cpp:3888/3909 — mate-1 round-0 seed failure
        aborts mate-2's seed stage, leaving only the up-front exact/1mm
        stages). Applying it HERE, after an unconditional mate-2 dispatch,
        removes the st1-fetch -> st2-dispatch data dependency so both
        mates' device work runs back-to-back (the paired-throughput
        critical path). Mirrors the device rule (candgen stage 7): keep
        candidates scoring `perfect` (exactSweep's set) or ungapped with
        <= 1 substitution (oneMmSearch's set); recompute the per-read
        best/secbest selection exactly as the device does (max score ->
        leftmost diag -> fw preferred -> largest candidate index)."""
        res = st.res
        mask = np.asarray(mask, bool)
        if res is None:
            # host-path state: candidates carry no per-candidate nm/ungapped
            # detail; keep only perfect-score hits (st.best is the only
            # selection input downstream)
            for i in np.nonzero(mask)[0]:
                for ci in st.by_read.get(int(i), []):
                    if st.best[ci] != st.perfect[i]:
                        st.best[ci] = NEG_INF
            return
        for i in np.nonzero(mask)[0]:
            i = int(i)
            ids = np.asarray(st.by_read.get(i, []), np.int64)
            if not len(ids):
                continue
            allowed = ((st.best[ids] == st.perfect[i])
                       | (res.c_ungapped[ids] & (res.c_nm[ids] <= 1)))
            st.best[ids[~allowed]] = NEG_INF
            sel = ids[allowed & res.c_interior[ids]
                      & (st.best[ids] >= st.minsc[i])]
            if not len(sel):
                res.best_ci[i] = -1
                res.best_sc[i] = NEG_INF
                res.sec_sc[i] = NEG_INF
                continue
            sc = st.best[sel]
            m1 = sc == sc.max()
            dg = res.c_diag[sel]
            m2 = m1 & (dg == dg[m1].min())
            fwv = res.c_fw[sel].astype(np.int64)
            m3 = m2 & (fwv == fwv[m2].max())
            bci = int(sel[m3].max())
            res.best_ci[i] = bci
            res.best_sc[i] = st.best[bci]
            dist = (res.c_end[sel] != res.c_end[bci]) | \
                   (res.c_fw[sel] != res.c_fw[bci])
            res.sec_sc[i] = int(sc[dist].max()) if dist.any() else NEG_INF

    def rect_stream(self):
        """Context of the host-driven rectangle DPs (run-boundary
        candidates, mate rescue): on CUDA a side stream, because on the
        main stream their copies from pageable memory would wait for the
        fused batches still in flight there; on the CPU nothing."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._rect_stream is None:
            self._rect_stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._rect_stream)

    def _rect_frame(self, rl, diag, nc):
        """REFERENCE-space rectangle window for a run-boundary candidate
        (a read of length rl on diagonal diag, N ceiling nc), with N leeway
        (ref: dp_framer.cpp:81-125 frameSeedExtensionRect): the window is
        built from the full reference INCLUDING ambiguous bases, so a read
        may span a short N gap between unambiguous runs, and up to nceil
        columns may lie beyond the reference ends (padded N by
        get_ref_stretch). Returns (rid, wl, wr) or None."""
        mg2 = 2 * self.pol.maxhalf
        ri = np.searchsorted(self._run_starts, max(diag, 0),
                             side="right") - 1
        ri = min(max(ri, 0), len(self._run_starts) - 1)
        rid = int(self.idx.run_ref_id[ri])
        roff = int(self.idx.run_ref_off[ri]) + (
            diag - int(self._run_starts[ri]))
        maxns = nc - 1 if nc >= rl else nc   # dp_framer.cpp:106-107
        reflen = int(self.idx.ref_lens[rid])
        wl = max(roff - mg2, -maxns)
        wr = min(roff + rl - 1 + mg2, reflen + maxns - 1) + 1
        return (rid, wl, wr) if wr > wl else None

    def _rect_dp(self, st, rect_ids):
        """Host rectangle-DP path for run-boundary candidates (rare),
        framed in reference space with N leeway (_rect_frame)."""
        jobs = []
        for ci in rect_ids:
            i, _, diag = st.cands[int(ci)]
            fr = self._rect_frame(int(st.lens[i]), diag, int(st.nceil[i]))
            if fr is not None:
                jobs.append((int(ci),) + fr)
        if not jobs:
            return
        rd_m, mm_m, ref_m, clens, wlens = pack_rect(
            [st.read_arrays(ci)[:2] for ci, _, _, _ in jobs],
            [self.idx.get_ref_stretch(rid, wl, wr - wl)
             for _, rid, wl, wr in jobs])
        # Host numpy engine for a few jobs, kept from the JAX package,
        # where a device call here queued behind the in-flight fused
        # batches; the rect side stream (rect_stream) removed that reason
        # on the card, and the fork waits for a cell with run-boundary
        # candidates to be judged. Rect jobs are rare (genome-edge/run-
        # boundary windows); above 128 of them the rectangle DP goes to
        # the device (the CUDA kernel of ops/csrc/sw.cu on the card).
        if len(jobs) <= 128:
            from ..ops.sw import sw_align_numpy_batch
            r_best, r_bi, r_bj = sw_align_numpy_batch(
                rd_m, clens, mm_m, ref_m, wlens, self.sw_cfg)
        else:
            with self.rect_stream():
                r_best, r_bi, r_bj = sw_align_batch(
                    rd_m, clens, mm_m, ref_m, wlens, self.sw_cfg,
                    device=self.device)
        for ri_, (ci, rid, wl, wr) in enumerate(jobs):
            st.best[ci] = int(r_best[ri_])
            st.end_joined[ci] = wl + int(r_bj[ri_])
            st.fin_info.set(ci, ("rectr", int(r_bi[ri_]), int(r_bj[ri_]),
                                 ref_m[ri_, : wr - wl], (rid, wl)))

    def _finish_fast(self, st) -> np.ndarray:
        """Vectorized commit of the device-selected best alignment per read
        (khits == 1). Returns the per-read handled mask; reads needing the
        general path (rect candidates, gapped/local traceback fallbacks that
        fail) stay unhandled."""
        res = st.res
        B = st.B
        ok_reads = ~res.has_rect & ~st.filtered
        handled = ok_reads & (res.best_ci < 0)   # unaligned: rec already set
        w = np.nonzero(ok_reads & (res.best_ci >= 0))[0]
        if not len(w):
            return handled
        # equal-score ties at distinct ends go through the general path for
        # per-read-RNG selection (ref: selectByScore shuffles equal-score
        # streaks, aln_sink.cpp:1577-1594)
        NEGH0 = NEG_INF // 2
        tie = ((res.sec_sc[w] > NEGH0)
               & (res.sec_sc[w] == res.best_sc[w]))
        w = w[~tie]
        if not len(w):
            return handled
        k = res.best_ci[w]
        fw_b = res.c_fw[k]
        ws = res.c_ws[k].astype(np.int64)
        bi = res.c_bi[k]
        bk = res.c_bk[k]
        score = res.c_score[k].astype(np.int64)
        rl = st.lens[w]
        cfg = self.sw_cfg

        # secbest per read (ref: AlnSetSumm secbest; second_best)
        NEGH = NEG_INF // 2
        has_sec = res.sec_sc[w] > NEGH
        exact_rule = (~has_sec) & self.exact_copies_hidden(st.exact_mult[w])

        # ungapped certification + NM computed ON DEVICE against the
        # gathered band (candgen stage 6) — no reference access here
        ungapped = (not cfg.local) & res.c_ungapped[k]
        jp = ws + bk                       # joined pos of alignment start
        ref_id, ref_off, _ = self.idx.joined_to_ref(jp)
        sec_eff = np.where(has_sec, res.sec_sc[w],
                           st.perfect[w]).astype(np.int64)
        mapqs = mapq_batch(self.mapq_v, score, sec_eff, has_sec | exact_rule,
                           st.minsc[w], st.perfect[w], self.sc.monotone)

        g = np.nonzero(~ungapped)[0]
        if len(g):
            # rare end-to-end, every winner in --local: gapped or local
            # winners, traced together (_finish_gapped)
            secs = [int(res.sec_sc[w[t]]) if has_sec[t]
                    else (int(st.perfect[w[t]]) if exact_rule[t] else None)
                    for t in g]
            ok = self._finish_gapped(st, w[g], score[g], secs)
            handled[w[g][ok]] = True

        # vectorized commit of the ungapped winners: store column arrays;
        # AlnRec objects materialize lazily (LazyRecs/FastSoA), and the
        # mismatch detail (MD) is only derived when something asks for it
        u = np.nonzero(ungapped)[0]
        if len(u):
            wu = w[u]
            soa = self.soa_from_best(
                st, wu, fw_b[u], ref_id[u], ref_off[u], score[u],
                (has_sec | exact_rule)[u],
                np.where(has_sec, res.sec_sc[w],
                         st.perfect[w]).astype(np.int64)[u],
                mapqs[u], res.c_nm[k][u], rl[u], jp[u])
            handled[wu] = True
            st.recs.soa = soa
        return handled

    def _finish_gapped(self, st, reads, scores, secs) -> np.ndarray:
        """Trace the fused winners of `reads` that the device did not
        certify ungapped, all in one `trace_candidates` call, and commit
        each (`finish_candidate`). Returns the [n] mask of the reads
        committed; a rejected read stays for the per-read loop."""
        cis = st.res.best_ci[reads].tolist()
        self.trace_candidates(st, cis, scores)
        return np.array([self.finish_candidate(st, i, ci, int(sc), sec)
                         for i, ci, sc, sec in zip(reads.tolist(), cis,
                                                   scores, secs)], bool)

    def trace_candidates(self, st, cis, scores) -> int:
        """Trace the candidates `cis` (scored `scores`) into st.traces,
        each once: a candidate already there is skipped. One on the pure
        diagonal (end-to-end, its score that diagonal's) takes the ungapped
        shortcut; the other band candidates go to one
        `banded_traceback_batch` call (the CUDA kernel on a card, on the
        rect side stream, which does not wait for the fused batches in
        flight; the numpy oracle on the CPU and wherever the kernel flags
        a problem); a rect candidate's traceback runs on the host. Returns
        the number of problems sent to the batch."""
        cfg, K = self.sw_cfg, self.band
        need = {}
        for ci, sc in zip(cis, scores):
            if ci in st.traces or ci in need:
                continue
            kind, bi, bk, window, _ = st.fin_info[ci]
            rd, mm, rl = st.read_arrays(ci)
            # the diagonal's start column; a band ends in the last row
            col, diag = ((bk, bi == rl - 1) if kind == "band"
                         else (bk - (rl - 1), bk >= rl - 1))
            if not cfg.local and diag and \
                    ungapped_score(rd, mm, window, col, cfg) == int(sc):
                st.traces[ci] = Trace(edits_from_ungapped(rd[:rl], window,
                                                          col),
                                      col, 0, rl, False)
            elif kind == "band":
                need[ci] = (rd, mm, rl, bi, bk, window)
            else:
                st.traces[ci] = Trace(*rect_traceback(rd[:rl], mm, window,
                                                      cfg, bi, bk),
                                      bi + 1, True)
        if not need:
            return 0
        probs = list(need.values())
        L = max(p[2] for p in probs)
        rd = np.zeros((len(probs), L), np.uint8)
        mm = np.zeros((len(probs), L), np.int32)
        band = np.full((len(probs), L + K), 4, np.uint8)
        for r, (s, q, rl, _, _, window) in enumerate(probs):
            rd[r, :rl], mm[r, :rl] = s, q
            band[r, : len(window)] = window
        lens, bi, bk = (np.array([p[k] for p in probs], np.int64)
                        for k in (2, 3, 4))
        with self.rect_stream():
            got, on_card = banded_traceback_batch(
                rd, mm, band, lens, bi, bk, cfg, K, device=self.device)
        for ci, p, tr, c in zip(need, probs, got, on_card):
            st.traces[ci] = Trace(*tr, p[3] + 1, True, bool(c))
        return len(need)

    def soa_from_best(self, st, wu, fw, ref_id, pos, score, sec_has, sec,
                      mapq, nm, rl, jp) -> FastSoA:
        """Assemble a FastSoA for the committed reads `wu` (column arrays
        already selected), with a lazy MD builder over the subset."""
        B = st.B
        soa = FastSoA()
        soa.filled = np.zeros(B, bool)
        soa.filled[wu] = True
        soa.tidx = np.full(B, -1, np.int32)
        soa.tidx[wu] = np.arange(len(wu), dtype=np.int32)
        soa.fw = fw
        soa.ref_id = ref_id
        soa.pos = pos
        soa.score = score
        soa.sec_has = sec_has
        soa.sec = sec
        soa.mapq = mapq
        soa.nm = nm
        soa.rl = rl
        joined = self.idx.joined
        fw_seqs = st.fw_seqs

        def build_mm():
            # derive per-read mismatch (column, ref base) lists for MD
            # in one vectorized pass over the committed subset
            Lm = int(rl.max(initial=1))
            cols = jp[:, None] + np.arange(Lm)
            refm = joined[np.clip(cols, 0, len(joined) - 1)]
            rd = fw_seqs[wu, :Lm].copy()
            rcm = ~fw
            if rcm.any():
                rr = rd[rcm]
                ll = rl[rcm]
                src = ll[:, None] - 1 - np.arange(Lm)[None, :]
                ok = src >= 0
                g = np.take_along_axis(rr, np.clip(src, 0, Lm - 1),
                                       axis=1)
                rd[rcm] = np.where(ok, np.where(g <= 3, 3 - g, g), 5)
            jmask = np.arange(Lm)[None, :] < rl[:, None]
            mmn = ((rd != refm) | (rd > 3)) & jmask
            rows, cols_mm = np.nonzero(mmn)
            split = np.searchsorted(rows, np.arange(len(jp) + 1))
            return (split.astype(np.int64), cols_mm,
                    refm[rows, cols_mm])

        soa._mm_builder = build_mm
        return soa

    def _resolve_cap(self) -> int:
        """Effective per-range SA-resolution cap PER DEVICE CALL: boosted
        for large -k / -a (ref: ReportingParams::mult boosting ROWM/POSF,
        aln_sink.h:264-283). Under -a the host path's exact-hit
        enumeration loops over chunks of this size, so the TOTAL is
        unbounded like the reference's (aln_sink.h:288)."""
        k = self.pol.khits
        if k <= self.pol.max_sa_elts:
            return self.pol.max_sa_elts
        return int(min(k + 1, _RESOLVE_CHUNK))

    def exact_copies_hidden(self, exact_mult):
        """Whether a read with exact_mult exact hits has exact copies that
        its candidates do not show (range clipping hides them): its second
        best is then the perfect score (second_best's rule). Takes a count
        or an array of them."""
        return (exact_mult > self._resolve_cap()) | (exact_mult > 1)

    def gap_budget(self, rl: int) -> int:
        """The most gaps, read or reference, a read of length rl can afford
        (the classes of tallyGappedDp, aligner_sw_common.h:246-251; the
        --met DP*Lt* columns), cached a length."""
        v = self._gapclass_cache.get(rl)
        if v is None:
            v = self._gapclass_cache[rl] = max(self.sc.max_gaps(rl, "read"),
                                               self.sc.max_gaps(rl, "ref"))
        return v

    def _collect_host(self, batch: ReadBatch, boost=None, seed_skip=None):
        """Run every candidate-generation and DP stage from the host, batch
        by batch of device calls; return the per-batch state (candidates
        with scores and finish info) without committing a selection —
        shared by the unpaired and paired aligners.

        boost[i]: paired-mode interval boost + round halving (ref:
        bt2_search.cpp:3392-3431 when filt[0] && filt[1]).
        seed_skip[i]: skip the seed stage (the other mate's round-0 seeds
        failed first — ref: bt2_search.cpp:3888/3909)."""
        B, L = batch.seqs.shape
        lens = batch.lens
        rcap = self._resolve_cap()
        fw_seqs, fw_quals = batch.seqs, batch.quals
        rc_seqs, rc_quals = revcomp_batch(fw_seqs, fw_quals, lens)
        mmtab = self.sc.mm_penalties()

        recs = [AlnRec(name=batch.names[i], aligned=False) for i in range(B)]
        for i in range(B):
            recs[i].seq = recs[i].orig_seq = batch.raw_seq[i]
            recs[i].qual = recs[i].orig_qual = batch.raw_qual[i]
            if batch.comments is not None:
                recs[i].comment = batch.comments[i]
            if batch.origs is not None:
                recs[i].orig_rec = batch.origs[i]
            if getattr(batch, "bam_tags", None):
                recs[i].preserved = batch.bam_tags[i]

        # -- filters (ref: bt2_search.cpp:3323-3352) --
        f = self._filters(batch)
        nceil, minsc, perfect = f["nceil"], f["minsc"], f["perfect"]
        filtered = f["len_bad"] | f["n_bad"] | f["sc_bad"]
        if self.qc_filter and batch.qc_fail is not None:
            filtered = filtered | batch.qc_fail
            for i in np.nonzero(batch.qc_fail)[0]:
                recs[i].yf = "QC"
        for i in np.nonzero(filtered)[0]:
            recs[i].filtered = True
            # YF reason priority LN > NS > SC > QC (ref: AlnFlags::printYF,
            # aligner_result.cpp:1095-1100)
            if f["len_bad"][i]:
                recs[i].yf = "LN"
            elif f["n_bad"][i]:
                recs[i].yf = "NS"
            elif f["sc_bad"][i]:
                recs[i].yf = "SC"

        exact_mult = np.zeros(B, np.int64)  # exact hits (for secbest)

        def read_row(i, is_fw):
            rl = int(lens[i])
            seqs, quals = ((fw_seqs, fw_quals) if is_fw
                           else (rc_seqs, rc_quals))
            return (seqs[i, :rl],
                    mmtab[np.clip(quals[i, :rl], 0, 255)].astype(np.int32))

        state = dict(B=B, recs=recs, read_row=read_row, lens=lens,
                     minsc=minsc, perfect=perfect, nceil=nceil,
                     exact_mult=exact_mult, filtered=filtered,
                     fw_seqs=fw_seqs)
        active = ~filtered
        if not active.any():
            return BatchState(seeds_failed_r0=np.zeros(B, bool), **state)

        # -- candidate generation: (read, fw?, diag), diag = the joined
        # position where the aligned-strand read starts --
        cand = set()
        # exact full-read sweep + 1-mismatch up front, fused (ref:
        # aligner_seed.cpp:854 exactSweep, :973 oneMmSearch): the exact
        # ranges fall out of the 1mm search's recorded pass; mismatches in
        # the left half search the fw index, the right half the mirror
        # index over the reversed patterns
        both2 = np.concatenate([fw_seqs, rc_seqs])
        lens2 = np.concatenate([lens, lens])
        act2 = np.concatenate([active, active])
        half2 = lens2 // 2
        unbounded = self.pol.khits >= ALL_HITS

        def add_fw_hits(r, top, bot):
            if not len(r):
                return
            total = (bot - top).astype(np.int64)
            base = np.zeros_like(total)
            while True:
                rem = total - base
                act = np.nonzero(rem > 0)[0]
                if not len(act):
                    break
                cnt = np.minimum(rem[act], rcap)
                offs = dfm.sa_resolve(self.dev, top[act] + base[act], cnt,
                                      rcap)
                for s, ai in enumerate(act):
                    i, is_fw = (int(r[ai]), True) if r[ai] < B else \
                        (int(r[ai]) - B, False)
                    for o in offs[s]:
                        if o >= 0:
                            cand.add((i, is_fw, int(o)))
                base[act] += rcap
                if not unbounded:
                    # bounded modes truncate at the per-call cap; -a loops
                    # until every range is enumerated (the reference's
                    # unbounded -a, aln_sink.h:288)
                    break

        if self.dev_mirror is not None:
            hits, (etop, ebot) = dfm.one_mm_branch_hits(
                self.dev, both2, lens2, np.zeros(2 * B, np.int64),
                np.where(act2, half2, 0), want_exact=True)
        else:
            hits = (np.zeros(0, np.int64),) * 4
            etop, ebot = dfm.backward_search(self.dev, both2, lens2)

        # exact hits (--no-exact-upfront drops the stage; seeds rediscover
        # them, ref: doExactUpFront bt2_search.cpp:3454)
        er = np.nonzero(act2 & (ebot > etop))[0]
        for s in er:
            exact_mult[int(s) % B] += int(ebot[s] - etop[s])
        if not self.pol.no_exact_upfront:
            add_fw_hits(er, etop[er], ebot[er])
        # 1mm left-half hits (--no-1mm-upfront, ref: do1mmUpFront :3634)
        if not self.pol.no_1mm_upfront:
            add_fw_hits(hits[0], hits[2], hits[3])

        if self.dev_mirror is not None and not self.pol.no_1mm_upfront:
            n_text = self.idx.n
            src = lens[:, None] - 1 - np.arange(L)[None, :]
            valid_r = src >= 0
            src_c = np.clip(src, 0, L - 1)
            bidx = np.arange(B)[:, None]
            rev2 = np.concatenate([
                np.where(valid_r, fw_seqs[bidx, src_c], 5).astype(np.uint8),
                np.where(valid_r, rc_seqs[bidx, src_c], 5).astype(np.uint8)])
            r, _, top, bot = dfm.one_mm_branch_hits(
                self.dev_mirror, rev2, lens2, np.zeros(2 * B, np.int64),
                np.where(act2, lens2 - half2, 0))
            if len(r):
                offs = dfm.sa_resolve(self.dev_mirror, top,
                                      np.minimum(bot - top, rcap), rcap)
                for s in range(len(r)):
                    i, is_fw = (int(r[s]), True) if r[s] < B else \
                        (int(r[s]) - B, False)
                    rl = int(lens[i])
                    for o in offs[s]:
                        if o >= 0:
                            diag = n_text - int(o) - rl
                            if diag > -rl:
                                cand.add((i, is_fw, diag))

        # seed rounds. Rounds past 0 run only for reads whose round-0 seeds
        # were highly repetitive (avg hits/seed >= boost_thresh) (ref:
        # bt2_search.cpp:4085-4089 seedBoostThresh, aligner_seed.h:821)
        Lseed = self.pol.seed_len
        boost = (np.zeros(B, bool) if boost is None
                 else np.asarray(boost, bool))
        half_rounds = -(-self.pol.n_seed_rounds // 2)
        nrounds_arr = np.where(boost, half_rounds, self.pol.n_seed_rounds)
        round_active = active.copy()
        if seed_skip is not None:
            round_active &= ~np.asarray(seed_skip, bool)
        seeds_failed_r0 = np.zeros(B, bool)
        for roundi in range(self.pol.n_seed_rounds):
            round_active &= roundi < nrounds_arr
            if not round_active.any():
                break
            # seeds grouped by read length; rc seeds are the revcomp of the
            # SAME fw-read window [off, off+L) (ref: sstring.h:1519
            # windowGetDna), i.e. rc-read position rl-off-L; seeds with an N
            # fail to instantiate (ref: aligner_seed.cpp:583-586)
            sr_parts, sf_parts, sd_parts, sp_parts = [], [], [], []
            inst_count = np.zeros(B, np.int64)
            for rl, bval in {(int(l), bool(bv)) for l, bv in
                             zip(lens[round_active], boost[round_active])}:
                grp = np.nonzero(round_active & (lens == rl)
                                 & (boost == bval))[0]
                offs = self.seed_offsets(rl, roundi, boost=bval,
                                         nrounds=half_rounds if bval
                                         else None)
                sl = min(Lseed, rl)
                for is_fw, seqs in ((True, fw_seqs), (False, rc_seqs)):
                    for off in offs:
                        start = off if is_fw else rl - off - sl
                        block = seqs[grp, start : start + sl]
                        ok = ~(block > 3).any(axis=1)
                        g2 = grp[ok]
                        if not len(g2):
                            continue
                        np.add.at(inst_count, g2, 1)
                        pats = np.full((len(g2), Lseed), 5, np.uint8)
                        pats[:, :sl] = block[ok]
                        sr_parts.append(g2)
                        sf_parts.append(np.full(len(g2), is_fw, bool))
                        sd_parts.append(np.full(len(g2), start, np.int32))
                        sp_parts.append(pats)
            # reads with no instantiated seed are done (ref:
            # bt2_search.cpp:3888-3893 "No seed hits! Done with this mate")
            if roundi == 0:
                seeds_failed_r0 |= round_active & (inst_count == 0)
            round_active &= inst_count > 0
            if not sr_parts:
                break
            seed_reads = np.concatenate(sr_parts)
            seed_fw = np.concatenate(sf_parts)
            seed_depth = np.concatenate(sd_parts)
            seed_pat = np.concatenate(sp_parts)
            slens = np.minimum(Lseed, lens[seed_reads]).astype(np.int32)
            top, bot = dfm.backward_search(self.dev, seed_pat, slens)
            offs = dfm.sa_resolve(self.dev, top, np.minimum(bot - top, rcap),
                                  rcap)
            # diag = off - depth; negative diagonals (the read overhanging
            # the reference start) stay for the rectangle path
            s_idx, e_idx = np.nonzero(offs >= 0)
            diag_flat = offs[s_idx, e_idx] - seed_depth[s_idx]
            keep = diag_flat > -lens[seed_reads[s_idx]]
            cand.update(zip(seed_reads[s_idx[keep]].tolist(),
                            seed_fw[s_idx[keep]].tolist(),
                            diag_flat[keep].tolist()))

            # -N 1: seeds aligning with exactly one in-seed substitution
            # (ref: aligner_seed.cpp:668 searchSeedBi with one mismatch):
            # left halves on the fw index, right halves on the mirror index
            if self.pol.n_seed_mms >= 1 and self.dev_mirror is not None:
                n_text = self.idx.n

                def add_seed_1mm(dev, pats, his, mirror: bool):
                    r, _, t1, b1 = dfm.one_mm_branch_hits(
                        dev, pats, slens, np.zeros(len(pats), np.int64),
                        his)
                    if not len(r):
                        return
                    offs1 = dfm.sa_resolve(dev, t1, np.minimum(b1 - t1, rcap),
                                           rcap)
                    ri, ei = np.nonzero(offs1 >= 0)
                    o1 = offs1[ri, ei]
                    rr = r[ri].astype(np.int64)
                    start1 = (n_text - o1 - slens[rr]) if mirror else o1
                    dg = start1 - seed_depth[rr]
                    kp = dg > -lens[seed_reads[rr]]
                    cand.update(zip(seed_reads[rr[kp]].tolist(),
                                    seed_fw[rr[kp]].tolist(),
                                    dg[kp].tolist()))

                half_s = (slens // 2).astype(np.int64)
                add_seed_1mm(self.dev, seed_pat, half_s, mirror=False)
                srcr = slens[:, None] - 1 - np.arange(Lseed)[None, :]
                rev_pat = np.where(
                    srcr >= 0,
                    seed_pat[np.arange(len(seed_pat))[:, None],
                             np.clip(srcr, 0, Lseed - 1)], 5).astype(np.uint8)
                add_seed_1mm(self.dev_mirror, rev_pat, slens - half_s,
                             mirror=True)
            # the next round only for reads whose hits were highly
            # repetitive; no hit ends the read (ref: bt2_search.cpp:3909,
            # :4086)
            hits_n = (bot - top).astype(np.int64)
            nonz = np.bincount(seed_reads, weights=(hits_n > 0), minlength=B)
            tot = np.bincount(seed_reads, weights=hits_n, minlength=B)
            if roundi == 0:
                seeds_failed_r0 |= round_active & (nonz == 0)
            round_active &= (nonz > 0) & (
                np.divide(tot, np.maximum(nonz, 1)) >= self.pol.boost_thresh)

        if self.nofw or self.norc:
            # --nofw/--norc (ref: bt2_search.cpp gNofw/gNorc)
            cand = {c for c in cand
                    if (c[1] and not self.nofw) or (not c[1]
                                                    and not self.norc)}
        if not cand:
            return BatchState(seeds_failed_r0=seeds_failed_r0, **state)

        # -- DP extension of every candidate: interior candidates through
        # the banded DP, those whose window crosses a run boundary or the
        # reference end through the rectangle DP in reference space with N
        # leeway (ref: dp_framer.cpp:81 frameSeedExtensionRect) --
        cands = sorted(cand)
        K = self.band
        c_half = K // 2
        joined = self.idx.joined
        band_ids, rect_ids, rect_geom = [], [], []
        run_idx = np.searchsorted(
            self._run_starts, np.maximum([c[2] for c in cands], 0),
            side="right") - 1
        run_idx = np.clip(run_idx, 0, max(len(self._run_starts) - 1, 0))
        for ci, (i, _, diag) in enumerate(cands):
            rl = int(lens[i])
            lo = int(self._run_starts[run_idx[ci]])
            hi = int(self._run_ends[run_idx[ci]])
            if diag - c_half >= lo and diag - c_half + rl + K <= hi:
                band_ids.append(ci)
            else:
                fr = self._rect_frame(rl, diag, int(nceil[i]))
                if fr is not None:
                    rect_ids.append(ci)
                    rect_geom.append(fr)

        C = len(cands)
        best = np.full(C, NEG_INF, np.int64)
        end_joined = np.full(C, -1, np.int64)
        fin_info = [None] * C  # what finish_candidate needs per candidate

        # the host path's banded and rectangular DP (-t: "Time dp")
        with trace.span("up.rect"):
            if band_ids:
                nb = len(band_ids)
                rd_m = np.full((nb, L), 5, np.uint8)
                mm_m = np.zeros((nb, L), np.int32)
                band_m = np.full((nb, L + K), 4, np.uint8)
                clens = np.zeros(nb, np.int32)
                for bi_, ci in enumerate(band_ids):
                    rd, mm = read_row(*cands[ci][:2])
                    rl = len(rd)
                    rd_m[bi_, :rl] = rd
                    mm_m[bi_, :rl] = mm
                    clens[bi_] = rl
                    ws = cands[ci][2] - c_half
                    band_m[bi_, : rl + K] = joined[ws : ws + rl + K]
                b_best, b_bi, b_bk = sw_banded_batch(
                    rd_m, clens, mm_m, band_m, self.sw_cfg, K=K,
                    device=self.device)
                for bi_, ci in enumerate(band_ids):
                    i = cands[ci][0]
                    ws = cands[ci][2] - c_half
                    best[ci] = int(b_best[bi_])
                    end_joined[ci] = ws + int(b_bi[bi_]) + int(b_bk[bi_])
                    fin_info[ci] = ("band", int(b_bi[bi_]), int(b_bk[bi_]),
                                    band_m[bi_, : int(lens[i]) + K], ws)

            if rect_ids:
                rd_m, mm_m, ref_m, clens, wlens = pack_rect(
                    [read_row(*cands[ci][:2]) for ci in rect_ids],
                    [self.idx.get_ref_stretch(rid, wl, wr - wl)
                     for rid, wl, wr in rect_geom])
                r_best, r_bi, r_bj = sw_align_batch(
                    rd_m, clens, mm_m, ref_m, wlens, self.sw_cfg,
                    device=self.device)
                for ri, (ci, (rid, wl, wr)) in enumerate(zip(rect_ids,
                                                             rect_geom)):
                    best[ci] = int(r_best[ri])
                    end_joined[ci] = wl + int(r_bj[ri])
                    fin_info[ci] = ("rectr", int(r_bi[ri]), int(r_bj[ri]),
                                    ref_m[ri, : wr - wl], (rid, wl))
        if self.dp_log is not None:
            for ci in range(C):
                if fin_info[ci] is None:
                    continue
                rd, _ = read_row(*cands[ci][:2])
                self.dp_log.write(dna.decode(rd) + "\t"
                                  + dna.decode(fin_info[ci][3]) + "\n")

        # -- the per-batch state --
        by_read: dict[int, list[int]] = {}
        for ci, (i, _, _) in enumerate(cands):
            by_read.setdefault(i, []).append(ci)
        return BatchState(cands=cands, best=best, end_joined=end_joined,
                          fin_info=fin_info, by_read=by_read,
                          seeds_failed_r0=seeds_failed_r0, **state)

    def read_seed(self, st, i) -> int:
        """Per-read 32-bit seed from the read content (ref: pat.cpp:129
        genRandSeed). With --non-deterministic, an arbitrary stream seeded
        from wall-clock time (ref: bt2_search.cpp:3215-3218 rndArb)."""
        if self.pol.non_deterministic:
            if not hasattr(self, "_rnd_arb"):
                import time as _t
                self._rnd_arb = RandomSource(int(_t.time_ns()) & 0xFFFFFFFF)
            return self._rnd_arb.next_u32()
        rec = st.recs[i]
        li = int(st.lens[i])
        codes = np.minimum(st.fw_seqs[i, :li], 4)
        q = np.frombuffer(rec.orig_qual, np.uint8)[:li]
        name = rec.name.encode() if isinstance(rec.name, str) else rec.name
        return gen_rand_seed(codes, q, name, self.pol.seed)

    def read_rnd(self, st, i) -> RandomSource:
        """Per-read tie-break generator (ref: bt2_search.cpp:3386
        rnd.init(read.seed)). The reference threads one stream through its
        sequential search; our batch pipeline draws a fresh stream at
        selection, keeping each read's choice deterministic and
        batch-independent."""
        return RandomSource(self.read_seed(st, i))

    def scored_candidates(self, st, i, rnd: RandomSource | None = None):
        """Valid candidates of read i, redundancy-suppressed (dedup on
        (strand, joined end position) — ref: aligner_sw_driver.h:300
        redAnchor / seenDiags), ordered best-first with equal-score streaks
        shuffled by the per-read generator (ref: aln_sink.cpp:1501
        selectByScore)."""
        msc = int(st.minsc[i])
        by_end: dict[tuple, tuple] = {}
        for ci in st.by_read.get(i, []):
            if st.best[ci] < msc or st.fin_info[ci] is None:
                continue
            key = (st.cands[ci][1], int(st.end_joined[ci]))
            cur = by_end.get(key)
            cand_t = (int(st.best[ci]), ci)
            if cur is None or cand_t[0] > cur[0]:
                by_end[key] = cand_t
        items = [(sc, (st.cands[ci][2], not st.cands[ci][1]), ci)
                 for sc, ci in by_end.values()]
        if rnd is None:
            rnd = self.read_rnd(st, i)
        return [(sc, ci) for sc, _, ci in select_by_score_order(items, rnd)]

    def finish_candidate(self, st, i, ci, bsc, sec, rec=None) -> bool:
        """Commit candidate ci of read i, scored bsc, into rec (default:
        the read's record), tracing it first (`trace_candidates`) where
        st.traces holds no trace of it. Returns False if the candidate is
        rejected."""
        if ci not in st.traces:
            self.trace_candidates(st, [ci], [bsc])
        return self._commit(rec if rec is not None else st.recs[i], st, i,
                            ci, bsc, sec)

    def second_best(self, st, i, scored, rank, start=0) -> int | None:
        """The second best (XS:i, and the MAPQ's) of read i when it reports
        candidate `rank` of `scored` (scored_candidates' list, best
        first): the best score of scored[start:] other than that one (ref:
        AlnSetSumm secbest; for a mate of a concordant pair it may pass
        AS:i, Bowtie 2 manual, XS:i); with no other, the perfect score
        where further exact copies exist (exact_mult counts those that
        range clipping hid); else None. The unpaired selection and the
        paired decision both take it from here."""
        k = start + (start == rank)
        if k < len(scored):
            return scored[k][0]
        if self.exact_copies_hidden(st.exact_mult[i]):
            return int(st.perfect[i])
        return None

    def select_unpaired(self, st, i) -> list:
        """Fill the read's primary record; with khits > 1 (-k) or -a,
        also return secondary records (SAM 0x100, MAPQ 255 — ref: -k
        semantics, ReportingParams khits)."""
        scored = self.scored_candidates(st, i)
        extras = []
        primary_done = False
        k = max(1, self.pol.khits)
        # -M sampling (ref: aln_sink.cpp:271-277 EXIT_SHORT_CIRCUIT_M):
        # when more than mhits distinct alignments exist, report exactly 1
        # — the RNG-sampled best (scored_candidates already shuffles
        # equal-score streaks with the per-read LCG, matching
        # selectByScore, aln_sink.cpp:1577-1594) — and flag the read
        # repetitive (YM:i:1 under print_ym). exact_mult counts exact
        # copies hidden by range clipping.
        maxed = (self.pol.msample and self.pol.mhits > 0
                 and (len(scored) > self.pol.mhits
                      or st.exact_mult[i] > self.pol.mhits))
        if maxed:
            k = 1
            st.recs[i].ym = True
        fail_streak = 0
        for rank, (bsc, bci) in enumerate(scored):
            # preset DPS as a retry-streak cap (see SearchPolicy.dp_streak)
            if fail_streak > self.pol.dp_streak:
                break
            # the candidates ranked before this one were rejected
            sec = self.second_best(st, i, scored, rank, start=rank)
            if not primary_done:
                if self.finish_candidate(st, i, bci, bsc, sec):
                    primary_done = True
                    fail_streak = 0
                    if sec is None and not self.pol.msample:
                        # -k/-a modes can't "max out" (canMax false) and
                        # the search is not exhausted: MAPQ unavailable
                        # (ref: unique.h:125 — !canMax && !exhausted &&
                        # !hasSecbest -> 255; verified on the a_on_unique
                        # tier golden). The reference's `exhausted`
                        # condition is dropped here: our batch search has
                        # no per-read exhaustion state, so an exhausted
                        # -k/-a search would get 255 where the reference
                        # computes a real MAPQ (golden-backed on all
                        # tested cases; revisit if a tier case can
                        # construct an exhausted -a search).
                        st.recs[i].mapq = 255
                    if k == 1:
                        break
                else:
                    fail_streak += 1
                continue
            if len(extras) + 1 >= k:
                break
            rec = AlnRec(name=st.recs[i].name, aligned=False,
                         seq=st.recs[i].orig_seq, qual=st.recs[i].orig_qual,
                         orig_seq=st.recs[i].orig_seq,
                         orig_qual=st.recs[i].orig_qual)
            if self.finish_candidate(st, i, bci, bsc, sec, rec=rec):
                rec.secondary = True
                rec.mapq = 255
                extras.append(rec)
                fail_streak = 0
            else:
                fail_streak += 1
        return extras

    def _commit(self, rec: AlnRec, st, i, ci, bsc, sec) -> bool:
        """Commit candidate ci's trace (st.traces[ci]) into rec: CIGAR/MD
        stats, the N ceiling, the run-straddle rejection, the record's
        fields and MAPQ, and, per attempt, the bt metrics and tb_card.
        Returns False if rejected."""
        edits, start_col, read_start, read_end, tb, card = st.traces[ci]
        kind, _, _, window, wstart = st.fin_info[ci]
        rl, nc = int(st.lens[i]), int(st.nceil[i])
        if tb:
            bc = self.bt_ctr
            bc["bt"] += 1
            # path cells = read rows walked + gap steps (our traceback is
            # single-pass, so the path length IS the cells-visited count)
            bc["btcell"] += (read_end - read_start) + len(edits)
            self.tb_card += card
        stats = cigar_md_stats(rl, edits, read_start, read_end)
        xn = int((window[max(0, start_col):start_col + stats["ref_span"]]
                  > 3).sum())
        if xn > nc:
            if tb:
                self.bt_ctr["btfail"] += 1
            return False  # too many reference Ns (ref: nCeil / maxns)
        if kind == "rectr":
            # reference-space rectangle (N-leeway framing, _rect_frame):
            # coordinates are direct; reject reference-end overhangs
            # (ref: gReportOverhangs defaults false)
            rid, wl = wstart
            pos = wl + start_col
            if pos < 0 or pos + stats["ref_span"] > int(
                    self.idx.ref_lens[rid]):
                if tb:
                    self.bt_ctr["btfail"] += 1
                return False
            ref_id = np.array([rid])
            ref_off = np.array([pos])
        else:
            joined_pos = wstart + start_col
            ref_id, ref_off, valid = self.idx.joined_to_ref(
                np.array([joined_pos]), aln_len=stats["ref_span"] - xn)
            if not valid[0]:
                if tb:
                    self.bt_ctr["btfail"] += 1
                return False  # straddles a run boundary: reject
        rec.aligned = True
        rec.fw = bool(st.cands[ci][1])
        rec.ref_id = int(ref_id[0])
        rec.pos = int(ref_off[0])
        rec.score = bsc
        rec.secbest = sec
        rec.cigar = stats["cigar"]
        rec.md = stats["md"]
        rec.nm, rec.xm, rec.xo, rec.xg = (
            stats["nm"], stats["xm"], stats["xo"], stats["xg"])
        rec.xn = xn
        rec.mapq = mapq_fn(self.mapq_v)(bsc, sec, int(st.minsc[i]),
                                        int(st.perfect[i]), self.sc.monotone)
        if rec.fw:
            rec.seq, rec.qual = rec.orig_seq, rec.orig_qual
        else:
            rec.seq = dna.revcomp_ascii(rec.orig_seq)
            rec.qual = rec.orig_qual[::-1]
        if tb:
            self.bt_ctr["btsucc"] += 1
        return True
