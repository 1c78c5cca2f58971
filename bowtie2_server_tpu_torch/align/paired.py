"""Paired-end alignment (ref: pe.cpp:37 peClassifyPair, pe.h:169
PairedEndPolicy, aligner_sw_driver.cpp:1385 extendSeedsPaired,
bt2_search.cpp paired driver paths). Port of
bowtie2_server_tpu/align/paired.py: both mates run through the port's
UnpairedAligner on the device given at construction, and mate rescue runs
the rectangle DP there (the CUDA kernel of ops/csrc/sw.cu on the card).

Strategy: run the full unpaired candidate machinery on both mates, then
 1. enumerate concordant combos from the two candidate sets (classification
    is a faithful port of peClassifyPair's FR/RF/FF/RR + overlap/containment
    /dovetail rules);
 2. batched mate rescue: for pairs with no concordant combo, run the
    opposite mate as a rectangle DP over the fragment window implied by the
    anchor (ref: frameFindMateRect + otherMate);
 3. classify: concordant pair (YT:Z:CP, proper flag, paired MAPQ over
    summed scores) > discordant (both mates unique, YT:Z:DP) > mixed
    unpaired (YT:Z:UP).
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..io.fastq import ReadBatch
from ..ops.sw import NEG_INF, sw_align_batch
from ..utils import dna
from ..utils.rng import RandomSource, select_by_score_order
from .mapq import mapq_batch, mapq_fn
from .pipeline import (AlnRec, BigCapacityError, ConcatRecs,
                       LazyRecs, SearchPolicy, UnpairedAligner, revcomp_batch)

CONCORDANT, DISCORDANT = 1, 0


@dataclass(frozen=True)
class PairedPolicy:
    """ref: pe.h:169 + bt2_search.cpp:377-386 defaults."""
    pol: str = "FR"
    minfrag: int = 0
    maxfrag: int = 500
    olap_ok: bool = True
    contain_ok: bool = True
    dovetail_ok: bool = False
    expand_to_fit: bool = True

    def classify(self, off1, len1, fw1, off2, len2, fw2) -> int:
        """Port of peClassifyPair (pe.cpp:37-137): returns CONCORDANT for
        NORMAL/OVERLAP/CONTAIN/DOVETAIL (when allowed), else DISCORDANT."""
        maxfrag = self.maxfrag
        if self.expand_to_fit:
            maxfrag = max(maxfrag, len1, len2)
        minfrag = max(self.minfrag, 1)
        if self.pol in ("FF", "RR"):
            if fw1 != fw2:
                return DISCORDANT
            one_left = fw1 if self.pol == "FF" else not fw1
        else:  # FR / RF
            if fw1 == fw2:
                return DISCORDANT
            one_left = fw1 if self.pol == "FR" else not fw1
        fraglo = min(off1, off2)
        fraghi = max(off1 + len1, off2 + len2)
        frag = fraghi - fraglo
        if frag > maxfrag or frag < minfrag:
            return DISCORDANT
        lo1, hi1 = off1, off1 + len1 - 1
        lo2, hi2 = off2, off2 + len2 - 1
        containment = (lo1 >= lo2 and hi1 <= hi2) or \
                      (lo2 >= lo1 and hi2 <= hi1)
        olap = (lo1 <= lo2 <= hi1) or (lo1 <= hi2 <= hi1) or containment
        if olap and not self.olap_ok:
            return DISCORDANT
        if not olap:
            if (one_left and lo2 < lo1) or (not one_left and lo1 < lo2):
                return DISCORDANT
        if containment and not self.contain_ok:
            return DISCORDANT
        # the dovetail check applies to contained pairs too: the left
        # mate's end overhang past the right mate's end IS dovetailing
        # (ref: pe.cpp:128-134 runs unconditionally after the containment
        # branch; verified against the reference binary on the
        # pe_containment simple-tier case)
        dovetail = (one_left and (hi1 > hi2 or lo2 < lo1)) or \
                   (not one_left and (hi2 > hi1 or lo1 < lo2))
        if dovetail and not self.dovetail_ok:
            return DISCORDANT
        return CONCORDANT

    def classify_batch(self, off1, len1, fw1, off2, len2, fw2):
        """Vectorized classify over numpy arrays — same decision table as
        classify() (differential-tested), True = CONCORDANT."""
        off1 = np.asarray(off1, np.int64)
        off2 = np.asarray(off2, np.int64)
        len1 = np.asarray(len1, np.int64)
        len2 = np.asarray(len2, np.int64)
        fw1 = np.asarray(fw1, bool)
        fw2 = np.asarray(fw2, bool)
        if self.expand_to_fit:
            maxfrag = np.maximum(self.maxfrag, np.maximum(len1, len2))
        else:
            maxfrag = np.full(off1.shape, self.maxfrag, np.int64)
        minfrag = max(self.minfrag, 1)
        if self.pol in ("FF", "RR"):
            ok = fw1 == fw2
            one_left = fw1 if self.pol == "FF" else ~fw1
        else:
            ok = fw1 != fw2
            one_left = fw1 if self.pol == "FR" else ~fw1
        frag = (np.maximum(off1 + len1, off2 + len2)
                - np.minimum(off1, off2))
        ok = ok & (frag <= maxfrag) & (frag >= minfrag)
        lo1, hi1 = off1, off1 + len1 - 1
        lo2, hi2 = off2, off2 + len2 - 1
        containment = ((lo1 >= lo2) & (hi1 <= hi2)) | \
                      ((lo2 >= lo1) & (hi2 <= hi1))
        olap = ((lo1 <= lo2) & (lo2 <= hi1)) | \
               ((lo1 <= hi2) & (hi2 <= hi1)) | containment
        if not self.olap_ok:
            ok &= ~olap
        wrong = np.where(one_left, lo2 < lo1, lo1 < lo2)
        ok &= olap | ~wrong
        if not self.contain_ok:
            ok &= ~containment
        if not self.dovetail_ok:
            dove = np.where(one_left, (hi1 > hi2) | (lo2 < lo1),
                            (hi2 > hi1) | (lo1 < lo2))
            ok &= ~dove
        return ok


class PairedRecs:
    """Lazy (rec1, rec2) sequence over the two mates' LazyRecs — AlnRec
    objects (and their MD strings) materialize only for pairs a consumer
    actually touches; count-only consumers (bench, summaries) read the
    fast-path columns directly."""

    __slots__ = ("r1", "r2")

    def __init__(self, r1, r2):
        self.r1, self.r2 = r1, r2

    def __len__(self):
        return len(self.r1)

    def __getitem__(self, i):
        return (self.r1[i], self.r2[i])

    def __iter__(self):
        for i in range(len(self.r1)):
            yield (self.r1[i], self.r2[i])

    def n_concordant(self) -> int:
        """Concordant (proper) pair count without materializing records:
        the fast pairs' column store plus the slow pairs' records (a list of
        records where the host path made them)."""
        if isinstance(self.r1, list):
            return sum(bool(rec.proper) for rec in self.r1)
        soa = self.r1.soa
        filled = soa.filled if soa is not None and soa.pair is not None \
            else None
        n = int(filled.sum()) if filled is not None else 0
        for i, rec in self.r1.cache_items():
            if rec.proper and not (filled is not None and filled[i]):
                n += 1
        return n


class PairedAligner:
    def __init__(self, index, scoring=None, policy: SearchPolicy | None = None,
                 pe: PairedPolicy | None = None, *, device,
                 no_mixed: bool = False, no_discordant: bool = False,
                 sc_unmapped_tlen: bool = False,
                 force_big: bool | None = None):
        """device: where both mates' pipelines and mate rescue run ('cpu'
        runs the plain torch versions of the kernels, 'cuda' the CUDA
        kernels); force_big: as UnpairedAligner's."""
        self.up = UnpairedAligner(index, scoring=scoring, policy=policy,
                                  device=device, force_big=force_big)
        self.pe = pe or PairedPolicy()
        self.no_mixed = no_mixed        # ref: --no-mixed (gMixedMode off)
        self.no_discordant = no_discordant  # ref: --no-discordant
        # --soft-clipped-unmapped-tlen: soft-clipped bases count as
        # unmapped, i.e. excluded from TLEN extents (ref:
        # bt2_search.cpp:731 ARG_SC_UNMAPPED_TLEN)
        self.sc_unmapped_tlen = sc_unmapped_tlen
        self.dp_log_opp = None   # file: log rescue DP problems (--log-dp-opp)
        self.last_metrics = {}   # the last pair batch's --met counters

    # approximate candidate ref start: end - readlen + 1 (exact for
    # ungapped; off by <= #gap bases otherwise — the final classification
    # re-checks with exact coordinates after traceback)
    def _approx_off(self, st, ci):
        i = st.cands[ci][0]
        return int(st.end_joined[ci]) - int(st.lens[i]) + 1

    def _combos_batch(self, st1, st2, idxs, scored1, scored2,
                      slack: int = 64):
        """Vectorized _combos over all non-fast pairs at once: one
        classify_batch call over the stacked <=8x8 combo matrices instead
        of 64 scalar classify() calls per pair (ref: the concordance
        scan inside extendSeedsPaired, aligner_sw_driver.cpp:1385). The
        per-pair ordering + RNG streak shuffle stays scalar (cheap)."""
        P = len(idxs)
        if P == 0:
            return {}
        M = 8
        sc = np.full((2, P, M), NEG_INF, np.int64)
        off = np.zeros((2, P, M), np.int64)
        fw = np.zeros((2, P, M), bool)
        ci = np.full((2, P, M), -1, np.int64)
        nv = np.zeros((2, P), np.int32)
        for s_i, (st, scored) in enumerate(((st1, scored1), (st2, scored2))):
            ends = np.asarray(st.end_joined)
            lens = np.asarray(st.lens, np.int64)
            for p, i in enumerate(idxs):
                s = scored[i][:M]
                nv[s_i, p] = len(s)
                for m, (s_sc, s_ci) in enumerate(s):
                    sc[s_i, p, m] = s_sc
                    ci[s_i, p, m] = s_ci
                    fw[s_i, p, m] = st.cands[s_ci][1]
                    off[s_i, p, m] = int(ends[s_ci]) - int(lens[i]) + 1
        l1 = np.asarray(st1.lens, np.int64)[idxs]
        l2 = np.asarray(st2.lens, np.int64)[idxs]
        # combo grids [P, M, M]: mate1 varies over axis 1, mate2 over 2
        o1 = np.broadcast_to(off[0][:, :, None], (P, M, M))
        o2 = np.broadcast_to(off[1][:, None, :], (P, M, M))
        f1 = np.broadcast_to(fw[0][:, :, None], (P, M, M))
        f2 = np.broadcast_to(fw[1][:, None, :], (P, M, M))
        L1 = np.broadcast_to(l1[:, None, None], (P, M, M))
        L2 = np.broadcast_to(l2[:, None, None], (P, M, M))
        vmask = (np.arange(M)[None, :, None] < nv[0][:, None, None]) & \
                (np.arange(M)[None, None, :] < nv[1][:, None, None])
        strict = self.pe.classify_batch(
            o1.ravel(), L1.ravel(), f1.ravel(),
            o2.ravel(), L2.ravel(), f2.ravel()).reshape(P, M, M) & vmask
        # loose acceptance: right orientation + extent within slack
        if self.pe.pol in ("FR", "RF"):
            orient_ok = f1 != f2
        else:
            orient_ok = f1 == f2
        frag = (np.maximum(o1 + L1, o2 + L2) - np.minimum(o1, o2))
        if self.pe.expand_to_fit:
            maxfrag = np.maximum(self.pe.maxfrag, np.maximum(L1, L2))
        else:
            maxfrag = np.full(frag.shape, self.pe.maxfrag, np.int64)
        loose = vmask & orient_ok & (frag <= maxfrag + slack) & ~strict
        any_combo = strict | loose
        out = {}
        for p, i in enumerate(idxs):
            pairs = np.nonzero(any_combo[p])
            combos = []
            for m1, m2 in zip(*pairs):
                combos.append((int(sc[0, p, m1] + sc[1, p, m2]),
                               int(sc[0, p, m1]), int(ci[0, p, m1]),
                               int(sc[1, p, m2]), int(ci[1, p, m2]),
                               bool(strict[p, m1, m2]),
                               int(off[0, p, m1])))
            combos.sort(key=lambda t: (-t[0], t[6]))
            combos = [t[:6] for t in combos]
            if len(combos) > 1 and any(a[0] == b[0] for a, b in
                                       zip(combos, combos[1:])):
                # re-rank with the exact scalar path's ordering + shuffle
                combos = self._order_combos(st1, st2, i, combos)
            out[i] = combos
        return out

    def _order_combos(self, st1, st2, i, out):
        """Equal-score-sum streak shuffle with the pair RNG (ref:
        bt2_search.cpp:3384 rnd.init(seed1 ^ seed2) + selectByScore)."""
        rnd = RandomSource(self.up.read_seed(st1, i)
                           ^ self.up.read_seed(st2, i))
        return [(tot, sc1, c1, sc2, c2, strict)
                for tot, _, (sc1, c1, sc2, c2, strict) in
                select_by_score_order(
                    [(t[0], (self._approx_off(st1, t[2]), k), t[1:])
                     for k, t in enumerate(out)], rnd)]

    def _combos(self, st1, st2, i, s1, s2, slack: int = 64):
        """Candidate concordant combos. The offsets here are approximate
        (end - readlen + 1; exact only for ungapped alignments), so this is
        a LOOSE prefilter — strict classification happens in _decide with
        exact post-traceback coordinates. `slack` absorbs gap-induced
        offset error (bounded by the DP band half-width)."""
        out = []
        l1, l2 = int(st1.lens[i]), int(st2.lens[i])
        for sc1, c1 in s1[:8]:
            fw1 = st1.cands[c1][1]
            o1 = self._approx_off(st1, c1)
            for sc2, c2 in s2[:8]:
                fw2 = st2.cands[c2][1]
                o2 = self._approx_off(st2, c2)
                if self.pe.classify(o1, l1, fw1, o2, l2, fw2) == CONCORDANT:
                    out.append((sc1 + sc2, sc1, c1, sc2, c2, True))
                    continue
                # loose acceptance: right orientation pattern and extents
                # within slack of the fragment limit
                if self.pe.pol in ("FR", "RF"):
                    orient_ok = fw1 != fw2
                else:
                    orient_ok = fw1 == fw2
                if not orient_ok:
                    continue
                frag = max(o1 + l1, o2 + l2) - min(o1, o2)
                maxfrag = max(self.pe.maxfrag, l1, l2) \
                    if self.pe.expand_to_fit else self.pe.maxfrag
                if frag <= maxfrag + slack:
                    out.append((sc1 + sc2, sc1, c1, sc2, c2, False))
        out.sort(key=lambda t: (-t[0], self._approx_off(st1, t[2])))
        if len(out) > 1 and any(a[0] == b[0]
                                for a, b in zip(out, out[1:])):
            out = self._order_combos(st1, st2, i, out)
        return out

    def _fast_cp(self, st1, st2):
        """Mask of pairs eligible for the concordant fast path, plus the
        per-mate (score, candidate-index) arrays for eligible pairs.

        Local mode deliberately excluded: the device certification proves
        no soft clip IMPROVES the winner, but the reference clips on
        EQUAL-score ties (zero-score prefixes/suffixes), which moves
        positions and can flip the pair classification — enabling the
        fast path here measured 97.7% -> 95.3% paired-local parity on
        the 600-pair golden (round 3), so local pairs keep the
        traceback path."""
        B = st1.B
        zero = np.zeros(B, bool)
        if self.up.sc.local:
            return zero, None, None
        out_sc, out_ci, singles, offs, fws, lens = [], [], [], [], [], []
        for st in (st1, st2):
            res = getattr(st, "sel", None)   # None: a host-path state
            if res is None or len(res.c_read) == 0:
                return zero, None, None
            NEGH = NEG_INF // 2
            has = res.best_ci >= 0
            k = np.clip(res.best_ci, 0, len(res.c_read) - 1)
            single = (has & ~res.has_rect & (res.sec_sc <= NEGH)
                      & res.c_ungapped[k] & ~st.filtered)
            out_sc.append(res.c_score[k].astype(np.int64))
            out_ci.append(k)
            singles.append(single)
            offs.append((res.c_ws[k] + res.c_bk[k]).astype(np.int64))
            fws.append(res.c_fw[k])
            lens.append(np.asarray(st.lens, np.int64))
        conc = self.pe.classify_batch(offs[0], lens[0], fws[0],
                                      offs[1], lens[1], fws[1])
        return singles[0] & singles[1] & conc, out_sc, out_ci

    def _commit_fast_cp(self, st1, st2, mask, f_sc, f_ci):
        """Vectorized commit of the concordant fast pairs into per-mate
        FastSoA views (the CP outcome of _decide, column-wise). Pairs whose
        mates resolve to different references are dropped back to the slow
        path. Returns the (possibly narrowed) committed mask."""
        w = np.nonzero(mask)[0]
        cols = []
        for st, ks in ((st1, f_ci[0]), (st2, f_ci[1])):
            res = st.res
            k = ks[w]
            jp = (res.c_ws[k] + res.c_bk[k]).astype(np.int64)
            ref_id, ref_off, _ = self.up.idx.joined_to_ref(jp)
            cols.append(dict(
                fw=res.c_fw[k], jp=jp, rl=np.asarray(st.lens, np.int64)[w],
                ref_id=ref_id.astype(np.int64),
                pos=ref_off.astype(np.int64),
                nm=res.c_nm[k], sc=res.c_score[k].astype(np.int64)))
        c1, c2 = cols
        ok = c1["ref_id"] == c2["ref_id"]
        if not ok.all():
            mask = mask.copy()
            mask[w[~ok]] = False
            w = w[ok]
            if not len(w):
                return mask
            for c in cols:
                for key in list(c):
                    c[key] = c[key][ok]
        n = len(w)
        tot = c1["sc"] + c2["sc"]
        msc = np.asarray(st1.minsc)[w] + np.asarray(st2.minsc)[w]
        per = np.asarray(st1.perfect)[w] + np.asarray(st2.perfect)[w]
        mapq = mapq_batch(self.up.mapq_v, tot, np.zeros_like(tot),
                          np.zeros(n, bool), msc, per,
                          self.up.sc.monotone)
        # TLEN over unclipped extents (ungapped: ref span == read length);
        # sign rules mirror _set_mate_fields
        lo = np.minimum(c1["pos"], c2["pos"])
        hi = np.maximum(c1["pos"] + c1["rl"], c2["pos"] + c2["rl"])
        tl = hi - lo
        same = c1["pos"] == c2["pos"]
        left1 = np.where(same, c1["fw"], c1["pos"] < c2["pos"])
        left2 = np.where(same, c2["fw"], c2["pos"] < c1["pos"])
        tl1 = np.where(left1, tl, -tl)
        tl2 = np.where(left2, tl, -tl)
        eq = same & (c1["fw"] == c2["fw"])
        tl1 = np.where(eq, tl, tl1)
        tl2 = np.where(eq, -tl, tl2)
        for st, me, other, m1, tln in ((st1, c1, c2, True, tl1),
                                       (st2, c2, c1, False, tl2)):
            soa = self.up._soa_from_best(
                st, w, me["fw"], me["ref_id"], me["pos"], me["sc"],
                np.zeros(n, bool), np.zeros(n, np.int64), mapq,
                me["nm"], me["rl"], me["jp"])
            soa.pair = dict(mate1=m1, mate_fw=other["fw"],
                            mate_ref_id=other["ref_id"],
                            mate_pos=other["pos"], tlen=tln, ys=other["sc"])
            st.recs.soa = soa
        return mask

    def _rescue_jobs(self, st_anchor, st_opp, i, s_anchor):
        """Rectangle-DP rescue windows (opp_fw, wl, wr) for the opposite
        mate from the anchor's best candidates (ref:
        PairedEndPolicy::otherMate + frameFindMateRect: the
        fragment-length window)."""
        jobs = []
        lo_idx = int(st_opp.lens[i])
        for _, ca in s_anchor[:2]:
            fw_a = st_anchor.cands[ca][1]
            off_a = self._approx_off(st_anchor, ca)
            alen = int(st_anchor.lens[i])
            maxfrag = max(self.pe.maxfrag, alen, lo_idx) \
                if self.pe.expand_to_fit else self.pe.maxfrag
            if self.pe.pol == "FR":
                opp_fw = not fw_a
                if fw_a:   # anchor is the left mate
                    wl, wr = off_a, off_a + maxfrag
                else:      # anchor right; opposite to the left
                    wl, wr = off_a + alen - maxfrag, off_a + alen
            else:  # other policies: symmetric window around the anchor
                opp_fw = not fw_a if self.pe.pol == "RF" else fw_a
                wl, wr = off_a + alen - maxfrag, off_a + maxfrag
            jobs.append((opp_fw, wl, wr))
        return jobs

    def align_batch(self, b1: ReadBatch, b2: ReadBatch):
        return self.align_wait(self.align_async(b1, b2))

    def align_async(self, b1: ReadBatch, b2: ReadBatch):
        """Dispatch BOTH mates' device programs back-to-back. The
        reference's mate-coupling rule (mate-1 round-0 seed failure skips
        mate-2's seed stage, bt2_search.cpp:3888/3909) is applied on the
        HOST after both fetches (UnpairedAligner.apply_seed_skip) instead
        of as a dispatch-time dependency — the st1-fetch -> st2-dispatch
        serialization was the paired critical path."""
        both_ok = (~self.up.compute_filtered(b1)) & \
                  (~self.up.compute_filtered(b2))
        h1 = self.up.collect_async(b1, boost=both_ok)
        h2 = self.up.collect_async(b2, boost=both_ok)
        return (b1, b2, both_ok, h1, h2)

    def align_wait(self, handle):
        # Paired-mode coupling (ref: bt2_search.cpp:3392-3431, 3888, 3909):
        # when both mates pass filters, the seed interval is boosted 20% and
        # rounds are halved; and mate 1 failing its round-0 seeds aborts
        # mate 2's seed stage for the round (which, with halved rounds, is
        # the whole seed stage).
        b1, b2, both_ok, h1, h2 = handle
        try:
            return self._align_wait_inner(b1, b2, both_ok, h1, h2)
        except BigCapacityError:
            # big-index degradation: halve the pair batch and retry (see
            # UnpairedAligner.align_wait)
            B = len(b1)
            if B < 2:
                raise
            mid = B // 2
            return ConcatRecs([
                self.align_batch(b1.slice(0, mid), b2.slice(0, mid)),
                self.align_batch(b1.slice(mid, B), b2.slice(mid, B))])

    def _align_wait_inner(self, b1, b2, both_ok, h1, h2):
        st1 = self.up.collect_wait(h1)
        skip2 = both_ok & st1.seeds_failed_r0
        if h2[0] == "host":
            # the host-path collect is lazy (runs at wait): inject the
            # dispatch-time seed_skip it would have received
            st2 = self.up.collect_wait(("host", h2[1], h2[2], skip2))
        else:
            st2 = self.up.collect_wait(h2)
            if skip2.any():
                self.up.apply_seed_skip(st2, skip2)
        # per-batch --met counters, both mates summed (ref: the paired
        # halves of the PerfMetrics merge, bt2_search.cpp:3229-3248)
        m1 = getattr(st1.recs, "metrics", {})
        m2 = getattr(st2.recs, "metrics", {})
        self.last_metrics = {k: m1.get(k, 0) + m2.get(k, 0)
                             for k in set(m1) | set(m2)}
        B = st1.B
        # fast-pair shortcut: both mates have exactly one (ungapped,
        # interior, untied) candidate and the pair classifies concordant on
        # exact offsets — the dominant case; skips the per-read python
        # candidate ranking entirely (ref: the happy path through
        # extendSeedsPaired, aligner_sw_driver.cpp:1385)
        fastcp, f_sc, f_ci = self._fast_cp(st1, st2)
        if fastcp.any():
            fastcp = self._commit_fast_cp(st1, st2, fastcp, f_sc, f_ci)
        scored1 = [None if fastcp[i]
                   else self.up.scored_candidates(st1, i) for i in range(B)]
        scored2 = [None if fastcp[i]
                   else self.up.scored_candidates(st2, i) for i in range(B)]
        idxs = [i for i in range(B) if not fastcp[i]]
        cb = self._combos_batch(st1, st2, idxs, scored1, scored2)
        combos = [None if fastcp[i] else cb[i] for i in range(B)]

        # ---- batched mate rescue ----
        jobs = []  # (which_st_opp, i, opp_fw, wl, wr)
        for i in range(B):
            if fastcp[i] or combos[i]:
                continue
            # never rescue a filtered mate (N-filter etc., ref:
            # bt2_search.cpp:3419 filt[] gates all paired work)
            if scored1[i] and not st2.filtered[i]:
                jobs += [("2", i, *w)
                         for w in self._rescue_jobs(st1, st2, i, scored1[i])]
            if scored2[i] and not st1.filtered[i]:
                jobs += [("1", i, *w)
                         for w in self._rescue_jobs(st2, st1, i, scored2[i])]
        self.last_metrics["dp_mate"] = len(jobs)   # DPMate* TSV columns
        if self.up.want_met and jobs:
            # DPMateLt* gap classes (ref: tallyGappedDp on the mate-search
            # DPs, aligner_sw_common.h:246): the rescued mate's budget
            gc, sc = self.up._gapclass_cache, self.up.sc
            lt10 = lt5 = lt3 = 0
            for which, i, _, _, _ in jobs:
                rl = int((b2 if which == "2" else b1).lens[i])
                mx = gc.get(rl)
                if mx is None:
                    mx = max(sc.max_gaps(rl, "read"), sc.max_gaps(rl, "ref"))
                    gc[rl] = mx
                lt10 += mx < 10
                lt5 += mx < 5
                lt3 += mx < 3
            self.last_metrics.update(dp_mate_lt10=lt10, dp_mate_lt5=lt5,
                                     dp_mate_lt3=lt3)
        if jobs:
            self._run_rescue(jobs, st1, st2, b1, b2)
            # recompute scored/combos for affected reads
            for i in {j[1] for j in jobs}:
                scored1[i] = self.up.scored_candidates(st1, i)
                scored2[i] = self.up.scored_candidates(st2, i)
                combos[i] = self._combos(st1, st2, i, scored1[i], scored2[i])

        # ---- per-pair decision (fast pairs are already committed) ----
        for i in range(B):
            if not fastcp[i]:
                self._decide(st1, st2, i, scored1[i], scored2[i], combos[i])
        return PairedRecs(st1.recs, st2.recs)

    def _run_rescue(self, jobs, st1, st2, b1, b2):
        """Rectangle DP of the missing mate over fragment windows, batched;
        successful hits are appended as new candidates."""
        up = self.up
        idx = up.idx
        joined = idx.joined
        lq = 0
        eff_maxfrag = self.pe.maxfrag
        for which, i, opp_fw, wl, wr in jobs:
            st_opp = st2 if which == "2" else st1
            st_anc = st1 if which == "2" else st2
            lq = max(lq, int(st_opp.lens[i]))
            if self.pe.expand_to_fit:
                # the effective fragment limit includes read lengths
                # (classify's expand_to_fit), so the window must too
                eff_maxfrag = max(eff_maxfrag, int(st_opp.lens[i]),
                                  int(st_anc.lens[i]))
        lq = -(-max(lq, 1) // 64) * 64
        wmax = -(-(eff_maxfrag + 64) // 128) * 128
        C = len(jobs)
        rd_m = np.full((C, lq), 5, np.uint8)
        mm_m = np.zeros((C, lq), np.int32)
        ref_m = np.full((C, wmax), 4, np.uint8)
        clens = np.zeros(C, np.int32)
        wlens = np.zeros(C, np.int32)
        metas = []
        mmtab = up.sc.mm_penalties()
        for ci, (which, i, opp_fw, wl, wr) in enumerate(jobs):
            st_opp = st2 if which == "2" else st1
            b_opp = b2 if which == "2" else b1
            rl = int(st_opp.lens[i])
            seqs, quals = b_opp.seqs, b_opp.quals
            if not opp_fw:
                seqs, quals = revcomp_batch(
                    seqs[i : i + 1], quals[i : i + 1],
                    st_opp.lens[i : i + 1])
                rd = seqs[0, :rl]
                qu = quals[0, :rl]
            else:
                rd = seqs[i, :rl]
                qu = quals[i, :rl]
            wl = max(0, int(wl))
            wr = min(idx.n, int(wr))
            if wr <= wl:
                metas.append(None)
                continue
            rd_m[ci, :rl] = rd
            mm_m[ci, :rl] = mmtab[np.clip(qu, 0, 255)]
            clens[ci] = rl
            width = min(wr - wl, wmax)
            ref_m[ci, :width] = joined[wl : wl + width]
            wlens[ci] = width
            metas.append((which, i, opp_fw, wl))
        if self.dp_log_opp is not None:
            # --log-dp-opp: opposite-mate DP problems in the same
            # read<TAB>window format as --dp-log (ref: bt2_dp.cpp replay)
            for ci in range(C):
                if metas[ci] is None:
                    continue
                self.dp_log_opp.write(
                    dna.decode(rd_m[ci, : int(clens[ci])]) + "\t"
                    + dna.decode(ref_m[ci, : int(wlens[ci])]) + "\n")
        # on CUDA the unpaired rect DP's side stream (rect_stream): on the
        # main stream the copies would wait for both mates' fused batches
        with up.rect_stream():
            best, bi, bj = sw_align_batch(
                rd_m, np.maximum(clens, 1), mm_m, ref_m, wlens, up.sw_cfg,
                device=up.device)
        for ci, meta in enumerate(metas):
            if meta is None:
                continue
            which, i, opp_fw, wl = meta
            st_opp = st2 if which == "2" else st1
            if best[ci] < st_opp.minsc[i]:
                continue
            # append as a new candidate of the opposite mate
            nci = len(st_opp.cands)
            st_opp.cands.append((i, bool(opp_fw), wl + int(bj[ci])
                                 - int(st_opp.lens[i]) + 1))
            st_opp.best = np.append(st_opp.best, int(best[ci]))
            st_opp.end_joined = np.append(st_opp.end_joined,
                                          wl + int(bj[ci]))
            st_opp.fin_info.append(
                ("rect", int(bi[ci]), int(bj[ci]),
                 ref_m[ci, : int(wlens[ci])].copy(), wl))
            st_opp.by_read.setdefault(i, []).append(nci)
            # register read arrays for the new candidate
            table = getattr(st_opp, "rescue_arrays", None)
            if table is None:
                table = st_opp.rescue_arrays = {}
                st_opp.read_arrays = _with_rescued(st_opp.read_arrays, table)
            table[nci] = (rd_m[ci, : int(st_opp.lens[i])].copy(),
                          mm_m[ci, : int(st_opp.lens[i])].copy())

    def _decide(self, st1, st2, i, s1, s2, combos):
        r1, r2 = st1.recs[i], st2.recs[i]
        pe = self.pe
        # try concordant combos best-first
        for rank, (tot, sc1, c1, sc2, c2, _strict) in enumerate(combos):
            # secbest for MAPQ: the best later combo that passed STRICT
            # concordant classification — loosely-accepted entries may never
            # be reportable and must not shift MAPQ (ref: bestUnchosenCScore
            # semantics, aln_sink.h AlnSetSumm)
            sec = next((c[0] for c in combos[rank + 1:] if c[5]), None)
            ok1 = self.up.finish_candidate(st1, i, c1, sc1, None)
            ok2 = self.up.finish_candidate(st2, i, c2, sc2, None)
            if not (ok1 and ok2):
                r1.aligned = r2.aligned = False
                continue
            # re-classify with exact coordinates; concordance requires the
            # same reference sequence (joined-space prefilter distances can
            # alias across a reference boundary)
            span1 = _ref_span(r1)
            span2 = _ref_span(r2)
            if r1.ref_id != r2.ref_id or \
                    pe.classify(r1.pos, span1, r1.fw, r2.pos, span2,
                                r2.fw) != CONCORDANT:
                r1.aligned = r2.aligned = False
                continue
            msc = int(st1.minsc[i]) + int(st2.minsc[i])
            per = int(st1.perfect[i]) + int(st2.perfect[i])
            mq = mapq_fn(self.up.mapq_v)(tot, sec, msc, per,
                                         self.up.sc.monotone)
            for r, other, m1 in ((r1, r2, True), (r2, r1, False)):
                r.mapq = mq
                r.yt = "CP"
                r.paired = True
                r.mate1 = m1
                r.proper = True
                r.mate_aligned = True
                r.pair_multi = len(combos) > 1
            self._set_mate_fields(r1, r2)
            return
        # discordant: both mates align uniquely (ref: ReportingState —
        # discordant only considered with exactly one alignment each)
        if not self.no_discordant and len(s1) == 1 and len(s2) == 1 \
                and s1 and s2:
            ok1 = self.up.finish_candidate(st1, i, s1[0][1], s1[0][0], None)
            ok2 = self.up.finish_candidate(st2, i, s2[0][1], s2[0][0], None)
            if ok1 and ok2:
                # discordant pairs use the paired (summed) MAPQ — both
                # mates share it (ref: unique.h mapq s.paired() branch)
                msc = int(st1.minsc[i]) + int(st2.minsc[i])
                per = int(st1.perfect[i]) + int(st2.perfect[i])
                mq = mapq_fn(self.up.mapq_v)(r1.score + r2.score, None,
                                             msc, per, self.up.sc.monotone)
                for r, m1 in ((r1, True), (r2, False)):
                    r.yt = "DP"
                    r.paired = True
                    r.mate1 = m1
                    r.proper = False
                    r.mate_aligned = True
                    r.mapq = mq
                self._set_mate_fields(r1, r2)
                return
            r1.aligned = r2.aligned = False
        # mixed: unpaired selection per mate (suppressed by --no-mixed)
        if not self.no_mixed:
            self.up._select_unpaired(st1, i)
            self.up._select_unpaired(st2, i)
        for r, m1 in ((r1, True), (r2, False)):
            r.yt = "UP"
            r.paired = True
            r.mate1 = m1
            r.proper = False
        r1.mate_aligned = r2.aligned
        r2.mate_aligned = r1.aligned
        self._set_mate_fields(r1, r2)

    def _set_mate_fields(self, r1, r2):
        for r, other in ((r1, r2), (r2, r1)):
            r.mate_fw = other.fw
            r.mate_ref_id = other.ref_id
            r.mate_pos = other.pos
        # TLEN + YS only when the mates were reported AS a pair (CP/DP);
        # mixed-mode UP halves get TLEN 0 and no YS even when both mates
        # aligned (ref: the reference emits YS/TLEN from the paired result
        # only — verified on the pe_discordant_no_discordant tier golden:
        # UP records carry tlen=0, no YS, but rnext/pnext stay set)
        as_pair = getattr(r1, "yt", None) in ("CP", "DP")
        # TLEN: signed outermost distance when both aligned on the same ref
        if as_pair and r1.aligned and r2.aligned and r1.ref_id == r2.ref_id:
            # TLEN spans the UNCLIPPED read extents (soft-clipped bases
            # count toward the fragment — observed reference default);
            # --soft-clipped-unmapped-tlen excludes them
            if self.sc_unmapped_tlen:
                us1, us2 = r1.pos, r2.pos
                lo = min(us1, us2)
                hi = max(r1.pos + _ref_span(r1), r2.pos + _ref_span(r2))
            else:
                us1 = r1.pos - _lead_clip(r1)
                us2 = r2.pos - _lead_clip(r2)
                lo = min(us1, us2)
                hi = max(r1.pos + _ref_span(r1) + _tail_clip(r1),
                         r2.pos + _ref_span(r2) + _tail_clip(r2))
            t = hi - lo
            # the SIGN compares UNCLIPPED starts (soft-clipped bases count
            # toward the fragment): a mate whose clip reaches further left
            # is the leftmost even when its POS is larger — verified on
            # the lambda paired-local golden (e.g. r37: 1S160M at POS+1
            # gets +TLEN); ties -> the forward-strand mate is leftmost
            for r, mine, theirs in ((r1, us1, us2), (r2, us2, us1)):
                if mine != theirs:
                    r.tlen = t if mine < theirs else -t
                else:
                    r.tlen = t if r.fw else -t
            if us1 == us2 and r1.fw == r2.fw:
                r1.tlen, r2.tlen = t, -t
        else:
            r1.tlen = r2.tlen = 0
        r1.ys = r2.score if (as_pair and r2.aligned) else None
        r2.ys = r1.score if (as_pair and r1.aligned) else None


def _with_rescued(orig, table):
    """`read_arrays` that serves the rescue-added candidates in `table`
    (candidate index -> (read codes, penalties)) and defers to `orig`."""
    def ra(ci):
        if ci in table:
            rd, mm = table[ci]
            return rd, mm, len(rd)
        return orig(ci)
    return ra


def _lead_clip(r: AlnRec) -> int:
    m = re.match(r"(\d+)S", r.cigar or "")
    return int(m.group(1)) if m else 0


def _tail_clip(r: AlnRec) -> int:
    m = re.search(r"(\d+)S$", r.cigar or "")
    return int(m.group(1)) if m else 0


def _ref_span(r: AlnRec) -> int:
    """Reference span from the CIGAR (M + D)."""
    if not r.aligned or r.cigar == "*":
        return 0
    return sum(int(n) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", r.cigar)
               if op in "MDN=X")
