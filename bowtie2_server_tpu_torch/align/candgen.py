"""Device-resident candidate generation + DP + selection — the hot path.
Port of bowtie2_server_tpu/align/candgen.py (small and big indexes, one
device or a 'dp' mesh of them).

One call of `fused_pipeline` runs a whole search batch on the device (ref:
the reference's hot loop, bt2_search.cpp:3050-4197 multiseedSearchWorker +
aligner_sw_driver.cpp:756 SwDriver::extendSeeds):

  1. unpack the transfer-packed batch; the seed schedule
  2. (general shape) recorded backward pass of both strands on the fw FM
     index: exact ranges and exact_mult (ref: aligner_seed.cpp:854
     exactSweep); 1-substitution branches of both read halves, the right
     halves on the mirror index (ref: aligner_seed.cpp:973 oneMmSearch)
  3. seed rounds (ref: bt2_search.cpp:3824-4089, seedBoostThresh gating):
     the fast shape looks seeds up in the k-mer position table
     (index/kmer.py), with reseed rounds compacted to their few active
     lanes; the general shape searches per-read truncated seeds in the FM
     index, with `-N 1` per-seed substitution branches (ref:
     aligner_seed.cpp:668 searchSeedBi)
  4. position resolution of every surviving range — one gather (small
     indexes), or the walk-left over the sampled SA (big indexes)
  5. candidate dedup on (lane, diagonal) via one sort of a packed key
     (ref: SwDriver seenDiags, aligner_sw_driver.h:300)
  6. banded affine-gap DP over every interior candidate — the CUDA kernel
     of ops/csrc/sw_banded.cu on the card (ops/sw_banded.py)
  7. center-diagonal ungapped stats
  8. per-read best + second-best-distinct-end selection via segment maxes
     (ref: AlnSinkWrap best/secbest bookkeeping, aln_sink.h)

Two shapes, picked per batch by `CandGen.dispatch`: the FAST shape, when
every active read keeps at least one intact seed under any single
substitution (nseeds >= ceil(Ls/ival)+1), so exact and 1-substitution hits
come out of the seed lookup + DP without an FM pass; and the general
short-read shape (`cfg.has_short`: a short read anywhere in the batch, or
`-N 1`), whose FM walks run the CUDA kernels of ops/csrc/fm.cu on the card
(ops/fm.py). A big index (docs/BIGINDEX.md) always takes the general shape
(no k-mer table beside it on the device): its rows and offsets are uint32
(ops/fm.py's row convention; here widened to int64 values), and its
diagonals carry a static bias BIAS = L + K so that they stay non-negative
in uint32 as in the JAX package, whose 32-bit wraparound the int64 code
reproduces where it reaches the output (the window start of a padding
candidate). Over a 'dp' mesh (parallel/mesh.py) `CandGen` runs one
pipeline a shard, each on its own device with the index replicated there,
and moves each shard's read and candidate indices into the mesh's global
space (`_to_global`), as the JAX package's `_sharded_pipeline` does.

Everything is fixed-shape: hit, element and candidate sets are compacted
to static capacities with overflow counters (no host synchronisation
inside the pipeline); the host escalates capacities when a counter trips.
I/O: ONE packed uint8 upload per batch (byte = code<<6 | min(qual,63);
255 = pad/N), ONE small int32 metadata array, ONE packed int32 download.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..index import kmer as kmod
from ..ops import fm as dfm
from ..ops.fm import M32
from ..ops.fm import nonzero_fixed as _nonzero_fixed
from ..ops.sw import NEG_INF, SwConfig
from ..ops.sw_banded import banded_dp
from ..parallel.mesh import device_scope, replicate
from ..utils import trace

INT32_MIN = -(1 << 31)


def _pow2(n: int, lo: int = 1) -> int:
    return max(lo, 1 << max(0, int(n - 1).bit_length()))


class CandGenCfg(NamedTuple):
    """Static shape/config parameters of one pipeline call: the fields of
    the reference package's CandGenCfg that its small-index shapes read
    (its engine switch is gone: here the device of the tensors picks the
    kernels)."""
    B: int            # reads per batch (padded)
    L: int            # padded read length
    S: int            # max seeds per strand per round
    R: int            # seed rounds (statically unrolled)
    E: int            # max SA elements resolved per range
    seed_len: int
    K: int            # DP band width
    k1: int           # 1mm surviving-branch capacity per chunk
    chunk_w: int      # 1mm branch positions per chunk (short shape)
    n_chunks: int
    NH: int           # hit-range capacity (level-1 compaction)
    C_pre: int        # resolved-element capacity (pre-dedup)
    C_max: int        # unique-candidate capacity
    sw: SwConfig
    has_short: bool = False   # the general short-read shape (module doc)
    kmer_mode: str = "sorted"  # 'cuckoo' or 'sorted'
    kmer_steps: int = 1       # binary-search trip count of the sorted table
    n_hi: int = 16            # key split of the seed table
    n_lo: int = 6
    bbits: int = 20
    tbits: int = 0            # cuckoo bucket bits
    salt: int = 0             # cuckoo hash salt
    RS: int = 0               # reseed-round lane-compaction capacity
                              # (0 = off)
    boost_thresh: int = 300  # ref: bt2_search.cpp:4086 seedBoostThresh
    mmtab_t: tuple = ()      # static mm-penalty-by-quality table
    sched: tuple | None = None  # static per-round seed offsets (uniform
                                # batches); None = per-read schedule
    static_len: int = 0         # the uniform read length when sched is set
    raw_len: int = 0            # >0: packed2 is raw [1, B, raw_len]
    seed_mms: int = 0           # -N: in-seed substitutions (general shape)
    no_exact_up: bool = False   # --no-exact-upfront
    no_1mm_up: bool = False     # --no-1mm-upfront
    big: bool = False           # big index: uint32 rows, walk-left
                                # resolution (its sampling exponent is
                                # the index's), biased diagonals
    pack5: bool = False         # compact 5-row output layout of width
                                # C_max+128 (vs the full 7 x C_max):
                                # L<=256, K<=256, B <= 2^18


class DeviceIndex(NamedTuple):
    """Device tensors of the index. The FM directions are read by the
    general shape only (None where a caller runs the fast shape alone)."""
    joined: torch.Tensor        # [n] uint8 packed unambiguous text
    joined_words: torch.Tensor  # [rows, 8] int64 (uint32 words) — 128
                                # bases per row
    run_starts: torch.Tensor    # [R] int64 unambiguous-run joined starts
    run_ends: torch.Tensor      # [R] int64 run joined ends
    fw: dfm.DeviceFm | None = None
    mirror: dfm.DeviceFm | None = None


def _pack_joined_words(joined: np.ndarray) -> np.ndarray:
    """2-bit pack into uint32 words (16 bases/word, LE), then reshape to
    [rows, 8]: one row = 128 bases."""
    n = len(joined)
    nrows = (n + 127) // 128 + 3   # +3 pad rows: band window overhang
    pad = np.zeros(nrows * 128, np.uint32)
    pad[:n] = joined
    words = (pad.reshape(-1, 16) << (2 * np.arange(16, dtype=np.uint32))
             ).sum(axis=1, dtype=np.uint64).astype(np.uint32)
    return words.reshape(-1, 8)


def make_device_index(idx, device, fw=None, mirror=None) -> DeviceIndex:
    """The index's device tensors; fw/mirror: its DeviceFm directions."""
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return DeviceIndex(
        joined=put(idx.joined),
        joined_words=put(_pack_joined_words(idx.joined).astype(np.int64)),
        run_starts=put(idx.run_joined_start.astype(np.int64)),
        run_ends=put(np.append(idx.run_joined_start[1:],
                               idx.n).astype(np.int64)),
        fw=fw, mirror=mirror)


# ------------------------------------------------------------ device utils -

def _rev_rows(a, lens, fill: int):
    """[B, L] per-row reversal within each row's length (fill beyond)."""
    L = a.shape[1]
    src = lens.to(torch.int64)[:, None] - 1 - torch.arange(
        L, device=a.device)[None, :]
    g = a.gather(1, src.clamp(0, L - 1))
    return torch.where(src >= 0, g, fill).to(a.dtype)


def _seg_max(data, ids, n: int):
    """Per-segment max; empty segments hold INT32_MIN (as
    jax.ops.segment_max leaves them)."""
    out = torch.full((n,), INT32_MIN, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, ids.to(torch.int64), data, "amax")


def _seg_sum(data, ids, n: int):
    out = torch.zeros(n, dtype=torch.int32, device=data.device)
    return out.index_add_(0, ids.to(torch.int64), data.to(torch.int32))


def _static_table(table: tuple, idx):
    """Table lookup by a run of wheres over the table's change points
    (values wrap to uint8, as the reference's uint8 table does)."""
    out = torch.full(idx.shape, int(table[0]) & 255, dtype=torch.int32,
                     device=idx.device)
    for q in range(1, len(table)):
        if table[q] != table[q - 1]:
            out = torch.where(idx >= q, int(table[q]) & 255, out)
    return out


def _rolling_keys(codes4, n_pack: int, shift0: int, reverse: bool):
    """Rolling 2-bit packed keys over [B, L] int64 code rows. Forward:
    key[j] packs codes[j+shift0 .. j+shift0+n_pack). Reverse: key[j] packs
    codes[j-shift0], codes[j-shift0-1], ... (reverse-complement windows
    indexed by their last fw position)."""
    B, L = codes4.shape
    acc = torch.zeros((B, L), dtype=torch.int64, device=codes4.device)
    m = shift0 + n_pack
    if not reverse:
        pad = torch.nn.functional.pad(codes4, (0, m))
        for t in range(shift0, m):
            acc = ((acc << 2) | pad[:, t : t + L]) & 0xFFFFFFFF
    else:
        pad = torch.nn.functional.pad(codes4, (m, 0))
        for t in range(shift0, m):
            acc = ((acc << 2) | pad[:, m - t : m - t + L]) & 0xFFFFFFFF
    return acc


def _const(vals, dev):
    """A small int64 constant tensor on `dev`, copied from pinned memory
    without blocking: a copy from pageable memory would wait for all the
    work queued on the stream, serialising the batches in flight."""
    t = torch.tensor(vals, dtype=torch.int64)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


# meta word 0 bit layout
_LEN_BITS = 20
_F_ACT_FW = 1 << 20
_F_ACT_RC = 1 << 21
_F_SEED_R0 = 1 << 22
_F_EXACT_ONLY = 1 << 23   # report only perfect-score hits (seed_skip reads)


# ------------------------------------------------------------ the pipeline -

def fused_pipeline(didx: DeviceIndex, dkm, cfg: CandGenCfg, packed2, meta,
                   mmtab):
    """One whole search batch on the device of its tensors, in the shape
    cfg.has_short picks (module doc). dkm: the seed table (read by the fast
    shape only).

    packed2: [2, B, L] uint8 — byte 255 = pad/N, else code<<6|min(qual,63);
             slot 0 left-aligned, slot 1 right-aligned ([1, B, raw_len]
             when cfg.raw_len)
    meta:    [B, 5] int32 — [len|flag bits, minsc, seed interval, nrounds,
             perfect score]
    mmtab:   [64] int32 — unused (cfg.mmtab_t is the static table)

    Returns out_pack int32: [5, C_max+128] when cfg.pack5, else [7, C_max]
    (layouts as in the reference package's fused_pipeline).
    """
    B, L, E = cfg.B, cfg.L, cfg.E
    dev = meta.device
    i32 = torch.int32
    n_text = didx.joined.shape[0]
    # big index: diagonals biased to stay non-negative in uint32 (module
    # doc); rows from the FM ops are widened to int64 values (ops/fm.py)
    BIAS = cfg.L + cfg.K if cfg.big else 0
    wide = dfm.widen

    def ar(n, dtype=i32):
        return torch.arange(n, dtype=dtype, device=dev)

    # ---- unpack the transfer-packed batch ----
    m0 = meta[:, 0]
    lens = m0 & ((1 << _LEN_BITS) - 1)
    act_fw = (m0 & _F_ACT_FW) > 0
    act_rc = (m0 & _F_ACT_RC) > 0
    seed_r0_active = (m0 & _F_SEED_R0) > 0
    ex_only = (m0 & _F_EXACT_ONLY) > 0
    minsc = meta[:, 1]
    interval = meta[:, 2].clamp_min(1)
    nrounds = meta[:, 3].clamp_min(1)
    perfect = meta[:, 4]

    if cfg.raw_len:
        enc = packed2[0].to(i32)                        # [B, raw_len]
        la = torch.nn.functional.pad(enc, (0, L - cfg.raw_len), value=255)
        ra = torch.nn.functional.pad(enc, (L - cfg.raw_len, 0), value=255)
    else:
        la, ra = packed2[0].to(i32), packed2[1].to(i32)
    is_n = la == 255
    fw_seqs = torch.where(is_n, 5, la >> 6)
    qual6 = torch.where(is_n, 0, la & 63)
    mm_fw = _static_table(cfg.mmtab_t, qual6)
    ra_codes = torch.where(ra == 255, 5, ra >> 6)
    la_codes = fw_seqs
    comp_ra = torch.where(ra_codes <= 3, 3 - ra_codes, ra_codes)

    # ---- per-read seed schedule (exact integer port of
    # UnpairedAligner.seed_offsets; ref: bt2_search.cpp:3848-3870,
    # aligner_seed.cpp:523-529); skipped when the schedule is static ----
    S, Ls = cfg.S, cfg.seed_len
    if cfg.sched is None:
        s_i = ar(S)[None, :]
        seed_start_l, seed_valid_l = [], []
        for r in range(cfg.R):
            ok = (interval > r) & (r < nrounds)
            off = torch.div(interval * r, nrounds, rounding_mode="floor")
            ok &= ~((off > 0) & (Ls + off > lens))
            nseeds = torch.where(
                ok, 1 + torch.where(
                    lens - off > Ls,
                    torch.div(lens - off - Ls, interval,
                              rounding_mode="floor"), 0), 0)
            seed_start_l.append(off[:, None] + s_i * interval[:, None])
            seed_valid_l.append(s_i < nseeds[:, None])
        seed_start = torch.stack(seed_start_l, dim=1)   # [B, R, S]
        seed_valid = torch.stack(seed_valid_l, dim=1)

    # the right-aligned layout makes reversal a flip:
    # flip(ra)[j] = fw[len-1-j]
    rc_seqs = torch.flip(comp_ra, dims=[1])
    mm_ra = torch.where(ra == 255, 0, _static_table(cfg.mmtab_t, ra & 63))
    mm_rc = torch.flip(mm_ra, dims=[1])
    both = torch.cat([fw_seqs, rc_seqs])                # [2B, L] lane order
    mm_both = torch.cat([mm_fw, mm_rc])

    lens2 = torch.cat([lens, lens])
    act2 = torch.cat([act_fw, act_rc])
    lane2 = ar(2 * B, torch.int64)
    zero = torch.zeros((), dtype=i32, device=dev)
    # ranges to resolve: (lane, depth, top, count, src), src 0 = fw SA,
    # 1 = mirror SA of a whole read, 2 = the seed position table, 3 = mirror
    # SA of a seed (its depth field carries depth + seed length)
    r_lane, r_depth, r_top, r_cnt, r_src = [], [], [], [], []
    cnt_fw = cnt_mr = zero
    round_active = seed_r0_active
    seeds_failed_r0 = torch.zeros(B, dtype=torch.bool, device=dev)
    n_seed_ct = zero
    # a full-read exact copy is in EVERY seed's range, so clipping can hide
    # one only when ALL of a strand's round-0 seed ranges clipped at E
    read_clip = torch.zeros(B, dtype=torch.bool, device=dev)
    reseed_max = zero

    def add_ranges(lane, depth, top, cnt, src):
        r_lane.append(lane)
        r_depth.append(depth)
        r_top.append(top)
        r_cnt.append(cnt)
        r_src.append(torch.full(lane.shape, src, dtype=i32, device=dev))

    if cfg.has_short:
        both_u8 = both.to(torch.uint8)
        # ---- recorded backward pass of both strands on the fw index:
        # exact ranges, and the per-suffix ranges that seed the
        # substitution branches ----
        tops, bots = dfm.backward_search_record_body(didx.fw, both_u8, lens2)
        s_ex = lens2.clamp(0, L).to(torch.int64)
        et, eb = wide(tops[s_ex, lane2]), wide(bots[s_ex, lane2])
        exact_ok = act2 & (et < eb)
        exact_cnt = torch.where(exact_ok, eb - et, 0).to(
            torch.int64).clamp_max(1 << 30)
        exact_mult = (exact_cnt[:B] + exact_cnt[B:]).clamp_max(1 << 30)
        if not cfg.no_exact_up:
            # --no-exact-upfront drops the dedicated exact ranges (the seed
            # ranges still find exact hits)
            add_ranges(lane2, torch.zeros(2 * B, dtype=i32, device=dev), et,
                       torch.where(exact_ok, eb - et, 0).clamp_max(E), 0)

        # ---- 1-substitution branches of both halves, the right halves on
        # the mirror index over the reversed reads ----
        def one_mm(fm, pat, hi, tops_, bots_):
            outs, max_cnt = [], zero
            for c in range(cfg.n_chunks):
                cb, _, pos, top, bot, count = dfm.one_mm_phase0_body(
                    fm, pat, lens2, hi, tops_, bots_, c * cfg.chunk_w,
                    cfg.chunk_w, cfg.k1)
                posf, topf, botf = dfm.one_mm_phase1_body(
                    fm, pat, cb, pos, top, bot, L // 2 + 2)
                topf, botf = wide(topf), wide(botf)
                ok = (cb >= 0) & (posf < 0) & (topf < botf)
                outs.append((cb, topf, botf, ok))
                max_cnt = torch.maximum(max_cnt, count)
            return outs, max_cnt

        half2 = torch.div(lens2, 2, rounding_mode="floor")
        act_1mm = act2 & (not cfg.no_1mm_up)
        hits_fw, cnt_fw = one_mm(didx.fw, both_u8,
                                 torch.where(act_1mm, half2, 0), tops, bots)
        rev2 = _rev_rows(both_u8, lens2, 5)
        tops_m, bots_m = dfm.backward_search_record_body(didx.mirror, rev2,
                                                         lens2)
        hits_mr, cnt_mr = one_mm(didx.mirror, rev2,
                                 torch.where(act_1mm, lens2 - half2, 0),
                                 tops_m, bots_m)
        for hits, src in ((hits_fw, 0), (hits_mr, 1)):
            for cb, topf, botf, ok in hits:
                add_ranges(cb.clamp(0, 2 * B - 1),
                           torch.zeros(cfg.k1, dtype=i32, device=dev), topf,
                           torch.where(ok, botf - topf, 0).clamp_max(E), src)

        # ---- FM seed search with per-read truncated seeds ----
        sl = lens.clamp_max(Ls)
        js = ar(Ls)
        bsel = ar(B, torch.int64)[:, None, None]
        in_seed = js[None, None, :] < sl[:, None, None]
        for r in range(cfg.R):
            sv = seed_valid[:, r, :] & round_active[:, None]      # [B, S]
            start_fw = seed_start[:, r, :]
            start_rc = lens[:, None] - start_fw - sl[:, None]
            pats, valids, depths, lanes = [], [], [], []
            for off_lane, seqs_, starts, act_s in (
                    (0, fw_seqs, start_fw, act_fw),
                    (B, rc_seqs, start_rc, act_rc)):
                idxc = (starts[:, :, None] + js[None, None, :]).clamp(
                    0, L - 1).to(torch.int64)
                pat = seqs_[bsel, idxc]                         # [B, S, Ls]
                has_n = ((pat > 3) & in_seed).any(2)
                valids.append(sv & act_s[:, None] & ~has_n & (starts >= 0))
                pats.append(torch.where(in_seed, pat, 5))
                depths.append(starts)
                lanes.append((ar(B) + off_lane)[:, None].expand(B, S))
            pat_all = torch.cat(pats).reshape(2 * B * S, Ls).to(torch.uint8)
            val_all = torch.cat(valids).reshape(-1)
            dep_all = torch.cat(depths).reshape(-1)
            lane_all = torch.cat(lanes).reshape(-1)
            slen_all = sl.repeat_interleave(S).repeat(2)
            slen_act = torch.where(val_all, slen_all, 0)
            if cfg.seed_mms >= 1:
                # -N 1 in-seed substitution branches (ref:
                # aligner_seed.cpp:668 searchSeedBi with one mismatch): left
                # halves on the fw index, right halves on the mirror index
                # over the reversed seeds; src 0 hits resolve like exact
                # seed ranges, src 3 marks mirror seed ranges. The seeds'
                # recorded pass also gives their exact ranges (its entry at
                # the seed length, an empty one as (0, 0)): the ftab search
                # would walk the same seeds again for the same ranges
                NP = pat_all.shape[0]
                half_s = torch.div(slen_all, 2, rounding_mode="floor")
                cw_s = max(1, min(_pow2(Ls, lo=8),
                                  (1 << 22) // max(NP * 4, 1)))
                tops_s, bots_s = dfm.backward_search_record_body(
                    didx.fw, pat_all, slen_act)
                ent = (slen_act.to(torch.int64), ar(NP, torch.int64))
                stop, sbot = wide(tops_s[ent]), wide(bots_s[ent])
                empty = stop >= sbot
                stop = torch.where(empty, 0, stop)
                sbot = torch.where(empty, 0, sbot)
                rev_pat = _rev_rows(pat_all, slen_all, 5)
                tops_m2, bots_m2 = dfm.backward_search_record_body(
                    didx.mirror, rev_pat, slen_act)

                def seed_one_mm(fm, pats_, his, tops_, bots_, mirror, over):
                    for c in range(-(-Ls // cw_s)):
                        cb, _, pos1, top1, bot1, cnt1 = \
                            dfm.one_mm_phase0_body(
                                fm, pats_, slen_act, his, tops_, bots_,
                                c * cw_s, cw_s, cfg.k1)
                        posf, topf, botf = dfm.one_mm_phase1_body(
                            fm, pats_, cb, pos1, top1, bot1, Ls + 2)
                        topf, botf = wide(topf), wide(botf)
                        ok1 = (cb >= 0) & (posf < 0) & (topf < botf)
                        cbc = cb.clamp(0, NP - 1).to(torch.int64)
                        dep1 = dep_all[cbc]
                        if mirror:
                            dep1 = dep1 + slen_all[cbc]
                        add_ranges(lane_all[cbc], dep1, topf,
                                   torch.where(ok1, botf - topf,
                                               0).clamp_max(E),
                                   3 if mirror else 0)
                        over = torch.maximum(over, cnt1)
                    return over

                cnt_fw = seed_one_mm(didx.fw, pat_all,
                                     torch.where(val_all, half_s, 0),
                                     tops_s, bots_s, False, cnt_fw)
                cnt_mr = seed_one_mm(didx.mirror, rev_pat,
                                     torch.where(val_all, slen_all - half_s,
                                                 0),
                                     tops_m2, bots_m2, True, cnt_mr)
            else:
                stop, sbot = map(wide, dfm.backward_search_body(
                    didx.fw, pat_all, slen_act, use_ftab=True))

            n_seed_ct = n_seed_ct + val_all.sum(dtype=i32)
            hit = val_all & (stop < sbot)
            hits_n = torch.where(hit, sbot - stop, 0).clamp_max(1 << 20)
            add_ranges(lane_all, dep_all, stop, hits_n.clamp_max(E), 0)
            read_of = lane_all % B
            inst = _seg_sum(val_all, read_of, B)
            nonz = _seg_sum(hit, read_of, B)
            tot = _seg_sum(hits_n, read_of, B)
            if r == 0:
                seeds_failed_r0 = seed_r0_active & ((inst == 0) | (nonz == 0))
            round_active = (round_active & (inst > 0) & (nonz > 0)
                            & (tot >= cfg.boost_thresh * nonz))
    else:
        # ---- seed rounds through the k-mer table ----

        def _seed_lookup(qh, ql):
            if cfg.kmer_mode == "cuckoo":
                return kmod.cuckoo_lookup(dkm, qh, ql, cfg.tbits, cfg.salt)
            return kmod.lookup_body(dkm, qh, ql, cfg.n_hi, cfg.bbits,
                                    cfg.kmer_steps)

        n_hi, n_lo = cfg.n_hi, cfg.n_lo
        codes4f = torch.where(la_codes <= 3, la_codes, 0).to(torch.int64)
        khi_fw = _rolling_keys(codes4f, n_hi, 0, False)
        klo_fw = (_rolling_keys(codes4f, n_lo, n_hi, False)
                  if n_lo else torch.zeros_like(khi_fw))
        codes4r = torch.where(ra_codes <= 3, comp_ra, 0).to(torch.int64)
        khi_rc = _rolling_keys(codes4r, n_hi, 0, True)
        klo_rc = (_rolling_keys(codes4r, n_lo, n_hi, True)
                  if n_lo else torch.zeros_like(khi_rc))
        # N-in-window flags, shared by both strands
        ncum = torch.nn.functional.pad(
            torch.cumsum(is_n.to(i32), 1, dtype=i32), (1, 0))    # [B, L+1]
        ncum = torch.cat([ncum, ncum[:, -1:].expand(B, Ls)], 1)  # edge pad
        lanes_fw = ar(B)[:, None]

        for r in range(cfg.R):
            # round 0 also looks up seeds of exact-only (seed_skip) reads,
            # which never count toward the reseeding stats below
            lk_active = (round_active | (ex_only & (act_fw | act_rc))
                         if r == 0 else round_active)
            if cfg.sched is not None:
                # batch-uniform schedule: static seed columns
                offs = cfg.sched[r]
                if not offs:
                    if r == 0:
                        seeds_failed_r0 = seed_r0_active
                    round_active = torch.zeros(B, dtype=torch.bool, device=dev)
                    continue
                S_r = len(offs)
                len0 = cfg.static_len
                oc = _const(offs, dev)
                # rc window indexed by its last fw position o + Ls - 1; the ra
                # column of fw position k is L - len + k
                rcol = oc + (L - len0 + Ls - 1)
                q_hi_f, q_lo_f = khi_fw[:, oc], klo_fw[:, oc]
                q_hi_r, q_lo_r = khi_rc[:, rcol], klo_rc[:, rcol]
                win_n = (ncum[:, oc + Ls] - ncum[:, oc]) > 0
                d_fw = oc.to(i32)[None, :].expand(B, S_r)
                d_rc = ((len0 - Ls) - oc).to(i32)[None, :].expand(B, S_r)
                sv = lk_active[:, None].expand(B, S_r)
                ok_f = sv & act_fw[:, None] & ~win_n
                ok_r = sv & act_rc[:, None] & ~win_n
            else:
                S_r = S
                sv = seed_valid[:, r, :] & lk_active[:, None]     # [B, S]
                d_fw = seed_start[:, r, :]                        # [B, S]
                d_rc = lens[:, None] - d_fw - Ls
                dc = d_fw.clamp(0, L - 1).to(torch.int64)
                q_hi_f = khi_fw.gather(1, dc)
                q_lo_f = klo_fw.gather(1, dc)
                # rc window indexed by its last fw position q = d_fw+Ls-1;
                # ra column of fw position k is L - len + k
                qcol = (L - lens[:, None] + d_fw + Ls - 1).clamp(
                    0, L - 1).to(torch.int64)
                q_hi_r = khi_rc.gather(1, qcol)
                q_lo_r = klo_rc.gather(1, qcol)
                ecol = (d_fw + Ls).clamp(0, ncum.shape[1] - 1).to(torch.int64)
                win_n = (ncum.gather(1, ecol) - ncum.gather(1, dc)) > 0
                ok_f = sv & act_fw[:, None] & ~win_n & (d_fw >= 0)
                ok_r = sv & act_rc[:, None] & ~win_n & (d_rc >= 0)
            q_hi = torch.cat([q_hi_f, q_hi_r]).reshape(-1)
            q_lo = torch.cat([q_lo_f, q_lo_r]).reshape(-1)
            val_all = torch.cat([ok_f, ok_r]).reshape(-1)
            dep_all = torch.cat([d_fw, d_rc]).reshape(-1)
            lane_all = torch.cat([lanes_fw.expand(B, S_r),
                                  (lanes_fw + B).expand(B, S_r)]).reshape(-1)
            Ntot = q_hi.shape[0]
            if r == 0 or cfg.RS == 0 or cfg.RS >= Ntot:
                start, cnt = _seed_lookup(q_hi, q_lo)
                n_seed_ct = n_seed_ct + val_all.sum(dtype=i32)
                cnt = torch.where(val_all, cnt, 0)
                st_val = val_all
            else:
                # reseed rounds fire for few reads: compact the active lanes
                # to cfg.RS rows before the table probes (overflow -> counter
                # slot 8 -> host capacity escalation)
                n_act = val_all.sum(dtype=i32)
                reseed_max = torch.maximum(reseed_max, n_act)
                sel_r = _nonzero_fixed(val_all, cfg.RS, Ntot)
                ok_c = sel_r < Ntot
                selc = sel_r.clamp(0, Ntot - 1)
                start, cnt = _seed_lookup(q_hi[selc], q_lo[selc])
                n_seed_ct = n_seed_ct + n_act
                cnt = torch.where(ok_c, cnt, 0)
                dep_all = dep_all[selc]
                lane_all = lane_all[selc].clamp(0, 2 * B - 1)
                st_val = ok_c
            hit = st_val & (cnt > 0)
            add_ranges(lane_all, dep_all, start, cnt.clamp_max(E), 2)

            read_of = lane_all % B
            if r == 0:
                unclip2 = _seg_max((st_val & (cnt <= E)).to(i32), lane_all,
                                   2 * B) > 0
                any2 = _seg_max(st_val.to(i32), lane_all, 2 * B) > 0
                allclip2 = any2 & ~unclip2
                read_clip = allclip2[:B] | allclip2[B:]
            # reseeding stats never include exact-only lanes
            st_ok = st_val & ~ex_only[read_of]
            inst = _seg_sum(st_ok, read_of, B)
            nonz = _seg_sum(hit & st_ok, read_of, B)
            tot = _seg_sum(torch.where(st_ok, cnt, 0), read_of, B)
            if r == 0:
                seeds_failed_r0 = seed_r0_active & ((inst == 0) | (nonz == 0))
            round_active = (round_active & (inst > 0) & (nonz > 0)
                            & (tot >= cfg.boost_thresh * nonz))

    # ---- assemble ranges -> elements -> resolve (two-level compaction:
    # hit ranges first, then their elements) ----
    r_lane = torch.cat(r_lane).to(i32)
    r_depth = torch.cat(r_depth).to(i32)
    r_top = torch.cat(r_top).to(torch.int64)
    r_cnt = torch.cat(r_cnt).to(i32)
    NR = r_lane.shape[0]
    NH = cfg.NH
    hitr = r_cnt > 0
    n_hit = hitr.sum(dtype=i32)
    hsel = _nonzero_fixed(hitr, NH, NR)
    hidx = hsel.clamp(0, NR - 1)
    h_lane, h_depth, h_top = r_lane[hidx], r_depth[hidx], r_top[hidx]
    h_cnt = torch.where(hsel >= NR, 0, r_cnt[hidx] & 0xFFFF)

    ev = (ar(E)[None, :] < h_cnt[:, None]).reshape(-1)
    n_elts = ev.sum(dtype=i32)
    sel = _nonzero_fixed(ev, cfg.C_pre, NH * E)
    pad = sel >= NH * E
    ridx = torch.div(sel, E, rounding_mode="floor").clamp(0, NH - 1)
    lane = h_lane[ridx]
    e_depth = h_depth[ridx]
    row = h_top[ridx] + sel % E
    if cfg.has_short:
        src = torch.cat(r_src)[hidx][ridx]
        is_m = (src == 1) | (src == 3)
        rl = lens[lane % B]
        if cfg.big:
            # walk-left over the sampled SA, one pass a direction (ref:
            # walkLeft/getOffset, bt2_idx.h:1607)
            off_fw = wide(dfm.resolve_rows_body(
                didx.fw, dfm.narrow(row.clamp_max(didx.fw.n - 1)),
                ~pad & ~is_m))
            off_mr = wide(dfm.resolve_rows_body(
                didx.mirror, dfm.narrow(row.clamp_max(didx.mirror.n - 1)),
                ~pad & is_m))
        else:
            off_fw = didx.fw.sa[row.clamp(0, didx.fw.sa.shape[0] - 1)]
            off_mr = didx.mirror.sa[row.clamp(0,
                                              didx.mirror.sa.shape[0] - 1)]
        off = torch.where(is_m, off_mr, off_fw)
        # src 1: a whole read's mirror range; src 3: a mirror seed range
        # whose depth field carries depth + seed length
        diag = torch.where(src == 1, n_text + BIAS - off - rl,
                           torch.where(src == 3,
                                       n_text + BIAS - off - e_depth,
                                       off + BIAS - e_depth))
        e_ok = ~pad & (diag + rl > BIAS)       # diag > -rl, unbiased
    else:
        # the fast shape: every range is a seed-table range (src 2)
        n_keys = dkm.pos.shape[0]
        off = dkm.pos[row.clamp(0, n_keys - 1)].to(i32)
        diag = off - e_depth
        e_ok = ~pad & (diag > -L)

    # ---- dedup on (lane, diag): one sort of the packed int64 key
    # lane<<32 | (diag + 2^31), which orders like the 2-key sort (a big
    # index's diagonals are uint32: lane<<32 | diag) ----
    doff = 0 if cfg.big else 1 << 31
    key_lane = torch.where(e_ok, lane, 1 << 30)
    key = (key_lane.to(torch.int64) << 32) | ((diag.to(torch.int64) + doff)
                                              & M32)
    key = torch.sort(key).values
    s_lane = (key >> 32).to(i32)
    s_diag = (key & M32) - doff
    prev_lane = torch.cat([torch.full((1,), -1, dtype=i32, device=dev),
                           s_lane[:-1]])
    prev_diag = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           s_diag[:-1]])
    uniq = (s_lane < (1 << 30)) & ((s_lane != prev_lane)
                                   | (s_diag != prev_diag))
    n_cand = uniq.sum(dtype=i32)
    csel = _nonzero_fixed(uniq, cfg.C_max, cfg.C_pre)
    cpad = csel >= cfg.C_pre
    cselc = csel.clamp(0, cfg.C_pre - 1)
    c_lane = torch.where(cpad, 0, s_lane[cselc])
    c_diag = torch.where(cpad, 0, s_diag[cselc])
    c_valid = ~cpad

    # ---- banded DP over interior candidates ----
    K = cfg.K
    c_read = c_lane % B
    c_fw = c_lane < B
    c_rl = lens[c_read]
    n_runs = didx.run_starts.shape[0]
    if cfg.big:
        # biased uint32 geometry: the run bounds carry the same bias, and
        # a padding candidate's window start wraps below 0 as in uint32
        ws = (c_diag - K // 2) & M32
        run_i = (torch.searchsorted(didx.run_starts + BIAS, c_diag,
                                    right=True) - 1).clamp(0, n_runs - 1)
        lo = didx.run_starts[run_i] + BIAS
        hi_run = didx.run_ends[run_i] + BIAS
        interior = (c_valid & (ws >= lo)
                    & (((ws + c_rl + K) & M32) <= hi_run))
        wsc = ws.clamp(BIAS, max(n_text - 1, 1) + BIAS) - BIAS
    else:
        ws = c_diag - K // 2
        run_i = (torch.searchsorted(didx.run_starts, c_diag.clamp_min(0),
                                    right=True) - 1).clamp(0, n_runs - 1)
        lo = didx.run_starts[run_i]
        hi_run = didx.run_ends[run_i]
        interior = c_valid & (ws >= lo) & (ws + c_rl + K <= hi_run)
        wsc = ws.clamp(0, max(n_text - 1, 1))

    Cx = cfg.C_max
    W = L + K
    # reference window: gather 128-base rows, then select the word offset
    # inside the first row and the base offset inside the word
    nw = W // 16 + 2
    n_rows = didx.joined_words.shape[0]
    nrow_g = -(-(nw + 7) // 8)
    r0 = wsc >> 7
    woff = (wsc >> 4) & 7
    sh = wsc & 15
    rgat = didx.joined_words[(r0[:, None] + ar(nrow_g, torch.int64)[None, :]
                              ).clamp(0, n_rows - 1)]      # [C, nrow_g, 8]
    words = rgat.reshape(Cx, nrow_g * 8)
    wwin = words.gather(1, woff[:, None] + ar(nw, torch.int64)[None, :])
    unp = torch.stack([(wwin >> (2 * t)) & 3 for t in range(16)], dim=2)
    unp = unp.reshape(Cx, nw * 16)
    band = unp.gather(1, sh[:, None] + ar(W, torch.int64)[None, :]).to(i32)
    lane_c = c_lane.clamp(0, 2 * B - 1)
    rd_c = both[lane_c]                                  # [C, L]
    mm_c = mm_both[lane_c]
    lens_c = c_rl.clamp_min(1)

    best, bi, bk = banded_dp(cfg.sw, K, rd_c.T.contiguous(),
                             mm_c.T.contiguous(), lens_c.contiguous(),
                             band.T.contiguous())
    c_end = ws + bi + bk
    if cfg.big:
        c_end = c_end & M32
    c_score = torch.where(interior, best, NEG_INF)

    # ---- center-diagonal ungapped stats: a winner is certified ungapped
    # iff its DP end sits on the last read row, its start column is the
    # candidate's own diagonal (band center K//2), and the pure diagonal
    # reproduces the DP score ----
    in_rl = ar(L)[None, :] < c_rl[:, None]
    ref_d = band[:, K // 2 : K // 2 + L]
    isn_c = rd_c > 3
    mism = (rd_c != ref_d) & ~isn_c & in_rl
    swc = cfg.sw
    step_sc = torch.where(isn_c, -swc.npen,
                          torch.where(mism, -mm_c, swc.ma))
    usc = torch.where(in_rl, step_sc, 0).sum(1, dtype=i32)
    nm_c = (mism | (isn_c & in_rl)).sum(1, dtype=i32)
    ungapped_c = (bi == c_rl - 1) & (bk == K // 2) & (usc == best)
    row6 = nm_c.clamp_max((1 << 16) - 1) | (ungapped_c.to(i32) << 16)

    # ---- per-read selection (best + secbest-distinct-end) ----
    sel_ok = interior & (c_score >= minsc[c_read])
    if not cfg.has_short:
        # seed_skip (exact-only) reads keep hits the up-front stages would
        # find without seeds: perfect matches and ungapped
        # <=1-substitution hits (the general shape runs those stages)
        allow_up = torch.zeros_like(sel_ok)
        if not cfg.no_exact_up:
            allow_up |= c_score == perfect[c_read]
        if not cfg.no_1mm_up:
            allow_up |= ungapped_c & (nm_c == 1)
        sel_ok &= ~ex_only[c_read] | allow_up
    sc = torch.where(sel_ok, c_score, NEG_INF)
    best_sc = _seg_max(sc, c_read, B)
    is_bs = sel_ok & (c_score == best_sc[c_read])
    # the leftmost diagonal: the largest negation (over uint32 for a big
    # index, the bitwise complement)
    if cfg.big:
        neg, neg_fill = M32 - c_diag, 0
    else:
        neg, neg_fill = -c_diag, -(1 << 30)
    best_nd = _seg_max(torch.where(is_bs, neg, neg_fill), c_read, B)
    is_bd = is_bs & (neg == best_nd[c_read])
    fwi = torch.where(is_bd, c_fw.to(i32), -1)
    best_fwi = _seg_max(fwi, c_read, B)
    is_bf = is_bd & (c_fw.to(i32) == best_fwi[c_read])
    best_ci = _seg_max(torch.where(is_bf, ar(Cx), -1), c_read,
                       B).clamp_min(-1)

    bcl = best_ci.clamp(0, Cx - 1)
    best_end_r = c_end[bcl]
    best_fw_r = c_fw[bcl]
    sec_ok = sel_ok & ((c_end != best_end_r[c_read])
                       | (c_fw != best_fw_r[c_read]))
    sec_sc = _seg_max(torch.where(sec_ok, c_score, NEG_INF), c_read, B)
    has_rect = _seg_max((c_valid & ~interior).to(i32), c_read,
                        B).clamp_min(0)

    if not cfg.has_short:
        # exact hits recovered from DP scores: a perfect-score candidate IS
        # a full-read exact match; a clipped seed range may hide further
        # exact copies -> conservative E+1 escape
        is_perf = sel_ok & (c_score == perfect[c_read])
        n_perf = _seg_sum(is_perf, c_read, B)
        exact_mult = torch.where(read_clip & (best_sc == perfect), E + 1,
                                 n_perf)

    # ---- pack outputs (single D2H array) ----
    best_pack = (((best_ci + 1) << 2) | (has_rect.clamp_max(1) << 1)
                 | seeds_failed_r0.to(i32))
    counters = torch.stack([n_cand, n_elts, cnt_fw, cnt_mr, n_hit,
                            n_seed_ct, interior.sum(dtype=i32),
                            (interior & ungapped_c).sum(dtype=i32),
                            reseed_max]).to(i32)
    if cfg.pack5:
        # r0: valid | interior<<1 | fw<<2 | read<<4 (18b) | nm<<22 (9b)
        #     | ungapped<<31
        # r2: score clamped +-30000, biased +32768 (16b) | (bi<<8|bk)<<16
        # r3: best_pack : B;  r4: [sec16<<16 | mult16 : B | counters : 9]
        Wp = Cx + 128
        i64 = torch.int64
        r0 = dfm.narrow(c_valid.to(i64) | (interior.to(i64) << 1)
                     | (c_fw.to(i64) << 2) | (c_read.to(i64) << 4)
                     | (nm_c.clamp_max(511).to(i64) << 22)
                     | (ungapped_c.to(i64) << 31))
        sc16 = c_score.clamp(-30000, 30000).to(i64) + 32768
        bibk = (bi.clamp(0, 255).to(i64) << 8) | bk.clamp(0, 255).to(i64)
        r2 = dfm.narrow(sc16 | (bibk << 16))
        sec16 = sec_sc.clamp(-30000, 30000).to(i64) + 32768
        secmult = dfm.narrow((sec16 << 16)
                          | exact_mult.to(i64).clamp_max(65535))
        out = torch.zeros((5, Wp), dtype=i32, device=dev)
        out[0, :Cx] = r0
        out[1, :Cx] = dfm.narrow(c_diag)
        out[2, :Cx] = r2
        out[3, :B] = best_pack
        out[4, :B] = secmult
        out[4, Wp - 9 :] = counters
        return out
    out = torch.zeros((7, Cx), dtype=i32, device=dev)
    out[0] = ((c_read << 4) | (c_fw.to(i32) << 2) | (interior.to(i32) << 1)
              | c_valid.to(i32))
    out[1] = dfm.narrow(c_diag)
    out[2] = c_score
    out[3] = (bi << 8) | bk.clamp(0, 255)
    out[4, :B] = best_pack
    out[4, B : 2 * B] = sec_sc.clamp_min(NEG_INF)
    out[5, :B] = exact_mult.to(i32)
    out[5, Cx - 9 :] = counters
    out[6] = row6
    return out


# --------------------------------------------------------------- host side -

def per_len(fn, lens):
    """Vectorize a scalar function of read length over a batch (few unique
    lengths per batch in practice)."""
    uniq, inv = np.unique(lens, return_inverse=True)
    vals = np.array([fn(int(l)) if l > 0 else fn(1) for l in uniq])
    return vals[inv]


def shard_overflows(counters, cfg) -> np.ndarray:
    """[ndev] bool: which shards' counters (rows of `counters`) outgrew a
    capacity of cfg."""
    c = np.asarray(counters)
    over = ((c[:, 0] > cfg.C_max) | (c[:, 1] > cfg.C_pre)
            | (c[:, 2] > cfg.k1) | (c[:, 3] > cfg.k1) | (c[:, 4] > cfg.NH))
    if cfg.RS > 0:
        over |= c[:, 8] > cfg.RS
    return over


class BatchResult:
    """Decoded outputs of one pipeline run (host numpy): `out` holds the
    ndev shards' blocks side by side along axis 1, their indices already
    global (`_to_global`)."""
    __slots__ = ("counters", "B0", "c_read", "c_fw", "c_diag", "c_score",
                 "c_end", "c_nm", "c_ungapped",
                 "c_bi", "c_bk", "c_interior", "c_ws", "best_ci", "best_sc",
                 "sec_sc", "exact_mult", "seeds_failed_r0", "has_rect",
                 "overflow")

    def __init__(self, B0, out, cfg, ndev, K):
        self.B0 = B0
        Cl, Bl = cfg.C_max, cfg.B
        if cfg.pack5:
            W = Cl + 128
            blk = [out[:, s * W : (s + 1) * W] for s in range(ndev)]
            bp = _join([b[3, :Bl] for b in blk])[:B0]
            secmult = _join([b[4, :Bl] for b in blk])[:B0]
            ctr = np.stack([b[4, W - 9 :] for b in blk])
            cand = _join([b[:3, :Cl] for b in blk], 1)
            r0 = cand[0].view(np.uint32)
            valid = (r0 & 1) > 0
            reads = ((r0 >> 4) & 0x3FFFF).astype(np.int32)
            keep = valid & (reads < B0)
            self.c_read = reads[keep]
            self.c_fw = ((r0 >> 2) & 1).astype(bool)[keep]
            self.c_interior = ((r0 >> 1) & 1).astype(bool)[keep]
            self.c_nm = ((r0 >> 22) & 0x1FF).astype(np.int32)[keep]
            self.c_ungapped = (r0 >> 31).astype(bool)[keep]
            self.c_diag = self._diag(cand[1][keep], cfg)
            r2 = cand[2][keep]
            sc = (r2 & 0xFFFF) - 32768
            self.c_score = np.where(sc <= -30000, NEG_INF, sc)
            self.c_bk = (r2 >> 16) & 0xFF
            self.c_bi = (r2 >> 24) & 0xFF
            sec_raw = ((secmult.view(np.uint32) >> 16)
                       .astype(np.int64) - 32768)
            sec = np.where(sec_raw <= -30000, NEG_INF, sec_raw)
            mult = (secmult & 0xFFFF).astype(np.int64)
        else:
            # the full 7-row layout: a shard's block is C_max columns
            row0 = out[0]
            blk = [out[:, s * Cl : (s + 1) * Cl] for s in range(ndev)]
            bp = _join([b[4, :Bl] for b in blk])[:B0]
            sec = _join([b[4, Bl : 2 * Bl] for b in blk])[:B0]
            mult = _join([b[5, :Bl] for b in blk])[:B0]
            ctr = np.stack([b[5, Cl - 9 :] for b in blk])
            valid = (row0 & 1) > 0
            reads = row0 >> 4
            keep = valid & (reads < B0)
            self.c_read = reads[keep]
            self.c_fw = ((row0 >> 2) & 1).astype(bool)[keep]
            self.c_interior = ((row0 >> 1) & 1).astype(bool)[keep]
            self.c_diag = self._diag(out[1][keep], cfg)
            self.c_score = out[2][keep]
            self.c_bi = (out[3] >> 8)[keep]
            self.c_bk = (out[3] & 255)[keep]
            self.c_nm = (out[6] & 0xFFFF)[keep]
            self.c_ungapped = ((out[6] >> 16) & 1).astype(bool)[keep]
        self.counters = ctr
        self.overflow = bool(shard_overflows(ctr, cfg).any())
        self.c_ws = self.c_diag - K // 2
        self.c_end = self.c_ws + self.c_bi + self.c_bk
        # remap best_ci (packed-array index) to compacted space
        remap = np.cumsum(keep) - 1
        bc = (bp >> 2) - 1
        self.best_ci = np.where(
            bc >= 0, remap[np.clip(bc, 0, len(keep) - 1)], -1).astype(np.int32)
        self.sec_sc = sec
        self.exact_mult = mult
        self.seeds_failed_r0 = (bp & 1).astype(bool)
        self.has_rect = ((bp >> 1) & 1).astype(bool)
        if len(self.c_read):
            self.best_sc = np.where(
                self.best_ci >= 0,
                self.c_score[np.clip(self.best_ci, 0,
                                     len(self.c_read) - 1)], NEG_INF)
        else:
            self.best_ci = np.full(B0, -1, np.int32)
            self.best_sc = np.full(B0, NEG_INF, np.int64)

    @staticmethod
    def _diag(row1, cfg):
        """The packed diagonals: a big index's are biased uint32 bit
        patterns."""
        if cfg.big:
            return row1.view(np.uint32).astype(np.int64) - (cfg.L + cfg.K)
        return row1


def _to_global(out, s: int, cfg: CandGenCfg):
    """Shard s's packed output, in place, with its read and candidate
    indices moved into the mesh's global space (JAX `_sharded_pipeline`):
    the read field of every valid candidate (bit 4 up in both layouts;
    pack5's is 18 bits, so dispatch keeps ndev * B <= 2^18) gains s * B,
    and best_ci (stored + 1 in the first B slots of the best-pack row)
    gains s * C_max. int32 arithmetic, as on the JAX side."""
    if s == 0:
        return out
    out[0] = torch.where((out[0] & 1) > 0, out[0] + ((s * cfg.B) << 4),
                         out[0])
    bp_row = 3 if cfg.pack5 else 4
    bp = out[bp_row, : cfg.B]
    ci1 = bp >> 2
    out[bp_row, : cfg.B] = torch.where(
        ci1 > 0, (((ci1 - 1 + s * cfg.C_max) + 1) << 2) | (bp & 3), bp)
    return out


def _staged(packed, meta, n: int, pinned: bool):
    """`packed` [planes, n*B, L] and `meta` [n*B, 5] (host numpy) as
    tensors laid out shard by shard, [n, planes, B, L] and [n, B, 5], so
    that each shard's block is contiguous; on the card in one pinned copy
    each, since only a copy from a contiguous pinned block runs
    asynchronously."""
    planes, Bp, L = packed.shape
    pk = torch.empty((n, planes, Bp // n, L), dtype=torch.uint8,
                     pin_memory=pinned)
    pk.numpy()[...] = packed.reshape(planes, n, Bp // n, L).swapaxes(0, 1)
    mt = torch.empty((n, Bp // n, meta.shape[1]), dtype=torch.int32,
                     pin_memory=pinned)
    mt.numpy()[...] = meta.reshape(mt.shape)
    return pk, mt


def _sharded_pipeline(cfg: CandGenCfg, devices, didx, dkm, packed, meta,
                      mmtab) -> list:
    """The fused pipeline over shards (JAX `_sharded_pipeline`, a
    shard_map over 'dp'): shard s runs on devices[s] with reads [s*B,
    (s+1)*B) of `packed` (axis 1) and `meta` (axis 0), host numpy; didx,
    dkm (None: no seed table) and mmtab map each distinct device to its
    replica. Every shard is enqueued before any is waited on: the
    pipeline has no host sync, so a card works while the host enqueues the
    next. Each shard's enqueue is a `cg.shard` span (`shard`; `reads`, its
    real reads: a padding row's seed interval, meta column 2, is 0, a
    read's at least 1). Returns each shard's (host result, the event
    recorded after its copy, or None on the CPU) for `_gather`."""
    pk, mt = _staged(packed, meta, len(devices), devices[0].type == "cuda")
    reads = (np.count_nonzero(meta[:, 2].reshape(len(devices), -1), axis=1)
             if trace.enabled() else np.zeros(len(devices), np.int64))
    shards = []
    for s, dev in enumerate(devices):
        with device_scope(dev), trace.span("cg.shard", shard=s,
                                           reads=int(reads[s])):
            shards.append(_launch_shard(
                s, dev, cfg, didx[dev], None if dkm is None else dkm[dev],
                pk[s], mt[s], mmtab[dev]))
    return shards


def _launch_shard(s, dev, cfg, didx, dkm, packed, meta, mmtab):
    """One shard's copies, pipeline, index remap and result copy on `dev`,
    which the caller has made current; packed and meta are its staged
    blocks (`_staged`)."""
    if dev.type == "cuda":
        # asynchronous copies: the host returns while the device works;
        # _gather waits on the event recorded after the result copy into
        # this shard's own pinned block
        up = lambda t: t.to(dev, non_blocking=True)
        out = _to_global(fused_pipeline(didx, dkm, cfg, up(packed),
                                        up(meta), mmtab), s, cfg)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done
    out = fused_pipeline(didx, dkm, cfg, packed.to(dev), meta.to(dev), mmtab)
    return _to_global(out, s, cfg).cpu(), None


def _join(parts, axis: int = 0) -> np.ndarray:
    """The shards' pieces end to end along `axis` (one shard: its own,
    not copied)."""
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis)


def _gather(shards) -> np.ndarray:
    """The shards' results side by side along axis 1 (the JAX
    out_specs=P(None, 'dp')), once each shard's copy has landed."""
    outs = []
    for host, done in shards:
        if done is not None:
            done.synchronize()
        outs.append(host.numpy())
    return _join(outs, 1)


class CandGen:
    """Host side of the fused device pipeline: padding/bucketing, packed
    transfers, dispatch (asynchronous on CUDA) and fetch; over a mesh, one
    pipeline a shard."""

    def __init__(self, dev_fw, dev_mirror, idx, pol, sw_cfg, K: int, device,
                 mesh=None):
        """dev_fw/dev_mirror: the index's DeviceFm directions on `device`
        (ops/fm.py), both small or both big. mesh: a parallel.mesh.Mesh
        whose first device is `device`; the index, its k-mer tables and
        the mismatch table are replicated once on each of its distinct
        devices (the JAX shard_map's P())."""
        self.device = torch.device(device)
        self.mesh = mesh
        self.devices = mesh.devices if mesh is not None else (self.device,)
        distinct = mesh.distinct if mesh is not None else self.devices
        if self.devices[0] != self.device:
            raise ValueError(f"the mesh's first device {self.devices[0]} "
                             f"is not {self.device}")
        self.big = dev_fw.big
        # sticky size_mult: the largest escalation that fetch saw succeed
        self._sticky = 1
        self.didx = make_device_index(idx, self.device, dev_fw, dev_mirror)
        self._didx = {d: replicate(self.didx, d)
                      for d in distinct}
        self._joined_host = idx.joined
        self._cache_base = getattr(idx, "cache_base", None)
        self.pol = pol
        self.sw_cfg = sw_cfg
        self.K = K
        self._mmtab_dev = None
        self._ktabs: dict[int, tuple] = {}

    def _mmtab(self, mmtab):
        """{device: the mismatch table} on each distinct device."""
        if self._mmtab_dev is None:
            t = torch.from_numpy(np.ascontiguousarray(mmtab[:64], np.int32))
            self._mmtab_dev = {d: t.to(d) for d in self._didx}
        return self._mmtab_dev

    def _kmer(self, seed_len: int):
        """({device: device table}, host table) for this seed length,
        cached. The cuckoo table is preferred; the sorted table is the
        fallback when placement fails."""
        hit = self._ktabs.get(seed_len)
        if hit is None:
            src = self._joined_host
            cb = self._cache_base
            tab = kmod.load_cuckoo_table(cb, seed_len, joined=src) \
                if cb else None
            if tab is None:
                tab = kmod.build_cuckoo_table(src, seed_len)
                if tab is not None and cb:
                    kmod.save_cuckoo_table(tab, cb, joined=src)
            if tab is not None:
                dtab = kmod.cuckoo_to_device(tab, self.device)
            else:
                tab = kmod.build_kmer_table(src, seed_len)
                dtab = kmod.to_device(tab, self.device)
            hit = ({d: replicate(dtab, d) for d in self._didx}, tab)
            self._ktabs[seed_len] = hit
        return hit

    def dispatch(self, seqs, quals, lens, act_fw, act_rc, minsc, mmtab,
                 perfect=None, boost=None, seed_skip=None,
                 size_mult: int = 1):
        """seqs/quals: [B0, L0] uint8/int; lens [B0]. Returns an opaque
        handle (device work and the result copy still in flight) for
        fetch()."""
        pol = self.pol
        B0, L0 = seqs.shape
        # reads split in ndev equal shards of Bl (JAX candgen.py:1350-1352)
        ndev = len(self.devices)
        Bl = _pow2(-(-B0 // ndev), lo=max(256 // ndev, 64))
        Bp = Bl * ndev
        Lp = _pow2(max(L0, 32), lo=32)

        if boost is None:
            boost = np.zeros(B0, bool)
        if seed_skip is None:
            seed_skip = np.zeros(B0, bool)

        # per-read interval with exact host SimpleFunc semantics
        # (ref: simple_func.h C-cast truncation)
        lens_i = np.asarray(lens, np.int64)
        interval = np.maximum(
            1, per_len(pol.interval.f_int, lens)).astype(np.int64)
        boost = np.asarray(boost, bool)
        interval = np.where(
            boost, np.maximum(1, (interval * 1.2 + 0.5).astype(np.int64)),
            interval)
        nrounds = np.where(boost, -(-pol.n_seed_rounds // 2),
                           pol.n_seed_rounds)
        nseeds_ub = 1 + np.maximum(0, lens_i - pol.seed_len) // interval
        S = _pow2(int(nseeds_ub.max(initial=1)), lo=4)

        # fast shape iff every active read keeps >=1 intact seed under any
        # single-position substitution (see module doc)
        active = np.asarray(act_fw, bool) | np.asarray(act_rc, bool)
        cover = -(-pol.seed_len // interval)       # ceil(Ls / interval)
        has_short = bool(np.any(active & ((lens_i < pol.seed_len)
                                          | (nseeds_ub < cover + 1))))
        if len(self._joined_host) < pol.seed_len:
            has_short = True
        if pol.n_seed_mms > 0:
            # -N 1 needs per-seed FM patterns for the substitution branches
            has_short = True
        if self.big:
            # a big index runs the general shape: no k-mer table fits on
            # the device beside it (docs/BIGINDEX.md)
            has_short = True
        # the seed table serves the fast shape only
        dkm, ktab = (None, None) if has_short else self._kmer(pol.seed_len)

        lens_u = np.unique(lens_i[:B0]) if B0 else lens_i[:0]
        uniform_len = len(lens_u) == 1 and int(lens_u[0]) == L0
        raw_len = 0
        q6 = np.minimum(np.asarray(quals), 63).astype(np.uint8)
        if uniform_len:
            # single-plane encoded upload (1 B/base); right-align on device
            raw_len = L0
            packed = np.full((1, Bp, L0), 255, np.uint8)
            s_a = np.asarray(seqs, np.uint8)
            packed[0, :B0] = np.where(s_a > 3, np.uint8(255),
                                      ((s_a & 3) << 6) | q6)
        else:
            packed = np.full((2, Bp, Lp), 255, np.uint8)
            enc = ((np.asarray(seqs) & 3) << 6) | q6
            enc = np.where(np.asarray(seqs) > 3, 255, enc).astype(np.uint8)
            packed[0, :B0, :L0] = enc
            j = np.arange(L0)
            dest = (Lp - lens_i[:, None]) + j[None, :]
            valid_e = j[None, :] < lens_i[:, None]
            rows_e = np.broadcast_to(np.arange(B0)[:, None], (B0, L0))
            packed[1, rows_e[valid_e], dest[valid_e]] = enc[valid_e]

        meta = np.zeros((Bp, 5), np.int32)
        m0 = lens_i.copy()
        m0 |= np.where(np.asarray(act_fw, bool), _F_ACT_FW, 0)
        m0 |= np.where(np.asarray(act_rc, bool), _F_ACT_RC, 0)
        ss = np.asarray(seed_skip, bool)
        r0 = active & ~ss
        m0 |= np.where(r0, _F_SEED_R0, 0)
        m0 |= np.where(active & ss, _F_EXACT_ONLY, 0)
        meta[:B0, 0] = m0.astype(np.int32)
        meta[:B0, 1] = np.asarray(minsc, np.int32)
        meta[:B0, 2] = interval.astype(np.int32)
        meta[:B0, 3] = nrounds.astype(np.int32)
        if perfect is not None:
            meta[:B0, 4] = np.asarray(perfect, np.int32)

        # batch-uniform seed schedule -> static seed columns (fast shape)
        sched = None
        static_len = 0
        if not has_short and B0 > 0:
            u_l = np.unique(lens_i[:B0])
            u_iv = np.unique(interval[:B0])
            u_nr = np.unique(nrounds[:B0])
            if len(u_l) == 1 and len(u_iv) == 1 and len(u_nr) == 1:
                l0, iv, nr = int(u_l[0]), int(u_iv[0]), int(u_nr[0])
                Lsd = pol.seed_len
                rounds = []
                for r in range(pol.n_seed_rounds):
                    ok = (iv > r) and (r < nr)
                    off = (iv * r) // nr
                    if ok and off > 0 and Lsd + off > l0:
                        ok = False
                    if not ok:
                        rounds.append(())
                        continue
                    nseeds = 1 + ((l0 - off - Lsd) // iv
                                  if l0 - off > Lsd else 0)
                    rounds.append(tuple(off + i * iv for i in range(nseeds)))
                sched = tuple(rounds)
                static_len = l0

        # the general shape's 1-mismatch branch grid: positions of the
        # read halves in chunks of cw, ~4M branches a chunk
        grid = 4 << 20
        cw = min(_pow2(max(Lp // 2, 8), lo=8), max(8, grid // (2 * Bl * 4)))
        n_chunks = -(-(Lp // 2) // cw)
        # sticky capacity escalation: a workload that overflowed once keeps
        # the larger sets
        size_mult = max(size_mult, self._sticky)
        pack5 = (Lp <= 256 and self.K <= 256 and ndev * Bl <= (1 << 18))
        # E scales with -k so the fused shape resolves enough elements per
        # range to honor khits (ref: aln_sink.h:264-283)
        E_eff = _pow2(max(pol.max_sa_elts, min(pol.khits, 1024)))
        cfg = CandGenCfg(
            B=Bl, L=Lp, S=S, R=pol.n_seed_rounds, E=E_eff,
            seed_len=pol.seed_len, K=self.K,
            k1=_pow2(4 * Bl * size_mult, lo=4096), chunk_w=cw,
            n_chunks=n_chunks,
            NH=max(6 * Bl * size_mult, 8192),
            C_pre=max(6 * Bl * size_mult, 8192),
            C_max=(_pow2(Bl * size_mult, lo=4096) + 1024 if pack5
                   else _pow2(2 * Bl * size_mult, lo=4096)),
            sw=self.sw_cfg, has_short=has_short, pack5=pack5,
            kmer_mode=("cuckoo" if isinstance(ktab, kmod.CuckooTable)
                       else "sorted"),
            kmer_steps=getattr(ktab, "search_steps", 1),
            n_hi=getattr(ktab, "n_hi", 16), n_lo=getattr(ktab, "n_lo", 6),
            bbits=getattr(ktab, "bbits", 10),
            tbits=getattr(ktab, "tbits", 0),
            salt=getattr(ktab, "salt", 0),
            RS=(0 if has_short
                else _pow2(max(Bl // 4, 2048) * size_mult)),
            mmtab_t=tuple(int(x) for x in np.asarray(mmtab[:64])),
            sched=sched, static_len=static_len, raw_len=raw_len,
            seed_mms=min(pol.n_seed_mms, 1),
            big=self.big,
            boost_thresh=getattr(pol, "boost_thresh", 300),
            no_exact_up=getattr(pol, "no_exact_upfront", False),
            no_1mm_up=getattr(pol, "no_1mm_upfront", False))
        return (*self._launch(B0, cfg, dkm, packed, meta, mmtab),
                size_mult)

    def _launch(self, B0, cfg, dkm, packed, meta, mmtab):
        """Enqueue a dispatch; its `cg.enqueue` span counts the reads
        (`reads`, B0) and says which shape took them (`short`: 1 for the
        general short-read shape, 0 for the fast shape)."""
        with trace.span("cg.enqueue", reads=B0, short=int(cfg.has_short)):
            return (B0, cfg, _sharded_pipeline(cfg, self.devices,
                                               self._didx, dkm, packed, meta,
                                               self._mmtab(mmtab)))

    def fetch(self, handle) -> BatchResult:
        """Wait for a dispatch's shards and decode their output. Its span
        counts the banded problems launched (C_max a shard) and the
        interior ones among them (the counter row's DPEx, ctr[6]). A
        dispatch escalated past the sticky size multiple that does not
        overflow makes its multiple sticky."""
        B0, cfg, shards, size_mult = handle
        with trace.span("cg.fetch",
                        launched=cfg.C_max * len(shards)) as sp:
            res = BatchResult(B0, _gather(shards), cfg, len(shards), self.K)
            sp.set(valid=int(res.counters[:, 6].sum()))
        if not res.overflow:
            self._sticky = max(self._sticky, size_mult)
        return res
