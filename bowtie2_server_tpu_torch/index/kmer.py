"""Seed-length k-mer position table — the seed lookup of the fast shape
(ref: aligner_seed.cpp:668 searchSeedBi with -N 0). Port of
bowtie2_server_tpu/index/kmer.py.

An exact-seed FM search costs seed_len dependent LF steps; a k-mer table
answers the same query — "all genome positions where this seed_len-mer
occurs" — with a few independent lookups:

  key(pos)  = the seed_len bases at joined[pos:pos+seed_len], packed 2-bit
              big-endian into (hi, lo) 32-bit halves
  cuckoo    = a two-choice bucket hash over the unique keys: a lookup is
              2 independent row gathers + compares (the main path)
  sorted    = key-sorted positions with a bucket directory and a
              fixed-trip binary search (the fallback when cuckoo placement
              fails)

The table indexes the same joined text as the FM index, so the hit set is
IDENTICAL to an exact backward search of the seed. The host-side table
construction is the reference package's, unchanged, so both packages
build equal tables.

Device arrays are torch tensors. torch has no unsigned 32-bit shifts on
the CPU, so keys and hash words ride in int64 holding the uint32 value,
masked to 32 bits after every multiply and shift.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import zipfile
from typing import NamedTuple

import numpy as np
import torch


class KmerTable(NamedTuple):
    """Host-side sorted k-mer position table."""
    bucket_start: np.ndarray   # [2^bbits + 1] uint32 bucket boundaries
    keys: np.ndarray           # [n_k, 2] uint32 (hi, lo), key-sorted
    pos: np.ndarray            # [n_k] uint32 joined position of each key
    seed_len: int
    n_hi: int                  # bases packed in hi (min(seed_len, 16))
    n_lo: int                  # bases packed in lo (seed_len - n_hi)
    bbits: int                 # bucket bits taken from the top of hi
    search_steps: int          # static binary-search trip count


class DeviceKmer(NamedTuple):
    """Device tensors of the sorted table."""
    bucket_start: torch.Tensor  # [2^bbits + 1] int64 (uint32 values)
    keys: torch.Tensor          # [n_k, 2] int64 (uint32 values)
    pos: torch.Tensor           # [n_k] int32 (positions < 2^31)


def pack_keys(codes: np.ndarray, seed_len: int):
    """(hi, lo) uint32 keys of every window start in `codes` (0..3 values).

    hi packs the first n_hi = min(seed_len, 16) bases big-endian in its low
    2*n_hi bits; lo packs the remaining bases in its low 2*n_lo bits.
    Window starts beyond len(codes) - seed_len get arbitrary (unused) keys.

    Logarithmic doubling: w[k][i] packs bases [i, i+2^k), so each level is
    one shift-or over the full array — 4 levels reach 16 bases where the
    naive per-base loop cost 16 passes (~5x wall on multi-Mbp genomes).
    """
    n = len(codes)
    n_hi = min(seed_len, 16)
    n_lo = seed_len - n_hi
    pad = np.zeros(n + seed_len + 16, np.uint32)
    pad[:n] = codes
    w = [pad]                       # w[k]: [*, ] bases [i, i+2^k)
    for k in range(4):
        span = 1 << k
        w.append((w[k] << np.uint32(2 * span))
                 | np.concatenate([w[k][span:],
                                   np.zeros(span, np.uint32)]))

    def span_pack(start: int, length: int) -> np.ndarray:
        """Packed bases [start, start+length) for every window start."""
        out = None
        off = start
        for k in range(4, -1, -1):
            if (length >> k) & 1:
                piece = w[k][off : off + n]
                out = piece if out is None else \
                    ((out << np.uint32(2 << k)) | piece)
                off += 1 << k
        return out if out is not None else np.zeros(n, np.uint32)

    hi = span_pack(0, n_hi)
    lo = span_pack(n_hi, n_lo)
    return hi, lo, n_hi, n_lo


def build_kmer_table(joined: np.ndarray, seed_len: int,
                     bbits: int | None = None) -> KmerTable:
    """Build the sorted table over every window of the joined text."""
    n = len(joined)
    n_k = max(n - seed_len + 1, 0)
    hi, lo, n_hi, n_lo = pack_keys(joined, seed_len)
    hi, lo = hi[:n_k], lo[:n_k]
    if bbits is None:
        # ~4x buckets over keys: shaves the max-bucket size (and so the
        # fixed binary-search trip count, 2 gathers/trip); bucket array
        # capped at 2^24 (64 MB)
        bbits = min(2 * n_hi,
                    max(10, int(np.ceil(np.log2(max(n_k, 2)))) + 2), 24)
    if n_k == 0:
        # sentinel row so device gathers stay well-formed; never matched
        # (callers force the general shape when the table is degenerate)
        return KmerTable(
            bucket_start=np.zeros((1 << 10) + 1, np.uint32),
            keys=np.array([[0xFFFFFFFF, 0xFFFFFFFF]], np.uint32),
            pos=np.zeros(1, np.uint32), seed_len=seed_len,
            n_hi=n_hi, n_lo=n_lo, bbits=10, search_steps=1)
    order = np.lexsort((lo, hi)).astype(np.uint32)
    hi_s = hi[order]
    lo_s = lo[order]
    keys = np.stack([hi_s, lo_s], axis=1)
    bucket = (hi_s >> np.uint32(2 * n_hi - bbits)).astype(np.int64)
    bucket_start = np.zeros((1 << bbits) + 1, np.uint32)
    counts = np.bincount(bucket, minlength=1 << bbits)
    bucket_start[1:] = np.cumsum(counts).astype(np.uint32)
    max_bucket = int(counts.max(initial=0))
    search_steps = max(1, int(np.ceil(np.log2(max_bucket + 1))))
    return KmerTable(bucket_start=bucket_start, keys=keys,
                     pos=order, seed_len=seed_len, n_hi=n_hi, n_lo=n_lo,
                     bbits=bbits, search_steps=search_steps)


def to_device(tab: KmerTable, device) -> DeviceKmer:
    return DeviceKmer(
        bucket_start=torch.from_numpy(
            tab.bucket_start.astype(np.int64)).to(device),
        keys=torch.from_numpy(tab.keys.astype(np.int64)).to(device),
        pos=torch.from_numpy(tab.pos.astype(np.int32)).to(device))


# ------------------------------------------------------------ cuckoo table -
#
# A bucketized two-choice hash table: every unique seed key lives in one of
# TWO buckets of TWO slots each, and a lookup is exactly 2 INDEPENDENT row
# gathers + compares — no chained steps, no data-dependent trip counts.
# (ref: the role of the ftab k-mer jump table, bt2_idx.h:1476 ftabLoHi.)

class CuckooTable(NamedTuple):
    """Host-side two-choice bucket hash table over unique seed keys.

    table[t] packs two slots: [hi0, lo0, start0, cnt0, hi1, lo1, start1,
    cnt1] (uint32). cnt == 0 marks an empty slot. (start, cnt) index the
    key-sorted `pos` array exactly like the sorted table's ranges."""
    table: np.ndarray          # [T, 8] uint32
    pos: np.ndarray            # [n_k] uint32 joined position of each key
    seed_len: int
    n_hi: int
    n_lo: int
    tbits: int                 # log2 of the bucket count
    salt: int


class DeviceCuckoo(NamedTuple):
    table: torch.Tensor        # [T, 8] int64 (uint32 values)
    pos: torch.Tensor          # [n_k] int32 (positions < 2^31)


_H_A = 0x9E3779B1
_H_B = 0x85EBCA77
_H_C = 0xC2B2AE3D
_H_D = 0x27D4EB2F
_M32 = 0xFFFFFFFF


def _buckets(hi, lo, salt: int, tbits: int):
    """The two bucket indices of a key (host numpy): uint32 wraparound
    multiply-xor mixes, top tbits of the product select the bucket."""
    u = np.uint32
    hi = hi.astype(u)
    lo = lo.astype(u)
    x1 = ((hi * u(_H_A)) ^ (lo * u(_H_B))) + u(salt & _M32)
    x1 = (x1 ^ (x1 >> u(16))) * u(_H_C)
    x2 = ((hi * u(_H_D)) ^ (lo * u(_H_C))) + u((salt * 0x165667B1) & _M32)
    x2 = (x2 ^ (x2 >> u(15))) * u(_H_A)
    sh = u(32 - tbits)
    return (x1 >> sh).astype(np.int32), (x2 >> sh).astype(np.int32)


def _buckets_torch(hi, lo, salt: int, tbits: int):
    """`_buckets` on int64 tensors holding uint32 values: the same
    arithmetic, masked to 32 bits after each multiply and add (an int64
    product may wrap, but its low 32 bits are the uint32 product's)."""
    m = _M32
    x1 = (((hi * _H_A) & m) ^ ((lo * _H_B) & m)) + (salt & m)
    x1 &= m
    x1 = ((x1 ^ (x1 >> 16)) * _H_C) & m
    x2 = (((hi * _H_D) & m) ^ ((lo * _H_C) & m)) + ((salt * 0x165667B1) & m)
    x2 &= m
    x2 = ((x2 ^ (x2 >> 15)) * _H_A) & m
    sh = 32 - tbits
    return x1 >> sh, x2 >> sh


def build_cuckoo_table(joined: np.ndarray, seed_len: int,
                       max_salts: int = 6) -> CuckooTable | None:
    """Build the two-choice table; None if placement fails at every salt
    and table size (callers then keep the sorted-table path)."""
    n = len(joined)
    n_k = max(n - seed_len + 1, 0)
    if n_k == 0:
        return None
    hi, lo, n_hi, n_lo = pack_keys(joined, seed_len)
    hi, lo = hi[:n_k], lo[:n_k]
    order = np.lexsort((lo, hi)).astype(np.uint32)
    hi_s, lo_s = hi[order], lo[order]
    new = np.ones(n_k, bool)
    new[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    ustart = np.nonzero(new)[0].astype(np.uint32)
    ucnt = np.diff(np.append(ustart, n_k)).astype(np.uint32)
    uhi, ulo = hi_s[ustart], lo_s[ustart]
    n_u = len(ustart)

    tbits = max(4, int(np.ceil(np.log2(n_u))))   # <= 0.5 load of 2T slots
    for grow in range(3):
        T = 1 << tbits
        for salt in range(1, max_salts + 1):
            h1, h2 = _buckets(uhi, ulo, salt, tbits)
            tbl_key = np.full((T, 2), -1, np.int32)
            pending = np.arange(n_u, dtype=np.int32)
            # Batched random-walk cuckoo insertion: each round scatters
            # every pending key at its emptier bucket (last-write-wins);
            # keys whose BOTH buckets are full evict a RANDOMLY chosen
            # (bucket, slot) — per-(key, round) mixed bits, so lockstep
            # two-cycles cannot form — and the displaced occupant rejoins
            # the pending set. (2 buckets x 2 slots)-cuckoo supports >90%
            # load, so at our <=0.5 load the walk converges in ~64 rounds
            # — the old fail-on-first-full-bucket rule made 12 Mbp
            # genomes cycle every (salt, size) combo for minutes each
            # before falling back to the sorted table.
            for it in range(256):
                if not len(pending):
                    break
                b1, b2 = h1[pending], h2[pending]
                r1 = tbl_key[b1]                        # [P, 2]
                r2 = tbl_key[b2]
                o1 = (r1 >= 0).sum(1)
                o2 = (r2 >= 0).sum(1)
                pick1 = o1 <= o2
                tgt = np.where(pick1, b1, b2)
                occt = np.where(pick1[:, None], r1, r2) >= 0
                full = occt[:, 0] & occt[:, 1]
                rr = (pending.astype(np.uint32) * np.uint32(0x9E3779B1)
                      + np.uint32((it * 0x85EBCA77) & 0xFFFFFFFF))
                rr = ((rr ^ (rr >> np.uint32(15)))
                      * np.uint32(0xC2B2AE3D)) >> np.uint32(13)
                rr = rr.astype(np.int32)
                tgt = np.where(full, np.where((rr & 1) > 0, b1, b2), tgt)
                slot = np.where(occt[:, 0], 1, 0)
                slot = np.where(full, (rr >> 1) & 1, slot).astype(np.int32)
                old = tbl_key[tgt, slot]
                tbl_key[tgt, slot] = pending   # last-write-wins scatter
                landed = tbl_key[tgt, slot] == pending
                disp = old[landed]             # displaced occupants
                pending = np.concatenate(
                    [pending[~landed], disp[disp >= 0]])
            failed = bool(len(pending))
            if not failed:
                table = np.zeros((T, 8), np.uint32)
                for s in range(2):
                    occ_m = tbl_key[:, s] >= 0
                    k = tbl_key[occ_m, s]
                    table[occ_m, 4 * s + 0] = uhi[k]
                    table[occ_m, 4 * s + 1] = ulo[k]
                    table[occ_m, 4 * s + 2] = ustart[k]
                    table[occ_m, 4 * s + 3] = ucnt[k]
                return CuckooTable(table=table, pos=order,
                                   seed_len=seed_len, n_hi=n_hi, n_lo=n_lo,
                                   tbits=tbits, salt=salt)
        tbits += 1
    return None


def cuckoo_cache_path(cache_base: str, seed_len: int) -> str:
    # the staleness signature differs from the reference package's cache
    # (a full-text digest here), so the port keeps its own file
    return f"{cache_base}.k{seed_len}.cuckoo.v2.npz"


def save_cuckoo_table(tab: CuckooTable, cache_base: str,
                      joined: np.ndarray | None = None) -> None:
    """Persist the built table next to its index, atomically (concurrent
    processes may race on the same index). Failure to write is not an
    error: the cache is an optimisation."""
    path = cuckoo_cache_path(cache_base, tab.seed_len)
    n, sig = _joined_sig(joined) if joined is not None else (0, 0)
    tmp = None
    try:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, table=tab.table, pos=tab.pos,
                     meta=np.array([tab.seed_len, tab.n_hi, tab.n_lo,
                                    tab.tbits, tab.salt, n, sig], np.int64))
        os.replace(tmp, path)
        tmp = None
    except OSError:
        pass
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _joined_sig(joined: np.ndarray) -> tuple[int, int]:
    """Staleness signature: (length, digest of the WHOLE text) — a change
    anywhere in the genome invalidates the cache."""
    d = hashlib.blake2b(np.ascontiguousarray(joined).tobytes(),
                        digest_size=8).digest()
    return len(joined), int.from_bytes(d, "little") & 0x7FFFFFFFFFFFFFFF


def load_cuckoo_table(cache_base: str, seed_len: int,
                      joined: np.ndarray | None = None
                      ) -> CuckooTable | None:
    """The cached table, or None when it is missing, stale or unreadable."""
    try:
        # open the file here: np.load leaks its own handle when the zip is
        # damaged
        with open(cuckoo_cache_path(cache_base, seed_len), "rb") as fh, \
                np.load(fh) as z:
            m = z["meta"]
            if int(m[0]) != seed_len:
                return None
            if joined is not None:
                n, sig = _joined_sig(joined)
                if len(m) < 7 or int(m[5]) != n or int(m[6]) != sig:
                    return None   # index rebuilt at this path: stale cache
            return CuckooTable(table=z["table"], pos=z["pos"],
                               seed_len=int(m[0]), n_hi=int(m[1]),
                               n_lo=int(m[2]), tbits=int(m[3]),
                               salt=int(m[4]))
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
        return None


def cuckoo_to_device(tab: CuckooTable, device) -> DeviceCuckoo:
    return DeviceCuckoo(
        table=torch.from_numpy(tab.table.astype(np.int64)).to(device),
        pos=torch.from_numpy(tab.pos.astype(np.int32)).to(device))


# ------------------------------------------------------------- lookups -----

def cuckoo_lookup(dkc: DeviceCuckoo, q_hi, q_lo, tbits: int, salt: int):
    """Batched lookup: (start, cnt) int32 row ranges into dkc.pos for int64
    query keys (uint32 values). Exactly 2 independent row gathers per
    query."""
    q_hi = q_hi.to(torch.int64) & _M32
    q_lo = q_lo.to(torch.int64) & _M32
    h1, h2 = _buckets_torch(q_hi, q_lo, salt, tbits)
    start = torch.zeros_like(q_hi)
    cnt = torch.zeros_like(q_hi)
    for r in (dkc.table[h1], dkc.table[h2]):          # [Q, 8]
        for s in (0, 4):
            m = (r[:, s] == q_hi) & (r[:, s + 1] == q_lo) & (r[:, s + 3] > 0)
            start = torch.where(m, r[:, s + 2], start)
            cnt = torch.where(m, r[:, s + 3], cnt)
    return start.to(torch.int32), cnt.to(torch.int32)


def lookup_body(dkm: DeviceKmer, q_hi, q_lo, n_hi: int, bbits: int,
                steps: int):
    """Batched sorted-table lookup: (start, cnt) int32 row ranges into
    dkm.pos for each (hi, lo) query key. Invalid queries must be masked by
    the caller (they return some range).

    Lower and upper bound run in the same fixed-trip loop: 2 key-row
    gathers per step, `steps` = ceil(log2(max_bucket+1)) from the table.
    """
    q_hi = q_hi.to(torch.int64) & _M32
    q_lo = q_lo.to(torch.int64) & _M32
    bucket = (q_hi >> (2 * n_hi - bbits)).clamp(
        0, dkm.bucket_start.shape[0] - 2)
    b0 = dkm.bucket_start[bucket]
    b1 = dkm.bucket_start[bucket + 1]
    n_k = dkm.keys.shape[0]
    lo_l, hi_l, lo_u, hi_u = b0, b1, b0, b1
    for _ in range(steps):
        mid_l = (lo_l + hi_l) >> 1
        mid_u = (lo_u + hi_u) >> 1
        kl = dkm.keys[mid_l.clamp(0, n_k - 1)]          # [Q, 2]
        ku = dkm.keys[mid_u.clamp(0, n_k - 1)]
        less = (kl[:, 0] < q_hi) | ((kl[:, 0] == q_hi) & (kl[:, 1] < q_lo))
        leq = (ku[:, 0] < q_hi) | ((ku[:, 0] == q_hi) & (ku[:, 1] <= q_lo))
        open_l = lo_l < hi_l
        open_u = lo_u < hi_u
        lo_l, hi_l = (torch.where(open_l & less, mid_l + 1, lo_l),
                      torch.where(open_l & ~less, mid_l, hi_l))
        lo_u, hi_u = (torch.where(open_u & leq, mid_u + 1, lo_u),
                      torch.where(open_u & ~leq, mid_u, hi_u))
    return lo_l.to(torch.int32), (lo_u - lo_l).clamp_min(0).to(torch.int32)
