"""Per-read pseudo-random machinery (ref: random_source.h:34-163
RandomSource, pat.cpp:51-88 genRandSeed, ds.h:804 shufflePortion).

The reference derives a per-read 32-bit seed from the read's sequence,
qualities, name and the global --seed, and uses a numerical-recipes LCG to
break ties among equal-score alignments (aln_sink.cpp:1501 selectByScore
shuffles equal-score streaks). We reproduce the seed derivation and the
generator bit-for-bit; the *consumption point* differs by design — the
reference threads one stream through the whole sequential search, while our
batch pipeline draws a fresh stream at selection time, making each read's
choice deterministic and independent of batch composition.
"""
from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF


def gen_rand_seed(seq_codes: np.ndarray, qual_ascii: np.ndarray,
                  name: bytes, global_seed: int = 0) -> int:
    """Per-read seed (exact port of pat.cpp:51-88 genRandSeed).

    seq_codes: 2-bit codes with N as 4 (the reference's BTDnaString values).
    qual_ascii: raw ASCII quality values (Phred+33 as stored).
    name: read name bytes; hashing stops at the first '/'.
    """
    rseed = ((int(global_seed) + 101) * 59 * 61 * 67 * 71 * 73 * 79 * 83) \
        & _M32
    q = np.asarray(seq_codes, np.uint32)
    i = np.arange(len(q), dtype=np.uint32)
    for v in (q << ((i & 15) << 1)) & _M32:
        rseed ^= int(v)
    qu = np.asarray(qual_ascii, np.uint32)
    i = np.arange(len(qu), dtype=np.uint32)
    for v in (qu << ((i & 3) << 3)) & _M32:
        rseed ^= int(v)
    for j, ch in enumerate(name):
        if ch == 0x2F:  # '/'
            break
        rseed ^= (ch << ((j & 3) << 3)) & _M32
    return rseed & _M32


def gen_rand_seeds_batch(seqs: np.ndarray, lens: np.ndarray,
                         quals_ascii: np.ndarray, names: list[bytes],
                         global_seed: int = 0) -> np.ndarray:
    """Vectorized gen_rand_seed over a padded [B, L] batch."""
    B, L = seqs.shape
    base = ((int(global_seed) + 101) * 59 * 61 * 67 * 71 * 73 * 79 * 83) \
        & _M32
    j = np.arange(L, dtype=np.uint32)[None, :]
    valid = j < np.asarray(lens, np.uint32)[:, None]
    sq = np.where(np.asarray(seqs) > 3, 4, np.asarray(seqs)).astype(np.uint32)
    sterm = np.where(valid, sq << ((j & 15) << 1), 0)
    qterm = np.where(valid,
                     np.asarray(quals_ascii, np.uint32) << ((j & 3) << 3), 0)
    acc = np.full(B, base, np.uint32)
    acc ^= np.bitwise_xor.reduce(sterm.astype(np.uint32), axis=1)
    acc ^= np.bitwise_xor.reduce(qterm.astype(np.uint32), axis=1)
    out = acc.astype(np.uint64)
    for b in range(B):
        nm = names[b] if isinstance(names[b], bytes) else names[b].encode()
        h = 0
        for k, ch in enumerate(nm):
            if ch == 0x2F:
                break
            h ^= (ch << ((k & 3) << 3)) & _M32
        out[b] ^= h
    return out.astype(np.uint32)


class RandomSource:
    """Numerical-recipes LCG (exact port of random_source.h:34-101)."""
    A = 1664525
    C = 1013904223

    __slots__ = ("last",)

    def __init__(self, seed: int = 0):
        self.last = int(seed) & _M32

    def init(self, seed: int) -> None:
        self.last = int(seed) & _M32

    def next_u32(self) -> int:
        last = (self.A * self.last + self.C) & _M32
        ret = last >> 16
        last = (self.A * last + self.C) & _M32
        self.last = last
        return (ret ^ last) & _M32

    def next_u64(self) -> int:
        return (self.next_u32() << 32) | self.next_u32()

    def next_float(self) -> float:
        """float32 in [0, 1] (exact port of random_source.h:221
        nextFloat: nextU32() / 0xffffffff in single precision)."""
        return float(np.float32(self.next_u32()) / np.float32(0xFFFFFFFF))

    # the reference's nextSizeT on 64-bit platforms
    next_size_t = next_u64


def shuffle_portion(lst: list, begin: int, num: int,
                    rnd: RandomSource) -> None:
    """In-place partial shuffle (exact port of ds.h:804 shufflePortion)."""
    if num < 2:
        return
    left = num
    for i in range(begin, begin + num - 1):
        rndi = rnd.next_size_t() % left
        if rndi > 0:
            lst[i], lst[i + rndi] = lst[i + rndi], lst[i]
        left -= 1


def select_by_score_order(items: list, rnd: RandomSource) -> list:
    """Order alignments the way AlnSinkWrap::selectByScore does (ref:
    aln_sink.cpp:1501): sort descending by score, then shuffle each
    equal-score streak with the per-read generator. `items` are
    (score, tiebreak_key, payload) tuples already in discovery order."""
    buf = sorted(items, key=lambda t: (-t[0], t[1]))
    streak = 0
    n = len(buf)
    for i in range(1, n):
        if buf[i][0] == buf[i - 1][0]:
            streak = streak + 1 if streak else 2
        else:
            if streak > 1:
                shuffle_portion(buf, i - streak, streak, rnd)
            streak = 0
    if streak > 1:
        shuffle_portion(buf, n - streak, streak, rnd)
    return buf
