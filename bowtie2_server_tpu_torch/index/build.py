"""Index construction: FASTA -> FmIndex (ref: bt2_build.cpp:376 entry point,
blockwise_sa.h, ref_read.cpp).

The reference builds its suffix array with a blockwise Kärkkäinen
difference-cover sort (or libsais) to bound memory; construction is a
host-side, one-time cost, so we use a simple prefix-doubling suffix-array
construction vectorized in numpy (O(n log n) lexsorts). This is plenty for
bacterial/fungal genomes; a C++ SA-IS backend is the planned upgrade for
mammalian-scale builds (same on-disk format).

Reference parsing follows ref_read.cpp's model: ambiguous characters are
excluded from the indexed text; each maximal unambiguous run becomes a
"run record" (RefRecord equivalent) mapping joined offsets back to
(reference, offset). The full reference including Ns is kept separately for
DP window fetches (ref: reference.cpp BitPairReference).
"""
from __future__ import annotations

import io
from pathlib import Path

import numpy as np

from ..utils import dna
from .fm import FTAB_CHARS, OCC_BLOCK, FmDirection, FmIndex


def parse_fasta(path_or_text) -> tuple[list[str], list[np.ndarray]]:
    """Parse FASTA into (names, code arrays incl. N=4)."""
    if isinstance(path_or_text, (str, Path)) and "\n" not in str(path_or_text):
        data = Path(path_or_text).read_bytes()
    elif isinstance(path_or_text, bytes):
        data = path_or_text
    else:
        data = str(path_or_text).encode()
    names: list[str] = []
    seqs: list[np.ndarray] = []
    cur: list[bytes] = []
    for line in io.BytesIO(data):
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            if names:
                seqs.append(dna.encode(b"".join(cur)))
                cur = []
            # keep the FULL header (whitespace included) — output-side
            # truncates at the first whitespace unless --fullref
            # (ref: ARG_FULLREF; the reference index stores full names)
            names.append(line[1:].decode().strip())
        else:
            cur.append(line)
    if names:
        seqs.append(dna.encode(b"".join(cur)))
    return names, seqs


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array: native C++ SA-IS when available (O(n), the counterpart
    of the reference's blockwise sort / libsais), else numpy prefix-doubling
    (O(n log n) lexsorts). Terminator-free semantics either way: shorter
    suffixes sort before longer ones sharing a prefix ($ < all)."""
    n = len(text)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n > 1 << 14:  # native pays off beyond small inputs
        from ..native import sais
        sa = sais(text)
        if sa is not None:
            return sa
    # rank starts at char+1 so 0 can mean "past end" (the implicit $).
    rank = text.astype(np.int64) + 1
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        second = np.where(idx + k < n, np.append(rank[k:], np.zeros(min(k, n), dtype=np.int64))[:n], 0)
        order = np.lexsort((second, rank))
        # new ranks: group identical (rank, second) pairs
        r_o, s_o = rank[order], second[order]
        changed = np.empty(n, dtype=np.int64)
        changed[0] = 1
        changed[1:] = (r_o[1:] != r_o[:-1]) | (s_o[1:] != s_o[:-1])
        new_rank_sorted = np.cumsum(changed)
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[order] = new_rank_sorted
        rank = new_rank
        if new_rank_sorted[-1] == n:
            return order
        k *= 2
        if k >= 2 * n:  # safety: should have converged
            return order


def _build_direction(text: np.ndarray, sa: np.ndarray) -> FmDirection:
    """Build one direction's FM arrays in standard (n+1)-row space: row 0 is
    the empty ($) suffix whose BWT char is the last text char; the row whose
    suffix starts at text position 0 holds a counted-as-nothing hole (code 4).
    C[c] = 1 + #{text chars < c} accounts for the $ row sorting first.

    Everything is chunked so peak memory stays O(n) bytes beyond the SA
    itself — multi-Gbp (.bt2l-scale) builds would otherwise allocate
    several 8·n temporaries (the reference bounds build memory the same
    way via the blockwise sort, blockwise_sa.h:79)."""
    n = len(text)
    n_rows = n + 1
    dtype = np.uint32 if n_rows < (1 << 32) else np.uint64
    CH = 1 << 26
    bwt = np.empty(n_rows, dtype=np.uint8)
    bwt[0] = text[n - 1]
    primary = 0
    for lo in range(0, n, CH):
        seg = sa[lo : lo + CH]
        prev = seg - 1          # -1 at the SA=0 row; clip for the gather
        bwt[1 + lo : 1 + lo + len(seg)] = np.where(
            seg > 0, text[np.clip(prev, 0, max(n - 1, 0))], 4
        ).astype(np.uint8)
        z = np.nonzero(seg == 0)[0]
        if len(z):
            primary = 1 + lo + int(z[0])
    sa_std = np.empty(n_rows, dtype=dtype)
    sa_std[0] = n  # the empty suffix; never inside a nonempty-pattern range
    sa_std[1:] = sa.astype(dtype)

    # Occ checkpoints: occ[k, c] = count of c in bwt[0 : k*OCC_BLOCK],
    # per-block counts over chunks of whole blocks (CH divisible by
    # OCC_BLOCK; the hole and the padding, code 4, count as nothing).
    n_blocks = (n_rows + OCC_BLOCK - 1) // OCC_BLOCK
    per_block = np.zeros((n_blocks, 4), np.int64)
    for lo in range(0, n_rows, CH):
        hi = min(lo + CH, n_rows)
        seg = np.full(-(-(hi - lo) // OCC_BLOCK) * OCC_BLOCK, 4, np.uint8)
        seg[: hi - lo] = bwt[lo:hi]
        blocks = seg.reshape(-1, OCC_BLOCK)
        b0 = lo // OCC_BLOCK
        for c in range(4):
            per_block[b0 : b0 + len(blocks), c] = (blocks == c).sum(1)
    occ = np.zeros((n_blocks + 1, 4), dtype=np.uint32)
    occ[1:] = np.cumsum(per_block, axis=0).astype(np.uint32)

    counts = np.zeros(4, np.int64)
    for lo in range(0, n, CH):
        counts += np.bincount(text[lo : lo + CH], minlength=5)[:4]
    cnt = np.ones(5, dtype=np.int64)  # the leading 1 is the $ row
    cnt[1:] += np.cumsum(counts)

    # ftab: row ranges per FTAB_CHARS-mer. The SA orders k-mer keys, so
    # searchsorted boundaries equal prefix sums of per-key counts — a
    # histogram of the keys of all suffixes, which it takes in text order
    # (sequential reads, no gathers through the SA) in chunks. A-padded
    # short suffixes sort first among equal keys, so `top` bumps past them
    # (a k-char pattern cannot match a <k-char suffix). Row indices are in
    # standard space (+1 for the $ row, which sorts before everything).
    k = FTAB_CHARS
    key_counts = np.zeros(4 ** k, np.int64)
    for lo in range(0, n, CH):
        hi = min(lo + CH, n)
        win = np.zeros(hi - lo + k - 1, np.uint8)   # A-padded past the end
        tail = text[lo : hi + k - 1]
        win[: len(tail)] = tail
        keys = np.zeros(hi - lo, np.int32)
        for i in range(k):
            keys = (keys << 2) | win[i : i + hi - lo]
        key_counts += np.bincount(keys, minlength=4 ** k)
    short = np.arange(max(n - k + 1, 0), n)     # suffixes under k chars
    pad = np.zeros(len(short) + k - 1, np.uint8)
    pad[: len(short)] = text[len(text) - len(short):]
    skeys = np.zeros(len(short), np.int64)
    for i in range(k):
        skeys = (skeys << 2) | pad[i : i + len(short)]
    bump = np.bincount(skeys, minlength=4 ** k)
    csum = np.zeros(4 ** k + 1, np.int64)
    np.cumsum(key_counts, out=csum[1:])
    top = csum[:-1] + 1 + bump
    bot = csum[1:] + 1
    return FmDirection(
        bwt=bwt, occ=occ, cnt=cnt, sa=sa_std, primary=primary,
        ftab_top=top.astype(np.uint32), ftab_bot=bot.astype(np.uint32))


def ref_geometry(names: list[str], seqs: list[np.ndarray]) -> dict:
    """Joined text + run tables + full-reference arrays from per-reference
    code arrays (RefRecord assembly, ref: ref_read.cpp)."""
    runs_js, runs_rid, runs_roff = [], [], []
    joined_parts = []
    joined_len = 0
    ref_full_parts, ref_full_start, ref_lens = [], [], []
    total_full = 0
    for rid, seq in enumerate(seqs):
        ref_full_start.append(total_full)
        ref_full_parts.append(seq)
        ref_lens.append(len(seq))
        total_full += len(seq)
        # maximal unambiguous runs
        ok = seq < 4
        if len(seq) == 0:
            continue
        d = np.diff(ok.astype(np.int8))
        starts = np.nonzero(np.concatenate([[ok[0]], d == 1]))[0]
        ends = np.nonzero(np.concatenate([d == -1, [ok[-1]]]))[0] + 1
        for s, e in zip(starts, ends):
            runs_js.append(joined_len)
            runs_rid.append(rid)
            runs_roff.append(int(s))
            joined_parts.append(seq[s:e])
            joined_len += int(e - s)

    joined = (np.concatenate(joined_parts) if joined_parts
              else np.zeros(0, dtype=np.uint8))
    return dict(
        joined=joined,
        run_joined_start=np.asarray(runs_js, dtype=np.int64),
        run_ref_id=np.asarray(runs_rid, dtype=np.int32),
        run_ref_off=np.asarray(runs_roff, dtype=np.int64),
        ref_full=(np.concatenate(ref_full_parts) if ref_full_parts
                  else np.zeros(0, dtype=np.uint8)),
        ref_full_start=np.asarray(ref_full_start, dtype=np.int64),
        ref_lens=np.asarray(ref_lens, dtype=np.int64),
        ref_names=names)


def build_index(fasta, both_directions: bool = True) -> FmIndex:
    """Build the full index from a FASTA path/bytes/text."""
    names, seqs = parse_fasta(fasta)
    if not names:
        raise ValueError("no sequences in FASTA input")
    geom = ref_geometry(names, seqs)
    joined = geom["joined"]
    sa_fw = suffix_array(joined)
    fw = _build_direction(joined, sa_fw)
    mirror = None
    if both_directions:
        rev = joined[::-1].copy()
        mirror = _build_direction(rev, suffix_array(rev))
    return FmIndex(fw=fw, mirror=mirror, **geom)
