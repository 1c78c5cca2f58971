"""Writer for the reference's .bt2/.bt2l index format — the interchange
half of a bowtie2-build replacement (ref: bt2_io.cpp:801 writeFromMemory,
bt2_idx.h:2829 buildToDisk, :933 szsToDisk/joinToDisk, reference.cpp
szsFromFasta for .3/.4).

Produces the six files {base}.{1,2,3,4,rev.1,rev.2}.bt2[l] byte-identically
to `bowtie2-build` with default parameters (lineRate 6, offRate 4,
ftabChars 10) — the JAX package's writer is verified against the
reference binary's output (tests/test_bt2_writer.py), and this one is held
byte-identical to it (tests/test_torch_bt2.py).

Format notes (all little-endian; OffU = u32 for .bt2, u64 for .bt2l):
  .1:  i32 endian(1) | OffU len | i32 lineRate | i32 2 | i32 offRate |
       i32 ftabChars | i32 -flags | OffU nPat | OffU plen[nPat] |
       OffU nFrag | OffU rstarts[3*nFrag] | u8 ebwt[numSides*sideSz] |
       OffU zOff | OffU fchr[5] | OffU ftab[4^k+1] | OffU eftab[2k] |
       names ("\\n" after each, trailing NUL)
  .2:  i32 endian(1) | OffU offs[ceil((len+1)/2^offRate)]
       (offs[j] = SA[j << offRate] — row-indexed sampling)
  .3:  i32 endian(1) | OffU nRecs | per record: OffU off(N-gap), OffU len,
       u8 first
  .4:  2-bit packed joined text, little-endian within bytes, no header

The suffix order on disk is the reference's $-AFTER-everything convention;
it is generated here by suffix-sorting text+[4] (code 4 outranks A..T, so
ties where one suffix prefixes another break long-first, and the lone [4]
suffix is the empty-suffix row).
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

LINE_RATE = 6
OFF_RATE = 4
FTAB_CHARS = 10
_EBWT_ENTIRE_REV = 4


def _ref_records(seqs):
    """RefRecords (off=N-gap, len, first) per fastaRefReadAppend semantics,
    including a trailing len-0 record when a sequence ends in Ns (plen is
    reconstructed as sum(off+len) over its records)."""
    recs = []
    for seq in seqs:
        ok = seq < 4
        n = len(seq)
        d = np.diff(ok.astype(np.int8))
        starts = (np.nonzero(np.concatenate([[ok[0]], d == 1]))[0]
                  if n else np.zeros(0, np.int64))
        ends = (np.nonzero(np.concatenate([d == -1, [ok[-1]]]))[0] + 1
                if n else np.zeros(0, np.int64))
        if len(starts) == 0:
            recs.append([n, 0, True])   # all-N / empty sequence
            continue
        prev_end = 0
        for i, (s, e) in enumerate(zip(starts, ends)):
            recs.append([int(s) - prev_end, int(e - s), i == 0])
            prev_end = int(e)
        if prev_end < n:                # trailing Ns
            recs.append([n - prev_end, 0, False])
    return recs


def _sa_dollar_large(joined: np.ndarray) -> np.ndarray:
    """(len+1)-row suffix array in the reference's $-large convention:
    suffix-sort joined+[4]; row value len means the empty suffix."""
    from ..native import sais
    text2 = np.concatenate([joined, np.array([4], np.uint8)])
    sa = sais(text2)
    if sa is None:
        raise RuntimeError(".bt2 export needs the native SA-IS backend")
    return sa


def _pack_2bit(codes: np.ndarray, out_len: int) -> np.ndarray:
    """2-bit little-endian-within-byte packing, padded with zeros."""
    pad = np.zeros(out_len * 4, np.uint8)
    pad[: len(codes)] = codes
    b = pad.reshape(-1, 4)
    return (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4) | (b[:, 3] << 6)
            ).astype(np.uint8)


def _build_direction_files(joined, off_dt, osz, off_rate,
                           ftab_chars):
    """ebwt side bytes, zOff, fchr, ftab, eftab, offs for one direction."""
    n = len(joined)
    bwt_len = n + 1
    sa = _sa_dollar_large(joined)
    # BWT chars ($ hole packed 0 at zOff)
    bwt = np.where(sa > 0, joined[np.maximum(sa, 1) - 1], 0).astype(np.uint8)
    zoff = int(np.nonzero(sa == 0)[0][0])
    bwt[zoff] = 0

    # fchr: cumulative char starts with a leading 0 (bt2_idx.h:3105-3118)
    counts = np.bincount(joined, minlength=4)[:4]
    fchr = np.zeros(5, np.int64)
    fchr[1:] = np.cumsum(counts)

    # ebwt sides: side_sz bytes = side_bwt_sz packed bytes + 4 OffU occ
    # checkpoints holding counts BEFORE the side ($ excluded)
    side_sz = 1 << LINE_RATE
    side_bwt_sz = side_sz - osz * 4
    bwt_sz = n // 4 + 1
    num_sides = (bwt_sz + side_bwt_sz - 1) // side_bwt_sz
    packed = _pack_2bit(bwt, num_sides * side_bwt_sz)
    sides = np.zeros((num_sides, side_sz), np.uint8)
    sides[:, :side_bwt_sz] = packed.reshape(num_sides, side_bwt_sz)
    chars_per_side = side_bwt_sz * 4
    onec = np.zeros((num_sides * chars_per_side, 4), np.uint32)
    valid = np.zeros(num_sides * chars_per_side, bool)
    valid[:bwt_len] = True
    valid[zoff] = False
    idx = np.nonzero(valid)[0]
    bpad = np.zeros(num_sides * chars_per_side, np.uint8)
    bpad[:bwt_len] = bwt
    onec[idx, bpad[idx]] = 1
    per_side = onec.reshape(num_sides, chars_per_side, 4).sum(
        axis=1, dtype=np.int64)
    ckpt = np.zeros((num_sides, 4), np.int64)
    ckpt[1:] = np.cumsum(per_side[:-1], axis=0)
    sides[:, side_bwt_sz:] = ckpt.astype(off_dt).view(np.uint8).reshape(
        num_sides, osz * 4)

    # offs: row-indexed SA sampling (bt2_idx.h:3008-3013)
    offs_len = (bwt_len + (1 << off_rate) - 1) >> off_rate
    offs = sa[: (offs_len - 1) * (1 << off_rate) + 1 : 1 << off_rate]
    assert len(offs) == offs_len

    # ftab/eftab with short-suffix absorption (bt2_idx.h:2973-2998,
    # :3125-3160). c[key] counts long suffixes (>= k chars); each short
    # suffix is absorbed at the next long suffix's key (or the final
    # ftab entry when trailing).
    k = ftab_chars
    ftab_len = (1 << (2 * k)) + 1
    suf_len = n - sa  # empty row -> 0... (sa==n)
    long_m = suf_len >= k
    pows = (4 ** np.arange(k - 1, -1, -1)).astype(np.int64)
    pad_t = np.concatenate([joined.astype(np.int64), np.zeros(k, np.int64)])
    starts = sa.astype(np.int64)
    keys = np.zeros(bwt_len, np.int64)
    for i in range(k):
        keys += pad_t[np.minimum(starts + i, n)] * pows[i]
    c = np.bincount(keys[long_m] + 1, minlength=ftab_len).astype(np.int64)
    # absorb: short suffix at row r -> key of next long row after r
    a = np.zeros(ftab_len, np.int64)
    long_rows = np.nonzero(long_m)[0]
    short_rows = np.nonzero(~long_m)[0]
    if len(short_rows):
        nxt = np.searchsorted(long_rows, short_rows, side="left")
        trailing = nxt >= len(long_rows)
        tgt = np.where(trailing, ftab_len - 1,
                       keys[long_rows[np.minimum(nxt, len(long_rows) - 1)]])
        a += np.bincount(tgt, minlength=ftab_len)
    hi = np.cumsum(c + a)          # Hi(i) for i in 0..ftab_len-1
    lo = hi - a
    ftab = lo.copy()
    ftab[0] = 0
    eftab = np.zeros(2 * k, np.int64)
    off_mask = (1 << (8 * osz)) - 1
    e = 0
    for i in np.nonzero(a[1:])[0] + 1:
        eftab[2 * e] = lo[i]
        eftab[2 * e + 1] = lo[i] + a[i]
        # the entry's bits are e ^ OFF_MASK in the OffU type; ftab is int64,
        # so keep the bit pattern (the 64-bit one does not fit int64 as a
        # number) and let offu's astype(off_dt) restore it
        ftab[i] = np.uint64(e ^ off_mask).astype(np.int64)
        e += 1
    return sides.tobytes(), zoff, fchr, ftab, eftab, offs


def write_bt2(names, seqs, base: str, large: bool | None = None,
              off_rate: int = OFF_RATE,
              ftab_chars: int = FTAB_CHARS) -> None:
    """Write the 6-file reference-format index for (names, code arrays)."""
    seqs = [np.asarray(s, np.uint8) for s in seqs]
    joined = (np.concatenate([s[s < 4] for s in seqs]) if seqs
              else np.zeros(0, np.uint8))
    n = len(joined)
    if large is None:
        # format limit, not the wrapper's memory-based auto-pick: the
        # small layout holds while len+1 fits in u32
        large = n + 1 >= (1 << 32)
    ext = ".bt2l" if large else ".bt2"
    off_dt = np.uint64 if large else np.uint32
    osz = 8 if large else 4
    plen = np.array([len(s) for s in seqs], np.int64)
    n_pat = len(seqs)
    recs = _ref_records(seqs)
    nz = [r for r in recs if r[1] > 0]
    n_frag = len(nz)

    def offu(vals):
        return np.asarray(vals, np.int64).astype(off_dt).tobytes()

    def header(flags: int) -> bytes:
        return (struct.pack("<i", 1) + offu([n])
                + struct.pack("<5i", LINE_RATE, 2, off_rate, ftab_chars,
                              -flags))

    # rstarts: (joined offset, seq id, ref offset) per nonzero fragment;
    # forward order for .1, reversed traversal with same ids/offsets for
    # .rev.1 (szsToDisk's REF_READ_REVERSE inversion composed with
    # reverseRefRecords lands back on the forward ids/offsets)
    fw_rows, totlen = [], 0
    seq_i = -1
    off_in_ref = 0
    for gap, ln, first in recs:
        if first:
            seq_i += 1
            off_in_ref = 0
        off_in_ref += gap
        if ln > 0:
            fw_rows.append((totlen, seq_i, off_in_ref))
            totlen += ln
            off_in_ref += ln
    lens_fw = []
    for k2, (jo, si, ro) in enumerate(fw_rows):
        nxt = fw_rows[k2 + 1][0] if k2 + 1 < len(fw_rows) else n
        lens_fw.append(nxt - jo)
    rev_rows, rtot = [], 0
    for (jo, si, ro), ln in zip(reversed(fw_rows), reversed(lens_fw)):
        rev_rows.append((rtot, si, ro))
        rtot += ln

    names_blob = b"".join(str(nm).encode() + b"\n" for nm in names) + b"\0"

    for tag, text, flags, rows in (
            ("", joined, 1, fw_rows),
            (".rev", joined[::-1].copy(), 1 | _EBWT_ENTIRE_REV, rev_rows)):
        sides, zoff, fchr, ftab, eftab, offs = _build_direction_files(
            text, off_dt, osz, off_rate, ftab_chars)
        p1 = Path(base + tag + ".1" + ext)
        with open(p1, "wb") as f:
            f.write(header(flags))
            f.write(offu([n_pat]))
            f.write(offu(plen))
            f.write(offu([n_frag]))
            f.write(offu(np.asarray(rows, np.int64).reshape(-1)))
            f.write(sides)
            f.write(offu([zoff]))
            f.write(offu(fchr))
            f.write(offu(ftab))
            f.write(offu(eftab))
            f.write(names_blob)
        with open(base + tag + ".2" + ext, "wb") as f:
            f.write(struct.pack("<i", 1))
            f.write(offu(offs))

    with open(base + ".3" + ext, "wb") as f:
        f.write(struct.pack("<i", 1))
        f.write(offu([len(recs)]))
        for gap, ln, first in recs:
            f.write(offu([gap]) + offu([ln]) + struct.pack("<B", first))
    with open(base + ".4" + ext, "wb") as f:
        f.write(_pack_2bit(joined, (n + 3) // 4).tobytes())


def write_bt2_from_fasta(fasta, base: str, **kw) -> None:
    """FASTA -> .bt2 file set. Keeps FULL header lines as names (the
    reference stores the whole line incl. spaces; SAM consumers split on
    whitespace at load time)."""
    import io as _io
    if isinstance(fasta, (str, Path)) and "\n" not in str(fasta):
        data = Path(fasta).read_bytes()
    elif isinstance(fasta, bytes):
        data = fasta
    else:
        data = str(fasta).encode()
    from ..utils import dna
    names, seqs, cur = [], [], []
    for line in _io.BytesIO(data):
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            if names:
                seqs.append(dna.encode(b"".join(cur)))
                cur = []
            names.append(line[1:].decode())
        else:
            cur.append(line)
    if names:
        seqs.append(dna.encode(b"".join(cur)))
    write_bt2(names, seqs, base, **kw)
