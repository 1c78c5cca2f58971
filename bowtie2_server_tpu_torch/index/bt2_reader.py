"""Reader for the reference's .bt2/.bt2l index format (ref: bt2_io.cpp:39
readIntoMemory, :933 szsToDisk; reference.cpp BitPairReference ctor).

Interop path: a user points us at an existing bowtie2 index; we recover the
complete reference sequences (including N runs) from:
  .3.bt2  — RefRecords: (off=N-gap, len, first) per unambiguous stretch
  .4.bt2  — the stretches' bases, 2-bit packed little-endian within bytes
  .1.bt2  — header (lengths/params), per-reference lengths (plen) and the
            reference names (stored after the eftab)
and DECODE the stored BWT directly (both .1 and .rev.1): unpacking the
2-bit ebwt sides and LF-walking the cycle once (native/bwt_walk.cpp) fills
our full suffix array in O(n) with no suffix sorting — the mammalian-scale
interop path (ref: bt2_io.cpp:39 readIntoMemory + bt2_idx.h:1607 walkLeft,
done eagerly). The stored layout uses the OPPOSITE terminator convention
from our native builds ($ sorts after every character — verified against
bowtie2-build output on crafted genomes), so the FmDirection built here
carries cnt/ftab/primary values in that convention; all search code is
value-driven and convention-agnostic. If the native walker is unavailable
the loader falls back to rebuilding from the reconstructed genome.

Layout of .1 (32-bit; .bt2l uses 8-byte offsets):
  u32 endian(=1) | OffU len | i32 lineRate, linesPerSide, offRate,
  ftabChars, flags | OffU nPat | OffU plen[nPat] | OffU nFrag |
  OffU rstarts[3*nFrag] | u8 ebwt[numSides*sideSz] | OffU zOff |
  OffU fchr[5] | OffU ftab[(1<<2k)+1] | OffU eftab[2k] | names \\0-separated
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..utils import dna
from .build import build_index
from .fm import FTAB_CHARS, OCC_BLOCK, FmDirection, FmIndex


def _off_dtype(large: bool):
    return (np.uint64, 8) if large else (np.uint32, 4)


def read_bt2_metadata(base: str):
    """Parse the .1 header: returns (params dict, plen, refnames)."""
    large = Path(base + ".1.bt2l").exists() and \
        not Path(base + ".1.bt2").exists()
    ext = ".bt2l" if large else ".bt2"
    dt, osz = _off_dtype(large)
    data = Path(base + ".1" + ext).read_bytes()
    pos = 0

    def u32():
        nonlocal pos
        v = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        return v

    def offu(n=1):
        nonlocal pos
        v = np.frombuffer(data, dt, n, pos)
        pos += osz * n
        return v if n > 1 else int(v[0])

    one = struct.unpack_from("<I", data, 0)[0]
    pos = 4
    if one != 1:
        raise ValueError("big-endian .bt2 indexes are not supported")
    length = offu()
    line_rate = u32()
    u32()  # linesPerSide
    off_rate = u32()
    ftab_chars = u32()
    u32()  # flags
    n_pat = offu()
    plen = np.array(offu(n_pat), dtype=np.int64).reshape(-1)
    n_frag = offu()
    rstarts = np.array(offu(3 * n_frag), dtype=np.int64).reshape(-1, 3)
    # ebwt sides / zOff / fchr / ftab / eftab (ref: bt2_idx.h:133-166)
    bwt_len = length + 1
    bwt_sz = length // 4 + 1
    side_sz = 1 << line_rate
    side_bwt_sz = side_sz - osz * 4
    num_sides = (bwt_sz + side_bwt_sz - 1) // side_bwt_sz
    ebwt_tot = num_sides * side_sz
    ebwt_pos = pos
    pos += ebwt_tot
    zoff = offu()
    pos += osz * 5      # fchr
    pos += osz * ((1 << (ftab_chars * 2)) + 1)  # ftab
    pos += osz * (ftab_chars * 2)               # eftab
    # names are newline-separated, NUL-terminated; each keeps the full
    # FASTA header line — SAM uses the first whitespace token
    names = data[pos:].rstrip(b"\x00").split(b"\n")
    # keep the FULL header; display sites truncate at the first
    # whitespace unless --fullref (ref: ARG_FULLREF)
    refnames = [n.decode().strip() for n in names if n.strip()][:n_pat]
    return dict(length=int(length), line_rate=line_rate, off_rate=off_rate,
                ftab_chars=ftab_chars, n_pat=int(n_pat), large=large,
                ext=ext, rstarts=rstarts, ebwt_pos=ebwt_pos,
                num_sides=num_sides, side_sz=side_sz,
                side_bwt_sz=side_bwt_sz, bwt_len=bwt_len,
                zoff=int(zoff)), plen, refnames


def read_bt2_reference(base: str):
    """Recover (names, per-ref code arrays incl. Ns) from .1/.3/.4."""
    meta, plen, names = read_bt2_metadata(base)
    dt, osz = _off_dtype(meta["large"])
    ext = meta["ext"]
    d3 = Path(base + ".3" + ext).read_bytes()
    one = struct.unpack_from("<I", d3, 0)[0]
    if one != 1:
        raise ValueError("big-endian .3 not supported")
    n_recs = struct.unpack_from("<I", d3, 4)[0] if osz == 4 else \
        struct.unpack_from("<Q", d3, 4)[0]
    recs = []
    pos = 4 + osz
    for _ in range(n_recs):
        off = int(np.frombuffer(d3, dt, 1, pos)[0]); pos += osz
        ln = int(np.frombuffer(d3, dt, 1, pos)[0]); pos += osz
        first = d3[pos] != 0; pos += 1
        recs.append((off, ln, first))

    packed = np.frombuffer(Path(base + ".4" + ext).read_bytes(), np.uint8)
    # 2-bit little-endian within byte (ref: reference.cpp getStretchNaive)
    codes = np.empty(len(packed) * 4, np.uint8)
    for j in range(4):
        codes[j::4] = (packed >> (2 * j)) & 3

    seqs = []
    cur = None
    joined_off = 0
    ref_i = -1
    for off, ln, first in recs:
        if first:
            if cur is not None:
                seqs.append(cur)
            ref_i += 1
            cur = np.full(int(plen[ref_i]), 4, np.uint8)
            ref_pos = 0
        ref_pos += off  # N gap
        cur[ref_pos : ref_pos + ln] = codes[joined_off : joined_off + ln]
        ref_pos += ln
        joined_off += ln
    if cur is not None:
        seqs.append(cur)
    return names, seqs


def read_bt2_ebwt(base: str) -> tuple[np.ndarray, int]:
    """Decode one direction's packed BWT from a .1/.rev.1 file: returns
    (bwt codes [length+1] uint8 with the $ hole marked 4, primary row).

    The ebwt is stored as fixed-size "sides": side_bwt_sz bytes of 2-bit
    little-endian packed BWT followed by 4 per-side occ checkpoints that we
    recompute ourselves (ref: bt2_idx.h:112-166 side layout)."""
    meta, _, _ = read_bt2_metadata(base)
    data = Path(base + ".1" + meta["ext"]).read_bytes()
    ebwt = np.frombuffer(data, np.uint8, meta["num_sides"] * meta["side_sz"],
                         meta["ebwt_pos"])
    packed = ebwt.reshape(meta["num_sides"],
                          meta["side_sz"])[:, : meta["side_bwt_sz"]]
    packed = packed.reshape(-1)
    codes = np.empty(len(packed) * 4, np.uint8)
    for j in range(4):
        codes[j::4] = (packed >> (2 * j)) & 3
    bwt = codes[: meta["bwt_len"]].copy()
    bwt[meta["zoff"]] = 4
    return bwt, meta["zoff"]


def direction_from_bwt(text: np.ndarray, bwt: np.ndarray,
                       primary: int) -> FmDirection | None:
    """FmDirection from a decoded reference BWT — no suffix sorting.

    The full SA comes from one native LF-walk of the BWT cycle
    (native/bwt_walk.cpp); occ/cnt/ftab are assembled in the reference's
    $-after-everything convention (see module docstring). Returns None when
    the native walker is unavailable (caller falls back to a rebuild)."""
    from ..native import sa_from_bwt
    n = len(text)
    n_rows = n + 1
    if len(bwt) != n_rows:
        return None
    sa_std = sa_from_bwt(bwt, primary, dollar_large=True)
    if sa_std is None:
        return None

    # occ checkpoints (hole uncounted)
    n_blocks = (n_rows + OCC_BLOCK - 1) // OCC_BLOCK
    onehot = np.zeros((n_blocks * OCC_BLOCK, 4), dtype=np.uint32)
    valid = np.nonzero(bwt < 4)[0]
    onehot[valid, bwt[valid]] = 1
    per_block = onehot.reshape(n_blocks, OCC_BLOCK, 4).sum(
        axis=1, dtype=np.uint64)
    occ = np.zeros((n_blocks + 1, 4), dtype=np.uint32)
    occ[1:] = np.cumsum(per_block, axis=0).astype(np.uint32)

    # C array, $-large: the empty-suffix row sorts LAST, so no +1 shift
    counts = np.bincount(text, minlength=4)[:4]
    cnt = np.zeros(5, dtype=np.int64)
    cnt[1:] = np.cumsum(counts)

    # ftab in $-large row order. Full suffixes use their packed k-mer key;
    # suffixes shorter than k sort at the END of their own-prefix block, so
    # they get the largest key with that prefix and a bot-side exclusion
    # (mirror image of the $-small top bump in build._build_direction).
    k = FTAB_CHARS
    pows = (4 ** np.arange(k - 1, -1, -1)).astype(np.int64)
    padded = np.concatenate([text.astype(np.int64), np.zeros(k, np.int64)])
    starts = sa_std.astype(np.int64)
    keys = np.zeros(n_rows, dtype=np.int64)
    for i in range(k):
        keys += padded[np.minimum(starts + i, n)] * pows[i]
    slen = np.minimum(n - starts, k)
    short = slen < k
    if short.any():
        tail = (4 ** (k - slen[short])).astype(np.int64)
        keys[short] = keys[short] + (tail - 1)
    all_kmers = np.arange(4 ** k, dtype=np.int64)
    top = np.searchsorted(keys, all_kmers, side="left")
    bot = np.searchsorted(keys, all_kmers, side="right")
    if short.any():
        bump = np.bincount(keys[short], minlength=4 ** k)
        bot = bot - bump

    return FmDirection(
        bwt=bwt, occ=occ, cnt=cnt,
        sa=sa_std.astype(np.uint32 if n_rows < (1 << 32) else np.uint64),
        primary=primary,
        ftab_top=top.astype(np.uint32), ftab_bot=bot.astype(np.uint32))


def load_bt2_index(base: str) -> FmIndex:
    """Load a reference-format index. Fast path: decode the stored BWTs of
    both directions and LF-walk them into full SAs (O(n), no sorting).
    Fallback (no native lib / inconsistent files): reconstruct the genome
    and rebuild from scratch."""
    from .build import ref_geometry
    names, seqs = read_bt2_reference(base)
    geom = ref_geometry(names, seqs)
    joined = geom["joined"]

    fw = mirror = None
    try:
        bwt_fw, z_fw = read_bt2_ebwt(base)
        fw = direction_from_bwt(joined, bwt_fw, z_fw)
        rev_base = base + ".rev"
        if fw is not None and (Path(rev_base + ".1.bt2").exists()
                               or Path(rev_base + ".1.bt2l").exists()):
            bwt_mr, z_mr = read_bt2_ebwt(rev_base)
            mirror = direction_from_bwt(joined[::-1].copy(), bwt_mr, z_mr)
    except (ValueError, OSError):
        fw = mirror = None
    if fw is not None and mirror is not None:
        return FmIndex(fw=fw, mirror=mirror, cache_base=str(base), **geom)

    # fallback: full rebuild from the reconstructed genome
    fasta = []
    for n, s in zip(names, seqs):
        fasta.append(f">{n}\n{dna.decode(s)}")
    return build_index("\n".join(fasta) + "\n")


def detect_index(base: str):
    """Return ('native'|'bt2', loader) for an index basename."""
    if Path(base + ".fm.npz").exists():
        return "native", FmIndex.load
    if Path(base + ".1.bt2").exists() or Path(base + ".1.bt2l").exists():
        return "bt2", load_bt2_index
    raise FileNotFoundError(f"no index found at {base}(.fm.npz/.1.bt2)")
