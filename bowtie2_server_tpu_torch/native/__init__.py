"""Native (C++) components, loaded via ctypes (ref: the reference's C++
core — index construction blockwise_sa.h/libsais, parsing pat.cpp).

The shared library is compiled on demand with g++ -O3 into the package's
build directory (`build/native/`, keyed by a hash of the sources, so a
stale library is never loaded); environments without a toolchain fall back
to the pure numpy/python implementations transparently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_BUILD = _HERE.parent / "build" / "native"
_LIB = None
_TRIED = False


def _build() -> Path | None:
    srcs = sorted(_HERE.glob("*.cpp"))
    if not srcs:
        return None
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.read_bytes())
    so = _BUILD / f"libbt2tpu_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent processes (test
    # workers) may race on the same library
    fd, tmp = tempfile.mkstemp(dir=_BUILD, suffix=".so.tmp")
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", "-o", tmp] + [str(s) for s in srcs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as e:
        # no toolchain / failed build -> python fallback
        print(f"bt2tpu: native build unavailable ({e}); using python "
              f"fallbacks", file=sys.stderr)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def get_lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        so = _build()
        if so is not None:
            lib = ctypes.CDLL(str(so))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.bt2tpu_sais.restype = ctypes.c_int
            lib.bt2tpu_sais.argtypes = [
                u8p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
            lib.bt2tpu_sais64.restype = ctypes.c_int
            lib.bt2tpu_sais64.argtypes = [
                u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            lib.bt2tpu_sa_from_bwt.restype = ctypes.c_int
            lib.bt2tpu_sa_from_bwt.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64)]
            cp = ctypes.c_char_p
            side_p = ctypes.POINTER(_Side)
            lib.bt2tpu_sam_emit.restype = ctypes.c_int64
            lib.bt2tpu_sam_emit.argtypes = [
                side_p, side_p, ctypes.c_int32,       # a, b (or None), B
                cp, _I64, ctypes.c_int32,             # ref-name blob, n_ref
                cp, ctypes.c_int64,                   # rg
                ctypes.c_int32, ctypes.c_int32,       # no_unal, markers
                _I64, ctypes.c_void_p, ctypes.c_int64]  # row_end, out, cap
            _LIB = lib
    return _LIB


def _offsets(items) -> "np.ndarray":
    off = np.zeros(len(items) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, items), np.int64, len(items)),
              out=off[1:])
    return off


_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)


class _Side(ctypes.Structure):
    """`struct Side` of samfmt.cpp, field for field."""
    _fields_ = [
        ("tidx", _I32), ("pysrc", _I64), ("filtered", _U8), ("yf2", _U8),
        ("name_blob", ctypes.c_char_p), ("name_off", _I64),
        ("seq_blob", ctypes.c_char_p), ("seq_off", _I64),
        ("qual_blob", ctypes.c_char_p), ("qual_off", _I64),
        ("fw", _U8), ("ref_id", _I32), ("pos0", _I64), ("score", _I64),
        ("sec_has", _U8), ("sec", _I64), ("mapq", _I32), ("nm", _I32),
        ("rl", _I32),
        ("mm_split", _I64), ("mm_cols", _I64), ("mm_ref", _U8),
        ("py_blob", ctypes.c_char_p), ("py_off", _I64),
        ("mate_fw", _U8), ("mate_ref_id", _I32), ("mate_pos", _I64),
        ("tlen", _I64), ("ys", _I64),
        ("mate1", ctypes.c_int32)]


# YF:Z: codes by LazyRecs.yf_codes (ref: AlnFlags::printYF priority)
_YF = np.frombuffer(b"LNNSSCQC", np.uint8).reshape(4, 2)
# each array field's pointer type and numpy dtype
_PTR = dict(_Side._fields_)
_DTYPE = {name: {_U8: np.uint8, _I32: np.int32, _I64: np.int64}[t]
          for name, t in _PTR.items() if t in (_U8, _I32, _I64)}


class SamSide:
    """The native emitter's inputs for one LazyRecs (`sam_side`): the
    structure it reads and the arrays and blobs it points into, held for
    as long as the emitter may read them. B: the reads; columns: those
    whose line the emitter writes from the column store; nbytes: the
    blobs' bytes."""

    __slots__ = ("st", "keep", "B", "columns", "nbytes")

    def __init__(self, B):
        self.st = _Side()
        self.keep = []
        self.B = B

    def put(self, field: str, a):
        """Point `field` at `a` as a contiguous array of its dtype."""
        a = np.ascontiguousarray(a, _DTYPE[field])
        self.keep.append(a)
        setattr(self.st, field, a.ctypes.data_as(_PTR[field]))

    def blob(self, field: str, items):
        """Point `field` at the items' bytes joined, `<field>_off` at their
        B + 1 offsets."""
        b = b"".join(items)
        self.keep.append(b)
        setattr(self.st, field + "_blob", b)
        self.put(field + "_off", _offsets(items))
        return len(b)


def sam_side(recs, ref_names, rg_id=None, no_unal=False, mates=False):
    """The emitter's inputs for a LazyRecs: its batch's names, sequences
    and qualities, its column store (FastSoA, with the concordant fast
    pairs' columns where it has them), and the lines of the reads the
    columns do not hold, rendered by `sam_record`: those the aligner
    materialised (`cache_items`), and with `mates` (a pair batch's mate,
    whose records the paired decisions made) every read outside the
    columns. Under no_unal an unaligned materialised read is left out."""
    from ..io.sam import sam_record

    B = len(recs)
    side = SamSide(B)
    soa = recs.soa
    if soa is None:
        tidx = np.full(B, -1, np.int32)
    else:
        soa._ensure_mm()
        tidx = np.array(soa.tidx, np.int32)
    if mates:
        for i in np.nonzero(tidx < 0)[0].tolist():
            recs[i]     # materialised: the decisions' record, or unaligned
    pysrc = np.full(B, -1, np.int64)
    py_lines = []
    for i, rec in recs.cache_items():
        if no_unal and not rec.aligned:
            tidx[i] = -1
            continue
        pysrc[i] = len(py_lines)
        py_lines.append(sam_record(rec, ref_names, rg_id).encode())
    side.columns = int(np.count_nonzero((tidx >= 0) & (pysrc < 0)))
    side.put("tidx", tidx)
    side.put("pysrc", pysrc)
    side.put("filtered", recs.filtered)
    if recs.yf_codes is not None:
        yf = np.asarray(recs.yf_codes)
    else:
        yf = np.ones(B, np.int64)   # NS
        if recs.qc is not None:
            yf[np.asarray(recs.qc, bool)] = 3
    side.put("yf2", _YF[yf])
    batch = recs.batch
    side.nbytes = (side.blob("name", [n.encode() for n in batch.names])
                   + side.blob("seq", batch.raw_seq)
                   + side.blob("qual", batch.raw_qual)
                   + side.blob("py", py_lines))
    if soa is None:
        return side
    for f in ("fw", "ref_id", "score", "sec_has", "sec", "mapq", "nm", "rl",
              "mm_split", "mm_cols", "mm_ref"):
        side.put(f, getattr(soa, f))
    side.put("pos0", soa.pos)
    side.nbytes += 24 * len(soa.mm_cols)
    if soa.pair is not None:
        p = soa.pair
        for f in ("mate_fw", "mate_ref_id", "mate_pos", "tlen", "ys"):
            side.put(f, p[f])
        side.st.mate1 = int(bool(p["mate1"]))
    return side


def _capacity(sides, rn_max: int, markers: bool) -> int:
    """The emitter's first buffer size: enough for every row of usual
    tags; a row that would not fit makes `sam_emit` grow it."""
    return sum(s.nbytes + s.B * (320 + 2 * rn_max) for s in sides) \
        + (sides[0].nbytes + 16 * sides[0].B if markers else 0)


def sam_emit(a: SamSide, b: SamSide | None = None, *, ref_names,
             rg_id=None, no_unal=False, markers=False):
    """One emitter call over side a's reads (and b's, a pair batch's
    mates 2, each after its mate 1), each row ended by its END READ
    marker where `markers` (a's name). Returns (bytes, each row's end
    offset in them); None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rn_b = [str(r).encode() for r in ref_names]
    rn_blob = b"".join(rn_b)
    rn_off = _offsets(rn_b)
    rg = (rg_id or "").encode()
    sides = [a] if b is None else [a, b]
    cap = _capacity(sides, max(map(len, rn_b), default=0), markers)
    row_end = np.empty(a.B, np.int64)
    while True:
        out = np.empty(max(int(cap), 1), np.uint8)
        ret = lib.bt2tpu_sam_emit(
            ctypes.byref(a.st), None if b is None else ctypes.byref(b.st),
            a.B, rn_blob, rn_off.ctypes.data_as(_I64), len(rn_b),
            rg, len(rg), int(bool(no_unal)), int(bool(markers)),
            row_end.ctypes.data_as(_I64), out.ctypes.data, out.size)
        if ret >= 0:
            return out[:ret].tobytes(), row_end
        cap = 4 * out.size


def sam_format_batch(recs, ref_names, rg_id=None, no_unal=False):
    """Format a whole unpaired batch into SAM bytes via the native emitter
    (ref: sam.cpp:252-744 buffer assembly). recs must be a LazyRecs with a
    FastSoA; the reads it materialised are rendered by `sam_record` and
    spliced in order. Returns bytes, or None when the native lib is
    unavailable (caller falls back to per-record formatting)."""
    if get_lib() is None or getattr(recs, "soa", None) is None:
        return None
    return sam_emit(sam_side(recs, ref_names, rg_id, no_unal),
                    ref_names=ref_names, rg_id=rg_id, no_unal=no_unal)[0]


def sais(text: np.ndarray, force64: bool = False) -> np.ndarray | None:
    """Suffix array via native SA-IS; 64-bit positions for texts beyond
    int32 (the .bt2l-scale path, ref: btypes.h BOWTIE_64BIT_INDEX). None if
    the native lib is unavailable."""
    lib = get_lib()
    n = len(text)
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.uint8)
    # the library sorts into n + 1 slots, the sentinel suffix first
    if n >= (1 << 31) or force64:
        sa = np.empty(n + 1, dtype=np.int64)
        rc = lib.bt2tpu_sais64(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            np.int64(n), sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return sa[1:] if rc == 0 else None
    sa = np.empty(n + 1, dtype=np.int32)
    rc = lib.bt2tpu_sais(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int32(n), sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        return None
    return sa[1:].astype(np.int64)


def sa_from_bwt(bwt: np.ndarray, primary: int,
                dollar_large: bool = False) -> np.ndarray | None:
    """Full suffix array ((n+1)-row space, int64) reconstructed from a BWT
    by one LF-walk — the .bt2 interop path that skips suffix sorting
    entirely (ref: bt2_idx.h:1607 walkLeft, done eagerly for the whole
    array). dollar_large selects the reference's suffix-order convention
    ($ sorts after every character). Returns None if the native lib is
    unavailable or the BWT is inconsistent."""
    lib = get_lib()
    if lib is None:
        return None
    bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
    sa = np.empty(len(bwt), dtype=np.int64)
    rc = lib.bt2tpu_sa_from_bwt(
        bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int64(len(bwt)), np.int64(primary), np.int32(dollar_large),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return sa if rc == 0 else None
