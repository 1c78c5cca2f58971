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
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            cp = ctypes.c_char_p
            lib.bt2tpu_sam_format.restype = ctypes.c_int64
            lib.bt2tpu_sam_format.argtypes = [
                i32p, i64p, u8p, u8p,                 # tidx,pysrc,filt,yf2
                cp, i64p, cp, i64p, cp, i64p,         # name/seq/qual blobs
                u8p, i32p, i64p, i64p, u8p, i64p,     # fw,refid,pos,score,
                i32p, i32p, i32p,                     # sec_has,sec,mapq,nm,rl
                i64p, i64p, u8p,                      # mm split/cols/ref
                cp, i64p,                             # ref-name blob
                cp, i64p,                             # py-lines blob
                cp, ctypes.c_int64,                   # rg
                ctypes.c_int32, ctypes.c_int32,       # B, no_unal
                cp, ctypes.c_int64]                   # out, cap
            _LIB = lib
    return _LIB


def _offsets(items) -> "np.ndarray":
    off = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(x) for x in items], out=off[1:])
    return off


def sam_format_batch(recs, ref_names, rg_id=None, no_unal=False):
    """Format a whole unpaired batch into SAM bytes via the native emitter
    (ref: sam.cpp:252-744 buffer assembly). recs must be a LazyRecs with a
    FastSoA; slow-path records are pre-rendered by the caller-supplied
    renderer and spliced in order. Returns bytes, or None when the native
    lib is unavailable (caller falls back to per-record formatting)."""
    from ..io.sam import sam_record

    lib = get_lib()
    soa = getattr(recs, "soa", None)
    if lib is None or soa is None:
        return None
    soa._ensure_mm()
    batch = recs.batch
    B = len(recs)

    tidx = np.ascontiguousarray(soa.tidx, np.int32).copy()
    pysrc = np.full(B, -1, np.int64)
    py_lines = []
    for i, rec in recs.cache_items():
        if no_unal and not rec.aligned:
            tidx[i] = -1
            continue
        pysrc[i] = len(py_lines)
        py_lines.append(sam_record(rec, ref_names, rg_id).encode())
    py_blob = b"".join(py_lines)
    py_off = _offsets(py_lines)

    names_b = [n.encode() for n in batch.names]
    name_blob = b"".join(names_b)
    name_off = _offsets(names_b)
    seq_blob = b"".join(batch.raw_seq)
    seq_off = _offsets(batch.raw_seq)
    qual_blob = b"".join(batch.raw_qual)
    qual_off = _offsets(batch.raw_qual)

    filt = np.ascontiguousarray(recs.filtered, np.uint8)
    yf2 = np.frombuffer(b"NS" * B, np.uint8).copy()
    if recs.qc is not None:
        qcm = np.asarray(recs.qc, bool)
        yf2 = yf2.reshape(B, 2)
        yf2[qcm] = np.frombuffer(b"QC", np.uint8)
        yf2 = yf2.reshape(-1)

    rn_b = [str(r).encode() for r in ref_names]
    rn_blob = b"".join(rn_b)
    rn_off = _offsets(rn_b)

    fw = np.ascontiguousarray(soa.fw, np.uint8)
    ref_id = np.ascontiguousarray(soa.ref_id, np.int32)
    pos = np.ascontiguousarray(soa.pos, np.int64)
    score = np.ascontiguousarray(soa.score, np.int64)
    sec_has = np.ascontiguousarray(soa.sec_has, np.uint8)
    sec = np.ascontiguousarray(soa.sec, np.int64)
    mapq = np.ascontiguousarray(soa.mapq, np.int32)
    nm = np.ascontiguousarray(soa.nm, np.int32)
    rl = np.ascontiguousarray(soa.rl, np.int32)
    mm_split = np.ascontiguousarray(soa.mm_split, np.int64)
    mm_cols = np.ascontiguousarray(soa.mm_cols, np.int64)
    mm_ref = np.ascontiguousarray(soa.mm_ref, np.uint8)

    rg = (rg_id or "").encode()
    cap = (len(name_blob) + 2 * len(seq_blob) + len(qual_blob)
           + 560 * B + 6 * len(mm_cols) + len(py_blob) + 1024)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def p32(a):
        return a.ctypes.data_as(i32p)

    def p64(a):
        return a.ctypes.data_as(i64p)

    def pu8(a):
        return a.ctypes.data_as(u8p)

    for _ in range(3):
        out = ctypes.create_string_buffer(int(cap))
        ret = lib.bt2tpu_sam_format(
            p32(tidx), p64(pysrc), pu8(filt), pu8(yf2),
            name_blob, p64(name_off), seq_blob, p64(seq_off),
            qual_blob, p64(qual_off),
            pu8(fw), p32(ref_id), p64(pos), p64(score), pu8(sec_has),
            p64(sec), p32(mapq), p32(nm), p32(rl),
            p64(mm_split), p64(mm_cols), pu8(mm_ref),
            rn_blob, p64(rn_off), py_blob, p64(py_off),
            rg, int(len(rg)),
            int(B), int(bool(no_unal)), out, int(cap))
        if ret >= 0:
            return out.raw[:ret]
        cap *= 4
    return None


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
