"""DNA alphabet encoding helpers (ref: alphabet.cpp/h, sstring.h).

Encoding: A=0, C=1, G=2, T=3, N/ambiguous=4 — matching the reference's 2-bit
nucleotide codes so index structures and DP profiles agree with Bowtie 2's
conventions (ref: alphabet.cpp `asc2dna`).
"""
from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4

# ASCII -> code lookup (IUPAC ambiguity codes all map to N=4, like asc2dna).
ASC2DNA = np.full(256, 4, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    ASC2DNA[ord(_ch)] = _code
    ASC2DNA[ord(_ch.lower())] = _code

DNA2ASC = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()

# Complement in code space: A<->T, C<->G, N->N.
COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return ASC2DNA[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return DNA2ASC[np.minimum(codes, 4)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[codes[::-1]]


def phred33(qual: bytes | str) -> np.ndarray:
    """Phred+33 quality string -> integer qualities."""
    if isinstance(qual, str):
        qual = qual.encode("ascii")
    q = np.frombuffer(qual, dtype=np.uint8).astype(np.int32) - 33
    return np.maximum(q, 0)


# ASCII-level reverse complement (C-speed via bytes.translate; IUPAC
# ambiguity codes map to N like asc2dna does in code space).
_COMP_ASCII = bytearray(b"N" * 256)
for _a, _b in ((b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A"),
               (b"U", b"A")):
    _COMP_ASCII[_a[0]] = _b[0]
    _COMP_ASCII[ord(chr(_a[0]).lower())] = _b[0]
COMP_ASCII = bytes(_COMP_ASCII)


def revcomp_ascii(seq: bytes) -> bytes:
    return seq[::-1].translate(COMP_ASCII)
