"""The port's io/bam.py against the JAX package's: BamWriter's BGZF bytes,
the tag decoder, and the unpaired and paired readers on BAMs the port's
writer wrote (tags of every type, reverse-strand, secondary and unpaired
records, a file past one BGZF block)."""
import numpy as np

from bowtie2_server_tpu.io import bam as jbam
from bowtie2_server_tpu_torch.io import bam as tbam

HEADER = "@HD\tVN:1.0\tSO:unsorted\n@SQ\tSN:chr1\tLN:5000\n"
_COMP = str.maketrans("ACGTN", "TGCAN")


def sam_lines(n, seed=3):
    """n SAM lines: unaligned and aligned records, mates, reverse-strand
    and secondary ones, with i/f/A/Z tags."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(20, 151))
        seq = "".join("ACGTN"[k] for k in rng.integers(0, 5, L))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 42, L))
        kind = i % 6
        if kind == 0:
            line = f"u{i}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual}"
        elif kind == 1:
            line = (f"a{i}\t16\tchr1\t{100 + i}\t42\t{L}M\t*\t0\t0\t"
                    f"{seq.translate(_COMP)[::-1]}\t{qual[::-1]}")
        elif kind == 2:
            line = f"s{i}\t256\tchr1\t7\t0\t{L}M\t*\t0\t0\t*\t*"
        elif kind == 3:
            line = (f"p{i}\t99\tchr1\t10\t30\t{L - 4}M2I2S\t=\t300\t390\t"
                    f"{seq}\t{qual}")
        elif kind == 4:
            line = (f"p{i - 1}\t147\tchr1\t300\t30\t{L}M\t=\t10\t-390\t"
                    f"{seq.translate(_COMP)[::-1]}\t{qual[::-1]}")
        else:
            line = f"m{i}\t73\tchr1\t55\t1\t3S{L - 3}M\t*\t0\t0\t{seq}\t*"
        out.append(line + f"\tRG:Z:lane{i % 3}\tXI:i:{-i}\tXF:f:1.5"
                   f"\tXA:A:{'QRS'[i % 3]}")
    return out


def write(mod, path, lines):
    with open(path, "wb") as fh:
        w = mod.BamWriter(fh, HEADER, ["chr1"], [5000])
        for ln in lines:
            w.write_sam_line(ln)
        w.close()
    return path.read_bytes()


def test_bam_writer_bytes_equal_jax(tmp_path):
    # 1500 records: past one 60000-byte BGZF block
    lines = sam_lines(1500)
    got = write(tbam, tmp_path / "t.bam", lines)
    assert got == write(jbam, tmp_path / "j.bam", lines)
    assert got.count(b"\x1f\x8b\x08\x04") > 2


def test_tags_to_sam_equal_jax():
    import struct
    tags = (b"RGZgrp1\x00" + b"NMi" + struct.pack("<i", 3)
            + b"XSC" + struct.pack("<B", 7)
            + b"XBs" + struct.pack("<h", -300)
            + b"XAB" + b"i" + struct.pack("<iii", 2, -1, 5)
            + b"ZFf" + struct.pack("<f", 1.5) + b"ZAAQ")
    assert tbam._tags_to_sam(tags) == jbam._tags_to_sam(tags)
    assert tbam._tags_to_sam(tags).startswith("RG:Z:grp1\tNM:i:3")


def _fields(b):
    return (list(b.names), [bytes(s) for s in b.raw_seq],
            [bytes(q) for q in b.raw_qual], getattr(b, "bam_tags", None),
            b.seqs.tolist(), b.lens.tolist())


def test_iter_bam_equal_jax(tmp_path):
    path = tmp_path / "r.bam"
    write(tbam, path, sam_lines(700))
    for kw in ({}, {"preserve_tags": True}, {"keep_paired_flags": True}):
        got = [_fields(b) for b in tbam.iter_bam(path, batch_size=128, **kw)]
        want = [_fields(b) for b in jbam.iter_bam(path, batch_size=128, **kw)]
        assert got == want, kw
        # secondary records are skipped
        assert sum(len(g[0]) for g in got) == 700 - 700 // 6 - (700 % 6 > 2)
    tags = next(tbam.iter_bam(path, preserve_tags=True)).bam_tags
    assert tags[0] == "RG:Z:lane0\tXI:i:0\tXF:f:1.5\tXA:A:Q"


def test_iter_bam_paired_equal_jax(tmp_path):
    path = tmp_path / "p.bam"
    write(tbam, path, sam_lines(600))
    got = [(_fields(a), _fields(b))
           for a, b in tbam.iter_bam_paired(path, batch_size=32)]
    want = [(_fields(a), _fields(b))
            for a, b in jbam.iter_bam_paired(path, batch_size=32)]
    assert got == want
    assert sum(len(a[0]) for a, _ in got) == 100
