"""BAM read input (ref: pat.h:1074 BAMPatternSource with BGZF inflation).

Parses BGZF blocks with stdlib zlib and decodes BAM alignment records into
read batches. Records flagged secondary/supplementary (0x900) are skipped;
reverse-strand records are reverse-complemented back to original read
orientation, as the reference does when re-aligning from BAM.
"""
from __future__ import annotations

import struct
import zlib

from ..utils import dna
from .fastq import make_batch

_SEQ4 = "=ACMGRSVTWYHKDBN"
_C4 = {c: i for i, c in enumerate(_SEQ4)}


def _bgzf_blocks(f):
    while True:
        head = f.read(12)
        if len(head) < 12:
            return
        magic, _mtime, _xfl, _os, xlen = struct.unpack("<IIBBH", head)
        extra = f.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], \
                struct.unpack("<H", extra[i + 2 : i + 4])[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0]
            i += 4 + slen
        if bsize is None:
            raise ValueError("not a BGZF stream (no BC subfield)")
        cdata = f.read(bsize - xlen - 19)
        f.read(8)  # crc + isize
        data = zlib.decompress(cdata, -15)
        if not data:
            return  # EOF block
        yield data


def iter_bam_paired(path, batch_size: int = 4096):
    """Paired BAM input (--align-paired-reads; ref: pat.h:1074
    BAMPatternSource with gAlignPairedBAM): mate-1 records (flag 0x40)
    pair with the NEXT mate-2 record (0x80) of the same QNAME — the
    name-adjacent layout of name-sorted / as-produced BAM. Unpaired
    records (no 0x1) are skipped. Yields (batch1, batch2)."""
    from .fastq import make_batch as _mk
    n1, s1, q1, n2, s2, q2 = [], [], [], [], [], []
    pend: dict[str, tuple] = {}
    for name, seq, qual, flag, _tb in _iter_bam_records(path):
        if not flag & 0x1:
            continue
        mate1 = bool(flag & 0x40)
        other = pend.pop(name, None)
        if other is None:
            pend[name] = (seq, qual, mate1)
            continue
        oseq, oq, omate1 = other
        if mate1 == omate1:     # same mate twice: keep the newest pending
            pend[name] = (seq, qual, mate1)
            continue
        m1s, m1q, m2s, m2q = ((seq, qual, oseq, oq) if mate1
                              else (oseq, oq, seq, qual))
        n1.append(name)
        s1.append(m1s)
        q1.append(m1q)
        n2.append(name)
        s2.append(m2s)
        q2.append(m2q)
        if len(n1) >= batch_size:
            yield _mk(n1, s1, q1), _mk(n2, s2, q2)
            n1, s1, q1, n2, s2, q2 = [], [], [], [], [], []
    if n1:
        yield _mk(n1, s1, q1), _mk(n2, s2, q2)


_TAG_FMT = {ord("c"): ("<b", 1), ord("C"): ("<B", 1), ord("s"): ("<h", 2),
            ord("S"): ("<H", 2), ord("i"): ("<i", 4), ord("I"): ("<I", 4),
            ord("f"): ("<f", 4)}


def _tags_to_sam(buf: bytes) -> str:
    """Decode a BAM optional-field block to tab-joined SAM text tags
    (ref: sam.cpp:881 printPreservedOptFlags — the --preserve-tags
    emitter; SAM spec 4.2.4 type mapping: c/C/s/S/i/I -> i, f -> f,
    A/Z/H verbatim, B arrays)."""
    out = []
    i, n = 0, len(buf)
    while i + 3 <= n:
        tag = buf[i : i + 2].decode("latin1")
        vt = buf[i + 2]
        i += 3
        if vt in _TAG_FMT:
            fmt, sz = _TAG_FMT[vt]
            (v,) = struct.unpack_from(fmt, buf, i)
            i += sz
            if vt == ord("f"):
                out.append(f"{tag}:f:{v:g}")
            else:
                out.append(f"{tag}:i:{v}")
        elif vt == ord("A"):
            out.append(f"{tag}:A:{chr(buf[i])}")
            i += 1
        elif vt in (ord("Z"), ord("H")):
            end = buf.index(b"\x00", i)
            out.append(f"{tag}:{chr(vt)}:{buf[i:end].decode('latin1')}")
            i = end + 1
        elif vt == ord("B"):
            sub = buf[i]
            (cnt,) = struct.unpack_from("<i", buf, i + 1)
            i += 5
            fmt, sz = _TAG_FMT[sub]
            vals = struct.unpack_from("<" + fmt[1] * cnt, buf, i)
            i += sz * cnt
            out.append(f"{tag}:B:{chr(sub)}," + ",".join(
                f"{v:g}" if sub == ord("f") else str(v) for v in vals))
        else:
            break   # unknown type: stop decoding this record's tags
    return "\t".join(out)


def _iter_bam_records(path):
    """Yield (name, seq, qual, flag) of primary records in a BAM file."""
    buf = b""
    with open(path, "rb") as f:
        blocks = _bgzf_blocks(f)

        def need(n):
            nonlocal buf
            while len(buf) < n:
                try:
                    buf += next(blocks)
                except StopIteration:
                    return False
            return True

        if not need(4) or buf[:4] != b"BAM\x01":
            raise ValueError("not a BAM file")
        buf = buf[4:]
        need(4)
        l_text = struct.unpack("<i", buf[:4])[0]
        need(4 + l_text + 4)
        buf = buf[4 + l_text:]
        n_ref = struct.unpack("<i", buf[:4])[0]
        buf = buf[4:]
        for _ in range(n_ref):
            need(4)
            l_name = struct.unpack("<i", buf[:4])[0]
            need(4 + l_name + 4)
            buf = buf[4 + l_name + 4:]
        while True:
            if not need(4):
                break
            bs = struct.unpack("<i", buf[:4])[0]
            if not need(4 + bs):
                break
            rec = buf[4 : 4 + bs]
            buf = buf[4 + bs:]
            (_refid, _pos, l_rn, _mapq, _bin, n_cigar, flag, l_seq,
             _nrefid, _npos, _tlen) = struct.unpack("<iiBBHHHiiii", rec[:32])
            if flag & 0x900:
                continue  # secondary / supplementary
            off = 32
            name = rec[off : off + l_rn - 1].decode()
            off += l_rn + 4 * n_cigar
            nb = (l_seq + 1) // 2
            seq4 = rec[off : off + nb]
            off += nb
            qual = rec[off : off + l_seq]
            tagblock = rec[off + l_seq :]
            chars = []
            for i in range(l_seq):
                b4 = (seq4[i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF
                chars.append(_SEQ4[b4])
            seq = "".join(chars).encode()
            q = bytes(min(x, 93) + 33 for x in qual) if qual and \
                qual[0] != 0xFF else b"I" * l_seq
            if flag & 0x10:  # stored revcomp: restore original orientation
                seq = dna.decode(dna.revcomp(dna.encode(seq))).encode()
                q = q[::-1]
            yield name, seq, q, flag, tagblock


def iter_bam(path, batch_size: int = 4096, keep_paired_flags: bool = False,
             preserve_tags: bool = False):
    """Yield ReadBatch objects of the reads stored in a BAM file
    (unpaired view: every primary record becomes a read). With
    preserve_tags, each batch carries the records' decoded SAM-text tag
    strings in `bam_tags` (ref: --preserve-tags, bt2_search.cpp:736)."""
    names, seqs, quals, tags = [], [], [], []
    for name, seq, q, _flag, tb in _iter_bam_records(path):
        names.append(name)
        seqs.append(seq)
        quals.append(q)
        if preserve_tags:
            tags.append(_tags_to_sam(tb))
        if len(names) >= batch_size:
            b = make_batch(names, seqs, quals)
            if preserve_tags:
                b.bam_tags = tags
            yield b
            names, seqs, quals, tags = [], [], [], []
    if names:
        b = make_batch(names, seqs, quals)
        if preserve_tags:
            b.bam_tags = tags
        yield b


# ------------------------------------------------------------- BAM output -

def _bgzf_compress(data: bytes) -> bytes:
    """One BGZF block wrapping `data` (<= 64 KB)."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    cd = c.compress(data) + c.flush()
    bsize = len(cd) + 25
    out = struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
    out += struct.pack("<BBHH", 66, 67, 2, bsize)
    out += cd + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return out


_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_CIGAR_OPS = "MIDNSHP=X"


def _reg2bin(beg: int, end: int) -> int:
    """SAM-spec distance-binning (used for the BAM `bin` field)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamWriter:
    """Native BAM output (the role the reference wrapper delegates to
    `samtools view -b`, bowtie2-server:495-505 — kept in-process here).
    Feed SAM text: the header first, then one record line at a time."""

    def __init__(self, fh, header_text: str, ref_names, ref_lens):
        self._fh = fh
        self._refs = {n: i for i, n in enumerate(ref_names)}
        hdr = b"BAM\x01" + struct.pack("<i", len(header_text)) \
            + header_text.encode()
        hdr += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lens):
            nb = str(n).encode() + b"\0"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
        self._buf = bytearray()
        self._emit(hdr)

    def _emit(self, data: bytes):
        self._buf += data
        while len(self._buf) >= 60000:
            self._fh.write(_bgzf_compress(bytes(self._buf[:60000])))
            del self._buf[:60000]

    def write_sam_line(self, line: str):
        f = line.rstrip("\n").split("\t")
        name, flag, rname, pos, mapq, cigar = (
            f[0], int(f[1]), f[2], int(f[3]), int(f[4]), f[5])
        rnext, pnext, tlen, seq, qual = f[6], int(f[7]), int(f[8]), f[9], \
            f[10]
        refid = self._refs.get(rname, -1)
        nrefid = (refid if rnext == "=" else self._refs.get(rnext, -1))
        cig = []
        if cigar != "*":
            num = ""
            for ch in cigar:
                if ch.isdigit():
                    num += ch
                else:
                    cig.append((int(num) << 4) | _CIGAR_OPS.index(ch))
                    num = ""
        ref_span = sum(c >> 4 for c in cig
                       if _CIGAR_OPS[c & 0xF] in "MDN=X") or 1
        nb = name.encode() + b"\0"
        rec = struct.pack(
            "<iiBBHHHiiii", refid, pos - 1, len(nb), mapq,
            _reg2bin(max(pos - 1, 0), max(pos - 1, 0) + ref_span),
            len(cig), flag, 0 if seq == "*" else len(seq), nrefid,
            pnext - 1, tlen)
        rec += nb
        rec += b"".join(struct.pack("<I", c) for c in cig)
        if seq != "*":
            s4 = bytearray((len(seq) + 1) // 2)
            for i, ch in enumerate(seq):
                v = _C4.get(ch, 15)
                s4[i // 2] |= v << (4 if i % 2 == 0 else 0)
            rec += bytes(s4)
            rec += (bytes(255 for _ in seq) if qual == "*"
                    else bytes(min(ord(q) - 33, 93) for q in qual))
        for tag in f[11:]:
            t, typ, val = tag.split(":", 2)
            if typ == "i":
                rec += t.encode() + b"i" + struct.pack("<i", int(val))
            elif typ == "f":
                rec += t.encode() + b"f" + struct.pack("<f", float(val))
            elif typ == "A":
                rec += t.encode() + b"A" + val[:1].encode()
            else:  # Z (and anything else as string)
                rec += t.encode() + b"Z" + val.encode() + b"\0"
        self._emit(struct.pack("<i", len(rec)) + rec)

    def close(self):
        if self._buf:
            self._fh.write(_bgzf_compress(bytes(self._buf)))
            self._buf.clear()
        self._fh.write(_BGZF_EOF)
        self._fh.flush()
