"""Read input parsing (ref: pat.h:1030 FastqPatternSource and friends).

The reference light-parses batches on a reader thread, then finalizes
per-worker. Here the host parses into flat numpy batches ready for device
upload: code matrix [B, Lmax], quality matrix, lengths, names.
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils import dna


@dataclass
class ReadBatch:
    names: list[str]
    seqs: np.ndarray    # [B, Lmax] uint8 codes, pad=5
    quals: np.ndarray   # [B, Lmax] int32 phred, pad=0
    lens: np.ndarray    # [B] int32
    raw_seq: list[bytes]   # original ASCII sequences (for SAM SEQ column)
    raw_qual: list[bytes]  # original ASCII qualities
    # FASTQ comments (text after the first whitespace in the header) for
    # --sam-append-comment, and original record text (readOrigBuf analog,
    # ref: read.h:311) for --passthrough; None unless the reader kept them
    comments: list[bytes] | None = None
    origs: list[bytes] | None = None
    # Qseq filter flags ('0' = failed QC; ref: read_qseq.cpp:217)
    qc_fail: np.ndarray | None = None
    # decoded SAM-text tag strings per read for BAM --preserve-tags
    # (ref: sam.cpp:881 printPreservedOptFlags)
    bam_tags: list[str] | None = None

    def __len__(self):
        return len(self.names)

    def slice(self, lo: int, hi: int) -> "ReadBatch":
        """Row-range view (capacity-degradation batch splitting)."""
        return ReadBatch(
            names=self.names[lo:hi], seqs=self.seqs[lo:hi],
            quals=self.quals[lo:hi], lens=self.lens[lo:hi],
            raw_seq=self.raw_seq[lo:hi], raw_qual=self.raw_qual[lo:hi],
            comments=self.comments[lo:hi] if self.comments else None,
            origs=self.origs[lo:hi] if self.origs else None,
            qc_fail=self.qc_fail[lo:hi] if self.qc_fail is not None
            else None,
            bam_tags=self.bam_tags[lo:hi] if self.bam_tags else None)


# Solexa(log-odds)->Phred table for --solexa-quals (ref: qual.cpp:57
# solToPhred; derived here as round(10*log10(1+10^(sol/10))) which
# reproduces the reference table exactly over its domain [-10, 255]).
_SOL_TO_PHRED = np.round(
    10.0 * np.log10(1.0 + 10.0 ** (np.arange(-10, 256) / 10.0))
).astype(np.int32)


def make_qual_conv(phred64: bool = False, solexa: bool = False,
                   int_quals: bool = False):
    """bytes->bytes quality converter to Phred+33 ASCII (ref: qual.h:105
    charToPhred33, :156 intToPhred33). Conversion happens at parse time so
    SAM QUAL output and the device quality matrix both see Phred+33.
    Returns None for the identity (plain Phred+33) case."""
    if int_quals:
        def conv(q: bytes) -> bytes:
            if not q:
                return q
            vals = [int(t) for t in q.split()]
            if solexa:
                vals = [int(_SOL_TO_PHRED[min(max(v, -10), 255) + 10])
                        for v in vals]
            return bytes(min(v, 93) + 33 for v in vals)
        return conv
    if solexa:
        def conv(q: bytes) -> bytes:
            return bytes(int(_SOL_TO_PHRED[min(max(c - 64, -10), 255) + 10])
                         + 33 for c in q)
        return conv
    if phred64:
        def conv(q: bytes) -> bytes:
            return bytes(max(c - 31, 33) for c in q)
        return conv
    return None


def _open_maybe_compressed(path):
    """Auto-detect gzip/zstd/bz2 by magic bytes (ref: pat.h:510-548 gzip
    and zstd auto-detection)."""
    p = str(path)
    f = open(p, "rb")
    magic = f.read(4)
    f.seek(0)
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(f)
    if magic == b"\x28\xb5\x2f\xfd":
        import io as _io

        import zstandard
        return _io.BufferedReader(
            zstandard.ZstdDecompressor().stream_reader(f))
    if magic[:3] == b"BZh":
        import bz2
        return bz2.open(f)
    return f


def _apply_trim_to(seq, qual, trim_to):
    """--trim-to [3:|5:]N — trim reads LONGER than N down to N bases from
    the given end (ref: pat.h:1489-1503; default end is 3')."""
    side, n = trim_to
    if len(seq) > n:
        if side == 5:
            seq = seq[len(seq) - n:]
            qual = qual[len(qual) - n:] if qual else qual
        else:
            seq = seq[:n]
            qual = qual[:n] if qual else qual
    return seq, qual


def iter_fastq(path_or_handle, batch_size: int = 4096, max_len: int = 100_000,
               trim5: int = 0, trim3: int = 0, skip: int = 0,
               upto: int | None = None, keep_comment: bool = False,
               keep_orig: bool = False, qname_trunc: bool = True,
               qual_conv=None, trim_to=None):
    """Yield ReadBatch objects from a FASTQ file (optionally gzipped).
    trim5/trim3: -5/-3 base trimming; skip/upto: -s/-u read windowing
    (ref: bt2_search.cpp gTrim5/gTrim3, skipReads/qUpto).
    keep_comment: retain header comments (--sam-append-comment);
    keep_orig: retain untrimmed record text (--passthrough, readOrigBuf);
    qname_trunc=False: keep the whole header as the name
    (--sam-no-qname-trunc, ref: bt2_search.cpp samTruncQname)."""
    if hasattr(path_or_handle, "read"):
        f = path_or_handle
        close = False
    else:
        f = _open_maybe_compressed(path_or_handle)
        close = True
    try:
        names, seqs, quals = [], [], []
        comments = [] if keep_comment else None
        origs = [] if keep_orig else None
        n_seen = 0
        while True:
            h = f.readline()
            if not h:
                break
            if isinstance(h, str):
                h = h.encode()
            h = h.strip()
            if not h:
                continue
            seq = f.readline().strip()
            plus = f.readline()
            qual = f.readline().strip()
            if isinstance(seq, str):
                seq, qual = seq.encode(), qual.encode()
            n_seen += 1
            if n_seen <= skip:
                continue
            if upto is not None and n_seen > skip + upto:
                break
            if keep_orig:
                pl = plus.strip()
                if isinstance(pl, str):
                    pl = pl.encode()
                origs.append(h + b"\n" + seq + b"\n" + pl + b"\n" + qual)
            if qual_conv is not None:
                qual = qual_conv(qual)
            if trim5 or trim3:
                end = len(seq) - trim3
                seq = seq[trim5:end]
                qual = qual[trim5:end] if qual else qual
            if trim_to is not None:
                seq, qual = _apply_trim_to(seq, qual, trim_to)
            hdr = h[1:] if h.startswith(b"@") else h
            if qname_trunc:
                name = hdr.split()[0].decode()
            else:
                name = hdr.decode()
            if keep_comment:
                parts = hdr.split(None, 1)
                comments.append(parts[1] if len(parts) > 1 else b"")
            names.append(name)
            seqs.append(seq[:max_len])
            quals.append(qual[:max_len])
            if len(names) >= batch_size:
                yield make_batch(names, seqs, quals, comments, origs)
                names, seqs, quals = [], [], []
                comments = [] if keep_comment else None
                origs = [] if keep_orig else None
        if names:
            yield make_batch(names, seqs, quals, comments, origs)
    finally:
        if close:
            f.close()


def subset_batch(b: ReadBatch, idx) -> ReadBatch:
    """Row-subset of a batch (--sample filtering; keeps all side arrays)."""
    idx = np.asarray(idx, np.int64)
    take = lambda lst: [lst[i] for i in idx]
    nb = ReadBatch(
        names=take(b.names), seqs=b.seqs[idx], quals=b.quals[idx],
        lens=b.lens[idx], raw_seq=take(b.raw_seq), raw_qual=take(b.raw_qual),
        comments=take(b.comments) if b.comments is not None else None,
        origs=take(b.origs) if b.origs is not None else None,
        qc_fail=b.qc_fail[idx] if b.qc_fail is not None else None)
    return nb


def make_batch(names, seqs, quals, comments=None, origs=None) -> ReadBatch:
    B = len(names)
    lmax = max((len(s) for s in seqs), default=1)
    lmax = max(lmax, 1)
    mat = np.full((B, lmax), 5, dtype=np.uint8)
    qmat = np.zeros((B, lmax), dtype=np.int32)
    lens = np.zeros(B, dtype=np.int32)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        codes = dna.encode(s)
        mat[i, : len(codes)] = codes
        if len(q) == len(s):
            qmat[i, : len(codes)] = dna.phred33(q)
        else:  # missing/malformed quals -> high quality
            qmat[i, : len(codes)] = 40
        lens[i] = len(codes)
    return ReadBatch(names=names, seqs=mat, quals=qmat, lens=lens,
                     raw_seq=list(seqs), raw_qual=list(quals),
                     comments=comments, origs=origs)


def iter_tab6(lines_iter, batch_size: int = 4096,
              qual_conv=None):
    """Parse tab6/tab5 lines: name\tseq\tqual[\tname2\tseq2\tqual2]
    (ref: pat.h:843 TabbedPatternSource). Yields (batch1, batch2|None)."""
    n1, s1, q1 = [], [], []
    n2, s2, q2 = [], [], []
    paired = False
    for line in lines_iter:
        if isinstance(line, str):
            line = line.encode()
        line = line.rstrip(b"\r\n")
        if not line:
            continue
        parts = line.split(b"\t")
        if qual_conv is not None:
            qis = (2, 4) if len(parts) == 5 else (2, 5)
            for qi in qis:
                if len(parts) > qi:
                    parts[qi] = qual_conv(parts[qi])
        n1.append(parts[0].decode())
        s1.append(parts[1])
        q1.append(parts[2] if len(parts) > 2 else b"")
        if len(parts) == 5:
            # tab5: name\tseq1\tqual1\tseq2\tqual2 — shared name
            # (ref: pat.h:843 TabbedPatternSource, secondName_ = false)
            paired = True
            n2.append(parts[0].decode())
            s2.append(parts[3])
            q2.append(parts[4])
        elif len(parts) >= 6:
            paired = True
            n2.append(parts[3].decode())
            s2.append(parts[4])
            q2.append(parts[5])
        if len(n1) >= batch_size:
            yield (make_batch(n1, s1, q1),
                   make_batch(n2, s2, q2) if paired else None)
            n1, s1, q1, n2, s2, q2 = [], [], [], [], [], []
            paired = False
    if n1:
        yield (make_batch(n1, s1, q1),
               make_batch(n2, s2, q2) if paired else None)


def iter_fasta_reads(path, batch_size: int = 4096, trim5=0, trim3=0,
                     skip=0, upto=None, trim_to=None):
    """FASTA read input (-f; ref: pat.h:778 FastaPatternSource)."""
    f = _open_maybe_compressed(path)
    names, seqs, quals = [], [], []
    name, parts, n_seen = None, [], 0

    def flush_read():
        nonlocal n_seen
        if name is None:
            return False
        n_seen += 1
        if n_seen <= skip or (upto is not None and n_seen > skip + upto):
            return False
        seq = b"".join(parts)
        end = len(seq) - trim3
        seq = seq[trim5:end]
        if trim_to is not None:
            seq, _ = _apply_trim_to(seq, b"", trim_to)
        names.append(name)
        seqs.append(seq)
        quals.append(b"I" * len(seq))
        return True

    out = []
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                flush_read()
                if len(names) >= batch_size:
                    out.append(make_batch(names, seqs, quals))
                    names, seqs, quals = [], [], []
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line)
        flush_read()
    if names:
        out.append(make_batch(names, seqs, quals))
    yield from out


def iter_qseq(path, batch_size: int = 4096, trim5=0, trim3=0, skip=0,
              upto=None, phred64: bool = False, trim_to=None):
    """Illumina Qseq input (--qseq; ref: read_qseq.cpp:52 QseqPatternSource).

    11 tab fields: machine, run, lane, tile, x, y, index, mate, seq, quals,
    filter. Name = first 7 fields '_'-joined + '/' + mate; '.' bases are N;
    the filter flag ('0' = failed QC) rides on the batch as `qc_fail` for
    --qc-filter (ref: read.h filter, bt2_search.cpp qcFilter)."""
    f = _open_maybe_compressed(path)
    names, seqs, quals, qc = [], [], [], []
    n_seen = 0
    with f:
        for line in f:
            if isinstance(line, str):
                line = line.encode()
            line = line.rstrip(b"\r\n")
            if not line:
                continue
            fields = line.split(b"\t")
            if len(fields) < 11:
                raise ValueError(f"qseq line has {len(fields)} fields, "
                                 "expected 11")
            n_seen += 1
            if n_seen <= skip:
                continue
            if upto is not None and n_seen > skip + upto:
                break
            name = b"_".join(fields[:7]).decode() + "/" + fields[7].decode()
            seq = fields[8].replace(b".", b"N")
            qual = fields[9]
            if phred64:
                qual = bytes(max(33, q - 31) for q in qual)
            end = len(seq) - trim3
            seq, qual = seq[trim5:end], qual[trim5:end]
            if trim_to is not None:
                seq, qual = _apply_trim_to(seq, qual, trim_to)
            filt = fields[10][:1]
            if filt not in (b"0", b"1"):
                raise ValueError(f"bad qseq filter flag {filt!r}")
            names.append(name)
            seqs.append(seq)
            quals.append(qual)
            qc.append(filt == b"0")
            if len(names) >= batch_size:
                b = make_batch(names, seqs, quals)
                b.qc_fail = np.array(qc, bool)
                yield b
                names, seqs, quals, qc = [], [], [], []
    if names:
        b = make_batch(names, seqs, quals)
        b.qc_fail = np.array(qc, bool)
        yield b


def iter_fasta_continuous(path, length: int, freq: int = 1,
                          batch_size: int = 4096):
    """FASTA-continuous input (-F k:<len>,i:<ivl>; ref: pat.h:956
    FastaContinuousPatternSource): cut every reference sequence into
    length-k windows every `freq` bases, named <seqname>_<offset>."""
    f = _open_maybe_compressed(path)
    names, seqs, quals = [], [], []

    def windows(name, seq):
        nonlocal names, seqs, quals
        out = []
        for off in range(0, max(len(seq) - length + 1, 0), freq):
            names.append(f"{name}_{off}")
            seqs.append(seq[off : off + length])
            quals.append(b"I" * length)
            if len(names) >= batch_size:
                out.append(make_batch(names, seqs, quals))
                names, seqs, quals = [], [], []
        return out

    cur_name, parts = None, []
    with f:
        for line in f:
            if isinstance(line, str):
                line = line.encode()
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if cur_name is not None:
                    yield from windows(cur_name, b"".join(parts))
                cur_name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line)
        if cur_name is not None:
            yield from windows(cur_name, b"".join(parts))
    if names:
        yield make_batch(names, seqs, quals)


def iter_raw_reads(path, batch_size: int = 4096, trim5=0, trim3=0,
                   trim_to=None, **kw):
    """Raw one-sequence-per-line input (-r; ref: pat.h:1186)."""
    f = _open_maybe_compressed(path)
    names, seqs, quals = [], [], []
    with f:
        for i, line in enumerate(f):
            seq = line.strip()
            if not seq:
                continue
            if trim5 or trim3:
                seq = seq[trim5 : len(seq) - trim3]
            if trim_to is not None:
                seq, _ = _apply_trim_to(seq, b"", trim_to)
            names.append(str(i))
            seqs.append(seq)
            quals.append(b"I" * len(seq))
            if len(names) >= batch_size:
                yield make_batch(names, seqs, quals)
                names, seqs, quals = [], [], []
    if names:
        yield make_batch(names, seqs, quals)


def iter_cmdline_reads(csv: str, batch_size: int = 4096, trim5=0, trim3=0,
                       trim_to=None, **kw):
    """Comma-separated reads given on the command line (-c; ref: pat.h:304)."""
    seqs = [s.strip().encode() for s in csv.split(",") if s.strip()]
    if trim5 or trim3:
        seqs = [s[trim5 : len(s) - trim3] for s in seqs]
    if trim_to is not None:
        seqs = [_apply_trim_to(s, b"", trim_to)[0] for s in seqs]
    names = [str(i) for i in range(len(seqs))]
    quals = [b"I" * len(s) for s in seqs]
    for i in range(0, len(seqs), batch_size):
        yield make_batch(names[i:i+batch_size], seqs[i:i+batch_size],
                         quals[i:i+batch_size])


def iter_tab_file(path, batch_size: int = 4096, qual_conv=None, **kw):
    """tab5/tab6 file input (--tab5/--tab6; ref: pat.h:843)."""
    f = _open_maybe_compressed(path)
    with f:
        yield from iter_tab6(f, batch_size=batch_size, qual_conv=qual_conv)


def iter_interleaved(path, batch_size: int = 4096, qual_conv=None, **kw):
    """Interleaved paired FASTQ (--interleaved; ref: pat.cpp composer).
    Yields (batch1, batch2) pairs."""
    n1, s1, q1, n2, s2, q2 = [], [], [], [], [], []
    f = _open_maybe_compressed(path)
    with f:
        rec = []
        which = 0
        while True:
            h = f.readline()
            if not h:
                break
            h = h.strip()
            if not h:
                continue
            seq = f.readline().strip()
            f.readline()
            qual = f.readline().strip()
            if qual_conv is not None:
                qual = qual_conv(qual)
            name = h[1:].split()[0].decode()
            if name.endswith("/1") or name.endswith("/2"):
                name = name[:-2]
            if which == 0:
                n1.append(name); s1.append(seq); q1.append(qual)
                which = 1
            else:
                n2.append(name); s2.append(seq); q2.append(qual)
                which = 0
                if len(n2) >= batch_size:
                    yield (make_batch(n1, s1, q1), make_batch(n2, s2, q2))
                    n1, s1, q1, n2, s2, q2 = [], [], [], [], [], []
    if n2:
        yield (make_batch(n1[:len(n2)], s1[:len(n2)], q1[:len(n2)]),
               make_batch(n2, s2, q2))


def prefetch(iterator, depth: int = 2):
    """Background read-ahead: parse upcoming batches on a thread while the
    device aligns the current one (ref: pat.h:1558
    PatternSourceReadAheadFactory's dedicated reader thread)."""
    import queue
    import threading
    q = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item
