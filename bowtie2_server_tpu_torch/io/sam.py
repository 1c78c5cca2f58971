"""SAM output (ref: sam.cpp:54-120 header, :121-681 printAlignedOptFlags).

Field order of optional tags matches the reference's emission order for
unpaired records: AS, (XS), XN, XM, XO, XG, NM, (YF), MD, YT.
"""
from __future__ import annotations

import re

from ..align.pipeline import AlnRec

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")
_MD_RE = re.compile(r"(\d+)|\^([A-Z]+)|([A-Z])")


def cigar_xeq(cigar: str, md: str) -> str:
    """Rewrite M runs as =/X runs using the MD tag (--xeq; ref:
    bt2_search.cpp:1133 ARG_XEQ — the reference emits =/X directly from
    the stacked alignment; splitting M by MD is equivalent)."""
    if cigar == "*" or "M" not in cigar:
        return cigar
    toks = []          # (kind, n): kind '=' match run, 'X' mismatch
    for num, dele, mm in _MD_RE.findall(md):
        if num:
            if int(num):
                toks.append(["=", int(num)])
        elif dele:
            toks.append(["D", len(dele)])
        else:
            toks.append(["X", 1])
    toks.reverse()     # consume from the end via pop()
    out: list[list] = []

    def emit(op, n):
        if n <= 0:
            return
        if out and out[-1][1] == op:
            out[-1][0] += n
        else:
            out.append([n, op])

    for num, op in _CIG_RE.findall(cigar):
        n = int(num)
        if op != "M":
            emit(op, n)
            if op == "D" and toks and toks[-1][0] == "D":
                toks.pop()
            continue
        while n > 0:
            if not toks:           # malformed MD: keep remainder as '='
                emit("=", n)
                break
            kind, k = toks[-1]
            if kind == "D":        # MD deletion mid-M shouldn't happen
                toks.pop()
                continue
            take = min(n, k)
            emit(kind, take)
            n -= take
            if take == k:
                toks.pop()
            else:
                toks[-1][1] = k - take
    return "".join(f"{n}{op}" for n, op in out)


def escape_newlines(s: bytes) -> str:
    """%-escape newline/CR/percent (ref: sam.h:286
    printOptFieldNewlineEscapedZ), for the --passthrough line."""
    out = []
    for ch in s:
        if ch in (10, 13, 0x25):
            out.append("%%%02X" % ch)
        else:
            out.append(chr(ch))
    return "".join(out)


def _is_illumina(comment: bytes) -> bool:
    """Illumina CASAVA comment shape 'N:[NY]:even:...' (ref: sam.h:429)."""
    fields = comment.split(b" ")[0].split(b":")
    if len(fields) < 4:
        return False
    try:
        if int(fields[0]) not in (1, 2):
            return False
        if fields[1] not in (b"N", b"Y"):
            return False
        if int(fields[2]) % 2 != 0:
            return False
    except ValueError:
        return False
    return True


def passthrough_line(rec: AlnRec) -> str:
    """The --passthrough extra line: the original read record with
    newlines %-escaped (ref: aln_sink.cpp:2144)."""
    orig = rec.orig_rec
    if orig is None:
        q = rec.orig_qual or b"I" * len(rec.orig_seq)
        name = rec.name.encode() if isinstance(rec.name, str) else rec.name
        orig = b"@" + name + b"\n" + rec.orig_seq + b"\n+\n" + q
    return escape_newlines(orig)


def comment_field(rec: AlnRec) -> str:
    """--sam-append-comment: '\\t' + comment, prefixed BC:Z: when it looks
    like an Illumina CASAVA field (ref: sam.h:415 printComment)."""
    c = rec.comment or b""
    if c and _is_illumina(c):
        return "\tBC:Z:" + c.decode()
    return "\t" + c.decode()

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_MATE1 = 0x40
FLAG_MATE2 = 0x80
FLAG_SECONDARY = 0x100


def parse_sam_opt_config(arg: str) -> dict:
    """--sam-opt-config: comma-separated tag toggles, 'tag' enables and
    '-tag' disables (ref: bt2_search.cpp:1596, sam.h:162
    toggleOptFlagByName; like the reference, 'as' and 'yn' share one
    toggle)."""
    toggles: dict[str, bool] = {}
    for tok in arg.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        val = not tok.startswith("-")
        name = tok.lstrip("-")
        if name in ("as", "yn"):
            toggles["as"] = val
        else:
            toggles[name] = val
    return toggles


def sam_header(ref_names, ref_lens, program_args: str = "",
               version: str = "2.5.4-tpu", rg_id: str | None = None,
               rg_fields: list[str] | None = None,
               no_head: bool = False, no_sq: bool = False) -> str:
    """no_head/no_sq: --sam-no-head suppresses ALL header lines, --sam-no-sq
    only the @SQ lines (ref: bt2_search.cpp ARG_SAM_NOHEAD/ARG_SAM_NOSQ,
    sam.cpp:54-120 printHeader)."""
    if no_head:
        return ""
    lines = ["@HD\tVN:1.0\tSO:unsorted"]
    if not no_sq:
        for name, ln in zip(ref_names, ref_lens):
            lines.append(f"@SQ\tSN:{name}\tLN:{int(ln)}")
    if rg_id:
        rg = f"@RG\tID:{rg_id}"
        for f in rg_fields or []:
            rg += "\t" + f
        lines.append(rg)
    lines.append(
        f"@PG\tID:bowtie2\tPN:bowtie2\tVN:{version}\tCL:\"{program_args}\"")
    return "\n".join(lines) + "\n"


def _flags(rec: AlnRec) -> int:
    f = 0
    if rec.paired:
        f |= FLAG_PAIRED | (FLAG_MATE1 if rec.mate1 else FLAG_MATE2)
        if rec.proper:
            f |= FLAG_PROPER
        if not rec.mate_aligned:
            f |= FLAG_MATE_UNMAPPED
        elif not rec.mate_fw:
            f |= FLAG_MATE_REVERSE
    if not rec.aligned:
        f |= FLAG_UNMAPPED
    else:
        if not rec.fw:
            f |= FLAG_REVERSE
        if rec.secondary:
            f |= FLAG_SECONDARY
    return f


def sam_record(rec: AlnRec, ref_names, rg_id: str | None = None,
               xeq: bool = False, append_comment: bool = False,
               show_rand_seed: bool = False, omit_sec_seq: bool = False,
               opt_flags: dict | None = None) -> str:
    line = _sam_record_core(rec, ref_names, rg_id, xeq, omit_sec_seq,
                            opt_flags)
    if show_rand_seed:
        # ZS:i: per-read pseudo-random seed (ref: --show-rand-seed,
        # bt2_search.cpp:1345 sam_print_zs)
        from ..utils import dna as _dna
        from ..utils.rng import gen_rand_seed
        import numpy as np
        codes = np.minimum(_dna.encode(rec.orig_seq), 4)
        q = np.frombuffer(rec.orig_qual or b"I" * len(rec.orig_seq),
                          np.uint8)
        name = rec.name.encode() if isinstance(rec.name, str) else rec.name
        line += f"\tZS:i:{gen_rand_seed(codes, q, name)}"
    if rec.preserved:
        # BAM input tags pass through verbatim, after generated flags and
        # before the comment (ref: aln_sink.cpp:2139 order)
        line += "\t" + rec.preserved
    if append_comment:
        line += comment_field(rec)
    return line


def _sam_record_core(rec: AlnRec, ref_names, rg_id: str | None = None,
                     xeq: bool = False, omit_sec_seq: bool = False,
                     opt_flags: dict | None = None) -> str:
    seq = rec.seq.decode() if isinstance(rec.seq, bytes) else rec.seq
    qual = rec.qual.decode() if isinstance(rec.qual, bytes) else rec.qual
    if omit_sec_seq and rec.secondary and rec.aligned:
        # --omit-sec-seq: secondary records print * for SEQ/QUAL
        # (ref: sam.cpp omit_sec_seq_, bt2_search.cpp:714)
        seq, qual = "*", "*"
    if not qual:
        qual = "*"
    on = (lambda t: opt_flags.get(t, True)) if opt_flags else \
        (lambda t: True)
    flag = _flags(rec)
    if not rec.aligned:
        # unaligned with an aligned mate: inherit the mate's RNAME/POS
        # (ref: sam.cpp printEmptyOptFlags placement rules)
        if rec.paired and rec.mate_aligned and rec.mate_ref_id >= 0:
            rname = ref_names[rec.mate_ref_id]
            pos = str(rec.mate_pos + 1)
            rnext, pnext = "=", str(rec.mate_pos + 1)
        else:
            rname, pos, rnext, pnext = "*", "0", "*", "0"
        # YT precedes YF (ref: sam.cpp:318-335 printYT then printYF)
        tags = []
        if on("yt"):
            tags.append(f"YT:Z:{rec.yt}")
        if rec.filtered and on("yf"):
            tags.append(f"YF:Z:{rec.yf}")
        if rg_id:
            tags.append(f"RG:Z:{rg_id}")
        return "\t".join([
            rec.name, str(flag), rname, pos, "0", "*", rnext, pnext, "0",
            seq, qual] + tags)
    if rec.paired and rec.mate_aligned and rec.mate_ref_id >= 0:
        rnext = "=" if rec.mate_ref_id == rec.ref_id else \
            ref_names[rec.mate_ref_id]
        pnext = str(rec.mate_pos + 1)
        tlen = str(rec.tlen)
    elif rec.paired:
        rnext, pnext, tlen = "=", str(rec.pos + 1), "0"
    else:
        rnext, pnext, tlen = "*", "0", "0"
    tags = [f"AS:i:{rec.score}"] if on("as") else []
    if rec.secbest is not None and on("xs"):
        tags.append(f"XS:i:{rec.secbest}")
    for t, v in (("xn", rec.xn), ("xm", rec.xm), ("xo", rec.xo),
                 ("xg", rec.xg), ("nm", rec.nm)):
        if on(t):
            tags.append(f"{t.upper()}:i:{v}")
    if on("md"):
        tags.append(f"MD:Z:{rec.md}")
    if rec.paired and rec.ys is not None and on("ys"):
        tags.append(f"YS:i:{rec.ys}")
    if on("yt"):
        tags.append(f"YT:Z:{rec.yt}")
    if rg_id:
        tags.append(f"RG:Z:{rg_id}")
    cig = cigar_xeq(rec.cigar, rec.md) if xeq else rec.cigar
    return "\t".join([
        rec.name, str(flag), ref_names[rec.ref_id], str(rec.pos + 1),
        str(rec.mapq), cig, rnext, pnext, tlen, seq, qual] + tags)


def sam_format_batch_native(recs, ref_names, rg_id=None, no_unal=False):
    """Whole-batch SAM bytes via the native emitter (native/samfmt.cpp);
    None when unavailable — callers fall back to per-record sam_record."""
    from ..native import sam_format_batch
    return sam_format_batch(recs, ref_names, rg_id=rg_id, no_unal=no_unal)
