"""The plain reference that decides `correct`. NumPy only: it imports
neither JAX nor any module of the program, and takes nothing the program
made. It reads the configuration, the genome (made by genome.py from the
configuration) and, for each sampled read, the read as sent, its truth and
the SAM records the client received over the socket; it judges each
record by what it says.

An aligner's search is a heuristic (seeds, extension limits), so no plain
program can say which alignment bowtie2's search reports. The reference
holds each answer to what the configuration guarantees instead:

* fields: from a record's placement (sequence, position, strand, CIGAR)
  it works out, against the genome and under the configuration's
  scoring, every other field: FLAG, MAPQ (V2, from AS and XS), RNEXT,
  PNEXT, TLEN, SEQ, QUAL, AS, XN, XM, XO, XG, NM, MD and YT, and that the
  placement is an end-to-end alignment of the whole read inside its
  sequence with no gap within `gbar` bases of either end, and XS no
  better than AS and no worse than the minimum score. A record that
  differs anywhere is a field fault.
* placement: a plain end-to-end dynamic program (affine gaps, the gap
  barrier, free ends in the reference) finds the best score a read can
  have at its true origin. A read whose reported score is below that
  best, or that is reported unaligned while that best is a valid score,
  was placed worse than its origin allows.
* repeats (MAPQ): a read cut from inside a planted repeat copy also
  aligns at the same place of the family's other copies (genome.py knows
  them). Where the best of those, without gaps, scores validly, the read
  has a second alignment: its record must carry XS no lower than the
  second best of the read's scores over all the copies (its origin's best
  and the others' ungapped bests), and its MAPQ follows from AS and XS.
* the server: every read is answered exactly once, its records then its
  END READ marker, and each connection ends with All Done (counted by the
  wire client as it receives them).

The numbers compared, each with its limit in
portbench/limits/<cell>.json: `unanswered` (reads not answered exactly
once, and responses without All Done; limit 0), `field_faults` (records;
limit 0), `below_pct` (of the judged reads, those whose best at their
origin is a valid score, the share placed below that best or left
unaligned), `gapped_below_pct` (the same share among the judged reads
whose best needs a gap) and `repeat_xs_pct` (of the judged repeat reads
that have a second alignment and were aligned, the share whose XS is
missing or below it). The three shares' limits lie between the program's
readings over many seeds and the control's.

The control (`control_records`): the reference itself in the program's
place, with one guarantee of the configuration broken: no gaps. Each read
is placed without gaps on its true origin's diagonal, with no XS (it looks
at no other copy), and its records are formatted by the same rules the
judge checks, so they pass every field check and fail where gaps were
owed and where a repeat read's second alignment was.
"""
from __future__ import annotations

import re

import numpy as np

from . import genome as gmod

NEG = -(1 << 28)
BASES = "ACGT"
_CIG = re.compile(r"(\d+)([MIDNSHP=X])")


class Scoring:
    """The configuration's end-to-end scoring (`guarantees.scoring`)."""

    def __init__(self, cfg: dict):
        s = cfg["guarantees"]["scoring"]
        if s["ma"] != 0 or cfg["guarantees"]["mode"] != "end-to-end":
            raise ValueError("the reference judges end-to-end scoring only")
        self.mx, self.mn = s["mp"]
        self.np = s["np"]
        self.rdg = s["rdg"]          # read gap (deletion): open, extend
        self.rfg = s["rfg"]          # reference gap (insertion)
        self.smin = s["score_min"]
        self.gbar = s["gbar"]

    def mm_pen(self, qual: bytes) -> np.ndarray:
        """Quality-aware mismatch penalties: MN + trunc(min(Q, 40) / 40 x
        (MX - MN)), in float32 as bowtie2 computes them."""
        q = np.minimum(np.frombuffer(qual, np.uint8).astype(np.int64) - 33, 40)
        frac = q.astype(np.float32) / np.float32(40.0)
        return self.mn + (frac * np.float32(self.mx - self.mn)).astype(np.int64)

    def min_score(self, L: int) -> int:
        """L,C,L score minimum, truncated toward zero, at most 0."""
        return min(int(self.smin[0] + self.smin[1] * L), 0)

    def gap(self, n: int, read_gap: bool) -> int:
        o, e = self.rdg if read_gap else self.rfg
        return o + e * n


def mapq_v2(best: int, sec: int | None, smin: int, sper: int = 0) -> int:
    """bowtie2's MAPQ V2 for end-to-end scores (unique.h BowtieMapq2): the
    best score over the minimum and, with a second best, their gap, as
    shares of the perfect-to-minimum range, with float32 thresholds."""
    diff = max(1, sper - smin)
    over = best - smin

    def ge(x, f):
        return x >= diff * float(np.float32(f))

    if sec is None:
        for f, q in ((0.8, 42), (0.7, 40), (0.6, 24), (0.5, 23), (0.4, 8),
                     (0.3, 3)):
            if ge(over, f):
                return q
        return 0
    bd = abs(abs(best) - abs(sec))
    full = over == diff
    for f, qf, qn in ((0.9, 39, 33), (0.8, 38, 27), (0.7, 37, 26),
                      (0.6, 36, 22)):
        if ge(bd, f):
            return qf if full else qn
    for f, qf, hi, lo, qa, qb, qc in (
            (0.5, 35, 0.84, 0.68, 25, 16, 5), (0.4, 34, 0.84, 0.68, 21, 14, 4),
            (0.3, 32, 0.88, 0.67, 18, 15, 3), (0.2, 31, 0.88, 0.67, 17, 11, 0),
            (0.1, 30, 0.88, 0.67, 12, 7, 0)):
        if ge(bd, f):
            if full:
                return qf
            return qa if ge(over, hi) else qb if ge(over, lo) else qc
    if bd > 0:
        return 6 if ge(over, 0.67) else 2
    return 1 if ge(over, 0.67) else 0


def revcomp(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


# ---------------------------------------------------------- best at origin -

def best_at_origin(sc: Scoring, gen: gmod.Genome, reads: list[bytes],
                   quals: list[bytes], truths: list[dict], pad: int = 24):
    """The best end-to-end score of each read around its true origin, in
    the orientation of its strand: all of the read aligned, free ends in
    the reference, affine gaps opened and extended at the configuration's
    costs, no gap opened or extended at a read position within gbar of
    either end; over the 2 pad + 32 diagonals from pad bases left of the
    origin's (room for 2 pad + 32 bases of indels, more than the minimum
    score allows a read of 100-150 bases). All reads have one length."""
    B = len(reads)
    if B == 0:
        return np.zeros(0, np.int64)
    rd, mm, ref = _windows(sc, gen, reads, quals, truths, pad)
    L = rd.shape[1]
    Kb = ref.shape[1] - L              # diagonals: 2 pad + 32
    ro, re_ = sc.rdg[0] + sc.rdg[1], sc.rdg[1]      # deletion
    fo, fe = sc.rfg[0] + sc.rfg[1], sc.rfg[1]      # insertion
    # band coordinates: cell (i, k) pairs read base i with window base
    # i + k; the diagonal step keeps k, an insertion comes from (i-1, k+1),
    # a deletion from (i, k-1)
    h_prev = np.zeros((B, Kb), np.int32)            # row -1: free start
    f_prev = np.full((B, Kb), NEG, np.int32)
    for i in range(L):
        band = ref[:, i : i + Kb]
        s = np.where(band == rd[:, i : i + 1], 0, -mm[:, i : i + 1])
        s = np.where(band == 9, NEG, s)
        diag = h_prev + s
        gap_ok = sc.gbar <= i < L - sc.gbar
        f = np.full((B, Kb), NEG, np.int32)
        if gap_ok:
            f[:, :-1] = np.maximum(h_prev[:, 1:] - fo, f_prev[:, 1:] - fe)
        base = np.maximum(diag, f)
        if gap_ok:
            e = np.full((B, Kb), NEG, np.int32)
            e[:, 1:] = base[:, :-1] - ro
            d = 1
            while d < Kb:
                e[:, d:] = np.maximum(e[:, d:], e[:, :-d] - d * re_)
                d *= 2
            h = np.maximum(base, e)
        else:
            h = base
        h_prev, f_prev = np.maximum(h, NEG), np.maximum(f, NEG)
    return h_prev.max(axis=1)


def _windows(sc, gen, reads, quals, truths, pad):
    """Read codes in reference orientation, mismatch penalties, and the
    reference window [start - pad, start + span + pad + 8) of each read
    (code 9 off its sequence)."""
    B, L = len(reads), len(reads[0])
    W = L + 2 * pad + 32
    rd = np.empty((B, L), np.int32)
    mm = np.empty((B, L), np.int32)
    ref = np.full((B, W), 9, np.int32)
    for b, (r, q, t) in enumerate(zip(reads, quals, truths)):
        if not t["fw"]:
            r, q = revcomp(r), q[::-1]
        rd[b] = np.frombuffer(r, np.uint8).astype(np.int64)
        mm[b] = sc.mm_pen(q)
        chrom = gen.chrom(t["chrom"])
        lo = t["start"] - pad
        a, z = max(lo, 0), min(lo + W, len(chrom))
        ref[b, a - lo : z - lo] = gmod.BASES[chrom[a:z]]
    return rd, mm, ref


def best_ungapped(sc: Scoring, gen: gmod.Genome, reads, quals, truths,
                  pad: int = 24, where: bool = False):
    """The best score of each read without gaps over the diagonals of the
    same window as best_at_origin; with `where`, also the window offset of
    the best diagonal (the one nearest the origin among equals)."""
    B = len(reads)
    if B == 0:
        return (np.zeros(0, np.int64),) * (2 if where else 1)
    rd, mm, ref = _windows(sc, gen, reads, quals, truths, pad)
    L, W = rd.shape[1], ref.shape[1]
    offs = np.arange(W - L + 1)
    score = np.zeros((B, len(offs)), np.int64)
    for i in range(L):
        col = ref[:, offs + i]
        pen = np.where(col == rd[:, i : i + 1], 0, -mm[:, i : i + 1])
        score += np.where(col == 9, NEG, pen)
    # among equal scores, the diagonal nearest the origin (offset pad)
    order = np.argsort(np.abs(offs - pad), kind="stable")
    k = order[np.argmax(score[:, order], axis=1)]
    best = score[np.arange(B), k]
    return (best, k) if where else best


# ------------------------------------------------------------------ fields -

class Placement:
    """An aligned record's placement, and what the genome says of it."""

    def __init__(self, chrom: int, pos0: int, fw: bool, cigar: str):
        self.chrom, self.pos0, self.fw, self.cigar = chrom, pos0, fw, cigar
        self.ops = [(int(n), op) for n, op in _CIG.findall(cigar)]
        self.span = sum(n for n, op in self.ops if op in "MD")


def alignment_fields(sc: Scoring, gen: gmod.Genome, pl: Placement,
                     read: bytes, qual: bytes):
    """(error or None, {AS, XN, XM, XO, XG, NM, MD}) of a placement of
    `read` (as sent) against the genome."""
    if "".join(op for _, op in pl.ops) == "" or \
            any(op not in "MID" for _, op in pl.ops) or \
            "".join(f"{n}{op}" for n, op in pl.ops) != pl.cigar:
        return f"CIGAR {pl.cigar} is not end-to-end M/I/D", None
    L = len(read)
    if sum(n for n, op in pl.ops if op in "MI") != L:
        return f"CIGAR {pl.cigar} does not cover the {L}-base read", None
    if pl.ops[0][1] != "M" or pl.ops[-1][1] != "M":
        return f"CIGAR {pl.cigar} starts or ends in a gap", None
    chrom = gen.chrom(pl.chrom)
    if pl.pos0 < 0 or pl.pos0 + pl.span > len(chrom):
        return "alignment runs off its sequence", None
    if not pl.fw:
        read, qual = revcomp(read), qual[::-1]
    pen = sc.mm_pen(qual)
    refs = BASES_ARR[chrom[pl.pos0 : pl.pos0 + pl.span]]
    score, xm, xo, xg, ri, fi = 0, 0, 0, 0, 0, 0
    md, run = [], 0
    for n, op in pl.ops:
        if op == "M":
            for _ in range(n):
                if read[ri] != refs[fi]:
                    score -= int(pen[ri])
                    xm += 1
                    md.append(str(run))
                    md.append(chr(refs[fi]))
                    run = 0
                else:
                    run += 1
                ri += 1
                fi += 1
        else:
            # the gap lies after read base ri - 1 (D) or covers read bases
            # ri..ri+n-1 (I); bowtie2 bars both within gbar of either end
            first, last = (ri - 1, ri - 1) if op == "D" else (ri, ri + n - 1)
            if first < sc.gbar or last >= L - sc.gbar:
                return f"gap in CIGAR {pl.cigar} within gbar of an end", None
            score -= sc.gap(n, read_gap=(op == "D"))
            xo += 1
            xg += n
            if op == "I":
                ri += n
            else:
                md.append(str(run))
                md.append("^" + bytes(refs[fi : fi + n]).decode())
                run = 0
                fi += n
    md.append(str(run))
    return None, {"AS": score, "XN": 0, "XM": xm, "XO": xo, "XG": xg,
                  "NM": xm + xg, "MD": "".join(md)}


BASES_ARR = np.frombuffer(b"ACGT", np.uint8)


def _int(s: str):
    try:
        return int(s)
    except ValueError:
        return None


def _tags(rec: list[str]) -> dict:
    out = {}
    for t in rec[11:]:
        k, typ, v = t.split(":", 2)
        out[k] = int(v) if typ == "i" else v
    return out


class Judge:
    """Judges the sampled answers of one run (see the module doc)."""

    def __init__(self, cfg: dict, gen: gmod.Genome):
        if cfg["reads"]["paired"]:
            raise ValueError("the reference judges unpaired reads only")
        self.cfg, self.gen, self.sc = cfg, gen, Scoring(cfg)
        self.names = gen.names
        self.chrom_of = {n: k for k, n in enumerate(gen.names)}
        self.faults: list[str] = []

    # ---- one record ----

    def _placement(self, rec):
        flag = int(rec[1])
        if flag & 4:
            return None
        return Placement(self.chrom_of.get(rec[2], -1), int(rec[3]) - 1,
                         not flag & 16, rec[5])

    def _expect_aligned(self, pl, read, qual, xs):
        """The fields 5-, 9-10 and tags an aligned record must carry
        (RNEXT/PNEXT/TLEN and pair tags filled by the caller)."""
        err, f = alignment_fields(self.sc, self.gen, pl, read, qual)
        if err:
            return err, None
        smin = self.sc.min_score(len(read))
        if f["AS"] < smin:
            return f"AS {f['AS']} below the minimum {smin}", None
        if xs is not None and not smin <= xs <= f["AS"]:
            return f"XS {xs} outside [{smin}, AS {f['AS']}]", None
        f["XS"] = xs
        seq = read if pl.fw else revcomp(read)
        q = qual if pl.fw else qual[::-1]
        f["SEQ"], f["QUAL"] = seq.decode(), q.decode()
        return None, f

    def _check(self, rec, want: list[str], what: str) -> bool:
        if rec[1:] != want[1:]:
            diff = [f"{k}: {a!r} != {b!r}" for k, a, b in
                    zip(range(len(want)), rec, want) if a != b]
            if len(rec) != len(want):
                diff.append(f"{len(rec)} fields, expected {len(want)}")
            self.faults.append(f"{what}: {'; '.join(diff[:4])}")
            return False
        return True

    def unpaired(self, key, recs, read, qual):
        """(fields all right, reported AS and XS: None when unaligned or
        not reported)."""
        if len(recs) != 1:
            self.faults.append(f"read {key}: {len(recs)} records")
            return False, None, None
        rec = recs[0].split("\t")
        if len(rec) < 11:
            self.faults.append(f"read {key}: {len(rec)} fields")
            return False, None, None
        pl = self._placement(rec)
        qs = qual.decode()
        if pl is None:
            want = [rec[0], "4", "*", "0", "0", "*", "*", "0", "0",
                    read.decode(), qs, "YT:Z:UU"]
            return self._check(rec, want, f"read {key}"), None, None
        tags = _tags(rec) if len(rec) > 11 else {}
        err, f = self._expect_aligned(pl, read, qual, tags.get("XS"))
        if err:
            self.faults.append(f"read {key}: {err}")
            return False, None, None
        smin = self.sc.min_score(len(read))
        want = [rec[0], str(0 if pl.fw else 16), rec[2], rec[3],
                str(mapq_v2(f["AS"], f["XS"], smin)), pl.cigar, "*", "0",
                "0", f["SEQ"], f["QUAL"]] + self._tag_list(f) + ["YT:Z:UU"]
        return self._check(rec, want, f"read {key}"), f["AS"], f["XS"]

    def _tag_list(self, f) -> list[str]:
        out = [f"AS:i:{f['AS']}"]
        if f["XS"] is not None:
            out.append(f"XS:i:{f['XS']}")
        out += [f"XN:i:{f['XN']}", f"XM:i:{f['XM']}", f"XO:i:{f['XO']}",
                f"XG:i:{f['XG']}", f"NM:i:{f['NM']}", f"MD:Z:{f['MD']}"]
        return out

    # ---- a run ----

    def judge(self, samples: list[dict]) -> dict:
        """samples: [{key, truth: [the read's truth], records: [lines] or
        None}]. Returns the counts: field_faults, missing (sampled reads
        never answered), judged (reads whose origin's best is a valid
        score), below (of them, placed below it or unaligned), unaligned,
        gapped and gapped_below (those whose best needs a gap), repeat and
        repeat_short (the repeat reads checked, and those whose XS is
        missing or below their second alignment)."""
        qchar = gmod.quality_char(self.cfg["reads"])
        reads, quals, truths, reported, xss = [], [], [], [], []
        faults = missing = 0
        for s in samples:
            t = s["truth"][0]
            rd = gmod.BASES[np.frombuffer(bytes.fromhex(t["codes"]),
                                          np.uint8)].tobytes()
            q = bytes([qchar]) * len(rd)
            if s["records"] is None:
                missing += 1
                continue
            try:
                ok, a, xs = self.unpaired(s["key"], s["records"], rd, q)
            except (ValueError, IndexError, KeyError) as e:
                self.faults.append(f"read {s['key']}: unreadable ({e!r})")
                ok, a, xs = False, None, None
            faults += not ok
            reads.append(rd)
            quals.append(q)
            truths.append(t)
            reported.append(a)
            xss.append(xs)
        best = best_at_origin(self.sc, self.gen, reads, quals, truths)
        ung = best_ungapped(self.sc, self.gen, reads, quals, truths)
        second = self.second_best(reads, quals, truths, best)
        out = {"field_faults": faults, "missing": missing,
               "judged": 0, "below": 0, "unaligned": 0, "gapped": 0,
               "gapped_below": 0, "repeat": 0, "repeat_short": 0}
        for k, (b, u, rep, rd) in enumerate(zip(best, ung, reported, reads)):
            smin = self.sc.min_score(len(rd))
            if b < smin:
                continue
            below = rep is None or rep < b
            out["judged"] += 1
            out["below"] += below
            out["unaligned"] += rep is None
            if b > u:                       # the best needs a gap
                out["gapped"] += 1
                out["gapped_below"] += below
            if second[k] is not None and second[k] >= smin \
                    and rep is not None:
                out["repeat"] += 1
                if xss[k] is None or xss[k] < second[k]:
                    out["repeat_short"] += 1
                    self.faults.append(
                        f"repeat read at {truths[k]['chrom']}:"
                        f"{truths[k]['start']}: AS {rep}, XS {xss[k]}, "
                        f"second alignment {second[k]}")
        out["faults"] = self.faults[:20]
        return out

    def second_best(self, reads, quals, truths, best):
        """For each read cut from inside a repeat copy, the second best of
        its scores over the family's copies: its origin's best and, at the
        same place of every other copy, the best ungapped score; None for
        the other reads."""
        rows, sib_truths = [], []
        for k, t in enumerate(truths):
            for s in self.siblings(t):
                rows.append(k)
                sib_truths.append(s)
        out = [None] * len(truths)
        if not rows:
            return out
        u = best_ungapped(self.sc, self.gen, [reads[k] for k in rows],
                          [quals[k] for k in rows], sib_truths)
        scores: dict[int, list[int]] = {}
        for k, v in zip(rows, u):
            scores.setdefault(k, [int(best[k])]).append(int(v))
        for k, v in scores.items():
            out[k] = sorted(v, reverse=True)[1]
        return out

    def siblings(self, t: dict) -> list[dict]:
        """Where a read of truth `t` lies inside a planted repeat copy, its
        truth moved to the same place of each other copy of the family (on
        the other strand where that copy is reversed against its own)."""
        lo, hi = t["start"], t["start"] + t["span"]
        for fam, chrom, cs, n, fwd in self.gen.copies:
            if chrom == t["chrom"] and cs <= lo and hi <= cs + n:
                break
        else:
            return []
        o = lo - cs
        out = []
        for fam2, chrom2, cs2, n2, fwd2 in self.gen.copies:
            if fam2 != fam or (chrom2, cs2) == (chrom, cs):
                continue
            if fwd2 == fwd:
                out.append(dict(t, chrom=chrom2, start=cs2 + o))
            else:
                out.append(dict(t, chrom=chrom2, start=cs2 + n - o - t["span"],
                                fw=not t["fw"]))
        return out


# ----------------------------------------------------------------- control -

def control_records(cfg: dict, gen: gmod.Genome, samples: list[dict]):
    """The samples with their records replaced by the control's: the
    reference aligner without gaps, each read placed on the best diagonal
    of its origin's window (best_ungapped), with no XS, unaligned where
    that scores below the minimum, formatted by the rules the judge holds
    records to."""
    sc = Scoring(cfg)
    judge = Judge(cfg, gen)
    qchar = gmod.quality_char(cfg["reads"])
    pad = 24
    truths = [s["truth"][0] for s in samples]
    reads = [gmod.BASES[np.frombuffer(bytes.fromhex(t["codes"]),
                                      np.uint8)].tobytes() for t in truths]
    quals = [bytes([qchar]) * len(r) for r in reads]
    _, where = best_ungapped(sc, gen, reads, quals, truths, pad, where=True)
    out = []
    for s, t, rd, q, k in zip(samples, truths, reads, quals, where):
        L = len(rd)
        pl = Placement(t["chrom"], t["start"] - pad + int(k), t["fw"], f"{L}M")
        err, f = alignment_fields(sc, gen, pl, rd, q)
        if err or f["AS"] < sc.min_score(L):
            rec = ["r", "4", "*", "0", "0", "*", "*", "0", "0", rd.decode(),
                   q.decode(), "YT:Z:UU"]
        else:
            f["XS"] = None
            seq = rd if pl.fw else revcomp(rd)
            qs = q if pl.fw else q[::-1]
            rec = (["r", str(0 if pl.fw else 16), gen.names[pl.chrom],
                    str(pl.pos0 + 1), str(mapq_v2(f["AS"], None,
                                                  sc.min_score(L))),
                    pl.cigar, "*", "0", "0", seq.decode(), qs.decode()]
                   + judge._tag_list(f) + ["YT:Z:UU"])
        out.append({"key": s["key"], "truth": s["truth"],
                    "records": ["\t".join(rec)]})
    return out
