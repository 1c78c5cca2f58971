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
* pairs (a configuration whose `reads.paired` is true): each mate's
  record is held to every check above. The pair's fields are worked out
  again from the two placements under the configuration's pair
  guarantees (`minins`, `maxins`, `orientation`, `mixed`, `discordant`;
  PairRules): FLAG 0x1, 0x2, 0x8, 0x20, 0x40 and 0x80, RNEXT, PNEXT,
  TLEN, YS and YT, and the MAPQ of a pair reported as one (V2 over the
  pair's summed scores, with the second-best concordant pair's sum where
  the pair lies in a repeat). A pair whose truth is concordant is held to
  being reported concordant at no less than its mates' bests summed.
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
missing or below it); for pairs also `pair_faults` (pairs whose pair
fields differ from the recomputation), `pair_below_pct` (of the pairs
concordant in truth whose mates' bests are valid, the share reported not
concordant or with a summed AS below those bests). numbers() gives each
with its base, and number_names() names them for a configuration: a
run's limits file gives a limit to each, and a run fails on a number with
no limit, a limit on a number the judge does not give, or a share whose
base is 0. The shares' limits lie between the program's readings over
many seeds and the control's.

The control (`control_records`): the reference itself in the program's
place, with one guarantee of the configuration broken: no gaps. Each read
is placed without gaps on its true origin's diagonal, with no XS (it looks
at no other copy), and its records are formatted by the same rules the
judge checks, so they pass every field check and fail where gaps were
owed and where a repeat read's second alignment was. A pair's fields are
given by the judge's rules, so the paired control passes `pair_faults`
and fails where a mate's best needed a gap.
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

    @property
    def extent(self) -> tuple:
        """(sequence, 0-based start, span, forward), as PairRules takes a
        mate's alignment."""
        return self.chrom, self.pos0, self.span, self.fw


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


# ------------------------------------------------------------------- pairs -

PAIR_BITS = 0x1 | 0x2 | 0x8 | 0x20 | 0x40 | 0x80
PAIR_TAGS = ("YS", "YT")
FIELDS = ("FLAG", "RNAME", "POS", "MAPQ", "CIGAR", "RNEXT", "PNEXT", "TLEN",
          "SEQ", "QUAL")


class PairRules:
    """The pair guarantees of a paired configuration (`guarantees`):
    `minins` and `maxins` (bowtie2's -I and -X), `orientation` ("fr"), and
    whether mixed (`mixed`) and discordant (`discordant`) alignments are
    reported."""

    def __init__(self, cfg: dict):
        g = cfg["guarantees"]
        if g["orientation"] != "fr":
            raise ValueError("the reference judges --fr pairs only")
        self.minins, self.maxins = int(g["minins"]), int(g["maxins"])
        self.mixed, self.discordant = bool(g["mixed"]), bool(g["discordant"])

    def concordant(self, a, b) -> bool:
        """Whether the alignments of mate 1 and mate 2, (sequence, 0-based
        start, span, forward) each, form a concordant pair (Bowtie 2
        manual, "Paired inputs", and -I, -X, --fr, --no-contain,
        --no-overlap and --dovetail at their defaults): both on one
        sequence, on opposite strands, the forward mate upstream of the
        reverse one; the fragment, from the leftmost base of either to the
        rightmost, minins to maxins bases long. The mates may overlap and
        one may contain the other, but they may not dovetail: the reverse
        mate may not start left of the forward one, nor the forward mate
        end right of the reverse one."""
        if a[0] != b[0] or a[3] == b[3]:
            return False
        f, r = (a, b) if a[3] else (b, a)
        frag = max(a[1] + a[2], b[1] + b[2]) - min(a[1], b[1])
        if not self.minins <= frag <= self.maxins:
            return False
        return f[1] <= r[1] and f[1] + f[2] <= r[1] + r[2]

    @staticmethod
    def tlen(a, b, mate1: bool) -> int:
        """TLEN of the record of the mate aligned at `a` whose mate is
        aligned at `b`, on one sequence (Bowtie 2 manual, SAM output,
        TLEN): the fragment's length, from the leftmost base of either
        alignment to the rightmost, negative where the mate's alignment
        lies upstream of this one. Where both start at one base, the
        forward mate counts as upstream; on one strand, mate 1."""
        t = max(a[1] + a[2], b[1] + b[2]) - min(a[1], b[1])
        if a[1] != b[1]:
            up = a[1] < b[1]
        elif a[3] != b[3]:
            up = a[3]
        else:
            up = mate1
        return t if up else -t


def truth_extent(t: dict) -> tuple:
    return t["chrom"], t["start"], t["span"], t["fw"]


class Judge:
    """Judges the sampled answers of one run (see the module doc)."""

    def __init__(self, cfg: dict, gen: gmod.Genome):
        self.cfg, self.gen, self.sc = cfg, gen, Scoring(cfg)
        self.paired = bool(cfg["reads"]["paired"])
        self.pe = PairRules(cfg) if self.paired else None
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

    def _expect_aligned(self, pl, read, qual, xs, xs_over_as=False):
        """The fields 5-, 9-10 and tags an aligned record must carry
        (RNEXT/PNEXT/TLEN and pair tags filled by the caller). xs_over_as:
        the record is a mate of a pair reported as one, whose XS may pass
        its AS (Bowtie 2 manual, SAM output, XS:i)."""
        err, f = alignment_fields(self.sc, self.gen, pl, read, qual)
        if err:
            return err, None
        smin = self.sc.min_score(len(read))
        if f["AS"] < smin:
            return f"AS {f['AS']} below the minimum {smin}", None
        if xs is not None and not (smin <= xs <= f["AS"] or
                                   (xs_over_as and xs >= smin)):
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

    # ---- a pair ----

    def pair_types(self, pls, fs) -> list[str]:
        """The YT values a pair may be reported under, given its mates'
        placements (None: unaligned) and fields (Bowtie 2 manual, SAM
        output, YT:Z, and "Concordant pairs match pair expectations,
        discordant pairs don't"): CP where the placements are concordant;
        DP where both mates aligned, not concordantly, and each uniquely
        (no XS), when discordant pairs are reported; UP for mates reported
        each on its own (both unaligned, or mixed mode)."""
        out = []
        if pls[0] is not None and pls[1] is not None:
            if self.pe.concordant(pls[0].extent, pls[1].extent):
                out.append("CP")
            elif self.pe.discordant and fs[0]["XS"] is None \
                    and fs[1]["XS"] is None:
                out.append("DP")
        if self.pe.mixed or (pls[0] is None and pls[1] is None):
            out.append("UP")
        return out

    def pair_mapq(self, fs, reads, sec) -> int:
        """The MAPQ both mates of a pair reported as one carry: V2 over the
        pair (unique.h BowtieMapq2 with the pair's summary): the mates'
        summed AS as the best, the summed minimum scores as the minimum
        (the perfect scores, 0 end to end, summed too), and `sec`, the
        second-best concordant pair's summed AS, as the second best."""
        smin = sum(self.sc.min_score(len(r)) for r in reads)
        return mapq_v2(fs[0]["AS"] + fs[1]["AS"], sec, smin)

    def pair_want(self, pls, fs, reads, quals, typ: str, mapq) -> list:
        """The records of a pair, each from FLAG on, as its placements
        (None: unaligned) and fields say under the pair type `typ`, with
        `mapq` the pair's MAPQ where `typ` is CP or DP (Bowtie 2 manual,
        SAM output): FLAG 0x1 always, 0x40 on mate 1 and 0x80 on mate 2,
        0x2 on a concordant pair's, 0x8 where the mate is unaligned and
        0x20 where it aligned to the reverse strand; RNEXT "=" on the
        mate's sequence, else its name; PNEXT the mate's POS; TLEN
        (PairRules.tlen) only for a pair reported as one on one sequence,
        else 0; YS:i the mate's AS on a pair reported as one. An unaligned
        mate takes its aligned mate's RNAME and POS, and an aligned mate
        whose mate is unaligned points RNEXT and PNEXT at itself (SAM
        specification, 1.4: an unmapped mate is placed at its mapped
        mate)."""
        out = []
        for m in (0, 1):
            pl, f, opl, of = pls[m], fs[m], pls[1 - m], fs[1 - m]
            flag = 0x1 | (0x40 if m == 0 else 0x80)
            if opl is None:
                flag |= 0x8
            elif not opl.fw:
                flag |= 0x20
            if pl is None:
                where = ([self.names[opl.chrom], str(opl.pos0 + 1)]
                         if opl is not None else ["*", "0"])
                nxt = ["=", where[1]] if opl is not None else ["*", "0"]
                out.append([str(flag | 0x4)] + where + ["0", "*"] + nxt
                           + ["0", reads[m].decode(), quals[m].decode(),
                              f"YT:Z:{typ}"])
                continue
            as_pair = typ in ("CP", "DP")
            if typ == "CP":
                flag |= 0x2
            if not pl.fw:
                flag |= 0x10
            tl = 0
            if opl is None:
                nxt = ["=", str(pl.pos0 + 1)]
            else:
                nxt = ["=" if opl.chrom == pl.chrom else self.names[opl.chrom],
                       str(opl.pos0 + 1)]
                if as_pair and opl.chrom == pl.chrom:
                    tl = PairRules.tlen(pl.extent, opl.extent, m == 0)
            mq = mapq if as_pair else mapq_v2(
                f["AS"], f["XS"], self.sc.min_score(len(reads[m])))
            tags = self._tag_list(f)
            if as_pair:
                tags.append(f"YS:i:{of['AS']}")
            out.append([str(flag), self.names[pl.chrom], str(pl.pos0 + 1),
                        str(mq), pl.cigar] + nxt
                       + [str(tl), f["SEQ"], f["QUAL"]] + tags
                       + [f"YT:Z:{typ}"])
        return out

    def pair(self, key, recs, reads, quals, sec):
        """Judges a pair's two records. sec: the judge's second-best
        concordant pair's summed AS where the pair is a repeat
        (pair_second), else None. Returns (each mate's own fields all
        right, the pair's fields all right, each mate's reported AS and
        XS: None when unaligned or not reported, the pair type judged)."""
        rec = [r.split("\t") for r in recs]
        if len(rec) != 2 or any(len(r) < 11 for r in rec):
            self.faults.append(f"pair {key}: {len(rec)} records of "
                               f"{[len(r) for r in rec]} fields")
            return [False, False], False, [None, None], [None, None], None
        tags = [_tags(r) for r in rec]
        typ = tags[0].get("YT")
        pls = [self._placement(r) for r in rec]
        fs, mate_ok = [None, None], [True, True]
        for m in (0, 1):
            if pls[m] is None:
                continue
            err, fs[m] = self._expect_aligned(pls[m], reads[m], quals[m],
                                              tags[m].get("XS"),
                                              typ in ("CP", "DP"))
            if err:
                self.faults.append(f"pair {key} mate {m + 1}: {err}")
                mate_ok[m] = False
        if not all(mate_ok):
            return mate_ok, False, [None, None], [None, None], None
        allowed = self.pair_types(pls, fs)
        pair_ok = typ in allowed
        if not pair_ok:
            self.faults.append(f"pair {key}: YT {typ} where its placements "
                               f"allow {allowed}")
            typ = allowed[0] if allowed else "UP"
        mq = None
        if typ in ("CP", "DP"):
            got = _int(rec[0][4])
            opts = {self.pair_mapq(fs, reads, None)}
            if typ == "CP" and sec is not None:
                # a repeat pair: the MAPQ of a second concordant pair no
                # better than the reported one, or of none, since the
                # program need not find the judge's second pair
                smin = sum(self.sc.min_score(len(r)) for r in reads)
                opts |= {self.pair_mapq(fs, reads, x)
                         for x in range(smin, fs[0]["AS"] + fs[1]["AS"] + 1)}
            mq = got if got in opts else min(opts)
        want = self.pair_want(pls, fs, reads, quals, typ, mq)
        for m in (0, 1):
            own, of_pair = _split_diff(rec[m][1:], want[m],
                                       pls[m] is not None,
                                       typ in ("CP", "DP"))
            if own:
                mate_ok[m] = False
                self.faults.append(f"pair {key} mate {m + 1}: "
                                   f"{'; '.join(own[:4])}")
            if of_pair:
                pair_ok = False
                self.faults.append(f"pair {key} mate {m + 1}, pair fields: "
                                   f"{'; '.join(of_pair[:4])}")
        return (mate_ok, pair_ok, [f["AS"] if f else None for f in fs],
                [f["XS"] if f else None for f in fs], typ)

    def pair_second(self, reads, quals, truths, best):
        """For each pair (mates 2j and 2j + 1 of the lists) of which a mate
        overlaps a planted repeat copy, the second best of the concordant
        pairs' summed scores over the family's copies: the origin's (the
        mates' bests) and, with both mates moved to the same place of every
        other copy, the sum of their bests there (best_at_origin) where
        both are valid; None for the other pairs and where no other pair
        is valid. A mate that only overlaps a copy is moved too: its best
        there is the full DP over the genome's own bases at the new place,
        which the bases outside the copy can only lower, so a valid sum is
        that of a pair the genome holds. Unlike copy_of's containment,
        this keeps as repeats the pairs whose second pair runs over a
        copy's end, whose MAPQ a found second pair lowers."""
        n = len(truths) // 2
        smin = [self.sc.min_score(len(r)) for r in reads]
        rows, sib = [], []
        for j in range(n):
            t1, t2 = truths[2 * j], truths[2 * j + 1]
            for c in sorted(set(self._overlapped(t1) + self._overlapped(t2))):
                for c2 in self._kin(c):
                    s1, s2 = self._moved(t1, c, c2), self._moved(t2, c, c2)
                    if self.pe.concordant(truth_extent(s1),
                                          truth_extent(s2)):
                        rows.append(j)
                        sib += [s1, s2]
        out = [None] * n
        if not rows:
            return out
        idx = [2 * j + m for j in rows for m in (0, 1)]
        u = best_at_origin(self.sc, self.gen, [reads[i] for i in idx],
                           [quals[i] for i in idx], sib)
        sums: dict[int, list[int]] = {}
        for k, j in enumerate(rows):
            u1, u2 = int(u[2 * k]), int(u[2 * k + 1])
            if u1 >= smin[2 * j] and u2 >= smin[2 * j + 1]:
                sums.setdefault(j, []).append(u1 + u2)
        for j, v in sums.items():
            if best[2 * j] >= smin[2 * j] and \
                    best[2 * j + 1] >= smin[2 * j + 1]:
                v.append(int(best[2 * j]) + int(best[2 * j + 1]))
            if len(v) >= 2:
                out[j] = sorted(v, reverse=True)[1]
        return out

    def _overlapped(self, t: dict) -> list[int]:
        """The planted repeat copies that a read of truth `t` overlaps."""
        lo, hi = t["start"], t["start"] + t["span"]
        return [c for c, (_, chrom, cs, n, _) in enumerate(self.gen.copies)
                if chrom == t["chrom"] and cs < hi and lo < cs + n]

    def _judge_pairs(self, samples: list[dict]) -> dict:
        qchar = gmod.quality_char(self.cfg["reads"])
        rows, missing = [], 0
        for s in samples:
            if s["records"] is None:
                missing += 1
                continue
            rows.append(s)
        truths = [t for s in rows for t in s["truth"]]
        reads = [gmod.BASES[np.frombuffer(bytes.fromhex(t["codes"]),
                                          np.uint8)].tobytes()
                 for t in truths]
        quals = [bytes([qchar]) * len(r) for r in reads]
        best = best_at_origin(self.sc, self.gen, reads, quals, truths)
        second = self.pair_second(reads, quals, truths, best)
        out = {"field_faults": 0, "missing": missing, "pairs": len(rows),
               "pair_faults": 0, "concordant": 0, "pair_held": 0,
               "pair_below": 0}
        reported, xss = [], []
        for j, s in enumerate(rows):
            two = slice(2 * j, 2 * j + 2)
            try:
                mate_ok, pair_ok, a, xs, typ = self.pair(
                    s["key"], s["records"], reads[two], quals[two], second[j])
            except (ValueError, IndexError, KeyError) as e:
                self.faults.append(f"pair {s['key']}: unreadable ({e!r})")
                mate_ok, pair_ok, a, xs, typ = (
                    [False, False], False, [None, None], [None, None], None)
            out["field_faults"] += 2 - sum(mate_ok)
            out["pair_faults"] += not pair_ok
            out["concordant"] += typ == "CP"
            reported += a
            xss += xs
            b = best[two]
            if self.pe.concordant(*(truth_extent(t) for t in s["truth"])) \
                    and all(b[m] >= self.sc.min_score(len(reads[2 * j + m]))
                            for m in (0, 1)):
                out["pair_held"] += 1
                if typ != "CP" or a[0] + a[1] < int(b[0]) + int(b[1]):
                    out["pair_below"] += 1
        self._reads(out, reads, quals, truths, reported, xss, best)
        out["faults"] = self.faults[:20]
        return out

    # ---- a run ----

    def judge(self, samples: list[dict]) -> dict:
        """samples: [{key, truth: [the truth of each read of the row],
        records: [lines] or None}]. Returns the counts: field_faults
        (records), missing (sampled rows never answered), judged (reads
        whose origin's best is a valid score), below (of them, placed
        below it or unaligned), unaligned, gapped and gapped_below (those
        whose best needs a gap), repeat and repeat_short (the repeat reads
        checked, and those whose XS is missing or below their second
        alignment); for pairs also pairs, pair_faults (pairs whose pair
        fields differ from the recomputation), concordant (reported CP),
        pair_held (pairs whose truth is concordant and whose mates' bests
        are valid) and pair_below (of them, reported not concordant or
        with a summed AS below the mates' bests). A mate counts as a
        read."""
        if self.paired:
            return self._judge_pairs(samples)
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
        out = {"field_faults": faults, "missing": missing}
        self._reads(out, reads, quals, truths, reported, xss)
        out["faults"] = self.faults[:20]
        return out

    def _reads(self, out, reads, quals, truths, reported, xss, best=None):
        """Adds the counts of the judged reads to `out`, from each read's
        reported AS and XS (None: unaligned, not reported)."""
        if best is None:
            best = best_at_origin(self.sc, self.gen, reads, quals, truths)
        ung = best_ungapped(self.sc, self.gen, reads, quals, truths)
        second = self.second_best(reads, quals, truths, best)
        out.update(judged=0, below=0, unaligned=0, gapped=0, gapped_below=0,
                   repeat=0, repeat_short=0)
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

    def copy_of(self, t: dict):
        """The index of the planted repeat copy (genome.copies) that a
        read of truth `t` lies inside, or None."""
        lo, hi = t["start"], t["start"] + t["span"]
        for c, (_, chrom, cs, n, _) in enumerate(self.gen.copies):
            if chrom == t["chrom"] and cs <= lo and hi <= cs + n:
                return c
        return None

    def siblings(self, t: dict) -> list[dict]:
        """Where a read of truth `t` lies inside a planted repeat copy, its
        truth moved to the same place of each other copy of the family."""
        c = self.copy_of(t)
        if c is None:
            return []
        return [self._moved(t, c, c2) for c2 in self._kin(c)]

    def _kin(self, c: int) -> list[int]:
        """The other copies of copy c's family."""
        fam = self.gen.copies[c][0]
        return [c2 for c2, cp in enumerate(self.gen.copies)
                if cp[0] == fam and c2 != c]

    def _moved(self, t: dict, c: int, c2: int) -> dict:
        """Truth `t` moved from copy c to the same place of copy c2 of the
        family (on the other strand where c2 is reversed against c)."""
        _, _, cs, n, fwd = self.gen.copies[c]
        _, chrom2, cs2, _, fwd2 = self.gen.copies[c2]
        o = t["start"] - cs
        if fwd2 == fwd:
            return dict(t, chrom=chrom2, start=cs2 + o)
        return dict(t, chrom=chrom2, start=cs2 + n - o - t["span"],
                    fw=not t["fw"])


def _split_diff(got: list[str], want: list[str], aligned: bool,
                as_pair: bool):
    """The differences between a mate's record and the one expected (each
    from FLAG on), split into the mate's own and the pair's: FLAG's pair
    bits, RNEXT, PNEXT, TLEN, YS and YT, MAPQ where the pair sets it, and
    an unaligned mate's RNAME and POS (its mate's place)."""
    own, pair = [], []
    for k, name in enumerate(FIELDS):
        a, b = got[k], want[k]
        if k == 0:
            fa = _int(a)
            if fa is None:
                own.append(f"FLAG {a!r}")
                continue
            fb = int(b)
            if fa & ~PAIR_BITS != fb & ~PAIR_BITS:
                own.append(f"FLAG {fa} != {fb}")
            if fa & PAIR_BITS != fb & PAIR_BITS:
                pair.append(f"FLAG {fa} != {fb}")
        elif a != b:
            of_pair = k in (5, 6, 7) or (k == 3 and as_pair) or \
                (k in (1, 2) and not aligned)
            (pair if of_pair else own).append(f"{name} {a!r} != {b!r}")
    gt, wt = got[len(FIELDS):], want[len(FIELDS):]
    for part, keep in ((own, lambda t: t[:2] not in PAIR_TAGS),
                       (pair, lambda t: t[:2] in PAIR_TAGS)):
        g, w = [t for t in gt if keep(t)], [t for t in wt if keep(t)]
        if g != w:
            part.append(f"tags {g} != {w}")
    if not own and not pair and gt != wt:
        own.append(f"tags in the order {gt}, expected {wt}")
    return own, pair


def number_names(cfg: dict) -> set[str]:
    """The names of the numbers a run of this configuration compares:
    `unanswered` (run.finish counts it) and those of numbers()."""
    keys = ["field_faults", "below", "judged", "gapped_below", "gapped",
            "repeat_short", "repeat"]
    if cfg["reads"]["paired"]:
        keys += ["pairs", "pair_faults", "pair_below", "pair_held"]
    return {"unanswered", *numbers(dict.fromkeys(keys, 0))}


def numbers(verdict: dict) -> dict:
    """Each number the judge's counts give, as (value, base): a share's
    base is the count it is a share of, None for a count of faults."""
    def share(n, d):
        return 100.0 * n / max(d, 1), d

    out = {"field_faults": (verdict["field_faults"], None),
           "below_pct": share(verdict["below"], verdict["judged"]),
           "gapped_below_pct": share(verdict["gapped_below"],
                                     verdict["gapped"]),
           "repeat_xs_pct": share(verdict["repeat_short"], verdict["repeat"])}
    if "pairs" in verdict:
        out["pair_faults"] = (verdict["pair_faults"], None)
        out["pair_below_pct"] = share(verdict["pair_below"],
                                      verdict["pair_held"])
    return out


# ----------------------------------------------------------------- control -

def control_records(cfg: dict, gen: gmod.Genome, samples: list[dict]):
    """The samples with their records replaced by the control's: the
    reference aligner without gaps, each read placed on the best diagonal
    of its origin's window (best_ungapped), with no XS, unaligned where
    that scores below the minimum, formatted by the rules the judge holds
    records to. Pairs: each mate so placed, and the pair's fields given by
    the judge's rules for the first type its placements allow (CP where
    they are concordant, its MAPQ with the judge's second pair where it is
    a repeat)."""
    judge = Judge(cfg, gen)
    reads, quals, truths, pls, fs = _control_placements(judge, samples)
    if judge.paired:
        return _control_pairs(judge, samples, reads, quals, truths, pls, fs)
    out = []
    for s, rd, q, pl, f in zip(samples, reads, quals, pls, fs):
        if pl is None:
            rec = ["r", "4", "*", "0", "0", "*", "*", "0", "0", rd.decode(),
                   q.decode(), "YT:Z:UU"]
        else:
            mq = mapq_v2(f["AS"], None, judge.sc.min_score(len(rd)))
            rec = (["r", str(0 if pl.fw else 16), gen.names[pl.chrom],
                    str(pl.pos0 + 1), str(mq), pl.cigar, "*", "0", "0",
                    f["SEQ"], f["QUAL"]] + judge._tag_list(f) + ["YT:Z:UU"])
        out.append({"key": s["key"], "truth": s["truth"],
                    "records": ["\t".join(rec)]})
    return out


def _control_placements(judge: Judge, samples: list[dict]):
    """Every read of the samples (a pair's mates in turn) with the
    control's placement of it: gap-free on the best diagonal of its
    origin's window, and its fields with no XS; None for both where that
    scores below the minimum. Returns (reads, quals, truths, placements,
    fields), a list each."""
    pad = 24
    qchar = gmod.quality_char(judge.cfg["reads"])
    truths = [t for s in samples for t in s["truth"]]
    reads = [gmod.BASES[np.frombuffer(bytes.fromhex(t["codes"]),
                                      np.uint8)].tobytes() for t in truths]
    quals = [bytes([qchar]) * len(r) for r in reads]
    _, where = best_ungapped(judge.sc, judge.gen, reads, quals, truths, pad,
                             where=True)
    pls, fs = [], []
    for t, rd, q, k in zip(truths, reads, quals, where):
        pl = Placement(t["chrom"], t["start"] - pad + int(k), t["fw"],
                       f"{len(rd)}M")
        err, f = judge._expect_aligned(pl, rd, q, None)
        pls.append(None if err else pl)
        fs.append(None if err else f)
    return reads, quals, truths, pls, fs


def _control_pairs(judge: Judge, samples, reads, quals, truths, pls, fs):
    second = judge.pair_second(
        reads, quals, truths,
        best_at_origin(judge.sc, judge.gen, reads, quals, truths))
    out = []
    for j, s in enumerate(samples):
        two = slice(2 * j, 2 * j + 2)
        typ = judge.pair_types(pls[two], fs[two])[0]
        mq = None
        if typ in ("CP", "DP"):
            sec = second[j] if typ == "CP" else None
            a = fs[2 * j]["AS"] + fs[2 * j + 1]["AS"]
            mq = judge.pair_mapq(fs[two], reads[two],
                                 None if sec is None else min(sec, a))
        want = judge.pair_want(pls[two], fs[two], reads[two], quals[two],
                               typ, mq)
        out.append({"key": s["key"], "truth": s["truth"],
                    "records": ["\t".join(["r"] + w) for w in want]})
    return out
