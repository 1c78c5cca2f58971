"""The genome and read simulator of the benchmark (NumPy only).

The genome comes from its configuration (`genome`: sequence names and
lengths, GC content, repeat families planted as near-identical copies) and
the configuration's own fixed seed, never from a run's `--seed`: it stands
for the reference that users index offline once. The reads come from a
run's seed. They follow wgsim's model (`reads`): each read is cut
from its stretch of genome; mutations at `mutation_rate` a base, of which
`indel_fraction` are indels (half insertions, half deletions, lengths
geometric with `indel_extend`) and the rest substitutions; then sequencing
errors, substitutions at `error_rate` a base; and wgsim's constant base
quality for that error rate. Unpaired reads take either strand. Pairs
(`reads.paired`) follow wgsim's paired model: a fragment whose length is
drawn from `reads.fragment`, on either strand; mate 1 is its first
`length` bases on that strand, mate 2 the reverse complement of its last
`length` bases (FR), each mutated and sequenced on its own stretch.

Codes are 0-3 for A, C, G, T. Each read carries its truth: the sequence
index, the leftmost reference base it covers (0-based, in the sequence),
the number of reference bases it covers (`span`: read length less
insertions plus deletions) and its strand.
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = np.array([3, 2, 1, 0], np.uint8)
SLACK = 32        # extra genome bases a read's stretch carries for deletions


@dataclass
class Genome:
    names: list[str]
    seq: np.ndarray           # all sequences concatenated, uint8 codes 0-3
    offsets: np.ndarray       # int64 [n + 1]: sequence k is seq[off[k]:off[k+1]]
    # the planted repeat copies: [family, sequence, 0-based start, length,
    # forward] each, forward when the copy reads as its family's unit
    copies: list = field(default_factory=list)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def chrom(self, k: int) -> np.ndarray:
        return self.seq[self.offsets[k] : self.offsets[k + 1]]

    def fasta(self) -> bytes:
        out = []
        for k, name in enumerate(self.names):
            out.append(b">" + name.encode() + b"\n")
            s = BASES[self.chrom(k)].tobytes()
            out.extend(s[i : i + 80] + b"\n" for i in range(0, len(s), 80))
        return b"".join(out)


def config_key(cfg: dict) -> str:
    """A name for the genome of `cfg`: its configuration's genome block and
    this file's source, hashed, so that either changing makes a new one."""
    h = hashlib.sha256(json.dumps(cfg["genome"], sort_keys=True).encode())
    h.update(Path(__file__).read_bytes())
    return h.hexdigest()[:16]


def _bases(rng, n: int, gc: float) -> np.ndarray:
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=n, p=p).astype(np.uint8)


def make_genome(cfg: dict) -> Genome:
    """The configuration's genome: random bases at its GC content, then
    each repeat family's copies written over them at places that do not
    overlap, each copy on a random strand and diverged from the family's
    unit by a uniform share of substitutions in `divergence`."""
    g = cfg["genome"]
    rng = np.random.default_rng(int(g["seed"]))
    names = [s[0] for s in g["sequences"]]
    lens = np.array([int(s[1]) for s in g["sequences"]], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    seq = _bases(rng, int(offsets[-1]), float(g["gc"]))
    taken: list[tuple[int, int]] = []
    copies = []
    for f, fam in enumerate(g.get("repeats", [])):
        unit = _bases(rng, int(fam["length"]), float(g["gc"]))
        lo, hi = fam["divergence"]
        for _ in range(int(fam["copies"])):
            for _attempt in range(1000):
                k = int(rng.choice(len(lens), p=lens / lens.sum()))
                if lens[k] <= 2 * len(unit):
                    continue
                at = int(offsets[k] + rng.integers(0, lens[k] - len(unit)))
                if all(at + len(unit) <= a or b <= at for a, b in taken):
                    break
            else:
                raise RuntimeError(f"no room for a copy of {fam['family']}")
            taken.append((at, at + len(unit)))
            copy = unit.copy()
            d = rng.uniform(lo, hi)
            m = rng.random(len(copy)) < d
            copy[m] = (copy[m] + rng.integers(1, 4, int(m.sum()))) % 4
            forward = rng.random() >= 0.5
            if not forward:
                copy = COMP[copy][::-1]
            seq[at : at + len(copy)] = copy
            copies.append([f, k, at - int(offsets[k]), len(copy), forward])
    return Genome(names, seq, offsets, copies)


def save_genome(gen: Genome, path: Path) -> None:
    np.save(path / "seq.npy", gen.seq)
    np.save(path / "offsets.npy", gen.offsets)
    (path / "names.json").write_text(json.dumps(gen.names))
    (path / "copies.json").write_text(json.dumps(gen.copies))


def load_genome(path: Path) -> Genome:
    return Genome(json.loads((path / "names.json").read_text()),
                  np.load(path / "seq.npy", mmap_mode="r"),
                  np.load(path / "offsets.npy"),
                  json.loads((path / "copies.json").read_text()))


def quality_char(rc: dict) -> int:
    """wgsim's base quality for its error rate, as a Phred+33 byte."""
    q = int(-10.0 * math.log10(float(rc["error_rate"])) + 0.499)
    return 33 + q


@dataclass
class Reads:
    """n reads of one length: codes as sequenced, and truth."""
    codes: np.ndarray      # uint8 [n, L]
    chrom: np.ndarray      # int64 [n]
    start: np.ndarray      # int64 [n], 0-based, in the sequence
    span: np.ndarray       # int64 [n]
    fw: np.ndarray         # bool [n]
    indel: np.ndarray      # bool [n]: an indel was planted in the read


def _mutate_stretches(rng, stretch: np.ndarray, L: int, rc: dict):
    """wgsim's mutations on each row of `stretch` ([n, L + SLACK], read
    orientation). Returns (the first L bases of each mutated row, the
    reference bases they cover). Indels start between read bases 1 and
    L - 2, so that a read's first base is always its stretch's first."""
    n = stretch.shape[0]
    r = float(rc["mutation_rate"])
    fr = float(rc["indel_fraction"])
    out = stretch.copy()
    sub = rng.random(out.shape) < r * (1 - fr)
    out[sub] = (out[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    span = np.full(n, L, np.int64)
    has = np.zeros(n, bool)
    indel = rng.random((n, L)) < r * fr
    indel[:, 0] = indel[:, L - 1] = False
    ext = float(rc["indel_extend"])
    for i in np.nonzero(indel.any(axis=1))[0]:
        src = out[i]
        events = set(np.nonzero(indel[i])[0].tolist())
        row, srcidx, j = [], [], 0
        while len(row) < L and j < len(src):
            if j in events:
                events.discard(j)
                ln = 1
                while rng.random() < ext:
                    ln += 1
                if rng.random() < 0.5:             # insertion before base j
                    row.extend(rng.integers(0, 4, ln).tolist())
                    srcidx.extend([-1] * ln)
                else:                              # deletion of ln bases
                    j += ln
                    continue
            row.append(int(src[j]))
            srcidx.append(j)
            j += 1
        if len(row) < L:
            continue          # the stretch ran out: keep the read unmutated
        out[i, :L] = np.array(row[:L], np.uint8)
        span[i] = max(srcidx[:L]) + 1
        has[i] = True
    return out[:, :L], span, has


def _errors(rng, codes: np.ndarray, rc: dict) -> np.ndarray:
    m = rng.random(codes.shape) < float(rc["error_rate"])
    codes = codes.copy()
    codes[m] = (codes[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return codes


def _stretch(gen: Genome, gpos: np.ndarray, fw: np.ndarray, L: int):
    """[n, L + SLACK] genome bases in read orientation: forward from gpos
    for fw rows, reverse complemented leftwards from gpos (exclusive) for
    the others."""
    W = L + SLACK
    ar = np.arange(W)
    top = len(gen.seq) - 1
    fwd = gen.seq[np.minimum(gpos[:, None] + ar[None, :], top)]
    rev = COMP[gen.seq[np.maximum((gpos[:, None] - 1) - ar[None, :], 0)]]
    return np.where(fw[:, None], fwd, rev)


def _positions(rng, gen: Genome, n: int, need: np.ndarray | int):
    """(sequence, 0-based start) of n stretches of `need` bases drawn
    uniformly over the genome, SLACK bases from either end of a
    sequence."""
    need = np.broadcast_to(np.asarray(need, np.int64), (n,))
    lens = gen.lengths
    room = np.maximum(lens[None, :] - need[:, None] - 2 * SLACK, 0)
    w = lens / lens.sum()
    k = rng.choice(len(lens), size=n, p=w)
    ok = room[np.arange(n), k] > 0
    if not ok.all():
        raise ValueError("a read does not fit its sequence")
    start = SLACK + (rng.random(n) * room[np.arange(n), k]).astype(np.int64)
    return k.astype(np.int64), start


def simulate_unpaired(gen: Genome, rc: dict, rng, n: int) -> Reads:
    L = int(rc["length"])
    chrom, start = _positions(rng, gen, n, L)
    fw = rng.random(n) < 0.5
    g0 = gen.offsets[chrom] + start
    anchor = np.where(fw, g0, g0 + L)
    codes, span, has = _mutate_stretches(rng, _stretch(gen, anchor, fw, L),
                                         L, rc)
    start = np.where(fw, start, start + L - span)
    return Reads(_errors(rng, codes, rc), chrom, start, span, fw, has)


def simulate_pairs(gen: Genome, rc: dict, rng, n: int) -> tuple[Reads, Reads]:
    """n FR pairs, as wgsim makes them: a fragment of length drawn from
    N(fragment.mean, fragment.sd), rounded and cut to [fragment.min,
    fragment.max], placed uniformly inside one sequence, on either strand;
    mate 1 is the fragment's first `length` bases on that strand and mate
    2 the reverse complement of its last `length` bases. Each mate takes
    the mutations and errors of the unpaired model on its own stretch."""
    L = int(rc["length"])
    fr = rc["fragment"]
    frag = np.clip(np.rint(rng.normal(float(fr["mean"]), float(fr["sd"]), n)),
                   max(int(fr["min"]), L), int(fr["max"])).astype(np.int64)
    chrom, start = _positions(rng, gen, n, frag)
    fw = rng.random(n) < 0.5            # the strand of the fragment, mate 1's
    g0 = gen.offsets[chrom] + start
    mates = []
    for mfw, anchor in ((fw, np.where(fw, g0, g0 + frag)),
                        (~fw, np.where(fw, g0 + frag, g0))):
        codes, span, has = _mutate_stretches(
            rng, _stretch(gen, anchor, mfw, L), L, rc)
        mstart = np.where(mfw, start, start + frag - span)
        mates.append(Reads(_errors(rng, codes, rc), chrom, mstart, span, mfw,
                           has))
    return mates[0], mates[1]
