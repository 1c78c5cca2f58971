"""The one traffic generator: it reads a traffic file
(`portbench/traffic/<name>.json`) and a configuration, and makes what each
client process sends, from the run's seed.

Traffic keys:
  loop         "closed": each client streams reads on one connection
               without end, up to the wire's in-flight bound (the one
               loop this generator has).
  clients      the connections, each a thread of the one load process.
  workers      the server's workers (`Bt2Server(n_workers=...)`).
  sample       the share of rows (reads, or pairs) whose records the
               reference judges;
  sample_indel the share of the rows in which an indel was planted (in
               either mate of a pair).
  chunk        reads a streaming client makes at a time.
  in_flight    reads a streaming client keeps in flight at most (the
               wire's bound, MAX_SLOTS).
  warmup_rows  reads sent through the socket in set-up in one request
               (whole packs).
  drain_s      seconds a client waits past the window for what is due.

The reads' places, strands and errors are drawn from the seed; every seed
gets the same kind and amount of work. A configuration whose
`reads.paired` is true gets pairs: each row carries both mates, and a
sampled pair is judged whole.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import genome as gmod

HERE = Path(__file__).resolve().parent


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def rng_for(seed: int, *stream: int):
    """A generator for one purpose of one run: the seed (any whole number)
    and the purpose's integers as a SeedSequence's entropy."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def records_per_row(cfg: dict) -> int:
    """The records the server owes a row of this configuration: one a
    read, two a pair."""
    return 2 if cfg["reads"]["paired"] else 1


class ReadSource:
    """Rows for one client: chunks of unpaired reads or of pairs with keys,
    and the truth of the sampled ones."""

    def __init__(self, gen: gmod.Genome, cfg: dict, traffic: dict, seed: int,
                 client: int, purpose: int = 0):
        self.gen = gen
        self.rc = cfg["reads"]
        self.paired = bool(self.rc["paired"])
        self.sample = float(traffic["sample"])
        self.sample_indel = float(traffic.get("sample_indel", 1.0))
        self.rng = rng_for(seed, client, purpose)
        self.client = client
        self.serial = 0
        L = int(self.rc["length"])
        self.qual = bytes([gmod.quality_char(self.rc)]) * L

    def chunk(self, n: int):
        """(rows, samples): rows as wire.Connection.send takes them, keyed
        by a serial number; samples: serial -> truth of the sampled rows,
        an entry a mate."""
        if self.paired:
            return self._pairs(n)
        m = gmod.simulate_unpaired(self.gen, self.rc, self.rng, n)
        keys = range(self.serial, self.serial + n)
        q = self.qual
        rows = [(k, [a.tobytes(), q])
                for k, a in zip(keys, gmod.BASES[m.codes])]
        # reads with a planted indel at a share of their own, so that the
        # gapped alignments the judge holds to their best are many
        u = self.rng.random(n)
        picked = np.nonzero(np.where(m.indel, u < self.sample_indel,
                                     u < self.sample))[0]
        samples = {self.serial + int(i): [_truth(m, int(i))] for i in picked}
        self.serial += n
        return rows, samples

    def _pairs(self, n: int):
        m1, m2 = gmod.simulate_pairs(self.gen, self.rc, self.rng, n)
        q = self.qual
        rows = [(k, [a.tobytes(), q, b.tobytes(), q]) for k, a, b in zip(
            range(self.serial, self.serial + n), gmod.BASES[m1.codes],
            gmod.BASES[m2.codes])]
        u = self.rng.random(n)
        picked = np.nonzero(np.where(m1.indel | m2.indel,
                                     u < self.sample_indel,
                                     u < self.sample))[0]
        samples = {self.serial + int(i): [_truth(m1, int(i)),
                                          _truth(m2, int(i))]
                   for i in picked}
        self.serial += n
        return rows, samples


def _truth(m: gmod.Reads, i: int) -> dict:
    return {"codes": m.codes[i].tobytes().hex(), "chrom": int(m.chrom[i]),
            "start": int(m.start[i]), "span": int(m.span[i]),
            "fw": bool(m.fw[i])}
