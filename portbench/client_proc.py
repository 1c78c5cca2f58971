"""The load: `python -m portbench.client_proc SPEC`, one process with a
few threads, on cores of its own (run.py pins it), apart from the server.

SPEC is a JSON file the run writes: the server's address, the
configuration and traffic, the seed, the genome's directory and the path
of the result file. The process imports neither torch nor the program: it
makes its reads (traffic.py), connects, prints `ready`, and waits for one
line `go <t0> <t_end>` on standard input (time.monotonic() values, which
every process of the machine shares).

A closed loop: each of the traffic's `clients` is a thread that streams
reads on a connection of its own from t0 until t_end, as many as the
wire's in-flight bound lets it, then sends its last chunk and waits for
All Done.

The result file holds a list, an entry a client: the reads answered
inside [t0, t_end] (a pair's mates count as two reads); every row
answered; the wire's faults; and the sampled rows with their truth and
the records they got.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path

from . import genome as gmod
from .traffic import ReadSource, records_per_row
from .wire import Connection


class Tally:
    def __init__(self, t0: float, t_end: float, reads_per_row: int = 1):
        self.t0, self.t_end = t0, t_end
        self.reads_per_row = reads_per_row
        self.in_window = 0
        self.answered = 0
        self.samples: dict[int, list] = {}
        self.got: dict[int, list[str]] = {}

    def on_read(self, key, lines, t):
        self.answered += 1
        if self.t0 <= t <= self.t_end:
            self.in_window += self.reads_per_row
        if key in self.samples:
            self.got[key] = [ln.decode() for ln in lines]


def _sleep_until(t: float):
    while (d := t - time.monotonic()) > 0:
        time.sleep(min(d, 0.05))


def stream(spec, gen):
    """Every client, a thread each on a connection of its own."""
    tr = spec["traffic"]
    n = int(tr["clients"])
    srcs = [ReadSource(gen, spec["config"], tr, spec["seed"], k)
            for k in range(n)]
    firsts = [src.chunk(int(tr["chunk"])) for src in srcs]
    conns = [Connection(spec["host"], spec["port"], spec["index_name"],
                        records_per_row(spec["config"]),
                        max_slots=int(tr["in_flight"]))
             for _ in range(n)]
    t0, t_end = _ready()
    outs: list = [None] * n
    threads = [threading.Thread(target=_stream_one, daemon=True, args=(
        spec, srcs[k], conns[k], firsts[k], t0, t_end, outs, k))
        for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(t_end - time.monotonic() + float(tr["drain_s"]) + 30)
    return [o for o in outs if o is not None]


def _stream_one(spec, src, conn, first, t0, t_end, outs, k):
    tr = spec["traffic"]
    tally = Tally(t0, t_end, conn.n_records)
    conn.on_read = tally.on_read
    _sleep_until(t0)
    rows, samples = first
    try:
        while True:
            # a read's truth is in place before its answer can come
            tally.samples.update(samples)
            sent = conn.send(rows, until=t_end)
            if sent < len(rows):
                for key, _ in rows[sent:]:
                    tally.samples.pop(key, None)
                break
            if time.monotonic() >= t_end:
                break
            rows, samples = src.chunk(int(tr["chunk"]))
    except (ConnectionError, OSError):
        pass
    conn.finish(max(t_end + float(tr["drain_s"]) - time.monotonic(), 1.0))
    outs[k] = dict(in_window=tally.in_window, answered=tally.answered,
                   faults=conn.faults, samples=_samples(tally))


def _samples(tally: Tally) -> list:
    out = []
    for key, truth in tally.samples.items():
        out.append({"key": key, "truth": truth,
                    "records": tally.got.get(key)})
    return out


def _ready() -> tuple[float, float]:
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if len(line) != 3 or line[0] != "go":
        raise SystemExit(f"client: expected 'go t0 t_end', got {line!r}")
    return float(line[1]), float(line[2])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    spec = json.loads(Path(argv[0]).read_text())
    gen = gmod.load_genome(Path(spec["genome_dir"]))
    out = stream(spec, gen)
    Path(spec["result"]).write_text(json.dumps(out))
    print("done", flush=True)


if __name__ == "__main__":
    main()
