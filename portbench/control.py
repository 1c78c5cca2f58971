"""The control of `correct`: the reference itself in the program's place
with one guarantee broken (no gaps, and no look at a repeat's other
copies for a read's XS; a pair's fields follow the judge's rules;
reference.control_records), judged by the run's own checks (run.finish)
on the reads or pairs a run of the cell sends.

    python3 -m portbench.control --workload ecoli_se100.stream \\
        --seeds 1,2,3 --rows 60000

For each seed it makes each client's reads as a run does (traffic.py,
the same sample) for `--rows` rows a client, answers the sampled ones by
the control, and prints the checks' lines and the run's verdict. It exits
0 when the control comes out not correct on every seed. The benchmark's
runs do not run it; it needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import genome as gmod
from . import run
from .reference import control_records
from .traffic import ReadSource


def control_results(cell, gen, seed: int, rows: int) -> list[dict]:
    """What the clients of a run would write, with the control's records
    in place of the program's."""
    tr = cell.traffic
    out = []
    for k in range(int(tr["clients"])):
        src = ReadSource(gen, cell.cfg, tr, seed, k)
        samples = []
        for _ in range(0, rows, int(tr["chunk"])):
            _, smp = src.chunk(int(tr["chunk"]))
            samples += [{"key": key, "truth": t, "records": None}
                        for key, t in smp.items()]
        out.append({"in_window": 0, "answered": rows, "faults": {},
                    "samples": control_records(cell.cfg, gen, samples)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rows", type=int, required=True,
                    help="rows each client sends (a run's count)")
    a = ap.parse_args(argv)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = run.resolve_cell(bench, a.workload)
    gen = gmod.load_genome(run.genome_dir(cell.cfg))
    failed_all = True
    for seed in (int(s) for s in a.seeds.split(",")):
        results = control_results(cell, gen, seed, a.rows)
        out, lines = run.finish(cell, gen, results, 1.0, 0.0, 0, {}, None,
                                None, None, None, "cpu", 1, False)
        for ln in lines:
            print(f"seed {seed}: {ln}", flush=True)
        failed_all &= not out["correct"]
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
