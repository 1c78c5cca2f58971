"""Tiny configurations (tiny_se100.json, and tiny_pe150.json for pairs,
beside this file) and cells of them cut to the CPU, for the harness's
tests."""
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def tiny_config(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


def tiny_cell(config: str, traffic: str):
    """A cell of a tiny configuration under a shipped traffic mix, cut to
    the CPU: packs of 256 (set by served_small), 1024 reads in flight, a
    small warm-up. Its limits are those of `<config>.<traffic>.json`
    beside this file where there is one, else ecoli_se100.stream's."""
    from portbench import run
    from portbench.traffic import load_traffic
    tr = dict(load_traffic(traffic), warmup_rows=256,
              chunk=64, in_flight=1024, sample=0.3, drain_s=120)
    e2e = [{"name": "reads_per_s", "unit": "reads/s"},
           {"name": "setup_s", "unit": "s"}]
    own = HERE / f"{config}.{traffic}.json"
    lim = json.loads((own if own.exists() else run.HERE / "limits"
                      / "ecoli_se100.stream.json").read_text())
    return run.Cell(f"tiny.{traffic}", tiny_config(config), tr, 1, e2e, [],
                    lim)


def served_small(served):
    """Hook: packs of 256 rows, so that a CPU server answers in time."""
    served.srv.batch_size = 256
