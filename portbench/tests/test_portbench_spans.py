"""The readers of the port's own spans (`portbench/spans.py`, the metrics
whose source is program_span and that list no probe) on whole CPU runs of
the tiny cell: a traced run gives each of them a number, and a --trace 0
run leaves the recorder off."""
import json
import time

import pytest

from portbench import run

from tinycells import served_small, tiny_cell


def span_metrics():
    """The metrics of the port's spans (their readers loaded: the recorder
    is on after)."""
    b = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    return [m for m in b["per_layer"] if m["source"] == "program_span"
            and not run.probes.load_reader(m["name"]).PROBES]


@pytest.fixture
def trace():
    from bowtie2_server_tpu_torch.utils import trace
    trace.disable()
    yield trace
    trace.disable()


def test_a_traced_cpu_run_reads_every_span_metric(trace):
    cell = tiny_cell("tiny_se100", "stream")
    cell.per_layer = span_metrics()
    # every program_span entry of BENCHMARK.json whose reader reads the
    # port's spans through portbench/spans.py
    b = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    through = [m["name"] for m in b["per_layer"]
               if m["source"] == "program_span" and "portbench.spans" in
               (run.probes.METRICS / f"{m['name']}.py").read_text()]
    assert [m["name"] for m in cell.per_layer] == through and through
    out, lines = run.run_cell(cell, 2**31 + 17, 8, True, device="cpu",
                              hook=served_small)
    assert out["correct"], lines
    got = out["metrics"]
    assert set(got) == {m["name"] for m in cell.per_layer}
    for name, v in got.items():
        assert v["value"] >= 0, name
    for name in ("server.worker_idle_pct", "server.worker_cpu_pct",
                 "aligner.slow_read_pct", "kernels.banded_fill_pct"):
        assert got[name]["value"] <= 100, name
    assert got["kernels.banded_fill_pct"]["value"] > 0


def test_an_untraced_run_leaves_the_recorder_off(trace):
    cell = tiny_cell("tiny_se100", "stream")
    cell.per_layer = span_metrics()
    trace.disable()     # span_metrics loaded the readers
    t0 = time.time()
    out, lines = run.run_cell(cell, 5, 3, False, device="cpu",
                              hook=served_small)
    assert out["correct"], lines
    assert not trace.enabled()
    assert trace.spans(t0) == []
