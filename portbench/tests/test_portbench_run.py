"""Whole runs of the harness on the CPU (past its look for a card): the
last line's keys, `correct` false under each fault the timed path can
have, no JAX in a run's modules, and a card run where there is a card."""
import json
import subprocess
import sys

import pytest

from portbench import run

from tinycells import served_small, tiny_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_a_cpu_run_is_correct_and_its_line_has_the_result_keys():
    cell = tiny_cell("tiny_se100", "stream")
    out, lines = run.run_cell(cell, 2**31 + 3, 3, False, device="cpu",
                              hook=served_small)
    assert set(out) == KEYS and list(out)[-1] == "checks"
    assert out["correct"], lines
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    n = len(out["checks"])
    assert lines[-n:] == [f"checks: {k} {c['value']} (limit {c['limit']})"
                          for k, c in out["checks"].items()]
    json.dumps(out)


def test_a_traced_cpu_run_reads_the_wrapped_layers():
    cell = tiny_cell("tiny_se100", "stream")
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell.per_layer = [m for m in bench["per_layer"]
                      if "ecoli_se100.stream" in m["workloads"]]
    out, lines = run.run_cell(cell, 11, 8, True, device="cpu",
                              hook=served_small)
    assert out["correct"], lines
    got = set(out["metrics"])
    # no card, so nothing of the device trace
    assert {"server.format_ms_per_kread.stream", "aligner.align_ms_per_kread",
            "candgen.dispatch_ms"} <= got
    assert not got & {"device.idle_share", "sw_banded_roofline"}
    assert "window_s" in out["device"] and "busy_s" in out["device"]


def _half_the_pack(served):
    served_small(served)
    pack = served.srv._align_pack

    def half(worker, rows, names):
        return pack(worker, rows[: len(rows) // 2], names)
    served.srv._align_pack = half


def _altered_answer(served):
    served_small(served)
    pack = served.srv._align_pack

    def altered(worker, rows, names):
        out = pack(worker, rows, names).split(b"\n")
        for k, line in enumerate(out):
            if b"\tAS:i:" in line:      # one score, where it is produced
                out[k] = line.replace(b"\tAS:i:", b"\tAS:i:-1", 1)
                break
        return b"\n".join(out)
    served.srv._align_pack = altered


def _no_exchange():
    """Two logical CPU shards, and the gather that brings the second
    shard's results to the host left out: shard 0's stand in for both."""
    import torch
    from bowtie2_server_tpu_torch.align import candgen
    from bowtie2_server_tpu_torch.parallel.mesh import Mesh
    from bowtie2_server_tpu_torch.server import dispatch
    groups, gather = dispatch.make_device_groups, candgen._gather
    dispatch.make_device_groups = \
        lambda n, device: [Mesh([torch.device("cpu")] * 2)]
    candgen._gather = lambda shards: gather([shards[0]] * len(shards))
    return lambda: (setattr(dispatch, "make_device_groups", groups),
                    setattr(candgen, "_gather", gather))


@pytest.mark.parametrize("fault", ["half_the_pack", "altered_answer",
                                   "no_exchange"])
def test_a_broken_timed_path_is_not_correct(fault):
    cell = tiny_cell("tiny_se100", "stream")
    undo = None

    def prepare():
        nonlocal undo
        if fault == "no_exchange":
            undo = _no_exchange()

    hook = {"half_the_pack": _half_the_pack,
            "altered_answer": _altered_answer}.get(fault, served_small)
    try:
        out, lines = run.run_cell(cell, 21, 3, False, device="cpu",
                                  prepare=prepare, hook=hook)
    finally:
        if undo:
            undo()
    assert not out["correct"], lines


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        "import portbench.run, portbench.client_proc, portbench.control\n"
        "import portbench.reference, portbench.yardstick\n"
        "import bowtie2_server_tpu_torch.server.bt2srv\n"
        "import bowtie2_server_tpu_torch.align.paired\n"
        "from portbench import probes\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "[probes.load_reader(m['name']) for m in b['per_layer']]\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(run.ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    tops = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "bowtie2_server_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN)


def test_without_a_card_there_is_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "ecoli_se100.stream", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    r = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "ecoli_se100.stream", "--seed", "4242", "--seconds", "3",
         "--trace", "1"], cwd=str(run.ROOT), capture_output=True, text=True,
        timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
