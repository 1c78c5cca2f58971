"""BENCHMARK.json and every file the harness finds by name load, and keep
the shape the benchmark's format requires."""
import json
import re

from portbench import probes, reference, run
from portbench.traffic import load_config, load_traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((run.ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(b)) < 64 * 1024


def test_every_file_loads_by_name():
    b = bench()
    for c in b["configs"]:
        cfg = load_config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        load_traffic(w["traffic"])
        cell = run.resolve_cell(b, w["name"])
        # a limit on each number the configuration's judge gives
        assert set(cell.limits) == reference.number_names(cell.cfg)
        assert cell.chips == w["chips"]
    for m in b["per_layer"]:
        mod = probes.load_reader(m["name"])
        assert callable(mod.read) and isinstance(mod.PROBES, dict)
    # every reader serves a metric of BENCHMARK.json
    files = {p.stem for p in probes.METRICS.glob("*.py")}
    assert files == {m["name"] for m in b["per_layer"]}


def test_each_layer_metric_moves_one_reported_metric():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for w in cells:
        cell = run.resolve_cell(b, w)
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
