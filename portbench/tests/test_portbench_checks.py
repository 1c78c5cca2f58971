"""The checks a run makes come from its cell's limits file, and a cell is
added by files and entries alone: the unpaired traffic is what it was, a
limits key the judge does not know fails the run, as do a number of the
judge's with no limit and a share of nothing, and a copy of
BENCHMARK.json with a paired cell appended resolves it with both
end-to-end metrics."""
import hashlib
import json
import shutil

import pytest

from portbench import genome as gmod
from portbench import reference as R
from portbench import run, traffic
from portbench.traffic import ReadSource, load_traffic

from tinycells import HERE as TESTS
from tinycells import tiny_config

# sha256 of the rows and samples that ReadSource made for tiny_se100 under
# the stream traffic before it made pairs too (_digest, seeds 1-3)
FROZEN = {
    1: "8de13e6cf8a86513761bb67cba2667ab353c71a8ecf44dd9569750710b124711",
    2: "e6822d243fa5351d932ceb214bd4d7520aec69a24d02899c438dd90ab6b48488",
    3: "a7f39039ee593c528e9a7799f34eacc71e6c83dbe12bc91bf0d66341cebfa779",
}


def _digest(gen, cfg, seed: int) -> str:
    h = hashlib.sha256()
    for client in (0, 3):
        src = ReadSource(gen, cfg, load_traffic("stream"), seed, client)
        for n in (256, 300):
            rows, samples = src.chunk(n)
            for k, f in rows:
                h.update(b"%d\t" % k + b"\t".join(f) + b"\n")
            h.update(json.dumps(samples, sort_keys=True).encode())
    return h.hexdigest()


def test_unpaired_rows_and_samples_are_unchanged():
    cfg = tiny_config("tiny_se100")
    gen = gmod.make_genome(cfg)
    for seed, want in FROZEN.items():
        assert _digest(gen, cfg, seed) == want, seed


@pytest.fixture(scope="module")
def judged():
    """An unpaired tiny cell's sampled answers, each given the records the
    control makes for it: what run.finish judges."""
    from portbench.control import control_results
    cfg = tiny_config("tiny_se100")
    gen = gmod.load_genome(run.genome_dir(cfg))
    cell = run.Cell("tiny.stream", cfg, dict(load_traffic("stream"),
                                             chunk=64, sample=1.0), 1,
                    [{"name": "reads_per_s", "unit": "reads/s"}], [], {})
    return cell, gen, control_results(cell, gen, 5, 128)


def _finish(cell, gen, results, limits):
    cell = run.Cell(cell.name, cell.cfg, cell.traffic, 1, cell.end_to_end,
                    [], limits)
    return run.finish(cell, gen, results, 1.0, 0.0, 0, {}, None, None, None,
                      None, "cpu", 1, False)


def _every(cfg, limit=1e9) -> dict:
    """A limit on each of the judge's numbers for the configuration."""
    return {k: {"limit": limit} for k in sorted(R.number_names(cfg))}


def test_each_limits_key_is_compared(judged):
    """A run compares the keys of its limits file, in the file's order; one
    whose every limit its value passes is correct, and one limit that its
    value passes not makes it not correct."""
    cell, gen, results = judged
    lim = _every(cell.cfg)
    out, lines = _finish(cell, gen, results, lim)
    assert list(out["checks"]) == list(lim) and out["correct"], lines
    out, lines = _finish(cell, gen, results,
                         dict(lim, gapped_below_pct={"limit": 15.0}))
    assert not out["correct"], lines


@pytest.mark.parametrize("key", sorted(R.number_names(
    tiny_config("tiny_se100"))))
def test_a_number_without_a_limit_fails(judged, key):
    """A limits file that leaves out one of the judge's numbers fails the
    run with a line that names it, and the number is still reported."""
    cell, gen, results = judged
    lim = _every(cell.cfg)
    del lim[key]
    out, lines = _finish(cell, gen, results, lim)
    assert not out["correct"]
    assert out["checks"][key]["limit"] is None
    assert out["checks"][key]["value"] is not None
    assert any(key in ln and "no limit" in ln for ln in lines), lines


@pytest.mark.parametrize("key", ["no_such_number", "pair_below_pct"])
def test_a_limits_key_the_judge_does_not_give_fails(judged, key):
    """An unknown key, or a paired number on an unpaired cell, fails the
    run with a line that names it, whatever its limit."""
    cell, gen, results = judged
    lim = dict(_every(cell.cfg), **{key: {"limit": 1e9}})
    out, lines = _finish(cell, gen, results, lim)
    assert not out["correct"]
    assert out["checks"][key]["value"] is None
    assert any(key in ln and "no such number" in ln for ln in lines), lines


def test_a_share_of_nothing_fails(judged):
    """repeat_xs_pct over a sample with no repeat read has base 0: the
    run fails, as a run that judged no repeat read did before."""
    cell, gen, results = judged
    judge = R.Judge(cell.cfg, gen)
    lone = [dict(r, samples=[s for s in r["samples"]
                             if not judge.siblings(s["truth"][0])])
            for r in results]
    out, lines = _finish(cell, gen, lone, _every(cell.cfg))
    assert not out["correct"]
    assert [ln for ln in lines if "share of nothing" in ln] == \
        ["checks: repeat_xs_pct is a share of nothing: the sample held no "
         "case of it"], lines


@pytest.mark.parametrize("config", ["tiny_se100", "tiny_pe150"])
def test_number_names_are_what_a_run_compares(judged, config):
    """number_names() lists exactly the numbers run.finish can compare for
    the configuration: a limits file naming each is fully judged."""
    cell, gen, results = judged
    names = R.number_names(tiny_config(config))
    unpaired = {"unanswered", "field_faults", "below_pct",
                "gapped_below_pct", "repeat_xs_pct"}
    assert names == (unpaired | {"pair_faults", "pair_below_pct"}
                     if config == "tiny_pe150" else unpaired)
    if config == "tiny_se100":
        out, lines = _finish(cell, gen, results, _every(cell.cfg))
        assert out["correct"] and set(out["checks"]) == names, lines


def test_a_paired_cell_is_added_by_files_and_entries(tmp_path, monkeypatch):
    """A copy of the harness's data with the tiny paired configuration and
    a limits file added, and a BENCHMARK.json that only appends its
    configuration and cell: the cell resolves with reads_per_s and
    setup_s, two records a row and its own checks."""
    data = tmp_path / "portbench"
    for d in ("configs", "limits", "traffic"):
        shutil.copytree(run.HERE / d, data / d)
    shutil.copy(TESTS / "tiny_pe150.json", data / "configs")
    shutil.copy(TESTS / "tiny_pe150.stream.json",
                data / "limits" / "tiny_pe150.stream.json")
    monkeypatch.setattr(run, "HERE", data)
    monkeypatch.setattr(traffic, "HERE", data)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    grown = json.loads(json.dumps(bench))
    grown["configs"].append({
        "name": "tiny_pe150", "source": "https://example.org/tiny",
        "file": "portbench/configs/tiny_pe150.json", "reduced": [],
        "why": "a tiny paired configuration"})
    grown["workloads"].append({
        "name": "tiny_pe150.stream", "config": "tiny_pe150",
        "traffic": "stream", "chips": 1, "why": "pairs streamed"})
    assert {k: v for k, v in grown.items()
            if k not in ("configs", "workloads")} == \
        {k: v for k, v in bench.items() if k not in ("configs", "workloads")}
    cell = run.resolve_cell(grown, "tiny_pe150.stream")
    assert {m["name"] for m in cell.end_to_end} == {"reads_per_s", "setup_s"}
    assert traffic.records_per_row(cell.cfg) == 2
    assert set(cell.limits) == R.number_names(cell.cfg)
