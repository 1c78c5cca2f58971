"""The readers of the paired aligner's spans (`paired.*`,
`portbench/pairspans.py`): on spans made by hand, where a program
without the spans reads nothing; and on a whole traced CPU run of
the tiny paired cell, which reads all four and is correct under every
limit of tiny_pe150.stream.json, `repeat_xs_pct` among them."""
import json
import time

import pytest

from portbench import probes, reference, run

from tinycells import tiny_cell

PAIRED_METRICS = ("paired.align_ms_per_kread", "paired.decide_ms_per_kread",
                  "paired.rescue_ms_per_kread", "paired.fast_pair_pct")


@pytest.fixture
def trace():
    from bowtie2_server_tpu_torch.utils import trace
    trace.disable()
    yield trace
    trace.disable()


def packs_of_64(served):
    """Hook: packs of 64 pairs, so that a CPU server ends pair batches
    inside the traced slice even when its cores are shared."""
    served.srv.batch_size = 64


class Slice:
    """The reader's context: the traced slice's ends."""
    def __init__(self, t_start, t_stop):
        self.t_start, self.t_stop = t_start, t_stop


def pair_batches(trace, n):
    """n pe.wait spans of 1024 pairs, each with pe.fast, pe.rescue and
    pe.decide inside; the slice that holds them."""
    t_start = time.time()
    for _ in range(n):
        with trace.span("pe.wait", reads=2048):
            with trace.span("pe.fast", pairs=1024, fast=768):
                time.sleep(0.002)
            with trace.span("pe.rescue", jobs=40, hits=30):
                time.sleep(0.002)
            with trace.span("pe.decide", pairs=256, cp=200, dp=6, up=50):
                time.sleep(0.004)
    return Slice(t_start, time.time())


@pytest.mark.parametrize("name", PAIRED_METRICS)
def test_readers_read_hand_made_spans(trace, name):
    """Each reader over three batches; a stage span outside any pe.wait
    counts nothing; a slice without the spans (a program without them)
    reads nothing."""
    mod = probes.load_reader(name)
    assert mod.PROBES == {}
    trace.enable()
    ctx = pair_batches(trace, 3)
    got = mod.read({}, ctx)
    if name == "paired.fast_pair_pct":
        assert got == pytest.approx(75.0)
    else:
        span = {"align": "pe.wait", "decide": "pe.decide",
                "rescue": "pe.rescue"}[name.split(".")[1].split("_")[0]]
        want = sum(s.s for s in trace.spans(ctx.t_start, ctx.t_stop)
                   if s.name == span) * 1e3 / (3 * 2048 / 1e3)
        assert got == pytest.approx(want)
        t0 = time.time()
        with trace.span(span, reads=2048, jobs=1, hits=1):
            time.sleep(0.002)
        with trace.span("pe.wait", reads=2048):
            pass
        assert mod.read({}, Slice(t0, time.time())) == \
            (0.0 if span != "pe.wait" else pytest.approx(
                sum(s.s for s in trace.spans(t0) if s.name == span)
                * 1e3 / (2 * 2048 / 1e3)))
    assert mod.read({}, Slice(ctx.t_stop + 1, ctx.t_stop + 2)) is None


def test_a_traced_paired_cpu_run_reads_the_paired_metrics(trace):
    b = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = tiny_cell("tiny_pe150", "stream")
    cell.traffic = dict(cell.traffic, warmup_rows=128, in_flight=512)
    cell.per_layer = [m for m in b["per_layer"]
                      if m["name"] in PAIRED_METRICS]
    assert len(cell.per_layer) == len(PAIRED_METRICS)
    out, lines = run.run_cell(cell, 2**31 + 23, 8, True, device="cpu",
                              hook=packs_of_64)
    c = out["checks"]
    assert set(c) == set(cell.limits) == reference.number_names(cell.cfg)
    for k, v in c.items():
        assert v["value"] <= v["limit"], (k, lines[-12:])
    assert out["correct"], lines[-12:]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == set(PAIRED_METRICS)
    assert 0 <= got["paired.fast_pair_pct"] <= 100
    # decisions and rescue run inside the wait
    assert got["paired.align_ms_per_kread"] >= \
        got["paired.decide_ms_per_kread"] + \
        got["paired.rescue_ms_per_kread"] > 0
