"""The readers of the unpaired aligner's `up.select` spans
(`aligner.select_ms_per_kread`, `aligner.card_traceback_pct`): on spans made
by hand, with and without the traceback counts a program may lack, and on a
whole traced CPU run of the tiny cell."""
import json
import time

import pytest

from portbench import run

from tinycells import served_small, tiny_cell

SELECT_METRICS = ("aligner.select_ms_per_kread", "aligner.card_traceback_pct")


@pytest.fixture
def trace():
    from bowtie2_server_tpu_torch.utils import trace
    trace.disable()
    yield trace
    trace.disable()


class Slice:
    """The reader's context: the traced slice's ends."""
    def __init__(self, t_start, t_stop):
        self.t_start, self.t_stop = t_start, t_stop


def select_spans(trace, attrs):
    """up.select spans of 4096 reads each with `attrs`, and the slice that
    holds them."""
    t0 = time.time()
    for a in attrs:
        with trace.span("up.select", reads=4096, slow=40, **a):
            time.sleep(0.001)
    return Slice(t0, time.time())


@pytest.mark.parametrize("case", ["counted", "parent", "no_traceback"])
def test_card_traceback_pct_reads_select_counts(trace, case):
    """aligner.card_traceback_pct: 100 x tb_card over tb; None where the
    spans carry no counts (a program without them) or count none."""
    mod = run.probes.load_reader("aligner.card_traceback_pct")
    attrs = {"counted": [dict(tb=50, tb_card=49), dict(tb=48, tb_card=48)],
             "parent": [{}, {}],
             "no_traceback": [dict(tb=0, tb_card=0)]}[case]
    ctx = select_spans(trace, attrs)
    got = mod.read({}, ctx)
    assert got == (100.0 * 97 / 98 if case == "counted" else None)


def test_select_ms_per_kread_reads_select_spans(trace):
    """aligner.select_ms_per_kread: the up.select spans' ms over their
    thousands of reads, with or without the traceback counts."""
    mod = run.probes.load_reader("aligner.select_ms_per_kread")
    ctx = select_spans(trace, [dict(tb=3, tb_card=3), {}])
    spans = [s for s in trace.spans(ctx.t_start, ctx.t_stop)
             if s.name == "up.select"]
    want = sum(s.s for s in spans) * 1e3 / 8.192
    assert mod.read({}, ctx) == pytest.approx(want)
    assert mod.read({}, Slice(ctx.t_stop + 1, ctx.t_stop + 2)) is None


def test_a_traced_cpu_run_reads_the_select_metrics(trace):
    """On the CPU every traceback runs on the host: the share the card ran
    is 0, and the select time is read."""
    b = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = tiny_cell("tiny_se100", "stream")
    cell.per_layer = [m for m in b["per_layer"] if m["name"] in SELECT_METRICS]
    assert len(cell.per_layer) == len(SELECT_METRICS)
    out, lines = run.run_cell(cell, 2**31 + 17, 8, True, device="cpu",
                              hook=served_small)
    assert out["correct"], lines
    got = out["metrics"]
    assert set(got) == set(SELECT_METRICS)
    assert got["aligner.select_ms_per_kread"]["value"] > 0
    assert got["aligner.card_traceback_pct"]["value"] == 0
