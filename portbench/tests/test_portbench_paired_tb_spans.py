"""The reader of the paired decisions' traceback share
(`paired.card_traceback_pct`, `pe.decide`'s `tb_card` over its `tb`): on
spans made by hand, with and without the counts a program may lack, and on
a whole traced CPU run of the tiny paired cell, where the CPU runs every
traceback on the host."""
import json
import time

import pytest

from portbench import probes, run

from tinycells import tiny_cell

NAME = "paired.card_traceback_pct"


@pytest.fixture
def trace():
    from bowtie2_server_tpu_torch.utils import trace
    trace.disable()
    trace.enable()
    yield trace
    trace.disable()


class Slice:
    """The reader's context: the traced slice's ends."""
    def __init__(self, t_start, t_stop):
        self.t_start, self.t_stop = t_start, t_stop


def decide_spans(trace, attrs, inside=True):
    """One pe.decide span with each of `attrs`, each inside a pe.wait span
    of 2048 mates (or after it, inside=False); the slice that holds them."""
    t0 = time.time()
    for a in attrs:
        with trace.span("pe.wait", reads=2048):
            if inside:
                with trace.span("pe.decide", pairs=256, cp=200, dp=6, up=50,
                                **a):
                    time.sleep(0.001)
        if not inside:
            with trace.span("pe.decide", pairs=256, **a):
                time.sleep(0.001)
    return Slice(t0, time.time())


@pytest.mark.parametrize("case", ["counted", "parent", "no_traceback",
                                  "outside_wait"])
def test_reader_reads_decide_counts(trace, case):
    """100 x tb_card over tb of the pe.decide spans inside a pe.wait; None
    where the spans carry no counts (a program without them), count no
    traceback, or lie outside every pe.wait."""
    mod = probes.load_reader(NAME)
    assert mod.PROBES == {}
    counted = [dict(tb=80, tb_held=80, tb_card=79, launched=82),
               dict(tb=20, tb_held=19, tb_card=19, launched=19)]
    attrs = {"counted": counted, "parent": [{}, {}],
             "no_traceback": [dict(tb=0, tb_held=0, tb_card=0, launched=0)],
             "outside_wait": counted}[case]
    ctx = decide_spans(trace, attrs, inside=case != "outside_wait")
    got = mod.read({}, ctx)
    assert got == (pytest.approx(98.0) if case == "counted" else None)
    assert mod.read({}, Slice(ctx.t_stop + 1, ctx.t_stop + 2)) is None


def test_a_traced_paired_cpu_run_reads_the_share(trace):
    """On the CPU the oracle runs every traceback: the share reads 0."""
    b = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = tiny_cell("tiny_pe150", "stream")
    cell.traffic = dict(cell.traffic, warmup_rows=128, in_flight=512)
    cell.per_layer = [m for m in b["per_layer"] if m["name"] == NAME]
    assert len(cell.per_layer) == 1

    def packs_of_64(served):
        served.srv.batch_size = 64

    out, lines = run.run_cell(cell, 2**31 + 29, 8, True, device="cpu",
                              hook=packs_of_64)
    assert out["correct"], lines[-12:]
    assert set(out["metrics"]) == {NAME}
    assert out["metrics"][NAME]["value"] == 0
