"""The reader of the server's column share (`server.column_sam_pct`,
`srv.sam`'s `columns` over its `mates`): on spans made by hand, where
`srv.sam` spans without the counts (a program before them) read nothing;
and on whole traced CPU runs of the tiny unpaired and paired cells, which
read it and stay correct."""
import json
import time

import pytest

from portbench import probes, run

from tinycells import served_small, tiny_cell

NAME = "server.column_sam_pct"


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


def test_reader_reads_hand_made_spans(trace):
    mod = probes.load_reader(NAME)
    assert mod.PROBES == {}
    trace.enable()
    t0 = time.time()
    for columns, mates in ((900, 1000), (3000, 4000)):
        with trace.span("srv.sam") as sp:
            sp.set(mates=mates, columns=columns)
    t1 = time.time()
    assert mod.read({}, Slice(t0, t1)) == pytest.approx(78.0)
    # spans without the counts, as a program before them records
    with trace.span("srv.sam"):
        pass
    assert mod.read({}, Slice(t1, time.time())) is None
    assert mod.read({}, Slice(t0, time.time())) == pytest.approx(78.0)


def packs_of_64(served):
    served.srv.batch_size = 64


@pytest.mark.parametrize("config,hook", [("tiny_se100", served_small),
                                         ("tiny_pe150", packs_of_64)],
                         ids=["unpaired", "paired"])
def test_a_traced_cpu_run_reads_the_column_share(trace, config, hook):
    b = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = tiny_cell(config, "stream")
    if config == "tiny_pe150":
        cell.traffic = dict(cell.traffic, warmup_rows=128, in_flight=512)
    cell.per_layer = [m for m in b["per_layer"] if m["name"] == NAME]
    assert len(cell.per_layer) == 1
    out, lines = run.run_cell(cell, 2**31 + 29, 12, True, device="cpu",
                              hook=hook)
    assert out["correct"], lines[-12:]
    assert NAME in out["metrics"], lines[-12:]
    got = out["metrics"][NAME]["value"]
    # most reads are committed on the fast paths and written from columns
    assert 50 <= got <= 100, got
