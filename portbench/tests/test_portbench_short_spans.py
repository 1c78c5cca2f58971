"""The readers of the general short-read shape's spans and of the mesh's
shard spans (`candgen.short_read_pct`, `aligner.escalate_ms_per_kread`,
`kernels.fm_ms_per_kread`, `mesh.shard_enqueue_ms`): each loads by name,
reads spans made by hand (and the FM one a synthetic device trace), reads
nothing where the spans or kernels are absent or carry no counts (a
program before them), the program-span ones read a whole traced CPU run
of the tiny 36 bp cell, and the shard reader one over a mesh of four
logical CPU shards."""
import json
import time
from types import SimpleNamespace

import pytest

from portbench import probes, run

from tinycells import served_small, tiny_cell

NAMES = ("candgen.short_read_pct", "aligner.escalate_ms_per_kread",
         "kernels.fm_ms_per_kread", "mesh.shard_enqueue_ms")


@pytest.fixture
def trace():
    from bowtie2_server_tpu_torch.utils import trace
    trace.disable()
    yield trace
    trace.disable()


class Slice:
    """The reader's context: the traced slice's ends, and a device trace
    (None: the run had none)."""
    def __init__(self, t_start, t_stop, dev=None):
        self.t_start, self.t_stop, self.trace = t_start, t_stop, dev


def enqueues(trace, attrs, escalate=()):
    """cg.enqueue spans with `attrs` each, then up.escalate spans of the
    given seconds, and the slice that holds them."""
    t0 = time.time()
    for a in attrs:
        with trace.span("cg.enqueue", **a):
            time.sleep(0.001)
    for s in escalate:
        with trace.span("up.escalate", reads=4096, mult=2, host=0):
            time.sleep(s)
    return Slice(t0, time.time())


def test_every_reader_loads_by_name():
    b = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in b["per_layer"]}
    for name in NAMES:
        mod = probes.load_reader(name)
        assert mod.PROBES == {} and callable(mod.read)
        assert len(listed[name]["workloads"]) == 1


@pytest.mark.parametrize("case", ["mixed", "parent", "none"])
def test_short_read_pct_reads_enqueue_counts(trace, case):
    """100 x the short enqueues' reads over all enqueued reads; None where
    the spans carry no counts or there are none."""
    mod = probes.load_reader("candgen.short_read_pct")
    attrs = {"mixed": [dict(reads=4096, short=1), dict(reads=1024, short=0),
                       dict(reads=3072, short=1)],
             "parent": [{}, {}], "none": []}[case]
    ctx = enqueues(trace, attrs)
    assert mod.read({}, ctx) == (100.0 * 7168 / 8192 if case == "mixed"
                                 else None)


@pytest.mark.parametrize("case", ["escalated", "calm", "parent"])
def test_escalate_ms_per_kread_reads_escalate_spans(trace, case):
    """The up.escalate spans' ms over the thousands of enqueued reads: 0
    where the enqueues count their reads and nothing escalated, None
    where they carry no counts."""
    mod = probes.load_reader("aligner.escalate_ms_per_kread")
    counted = [dict(reads=4096, short=1)] * 2
    ctx = enqueues(trace, [{}, {}] if case == "parent" else counted,
                   (0.004, 0.002) if case == "escalated" else ())
    got = mod.read({}, ctx)
    if case == "parent":
        assert got is None
    elif case == "calm":
        assert got == 0.0
    else:
        esc = [s for s in trace.spans(ctx.t_start, ctx.t_stop)
               if s.name == "up.escalate"]
        assert got == pytest.approx(sum(s.s for s in esc) * 1e3 / 8.192)
        assert got > 0


def test_fm_ms_per_kread_reads_a_synthetic_trace(trace):
    """The device time of the FM walk and LF-step launches that started in
    the slice, on any card, over the thousands of enqueued reads; other
    kernels (the resolve walk-left among them) and launches before the
    slice do not count. None without a trace, without FM launches, or
    without counted enqueues."""
    mod = probes.load_reader("kernels.fm_ms_per_kread")
    ctx = enqueues(trace, [dict(reads=4096, short=1),
                           dict(reads=4096, short=1)])
    origin = ctx.t_start - 10.0
    lo = (ctx.t_start - origin) * 1e6
    events = [
        ("void fm_walk_kernel<int>(Fm<int>, int const*)", 0, lo + 5,
         lo + 45),
        ("void fm_lf_step_kernel<int>(Fm<int>, int const*)", 1, lo + 50,
         lo + 70),
        ("void fm_walk_kernel<int>(Fm<int>, int const*)", 0, lo - 30,
         lo - 1),                                   # before the slice
        ("fm_resolve_kernel", 0, lo + 80, lo + 180),
        ("void banded_kernel<64>(...)", 0, lo + 200, lo + 900),
    ]
    dev = SimpleNamespace(origin=origin, t_start=ctx.t_start,
                          t_stop=ctx.t_stop, events=events)
    got = mod.read({}, Slice(ctx.t_start, ctx.t_stop, dev))
    assert got == pytest.approx((40 + 20) / 1e3 / 8.192)
    assert mod.read({}, Slice(ctx.t_start, ctx.t_stop)) is None
    no_fm = SimpleNamespace(origin=origin, t_start=ctx.t_start,
                            t_stop=ctx.t_stop, events=events[3:])
    assert mod.read({}, Slice(ctx.t_start, ctx.t_stop, no_fm)) is None
    parent = enqueues(trace, [{}, {}])
    dev_p = SimpleNamespace(origin=origin, t_start=parent.t_start,
                            t_stop=parent.t_stop, events=events)
    assert mod.read({}, Slice(parent.t_start, parent.t_stop, dev_p)) is None


def test_shard_enqueue_ms_reads_shard_spans(trace):
    mod = probes.load_reader("mesh.shard_enqueue_ms")
    trace.enable()
    t0 = time.time()
    for s in range(4):
        with trace.span("cg.shard", shard=s, reads=1024):
            time.sleep(0.001 * (s + 1))
    ctx = Slice(t0, time.time())
    spans = trace.spans(ctx.t_start, ctx.t_stop)
    assert mod.read({}, ctx) == pytest.approx(
        sum(s.s for s in spans) * 1e3 / 4)
    assert mod.read({}, Slice(ctx.t_stop + 1, ctx.t_stop + 2)) is None


def test_a_traced_cpu_run_of_the_tiny_36bp_cell(trace):
    """Every dispatch of 36 bp reads is short, nothing escalates, each
    dispatch enqueues its one shard on the CPU; no device trace, so the
    FM reader reads nothing. Every read is answered and no record is at
    fault (how many gapped reads a short CPU window samples depends on
    the machine's load, so the shares' limits are not held here)."""
    b = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = tiny_cell("tiny_se36", "stream")
    cell.per_layer = [m for m in b["per_layer"] if m["name"] in NAMES]
    assert len(cell.per_layer) == len(NAMES)
    out, lines = run.run_cell(cell, 2**31 + 36, 6, True, device="cpu",
                              hook=served_small)
    assert out["checks"]["unanswered"]["value"] == 0, lines
    assert out["checks"]["field_faults"]["value"] == 0, lines
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == set(NAMES) - {"kernels.fm_ms_per_kread"}
    assert got["candgen.short_read_pct"] == 100.0
    assert got["aligner.escalate_ms_per_kread"] == 0.0
    assert got["mesh.shard_enqueue_ms"] > 0


def test_a_traced_cpu_run_over_a_mesh_reads_shard_enqueues(trace,
                                                           monkeypatch):
    """The x4 cell's path on the CPU: the server's one worker over a mesh
    of four logical CPU shards (the device groups of four cards), the
    tiny E. coli cell correct, and `mesh.shard_enqueue_ms` read from the
    four shards' spans."""
    import torch
    from bowtie2_server_tpu_torch.parallel.mesh import Mesh
    from bowtie2_server_tpu_torch.server import dispatch
    monkeypatch.setattr(dispatch, "make_device_groups",
                        lambda n, device: [Mesh([torch.device("cpu")] * 4)])
    b = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = tiny_cell("tiny_se100", "stream")
    cell.per_layer = [m for m in b["per_layer"]
                      if "ecoli_se100.stream.x4" in m["workloads"]]
    assert [m["name"] for m in cell.per_layer] == ["mesh.shard_enqueue_ms"]
    t0 = time.time()
    out, lines = run.run_cell(cell, 2**31 + 44, 6, True, device="cpu",
                              hook=served_small)
    assert out["correct"], lines
    assert out["metrics"]["mesh.shard_enqueue_ms"]["value"] > 0
    shards = [s for s in trace.spans(t0) if s.name == "cg.shard"]
    assert {s.attrs["shard"] for s in shards} == {0, 1, 2, 3}
