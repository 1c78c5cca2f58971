"""The paired decisions' band tracebacks traced together (the port's
PairedAligner: `_hold_traces` before the `pe.decide` loop traces, one
`trace_candidates` call a mate, the candidates `_decide` commits first, and
`finish_candidate` commits their traces): on the benchmark's tiny paired
configuration (portbench/tests/tiny_pe150.json), 2000 simulated pairs
through the server's row path give the same SAM records and the same --met
traceback counts with the traces held as with none held, the batches take
nearly every traceback of the decisions, and no candidate is traced twice.
On a card (skipped without one; this file imports no JAX, so there run it
with
    python -m pytest --noconftest tests/test_torch_paired_tb.py -q
) the held traces are the CUDA kernel's, and the records equal the CPU's."""
import json
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import portbench  # noqa: E402
from portbench import genome as gmod  # noqa: E402
from portbench import run  # noqa: E402
from portbench.traffic import ReadSource  # noqa: E402

TINY = Path(portbench.__file__).resolve().parent / "tests"
N_PAIRS = 2000
SEED = 2**31 + 19


@pytest.fixture(scope="module")
def tiny():
    """The tiny paired configuration's index (built once into the
    harness's cache) and N_PAIRS of its pairs as server rows."""
    from bowtie2_server_tpu_torch.index.bt2_reader import detect_index
    cfg = json.loads((TINY / "tiny_pe150.json").read_text())
    gdir = run.genome_dir(cfg)
    gen = gmod.load_genome(gdir)
    _, loader = detect_index(str(gdir / "genome"))
    idx = loader(str(gdir / "genome"))
    rows, _ = ReadSource(gen, cfg, {"sample": 0.0}, SEED, 0).chunk(N_PAIRS)
    wire = [(f"{k:04X}/1", f[0], f[1], f"{k:04X}/2", f[2], f[3])
            for k, f in rows]
    return idx, wire


@pytest.fixture
def recorder():
    from bowtie2_server_tpu_torch.utils import trace
    trace.disable()
    trace.enable()
    yield trace
    trace.disable()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the traceback kernel has no CPU "
                    "mode")
    return "cuda"


def serve(idx, wire, device, recorder, hold=True):
    """The rows' SAM lines through a new PairedAligner on `device`, its
    --met traceback counters, and the counts of its pe.decide span.
    hold=False: `_hold_traces` chooses no candidate (it is told every pair
    took the fast path), so the decisions hold no traces and each
    traceback runs alone, in finish_candidate."""
    from bowtie2_server_tpu_torch.align.paired import PairedAligner
    from bowtie2_server_tpu_torch.server.bt2srv import _align_rows
    pal = PairedAligner(idx, device=device)
    if not hold:
        choose = pal._hold_traces
        pal._hold_traces = (lambda st1, st2, fastcp, *a:
                            choose(st1, st2, np.ones_like(fastcp), *a))
    t0 = time.time()
    lines = _align_rows(pal.up, pal, wire, idx.ref_names)
    dec = [s for s in recorder.spans(t0) if s.name == "pe.decide"]
    assert len(dec) == 1
    counts = {k: dec[0].attrs[k]
              for k in ("pairs", "tb", "tb_card", "launched")}
    return lines, dict(pal.up.bt_ctr), counts


def test_held_traces_give_the_same_records(tiny, recorder):
    """The SAM lines (flag, POS, CIGAR, MD:Z, NM:i, AS:i, XS:i, MAPQ,
    YT:Z, TLEN and the rest) and the Bt/BtCell/BtSucc/BtFail counts are
    those of the decisions without held traces; the batches took problems
    at least 95% of the decisions' tracebacks in number, none without held
    traces, and on the CPU none ran on a kernel."""
    idx, wire = tiny
    got, ctr, n = serve(idx, wire, "cpu", recorder)
    want, ctr0, n0 = serve(idx, wire, "cpu", recorder, hold=False)
    assert got == want
    assert sum(l.startswith("@CO END READ") for l in got) == N_PAIRS
    assert ctr == ctr0
    assert n["tb"] == n0["tb"] == ctr["bt"] >= 40, (n, ctr)
    assert n["pairs"] == n0["pairs"] > 100
    assert n["launched"] >= 0.95 * n["tb"]
    assert n["launched"] > 0 and n["tb_card"] == 0
    assert n0["launched"] == 0


def test_each_candidate_traced_once(tiny, recorder, monkeypatch):
    """Every band problem sent to `banded_traceback_batch` is one
    candidate's trace held in its state, so no candidate is traced twice
    however often it is committed, and the problems number at most the
    --met Bt count (a commit attempt of a traced candidate)."""
    from bowtie2_server_tpu_torch.align import pipeline as tpipe
    idx, wire = tiny
    sent, states = [], {}
    batch, trace_candidates = (tpipe.banded_traceback_batch,
                               tpipe.UnpairedAligner.trace_candidates)

    def counted(rd, mm, band, lens, *a, **k):
        sent.append(len(lens))
        return batch(rd, mm, band, lens, *a, **k)

    def kept(self, st, cis, scores):
        states[id(st)] = st
        return trace_candidates(self, st, cis, scores)

    monkeypatch.setattr(tpipe, "banded_traceback_batch", counted)
    monkeypatch.setattr(tpipe.UnpairedAligner, "trace_candidates", kept)
    _, ctr, n = serve(idx, wire, "cpu", recorder)
    held = sum(tr.tb and st.fin_info[ci][0] == "band"
               for st in states.values() for ci, tr in st.traces.items())
    assert len(states) == 2
    assert sum(sent) == held >= n["launched"] > 0
    assert sum(sent) <= ctr["bt"], (sent, ctr)


def test_card_holds_the_kernels_traces(tiny, recorder, cuda_device):
    """On the card: the records and the traceback counts of the CPU
    oracle's run on the same pairs, and at least 95% of the decisions'
    tracebacks ran on the kernel."""
    idx, wire = tiny
    got, ctr, n = serve(idx, wire, cuda_device, recorder)
    want, ctr0, _ = serve(idx, wire, "cpu", recorder)
    assert got == want
    assert ctr == ctr0
    assert n["tb"] >= 40 and n["tb_card"] >= 0.95 * n["tb"], n
