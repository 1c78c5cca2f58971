"""36 bp single-end reads served on the CPU the way the server serves a
pack (`bt2srv._align_rows`: the aligner, then the SAM emitter), on a tiny
genome shaped like the benchmark's fly ChIP-seq configuration
(`portbench/tests/tiny_se36.json`: three sequences, a transposable-element
family at 0-2% and INE-1 at 5-20%), so that every dispatch takes the
general short-read shape (FM walks): the plain reference
(`portbench.reference.Judge`, which imports neither JAX nor the port)
finds no field fault and a below-the-origin share within the cell's limit;
the records equal the JAX package's `UnpairedAligner`'s, field for field,
so that the cell's loose 36 bp readings are the reference's seed
heuristic and not a fault of the port; every enqueue says short; and a
capacity overflow forced by shrinking a capacity records `up.escalate`
with the multiple it ended at and the reads the host path took."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

from bowtie2_server_tpu.align.pipeline import (  # noqa: E402
    SearchPolicy as JPolicy, UnpairedAligner as JAligner)
from bowtie2_server_tpu.index.build import build_index  # noqa: E402
from bowtie2_server_tpu.io.fastq import make_batch as j_make_batch  # noqa
from bowtie2_server_tpu.io.sam import sam_record as j_sam  # noqa: E402
from bowtie2_server_tpu.utils.presets import (  # noqa: E402
    preset_params as j_preset_params)
from bowtie2_server_tpu_torch import native  # noqa: E402
from bowtie2_server_tpu_torch.align import candgen as tcg  # noqa: E402
from bowtie2_server_tpu_torch.align.pipeline import (  # noqa: E402
    SearchPolicy, UnpairedAligner)
from bowtie2_server_tpu_torch.index.fm import FmIndex  # noqa: E402
from bowtie2_server_tpu_torch.server import bt2srv  # noqa: E402
from bowtie2_server_tpu_torch.utils import trace  # noqa: E402
from bowtie2_server_tpu_torch.utils.presets import preset_params  # noqa
from portbench import genome as gmod  # noqa: E402
from portbench.reference import Judge, numbers  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_READS = 600
PACK = 256          # the test server's pack: three packs, the last partial
MIN_BASE = 100      # a share is held to its limit only over this many reads


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The tiny configuration's genome, its index (built by the JAX
    package, loaded by the port) and N_READS simulated reads as the
    server receives them (name, seq, qual, and no mate), with their
    truth."""
    cfg = json.loads((ROOT / "portbench" / "tests"
                      / "tiny_se36.json").read_text())
    assert cfg["reads"]["length"] == 36 and not cfg["reads"]["paired"]
    gen = gmod.make_genome(cfg)
    jidx = build_index(gen.fasta().decode())
    d = tmp_path_factory.mktemp("torch_short_served")
    jidx.save(d / "genome")
    m = gmod.simulate_unpaired(gen, cfg["reads"],
                               np.random.default_rng(2**31 + 36), N_READS)
    qual = bytes([gmod.quality_char(cfg["reads"])]) * 36
    rows = [(f"r{k}", gmod.BASES[m.codes[k]].tobytes(), qual, None, None,
             None) for k in range(N_READS)]
    truths = [{"codes": m.codes[k].tobytes().hex(), "chrom": int(m.chrom[k]),
               "start": int(m.start[k]), "span": int(m.span[k]),
               "fw": bool(m.fw[k])} for k in range(N_READS)]
    return cfg, gen, jidx, FmIndex.load(d / "genome"), rows, truths


def _aligner(tidx):
    """The server's unpaired aligner on the CPU: its default preset."""
    sc, pol = preset_params(None, False)
    return UnpairedAligner(tidx, scoring=sc, policy=SearchPolicy(**pol),
                           device="cpu")


def _serve(up, rows, ref_names) -> list[str]:
    """The packs' lines as the server writes them, END READ markers in."""
    out = []
    for lo in range(0, len(rows), PACK):
        out += bt2srv._align_rows(up, None, rows[lo : lo + PACK], ref_names)
    return out


def _records(lines) -> list[list[str]]:
    """Each read's records, from the lines before its END READ marker."""
    out, cur = [], []
    for ln in lines:
        if ln.startswith("@CO END READ\t"):
            out.append(cur)
            cur = []
        else:
            cur.append(ln)
    assert cur == []
    return out


def test_served_short_reads_judged_and_equal_to_jax(served):
    cfg, gen, jidx, tidx, rows, truths = served
    up = _aligner(tidx)
    trace.disable()
    trace.enable()
    try:
        lines = _serve(up, rows, tidx.ref_names)
        spans = trace.spans()
    finally:
        trace.disable()
    recs = _records(lines)
    assert [len(r) for r in recs] == [1] * N_READS

    # every dispatch of 36 bp reads takes the general short-read shape
    enq = [s for s in spans if s.name == "cg.enqueue"]
    assert len(enq) == -(-N_READS // PACK)
    assert all(s.attrs["short"] == 1 for s in enq)
    assert sum(s.attrs["reads"] for s in enq) == N_READS
    assert not [s for s in spans if s.name == "up.escalate"]
    # the general shape's packs stay in the column emitter: each pack's
    # aligned reads come from the column store, but for those the
    # per-read selection loop finished (`slow`) and the gapped winners
    # (traced: `tb`), which sam_record renders; the emitter writes the
    # unaligned reads itself and counts them in no column
    if native.get_lib() is not None:
        sams = [s for s in spans if s.name == "srv.sam"]
        sels = [s for s in spans if s.name == "up.select"]
        assert len(sams) == len(sels) == len(enq)
        for k, (sam, sel) in enumerate(zip(sams, sels)):
            aligned = sum(int(r[0].split("\t")[1]) & 4 == 0
                          for r in recs[k * PACK : (k + 1) * PACK])
            assert sam.attrs["mates"] == sel.attrs["reads"]
            assert aligned - sel.attrs["slow"] - sel.attrs["tb"] \
                <= sam.attrs["columns"] <= aligned

    # the JAX package's aligner writes the same records
    sc, pol = j_preset_params(None, False)
    jal = JAligner(jidx, scoring=sc, policy=JPolicy(**pol))
    want = []
    for lo in range(0, N_READS, PACK):
        part = rows[lo : lo + PACK]
        jrecs = jal.align_batch(j_make_batch([r[0] for r in part],
                                             [r[1] for r in part],
                                             [r[2] for r in part]))
        want += [j_sam(jrecs[i], jidx.ref_names) for i in range(len(part))]
    assert [r[0] for r in recs] == want

    # the plain reference: no field fault, and each share held to the
    # dm6_se36.stream cell's limit where it is over enough reads
    verdict = Judge(cfg, gen).judge(
        [{"key": k, "truth": [t], "records": r}
         for k, (t, r) in enumerate(zip(truths, recs))])
    assert verdict["field_faults"] == 0, verdict["faults"]
    assert verdict["missing"] == 0 and verdict["judged"] >= MIN_BASE
    # 36 bp reads: three seeds of 22 at 0, 7 and 14 leave reads with two
    # errors unfound, but most reads align
    assert 0 < verdict["below"] < 0.3 * verdict["judged"]
    limits = json.loads((ROOT / "portbench" / "limits"
                         / "dm6_se36.stream.json").read_text())
    held = 0
    for name, (value, base) in numbers(verdict).items():
        if base is None:
            assert value <= limits[name]["limit"], name
        elif base >= MIN_BASE:
            assert value <= limits[name]["limit"], (name, value, base)
            held += 1
    assert held >= 1


def _shrunk(monkeypatch, cap: int) -> list:
    """Shrink the pre-dedup element capacity to `cap` times a dispatch's
    size multiple, so that the multiple decides whether it overflows.
    Returns the multiple of each dispatch, in order."""
    mults = []
    dispatch, launch = tcg.CandGen.dispatch, tcg.CandGen._launch

    def shrunk_dispatch(self, *a, size_mult: int = 1, **k):
        mults.append(max(size_mult, self._sticky))
        return dispatch(self, *a, size_mult=size_mult, **k)

    def shrunk_launch(self, B0, cfg, *a):
        return launch(self, B0, cfg._replace(C_pre=cap * mults[-1]), *a)

    monkeypatch.setattr(tcg.CandGen, "dispatch", shrunk_dispatch)
    monkeypatch.setattr(tcg.CandGen, "_launch", shrunk_launch)
    return mults


def _demand(up, pack, ref_names):
    """(the pre-dedup elements a pack's dispatch resolves, its C_pre
    counter; the pack's lines), from one unshrunk run."""
    got = []
    fetch = up.candgen.fetch

    def counting(h):
        res = fetch(h)
        got.append(int(res.counters[:, 1].max()))
        return res

    up.candgen.fetch = counting
    try:
        lines = _serve(up, pack, ref_names)
    finally:
        del up.candgen.fetch
    assert len(got) == 1
    return got[0], lines


@pytest.mark.parametrize("case", ["escalates", "from_sticky", "host"])
def test_forced_overflow_records_escalation(served, monkeypatch, case):
    """escalates: the 1x dispatch overflows and the 2x holds, which then
    sticks, so the same pack sent again runs at 2x without escalating;
    from_sticky: at a sticky 2x the pack escalates straight to 4x (the 2x
    it overflowed at is not run again); host: still overflowing at 4x,
    the pack takes the host path. The records equal the unshrunk run's
    wherever the fused pipeline held the pack."""
    cfg, gen, jidx, tidx, rows, truths = served
    pack = rows[:PACK]
    base, want = _demand(_aligner(tidx), pack, tidx.ref_names)
    assert base > 16
    up = _aligner(tidx)
    if case == "from_sticky":
        up.candgen._sticky = 2
    cap = {"escalates": -(-3 * base // 4), "from_sticky": -(-base // 3),
           "host": base // 8}[case]
    mults = _shrunk(monkeypatch, cap)
    trace.disable()
    trace.enable()
    try:
        got = [_serve(up, pack, tidx.ref_names)
               for _ in range(2 if case == "escalates" else 1)]
        esc = [s for s in trace.spans() if s.name == "up.escalate"]
    finally:
        trace.disable()
    assert len(esc) == 1
    (e,) = esc
    assert e.attrs["reads"] == PACK
    if case == "escalates":
        assert mults == [1, 2, 2]
        assert e.attrs == {"reads": PACK, "mult": 2, "host": 0}
        assert got == [want, want]
    elif case == "from_sticky":
        assert mults == [2, 4]
        assert e.attrs == {"reads": PACK, "mult": 4, "host": 0}
        assert got == [want]
    else:
        assert mults == [1, 2, 4]
        assert e.attrs == {"reads": PACK, "mult": 4, "host": PACK}
        assert [len(r) for r in _records(got[0])] == [1] * PACK
