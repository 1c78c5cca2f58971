"""The port's span recorder (bowtie2_server_tpu_torch/utils/trace.py) on the
CPU: off it records nothing, its ring keeps its bound, `spans(t0, t1)`
keeps the spans inside the interval; a round trip to a CPU `Bt2Server`
over the socket gives each pack one queue, pack, records and SAM span,
nested on the worker's thread, whose packs' reads add up to the reads
sent; the fetch spans' interior DP problems equal the `--met` TSV's; a
paired batch gives one `pe.wait` holding its `pe.fast`, `pe.rescue` and
`pe.decide`, whose counts add up to its pairs; an enqueue counts its
reads and its shape, and over a mesh each shard's enqueue is a span of
its own; and -t prints its stage times from the recorder."""
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

from bowtie2_server_tpu_torch.__main__ import main as port_main  # noqa
from bowtie2_server_tpu_torch.index.build import build_index  # noqa: E402
from bowtie2_server_tpu_torch.server import bt2srv  # noqa: E402
from bowtie2_server_tpu_torch.utils import dna, trace  # noqa: E402
from torch_serving import raw_request, serving, tab6_line  # noqa: E402

CHROM_LEN = 30_000
READ_LEN = 100
BATCH = 64          # the test server's pack size: a request spans packs


@pytest.fixture
def recorder():
    """The recorder on, with a ring of its own; off again after."""
    trace.disable()
    trace.enable()
    yield trace
    trace.disable()


def test_off_records_nothing():
    trace.disable()
    before = trace.spans()
    sp = trace.span("x", reads=3)
    assert sp is trace.span("y")
    with sp as s:
        s.set(slow=1)
    trace.record("z", trace.now())
    assert trace.now() == 0
    assert trace.spans() == before
    assert not trace.enabled()


def test_ring_keeps_its_bound():
    trace.disable()
    trace.enable(capacity=8)
    try:
        for k in range(20):
            with trace.span("s", k=k):
                pass
        got = trace.spans()
        assert [s.attrs["k"] for s in got] == list(range(12, 20))
    finally:
        trace.disable()


def test_spans_keeps_the_interval(recorder):
    with trace.span("before"):
        time.sleep(0.002)
    t0 = time.time()
    with trace.span("inside") as sp:
        time.sleep(0.002)
        sp.set(n=1)
    with trace.span("straddles"):
        time.sleep(0.002)
        t1 = time.time()
        time.sleep(0.002)
    with trace.span("after"):
        pass
    names = [s.name for s in trace.spans(t0, t1)]
    assert names == ["inside"]
    (s,) = trace.spans(t0, t1)
    assert s.attrs == {"n": 1} and s.pack is None
    assert 0.002 <= s.s < 1 and 0 <= s.cpu_s <= s.s + 0.01
    assert t0 <= s.t0 < s.t1 <= t1


def test_pack_and_record(recorder):
    """set_pack's identifier rides the spans of its thread; record() closes
    a span another thread opened, with no CPU time."""
    start = trace.now()
    trace.set_pack(7)
    try:
        trace.record("q", start)
        with trace.span("inner"):
            pass
    finally:
        trace.set_pack(None)
    with trace.span("outside"):
        pass
    got = {s.name: s for s in trace.spans()}
    assert got["q"].pack == 7 and got["q"].cpu_s is None
    assert got["q"].attrs == {}
    assert got["inner"].pack == 7 and got["outside"].pack is None


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """Two chromosomes: the codes, the index base and a FASTQ of reads cut
    from them with a few substitutions."""
    rng = np.random.default_rng(5)
    chroms = [rng.integers(0, 4, CHROM_LEN).astype(np.uint8)
              for _ in range(2)]
    d = tmp_path_factory.mktemp("torch_trace")
    fa = d / "genome.fa"
    fa.write_text("".join(f">chr{i}\n{dna.decode(c)}\n"
                          for i, c in enumerate(chroms)))
    build_index(str(fa)).save(str(d / "genome"))
    return chroms, str(d / "genome"), d


def make_reads(chroms, n, seed):
    """n (name, seq, qual) of READ_LEN bp, either strand, 0-3 mismatches."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        c = chroms[k % len(chroms)]
        st = int(rng.integers(0, len(c) - READ_LEN))
        r = c[st : st + READ_LEN].copy()
        for p in rng.choice(READ_LEN, int(rng.integers(0, 4)), False):
            r[p] = (r[p] + 1) % 4
        if k % 2:
            r = (3 - r)[::-1]
        out.append((f"r{k}", dna.decode(r), "I" * READ_LEN))
    return out


def test_server_round_trip_spans(genome, recorder):
    chroms, base, _ = genome
    reads = make_reads(chroms, 2 * BATCH + 22, 1)
    srv = bt2srv.Bt2Server(base, batch_size=BATCH, device="cpu")
    try:
        with serving(srv) as port:
            t0 = time.time()
            _, body = raw_request(port, [tab6_line((n, s, q, None))
                                         for n, s, q in reads])
            t1 = time.time()
    finally:
        srv.close()
    assert body.endswith(b"@CO BT2SRV All Done\n")
    assert body.count(b"@CO END READ\t") == len(reads)
    got = trace.spans(t0, t1)
    parse = [s for s in got if s.name == "srv.parse"]
    assert sum(s.attrs["reads"] for s in parse) == len(reads)
    assert all(s.pack is None for s in parse)
    by_pack: dict = {}
    for s in got:
        if s.pack is not None:
            by_pack.setdefault(s.pack, []).append(s)
    assert len(by_pack) == 3
    reads_in = {}
    for pack, sps in by_pack.items():
        one = {s.name: s for s in sps if s.name.startswith("srv.")}
        assert Counter(s.name for s in sps if s.name.startswith("srv.")) \
            == Counter(["srv.queue", "srv.pack", "srv.records", "srv.sam"])
        q, p, r, m = (one[k] for k in ("srv.queue", "srv.pack",
                                       "srv.records", "srv.sam"))
        # all on the worker's thread, nested in the pack
        assert len({s.thread for s in sps}) == 1
        assert q.t1 <= p.t0 and q.cpu_s is None
        assert p.t0 <= r.t0 <= r.t1 <= m.t0 <= m.t1 <= p.t1
        for s in sps:
            if s is not p and s is not q:
                assert p.t0 <= s.t0 and s.t1 <= p.t1, s.name
        # srv.sam counts the pack's reads and those the native emitter
        # wrote from the column store
        assert r.attrs == {}
        assert m.attrs["mates"] == p.attrs["reads"]
        assert 0 < m.attrs["columns"] <= m.attrs["mates"]
        reads_in[pack] = p.attrs["reads"]
        # the aligner's spans of the pack, inside it
        names = Counter(s.name for s in sps)
        assert names["cg.enqueue"] >= 1 and names["cg.fetch"] >= 1
        # 100 bp reads: the fast shape, every read of the pack enqueued
        assert next(s for s in sps if s.name == "cg.enqueue").attrs == {
            "reads": p.attrs["reads"], "short": 0}
        assert names["up.select"] == 1
        sel = next(s for s in sps if s.name == "up.select")
        assert 0 <= sel.attrs["slow"] <= sel.attrs["reads"] \
            == p.attrs["reads"]
    assert sum(reads_in.values()) == len(reads)
    # the worker waited for packs between requests, outside any pack
    idle = [s for s in trace.spans() if s.name == "srv.idle"]
    assert idle and all(s.pack is None for s in idle)


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_select_counts_tracebacks(genome, recorder, local):
    """up.select's tb counts the batch's traceback passes (the increase of
    the --met Bt counter: the fast commit's and the per-read loop's) and
    tb_card those the CUDA kernel ran, none on the CPU."""
    from bowtie2_server_tpu_torch.align.pipeline import (SearchPolicy,
                                                         UnpairedAligner)
    from bowtie2_server_tpu_torch.index.fm import FmIndex
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.utils.presets import preset_params
    chroms, base, _ = genome
    rng = np.random.default_rng(9)
    reads = make_reads(chroms, 96, 4)
    for k in range(0, len(reads), 3):     # a deletion in one read of three
        n, s, q = reads[k]
        p = int(rng.integers(20, 80))
        reads[k] = (n, s[:p] + s[p + 2 :] + "A" * 2, q)
    sc, pol = preset_params(None, local)
    al = UnpairedAligner(FmIndex.load(base), scoring=sc,
                         policy=SearchPolicy(**pol), device="cpu")
    t0 = time.time()
    for lo in (0, 48):
        al.align_batch(make_batch(*zip(*(
            (n.encode(), s.encode(), q.encode())
            for n, s, q in reads[lo : lo + 48]))))
    sel = [s for s in trace.spans(t0) if s.name == "up.select"]
    assert len(sel) == 2
    assert sum(s.attrs["tb"] for s in sel) == al.bt_ctr["bt"] > 16
    assert all(s.attrs["tb_card"] == 0 for s in sel)


def test_fetch_valid_equals_met_dpex(genome, tmp_path, recorder):
    """cg.fetch's interior problems over a CLI run equal the --met TSV's
    DP16ExDps (DPEx) for the same reads."""
    chroms, base, _ = genome
    reads = make_reads(chroms, 300, 2)
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    t0 = time.time()
    port_main(["align", "-x", base, "-U", str(fq), "-S",
               str(tmp_path / "o.sam"), "--batch", "128", "--met-file",
               str(tmp_path / "met.tsv"), "--met-read", "--device", "cpu"])
    fetches = [s for s in trace.spans(t0) if s.name == "cg.fetch"]
    assert len(fetches) == 3
    lines = (tmp_path / "met.tsv").read_text().splitlines()
    col = lines[0].split("\t").index("DP16ExDps")
    dpex = int(lines[-1].split("\t")[col])
    assert dpex > 0
    assert sum(s.attrs["valid"] for s in fetches) == dpex
    assert all(s.attrs["valid"] <= s.attrs["launched"] for s in fetches)


def test_t_prints_stage_times_and_leaves_recorder_off(genome, tmp_path,
                                                       capsys):
    """-t turns the recorder on for the run and off after it."""
    chroms, base, _ = genome
    reads = make_reads(chroms, 50, 3)
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    trace.disable()
    capsys.readouterr()
    port_main(["align", "-x", base, "-U", str(fq), "-S",
               str(tmp_path / "o.sam"), "-t", "--device", "cpu"])
    err = capsys.readouterr().err
    times = [ln.split(":")[0] for ln in err.splitlines()
             if ln.startswith(("Time ", "Overall time"))]
    assert times == ["Time device_fetch", "Overall time"]
    assert not trace.enabled()


def make_pairs(chroms, n, seed):
    """n FR pairs of READ_LEN bp mates from 250-400 bp fragments, 0-2
    substitutions a mate, mate 1 forward in half of them. Mate 2 of every
    8th pair has a substitution every 16 bases (no seed survives, so mate
    rescue finds it), every 8th (offset 3) has its mates 10 kbp apart
    (discordant), every 8th (offset 5) a random mate 2 (mixed)."""
    rng = np.random.default_rng(seed)
    m1s, m2s = [], []
    for p in range(n):
        c = chroms[p % len(chroms)]
        frag = int(rng.integers(250, 400))
        st = int(rng.integers(0, len(c) - frag - 10_000))
        end2 = st + frag + (10_000 if p % 8 == 3 else 0)
        m1 = c[st : st + READ_LEN].copy()
        m2 = (3 - c[end2 - READ_LEN : end2])[::-1].copy()
        for m in (m1, m2):
            for q in rng.choice(READ_LEN, int(rng.integers(0, 3)), False):
                m[q] = (m[q] + 1) % 4
        if p % 8 == 0:
            at = np.arange(int(rng.integers(0, 16)), READ_LEN, 16)
            m2[at] = (m2[at] + 1) % 4
        elif p % 8 == 5:
            m2 = rng.integers(0, 4, READ_LEN).astype(np.uint8)
        if p % 2:
            m1, m2 = m2, m1
        m1s.append(dna.decode(m1))
        m2s.append(dna.decode(m2))
    return m1s, m2s


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_paired_batch_spans(genome, on):
    """A paired CPU batch: pe.wait counts its mates and holds pe.fast,
    pe.rescue and pe.decide, in that order, on its thread; the fast path's
    pairs and the decisions' CP, DP and UP add up to the pairs, as the
    records' YT:Z says; rescue's hits are at most its jobs. With the
    recorder off the batch records nothing."""
    from bowtie2_server_tpu_torch.align.paired import PairedAligner
    from bowtie2_server_tpu_torch.index.fm import FmIndex
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    chroms, base, _ = genome
    n = 96
    m1s, m2s = make_pairs(chroms, n, 6)
    names = [f"p{k}".encode() for k in range(n)]
    qual = [b"I" * READ_LEN] * n
    pal = PairedAligner(FmIndex.load(base), device="cpu")
    trace.disable()
    if on:
        trace.enable()
    try:
        t0 = time.time()
        pairs = pal.align_batch(
            make_batch(names, [m.encode() for m in m1s], qual),
            make_batch(names, [m.encode() for m in m2s], qual))
        got = [s for s in trace.spans(t0) if s.name.startswith("pe.")]
    finally:
        trace.disable()
    if not on:
        assert got == []
        return
    assert Counter(s.name for s in got) == Counter(
        ["pe.wait", "pe.fast", "pe.rescue", "pe.decide"])
    w, f, r, d = (next(s for s in got if s.name == k)
                  for k in ("pe.wait", "pe.fast", "pe.rescue", "pe.decide"))
    assert w.attrs == {"reads": 2 * n}
    assert len({s.thread for s in got}) == 1
    assert w.t0 <= f.t0 <= f.t1 <= r.t0 <= r.t1 <= d.t0 <= d.t1 <= w.t1
    assert f.attrs["pairs"] == n
    fast, cp, dp, up = (f.attrs["fast"], d.attrs["cp"], d.attrs["dp"],
                        d.attrs["up"])
    assert d.attrs["pairs"] == cp + dp + up == n - fast
    assert fast > 0 and cp > 0 and dp > 0 and up > 0
    yt = Counter(r1.yt for r1, _ in pairs)
    assert yt == Counter({"CP": fast + cp, "DP": dp, "UP": up})
    assert 0 < r.attrs["hits"] <= r.attrs["jobs"]


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_enqueue_shape_and_shard_spans(genome, on):
    """36 bp reads on a mesh of two logical CPU shards: each dispatch's
    cg.enqueue counts the batch's reads and the general short-read shape
    (short 1), and holds one cg.shard a shard on its thread, whose reads
    add up to the batch's; 100 bp reads take the fast shape (short 0).
    With the recorder off nothing is recorded."""
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu_torch.index.fm import FmIndex
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.parallel.mesh import Mesh
    chroms, base, _ = genome
    al = UnpairedAligner(FmIndex.load(base),
                         mesh=Mesh([torch.device("cpu")] * 2))
    reads = make_reads(chroms, 150, 8)
    short = [(n, s[:36], q[:36]) for n, s, q in reads[:130]]
    trace.disable()
    if on:
        trace.enable()
    try:
        t0 = time.time()
        for batch in (short, reads[130:]):
            al.align_batch(make_batch(*zip(*(
                (n.encode(), s.encode(), q.encode()) for n, s, q in batch))))
        got = [s for s in trace.spans(t0) if s.name.startswith("cg.")]
    finally:
        trace.disable()
    if not on:
        assert got == []
        return
    enq = [s for s in got if s.name == "cg.enqueue"]
    assert [s.attrs for s in enq] == [{"reads": 130, "short": 1},
                                      {"reads": 20, "short": 0}]
    for e in enq:
        shards = [s for s in got if s.name == "cg.shard"
                  and e.t0 <= s.t0 and s.t1 <= e.t1]
        assert [s.attrs["shard"] for s in shards] == [0, 1]
        # shards of 128 rows (the dispatch's least): the first takes the
        # batch's first 128 reads, the second the rest
        assert [s.attrs["reads"] for s in shards] == \
            {130: [128, 2], 20: [20, 0]}[e.attrs["reads"]]
        assert {s.thread for s in shards} == {e.thread}
