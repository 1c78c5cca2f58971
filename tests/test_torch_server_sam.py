"""The server's response bytes from the native SAM emitter
(`native.sam_emit`, `native/samfmt.cpp`) against the per-record path
(`sam_record` a record, taken when the native library is missing): a
pack's bytes from `Bt2Server._align_pack` (device 'cpu') are the same
either way, end to end and under --local, for committed reads on either
strand with mismatches, gapped winners, unaligned and filtered reads (each
YF:Z: code), a row without quals, repeats, fast, slow, discordant and mixed
pairs, mates on two references, and a pack mixing unpaired and paired
rows. The `srv.sam` span counts the pack's reads and those the emitter
wrote from the column stores; a small first buffer grows and gives the
same bytes; and the CLI's emitter call (`sam_format_batch`) writes each
filtered read's YF:Z: as `sam_record` does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

from bowtie2_server_tpu_torch import native  # noqa: E402
from bowtie2_server_tpu_torch.align.paired import PairedAligner  # noqa
from bowtie2_server_tpu_torch.align.pipeline import (  # noqa: E402
    LazyRecs, SearchPolicy, UnpairedAligner)
from bowtie2_server_tpu_torch.index.build import build_index  # noqa: E402
from bowtie2_server_tpu_torch.io.fastq import make_batch  # noqa: E402
from bowtie2_server_tpu_torch.io.sam import sam_record  # noqa: E402
from bowtie2_server_tpu_torch.server import bt2srv  # noqa: E402
from bowtie2_server_tpu_torch.utils import dna, trace  # noqa: E402
from bowtie2_server_tpu_torch.utils.presets import preset_params  # noqa

CHROM_LEN = 20_000
RL = 60
REPEAT = 300        # a segment both chromosomes hold at REPEAT_AT
REPEAT_AT = 5_000


@pytest.fixture(scope="module")
def genome():
    """Two chromosomes sharing one 300 bp segment, and the index."""
    rng = np.random.default_rng(11)
    chroms = [rng.integers(0, 4, CHROM_LEN).astype(np.uint8)
              for _ in range(2)]
    chroms[1][REPEAT_AT : REPEAT_AT + REPEAT] = \
        chroms[0][REPEAT_AT : REPEAT_AT + REPEAT]
    fa = "".join(f">chr{i} some words\n{dna.decode(c)}\n"
                 for i, c in enumerate(chroms))
    idx = build_index(fa)
    return chroms, idx, [n.split()[0] for n in idx.ref_names]


_WORKERS: dict = {}


def worker(idx, mode):
    """The server's worker (up, pal) for a mode, one a module."""
    key = (id(idx), mode)
    if key not in _WORKERS:
        sc, polkw = preset_params(None, mode == "local")
        pal = PairedAligner(idx, scoring=sc, policy=SearchPolicy(**polkw),
                            device="cpu")
        _WORKERS[key] = (pal.up, pal)
    return _WORKERS[key]


def _qual(rng, n):
    return bytes(rng.integers(35, 74, n).astype(np.uint8))


def _cut(rng, g, st, n, mm, fw=True):
    r = g[st : st + n].copy()
    for p in rng.choice(n, mm, False):
        r[p] = (r[p] + int(rng.integers(1, 4))) % 4
    return r if fw else dna.revcomp(r)


def _row(name, r, rng, qual=True):
    s = dna.decode(r).encode() if not isinstance(r, bytes) else r
    return (name, s, _qual(rng, len(s)) if qual else b"", None, None, None)


def unpaired(rng, chroms, kind, n=12):
    """Rows of one kind of unpaired read."""
    rows = []
    for k in range(n):
        g = chroms[k % 2]
        st = int(rng.integers(0, CHROM_LEN - 2 * RL))
        fw = bool(k % 2)
        name = f"{kind}{k}"
        if kind == "committed":       # 0-3 mismatches, either strand
            rows.append(_row(name, _cut(rng, g, st, RL, k % 4, fw), rng))
        elif kind == "gapped":        # a deletion or an insertion
            r = _cut(rng, g, st, RL + 3, 0)
            r = (np.concatenate([r[:30], r[32:RL + 2]]) if k % 2 else
                 np.concatenate([r[:30], [(r[30] + 1) % 4], r[30:RL - 1]]))
            rows.append(_row(name, r if fw else dna.revcomp(r), rng))
        elif kind == "unaligned":     # random sequence
            rows.append(_row(name, rng.integers(0, 4, RL).astype(np.uint8),
                             rng))
        elif kind == "repeat":        # inside the shared segment
            st = REPEAT_AT + int(rng.integers(0, REPEAT - RL))
            rows.append(_row(name, _cut(rng, g, st, RL, k % 2, fw), rng))
    return rows


def filtered(rng, chroms):
    """Reads each read filter stops: empty (LN), mostly N (NS), 6 bp
    (SC under --local, whose minimum score a 6 bp read cannot reach), a
    row without quals, and committed reads around them."""
    r = _cut(rng, chroms[0], 700, RL, 1)
    s = bytearray(dna.decode(r).encode())
    s[5:45] = b"N" * 40
    return [_row("ln", b"", rng), _row("ns", bytes(s), rng),
            _row("sc", _cut(rng, chroms[1], 900, 6, 0), rng),
            _row("noqual", _cut(rng, chroms[1], 1300, RL, 2, False), rng,
                 qual=False)] + unpaired(rng, chroms, "committed", 6)


def pairs(rng, chroms, kind, n=12):
    """Pair rows (name/1, seq1, qual1, name/2, seq2, qual2) of one kind."""
    rows = []
    for k in range(n):
        g = chroms[k % 2]
        frag = int(rng.integers(250, 400))
        st = int(rng.integers(REPEAT_AT + REPEAT, CHROM_LEN - 6000))
        m1 = _cut(rng, g, st, RL, k % 3)
        m2 = _cut(rng, g, st + frag - RL, RL, (k + 1) % 3, False)
        if kind == "two_refs":        # mate 2 on the other chromosome
            m2 = _cut(rng, chroms[1 - k % 2], st + frag - RL, RL, 1, False)
        elif kind == "discordant":    # a 5 kbp fragment
            m2 = _cut(rng, g, st + 5000, RL, 1, False)
        elif kind == "mixed":         # mate 2 aligns nowhere
            m2 = rng.integers(0, 4, RL).astype(np.uint8)
        elif kind == "slow":          # a gapped mate, or a repeat's
            if k % 2:
                m2 = np.concatenate([m2[:30], m2[32:],
                                     g[st + frag : st + frag + 2]])
            else:
                rs = REPEAT_AT + int(rng.integers(0, REPEAT - RL))
                m1 = _cut(rng, g, rs, RL, 0)
        if k % 3 == 2:                # the pair on the other strand
            m1, m2 = m2, m1
        rows.append((f"{kind}{k}/1", dna.decode(m1).encode(),
                     _qual(rng, RL), f"{kind}{k}/2", dna.decode(m2).encode(),
                     _qual(rng, RL)))
    return rows


PACKS = {
    "committed": lambda rng, c: unpaired(rng, c, "committed"),
    "gapped": lambda rng, c: unpaired(rng, c, "gapped"),
    "unaligned": lambda rng, c: unpaired(rng, c, "unaligned", 6)
    + unpaired(rng, c, "committed", 6),
    "repeat": lambda rng, c: unpaired(rng, c, "repeat"),
    "filtered": filtered,
    "fast_pairs": lambda rng, c: pairs(rng, c, "fast"),
    "slow_pairs": lambda rng, c: pairs(rng, c, "slow"),
    "two_refs_pairs": lambda rng, c: pairs(rng, c, "two_refs", 6)
    + pairs(rng, c, "fast", 4),
    "discordant_pairs": lambda rng, c: pairs(rng, c, "discordant", 6)
    + pairs(rng, c, "fast", 4),
    "mixed_pairs": lambda rng, c: pairs(rng, c, "mixed", 6)
    + pairs(rng, c, "fast", 4),
    "mixed_pack": lambda rng, c: unpaired(rng, c, "committed", 4)
    + pairs(rng, c, "fast", 3) + unpaired(rng, c, "gapped", 3)
    + pairs(rng, c, "slow", 3) + filtered(rng, c)[:4]
    + pairs(rng, c, "mixed", 2),
}


def pack(genome, name):
    return PACKS[name](np.random.default_rng(sum(map(ord, name))),
                       genome[0])


def per_record(monkeypatch, w, rows, ref_names):
    """The pack's bytes without the native library."""
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        return bt2srv.Bt2Server._align_pack(w, rows, ref_names)


@pytest.mark.parametrize("mode", ["e2e", "local"])
@pytest.mark.parametrize("name", list(PACKS))
def test_emitter_bytes_equal_per_record(genome, monkeypatch, name, mode):
    _, idx, ref_names = genome
    rows = pack(genome, name)
    w = worker(idx, mode)
    got = bt2srv.Bt2Server._align_pack(w, rows, ref_names)
    want = per_record(monkeypatch, w, rows, ref_names)
    assert got == want
    assert got.count(b"@CO END READ\t") == len(rows)
    n_pairs = sum(r[3] is not None for r in rows)
    assert got.count(b"\n") == 2 * len(rows) + n_pairs


def test_packs_reach_every_kind_of_record(genome):
    """The packs above hold what they claim: gapped and unaligned reads,
    every filter of its mode, XS:i, fast (CP from the columns), slow CP,
    DP and UP pairs, RNEXT a name."""
    _, idx, ref_names = genome
    seen = {}
    for mode in ("e2e", "local"):
        lines = b"".join(bt2srv.Bt2Server._align_pack(
            worker(idx, mode), pack(genome, name), ref_names)
            for name in PACKS).decode().split("\n")
        recs = [ln.split("\t") for ln in lines if ln and ln[0] != "@"]
        tags = [set(f[11:]) for f in recs]
        seen[mode] = dict(
            gap=any(("I" in f[5] or "D" in f[5]) for f in recs),
            unal=any(int(f[1]) & 4 for f in recs),
            xs=any(t.startswith("XS:i:") for ts in tags for t in ts),
            yf={t for ts in tags for t in ts if t.startswith("YF:Z:")},
            yt={t for ts in tags for t in ts if t.startswith("YT:Z:")},
            rnext=any(f[6] not in ("*", "=") for f in recs))
    for mode in ("e2e", "local"):
        s = seen[mode]
        assert s["gap"] and s["unal"] and s["xs"] and s["rnext"], (mode, s)
        assert s["yt"] == {"YT:Z:UU", "YT:Z:CP", "YT:Z:DP", "YT:Z:UP"}, s
    assert seen["e2e"]["yf"] == {"YF:Z:LN", "YF:Z:NS"}
    assert seen["local"]["yf"] == {"YF:Z:LN", "YF:Z:NS", "YF:Z:SC"}


def column_mates(res) -> int:
    """A LazyRecs's reads in its column store and not materialised."""
    soa = res.soa
    if soa is None:
        return 0
    cached = {i for i, _ in res.cache_items()}
    return sum(1 for i in np.nonzero(soa.filled)[0] if int(i) not in cached)


def test_sam_span_counts_the_columns(genome, monkeypatch):
    """srv.sam's mates are the pack's reads (a mate one), its columns the
    reads of the column stores the emitter wrote, most of a pack of
    committed reads and fast pairs."""
    _, idx, ref_names = genome
    rows = pack(genome, "mixed_pack") + pack(genome, "fast_pairs")
    up, pal = worker(idx, "e2e")
    got = {}
    orig = bt2srv._pack_bytes

    def keep(up, rows, recs, pairs, ref_names):
        got["res"] = (recs, pairs)
        return orig(up, rows, recs, pairs, ref_names)

    monkeypatch.setattr(bt2srv, "_pack_bytes", keep)
    trace.disable()
    trace.enable()
    try:
        bt2srv.Bt2Server._align_pack((up, pal), rows, ref_names)
        spans = trace.spans()
    finally:
        trace.disable()
    sam = [s for s in spans if s.name == "srv.sam"]
    pk = [s for s in spans if s.name == "srv.pack"]
    assert len(sam) == len(pk) == 1
    recs, prs = got["res"]
    assert isinstance(recs, LazyRecs) and isinstance(prs.r1, LazyRecs)
    want = column_mates(recs) + column_mates(prs.r1) + column_mates(prs.r2)
    n = sum(1 if r[3] is None else 2 for r in rows)
    assert sam[0].attrs == {"mates": n, "columns": want}
    assert pk[0].attrs["reads"] == n
    assert want >= 0.6 * n


def test_per_record_path_counts_no_columns(genome, monkeypatch):
    _, idx, ref_names = genome
    rows = pack(genome, "mixed_pack")
    trace.disable()
    trace.enable()
    try:
        per_record(monkeypatch, worker(idx, "e2e"), rows, ref_names)
        sam = [s for s in trace.spans() if s.name == "srv.sam"]
    finally:
        trace.disable()
    n = sum(1 if r[3] is None else 2 for r in rows)
    assert [s.attrs for s in sam] == [{"mates": n, "columns": 0}]


def test_small_first_buffer_grows(genome, monkeypatch):
    """A first buffer of 64 bytes: the emitter stops at the first row that
    does not fit, and the buffer grows until the pack fits."""
    _, idx, ref_names = genome
    rows = pack(genome, "mixed_pack")
    w = worker(idx, "e2e")
    calls = []
    emit = native.get_lib().bt2tpu_sam_emit

    def counted(*a):
        calls.append(a[-1])
        return emit(*a)

    monkeypatch.setattr(native, "_capacity", lambda *a: 64)
    monkeypatch.setattr(native.get_lib(), "bt2tpu_sam_emit", counted)
    got = bt2srv.Bt2Server._align_pack(w, rows, ref_names)
    monkeypatch.undo()
    assert len(calls) > 2 and calls[0] == 64
    assert got == per_record(monkeypatch, w, rows, ref_names)


def test_cli_emitter_writes_each_yf_code(genome):
    """The CLI's emitter call (no markers, unpaired) writes each filtered
    read's YF:Z: as sam_record does: LN, NS and QC (a read whose QC flag
    --qc-filter honours). (SC needs --local, whose batches have no column
    store, so the CLI formats them a record at a time; the server's
    --local packs above reach it.)"""
    _, idx, ref_names = genome
    rows = filtered(np.random.default_rng(4), genome[0])
    b = make_batch([r[0] for r in rows], [r[1] for r in rows],
                   [r[2] for r in rows])
    b.qc_fail = np.zeros(len(rows), bool)
    b.qc_fail[-1] = True
    up = UnpairedAligner(idx, device="cpu")
    up.qc_filter = True
    recs = up.align_batch(b)
    got = native.sam_format_batch(recs, ref_names)
    want = "".join(sam_record(r, ref_names) + "\n" for r in recs).encode()
    assert got == want
    yf = {t for t in got.decode().split() if t.startswith("YF:Z:")}
    assert yf == {"YF:Z:LN", "YF:Z:NS", "YF:Z:QC"}
