"""The big-index path of the port (uint32 rows, the sampled SA and its
walk-left resolution, biased diagonals; docs/BIGINDEX.md) against the JAX
package on the CPU, with tolerance 0: forced on small synthetic genomes
(`force_big`, as tests/test_big_index.py forces it on the lambda genome),
where the small path on the same index is a second oracle. The device
layout and the resolved offsets, the fused pipeline's packed output, the
unpaired and paired SAM, and the batch halving after the capacity
escalation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bowtie2_server_tpu.align import paired as jpaired  # noqa: E402
from bowtie2_server_tpu.align.pipeline import (  # noqa: E402
    UnpairedAligner as JAligner)
from bowtie2_server_tpu.index.build import build_index  # noqa: E402
from bowtie2_server_tpu.io.fastq import make_batch as j_make_batch  # noqa
from bowtie2_server_tpu.io.sam import sam_record as j_sam  # noqa: E402
from bowtie2_server_tpu.ops import fm as jfm  # noqa: E402
from bowtie2_server_tpu.utils import dna  # noqa: E402
from bowtie2_server_tpu_torch.align import candgen as tcg  # noqa: E402
from bowtie2_server_tpu_torch.align import paired as tpaired  # noqa: E402
from bowtie2_server_tpu_torch.align import pipeline as tpipe  # noqa: E402
from bowtie2_server_tpu_torch.index.fm import FmIndex  # noqa: E402
from bowtie2_server_tpu_torch.io.fastq import make_batch  # noqa: E402
from bowtie2_server_tpu_torch.io.sam import sam_record  # noqa: E402
from bowtie2_server_tpu_torch.ops import fm as tfm  # noqa: E402
from test_torch_candgen import (  # noqa: E402
    _assert_batch_results_equal, _capture, _reads, _run_both)
from test_torch_paired import make_pairs  # noqa: E402


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """Two chromosomes of 100 kbp (the paired tests' shape), saved by the
    JAX package and loaded by the port: (chromosome codes, JAX index, port
    index)."""
    rng = np.random.default_rng(29)
    chroms = [rng.integers(0, 4, 100_000).astype(np.uint8)
              for _ in range(2)]
    idx = build_index("".join(f">chr{i}\n{dna.decode(c)}\n"
                              for i, c in enumerate(chroms)))
    d = tmp_path_factory.mktemp("torch_big")
    idx.save(d / "genome")
    return chroms, idx, FmIndex.load(d / "genome")


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("direction", ["fw", "mirror"])
def test_to_device_big_fields_equal_jax(genome, direction):
    _, jidx, tidx = genome
    j = jfm.to_device(getattr(jidx, direction), big=True)
    t = tfm.to_device(getattr(tidx, direction), "cpu", big=True)
    assert t.big and t.off_rate == j.off_rate == jfm.OFF_RATE_BIG
    for name in ("side", "mark", "sa_samp", "ftab_top", "ftab_bot"):
        np.testing.assert_array_equal(_u32(getattr(t, name)),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert t.sa.numel() == 1                      # the full SA stays home
    assert t.cnt.tolist() == np.asarray(j.cnt).tolist()
    assert (t.n, t.primary) == (int(j.n), int(j.primary))


@pytest.mark.parametrize("source", ["to_device", "convert"])
def test_big_records_layout(genome, source):
    """A big direction's block rows as the kernels read them: contiguous
    [n_blocks+1, 8] sides (the walks' and the walk-left's) and [n_blocks+1,
    4] mark rows, 16-byte aligned, built alike by to_device and from the
    JAX package's arrays (convert.fm_from_numpy), with the JAX values; a
    small direction has no marks."""
    from bowtie2_server_tpu_torch import convert
    _, jidx, tidx = genome
    j = jfm.to_device(jidx.fw, big=True)
    if source == "to_device":
        t = tfm.to_device(tidx.fw, "cpu", big=True)
    else:
        t = convert.fm_from_numpy(
            {k: np.asarray(getattr(j, k)) for k in
             ("side", "cnt", "sa", "ftab_top", "ftab_bot", "n", "primary",
              "mark", "sa_samp", "off_rate")}, "cpu")
    rows = t.side.shape[0]
    assert t.side.shape == (rows, 8) and t.side.is_contiguous()
    assert t.mark.shape == (rows, 4) and t.mark.is_contiguous()
    assert t.side.dtype == t.mark.dtype == torch.int32
    assert t.side.data_ptr() % 16 == 0 and t.mark.data_ptr() % 16 == 0
    np.testing.assert_array_equal(_u32(t.side), np.asarray(j.side))
    np.testing.assert_array_equal(_u32(t.mark), np.asarray(j.mark))
    np.testing.assert_array_equal(_u32(t.sa_samp), np.asarray(j.sa_samp))
    assert t.off_rate == int(j.off_rate) and t.big
    small = tfm.to_device(tidx.fw, "cpu")
    assert small.mark is None and small.side.is_contiguous()


@pytest.mark.parametrize("direction", ["fw", "mirror"])
def test_resolve_rows_equals_jax_and_sa(genome, direction):
    """The walk-left on 4096 random rows (the primary row, row 0 and the
    last row among them, a tenth invalid) equals JAX's resolve_rows_body,
    and the full SA where valid."""
    _, jidx, tidx = genome
    d = getattr(jidx, direction)
    j = jfm.to_device(d, big=True)
    t = tfm.to_device(getattr(tidx, direction), "cpu", big=True)
    rng = np.random.default_rng(7)
    rows = rng.integers(0, d.n, 4096).astype(np.uint32)
    rows[:3] = (d.primary, 0, d.n - 1)
    valid = rng.random(4096) < 0.9
    valid[:3] = True
    want = np.asarray(jfm.resolve_rows_body(
        j, jnp.asarray(rows), jnp.asarray(valid), j.off_rate))
    got = _u32(tfm.resolve_rows_body(t, torch.from_numpy(rows.view(np.int32)),
                                     torch.from_numpy(valid)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[valid], d.sa[rows[valid]])
    assert got[0] == 0 and (got[~valid] == 0).all()


def test_widen_narrow_round_trip():
    v = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, -1,
                      (1 << 32) + 5], dtype=torch.int64)
    n = tfm.narrow(v)
    assert n.dtype == torch.int32
    assert tfm.widen(n).tolist() == [0, 1, (1 << 31) - 1, 1 << 31,
                                     (1 << 32) - 1, (1 << 32) - 1, 5]
    assert [tfm.as_i32(x) for x in (5, 1 << 31, (1 << 32) - 1)] == \
        [5, -(1 << 31), -1]


def _boundary_genome():
    """tests/test_big_index.py::test_big_path_multi_ref_boundaries' genome
    and reads: three references of 400 bp, reads inside each and one at a
    reference start. Returns (FASTA, reads, [(ref id, pos)])."""
    rng = np.random.default_rng(11)
    refs = ["".join("ACGT"[c] for c in rng.integers(0, 4, 400))
            for _ in range(3)]
    fa = "".join(f">r{i}\n{s}\n" for i, s in enumerate(refs))
    reads = [refs[0][100:140], refs[1][10:50], refs[2][360:400],
             refs[1][0:40]]
    return fa, [s.encode() for s in reads], [(0, 100), (1, 10), (2, 360),
                                             (1, 0)]


@pytest.fixture(scope="module")
def jax_big_run(genome):
    """The JAX aligner under force_big on 300 reads of 100 bp from
    chromosome 0: the state its first dispatch captured, and its SAM."""
    chroms, jidx, _ = genome
    seqs = _reads(np.random.default_rng(31), chroms[0], 300, lens=(100,))
    al = JAligner(jidx, force_big=True)
    assert al.big
    cap = _capture(al, seqs)
    names = [f"r{i}" for i in range(len(seqs))]
    quals = [b"I" * len(s) for s in seqs]
    recs = al.align_batch(j_make_batch(names, seqs, quals))
    sam = [j_sam(recs[i], jidx.ref_names) for i in range(len(recs))]
    return seqs, names, quals, cap, sam


@pytest.mark.parametrize("case", ["reads100", "boundaries"])
def test_fused_big_packed_equal(genome, jax_big_run, case):
    """The packed output (and every decoded BatchResult field) of the port
    under force_big equals JAX's on the state its aligner dispatched."""
    if case == "reads100":
        (didx, dkm, cfg, arrays), B0 = jax_big_run[3]
    else:
        fa, seqs, _ = _boundary_genome()
        (didx, dkm, cfg, arrays), B0 = _capture(
            JAligner(build_index(fa), force_big=True), seqs)
    assert cfg.big and cfg.has_short and cfg.off_rate == jfm.OFF_RATE_BIG
    want, got, tcfg = _run_both(didx, dkm, cfg, arrays)
    assert tcfg.big
    np.testing.assert_array_equal(got, want)
    _assert_batch_results_equal(want, got, cfg, tcfg, B0, cfg.K)
    res = tcg.BatchResult(B0, got, tcfg, 1, cfg.K)
    assert len(res.c_diag) and (res.c_diag > -cfg.L).all()


def test_boundary_reads_placed():
    """The multi-reference geometry survives the biased diagonals: each
    read at its reference and offset, 40M with no edit."""
    fa, seqs, exp = _boundary_genome()
    al = tpipe.UnpairedAligner(build_index(fa), device="cpu", force_big=True)
    recs = al.align_batch(make_batch([f"q{i}" for i in range(len(seqs))],
                                     seqs, [b"I" * 40] * len(seqs)))
    for i, (rid, pos) in enumerate(exp):
        r = recs[i]
        assert r.aligned and (r.ref_id, r.pos) == (rid, pos), i
        assert r.cigar == "40M" and r.nm == 0


def _port_sam(recs, ref_names):
    return [sam_record(r, ref_names) for r in recs]


def test_sam_big_equals_jax_and_small(genome, jax_big_run):
    _, _, tidx = genome
    seqs, names, quals, _, want = jax_big_run
    big = tpipe.UnpairedAligner(tidx, device="cpu", force_big=True)
    small = tpipe.UnpairedAligner(tidx, device="cpu")
    assert big.big and big.candgen.big and not small.big
    got = _port_sam(big.align_batch(make_batch(names, seqs, quals)),
                    tidx.ref_names)
    assert got == want
    assert got == _port_sam(small.align_batch(make_batch(names, seqs,
                                                         quals)),
                            tidx.ref_names)
    assert sum(int(ln.split("\t")[1]) & 4 == 0 for ln in got) > 290


def test_big_refuses_host_path(genome):
    _, _, tidx = genome
    al = tpipe.UnpairedAligner(tidx, device="cpu", force_big=True,
                               policy=tpipe.SearchPolicy(khits=2000))
    with pytest.raises(NotImplementedError, match="fused device path"):
        al.align_batch(make_batch(["a"], [b"ACGT" * 10], [b"I" * 40]))


@pytest.fixture(scope="module")
def jax_big_pairs(genome):
    """64 pairs (tests/test_torch_paired.py's shape) and the SAM of the JAX
    pair aligner whose unpaired aligner runs under force_big (its pair
    aligner has no force_big option)."""
    chroms, jidx, _ = genome
    names, (s1, q1), (s2, q2) = make_pairs(np.random.default_rng(41),
                                           chroms, 64)
    jpal = jpaired.PairedAligner(jidx)
    jpal.up = JAligner(jidx, force_big=True)
    jp = jpal.align_batch(j_make_batch(names, s1, q1),
                          j_make_batch(names, s2, q2))
    return (names, s1, q1, s2, q2,
            [j_sam(r, jidx.ref_names) for pr in jp for r in pr])


def test_paired_big_sam_equals_jax(genome, jax_big_pairs):
    _, _, tidx = genome
    names, s1, q1, s2, q2, want = jax_big_pairs
    tpal = tpaired.PairedAligner(tidx, device="cpu", force_big=True)
    assert tpal.up.big
    tp = tpal.align_batch(make_batch(names, s1, q1), make_batch(names, s2, q2))
    got = [sam_record(r, tidx.ref_names) for pr in tp for r in pr]
    assert got == want
    assert tp.n_concordant() > 48


def _capped_fetch(monkeypatch, cap):
    """CandGen.fetch reporting an overflow at every escalation for batches
    of more than `cap` reads: their capacities are too small even at 16x.
    Returns the list of (reads, cfg) of every fetch."""
    fetched = []
    orig = tcg.CandGen.fetch

    def fetch(self, h):
        res = orig(self, h)
        fetched.append((h[0], h[1]))
        if h[0] > cap:
            res.overflow = True
        return res

    monkeypatch.setattr(tcg.CandGen, "fetch", fetch)
    return fetched


@pytest.fixture(scope="module")
def halved(genome, jax_big_run, jax_big_pairs):
    """The port's runs of jax_big_run's reads and of jax_big_pairs' pairs
    with CandGen.fetch capped (_capped_fetch at 150 reads and 32 pairs):
    ((records, fetches) unpaired, (pair records, fetches))."""
    _, _, tidx = genome
    seqs, names, quals, _, _ = jax_big_run
    pnames, s1, q1, s2, q2, _ = jax_big_pairs
    with pytest.MonkeyPatch.context() as mp:
        fetched = _capped_fetch(mp, 150)
        al = tpipe.UnpairedAligner(tidx, device="cpu", force_big=True)
        recs = al.align_batch(make_batch(names, seqs, quals))
    with pytest.MonkeyPatch.context() as mp:
        pfetched = _capped_fetch(mp, 32)
        tpal = tpaired.PairedAligner(tidx, device="cpu", force_big=True)
        tp = tpal.align_batch(make_batch(pnames, s1, q1),
                              make_batch(pnames, s2, q2))
    return (recs, fetched), (tp, pfetched)


def test_big_halving_equals_unsplit(genome, jax_big_run, halved):
    """A batch that still overflows at 16x is split in halves until the
    halves fit (300 -> 150 reads): the records equal the unsplit JAX
    run's."""
    _, _, tidx = genome
    want = jax_big_run[4]
    recs, fetched = halved[0]
    assert isinstance(recs, tpipe.ConcatRecs) and len(recs) == 300
    assert _port_sam(recs, tidx.ref_names) == want
    # 300 reads at 1x, 2x, 4x and 16x, then the two halves at 1x
    assert [n for n, _ in fetched] == [300] * 4 + [150, 150]
    assert fetched[3][1].NH > fetched[0][1].NH        # 16x over 1x


def test_paired_big_halving(genome, jax_big_pairs, halved):
    """The pair batch splits the same way (64 -> 32 pairs): the records
    equal the unsplit JAX run's."""
    _, _, tidx = genome
    want = jax_big_pairs[5]
    tp, fetched = halved[1]
    assert isinstance(tp, tpipe.ConcatRecs) and len(tp) == 64
    assert [sam_record(r, tidx.ref_names) for pr in tp for r in pr] == want
    # mate 1 at 1x, 2x, 4x and 16x, then both mates of each half
    assert [n for n, _ in fetched] == [64] * 4 + [32] * 4


def _flags(lines):
    return [int(ln.split("\t")[1]) for ln in lines]


@pytest.mark.parametrize("which", ["unpaired", "paired"])
def test_halved_counts_equal_jax(jax_big_run, jax_big_pairs, halved, which):
    """A halved batch's ConcatRecs counts as the JAX package's records of
    the same reads do (from the flags of their SAM): n_aligned() of the
    unpaired aligner's, n_concordant() of the pair aligner's."""
    if which == "unpaired":
        recs = halved[0][0]
        want = sum(not f & 4 for f in _flags(jax_big_run[4]))
        assert recs.n_aligned() == want > 250
        return
    tp = halved[1][0]
    want = sum(bool(f & 2) for f in _flags(jax_big_pairs[5])[::2])
    assert tp.n_concordant() == want > 48
