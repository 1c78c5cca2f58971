"""The general short-read shape and the host path of the port (device
'cpu', the plain torch versions of the kernels) against the JAX package:
the fused pipeline's packed output on the same inputs, and byte-identical
SAM from both aligners and both CLIs for short reads, -N 1, -k, -a, an
index without its mirror direction and paired 36 bp mates."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

from bowtie2_server_tpu.align.paired import (  # noqa: E402
    PairedAligner as JPaired)
from bowtie2_server_tpu.align.pipeline import (  # noqa: E402
    ALL_HITS, SearchPolicy as JPolicy, UnpairedAligner as JAligner)
from bowtie2_server_tpu.index.build import build_index  # noqa: E402
from bowtie2_server_tpu.io.fastq import make_batch as j_make_batch  # noqa
from bowtie2_server_tpu.io.sam import sam_record as j_sam  # noqa: E402
from bowtie2_server_tpu.utils import dna  # noqa: E402
from bowtie2_server_tpu.utils.presets import preset_params  # noqa: E402
from bowtie2_server_tpu_torch.align import candgen as tcg  # noqa: E402
from bowtie2_server_tpu_torch.align import pipeline as tpipe  # noqa: E402
from bowtie2_server_tpu_torch.align.paired import PairedAligner  # noqa
from bowtie2_server_tpu_torch.index.fm import FmIndex  # noqa: E402
from bowtie2_server_tpu_torch.io.fastq import make_batch  # noqa: E402
from bowtie2_server_tpu_torch.io.sam import sam_record  # noqa: E402
from bowtie2_server_tpu_torch.ops import fm as tfm  # noqa: E402
from test_torch_candgen import (  # noqa: E402
    _assert_batch_results_equal, _capture, _reads, _run_both)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """Saved by the JAX package, loaded by the port: a 30 kbp chromosome
    and a chromosome with a 60-mer planted 40 times in random background
    (the shape of tests/test_large_k.py); the same genome again without
    its mirror direction. Returns (chromosome codes, repeat unit, {name:
    (JAX index, port index)})."""
    rng = np.random.default_rng(11)
    chrom = rng.integers(0, 4, 30_000).astype(np.uint8)
    unit = rng.integers(0, 4, 60).astype(np.uint8)
    rep = np.concatenate([np.concatenate(
        [rng.integers(0, 4, 50).astype(np.uint8), unit])
        for _ in range(40)])
    fa = f">chr\n{dna.decode(chrom)}\n>rep\n{dna.decode(rep)}\n"
    d = tmp_path_factory.mktemp("torch_short")
    out = {}
    for name, both in (("full", True), ("nomirror", False)):
        idx = build_index(fa, both_directions=both)
        idx.save(d / name)
        out[name] = (idx, FmIndex.load(d / name))
    assert out["nomirror"][1].mirror is None
    return chrom, unit, out


def _short_reads(chrom, n, seed, lens=(18, 22, 25, 30, 36, 44, 50, 60)):
    rng = np.random.default_rng(seed)
    return _reads(rng, chrom, n, lens=lens, nmm=2)


def _n1_reads(chrom, n, seed):
    """60 bp reads whose only seed-findable hit needs an in-seed
    substitution (tests/test_n1_fused.py's reads): one substitution at a
    position 2-19, inside every round-0 seed window."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n):
        s = int(rng.integers(0, len(chrom) - 60))
        r = chrom[s : s + 60].copy()
        p = int(rng.integers(2, 20))
        r[p] = (r[p] + 1) % 4
        seqs.append(dna.decode(r).encode())
    return seqs


@pytest.mark.parametrize("case", ["mixed", "n1"])
def test_fused_short_packed_equal(genome, case, monkeypatch):
    """The packed output rows (and every decoded BatchResult field) of the
    general shape equal JAX's on the state and config its UnpairedAligner
    dispatches: 300 reads of 18-60 bp, and -N 1 on 60, 77 and 100 bp.
    Under -N 1 the port takes the seeds' exact ranges from their recorded
    pass and runs no ftab search walk."""
    chrom, _, idxs = genome
    jidx = idxs["full"][0]
    sc, pol = preset_params(None, False)
    if case == "n1":
        pol = dict(pol, n_seed_mms=1)
        seqs = _short_reads(chrom, 300, 5, lens=(60, 77, 100))
    else:
        seqs = _short_reads(chrom, 300, 6)
    al = JAligner(jidx, scoring=sc, policy=JPolicy(**pol))
    (didx, dkm, cfg, arrays), B0 = _capture(al, seqs)
    assert cfg.has_short and cfg.seed_mms == (case == "n1")
    searches = []
    search = tfm.backward_search_body
    monkeypatch.setattr(tfm, "backward_search_body", lambda *a, **k: (
        searches.append(1), search(*a, **k))[1])
    want, got, tcfg = _run_both(didx, dkm, cfg, arrays)
    np.testing.assert_array_equal(got, want)
    _assert_batch_results_equal(want, got, cfg, tcfg, B0, cfg.K)
    assert len(searches) == (0 if case == "n1" else cfg.R)
    ctr = tcg.BatchResult(B0, got, tcfg, 1, cfg.K).counters[0]
    assert ctr[2] > 0 and ctr[3] > 0     # 1mm branches survived, both sides


def _jax_sam(recs, names):
    return [j_sam(r, names) for r in (recs if isinstance(recs, list)
                                      else (recs[i] for i in
                                            range(len(recs))))]


def _port_sam(recs, names):
    return [sam_record(r, names) for r in (recs if isinstance(recs, list)
                                           else (recs[i] for i in
                                                 range(len(recs))))]


def _case(chrom, unit, case):
    """(index name, local, policy overrides, reads) of a SAM case."""
    if case in ("short_e2e", "short_local"):
        return "full", case == "short_local", {}, _short_reads(chrom, 300, 7)
    if case == "n1":
        return "full", False, dict(n_seed_mms=1), _n1_reads(chrom, 48, 33)
    multi = dict(mhits=0, msample=False)
    reads = ([dna.decode(unit).encode()]
             + _short_reads(chrom, 20, 8, lens=(36, 60)))
    if case == "k100":
        return "full", False, dict(multi, khits=100), reads
    if case == "k2000":
        return "full", False, dict(multi, khits=2000), reads
    if case == "all":
        return "full", False, dict(multi, khits=ALL_HITS), reads
    # an index without its mirror direction takes the host path
    return "nomirror", False, {}, (_short_reads(chrom, 100, 9)
                                   + _reads(np.random.default_rng(10),
                                            chrom, 100, lens=(100,)))


@pytest.mark.parametrize("case", ["short_e2e", "short_local", "n1", "k100",
                                  "k2000", "all", "mirrorless"])
def test_sam_identical(genome, case, monkeypatch):
    chrom, unit, idxs = genome
    which, local, over, seqs = _case(chrom, unit, case)
    jidx, tidx = idxs[which]
    names = [f"q{i}" for i in range(len(seqs))]
    quals = [bytes(np.random.default_rng(len(s)).integers(
        35, 74, len(s)).astype(np.uint8)) for s in seqs]
    sc, pol = preset_params(None, local)
    pol = dict(pol, **over)
    jrecs = JAligner(jidx, scoring=sc, policy=JPolicy(**pol)).align_batch(
        j_make_batch(names, seqs, quals))
    want = _jax_sam(jrecs, jidx.ref_names)

    host = []
    orig = tpipe.UnpairedAligner._collect_host
    monkeypatch.setattr(tpipe.UnpairedAligner, "_collect_host",
                        lambda self, *a: (host.append(1),
                                          orig(self, *a))[1])
    tal = tpipe.UnpairedAligner(tidx, scoring=sc,
                                policy=tpipe.SearchPolicy(**pol),
                                device="cpu")
    got = _port_sam(tal.align_batch(make_batch(names, seqs, quals)),
                    tidx.ref_names)
    assert got == want
    assert bool(host) == (case in ("k2000", "all", "mirrorless"))
    n_al = sum(int(ln.split("\t")[1]) & 4 == 0 for ln in got)
    # an 18 bp read with 2 substitutions is below the e2e minimum score;
    # under --local no read under 22 bp reaches it
    assert n_al > (0.6 if local else 0.8) * len(seqs)
    if case in ("k100", "k2000", "all"):
        # the repeat read: a primary and 39 secondary records
        assert sum(ln.startswith("q0\t") for ln in got) == 40


def test_overflow_takes_host_path(genome, monkeypatch):
    """A batch still overflowing after the 4x escalation goes to the host
    path, which writes the SAM that JAX's host path writes."""
    chrom, _, idxs = genome
    jidx, tidx = idxs["full"]
    seqs = _short_reads(chrom, 60, 12, lens=(36, 100))
    names = [f"o{i}" for i in range(len(seqs))]
    quals = [b"I" * len(s) for s in seqs]
    jal = JAligner(jidx)
    jal.candgen = None                       # the JAX host path
    want = _jax_sam(jal.align_batch(j_make_batch(names, seqs, quals)),
                    jidx.ref_names)
    fetched = []
    orig = tcg.CandGen.fetch

    def overflowing(self, h):
        res = orig(self, h)
        res.overflow = True
        fetched.append(h[1].has_short)
        return res

    monkeypatch.setattr(tcg.CandGen, "fetch", overflowing)
    tal = tpipe.UnpairedAligner(tidx, device="cpu")
    got = _port_sam(tal.align_batch(make_batch(names, seqs, quals)),
                    tidx.ref_names)
    assert got == want
    assert len(fetched) == 3                  # 1x, 2x, 4x


@pytest.mark.parametrize("path", ["fused", "host"])
def test_paired_short_mates_identical(genome, path):
    """FR pairs of 36 bp mates, a few with mismatches: through the general
    shape for both mates, and through the host path (-k 2000), where mate
    2's collect takes the seed_skip of mate 1's round-0 seed failures at
    wait."""
    chrom, _, idxs = genome
    jidx, tidx = idxs["full" if path == "fused" else "nomirror"]
    rng = np.random.default_rng(13)
    s1, s2 = [], []
    for p in range(200):
        st = int(rng.integers(0, len(chrom) - 400))
        end = st + int(rng.integers(150, 350))
        m1 = chrom[st : st + 36].copy()
        m2 = (3 - chrom[end - 36 : end])[::-1].copy()
        if p % 5 == 0:
            m1[rng.integers(0, 36)] ^= 1
        if p % 7 == 0:
            m2[rng.integers(0, 36)] ^= 2
        s1.append(dna.decode(m1).encode())
        s2.append(dna.decode(m2).encode())
    names = [f"p{i}" for i in range(200)]
    quals = [b"I" * 36] * 200
    pol = ({} if path == "fused"
           else dict(khits=2000, mhits=0, msample=False))
    jp = JPaired(jidx, policy=JPolicy(**pol)).align_batch(
        j_make_batch(names, s1, quals), j_make_batch(names, s2, quals))
    want = [j_sam(r, jidx.ref_names) for pr in jp for r in pr]
    tp = PairedAligner(tidx, policy=tpipe.SearchPolicy(**pol),
                       device="cpu").align_batch(
        make_batch(names, s1, quals), make_batch(names, s2, quals))
    got = [sam_record(r, tidx.ref_names) for pr in tp for r in pr]
    assert got == want
    assert tp.n_concordant() > 180


@pytest.mark.parametrize("opts", [["-N", "1", "-L", "20"], ["-k", "5"],
                                  ["-a"], ["--no-1mm-upfront", "-i",
                                           "S,1,0.5"]],
                         ids=["N1", "k5", "a", "no1mm_ival"])
def test_cli_same_sam_as_jax_cli(genome, tmp_path, monkeypatch, capsys,
                                 opts):
    from bowtie2_server_tpu.__main__ import main as jax_main
    from bowtie2_server_tpu_torch.__main__ import main as port_main
    chrom, unit, idxs = genome
    monkeypatch.chdir(tmp_path)
    jidx = idxs["full"][0]
    fa = tmp_path / "ref.fa"
    fa.write_text("".join(
        f">{n}\n{dna.decode(jidx.joined[s:e])}\n"
        for n, s, e in zip(jidx.ref_names, jidx.run_joined_start,
                           list(jidx.run_joined_start[1:]) + [jidx.n])))
    seqs = ([dna.decode(unit).encode()] + _short_reads(chrom, 60, 14)
            + _n1_reads(chrom, 20, 15))
    with open(tmp_path / "reads.fq", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@c{i}\n{s.decode()}\n+\n{'I' * len(s)}\n")
    port_main(["build", str(fa), "idx"])   # the JAX CLI aligns on it too
    capsys.readouterr()
    jax_main(["align", "-x", "idx", "-U", "reads.fq", "-S", "jax.sam",
              "--cpu", *opts])
    j_err = capsys.readouterr().err
    port_main(["align", "-x", "idx", "-U", "reads.fq", "-S", "port.sam",
               "--device", "cpu", *opts])
    t_err = capsys.readouterr().err

    def strip_pg(path):
        return [ln for ln in open(path).read().splitlines()
                if not ln.startswith("@PG")]

    want, got = strip_pg("jax.sam"), strip_pg("port.sam")
    assert got == want
    assert len(got) >= len(seqs) + len(jidx.ref_names) + 1

    def summary(err):
        return [ln for ln in err.splitlines() if not ln.startswith("#")]

    assert summary(t_err) == summary(j_err)
