"""The paired slice: the port's PairedAligner (device 'cpu', the plain torch
versions of the kernels) writes SAM byte-identical to the JAX package's
PairedAligner, end-to-end and --local, with mate rescue exercised; its pair
classification equals the JAX package's; and the port's paired CLI writes
the same SAM and summary as the JAX CLI."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

from bowtie2_server_tpu.align import paired as jpaired  # noqa: E402
from bowtie2_server_tpu.align.pipeline import SearchPolicy as JPolicy  # noqa
from bowtie2_server_tpu.index.build import build_index  # noqa: E402
from bowtie2_server_tpu.io.fastq import make_batch as j_make_batch  # noqa
from bowtie2_server_tpu.io.sam import sam_record as j_sam  # noqa: E402
from bowtie2_server_tpu.utils import dna  # noqa: E402
from bowtie2_server_tpu.utils.presets import preset_params  # noqa: E402
from bowtie2_server_tpu_torch.align import paired as tpaired  # noqa: E402
from bowtie2_server_tpu_torch.align.pipeline import SearchPolicy  # noqa
from bowtie2_server_tpu_torch.index.fm import FmIndex  # noqa: E402
from bowtie2_server_tpu_torch.io.fastq import make_batch  # noqa: E402
from bowtie2_server_tpu_torch.io.sam import sam_record  # noqa: E402

READ_LEN = 150
CHROM_LEN = 100_000


def make_pairs(rng, chroms, n):
    """bench_paired.py-shaped FR pairs: 150 bp mates of a fragment drawn
    from N(350, 40) clipped to [300, 600], 0-3 substitutions per mate, mate
    1 on the forward strand in half the pairs. Every 25th pair has a mate 2
    with a substitution every 16 bases (no 22-mer seed survives, so mate
    rescue must find it), every 25th (offset 8) has its mates 20 kbp apart
    (discordant), and every 25th (offset 16) a random mate 2 (mixed)."""
    names, s1, s2 = [], [], []
    for p in range(n):
        ci = int(rng.integers(0, len(chroms)))
        g = chroms[ci]
        frag = int(np.clip(rng.normal(350, 40), 2 * READ_LEN, 600))
        st = int(rng.integers(0, CHROM_LEN - frag - 20_000))
        end2 = st + frag
        if p % 25 == 8:
            end2 += 20_000
        m1 = g[st : st + READ_LEN].copy()
        m2 = dna.revcomp(g[end2 - READ_LEN : end2])
        for m in (m1, m2):
            for _ in range(int(rng.integers(0, 4))):
                m[rng.integers(0, READ_LEN)] = rng.integers(0, 4)
        if p % 25 == 0:
            at = np.arange(int(rng.integers(0, 16)), READ_LEN, 16)
            m2[at] = (m2[at] + rng.integers(1, 4, len(at))) % 4
        elif p % 25 == 16:
            m2 = rng.integers(0, 4, READ_LEN).astype(np.uint8)
        if p % 2:
            m1, m2 = m2, m1
        names.append(f"p{p}")
        s1.append(dna.decode(m1).encode())
        s2.append(dna.decode(m2).encode())
    q1 = [bytes(rng.integers(35, 74, READ_LEN).astype(np.uint8))
          for _ in range(n)]
    q2 = [bytes(rng.integers(35, 74, READ_LEN).astype(np.uint8))
          for _ in range(n)]
    return names, (s1, q1), (s2, q2)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """Two chromosomes of 100 kbp (index built and saved by the JAX package,
    loaded by the port) and 400 pairs."""
    rng = np.random.default_rng(17)
    d = tmp_path_factory.mktemp("torch_paired")
    chroms = [rng.integers(0, 4, CHROM_LEN).astype(np.uint8)
              for _ in range(2)]
    idx = build_index("".join(f">chr{i} extra words\n{dna.decode(c)}\n"
                              for i, c in enumerate(chroms)))
    idx.save(d / "genome")
    return idx, FmIndex.load(d / "genome"), make_pairs(rng, chroms, 400)


def _sam_lines(pairs, sam, ref_names):
    return [sam(r, ref_names) for r1, r2 in pairs for r in (r1, r2)]


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_paired_sam_identical(workload, local, monkeypatch):
    jidx, tidx, (names, (s1, q1), (s2, q2)) = workload
    if local:    # local winners all take the host traceback: fewer pairs
        names, s1, q1, s2, q2 = (x[:100] for x in (names, s1, q1, s2, q2))
    sc, pol = preset_params(None, local)
    jpal = jpaired.PairedAligner(jidx, scoring=sc, policy=JPolicy(**pol),
                                 engine="xla")
    jpairs = jpal.align_batch(j_make_batch(names, s1, q1),
                              j_make_batch(names, s2, q2))
    want = _sam_lines(jpairs, j_sam, jidx.ref_names)

    rescues = []
    orig = tpaired.sw_align_batch
    monkeypatch.setattr(tpaired, "sw_align_batch", lambda *a, **k: (
        rescues.append(len(a[0])), orig(*a, **k))[1])
    sc, pol = preset_params(None, local)
    tpal = tpaired.PairedAligner(tidx, scoring=sc,
                                 policy=SearchPolicy(**pol), device="cpu")
    tpairs = tpal.align_batch(make_batch(names, s1, q1),
                              make_batch(names, s2, q2))
    got = _sam_lines(tpairs, sam_record, tidx.ref_names)
    assert got == want
    assert rescues, "mate rescue never ran its rectangle DP"
    yt = [ln.rsplit("YT:Z:", 1)[1][:2] for ln in got]
    assert {"CP", "UP"} <= set(yt)
    if not local:
        assert "DP" in yt
    # the seedless mates 2 were found by rescue: concordant, at their origin
    cp = [r1.proper for r1, _ in tpairs]
    assert sum(cp[0::25]) >= 0.75 * len(cp[0::25])
    assert sum(cp) > 0.8 * len(cp)


@pytest.mark.parametrize("pol", ["FR", "RF", "FF"])
def test_classify_equals_jax(pol):
    rng = np.random.default_rng(5)
    for dove, olap, cont, lo, hi in ((False, True, True, 0, 500),
                                     (True, True, False, 50, 300),
                                     (False, False, True, 10, 400)):
        kw = dict(pol=pol, minfrag=lo, maxfrag=hi, dovetail_ok=dove,
                  olap_ok=olap, contain_ok=cont)
        jpe, tpe = jpaired.PairedPolicy(**kw), tpaired.PairedPolicy(**kw)
        n = 300
        o1 = rng.integers(0, 600, n)
        o2 = o1 + rng.integers(-400, 400, n)
        l1 = rng.integers(30, 160, n)
        l2 = rng.integers(30, 160, n)
        f1 = rng.random(n) < 0.5
        f2 = rng.random(n) < 0.5
        np.testing.assert_array_equal(
            tpe.classify_batch(o1, l1, f1, o2, l2, f2),
            jpe.classify_batch(o1, l1, f1, o2, l2, f2))
        for t in range(n):
            a = (int(o1[t]), int(l1[t]), bool(f1[t]), int(o2[t]),
                 int(l2[t]), bool(f2[t]))
            assert tpe.classify(*a) == jpe.classify(*a), (kw, a)


@pytest.mark.parametrize("opts", [
    [], ["-I", "320", "-X", "420", "--no-mixed", "--no-discordant"],
    ["--ff", "--local"]], ids=["default", "limits", "ff_local"])
def test_paired_cli_same_sam_as_jax_cli(workload, tmp_path, monkeypatch,
                                        capsys, opts):
    from bowtie2_server_tpu.__main__ import main as jax_main
    from bowtie2_server_tpu_torch.__main__ import main as port_main
    monkeypatch.chdir(tmp_path)
    jidx, _, (names, (s1, q1), (s2, q2)) = workload
    n = 60 if "--local" in opts else 150
    fa = tmp_path / "ref.fa"
    fa.write_text("".join(
        f">{nm}\n{dna.decode(jidx.joined[s:e])}\n"
        for nm, s, e in zip(jidx.ref_names, jidx.run_joined_start,
                            list(jidx.run_joined_start[1:]) + [jidx.n])))
    for tag, seqs, quals in (("1", s1, q1), ("2", s2, q2)):
        with open(tmp_path / f"r{tag}.fq", "w") as f:
            for nm, s, q in zip(names[:n], seqs[:n], quals[:n]):
                f.write(f"@{nm}/{tag}\n{s.decode()}\n+\n{q.decode()}\n")
    port_main(["build", str(fa), "idx"])
    capsys.readouterr()
    args = ["align", "-x", "idx", "-1", "r1.fq", "-2", "r2.fq", "--seed", "3",
            *opts]
    jax_main(args + ["-S", "jax.sam", "--cpu"])
    j_err = capsys.readouterr().err
    port_main(args + ["-S", "port.sam", "--device", "cpu"])
    t_err = capsys.readouterr().err

    def strip_pg(path):
        return [ln for ln in open(path).read().splitlines()
                if not ln.startswith("@PG")]

    want, got = strip_pg("jax.sam"), strip_pg("port.sam")
    assert got == want
    assert len(got) == 2 * n + len(jidx.ref_names) + 1

    def summary(err):
        return [ln for ln in err.splitlines() if not ln.startswith("#")]

    assert summary(t_err) == summary(j_err)
    assert "were paired" in t_err


def test_cli_needs_both_mates():
    from bowtie2_server_tpu_torch.__main__ import main as port_main
    with pytest.raises(SystemExit) as e:
        port_main(["align", "-x", "i", "-1", "r1.fq"])
    assert "-1 <m1.fq> -2 <m2.fq>" in str(e.value)
