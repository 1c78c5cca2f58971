"""The slice as a whole: the port's UnpairedAligner (device 'cpu', the
plain torch versions of the kernels) writes SAM byte-identical to the JAX
package's UnpairedAligner, end-to-end and --local, and at a --dpad whose
band only the wide-band kernel serves on the card; the port's CLI writes
the same SAM and summary as the JAX CLI."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

from bowtie2_server_tpu.align.pipeline import (  # noqa: E402
    SearchPolicy as JPolicy, UnpairedAligner as JAligner)
from bowtie2_server_tpu.index.build import build_index  # noqa: E402
from bowtie2_server_tpu.io.fastq import make_batch as j_make_batch  # noqa
from bowtie2_server_tpu.io.sam import sam_record as j_sam  # noqa: E402
from bowtie2_server_tpu.utils import dna  # noqa: E402
from bowtie2_server_tpu.utils.presets import preset_params  # noqa: E402
from bowtie2_server_tpu_torch.align import pipeline as tpipe  # noqa: E402
from bowtie2_server_tpu_torch.index.fm import FmIndex  # noqa: E402
from bowtie2_server_tpu_torch.io.fastq import make_batch  # noqa: E402
from bowtie2_server_tpu_torch.io.sam import sam_record  # noqa: E402
from bowtie2_server_tpu_torch.ops.sw_banded import KERNEL_BANDS  # noqa: E402
from bowtie2_server_tpu_torch.utils.presets import (  # noqa: E402
    preset_params as t_preset_params)

READ_LEN = 100


def bench_reads(rng, contigs, n, edge=0):
    """bench.py-shaped reads: 100 bp, 0-3 substitutions, half reverse-
    complemented, a few with an N; names/seqs/quals lists. With `edge`,
    every other read starts within `edge` bases of a contig end."""
    seqs = []
    for i in range(n):
        c = contigs[int(rng.integers(0, len(contigs)))]
        s = int(rng.integers(0, len(c) - READ_LEN))
        if edge and i % 2:
            s = int(rng.choice([rng.integers(0, edge),
                                len(c) - READ_LEN - rng.integers(0, edge)]))
        r = c[s : s + READ_LEN].copy()
        for _ in range(int(rng.integers(0, 4))):
            r[rng.integers(0, READ_LEN)] = rng.integers(0, 4)
        if i % 40 == 0:
            r[rng.integers(0, READ_LEN)] = 4
        if rng.random() < 0.5:
            r = np.where(r < 4, 3 - r, r)[::-1]
        seqs.append(dna.decode(r).encode())
    names = [f"b{i}" for i in range(n)]
    quals = [bytes(rng.integers(35, 74, READ_LEN).astype(np.uint8))
             for _ in range(n)]
    return names, seqs, quals


@pytest.fixture(scope="module")
def workloads(tmp_path_factory):
    """Two indexes saved by the JAX package and loaded by the port: a
    200 kbp genome with 2000 reads, and 300 contigs of 1 kbp with 800
    reads, half of them at contig ends, so that the run-boundary
    candidates exceed 128 in one batch."""
    rng = np.random.default_rng(42)
    d = tmp_path_factory.mktemp("torch_pipeline")
    out = {}
    g = rng.integers(0, 4, 200_000).astype(np.uint8)
    ctg = [rng.integers(0, 4, 1000).astype(np.uint8) for _ in range(300)]
    for name, contigs, n, edge in (("genome", [g], 2000, 0),
                                   ("contigs", ctg, 800, 40)):
        fa = "".join(f">{name}{i} extra words\n{dna.decode(c)}\n"
                     for i, c in enumerate(contigs))
        idx = build_index(fa)
        idx.save(d / name)
        out[name] = (idx, FmIndex.load(d / name),
                     bench_reads(rng, contigs, n, edge))
    return out


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
@pytest.mark.parametrize("which", ["genome", "contigs"])
def test_aligner_sam_identical(workloads, which, local, monkeypatch):
    jidx, tidx, (names, seqs, quals) = workloads[which]
    if local and which == "genome":
        # local winners all take the host traceback: fewer reads
        names, seqs, quals = names[:500], seqs[:500], quals[:500]
    sc, pol = preset_params(None, local)
    jrecs = JAligner(jidx, scoring=sc, policy=JPolicy(**pol)).align_batch(
        j_make_batch(names, seqs, quals))
    want = [j_sam(jrecs[i], jidx.ref_names) for i in range(len(names))]

    rect_jobs = []
    orig = tpipe.sw_align_batch
    monkeypatch.setattr(tpipe, "sw_align_batch", lambda *a, **k: (
        rect_jobs.append(len(a[0])), orig(*a, **k))[1])
    tsc, tpol = t_preset_params(None, local)
    tal = tpipe.UnpairedAligner(tidx, scoring=tsc,
                                policy=tpipe.SearchPolicy(**tpol),
                                device="cpu")
    trecs = tal.align_batch(make_batch(names, seqs, quals))
    got = [sam_record(trecs[i], tidx.ref_names) for i in range(len(names))]
    assert got == want
    assert sum(r.aligned for r in trecs) > 0.95 * len(names)
    if which == "contigs":
        # the rectangle DP ran through the device path, not numpy
        assert rect_jobs and max(rect_jobs) > 128


def test_band_for_lies_in_kernel_bands():
    """Every band width the policy gives for --dpad up to 255 is one the
    CUDA kernels are built for."""
    got = {tpipe.band_for(m) for m in range(256)}
    assert got <= set(KERNEL_BANDS)
    assert {256, 512, 1024} <= got
    assert tpipe.band_for(31) == 128 and tpipe.band_for(32) == 256


def test_wide_band_sam_identical(workloads):
    """--dpad 32 (band K = 256): the same SAM as the JAX package on 300
    reads of the 200 kbp genome."""
    jidx, tidx, (names, seqs, quals) = workloads["genome"]
    names, seqs, quals = names[:300], seqs[:300], quals[:300]
    sc, pol = preset_params(None, False)
    pol = dict(pol, maxhalf=32)
    jrecs = JAligner(jidx, scoring=sc, policy=JPolicy(**pol)).align_batch(
        j_make_batch(names, seqs, quals))
    want = [j_sam(jrecs[i], jidx.ref_names) for i in range(len(names))]
    tsc, tpol = t_preset_params(None, False)
    tal = tpipe.UnpairedAligner(tidx, scoring=tsc,
                                policy=tpipe.SearchPolicy(**dict(
                                    tpol, maxhalf=32)), device="cpu")
    assert tal.band == 256
    trecs = tal.align_batch(make_batch(names, seqs, quals))
    got = [sam_record(trecs[i], tidx.ref_names) for i in range(len(names))]
    assert got == want
    assert sum(r.aligned for r in trecs) > 0.95 * len(names)


@pytest.mark.parametrize("mode", ["--end-to-end", "--local"])
def test_cli_same_sam_as_jax_cli(workloads, tmp_path, monkeypatch, capsys,
                                 mode):
    from bowtie2_server_tpu.__main__ import main as jax_main
    from bowtie2_server_tpu_torch.__main__ import main as port_main
    monkeypatch.chdir(tmp_path)
    jidx, _, (names, seqs, quals) = workloads["contigs"]
    fa = tmp_path / "ref.fa"
    fa.write_text("".join(
        f">{n}\n{dna.decode(jidx.joined[s:e])}\n"
        for n, s, e in zip(jidx.ref_names, jidx.run_joined_start,
                           list(jidx.run_joined_start[1:]) + [jidx.n])))
    with open(tmp_path / "reads.fq", "w") as f:
        for n, s, q in zip(names[:300], seqs[:300], quals[:300]):
            f.write(f"@{n}\n{s.decode()}\n+\n{q.decode()}\n")
    port_main(["build", str(fa), "idx"])   # the JAX CLI aligns on it too
    capsys.readouterr()
    jax_main(["align", "-x", "idx", "-U", "reads.fq", "-S", "jax.sam",
              "--cpu", mode, "--seed", "3"])
    j_err = capsys.readouterr().err
    port_main(["align", "-x", "idx", "-U", "reads.fq", "-S", "port.sam",
               "--device", "cpu", mode, "--seed", "3"])
    t_err = capsys.readouterr().err

    def strip_pg(path):
        return [ln for ln in open(path).read().splitlines()
                if not ln.startswith("@PG")]

    want, got = strip_pg("jax.sam"), strip_pg("port.sam")
    assert got == want
    assert len(got) == 300 + len(jidx.ref_names) + 1

    def summary(err):
        return [ln for ln in err.splitlines() if not ln.startswith("#")]

    assert summary(t_err) == summary(j_err)
    assert "overall alignment rate" in t_err


def test_cli_refuses_other_options(capsys):
    """An option the port's CLI does not take yet (-M, the -M sampling
    bound) is refused, naming the ROADMAP item that ports it."""
    from bowtie2_server_tpu_torch.__main__ import main as port_main
    with pytest.raises(SystemExit) as e:
        port_main(["align", "-x", "i", "-U", "r.fq", "-M", "5"])
    assert "ROADMAP Queue A item 14" in str(e.value)
