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
from torch_tiles import indel_reads  # noqa: E402

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


@pytest.mark.parametrize("mode", ["--end-to-end", "--local", "-M 5"])
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
              "--cpu", *mode.split(), "--seed", "3"])
    j_err = capsys.readouterr().err
    port_main(["align", "-x", "idx", "-U", "reads.fq", "-S", "port.sam",
               "--device", "cpu", *mode.split(), "--seed", "3"])
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
    """An option of the reference that neither CLI takes (--bowtie2p5, the
    deprecated descent engine) is refused with the JAX parser's message."""
    from bowtie2_server_tpu.__main__ import main as jax_main
    from bowtie2_server_tpu_torch.__main__ import main as port_main
    argv = ["align", "-x", "i", "-U", "r.fq", "--bowtie2p5"]
    errs = []
    for fn in (jax_main, port_main):
        with pytest.raises(SystemExit) as e:
            fn(argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[1].split(": error: ")[1] == errs[0].split(": error: ")[1]
    assert "--bowtie2p5 is not supported: the deprecated 2.5" in errs[1]


@pytest.fixture(scope="module")
def indel_workload():
    """A 300 kbp genome (the port's own index) and 4096 reads of 100 bp cut
    from it, either strand, 0-3 substitutions, one in eight with a planted
    insertion or deletion of 1-3 bases (`torch_tiles.indel_reads`): the
    gapped winners _finish_gapped traces together."""
    from bowtie2_server_tpu_torch.index.build import build_index as tbuild
    fasta, names, seqs, quals = indel_reads(4096, READ_LEN)
    return tbuild(fasta), (names, seqs, quals)


def per_read_gapped(self, st, reads, scores, secs):
    """_finish_gapped as finish_candidate one winner at a time: the
    per-read path the batched commit replaces."""
    ok = np.zeros(len(reads), bool)
    for t, i in enumerate(reads.tolist()):
        ok[t] = self.finish_candidate(st, i, int(st.res.best_ci[i]),
                                      int(scores[t]), secs[t])
    return ok


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_batched_gapped_commit_equals_per_read(indel_workload, local,
                                               monkeypatch):
    """The batched traceback and commit of the fused winners gives the
    records and the --met traceback counts of the per-read path: 4096
    reads end-to-end, 512 in --local (where every winner is traced)."""
    idx, (names, seqs, quals) = indel_workload
    if local:
        names, seqs, quals = names[:512], seqs[:512], quals[:512]
    batch = make_batch(names, seqs, quals)
    sc, pol = t_preset_params(None, local)

    def run():
        al = tpipe.UnpairedAligner(idx, scoring=sc,
                                   policy=tpipe.SearchPolicy(**pol),
                                   device="cpu")
        recs = al.align_batch(batch)
        return [recs[i] for i in range(len(names))], al

    got, al = run()
    monkeypatch.setattr(tpipe.UnpairedAligner, "_finish_gapped",
                        per_read_gapped)
    want, ref = run()
    assert got == want
    assert al.bt_ctr == ref.bt_ctr
    assert al.bt_ctr["bt"] > (400 if local else 200)
    assert al.tb_card == 0      # the CPU runs the oracle
    assert sum(r.aligned for r in got) > 0.99 * len(names)


def test_rejected_gapped_winners_fall_to_the_slow_loop(indel_workload,
                                                       monkeypatch):
    """A traced winner that the commit rejects, by the N ceiling or by a
    run straddle, stays unhandled after _finish_fast, and the per-read
    loop takes it up."""
    idx, (names, seqs, quals) = indel_workload
    names, seqs, quals = names[:256], seqs[:256], quals[:256]
    sc, pol = t_preset_params(None, False)
    al = tpipe.UnpairedAligner(idx, scoring=sc,
                               policy=tpipe.SearchPolicy(**pol),
                               device="cpu")
    st = al.collect(make_batch(names, seqs, quals))
    res = st.res
    w = np.nonzero(~st.filtered & ~res.has_rect & (res.best_ci >= 0)
                   & (res.sec_sc < res.best_sc))[0]
    gapped = w[~res.c_ungapped[res.best_ci[w]]]
    assert len(gapped) >= 4
    a, b = int(gapped[0]), int(gapped[1])
    st.nceil[a] = -1           # no reference N allowed below zero
    ws_b = int(res.c_ws[res.best_ci[b]])
    orig = al.idx.joined_to_ref

    def straddle(jp, aln_len=None):
        ref_id, ref_off, valid = orig(jp, aln_len=aln_len)
        if aln_len is not None:
            valid = valid & ~((jp >= ws_b) & (jp < ws_b + 100 + al.band))
        return ref_id, ref_off, valid

    monkeypatch.setattr(al.idx, "joined_to_ref", straddle)
    handled = al._finish_fast(st)
    assert not handled[a] and not handled[b]
    assert handled[gapped[2:]].all()
    assert al.bt_ctr["btfail"] == 2
    assert al.bt_ctr["btsucc"] == al.bt_ctr["bt"] - 2
    for i in np.nonzero(~handled)[0]:
        al.select_unpaired(st, i)
    # the loop committed both again from their traces, and rejected them
    # again
    assert al.bt_ctr["btfail"] >= 4
