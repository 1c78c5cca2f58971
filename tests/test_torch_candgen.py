"""The port's fused pipeline (bowtie2_server_tpu_torch/align/candgen.py)
against the JAX package's `fused_pipeline` (engine 'xla'): the state and
config that the JAX UnpairedAligner dispatches are carried across with
convert.py, and the packed output rows must be identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from bowtie2_server_tpu.align import candgen as jcg  # noqa: E402
from bowtie2_server_tpu.align.pipeline import (  # noqa: E402
    SearchPolicy, UnpairedAligner)
from bowtie2_server_tpu.index.build import build_index  # noqa: E402
from bowtie2_server_tpu.utils import dna  # noqa: E402
from bowtie2_server_tpu.utils.presets import preset_params  # noqa: E402
from bowtie2_server_tpu_torch import convert  # noqa: E402
from bowtie2_server_tpu_torch.align import candgen as tcg  # noqa: E402


def _to_port(didx, dkm, cfg):
    fm = lambda d: {k: np.asarray(v) for k, v in d._asdict().items()}
    tdidx, tdkm = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in didx._asdict().items()
         if k in convert.INDEX_FIELDS}, fm(dkm), "cpu",
        fw=fm(didx.fw), mirror=fm(didx.mirror))
    return tdidx, tdkm, convert.cfg_from_fields(cfg._asdict())


def _run_both(didx, dkm, cfg, arrays):
    jcfg = cfg._replace(engine="xla")
    want = np.asarray(jcg.fused_pipeline(didx, dkm, jcfg, *arrays))
    tdidx, tdkm, tcfg = _to_port(didx, dkm, jcfg)
    got = tcg.fused_pipeline(tdidx, tdkm, tcfg,
                             *(torch.from_numpy(np.array(a))
                               for a in arrays))
    return want, got.numpy(), tcfg


@pytest.fixture(scope="module")
def entry_state():
    """The exact state UnpairedAligner dispatches on a 16 kbp genome
    (uniform 64 bp reads: static schedule, one-plane upload, pack5)."""
    fn, (didx, dkm, *arrays) = __graft_entry__.entry()
    cfg = dict(zip(fn.__code__.co_freevars,
                   (c.cell_contents for c in fn.__closure__)))["cfg"]
    return didx, dkm, cfg, arrays


def _assert_batch_results_equal(want_out, got_out, jcfg, tcfg, B0, K):
    jr = jcg.BatchResult(B0, want_out, jcfg, 1, K)
    tr = tcg.BatchResult(B0, got_out, tcfg, 1, K)
    for name in jcg.BatchResult.__slots__:
        w, g = getattr(jr, name), getattr(tr, name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


@pytest.mark.parametrize("pack5", [True, False], ids=["pack5", "7row"])
def test_entry_fused_pipeline_equal(entry_state, pack5):
    didx, dkm, cfg, arrays = entry_state
    assert cfg.sched is not None and cfg.raw_len and cfg.pack5
    cfg = cfg._replace(pack5=pack5, C_max=cfg.C_max if pack5 else 4096)
    want, got, tcfg = _run_both(didx, dkm, cfg, arrays)
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)
    B0 = int((np.asarray(arrays[1])[:, 0] != 0).sum())
    _assert_batch_results_equal(want, got, cfg, tcfg, B0, cfg.K)


def _capture(al, seqs, quals=None):
    """(didx, dkm, cfg, arrays) that `al` dispatches for these reads."""
    from bowtie2_server_tpu.io.fastq import make_batch
    names = [f"r{i}" for i in range(len(seqs))]
    quals = quals or [b"I" * len(s) for s in seqs]
    batch = make_batch(names, seqs, quals)
    captured = {}
    orig = jcg.fused_pipeline

    def capture(didx, dkm, cfg, *arrays):
        captured["v"] = (didx, dkm, cfg, arrays)
        return orig(didx, dkm, cfg, *arrays)

    jcg.fused_pipeline = capture
    try:
        h = al.collect_async(batch)
    finally:
        jcg.fused_pipeline = orig
    al.collect_wait(h)
    return captured["v"], len(seqs)


def _reads(rng, g, n, lens, nmm=3, n_rate=0.02):
    seqs = []
    for i in range(n):
        rl = int(lens[i % len(lens)])
        s = int(rng.integers(0, len(g) - rl))
        r = g[s : s + rl].copy()
        for _ in range(int(rng.integers(0, nmm + 1))):
            r[rng.integers(0, rl)] = rng.integers(0, 4)
        if rng.random() < n_rate:
            r[rng.integers(0, rl)] = 4
        if rng.random() < 0.5:
            r = np.where(r < 4, 3 - r, r)[::-1]
        seqs.append(dna.decode(r).encode())
    return seqs


@pytest.fixture(scope="module")
def genome():
    """16 kbp random plus 350 copies of a 60 bp motif: reads from the
    repeat make round 0 seeds too frequent, so the compacted reseed round
    runs."""
    rng = np.random.default_rng(77)
    motif = rng.integers(0, 4, 60).astype(np.uint8)
    g = np.concatenate([rng.integers(0, 4, 16_000).astype(np.uint8),
                        np.tile(motif, 350)])
    return g, build_index(f">g\n{dna.decode(g)}\n")


@pytest.mark.parametrize("case", ["mixed_e2e", "mixed_local",
                                  "uniform_local", "repeat_e2e"])
def test_dispatched_fused_pipeline_equal(genome, case):
    g, idx = genome
    rng = np.random.default_rng(len(case))
    local = case.endswith("local")
    sc, pol = preset_params(None, local)
    al = UnpairedAligner(idx, scoring=sc, policy=SearchPolicy(**pol))
    if case.startswith("mixed"):
        seqs = _reads(rng, g[:16_000], 300, lens=(100, 77, 64, 91))
    elif case.startswith("uniform"):
        seqs = _reads(rng, g[:16_000], 300, lens=(100,))
    else:
        seqs = (_reads(rng, g[16_000:], 200, lens=(100,), nmm=1)
                + _reads(rng, g[:16_000], 100, lens=(100,)))
    (didx, dkm, cfg, arrays), B0 = _capture(al, seqs)
    assert (cfg.sched is None) == case.startswith("mixed")
    want, got, tcfg = _run_both(didx, dkm, cfg, arrays)
    np.testing.assert_array_equal(got, want)
    _assert_batch_results_equal(want, got, cfg, tcfg, B0, cfg.K)
    if case.startswith("repeat"):
        reseed_max = jcg.BatchResult(B0, want, cfg, 1, cfg.K).counters[0, 8]
        assert reseed_max > 0      # the compacted reseed round had lanes


def test_nonzero_fixed_matches_jnp_nonzero():
    rng = np.random.default_rng(0)
    for n, size in ((1000, 50), (1000, 900), (37, 64), (5, 1)):
        mask = rng.random(n) < 0.3
        want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size,
                                      fill_value=n)[0])
        got = tcg._nonzero_fixed(torch.from_numpy(mask), size, n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_dispatch_refuses_unported_shapes(genome, monkeypatch):
    """The port refuses no shape the JAX package dispatches: meshes run
    (tests/test_torch_mesh*.py), and so do big indexes
    (tests/test_torch_big.py): convert carries a big config across, and an
    index past the threshold takes the big layout on its own."""
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner as TAl
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.ops import fm as tfm
    _, idx = genome
    short = make_batch(["s"], [b"ACGTACGTAC"], [b"IIIIIIIIII"])
    cfg = convert.cfg_from_fields({"sw": {}, "B": 256, "L": 32, "S": 4,
                                   "R": 2, "E": 16, "seed_len": 20, "K": 64,
                                   "k1": 4096, "chunk_w": 8, "n_chunks": 2,
                                   "NH": 8192, "C_pre": 8192, "C_max": 4096,
                                   "big": True, "off_rate": 4})
    assert cfg.big
    # an index past the threshold takes the big layout
    monkeypatch.setattr(tfm, "BIG_THRESHOLD", idx.n)
    al = TAl(idx, device="cpu")
    assert al.big and al.dev.big and al.candgen.big
    assert len(al.align_batch(short)) == 1
