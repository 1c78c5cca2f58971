"""The port's 'dp' mesh (bowtie2_server_tpu_torch/parallel/mesh.py and the
sharded dispatch of align/candgen.py) against the JAX package's on the CPU:
the JAX side runs on the 8 virtual CPU devices of tests/conftest.py, the
port side on a mesh of logical CPU shards (`Mesh([cpu] * n)`). Tolerance
0 throughout: the sharded packed output, every decoded BatchResult field,
the per-shard CandGenCfg and the SAM are exact against the JAX package on
the same synthetic genome and reads (a seeded numpy RNG), and the sharded
SAM equals the port's one-device SAM. Read counts are not multiples of the
shard count, so the shards' padding shows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

from bowtie2_server_tpu.align import candgen as jcg  # noqa: E402
from bowtie2_server_tpu.align.pipeline import (  # noqa: E402
    SearchPolicy as JPolicy, UnpairedAligner as JAligner)
from bowtie2_server_tpu.index.build import build_index  # noqa: E402
from bowtie2_server_tpu.io.fastq import make_batch as j_make_batch  # noqa
from bowtie2_server_tpu.io.sam import sam_record as j_sam  # noqa: E402
from bowtie2_server_tpu.parallel import mesh as jmesh  # noqa: E402
from bowtie2_server_tpu.utils import dna  # noqa: E402
from bowtie2_server_tpu.utils.presets import preset_params  # noqa: E402
from bowtie2_server_tpu_torch import convert  # noqa: E402
from bowtie2_server_tpu_torch.align import candgen as tcg  # noqa: E402
from bowtie2_server_tpu_torch.align.pipeline import (  # noqa: E402
    SearchPolicy, UnpairedAligner)
from bowtie2_server_tpu_torch.io.fastq import make_batch  # noqa: E402
from bowtie2_server_tpu_torch.io.sam import sam_record  # noqa: E402
from bowtie2_server_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from test_torch_candgen import _reads, _to_port  # noqa: E402

CPU = torch.device("cpu")
UNIQUE_LEN, MOTIF_LEN, MOTIF_COPIES = 30_000, 60, 12
# seed-table fields of CandGenCfg: the general shape reads no seed table
# (the port gives it none; the JAX package a table it does not read)
KMER_FIELDS = {"kmer_mode", "kmer_steps", "n_hi", "n_lo", "bbits", "tbits",
               "salt"}

# case: (reads: [(count, lengths, source)], policy fields, local, big)
CASES = {
    "fast": ([(300, (100,), "unique")], {}, False, False),
    "local": ([(150, (100,), "unique")], {}, True, False),
    "general": ([(300, (18, 25, 36, 45, 60), "unique")], {}, False, False),
    "n1": ([(150, (50,), "unique")], {"n_seed_mms": 1}, False, False),
    # tests/test_torch_mesh_big.py:
    "big": ([(300, (100,), "unique")], {}, False, True),
    # 450 reads of the tandem repeat overflow shard 0's first capacities:
    # the batch runs again at 2x and 4x, and 4x sticks
    "escalate": ([(450, (100,), "repeat"), (3645, (100,), "unique")], {},
                 False, False),
}


@pytest.fixture(scope="module")
def genome():
    """30 kbp of random sequence, then 12 copies of a 60 bp motif."""
    rng = np.random.default_rng(41)
    motif = rng.integers(0, 4, MOTIF_LEN).astype(np.uint8)
    g = np.concatenate([rng.integers(0, 4, UNIQUE_LEN).astype(np.uint8),
                        np.tile(motif, MOTIF_COPIES)])
    return g, build_index(f">g\n{dna.decode(g)}\n")


def _recording(module, calls, jax_side):
    """A stand-in for module._sharded_pipeline that records each call:
    JAX (didx, dkm, cfg, numpy inputs, numpy output); port cfg."""
    orig = module._sharded_pipeline
    if not jax_side:
        def port(cfg, *args):
            calls.append(cfg)
            return orig(cfg, *args)
        return port

    def jax(cfg, mesh):
        fn = orig(cfg, mesh)

        def run(didx, dkm, *arrays):
            out = fn(didx, dkm, *arrays)
            calls.append((didx, dkm, cfg, [np.asarray(a) for a in arrays],
                          np.asarray(out)))
            return out
        return run
    return jax


def _aligned(module, calls, jax_side, fn):
    rec = _recording(module, calls, jax_side)
    orig, module._sharded_pipeline = module._sharded_pipeline, rec
    try:
        return fn()
    finally:
        module._sharded_pipeline = orig


@pytest.fixture(scope="module")
def runs(genome):
    """(case, n) -> one run of the JAX aligner over a mesh of n virtual
    devices, the port's over n logical CPU shards and the port's on the
    CPU alone, on the case's reads (computed once a module)."""
    g, idx = genome
    cache = {}

    def get(case, n):
        if (case, n) in cache:
            return cache[case, n]
        groups, polkw, local, big = CASES[case]
        rng = np.random.default_rng(len(case) * 10 + n)
        seqs = []
        for count, lens, src in groups:
            text = g[:UNIQUE_LEN] if src == "unique" else g[UNIQUE_LEN:]
            seqs += _reads(rng, text, count, lens=lens, nmm=2)
        names = [f"r{i}" for i in range(len(seqs))]
        quals = [bytes(rng.integers(35, 74, len(s)).astype(np.uint8))
                 for s in seqs]
        sc, pol = preset_params(None, local)
        pol = {**pol, **polkw}
        jcalls, tcalls = [], []
        jal = JAligner(idx, scoring=sc, policy=JPolicy(**pol), engine="xla",
                       mesh=jmesh.make_mesh(n), force_big=big)
        jrecs = _aligned(jcg, jcalls, True, lambda: jal.align_batch(
            j_make_batch(names, seqs, quals)))
        tal = UnpairedAligner(idx, scoring=sc, policy=SearchPolicy(**pol),
                              mesh=tmesh.Mesh([CPU] * n), force_big=big)
        batch = make_batch(names, seqs, quals)
        trecs = _aligned(tcg, tcalls, False, lambda: tal.align_batch(batch))
        one = UnpairedAligner(idx, scoring=sc, policy=SearchPolicy(**pol),
                              device="cpu", force_big=big).align_batch(batch)
        cache[case, n] = dict(
            B0=len(seqs), jcalls=jcalls, tcfgs=tcalls,
            jsam=[j_sam(r, idx.ref_names) for r in jrecs],
            tsam=[sam_record(r, idx.ref_names) for r in trecs],
            one=[sam_record(r, idx.ref_names) for r in one],
            sticky=(jal.candgen._sticky, tal.candgen._sticky))
        return cache[case, n]
    return get


def check_packed(r, n):
    """Each sharded dispatch of the JAX aligner, replayed through the
    port's `_sharded_pipeline` on n logical CPU shards: the same packed
    output, and every BatchResult field decoded the same."""
    assert r["jcalls"]
    for didx, dkm, cfg, (packed, meta, mmtab), want in r["jcalls"]:
        tdidx, tdkm, tcfg = _to_port(didx, dkm, cfg)
        shards = tcg._sharded_pipeline(
            tcfg, [CPU] * n, {CPU: tdidx}, {CPU: tdkm}, packed, meta,
            {CPU: torch.from_numpy(mmtab.copy())})
        assert len(shards) == n
        got = tcg._gather(shards)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        jr = jcg.BatchResult(r["B0"], want, cfg, n, cfg.K)
        tr = tcg.BatchResult(r["B0"], got, tcfg, n, cfg.K)
        for name in jcg.BatchResult.__slots__:
            w, h = getattr(jr, name), getattr(tr, name)
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(h, w, err_msg=name)
            else:
                assert h == w, name


def check_cfg(r, n):
    """The port's per-shard CandGenCfg equals the JAX one field for field
    at every dispatch of the batch (the seed-table fields aside on the
    general shape, which reads no seed table): B = the JAX B_local, and
    the capacities and the pack5 gate follow from it."""
    assert len(r["tcfgs"]) == len(r["jcalls"])
    B_local = tcg._pow2(-(-r["B0"] // n), lo=max(256 // n, 64))
    for (_, _, jcfg, _, _), tcfg in zip(r["jcalls"], r["tcfgs"]):
        want = convert.cfg_from_fields(jcfg._asdict())._asdict()
        got = tcfg._asdict()
        assert got.keys() == want.keys()
        for k in want:
            if k in KMER_FIELDS and got["has_short"]:
                continue
            assert got[k] == want[k], k
        assert tcfg.B == B_local
        assert tcfg.pack5 == (tcfg.L <= 256 and tcfg.K <= 256
                              and n * B_local <= 1 << 18)


def check_sam(r):
    """UnpairedAligner(mesh=) SAM equals the JAX
    UnpairedAligner(mesh=make_mesh(n)) SAM and the port's one-device
    SAM."""
    assert len(r["tsam"]) >= r["B0"]
    assert r["tsam"] == r["jsam"]
    assert r["tsam"] == r["one"]
    aligned = sum(int(ln.split("\t")[1]) & 4 == 0 for ln in r["tsam"])
    assert aligned >= 0.8 * r["B0"]


RUNS = [("fast", 2), ("fast", 8), ("general", 2), ("general", 8),
        ("n1", 2)]


@pytest.mark.parametrize("case,n", RUNS, ids=[f"{c}-{n}" for c, n in RUNS])
def test_sharded_packed_output_equal(runs, case, n):
    """Exact (check_packed)."""
    check_packed(runs(case, n), n)


@pytest.mark.parametrize("case,n", RUNS, ids=[f"{c}-{n}" for c, n in RUNS])
def test_shard_cfg_equal(runs, case, n):
    """Exact (check_cfg)."""
    check_cfg(runs(case, n), n)


SAM = [("fast", 2), ("fast", 8), ("local", 2), ("general", 2)]


@pytest.mark.parametrize("case,n", SAM, ids=[f"{c}-{n}" for c, n in SAM])
def test_mesh_sam_equal(runs, case, n):
    """Exact (check_sam), end-to-end, --local and the general shape."""
    check_sam(runs(case, n))


# ---- the mesh itself, and the small sharded step -------------------------

def test_mesh_devices_and_make_mesh(monkeypatch):
    m = tmesh.Mesh(["cpu"] * 8)
    assert m.size == 8 and m.distinct == (CPU,)
    assert repr(m) == "Mesh('dp': " + str(["cpu"] * 8) + ")"
    m = tmesh.Mesh(["cuda:0", "cuda:1", "cuda:0"])
    assert m.size == 3 and [str(d) for d in m.distinct] == ["cuda:0",
                                                            "cuda:1"]
    for bad in ([], ["cpu", "cuda:0"], ["cuda"]):
        with pytest.raises(ValueError):
            tmesh.Mesh(bad)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [str(d) for d in tmesh.make_mesh().devices] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert [str(d) for d in tmesh.make_mesh(2).devices] == ["cuda:0",
                                                           "cuda:1"]
    assert tmesh.make_mesh(4, device="cuda:1").devices == (
        torch.device("cuda:1"),) * 4
    assert tmesh.make_mesh(3, device="cpu").devices == (CPU,) * 3
    with pytest.raises(ValueError, match=r"needs 5 cards \(have 4\)"):
        tmesh.make_mesh(5)


def test_replicate_shares_tensors_on_the_same_device(genome):
    _, idx = genome
    didx = tcg.make_device_index(idx, CPU)
    rep = tmesh.replicate(didx, CPU)
    assert type(rep) is type(didx)
    assert all(a is b for a, b in zip(rep, didx) if torch.is_tensor(a))


def test_sharded_step_equal_jax():
    """Exact: make_sharded_step over 8 logical CPU shards gives the same
    best, offs and n_aligned as the JAX step over the 8-device virtual
    mesh, on dryrun_multichip's index and reads plus reads with no exact
    hit (offs -1) and some scoring below minsc."""
    import jax
    import jax.numpy as jnp
    from bowtie2_server_tpu.ops.fm import to_device as j_to_device
    from bowtie2_server_tpu.ops.sw import SwConfig as JSw
    from bowtie2_server_tpu_torch.ops import fm as tfm
    from bowtie2_server_tpu_torch.ops.sw import SwConfig as TSw
    n, K, L = 8, 32, 32
    B = 8 * n
    rng = np.random.default_rng(0)
    text = dna.decode(rng.integers(0, 4, 2048).astype(np.uint8))
    idx = build_index(f">r\n{text}\n", both_directions=False)
    reads = np.zeros((B, L), np.uint8)
    for b in range(B):
        s = rng.integers(0, idx.n - L)
        reads[b] = idx.joined[s : s + L]
    reads[::5] = rng.integers(0, 4, (len(reads[::5]), L))   # no exact hit
    lens = rng.integers(24, L + 1, B).astype(np.int32)
    mmpen = rng.integers(2, 7, (B, L)).astype(np.int32)
    minsc = -20
    step = jmesh.make_sharded_step(jax.sharding.Mesh(
        np.array(jax.devices()[:n]), ("dp",)), JSw(), K)
    want = [np.asarray(x) for x in step(
        j_to_device(idx.fw), jnp.asarray(idx.joined), jnp.asarray(reads),
        jnp.asarray(lens), jnp.asarray(mmpen), jnp.int32(minsc))]
    tstep = tmesh.make_sharded_step(tmesh.Mesh([CPU] * n), TSw(), K)
    got = [x.numpy() for x in tstep(
        tfm.to_device(idx.fw, CPU), torch.from_numpy(idx.joined),
        *(torch.from_numpy(a) for a in (reads, lens, mmpen)), minsc)]
    for w, h, name in zip(want, got, ("best", "offs", "n_aligned")):
        np.testing.assert_array_equal(h, w, err_msg=name)
    assert (got[1] == -1).any() and 0 < int(got[2]) < B


@pytest.mark.parametrize("dryrun", ["dryrun_multichip",
                                    "dryrun_full_pipeline"])
def test_dryruns_on_eight_cpu_shards(dryrun):
    """The twins of tests/test_multichip.py without the lambda genome:
    each dry run's own checks pass on 8 logical CPU shards."""
    getattr(tmesh, dryrun)(8, "cpu")
