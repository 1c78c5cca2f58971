"""The port on the card: each CUDA kernel equals its plain torch version on
the same CUDA tensors, and UnpairedAligner on 'cuda' writes the same SAM as
on 'cpu'. Every test here needs a CUDA device and skips without one; none
imports JAX, so on a machine with the card (and no JAX) run them with
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bowtie2_server_tpu_torch.ops import kernels  # noqa: E402
from bowtie2_server_tpu_torch.ops import sw as tsw  # noqa: E402
from bowtie2_server_tpu_torch.ops import sw_banded as tsb  # noqa: E402
from torch_tiles import CFGS, RECT_CFGS, banded_tile, rect_tile  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("K", [32, 64, 128])
@pytest.mark.parametrize("name", list(CFGS))
def test_banded_kernel_equals_plain(name, K, cuda_device):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in banded_tile(3 * K, 100, K)]
    cfg = tsw.SwConfig(**CFGS[name])
    n0 = kernels.LAUNCHES["sw_banded"]
    got = tsb.banded_dp(cfg, K, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sw_banded"] == n0 + 1
    want = tsb.banded_tile_torch(cfg, K, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(RECT_CFGS))
def test_sw_kernel_equals_plain(name, cuda_device):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in rect_tile(2, 136, 200)]
    cfg = tsw.SwConfig(**RECT_CFGS[name])
    n0 = kernels.LAUNCHES["sw"]
    got = tsw.sw_tile(cfg, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sw"] == n0 + 1
    want = tsw.sw_tile_torch(cfg, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_banded_kernel_refuses_unbuilt_band(cuda_device):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in banded_tile(1, 20, 256)]
    with pytest.raises(ValueError, match="band width 256"):
        tsb.banded_dp(tsw.SwConfig(), 256, *args)


def _workload(seed=3, n=3000):
    """A 60 kbp chromosome plus 150 contigs of 1 kbp; every other read
    starts within 40 bases of a contig end, so one batch has more than 128
    run-boundary candidates and the rect kernel runs."""
    from bowtie2_server_tpu_torch.index.build import build_index
    from bowtie2_server_tpu_torch.utils import dna
    rng = np.random.default_rng(seed)
    contigs = [rng.integers(0, 4, 60_000).astype(np.uint8)]
    contigs += [rng.integers(0, 4, 1000).astype(np.uint8)
                for _ in range(150)]
    idx = build_index("".join(f">c{i}\n{dna.decode(c)}\n"
                              for i, c in enumerate(contigs)))
    seqs = []
    for i in range(n):
        c = contigs[int(rng.integers(0, len(contigs)))]
        s = int(rng.integers(0, len(c) - 100))
        if i % 2 and len(c) == 1000:
            s = int(rng.choice([rng.integers(0, 40),
                                900 - rng.integers(0, 40)]))
        r = c[s : s + 100].copy()
        for _ in range(int(rng.integers(0, 4))):
            r[rng.integers(0, 100)] = rng.integers(0, 4)
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        seqs.append(dna.decode(r).encode())
    return idx, [f"r{i}" for i in range(n)], seqs, [b"I" * 100] * n


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_aligner_cuda_equals_cpu(local, cuda_device):
    from bowtie2_server_tpu_torch.align.pipeline import (SearchPolicy,
                                                         UnpairedAligner)
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.io.sam import sam_record
    from bowtie2_server_tpu_torch.utils.presets import preset_params
    idx, names, seqs, quals = _workload()
    if local:      # local winners take the host traceback: fewer reads
        names, seqs, quals = names[:600], seqs[:600], quals[:600]
    sc, pol = preset_params(None, local)
    sams = {}
    for dev in ("cpu", cuda_device):
        kernels.reset_launches()
        al = UnpairedAligner(idx, scoring=sc, policy=SearchPolicy(**pol),
                             device=dev)
        recs = al.align_batch(make_batch(names, seqs, quals))
        sams[str(dev)] = [sam_record(recs[i], idx.ref_names)
                          for i in range(len(names))]
    assert sams["cuda"] == sams["cpu"]
    assert kernels.LAUNCHES["sw_banded"] >= 1
    if not local:
        assert kernels.LAUNCHES["sw"] >= 1
