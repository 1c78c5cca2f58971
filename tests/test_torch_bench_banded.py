"""The port's banded-DP bench (bowtie2_server_tpu_torch/scripts/
bench_banded.py) on the CPU: its length mixes, its bound (the operations of
the rows below each length), and its run, which holds the wrapper to the
plain version (on the CPU both are the plain version, so only the control
flow is checked) and to the JAX Pallas kernel, interpreted."""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bowtie2_server_tpu.ops import sw as jsw  # noqa: E402
from bowtie2_server_tpu.ops import sw_banded as jsb  # noqa: E402
from bowtie2_server_tpu_torch.ops.sw import SwConfig  # noqa: E402
from bowtie2_server_tpu_torch.ops.sw_banded import banded_dp  # noqa: E402
from bowtie2_server_tpu_torch.scripts import bench_banded  # noqa: E402

# the bench's shapes cut to a size the CPU runs in a second
TINY = {"k64": (40, 32, 64, None), "k64_len100": (40, 32, 64, 25),
        "k32": (24, 32, 32, None), "k256": (16, 24, 256, None),
        "k256_len100": (16, 24, 256, 19), "k512": (8, 24, 512, None)}
TINY_GENERAL = {"k64_large_scores": (40, 32, 64, None)}


@pytest.mark.parametrize("every", [None, 100], ids=["mix", "len100"])
def test_banded_inputs_lengths(every):
    rd, mm, lens, band = bench_banded.banded_inputs(1, 500, 64, 128, every)
    assert rd.shape == mm.shape == (128, 500) and band.shape == (192, 500)
    assert all(a.dtype == np.int32 for a in (rd, mm, lens, band))
    assert band.min() >= 0 and band.max() <= 3
    if every is None:   # 4 in 5 of length 128, the fifth of 60-128
        assert (lens[np.arange(500) % 5 != 0] == 128).all()
        short = lens[::5]
        assert short.min() >= 60 and short.max() <= 128
    else:               # the main path's mix: rows past the read padded
        assert (lens == 100).all()
        assert (rd[100:] == 5).all() and (mm[100:] == 0).all()
        assert (mm[:100] >= 2).all() and (mm[:100] <= 6).all()


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_banded_bound(local):
    """Operations of the rows below each length (clipped to [0, Lq]) times
    K, at the recurrence's own count a cell: 10 end-to-end, 12 local."""
    lens = np.array([100, 128, 0, 300, -4])
    ceiling = 3.1e13
    ms, by = bench_banded.banded_bound(lens, 128, 64, local, ceiling)
    assert by == "operations"
    assert ms == pytest.approx((100 + 128 + 128) * 64 * (10 + 2 * local)
                               / ceiling * 1e3)


@pytest.mark.parametrize("every", [None, 25], ids=["mix", "len25"])
def test_bench_inputs_equal_pallas(every):
    """The bench's inputs through the port's wrapper (plain version on the
    CPU) equal the JAX Pallas kernel, interpreted, on the same arrays."""
    lq, K = 32, 64
    arrs = bench_banded.banded_inputs(3, 128, K, lq, every)
    for cfg in bench_banded.MODES.values():
        jcfg = jsw.SwConfig(ma=cfg.ma, local=cfg.local)
        rd, mm, lens, band = (jnp.asarray(a) for a in arrs)
        want = jsb._pallas_banded(jcfg, K, lq, 1, True)(rd, mm, lens[None, :],
                                                        band)
        got = banded_dp(cfg, K, *(torch.from_numpy(a) for a in arrs))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])


def test_bench_banded_cpu_run(monkeypatch, capsys):
    """The script end to end on the CPU at the tiny shapes: one row per
    shape and mode, then the general kernel's row, exact, with its bound
    and the kernel its route times; plain times with plain_reps."""
    monkeypatch.setattr(bench_banded, "SHAPES", TINY)
    monkeypatch.setattr(bench_banded, "GENERAL", TINY_GENERAL)
    bench_banded.main(["--device", "cpu", "--reps", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"] == "cpu" and out["ceiling_ops_per_s"] > 0
    assert [(r["shape"], r["mode"]) for r in out["rows"]] == [
        (s, m) for s in TINY for m in ("e2e", "local")] + [
        ("k64_large_scores", "large_scores")]
    assert [r["kernel"] for r in out["rows"]] == [
        "::banded_kernel<"] * 6 + ["banded_wide_kernel"] * 6 + [
        "banded_general_kernel"]
    for r in out["rows"]:
        assert r["max_abs_err"] == 0 and r["ms"] > 0
        assert r["frac_of_bound"] == pytest.approx(r["bound_ms"] / r["ms"])
    rows = bench_banded.measure(torch.device("cpu"), 1e10, reps=1,
                                plain_reps=1)
    assert all(r["plain_ms"] > 0 for r in rows)
    rows = bench_banded.measure(torch.device("cpu"), 1e10, reps=1,
                                shapes=["k256"])
    assert [(r["shape"], r["mode"]) for r in rows] == [
        ("k256", "e2e"), ("k256", "local")]


def test_bench_shapes_are_the_paths():
    """The wide-band rows at the fused stage's P and Lq, at the bands of
    --dpad 32-63 (both length mixes) and 64-127; the general kernel's row
    at the k64 shape under the tests' LARGE_SCORE_CFG."""
    from bowtie2_server_tpu_torch.align.pipeline import band_for
    from torch_tiles import LARGE_SCORE_CFG
    P, lq = bench_banded.P_FUSED, bench_banded.LQ
    assert bench_banded.SHAPES["k256"] == (P, lq, band_for(32), None)
    assert bench_banded.SHAPES["k256_len100"] == (P, lq, band_for(63), 100)
    assert bench_banded.SHAPES["k512"] == (P, lq, band_for(64), None)
    assert bench_banded.GENERAL == {
        "k64_large_scores": bench_banded.SHAPES["k64"]}
    assert bench_banded.LARGE_SCORE == SwConfig(**LARGE_SCORE_CFG)


# (K, scoring, lq) -> the profiler name part of the kernel banded_dp runs
ROUTES = [
    (32, SwConfig(), 128, "::banded_kernel<"),
    (64, SwConfig(ma=2, local=True), 128, "::banded_kernel<"),
    (128, SwConfig(ma=127, npen=128), 128, "::banded_kernel<"),
    (64, SwConfig(rdg_ext=-1), 128, "::banded_kernel<"),   # e2e: any gaps
    (64, SwConfig(ma=128), 128, "banded_general_kernel"),
    (128, SwConfig(npen=129), 128, "banded_general_kernel"),
    (64, SwConfig(ma=150, npen=2, local=True), 128, "banded_general_kernel"),
    (32, SwConfig(ma=2, local=True, rfg_open=-1), 128,
     "banded_general_kernel"),
    (64, SwConfig(ma=2, local=True), 65537, "banded_general_kernel"),
    (64, SwConfig(), 65537, "::banded_kernel<"),
    (256, SwConfig(), 128, "banded_wide_kernel"),
    (512, SwConfig(ma=150, npen=2, local=True), 128, "banded_wide_kernel"),
    (1024, SwConfig(ma=2, local=True), 128, "banded_wide_kernel"),
]


@pytest.mark.parametrize("K, cfg, lq, want", ROUTES)
def test_route_symbol(K, cfg, lq, want):
    """The kernel the bench times for each route: the register kernel for
    byte scores at K <= 128 (bt2_sw_banded's host rule), its general kernel
    otherwise, the wide-band kernel above K = 128; and each name is a
    kernel of the port's sources."""
    from pathlib import Path
    assert bench_banded.route_symbol(K, cfg, lq) == want
    csrc = Path(bench_banded.sb_mod.__file__).parent / "csrc"
    src = (csrc / ("sw_banded_wide.cu" if K > 128 else "sw_banded.cu")
           ).read_text()
    assert re.search(r"__global__ void[^;{]*\b" + want.strip(":<") + r"\(",
                     src)
