"""The DP microbench of the port (bowtie2_server_tpu_torch/scripts/bench_dp.py)
against the JAX package's scripts/bench_dp.py: the same op model, the same
ALU-probe chain, and the same banded DP results on the bench's inputs.

The probe's TPU kernel (`_measure_alu_ceiling.kern`) is a function local to
the JAX script and cannot be imported without editing the script, so the
plain torch chain is held against a numpy rendering of that kernel's body
(scripts/bench_dp.py:49-59)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bowtie2_server_tpu.ops import sw as jsw  # noqa: E402
from bowtie2_server_tpu.ops import sw_banded as jsb  # noqa: E402
from bowtie2_server_tpu_torch.ops import alu_probe  # noqa: E402
from bowtie2_server_tpu_torch.ops.sw import SwConfig  # noqa: E402
from bowtie2_server_tpu_torch.ops.sw_banded import banded_dp  # noqa: E402
from bowtie2_server_tpu_torch.scripts import bench_dp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX script, loaded from its file (its top level imports numpy
    only)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_dp", ROOT / "scripts" / "bench_dp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
@pytest.mark.parametrize("K", [32, 64, 128, 256])
def test_ops_per_cell_equals_jax(jax_bench, K, local):
    assert bench_dp.ops_per_cell(K, local) == jax_bench.ops_per_cell(K, local)


def _chain_numpy(x, nsteps):
    """The body of the JAX probe kernel, in numpy."""
    y = x + 1
    for i in range(nsteps):
        x = np.maximum(x + i, y)
        y = np.maximum(y + 2, x)
    return x + y


def test_alu_chain_torch_equals_kernel_body():
    x = np.random.default_rng(0).integers(0, 100, (8, 256)).astype(np.int32)
    want = _chain_numpy(x.copy(), 50)
    got = alu_probe.alu_chain_torch(torch.from_numpy(x), 50)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper runs the plain version for a CPU tensor
    np.testing.assert_array_equal(
        alu_probe.alu_chain(torch.from_numpy(x), 50).numpy(), want)


def test_alu_chain_checks_inputs():
    with pytest.raises(ValueError, match="int32"):
        alu_probe.alu_chain(torch.zeros(4, dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="contiguous"):
        alu_probe.alu_chain(torch.zeros((4, 6), dtype=torch.int32).T, 3)


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_bench_banded_equals_pallas(local):
    """The microbench's banded call on its own inputs (P = 256, L = 40,
    K = 32) equals the JAX Pallas kernel, interpreted on the CPU."""
    P, L, K = 256, 40, 32
    rd, mm, lens, band = bench_dp.banded_inputs(P, L, K, torch.device("cpu"))
    kw = dict(ma=2, local=True) if local else {}
    got = banded_dp(SwConfig(**kw), K, rd, mm, lens, band)
    call = jsb._pallas_banded(jsw.SwConfig(**kw), K, L, P // jsw.LANES, True)
    want = call(jnp.asarray(rd.numpy()), jnp.asarray(mm.numpy()),
                jnp.asarray(lens.numpy()[None, :]), jnp.asarray(band.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])


def test_bench_dp_cpu_run(capsys):
    """The script end to end on the CPU at a small size: the JAX bench's
    keys, and a roofline share labelled as not meaningful."""
    bench_dp.main(["--device", "cpu", "--P", "128", "--L", "20"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "dp_banded_cells_per_s_per_chip"
    assert out["unit"] == "cells/s"
    assert out["value"] > 0 and out["ceiling_ops_per_s"] > 0
    assert out["roofline_frac"] == pytest.approx(
        out["value"] * bench_dp.ops_per_cell(32, False)
        / out["ceiling_ops_per_s"])
    assert out["card"] == "cpu"
    assert "not meaningful" in out["note"]


@pytest.mark.parametrize("dev_ms,event_ms,want", [
    (0.5336, 0.7940, (0.7940, "events")),   # the profiler misread it
    (0.7870, 0.7900, (0.7870, "device")),
    (0.9000, 1.0000, (0.9000, "device")),   # at the tolerance: kept
    (1.1100, 1.0000, (1.0000, "events")),   # above the event time too
], ids=["misread", "agree", "at_tol", "above"])
def test_probe_ms_picks_the_clock(dev_ms, event_ms, want):
    """The probe's time for the ceiling: its profiler time unless that
    strays more than 10% from its event time (exact on made-up times)."""
    from bowtie2_server_tpu_torch.scripts.bench_dp import probe_ms
    assert probe_ms(dev_ms, event_ms) == want
