"""The port's 'dp' mesh on a big index (force_big) and on a batch that
outgrows its first capacities, against the JAX package's on the CPU
(tests/test_torch_mesh.py has the shared runs and checks). Tolerance 0:
the packed output, every BatchResult field, the per-shard CandGenCfg at
each escalation step, and the SAM."""
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

from bowtie2_server_tpu_torch.align import candgen as tcg  # noqa: E402
from test_torch_mesh import (  # noqa: E402,F401
    check_cfg, check_packed, check_sam, genome, runs)

RUNS = [("big", 2), ("big", 8), ("escalate", 2)]


@pytest.mark.parametrize("case,n", RUNS, ids=[f"{c}-{n}" for c, n in RUNS])
def test_sharded_packed_output_equal(runs, case, n):
    """Exact (check_packed)."""
    check_packed(runs(case, n), n)


@pytest.mark.parametrize("case,n", RUNS, ids=[f"{c}-{n}" for c, n in RUNS])
def test_shard_cfg_equal(runs, case, n):
    """Exact (check_cfg)."""
    check_cfg(runs(case, n), n)


@pytest.mark.parametrize("case,n", [("big", 2), ("escalate", 2)],
                         ids=["big-2", "escalate-2"])
def test_mesh_sam_equal(runs, case, n):
    """Exact (check_sam). The escalated batch ran three times (1x, 2x,
    4x), only shard 0 overflowed its first capacities, and 4x stuck on
    both sides."""
    r = runs(case, n)
    check_sam(r)
    if case == "escalate":
        assert r["sticky"] == (4, 4)
        calls = r["jcalls"]
        assert [c[2].C_max for c in calls] == [5120, 5120, 9216]
        first = tcg.BatchResult(r["B0"], calls[0][4], calls[0][2], n,
                                calls[0][2].K)
        assert first.overflow
        assert tcg.shard_overflows(first.counters, calls[0][2]).tolist() == [
            True, False]
