"""The port's rectangle-DP bench (bowtie2_server_tpu_torch/scripts/
bench_rect.py) on the CPU: its inputs are what `sw_align_batch` would give
the kernel, its bound counts the operations of the sequential
recurrence (the reference bench's op model without its scan), and its run
holds the wrapper to the plain version (on the CPU both are the plain
version, so only the control flow is checked) and to the JAX engine."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bowtie2_server_tpu.ops import sw as jsw  # noqa: E402
from bowtie2_server_tpu_torch.ops.sw import sw_tile  # noqa: E402
from bowtie2_server_tpu_torch.scripts import bench_dp, bench_rect  # noqa

# the bench's shapes cut to a size the CPU runs in a second
TINY = {"tile4096": (16, 24, 40, (10, 24), (20, 40)),
        "unpaired": (9, 16, 32, (12, 12), (12, 32)),
        "rescue": (7, 24, 64, (20, 20), (40, 64))}


@pytest.mark.parametrize("name", list(bench_rect.SHAPES))
def test_rect_inputs_padding(name):
    P, lq_pad, lc, rl, wl = bench_rect.SHAPES[name]
    rd, mm, lens, ref, reflens = bench_rect.rect_inputs(P, lq_pad, lc, rl,
                                                        wl, 1)
    assert rd.shape == mm.shape == (lq_pad, P) and ref.shape == (lc, P)
    assert all(a.dtype == np.int32 for a in (rd, mm, lens, ref, reflens))
    assert rl[0] <= lens.min() and lens.max() <= min(rl[1], lq_pad)
    assert wl[0] <= reflens.min() and reflens.max() <= min(wl[1], lc)
    rows = np.arange(lq_pad)[:, None]
    assert (rd[rows >= lens] == 5).all() and (mm[rows >= lens] == 0).all()
    assert (rd[rows < lens] <= 3).all()
    assert (mm[rows < lens] >= 2).all() and (mm[rows < lens] <= 6).all()
    cols = np.arange(lc)[:, None]
    assert (ref[cols >= reflens] == 4).all()
    assert (ref[cols < reflens] <= 3).all()


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_rect_bound(local):
    lens = np.array([100, 150, 0, 300])
    reflens = np.array([256, 700, 10, -1])
    ceiling = 3.2e13
    ms, by = bench_rect.rect_bound(lens, reflens, 192, 640, local, ceiling)
    cells = 100 * 256 + 150 * 640
    assert by == "operations"
    assert ms == pytest.approx(cells * (16 + local) / ceiling * 1e3)
    # the reference op model less its log-depth scan (2 * ceil(log2 192)
    # = 16 operations), plus the sequential chain's subtract and max
    assert bench_rect.dp_ops_per_cell(local) == \
        bench_dp.ops_per_cell(192, local) - 16 + 2
    # few cells and many bytes: bound by the bytes
    ms, by = bench_rect.bound(1.0, 3.35e9, ceiling)
    assert by == "bytes" and ms == pytest.approx(1.0)


def test_bench_inputs_equal_jax():
    """The bench's inputs through the port's wrapper (plain version on the
    CPU) equal the JAX engine on the same arrays."""
    P, lq_pad, lc, rl, wl = TINY["rescue"]
    arrs = bench_rect.rect_inputs(128, lq_pad, lc, rl, wl, 3)
    for cfg in bench_rect.MODES.values():
        want = jsw._sw_tile_xla(jsw.SwConfig(local=cfg.local, ma=cfg.ma),
                                *(jnp.asarray(a) for a in arrs))
        got = sw_tile(cfg, *(torch.from_numpy(a) for a in arrs))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bench_rect_cpu_run(monkeypatch, capsys):
    """The script end to end on the CPU at the tiny shapes: one row per
    shape and mode, exact, with its bound."""
    monkeypatch.setattr(bench_rect, "SHAPES", TINY)
    bench_rect.main(["--device", "cpu", "--reps", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"] == "cpu" and out["ceiling_ops_per_s"] > 0
    assert [(r["shape"], r["mode"]) for r in out["rows"]] == [
        (s, m) for s in TINY for m in ("e2e", "local")]
    for r in out["rows"]:
        assert r["max_abs_err"] == 0 and r["ms"] > 0
        assert r["frac_of_bound"] == pytest.approx(r["bound_ms"] / r["ms"])


def test_measure_plain_times(monkeypatch):
    """With plain_reps, each row also times the plain version (as
    chip_smoke phase 3 asks)."""
    monkeypatch.setattr(bench_rect, "SHAPES", TINY)
    rows = bench_rect.measure(torch.device("cpu"), 1e10, reps=1,
                              plain_reps=1)
    assert len(rows) == 2 * len(TINY)
    assert all(r["plain_ms"] > 0 and r["max_abs_err"] == 0 for r in rows)
