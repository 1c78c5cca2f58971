"""The port's rectangle DP (bowtie2_server_tpu_torch/ops/sw.py) against the
JAX package's: the plain torch version equals `_sw_tile_xla`, the numpy
column scan `sw_align_numpy_batch` and the Pallas kernel (interpreted on the
CPU) exactly, on best/bi/bj."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bowtie2_server_tpu.ops import sw as jsw  # noqa: E402
from bowtie2_server_tpu_torch.ops import sw as tsw  # noqa: E402
from torch_tiles import P, RECT_CFGS as CFGS, rect_tile as make_tile  # noqa
from torch_tiles import rect_tie_tile  # noqa: E402


def _hold_against_jax(name, arrs):
    """The port's sw_tile on a CPU tile equals `_sw_tile_xla`, the Pallas
    kernel interpreted on the CPU and `sw_align_numpy_batch`."""
    rd, mm, lens, ref, reflens = arrs
    lq_pad, lc = rd.shape[0], ref.shape[0]
    jcfg = jsw.SwConfig(**CFGS[name])
    want_xla = [np.asarray(x) for x in jsw._sw_tile_xla(
        jcfg, *(jnp.asarray(a) for a in arrs))]
    call = jsw._pallas_engine(jcfg, lq_pad, lc, 1, True)
    want_pl = [np.asarray(x)[0] for x in call(
        jnp.asarray(rd), jnp.asarray(mm), jnp.asarray(lens[None, :]),
        jnp.asarray(ref), jnp.asarray(reflens[None, :]))]
    want_np = jsw.sw_align_numpy_batch(rd.T, lens, mm.T, ref.T, reflens,
                                       jcfg)
    got = tsw.sw_tile(tsw.SwConfig(**CFGS[name]),
                      *(torch.from_numpy(a) for a in arrs))
    for w_x, w_p, w_n, g in zip(want_xla, want_pl, want_np, got):
        np.testing.assert_array_equal(w_x, w_p)
        np.testing.assert_array_equal(w_x, w_n)
        np.testing.assert_array_equal(g.numpy(), w_x)


@pytest.mark.parametrize("name", list(CFGS))
def test_sw_torch_equals_jax(name):
    _hold_against_jax(name, make_tile(len(name), 24, 40))


# Lq_pad not a multiple of 32; the last case at the mate-rescue widths
TIE_CASES = [(name, 40, 72) for name in CFGS] + [("local", 192, 640)]


@pytest.mark.parametrize("name,lq_pad,lc", TIE_CASES)
def test_sw_tie_tile_equals_jax(name, lq_pad, lc):
    """The tie-heavy tile: many equal-score ends, all-N reads, len 0 and 1,
    windows shorter than Lc; the CUDA kernel's reduction of the best cell
    is held to the same tile on the card (tests/test_torch_cuda.py)."""
    _hold_against_jax(name, rect_tie_tile(7 + lq_pad, lq_pad, lc))


@pytest.mark.parametrize("name", ["e2e", "local"])
def test_sw_align_batch_equals_jax(name):
    """Host wrapper: ragged problems, Lq not a multiple of 8, B not a tile
    multiple."""
    rd, mm, lens, ref, reflens = make_tile(5, 21, 33)
    B = 90
    lens = np.minimum(lens, 21)
    cfg = CFGS[name]
    args = (rd.T[:B].astype(np.uint8), lens[:B], mm.T[:B],
            ref.T[:B].astype(np.uint8), reflens[:B])
    want = jsw.sw_align_batch(*args, jsw.SwConfig(**cfg), engine="xla")
    got = tsw.sw_align_batch(*args, tsw.SwConfig(**cfg), device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_sw_numpy_oracles_carried_over():
    rd, mm, lens, ref, reflens = make_tile(9, 16, 24)
    for cfg in CFGS.values():
        want = jsw.sw_align_numpy_batch(rd.T, lens, mm.T, ref.T, reflens,
                                        jsw.SwConfig(**cfg))
        got = tsw.sw_align_numpy_batch(rd.T, lens, mm.T, ref.T, reflens,
                                       tsw.SwConfig(**cfg))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        for p in range(0, P, 17):
            n = int(lens[p])
            assert tsw.sw_score_numpy(
                rd[:n, p], mm[:n, p], ref[:, p], tsw.SwConfig(**cfg)) == \
                jsw.sw_score_numpy(rd[:n, p], mm[:n, p], ref[:, p],
                                   jsw.SwConfig(**cfg))


def test_sw_align_batch_needs_a_device():
    """No CPU default: the caller names where the DP runs."""
    rd, mm, lens, ref, reflens = make_tile(5, 16, 24)
    with pytest.raises(TypeError, match="device"):
        tsw.sw_align_batch(rd.T.astype(np.uint8), lens, mm.T,
                           ref.T.astype(np.uint8), reflens, tsw.SwConfig())
