"""The port's banded DP (bowtie2_server_tpu_torch/ops/sw_banded.py) against
the JAX package's: the plain torch version equals `_banded_tile_xla` and the
Pallas kernel (interpreted on the CPU) exactly, on best/bi/bk."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bowtie2_server_tpu.ops import sw as jsw  # noqa: E402
from bowtie2_server_tpu.ops import sw_banded as jsb  # noqa: E402
from bowtie2_server_tpu_torch.ops import sw_banded as tsb  # noqa: E402
from bowtie2_server_tpu_torch.ops.sw import SwConfig  # noqa: E402
from torch_tiles import (CFGS, P, LARGE_SCORE_CFG,  # noqa: E402
                         banded_edge_tile, banded_tile as make_tile)


# K = 256 and 512: the wide-band kernel's bands (--dpad 32-127)
@pytest.mark.parametrize("K", [32, 64, 256, 512])
@pytest.mark.parametrize("name", list(CFGS))
def test_banded_torch_equals_jax(name, K):
    lq = 40
    rd, mm, lens, band = make_tile(K + len(name), lq, K)
    jcfg = jsw.SwConfig(**CFGS[name])
    tcfg = SwConfig(**CFGS[name])
    want_xla = [np.asarray(x) for x in jsb._banded_tile_xla(
        jcfg, K, jnp.asarray(rd), jnp.asarray(mm), jnp.asarray(lens),
        jnp.asarray(band))]
    call = jsb._pallas_banded(jcfg, K, lq, 1, True)
    want_pl = [np.asarray(x)[0] for x in call(
        jnp.asarray(rd), jnp.asarray(mm), jnp.asarray(lens[None, :]),
        jnp.asarray(band))]
    got = tsb.banded_dp(tcfg, K, *(torch.from_numpy(a) for a in
                                   (rd, mm, lens, band)))
    for w_x, w_p, g in zip(want_xla, want_pl, got):
        np.testing.assert_array_equal(w_x, w_p)
        np.testing.assert_array_equal(g.numpy(), w_x)


@pytest.mark.parametrize("name", ["e2e", "local"])
def test_sw_banded_batch_equals_jax(name):
    """Host wrapper: [B, rows] uint8 problems, B not a tile multiple."""
    K, lq, B = 32, 30, 77
    rd, mm, lens, band = make_tile(7, lq, K)
    rd8, band8 = rd.T[:B].astype(np.uint8), band.T[:B].astype(np.uint8)
    cfg = CFGS[name]
    want = jsb.sw_banded_batch(rd8, lens[:B], mm.T[:B], band8,
                               jsw.SwConfig(**cfg), K=K, engine="xla")
    got = tsb.sw_banded_batch(rd8, lens[:B], mm.T[:B], band8,
                              SwConfig(**cfg), K=K, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["e2e", "local"])
def test_banded_traceback_equals_jax(name):
    """The host traceback of the gapped winners gives the same edits."""
    K, lq = 64, 50
    rd, mm, lens, band = make_tile(11, lq, K)
    cfg = CFGS[name]
    jcfg, tcfg = jsw.SwConfig(**cfg), SwConfig(**cfg)
    for p in range(0, P, 3):
        n = int(lens[p])
        r, m, b = rd[:n, p], mm[:n, p], band[: n + K, p]
        best, bi, bk = jsb.banded_best_numpy(r, m, b, jcfg, K)
        assert tsb.banded_best_numpy(r, m, b, tcfg, K) == (best, bi, bk)
        want = jsb.banded_traceback(r, m, b, jcfg, bi, bk, K=K)
        got = tsb.banded_traceback(r, m, b, tcfg, bi, bk, K=K)
        assert got == want, f"problem {p}"


def test_banded_dp_checks_inputs():
    cfg = SwConfig()
    rd = torch.zeros((8, 4), dtype=torch.int32)
    band = torch.zeros((8 + 32, 4), dtype=torch.int32)
    lens = torch.full((4,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="band"):
        tsb.banded_dp(cfg, 32, rd, rd, lens, band[:-1])
    with pytest.raises(TypeError, match="int32"):
        tsb.banded_dp(cfg, 32, rd.long(), rd, lens, band)
    with pytest.raises(ValueError, match="contiguous"):
        tsb.banded_dp(cfg, 32, rd, rd, lens,
                      torch.zeros((4, 40), dtype=torch.int32).T)


def test_sw_banded_batch_needs_a_device():
    """No CPU default: the caller names where the DP runs."""
    rd, mm, lens, band = make_tile(7, 30, 32)
    with pytest.raises(TypeError, match="device"):
        tsb.sw_banded_batch(rd.T.astype(np.uint8), lens, mm.T,
                            band.T.astype(np.uint8), SwConfig(), K=32)


@pytest.mark.parametrize("K", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("name", list(CFGS) + ["large_scores"])
def test_banded_edge_tile_torch_equals_jax(name, K):
    """The edge tile the CUDA kernel is held to on the card (P = 129: a
    partial warp and block; lengths from < 0 to past Lq; all-N rows; ties;
    penalties at the int8 edge): the plain torch version equals the JAX XLA
    engine on every problem and the Pallas kernel (interpreted on the CPU)
    on the first tile of 128, so the tile's expectations are the
    reference's."""
    lq = 40
    rd, mm, lens, band = banded_edge_tile(5 * K, lq, K)
    kw = LARGE_SCORE_CFG if name == "large_scores" else CFGS[name]
    jcfg, tcfg = jsw.SwConfig(**kw), SwConfig(**kw)
    want = [np.asarray(x) for x in jsb._banded_tile_xla(
        jcfg, K, jnp.asarray(rd), jnp.asarray(mm), jnp.asarray(lens),
        jnp.asarray(band))]
    call = jsb._pallas_banded(jcfg, K, lq, 1, True)
    want_pl = [np.asarray(x)[0] for x in call(
        jnp.asarray(rd[:, :P]), jnp.asarray(mm[:, :P]),
        jnp.asarray(lens[None, :P]), jnp.asarray(band[:, :P]))]
    got = tsb.banded_dp(tcfg, K, *(torch.from_numpy(a) for a in
                                   (rd, mm, lens, band)))
    for w_x, w_p, g in zip(want, want_pl, got):
        np.testing.assert_array_equal(w_x[:P], w_p)
        np.testing.assert_array_equal(g.numpy(), w_x)


@pytest.mark.parametrize("name", list(CFGS))
def test_traceback_batch_on_cpu_is_the_oracle(name):
    """banded_traceback_batch on the CPU: banded_traceback of each problem
    (ragged lengths in one batch), none taken from the kernel."""
    from torch_tiles import traceback_problems
    cfg = SwConfig(**CFGS[name])
    K = 64
    rd, mm, band, lens = traceback_problems(11, 12, K, 20, 120)
    ends = [tsb.banded_best_numpy(rd[t, :n], mm[t, :n], band[t, : n + K],
                                  cfg, K)[1:] for t, n in enumerate(lens)]
    bi, bk = np.array(ends).T
    got, on_card = tsb.banded_traceback_batch(rd, mm, band, lens, bi, bk,
                                              cfg, K, device="cpu")
    assert not on_card.any()
    for t, n in enumerate(lens):
        assert got[t] == tsb.banded_traceback(
            rd[t, :n], mm[t, :n], band[t, : n + K], cfg, int(bi[t]),
            int(bk[t]), K)


@pytest.mark.parametrize("K", tsb.TB_BANDS)
@pytest.mark.parametrize("name", list(CFGS))
def test_traceback_kernel_emulation_is_the_oracle(name, K):
    """The traceback kernel's logic (torch_tiles.emulate_traceback_kernel,
    its steps lane by lane in numpy) gives banded_traceback's answer on
    every problem: the best end cells, and one in five moved (end-to-end
    along the last row, --local to any row)."""
    from torch_tiles import emulate_traceback_kernel, traceback_problems
    cfg = SwConfig(**CFGS[name])
    seed = 100 * K + list(CFGS).index(name)
    rd, mm, band, lens = traceback_problems(seed, 24, K, 20, 120)
    rng = np.random.default_rng(seed)
    gaps = 0
    for t, n in enumerate(lens.tolist()):
        args = (rd[t, :n], mm[t, :n], band[t, : n + K])
        _, bi, bk = tsb.banded_best_numpy(*args, cfg, K)
        if rng.random() < 0.2:
            bk = int(rng.integers(0, K))
            if cfg.local:
                bi = int(rng.integers(0, n))
        want = tsb.banded_traceback(*args, cfg, bi, bk, K)
        got = emulate_traceback_kernel(*args, n, bi, bk, cfg, K,
                                       2 * rd.shape[1] + K)
        assert got == want, (t, n, bi, bk)
        gaps += any(e[0] != "M" for e in want[0])
    assert gaps > 0
