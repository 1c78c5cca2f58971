"""The port's FM-index ops (bowtie2_server_tpu_torch/ops/fm.py, device
'cpu': the plain torch versions of the fm_walk and fm_lf_step kernels)
against the JAX package's ops/fm.py on the same index and inputs. Every
value is an integer row, count or offset: the tolerance is zero."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bowtie2_server_tpu.index.build import build_index  # noqa: E402
from bowtie2_server_tpu.ops import fm as jfm  # noqa: E402
from bowtie2_server_tpu.utils import dna  # noqa: E402
from bowtie2_server_tpu_torch.index.fm import FmIndex  # noqa: E402
from bowtie2_server_tpu_torch.ops import fm as tfm  # noqa: E402
from torch_tiles import fm_edge_tile, fm_genome  # noqa: E402


@pytest.fixture(scope="module")
def fms(tmp_path_factory):
    """direction -> (JAX DeviceFm, port DeviceFm, the direction's text, its
    FmDirection) for an index saved by the JAX package and loaded by the
    port: fm_genome's 20 kbp (a repeat, a homopolymer run) and a copy of
    its first 3 kbp."""
    g = fm_genome(12)
    idx = build_index(f">g\n{dna.decode(g)}\n>h\n{dna.decode(g[:3000])}\n")
    base = tmp_path_factory.mktemp("torch_fm") / "idx"
    idx.save(base)
    tidx = FmIndex.load(base)
    out = {}
    for name, text in (("fw", idx.joined), ("mirror", idx.joined[::-1])):
        d = getattr(idx, name)
        out[name] = (jfm.to_device(d), tfm.to_device(getattr(tidx, name),
                                                     "cpu"), text, d)
    return out


def _eq(want, got):
    """JAX outputs (arrays or tuples of them) against the port's."""
    if not isinstance(want, (tuple, list)):
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


def _tile(fms, direction, seed=7):
    _, _, text, d = fms[direction]
    return fm_edge_tile(seed, text, d.n, d.primary)


DIRS = ["fw", "mirror"]


@pytest.mark.parametrize("direction", DIRS)
def test_sides_equal(fms, direction):
    jd, td, _, _ = fms[direction]
    np.testing.assert_array_equal(td.side.numpy().view(np.uint32),
                                  np.asarray(jd.side))
    assert (td.n, td.primary) == (int(jd.n), int(jd.primary))
    np.testing.assert_array_equal(td.cnt.numpy(), np.asarray(jd.cnt))


@pytest.mark.parametrize("direction", DIRS)
def test_occ_equal(fms, direction):
    """occ_batch and occ_all4 at random rows and at the tile's rows (block
    boundaries, the $ row, 0 and n)."""
    jd, td, _, d = fms[direction]
    rng = np.random.default_rng(1)
    rows = np.concatenate([_tile(fms, direction)[3],
                           rng.integers(0, d.n + 1, 2000)]).astype(np.int32)
    cs = rng.integers(0, 4, len(rows)).astype(np.int32)
    _eq(jfm.occ_batch(jd, jnp.asarray(cs), jnp.asarray(rows)),
        tfm.occ_batch(td, torch.from_numpy(cs), torch.from_numpy(rows)))
    _eq(jfm.occ_all4(jd, jnp.asarray(rows)),
        tfm.occ_all4(td, torch.from_numpy(rows)))


@pytest.mark.parametrize("direction", DIRS)
def test_lf_step_equal(fms, direction):
    """lf_step (c of 4 and 5, empty and inverted ranges), lf_all4 and the
    host-side lf_step_padded."""
    jd, td, _, _ = fms[direction]
    _, _, c, top, bot = _tile(fms, direction)
    T = torch.from_numpy
    _eq(jfm.lf_step(jd, jnp.asarray(c), jnp.asarray(top), jnp.asarray(bot)),
        tfm.lf_step(td, T(c), T(top), T(bot)))
    ok = top < bot
    _eq(jfm.lf_all4(jd, jnp.asarray(top[ok]), jnp.asarray(bot[ok])),
        tfm.lf_all4(td, T(top[ok]), T(bot[ok])))
    _eq(jfm.lf_step_padded(jd, c, top, bot),
        tfm.lf_step_padded(td, c, top, bot))


@pytest.mark.parametrize("use_ftab", [True, False], ids=["ftab", "noftab"])
@pytest.mark.parametrize("direction", DIRS)
def test_backward_search_equal(fms, direction, use_ftab):
    jd, td, _, _ = fms[direction]
    pat, lens, *_ = _tile(fms, direction)
    want = jfm.backward_search(jd, pat, lens, use_ftab=use_ftab)
    _eq(want, tfm.backward_search(td, pat, lens, use_ftab=use_ftab))
    assert (want[0] < want[1]).sum() > len(lens) // 3


@pytest.mark.parametrize("direction", DIRS)
def test_backward_search_record_equal(fms, direction):
    jd, td, _, _ = fms[direction]
    pat, lens, *_ = _tile(fms, direction)
    _eq(jfm.backward_search_record(jd, pat, lens),
        tfm.backward_search_record(td, pat, lens))


def test_sa_resolve_equal(fms):
    """Ranges of the tile's patterns (many rows from the repeat), clipped
    at 8 elements, and empty ones."""
    jd, td, _, _ = fms["fw"]
    pat, lens, *_ = _tile(fms, "fw")
    top, bot = jfm.backward_search(jd, pat, lens)
    assert (bot - top).max() > 8
    for cap in (1, 8, 32):
        _eq(jfm.sa_resolve(jd, top, bot - top, cap),
            tfm.sa_resolve(td, top, bot - top, cap))


@pytest.mark.parametrize("want_exact", [True, False], ids=["exact", "hits"])
@pytest.mark.parametrize("direction", DIRS)
def test_one_mm_branch_hits_equal(fms, direction, want_exact):
    jd, td, _, _ = fms[direction]
    pat, lens, *_ = _tile(fms, direction)
    args = (pat, lens, np.zeros(len(lens), np.int64), lens // 2)
    want = jfm.one_mm_branch_hits(jd, *args, want_exact=want_exact)
    got = tfm.one_mm_branch_hits(td, *args, want_exact=want_exact)
    if want_exact:
        (want, w_ex), (got, g_ex) = want, got
        _eq(w_ex, g_ex)
    _eq(want, got)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
    assert len(want[0]) > 0


def test_one_mm_capacity_retry(fms, monkeypatch):
    """512 patterns of 8 bases from the text branch at their first 4
    positions: some 4700 branches survive the substitution step of one
    chunk, past the compaction capacity of 4096, so the search narrows the
    chunk and runs again; the hits equal JAX's, which does the same."""
    jd, td, text, _ = fms["fw"]
    rng = np.random.default_rng(3)
    starts = rng.integers(0, len(text) - 8, 512)
    pat = np.stack([text[s : s + 8] for s in starts]).astype(np.uint8)
    lens = np.full(512, 8, np.int32)
    calls = []
    orig = tfm.one_mm_phase0_body
    monkeypatch.setattr(tfm, "one_mm_phase0_body", lambda *a: (
        calls.append(a[6:]), orig(*a))[1])
    args = (pat, lens, np.zeros(512, np.int64), lens // 2)
    want = jfm.one_mm_branch_hits(jd, *args)
    got = tfm.one_mm_branch_hits(td, *args)
    _eq(want, got)
    # (w0, cw, k1) of each chunk: the first one overflowed and ran again
    # narrower
    assert calls[0] == (0, 8, 4096) and calls[1][:2] == (0, 4)
    assert calls[-1][1] < 4 and len(want[0]) > 0


@pytest.mark.parametrize("direction", DIRS)
def test_phase_bodies_equal(fms, direction):
    """one_mm_phase0_body and one_mm_phase1_body directly (the port's
    record is [L+1, B], JAX's [B, L+1]), and the continuation from the
    tile's odd states (empty and inverted ranges, positions past the
    start)."""
    jd, td, _, _ = fms[direction]
    pat, lens, c, top, bot = _tile(fms, direction)
    J, T = jnp.asarray, torch.from_numpy
    jt, jb = jfm.backward_search_record_body(jd, J(pat), J(lens))
    tt, tb = tfm.backward_search_record_body(td, T(pat), T(lens))
    _eq((np.asarray(jt).T, np.asarray(jb).T), (tt, tb))
    hi = lens // 2
    want = jfm.one_mm_phase0_body(jd, J(pat.astype(np.int8)), J(lens), J(hi),
                                  jt, jb, 4, 16, 4096)
    got = tfm.one_mm_phase0_body(td, T(pat), T(lens), T(hi), tt, tb, 4, 16,
                                 4096)
    _eq(want, got)
    _eq(jfm.one_mm_phase1_body(jd, J(pat.astype(np.int8)), *want[:1],
                               *want[2:5], 24),
        tfm.one_mm_phase1_body(td, T(pat), *got[:1], *got[2:5], 24))
    lanes = np.arange(len(lens), dtype=np.int32)
    _eq(jfm.one_mm_phase1_body(jd, J(pat.astype(np.int8)), J(lanes),
                               J(lens - 1), J(top), J(bot), 48),
        tfm.one_mm_phase1_body(td, T(pat), T(lanes), T(lens - 1), T(top),
                               T(bot), 48))


def test_big_index_refused(fms):
    """A big index is no longer refused: to_device builds its sampled-SA
    layout (tests/test_torch_big.py holds it against the JAX package).
    What is refused is the walk-left on an index that keeps its full SA."""
    d = fms["fw"][3]
    big = tfm.to_device(d, "cpu", big=True)
    assert big.big and big.mark is not None and big.sa.numel() == 1
    small = tfm.to_device(d, "cpu")
    rows = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="full SA"):
        tfm.resolve_rows_body(small, rows, rows > 0)


def test_walks_refuse_other_devices(fms):
    td = fms["fw"][1]
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tfm.lf_step(td, t, t, t)
