"""The FM walks' work counts and bounds (scripts/bench_fm.py of the port),
which chip_smoke.py reports beside the kernels' times: the steps counted
from a recorded pass are the steps the plain walk takes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker (the workers share the cores)
torch.set_num_threads(1)

from bowtie2_server_tpu_torch.index.build import build_index  # noqa: E402
from bowtie2_server_tpu_torch.index.fm import FTAB_CHARS  # noqa: E402
from bowtie2_server_tpu_torch.ops import fm as tfm  # noqa: E402
from bowtie2_server_tpu_torch.scripts import bench_fm  # noqa: E402
from bowtie2_server_tpu_torch.scripts.bench_rect import (  # noqa: E402
    HBM_BYTES_PER_S)
from bowtie2_server_tpu_torch.utils import dna  # noqa: E402
from torch_tiles import fm_edge_tile, fm_genome  # noqa: E402


@pytest.fixture(scope="module")
def tile():
    g = fm_genome(4)
    idx = build_index(f">g\n{dna.decode(g)}\n")
    fm = tfm.to_device(idx.fw, "cpu")
    pat, lens, *_ = fm_edge_tile(2, idx.joined, idx.fw.n, idx.fw.primary)
    return fm, torch.from_numpy(pat), torch.from_numpy(lens)


def test_walk_steps_are_the_plain_walks_steps(tile, monkeypatch):
    """Every LF step of the plain recorded pass (an occ_batch call counts
    the top and bottom rows of the lanes that step) is counted, lane by
    lane."""
    fm, pat, lens = tile
    rows = []
    orig = tfm.occ_batch
    monkeypatch.setattr(tfm, "occ_batch", lambda f, c, r: (
        rows.append(r.shape[0] // 2), orig(f, c, r))[1])
    rec = tfm.backward_search_record_body(fm, pat, lens)
    per_lane = bench_fm.walk_steps(pat, lens, *rec)
    assert per_lane.shape == lens.shape
    assert int(per_lane.sum()) == sum(rows) > 0
    assert bool((per_lane <= lens.to(torch.int64)).all())


def test_ftab_lanes(tile):
    """The lanes that start from the ftab: long enough, no N among their
    last FTAB_CHARS characters; with the jump they step FTAB_CHARS times
    less at most."""
    fm, pat, lens = tile
    p, n = pat.numpy(), lens.numpy()
    want = np.array([n[i] >= FTAB_CHARS
                     and (p[i, n[i] - FTAB_CHARS : n[i]] <= 3).all()
                     for i in range(len(n))])
    got = bench_fm.ftab_lanes(pat, lens).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    rec = tfm.backward_search_record_body(fm, pat, lens)
    plain = bench_fm.walk_steps(pat, lens, *rec)
    jump = bench_fm.walk_steps(pat, lens, *rec, use_ftab=True)
    assert bool((jump <= plain).all())
    assert bool((plain - jump <= FTAB_CHARS).all())
    assert bool((jump[~torch.from_numpy(want)]
                 == plain[~torch.from_numpy(want)]).all())


def test_walk_bound_counts(tile):
    """The bound counts each input once: the sides (64 bytes a step, at
    most the whole side array), the patterns, the lanes' start positions,
    and the record's 8 bytes a lane and entry; a huge op count turns the
    bound to operations."""
    ms, by = bench_fm.walk_bound(1000, 10, 64, "record", 3e13,
                                 side_bytes=10**6, pat_bytes=640)
    want = (1000 * 64 + 640 + 10 * 4 + 65 * 10 * 8) / HBM_BYTES_PER_S * 1e3
    assert by == "bytes" and ms == pytest.approx(want)
    ms, _ = bench_fm.walk_bound(10**6, 10, 64, "record", 1e18,
                                side_bytes=32_000, pat_bytes=640)
    want = (32_000 + 640 + 10 * 4 + 65 * 10 * 8) / HBM_BYTES_PER_S * 1e3
    assert ms == pytest.approx(want)
    ms, by = bench_fm.walk_bound(1000, 10, 64, "search", 1e6,
                                 side_bytes=10**6, pat_bytes=640)
    assert by == "operations"
    assert ms == pytest.approx(1000 * bench_fm.OPS_PER_STEP / 1e6 * 1e3)


def test_resolve_steps_follow_the_sa():
    """The walk-left steps SA[row] % 16 times before it reaches a marked
    row (its SA value falls by one a step): the counts resolve_steps gives
    the bound, lane by lane, on a big layout forced on a small index."""
    g = fm_genome(5)
    idx = build_index(f">g\n{dna.decode(g)}\n")
    d = idx.fw
    fm = tfm.to_device(d, "cpu", big=True)
    rng = np.random.default_rng(3)
    rows = rng.integers(0, d.n, 2000).astype(np.int32)
    rows[0] = d.primary
    valid = torch.from_numpy(rng.random(2000) < 0.8)
    steps = bench_fm.resolve_steps(fm, torch.from_numpy(rows), valid)
    want = np.where(valid.numpy(), d.sa[rows].astype(np.int64) % 16, 0)
    np.testing.assert_array_equal(steps.numpy(), want)
    assert steps.max() == 15


def test_resolve_bound_counts():
    """A lane with s steps makes s + 1 trips of 48 bytes (at most the mark
    and side tables), loads one sample and moves its 9 bytes; the
    operations are the trips' tests, the steps' LF and a rank a lane."""
    steps = torch.tensor([0, 3, 15, 0])
    valid = torch.tensor([True, True, True, False])
    ms, by = bench_fm.resolve_bound(steps, valid, 3e13, table_bytes=10**6)
    want = (21 * 48 + 3 * 4 + 4 * 9) / HBM_BYTES_PER_S * 1e3
    assert by == "bytes" and ms == pytest.approx(want)
    ms, by = bench_fm.resolve_bound(steps, valid, 1e6, table_bytes=10**6)
    ops = (21 * bench_fm.OPS_RESOLVE_TEST + 18 * bench_fm.OPS_RESOLVE_STEP
           + 3 * bench_fm.OPS_RESOLVE_HIT)
    assert by == "operations" and ms == pytest.approx(ops / 1e6 * 1e3)
