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


def test_walk_blocks_count_distinct_blocks(tile):
    """The distinct blocks a walk reads (both ends of every step that
    fetches), from the recorded pass: at most two a step, at least the
    blocks of one end; and on a hand-made record."""
    fm, pat, lens = tile
    rec = tfm.backward_search_record_body(fm, pat, lens)
    steps = bench_fm.walk_steps(pat, lens, *rec)
    assert 0 < bench_fm.walk_blocks(pat, lens, *rec) <= 2 * int(steps.sum())
    # two lanes of three characters: lane 0 in one block, then two, then
    # empty; lane 1 across blocks, then past its start
    p = torch.tensor([[0, 1, 2], [3, 3, 3]], dtype=torch.uint8)
    ln = torch.tensor([3, 2], dtype=torch.int32)
    top = torch.tensor([[0, 0], [64, 10], [100, 0], [5, 0]])
    bot = torch.tensor([[10, 200], [130, 300], [100, 0], [5, 0]])
    assert bench_fm.walk_steps(p, ln, top, bot).tolist() == [2, 2]
    # blocks 0 (twice), 1, 2, 3, 0 (again), 4: five distinct
    assert bench_fm.walk_blocks(p, ln, top, bot) == 5


def test_hbm_bounds_count_random_reads():
    """The HBM forms charge each distinct block a walk reads a random
    32-byte read, and each a walk-left reads two (its side and its mark
    row), at the probe's rate, the rest of the bytes at the stream rate; a huge op
    count turns them to operations."""
    ms, by = bench_fm.walk_bound_hbm(1500, 1000, 10, 64, "record", 3e13,
                                     rate32=1e10, pat_bytes=640)
    rest = (640 + 10 * 4 + 65 * 10 * 8) / HBM_BYTES_PER_S * 1e3
    assert by == "bytes" and ms == pytest.approx(1500 / 1e10 * 1e3 + rest)
    _, by = bench_fm.walk_bound_hbm(1500, 10**9, 10, 64, "record", 1e6,
                                    rate32=1e10, pat_bytes=640)
    assert by == "operations"
    steps = torch.tensor([0, 3, 15, 0])
    valid = torch.tensor([True, True, True, False])
    ms, by = bench_fm.resolve_bound_hbm(17, steps, valid, 3e13, rate32=1e9)
    want = 2 * 17 / 1e9 * 1e3 + (3 * 4 + 4 * 9) / HBM_BYTES_PER_S * 1e3
    assert by == "bytes" and ms == pytest.approx(want)


@pytest.mark.parametrize("big", [False, True], ids=["int", "big"])
def test_random_fm_is_an_index_layout(big):
    """random_fm's direction keeps the layout's rules: LF (C array plus the
    block counts and the packed codes, the $ row uncounted) is a
    permutation of the rows, the sentinel side holds the totals, the
    marks' ranks count the bits before each block (the primary row
    marked), there is a sample a mark, and the ftab is the plain search of
    every 10-mer; its sides (and a big one's marks) are contiguous
    arrays."""
    n = (1 << 13) + 37
    fm = bench_fm.random_fm(n, "cpu", seed=2, big=big)
    assert fm.big == big and fm.n == n
    rows = torch.arange(n)
    c = bench_fm.bwt_codes(fm, rows)
    lf = fm.cnt[c] + tfm.widen(tfm.occ_batch(fm, c, tfm.narrow(rows)))
    lf[fm.primary] = 0
    assert torch.equal(lf.sort().values, rows)
    assert tfm.widen(fm.side[-1, :4]).tolist() == [
        fm.cnt_host[1] - 1, fm.cnt_host[2] - fm.cnt_host[1],
        fm.cnt_host[3] - fm.cnt_host[2], n - fm.cnt_host[3]]
    if big:
        mk = tfm.widen(fm.mark)
        per = tfm._popc32(mk[:, 0]) + tfm._popc32(mk[:, 1])
        assert torch.equal(mk[1:, 2], torch.cumsum(per, 0)[:-1])
        assert fm.sa_samp.shape[0] == int(per.sum())
        assert (int(mk[fm.primary >> 6, (fm.primary & 63) >> 5])
                >> (fm.primary & 31)) & 1
        assert 0.04 < int(per.sum()) / n < 0.09
        assert fm.mark.shape == (fm.side.shape[0], 4)
        assert fm.mark.is_contiguous()
    assert fm.side.is_contiguous()
    assert bench_fm.table_bytes(fm) == fm.side.shape[0] * (48 if big
                                                          else 32)
    keys = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4 ** FTAB_CHARS, 500))
    pat = torch.stack([(keys >> (2 * (FTAB_CHARS - 1 - i))) & 3
                       for i in range(FTAB_CHARS)], 1).to(torch.uint8)
    top, bot = tfm.backward_search_body(
        fm, pat, torch.full((500,), FTAB_CHARS, dtype=torch.int32), False)
    assert torch.equal(fm.ftab_top[keys], top)
    assert torch.equal(fm.ftab_bot[keys], bot)


def test_walk_patterns_keep_ranges_nonempty():
    """Patterns read off a random table by LF walks: every suffix's range
    holds the walk's row, so the recorded pass stays nonempty to the end
    (but for walks through the $ row), and the ftab search finds them."""
    fm = bench_fm.random_fm(1 << 14, "cpu", seed=3, big=True)
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.integers(0, fm.n, 400))
    pat = bench_fm.walk_patterns(fm, rows, 30)
    lens = torch.full((400,), 30, dtype=torch.int32)
    tops, bots = tfm.backward_search_record_body(fm, pat, lens)
    ok = tfm.widen(tops) < tfm.widen(bots)
    assert float(ok[-1].float().mean()) > 0.97
    top, bot = tfm.backward_search_body(fm, pat, lens, True)
    assert torch.equal(top, torch.where(ok[-1], tops[-1], 0))


def test_cont_work_counts_the_plain_steps(tile):
    """cont_work counts, lane by lane, the LF steps of a continuation walk:
    the positions the plain walk moves, but for a last move onto an N
    (which empties the range without a side fetch); and at most two
    distinct blocks a step."""
    fm, pat, lens = tile
    P, L = pat.shape
    rng = np.random.default_rng(6)
    rec = tfm.backward_search_record_body(fm, pat, lens)
    cb = torch.from_numpy(rng.integers(0, P, 300).astype(np.int32))
    pos = torch.from_numpy(rng.integers(-1, L, 300).astype(np.int32))
    at = (lens.long()[cb.long()] - 1 - pos.long()).clamp(0, L)
    top, bot = rec[0][at, cb.long()], rec[1][at, cb.long()]
    steps, blocks = bench_fm.cont_work(fm, pat, cb, pos, top, bot, L)
    pos_out, t_out, b_out = tfm.one_mm_phase1_body(fm, pat, cb, pos, top,
                                                   bot, L)
    moved = (pos - pos_out).long()
    on_n = (moved - steps) == 1
    assert bool(((moved == steps) | on_n).all())
    assert bool((t_out[on_n] == 0).all() and (b_out[on_n] == 0).all())
    assert int(steps.sum()) > 0 and on_n.any()
    assert 0 < blocks <= 2 * int(steps.sum())


def test_resolve_blocks_follow_the_walk():
    """resolve_blocks replays the walk-left: on a big layout forced on a
    small index (every chain marked within 16 trips) its distinct blocks
    are those of the rows SA[row] - k, k = 0..SA[row] % 16, of the valid
    lanes."""
    g = fm_genome(6)
    idx = build_index(f">g\n{dna.decode(g)}\n")
    d = idx.fw
    fm = tfm.to_device(d, "cpu", big=True)
    rng = np.random.default_rng(8)
    rows = rng.integers(0, d.n, 300)
    valid = rng.random(300) < 0.8
    inv = np.empty(d.n, np.int64)
    inv[d.sa] = np.arange(d.n)
    want = set()
    for r in rows[valid]:
        v = int(d.sa[r])
        for k in range(v % 16 + 1):
            want.add(int(inv[v - k]) >> 6)
    got = bench_fm.resolve_blocks(fm, torch.from_numpy(rows.astype(np.int32)),
                                  torch.from_numpy(valid))
    assert got == len(want)
