"""The port on the card: each CUDA kernel equals its plain torch version on
the same CUDA tensors, UnpairedAligner and PairedAligner on 'cuda' write
the same SAM as on 'cpu', and Bt2Server(device='cuda') answers a request
as the CPU server does. Every test here needs a CUDA device and
skips without one (the big-index cases force the big layout on small
genomes); none imports JAX, so on a machine with the card (and no
JAX) run them with
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bowtie2_server_tpu_torch.ops import alu_probe, kernels  # noqa: E402
from bowtie2_server_tpu_torch.ops import sw as tsw  # noqa: E402
from bowtie2_server_tpu_torch.ops import sw_banded as tsb  # noqa: E402
from torch_tiles import (CFGS, RECT_CFGS, LARGE_SCORE_CFG,  # noqa: E402
                         banded_edge_tile, banded_int16_edge_tile,
                         banded_ragged_tile, banded_tile, fm_edge_tile,
                         fm_genome, rect_tie_tile, rect_tile)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# "edges": banded_edge_tile, P = 129 (a partial warp and block), Lq = 40,
# lengths from < 0 to past Lq, penalties past the int8 edge of the register
# kernel's byte scores (those problems, and every problem under
# LARGE_SCORE_CFG, take its general kernel)
@pytest.mark.parametrize("tile", ["planted", "edges"])
@pytest.mark.parametrize("K", tsb.KERNEL_BANDS)
@pytest.mark.parametrize("name", list(CFGS) + ["large_scores"])
def test_banded_kernel_equals_plain(name, K, tile, cuda_device):
    """The register kernel (K <= 128) and the wide-band kernel (above)."""
    arrs = (banded_tile(3 * K, 100, K) if tile == "planted"
            else banded_edge_tile(5 * K, 40, K))
    args = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    cfg = tsw.SwConfig(**(LARGE_SCORE_CFG if name == "large_scores"
                          else CFGS[name]))
    which = "sw_banded" if K <= tsb.REGISTER_BAND_MAX else "sw_banded_wide"
    n0 = kernels.LAUNCHES[which]
    g0 = kernels.LAUNCHES["sw_banded_general"]
    got = tsb.banded_dp(cfg, K, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[which] == n0 + 1
    # the register kernel's call launches its general kernel too
    assert kernels.LAUNCHES["sw_banded_general"] == g0 + (which == "sw_banded")
    want = tsb.banded_tile_torch(cfg, K, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(CFGS))
def test_wide_kernel_at_register_band(name, cuda_device):
    """The wide-band kernel also takes K = 128, where banded_dp routes to
    the register kernel: both equal the plain version there."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in banded_tile(5, 100, 128)]
    cfg = tsw.SwConfig(**CFGS[name])
    want = tsb.banded_tile_torch(cfg, 128, *args)
    for kernel in ("sw_banded", "sw_banded_wide"):
        got = tsb._launch(kernel, cfg, 128, *args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# scorings of the ragged tiles: the tests' own, gap barriers at both ends
# that leave the short problems no gap row at all (Lq = 40), and a bonus
# past a byte (every row on the exact route)
RAGGED_CFGS = dict(CFGS, e2e_gapbar15=dict(gapbar=15),
                   local_gapbar15=dict(ma=2, local=True, gapbar=15),
                   large_scores=LARGE_SCORE_CFG)


@pytest.mark.parametrize("P", [1, 3, 5, 33, 129])
@pytest.mark.parametrize("K", [256, 512, 1024])
@pytest.mark.parametrize("name", list(RAGGED_CFGS))
def test_wide_kernel_ragged_warps(name, K, P, cuda_device):
    """The wide-band kernel with its last warp and the last segment of
    lanes partly filled (P problems of K/32 lanes each), lengths that
    differ inside every warp (finished problems beside live ones, gap runs
    that end at different rows, lengths below 0 and past Lq) and gap
    barriers at both ends of the read."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in banded_ragged_tile(13 * K + P, 40, K, P)]
    cfg = tsw.SwConfig(**RAGGED_CFGS[name])
    n0 = kernels.LAUNCHES["sw_banded_wide"]
    got = tsb.banded_dp(cfg, K, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sw_banded_wide"] == n0 + 1
    want = tsb.banded_tile_torch(cfg, K, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# scorings for the score routes: byte scores (penalties past the int8
# edge take the register kernel's general kernel, the wide kernel's exact
# route), then scorings the byte tables do not take: a bonus past a byte
# (--local: with the key; e2e), a negative gap penalty in --local (compare
# and select), a bonus past int16 (the exact route in every row)
ROUTE_CFGS = {"e2e": {}, "local": dict(ma=2, local=True),
              "large_scores": LARGE_SCORE_CFG,
              "large_e2e": dict(ma=200, npen=3),
              "local_neg_gap": dict(ma=2, local=True, rdg_ext=-1),
              "beyond_int16": dict(ma=40000, npen=2, local=True)}


@pytest.mark.parametrize("K", tsb.KERNEL_BANDS)
@pytest.mark.parametrize("name", list(ROUTE_CFGS))
def test_banded_score_routes(name, K, cuda_device):
    """Penalties at the int8 edge (128 and -127 fit a signed byte as -mm,
    129 and -128 do not) and at the edges of the general kernel's int16
    route (32768 and -127 fit it, 32769 and -128 do not), under scorings
    that send every problem to the general kernel (K <= 128) or to the
    wide-band kernel's exact route."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in banded_int16_edge_tile(11 * K, 40, K)]
    cfg = tsw.SwConfig(**ROUTE_CFGS[name])
    g0 = kernels.LAUNCHES["sw_banded_general"]
    got = tsb.banded_dp(cfg, K, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sw_banded_general"] == g0 + (K <= 128)
    want = tsb.banded_tile_torch(cfg, K, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# P = 129 problems: not a multiple of the rect kernel's warps a block; the
# Lq_pad reach every instantiation of bt2_sw (J = 4, 6, 8, 16, 32 rows a lane)
@pytest.mark.parametrize("tile", [rect_tile, rect_tie_tile],
                         ids=["planted", "ties"])
@pytest.mark.parametrize("lq_pad", [8, 136, 192, 250, 500, 1024])
@pytest.mark.parametrize("name", list(RECT_CFGS))
def test_sw_kernel_equals_plain(name, lq_pad, tile, cuda_device):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in tile(2 + lq_pad, lq_pad, 200, p=129)]
    cfg = tsw.SwConfig(**RECT_CFGS[name])
    n0 = kernels.LAUNCHES["sw"]
    got = tsw.sw_tile(cfg, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sw"] == n0 + 1
    want = tsw.sw_tile_torch(cfg, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_span_encloses_banded_kernel_on_profiler_clock(cuda_device):
    """The span recorder and a torch.profiler trace share one clock: a span
    around a banded_dp launch and the synchronize after it holds, within
    1 ms, the interval of each kernel the launch ran, placed on the epoch
    by the benchmark's rule (portbench/yardstick.Trace: the trace's
    start_ns plus each event's offset)."""
    from torch.profiler import ProfilerActivity, profile
    from bowtie2_server_tpu_torch.utils import trace
    from portbench.yardstick import Trace
    args = [torch.from_numpy(a).to(cuda_device)
            for a in banded_tile(7, 100, 64)]
    cfg = tsw.SwConfig(**CFGS["e2e"])
    tsb.banded_dp(cfg, 64, *args)       # builds the kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device=cuda_device).add_(1)
    trace.disable()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with trace.span("launch"):
                tsb.banded_dp(cfg, 64, *args)
                torch.cuda.synchronize()
        (sp,) = [s for s in trace.spans() if s.name == "launch"]
    finally:
        trace.disable()
    tr = Trace(prof, sp.t0 - 1.0, sp.t1 + 1.0)
    evs = [(tr.origin + a / 1e6, tr.origin + b / 1e6)
           for name, _, a, b in tr.events
           if "banded_kernel<" in name or "banded_general_kernel" in name]
    assert len(evs) == 2
    for a, b in evs:
        assert sp.t0 - 1e-3 <= a < b <= sp.t1 + 1e-3, (sp.t0, a, b, sp.t1)


def test_banded_kernel_refuses_unbuilt_band(cuda_device):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in banded_tile(1, 20, 2048)]
    with pytest.raises(ValueError, match="band width 2048"):
        tsb.banded_dp(tsw.SwConfig(), 2048, *args)


def test_alu_probe_equals_plain(cuda_device):
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 100, (64, 4096)).astype(np.int32)).to(cuda_device)
    n0 = kernels.LAUNCHES["alu_probe"]
    got = alu_probe.alu_chain(x, 100)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["alu_probe"] == n0 + 1
    assert torch.equal(got, alu_probe.alu_chain_torch(x, 100))


@pytest.fixture(scope="module")
def fm_index():
    """An index of fm_genome's text and a copy of its first 3 kbp."""
    from bowtie2_server_tpu_torch.index.build import build_index
    from bowtie2_server_tpu_torch.utils import dna
    g = fm_genome(12)
    return build_index(f">g\n{dna.decode(g)}\n>h\n{dna.decode(g[:3000])}\n")


def _fm_run(fm, dev, pat, lens, c, top, bot):
    """Every FM wrapper on the edge tile's inputs on `dev`."""
    from bowtie2_server_tpu_torch.ops import fm as tfm
    T = lambda a: torch.from_numpy(a).to(dev)
    out = {"lf": tfm.lf_step(fm, T(c), T(top), T(bot))}
    for ftab in (False, True):
        out[f"search_ftab{ftab}"] = tfm.backward_search_body(
            fm, T(pat), T(lens), ftab)
    tops, bots = tfm.backward_search_record_body(fm, T(pat), T(lens))
    out["record"] = (tops, bots)
    res = tfm.one_mm_phase0_body(fm, T(pat), T(lens), T(lens // 2), tops,
                                 bots, 0, 32, 4096)
    out["phase0"] = res
    out["cont"] = tfm.one_mm_phase1_body(fm, T(pat), *res[:1], *res[2:5],
                                         40)
    # continuation from the tile's odd states: empty, inverted, full
    # ranges, the $ row, positions 0 and past the start
    lanes = np.arange(len(lens), dtype=np.int32)
    out["cont_edges"] = tfm.one_mm_phase1_body(
        fm, T(pat), T(lanes), T(lens - 1), T(top), T(bot), 48)
    return out


@pytest.mark.parametrize("direction", ["fw", "mirror"])
def test_fm_kernels_equal_plain(direction, fm_index, cuda_device):
    """fm_walk (search with and without the ftab, record, continuation)
    and fm_lf_step against the plain torch versions on the edge tile."""
    from bowtie2_server_tpu_torch.ops import fm as tfm
    d = getattr(fm_index, direction)
    text = fm_index.joined if direction == "fw" else fm_index.joined[::-1]
    args = fm_edge_tile(7, text, d.n, d.primary)
    want = _fm_run(tfm.to_device(d, "cpu"), "cpu", *args)
    w0, l0 = kernels.LAUNCHES["fm_walk"], kernels.LAUNCHES["fm_lf_step"]
    got = _fm_run(tfm.to_device(d, cuda_device), cuda_device, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fm_walk"] == w0 + 5
    assert kernels.LAUNCHES["fm_lf_step"] == l0 + 2
    for key in want:
        for g, w in zip(got[key], want[key]):
            assert torch.equal(g.cpu(), w), key
    assert int(want["phase0"][5]) > 0      # some branches survived


@pytest.mark.parametrize("direction", ["fw", "mirror"])
def test_fm_kernels_u32_equal_plain(direction, fm_index, cuda_device):
    """The uint32 instantiations of fm_walk and fm_lf_step (a big layout
    forced on the small index) against the plain torch versions on the
    same layout and against the int32 instantiations on the small one: the
    rows are below 2^31, so every output has the same bits."""
    from bowtie2_server_tpu_torch.ops import fm as tfm
    d = getattr(fm_index, direction)
    text = fm_index.joined if direction == "fw" else fm_index.joined[::-1]
    args = fm_edge_tile(8, text, d.n, d.primary)
    want = _fm_run(tfm.to_device(d, "cpu", big=True), "cpu", *args)
    small = _fm_run(tfm.to_device(d, cuda_device), cuda_device, *args)
    w0, l0 = kernels.LAUNCHES["fm_walk"], kernels.LAUNCHES["fm_lf_step"]
    fm = tfm.to_device(d, cuda_device, big=True)
    assert fm.big
    got = _fm_run(fm, cuda_device, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fm_walk"] == w0 + 5
    assert kernels.LAUNCHES["fm_lf_step"] == l0 + 2
    for key in want:
        for g, s, w in zip(got[key], small[key], want[key]):
            assert torch.equal(g.cpu(), w), key
            assert torch.equal(g, s), key


@pytest.mark.parametrize("direction", ["fw", "mirror"])
def test_fm_resolve_equals_plain(direction, fm_index, cuda_device):
    """fm_resolve against resolve_rows_body_torch and the full SA: random
    rows, every row of the first blocks (rows marked at step 0 among
    them), the primary row, row 0, the last row, a tenth invalid."""
    from bowtie2_server_tpu_torch.ops import fm as tfm
    d = getattr(fm_index, direction)
    rng = np.random.default_rng(9)
    rows = np.concatenate([np.arange(200), [d.primary, 0, d.n - 1],
                           rng.integers(0, d.n, 4000)]).astype(np.int32)
    valid = rng.random(len(rows)) < 0.9
    valid[:203] = True
    assert (d.sa[rows[:200]] % 16 == 0).any()
    T = lambda a, dev: torch.from_numpy(a).to(dev)
    want = tfm.resolve_rows_body(tfm.to_device(d, "cpu", big=True),
                                 T(rows, "cpu"), T(valid, "cpu"))
    n0 = kernels.LAUNCHES["fm_resolve"]
    got = tfm.resolve_rows_body(tfm.to_device(d, cuda_device, big=True),
                                T(rows, cuda_device), T(valid, cuda_device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fm_resolve"] == n0 + 1
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(want.numpy()[valid],
                                  d.sa[rows[valid]].astype(np.int32))


def _resolve_lanes(d, rng, n_lanes):
    """Rows for fm_resolve whose walk-left takes every step count from 0 to
    15 in the first 16 lanes (all in one warp of the kernel), then random
    rows, the primary row, row 0 and the last rows, a tenth invalid; and
    their steps (SA % 16)."""
    sa = np.asarray(d.sa)
    rows = rng.integers(0, d.n, n_lanes)
    for k in range(16):
        rows[k] = np.flatnonzero(sa % 16 == k)[rng.integers(0, 50)]
    edge = [d.primary, 0, d.n - 1, d.n - 2, d.n - 65]
    rows[16 : 16 + len(edge)] = edge[: max(0, n_lanes - 16)]
    valid = rng.random(n_lanes) < 0.9
    valid[: 16 + len(edge)] = True
    return rows.astype(np.int32), valid, sa[rows] % 16


@pytest.mark.parametrize("n_lanes", [16, 333, 4096 + 37])
def test_fm_resolve_every_trip_count(n_lanes, fm_index, cuda_device):
    """fm_resolve on lanes that end at every trip from 0 to 15 in one warp,
    at lane counts that are not a multiple of the warp or of the kernel's
    block (256 rows), against the plain version and the full SA."""
    from bowtie2_server_tpu_torch.ops import fm as tfm
    d = fm_index.fw
    rows, valid, steps = _resolve_lanes(d, np.random.default_rng(n_lanes),
                                        n_lanes)
    assert (np.sort(steps[:16]) == np.arange(16)).all()
    T = lambda a, dev: torch.from_numpy(a).to(dev)
    fm = tfm.to_device(d, cuda_device, big=True)
    got = tfm.resolve_rows_body(fm, T(rows, cuda_device),
                                T(valid, cuda_device))
    want = tfm.resolve_rows_body(tfm.to_device(d, "cpu", big=True),
                                 T(rows, "cpu"), T(valid, "cpu"))
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(want.numpy()[valid],
                                  d.sa[rows[valid]].astype(np.int32))
    assert (want.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("n_iter_short", [False, True])
def test_fm_resolve_unmarked_and_invalid(n_iter_short, cuda_device):
    """A random table's marks (bench_fm.random_fm: density 1/16, so a third
    of the chains meet no mark within 16 trips) and a tenth of the rows
    invalid: the kernel keeps the JAX loop's 0 for both, and equals the
    plain version on the rest; with off_rate 2 (4 trips) most chains run
    out."""
    from bowtie2_server_tpu_torch.ops import fm as tfm
    from bowtie2_server_tpu_torch.scripts import bench_fm
    off_rate = 2 if n_iter_short else 4
    n = (1 << 16) + 64 * 3 + 5
    fm = bench_fm.random_fm(n, cuda_device, seed=4, big=True,
                            off_rate=off_rate)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, n, 5000)
    rows[:4] = (fm.primary, 0, n - 1, n - 64)
    valid = rng.random(5000) < 0.9
    rows_t = torch.from_numpy(rows.astype(np.int32)).to(cuda_device)
    valid_t = torch.from_numpy(valid).to(cuda_device)
    got = tfm.resolve_rows_body(fm, rows_t, valid_t)
    off, steps = tfm.walk_left_torch(fm, rows_t, valid_t)
    assert torch.equal(got, tfm.narrow(off))
    unmarked = valid_t & (steps == (1 << off_rate)) & (off == 0)
    assert int(unmarked.sum()) > 100
    assert int(got[~valid_t].abs().sum()) == 0


def _block_edge_lanes(d, rng, n_lanes):
    """(top, bot) [n_lanes] uint32 ranges at the sides' edges: top at and
    beside 64-row block boundaries, at the primary row's block and at the
    top of the table (n - 1, n), bot 0, 1, 2, 63, 64, 65 or 200 rows on,
    so that both ends lie in one block, in adjacent blocks or further
    apart."""
    b = 64 * rng.integers(1, max(2, d.n // 64), 8)
    tops = np.concatenate([
        b - 1, b, b + 1, b + 63,
        [0, 1, 63, 64, d.primary - 1, d.primary, d.primary + 1,
         d.primary // 64 * 64, d.primary // 64 * 64 + 63,
         d.n - 66, d.n - 65, d.n - 64, d.n - 2, d.n - 1, d.n]])
    tops = np.clip(tops, 0, d.n)
    top = np.resize(tops, n_lanes)
    width = np.resize([0, 1, 2, 63, 64, 65, 200], n_lanes)
    rng.shuffle(width)
    return top, np.clip(top + width, 0, d.n)


@pytest.mark.parametrize("big", [False, True], ids=["int", "uint32"])
def test_fm_walk_block_edges(big, fm_index, cuda_device):
    """fm_walk continuations and fm_lf_step from ranges at the sides' edges
    (both ends in one block, in adjacent blocks, in the primary row's
    block, at the top of the table, the uint32 rows as int32 bit patterns
    on the big layout), over 333 lanes (not a multiple of the warp or of
    the block), against the plain versions."""
    from bowtie2_server_tpu_torch.ops import fm as tfm
    d = fm_index.fw
    rng = np.random.default_rng(11)
    P, L = 333, 37                 # a pattern stride that is not 16-aligned
    top, bot = _block_edge_lanes(d, rng, P)
    assert ((top // 64 == bot // 64) & (top < bot)).any()
    assert ((top // 64 + 1 == bot // 64) & (top < bot)).any()
    pat = rng.integers(0, 4, (P, L)).astype(np.uint8)
    pat[rng.random((P, L)) < 0.01] = 4
    pos = rng.integers(-1, L, P).astype(np.int32)
    cb = rng.permutation(P).astype(np.int32)
    c = rng.integers(0, 6, P).astype(np.int32)
    args = (pat, cb, pos, top.astype(np.int32), bot.astype(np.int32))
    outs = {}
    for dev in ("cpu", cuda_device):
        fm = tfm.to_device(d, dev, big=big)
        T = lambda a: torch.from_numpy(a).to(dev)
        outs[str(dev)] = (
            *tfm.one_mm_phase1_body(fm, *map(T, args), L),
            *tfm.lf_step(fm, T(c), T(args[3]), T(args[4])))
    for g, w in zip(outs[str(cuda_device)], outs["cpu"]):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("big", [False, True], ids=["int", "uint32"])
@pytest.mark.parametrize("offset", [0, 1])
def test_fm_walk_patterns_any_alignment(big, offset, fm_index, cuda_device):
    """The recorded pass and the ftab search, each lane's next character
    loaded a step ahead: patterns of 22 and 45 bases a row (strides that
    are not 16-aligned), from a tensor that starts off a 16-byte boundary
    (offset 1: a view one row into another), lengths 0 to the full row,
    517 lanes; against the plain versions."""
    from bowtie2_server_tpu_torch.ops import fm as tfm
    d = fm_index.fw
    text = fm_index.joined
    rng = np.random.default_rng(13 + offset)
    for L in (22, 45):
        P = 517
        starts = rng.integers(0, len(text) - L, P + offset)
        pat = np.stack([text[s : s + L] for s in starts]).astype(np.uint8)
        pat[rng.random(pat.shape) < 0.005] = 4
        lens = rng.integers(0, L + 1, P).astype(np.int32)
        outs = {}
        for dev in ("cpu", cuda_device):
            fm = tfm.to_device(d, dev, big=big)
            p = torch.from_numpy(pat).to(dev)[offset:]
            ln = torch.from_numpy(lens).to(dev)
            outs[str(dev)] = (
                *tfm.backward_search_record_body(fm, p, ln),
                *tfm.backward_search_body(fm, p, ln, True),
                *tfm.backward_search_body(fm, p, ln, False))
        for g, w in zip(outs[str(cuda_device)], outs["cpu"]):
            assert torch.equal(g.cpu(), w)


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


# the bands of --dpad 15 (the default), 16, 32 and 64: K = 64 and 128 on
# the register kernel, 256 and 512 on the wide-band kernel (band_for gives
# no band below 64, so K = 32 is held on tiles only)
BANDS = {"K64": 15, "K128": 16, "K256": 32, "K512": 64}


def _sams(recs, names):
    from bowtie2_server_tpu_torch.io.sam import sam_record
    items = recs if isinstance(recs, list) else [recs[i]
                                                for i in range(len(recs))]
    return [sam_record(r, names) for r in items]


@pytest.mark.parametrize("big", [False, True], ids=["small", "big"])
@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_aligner_cuda_equals_cpu(local, band, big, cuda_device):
    """Also under force_big: the big-index path (the general shape, the
    uint32 walks and fm_resolve) on the same index."""
    from bowtie2_server_tpu_torch.align.pipeline import (SearchPolicy,
                                                         UnpairedAligner)
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.utils.presets import preset_params
    idx, names, seqs, quals = _workload()
    if local or big:   # local winners take the host traceback, and the
        # big path's plain walks are slow on the CPU: fewer reads
        names, seqs, quals = names[:600], seqs[:600], quals[:600]
    sc, pol = preset_params(None, local)
    pol = SearchPolicy(**dict(pol, maxhalf=BANDS[band]))
    sams = {}
    for dev in ("cpu", cuda_device):
        kernels.reset_launches()
        al = UnpairedAligner(idx, scoring=sc, policy=pol, device=dev,
                             force_big=big)
        assert f"K{al.band}" == band and al.big == big
        recs = al.align_batch(make_batch(names, seqs, quals))
        sams[str(dev)] = _sams(recs, idx.ref_names)
    assert sams["cuda"] == sams["cpu"]
    which = "sw_banded" if band in ("K64", "K128") else "sw_banded_wide"
    assert kernels.LAUNCHES[which] >= 1
    if not local and not big:
        assert kernels.LAUNCHES["sw"] >= 1
    if big:
        assert kernels.LAUNCHES["fm_resolve"] >= 2
        assert kernels.LAUNCHES["fm_walk"] >= 1


@pytest.mark.parametrize("band", ["K64", "K128"])
@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_paired_cuda_equals_cpu(local, band, cuda_device):
    """Pairs of the workload's reads (mate 2 reverse-complemented 200-400
    bases downstream of mate 1 on the 60 kbp chromosome; every 10th mate 2
    with a substitution every 16 bases, so mate rescue runs), end-to-end
    and --local, at the bands of --dpad 15 and 16."""
    from bowtie2_server_tpu_torch.align.paired import PairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.io.sam import sam_record
    from bowtie2_server_tpu_torch.utils import dna
    idx, _, _, _ = _workload(n=1)
    rng = np.random.default_rng(4)
    chrom = idx.joined[: idx.ref_lens[0]]
    s1, s2 = [], []
    for p in range(500):
        st = int(rng.integers(0, len(chrom) - 500))
        end = st + int(rng.integers(200, 400))
        m1 = chrom[st : st + 100].copy()
        m2 = (3 - chrom[end - 100 : end])[::-1].copy()
        if p % 10 == 0:
            m2[np.arange(p % 16, 100, 16)] ^= 1
        s1.append(dna.decode(m1).encode())
        s2.append(dna.decode(m2).encode())
    from bowtie2_server_tpu_torch.align.pipeline import SearchPolicy
    from bowtie2_server_tpu_torch.utils.presets import preset_params
    n = 200 if local else 500     # local winners take the host traceback
    names = [f"p{i}" for i in range(n)]
    quals = [b"I" * 100] * n
    sc, pol = preset_params(None, local)
    pol = SearchPolicy(**dict(pol, maxhalf=BANDS[band]))
    sams = {}
    for dev in ("cpu", cuda_device):
        kernels.reset_launches()
        pal = PairedAligner(idx, scoring=sc, policy=pol, device=dev)
        pairs = pal.align_batch(make_batch(names, s1[:n], quals),
                                make_batch(names, s2[:n], quals))
        sams[str(dev)] = [sam_record(r, idx.ref_names)
                          for pr in pairs for r in pr]
    assert sams["cuda"] == sams["cpu"]
    assert kernels.LAUNCHES["sw_banded"] >= 2 and kernels.LAUNCHES["sw"] >= 1


def _short_workload(n=2000, seed=5):
    """The workload's genome with reads of 18-60 bp (0-2 substitutions,
    half reverse-complemented, an N in every 50th) and -N 1 reads of 60 bp
    with a substitution inside every round-0 seed window."""
    from bowtie2_server_tpu_torch.utils import dna
    idx, _, _, _ = _workload(n=1)
    rng = np.random.default_rng(seed)
    chrom = idx.joined[: idx.ref_lens[0]]
    short, n1 = [], []
    for i in range(n):
        rl = int(rng.integers(18, 61))
        s = int(rng.integers(0, len(chrom) - rl))
        r = chrom[s : s + rl].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[rng.integers(0, rl)] = rng.integers(0, 4)
        if i % 50 == 0:
            r[rng.integers(0, rl)] = 4
        if rng.random() < 0.5:
            r = np.where(r < 4, 3 - r, r)[::-1]
        short.append(dna.decode(r).encode())
        s = int(rng.integers(0, len(chrom) - 60))
        r = chrom[s : s + 60].copy()
        p = int(rng.integers(2, 20))
        r[p] = (r[p] + 1) % 4
        n1.append(dna.decode(r).encode())
    return idx, short, n1


@pytest.mark.parametrize("case", ["short", "n1"])
def test_short_shape_cuda_equals_cpu(case, cuda_device):
    """The general short-read shape on the card: identical decoded batch
    results and SAM for reads of 18-60 bp, and for -N 1; the FM kernels
    launch."""
    from bowtie2_server_tpu_torch.align.candgen import BatchResult
    from bowtie2_server_tpu_torch.align.pipeline import (SearchPolicy,
                                                         UnpairedAligner)
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    idx, short, n1 = _short_workload()
    seqs = short if case == "short" else n1
    pol = SearchPolicy(n_seed_mms=1 if case == "n1" else 0)
    names = [f"s{i}" for i in range(len(seqs))]
    quals = [b"I" * len(s) for s in seqs]
    sams, results = {}, {}
    for dev in ("cpu", cuda_device):
        kernels.reset_launches()
        al = UnpairedAligner(idx, policy=pol, device=dev)
        batch = make_batch(names, seqs, quals)
        results[str(dev)] = al.collect(batch).res
        sams[str(dev)] = _sams(al.align_batch(batch), idx.ref_names)
    for name in BatchResult.__slots__:
        a, b = getattr(results["cuda"], name), getattr(results["cpu"], name)
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b), name
    assert sams["cuda"] == sams["cpu"]
    assert kernels.LAUNCHES["fm_walk"] >= 1
    assert kernels.LAUNCHES["fm_lf_step"] >= 1
    assert kernels.LAUNCHES["sw_banded"] >= 1


@pytest.mark.parametrize("case", ["k2000", "all", "mirrorless"])
def test_host_path_cuda_equals_cpu(case, cuda_device):
    """The host path on the card (-k 2000 and -a on a genome with a
    60-mer planted 40 times; an index without its mirror direction):
    identical SAM."""
    from bowtie2_server_tpu_torch.align.pipeline import (ALL_HITS,
                                                         SearchPolicy,
                                                         UnpairedAligner)
    from bowtie2_server_tpu_torch.index.build import build_index
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.utils import dna
    idx, short, _ = _short_workload(n=200)
    rng = np.random.default_rng(6)
    unit = rng.integers(0, 4, 60).astype(np.uint8)
    rep = np.concatenate([np.concatenate([rng.integers(0, 4, 50), unit])
                          for _ in range(40)]).astype(np.uint8)
    chrom = idx.joined[: idx.ref_lens[0]]
    fa = f">chr\n{dna.decode(chrom)}\n>rep\n{dna.decode(rep)}\n"
    idx = build_index(fa, both_directions=case != "mirrorless")
    seqs = [dna.decode(unit).encode()] + short
    khits = {"k2000": 2000, "all": ALL_HITS, "mirrorless": 1}[case]
    pol = SearchPolicy(khits=khits, **(dict(mhits=0, msample=False)
                                       if khits > 1 else {}))
    names = [f"h{i}" for i in range(len(seqs))]
    quals = [b"I" * len(s) for s in seqs]
    sams = {}
    for dev in ("cpu", cuda_device):
        kernels.reset_launches()
        al = UnpairedAligner(idx, policy=pol, device=dev)
        assert (al.candgen is None) == (case == "mirrorless")
        sams[str(dev)] = _sams(al.align_batch(make_batch(names, seqs,
                                                         quals)),
                               idx.ref_names)
    assert sams["cuda"] == sams["cpu"]
    assert kernels.LAUNCHES["fm_walk"] >= 1
    assert kernels.LAUNCHES["sw_banded"] >= 1
    if khits > 1:
        assert sum(ln.startswith("h0\t") for ln in sams["cpu"]) == 40


def test_server_cuda_equals_cpu(cuda_device, tmp_path):
    """One raw tab6 request with fixed names (reads of 18-100 bp, so packs
    take the fast and the general shape, and pairs whose every 10th mate 2
    only mate rescue finds) to Bt2Server(device='cuda'): the same response
    as the CPU server's, with the banded and the rect kernel launched from
    the server's worker thread."""
    from bowtie2_server_tpu_torch.server.bt2srv import Bt2Server
    from bowtie2_server_tpu_torch.utils import dna
    from torch_serving import raw_request, serving
    idx, names, seqs, _ = _workload(n=600)
    idx.save(tmp_path / "genome")
    rng = np.random.default_rng(8)
    lines = []
    for n, s in zip(names, seqs):
        s = s[: int(rng.integers(18, 101))]
        lines.append(n.encode() + b"\t" + s + b"\t" + b"I" * len(s))
    chrom = idx.joined[: idx.ref_lens[0]]
    for p in range(200):
        st = int(rng.integers(0, len(chrom) - 500))
        end = st + int(rng.integers(200, 400))
        m1 = chrom[st : st + 100].copy()
        m2 = (3 - chrom[end - 100 : end])[::-1].copy()
        if p % 10 == 0:
            m2[np.arange(p % 16, 100, 16)] ^= 1
        lines.append(b"\t".join([
            b"q%d/1" % p, dna.decode(m1).encode(), b"I" * 100,
            b"q%d/2" % p, dna.decode(m2).encode(), b"I" * 100]))
    rng.shuffle(lines)
    bodies = {}
    for dev in ("cpu", "cuda"):
        srv = Bt2Server(str(tmp_path / "genome"), batch_size=512, device=dev)
        try:
            with serving(srv) as port:
                kernels.reset_launches()
                _, bodies[dev] = raw_request(port, lines)
                launches = dict(kernels.LAUNCHES)
        finally:
            srv.close()
    assert bodies["cuda"] == bodies["cpu"]
    assert bodies["cuda"].endswith(b"@CO BT2SRV All Done\n")
    assert bodies["cuda"].count(b"@CO END READ\t") == len(lines)
    assert launches["sw_banded"] >= 2 and launches["sw"] >= 1


@pytest.mark.parametrize("shards", [2, 4])
def test_logical_mesh_equals_one_card(shards, cuda_device):
    """UnpairedAligner over a mesh of `shards` logical shards of cuda:0
    writes the one card's SAM (exact), launching sw_banded once a shard;
    the paired aligner over the same mesh writes the one card's pairs."""
    from bowtie2_server_tpu_torch.align.paired import PairedAligner
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.parallel.mesh import make_mesh
    idx, names, seqs, quals = _workload()
    batch = make_batch(names, seqs, quals)
    mesh = make_mesh(shards, device="cuda:0")
    one = _sams(UnpairedAligner(idx, device="cuda:0").align_batch(batch),
                idx.ref_names)
    kernels.reset_launches()
    got = _sams(UnpairedAligner(idx, mesh=mesh).align_batch(batch),
                idx.ref_names)
    torch.cuda.synchronize()
    assert got == one
    assert kernels.LAUNCHES["sw_banded"] == shards
    assert kernels.LAUNCHES["sw"] >= 1
    b1 = make_batch(names[:400], seqs[:400], quals[:400])
    b2 = make_batch(names[:400], seqs[400:800], quals[400:800])
    pairs = {}
    for tag, where in (("one", dict(device="cuda:0")),
                       ("mesh", dict(mesh=mesh))):
        pairs[tag] = [_sams([r1, r2], idx.ref_names) for r1, r2 in
                      PairedAligner(idx, **where).align_batch(b1, b2)]
    assert pairs["mesh"] == pairs["one"]


def test_sharded_step_on_the_card(cuda_device):
    """make_sharded_step over two logical shards of cuda:0 equals the CPU
    (exact best, offs and n_aligned), with fm_walk and banded_kernel<32>
    launched once a shard; the dry runs pass on the card."""
    from bowtie2_server_tpu_torch.ops import fm as dfm
    from bowtie2_server_tpu_torch.parallel import mesh as tmesh
    from bowtie2_server_tpu_torch.utils import dna
    idx, _, seqs, _ = _workload(n=1024)
    reads = np.stack([dna.encode(s) for s in seqs]).astype(np.uint8)
    lens = np.full(len(seqs), 100, np.int32)
    mmpen = np.full(reads.shape, 6, np.int32)
    host = [torch.from_numpy(a) for a in (reads, lens, mmpen)]
    got = []
    for dev in ("cuda:0", "cpu"):
        step = tmesh.make_sharded_step(tmesh.make_mesh(2, device=dev),
                                       tsw.SwConfig(), 32)
        kernels.reset_launches()
        got.append([t.cpu() for t in step(
            dfm.to_device(idx.fw, dev), torch.from_numpy(idx.joined).to(dev),
            *host, -61)])
        if dev != "cpu":
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["sw_banded"] == 2
            assert kernels.LAUNCHES["fm_walk"] == 2
    for g, w in zip(*got):
        assert torch.equal(g, w)
    tmesh.dryrun_multichip(2, "cuda:0")
    tmesh.dryrun_full_pipeline(2, "cuda:0")


def test_mesh_over_cards(cuda_device):
    """A mesh over every card (make_mesh()) writes one card's SAM, each
    card launching its shard; and a --workers 1 server holds that mesh."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least two cards")
    from bowtie2_server_tpu_torch.align.pipeline import UnpairedAligner
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.parallel.mesh import Mesh, make_mesh
    from bowtie2_server_tpu_torch.server.dispatch import make_device_groups
    idx, names, seqs, quals = _workload()
    batch = make_batch(names, seqs, quals)
    mesh = make_mesh()
    one = _sams(UnpairedAligner(idx, device="cuda:0").align_batch(batch),
                idx.ref_names)
    kernels.reset_launches()
    got = _sams(UnpairedAligner(idx, mesh=mesh).align_batch(batch),
                idx.ref_names)
    assert got == one
    assert kernels.LAUNCHES["sw_banded"] == mesh.size
    groups = make_device_groups(1, "cuda")
    assert len(groups) == 1 and isinstance(groups[0], Mesh)
    assert groups[0].size == torch.cuda.device_count()


def _cli_workload(tmp_path, n=1000):
    """_workload's genome saved as an index and n of its reads as FASTQ."""
    idx, names, seqs, quals = _workload(n=n)
    idx.save(tmp_path / "genome")
    with open(tmp_path / "reads.fq", "w") as f:
        for nm, s, q in zip(names, seqs, quals):
            f.write(f"@{nm}\n{s.decode()}\n+\n{q.decode()}\n")
    return tmp_path / "genome", tmp_path / "reads.fq"


def _cli(argv, out):
    """The port's CLI in process: (kernel launches of the run, output)."""
    from bowtie2_server_tpu_torch.__main__ import main
    kernels.reset_launches()
    main([*argv, *out])
    torch.cuda.synchronize()
    return dict(kernels.LAUNCHES)


@pytest.mark.parametrize("dpad", [32, 64])
def test_cli_dpad_wide_cuda_equals_cpu(dpad, cuda_device, tmp_path):
    """align --dpad 32 and 64 (bands K = 256 and 512) from the command line
    launch the wide-band kernel, and the card's SAM equals the CPU's."""
    base, fq = _cli_workload(tmp_path)
    sams = {}
    for dev in ("cuda", "cpu"):
        sam = tmp_path / f"{dev}.sam"
        launches = _cli(["align", "-x", str(base), "-U", str(fq), "--dpad",
                         str(dpad), "--device", dev], ["-S", str(sam)])
        if dev == "cuda":
            assert launches["sw_banded_wide"] >= 1
        sams[dev] = [ln for ln in sam.read_text().splitlines()
                     if not ln.startswith("@PG")]
    assert sams["cuda"] == sams["cpu"]
    assert len(sams["cuda"]) > 1000


def test_dp_cuda_equals_cpu(cuda_device, tmp_path, capsys):
    """dp on the problems --dp-log wrote: the same lines on the card (the
    rect kernel launched) as on the CPU."""
    base, fq = _cli_workload(tmp_path, n=300)
    log = tmp_path / "dp.txt"
    _cli(["align", "-x", str(base), "-U", str(fq), "--dp-log", str(log),
          "--device", "cuda"], ["-S", str(tmp_path / "o.sam")])
    out = {}
    for dev in ("cuda", "cpu"):
        capsys.readouterr()
        launches = _cli(["dp", str(log), "--device", dev], [])
        out[dev] = capsys.readouterr().out.splitlines()
        if dev == "cuda":
            assert launches["sw"] == 1
    assert out["cuda"] == out["cpu"]
    assert len(out["cuda"]) == len(log.read_text().splitlines()) > 100


def test_cli_cuda_without_card_fails(cuda_device, tmp_path):
    """align --device cuda with CUDA hidden fails: it never carries on on
    the CPU."""
    import os
    import subprocess
    import sys
    base, fq = _cli_workload(tmp_path, n=50)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "bowtie2_server_tpu_torch", "align", "-x",
         str(base), "-U", str(fq), "-S", str(tmp_path / "o.sam"),
         "--device", "cuda"], env=env, capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    assert r.returncode != 0
    assert "reads in" not in r.stderr
