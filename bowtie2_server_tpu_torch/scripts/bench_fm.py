"""The work and the bound of the FM walk kernels (ops/csrc/fm.cu), as
chip_smoke.py reports them beside their times.

The work depends on the data: a lane steps (two 32-byte side fetches and
the count) only while its range is nonempty, its position not past the
start and its character not N. `walk_steps` counts the steps a walk takes
from a recorded pass over the same patterns (ops/fm.py
`backward_search_record_body`), which visits the same ranges: with the
ftab jump, a lane's walk resumes at the record's entry FTAB_CHARS. The
bound is `bench_rect.bound`: the larger of the int32 operations over the
probe's ceiling and the bytes over the memory rate, each input read once
and each output written once. The sides count once (the direction's side
array, or 64 bytes a step where fewer steps touch less of it): the walks
fetch them again and again, but a direction's sides (~2 MB at 4 Mbp) stay
in the 50 MB L2, and a kernel has run faster than 64 bytes a step over
the memory rate would allow.

`step_latency_ms` times one dependent step: a warp of lanes walking 2048
characters of the text, each step waiting for the last.

The bounds above count the sides once, as if they stayed in L2. A
direction of a genome past ~64 Mbp does not fit the 50 MB L2 (2^29 bp:
256 MB of sides; GRCh38: 1.5 GB of sides and 0.76 GB of marks), and every
step then reads its sides from HBM at random. HBM serves random 32- and
64-byte reads far below its 3.35 TB/s stream rate, so the HBM forms
(`walk_bound_hbm`, `resolve_bound_hbm`) charge each distinct block whose
side the walk reads (`walk_blocks`, `cont_work`; a block read again may
hit L2) as one random 32-byte read, and each distinct block a walk-left
trip reads (`resolve_blocks`) as two (its mark row and its side lie in
separate arrays), at the rate the gather probe (`gather_rates`: plain
PyTorch indexing into a 2 GB table on the card, best of 5) measures;
everything else at the stream rate. `random_fm` lays out a direction of
any size on the card in seconds (a random BWT with its $ row, marks and
samples, by the layout's own rules) for exactness and timing far past
L2, and `walk_patterns` reads patterns off it by LF walks, so that every
walk runs its full length.

    python -m bowtie2_server_tpu_torch.scripts.bench_fm [--n 536870912]
        [--parent DIR]

runs the gather probe, then times fm_walk and fm_resolve at the L2 shape
(a 4 Mbp random text) and at the HBM shape (the --n text, built with
scripts/bench_big_index.py's build_or_load, cached under tmp/bigidx_port/) on
the inputs one batch of 32768 reads of 100 bp (and, at the L2 shape, of
36 bp) gives them, beside their L2 and HBM bounds and their chain floors
(the longest lane's steps x the step latency on the same table). With
--parent, the package of another checkout is loaded beside this one
(under another name, so that both run in one process on one card) and
each kernel runs in turns, parent, change, change, parent. The last line
is one JSON object.

The walk-left of a big index (`fm_resolve`) is counted the same way:
`resolve_steps` gives each lane's LF steps (ops/fm.py `walk_left_torch`),
and `resolve_bound` charges a trip (a step, or the final test of the
marked row) its 48 bytes of mark and side (counted once, as the sides
are) and the recurrence's operations, a lane its sample and its input
and output.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..index.fm import FTAB_CHARS
from ..ops import fm as dfm
from .bench_rect import HBM_BYTES_PER_S, bound

# int32 operations one LF step needs, each binary op one (the probe's
# count), counted from the recurrence and not from this kernel's code. An
# occ(c, row), one a range end: the block and remainder of the row (2);
# the block's count of c (1); for each of the block's four words the xor
# with c's pattern, the shift, the or, the and with 0x55555555, the and
# with the word's prefix mask and the popcount (6 x 4) and that prefix
# mask from the remainder (2 x 4); the sum of the four counts and base +
# rem - it (5); the $ hole, the primary inside [block start, row) (4):
# 44. The step: two occ (88), c's pattern and c == 0 (2), the C-array
# pick and two adds (3), the tests of c <= 3 and top < bot (2). The
# compiled step issues more (chip_smoke.py reads the SASS of its loop).
OPS_PER_STEP = 2 * 44 + 2 + 3 + 2
OPS_FTAB_KEY = 3 * FTAB_CHARS     # the ftab key: load check, shift, add
SIDE_BYTES_PER_STEP = 64          # two 32-byte sides
LANE_IO_BYTES = {"search": 4 + 12, "record": 4, "cont": 16 + 12,
                 "lf_step": 12 + 8}


def walk_steps(pat, lens, rec_top, rec_bot, use_ftab: bool = False):
    """LF steps (side fetch pairs) of each lane [P] of a walk over patterns
    [P, L] with lengths [P], from the recorded pass (rec_top, rec_bot)
    [L+1, P] over the same patterns: step s (matching character lens-1-s)
    fetches when the range after s steps is nonempty and the character is
    0..3. With use_ftab, lanes whose last FTAB_CHARS characters are all
    0..3 start at step FTAB_CHARS (their ftab range is the record's entry
    there)."""
    s, c, pos = _chars(pat, lens)
    go = (pos >= 0) & (rec_top[:pat.shape[1]] < rec_bot[:pat.shape[1]]) \
        & (c <= 3)
    if use_ftab:
        go &= ~(ftab_lanes(pat, lens)[None, :] & (s < FTAB_CHARS))
    return go.sum(0)


def _chars(pat, lens):
    """(step [L, 1], the character matched at each step [L, P], its
    position [L, P]) of patterns [P, L] read right to left."""
    L = pat.shape[1]
    s = torch.arange(L, device=pat.device)[:, None]
    pos = lens.to(torch.int64)[None, :] - 1 - s
    c = pat.T.gather(0, pos.clamp(0, L - 1)).to(torch.int64)
    return s, c, pos


def ftab_lanes(pat, lens):
    """[P] bool: the lanes that start from the ftab (length >= FTAB_CHARS
    and no N among their last FTAB_CHARS characters)."""
    s, c, pos = _chars(pat, lens)
    bad = ((c > 3) & (pos >= 0) & (s < FTAB_CHARS)).any(0)
    return (lens.to(torch.int64) >= FTAB_CHARS) & ~bad


def walk_bound(steps: int, P: int, n_steps: int, mode: str, ceiling: float,
               side_bytes: int, pat_bytes: int, ftab_lanes: int = 0):
    """(bound ms, "operations" or "bytes") of an fm_walk launch over P lanes
    taking `steps` LF steps in all, on an index whose sides take
    side_bytes, over patterns of pat_bytes; RECORD writes n_steps+1 ranges
    a lane; ftab_lanes look up 8 bytes of the ftab each."""
    ops = steps * OPS_PER_STEP + ftab_lanes * OPS_FTAB_KEY
    nbytes = (min(steps * SIDE_BYTES_PER_STEP, side_bytes) + pat_bytes
              + P * LANE_IO_BYTES[mode] + ftab_lanes * 8)
    if mode == "record":
        nbytes += (n_steps + 1) * P * 8
    return bound(ops, nbytes, ceiling)


def lf_step_bound(c, top, bot, ceiling: float, side_bytes: int):
    """(bound ms, ...) of an fm_lf_step launch on these lanes: every lane's
    inputs and outputs, and a step (its sides counted once, as in
    walk_bound) for those whose c is 0..3 and whose range is nonempty."""
    steps = int(((c <= 3) & (top < bot)).sum())
    return bound(steps * OPS_PER_STEP,
                 min(steps * SIDE_BYTES_PER_STEP, side_bytes)
                 + c.shape[0] * LANE_IO_BYTES["lf_step"], ceiling)


def step_latency_ms(fm: "dfm.DeviceFm", text=None, n_steps: int = 2048,
                    reps: int = 5, pat=None) -> float:
    """Milliseconds of one dependent LF step on the card: 32 lanes (one
    warp) each search an exact n_steps-character substring of `text` (the
    index's text), or the patterns `pat` [32, n_steps] (`walk_patterns`),
    so every step fetches; the launch's median time (CUDA events) over
    n_steps."""
    import statistics
    dev = fm.device
    if pat is None:
        starts = np.linspace(0, len(text) - n_steps - 1, 32).astype(
            np.int64)
        pat = torch.from_numpy(np.stack(
            [text[s : s + n_steps] for s in starts]).astype(np.uint8))
    pat_t = pat.to(dev)
    n_steps = pat_t.shape[1]
    lens = torch.full((pat_t.shape[0],), n_steps, dtype=torch.int32,
                      device=dev)
    dfm.backward_search_body(fm, pat_t, lens, use_ftab=False)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        top, bot = dfm.backward_search_body(fm, pat_t, lens, use_ftab=False)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    if not bool((top < bot).all()):
        raise RuntimeError("step_latency_ms: a substring of the text has an "
                           "empty range")
    return statistics.median(times) / n_steps


# int32 operations of the walk-left (ops/csrc/fm.cu fm_resolve), from the
# recurrence as OPS_PER_STEP is. A trip's mark test: the block and the
# remainder (2), the lo/hi word select (1), the bit's shift and test (2):
# 5. An LF step after it: the character (word index, select, shift
# amount, shift and mask: 5), then one occ of that character as above
# (the pattern 1, six ops a word and the prefix mask's two, 32, the sum
# and rem - it, 5: 38), the count and C-array picks (2), the $ hole (4)
# and the sum of C, count and occ (2): 51. The marked row's rank and
# sample: the mask below the row (2), the two masked words (2), two
# popcounts (2), the two adds (2), the clamp (1), the add of the steps (1):
# 10.
OPS_RESOLVE_TEST = 5
OPS_RESOLVE_STEP = 51
OPS_RESOLVE_HIT = 10
RESOLVE_TRIP_BYTES = 16 + 32      # the mark row and the side
RESOLVE_LANE_BYTES = 4 + 1 + 4    # the row, valid, the offset


def table_bytes(fm: "dfm.DeviceFm") -> int:
    """Bytes of a direction's sides and (a big index's) marks."""
    return 4 * (fm.side.numel() + (fm.mark.numel() if fm.mark is not None
                                   else 0))


def resolve_steps(fm: "dfm.DeviceFm", rows, valid):
    """[P] int64: the LF steps each lane of a resolve_rows_body call
    takes (0 where ~valid)."""
    return torch.where(valid, dfm.walk_left_torch(fm, rows, valid)[1], 0)


def resolve_bound(steps, valid, ceiling: float, table_bytes: int):
    """(bound ms, ...) of an fm_resolve launch whose lanes take `steps`
    LF steps ([P] int64) on an index whose sides and marks take
    table_bytes: each valid lane makes steps + 1 trips and one sample
    load."""
    n_valid = int(valid.sum())
    trips = int(steps.sum()) + n_valid
    ops = (trips * OPS_RESOLVE_TEST + int(steps.sum()) * OPS_RESOLVE_STEP
           + n_valid * OPS_RESOLVE_HIT)
    nbytes = (min(trips * RESOLVE_TRIP_BYTES, table_bytes) + 4 * n_valid
              + valid.shape[0] * RESOLVE_LANE_BYTES)
    return bound(ops, nbytes, ceiling)


# ------------------------------------------------ HBM-resident tables -

def walk_blocks(pat, lens, rec_top, rec_bot, use_ftab: bool = False) -> int:
    """Distinct 64-row blocks whose sides the walk `walk_steps` counts
    reads (rec_*: its recorded pass, int32 bit patterns or widened): the
    DRAM reads a launch needs at least, when a block once read stays in
    L2."""
    s, c, pos = _chars(pat, lens)
    L = pat.shape[1]
    t, b = dfm.widen(rec_top[:L]), dfm.widen(rec_bot[:L])
    go = (pos >= 0) & (t < b) & (c <= 3)
    if use_ftab:
        go &= ~(ftab_lanes(pat, lens)[None, :] & (s < FTAB_CHARS))
    return int(torch.unique(torch.cat([t[go] >> 6, b[go] >> 6])).numel())


def cont_work(fm: "dfm.DeviceFm", pat, cb, pos, top, bot, n_steps: int):
    """(LF steps of each lane [P], distinct blocks read) of a continuation
    walk (ops/fm.py `one_mm_phase1_body`), stepped once at a time by its
    plain version: a lane reads the sides of its range's ends while its
    position is not past the start, its range is nonempty and its
    character is 0..3."""
    R, L = pat.shape
    rows = cb.to(torch.int64).clamp(0, R - 1)
    steps = torch.zeros(cb.shape[0], dtype=torch.int64, device=cb.device)
    blocks = []
    for _ in range(n_steps):
        t, b = dfm.widen(top), dfm.widen(bot)
        c = pat[rows, pos.to(torch.int64).clamp(0, L - 1)]
        go = (pos >= 0) & (t < b) & (c <= 3)
        if not go.any():
            break
        steps += go
        blocks.append(torch.unique(torch.cat([t[go] >> 6, b[go] >> 6])))
        pos, top, bot = dfm.one_mm_phase1_body_torch(fm, pat, cb, pos, top,
                                                     bot, 1)
    n_blocks = (int(torch.unique(torch.cat(blocks)).numel()) if blocks
                else 0)
    return steps, n_blocks


def resolve_blocks(fm: "dfm.DeviceFm", rows, valid) -> int:
    """Distinct 64-row blocks the walk-left of these rows reads (a trip
    reads its row's block's mark row and side; a lane stops at a marked
    row or after 2^off_rate trips), replayed with the plain LF step."""
    row = dfm.widen(rows)[valid]
    blocks = []
    for _ in range(1 << fm.off_rate):
        if row.numel() == 0:
            break
        blk, rem = row >> 6, row & 63
        blocks.append(torch.unique(blk))
        mk = dfm.widen(fm.mark[blk])
        word = torch.where(rem < 32, mk[:, 0], mk[:, 1])
        live = ((word >> (rem & 31)) & 1) == 0
        row, c = row[live], bwt_codes(fm, row[live])
        row = fm.cnt[c] + dfm.widen(dfm.occ_batch(fm, c, dfm.narrow(row)))
    return (int(torch.unique(torch.cat(blocks)).numel()) if blocks else 0)


def walk_bound_hbm(blocks: int, steps: int, P: int, n_steps: int,
                   mode: str, ceiling: float, rate32: float, pat_bytes: int,
                   ftab_lanes: int = 0):
    """(bound ms, "operations" or "bytes") of an fm_walk launch whose sides
    lie in HBM: each of the `blocks` distinct sides it reads one random
    32-byte read at the gather probe's rate32 (reads/s), the patterns, the
    lanes' inputs and outputs, the ftab entries and the record at the
    stream rate."""
    ops = steps * OPS_PER_STEP + ftab_lanes * OPS_FTAB_KEY
    nbytes = pat_bytes + P * LANE_IO_BYTES[mode] + ftab_lanes * 8
    if mode == "record":
        nbytes += (n_steps + 1) * P * 8
    t_ops = ops / ceiling * 1e3
    t_bytes = blocks / rate32 * 1e3 + nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def resolve_bound_hbm(blocks: int, steps, valid, ceiling: float,
                      rate32: float):
    """(bound ms, ...) of an fm_resolve launch whose marks and sides lie in
    HBM: each of the `blocks` distinct blocks its trips read two random
    32-byte reads (its 16-byte mark row and its 32-byte side, in separate
    arrays) at the gather probe's rate32, the samples and each lane's
    input and output at the stream rate."""
    n_valid = int(valid.sum())
    trips = int(steps.sum()) + n_valid
    ops = (trips * OPS_RESOLVE_TEST + int(steps.sum()) * OPS_RESOLVE_STEP
           + n_valid * OPS_RESOLVE_HIT)
    t_ops = ops / ceiling * 1e3
    t_bytes = (2 * blocks / rate32 * 1e3
               + (4 * n_valid + valid.shape[0] * RESOLVE_LANE_BYTES)
               / HBM_BYTES_PER_S * 1e3)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gather_rates(device, table_bytes: int = 1 << 31, n: int = 1 << 24,
                 reps: int = 5, seed: int = 0) -> dict:
    """Random reads/s of 32- and 64-byte aligned records from a table of
    table_bytes on the card: plain PyTorch indexing of one int32 in each
    32-byte sector of n uniformly random records, the best of `reps` timed
    launches (CUDA events, after one warm-up). The time includes reading
    the int64 indices and writing the values (12 bytes a sector at the
    stream rate), so the rate is a little below the DRAM's own."""
    dev = torch.device(device)
    words = table_bytes // 4
    table = torch.zeros(words, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    out = {}
    for width in (32, 64):
        per = width // 4
        rec = torch.randint(0, words // per, (n,), generator=g, device=dev)
        idx = (rec[:, None] * per
               + torch.arange(0, per, 8, device=dev)[None, :]).reshape(-1)
        del rec
        best = float("inf")
        for k in range(reps + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            table[idx]
            b.record()
            torch.cuda.synchronize(dev)
            if k:
                best = min(best, a.elapsed_time(b))
        out[width] = n / (best / 1e3)
        del idx
    return out


_M32 = dfm.M32


def _set_bits(t, r: int, c: int, value: int, nbits: int) -> None:
    """Write `value` into bits [r, r + nbits) of int32 t[..., c] at row
    index r (host round trip: one element)."""
    v = int(t[c]) & _M32
    mask = ((1 << nbits) - 1) << r
    t[c] = dfm.as_i32((v & ~mask & _M32) | ((value << r) & mask))


def random_fm(n: int, device, seed: int = 0, big: bool = False,
              off_rate: int = dfm.OFF_RATE_BIG) -> "dfm.DeviceFm":
    """A direction of n rows laid out as `ops.fm.to_device` lays out an
    index (a big one: also its marks and samples), built on `device` in
    seconds: a random BWT with its $ (packed as 0, uncounted) at
    a random primary row; block counts and the C array from it, so that LF
    is a permutation of the rows and every walk stays in range; with
    `big`, mark bits of density 2^-off_rate (the primary row marked, as
    SA 0 is in an index) with consistent block ranks and random samples;
    the ftab from a plain search of every FTAB_CHARS-mer. Its SA is
    unknown: a walk-left resolves to a sample plus steps, or to 0 when no
    mark lies within 2^off_rate trips, as on any index."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rint = lambda *shape: torch.randint(
        -(1 << 31), 1 << 31, shape, generator=g, device=dev,
        dtype=torch.int32)
    nb = (n + dfm.DEV_OCC_BLOCK - 1) // dfm.DEV_OCC_BLOCK
    rec = torch.zeros((nb + 1, 8), dtype=torch.int32, device=dev)
    rec[:nb, 4:8] = rint(nb, 4)
    primary = int(torch.randint(1, n, (1,), generator=g, device=dev))
    # the $ and the rows past n pack as 0
    words = rec[:, 4:8].reshape(-1)
    _set_bits(words, 2 * (primary & 15), primary >> 4, 0, 2)
    for r in range(n, nb * 64):
        _set_bits(words, 2 * (r & 15), r >> 4, 0, 2)
    rec[:nb, 4:8] = words.view(-1, 4)[:nb]
    per = torch.zeros((nb, 4), dtype=torch.int64, device=dev)
    ch = 1 << 22
    for b0 in range(0, nb, ch):
        b1 = min(b0 + ch, nb)
        w = dfm.widen(rec[b0:b1, 4:8])
        for c in range(4):
            x = w ^ (c * dfm._PAIR_MASK)
            per[b0:b1, c] = 64 - dfm._popc32(
                (x | (x >> 1)) & dfm._PAIR_MASK).sum(1)
    per[primary >> 6, 0] -= 1
    per[nb - 1, 0] -= nb * 64 - n
    tot = per.sum(0).tolist()
    if sum(tot) != n - 1:
        raise AssertionError("random_fm: block counts do not sum to n - 1")
    rec[1:, :4] = dfm.narrow(torch.cumsum(per, 0))
    del per
    cnt = (1, 1 + tot[0], 1 + tot[0] + tot[1], 1 + tot[0] + tot[1] + tot[2])
    big_f = {}
    if big:
        bits = rint(nb, 2)
        for _ in range(off_rate - 1):
            bits &= rint(nb, 2)
        flat = bits.reshape(-1)
        _set_bits(flat, primary & 31, primary >> 5, 1, 1)
        for r in range(n, nb * 64):
            _set_bits(flat, r & 31, r >> 5, 0, 1)
        mark = torch.zeros((nb + 1, 4), dtype=torch.int32, device=dev)
        mark[:nb, :2] = bits
        marked = dfm._popc32(dfm.widen(bits)).sum(1)
        mark[1:, 2] = dfm.narrow(torch.cumsum(marked, 0))
        big_f = dict(mark=mark, sa_samp=rint(int(marked.sum())),
                     off_rate=off_rate)
        del bits, flat, marked
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    fm = dfm.DeviceFm(side=rec, cnt=torch.tensor(cnt, device=dev), sa=one,
                      ftab_top=one, ftab_bot=one, n=n, primary=primary,
                      cnt_host=cnt, **big_f)
    # the ftab: the ranges of all 4^j suffixes of length j, j = 1..10 (the
    # key's character i, in text order, weighs 4^(FTAB_CHARS - 1 - i))
    top = torch.zeros(1, dtype=torch.int32, device=dev)
    bot = torch.full((1,), dfm.as_i32(n), dtype=torch.int32, device=dev)
    for _ in range(FTAB_CHARS):
        k = top.shape[0]
        c = torch.arange(4, device=dev).repeat_interleave(k)
        top, bot = dfm.lf_step_torch(fm, c, top.repeat(4), bot.repeat(4))
    empty = dfm.widen(top) >= dfm.widen(bot)
    return fm._replace(ftab_top=torch.where(empty, 0, top),
                       ftab_bot=torch.where(empty, 0, bot))


def bwt_codes(fm: "dfm.DeviceFm", rows):
    """[B] int64: the packed BWT code (0..3; the $ row packs as 0) of each
    row (int32 bit patterns or int64)."""
    r = dfm.widen(rows)
    blk, rem = r >> 6, r & 63
    words = dfm.widen(fm.side[blk][:, 4:])
    w = words.gather(1, (rem >> 4)[:, None])[:, 0]
    return (w >> (2 * (rem & 15))) & 3


def walk_patterns(fm: "dfm.DeviceFm", rows, L: int):
    """[P, L] uint8 patterns read off the index by LF walks from `rows`
    [P]: lane i's last character is BWT[rows[i]], its next-to-last the
    BWT at LF of that row, and so on, so that a backward search of any
    suffix of a pattern keeps a nonempty range (the walk's row lies in it)
    unless the walk met the $ row (about L/n of lanes)."""
    row = dfm.widen(rows)
    pat = torch.empty((row.shape[0], L), dtype=torch.uint8,
                      device=row.device)
    for s in range(L):
        c = bwt_codes(fm, row)
        pat[:, L - 1 - s] = c.to(torch.uint8)
        row = fm.cnt[c] + dfm.widen(dfm.occ_batch(fm, c, dfm.narrow(row)))
    return pat


# ------------------------------------------------------- the HBM bench -

L2_N = 1 << 22          # the L2 shape's text: 4 Mbp, 3 MB of tables a
                        # direction
# the FM wrappers whose first call in a batch each shape takes, and the
# kernel that call launches
CAPTURED = {"backward_search_record_body": "fm_walk_kernel",
            "backward_search_body": "fm_walk_kernel",
            "one_mm_phase1_body": "fm_walk_kernel",
            "lf_step": "fm_lf_step_kernel",
            "resolve_rows_body": "fm_resolve_kernel"}


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def load_parent(root):
    """The port package of the checkout at `root`, imported under the name
    bt2port_parent (its modules import each other relatively), so that it
    runs beside this one in one process; it builds its kernels into its
    own checkout."""
    pkg = Path(root).resolve() / "bowtie2_server_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "bt2port_parent", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bt2port_parent"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("bt2port_parent.ops.fm")


class _Capture:
    """Wraps the FM wrappers of ops.fm while a batch runs: the first call's
    arguments and the number of calls of each of CAPTURED."""

    def __init__(self):
        self.first, self.calls, self.orig = {}, dict.fromkeys(CAPTURED, 0), {}

    def __enter__(self):
        for name in CAPTURED:
            fn = self.orig[name] = getattr(dfm, name)

            def call(*a, _name=name, _fn=fn, **k):
                self.calls[_name] += 1
                self.first.setdefault(_name, (a, k))
                return _fn(*a, **k)
            setattr(dfm, name, call)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(dfm, name, fn)


def _work(name, fm, args, kw, ceiling, rates):
    """Lanes, LF steps, the longest lane's steps and the L2 and HBM bounds
    of one captured call."""
    if name == "resolve_rows_body":
        rows, valid = args
        steps = resolve_steps(fm, rows, valid)
        return dict(lanes=int(rows.shape[0]), lf_steps=int(steps.sum()),
                    max_steps=int(steps.max()),
                    bound_l2=resolve_bound(steps, valid, ceiling,
                                           table_bytes(fm)),
                    dram_blocks=(nbl := resolve_blocks(fm, rows, valid)),
                    bound_hbm=resolve_bound_hbm(nbl, steps, valid, ceiling,
                                                rates[32]))
    side_bytes = fm.side.shape[0] * 32
    if name == "lf_step":
        c, top, bot = args
        t, b = dfm.widen(top), dfm.widen(bot)
        go = (c <= 3) & (t < b)
        nbl = int(torch.unique(torch.cat([t[go] >> 6, b[go] >> 6])).numel())
        return dict(lanes=int(c.shape[0]), lf_steps=int(go.sum()),
                    max_steps=1, dram_blocks=nbl,
                    bound_l2=lf_step_bound(c, top, bot, ceiling, side_bytes),
                    bound_hbm=walk_bound_hbm(nbl, int(go.sum()),
                                             int(c.shape[0]), 1, "lf_step",
                                             ceiling, rates[32], 0))
    if name == "one_mm_phase1_body":
        pat, cb, pos, top, bot, n_steps = args
        per, nbl = cont_work(fm, pat, cb, pos, top, bot, n_steps)
        mode, P, L = "cont", cb.shape[0], n_steps
        pat_bytes = pat.numel()
        n_ftab = 0
    else:
        pat, lens = args[:2]
        use_ftab = (name == "backward_search_body"
                    and kw.get("use_ftab", args[2] if len(args) > 2
                               else True))
        rec = dfm.backward_search_record_body(fm, pat, lens)
        per = walk_steps(pat, lens, *map(dfm.widen, rec), use_ftab=use_ftab)
        nbl = walk_blocks(pat, lens, *rec, use_ftab=use_ftab)
        mode = "record" if name == "backward_search_record_body" else "search"
        P, L = pat.shape
        pat_bytes = pat.numel()
        n_ftab = int(ftab_lanes(pat, lens).sum()) if use_ftab else 0
    steps = int(per.sum())
    return dict(lanes=int(P), lf_steps=steps, max_steps=int(per.max()),
                dram_blocks=nbl,
                bound_l2=walk_bound(steps, P, L, mode, ceiling, side_bytes,
                                    pat_bytes, ftab_lanes=n_ftab),
                bound_hbm=walk_bound_hbm(nbl, steps, P, L, mode, ceiling,
                                         rates[32], pat_bytes,
                                         ftab_lanes=n_ftab))


def _turns(fn_parent, fn_change, symbol, dev):
    """Device ms of the parent's and the change's kernel in turns: parent,
    change, change, parent."""
    from .bench_dp import device_ms
    out = dict(parent=[], change=[])
    if fn_parent is not None:
        out["parent"].append(device_ms(fn_parent, dev, symbol, reps=5))
    out["change"].append(device_ms(fn_change, dev, symbol, reps=5))
    out["change"].append(device_ms(fn_change, dev, symbol, reps=5))
    if fn_parent is not None:
        out["parent"].append(device_ms(fn_parent, dev, symbol, reps=5))
    return out


def bench_shape(label, idx, big, read_len, n_reads, ceiling, rates, pfm,
                seed=5, device="cuda"):
    """One batch of n_reads reads through UnpairedAligner on idx (the big
    layout when `big`), its first call of each CAPTURED wrapper timed with
    this checkout's kernels and (pfm, the parent's ops.fm) the parent's,
    beside its bounds and chain floor. Returns the shape's records."""
    from ..align.pipeline import UnpairedAligner
    from ..io.fastq import make_batch
    from .bench_big_index import make_reads
    dev = torch.device(device)
    t0 = time.time()
    al = UnpairedAligner(idx, device=dev, force_big=big)
    seqs = make_reads(idx.joined, n_reads, seed=seed)[0]
    seqs = [s[:read_len] for s in seqs]
    batch = make_batch([f"r{i}" for i in range(n_reads)], seqs,
                       [b"I" * read_len] * n_reads)
    with _Capture() as cap:
        al.align_batch(batch)
    log(f"{label}: aligner and one batch in {time.time() - t0:.1f} s; "
        f"calls {cap.calls}")
    dirs = {al.dev.side.data_ptr(): "fw"}
    if al.dev_mirror is not None:
        dirs[al.dev_mirror.side.data_ptr()] = "mirror"
    pdev = ({name: pfm.to_device(getattr(idx, name), dev, big=big)
             for name in dirs.values()} if pfm is not None else {})
    # the chain floor's step on these tables (fw, 32 lanes x 2048 steps)
    text = np.asarray(idx.joined)
    lat = step_latency_ms(al.dev, text)
    out = dict(step_latency_ms=lat, table_bytes=table_bytes(al.dev),
               calls_a_batch=cap.calls, kernels={})
    for name, (args, kw) in cap.first.items():
        fm = args[0]
        rest = args[1:]
        w = _work(name, fm, rest, kw, ceiling, rates)
        fn_c = lambda: getattr(dfm, name)(fm, *rest, **kw)
        fn_p = None
        if pfm is not None:
            pf = pdev[dirs[fm.side.data_ptr()]]
            fn_p = lambda: getattr(pfm, name)(pf, *rest, **kw)
            got, want = fn_c(), fn_p()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if not all(torch.equal(g, w_) for g, w_ in zip(got, want)):
                raise RuntimeError(f"{label} {name}: the change's kernel "
                                   f"differs from the parent's")
        t = _turns(fn_p, fn_c, CAPTURED[name], dev)
        w.update(t, chain_floor_ms=w["max_steps"] * lat)
        ms = float(np.mean(t["change"]))
        log(f"{label} {name}: {w['lanes']} lanes, {w['lf_steps']} LF "
            f"steps; parent {t['parent']} ms, change {t['change']} ms"
            f"; bound L2 {w['bound_l2'][0]:.4f} "
            f"({ms and w['bound_l2'][0] / ms:.3f}),"
            f" HBM {w['bound_hbm'][0]:.4f} ({w['bound_hbm'][0] / ms:.3f});"
            f" chain floor {w['chain_floor_ms']:.4f}")
        out["kernels"][name] = w
    return out


def main(argv=None):
    from .bench_big_index import build_or_load
    from .bench_dp import card_line, measure_alu_ceiling
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 29)
    ap.add_argument("--reads", type=int, default=32768)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--no-cache", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fm: needs a CUDA device")
    dev = torch.device("cuda")
    card = card_line(dev)
    pfm = load_parent(args.parent) if args.parent else None
    rates = gather_rates(dev)
    log(f"gather probe: {rates[32]:.4g} random 32-byte and {rates[64]:.4g} "
        f"random 64-byte reads/s ({rates[32] * 32 / 1e12:.3f} and "
        f"{rates[64] * 64 / 1e12:.3f} TB/s) on {card}")
    ceiling = measure_alu_ceiling(dev)[0]
    out = dict(card=card, gather_reads_per_s={str(k): v for k, v in
                                              rates.items()},
               ceiling_ops_per_s=ceiling, shapes={})
    for tag, n in (("l2", L2_N), ("hbm", args.n)):
        t0 = time.time()
        idx, _ = build_or_load(n, not args.no_cache)
        log(f"{tag}: index of {n} bp ready in {time.time() - t0:.1f} s")
        for label, big, rl in ((f"{tag}_big_100bp", True, 100),
                               (f"{tag}_small_36bp", False, 36)):
            out["shapes"][label] = bench_shape(label, idx, big, rl,
                                               args.reads, ceiling, rates,
                                               pfm)
        del idx
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
