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

The walk-left of a big index (`fm_resolve`) is counted the same way:
`resolve_steps` gives each lane's LF steps (ops/fm.py `walk_left_torch`),
and `resolve_bound` charges a trip (a step, or the final test of the
marked row) its 48 bytes of mark and side (counted once, as the sides
are) and the recurrence's operations, a lane its sample and its input
and output.
"""
from __future__ import annotations

import torch

from ..index.fm import FTAB_CHARS
from ..ops import fm as dfm
from .bench_rect import bound

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


def step_latency_ms(fm: "dfm.DeviceFm", text, n_steps: int = 2048,
                    reps: int = 5) -> float:
    """Milliseconds of one dependent LF step on the card: 32 lanes (one
    warp) each search an exact n_steps-character substring of `text` (the
    index's text), so every step fetches; the launch's median time (CUDA
    events) over n_steps."""
    import statistics
    import numpy as np
    starts = np.linspace(0, len(text) - n_steps - 1, 32).astype(np.int64)
    pat = np.stack([text[s : s + n_steps] for s in starts]).astype(np.uint8)
    dev = fm.device
    pat_t = torch.from_numpy(pat).to(dev)
    lens = torch.full((32,), n_steps, dtype=torch.int32, device=dev)
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
