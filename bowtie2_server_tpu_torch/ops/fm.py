"""Batched FM-index ops on the device (ref: aligner_seed.cpp:668
searchSeedBi, :854 exactSweep; bt2_idx.h:1758 countBt2Side, :2087
mapLFEx). Port of bowtie2_server_tpu/ops/fm.py, small (full-SA) and big
(sampled-SA) indexes.

    occ(c, row) = ckpt[row // 64, c] + count(bwt[row//64*64 : row] == c)
    LF: top' = cnt[c] + occ(c, top);  bot' = cnt[c] + occ(c, bot)

applied to [lanes]-shaped row vectors, one step per pattern character,
right to left. Sides are 32 bytes per 64-row block: [cntA, cntC, cntG,
cntT, w0..w3] as 8 uint32 words (the counts at the block start, then the
block's BWT 2-bit packed, 16 bases a word, little-endian; the $ hole packs
as 0 and is subtracted from c == 0 counts).

Row convention. A row (and an SA offset) is a uint32 value. Every tensor
holding rows, and the sides, marks, samples and ftab, is int32 holding the
uint32 bit pattern (the same bytes as the JAX package's arrays). The plain
torch code widens such a tensor with `widen` (int64, `& 0xFFFFFFFF`)
before any arithmetic or comparison and narrows a result with `narrow`
(mod 2^32, then the int32 with those bits), never with a plain
`.to(torch.int32)`. Small indexes (joined text under BIG_THRESHOLD) only
hold rows below 2^31, where the pattern is the value; big indexes
(GRCh38-scale, docs/BIGINDEX.md) reach 2^32 - 1, and the CUDA kernels
then run their uint32 instantiation (`DeviceFm.big`).

Two implementations of the LF walk:
  - the plain PyTorch version: `lf_step_torch` (occ by a SWAR popcount in
    int64), stepped in a Python loop by the `*_torch` walks;
  - the CUDA kernels of ops/csrc/fm.cu: `fm_walk` (one thread a lane walks
    its whole chain in one launch: the exact search with or without the
    ftab jump, the recorded pass, the 1-mismatch continuation) and
    `fm_lf_step` (one step on explicit characters).
The wrappers (`lf_step`, `backward_search_body`,
`backward_search_record_body`, `one_mm_phase1_body`,
`resolve_rows_body`) take the plain version only for tensors on the CPU;
on CUDA tensors they launch the kernel or raise. `occ_batch`, `occ_all4`
and `lf_all4` are the plain building blocks (no path calls them on the
card).

A recorded pass is laid out [L+1, lanes] (entry s holds the range after
matching the length-s suffix), so that the kernel's writes are coalesced;
every consumer here indexes it that way.

SA resolution: a small index keeps the full suffix array on the device
and resolves a row by one gather (ref: group_walk.h, redesigned away); a
big index keeps only the SA values that are multiples of 2^off_rate, with
a mark bitmap, and resolves a row by walking left to a marked row
(`resolve_rows_body`, the `fm_resolve` kernel; ref: bt2_idx.h:1607
walkLeft, :1612 getOffset). The host-array helpers (`backward_search`,
`sa_resolve`, `lf_step_padded`, `one_mm_branch_hits`) serve the host path,
which big indexes do not take (as in the JAX package).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..index.fm import FTAB_CHARS, FmDirection
from . import kernels

DEV_OCC_BLOCK = 64
_SIDE_W = 8
_PAIR_MASK = 0x55555555
M32 = 0xFFFFFFFF          # a uint32 row's bits in int64
# joined texts this long take the big-index layout: uint32 rows and an SA
# sampled every 2^OFF_RATE_BIG values (the reference's offRate,
# bt2_idx.h:133, defaults to 5; 4 halves the walk-left trips)
BIG_THRESHOLD = (1 << 31) - (1 << 23)   # headroom for the diagonal bias
OFF_RATE_BIG = 4

# fm_walk modes (ops/csrc/fm.cu)
WALK_SEARCH, WALK_RECORD, WALK_CONT = 0, 1, 2


class DeviceFm(NamedTuple):
    """Device tensors of one FM direction, plus its scalars on the host
    (int32 tensors hold uint32 bit patterns: the module doc's row
    convention)."""
    side: torch.Tensor      # [n_blocks+1, 8] int32
    cnt: torch.Tensor       # [4] int64 C-array
    sa: torch.Tensor        # [n] int32 full SA ([1] dummy when big)
    ftab_top: torch.Tensor  # [4^FTAB_CHARS] int32
    ftab_bot: torch.Tensor  # [4^FTAB_CHARS] int32
    n: int                  # rows (text length + 1)
    primary: int            # row of the BWT hole ($, packed 0)
    cnt_host: tuple         # the C-array as 4 ints
    # big indexes only (None otherwise):
    mark: torch.Tensor | None = None     # [n_blocks+1, 4] int32: [bits_lo,
                            # bits_hi, rank, 0] a 64-row block; bit b set
                            # iff SA[blk*64+b] % 2^off_rate == 0, rank =
                            # marked rows before the block
    sa_samp: torch.Tensor | None = None  # [n_marked] int32: the SA values
                            # of the marked rows, in row order
    off_rate: int = 0       # 0: full SA, else the sampling exponent

    @property
    def device(self) -> torch.device:
        return self.side.device

    @property
    def big(self) -> bool:
        return self.off_rate > 0


def widen(t):
    """int32 tensor of uint32 bit patterns -> int64 values."""
    return t.to(torch.int64) & M32


def narrow(x):
    """int64 tensor -> int32 tensor holding the bits of x mod 2^32."""
    x = x & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def as_i32(v: int) -> int:
    """A uint32 Python int as the int32 with the same bits."""
    v &= M32
    return v - (1 << 32) if v >= (1 << 31) else v


_CH_BLOCKS = 1 << 20       # host build chunk: 64 Mi rows


def build_sides(d: FmDirection) -> np.ndarray:
    """[n_blocks+1, 8] uint32 fused sides of one direction (see module
    doc), built in chunks of blocks (host memory O(chunk) beyond the
    result)."""
    n = d.n
    n_blocks = (n + DEV_OCC_BLOCK - 1) // DEV_OCC_BLOCK
    side = np.zeros((n_blocks + 1, _SIDE_W), np.uint32)
    per_block = np.zeros((n_blocks + 1, 4), np.uint64)
    shifts = 2 * np.arange(16, dtype=np.uint32)
    for b0 in range(0, n_blocks + 1, _CH_BLOCKS):
        b1 = min(b0 + _CH_BLOCKS, n_blocks + 1)
        lo, hi = b0 * DEV_OCC_BLOCK, b1 * DEV_OCC_BLOCK
        codes = np.zeros(hi - lo, np.uint8)
        seg = d.bwt[lo : min(hi, n)]
        codes[: len(seg)] = seg
        valid = codes < 4
        valid[len(seg):] = False
        codes[~valid] = 0         # the $ hole (and padding) packs as 0
        side[b0:b1, 4:] = (codes.reshape(-1, 16).astype(np.uint32)
                           << shifts).sum(axis=1, dtype=np.uint64).astype(
            np.uint32).reshape(-1, 4)
        cb = codes.reshape(-1, DEV_OCC_BLOCK)
        vb = valid.reshape(-1, DEV_OCC_BLOCK)
        per_block[b0:b1] = np.stack(
            [((cb == c) & vb).sum(1, dtype=np.uint64) for c in range(4)], 1)
    # checkpoint counts at block starts (hole uncounted)
    side[1:, :4] = np.cumsum(per_block[:-1], axis=0).astype(np.uint32)
    return side


def build_marks(sa: np.ndarray, off_rate: int):
    """The sampled SA of a big index from its full SA [n] (row order):
    (mark [n_blocks+1, 4] uint32, sa_samp [n_marked] uint32), laid out as
    DeviceFm's fields; built in chunks of blocks."""
    n = len(sa)
    n_blocks = (n + DEV_OCC_BLOCK - 1) // DEV_OCC_BLOCK
    mask = (1 << off_rate) - 1
    mark = np.zeros((n_blocks + 1, 4), np.uint32)
    samp = []
    for b0 in range(0, n_blocks + 1, _CH_BLOCKS):
        b1 = min(b0 + _CH_BLOCKS, n_blocks + 1)
        lo, hi = b0 * DEV_OCC_BLOCK, b1 * DEV_OCC_BLOCK
        seg = np.asarray(sa[lo : min(hi, n)])
        marked = np.zeros(hi - lo, bool)
        marked[: len(seg)] = (seg & mask) == 0
        # bit b of word w is row 32w + b: the lo and hi words of a block
        mark[b0:b1, :2] = np.packbits(marked, bitorder="little").view(
            "<u4").reshape(-1, 2)
        mark[b0:b1, 2] = marked.reshape(-1, DEV_OCC_BLOCK).sum(
            1, dtype=np.uint64).astype(np.uint32)
        samp.append(seg[marked[: len(seg)]].astype(np.uint32))
    # rank = marked rows before the block
    counts = mark[:, 2].astype(np.uint64)
    mark[:, 2] = 0
    mark[1:, 2] = np.cumsum(counts[:-1]).astype(np.uint32)
    return mark, np.concatenate(samp)


def to_device(d: FmDirection, device, big: bool | None = None,
              off_rate: int = OFF_RATE_BIG) -> DeviceFm:
    """The device layout of one direction on `device`: small (full SA) or,
    with `big` (default: the direction's rows reach BIG_THRESHOLD), the
    big layout, whose SA is sampled every 2^off_rate values."""
    if big is None:
        big = d.n >= BIG_THRESHOLD
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    i32 = lambda a: put(np.ascontiguousarray(a, np.uint32).view(np.int32))
    cnt = tuple(int(x) for x in d.cnt[:4])
    fields = dict(side=i32(build_sides(d)),
                  cnt=put(np.asarray(cnt, np.int64)),
                  ftab_top=i32(d.ftab_top), ftab_bot=i32(d.ftab_bot),
                  n=int(d.n), primary=int(d.primary), cnt_host=cnt)
    if not big:
        return DeviceFm(sa=i32(d.sa), **fields)
    mark, samp = build_marks(d.sa, off_rate)
    return DeviceFm(sa=put(np.zeros(1, np.int32)), mark=i32(mark),
                    sa_samp=i32(samp), off_rate=off_rate, **fields)


def _pow2_pad(n: int, lo: int = 256) -> int:
    """n rounded up to a power of two (>= lo): the reference package's
    shape bucketing, kept where it sets `one_mm_branch_hits`' chunk width
    and capacity, and so the order of its output."""
    return max(lo, 1 << max(0, int(n - 1).bit_length()))


def nonzero_fixed(mask, size: int, fill: int):
    """Indices of the first `size` True entries of a 1-D mask, ascending,
    padded with `fill` — `jnp.nonzero(size=, fill_value=)` without a host
    synchronisation (rank by cumsum, then scatter; ranks past `size` land
    in a discarded overflow slot)."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    tgt = torch.where(mask & (rank < size), rank, size).to(torch.int64)
    out = torch.full((size + 1,), fill, dtype=torch.int64,
                     device=mask.device)
    out.scatter_(0, tgt, torch.arange(n, dtype=torch.int64,
                                      device=mask.device))
    return out[:size]


# ------------------------------------------------------ plain occ and LF -

def _row_mask(rem):
    """[B, 4] int64 masks selecting the first `rem` (< 64) bases of a side's
    4 packed words. rem: [B] int64."""
    rem_w = (rem[:, None] - 16 * torch.arange(4, device=rem.device)).clamp(
        0, 16)
    return (torch.ones_like(rem_w) << (2 * rem_w)) - 1


def _popc_pairs(x):
    """Set bits of int64 values holding 32-bit patterns whose set bits lie
    only at even positions (SWAR: 2-bit fields already hold 0/1), summed
    over the last axis."""
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x.sum(-1)                       # bytes stay below 256
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0xFF


def _side(fm: DeviceFm, rows):
    """(block, widened side [B, 8]) of int64 rows."""
    blk = rows >> 6
    return blk, widen(fm.side[blk])


def occ_batch(fm: DeviceFm, c, rows):
    """occ(c, row): occurrences of c in bwt[0:row]. c: [B] in 0..3, rows:
    [B] int32 -> [B] int32 (plain torch, one side gather)."""
    c = c.to(torch.int64)
    rows = widen(rows)
    blk, side = _side(fm, rows)
    rem = rows & 63
    base = side[:, :4].gather(1, c[:, None])[:, 0]
    x = side[:, 4:] ^ (c * _PAIR_MASK)[:, None]
    nonmatch = (x | (x >> 1)) & _PAIR_MASK & _row_mask(rem)
    in_block = rem - _popc_pairs(nonmatch)
    corr = ((c == 0) & (fm.primary >= blk * DEV_OCC_BLOCK)
            & (fm.primary < rows))
    return narrow(base + in_block - corr.to(torch.int64))


def occ_all4(fm: DeviceFm, rows):
    """occ(c, row) for all four characters from one side gather a row.
    rows: [B] int32 -> [B, 4] int32 (plain torch)."""
    rows = widen(rows)
    blk, side = _side(fm, rows)
    rem = rows & 63
    mask = _row_mask(rem)
    words = side[:, 4:]
    outs = []
    for c in range(4):
        x = words ^ (c * _PAIR_MASK)
        outs.append(rem - _popc_pairs((x | (x >> 1)) & _PAIR_MASK & mask))
    in_block = torch.stack(outs, 1)
    corr = (fm.primary >= blk * DEV_OCC_BLOCK) & (fm.primary < rows)
    in_block[:, 0] -= corr.to(torch.int64)   # the $ hole counted as 0
    return narrow(side[:, :4] + in_block)


def lf_all4(fm: DeviceFm, top, bot):
    """All-four-character LF step: (new_top, new_bot) each [B, 4] int32.
    Empty/invalid input ranges must be masked by the caller."""
    B = top.shape[0]
    both = widen(occ_all4(fm, torch.cat([top, bot])))
    cnt = fm.cnt[None, :]
    return narrow(cnt + both[:B]), narrow(cnt + both[B:])


def lf_step_torch(fm: DeviceFm, c, top, bot):
    """Plain PyTorch version of one batched backward-search step: lanes
    with c > 3 (N) or an already empty range collapse to (0, 0).
    c/top/bot: [B] -> int32 (new_top, new_bot)."""
    c = c.to(torch.int64)
    new_top = torch.zeros(top.shape, dtype=torch.int32, device=top.device)
    new_bot = torch.zeros_like(new_top)
    # only the lanes that step (most of a branch grid or of a finished
    # walk do not) are counted
    go = torch.nonzero((c <= 3) & (widen(top) < widen(bot))).squeeze(1)
    if go.numel():
        cc = c[go]
        k = go.shape[0]
        both = widen(occ_batch(fm, torch.cat([cc, cc]),
                               torch.cat([top[go], bot[go]])))
        base = fm.cnt[cc]
        new_top[go] = narrow(base + both[:k])
        new_bot[go] = narrow(base + both[k:])
    return new_top, new_bot


def _check_device(name: str, fm: DeviceFm, *tensors) -> torch.device:
    dev = fm.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: a tensor is on {t.device}, the index "
                             f"on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _i32(t):
    return t.to(torch.int32).contiguous()


def _fm_args(fm: DeviceFm):
    """The index's scalars as the C entry points take them (int32 bit
    patterns), then whether rows are uint32."""
    return [*(as_i32(v) for v in (*fm.cnt_host, fm.n, fm.primary)),
            int(fm.big)]


def lf_step(fm: DeviceFm, c, top, bot):
    """One batched LF step (see `lf_step_torch`). On CUDA tensors this
    launches the `fm_lf_step` kernel (ops/csrc/fm.cu)."""
    dev = _check_device("lf_step", fm, c, top, bot)
    if dev.type == "cpu":
        return lf_step_torch(fm, c, top, bot)
    P = c.shape[0]
    c, top, bot = _i32(c), _i32(top), _i32(bot)
    t_out = torch.empty(P, dtype=torch.int32, device=dev)
    b_out = torch.empty_like(t_out)
    if P == 0:
        return t_out, b_out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = kernels.lib().bt2_fm_lf_step(
        fm.side.data_ptr(), c.data_ptr(), top.data_ptr(), bot.data_ptr(),
        t_out.data_ptr(), b_out.data_ptr(), *_fm_args(fm), P, stream)
    kernels.check(rc, "fm_lf_step")
    kernels.LAUNCHES["fm_lf_step"] += 1
    return t_out, b_out


def _walk_cuda(fm, mode, pat, start_pos, n_steps, use_ftab=False, row=None,
               top=None, bot=None):
    """Launch `fm_walk` over P = len(start_pos) lanes; returns (top, bot,
    pos) [P] (search and continuation) or (tops, bots) [n_steps+1, P]
    (record)."""
    dev = fm.device
    P = start_pos.shape[0]
    pat = pat.to(torch.uint8).contiguous()
    start_pos = _i32(start_pos)
    row = _i32(row) if row is not None else None
    top = _i32(top) if top is not None else None
    bot = _i32(bot) if bot is not None else None
    i32 = dict(dtype=torch.int32, device=dev)
    if mode == WALK_RECORD:
        rec_t = torch.empty((n_steps + 1, P), **i32)
        rec_b = torch.empty_like(rec_t)
        outs = (rec_t, rec_b)
        t_out = b_out = p_out = None
    else:
        t_out, b_out, p_out = (torch.empty(P, **i32) for _ in range(3))
        outs = (t_out, b_out, p_out)
        rec_t = rec_b = None
    if P == 0:
        return outs
    ptr = lambda t: t.data_ptr() if t is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = kernels.lib().bt2_fm_walk(
        fm.side.data_ptr(), ptr(fm.ftab_top if use_ftab else None),
        ptr(fm.ftab_bot if use_ftab else None), pat.data_ptr(), ptr(row),
        start_pos.data_ptr(), ptr(top), ptr(bot), ptr(t_out), ptr(b_out),
        ptr(p_out), ptr(rec_t), ptr(rec_b), *_fm_args(fm), pat.shape[1],
        pat.shape[0], P, int(n_steps), mode, int(use_ftab), stream)
    kernels.check(rc, "fm_walk")
    kernels.LAUNCHES["fm_walk"] += 1
    return outs


# ------------------------------------------------------- exact search -

def backward_search_body_torch(fm: DeviceFm, patterns, lengths,
                               use_ftab: bool = True):
    """Plain PyTorch version of `backward_search_body`."""
    B, L = patterns.shape
    k = FTAB_CHARS
    dev = patterns.device
    pat = patterns.to(torch.int64)
    lengths = lengths.to(torch.int64)
    lanes = torch.arange(B, device=dev)

    def gather_char(step):
        # step counts from the right: step 0 -> the last character
        pos = lengths - 1 - step
        c = pat[lanes, pos.clamp(0, L - 1)]
        return torch.where(pos >= 0, c, -1)   # -1: past the start

    if use_ftab:
        # the rightmost k characters, big-endian in text order
        key = torch.zeros(B, dtype=torch.int64, device=dev)
        valid = lengths >= k
        for i in range(k):
            c = gather_char(k - 1 - i)
            key = key * 4 + c.clamp_min(0)
            valid &= (c >= 0) & (c <= 3)
        key = key.clamp(0, 4 ** k - 1)
        top = torch.where(valid, fm.ftab_top[key], 0).to(torch.int32)
        bot = torch.where(valid, fm.ftab_bot[key],
                          as_i32(fm.n)).to(torch.int32)
        # lanes that cannot use the ftab (short, or an N in the last k
        # characters) start from the whole range and LF through every char
        start_step = torch.where(valid, k, 0)
    else:
        top = torch.zeros(B, dtype=torch.int32, device=dev)
        bot = torch.full((B,), as_i32(fm.n), dtype=torch.int32, device=dev)
        start_step = torch.zeros(B, dtype=torch.int64, device=dev)
    for step in range(L):
        c = gather_char(step)
        active = (step >= start_step) & (c >= 0)
        nt, nb = lf_step_torch(fm, torch.where(c < 0, 4, c), top, bot)
        top = torch.where(active, nt, top)
        bot = torch.where(active, nb, bot)
    empty = widen(top) >= widen(bot)
    return torch.where(empty, 0, top), torch.where(empty, 0, bot)


def backward_search_body(fm: DeviceFm, patterns, lengths,
                         use_ftab: bool = True):
    """Batched exact backward search (right to left over each pattern) on
    the index's device. patterns: [B, L] codes (0..3, > 3 = N),
    left-aligned; lengths: [B] (<= L). Returns int32 (top, bot) [B]; an
    empty hit is (0, 0). With `use_ftab` a lane starts from the ftab range
    of its rightmost FTAB_CHARS characters (ref: bt2_idx.h ftabLoHi). On
    CUDA tensors this launches `fm_walk`."""
    dev = _check_device("backward_search", fm, patterns, lengths)
    if dev.type == "cpu":
        return backward_search_body_torch(fm, patterns, lengths, use_ftab)
    top, bot, _ = _walk_cuda(fm, WALK_SEARCH, patterns, lengths - 1,
                             patterns.shape[1], use_ftab=use_ftab)
    return top, bot


def _pad_rows(patterns, lengths, Bp):
    B0, L = patterns.shape
    pat = np.zeros((Bp, L), np.uint8)
    pat[:B0] = patterns
    lens = np.zeros(Bp, np.int32)
    lens[:B0] = lengths
    return pat, lens


def _put(fm: DeviceFm, a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(fm.device)


def backward_search(fm: DeviceFm, patterns, lengths, use_ftab: bool = True):
    """Host arrays in and out: patterns [B, L] uint8 codes, left-aligned;
    lengths [B] -> (top, bot) numpy int32 [B]; empty hit = (0, 0)."""
    top, bot = backward_search_body(fm, _put(fm, patterns, np.uint8),
                                    _put(fm, lengths, np.int32), use_ftab)
    return top.cpu().numpy(), bot.cpu().numpy()


def sa_resolve(fm: DeviceFm, top, count, max_elts: int):
    """Up to max_elts SA entries a range: offsets[b, i] = SA[top[b]+i] for
    i < count[b], else -1 (one gather; replaces lazy group-walk
    resolution, ref: group_walk.h GWState::advance). Host arrays in, numpy
    int32 [B, max_elts] out."""
    top, count = _put(fm, top, np.int64), _put(fm, count, np.int64)
    i = torch.arange(max_elts, device=fm.device)[None, :]
    rows = (top[:, None] + i).clamp(0, fm.sa.shape[0] - 1)
    offs = torch.where(i < count[:, None], fm.sa[rows], -1)
    return offs.to(torch.int32).cpu().numpy()


# ------------------------------------- walk-left resolution (big index) -

def _popc32(x):
    """Set bits of int64 values holding 32-bit patterns (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def resolve_rows_body_torch(fm: DeviceFm, rows, valid):
    """Plain PyTorch version of `resolve_rows_body`."""
    return narrow(walk_left_torch(fm, rows, valid)[0])


def walk_left_torch(fm: DeviceFm, rows, valid):
    """The walk-left of `resolve_rows_body` as the JAX package's fixed
    2^off_rate-iteration masked loop, every lane in every iteration:
    (offsets, LF steps taken) as int64 [B]."""
    row = torch.where(valid, widen(rows), 0)
    done = ~valid
    off = torch.zeros_like(row)
    steps = torch.zeros_like(row)
    n_samp = fm.sa_samp.shape[0]
    for _ in range(1 << fm.off_rate):
        blk, rem = row >> 6, row & 63
        mk = widen(fm.mark[blk])                                # [B, 4]
        in_lo = rem < 32
        sh = rem & 31
        word = torch.where(in_lo, mk[:, 0], mk[:, 1])
        marked = ((word >> sh) & 1) == 1
        below = (torch.ones_like(sh) << sh) - 1
        rank = mk[:, 2] + _popc32(mk[:, 0] & torch.where(in_lo, below, M32)) \
            + _popc32(mk[:, 1] & torch.where(in_lo, 0, below))
        samp = widen(fm.sa_samp[rank.clamp(0, n_samp - 1)])
        off = torch.where(~done & marked, samp + steps, off)
        done = done | marked
        # LF for the unfinished rows: the character and its occ from the
        # same side
        side = widen(fm.side[blk])
        words = side[:, 4:]
        c = (words.gather(1, (rem >> 4)[:, None])[:, 0]
             >> (2 * (rem & 15))) & 3
        x = words ^ (c * _PAIR_MASK)[:, None]
        occ_c = rem - _popc_pairs((x | (x >> 1)) & _PAIR_MASK
                                  & _row_mask(rem))
        base_c = side[:, :4].gather(1, c[:, None])[:, 0]
        corr = ((c == 0) & (fm.primary >= blk * DEV_OCC_BLOCK)
                & (fm.primary < row))
        nrow = fm.cnt[c] + base_c + occ_c - corr.to(torch.int64)
        row = torch.where(done, row, nrow)
        steps = steps + (~done).to(torch.int64)
    return off, steps


def resolve_rows_body(fm: DeviceFm, rows, valid):
    """SA offsets of rows of a big (sampled-SA) index, by walking left
    (ref: bt2_idx.h:1607 walkLeft, :1612 getOffset): LF-step each row
    until it reaches a marked row (SA value % 2^off_rate == 0; the primary
    row, SA 0, is marked, so the BWT hole is never stepped), then offset =
    sa_samp[rank(row)] + steps, after at most 2^off_rate - 1 steps.
    rows: [B] int32 (uint32 patterns), valid: [B] bool -> [B] int32
    offsets (uint32 patterns); 0 where ~valid, which callers mask. On
    CUDA tensors this launches the `fm_resolve` kernel."""
    dev = _check_device("resolve_rows", fm, rows, valid)
    if not fm.big:
        raise ValueError("resolve_rows_body: the index keeps its full SA")
    if dev.type == "cpu":
        return resolve_rows_body_torch(fm, rows, valid)
    P = rows.shape[0]
    rows = _i32(rows)
    valid = valid.to(torch.uint8).contiguous()
    out = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = kernels.lib().bt2_fm_resolve(
        fm.side.data_ptr(), fm.mark.data_ptr(), fm.sa_samp.data_ptr(),
        rows.data_ptr(), valid.data_ptr(), out.data_ptr(),
        fm.sa_samp.shape[0], *(as_i32(v) for v in fm.cnt_host),
        as_i32(fm.primary), P, 1 << fm.off_rate, stream)
    kernels.check(rc, "fm_resolve")
    kernels.LAUNCHES["fm_resolve"] += 1
    return out


# ------------------------------------------------------ recorded pass -

def backward_search_record_body_torch(fm: DeviceFm, patterns, lengths):
    """Plain PyTorch version of `backward_search_record_body`."""
    B, L = patterns.shape
    dev = patterns.device
    pat = patterns.to(torch.int64)
    lengths = lengths.to(torch.int64)
    lanes = torch.arange(B, device=dev)
    top = torch.zeros(B, dtype=torch.int32, device=dev)
    bot = torch.full((B,), as_i32(fm.n), dtype=torch.int32, device=dev)
    tops, bots = [top], [bot]
    for step in range(L):
        pos = lengths - 1 - step
        c = torch.where(pos < 0, 4, pat[lanes, pos.clamp(0, L - 1)])
        nt, nb = lf_step_torch(fm, c, top, bot)
        active = pos >= 0
        top = torch.where(active, nt, top)
        bot = torch.where(active, nb, bot)
        tops.append(top)
        bots.append(bot)
    return torch.stack(tops), torch.stack(bots)


def backward_search_record_body(fm: DeviceFm, patterns, lengths):
    """Like backward_search_body without the ftab and without the final
    normalisation, recording the range after every step: (tops, bots)
    int32 [L+1, B], entry s = the range after matching the length-s suffix
    (s = 0: the full range). Used to seed the substitution branches (ref:
    aligner_seed.cpp:973 oneMmSearch matches one half exactly first). On
    CUDA tensors this launches `fm_walk`."""
    dev = _check_device("backward_search_record", fm, patterns, lengths)
    if dev.type == "cpu":
        return backward_search_record_body_torch(fm, patterns, lengths)
    return _walk_cuda(fm, WALK_RECORD, patterns, lengths - 1,
                      patterns.shape[1])


def backward_search_record(fm: DeviceFm, patterns, lengths):
    """Host arrays in and out: (tops, bots) numpy int32 [B, L+1] (the
    reference package's orientation)."""
    tops, bots = backward_search_record_body(
        fm, _put(fm, patterns, np.uint8), _put(fm, lengths, np.int32))
    return tops.T.cpu().numpy().copy(), bots.T.cpu().numpy().copy()


def lf_step_padded(fm: DeviceFm, c, top, bot):
    """Host arrays in and out: one LF step. (The reference package pads
    the batch to a power of two for its compile cache; eager torch needs
    no padding, and the lanes are independent.)"""
    t, b = lf_step(fm, *(_put(fm, a, np.int32) for a in (c, top, bot)))
    return t.cpu().numpy(), b.cpu().numpy()


# ---------------------------------------------------------------------------
# 1-mismatch search (ref: aligner_seed.cpp:973 oneMmSearch): one half of the
# read is matched exactly (the recorded pass), then every substitution
# branch is tried: the branch grid, one substitution step, a fixed-size
# compaction, and one continuation walk, all on the device.
# ---------------------------------------------------------------------------

def one_mm_phase0_body(fm: DeviceFm, pat, lens, hi, tops, bots,
                       w0: int, cw: int, k1: int):
    """Substitution step for branch positions [w0, w0+cw) of every pattern,
    compacted to at most k1 surviving branches.

    pat: [B, L] codes; lens/hi: [B]; tops/bots: [L+1, B] (a recorded
    pass). Returns (cb, cm, pos, top, bot) each [k1] and the survivor
    count before compaction."""
    B, L = pat.shape
    dev = pat.device
    i64 = torch.int64
    p = (w0 + torch.arange(cw, device=dev))[None, :].expand(B, cw)
    b = torch.arange(B, device=dev)[:, None].expand(B, cw)
    lens = lens.to(i64)
    valid = (p < hi.to(i64)[:, None]) & (p < lens[:, None])
    s = (lens[:, None] - 1 - p).clamp(0, L)
    t0 = tops[s, b]
    b0 = bots[s, b]
    valid &= widen(t0) < widen(b0)
    orig = pat[b, p.clamp(0, L - 1)].to(i64)
    # expand to the 4 substitution characters
    x = torch.arange(4, device=dev)[None, None, :].expand(B, cw, 4)
    ok = (valid[:, :, None] & (x != orig[:, :, None])).reshape(-1)
    xs = x.reshape(-1)
    cbs = b[:, :, None].expand(B, cw, 4).reshape(-1)
    ps = p[:, :, None].expand(B, cw, 4).reshape(-1)
    t0f = torch.where(ok, t0[:, :, None].expand(B, cw, 4).reshape(-1), 0)
    b0f = torch.where(ok, b0[:, :, None].expand(B, cw, 4).reshape(-1), 0)
    nt, nb = lf_step(fm, xs, t0f, b0f)
    alive = widen(nt) < widen(nb)
    count = alive.sum(dtype=torch.int32)
    n = xs.shape[0]
    idx = nonzero_fixed(alive, k1, n)
    safe = idx.clamp(0, n - 1)
    pad = idx >= n
    return (torch.where(pad, -1, cbs[safe]).to(torch.int32),
            torch.where(pad, -1, ps[safe]).to(torch.int32),
            torch.where(pad, -1, ps[safe] - 1).to(torch.int32),
            torch.where(pad, 0, nt[safe]), torch.where(pad, 0, nb[safe]),
            count)


def one_mm_phase1_body_torch(fm: DeviceFm, pat, cb, pos, top, bot,
                             n_steps: int):
    """Plain PyTorch version of `one_mm_phase1_body`."""
    R, L = pat.shape
    rows = cb.to(torch.int64).clamp(0, R - 1)
    pos = pos.to(torch.int32)
    for _ in range(n_steps):
        act = (pos >= 0) & (widen(top) < widen(bot))
        c = pat[rows, pos.to(torch.int64).clamp(0, L - 1)]
        nt, nb = lf_step_torch(fm, c, top, bot)
        top = torch.where(act, nt, top)
        bot = torch.where(act, nb, bot)
        pos = torch.where(act, pos - 1, pos)
    return pos, top, bot


def one_mm_phase1_body(fm: DeviceFm, pat, cb, pos, top, bot, n_steps: int):
    """Continue every branch backward to pattern position 0: lane j reads
    row cb[j] of pat from position pos[j] leftwards, for at most n_steps
    steps, frozen once its range is empty or its position negative.
    Returns int32 (pos, top, bot). On CUDA tensors this launches
    `fm_walk`."""
    dev = _check_device("one_mm_phase1", fm, pat, cb, pos, top, bot)
    if dev.type == "cpu":
        return one_mm_phase1_body_torch(fm, pat, cb, pos, top, bot, n_steps)
    t, b, p = _walk_cuda(fm, WALK_CONT, pat, pos, n_steps, row=cb, top=top,
                         bot=bot)
    return p, t, b


def _exact_from_record(tops, bots, lengths):
    """Full-pattern ranges from a recorded pass: entry s = lengths[b].
    Returns [2, B]."""
    s = lengths.to(torch.int64).clamp(0, tops.shape[0] - 1)
    b = torch.arange(tops.shape[1], device=tops.device)
    return torch.stack([tops[s, b], bots[s, b]])


def one_mm_branch_hits(fm: DeviceFm, patterns, lengths, branch_lo, branch_hi,
                       max_grid: int = 1 << 22, want_exact: bool = False):
    """Occurrences of each pattern with EXACTLY one substitution at a
    position p in [branch_lo[b], branch_hi[b]) — branch_lo must be 0 (both
    reference cases use 0).

    Returns numpy int64 arrays (read_idx, mm_pos, top, bot) of full 1mm
    matches; with want_exact also (exact_top, exact_bot) int32 [B], the
    full exact-match ranges (free by-products of the recorded pass)."""
    patterns = np.asarray(patterns)
    lengths = np.asarray(lengths, np.int32)
    B, L = patterns.shape
    hi = np.minimum(np.asarray(branch_hi, np.int32), lengths)
    maxw = int(hi.max(initial=0))
    empty = (np.zeros(0, np.int64),) * 4

    Bp = _pow2_pad(B)
    pat_p, len_p = _pad_rows(patterns.astype(np.uint8), lengths, Bp)
    hi_p = np.zeros(Bp, np.int32)
    hi_p[:B] = hi
    pat_dev, len_dev, hi_dev = (_put(fm, pat_p, np.uint8),
                                _put(fm, len_p, np.int32),
                                _put(fm, hi_p, np.int32))
    tops, bots = backward_search_record_body(fm, pat_dev, len_dev)

    exact = None
    if want_exact:
        ex = _exact_from_record(tops, bots, len_dev).cpu().numpy()
        et, eb = ex[0, :B].copy(), ex[1, :B].copy()
        bad = et >= eb
        et[bad] = 0
        eb[bad] = 0
        exact = (et, eb)

    if maxw == 0:
        return (empty, exact) if want_exact else empty

    cw = max(1, min(_pow2_pad(maxw, lo=8), max_grid // (Bp * 4)))
    k1 = _pow2_pad(2 * Bp, lo=4096)
    n_steps = _pow2_pad(maxw, lo=32)
    out = [[], [], [], []]
    w0 = 0
    while w0 < maxw:
        cb, cm, pos, top, bot, count = one_mm_phase0_body(
            fm, pat_dev, len_dev, hi_dev, tops, bots, w0, cw, k1)
        posf, topf, botf = one_mm_phase1_body(fm, pat_dev, cb, pos, top, bot,
                                              n_steps)
        arr = torch.stack([posf, topf, botf, cb, cm,
                           count.expand(k1)]).cpu().numpy()
        pos_h, top_h, bot_h, cb_h, cm_h = arr[0], arr[1], arr[2], arr[3], \
            arr[4]
        if int(arr[5, 0]) > k1:
            # compaction capacity exceeded (repetitive genome): narrow the
            # position window, then grow the capacity — never drop
            # survivors (ref: aligner_sw_driver.h:179 RowSampler's role)
            if cw > 1:
                cw = max(1, cw // 2)
            else:
                k1 *= 2
            continue
        good = (cb_h >= 0) & (cb_h < B) & (pos_h < 0) & (top_h < bot_h)
        for o, a in zip(out, (cb_h, cm_h, top_h, bot_h)):
            o.append(a[good].astype(np.int64))
        w0 += cw
    hits = tuple(np.concatenate(o) for o in out) if out[0] else empty
    return (hits, exact) if want_exact else hits
