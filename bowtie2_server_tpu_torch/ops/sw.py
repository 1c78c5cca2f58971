"""Batched affine-gap Smith-Waterman over full rectangles (ref:
aligner_swsse_ee_u8.cpp:775 alignNucleotidesEnd2EndSseU8 and the other SSE
kernel variants, aligner_sw.cpp:500 SwAligner::align). Port of
bowtie2_server_tpu/ops/sw.py.

Problems are laid out [Lq, P] (query row x problem), and the DP walks the
reference columns left to right. Within a column the vertical (ref-gap)
dependency F[i] = max(F[i-1]-e, H[i-1]-o) is exact from H-without-F of the
same column, because re-opening a vertical gap from a cell reached by a
vertical gap is never better than extending it.

Scoring semantics mirror the reference (ref: scoring.h):
  cell score  = +MA on match, -mmpen[i] on mismatch, -NP if either char is N
  read gap    (ref consumed, horizontal E) open/extend
  ref gap     (read consumed, vertical F)  open/extend
  gap barrier: no gap moves in the first/last `gapbar` read rows
  end-to-end:  alignment consumes the whole read; best over row len-1
  local:       H clamped at 0; best over all cells; +MA bonus per match

Three implementations of one function:
  - `sw_tile_torch`: the plain PyTorch version (column loop of tensor ops);
  - the CUDA kernel `ops/csrc/sw.cu` (one warp per problem, the read rows
    spread over its lanes and walked as a wavefront), launched by `sw_tile`
    for tensors on a CUDA device;
  - the numpy oracles `sw_score_numpy` / `sw_align_numpy_batch`.
`sw_tile` takes the plain version only for tensors on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import kernels

NEG_INF = -(10 ** 8)
LANES = 128  # problems per tile of the reference's TPU kernel


@dataclass(frozen=True)
class SwConfig:
    ma: int = 0            # match bonus
    npen: int = 1          # N penalty
    rdg_open: int = 8      # read-gap first base (const+linear)
    rdg_ext: int = 3
    rfg_open: int = 8      # ref-gap first base
    rfg_ext: int = 3
    gapbar: int = 4
    local: bool = False


# ---------------------------------------------------------------- oracle ---

def sw_score_numpy(rd, mmpen, ref, cfg: SwConfig):
    """Scalar textbook-DP oracle. rd: [lq] codes, mmpen: [lq], ref: [lc]
    codes. Returns (best, best_i, best_j); ties prefer the leftmost end
    column, then the topmost row — matching the batched engines."""
    lq, lc = len(rd), len(ref)
    H = np.full((lq + 1, lc + 1), NEG_INF, dtype=np.int64)
    E = np.full((lq + 1, lc + 1), NEG_INF, dtype=np.int64)  # read gap (horiz)
    F = np.full((lq + 1, lc + 1), NEG_INF, dtype=np.int64)  # ref gap (vert)
    H[0, :] = 0  # alignment may start before any column (row -1)
    if cfg.local:
        H[:, 0] = 0  # local alignments may also start at any row at col 0
    best, bi, bj = NEG_INF, -1, -1
    for j in range(1, lc + 1):
        for i in range(1, lq + 1):
            rdc, rfc = rd[i - 1], ref[j - 1]
            if rdc > 3 or rfc > 3:
                s = -cfg.npen
            elif rdc == rfc:
                s = cfg.ma
            else:
                s = -int(mmpen[i - 1])
            gap_ok = (i - 1 >= cfg.gapbar) and (i - 1 < lq - cfg.gapbar)
            if gap_ok:
                E[i, j] = max(E[i, j - 1] - cfg.rdg_ext,
                              H[i, j - 1] - cfg.rdg_open)
                F[i, j] = max(F[i - 1, j] - cfg.rfg_ext,
                              H[i - 1, j] - cfg.rfg_open)
            h = max(H[i - 1, j - 1] + s, E[i, j], F[i, j])
            if cfg.local:
                h = max(h, 0)
            H[i, j] = h
        if cfg.local:
            for i in range(1, lq + 1):
                if H[i, j] >= best:  # ties: prefer later column & larger row
                    best, bi, bj = H[i, j], i - 1, j - 1
        else:
            if H[lq, j] > best:
                best, bi, bj = H[lq, j], lq - 1, j - 1
    return int(best), bi, bj


def sw_align_numpy_batch(rd, lens, mmpen, ref, reflens, cfg: SwConfig):
    """Vectorized host column-scan — same semantics (including tie rules)
    as the device engines. Used for SMALL job counts on the fused path's
    host side: a device call there would queue behind the in-flight fused
    batches (~2 batch periods of latency), so a few-problem rectangle DP
    is cheaper on the host even at numpy speed.

    rd: [B, Lq] codes (pad 5); lens: [B]; mmpen: [B, Lq] int;
    ref: [B, Lc] codes (pad 4); reflens: [B].
    Returns (best, best_i, best_j) int64 arrays, NEG_INF when no cell.
    """
    B, lq = rd.shape
    lc = ref.shape[1]
    neg = np.int64(NEG_INF)
    rd_t = np.asarray(rd, np.int64).T                    # [Lq, B]
    mm_t = np.asarray(mmpen, np.int64).T
    lens_a = np.asarray(lens, np.int64)
    reflens_a = np.asarray(reflens, np.int64)
    rows = np.arange(lq, dtype=np.int64)[:, None]
    gap_ok = (rows >= cfg.gapbar) & (rows < lens_a[None, :] - cfg.gapbar)
    last_mask = (rows < lens_a[None, :]) if cfg.local else \
        (rows == lens_a[None, :] - 1)
    h = np.zeros((lq, B), np.int64) if cfg.local else \
        np.full((lq, B), neg, np.int64)
    e = np.full((lq, B), neg, np.int64)
    best = np.full(B, neg, np.int64)
    bi = np.full(B, -1, np.int64)
    bj = np.full(B, -1, np.int64)
    is_n_rd = rd_t > 3
    for j in range(lc):
        rcol = np.asarray(ref[:, j], np.int64)[None, :]
        is_n = is_n_rd | (rcol > 3)
        s = np.where(is_n, -cfg.npen,
                     np.where(rd_t == rcol, cfg.ma, -mm_t))
        e = np.maximum(e - cfg.rdg_ext, h - cfg.rdg_open)
        e[~gap_ok] = neg
        h_up = np.concatenate([np.zeros((1, B), np.int64), h[:-1]], axis=0)
        hnf = np.maximum(h_up + s, e)
        hnf_src = np.where(rows >= (cfg.gapbar - 1), hnf, neg)
        f = np.concatenate([np.full((1, B), neg, np.int64),
                            hnf_src[:-1] - cfg.rfg_open], axis=0)
        d = 1
        while d < lq:
            f[d:] = np.maximum(f[d:], f[:-d] - d * cfg.rfg_ext)
            d *= 2
        f[~gap_ok] = neg
        h = np.maximum(hnf, f)
        if cfg.local:
            np.maximum(h, 0, out=h)
        scored = np.where(last_mask, h, neg)
        col_best = scored.max(axis=0)
        if cfg.local:   # ties: larger row
            col_arg = np.where(scored == col_best[None, :],
                               rows, -1).max(axis=0)
            ok = (j < reflens_a) & (col_best >= best)
        else:           # ties: smallest row
            col_arg = np.where(scored == col_best[None, :],
                               rows, np.int64(1 << 30)).min(axis=0)
            ok = (j < reflens_a) & (col_best > best)
        best = np.where(ok, col_best, best)
        bi = np.where(ok, col_arg, bi)
        bj = np.where(ok, j, bj)
    return best, bi, bj


# ------------------------------------------------------ plain torch version -

def _column_update(cfg: SwConfig, lq_pad: int, rd, mmpen, gap_ok, last_mask,
                   h_prev, e_prev, rcol):
    """One DP column for a [Lq, P] tile (torch port of the reference's
    `_column_update`).

    rd, mmpen, gap_ok, last_mask: [Lq, P] static per problem
    h_prev, e_prev: [Lq, P] carries (H and E of the previous column)
    rcol: [1, P] ref codes of this column
    returns (h, e, col_best, col_arg): new carries + per-problem best-in-column
    """
    neg = NEG_INF
    p = h_prev.shape[1]
    dev = h_prev.device
    is_n = (rd > 3) | (rcol > 3)
    s = torch.where(is_n, -cfg.npen, torch.where(rd == rcol, cfg.ma, -mmpen))

    # E: read gap (horizontal)
    e = torch.maximum(e_prev - cfg.rdg_ext, h_prev - cfg.rdg_open)
    e = torch.where(gap_ok, e, neg)

    # diagonal: H_prev shifted down one row; row 0 sees H[-1] = 0
    h_up = torch.cat([torch.zeros((1, p), dtype=torch.int32, device=dev),
                      h_prev[:-1]])
    hnf = torch.maximum(h_up + s, e)

    # F: ref gap (vertical) via a Kogge-Stone max-scan over rows. Scan
    # sources are restricted to rows >= gapbar-1 so a gap cannot jump the
    # barred prefix (targets are masked by gap_ok below).
    rows = torch.arange(lq_pad, dtype=torch.int32, device=dev)[:, None]
    hnf_src = torch.where(rows >= cfg.gapbar - 1, hnf, neg)
    f = torch.cat([torch.full((1, p), neg, dtype=torch.int32, device=dev),
                   hnf_src[:-1] - cfg.rfg_open])
    d = 1
    while d < lq_pad:
        f = torch.maximum(f, torch.cat([
            torch.full((d, p), neg, dtype=torch.int32, device=dev),
            f[:-d] - d * cfg.rfg_ext]))
        d *= 2
    f = torch.where(gap_ok, f, neg)

    h = torch.maximum(hnf, f)
    if cfg.local:
        h = h.clamp_min(0)
    scored = torch.where(last_mask, h, neg)
    col_best = scored.max(dim=0).values
    hit = scored == col_best[None, :]
    if cfg.local:  # ties: larger row = longer alignment
        col_arg = torch.where(hit, rows, -1).max(dim=0).values
    else:          # ties: smallest row
        col_arg = torch.where(hit, rows, 1 << 30).min(dim=0).values
    return h, e, col_best, col_arg


def _make_masks(cfg: SwConfig, lens, lq_pad: int):
    """[Lq, P] masks from per-problem read lengths [P]."""
    rows = torch.arange(lq_pad, dtype=torch.int32, device=lens.device)[:, None]
    lens_b = lens[None, :]
    gap_ok = (rows >= cfg.gapbar) & (rows < lens_b - cfg.gapbar)
    last_mask = (rows < lens_b) if cfg.local else (rows == lens_b - 1)
    return gap_ok, last_mask


def sw_tile_torch(cfg: SwConfig, rd, mmpen, lens, ref, reflens):
    """Plain PyTorch version of the rectangle DP. rd/mmpen: [Lq, P] int32,
    lens/reflens: [P] int32, ref: [Lc, P] int32 -> (best, bi, bj) [P]."""
    lq_pad, p = rd.shape
    dev = rd.device
    gap_ok, last_mask = _make_masks(cfg, lens, lq_pad)
    h = torch.full((lq_pad, p), 0 if cfg.local else NEG_INF,
                   dtype=torch.int32, device=dev)
    e = torch.full((lq_pad, p), NEG_INF, dtype=torch.int32, device=dev)
    best = torch.full((p,), NEG_INF, dtype=torch.int32, device=dev)
    bi = torch.full((p,), -1, dtype=torch.int32, device=dev)
    bj = torch.full((p,), -1, dtype=torch.int32, device=dev)
    for j in range(ref.shape[0]):
        h, e, col_best, col_arg = _column_update(
            cfg, lq_pad, rd, mmpen, gap_ok, last_mask, h, e, ref[j][None, :])
        better = (col_best >= best) if cfg.local else (col_best > best)
        ok = (reflens > j) & better
        best = torch.where(ok, col_best, best)
        bi = torch.where(ok, col_arg, bi)
        bj = torch.where(ok, j, bj)
    return best, bi, bj


# ----------------------------------------------------------------- wrapper -

def check_tile(name: str, tensors: dict, shapes: dict) -> torch.device:
    dev = None
    for k, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {k} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {k} must be int32, got {t.dtype}")
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, "
                             f"expected {shapes[k]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {k} is on {t.device}, not {dev}")
    return dev


def sw_tile(cfg: SwConfig, rd, mmpen, lens, ref, reflens):
    """Rectangle DP on [Lq_pad, P] tiles (the layout of the reference's
    `_sw_kernel`). On CUDA tensors this launches the CUDA kernel
    (ops/csrc/sw.cu); on CPU tensors it runs `sw_tile_torch`.
    Returns (best, bi, bj) int32 [P]."""
    lq_pad, p = rd.shape
    lc = ref.shape[0]
    dev = check_tile("sw_tile", dict(rd=rd, mmpen=mmpen, lens=lens, ref=ref,
                                      reflens=reflens),
                      dict(rd=(lq_pad, p), mmpen=(lq_pad, p), lens=(p,),
                           ref=(lc, p), reflens=(p,)))
    if dev.type == "cpu":
        return sw_tile_torch(cfg, rd, mmpen, lens, ref, reflens)
    if dev.type != "cuda":
        raise ValueError(f"sw_tile: unsupported device {dev}")
    if not 1 <= lq_pad <= 1024:
        raise ValueError(f"sw_tile: Lq_pad {lq_pad} outside 1..1024")
    best = torch.empty(p, dtype=torch.int32, device=dev)
    bi = torch.empty_like(best)
    bj = torch.empty_like(best)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = kernels.lib().bt2_sw(
        rd.data_ptr(), mmpen.data_ptr(), lens.data_ptr(), ref.data_ptr(),
        reflens.data_ptr(), best.data_ptr(), bi.data_ptr(), bj.data_ptr(),
        lq_pad, lc, p, *kernels.cfg_args(cfg), int(cfg.local), stream)
    kernels.check(rc, "sw")
    kernels.LAUNCHES["sw"] += 1
    return best, bi, bj


def sw_align_batch(rd, lens, mmpen, ref, reflens, cfg: SwConfig, *,
                   device):
    """Batched best-score alignment (host arrays in and out).

    rd:      [B, Lq] uint8 read codes (pad with 5)
    lens:    [B] int32 read lengths
    mmpen:   [B, Lq] int32 per-position mismatch penalties
    ref:     [B, Lc] uint8 ref window codes (pad with 4)
    reflens: [B] int32 valid window lengths
    device:  where the DP runs ('cpu' = plain torch, 'cuda' = the kernel)
    -> (best, best_i, best_j): [B] int32 numpy; best_i/j are 0-based
       read/window coordinates of the alignment end cell; best=NEG_INF if
       none.
    """
    B, lq = rd.shape
    lq_pad = max(8, -(-lq // 8) * 8)
    rd_t = np.full((lq_pad, B), 5, np.int32)
    rd_t[:lq] = np.asarray(rd, np.int32).T
    mm_t = np.zeros((lq_pad, B), np.int32)
    mm_t[:lq] = np.asarray(mmpen, np.int32).T
    ref_t = np.ascontiguousarray(np.asarray(ref, np.int32).T)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    best, bi, bj = sw_tile(cfg, put(rd_t), put(mm_t), put(lens), put(ref_t),
                           put(reflens))
    return best.cpu().numpy(), bi.cpu().numpy(), bj.cpu().numpy()
