"""Banded affine-gap DP in diagonal coordinates — the seed-extension
workhorse (ref: aligner_swsse_*.cpp fills a read x window rectangle; here a
band of width K around the anchor diagonal, O(L*K) cells instead of
O(L^2)). Port of bowtie2_server_tpu/ops/sw_banded.py.

Coordinates: band index k in [0, K), center c = K//2. Cell (i, k) is read
position i against joined position pos = (diag - c) + i + k, i.e. ref char
`band[i + k]` where `band` is the window slice of length len+K starting at
diag - c.

Moves in band coordinates:
  diagonal  (i-1, j-1) -> (i-1, k)     consume read+ref
  vertical  (i-1, j)   -> (i-1, k+1)   ref gap (read char inserted), F
  horizontal(i,   j-1) -> (i,   k-1)   read gap (ref char deleted),  E
E has a within-row chain along k (exact from H-without-E while gap-open >=
gap-extend, same argument as ops/sw.py).

Three implementations of one function:
  - `banded_tile_torch`: the plain PyTorch version (a row loop of tensor
    ops, E by a Kogge-Stone max-scan);
  - two CUDA kernels, launched by `banded_dp` for tensors on a CUDA device
    at every band width in KERNEL_BANDS (all that `band_for` gives for
    --dpad up to 255): the register kernel `ops/csrc/sw_banded.cu` (one
    thread per problem, DPX max-adds and byte-table scores, with a general
    kernel behind it for scores outside a byte) for K = 32, 64, 128, and
    the wide-band kernel `ops/csrc/sw_banded_wide.cu` (K/J lanes per
    problem, J = `wide_cells(local)` cells a lane) for K = 256, 512, 1024
    (`_launch` also runs it at K = 128, to time it beside the register
    kernel there);
  - the numpy oracle `banded_fill_numpy` (and `banded_traceback`, the host
    traceback of the main path's rare gapped winners).
`banded_dp` takes the plain version only for tensors on the CPU.

The traceback from a known end cell has two implementations:
`banded_traceback` (the numpy oracle: a refill of the band, then a Python
walk) and the CUDA kernel `ops/csrc/sw_banded_tb.cu` (one warp a problem:
the refill with a direction byte a cell, then one lane's walk), which
`banded_traceback_batch` launches for a batch of problems on a CUDA device
at K in TB_BANDS; elsewhere it runs the oracle per problem.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .sw import NEG_INF, SwConfig, check_tile

DEFAULT_BAND = 32
# band widths the CUDA kernels are built for: the register kernel up to
# REGISTER_BAND_MAX, the wide-band kernel above
KERNEL_BANDS = (32, 64, 128, 256, 512, 1024)
REGISTER_BAND_MAX = 128
# band widths of the traceback kernel (ops/csrc/sw_banded_tb.cu)
TB_BANDS = (32, 64, 128)


def wide_cells(local: bool) -> int:
    """Band cells a lane of the wide-band kernel owns: 64 end-to-end, 32
    in --local (bt2_sw_banded_wide's launch)."""
    return 32 if local else 64


def wide_loop(K: int, local: bool):
    """(symbol, rank) for `kernels.loop_mix`: the wide-band kernel's row
    loop over gap rows on the byte tables, the one nearly all its cells
    take. Its loops of mixed rows and of both score routes hold the same
    shuffles and more code, its loops outside the gap run one shuffle, so
    it is the smallest of the loops with the most shuffles."""
    J = wide_cells(local)
    return (f"banded_wide_kernelILi{J}ELi{K // J}ELb{int(local)}ELb1EE",
            lambda n, mix: (mix.get("SHFL", 0), -n))


def general_loop(K: int, local: bool):
    """(symbol, rank) for `kernels.loop_mix`: the general kernel's row
    loop over gap rows on its int16 tables (with the --local key), the
    largest of the loops with the most PRMTs (its loops outside the gap
    run read the same tables, its exact route none or fewer)."""
    return (f"banded_general_kernelILi{K}ELb{int(local)}ELb{int(local)}EE",
            lambda n, mix: (mix.get("PRMT", 0), n))


# ---------------------------------------------------------------- oracle ---

def banded_fill_numpy(rd, mmpen, band, cfg: SwConfig, K: int = DEFAULT_BAND):
    """Host fill (vectorized over k per row). band: [len(rd)+K] ref codes.
    Returns H, E, F arrays of shape [lq, K] (no boundary rows; row -1
    handled implicitly: H[-1][*] = 0)."""
    lq = len(rd)
    H = np.full((lq, K), NEG_INF, np.int64)
    E = np.full((lq, K), NEG_INF, np.int64)
    F = np.full((lq, K), NEG_INF, np.int64)
    ks = np.arange(K)
    for i in range(lq):
        rfc = band[i : i + K].astype(np.int64)
        rdc = int(rd[i])
        if rdc > 3:
            s = np.full(K, -cfg.npen, np.int64)
        else:
            s = np.where(rfc > 3, -cfg.npen,
                         np.where(rfc == rdc, cfg.ma, -int(mmpen[i])))
        gap_ok = (i >= cfg.gapbar) and (i < lq - cfg.gapbar)
        h_up = H[i - 1] if i > 0 else np.zeros(K, np.int64)
        f_up = F[i - 1] if i > 0 else np.full(K, NEG_INF, np.int64)
        diag = h_up + s
        # F from (i-1, k+1)
        f = np.full(K, NEG_INF, np.int64)
        f[:-1] = np.maximum(f_up[1:] - cfg.rfg_ext, h_up[1:] - cfg.rfg_open)
        if not gap_ok:
            f[:] = NEG_INF
        base = np.maximum(diag, f)
        # E scan along k from base
        e = np.full(K, NEG_INF, np.int64)
        e[1:] = base[:-1] - cfg.rdg_open
        d = 1
        while d < K:
            e[d:] = np.maximum(e[d:], e[:-d] - d * cfg.rdg_ext)
            d *= 2
        if not gap_ok:
            e[:] = NEG_INF
        h = np.maximum(base, e)
        if cfg.local:
            h = np.maximum(h, 0)
        H[i], E[i], F[i] = h, e, f
    return H, E, F


def banded_best_numpy(rd, mmpen, band, cfg, K=DEFAULT_BAND):
    H, _, _ = banded_fill_numpy(rd, mmpen, band, cfg, K)
    lq = len(rd)
    if cfg.local:
        # ties: prefer the LAST maximal cell (longer alignment), matching
        # the reference's observed choice
        m = int(H.max())
        rows, ks = np.nonzero(H == m)
        return m, int(rows[-1]), int(ks[-1])
    row = H[lq - 1]
    m = int(row.max())
    k = int(np.nonzero(row == m)[0][-1])   # ties: larger k, see engines
    return m, lq - 1, k


def banded_traceback(rd, mmpen, band, cfg, end_i, end_k, K=DEFAULT_BAND):
    """Backtrace in band coordinates. Returns (edits, start_band_pos,
    read_start): start_band_pos = index into `band` of the first aligned ref
    base. Edit convention matches align/edits.py."""
    H, E, F = banded_fill_numpy(rd, mmpen, band, cfg, K)
    edits = []
    i, k = end_i, end_k
    state = "H"
    while True:
        if state == "H":
            rdc, rfc = int(rd[i]), int(band[i + k])
            if rdc > 3 or rfc > 3:
                s = -cfg.npen
            elif rdc == rfc:
                s = cfg.ma
            else:
                s = -int(mmpen[i])
            h_up = H[i - 1, k] if i > 0 else 0
            # Local zero cells: continue only through a GAP predecessor
            # (see edits.py rect traceback note — golden-verified both
            # ways), otherwise clip here.
            if cfg.local and H[i, k] == 0:
                if H[i, k] == E[i, k]:
                    state = "E"
                    continue
                if H[i, k] == F[i, k]:
                    state = "F"
                    continue
                # zero-restart cell: the local alignment starts at i+1
                i += 1
                break
            if H[i, k] == h_up + s:
                if rdc != rfc or rdc > 3 or rfc > 3:
                    edits.append(("M", i, rfc, rdc))
                i -= 1
                if i < 0:
                    i = 0
                    break
            elif H[i, k] == E[i, k]:
                state = "E"
            elif H[i, k] == F[i, k]:
                state = "F"
            else:
                raise AssertionError(f"banded backtrace stuck at ({i},{k})")
        elif state == "E":  # read gap: ref char at band[i+k] deleted
            # keyed at i+1: the gap's ref chars precede read char i+1
            edits.append(("D", i + 1, int(band[i + k])))
            prev_ext = k >= 1 and E[i, k] == E[i, k - 1] - cfg.rdg_ext
            k -= 1
            if not prev_ext:
                state = "H"
        else:  # state == "F": read char i inserted
            edits.append(("I", i, int(rd[i])))
            prev_ext = (i >= 1 and k + 1 < K
                        and F[i, k] == F[i - 1, k + 1] - cfg.rfg_ext)
            i -= 1
            k += 1
            if i < 0:
                i = 0
                break
            if not prev_ext:
                state = "H"
    edits.reverse()
    # after the loop: (i, k) is the first aligned cell
    return edits, i + k, i


# ------------------------------------------------------ plain torch version -

def _banded_update(cfg: SwConfig, K: int, h_up, f_up, s, gap_row):
    """One row update on [K, P] tiles. gap_row: [1, P] bool (row within the
    gap barrier limits)."""
    neg = NEG_INF
    p = h_up.shape[1]
    dev = h_up.device
    negrow = torch.full((1, p), neg, dtype=torch.int32, device=dev)
    diag = h_up + s
    f = torch.cat([torch.maximum(f_up[1:] - cfg.rfg_ext,
                                 h_up[1:] - cfg.rfg_open), negrow])
    f = torch.where(gap_row, f, neg)
    base = torch.maximum(diag, f)
    e = torch.cat([negrow, base[:-1] - cfg.rdg_open])
    d = 1
    while d < K:
        e = torch.maximum(e, torch.cat([
            torch.full((d, p), neg, dtype=torch.int32, device=dev),
            e[:-d] - d * cfg.rdg_ext]))
        d *= 2
    e = torch.where(gap_row, e, neg)
    h = torch.maximum(base, e)
    if cfg.local:
        h = h.clamp_min(0)
    return h, f


def banded_tile_torch(cfg: SwConfig, K: int, rd, mmpen, lens, band):
    """Plain PyTorch version of the banded DP. rd/mmpen: [Lq, P] int32;
    lens: [P] int32; band: [Lq+K, P] int32 -> (best, bi, bk) [P] int32."""
    lq, p = rd.shape
    dev = rd.device
    ks = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    h = torch.zeros((K, p), dtype=torch.int32, device=dev)  # H[-1] = 0
    f = torch.full((K, p), NEG_INF, dtype=torch.int32, device=dev)
    best = torch.full((p,), NEG_INF, dtype=torch.int32, device=dev)
    bi = torch.full((p,), -1, dtype=torch.int32, device=dev)
    bk = torch.full((p,), -1, dtype=torch.int32, device=dev)
    for i in range(lq):
        rfc = band[i : i + K]
        rdc = rd[i][None, :]
        is_n = (rdc > 3) | (rfc > 3)
        s = torch.where(is_n, -cfg.npen,
                        torch.where(rfc == rdc, cfg.ma, -mmpen[i][None, :]))
        gap_row = ((lens - cfg.gapbar > i) & (i >= cfg.gapbar))[None, :]
        h, f = _banded_update(cfg, K, h, f, s, gap_row)
        if cfg.local:
            scored = torch.where((lens > i)[None, :], h, NEG_INF)
        else:
            scored = torch.where((lens - 1 == i)[None, :], h, NEG_INF)
        col_best = scored.max(dim=0).values
        # ties: larger k (rightmost end column) in both modes
        col_arg = torch.where(scored == col_best[None, :], ks,
                              -1).max(dim=0).values
        ok = (col_best >= best) if cfg.local else (col_best > best)
        best = torch.where(ok, col_best, best)
        bi = torch.where(ok, i, bi)
        bk = torch.where(ok, col_arg, bk)
    return best, bi, bk


# ----------------------------------------------------------------- wrapper -

def banded_dp(cfg: SwConfig, K: int, rd, mmpen, lens, band):
    """Banded DP on [rows, P] tiles (the layout of the reference's
    `_banded_kernel`). On CUDA tensors this launches CUDA kernels:
    ops/csrc/sw_banded.cu for K <= REGISTER_BAND_MAX (its two kernels,
    counted as `sw_banded` and `sw_banded_general`),
    ops/csrc/sw_banded_wide.cu above (`sw_banded_wide`); on
    CPU tensors it runs `banded_tile_torch`. Returns (best, bi, bk) int32
    [P]."""
    lq, p = rd.shape
    dev = check_tile("banded_dp", dict(rd=rd, mmpen=mmpen, lens=lens,
                                        band=band),
                      dict(rd=(lq, p), mmpen=(lq, p), lens=(p,),
                           band=(lq + K, p)))
    if dev.type == "cpu":
        return banded_tile_torch(cfg, K, rd, mmpen, lens, band)
    if dev.type != "cuda":
        raise ValueError(f"banded_dp: unsupported device {dev}")
    if K not in KERNEL_BANDS:
        raise ValueError(
            f"banded_dp: band width {K} not in {KERNEL_BANDS}: the CUDA "
            f"kernels take bands up to {KERNEL_BANDS[-1]} (--dpad up to "
            f"255)")
    name = "sw_banded" if K <= REGISTER_BAND_MAX else "sw_banded_wide"
    return _launch(name, cfg, K, rd, mmpen, lens, band)


def _launch(name: str, cfg: SwConfig, K: int, rd, mmpen, lens, band):
    """Launch the CUDA kernel `name` ("sw_banded" or "sw_banded_wide") on
    tiles that banded_dp has checked, and count the launches. The wide-band
    kernel is also built for K = 128, where banded_dp routes to the
    register kernel, so that the two can be timed side by side there."""
    lq, p = rd.shape
    dev = rd.device
    best = torch.empty(p, dtype=torch.int32, device=dev)
    bi = torch.empty_like(best)
    bk = torch.empty_like(best)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(kernels.lib(), "bt2_" + name)(
        rd.data_ptr(), mmpen.data_ptr(), lens.data_ptr(), band.data_ptr(),
        best.data_ptr(), bi.data_ptr(), bk.data_ptr(), lq, p, K,
        *kernels.cfg_args(cfg), int(cfg.local), stream)
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    if name == "sw_banded":   # and the general kernel behind it
        kernels.LAUNCHES["sw_banded_general"] += 1
    return best, bi, bk


def sw_banded_batch(rd, lens, mmpen, band, cfg: SwConfig,
                    K: int = DEFAULT_BAND, *, device):
    """Batched banded alignment (host arrays in and out).

    rd:    [B, Lq] uint8 (pad 5); lens: [B]; mmpen: [B, Lq] int32
    band:  [B, Lq+K] uint8 ref codes (pad 4)
    device: where the DP runs ('cpu' = plain torch, 'cuda' = the kernel)
    -> (best, bi, bk): [B] int32 numpy; joined end pos = band_start + bi + bk.
    """
    B, lq = rd.shape
    if band.shape[1] != lq + K:
        raise ValueError(f"band width {band.shape[1]} != Lq + K = {lq + K}")

    def put(a):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a, np.int32).T)).to(device)

    best, bi, bk = banded_dp(
        cfg, K, put(rd), put(mmpen),
        torch.from_numpy(np.asarray(lens, np.int32).copy()).to(device),
        put(band))
    return best.cpu().numpy(), bi.cpu().numpy(), bk.cpu().numpy()


def _tb_scoring_fits(cfg: SwConfig, mm, lq: int) -> bool:
    """Whether the traceback kernel's int32 fill is exact for this scoring
    (its E sentinel, sw_banded_tb.cu step 3): bonus, penalties and the
    mismatch penalties in [0, 2^15), rows at most 8192."""
    vals = (cfg.ma, cfg.npen, cfg.rdg_open, cfg.rdg_ext, cfg.rfg_open,
            cfg.rfg_ext)
    return (lq <= 8192 and all(0 <= int(v) < 1 << 15 for v in vals)
            and (mm.size == 0 or (int(mm.min()) >= 0
                                  and int(mm.max()) < 1 << 15)))


_TB_KIND = ("M", "D", "I")


def banded_traceback_batch(rd, mm, band, lens, end_i, end_k, cfg: SwConfig,
                           K: int = DEFAULT_BAND, *, device):
    """`banded_traceback` of P problems at once (host arrays in and out).

    rd:    [P, Lq] read codes; mm: [P, Lq] mismatch penalties
    band:  [P, Lq+K] ref codes (row t: the window of problem t, its first
           lens[t] + K codes used)
    lens, end_i, end_k: [P] read lengths and DP end cells (band coords)
    device: where the tracebacks run. On a CUDA device at K in TB_BANDS
    one launch of the kernel `ops/csrc/sw_banded_tb.cu` (counted as
    `sw_banded_tb`) on the current stream; a problem it flags (no
    predecessor, the edit slots full, an end cell outside the problem)
    and every problem elsewhere (the CPU, a wider band, a scoring outside
    `_tb_scoring_fits`) run the oracle.
    -> (list of (edits, start_band_pos, read_start), the oracle's format;
    [P] bool numpy, True where the kernel's answer was taken).
    """
    P = len(lens)
    lens = np.asarray(lens, np.int64)
    on_card = np.zeros(P, bool)

    def oracle(t):
        rl = int(lens[t])
        return banded_traceback(rd[t, :rl], mm[t, :rl], band[t, : rl + K],
                                cfg, int(end_i[t]), int(end_k[t]), K=K)

    dev = torch.device(device)
    lq = rd.shape[1] if P else 0
    if (P == 0 or dev.type != "cuda" or K not in TB_BANDS
            or not _tb_scoring_fits(cfg, mm, lq)):
        return [oracle(t) for t in range(P)], on_card
    if band.shape[1] != lq + K:
        raise ValueError(f"band width {band.shape[1]} != Lq + K = {lq + K}")

    def put(a):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a, np.int32).T)).to(dev)

    def put1(a):
        return torch.from_numpy(np.asarray(a, np.int32).copy()).to(dev)

    cap = 2 * lq + K    # a walk makes at most rl + K - 1 + (insertions) edits
    dirs = torch.empty((P, lq, K), dtype=torch.uint8, device=dev)
    edits = torch.empty((P, cap, 4), dtype=torch.int32, device=dev)
    meta = torch.empty((P, 4), dtype=torch.int32, device=dev)
    args = (put(rd), put(mm), put1(lens), put(band), put1(end_i),
            put1(end_k))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = kernels.lib().bt2_sw_banded_tb(
        *(a.data_ptr() for a in args), dirs.data_ptr(), edits.data_ptr(),
        meta.data_ptr(), lq, P, K, cap, *kernels.cfg_args(cfg),
        int(cfg.local), stream)
    kernels.check(rc, "sw_banded_tb")
    kernels.LAUNCHES["sw_banded_tb"] += 1
    m = meta.cpu().numpy()
    n_max = int(m[:, 0].max())
    ed = edits[:, :n_max].cpu().numpy() if n_max else None
    out = []
    for t in range(P):
        n, start, read_start, status = m[t].tolist()
        if status:
            out.append(oracle(t))
            continue
        on_card[t] = True
        walk = ed[t, n - 1 :: -1].tolist() if n else []
        out.append(([(_TB_KIND[ty], pos, a, b) if ty == 0
                     else (_TB_KIND[ty], pos, a)
                     for ty, pos, a, b in walk], start, read_start))
    return out, on_card
