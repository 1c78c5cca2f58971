"""Alignment edit extraction: vectorized DP re-fill + backtrace for the few
gapped winners, ungapped fast path for the rest (ref: aligner_bt.h:544
BtBranchTracer; the reference re-fills checkpointed squares — we re-fill the
winner's whole (small) rectangle on the host, vectorized per column).

Edit list convention (read-orientation == reference orientation here, i.e.
the pipeline passes the aligned-strand read):
  ('M', read_pos, ref_char, read_char)   mismatch (chars differ or N)
  ('I', read_pos, read_char)             insertion in read (ref gap)
  ('D', read_pos, ref_char)              deletion from read (read gap);
                                         read_pos = read position AFTER which
                                         the ref char was skipped
"""
from __future__ import annotations

import numpy as np

from ..ops.sw import NEG_INF, SwConfig


def ungapped_score(rd, mmpen, window, start_col, cfg: SwConfig):
    """Score of the pure-diagonal alignment of rd at window[start_col:]."""
    lq = len(rd)
    ref = window[start_col : start_col + lq]
    if len(ref) < lq:
        return NEG_INF
    is_n = (rd > 3) | (ref > 3)
    match = (rd == ref) & ~is_n
    s = np.where(is_n, -cfg.npen, np.where(match, cfg.ma, -mmpen))
    return int(s.sum())


def edits_from_ungapped(rd, window, start_col):
    lq = len(rd)
    ref = window[start_col : start_col + lq]
    edits = []
    for i in np.nonzero((rd != ref) | (rd > 3) | (ref > 3))[0]:
        edits.append(("M", int(i), int(ref[i]), int(rd[i])))
    return edits


def _fill_matrices(rd, mmpen, window, cfg: SwConfig):
    """Column-vectorized textbook fill; returns H, E, F of shape
    [lq+1, lc+1] (row/col 0 = boundary)."""
    lq, lc = len(rd), len(window)
    H = np.full((lq + 1, lc + 1), NEG_INF, np.int64)
    E = np.full((lq + 1, lc + 1), NEG_INF, np.int64)
    F = np.full((lq + 1, lc + 1), NEG_INF, np.int64)
    H[0, :] = 0
    if cfg.local:
        H[:, 0] = 0  # local alignments may start at any row at column 0
    rows = np.arange(lq)
    gap_ok = (rows >= cfg.gapbar) & (rows < lq - cfg.gapbar)
    rd_i = rd.astype(np.int64)
    mm = mmpen.astype(np.int64)
    for j in range(1, lc + 1):
        rfc = int(window[j - 1])
        if rfc > 3:
            s = np.full(lq, -cfg.npen, np.int64)
        else:
            s = np.where(rd_i > 3, -cfg.npen,
                         np.where(rd_i == rfc, cfg.ma, -mm))
        e = np.maximum(E[1:, j - 1] - cfg.rdg_ext, H[1:, j - 1] - cfg.rdg_open)
        e = np.where(gap_ok, e, NEG_INF)
        diag = H[:-1, j - 1] + s
        hnf = np.maximum(diag, e)
        # F: sequential in i -> prefix-scan trick (exact, open>=ext)
        src = np.where(rows >= cfg.gapbar - 1, hnf, NEG_INF)
        f = np.full(lq, NEG_INF, np.int64)
        f[1:] = src[:-1] - cfg.rfg_open
        d = 1
        while d < lq:
            f[d:] = np.maximum(f[d:], f[:-d] - d * cfg.rfg_ext)
            d *= 2
        f = np.where(gap_ok, f, NEG_INF)
        h = np.maximum(hnf, f)
        if cfg.local:
            h = np.maximum(h, 0)
        E[1:, j] = e
        F[1:, j] = f
        H[1:, j] = h
    return H, E, F


def traceback(rd, mmpen, window, cfg: SwConfig, end_i, end_j):
    """Backtrace from end cell (0-based read row end_i, window col end_j).
    Returns (edits, start_col, read_start) where start_col is the window
    column of the first aligned ref base and read_start the first aligned
    read position (0 for end-to-end; >0 possible in local mode)."""
    H, E, F = _fill_matrices(rd, mmpen, window, cfg)
    edits = []
    i, j = end_i + 1, end_j + 1  # 1-based matrix coords
    state = "H"
    while i > 0:
        if state == "H":
            rdc = int(rd[i - 1])
            rfc = int(window[j - 1]) if j >= 1 else 4
            if rdc > 3 or rfc > 3:
                s = -cfg.npen
            elif rdc == rfc:
                s = cfg.ma
            else:
                s = -int(mmpen[i - 1])
            # Local zero cells: continue only through a GAP predecessor
            # (zero-score prefix ending in a gap — the reference reports
            # 4M1D87M over 4S87M), otherwise clip (it reports 3S66M over
            # a 69M with a zero-sum mismatch prefix). Both classes
            # verified against the lambda paired-local golden.
            if cfg.local and H[i, j] == 0:
                if H[i, j] == E[i, j]:
                    state = "E"
                    continue
                if H[i, j] == F[i, j]:
                    state = "F"
                    continue
                break  # local alignment start (zero-restart clip)
            if j >= 1 and H[i, j] == H[i - 1, j - 1] + s:
                if rdc != rfc or rdc > 3 or rfc > 3:
                    edits.append(("M", i - 1, rfc, rdc))
                i -= 1
                j -= 1
            elif H[i, j] == E[i, j]:
                state = "E"
            elif H[i, j] == F[i, j]:
                state = "F"
            else:
                raise AssertionError(
                    f"backtrace stuck at ({i},{j}): H={H[i,j]}")
        elif state == "E":  # read gap: ref char at col j consumed without read
            # keyed at read index i (0-based next read char after the gap)
            edits.append(("D", i, int(window[j - 1])))
            if E[i, j] == E[i, j - 1] - cfg.rdg_ext:
                j -= 1
            else:  # opened here
                j -= 1
                state = "H"
        else:  # state == "F": ref gap: consumed read char without ref
            edits.append(("I", i - 1, int(rd[i - 1])))
            if F[i, j] == F[i - 1, j] - cfg.rfg_ext:
                i -= 1
            else:
                i -= 1
                state = "H"
    edits.reverse()
    return edits, j, i  # j = start col (0-based first aligned ref base), i = read start


def cigar_md_stats(rdlen, edits, read_start=0, read_end=None):
    """Build CIGAR string, MD:Z value, and tag stats from an edit list.

    Sparse event walk (O(#edits), not O(rdlen) — edit lists are tiny for
    real reads). read_end: exclusive end of aligned read region (for local
    soft clips). Returns dict with cigar, md, nm, xm, xo, xg, ref_span.
    """
    if read_end is None:
        read_end = rdlen
    ops = []  # [op_char, length] runs

    def push(op, n=1):
        if n <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1][1] += n
        else:
            ops.append([op, n])

    if read_start > 0:
        push("S", read_start)
    # event order at one read position: D (before consuming the char),
    # then I/M (consume it)
    order = {"D": 0, "I": 1, "M": 2}
    events = sorted(edits, key=lambda e: (e[1], order[e[0]]))
    i = read_start
    nm = xm = xo = xg = 0
    md = []
    run = 0
    k = 0
    n_ev = len(events)
    while k < n_ev:
        e = events[k]
        pos = e[1]
        if pos > i:  # matching stretch up to the event
            push("M", pos - i)
            run += pos - i
            i = pos
        if e[0] == "D":
            # collect the whole deletion group at this position
            chars = []
            while k < n_ev and events[k][0] == "D" and events[k][1] == pos:
                chars.append("ACGTN"[min(events[k][2], 4)])
                k += 1
            push("D", len(chars))
            nm += len(chars)
            xg += len(chars)
            xo += 1
            md.append(str(run)); run = 0
            md.append("^" + "".join(chars))
        elif e[0] == "I":
            new_open = not (ops and ops[-1][0] == "I")
            push("I", 1)
            nm += 1
            xg += 1
            if new_open:
                xo += 1
            i += 1
            k += 1
        else:  # mismatch
            push("M", 1)
            nm += 1
            xm += 1
            md.append(str(run)); run = 0
            md.append("ACGTN"[min(e[2], 4)])
            i += 1
            k += 1
    if read_end > i:
        push("M", read_end - i)
        run += read_end - i
    md.append(str(run))
    if read_end < rdlen:
        push("S", rdlen - read_end)
    cigar = "".join(f"{n}{op}" for op, n in ops)
    mdstr = "".join(md)
    ref_span = sum(n for op, n in ops if op in ("M", "D"))
    return dict(cigar=cigar, md=mdstr, nm=nm, xm=xm, xo=xo, xg=xg,
                ref_span=ref_span)
