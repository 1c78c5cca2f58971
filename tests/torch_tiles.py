"""Seeded DP problem tiles shared by the port's tests ([rows, P] int32
arrays, P = 128 problems: one tile of the reference's Pallas kernels).
Imports neither jax nor the JAX package, so the CUDA tests can use it on a
machine without JAX."""
import numpy as np

P = 128

# scoring configurations (SwConfig fields) the DP tests run
CFGS = {
    "e2e": dict(),
    "local": dict(ma=2, local=True),
    "e2e_gapbar0": dict(gapbar=0, npen=3, rdg_open=5, rdg_ext=2),
    "local_gapbar10": dict(ma=1, local=True, gapbar=10, rfg_open=4,
                           rfg_ext=1),
}
RECT_CFGS = {
    "e2e": dict(),
    "local": dict(ma=2, local=True),
    "e2e_gapbar1": dict(gapbar=1, npen=2, rfg_open=5, rfg_ext=2),
    "local_gapbar6": dict(ma=1, local=True, gapbar=6, rdg_open=4,
                          rdg_ext=1),
}


def banded_tile(seed, lq, K):
    """[rows, P] int32 inputs: planted reads with substitutions and
    indels, N codes in reads (5) and references (4), ragged lengths, and
    homopolymer problems full of equal-score ties."""
    rng = np.random.default_rng(seed)
    C = K // 2
    band = rng.integers(0, 4, (lq + K, P))
    rd = band[C : C + lq].copy()
    for p in range(P):
        kind = p % 8
        for _ in range(p % 4):
            rd[rng.integers(0, lq), p] = rng.integers(0, 4)
        if kind == 1:      # deletion of one reference base
            q = int(rng.integers(lq // 4, 3 * lq // 4))
            rd[q:, p] = band[C + q + 1 : C + lq + 1, p]
        elif kind == 2:    # insertion of one read base
            q = int(rng.integers(lq // 4, 3 * lq // 4))
            rd[q + 1 :, p] = band[C + q : C + lq - 1, p]
        elif kind == 3:    # N in the read and in the reference
            rd[rng.integers(0, lq, 2), p] = 5
            band[rng.integers(0, lq + K, 3), p] = 4
        elif kind == 4:    # ties everywhere
            band[:, p] = 2
            rd[:, p] = 2
        elif kind == 5:    # unrelated
            rd[:, p] = rng.integers(0, 4, lq)
    mm = rng.integers(2, 7, (lq, P))
    lens = np.where(np.arange(P) % 3 == 0, rng.integers(1, lq + 1, P), lq)
    return [np.ascontiguousarray(a, np.int32) for a in (rd, mm, lens, band)]


# a scoring the byte-table kernel does not take (ma above 127): every
# problem goes to the general kernel of ops/csrc/sw_banded.cu
LARGE_SCORE_CFG = dict(ma=150, npen=2, local=True)

# lengths of the second warp of banded_edge_tile (which adds Lq-1, Lq and
# Lq+3): empty, one row, the gap barriers of CFGS (0, 4, 10) and twice
# them, and below zero
EDGE_LENS = (0, 1, 4, 8, 10, 20, -1, -2, 2, 3, 5)


def banded_edge_tile(seed, lq, K, p=P + 1):
    """[rows, p] int32 inputs at the edges of the banded kernels: per warp
    of 32 problems, lengths all Lq (warp 0), the EDGE_LENS with Lq-1, Lq
    and Lq+3 (warp 1), all equal and short (warp 2), random (warp 3), and
    problem 128 alone in its warp and block (p = 129); all-N read rows and
    all-N reads and bands; homopolymer and tandem-repeat ties; and
    mismatch penalties at and past the int8 edge (128 and -127 fit a
    signed byte as -mm, 129 and -128 do not)."""
    rng = np.random.default_rng(seed)
    C = K // 2
    band = rng.integers(0, 4, (lq + K, p))
    rd = band[C : C + lq].copy()
    mm = rng.integers(2, 7, (lq, p))
    for q in range(p):
        kind = q % 8
        for _ in range(q % 3):
            rd[rng.integers(0, lq), q] = rng.integers(0, 4)
        if kind == 1:      # homopolymer: equal scores along every row
            band[:, q] = 1
            rd[:, q] = 1
            rd[rng.integers(0, lq), q] = 2
        elif kind == 2:    # tandem repeat of a 2-3 base unit
            unit = rng.integers(0, 4, 2 + q % 2)
            band[:, q] = np.resize(unit, lq + K)
            rd[:, q] = band[C + 1 : C + 1 + lq, q]
        elif kind == 3:    # a run of all-N read rows, N in the band
            a = int(rng.integers(0, lq))
            rd[a : a + 5, q] = 5
            band[rng.integers(0, lq + K, 4), q] = 4
        elif kind == 4:    # an all-N read
            rd[:, q] = 5
        elif kind == 5:    # an all-N band
            band[:, q] = 4
        elif kind == 6:    # penalties at the int8 edge: still in range
            mm[rng.integers(0, lq, 3), q] = (128, -127, 128)
        elif kind == 7 and q % 16 == 7:   # and past it, in one row
            mm[rng.integers(0, lq), q] = 129 if q % 32 == 7 else -128
    lens = np.full(p, lq)
    lens[32:64] = np.resize(list(EDGE_LENS) + [lq - 1, lq, lq + 3], 32)
    lens[64:96] = lq // 2 + 1
    lens[96:128] = rng.integers(1, lq + 1, 32)
    return [np.ascontiguousarray(a, np.int32) for a in (rd, mm, lens, band)]


def banded_ragged_tile(seed, lq, K, p):
    """banded_edge_tile's problems (p of them) with lengths that differ
    inside every warp of the wide-band kernel (K/32 lanes a problem, 1 to
    8 problems a warp): problem q has length (7 q + 3) % (lq + 5) - 1,
    from -1 to lq + 3, so neighbours finish, and leave their gap runs, at
    different rows."""
    rd, mm, _, band = banded_edge_tile(seed, lq, K, max(p, P + 1))
    rd, mm, band = (np.ascontiguousarray(a[:, :p]) for a in (rd, mm, band))
    lens = (7 * np.arange(p) + 3) % (lq + 5) - 1
    return [rd, mm, np.ascontiguousarray(lens, np.int32), band]


# mismatch penalties at the edges of the general kernel's int16 route:
# -mm = -32768 and 127 take it, -32769 and 128 do not
INT16_EDGE_MM = (32768, 32769, -127, -128)


def banded_int16_edge_tile(seed, lq, K, p=P + 1):
    """banded_edge_tile with one penalty of INT16_EDGE_MM in every fifth
    problem, at a random row."""
    rd, mm, lens, band = banded_edge_tile(seed, lq, K, p)
    rng = np.random.default_rng(seed + 1)
    for q in range(0, p, 5):
        mm[rng.integers(0, lq), q] = INT16_EDGE_MM[(q // 5) % 4]
    return [rd, mm, lens, band]


def rect_tile(seed, lq_pad, lc, p=P):
    """[rows, p] int32 inputs: reads planted in their windows with
    substitutions and indels, N codes, ragged read and window lengths."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, (lc, p))
    rd = np.full((lq_pad, p), 5)
    lens = rng.integers(lq_pad // 2, lq_pad + 1, p)
    lens[::5] = lq_pad
    reflens = np.minimum(lc, lens + rng.integers(0, lc, p))
    reflens[::7] = lc
    for q in range(p):
        n = int(lens[q])
        s = int(rng.integers(0, max(1, lc - n)))
        r = ref[s : s + n, q].copy()
        r = np.concatenate([r, rng.integers(0, 4, n - len(r))])
        for _ in range(q % 4):
            r[rng.integers(0, n)] = rng.integers(0, 4)
        if q % 5 == 1:
            k = int(rng.integers(2, max(3, n - 2)))
            r = np.concatenate([r[:k], r[k + 1 :], [1]])
        elif q % 5 == 2:
            k = int(rng.integers(2, max(3, n - 2)))
            r = np.concatenate([r[:k], [3], r[k:]])[:n]
        elif q % 5 == 3:
            r[rng.integers(0, n)] = 5
            ref[rng.integers(0, lc), q] = 4
        rd[:n, q] = r
    mm = rng.integers(2, 7, (lq_pad, p))
    return [np.ascontiguousarray(a, np.int32)
            for a in (rd, mm, lens, ref, reflens)]


def rect_tie_tile(seed, lq_pad, lc, p=P):
    """[rows, p] int32 inputs full of equal-score ends: homopolymer and
    tandem-repeat references (some with N codes) and reads cut from them,
    all-N reads, reads of length 1 and one of length 0, windows shorter
    than Lc (down to 0 and 1), and a constant mismatch penalty in half the
    problems."""
    rng = np.random.default_rng(seed)
    ref = np.full((lc, p), 4)
    rd = np.full((lq_pad, p), 5)
    lens = rng.integers(1, lq_pad + 1, p)
    lens[::11] = lq_pad
    reflens = rng.integers(2, lc, p)
    for q in range(p):
        kind = q % 10
        unit = rng.integers(0, 4, 1 + q % 4)      # 1: homopolymer
        reps = np.resize(unit, lc + lq_pad + 4)
        if kind == 4:
            reps[rng.integers(0, lc, 3)] = 4
        if kind == 8:
            reps = rng.integers(0, 4, len(reps))
        if kind == 9:
            reflens[q] = q % 2
        ref[: reflens[q], q] = reps[: reflens[q]]
        n = int(lens[q])
        if kind in (6, 7):
            n = lens[q] = 1
        r = reps[int(rng.integers(0, len(unit))):][:n].copy()
        if kind == 1:
            r[rng.integers(0, n)] = (r[0] + 1) % 4
        elif kind == 5:
            r[:] = 5                                # all-N read
        elif kind in (7, 8):
            r = rng.integers(0, 4, n)
        rd[:n, q] = r
    lens[p - 1] = 0
    rd[:, p - 1] = 5
    mm = np.where(np.arange(p) % 2 == 0, 6, rng.integers(2, 7, (lq_pad, p)))
    return [np.ascontiguousarray(a, np.int32)
            for a in (rd, mm, lens, ref, reflens)]


def fm_genome(seed, n=20_000):
    """Codes of a genome for the FM tiles: random, with a 300-base unit
    copied 8 times (ranges of many rows) and a 100-base run of one base."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    unit = g[:300].copy()
    for k in range(1, 9):
        g[k * 1000 : k * 1000 + 300] = unit
    g[15_000:15_100] = 2
    return g


def fm_edge_tile(seed, text, n_rows, primary, p=P + 1, lq=48):
    """Inputs at the edges of the FM walks over an index of `text` (codes
    0..3) with n_rows BWT rows and its $ row at `primary`: patterns [p, lq]
    uint8 and lengths [p] int32 — substrings of the text (from the repeat,
    from the text's end, so that LF passes the $ row), random ones (empty
    ranges), an N at a random place or among the last 10 characters (no
    ftab jump), lengths 0, 1, 9, 10, 11 and lq; and one LF step's (c, top,
    bot) [p] int32 — rows at and beside the 64-row block boundaries, the $
    row, 0 and n_rows, empty (top == bot) and inverted ranges, and c of 4
    and 5 (N, pad)."""
    rng = np.random.default_rng(seed)
    pat = np.full((p, lq), 5, np.uint8)
    lens = rng.integers(1, lq + 1, p)
    lens[:8] = (0, 1, 9, 10, 11, lq, lq, 0)
    for q in range(p):
        n = int(lens[q])
        kind = q % 6
        if kind == 1:                         # from the repeat
            s = int(rng.integers(1000, 1300 - min(n, 300)))
        elif kind == 2:                       # the text's end
            s = len(text) - n
        else:
            s = int(rng.integers(0, len(text) - n + 1))
        r = text[s : s + n].copy()
        if kind == 3:                         # random: mostly empty
            r = rng.integers(0, 4, n).astype(np.uint8)
        elif kind == 4 and n:                 # an N anywhere
            r[rng.integers(0, n)] = 4
        elif kind == 5 and n:                 # an N among the last 10
            r[max(0, n - 1 - int(rng.integers(0, 10)))] = 4
        pat[q, :n] = r
    rows = np.array([0, 1, 62, 63, 64, 65, 127, 128, 129, primary - 1,
                     primary, primary + 1, n_rows - 65, n_rows - 64,
                     n_rows - 1, n_rows])
    rows = np.clip(rows, 0, n_rows)
    top = np.resize(rows, p)
    width = np.resize([0, 1, 2, 5, 64, -1, 200], p)
    bot = np.clip(top + width, 0, n_rows)
    top[-16:] = rng.integers(0, n_rows, 16)
    bot[-16:] = np.minimum(top[-16:] + rng.integers(0, 300, 16), n_rows)
    c = np.resize(np.arange(6), p)
    return (pat, lens.astype(np.int32),
            *(np.ascontiguousarray(a, np.int32) for a in (c, top, bot)))


def traceback_problems(seed, p, K, lo=20, hi=250):
    """p banded traceback problems in banded_traceback_batch's layout
    (host [p, ...] arrays): rd [p, Lq] uint8 (pad 5), mm [p, Lq] int32,
    band [p, Lq + K] uint8 (pad 4), lens [p] int32, read lengths lo..hi in
    one batch. Reads are cut from their window on a diagonal near either
    band edge or inside, with 0-3 indels of 1-4 bases anywhere (inside the
    gap barrier too), substitutions and N codes in reads and windows; one
    problem in four has a window of a short repeated unit, full of
    equal-score ties."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, p).astype(np.int32)
    lq = int(lens.max())
    rd = np.full((p, lq), 5, np.uint8)
    mm = np.zeros((p, lq), np.int32)
    band = np.full((p, lq + K), 4, np.uint8)
    for t in range(p):
        rl = int(lens[t])
        if t % 4 == 3:
            unit = rng.integers(0, 4, int(rng.integers(1, 4)))
            ref = np.resize(unit, rl + K + 8)
            ref[rng.integers(0, len(ref), 2)] = rng.integers(0, 4, 2)
        else:
            ref = rng.integers(0, 4, rl + K + 8)
        if t % 5 == 1:
            ref[rng.integers(0, len(ref), 3)] = 4
        c = int((0, 1, K - 3, K // 2, rng.integers(0, K))[t % 5])
        read = list(ref[c:])
        for _ in range(int(rng.integers(0, 4))):
            q = int(rng.integers(0, rl))
            n = int(rng.integers(1, 5))
            if rng.random() < 0.5:
                del read[q : q + n]
            else:
                read[q:q] = list(rng.integers(0, 4, n))
        read = np.resize(np.array(read, np.uint8), rl)
        for q in rng.choice(rl, int(rng.integers(0, 6)), False):
            read[q] = rng.integers(0, 4)
        if t % 7 == 2:
            read[rng.integers(0, rl)] = 4
        rd[t, :rl] = read
        mm[t, :rl] = rng.integers(2, 7, rl)
        band[t, : rl + K] = ref[: rl + K]
    return rd, mm, band, lens


# the direction bits of ops/csrc/sw_banded_tb.cu
TB_DIAG, TB_HE, TB_HF, TB_EX, TB_FX, TB_Z = 1, 2, 4, 8, 16, 32


def emulate_traceback_kernel(rd, mm, band, rl, bi, bk, cfg, K, cap):
    """The traceback kernel of ops/csrc/sw_banded_tb.cu, lane by lane in
    numpy for one problem (rd, mm: the read's rows; band: its window of
    rl + K codes): the 32 lanes of the warp are rows of [32, K/32] arrays,
    a shuffle a shift along them, and each step is the kernel's (its
    sentinel, its max-scan over the lanes, its direction bits tested on H
    before the --local clamp, its walk and its edit cap). Returns the
    oracle's (edits, start_band_pos, read_start), or None where the kernel
    flags the problem for the oracle. A fault in the kernel's logic shows
    here on the CPU; what the CUDA compiler makes of it shows only on the
    card."""
    NEG, SENT = -100_000_000, -(1 << 30)
    J, local = K // 32, cfg.local
    if bi < 0 or bi >= min(rl, len(rd)) or bk < 0 or bk >= K:
        return None

    def down(v):   # __shfl_down_sync(v, 1): lane 31 keeps its own
        return np.concatenate([v[1:], v[-1:]])

    def up(v, d=1):   # __shfl_up_sync(v, d): lanes below d keep their own
        return np.concatenate([v[:d], v[:-d]])

    lanes = np.arange(32)
    kk = lanes[:, None] * J + np.arange(J)[None, :]   # band cell of (lane, j)
    edge = kk == K - 1
    h = np.zeros((32, J), np.int64)
    f = np.full((32, J), NEG, np.int64)
    cd = band[kk].astype(np.int64)
    dirs = np.zeros((bi + 1, K), np.int64)
    for i in range(bi + 1):
        rdc, mmv = int(rd[i]), int(mm[i])
        gap = cfg.gapbar <= i < rl - cfg.gapbar
        s = np.where((rdc > 3) | (cd > 3), -cfg.npen,
                     np.where(cd == rdc, cfg.ma, -mmv))
        diag = h + s
        hu = np.concatenate([h[:, 1:], down(h[:, 0])[:, None]], 1)
        fu = np.concatenate([f[:, 1:], down(f[:, 0])[:, None]], 1)
        fv = np.where(gap & ~edge, np.maximum(fu - cfg.rfg_ext,
                                              hu - cfg.rfg_open), NEG)
        fx = (i >= 1) & ~edge & (fv == fu - cfg.rfg_ext)
        base = np.maximum(diag, fv)
        e = np.full((32, J), NEG, np.int64)
        if gap:
            run = np.where(lanes == 0, NEG, SENT).astype(np.int64)
            for j in range(J):
                run = np.maximum(run - cfg.rdg_ext, base[:, j] - cfg.rdg_open)
            d = 1
            while d < 32:
                run = np.where(lanes >= d, np.maximum(
                    run, up(run, d) - d * J * cfg.rdg_ext), run)
                d *= 2
            e[:, 0] = np.where(lanes == 0, NEG, up(run))
            for j in range(1, J):
                e[:, j] = np.maximum(e[:, j - 1] - cfg.rdg_ext,
                                     base[:, j - 1] - cfg.rdg_open)
        ep = np.concatenate([up(e[:, J - 1])[:, None], e[:, :-1]], 1)
        h0 = np.maximum(base, e)
        b = (np.where((h0 == diag) & (not local or diag >= 0), TB_DIAG, 0)
             | np.where((h0 == e) & (not local or e >= 0), TB_HE, 0)
             | np.where((h0 == fv) & (not local or fv >= 0), TB_HF, 0)
             | np.where(fx, TB_FX, 0)
             | np.where((kk >= 1) & (e == ep - cfg.rdg_ext), TB_EX, 0))
        if local:
            b |= np.where(h0 <= 0, TB_Z, 0)
        dirs[i] = b.reshape(-1)
        h, f = (np.maximum(h0, 0) if local else h0), fv
        cd = np.concatenate([cd[:, 1:], down(cd[:, 0])[:, None]], 1)
        if i + 1 <= bi:
            cd[31, J - 1] = band[i + K]
    i, k, state, edits = bi, bk, 0, []   # state 0: H, 1: E, 2: F
    while True:
        if not 0 <= k < K:
            return None
        d = dirs[i, k]
        if state == 0:
            if local and d & TB_Z:
                if d & (TB_HE | TB_HF):
                    state = 1 if d & TB_HE else 2
                    continue
                i += 1
                break
            if d & TB_DIAG:
                rdc, rfc = int(rd[i]), int(band[i + k])
                if rdc != rfc or rdc > 3 or rfc > 3:
                    if len(edits) == cap:
                        return None
                    edits.append(("M", i, rfc, rdc))
                i -= 1
                if i < 0:
                    i = 0
                    break
            elif d & (TB_HE | TB_HF):
                state = 1 if d & TB_HE else 2
            else:
                return None
            continue
        if len(edits) == cap:
            return None
        if state == 1:   # ref char band[i + k] deleted, keyed at i + 1
            edits.append(("D", i + 1, int(band[i + k])))
            k -= 1
            if not d & TB_EX:
                state = 0
        else:            # read char i inserted
            edits.append(("I", i, int(rd[i])))
            i, k = i - 1, k + 1
            if i < 0:
                i = 0
                break
            if not d & TB_FX:
                state = 0
    return edits[::-1], i + k, i


def indel_reads(n=4096, read_len=100, seed=3):
    """A 300 kbp random genome (FASTA text) and n reads of read_len cut
    from it, either strand, 0-3 substitutions, one in eight with a planted
    insertion or deletion of 1-3 bases: the aligner's gapped winners. ->
    (fasta, names, seqs, quals)."""
    rng = np.random.default_rng(seed)
    abc = np.frombuffer(b"ACGTN", np.uint8)
    g = rng.integers(0, 4, 300_000).astype(np.uint8)
    names, seqs = [], []
    for k in range(n):
        s = int(rng.integers(0, len(g) - 120))
        r = list(g[s : s + 110])
        if k % 8 == 0:
            p = int(rng.integers(10, 90))
            if k % 16 == 0:
                del r[p : p + int(rng.integers(1, 4))]
            else:
                r[p:p] = list(rng.integers(0, 4, int(rng.integers(1, 4))))
        r = np.array(r[:read_len], np.uint8)
        for p in rng.choice(read_len, int(rng.integers(0, 4)), False):
            r[p] = (r[p] + 1) % 4
        if k % 2:
            r = (3 - r)[::-1]
        names.append(f"r{k}")
        seqs.append(abc[r].tobytes())
    quals = [bytes(rng.integers(35, 74, read_len).astype(np.uint8))
             for _ in range(n)]
    return ">c0\n" + abc[g].tobytes().decode() + "\n", names, seqs, quals
