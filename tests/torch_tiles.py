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


def rect_tile(seed, lq_pad, lc):
    """[rows, P] int32 inputs: reads planted in their windows with
    substitutions and indels, N codes, ragged read and window lengths."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, (lc, P))
    rd = np.full((lq_pad, P), 5)
    lens = rng.integers(lq_pad // 2, lq_pad + 1, P)
    lens[::5] = lq_pad
    reflens = np.minimum(lc, lens + rng.integers(0, lc, P))
    reflens[::7] = lc
    for p in range(P):
        n = int(lens[p])
        s = int(rng.integers(0, max(1, lc - n)))
        r = ref[s : s + n, p].copy()
        r = np.concatenate([r, rng.integers(0, 4, n - len(r))])
        for _ in range(p % 4):
            r[rng.integers(0, n)] = rng.integers(0, 4)
        if p % 5 == 1:
            q = int(rng.integers(2, n - 2))
            r = np.concatenate([r[:q], r[q + 1 :], [1]])
        elif p % 5 == 2:
            q = int(rng.integers(2, n - 2))
            r = np.concatenate([r[:q], [3], r[q:]])[:n]
        elif p % 5 == 3:
            r[rng.integers(0, n)] = 5
            ref[rng.integers(0, lc), p] = 4
        rd[:n, p] = r
    mm = rng.integers(2, 7, (lq_pad, P))
    return [np.ascontiguousarray(a, np.int32)
            for a in (rd, mm, lens, ref, reflens)]
