// Banded affine-gap DP in diagonal band coordinates, one thread per problem,
// built from Hopper's fused DPX max-add instructions.
//
// Replaces the TPU kernel bowtie2_server_tpu/ops/sw_banded.py::_banded_kernel
// (launched through _pallas_banded) for bands of K = 32, 64 and 128. It
// computes the same function as that kernel and as the plain torch version
// banded_tile_torch (bowtie2_server_tpu_torch/ops/sw_banded.py), bit for bit:
//   - cell (i, k) scores read row i against band code band[i + k]: -npen if
//     either code is N (read code > 3, band code > 3), ma on a match, else
//     -mm[i];
//   - F comes from (i-1, k+1), E is the chain along k, both barred outside
//     the gap rows gapbar <= i < len - gapbar; --local clamps H at 0;
//   - the running best per problem takes ties at the larger k; end-to-end
//     updates on a strictly greater score in row len-1 only, local on a
//     greater-or-equal score in any row < len.
//
// What bounds it on this card: the issue rate of the integer pipe. A cell is
// a handful of dependent integer operations on registers; no matrix
// products, and each row reads one read code, one penalty and one new band
// code per problem. The kernel it replaces issued 17.16 SASS instructions a
// cell (kernels.loop_mix of its row loop at K = 64), at the rate of the ALU
// probe. This one issues about 7 in a gap row and about 3 in a row where
// gaps are barred (chip_smoke phase 3 logs the count).
//
// The design, and why each step gives the plain version's values exactly:
//   1. One thread owns one problem: H and F rows (K int32 each) in
//      registers, every loop over k unrolled (K is a template parameter).
//   2. Fused max-add. In a gap row, per cell:
//        fn   = __viaddmax_s32(h[k+1], -rfg_open, f[k+1] - rfg_ext)
//             = max(h - open, f - ext), the plain F (NEG at k = K-1);
//        base = __viaddmax_s32(h[k], s, fn) = max(diag, F);
//        h    = __viaddmax_s32(eo, -rdg_open, base) = max(base, E)
//               (__viaddmax_s32_relu in --local: the clamp at 0);
//        eo   = __viaddmax_s32(eo, -rdg_ext, base), for cell k+1.
//      eo carries E + rdg_open: the plain E chain along k, E[0] = NEG and
//      E[k] = max(E[k-1] - rdg_ext, base[k-1] - rdg_open), with rdg_open
//      added to both sides, becomes eo[k] = max(eo[k-1] - rdg_ext,
//      base[k-1]), one instruction on the chain and none off it (at
//      K = 128 in --local the chain keeps the plain form, see row_update).
//      The sequential chain unrolls into exactly the plain version's
//      Kogge-Stone max-scan. These are the plain version's additions and
//      maxima, in the same int32 arithmetic (far from overflow: NEG is
//      -1e8), regrouped into single instructions: five a cell.
//   3. Gap rows are handled per row, not per cell. Per problem the gap rows
//      are one run [g0, g1), so the row loop is three loops: rows before
//      the run, the run, rows after it. Outside the run the plain version
//      sets F = E = NEG, so H = max(max(diag, NEG), NEG) = max(diag, NEG)
//      end-to-end, and max(diag, 0) in --local (NEG < 0): one
//      __viaddmax_s32 a cell. Those rows do not write f. Before the run f
//      still holds its initial NEG everywhere, the value the plain version
//      would have stored, and the first gap row reads exactly that; after
//      the run no gap row follows, so the stale f is never read again.
//   4. The score in 1 + 3/8 instructions a cell. The window of K band codes
//      is nibble-packed, eight codes to a register (band code > 3 stored as
//      4), and slides one code a row by funnel shifts, so each row loads one
//      new band code. Per row a byte table holds the five scores, indexed
//      by band code (byte 4: N); one PRMT with four window nibbles as its
//      selector looks up four cells at once, and one PRMT per cell takes
//      its byte out sign-extended. The bytes hold the scores only while
//      they fit int8: ma and -npen in [-128, 127] (checked on the host) and
//      -mm[i] (checked per row). A problem with a row outside that range is
//      marked and recomputed by the second kernel below; the host sends
//      every problem there when ma or npen do not fit.
//   5. Each thread's row loop ends at min(len, lq): rows at or past len are
//      scored in no mode. For a problem with len >= 1 they change nothing:
//      end-to-end scores only row len-1, and in --local an unscored row
//      offers NEG >= best, false once best >= 0. The rows skipped leave
//      these results, written out literally: --local with len <= 0 gives
//      (NEG, lq-1, K-1), as every unscored row updates on NEG >= NEG; end-
//      to-end with len <= 0 or len > lq gives (NEG, -1, -1). A warp runs
//      until its longest problem; no warp collective is used, so the
//      threads past P simply return.
//   6. The running best. End-to-end: only row len-1 is scored, and it is
//      the last row the loop computes, so its arg-max (ties at the larger
//      k) runs once, after the loop. --local: every row; the row's best and
//      its largest arg-max are the max over keys h[k] * 128 + k (k < 128),
//      which order as (h, k) since 0 <= h < 2^24 there: h >= 0 by the
//      clamp, and h <= 127 * (i + 1) when scores fit int8 and the four gap
//      penalties are >= 0 (checked on the host, with lq <= 65536). Across
//      rows it updates on cb >= best, as the plain version does.
// The second kernel, banded_general_kernel, takes what the first cannot:
// it runs after the first on the same stream (every call launches both: the
// host cannot see the marks without waiting for the card), computes the
// problems marked REDO, or every problem when the host found the scoring
// outside the first kernel's range, and returns at once for the others. No
// preset or CLI option gives a score outside a byte (ma <= 2, mismatch
// penalties 2-6, npen 1, gap penalties 5+3), so on the aligners' paths it
// does no work; its launch costs what chip_smoke's profiled batches report
// for it. A caller passing its own scoring sends problems to it: ma or npen
// past a byte (all problems), a mismatch penalty past a byte (the problems
// with such a row), or --local with a negative gap penalty or lq > 65536
// (all problems). It is built on the first kernel's design, and each step
// is exact for the same reasons:
//   - one thread a problem, the DPX cell of step 2 (E carried as E +
//     rdg_open, five instructions a gap cell), the three row loops of step
//     3, the rows ending at min(len, lq) of step 5, and the end-to-end
//     arg-max once after the loop of step 6;
//   - scores: the plain version's three values a row, ma on a match,
//     -mm[i] (-npen for an N read) on a mismatch, -npen for band code 4,
//     held as int16 in two byte tables (the low bytes and the high bytes,
//     built as in step 4), two PRMTs looking up four cells and one PRMT a
//     cell joining a cell's two bytes and extending the sign: the int16
//     value itself, while ma and -npen fit int16 (checked on the host) and
//     -mm[i] lies in [-32768, 127] (checked per row);
//   - --local: the row's best and its largest k by the key h * 128 + k of
//     step 6 when the host proves h < 2^24: the four gap penalties >= 0
//     and max(ma, -npen, 127) * lq < 2^24 (h <= that score times i + 1,
//     since no row's score on this route is larger); compare and select
//     otherwise;
//   - the exact route: a row outside that range takes the plain version's
//     selects on the band code (exact_score, any int32 scores) and compare
//     and select for the best, and so does every later row of the problem
//     (the key bound needs every earlier row's scores); every row when ma
//     or -npen do not fit int16.
// The DPX instructions add in int32 as the plain version does; every sum
// here is one the plain version forms (regrouped), so both agree for any
// scoring whose sums stay inside int32 (NEG = -1e8 plus at most lq scores
// and lq + K gap penalties).
#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_common.cuh"

namespace {

constexpr int REDO = -2;          // bk mark: recompute in the general kernel

// One row of the DP over the window w, from the score tables tlo (band
// codes 0-3) and thi (code 4); h and f are updated in place. --local:
// returns the row's largest key h[k] * 128 + k, taken as each cell is
// made, so that no key outlives its cell (design note, step 6).
template <int K, bool LOCAL, bool GAP>
__device__ __forceinline__ int row_update(int (&h)[K], int (&f)[K],
                                          const uint32_t (&w)[K / 8],
                                          uint32_t tlo, uint32_t thi,
                                          const Cfg& c) {
  // E + rdg_open (design note, step 2); at K = 128 in --local, E itself
  // with pbo = base[k-1] - rdg_open off the chain (one VIADD a cell more):
  // there the first form made ptxas spill 1036 bytes against 312 and ran
  // 0.75 ms against 0.32 on the H100
  constexpr bool EO = !(K == 128 && LOCAL);
  int eo = EO ? NEG + c.rdg_open : NEG, pbo = NEG;
  int key = 0, even = 0;       // keys are >= 0: h >= 0 in --local
  uint32_t four = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if ((k & 3) == 0)   // the scores of cells k..k+3 as four bytes
      four = prmt(tlo, thi, (k & 4) ? w[k >> 3] >> 16 : w[k >> 3]);
    int s;
    switch (k & 3) {
      case 0: s = sbyte<0>(four); break;
      case 1: s = sbyte<1>(four); break;
      case 2: s = sbyte<2>(four); break;
      default: s = sbyte<3>(four); break;
    }
    if (!GAP) {
      h[k] = __viaddmax_s32(h[k], s, LOCAL ? 0 : NEG);
    } else {
      const int fn = k < K - 1
          ? __viaddmax_s32(h[k + 1], -c.rfg_open, f[k + 1] - c.rfg_ext)
          : NEG;
      const int base = __viaddmax_s32(h[k], s, fn);
      if (EO) {
        h[k] = LOCAL ? __viaddmax_s32_relu(eo, -c.rdg_open, base)
                     : __viaddmax_s32(eo, -c.rdg_open, base);
        eo = __viaddmax_s32(eo, -c.rdg_ext, base);   // for k + 1
      } else {
        if (k > 0) eo = __viaddmax_s32(eo, -c.rdg_ext, pbo);
        pbo = base - c.rdg_open;
        h[k] = __vimax3_s32(base, eo, 0);
      }
      f[k] = fn;   // (i-1, k+1) was read above; slot k is not read again
    }
    if (LOCAL) {   // two cells' keys into one 3-way max
      if (k & 1)
        key = __vimax3_s32(key, even, (h[k] << 7) | k);
      else
        even = (h[k] << 7) | k;
    }
  }
  return key;
}

// The per-problem state of banded_kernel between rows.
template <int K>
struct Problem {
  int h[K], f[K];
  uint32_t w[K / 8];   // nibble j of w[q]: band code of row i + 8q + j
  int rdc, mmv;        // this row's read code and penalty (loaded ahead)
  uint32_t nxt;        // the band code entering the window after this row
  int best, bi, bk;
};

// Row i of problem p: returns false when -mm[i] does not fit a byte.
template <int K, bool LOCAL, bool GAP>
__device__ __forceinline__ bool row(Problem<K>& s, int i, int n,
                                    const int32_t* __restrict__ rd,
                                    const int32_t* __restrict__ mm,
                                    const int32_t* __restrict__ band,
                                    size_t sP, int p, const Cfg& c,
                                    uint32_t ma4, uint32_t thi) {
  constexpr int NW = K / 8;
  const int rdc = s.rdc, mmv = s.mmv;
  const uint32_t nxt = s.nxt;
  if (i + 1 < n) {   // the next row's inputs, a row ahead of their use
    s.rdc = rd[(i + 1) * sP + p];
    s.mmv = mm[(i + 1) * sP + p];
    s.nxt = code4(band[(i + 1 + K) * sP + p]);
  }
  if (static_cast<uint32_t>(mmv) + 127u > 255u) return false;   // -mmv: int8
  // score table: bytes 0-3 the mismatch score (-npen for an N read), the
  // byte of the read's code (0..3) ma; byte 4 (thi) -npen
  const bool rd_n = rdc > 3;
  const int mis = rd_n ? -c.npen : -mmv;
  uint32_t sel = 0x3210u;   // nibble rdc + 4 takes byte rdc of ma4
  if (!rd_n && rdc >= 0) sel += 4u << (4 * rdc);
  const uint32_t tlo =
      prmt((static_cast<uint32_t>(mis) & 0xFFu) * 0x01010101u, ma4, sel);
  const int key = row_update<K, LOCAL, GAP>(s.h, s.f, s.w, tlo, thi, c);
  if (LOCAL) {   // the row's best and its largest arg-max
    const int cb = key >> 7;
    if (cb >= s.best) {
      s.best = cb;
      s.bi = i;
      s.bk = key & 127;
    }
  }
#pragma unroll
  for (int q = 0; q < NW - 1; ++q) s.w[q] = __funnelshift_r(s.w[q], s.w[q + 1], 4);
  s.w[NW - 1] = __funnelshift_r(s.w[NW - 1], nxt, 4);
  return true;
}

template <int K, bool LOCAL>
__global__ void __launch_bounds__(128)
banded_kernel(const int32_t* __restrict__ rd, const int32_t* __restrict__ mm,
              const int32_t* __restrict__ lens,
              const int32_t* __restrict__ band,
              int32_t* __restrict__ best_out, int32_t* __restrict__ bi_out,
              int32_t* __restrict__ bk_out, int lq, int P, Cfg c) {
  static_assert(K % 8 == 0 && K <= 128, "K: a multiple of 8, at most 128");
  constexpr int NW = K / 8;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t sP = static_cast<size_t>(P);
  const int len = lens[p];
  const int n = min(max(len, 0), lq);        // rows this problem needs
  const int g0 = min(max(c.gapbar, 0), n);   // gap rows: [g0, g1)
  const int g1 = max(g0, min(len - c.gapbar, n));

  Problem<K> s;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s.h[k] = 0;     // H[-1] = 0: the alignment may start at any column
    s.f[k] = NEG;
  }
  s.best = NEG;
  s.bi = -1;
  s.bk = -1;
  s.rdc = s.mmv = 0;
  s.nxt = 0;
  if (n > 0) {
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v |= code4(band[(8 * q + j) * sP + p]) << (4 * j);
      s.w[q] = v;
    }
    s.rdc = rd[p];
    s.mmv = mm[p];
    s.nxt = code4(band[K * sP + p]);
  }
  // ma in every byte; -npen, the score of band code 4, in byte 0
  const uint32_t ma4 = (static_cast<uint32_t>(c.ma) & 0xFFu) * 0x01010101u;
  const uint32_t thi = static_cast<uint32_t>(-c.npen) & 0xFFu;

  bool ok = true;
  int i = 0;
  for (; ok && i < g0; ++i)
    ok = row<K, LOCAL, false>(s, i, n, rd, mm, band, sP, p, c, ma4, thi);
  for (; ok && i < g1; ++i)
    ok = row<K, LOCAL, true>(s, i, n, rd, mm, band, sP, p, c, ma4, thi);
  for (; ok && i < n; ++i)
    ok = row<K, LOCAL, false>(s, i, n, rd, mm, band, sP, p, c, ma4, thi);
  if (!ok) {
    bk_out[p] = REDO;
    return;
  }

  if (LOCAL && len <= 0 && lq > 0) {   // every row unscored, all updating
    s.bi = lq - 1;
    s.bk = K - 1;
  }
  if (!LOCAL && len >= 1 && len <= lq) {   // row len-1, the last computed
    int cb = s.h[0], ca = 0;
#pragma unroll
    for (int k = 1; k < K; ++k)
      if (s.h[k] >= cb) {
        cb = s.h[k];
        ca = k;
      }
    if (cb > s.best) {
      s.best = cb;
      s.bi = len - 1;
      s.bk = ca;
    }
  }
  best_out[p] = s.best;
  bi_out[p] = s.bi;
  bk_out[p] = s.bk;
}

// The general kernel's row i (design note, second part): int16 scores
// from two byte tables (FAST) or the exact route's selects; --local keys
// when FAST and KEYS, else compare and select. h, f and the window are
// updated in place, the running best with the row.
template <int K, bool LOCAL, bool GAP, bool FAST, bool KEYS>
__device__ __forceinline__ void general_row(
    Problem<K>& s, int i, int n, const int32_t* __restrict__ rd,
    const int32_t* __restrict__ mm, const int32_t* __restrict__ band,
    size_t sP, int p, const Cfg& c, uint32_t malo, uint32_t mahi,
    uint32_t t4lo, uint32_t t4hi) {
  constexpr int NW = K / 8;
  const int rdc = s.rdc, mmv = s.mmv;
  const uint32_t nxt = s.nxt;
  if (i + 1 < n) {   // the next row's inputs, a row ahead of their use
    s.rdc = rd[(i + 1) * sP + p];
    s.mmv = mm[(i + 1) * sP + p];
    s.nxt = code4(band[(i + 1 + K) * sP + p]);
  }
  const bool rd_n = rdc > 3;
  const int mis = rd_n ? -c.npen : -mmv;
  // FAST: the low and the high bytes of the five scores, as byte_table
  uint32_t lo = 0, hi = 0;
  int rdx = 15;
  if (FAST) {
    uint32_t sel = 0x3210u;
    if (!rd_n && rdc >= 0) sel += 4u << (4 * rdc);
    lo = prmt((static_cast<uint32_t>(mis) & 0xFFu) * 0x01010101u, malo, sel);
    hi = prmt((static_cast<uint32_t>(mis) >> 8 & 0xFFu) * 0x01010101u, mahi,
              sel);
  } else if (!rd_n && rdc >= 0) {
    rdx = rdc;
  }
  int eo = NEG + c.rdg_open;   // E + rdg_open
  int key = 0, even = 0, cb = -1, ca = 0;
  uint32_t flo = 0, fhi = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int sc;
    if (FAST) {
      if ((k & 3) == 0) {   // cells k..k+3: four low and four high bytes
        const uint32_t nib = (k & 4) ? s.w[k >> 3] >> 16 : s.w[k >> 3];
        flo = prmt(lo, t4lo, nib);
        fhi = prmt(hi, t4hi, nib);
      }
      // low byte k % 4 of flo, high byte k % 4 of fhi, sign-extended
      const uint32_t q = k & 3;
      sc = static_cast<int>(prmt(flo, fhi, q | (q + 4) << 4 |
                                               (q + 12) << 8 | (q + 12) << 12));
    } else {
      sc = exact_score(nibble(s.w, k), rdx, mis, c);
    }
    if (!GAP) {
      s.h[k] = __viaddmax_s32(s.h[k], sc, LOCAL ? 0 : NEG);
    } else {
      const int fn = k < K - 1 ? __viaddmax_s32(s.h[k + 1], -c.rfg_open,
                                                s.f[k + 1] - c.rfg_ext)
                               : NEG;
      const int base = __viaddmax_s32(s.h[k], sc, fn);
      s.h[k] = LOCAL ? __viaddmax_s32_relu(eo, -c.rdg_open, base)
                     : __viaddmax_s32(eo, -c.rdg_open, base);
      eo = __viaddmax_s32(eo, -c.rdg_ext, base);   // for k + 1
      s.f[k] = fn;
    }
    if (LOCAL) {
      if (FAST && KEYS) {   // two cells' keys into one 3-way max
        if (k & 1)
          key = __vimax3_s32(key, even, (s.h[k] << 7) | k);
        else
          even = (s.h[k] << 7) | k;
      } else if (s.h[k] >= cb) {
        cb = s.h[k];
        ca = k;
      }
    }
  }
  if (LOCAL) {   // the row's best and its largest arg-max
    if (FAST && KEYS) {
      cb = key >> 7;
      ca = key & 127;
    }
    if (cb >= s.best) {
      s.best = cb;
      s.bi = i;
      s.bk = ca;
    }
  }
#pragma unroll
  for (int q = 0; q < NW - 1; ++q) s.w[q] = __funnelshift_r(s.w[q], s.w[q + 1], 4);
  s.w[NW - 1] = __funnelshift_r(s.w[NW - 1], nxt, 4);
}

// Whether row i of the general kernel takes the int16 tables: -mm[i] in
// [-32768, 127] (an int16 score, and no larger bonus than a byte's, for
// the key bound), or an N read (-npen, checked on the host).
template <int K>
__device__ __forceinline__ bool int16_row(const Problem<K>& s) {
  return s.rdc > 3 || static_cast<uint32_t>(s.mmv) + 127u <= 32895u;
}

// The general kernel's problem p; exact for any int32 scores. fit16: ma
// and -npen fit int16.
template <int K, bool LOCAL, bool KEYS>
__device__ __noinline__ void general_body(
    const int32_t* __restrict__ rd, const int32_t* __restrict__ mm,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ band,
    int32_t* __restrict__ best_out, int32_t* __restrict__ bi_out,
    int32_t* __restrict__ bk_out, int lq, int P, Cfg c, bool fit16, int p) {
  static_assert(K % 8 == 0 && K <= 128, "K: a multiple of 8, at most 128");
  constexpr int NW = K / 8;
  const size_t sP = static_cast<size_t>(P);
  const int len = lens[p];
  const int n = min(max(len, 0), lq);        // rows this problem needs
  const int g0 = min(max(c.gapbar, 0), n);   // gap rows: [g0, g1)
  const int g1 = max(g0, min(len - c.gapbar, n));

  Problem<K> s;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s.h[k] = 0;     // H[-1] = 0: the alignment may start at any column
    s.f[k] = NEG;
  }
  s.best = NEG;
  s.bi = -1;
  s.bk = -1;
  s.rdc = s.mmv = 0;
  s.nxt = 0;
#pragma unroll
  for (int q = 0; q < NW; ++q) s.w[q] = 0;
  if (n > 0) {
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v |= code4(band[(8 * q + j) * sP + p]) << (4 * j);
      s.w[q] = v;
    }
    s.rdc = rd[p];
    s.mmv = mm[p];
    s.nxt = code4(band[K * sP + p]);
  }
  // the low and the high byte of ma in every byte; of -npen in byte 0
  const uint32_t ma = static_cast<uint32_t>(c.ma);
  const uint32_t malo = (ma & 0xFFu) * 0x01010101u;
  const uint32_t mahi = (ma >> 8 & 0xFFu) * 0x01010101u;
  const uint32_t t4lo = static_cast<uint32_t>(-c.npen) & 0xFFu;
  const uint32_t t4hi = static_cast<uint32_t>(-c.npen) >> 8 & 0xFFu;

  // the rows on the int16 tables, then, from the first row that does not
  // fit them (row 0 when ma or -npen do not), the exact route
  bool ok = fit16;
  int i = 0;
  for (; ok && i < g0 && (ok = int16_row(s)); ++i)
    general_row<K, LOCAL, false, true, KEYS>(s, i, n, rd, mm, band, sP, p, c,
                                             malo, mahi, t4lo, t4hi);
  for (; ok && i < g1 && (ok = int16_row(s)); ++i)
    general_row<K, LOCAL, true, true, KEYS>(s, i, n, rd, mm, band, sP, p, c,
                                            malo, mahi, t4lo, t4hi);
  for (; ok && i < n && (ok = int16_row(s)); ++i)
    general_row<K, LOCAL, false, true, KEYS>(s, i, n, rd, mm, band, sP, p, c,
                                             malo, mahi, t4lo, t4hi);
  for (; i < g0; ++i)
    general_row<K, LOCAL, false, false, false>(s, i, n, rd, mm, band, sP, p,
                                               c, malo, mahi, t4lo, t4hi);
  for (; i < g1; ++i)
    general_row<K, LOCAL, true, false, false>(s, i, n, rd, mm, band, sP, p,
                                              c, malo, mahi, t4lo, t4hi);
  for (; i < n; ++i)
    general_row<K, LOCAL, false, false, false>(s, i, n, rd, mm, band, sP, p,
                                               c, malo, mahi, t4lo, t4hi);

  if (LOCAL && len <= 0 && lq > 0) {   // every row unscored, all updating
    s.bi = lq - 1;
    s.bk = K - 1;
  }
  if (!LOCAL && len >= 1 && len <= lq) {   // row len-1, the last computed
    int cb = s.h[0], ca = 0;
#pragma unroll
    for (int k = 1; k < K; ++k)
      if (s.h[k] >= cb) {
        cb = s.h[k];
        ca = k;
      }
    if (cb > s.best) {
      s.best = cb;
      s.bi = len - 1;
      s.bk = ca;
    }
  }
  best_out[p] = s.best;
  bi_out[p] = s.bi;
  bk_out[p] = s.bk;
}

// The general kernel: runs the problems marked REDO (all of them when
// `all`). Its body is a function of its own so that the kernel's entry,
// which every call on the paths runs and whose threads all leave at once,
// stays that short: inlined, that launch took 1.37-1.38 us against 1.34 on
// the H100 (k64 shape, no problem marked), for a body 0.8% faster.
template <int K, bool LOCAL, bool KEYS>
__global__ void __launch_bounds__(128)
banded_general_kernel(const int32_t* __restrict__ rd,
                      const int32_t* __restrict__ mm,
                      const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ band,
                      int32_t* __restrict__ best_out,
                      int32_t* __restrict__ bi_out,
                      int32_t* __restrict__ bk_out, int lq, int P, Cfg c,
                      bool all, bool fit16) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P || (!all && bk_out[p] != REDO)) return;
  general_body<K, LOCAL, KEYS>(rd, mm, lens, band, best_out, bi_out, bk_out,
                               lq, P, c, fit16, p);
}

bool fits8(long long v) { return v >= -128 && v <= 127; }
bool fits16(long long v) { return v >= -32768 && v <= 32767; }

// The scoring's routes (design note): fast, the byte scores of
// banded_kernel; keys, the general kernel's --local key; fit16, its int16
// tables.
struct Route {
  bool fast, keys, fit16;
};

template <int K, bool LOCAL>
void launch(const Route& r, dim3 grid, dim3 block, cudaStream_t st,
            const int32_t* rd, const int32_t* mm, const int32_t* lens,
            const int32_t* band, int32_t* best, int32_t* bi, int32_t* bk,
            int lq, int P, Cfg c) {
  if (r.fast)
    banded_kernel<K, LOCAL><<<grid, block, 0, st>>>(rd, mm, lens, band, best,
                                                    bi, bk, lq, P, c);
  if (LOCAL && r.keys)
    banded_general_kernel<K, LOCAL, true><<<grid, block, 0, st>>>(
        rd, mm, lens, band, best, bi, bk, lq, P, c, !r.fast, r.fit16);
  else
    banded_general_kernel<K, LOCAL, false><<<grid, block, 0, st>>>(
        rd, mm, lens, band, best, bi, bk, lq, P, c, !r.fast, r.fit16);
}

template <int K>
void launch(bool local, const Route& r, dim3 grid, dim3 block,
            cudaStream_t st, const int32_t* rd, const int32_t* mm,
            const int32_t* lens, const int32_t* band, int32_t* best,
            int32_t* bi, int32_t* bk, int lq, int P, Cfg c) {
  if (local)
    launch<K, true>(r, grid, block, st, rd, mm, lens, band, best, bi, bk, lq,
                    P, c);
  else
    launch<K, false>(r, grid, block, st, rd, mm, lens, band, best, bi, bk,
                     lq, P, c);
}

}  // namespace

// rd, mm: [lq, P]; lens: [P]; band: [lq + K, P]; best, bi, bk: [P] (int32,
// contiguous, on the device; codes non-negative, as the callers' uint8
// codes are). Returns cudaGetLastError() after the launches.
extern "C" int bt2_sw_banded(const int32_t* rd, const int32_t* mm,
                             const int32_t* lens, const int32_t* band,
                             int32_t* best, int32_t* bi, int32_t* bk, int lq,
                             int P, int K, int ma, int npen, int rdg_open,
                             int rdg_ext, int rfg_open, int rfg_ext,
                             int gapbar, int local, void* stream) {
  if (P <= 0) return 0;
  const Cfg c{ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar};
  const bool gaps_ok = rdg_open >= 0 && rdg_ext >= 0 && rfg_open >= 0 &&
                       rfg_ext >= 0;
  const long long smax = ma > -static_cast<long long>(npen)
      ? (ma > 127 ? ma : 127)
      : (-static_cast<long long>(npen) > 127 ? -static_cast<long long>(npen)
                                             : 127);
  Route r;
  // the byte scores of banded_kernel (design note, steps 4 and 6)
  r.fast = fits8(ma) && fits8(-static_cast<long long>(npen)) &&
           (!local || (lq <= 65536 && gaps_ok));
  // the general kernel's int16 tables and its --local key (second part)
  r.fit16 = fits16(ma) && fits16(-static_cast<long long>(npen));
  r.keys = local && gaps_ok && smax * lq < (1LL << 24);
  const dim3 block(128);
  const dim3 grid((P + 127) / 128);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 32:
      launch<32>(local, r, grid, block, st, rd, mm, lens, band, best, bi, bk,
                 lq, P, c);
      break;
    case 64:
      launch<64>(local, r, grid, block, st, rd, mm, lens, band, best, bi, bk,
                 lq, P, c);
      break;
    case 128:
      launch<128>(local, r, grid, block, st, rd, mm, lens, band, best, bi,
                  bk, lq, P, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
