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
// The second kernel, banded_general_kernel, is the one-thread-a-problem
// design this file had before: per cell selects for the score and the gap
// flag, exact for any int32 scores. It runs after the first on the same
// stream (every call launches both: the host cannot see the marks without
// waiting for the card) and returns at once for every problem the first
// kernel finished. No preset or CLI option gives a score outside a byte
// (ma <= 2, mismatch penalties 2-6, npen 1, gap penalties 5+3), so on the
// aligners' paths it does no work; its launch costs what chip_smoke's
// profiled batches report for it. Only a caller passing its own scoring
// sends problems to it: ma or npen past a byte (all problems), a mismatch
// penalty past a byte (the problems with such a row), or --local with a
// negative gap penalty or lq > 65536 (all problems).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -100000000;   // NEG_INF of ops/sw.py
constexpr int REDO = -2;          // bk mark: recompute in the general kernel

struct Cfg {
  int ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar;
};

// Reference codes are only compared with read codes 0..3 or tested for
// "> 3", so any code above 3 (read as unsigned) is stored as 4.
__device__ __forceinline__ uint32_t code4(int c) {
  return static_cast<uint32_t>(c) > 3u ? 4u : static_cast<uint32_t>(c);
}

// prmt.b32 in its default mode: byte n of the result is the byte of
// {b, a} that nibble n of sel names (bits 0-2), or that byte's sign bit
// replicated (bit 3 set).
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// byte j of x, sign-extended to 32 bits
template <int J>
__device__ __forceinline__ int sbyte(uint32_t x) {
  constexpr uint32_t sel = J | (J | 8) << 4 | (J | 8) << 8 | (J | 8) << 12;
  return static_cast<int>(prmt(x, 0u, sel));
}

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

// The general kernel: byte-packed window, per cell selects; exact for any
// int32 scores. Runs the problems marked REDO (all of them when `all`).
template <int K, bool LOCAL>
__global__ void __launch_bounds__(128)
banded_general_kernel(const int32_t* __restrict__ rd,
                   const int32_t* __restrict__ mm,
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ band,
                   int32_t* __restrict__ best_out, int32_t* __restrict__ bi_out,
                   int32_t* __restrict__ bk_out, int lq, int P, Cfg c,
                   bool all) {
  constexpr int NW = K / 4;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P || (!all && bk_out[p] != REDO)) return;
  const size_t sP = static_cast<size_t>(P);

  int h[K], f[K];
  uint32_t w[NW];   // byte j of w[q]: band code of row i + 4q + j
#pragma unroll
  for (int k = 0; k < K; ++k) {
    h[k] = 0;
    f[k] = NEG;
  }
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v |= code4(band[(4 * q + j) * sP + p]) << (8 * j);
    w[q] = v;
  }

  const int len = lens[p];
  int best = NEG, bi = -1, bk = -1;
  for (int i = 0; i < lq; ++i) {
    const int rdc = rd[i * sP + p];
    const int mmv = mm[i * sP + p];
    const uint32_t nxt = code4(band[(i + K) * sP + p]);
    const bool gap = (i >= c.gapbar) && (i < len - c.gapbar);
    const bool rd_n = rdc > 3;

    int e = NEG, prev_base = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t rf = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
      const int s = (rd_n || rf > 3u) ? -c.npen
                                      : (static_cast<int>(rf) == rdc ? c.ma
                                                                     : -mmv);
      const int diag = h[k] + s;
      int fn = NEG;
      if (k < K - 1) fn = max(f[k + 1] - c.rfg_ext, h[k + 1] - c.rfg_open);
      if (!gap) fn = NEG;
      const int base = max(diag, fn);
      if (k > 0) e = max(e - c.rdg_ext, prev_base - c.rdg_open);
      int hn = max(base, gap ? e : NEG);
      if (LOCAL) hn = max(hn, 0);
      prev_base = base;
      f[k] = fn;
      h[k] = hn;
    }

    int cb = NEG, ca = K - 1;
    if (LOCAL ? (i < len) : (i == len - 1)) {
      cb = h[0];
      ca = 0;
#pragma unroll
      for (int k = 1; k < K; ++k)
        if (h[k] >= cb) {
          cb = h[k];
          ca = k;
        }
    }
    if (LOCAL ? (cb >= best) : (cb > best)) {
      best = cb;
      bi = i;
      bk = ca;
    }

#pragma unroll
    for (int q = 0; q < NW - 1; ++q) w[q] = __funnelshift_r(w[q], w[q + 1], 8);
    w[NW - 1] = (w[NW - 1] >> 8) | (nxt << 24);
  }
  best_out[p] = best;
  bi_out[p] = bi;
  bk_out[p] = bk;
}

bool fits8(long long v) { return v >= -128 && v <= 127; }

template <int K, bool LOCAL>
void launch(bool fast, dim3 grid, dim3 block, cudaStream_t st,
            const int32_t* rd, const int32_t* mm, const int32_t* lens,
            const int32_t* band, int32_t* best, int32_t* bi, int32_t* bk,
            int lq, int P, Cfg c) {
  if (fast)
    banded_kernel<K, LOCAL><<<grid, block, 0, st>>>(rd, mm, lens, band, best,
                                                    bi, bk, lq, P, c);
  banded_general_kernel<K, LOCAL><<<grid, block, 0, st>>>(
      rd, mm, lens, band, best, bi, bk, lq, P, c, !fast);
}

template <int K>
void launch(bool local, bool fast, dim3 grid, dim3 block, cudaStream_t st,
            const int32_t* rd, const int32_t* mm, const int32_t* lens,
            const int32_t* band, int32_t* best, int32_t* bi, int32_t* bk,
            int lq, int P, Cfg c) {
  if (local)
    launch<K, true>(fast, grid, block, st, rd, mm, lens, band, best, bi, bk,
                    lq, P, c);
  else
    launch<K, false>(fast, grid, block, st, rd, mm, lens, band, best, bi, bk,
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
  // the byte scores of banded_kernel (design note, steps 4 and 6)
  const bool fast = fits8(ma) && fits8(-static_cast<long long>(npen)) &&
                    (!local || (lq <= 65536 && rdg_open >= 0 &&
                                rdg_ext >= 0 && rfg_open >= 0 &&
                                rfg_ext >= 0));
  const dim3 block(128);
  const dim3 grid((P + 127) / 128);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 32:
      launch<32>(local, fast, grid, block, st, rd, mm, lens, band, best, bi,
                 bk, lq, P, c);
      break;
    case 64:
      launch<64>(local, fast, grid, block, st, rd, mm, lens, band, best, bi,
                 bk, lq, P, c);
      break;
    case 128:
      launch<128>(local, fast, grid, block, st, rd, mm, lens, band, best, bi,
                  bk, lq, P, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
