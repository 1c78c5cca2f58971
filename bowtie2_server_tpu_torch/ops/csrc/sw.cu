// Full-rectangle affine-gap DP, one warp per problem, read rows spread over
// the lanes and walked as a wavefront.
//
// Replaces the TPU kernel bowtie2_server_tpu/ops/sw.py::_sw_kernel
// (launched through _pallas_engine / sw_align_batch). It computes the same
// function as that kernel and as the plain torch version sw_tile_torch
// (bowtie2_server_tpu_torch/ops/sw.py), bit for bit:
//   - the DP walks reference columns j < lc, each column over read rows
//     i < lq_pad; E is the horizontal carry from column j-1;
//   - F runs down the rows of a column from H-without-F, with sources
//     limited to rows >= gapbar-1 so a gap cannot jump the barred prefix;
//     gap moves are barred in the first and last `gapbar` rows;
//   - --local clamps H at 0 and starts every row from 0;
//   - the running best is masked by reflens; ties: local takes >= and the
//     larger row, end-to-end takes > and the smallest row (in row len-1,
//     the only scored row).
//
// What bounds it on this card: int32 ALU work (about 15 integer operations
// a cell, many fused by ptxas into DPX add-and-max instructions) and the
// dependent chains: F down each column, H and E along each row from one
// column to the next. No matrix products, and few bytes (each problem's
// inputs are read once). The paths launch it on a few hundred problems
// (about 210 run-boundary candidates a batch on the unpaired path, about
// 330 mate-rescue windows on the paired path), so it must spread a few
// hundred problems over 132 SMs and keep each problem's serial chain short.
//
// What the design does about it:
//   - One warp owns one problem; a block holds WARPS warps, so a few hundred
//     problems make a few hundred warps on all SMs. Lane l owns the J
//     consecutive read rows [l*J, l*J+J) (J = 4, 6, 8, 16, 32 for Lq_pad up
//     to 128, 192, 256, 512, 1024). Their H, E, read codes, mismatch
//     penalties and row flags live in registers: every loop over a lane's
//     rows is unrolled, so nothing is indexed at run time.
//   - Wavefront: at step t lane l computes column j = t - l for its rows,
//     top to bottom, with exactly the sequential recurrences of the column
//     walk. It needs three values of the lane above at column j, which that
//     lane computed at step t-1: the F carry and F source (H-without-F) of
//     its last row, and its last row's H, which becomes this lane's
//     diagonal at column j+1. Three __shfl_up_sync a step carry them. Lane
//     0 starts each column from row -1: diagonal 0, F and its source NEG,
//     and no F update in row 0. No scan is needed, so the result equals
//     the sequential walk by construction. A problem takes ncols + L - 1
//     steps, with ncols = min(reflens, lc) and L the lanes that own one of
//     its first min(len, Lq_pad) rows: columns at or past reflens and rows
//     at or past len influence no scored cell (values flow only right and
//     down), so they are never computed.
//   - Reference codes: lane l needs the code of column t - l, which lane
//     l-1 held at step t-1, so the code moves down one lane a step with the
//     same shuffle. Lane 0 takes column t from a register chunk: the 32
//     lanes load the codes of 32 columns together, one chunk ahead of use,
//     and a __shfl_sync broadcasts code t. No global load sits on a step's
//     dependent path.
//   - Best cell, as one reduction over the problem's cells instead of the
//     column rule. Each lane walks its cells in increasing (j, i) order and
//     keeps a running best; a warp butterfly then takes the lexicographic
//     maximum of (best, j, i) over the lanes. Why this equals the column
//     rule (best NEG, bi = bj = -1 at the start; per column cb over the
//     scored rows, starting at INT_MIN; then "cb > best" or "cb >= best"
//     for j < reflens):
//       * end-to-end: only row len-1 is scored, and only when it is a row of
//         the tile (0 <= len-1 < lq_pad); otherwise cb ends at NEG and
//         "NEG > best" never holds, so the answer is (NEG, -1, -1). With the
//         row present, cb is that row's h whenever h > NEG (an unscored row
//         gives NEG, which h beats), and a column with h <= NEG cannot pass
//         "cb > best >= NEG". So the answer is the first j < ncols with the
//         largest h(len-1, j), if that h is above NEG: the running best of
//         the one lane that owns row len-1, updated on a strict ">" from
//         NEG in increasing j. Scores at or below NEG (H can fall below NEG
//         through hdiag + s with hdiag = NEG) are never taken, as there.
//         Every other lane keeps (NEG, -1, -1), which the butterfly drops.
//       * local: H >= 0 after the clamp, so with len >= 1 every column has a
//         scored row (row 0) and cb >= 0 > NEG. The column rule takes the
//         largest h, then the larger row in the column (">=" down the rows),
//         then the later column (">=" along j): the lexicographic maximum of
//         (h, j, i) over the cells with i < min(len, lq_pad), j < ncols. Each
//         lane's ">=" running best over its cells in increasing (j, i) order
//         is that maximum over its own cells, and the butterfly, ordered by
//         (best, j, i), is the maximum over all lanes.
//       * local with len <= 0: no row is scored, every column's cb is NEG
//         with ca = lq_pad-1 (">=" over all-NEG rows keeps the last row),
//         and "NEG >= best" holds in every column j < ncols. The column rule
//         thus gives (NEG, lq_pad-1, ncols-1) when ncols >= 1, (NEG, -1, -1)
//         otherwise. The reduction would give (NEG, -1, -1), so this case
//         is written out literally.
//       * no columns (ncols = 0): (NEG, -1, -1) in both rules.
//     All-N reads and len = 1 need no case of their own: they only change
//     the scores, which both rules see the same.
//   - Ptxas fuses the add-and-max pairs of the recurrences into DPX
//     VIADDMNMX, as in the banded kernels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -100000000;   // NEG_INF of ops/sw.py
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 2;          // problems a block

struct Cfg {
  int ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar;
};

template <int J, bool LOCAL>
__global__ void __launch_bounds__(32 * WARPS)
rect_warp_kernel(const int32_t* __restrict__ rd,
                 const int32_t* __restrict__ mm,
                 const int32_t* __restrict__ lens,
                 const int32_t* __restrict__ ref,
                 const int32_t* __restrict__ reflens,
                 int32_t* __restrict__ best_out, int32_t* __restrict__ bi_out,
                 int32_t* __restrict__ bj_out, int lq, int lc, int P, Cfg c) {
  const int lane = threadIdx.x & 31;
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (p >= P) return;            // the whole warp: p is the warp's problem
  const size_t sP = static_cast<size_t>(P);
  const int i0 = lane * J;
  const int len = lens[p];
  const int ncols = min(max(reflens[p], 0), lc);
  const int rows = min(max(len, 0), lq);   // rows that reach a scored cell
  const int live = (rows + J - 1) / J;     // lanes that own one of them

  // this lane's rows: H and E of the previous column, read code, mismatch
  // score (-npen for an N), and the row flags
  int H[J], E[J], rdc[J], mis[J];
  bool gap[J], src[J], scored[J];
#pragma unroll
  for (int r = 0; r < J; ++r) {
    const int i = i0 + r;
    const bool row = i < rows;
    rdc[r] = row ? rd[i * sP + p] : 5;
    mis[r] = rdc[r] > 3 ? -c.npen : (row ? -mm[i * sP + p] : 0);
    gap[r] = (i >= c.gapbar) && (i < len - c.gapbar);
    src[r] = i >= c.gapbar - 1;
    scored[r] = row && (LOCAL ? (i < len) : (i == len - 1));
    H[r] = LOCAL ? 0 : NEG;
    E[r] = NEG;
  }

  int best = NEG, bi = -1, bj = -1;
  // what this lane hands the lane below after its last computed column: F
  // carry, F source and H of its last row (H starts as column -1's)
  int f_pub = NEG, s_pub = NEG, h_pub = LOCAL ? 0 : NEG;
  int diag = LOCAL ? 0 : NEG;    // H of the row above at column j-1
  int rc = 4;                    // reference code of this lane's column
  // reference codes, 32 columns a chunk: lane k holds column 32*chunk + k
  int cur = lane < ncols ? ref[lane * sP + p] : 4;
  int nxt = 32 + lane < ncols ? ref[(32 + lane) * sP + p] : 4;
  const int steps = ncols > 0 && live > 0 ? ncols + live - 1 : 0;
  for (int t = 0; t < steps; ++t) {
    if ((t & 31) == 0 && t > 0) {
      cur = nxt;
      const int col = t + 32 + lane;
      nxt = col < ncols ? ref[col * sP + p] : 4;
    }
    const int bc = __shfl_sync(FULL, cur, t & 31);
    const int rc_up = __shfl_up_sync(FULL, rc, 1);
    const int f_in = __shfl_up_sync(FULL, f_pub, 1);
    const int s_in = __shfl_up_sync(FULL, s_pub, 1);
    const int h_in = __shfl_up_sync(FULL, h_pub, 1);
    rc = lane == 0 ? bc : rc_up;
    const int j = t - lane;
    if (j >= 0 && j < ncols && lane < live) {
      const bool rc_n = rc > 3;
      int hd = lane == 0 ? 0 : diag;     // row -1 is 0
      int f = lane == 0 ? NEG : f_in;    // F before the gap mask
      int ps = s_in;                     // F source of the row above
#pragma unroll
      for (int r = 0; r < J; ++r) {
        const int s = rc_n ? -c.npen : (rdc[r] == rc ? c.ma : mis[r]);
        const int hp = H[r];
        const int e = gap[r] ? max(E[r] - c.rdg_ext, hp - c.rdg_open) : NEG;
        const int hnf = max(hd + s, e);
        if (r > 0 || lane > 0) f = max(f - c.rfg_ext, ps - c.rfg_open);
        int h = max(hnf, gap[r] ? f : NEG);
        if (LOCAL) h = max(h, 0);
        ps = src[r] ? hnf : NEG;
        hd = hp;
        H[r] = h;
        E[r] = e;
        if (scored[r] && (LOCAL ? (h >= best) : (h > best))) {
          best = h;
          bi = i0 + r;
          bj = j;
        }
      }
      f_pub = f;
      s_pub = ps;
      h_pub = H[J - 1];
    }
    diag = h_in;
  }

  // lexicographic maximum of (best, bj, bi) over the lanes
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ob = __shfl_xor_sync(FULL, best, o);
    const int oj = __shfl_xor_sync(FULL, bj, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (ob > best || (ob == best && (oj > bj || (oj == bj && oi > bi)))) {
      best = ob;
      bj = oj;
      bi = oi;
    }
  }
  if (lane == 0) {
    if (LOCAL && len <= 0 && ncols > 0) {   // no scored row: see the note
      bi = lq - 1;
      bj = ncols - 1;
    }
    best_out[p] = best;
    bi_out[p] = bi;
    bj_out[p] = bj;
  }
}

template <int J>
void launch(bool local, dim3 grid, dim3 block, cudaStream_t st,
            const int32_t* rd, const int32_t* mm, const int32_t* lens,
            const int32_t* ref, const int32_t* reflens, int32_t* best,
            int32_t* bi, int32_t* bj, int lq, int lc, int P, Cfg c) {
  if (local)
    rect_warp_kernel<J, true><<<grid, block, 0, st>>>(
        rd, mm, lens, ref, reflens, best, bi, bj, lq, lc, P, c);
  else
    rect_warp_kernel<J, false><<<grid, block, 0, st>>>(
        rd, mm, lens, ref, reflens, best, bi, bj, lq, lc, P, c);
}

}  // namespace

// rd, mm: [lq_pad, P]; lens, reflens: [P]; ref: [lc, P]; best, bi, bj: [P]
// (int32, contiguous, on the device). lq_pad <= 1024. Returns
// cudaGetLastError() after the launch.
extern "C" int bt2_sw(const int32_t* rd, const int32_t* mm,
                      const int32_t* lens, const int32_t* ref,
                      const int32_t* reflens, int32_t* best, int32_t* bi,
                      int32_t* bj, int lq, int lc, int P, int ma, int npen,
                      int rdg_open, int rdg_ext, int rfg_open, int rfg_ext,
                      int gapbar, int local, void* stream) {
  if (P <= 0) return 0;
  const Cfg c{ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar};
  const dim3 block(32 * WARPS);
  const dim3 grid((P + WARPS - 1) / WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lq <= 128)
    launch<4>(local, grid, block, st, rd, mm, lens, ref, reflens, best, bi,
              bj, lq, lc, P, c);
  else if (lq <= 192)
    launch<6>(local, grid, block, st, rd, mm, lens, ref, reflens, best, bi,
              bj, lq, lc, P, c);
  else if (lq <= 256)
    launch<8>(local, grid, block, st, rd, mm, lens, ref, reflens, best, bi,
              bj, lq, lc, P, c);
  else if (lq <= 512)
    launch<16>(local, grid, block, st, rd, mm, lens, ref, reflens, best, bi,
               bj, lq, lc, P, c);
  else if (lq <= 1024)
    launch<32>(local, grid, block, st, rd, mm, lens, ref, reflens, best, bi,
               bj, lq, lc, P, c);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
