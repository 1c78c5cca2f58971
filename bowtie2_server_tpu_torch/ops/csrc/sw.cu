// Full-rectangle affine-gap DP, one thread per problem.
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
// per cell) and the dependent chains: F down each column, H and E along
// the row from one column to the next. No matrix products.
//
// What the design does about it: one thread owns one problem, so both
// chains are sequential in one thread and need no synchronisation or
// scan. F is the sequential recurrence f[i] = max(f[i-1] - ext,
// src[i-1] - open), which equals the TPU kernel's Kogge-Stone max-scan.
// The H and E columns (lq_pad int32 each) live in the thread's local memory
// (capacity LQ, a template parameter: 128, 256, 512, 1024); read codes and
// penalties are re-read from [rows, P] inputs, coalesced across the warp
// and cached in L1/L2. A simple first design: faster layouts (a warp per
// problem, anti-diagonal wavefronts, DPX max3) are for later work.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int NEG = -100000000;   // NEG_INF of ops/sw.py

struct Cfg {
  int ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar;
};

template <int LQ, bool LOCAL>
__global__ void __launch_bounds__(128)
rect_kernel(const int32_t* __restrict__ rd, const int32_t* __restrict__ mm,
            const int32_t* __restrict__ lens, const int32_t* __restrict__ ref,
            const int32_t* __restrict__ reflens, int32_t* __restrict__ best_out,
            int32_t* __restrict__ bi_out, int32_t* __restrict__ bj_out,
            int lq, int lc, int P, Cfg c) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t sP = static_cast<size_t>(P);

  int H[LQ], E[LQ];
  for (int i = 0; i < lq; ++i) {
    H[i] = LOCAL ? 0 : NEG;
    E[i] = NEG;
  }
  const int len = lens[p];
  const int rlen = reflens[p];
  int best = NEG, bi = -1, bj = -1;
  for (int j = 0; j < lc; ++j) {
    const int rc = ref[j * sP + p];
    int hdiag = 0;      // previous column's H[i-1]; row -1 is 0
    int fs = NEG;       // F before the gap mask, carried down the rows
    int psrc = NEG;     // F source of the previous row (H-without-F)
    int cb = INT_MIN, ca = -1;
    for (int i = 0; i < lq; ++i) {
      const int rdc = rd[i * sP + p];
      const int s = (rdc > 3 || rc > 3) ? -c.npen
                                        : (rdc == rc ? c.ma : -mm[i * sP + p]);
      const bool gap = (i >= c.gapbar) && (i < len - c.gapbar);
      const int hp = H[i];
      int e = max(E[i] - c.rdg_ext, hp - c.rdg_open);
      if (!gap) e = NEG;
      const int hnf = max(hdiag + s, e);
      if (i > 0) fs = max(fs - c.rfg_ext, psrc - c.rfg_open);
      int h = max(hnf, gap ? fs : NEG);
      if (LOCAL) h = max(h, 0);
      psrc = (i >= c.gapbar - 1) ? hnf : NEG;
      hdiag = hp;
      H[i] = h;
      E[i] = e;
      const int sc = (LOCAL ? (i < len) : (i == len - 1)) ? h : NEG;
      if (LOCAL ? (sc >= cb) : (sc > cb)) {
        cb = sc;
        ca = i;
      }
    }
    if (j < rlen && (LOCAL ? (cb >= best) : (cb > best))) {
      best = cb;
      bi = ca;
      bj = j;
    }
  }
  best_out[p] = best;
  bi_out[p] = bi;
  bj_out[p] = bj;
}

template <int LQ>
void launch(bool local, dim3 grid, dim3 block, cudaStream_t st,
            const int32_t* rd, const int32_t* mm, const int32_t* lens,
            const int32_t* ref, const int32_t* reflens, int32_t* best,
            int32_t* bi, int32_t* bj, int lq, int lc, int P, Cfg c) {
  if (local)
    rect_kernel<LQ, true><<<grid, block, 0, st>>>(rd, mm, lens, ref, reflens,
                                                  best, bi, bj, lq, lc, P, c);
  else
    rect_kernel<LQ, false><<<grid, block, 0, st>>>(rd, mm, lens, ref, reflens,
                                                   best, bi, bj, lq, lc, P, c);
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
  const dim3 block(128);
  const dim3 grid((P + 127) / 128);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lq <= 128)
    launch<128>(local, grid, block, st, rd, mm, lens, ref, reflens, best, bi,
                bj, lq, lc, P, c);
  else if (lq <= 256)
    launch<256>(local, grid, block, st, rd, mm, lens, ref, reflens, best, bi,
                bj, lq, lc, P, c);
  else if (lq <= 512)
    launch<512>(local, grid, block, st, rd, mm, lens, ref, reflens, best, bi,
                bj, lq, lc, P, c);
  else if (lq <= 1024)
    launch<1024>(local, grid, block, st, rd, mm, lens, ref, reflens, best, bi,
                 bj, lq, lc, P, c);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
