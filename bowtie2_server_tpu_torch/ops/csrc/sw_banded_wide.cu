// Banded affine-gap DP for wide bands (K = 256, 512, 1024), one warp per
// problem. It also takes K = 128, which the wrapper routes to the register
// kernel; that width is built so that the two kernels can be timed side by
// side at the band where the register kernel spills.
//
// Replaces, for the band widths that band_for gives at --dpad 32..255, the
// TPU kernel bowtie2_server_tpu/ops/sw_banded.py::_banded_kernel (launched
// through _pallas_banded), which takes any K. It computes the same function
// as that kernel, as the plain torch version banded_tile_torch
// (bowtie2_server_tpu_torch/ops/sw_banded.py) and as the register kernel of
// sw_banded.cu, bit for bit (see that file for the recurrence and the tie
// rules). The register kernel cannot take these widths: one thread holding
// h[K] and f[K] needs 2K registers, and it already spills at K = 128.
//
// What bounds it on this card: int32 ALU work (about 20 integer operations
// per cell, of which 4 are the E chain run twice) and, per row, 12 warp
// shuffles plus one load of a read code, a penalty and one band code.
//
// What the design does about it: a warp owns one problem. Lane l owns the
// J = K/32 contiguous band cells k = l*J .. l*J+J-1 of H and F in registers
// (J = 8, 16, 32; every loop over j unrolled) and their J reference codes,
// byte-packed four to a register. Per row:
//   - F at (i, k) reads (i-1, k+1): inside the lane from its own registers,
//     at the lane's last cell from the next lane's first cell, fetched with
//     one __shfl_down_sync of h and one of f before the row overwrites them;
//   - E is the chain e[k] = max(e[k-1] - ext, base[k-1] - open), which is
//     max-plus linear in its carry. A pass inside the lane from carry NEG
//     gives the value at the lane's last cell; a 5-step Kogge-Stone max-plus
//     scan across lanes (a carry that crosses d lanes pays d*J*ext) gives
//     each lane its true incoming carry; a second pass from that carry gives
//     e exactly. Every value that reaches H is a max over finite terms, far
//     from int32 overflow (NEG = -1e8, K*ext < 1e5), so the result is the
//     sequential recurrence's, which equals the TPU kernel's scan. Rows
//     where gaps are barred skip the chain (uniform across the warp);
//   - the row's arg-max is a butterfly reduction that prefers the larger k
//     on equal scores;
//   - the window slides one base a row: each lane shifts its codes down by
//     one, takes the next lane's first code, and lane 31 loads the one new
//     band code.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -100000000;   // NEG_INF of ops/sw.py
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Cfg {
  int ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar;
};

// Reference codes are only compared with read codes 0..3 or tested for
// "> 3", so any code above 3 is stored as 4 in its byte.
__device__ __forceinline__ uint32_t code8(int c) {
  return c > 3 ? 4u : static_cast<uint32_t>(c);
}

template <int J, bool LOCAL>
__global__ void __launch_bounds__(128)
banded_wide_kernel(const int32_t* __restrict__ rd,
                   const int32_t* __restrict__ mm,
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ band,
                   int32_t* __restrict__ best_out,
                   int32_t* __restrict__ bi_out,
                   int32_t* __restrict__ bk_out, int lq, int P, Cfg c) {
  static_assert(J % 4 == 0, "J must be a multiple of 4");
  constexpr int K = 32 * J;
  constexpr int NW = J / 4;
  const int lane = threadIdx.x & 31;
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (p >= P) return;            // the whole warp: p is the warp's problem
  const size_t sP = static_cast<size_t>(P);
  const int k0 = lane * J;

  int h[J], f[J];
  uint32_t w[NW];   // byte b of w[q]: band code of row i + k0 + 4q + b
#pragma unroll
  for (int j = 0; j < J; ++j) {
    h[j] = 0;       // H[-1] = 0: the alignment may start at any column
    f[j] = NEG;
  }
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      v |= code8(band[(k0 + 4 * q + b) * sP + p]) << (8 * b);
    w[q] = v;
  }

  const int len = lens[p];
  int best = NEG, bi = -1, bk = -1;
  for (int i = 0; i < lq; ++i) {
    const int rdc = rd[i * sP + p];
    const int mmv = mm[i * sP + p];
    // the code that enters the window for row i+1 (row i+K <= lq+K-1)
    const uint32_t nxt = lane == 31 ? code8(band[(i + K) * sP + p]) : 0u;
    const bool gap = (i >= c.gapbar) && (i < len - c.gapbar);
    const bool rd_n = rdc > 3;
    // (i-1, k0+J): the next lane's first cell of the previous row
    const int h_nx = __shfl_down_sync(FULL, h[0], 1);
    const int f_nx = __shfl_down_sync(FULL, f[0], 1);

    // F and base = max(diag, F); h[j] holds base until the E pass
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const uint32_t rf = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      const int s = (rd_n || rf > 3u) ? -c.npen
                                      : (static_cast<int>(rf) == rdc ? c.ma
                                                                     : -mmv);
      const int diag = h[j] + s;
      int fn;
      if (j < J - 1)
        fn = max(f[j + 1] - c.rfg_ext, h[j + 1] - c.rfg_open);
      else
        fn = lane == 31 ? NEG : max(f_nx - c.rfg_ext, h_nx - c.rfg_open);
      if (!gap) fn = NEG;
      f[j] = fn;    // (i-1, j+1) was read above, before slot j+1 changes
      h[j] = max(diag, fn);
    }

    if (gap) {      // uniform across the warp
      // base at k0-1 (the previous lane's last cell); e[0] = NEG
      const int pb = __shfl_up_sync(FULL, h[J - 1], 1);
      const int x0 = lane == 0 ? NEG : pb - c.rdg_open;
      // the chain inside the lane from carry NEG
      int a = x0;
#pragma unroll
      for (int j = 1; j < J; ++j) a = max(a - c.rdg_ext, h[j - 1] - c.rdg_open);
      // inclusive max-plus scan of the lanes' last-cell values
      int t = a;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, t, d);
        if (lane >= d) t = max(t, u - d * J * c.rdg_ext);
      }
      int carry = __shfl_up_sync(FULL, t, 1);   // e at k0-1
      if (lane == 0) carry = NEG;
      // the chain from the true carry, then H = max(base, E)
      int e = max(carry - c.rdg_ext, x0);
      int prev_base = h[0];
      h[0] = max(h[0], e);
#pragma unroll
      for (int j = 1; j < J; ++j) {
        e = max(e - c.rdg_ext, prev_base - c.rdg_open);
        prev_base = h[j];
        h[j] = max(h[j], e);
      }
    }
    if (LOCAL) {
#pragma unroll
      for (int j = 0; j < J; ++j) h[j] = max(h[j], 0);
    }

    // row best over the scored cells; an unscored row is all NEG, whose
    // arg-max (largest k) is K-1
    int cb = NEG, ca = K - 1;
    if (LOCAL ? (i < len) : (i == len - 1)) {
      cb = h[0];
      ca = k0;
#pragma unroll
      for (int j = 1; j < J; ++j)
        if (h[j] >= cb) {
          cb = h[j];
          ca = k0 + j;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int ob = __shfl_xor_sync(FULL, cb, o);
        const int oa = __shfl_xor_sync(FULL, ca, o);
        if (ob > cb || (ob == cb && oa > ca)) {
          cb = ob;
          ca = oa;
        }
      }
    }
    if (LOCAL ? (cb >= best) : (cb > best)) {
      best = cb;
      bi = i;
      bk = ca;
    }

    // slide the window: this lane's last code comes from the next lane
    uint32_t nb = __shfl_down_sync(FULL, w[0], 1) & 0xFFu;
    if (lane == 31) nb = nxt;
#pragma unroll
    for (int q = 0; q < NW - 1; ++q) w[q] = __funnelshift_r(w[q], w[q + 1], 8);
    w[NW - 1] = (w[NW - 1] >> 8) | (nb << 24);
  }
  if (lane == 0) {
    best_out[p] = best;
    bi_out[p] = bi;
    bk_out[p] = bk;
  }
}

template <int J>
void launch(bool local, dim3 grid, dim3 block, cudaStream_t st,
            const int32_t* rd, const int32_t* mm, const int32_t* lens,
            const int32_t* band, int32_t* best, int32_t* bi, int32_t* bk,
            int lq, int P, Cfg c) {
  if (local)
    banded_wide_kernel<J, true><<<grid, block, 0, st>>>(rd, mm, lens, band,
                                                        best, bi, bk, lq, P, c);
  else
    banded_wide_kernel<J, false><<<grid, block, 0, st>>>(rd, mm, lens, band,
                                                         best, bi, bk, lq, P,
                                                         c);
}

}  // namespace

// rd, mm: [lq, P]; lens: [P]; band: [lq + K, P]; best, bi, bk: [P] (int32,
// contiguous, on the device); K in {128, 256, 512, 1024}. Returns
// cudaGetLastError() after the launch.
extern "C" int bt2_sw_banded_wide(const int32_t* rd, const int32_t* mm,
                                  const int32_t* lens, const int32_t* band,
                                  int32_t* best, int32_t* bi, int32_t* bk,
                                  int lq, int P, int K, int ma, int npen,
                                  int rdg_open, int rdg_ext, int rfg_open,
                                  int rfg_ext, int gapbar, int local,
                                  void* stream) {
  if (P <= 0) return 0;
  const Cfg c{ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar};
  const dim3 block(128);                // four warps: four problems
  const dim3 grid((P + 3) / 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 128:
      launch<4>(local, grid, block, st, rd, mm, lens, band, best, bi, bk, lq,
                P, c);
      break;
    case 256:
      launch<8>(local, grid, block, st, rd, mm, lens, band, best, bi, bk, lq,
                P, c);
      break;
    case 512:
      launch<16>(local, grid, block, st, rd, mm, lens, band, best, bi, bk, lq,
                 P, c);
      break;
    case 1024:
      launch<32>(local, grid, block, st, rd, mm, lens, band, best, bi, bk, lq,
                 P, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
