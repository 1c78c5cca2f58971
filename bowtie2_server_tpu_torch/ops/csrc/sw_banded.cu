// Banded affine-gap DP in diagonal band coordinates, one thread per problem.
//
// Replaces the TPU kernel bowtie2_server_tpu/ops/sw_banded.py::_banded_kernel
// (launched through _pallas_banded). It computes the same function as that
// kernel and as the plain torch version banded_tile_torch
// (bowtie2_server_tpu_torch/ops/sw_banded.py), bit for bit:
//   - cell (i, k) scores read row i against band code band[i + k];
//   - F comes from (i-1, k+1), E is the chain along k, both barred in the
//     first and last `gapbar` rows; --local clamps H at 0;
//   - the running best per problem takes ties at the larger k; end-to-end
//     updates on a strictly greater score in row len-1 only, local on a
//     greater-or-equal score in any row < len.
//
// What bounds it on this card: int32 ALU work (about 12 integer operations
// per cell) and the dependent chain along k (E) and along i (H, F). There
// are no matrix products and few bytes: each row reads one read code, one
// penalty and one new band code per problem.
//
// What the design does about it: one thread owns one problem for the whole
// band, so the chains stay in registers and need no synchronisation. The
// H and F rows (K int32 each) and the K-base reference window live in
// registers with every loop over k fully unrolled (K is a template
// parameter: 32, 64, 128). The window is byte-packed, four codes to a
// register, and slides by one base per row with funnel shifts, so each row
// loads exactly one new band code. Inputs are [rows, P] with P innermost,
// so the loads of the 32 threads of a warp are coalesced. E is the
// sequential recurrence e[k] = max(e[k-1] - ext, base[k-1] - open), which
// equals the Kogge-Stone max-scan of the TPU kernel exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -100000000;   // NEG_INF of ops/sw.py

struct Cfg {
  int ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar;
};

// Reference codes are only ever compared with read codes 0..3 or tested
// for "> 3", so any code above 3 is stored as 4 in its byte.
__device__ __forceinline__ uint32_t code8(int c) {
  return c > 3 ? 4u : static_cast<uint32_t>(c);
}

template <int K, bool LOCAL>
__global__ void __launch_bounds__(128)
banded_kernel(const int32_t* __restrict__ rd, const int32_t* __restrict__ mm,
              const int32_t* __restrict__ lens,
              const int32_t* __restrict__ band,
              int32_t* __restrict__ best_out, int32_t* __restrict__ bi_out,
              int32_t* __restrict__ bk_out, int lq, int P, Cfg c) {
  static_assert(K % 4 == 0, "K must be a multiple of 4");
  constexpr int NW = K / 4;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t sP = static_cast<size_t>(P);

  int h[K], f[K];
  uint32_t w[NW];   // byte j of w[q]: band code of row i + 4q + j
#pragma unroll
  for (int k = 0; k < K; ++k) {
    h[k] = 0;       // H[-1] = 0: the alignment may start at any column
    f[k] = NEG;
  }
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v |= code8(band[(4 * q + j) * sP + p]) << (8 * j);
    w[q] = v;
  }

  const int len = lens[p];
  int best = NEG, bi = -1, bk = -1;
  for (int i = 0; i < lq; ++i) {
    const int rdc = rd[i * sP + p];
    const int mmv = mm[i * sP + p];
    // the code that enters the window for row i+1 (row i+K <= lq+K-1)
    const uint32_t nxt = code8(band[(i + K) * sP + p]);
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
      f[k] = fn;   // (i-1, k+1) is read before (i, k) overwrites slot k
      h[k] = hn;
    }

    // row best over the scored cells; an unscored row is all NEG, whose
    // arg-max (largest k) is K-1
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

template <int K>
void launch(bool local, dim3 grid, dim3 block, cudaStream_t st,
            const int32_t* rd, const int32_t* mm, const int32_t* lens,
            const int32_t* band, int32_t* best, int32_t* bi, int32_t* bk,
            int lq, int P, Cfg c) {
  if (local)
    banded_kernel<K, true><<<grid, block, 0, st>>>(rd, mm, lens, band, best,
                                                   bi, bk, lq, P, c);
  else
    banded_kernel<K, false><<<grid, block, 0, st>>>(rd, mm, lens, band, best,
                                                    bi, bk, lq, P, c);
}

}  // namespace

// rd, mm: [lq, P]; lens: [P]; band: [lq + K, P]; best, bi, bk: [P] (int32,
// contiguous, on the device). Returns cudaGetLastError() after the launch.
extern "C" int bt2_sw_banded(const int32_t* rd, const int32_t* mm,
                             const int32_t* lens, const int32_t* band,
                             int32_t* best, int32_t* bi, int32_t* bk, int lq,
                             int P, int K, int ma, int npen, int rdg_open,
                             int rdg_ext, int rfg_open, int rfg_ext,
                             int gapbar, int local, void* stream) {
  if (P <= 0) return 0;
  const Cfg c{ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar};
  const dim3 block(128);
  const dim3 grid((P + 127) / 128);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 32:
      launch<32>(local, grid, block, st, rd, mm, lens, band, best, bi, bk, lq,
                 P, c);
      break;
    case 64:
      launch<64>(local, grid, block, st, rd, mm, lens, band, best, bi, bk, lq,
                 P, c);
      break;
    case 128:
      launch<128>(local, grid, block, st, rd, mm, lens, band, best, bi, bk,
                  lq, P, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
