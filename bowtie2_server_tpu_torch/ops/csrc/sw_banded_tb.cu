// The traceback of banded affine-gap DP problems whose end cell is known,
// one warp a problem: the fill of rows 0..bi again, with a direction byte
// a cell, then one lane's walk back from the end cell.
//
// Replaces no TPU kernel: the JAX package leaves this traceback to the host
// (bowtie2_server_tpu/ops/sw_banded.py::banded_traceback, a numpy refill of
// the band and a Python walk, one read at a time). The port ran that oracle
// on the host for every gapped or --local winner of a pack while the card
// sat idle; this kernel gives the same answers for all of a pack's winners
// in one launch. It computes exactly what banded_traceback
// (bowtie2_server_tpu_torch/ops/sw_banded.py) computes:
//   - the fill is banded_fill_numpy's, row by row: cell (i, k) scores read
//     row i against band code band[i + k] (-npen if either code is > 3, ma
//     on a match, else -mm[i]); F from (i-1, k+1); E the chain along k;
//     both barred outside the gap rows gapbar <= i < len - gapbar; --local
//     clamps H at 0; row -1 is H = 0, F = NEG;
//   - each cell's byte holds the equalities the walk tests (TB_* below);
//   - the walk is banded_traceback's, test for test and in its order.
//
// What bounds it on this card: latency, not throughput. A pack holds a few
// dozen such problems end-to-end (the reads with an indel) and a few
// thousand in --local; the fill is a few integer operations a cell on
// registers, the walk one dependent byte load a step. So the design keeps
// the walk's loads few and near, and gives the fill a warp:
//   1. One warp a problem, J = K/32 consecutive band cells a lane
//      (k = lane * J + j), H and F of the previous row in registers.
//   2. F of cell k reads (i-1, k+1): the lane's own next cell, or for its
//      last cell the next lane's first (one shuffle each of H and F).
//   3. E[k] = max(E[k-1] - rdg_ext, base[k-1] - rdg_open), E[0] = NEG: each
//      lane runs the chain over its own cells from a sentinel (lane 0 from
//      NEG), a Kogge-Stone max-scan over the lanes' results with decay
//      d * J * rdg_ext gives each lane its exact E on entry, and the lane
//      runs the chain again from it. The scan's terms are the chain's own
//      (max is exact in integers), so E is banded_fill_numpy's value; the
//      sentinel's terms lie below every real term under the scoring the
//      host admits (penalties and bonus in [0, 2^15), lq <= 8192: every
//      real term is above -2^30 + 2^25, the sentinel -2^30 and below).
//   4. The band window slides one code a row: a lane's cells take the next
//      cell's code, the last the next lane's first, and lane 31 loads the
//      one new code, band[i + K].
//   5. Direction bytes go to a scratch [P, lq, K] uint8 the wrapper
//      allocates, J bytes a lane a row, each row of a warp one contiguous
//      K-byte stretch; after __syncwarp (which orders the warp's memory
//      accesses) lane 0 walks them back from (bi, bk).
//   6. The walk writes its edits in walk order (the host reverses them),
//      four int32 each: (0, i, ref, read) a mismatch or N, (1, i + 1, ref,
//      0) a read gap, (2, i, read, 0) a read character inserted; then per
//      problem (edits, i + k, i, status). Status 1: the walk found no
//      predecessor, left the band, or ran out of edit slots (cap), or the
//      end cell lies outside the problem; the host then runs the oracle.
#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_common.cuh"

namespace {

// the tests of banded_traceback, one bit each, of cell (i, k)
constexpr int TB_DIAG = 1;   // H == H[i-1, k] + s (H[-1] = 0)
constexpr int TB_HE = 2;     // H == E
constexpr int TB_HF = 4;     // H == F
constexpr int TB_EX = 8;     // k >= 1 and E == E[i, k-1] - rdg_ext
constexpr int TB_FX = 16;    // i >= 1, k + 1 < K and F == F[i-1, k+1] - rfg_ext
constexpr int TB_Z = 32;     // --local and H == 0

constexpr int SENT = -(1 << 30);   // a lane's chain before any term (step 3)
constexpr unsigned FULL = 0xFFFFFFFFu;

template <int K, bool LOCAL>
__global__ void __launch_bounds__(128)
traceback_kernel(const int32_t* __restrict__ rd,
                 const int32_t* __restrict__ mm,
                 const int32_t* __restrict__ lens,
                 const int32_t* __restrict__ band,
                 const int32_t* __restrict__ end_i,
                 const int32_t* __restrict__ end_k,
                 uint8_t* __restrict__ dirs, int32_t* __restrict__ edits,
                 int32_t* __restrict__ meta, int lq, int P, int cap, Cfg c) {
  static_assert(K % 32 == 0 && K <= 128, "K: 32, 64 or 128");
  constexpr int J = K / 32;
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= P) return;   // a whole warp: P is checked per warp
  const size_t sP = static_cast<size_t>(P);
  const int rl = lens[p];
  const int bi = end_i[p], bk = end_k[p];
  int32_t* out = meta + 4 * static_cast<size_t>(p);
  if (bi < 0 || bi >= min(rl, lq) || bk < 0 || bk >= K) {
    if (lane == 0) {
      out[0] = 0;
      out[1] = out[2] = 0;
      out[3] = 1;
    }
    return;
  }
  uint8_t* drow = dirs + static_cast<size_t>(p) * lq * K;
  const int k0 = lane * J;

  int h[J], f[J], cd[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    h[j] = 0;      // H[-1] = 0
    f[j] = NEG;    // F[-1] = NEG
    cd[j] = band[(k0 + j) * sP + p];
  }
  for (int i = 0; i <= bi; ++i) {
    const int rdc = rd[i * sP + p];
    const int mmv = mm[i * sP + p];
    const bool gap = i >= c.gapbar && i < rl - c.gapbar;
    // (i-1, k+1) of the lane's last cell: the next lane's first
    const int hn = __shfl_down_sync(FULL, h[0], 1);
    const int fnx = __shfl_down_sync(FULL, f[0], 1);
    int diag[J], fv[J], base[J], fx[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int rfc = cd[j];
      const int s = (rdc > 3 || rfc > 3) ? -c.npen
                                         : (rdc == rfc ? c.ma : -mmv);
      diag[j] = h[j] + s;
      const int hu = j < J - 1 ? h[j + 1] : hn;
      const int fu = j < J - 1 ? f[j + 1] : fnx;
      const bool edge = k0 + j == K - 1;
      const int fval =
          gap && !edge ? __viaddmax_s32(fu, -c.rfg_ext, hu - c.rfg_open) : NEG;
      fv[j] = fval;
      fx[j] = i >= 1 && !edge && fval == fu - c.rfg_ext;
      base[j] = max(diag[j], fval);
    }
    int e[J];
    if (gap) {   // warp-uniform: gap depends on i and rl only
      int run = lane == 0 ? NEG : SENT;
#pragma unroll
      for (int j = 0; j < J; ++j)
        run = __viaddmax_s32(run, -c.rdg_ext, base[j] - c.rdg_open);
      // run: E at k0 + J from this lane's cells (and NEG on lane 0)
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, run, d);
        if (lane >= d) run = max(run, y - d * J * c.rdg_ext);
      }
      int cin = __shfl_up_sync(FULL, run, 1);
      if (lane == 0) cin = NEG;   // E[0] = NEG
      e[0] = cin;
#pragma unroll
      for (int j = 1; j < J; ++j)
        e[j] = __viaddmax_s32(e[j - 1], -c.rdg_ext, base[j - 1] - c.rdg_open);
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) e[j] = NEG;
    }
    const int eprev = __shfl_up_sync(FULL, e[J - 1], 1);
    uint32_t bytes = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      // H before the --local clamp; each test against the clamped H is
      // made on it: H == x holds when h0 == x and, in --local, x >= 0
      // (tested on the clamped value itself, the H100 build set H == E
      // on --local cells with H > 0 and E = NEG)
      const int h0 = max(base[j], e[j]);
      const int ep = j > 0 ? e[j - 1] : eprev;
      int b = (h0 == diag[j] && (!LOCAL || diag[j] >= 0) ? TB_DIAG : 0) |
              (h0 == e[j] && (!LOCAL || e[j] >= 0) ? TB_HE : 0) |
              (h0 == fv[j] && (!LOCAL || fv[j] >= 0) ? TB_HF : 0) |
              (fx[j] ? TB_FX : 0);
      if (k0 + j >= 1 && e[j] == ep - c.rdg_ext) b |= TB_EX;
      if (LOCAL && h0 <= 0) b |= TB_Z;   // the clamped H is 0
      bytes |= static_cast<uint32_t>(b) << (8 * j);
      h[j] = LOCAL ? max(h0, 0) : h0;
      f[j] = fv[j];
    }
    uint8_t* dst = drow + static_cast<size_t>(i) * K + k0;
    if constexpr (J == 4)
      *reinterpret_cast<uint32_t*>(dst) = bytes;
    else if constexpr (J == 2)
      *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(bytes);
    else
      *dst = static_cast<uint8_t>(bytes);
    // slide the window one code (step 4)
    const int cnext = __shfl_down_sync(FULL, cd[0], 1);
#pragma unroll
    for (int j = 0; j < J - 1; ++j) cd[j] = cd[j + 1];
    cd[J - 1] = cnext;
    if (lane == 31 && i + 1 <= bi) cd[J - 1] = band[(i + K) * sP + p];
  }
  __syncwarp();
  if (lane != 0) return;

  // the walk (banded_traceback's, in its order)
  int32_t* ed = edits + static_cast<size_t>(p) * cap * 4;
  int i = bi, k = bk, n = 0, status = 0;
  int state = 0;   // 0: H, 1: E (read gap), 2: F (read char inserted)
  for (;;) {
    if (k < 0 || k >= K) {
      status = 1;
      break;
    }
    const int d = drow[static_cast<size_t>(i) * K + k];
    if (state == 0) {
      if (LOCAL && (d & TB_Z)) {
        if (d & TB_HE) {
          state = 1;
          continue;
        }
        if (d & TB_HF) {
          state = 2;
          continue;
        }
        i += 1;   // a zero-restart cell: the alignment starts at i + 1
        break;
      }
      if (d & TB_DIAG) {
        const int rdc = rd[i * sP + p];
        const int rfc = band[(i + k) * sP + p];
        if (rdc != rfc || rdc > 3 || rfc > 3) {
          if (n == cap) {
            status = 1;
            break;
          }
          int32_t* e4 = ed + 4 * n++;
          e4[0] = 0;
          e4[1] = i;
          e4[2] = rfc;
          e4[3] = rdc;
        }
        if (--i < 0) {
          i = 0;
          break;
        }
      } else if (d & TB_HE) {
        state = 1;
      } else if (d & TB_HF) {
        state = 2;
      } else {
        status = 1;
        break;
      }
    } else {
      if (n == cap) {
        status = 1;
        break;
      }
      int32_t* e4 = ed + 4 * n++;
      if (state == 1) {   // ref char band[i + k] deleted, keyed at i + 1
        e4[0] = 1;
        e4[1] = i + 1;
        e4[2] = band[(i + k) * sP + p];
        e4[3] = 0;
        const bool ext = d & TB_EX;
        k -= 1;
        if (!ext) state = 0;
      } else {            // read char i inserted
        e4[0] = 2;
        e4[1] = i;
        e4[2] = rd[i * sP + p];
        e4[3] = 0;
        const bool ext = d & TB_FX;
        i -= 1;
        k += 1;
        if (i < 0) {
          i = 0;
          break;
        }
        if (!ext) state = 0;
      }
    }
  }
  out[0] = n;
  out[1] = i + k;
  out[2] = i;
  out[3] = status;
}

template <int K>
void launch(bool local, dim3 grid, dim3 block, cudaStream_t st,
            const int32_t* rd, const int32_t* mm, const int32_t* lens,
            const int32_t* band, const int32_t* end_i, const int32_t* end_k,
            uint8_t* dirs, int32_t* edits, int32_t* meta, int lq, int P,
            int cap, Cfg c) {
  if (local)
    traceback_kernel<K, true><<<grid, block, 0, st>>>(
        rd, mm, lens, band, end_i, end_k, dirs, edits, meta, lq, P, cap, c);
  else
    traceback_kernel<K, false><<<grid, block, 0, st>>>(
        rd, mm, lens, band, end_i, end_k, dirs, edits, meta, lq, P, cap, c);
}

}  // namespace

// rd, mm: [lq, P]; lens, end_i, end_k: [P]; band: [lq + K, P] (int32,
// contiguous, on the device; codes non-negative); dirs: [P, lq, K] uint8
// scratch; edits: [P, cap, 4] int32; meta: [P, 4] int32. K: 32, 64 or
// 128. Returns cudaGetLastError() after the launch.
extern "C" int bt2_sw_banded_tb(const int32_t* rd, const int32_t* mm,
                                const int32_t* lens, const int32_t* band,
                                const int32_t* end_i, const int32_t* end_k,
                                uint8_t* dirs, int32_t* edits, int32_t* meta,
                                int lq, int P, int K, int cap, int ma,
                                int npen, int rdg_open, int rdg_ext,
                                int rfg_open, int rfg_ext, int gapbar,
                                int local, void* stream) {
  if (P <= 0) return 0;
  const Cfg c{ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar};
  const dim3 block(128);   // four problems a block
  const dim3 grid((P + 3) / 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 32:
      launch<32>(local, grid, block, st, rd, mm, lens, band, end_i, end_k,
                 dirs, edits, meta, lq, P, cap, c);
      break;
    case 64:
      launch<64>(local, grid, block, st, rd, mm, lens, band, end_i, end_k,
                 dirs, edits, meta, lq, P, cap, c);
      break;
    case 128:
      launch<128>(local, grid, block, st, rd, mm, lens, band, end_i, end_k,
                  dirs, edits, meta, lq, P, cap, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
