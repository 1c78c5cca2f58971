// FM-index LF walks: one thread a lane walks its whole chain of
// backward-search steps in one launch.
//
// Replaces the plain-jnp LF chains of bowtie2_server_tpu/ops/fm.py, which
// the JAX package left to XLA (a lax.fori_loop of lf_step, fm.py:240, one
// while-loop per pass; occ counted with population_count, fm.py:191):
// backward_search_body (:360, with and without the ftab jump),
// backward_search_record_body (:467) and one_mm_phase1_body (:579) become
// the three modes of fm_walk_kernel; lf_step on explicit characters (the
// 1-mismatch branch grid, one_mm_phase0_body :531) is fm_lf_step_kernel.
// Each computes exactly what the plain torch version does
// (bowtie2_server_tpu_torch/ops/fm.py: lf_step_torch and the *_torch
// walks), lane by lane:
//
//   occ(c, row) = side[row/64].cnt[c] + rem - popc(nonmatch & first-rem)
//                 - (c == 0 && row/64*64 <= primary < row)
//     nonmatch  = (x | x >> 1) & 0x55555555,  x = word ^ (c * 0x55555555)
//   LF(c, [top, bot)) = cnt[c] + occ(c, top), cnt[c] + occ(c, bot)
//   a step on c > 3 (N) or on an empty range gives (0, 0)
//
// Rows. fm_walk and fm_lf_step are templated on the row type R: int for
// small indexes (rows below 2^31; this instantiation is the kernels as they
// were before big indexes), unsigned for big ones (GRCh38-scale, rows up to
// 2^32 - 1), which the wrappers pick from DeviceFm.big. With R = unsigned
// every row value, the block (row >> 6), the comparisons (top >= bot, the
// $-hole test) and the side counts are unsigned, as the JAX package's
// uint32 rows are; the tensors carry the same 32 bits either way.
//
// Modes (a lane's characters come from its pattern row, right to left from
// its start position):
//   SEARCH: start from (0, n), or with use_ftab from the ftab range of the
//     rightmost FTAB_CHARS characters when they are all 0..3; step until the
//     position falls below 0 or the range empties; an empty result is (0, 0).
//   RECORD: start from (0, n); after each of n_steps steps write the range
//     to rec[step + 1] ([n_steps + 1, P], rec[0] = the start); a step past
//     the start keeps the range, a step on an empty range or an N makes it
//     (0, 0); no normalisation (a range may end empty as (t, t)).
//   CONT: start from the given (top, bot, pos) on pattern row rowsel[lane];
//     a lane with pos < 0 or an empty range is frozen as it is; an N makes
//     (0, 0) and moves pos once more; at most n_steps steps.
//
// What bounds it on this card: the dependent chain. A step is two 32-byte
// side fetches (two 16-byte loads each, independent of each other) whose
// addresses depend on the previous step's range, then ~40 integer
// operations; the sides of a 4 Mbp direction (~2 MB) stay in the 50 MB L2.
// So a lane's time is steps x (L2 latency + the step's arithmetic), and the
// card is filled by lanes: 65536 lanes make 2048 warps, ~16 an SM. Bytes
// (64 a lane-step from the sides, the pattern byte, 8 recorded bytes) and
// operations are far below the card's rates at these lane counts.
//
// What the design does about it: nothing is shared between lanes, so one
// thread a lane and no synchronisation; the side is read with two 16-byte
// __ldg loads; the counts are selected in registers; a finished lane stops
// fetching (SEARCH and CONT leave the loop; RECORD only writes); the record
// is laid out [step, lane] so a warp's writes are coalesced. It is a simple
// kernel: no tuning of occupancy or of the pattern reads (one byte a step,
// uncoalesced) yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FTAB_CHARS = 10;
constexpr int SEARCH = 0, RECORD = 1, CONT = 2;

template <typename R>
struct Fm {
  const uint4* side;   // [n_blocks + 1] x 2: counts, then packed words
  R cnt0, cnt1, cnt2, cnt3;
  R n;
  R primary;
};

template <typename T>
__device__ __forceinline__ T pick(int c, T a, T b, T d, T e) {
  return c == 0 ? a : c == 1 ? b : c == 2 ? d : e;
}

// bases among the first r (clamped to 0..16) of word w that are not c
__device__ __forceinline__ int nonmatch_word(unsigned w, unsigned pat,
                                             int r) {
  r = min(max(r, 0), 16);
  const unsigned x = w ^ pat;
  const unsigned nm = (x | (x >> 1)) & 0x55555555u;
  const unsigned m = r >= 16 ? 0xFFFFFFFFu : ((1u << (2 * r)) - 1u);
  return __popc(nm & m);
}

template <typename R>
__device__ __forceinline__ R occ(const Fm<R>& fm, int c, R row) {
  const R blk = row >> 6;
  const int rem = (int)(row & 63);
  const uint4 ck = __ldg(fm.side + 2 * (size_t)blk);
  const uint4 wd = __ldg(fm.side + 2 * (size_t)blk + 1);
  const R base = pick(c, (R)ck.x, (R)ck.y, (R)ck.z, (R)ck.w);
  const unsigned pat = (unsigned)c * 0x55555555u;
  const int nm = nonmatch_word(wd.x, pat, rem)
               + nonmatch_word(wd.y, pat, rem - 16)
               + nonmatch_word(wd.z, pat, rem - 32)
               + nonmatch_word(wd.w, pat, rem - 48);
  const R corr = (c == 0 && fm.primary >= (blk << 6) && fm.primary < row);
  return base + (R)(rem - nm) - corr;
}

// one LF step on a valid character (0..3) and a nonempty range
template <typename R>
__device__ __forceinline__ void lf(const Fm<R>& fm, int c, R& top, R& bot) {
  const R base = pick(c, fm.cnt0, fm.cnt1, fm.cnt2, fm.cnt3);
  const R t = occ(fm, c, top);
  const R b = occ(fm, c, bot);
  top = base + t;
  bot = base + b;
}

template <typename R>
__global__ void __launch_bounds__(256)
fm_walk_kernel(Fm<R> fm, const R* __restrict__ ftab_top,
               const R* __restrict__ ftab_bot,
               const uint8_t* __restrict__ pat, int pat_stride, int pat_rows,
               const int* __restrict__ rowsel,
               const int* __restrict__ start_pos,
               const R* __restrict__ top_in, const R* __restrict__ bot_in,
               int P, int n_steps, int mode, int use_ftab,
               R* __restrict__ top_out, R* __restrict__ bot_out,
               int* __restrict__ pos_out, R* __restrict__ rec_top,
               R* __restrict__ rec_bot) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P) return;
  int row = rowsel != nullptr ? rowsel[lane] : lane;
  row = min(max(row, 0), pat_rows - 1);
  const uint8_t* p = pat + (size_t)row * pat_stride;
  int pos = start_pos[lane];
  R top = top_in != nullptr ? top_in[lane] : (R)0;
  R bot = bot_in != nullptr ? bot_in[lane] : fm.n;
  if (use_ftab && pos >= FTAB_CHARS - 1) {
    // the rightmost FTAB_CHARS characters, big-endian in text order
    int key = 0;
    bool ok = true;
    for (int i = FTAB_CHARS - 1; i >= 0; --i) {
      const int c = p[pos - i];
      ok &= c <= 3;
      key = key * 4 + (c & 3);
    }
    if (ok) {
      top = __ldg(ftab_top + key);
      bot = __ldg(ftab_bot + key);
      pos -= FTAB_CHARS;
    }
  }
  if (mode == RECORD) {
    rec_top[lane] = top;
    rec_bot[lane] = bot;
    for (int s = 0; s < n_steps; ++s) {
      if (pos >= 0) {
        const int c = p[pos];
        if (c > 3 || top >= bot) {
          top = bot = 0;
        } else {
          lf(fm, c, top, bot);
        }
        --pos;
      }
      rec_top[(size_t)(s + 1) * P + lane] = top;
      rec_bot[(size_t)(s + 1) * P + lane] = bot;
    }
    return;
  }
  for (int s = 0; s < n_steps && pos >= 0 && top < bot; ++s) {
    const int c = p[pos];
    if (c > 3) {
      top = bot = 0;
    } else {
      lf(fm, c, top, bot);
    }
    --pos;
  }
  if (mode == SEARCH && top >= bot) top = bot = 0;
  top_out[lane] = top;
  bot_out[lane] = bot;
  pos_out[lane] = pos;
}

template <typename R>
__global__ void __launch_bounds__(256)
fm_lf_step_kernel(Fm<R> fm, const int* __restrict__ c_in,
                  const R* __restrict__ top_in,
                  const R* __restrict__ bot_in, int P,
                  R* __restrict__ top_out, R* __restrict__ bot_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P) return;
  const int c = c_in[lane];
  R top = top_in[lane];
  R bot = bot_in[lane];
  if (c > 3 || top >= bot) {
    top = bot = 0;
  } else {
    lf(fm, c, top, bot);
  }
  top_out[lane] = top;
  bot_out[lane] = bot;
}

template <typename R>
Fm<R> make_fm(const int* side, int cnt0, int cnt1, int cnt2, int cnt3, int n,
              int primary) {
  Fm<R> fm;
  fm.side = reinterpret_cast<const uint4*>(side);
  fm.cnt0 = (R)cnt0;
  fm.cnt1 = (R)cnt1;
  fm.cnt2 = (R)cnt2;
  fm.cnt3 = (R)cnt3;
  fm.n = (R)n;
  fm.primary = (R)primary;
  return fm;
}

template <typename R>
void launch_walk(const int* side, const int* ftab_top, const int* ftab_bot,
                 const uint8_t* pat, const int* rowsel, const int* start_pos,
                 const int* top_in, const int* bot_in, int* top_out,
                 int* bot_out, int* pos_out, int* rec_top, int* rec_bot,
                 int cnt0, int cnt1, int cnt2, int cnt3, int n, int primary,
                 int pat_stride, int pat_rows, int P, int n_steps, int mode,
                 int use_ftab, cudaStream_t stream) {
  const Fm<R> fm = make_fm<R>(side, cnt0, cnt1, cnt2, cnt3, n, primary);
  fm_walk_kernel<R><<<(P + 255) / 256, 256, 0, stream>>>(
      fm, reinterpret_cast<const R*>(ftab_top),
      reinterpret_cast<const R*>(ftab_bot), pat, pat_stride, pat_rows,
      rowsel, start_pos, reinterpret_cast<const R*>(top_in),
      reinterpret_cast<const R*>(bot_in), P, n_steps, mode, use_ftab,
      reinterpret_cast<R*>(top_out), reinterpret_cast<R*>(bot_out), pos_out,
      reinterpret_cast<R*>(rec_top), reinterpret_cast<R*>(rec_bot));
}

template <typename R>
void launch_lf_step(const int* side, const int* c_in, const int* top_in,
                    const int* bot_in, int* top_out, int* bot_out, int cnt0,
                    int cnt1, int cnt2, int cnt3, int n, int primary, int P,
                    cudaStream_t stream) {
  const Fm<R> fm = make_fm<R>(side, cnt0, cnt1, cnt2, cnt3, n, primary);
  fm_lf_step_kernel<R><<<(P + 255) / 256, 256, 0, stream>>>(
      fm, c_in, reinterpret_cast<const R*>(top_in),
      reinterpret_cast<const R*>(bot_in), P, reinterpret_cast<R*>(top_out),
      reinterpret_cast<R*>(bot_out));
}

// fm_resolve: the walk-left SA resolution of a big (sampled-SA) index.
// Replaces the JAX package's plain-jnp resolve_rows_body
// (bowtie2_server_tpu/ops/fm.py:260, a fixed 2^off_rate-trip masked
// fori_loop); the plain torch version is resolve_rows_body_torch in
// bowtie2_server_tpu_torch/ops/fm.py. One thread a row:
//
//   repeat: if the row's mark bit is set, offset = samp[rank + popc(mark
//     bits below the row)] + steps, done; else c = BWT[row] (from the
//     side's packed words), row = cnt[c] + occ(c, row), steps += 1
//
// It equals the JAX loop lane by lane: the JAX loop tests the mark first
// in every trip and LF-steps only a lane not yet done, so a lane's result
// is fixed at the first marked row on its chain, after the same number of
// steps; a row marked at step 0 returns its own sample; the primary row
// (SA 0, the BWT hole) is marked (0 % 2^r == 0), so the hole is never
// LF-stepped; a chain not marked within 2^off_rate trips (impossible in a
// well-formed index: the SA value falls by one a step) and a row with
// valid == 0 keep the JAX loop's initial offset, 0. The rank is clamped
// to the sample array as in the JAX loop. Arithmetic is uint32 as there.
//
// What bounds it: the dependent chain. A trip is one 16-byte mark load and
// one 32-byte side load (two 16-byte loads), all three addressed by the
// row and issued together, then ~30 integer operations to test the bit
// or take the LF step; the next trip's loads wait on this one's row. A
// chain is at most 2^off_rate - 1 = 15 steps (0 to 15, uniform over the
// sampled values, 7.5 on average). On the 4 Mbp genome the sides (2 MB)
// and marks (1 MB) of a direction stay in the 50 MB L2, so a trip costs an
// L2 round trip; on a GRCh38-scale index (1.5 GB of sides and 0.76 GB of
// marks a direction) nearly every trip misses L2 and waits on HBM. Bytes
// (48 a trip, the sample, 9 a lane) and operations are far below the
// card's rates at a batch's lane counts (~10^5), so the time is the
// longest chain's trips times the latency, with the card filled by lanes.
//
// What the design does: one thread a row, no sharing and no
// synchronisation; the mark and side loads of a trip are issued before
// either is used, so a trip pays one latency rather than two; a lane
// leaves as soon as it is marked (the JAX loop runs every trip for every
// lane). It is a simple kernel: a warp's lanes finish at different trips
// (up to 15 apart) and nothing regroups them yet.
__global__ void __launch_bounds__(256)
fm_resolve_kernel(const uint4* __restrict__ side,
                  const uint4* __restrict__ mark,
                  const unsigned* __restrict__ samp, unsigned n_samp,
                  unsigned cnt0, unsigned cnt1, unsigned cnt2, unsigned cnt3,
                  unsigned primary, const unsigned* __restrict__ rows,
                  const uint8_t* __restrict__ valid, int P, int n_iter,
                  unsigned* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P) return;
  unsigned off = 0;
  if (valid[lane]) {
    unsigned row = rows[lane];
    unsigned steps = 0;
    for (int it = 0; it < n_iter; ++it) {
      const unsigned blk = row >> 6;
      const int rem = (int)(row & 63u);
      const uint4 mk = __ldg(mark + blk);
      const uint4 ck = __ldg(side + 2 * (size_t)blk);
      const uint4 wd = __ldg(side + 2 * (size_t)blk + 1);
      const int sh = rem & 31;
      const unsigned below = (1u << sh) - 1u;
      const bool in_lo = rem < 32;
      if (((in_lo ? mk.x : mk.y) >> sh) & 1u) {
        const unsigned rank =
            mk.z + __popc(in_lo ? (mk.x & below) : mk.x)
            + __popc(in_lo ? 0u : (mk.y & below));
        off = __ldg(samp + min(rank, n_samp - 1u)) + steps;
        break;
      }
      const int wi = rem >> 4;
      const unsigned w = wi == 0 ? wd.x : wi == 1 ? wd.y : wi == 2 ? wd.z
                                                                   : wd.w;
      const int c = (int)((w >> (2 * (rem & 15))) & 3u);
      const unsigned pat = (unsigned)c * 0x55555555u;
      const int nm = nonmatch_word(wd.x, pat, rem)
                   + nonmatch_word(wd.y, pat, rem - 16)
                   + nonmatch_word(wd.z, pat, rem - 32)
                   + nonmatch_word(wd.w, pat, rem - 48);
      const unsigned base = pick(c, ck.x, ck.y, ck.z, ck.w);
      const unsigned corr =
          (c == 0 && primary >= (blk << 6) && primary < row) ? 1u : 0u;
      row = pick(c, cnt0, cnt1, cnt2, cnt3) + base + (unsigned)(rem - nm)
            - corr;
      ++steps;
    }
  }
  out[lane] = off;
}

}  // namespace

// side: [n_blocks + 1, 8] int32 (32-byte aligned rows); pat: [pat_rows,
// pat_stride] uint8 codes; per-lane int32 arrays of P entries (rowsel,
// top_in and bot_in may be null, ftab_* are read only with use_ftab); the
// outputs of the mode: top_out, bot_out, pos_out [P] (SEARCH, CONT) or
// rec_top, rec_bot [n_steps + 1, P] (RECORD). The index's scalars are the
// int32 bit patterns of its rows; with row_u32 the rows (and the ranges in
// and out) are read as uint32. Returns cudaGetLastError().
extern "C" int bt2_fm_walk(const int* side, const int* ftab_top,
                           const int* ftab_bot, const uint8_t* pat,
                           const int* rowsel, const int* start_pos,
                           const int* top_in, const int* bot_in,
                           int* top_out, int* bot_out, int* pos_out,
                           int* rec_top, int* rec_bot, int cnt0, int cnt1,
                           int cnt2, int cnt3, int n, int primary,
                           int row_u32, int pat_stride, int pat_rows, int P,
                           int n_steps, int mode, int use_ftab,
                           void* stream) {
  if (P <= 0) return 0;
  if (mode < SEARCH || mode > CONT || pat_rows <= 0) return 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_u32) {
    launch_walk<unsigned>(side, ftab_top, ftab_bot, pat, rowsel, start_pos,
                          top_in, bot_in, top_out, bot_out, pos_out, rec_top,
                          rec_bot, cnt0, cnt1, cnt2, cnt3, n, primary,
                          pat_stride, pat_rows, P, n_steps, mode, use_ftab,
                          st);
  } else {
    launch_walk<int>(side, ftab_top, ftab_bot, pat, rowsel, start_pos,
                     top_in, bot_in, top_out, bot_out, pos_out, rec_top,
                     rec_bot, cnt0, cnt1, cnt2, cnt3, n, primary, pat_stride,
                     pat_rows, P, n_steps, mode, use_ftab, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// c, top_in, bot_in, top_out, bot_out: [P] int32 (ranges as uint32 with
// row_u32). Returns cudaGetLastError().
extern "C" int bt2_fm_lf_step(const int* side, const int* c_in,
                              const int* top_in, const int* bot_in,
                              int* top_out, int* bot_out, int cnt0, int cnt1,
                              int cnt2, int cnt3, int n, int primary,
                              int row_u32, int P, void* stream) {
  if (P <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_u32) {
    launch_lf_step<unsigned>(side, c_in, top_in, bot_in, top_out, bot_out,
                             cnt0, cnt1, cnt2, cnt3, n, primary, P, st);
  } else {
    launch_lf_step<int>(side, c_in, top_in, bot_in, top_out, bot_out, cnt0,
                        cnt1, cnt2, cnt3, n, primary, P, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// side: as above; mark: [n_blocks + 1, 4] int32 ([bits_lo, bits_hi, rank,
// 0] a block); samp: [n_samp] int32; rows, out: [P] int32 (uint32 rows and
// offsets); valid: [P] uint8; n_iter: 2^off_rate. Returns
// cudaGetLastError().
extern "C" int bt2_fm_resolve(const int* side, const int* mark,
                              const int* samp, const int* rows,
                              const uint8_t* valid, int* out, int n_samp,
                              int cnt0, int cnt1, int cnt2, int cnt3,
                              int primary, int P, int n_iter, void* stream) {
  if (P <= 0) return 0;
  if (n_samp <= 0 || n_iter <= 0) return 1;
  fm_resolve_kernel<<<(P + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(side),
      reinterpret_cast<const uint4*>(mark),
      reinterpret_cast<const unsigned*>(samp), (unsigned)n_samp,
      (unsigned)cnt0, (unsigned)cnt1, (unsigned)cnt2, (unsigned)cnt3,
      (unsigned)primary, reinterpret_cast<const unsigned*>(rows), valid, P,
      n_iter, reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
