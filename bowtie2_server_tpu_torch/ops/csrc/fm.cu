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
// Modes (ranges are int32 rows; a lane's characters come from its pattern
// row, right to left from its start position):
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

struct Fm {
  const uint4* side;   // [n_blocks + 1] x 2: counts, then packed words
  int cnt0, cnt1, cnt2, cnt3;
  int n;
  int primary;
};

__device__ __forceinline__ int pick(int c, int a, int b, int d, int e) {
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

__device__ __forceinline__ int occ(const Fm& fm, int c, int row) {
  const int blk = row >> 6;
  const int rem = row & 63;
  const uint4 ck = __ldg(fm.side + 2 * blk);
  const uint4 wd = __ldg(fm.side + 2 * blk + 1);
  const int base = pick(c, (int)ck.x, (int)ck.y, (int)ck.z, (int)ck.w);
  const unsigned pat = (unsigned)c * 0x55555555u;
  const int nm = nonmatch_word(wd.x, pat, rem)
               + nonmatch_word(wd.y, pat, rem - 16)
               + nonmatch_word(wd.z, pat, rem - 32)
               + nonmatch_word(wd.w, pat, rem - 48);
  const int corr = (c == 0 && fm.primary >= (blk << 6) && fm.primary < row);
  return base + rem - nm - corr;
}

// one LF step on a valid character (0..3) and a nonempty range
__device__ __forceinline__ void lf(const Fm& fm, int c, int& top, int& bot) {
  const int base = pick(c, fm.cnt0, fm.cnt1, fm.cnt2, fm.cnt3);
  const int t = occ(fm, c, top);
  const int b = occ(fm, c, bot);
  top = base + t;
  bot = base + b;
}

__global__ void __launch_bounds__(256)
fm_walk_kernel(Fm fm, const int* __restrict__ ftab_top,
               const int* __restrict__ ftab_bot,
               const uint8_t* __restrict__ pat, int pat_stride, int pat_rows,
               const int* __restrict__ rowsel,
               const int* __restrict__ start_pos,
               const int* __restrict__ top_in, const int* __restrict__ bot_in,
               int P, int n_steps, int mode, int use_ftab,
               int* __restrict__ top_out, int* __restrict__ bot_out,
               int* __restrict__ pos_out, int* __restrict__ rec_top,
               int* __restrict__ rec_bot) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P) return;
  int row = rowsel != nullptr ? rowsel[lane] : lane;
  row = min(max(row, 0), pat_rows - 1);
  const uint8_t* p = pat + (size_t)row * pat_stride;
  int pos = start_pos[lane];
  int top = top_in != nullptr ? top_in[lane] : 0;
  int bot = bot_in != nullptr ? bot_in[lane] : fm.n;
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

__global__ void __launch_bounds__(256)
fm_lf_step_kernel(Fm fm, const int* __restrict__ c_in,
                  const int* __restrict__ top_in,
                  const int* __restrict__ bot_in, int P,
                  int* __restrict__ top_out, int* __restrict__ bot_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P) return;
  const int c = c_in[lane];
  int top = top_in[lane];
  int bot = bot_in[lane];
  if (c > 3 || top >= bot) {
    top = bot = 0;
  } else {
    lf(fm, c, top, bot);
  }
  top_out[lane] = top;
  bot_out[lane] = bot;
}

Fm make_fm(const int* side, int cnt0, int cnt1, int cnt2, int cnt3, int n,
           int primary) {
  Fm fm;
  fm.side = reinterpret_cast<const uint4*>(side);
  fm.cnt0 = cnt0;
  fm.cnt1 = cnt1;
  fm.cnt2 = cnt2;
  fm.cnt3 = cnt3;
  fm.n = n;
  fm.primary = primary;
  return fm;
}

}  // namespace

// side: [n_blocks + 1, 8] int32 (32-byte aligned rows); pat: [pat_rows,
// pat_stride] uint8 codes; per-lane int32 arrays of P entries (rowsel,
// top_in and bot_in may be null, ftab_* are read only with use_ftab); the
// outputs of the mode: top_out, bot_out, pos_out [P] (SEARCH, CONT) or
// rec_top, rec_bot [n_steps + 1, P] (RECORD). Returns cudaGetLastError().
extern "C" int bt2_fm_walk(const int* side, const int* ftab_top,
                           const int* ftab_bot, const uint8_t* pat,
                           const int* rowsel, const int* start_pos,
                           const int* top_in, const int* bot_in,
                           int* top_out, int* bot_out, int* pos_out,
                           int* rec_top, int* rec_bot, int cnt0, int cnt1,
                           int cnt2, int cnt3, int n, int primary,
                           int pat_stride, int pat_rows, int P, int n_steps,
                           int mode, int use_ftab, void* stream) {
  if (P <= 0) return 0;
  if (mode < SEARCH || mode > CONT || pat_rows <= 0) return 1;
  const Fm fm = make_fm(side, cnt0, cnt1, cnt2, cnt3, n, primary);
  fm_walk_kernel<<<(P + 255) / 256, 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      fm, ftab_top, ftab_bot, pat, pat_stride, pat_rows, rowsel, start_pos,
      top_in, bot_in, P, n_steps, mode, use_ftab, top_out, bot_out, pos_out,
      rec_top, rec_bot);
  return static_cast<int>(cudaGetLastError());
}

// c, top_in, bot_in, top_out, bot_out: [P] int32. Returns
// cudaGetLastError().
extern "C" int bt2_fm_lf_step(const int* side, const int* c_in,
                              const int* top_in, const int* bot_in,
                              int* top_out, int* bot_out, int cnt0, int cnt1,
                              int cnt2, int cnt3, int n, int primary, int P,
                              void* stream) {
  if (P <= 0) return 0;
  const Fm fm = make_fm(side, cnt0, cnt1, cnt2, cnt3, n, primary);
  fm_lf_step_kernel<<<(P + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      fm, c_in, top_in, bot_in, P, top_out, bot_out);
  return static_cast<int>(cudaGetLastError());
}
