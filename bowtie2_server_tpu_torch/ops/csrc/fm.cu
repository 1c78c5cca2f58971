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
// $-hole test) and the side counts are unsigned, as
// the JAX package's uint32 rows are; the tensors carry the same 32 bits
// either way.
//
// Sides. A block's side is 32 bytes (its four counts, then its 64 bases
// packed in four words), the sides contiguous, 32-byte aligned, in a small
// and a big index alike; a big index keeps its mark rows in an array of
// their own (fm_resolve). The card reads HBM 64 bytes at a time, so a side
// read brings the next block's side, which a step often needs.
//
// Modes (a lane's characters come from its pattern row, right to left from
// its start position, which lies inside the row):
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
// What bounds fm_walk on this card (NVIDIA H100 80GB HBM3, 700 W;
// scripts/bench_fm.py at the big batch's shapes). With the sides in HBM (a
// direction of a genome past ~64 Mbp: 2^29 bp has 256 MB of sides, GRCh38
// 1.5 GB) nearly every step past the first ~10 characters reads a block no
// other lane read, and the walk runs close to the rate at which the card
// serves random 32-byte reads (the gather probe: ~2.5-2.7e10 a second):
// about 0.7 of that rate for the recorded pass at 2^29 bp. A step
// whose two ends share a block reads it once from DRAM even with four
// loads, since L1 merges the second pair. With the sides in L2 (a
// direction of the 4 Mbp genome: 2 MB) the first design's recorded pass
// took ~1.7x its chain floor (the longest lane's 100 steps, one after
// another, at the time of one dependent step), at ~0.3 of its bound: its
// ~16 warps an SM each wait on a side load and then execute ~160
// instructions a step, and the step's byte load of the pattern sat on the
// chain.
//
// What the design does about it: one thread a lane (nothing is shared, no
// synchronisation); contiguous sides (a big index's blocks laid out as
// 64-byte records of side and mark row, which the walk-left wants, made
// the recorded pass 2-6% and the seed search 10% slower in HBM, with or
// without the next block's words in the record's spare 16 bytes, which a
// range ending in the next block would read); a lane's next character is
// loaded one step ahead, off the chain; occ counts the nonmatching bases
// of the whole words below the row's word by prefix popcounts and masks
// only that word (`lf_walk`);
// 32 registers a thread (`__launch_bounds__(256, 8)`), so that the card
// holds 2048 threads an SM and keeps as many random reads in flight as the
// first design did (with 40 registers the seed search in HBM was slower);
// a finished lane stops fetching (SEARCH and CONT leave the loop; RECORD
// only writes); the record is laid out [step, lane] so a warp's writes are
// coalesced. Tried on the card and dropped: one side fetch when both ends
// share a block (no DRAM read saved, and its branch was slower in HBM),
// the pattern read in 16-byte chunks (its two loads a lane slowed the
// short seed walks). Two lanes a thread would not shorten a chain: where
// lanes are few the time is the longest chain's steps x the step latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FTAB_CHARS = 10;
constexpr int SEARCH = 0, RECORD = 1, CONT = 2;
constexpr unsigned FULL = 0xFFFFFFFFu;

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

// one LF step on a valid character (0..3) and a nonempty range (fm_lf_step)
template <typename R>
__device__ __forceinline__ void lf(const Fm<R>& fm, int c, R& top, R& bot) {
  const R base = pick(c, fm.cnt0, fm.cnt1, fm.cnt2, fm.cnt3);
  const R t = occ(fm, c, top);
  const R b = occ(fm, c, bot);
  top = base + t;
  bot = base + b;
}

// the nonmatch bits of c (pat = c * 0x55555555) in a word of packed bases
__device__ __forceinline__ unsigned nm_bits(unsigned w, unsigned pat) {
  const unsigned x = w ^ pat;
  return (x | (x >> 1)) & 0x55555555u;
}

__device__ __forceinline__ uint4 nm_side(const uint4& wd, unsigned pat) {
  return make_uint4(nm_bits(wd.x, pat), nm_bits(wd.y, pat),
                    nm_bits(wd.z, pat), nm_bits(wd.w, pat));
}

// set nonmatch bits among the first rem (0..63) bases: the whole words
// below the row's word, then that word masked
__device__ __forceinline__ int nm_prefix(const uint4& nm, int rem) {
  const int k = rem >> 4;
  const int p1 = __popc(nm.x), p2 = p1 + __popc(nm.y);
  const int p3 = p2 + __popc(nm.z);
  const int full = k == 0 ? 0 : k == 1 ? p1 : k == 2 ? p2 : p3;
  const unsigned part = k == 0 ? nm.x : k == 1 ? nm.y : k == 2 ? nm.z : nm.w;
  return full + __popc(part & ((1u << (2 * (rem & 15))) - 1u));
}

// fm_walk's LF step: the same counts as lf, by prefix popcounts
template <typename R>
__device__ __forceinline__ void lf_walk(const Fm<R>& fm, int c, R& top,
                                        R& bot) {
  const R bt = top >> 6, bb = bot >> 6;
  const uint4* st = fm.side + 2 * (size_t)bt;
  const uint4 ckt = __ldg(st);
  const uint4 wdt = __ldg(st + 1);
  const unsigned pat = (unsigned)c * 0x55555555u;
  const uint4 nmt = nm_side(wdt, pat);
  const uint4* sb = fm.side + 2 * (size_t)bb;
  const uint4 ckb = __ldg(sb);
  const uint4 nmb = nm_side(__ldg(sb + 1), pat);
  const int rt = (int)(top & 63), rb = (int)(bot & 63);
  const R base = pick(c, fm.cnt0, fm.cnt1, fm.cnt2, fm.cnt3);
  const R ct = (c == 0 && fm.primary >= (bt << 6) && fm.primary < top);
  const R cb = (c == 0 && fm.primary >= (bb << 6) && fm.primary < bot);
  top = base + pick(c, (R)ckt.x, (R)ckt.y, (R)ckt.z, (R)ckt.w)
        + (R)(rt - nm_prefix(nmt, rt)) - ct;
  bot = base + pick(c, (R)ckb.x, (R)ckb.y, (R)ckb.z, (R)ckb.w)
        + (R)(rb - nm_prefix(nmb, rb)) - cb;
}

template <typename R>
__global__ void __launch_bounds__(256, 8)
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
  // the character at pos, loaded one step before it is used
  int next = pos >= 0 ? __ldg(p + pos) : 0;
  if (use_ftab && pos >= FTAB_CHARS - 1) {
    // the rightmost FTAB_CHARS characters, big-endian in text order: the
    // character k left of pos weighs 4^k
    int key = 0;
    bool ok = true;
#pragma unroll
    for (int k = 0; k < FTAB_CHARS; ++k) {
      const int c = __ldg(p + pos - k);
      ok &= c <= 3;
      key |= (c & 3) << (2 * k);
    }
    if (ok) {
      top = __ldg(ftab_top + key);
      bot = __ldg(ftab_bot + key);
      pos -= FTAB_CHARS;
      next = pos >= 0 ? __ldg(p + pos) : 0;
    }
  }
  if (mode == RECORD) {
    rec_top[lane] = top;
    rec_bot[lane] = bot;
    for (int s = 0; s < n_steps; ++s) {
      if (pos >= 0) {
        const int c = next;
        --pos;
        next = pos >= 0 ? __ldg(p + pos) : 0;
        if (c > 3 || top >= bot) {
          top = bot = 0;
        } else {
          lf_walk(fm, c, top, bot);
        }
      }
      rec_top[(size_t)(s + 1) * P + lane] = top;
      rec_bot[(size_t)(s + 1) * P + lane] = bot;
    }
    return;
  }
  for (int s = 0; s < n_steps && pos >= 0 && top < bot; ++s) {
    const int c = next;
    --pos;
    next = pos >= 0 ? __ldg(p + pos) : 0;
    if (c > 3) {
      top = bot = 0;
    } else {
      lf_walk(fm, c, top, bot);
    }
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
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; scripts/bench_fm.py). A
// trip is one 16-byte mark load and one 32-byte side load (two 16-byte
// loads), all three addressed by the row and issued together, then ~30
// integer operations to test the bit or take the LF step; the next trip's
// loads wait on this one's row. A chain is at most 2^off_rate - 1 = 15
// steps (7.5 on average), 16 trips at ~0.5 us: far below the measured
// times, so the bound is a rate. A big index is built only past 2^31 -
// 2^23 bp (GRCh38: 1.5 GB of sides and 0.76 GB of marks a direction), so
// its tables lie in HBM and nearly every trip reads a mark row and a side
// from two random DRAM pages; the card serves random 32- and 64-byte reads
// at about the same rate (the gather probe: ~2.6e10 and ~2.5e10 a second),
// and at 2^29 bp the kernel runs close to that rate for two reads a
// block. With the tables in L2 (only where tests and chip_smoke force the
// big layout on a small genome) a trip is an L2 round trip and the time
// is the longest chain's trips times that latency.
//
// What the design does: one thread a row, no sharing and no
// synchronisation; the mark and side loads of a trip are issued before
// either is used, so a trip pays one latency rather than two; a lane
// leaves as soon as it is marked (the JAX loop runs every trip for every
// lane). Tried on the card and dropped: each block's side and mark row in
// one 64-byte record with two threads a row (0.72 of this kernel's time
// in HBM, 1.5x in L2; the same two-thread kernel on these separate arrays
// 1.1x), because the walks then read the records too (one table layout)
// and lost as much as the walk-left gained; regrouping a warp's lanes as
// they finish (a batch's ~2 x 10^5 rows fill the card at most twice, so a
// regrouped warp would find few rows to take).
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
// pat_stride] uint8 codes, every start position inside its row; per-lane
// int32 arrays of P entries (rowsel, top_in and bot_in may be null,
// ftab_* are read only with use_ftab); the outputs of the mode: top_out,
// bot_out, pos_out [P] (SEARCH, CONT) or rec_top, rec_bot [n_steps + 1, P]
// (RECORD). The index's scalars are the int32 bit patterns of its rows;
// with row_u32 the rows (and the ranges in and out) are read as uint32.
// Returns cudaGetLastError().
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
