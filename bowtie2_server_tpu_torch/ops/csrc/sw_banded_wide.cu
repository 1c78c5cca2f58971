// Banded affine-gap DP for wide bands (K = 256, 512, 1024), a segment of
// L = K/J lanes per problem, J band cells a lane (J = 64 end-to-end, 32 in
// --local). It also takes K = 128, which the wrapper routes to the
// register kernel; that width is built so that the two kernels can be
// timed side by side.
//
// Replaces, for the band widths that band_for gives at --dpad 32..255, the
// TPU kernel bowtie2_server_tpu/ops/sw_banded.py::_banded_kernel (launched
// through _pallas_banded), which takes any K. It computes the same function
// as that kernel, as the plain torch version banded_tile_torch
// (bowtie2_server_tpu_torch/ops/sw_banded.py) and as the register kernel of
// sw_banded.cu, bit for bit, for any int32 scoring (see sw_banded.cu for
// the recurrence and the tie rules). One thread cannot hold these bands:
// h[K] and f[K] need 2K registers, and the register kernel already spills
// at K = 128.
//
// What bounds it on this card: the issue rate of the integer pipe, as for
// the register kernel. A cell is a handful of dependent integer operations
// on registers; per row a problem reads one read code, one penalty and one
// new band code. What a lane adds to the register kernel's cell is the E
// chain's second pass (one fused max-add a cell) and, per row, a segment
// scan of log2(L) shuffle steps and the other shuffles, loads and tests of
// a row (about 90 SASS instructions), shared by its J cells (chip_smoke
// phase 3 logs the SASS instructions a cell of the row loop).
//
// The design, and why each step gives the plain version's values exactly:
//   1. Lane s of a segment owns the band cells k = Js .. Js+J-1 of one
//      problem: its H and F (J int32 each) in registers, every loop over
//      them unrolled. A warp holds 32/L problems; a block of 128 threads
//      holds 128/L. Lanes of problems past P take part in every shuffle
//      (all shuffles name the full warp and stay inside a segment, `width`
//      L) with no rows of their own, and write nothing. J = 64 halves the
//      row's fixed cost a cell (96-128 registers at J = 32, no spills);
//      on the H100 it ran the end-to-end rows 8-10% faster than J = 32 and
//      the --local rows 3-6% slower (PERF.md, section 6), so each mode takes
//      its faster width.
//   2. F at (i, k) reads (i-1, k+1). Inside the lane it is the register
//      kernel's fused max-add, fn = __viaddmax_s32(h[j+1], -rfg_open,
//      f[j+1] - rfg_ext); for the lane's last cell the next lane computes
//      the same expression from its first cell before the row changes it
//      and sends it with one __shfl_down_sync (NEG at k = K-1).
//   3. E is the chain along k, carried as eo = E + rdg_open:
//      eo[k+1] = max(eo[k] - rdg_ext, base[k]), eo[0] = NEG + rdg_open,
//      H = max(base, eo - rdg_open) (sw_banded.cu, step 2). It is max-plus
//      linear in its carry: over the lane's J cells, eo_out = max(eo_in -
//      J rdg_ext, a), where a is the chain run from the lane's first base
//      alone (the segment's lane 0 starts from eo[0] itself). Pass 1 makes
//      base = __viaddmax_s32(h, s, fn) and a, one fused max-add a cell
//      each; an inclusive Kogge-Stone scan of (a, -J rdg_ext) over the
//      segment (log2(L) __shfl_up_sync steps, a carry crossing d lanes
//      paying J d rdg_ext) gives each lane its true eo_in; pass 2 runs
//      the chain from it: h = __viaddmax_s32(eo, -rdg_open, base)
//      (_relu in --local: the clamp at 0) and eo = __viaddmax_s32(eo,
//      -rdg_ext, base), two a cell. Every term of every max is a term of
//      the plain version's scan, the same sums in int32 (far from
//      overflow: NEG is -1e8), only grouped otherwise, so H is the same.
//   4. Scores, as in the register kernel (sw_banded.cu, step 4): the
//      lane's J band codes nibble-packed, eight to a register, sliding one
//      code a row (the lane's new last code is the next lane's first, by
//      one __shfl_down_sync; the segment's last lane loads it a row
//      ahead); a per-row byte table read by PRMT, four cells a lookup and
//      one sign-extending PRMT a cell. A row whose -mm[i] does not fit a
//      signed byte takes the exact route instead, the plain version's
//      selects on the code (exact_score), and so does every later row of
//      that problem (step 6 needs the byte bound on all earlier rows). The
//      warp runs its rows in loops built for the byte tables alone until a
//      vote finds a live problem whose row does not fit, then the same
//      loops built with both routes, chosen per problem.
//      When ma or npen do not fit a byte, or --local has a negative gap
//      penalty or lq > 65536, the host launches the instantiation with
//      BYTES = false, where every row takes the exact route: nothing falls
//      back to the plain version.
//   5. Rows. A problem's rows end at n = min(len, lq), and its gap rows
//      are one run [g0, g1) (sw_banded.cu, steps 3 and 5). The warp's rows
//      run in four loops, bounded by warp reductions: rows where every
//      problem is outside its gap run or finished (no F, no E, no scan:
//      H = max(diag, NEG), max(diag, 0) in --local; f is not written, and
//      it is read again only by a later gap row, which before the run
//      finds its initial NEG, the plain value, and after the run does not
//      come), rows where every problem is in its run or finished, rows
//      where problems differ (per-problem branches around the shuffles),
//      and rows where every problem is past its run or finished. A
//      finished problem's lanes skip the arithmetic, so its H stays that
//      of row n-1.
//   6. The best cell. End-to-end: row len-1 is the last one computed, so
//      each lane takes its largest H and that cell's largest k once, after
//      the loops. --local: each lane keeps a running best over its cells
//      (the row's largest key h * J + j, taken as each cell is made,
//      which orders as (h, j) since 0 <= h <= 127 (i + 1) < 2^25 under
//      byte scores and gap penalties >= 0; compare and select on the exact
//      route), updated on cb >= best with the row: its (value, row, k) is
//      the lexicographic largest of its cells, and that of the segment is
//      the plain version's (best, bi, bk): the largest value, the last row
//      that reaches it, the largest k in that row. A butterfly over the
//      segment (log2(L) steps, once) picks it. Problems with len <= 0 or
//      len > lq get the plain version's results written out literally
//      (sw_banded.cu, step 5).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "banded_common.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
enum Mode { NOGAP, GAP, MIXED };

template <int J>
struct Lane {
  int h[J], f[J];
  uint32_t w[J / 8];   // nibble b of w[q]: band code of row i + k0 + 8q + b
  int rdc, mmv;        // this row's read code and penalty (loaded ahead)
  uint32_t nxt;        // the segment's last lane: the code entering after
  int best, bi, bj;    // --local: the lane's running best
  bool exact;          // this and every later row: exact scores
};

// What a lane knows of its problem.
struct Seg {
  size_t sP;
  int p;           // problem (clamped to P-1 for lanes past P)
  int sl;          // lane in the segment
  bool last;       // sl == L-1
  int n, g0, g1;   // rows, gap run [g0, g1)
};

// One row's scores: the byte table (tlo; thi holds -npen) or, on the exact
// route, the read's code rdx and the mismatch score mis.
struct Scores {
  uint32_t tlo;
  int rdx, mis;
};

template <bool BYTES>
__device__ __forceinline__ Scores row_scores(int rdc, int mmv, uint32_t ma4,
                                             const Cfg& c) {
  const bool rd_n = rdc > 3;
  const int mis = rd_n ? -c.npen : -mmv;
  Scores r;
  r.tlo = BYTES ? byte_table(rdc, mis, ma4) : 0u;
  r.rdx = (rd_n || rdc < 0) ? 15 : rdc;
  r.mis = mis;
  return r;
}

// the score of cell j; `four` carries the byte-table lookup of cells
// j..j+3 (looked up at j % 4 == 0)
template <bool TAB, int J>
__device__ __forceinline__ int cell_score(const uint32_t (&w)[J / 8], int j,
                                          uint32_t& four, const Scores& r,
                                          uint32_t thi, const Cfg& c) {
  if (!TAB) return exact_score(nibble(w, j), r.rdx, r.mis, c);
  if ((j & 3) == 0)
    four = prmt(r.tlo, thi, (j & 4) ? w[j >> 3] >> 16 : w[j >> 3]);
  switch (j & 3) {
    case 0: return sbyte<0>(four);
    case 1: return sbyte<1>(four);
    case 2: return sbyte<2>(four);
    default: return sbyte<3>(four);
  }
}

// --local: the running row best of a lane, by key (TAB) or by compare
template <int J, bool TAB>
struct RowBest {
  static constexpr int JB = J == 64 ? 6 : 5;
  int key = 0, even = 0;   // keys h << JB | j, >= 0 (h >= 0 in --local)
  int cb = -1, jb = 0;
  __device__ __forceinline__ void add(int h, int j) {
    if (TAB) {
      if (j & 1)
        key = __vimax3_s32(key, even, (h << JB) | j);
      else
        even = (h << JB) | j;
    } else if (h >= cb) {
      cb = h;
      jb = j;
    }
  }
  __device__ __forceinline__ void commit(Lane<J>& s, int i) {
    if (TAB) {
      cb = key >> JB;
      jb = key & (J - 1);
    }
    if (cb >= s.best) {
      s.best = cb;
      s.bi = i;
      s.bj = jb;
    }
  }
};

// A row outside the gap run: H = max(diag, NEG), max(diag, 0) in --local.
template <int J, bool LOCAL, bool TAB>
__device__ __forceinline__ void row_nogap(Lane<J>& s, const Scores& r,
                                          uint32_t thi, int i, const Cfg& c) {
  uint32_t four = 0;
  RowBest<J, TAB> rb;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int sc = cell_score<TAB, J>(s.w, j, four, r, thi, c);
    s.h[j] = __viaddmax_s32(s.h[j], sc, LOCAL ? 0 : NEG);
    if (LOCAL) rb.add(s.h[j], j);
  }
  if (LOCAL) rb.commit(s, i);
}

// Pass 1 of a gap row: F, base = max(diag, F) into h, and the E chain's
// value at the lane's end from the lane alone (design note, step 3).
template <int J, bool TAB>
__device__ __forceinline__ int gap_pass1(Lane<J>& s, const Scores& r,
                                         uint32_t thi, int fx, bool first,
                                         const Cfg& c) {
  uint32_t four = 0;
  int a = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int sc = cell_score<TAB, J>(s.w, j, four, r, thi, c);
    const int fn = j < J - 1
        ? __viaddmax_s32(s.h[j + 1], -c.rfg_open, s.f[j + 1] - c.rfg_ext)
        : fx;
    const int base = __viaddmax_s32(s.h[j], sc, fn);
    s.f[j] = fn;   // (i-1, j+1) was read above; slot j is not read again
    s.h[j] = base;
    if (j == 0)
      a = first ? __viaddmax_s32(NEG + c.rdg_open, -c.rdg_ext, base) : base;
    else
      a = __viaddmax_s32(a, -c.rdg_ext, base);
  }
  return a;
}

// Pass 2 of a gap row: the E chain from the lane's true carry eo, and H.
template <int J, bool LOCAL, bool TAB>
__device__ __forceinline__ void gap_pass2(Lane<J>& s, int eo, int i,
                                          const Cfg& c) {
  RowBest<J, TAB> rb;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int base = s.h[j];
    s.h[j] = LOCAL ? __viaddmax_s32_relu(eo, -c.rdg_open, base)
                   : __viaddmax_s32(eo, -c.rdg_open, base);
    eo = __viaddmax_s32(eo, -c.rdg_ext, base);   // for j + 1
    if (LOCAL) rb.add(s.h[j], j);
  }
  if (LOCAL) rb.commit(s, i);
}

// Whether every live problem of the warp takes row i on the byte tables
// (the loops of byte rows leave at the first row where one does not).
template <int J>
__device__ __forceinline__ bool byte_row(const Lane<J>& s, int i,
                                         const Seg& g) {
  return !__any_sync(FULL, i < g.n &&
                               static_cast<uint32_t>(s.mmv) + 127u > 255u);
}

// Row i of the lane's problem. Every lane of the warp calls it (the
// shuffles name the full warp); MODE is what the warp's loop knows of the
// rows (design note, step 5); FAST: the warp's live problems all take this
// row on the byte tables (byte_row), so the exact route is not built in.
template <int J, int L, bool LOCAL, bool BYTES, Mode MODE, bool FAST>
__device__ __forceinline__ void row(Lane<J>& s, int i, const Seg& g,
                                    const int32_t* __restrict__ rd,
                                    const int32_t* __restrict__ mm,
                                    const int32_t* __restrict__ band,
                                    const Cfg& c, uint32_t ma4,
                                    uint32_t thi) {
  constexpr int K = J * L;
  constexpr int NW = J / 8;
  const int rdc = s.rdc, mmv = s.mmv;
  const uint32_t nxt = s.nxt;
  if (i + 1 < g.n) {   // the next row's inputs, a row ahead of their use
    s.rdc = rd[(i + 1) * g.sP + g.p];
    s.mmv = mm[(i + 1) * g.sP + g.p];
    if (g.last) s.nxt = code4(band[(i + 1 + K) * g.sP + g.p]);
  }
  const bool live = i < g.n;
  const bool gap = MODE == GAP || (MODE == MIXED && i >= g.g0 && i < g.g1);
  if (!FAST && BYTES && static_cast<uint32_t>(mmv) + 127u > 255u)
    s.exact = true;   // -mmv does not fit a signed byte
  const bool tab = FAST || (BYTES && !s.exact);
  const Scores r = row_scores<BYTES>(rdc, mmv, ma4, c);

  int fx = NEG, a = 0;
  if (MODE != NOGAP) {   // F of the lane's last cell, from the next lane
    const int mine = __viaddmax_s32(s.h[0], -c.rfg_open,
                                    s.f[0] - c.rfg_ext);
    fx = __shfl_down_sync(FULL, mine, 1, L);
    if (g.last) fx = NEG;
  }
  if (live) {
    if (gap) {
      a = tab ? gap_pass1<J, true>(s, r, thi, fx, g.sl == 0, c)
              : gap_pass1<J, false>(s, r, thi, fx, g.sl == 0, c);
    } else if (tab) {
      row_nogap<J, LOCAL, true>(s, r, thi, i, c);
    } else {
      row_nogap<J, LOCAL, false>(s, r, thi, i, c);
    }
  }
  if (MODE != NOGAP) {   // the E carry into each lane: a segment scan
    int t = a;
#pragma unroll
    for (int d = 1; d < L; d <<= 1) {
      const int u = __shfl_up_sync(FULL, t, d, L);
      if (g.sl >= d) t = __viaddmax_s32(u, -d * J * c.rdg_ext, t);
    }
    int eo = __shfl_up_sync(FULL, t, 1, L);
    if (g.sl == 0) eo = NEG + c.rdg_open;
    if (live && gap) {
      if (tab)
        gap_pass2<J, LOCAL, true>(s, eo, i, c);
      else
        gap_pass2<J, LOCAL, false>(s, eo, i, c);
    }
  }
  // slide the window: the lane's new last code is the next lane's first
  uint32_t nb = __shfl_down_sync(FULL, s.w[0], 1, L) & 0xFu;
  if (g.last) nb = nxt;
#pragma unroll
  for (int q = 0; q < NW - 1; ++q)
    s.w[q] = __funnelshift_r(s.w[q], s.w[q + 1], 4);
  s.w[NW - 1] = __funnelshift_r(s.w[NW - 1], nb, 4);
}

template <int J, int L, bool LOCAL, bool BYTES>
__global__ void __launch_bounds__(128)
banded_wide_kernel(const int32_t* __restrict__ rd,
                   const int32_t* __restrict__ mm,
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ band,
                   int32_t* __restrict__ best_out,
                   int32_t* __restrict__ bi_out,
                   int32_t* __restrict__ bk_out, int lq, int P, Cfg c) {
  static_assert(J % 8 == 0 && (J == 32 || J == 64), "J: 32 or 64 cells");
  static_assert(L >= 2 && L <= 32 && (L & (L - 1)) == 0, "L: 2..32");
  constexpr int K = J * L;
  constexpr int NW = J / 8;
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = gt / L;
  const bool valid = p < P;
  Seg g;
  g.sP = static_cast<size_t>(P);
  g.p = valid ? p : P - 1;
  g.sl = threadIdx.x & (L - 1);
  g.last = g.sl == L - 1;
  const int k0 = g.sl * J;
  const int len = valid ? lens[g.p] : 0;
  g.n = valid ? min(max(len, 0), lq) : 0;
  g.g0 = min(max(c.gapbar, 0), g.n);
  g.g1 = max(g.g0, min(len - c.gapbar, g.n));

  // the warp's four row loops (design note, step 5): rows [0, A) outside
  // every run, [A, B) inside every run, [B, C) mixed, [C, N) past every run
  // (a finished problem fits any)
  const bool has = g.g1 > g.g0;
  const int N = __reduce_max_sync(FULL, g.n);
  const int A = min(N, __reduce_min_sync(FULL, has ? g.g0 : INT_MAX));
  const int Bl = has ? (g.g1 < g.n ? g.g1 : INT_MAX)
                     : (g.n > A ? A : INT_MAX);
  const int B = max(A, min(N, __reduce_min_sync(FULL, Bl)));
  const int C = max(B, __reduce_max_sync(FULL, has ? g.g1 : 0));

  Lane<J> s;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    s.h[j] = 0;     // H[-1] = 0: the alignment may start at any column
    s.f[j] = NEG;
  }
  s.best = NEG;
  s.bi = -1;
  s.bj = 0;
  s.exact = !BYTES;
  s.rdc = s.mmv = 0;
  s.nxt = 0;
#pragma unroll
  for (int q = 0; q < NW; ++q) s.w[q] = 0;
  if (g.n > 0) {
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        v |= code4(band[(k0 + 8 * q + b) * g.sP + g.p]) << (4 * b);
      s.w[q] = v;
    }
    s.rdc = rd[g.p];
    s.mmv = mm[g.p];
    if (g.last) s.nxt = code4(band[K * g.sP + g.p]);
  }
  // ma in every byte; -npen, the score of band code 4, in byte 0
  const uint32_t ma4 = (static_cast<uint32_t>(c.ma) & 0xFFu) * 0x01010101u;
  const uint32_t thi = static_cast<uint32_t>(-c.npen) & 0xFFu;

  // the byte rows, then (from the first row a live problem of the warp
  // takes on the exact route, or from row 0 when BYTES is false) the same
  // four loops with both routes
  int i = 0;
  if (BYTES) {
    while (i < A && byte_row(s, i, g)) {
      row<J, L, LOCAL, true, NOGAP, true>(s, i, g, rd, mm, band, c, ma4, thi);
      ++i;
    }
    while (i < B && byte_row(s, i, g)) {
      row<J, L, LOCAL, true, GAP, true>(s, i, g, rd, mm, band, c, ma4, thi);
      ++i;
    }
    while (i < C && byte_row(s, i, g)) {
      row<J, L, LOCAL, true, MIXED, true>(s, i, g, rd, mm, band, c, ma4, thi);
      ++i;
    }
    while (i < N && byte_row(s, i, g)) {
      row<J, L, LOCAL, true, NOGAP, true>(s, i, g, rd, mm, band, c, ma4, thi);
      ++i;
    }
  }
  for (; i < A; ++i)
    row<J, L, LOCAL, BYTES, NOGAP, false>(s, i, g, rd, mm, band, c, ma4, thi);
  for (; i < B; ++i)
    row<J, L, LOCAL, BYTES, GAP, false>(s, i, g, rd, mm, band, c, ma4, thi);
  for (; i < C; ++i)
    row<J, L, LOCAL, BYTES, MIXED, false>(s, i, g, rd, mm, band, c, ma4, thi);
  for (; i < N; ++i)
    row<J, L, LOCAL, BYTES, NOGAP, false>(s, i, g, rd, mm, band, c, ma4, thi);

  // the lane's best: --local its running best; end-to-end the largest H
  // of row n-1 and its largest k
  int cb, ci, ck;
  if (LOCAL) {
    cb = s.best;
    ci = s.bi;
    ck = k0 + s.bj;
  } else {
    cb = s.h[0];
    ck = 0;
#pragma unroll
    for (int j = 1; j < J; ++j)
      if (s.h[j] >= cb) {
        cb = s.h[j];
        ck = j;
      }
    ck += k0;
    ci = 0;
  }
  // the segment's: the lexicographic largest (value, row, k)
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    const int ob = __shfl_xor_sync(FULL, cb, o, L);
    const int oi = __shfl_xor_sync(FULL, ci, o, L);
    const int ok = __shfl_xor_sync(FULL, ck, o, L);
    if (ob > cb || (ob == cb && (oi > ci || (oi == ci && ok > ck)))) {
      cb = ob;
      ci = oi;
      ck = ok;
    }
  }
  if (!valid || g.sl != 0) return;
  int best = NEG, bi = -1, bk = -1;
  if (LOCAL) {
    if (g.n >= 1) {
      best = cb;
      bi = ci;
      bk = ck;
    } else if (len <= 0 && lq > 0) {   // every row unscored, all updating
      bi = lq - 1;
      bk = K - 1;
    }
  } else if (len >= 1 && len <= lq && cb > NEG) {   // row len-1
    best = cb;
    bi = len - 1;
    bk = ck;
  }
  best_out[p] = best;
  bi_out[p] = bi;
  bk_out[p] = bk;
}

template <int J, int L, bool LOCAL>
void launch(bool bytes, cudaStream_t st, const int32_t* rd, const int32_t* mm,
            const int32_t* lens, const int32_t* band, int32_t* best,
            int32_t* bi, int32_t* bk, int lq, int P, Cfg c) {
  const dim3 block(128);   // 128 / L problems a block
  const dim3 grid(static_cast<unsigned>(
      (static_cast<long long>(P) * L + 127) / 128));
  if (bytes)
    banded_wide_kernel<J, L, LOCAL, true><<<grid, block, 0, st>>>(
        rd, mm, lens, band, best, bi, bk, lq, P, c);
  else
    banded_wide_kernel<J, L, LOCAL, false><<<grid, block, 0, st>>>(
        rd, mm, lens, band, best, bi, bk, lq, P, c);
}

// band K: 64 cells a lane end-to-end, 32 in --local (design note, step 1)
template <int K>
void launch_band(bool local, bool bytes, cudaStream_t st, const int32_t* rd,
                 const int32_t* mm, const int32_t* lens, const int32_t* band,
                 int32_t* best, int32_t* bi, int32_t* bk, int lq, int P,
                 Cfg c) {
  if (local)
    launch<32, K / 32, true>(bytes, st, rd, mm, lens, band, best, bi, bk, lq,
                             P, c);
  else
    launch<64, K / 64, false>(bytes, st, rd, mm, lens, band, best, bi, bk,
                              lq, P, c);
}

bool fits8(long long v) { return v >= -128 && v <= 127; }

}  // namespace

// rd, mm: [lq, P]; lens: [P]; band: [lq + K, P]; best, bi, bk: [P] (int32,
// contiguous, on the device; codes non-negative, as the callers' uint8
// codes are); K in {128, 256, 512, 1024}. Returns cudaGetLastError() after
// the launch.
extern "C" int bt2_sw_banded_wide(const int32_t* rd, const int32_t* mm,
                                  const int32_t* lens, const int32_t* band,
                                  int32_t* best, int32_t* bi, int32_t* bk,
                                  int lq, int P, int K, int ma, int npen,
                                  int rdg_open, int rdg_ext, int rfg_open,
                                  int rfg_ext, int gapbar, int local,
                                  void* stream) {
  if (P <= 0) return 0;
  const Cfg c{ma, npen, rdg_open, rdg_ext, rfg_open, rfg_ext, gapbar};
  // byte scores and the --local key (design note, steps 4 and 6)
  const bool bytes = fits8(ma) && fits8(-static_cast<long long>(npen)) &&
                     (!local || (lq <= 65536 && rdg_open >= 0 &&
                                 rdg_ext >= 0 && rfg_open >= 0 &&
                                 rfg_ext >= 0));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 128:
      launch_band<128>(local, bytes, st, rd, mm, lens, band, best, bi, bk,
                        lq, P, c);
      break;
    case 256:
      launch_band<256>(local, bytes, st, rd, mm, lens, band, best, bi, bk,
                        lq, P, c);
      break;
    case 512:
      launch_band<512>(local, bytes, st, rd, mm, lens, band, best, bi, bk,
                        lq, P, c);
      break;
    case 1024:
      launch_band<1024>(local, bytes, st, rd, mm, lens, band, best, bi,
                         bk, lq, P, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
