// Pieces shared by the banded-DP kernels of sw_banded.cu and
// sw_banded_wide.cu: the scoring arguments, the band-code squash, the byte
// permute that the score tables are read with, and the exact int32 score
// of one cell.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -100000000;   // NEG_INF of ops/sw.py

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

// The byte table of one row's scores (banded_kernel's design, step 4):
// bytes 0-3 the score against band codes 0-3 (ma for the read's code,
// else the mismatch score, -npen for an N read), for codes 0..3 a byte
// each; `mis` is that mismatch score and `ma4` holds ma in every byte.
__device__ __forceinline__ uint32_t byte_table(int rdc, int mis,
                                               uint32_t ma4) {
  uint32_t sel = 0x3210u;   // nibble rdc + 4 takes byte rdc of ma4
  if (rdc <= 3 && rdc >= 0) sel += 4u << (4 * rdc);
  return prmt((static_cast<uint32_t>(mis) & 0xFFu) * 0x01010101u, ma4, sel);
}

// The exact int32 score of one cell from its band code c (0..4): the
// plain version's selects. rdx is the read's code, or 15 (no band code
// matches it) for an N read or a code below 0; mis is -npen for an N
// read, else -mm[i].
__device__ __forceinline__ int exact_score(uint32_t c, int rdx, int mis,
                                           const Cfg& cf) {
  const int s = static_cast<int>(c) == rdx ? cf.ma : mis;
  return c == 4u ? -cf.npen : s;
}

// nibble j of a nibble-packed window (eight codes a register)
template <int NW>
__device__ __forceinline__ uint32_t nibble(const uint32_t (&w)[NW], int j) {
  return (w[j >> 3] >> (4 * (j & 7))) & 0xFu;
}

}  // namespace
