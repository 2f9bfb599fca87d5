// Bit-sliced SC counting, shared by schist.cu and masked_rerank.cu.
//
// The packed collision table holds, in bit j of word [tile][s][c], whether
// IMI cell c of subspace s is activated for query 32 * tile + j. A lane that
// owns one point reads one word per subspace (the word of the point's cell)
// and so gets that subspace's collision bit for all 32 queries of the tile
// at once. Adding the N_s words in carry-save form gives SC for the 32
// queries as kPlanes bit-planes: bit j of plane b is bit b of SC(query j).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxSub = 16;
constexpr int kPlanes = 5;  // SC <= 16 fits in 5 bits
constexpr unsigned kFull = 0xffffffffu;

// SC planes of one point over the 32 queries of a tile. cell[s] is the
// point's cell in subspace s; an invalid point gets SC = 0 everywhere.
__device__ __forceinline__ void sc_planes(const uint32_t* tab, int k2,
                                          const int (&cell)[kMaxSub],
                                          int n_sub, bool valid,
                                          uint32_t (&planes)[kPlanes]) {
#pragma unroll
  for (int b = 0; b < kPlanes; ++b) planes[b] = 0u;
#pragma unroll
  for (int s = 0; s < kMaxSub; ++s) {
    if (s < n_sub) {
      uint32_t carry = valid ? tab[s * k2 + cell[s]] : 0u;
#pragma unroll
      for (int b = 0; b < kPlanes; ++b) {
        const uint32_t t = planes[b] & carry;
        planes[b] ^= carry;
        carry = t;
      }
    }
  }
}

// 32 x 32 bit transpose across a warp: lane i passes in row i (bit j is
// element (i, j)) and gets back column i (bit j is element (j, i)).
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const uint32_t m = masks[i];
    const uint32_t other = __shfl_xor_sync(kFull, x, s);
    x = (lane & s) ? ((x & ~m) | ((other & ~m) >> s))
                   : ((x & m) | ((other & m) << s));
  }
  return x;
}

// ---- helpers of schist.cu's multi-tile kernel ----------------------------

// The same 32 x 32 bit transpose as transpose32, three instructions a round:
// a shuffle, a rotate (a funnel shift) and a bit select with per-lane masks
// computed once.
struct Transpose32 {
  uint32_t keep[5];
  int rot[5];
  __device__ __forceinline__ explicit Transpose32(int lane) {
    const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                               0x33333333u, 0x55555555u};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int s = 16 >> i;
      const bool upper = lane & s;
      keep[i] = upper ? ~masks[i] : masks[i];
      rot[i] = upper ? 32 - s : s;
    }
  }
  // Transposes every word of x; round by round over all words, so the
  // shuffles of one round are independent and overlap their latency.
  template <int A, int B>
  __device__ __forceinline__ void operator()(uint32_t (&x)[A][B]) const {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const uint32_t other = __shfl_xor_sync(kFull, x[a][b], 16 >> i);
          const uint32_t moved = __funnelshift_l(other, other, rot[i]);
          x[a][b] = (x[a][b] & keep[i]) | (moved & ~keep[i]);
        }
    }
  }
};

// Adds two collision words a and b (weight 1 each) into the NP bit-planes of
// a per-bit counter: a full adder into plane 0, then the carry ripples up.
template <int NP>
__device__ __forceinline__ void add2_planes(uint32_t (&p)[NP], uint32_t a,
                                            uint32_t b) {
  uint32_t carry = (p[0] & a) | (p[0] & b) | (a & b);
  p[0] ^= a ^ b;
#pragma unroll
  for (int k = 1; k < NP; ++k) {
    const uint32_t t = p[k] & carry;
    p[k] ^= carry;
    carry = t;
  }
}
