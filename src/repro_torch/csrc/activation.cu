// Sort activation (SDA) of a whole query batch: for every (subspace s,
// query q), the threshold tau and the retrieved count of
// core/activation.py's sort_activation, bit for bit, ties included.
//
// Replaces: no Pallas kernel. The reference's sort_activation
// (src/repro/core/activation.py) is plain jnp that XLA fuses on the TPU;
// the port's eager version runs its 32-round bisection as 387 separate
// operations a batch over (N_s, Q, K) int64 keys. This kernel does the
// whole batch in one launch and writes no (N_s, Q, K) tensor.
//
// Bound on the H100: the bytes of the centroid distances. At SIFT1M's
// batch (N_s 6, Q 10,000, sqrt_k 32) they are 15.4 MB, 4.6 us at 3.35
// TB/s; the 6.1e7 cell sums at one 32-bit operation each take 0.9 us at
// 67e12. The bisection's rounds re-read every cell (from registers or
// shared memory), so the kernel's own work is ~10-14 rounds x 3-4 integer
// instructions a cell: the CUDA cores' integer rate and shared memory's
// bandwidth, not device memory, bound this design.
//
// Design: one warp a problem (s, q). A block takes one subspace and
// kQueries queries; it stages the subspace's (sqrt_k, sqrt_k) int32 sizes
// in shared memory once (lane-major, zero-padded to 32 NT cells), and each
// warp walks its queries one after the other.
// - Lane l owns cells c = 32 t + l, t < NT (NT = the least power of two
//   with 32 NT >= K, a template parameter up to 128, K up to 4096). It
//   forms each cell sum d1[i] + d2[j] (one f32 add, the rows staged in the
//   warp's shared memory) and keeps its total-order key. Up to NT = 32
//   (SIFT1M's K = 1024) keys and sizes sit in registers; past it (GIST1M's
//   4096) 128 keys a lane would crowd out the rest, so keys and sizes sit
//   in shared memory, lane-major, four of each read with two 16-byte loads.
// - The bisection is the torch version's: lo/hi start at the least and
//   largest key, mid = lo + floor((hi - lo) / 2), rounds of a masked
//   integer weight sum and a warp reduction (__reduce_add_sync). It stops
//   early, with the torch version's answer, once lo == hi (hi always
//   satisfies: the largest key's weight is the total, and the target is at
//   most the total). A NaN target runs all 32 rounds, as the torch version
//   does.
// - Weights are summed as integers: exact and independent of order. They
//   are compared in f32 with the target min(f32(alpha_n), f32(total)), as
//   the torch version compares its f32 sums, which are exact below 2^24.
// - The tie replay walks t in order: `below` sums the cells with sum < tau,
//   then a ballot skips every t without a tie (sum == tau in f32, so -0 and
//   +0 tie), and for the others a warp prefix scan over the lanes gives the
//   running total in flat index order (i sqrt_k + j); the first tie cell
//   whose total reaches the target gives `retrieved`.
// - Integer sums run in int32 where the sizes' absolute total fits it
//   (every partial sum then fits, whatever the sizes' signs); a block whose
//   subspace does not, and every problem with K past 4096 (the stream
//   kernel), runs stream_problem: the bisection in int64 for all 32 rounds
//   (or until lo == hi), the cell sums formed again each round from global
//   memory. Adapting to the shape this way takes no knob.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // warps a block: one problem each at a time
constexpr int kQueries = 16;  // queries a block (4 a warp)
constexpr int kRegNT = 32;    // cells a lane keeps in registers: K <= 1024
constexpr int kMaxNT = 128;   // cells a lane on the on-chip route: K <= 4096
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t sort_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The inverse of sort_key on [0, 2^32); key 2^32, which only an unsatisfiable
// (NaN) target reaches, maps to the torch version's -0.0 as its int64 does.
__device__ __forceinline__ float key_to_f32(long long key) {
  const uint32_t b = key >= 0x80000000ll ? static_cast<uint32_t>(key - 0x80000000ll)
                                         : static_cast<uint32_t>(0xFFFFFFFFll - key);
  return __uint_as_float(b);
}

__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// torch.minimum(alpha, total): NaN if alpha is.
__device__ __forceinline__ float target_of(float alpha, long long total) {
  const float t = static_cast<float>(total);
  return alpha != alpha ? alpha : fminf(alpha, t);
}

// The torch version's midpoint, lo + floor((hi - lo) / 2) (lo passes hi only
// for a NaN target).
__device__ __forceinline__ long long midpoint(long long lo, long long hi) {
  return lo + ((hi - lo) >> 1);
}

// One problem with any K, sums in int64, the cells read from global memory
// (d1, d2: the problem's rows; sz: the subspace's K sizes). Lanes take
// j = lane, lane + 32, ... of each row i, so a row's chunks come in flat
// index order.
__device__ void stream_problem(const float* __restrict__ d1, const float* __restrict__ d2,
                               const int* __restrict__ sz, int sqrt_k, float alpha,
                               float* tau_out, float* ret_out) {
  const int lane = threadIdx.x & 31;
  uint32_t kmin = 0xFFFFFFFFu, kmax = 0u;
  long long total = 0;
  for (int i = 0; i < sqrt_k; ++i) {
    const float a = d1[i];
    for (int j = lane; j < sqrt_k; j += 32) {
      const uint32_t k = sort_key(__fadd_rn(a, d2[j]));
      kmin = min(kmin, k);
      kmax = max(kmax, k);
      total += sz[i * sqrt_k + j];
    }
  }
  kmin = __reduce_min_sync(kFull, kmin);
  kmax = __reduce_max_sync(kFull, kmax);
  const float target = target_of(alpha, warp_sum64(total));
  long long lo = kmin, hi = kmax;
  for (int r = 0; r < 32 && !(lo == hi && target == target); ++r) {
    const long long mid = midpoint(lo, hi);
    long long w = 0;
    for (int i = 0; i < sqrt_k; ++i) {
      const float a = d1[i];
      for (int j = lane; j < sqrt_k; j += 32)
        if (sort_key(__fadd_rn(a, d2[j])) <= static_cast<uint32_t>(mid))
          w += sz[i * sqrt_k + j];
    }
    if (static_cast<float>(warp_sum64(w)) >= target) hi = mid; else lo = mid + 1;
  }
  const float tau = key_to_f32(lo);
  long long below = 0;
  for (int i = 0; i < sqrt_k; ++i) {
    const float a = d1[i];
    for (int j = lane; j < sqrt_k; j += 32)
      if (__fadd_rn(a, d2[j]) < tau) below += sz[i * sqrt_k + j];
  }
  below = warp_sum64(below);
  // no tie cell reaching the target (a NaN target): argmax's index 0
  long long ret = below + (__fadd_rn(d1[0], d2[0]) == tau ? sz[0] : 0);
  long long run = below;
  bool found = false;
  for (int i = 0; i < sqrt_k && !found; ++i) {
    const float a = d1[i];
    for (int j0 = 0; j0 < sqrt_k && !found; j0 += 32) {
      const int j = j0 + lane;
      const bool tie = j < sqrt_k && __fadd_rn(a, d2[j]) == tau;
      if (!__ballot_sync(kFull, tie)) continue;
      long long v = tie ? sz[i * sqrt_k + j] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += u;
      }
      const long long cs = run + v;
      const unsigned hit = __ballot_sync(kFull, tie && static_cast<float>(cs) >= target);
      if (hit) {
        ret = __shfl_sync(kFull, cs, __ffs(hit) - 1);
        found = true;
      } else {
        run += __shfl_sync(kFull, v, 31);
      }
    }
  }
  if (lane == 0) {
    *tau_out = tau;
    *ret_out = static_cast<float>(ret);
  }
}

// Sums the block's sizes and their absolute values (int64) into every thread.
__device__ void block_totals(const int* __restrict__ sz, int k2, long long* red,
                             long long& total, long long& abs_total) {
  long long t = 0, a = 0;
  for (int c = threadIdx.x; c < k2; c += blockDim.x) {
    const int v = sz[c];
    t += v;
    a += v < 0 ? -static_cast<long long>(v) : v;
  }
  t = warp_sum64(t);
  a = warp_sum64(a);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[2 * warp] = t;
    red[2 * warp + 1] = a;
  }
  __syncthreads();
  total = abs_total = 0;
  for (int w = 0; w < kWarps; ++w) {
    total += red[2 * w];
    abs_total += red[2 * w + 1];
  }
}

// Four consecutive words of a lane's row in shared memory, read anew every
// round (asm volatile: the compiler may not hold all NT in registers).
__device__ __forceinline__ int4 lds4(const void* p) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

// The on-chip route: K <= 32 NT cells. Where NT <= kRegNT a lane keeps its keys
// and sizes in registers; past that (K from 1,025 to 4,096) NT keys a lane
// would not fit beside the rest, so they sit in the warp's shared memory,
// lane-major like the sizes, and every round reads four keys and four sizes
// with two 16-byte loads. Shared memory: the block's totals; the sizes
// lane-major (lane l's NT at l (NT + 4), zero-padded past K: the warp's
// eight-lane phases of a 16-byte load fall on distinct banks); each warp's
// keys, likewise (NT > kRegNT); each warp's d1 | d2 rows.
template <int NT>
__global__ void __launch_bounds__(kWarps * 32)
sort_activation_kernel(const float* __restrict__ d1s, const float* __restrict__ d2s,
                       const int* __restrict__ sizes, float alpha, float* __restrict__ taus,
                       float* __restrict__ retrieved, int q, int sqrt_k) {
  constexpr bool kInRegs = NT <= kRegNT;
  // loops over a lane's cells unroll whole for registers; in shared memory a
  // whole unroll of NT = 128 batches loads past the register file
  constexpr int kUnroll = kInRegs ? NT : 4;
  constexpr int kStride = NT + 4;
  extern __shared__ long long smem_ll[];
  long long* red = smem_ll;                                    // 2 kWarps
  int* sz_s = reinterpret_cast<int*>(smem_ll + 2 * kWarps);  // 32 x kStride
  uint32_t* keys_s = reinterpret_cast<uint32_t*>(sz_s + 32 * kStride);
  float* rows = reinterpret_cast<float*>(keys_s + (kInRegs ? 0 : kWarps * 32 * kStride));
  const int s = blockIdx.y;
  const int k2 = sqrt_k * sqrt_k;
  const int* sz_g = sizes + static_cast<size_t>(s) * k2;
  for (int c = threadIdx.x; c < 32 * NT; c += blockDim.x)
    sz_s[(c & 31) * kStride + (c >> 5)] = c < k2 ? sz_g[c] : 0;
  long long total, abs_total;
  block_totals(sz_g, k2, red, total, abs_total);  // its barrier also publishes sz_s
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kQueries;
  const int q1 = min(q, q0 + kQueries);
  if (abs_total > 0x7FFFFFFFll) {  // int32 partial sums could overflow
    for (int qi = q0 + warp; qi < q1; qi += kWarps) {
      const size_t p = static_cast<size_t>(s) * q + qi;
      stream_problem(d1s + p * sqrt_k, d2s + p * sqrt_k, sz_g, sqrt_k, alpha, taus + p,
                     retrieved + p);
    }
    return;
  }
  const float target = target_of(alpha, total);
  const bool numeric = target == target;
  const int* my_sz = sz_s + lane * kStride;
  uint32_t* my_keys = keys_s + (warp * 32 + lane) * kStride;  // NT > kRegNT only
  int sz[kInRegs ? NT : 1];
  uint32_t key[kInRegs ? NT : 1];
  if constexpr (kInRegs) {
#pragma unroll
    for (int t = 0; t < NT; ++t) sz[t] = my_sz[t];
  }
// cell 32 t + lane's key and size (in registers, t a constant after unrolling)
#define KEY(t) (kInRegs ? key[kInRegs ? (t) : 0] : my_keys[t])
#define SIZE(t) (kInRegs ? sz[kInRegs ? (t) : 0] : my_sz[t])
  // (i, j) of cell c = 32 t + lane advance by (32 / sqrt_k, 32 % sqrt_k) a step
  const int di = 32 / sqrt_k, dj = 32 % sqrt_k;
  const int i0 = lane / sqrt_k, j0 = lane % sqrt_k;
  float* r1 = rows + warp * 2 * sqrt_k;
  float* r2 = r1 + sqrt_k;
  for (int qi = q0 + warp; qi < q1; qi += kWarps) {
    const size_t p = static_cast<size_t>(s) * q + qi;
    __syncwarp();
    for (int x = lane; x < sqrt_k; x += 32) {
      r1[x] = d1s[p * sqrt_k + x];
      r2[x] = d2s[p * sqrt_k + x];
    }
    __syncwarp();
    uint32_t kmin = 0xFFFFFFFFu, kmax = 0u;
    {
      int i = i0, j = j0;
#pragma unroll kUnroll
      for (int t = 0; t < NT; ++t) {
        uint32_t k = 0u;  // a padded cell: size 0, and key 0's value is a NaN
        if (32 * t + lane < k2) {
          k = sort_key(__fadd_rn(r1[i], r2[j]));
          kmin = min(kmin, k);
          kmax = max(kmax, k);
        }
        if constexpr (kInRegs) key[kInRegs ? t : 0] = k; else my_keys[t] = k;
        i += di;
        j += dj;
        if (j >= sqrt_k) {
          j -= sqrt_k;
          ++i;
        }
      }
    }
    kmin = __reduce_min_sync(kFull, kmin);
    kmax = __reduce_max_sync(kFull, kmax);
    long long lo = kmin, hi = kmax;
    for (int r = 0; r < 32 && !(numeric && lo == hi); ++r) {
      const long long mid = midpoint(lo, hi);
      const uint32_t m = static_cast<uint32_t>(mid);
      int acc[4] = {0, 0, 0, 0};  // four chains, so the adds overlap
      if constexpr (kInRegs) {
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[t & 3] += key[t] <= m ? sz[t] : 0;
      } else {
#pragma unroll 8
        for (int t = 0; t < NT; t += 4) {
          const int4 k = lds4(my_keys + t);
          const int4 v = lds4(my_sz + t);
          acc[0] += static_cast<uint32_t>(k.x) <= m ? v.x : 0;
          acc[1] += static_cast<uint32_t>(k.y) <= m ? v.y : 0;
          acc[2] += static_cast<uint32_t>(k.z) <= m ? v.z : 0;
          acc[3] += static_cast<uint32_t>(k.w) <= m ? v.w : 0;
        }
      }
      const int w = __reduce_add_sync(kFull, (acc[0] + acc[1]) + (acc[2] + acc[3]));
      if (static_cast<float>(w) >= target) hi = mid; else lo = mid + 1;
    }
    const float tau = key_to_f32(lo);
    int below = 0;
#pragma unroll kUnroll
    for (int t = 0; t < NT; ++t) below += key_to_f32(KEY(t)) < tau ? SIZE(t) : 0;
    below = __reduce_add_sync(kFull, below);
    const bool tie0 = __shfl_sync(kFull, key_to_f32(KEY(0)) == tau, 0);
    int ret = below + (tie0 ? sz_s[0] : 0);  // no tie reaching the target: index 0
    int run = below;
    bool found = false;
#pragma unroll kUnroll
    for (int t = 0; t < NT; ++t) {
      if (!found) {
        const bool tie = key_to_f32(KEY(t)) == tau;
        if (__ballot_sync(kFull, tie)) {
          int v = tie ? SIZE(t) : 0;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(kFull, v, o);
            if (lane >= o) v += u;
          }
          const int cs = run + v;
          const unsigned hit = __ballot_sync(kFull, tie && static_cast<float>(cs) >= target);
          if (hit) {
            ret = __shfl_sync(kFull, cs, __ffs(hit) - 1);
            found = true;
          } else {
            run += __shfl_sync(kFull, v, 31);
          }
        }
      }
    }
    if (lane == 0) {
      taus[p] = tau;
      retrieved[p] = static_cast<float>(ret);
    }
  }
#undef KEY
#undef SIZE
}

// K past the on-chip route: one warp a problem, everything from global memory.
__global__ void __launch_bounds__(kWarps * 32)
sort_activation_stream_kernel(const float* __restrict__ d1s, const float* __restrict__ d2s,
                              const int* __restrict__ sizes, float alpha,
                              float* __restrict__ taus, float* __restrict__ retrieved, int q,
                              int sqrt_k) {
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int q1 = min(q, static_cast<int>(blockIdx.x + 1) * kQueries);
  const int* sz = sizes + static_cast<size_t>(s) * sqrt_k * sqrt_k;
  for (int qi = blockIdx.x * kQueries + warp; qi < q1; qi += kWarps) {
    const size_t p = static_cast<size_t>(s) * q + qi;
    stream_problem(d1s + p * sqrt_k, d2s + p * sqrt_k, sz, sqrt_k, alpha, taus + p,
                   retrieved + p);
  }
}

// Where a problem's K cells live: 0 registers (K <= 32 kRegNT), 1 shared
// memory (K <= 32 kMaxNT), 2 global memory (the stream kernel).
int route_of(long long k2) { return k2 > 32 * kMaxNT ? 2 : k2 > 32 * kRegNT ? 1 : 0; }

template <int NT>
int launch_on_chip(dim3 grid, const float* d1s, const float* d2s, const int* sizes, float alpha,
                   float* taus, float* retrieved, int q, int sqrt_k, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(32) * (NT + 4) * sizeof(int);  // sizes or keys
  const size_t smem = 2 * kWarps * sizeof(long long) + (NT <= kRegNT ? 1 : 1 + kWarps) * rows +
                      static_cast<size_t>(kWarps) * 2 * sqrt_k * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(sort_activation_kernel<NT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sort_activation_kernel<NT><<<grid, kWarps * 32, smem, stream>>>(d1s, d2s, sizes, alpha, taus,
                                                                  retrieved, q, sqrt_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* activation_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// route_of(sqrt_k^2): the label the wrapper counts a launch under.
int sort_activation_route(int sqrt_k) { return route_of(static_cast<long long>(sqrt_k) * sqrt_k); }

// d1s, d2s (n_sub, q, sqrt_k) float32; sizes (n_sub, sqrt_k, sqrt_k) int32;
// taus, retrieved (n_sub, q) float32, every element written. alpha is
// alpha_n rounded to float32. All contiguous, on the device.
int sort_activation_f32(const float* d1s, const float* d2s, const int* sizes, float alpha,
                        float* taus, float* retrieved, int n_sub, int q, int sqrt_k,
                        cudaStream_t stream) {
  if (n_sub < 0 || q < 0 || sqrt_k <= 0 || n_sub > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_sub == 0 || q == 0) return 0;
  const dim3 grid((q + kQueries - 1) / kQueries, n_sub);
  const long long k2 = static_cast<long long>(sqrt_k) * sqrt_k;
  if (route_of(k2) == 2) {
    sort_activation_stream_kernel<<<grid, kWarps * 32, 0, stream>>>(d1s, d2s, sizes, alpha, taus,
                                                                    retrieved, q, sqrt_k);
    return static_cast<int>(cudaGetLastError());
  }
  const int nt = static_cast<int>((k2 + 31) / 32);
#define ACT_LAUNCH(N)                                                                      \
  if (nt <= N)                                                                             \
    return launch_on_chip<N>(grid, d1s, d2s, sizes, alpha, taus, retrieved, q, sqrt_k, stream);
  ACT_LAUNCH(1)
  ACT_LAUNCH(2)
  ACT_LAUNCH(4)
  ACT_LAUNCH(8)
  ACT_LAUNCH(16)
  ACT_LAUNCH(32)
  ACT_LAUNCH(64)
  ACT_LAUNCH(128)
#undef ACT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
