// Fused softmax attention O = softmax(Q K^T * hd^-1/2) V, forward, with an
// optional causal mask (key position <= query position, top-left aligned).
//
// Replaces: flash_attention_pallas / _flash_kernel in
// src/repro/kernels/flash_attention.py.
//
// Bound on the H100: operations. Every unmasked (query, key) pair costs
// 2 hd FLOPs for the score and 2 hd for the P.V product, so at S = T = 4096
// and hd = 64 the work is ~4 * 4096^2/2 * 64 FLOPs per head against
// 3 * 4096 * 64 elements read and 4096 * 64 written: over a thousand FLOPs
// per byte, far above both the float32 and the bf16 tensor-core balance
// points. The (S, T) score matrix never reaches device memory.
//
// Design: one block owns one (batch*head, 64-query tile) pair and loops
// over 64-key tiles, keeping the running row max m, row sum l and the
// (64, hd) accumulator in registers (the online-softmax recurrence), so
// nothing carries over between blocks. 256 threads as a 16 x 16 grid: a
// thread owns 4 query rows x 4 key columns of the score tile and 4 rows x
// hd/16 columns of the accumulator. Q is staged once, transposed, in shared
// memory; the K tile (transposed) and then the V tile share one buffer, so
// a block needs ~51 KB at hd = 64 and ~85 KB at hd = 128 (several blocks
// per SM). Q.K^T reads one float4 of Q and one of K per step for 16 FMAs.
// Row max and row sum reduce across the 16 lanes of a row with warp
// shuffles. Under the causal mask a block stops at the last key tile that
// touches its diagonal, and blocks are issued heaviest (last query tile)
// first so the ragged causal work spreads over the SMs. Ragged S and T are
// masked in the kernel: the caller pads nothing. hd up to 128; columns past
// hd are zero in shared memory and never stored.
//
// Numerics: IEEE float32 FMA throughout (no TF32, no tensor cores, accurate
// expf); bf16 inputs are widened on load and the output is rounded once to
// bf16 on store, as the reference does. A row whose keys are all masked
// outputs 0. Using wgmma/TMA for the two products is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps transposed rows 16-byte aligned

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
constexpr int smem_floats() {
  // Q^T (HD, BQ+PAD) + one buffer for K^T (HD, BK+PAD), later V (BK, HD),
  // + P^T (BK, BQ+PAD)
  return HD * (BQ + PAD) + HD * (BK + PAD) + BK * (BQ + PAD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int s_len, int t_len,
             int hd, int causal, float scale) {
  constexpr int QS = BQ + PAD;  // row stride of Q^T and P^T
  constexpr int KS = BK + PAD;  // row stride of K^T
  constexpr int NV = HD / 16;   // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;          // (HD, QS): Q^T
  float* kv = qt + HD * QS;  // (HD, KS): K^T, then (BK, HD): V
  float* pt = kv + HD * KS;  // (BK, QS): P^T

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qb * BQ;
  const size_t bh = blockIdx.y;
  const T* qg = q + bh * s_len * hd;
  const T* kg = k + bh * t_len * hd;
  const T* vg = v + bh * t_len * hd;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    float x = 0.f;
    if (q0 + r < s_len && d < hd) x = to_f32(qg[static_cast<size_t>(q0 + r) * hd + d]);
    qt[d * QS + r] = x;
  }

  float m[4], l[4], acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[i][e] = 0.f;
  }

  int n_kt = (t_len + BK - 1) / BK;
  if (causal) {
    const int q_last = min(q0 + BQ, s_len) - 1;
    n_kt = min(n_kt, q_last / BK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's V and P are no longer read
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int c = idx / HD, d = idx % HD;
      float x = 0.f;
      if (k0 + c < t_len && d < hd) x = to_f32(kg[static_cast<size_t>(k0 + c) * hd + d]);
      kv[d * KS + c] = x;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * QS + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kv + d * KS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = kpos < t_len && (!causal || kpos <= qpos);
        sc[i][j] = ok ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new == -INFINITY) {  // every key so far masked: nothing to add
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
      } else {
        alpha = expf(m[i] - m_new);  // exp(-inf) = 0 on the row's first keys
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[i][j] = expf(sc[i][j] - m_new);  // masked: exp(-inf) = 0
          sum += p[i][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[i] = m_new;
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[i][e] *= alpha;
    }

    __syncthreads();  // every thread is done with K^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * QS + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int c = idx / HD, d = idx % HD;
      float x = 0.f;
      if (k0 + c < t_len && d < hd) x = to_f32(vg[static_cast<size_t>(k0 + c) * hd + d]);
      kv[c * HD + d] = x;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pc = *reinterpret_cast<const float4*>(pt + c * QS + ty * 4);
      const float pv[4] = {pc.x, pc.y, pc.z, pc.w};
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const float x = kv[c * HD + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pv[i], x, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_len) continue;
    T* out = o + (bh * s_len + row) * hd;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int d = tx + 16 * e;
      if (d < hd) store(out + d, l[i] > 0.f ? acc[i][e] / l[i] : 0.f);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, int bh, int s_len,
                   int t_len, int hd, int causal, float scale, cudaStream_t stream) {
  const int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s_len + BQ - 1) / BQ, bh);
  flash_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(q, k, v, o, s_len, t_len, hd,
                                                       causal, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int bh, int s_len, int t_len,
             int hd, int causal, float scale, cudaStream_t stream) {
  if (bh <= 0 || s_len <= 0 || t_len <= 0 || hd <= 0 || hd > 128 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (hd <= 16)
    err = launch<T, 16>(q, k, v, o, bh, s_len, t_len, hd, causal, scale, stream);
  else if (hd <= 32)
    err = launch<T, 32>(q, k, v, o, bh, s_len, t_len, hd, causal, scale, stream);
  else if (hd <= 64)
    err = launch<T, 64>(q, k, v, o, bh, s_len, t_len, hd, causal, scale, stream);
  else
    err = launch<T, 128>(q, k, v, o, bh, s_len, t_len, hd, causal, scale, stream);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (bh, s, hd), k and v (bh, t, hd), o (bh, s, hd): float32, contiguous, on
// the device. scale is hd^-1/2; causal is 0 or 1.
int flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                        int bh, int s_len, int t_len, int hd, int causal, float scale,
                        cudaStream_t stream) {
  return dispatch(q, k, v, o, bh, s_len, t_len, hd, causal, scale, stream);
}

// The same with bfloat16 q, k, v and o; arithmetic in float32.
int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o, int bh, int s_len,
                         int t_len, int hd, int causal, float scale,
                         cudaStream_t stream) {
  return dispatch(q, k, v, o, bh, s_len, t_len, hd, causal, scale, stream);
}

}  // extern "C"
