// Fused k-means assignment for P independent (points, centroids) pairs in
// one launch: for each point of each pair, the index of its nearest centroid
// (first index on ties, as jnp.argmin) and that squared distance.
//
// Replaces: kmeans_assign_pallas / _assign_kernel in
// src/repro/kernels/kmeans_assign.py (which the reference calls once per
// (subspace, half) per Lloyd iteration).
//
// Bound on the H100: reading the points once. In the build's Lloyd loop a
// launch sees P = 2 N_s = 12 pairs of n = 10^6 points of w = 4 floats
// (192 MB) against k = 32 centroids each, and writes 96 MB: 288 MB, about
// 0.086 ms at 3.35 TB/s. Each point costs 2 k w + 3 k = 352 FLOPs for 16
// bytes read, about 22 FLOP/byte, close to the card's float32 balance
// point, so instruction issue is the other limit; tensor cores do not help
// a one-pass stream at w = 4.
//
// Design: the grid is (point tiles, P), one pair per blockIdx.y. A block
// stages only its own pair's k x w centroids in shared memory and their
// norms beside them; thread j computes centroid j's norm while it stages
// the row, so one barrier suffices. Each thread owns PTS points of its
// tile, loaded up front (one 16-byte load per 4 floats, neighbouring threads
// on neighbouring points, PTS loads in flight), holds them in registers and
// walks the k centroids in order with a strict '<', reading each centroid
// row once for all its points (a shared-memory broadcast). Distances keep
// the single-pair kernel's arithmetic exactly: |x|^2 and x.c by fmaf in
// feature order, then max((|x|^2 + |c|^2) - 2 x.c, 0). Zero padding of a
// pair's rows to the launch's width w is exact (fmaf(0, c, s) == s), so a
// pair padded to w gives bit for bit what it gives at its own width. The
// single-pair entry point launches the same kernel with P = 1.
//
// Past shared memory (k (w + 1) floats above 227 KB, e.g. IVF's k = 1024
// lists of w = 128: 528 KB) a second kernel takes over. Its block stages
// the centroids in tiles that fit, one after another in index order, and
// each thread keeps its point's running (min, argmin) in registers across
// the tiles with the same strict '<'; the distance is the same arithmetic
// as above, bit for bit, so a point's answer does not depend on the tile
// size and the first index still wins a tie. Bound at IVF's shape (n =
// 10^6, w = 128, k = 1024): the operations, 2 k w + 3 k = 265 kFLOP a point,
// 265 GFLOP, ~3.96 ms at 67 TFLOP/s (the points are 512 MB, 0.155 ms). One
// point a thread (its 128 features fill the registers), four centroids'
// dot products side by side for independent fmaf chains, each centroid row
// a shared-memory broadcast; rows are staged with a stride of w + 4 (w + 1
// when w % 4 != 0) floats so that the staging stores do not collide in
// one bank.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

// points a thread holds: as many as keep the point registers near 64
template <int MAXW>
__host__ __device__ constexpr int points_per_thread() {
  return MAXW <= 16 ? 4 : (MAXW <= 32 ? 2 : 1);
}

// MAXW: the widest row the instantiation takes. EXACT: the row width is
// MAXW (the feature loops have constant bounds). VEC: w % 4 == 0, so rows
// load as float4 from global and shared memory.
template <int MAXW, bool EXACT, bool VEC>
__global__ void __launch_bounds__(kThreads)
assign_pairs_kernel(const float* __restrict__ xs, const float* __restrict__ cs,
                    int* __restrict__ assign, float* __restrict__ dmin, int n,
                    int k, int w) {
  constexpr int PTS = points_per_thread<MAXW>();
  const int wd = EXACT ? MAXW : w;
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;            // (k, wd)
  float* c2_s = smem + k * wd;  // (k,)
  const int pair = blockIdx.y;
  const float* c = cs + static_cast<size_t>(pair) * k * wd;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    float s = 0.f;
    for (int t = 0; t < wd; ++t) {
      const float v = __ldg(c + static_cast<size_t>(j) * wd + t);
      c_s[j * wd + t] = v;
      s = fmaf(v, v, s);
    }
    c2_s[j] = s;
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(pair) * n;
  const float* x = xs + base * wd;
  const long long p0 = static_cast<long long>(blockIdx.x) * kThreads * PTS + threadIdx.x;
  float xv[PTS][MAXW];
  float x2[PTS];
#pragma unroll
  for (int i = 0; i < PTS; ++i) {
    const long long p = p0 + static_cast<long long>(i) * kThreads;
    const bool live = p < n;
    const float* row = x + (live ? p : 0) * wd;
    if (VEC) {
#pragma unroll
      for (int t4 = 0; t4 < MAXW / 4; ++t4) {
        if (4 * t4 < wd) {
          const float4 v = live ? __ldg(reinterpret_cast<const float4*>(row) + t4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          xv[i][4 * t4] = v.x;
          xv[i][4 * t4 + 1] = v.y;
          xv[i][4 * t4 + 2] = v.z;
          xv[i][4 * t4 + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < MAXW; ++t) {
        if (t < wd) xv[i][t] = live ? __ldg(row + t) : 0.f;
      }
    }
    x2[i] = 0.f;
#pragma unroll
    for (int t = 0; t < MAXW; ++t) {
      if (t < wd) x2[i] = fmaf(xv[i][t], xv[i][t], x2[i]);
    }
  }

  int best[PTS];
  float best_d[PTS];
#pragma unroll
  for (int i = 0; i < PTS; ++i) {
    best[i] = 0;
    best_d[i] = CUDART_INF_F;
  }
  for (int j = 0; j < k; ++j) {
    const float* cj = c_s + j * wd;
    float dot[PTS];
#pragma unroll
    for (int i = 0; i < PTS; ++i) dot[i] = 0.f;
    if (VEC) {
#pragma unroll
      for (int t4 = 0; t4 < MAXW / 4; ++t4) {
        if (4 * t4 < wd) {
          const float4 cv = reinterpret_cast<const float4*>(cj)[t4];
#pragma unroll
          for (int i = 0; i < PTS; ++i) {
            dot[i] = fmaf(xv[i][4 * t4], cv.x, dot[i]);
            dot[i] = fmaf(xv[i][4 * t4 + 1], cv.y, dot[i]);
            dot[i] = fmaf(xv[i][4 * t4 + 2], cv.z, dot[i]);
            dot[i] = fmaf(xv[i][4 * t4 + 3], cv.w, dot[i]);
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < MAXW; ++t) {
        if (t < wd) {
          const float cv = cj[t];
#pragma unroll
          for (int i = 0; i < PTS; ++i) dot[i] = fmaf(xv[i][t], cv, dot[i]);
        }
      }
    }
    const float c2 = c2_s[j];
#pragma unroll
    for (int i = 0; i < PTS; ++i) {
      const float v = fmaxf((x2[i] + c2) - 2.0f * dot[i], 0.0f);
      if (v < best_d[i]) {
        best_d[i] = v;
        best[i] = j;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PTS; ++i) {
    const long long p = p0 + static_cast<long long>(i) * kThreads;
    if (p < n) {
      assign[base + p] = best[i];
      dmin[base + p] = best_d[i];
    }
  }
}

// centroids whose dot products a tiled thread runs side by side
constexpr int kGroup = 4;
// shared memory a block may hold (H100: 227 KB)
constexpr int kMaxSmem = 232448;

// The tiled kernel: one point a thread, the k centroids staged tile_k at a
// time with a row stride of ws floats (see the header).
template <int MAXW, bool VEC>
__global__ void __launch_bounds__(kThreads)
assign_pairs_tiled_kernel(const float* __restrict__ xs, const float* __restrict__ cs,
                          int* __restrict__ assign, float* __restrict__ dmin, int n,
                          int k, int w, int ws, int tile_k) {
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;              // (tile_k, ws)
  float* c2_s = smem + tile_k * ws;  // (tile_k,)
  const int pair = blockIdx.y;
  const float* c = cs + static_cast<size_t>(pair) * k * w;
  const size_t base = static_cast<size_t>(pair) * n;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = p < n;
  const float* row = xs + (base + (live ? p : 0)) * w;
  float xv[MAXW];
  if (VEC) {
#pragma unroll
    for (int t4 = 0; t4 < MAXW / 4; ++t4) {
      if (4 * t4 < w) {
        const float4 v = live ? __ldg(reinterpret_cast<const float4*>(row) + t4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        xv[4 * t4] = v.x;
        xv[4 * t4 + 1] = v.y;
        xv[4 * t4 + 2] = v.z;
        xv[4 * t4 + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < MAXW; ++t) {
      if (t < w) xv[t] = live ? __ldg(row + t) : 0.f;
    }
  }
  float x2 = 0.f;
#pragma unroll
  for (int t = 0; t < MAXW; ++t) {
    if (t < w) x2 = fmaf(xv[t], xv[t], x2);
  }

  int best = 0;
  float best_d = CUDART_INF_F;
  for (int j0 = 0; j0 < k; j0 += tile_k) {
    const int kn = min(tile_k, k - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int j = threadIdx.x; j < kn; j += kThreads) {
      const float* src = c + static_cast<size_t>(j0 + j) * w;
      float* dst = c_s + j * ws;
      float s = 0.f;
      if (VEC) {
#pragma unroll 8
        for (int t4 = 0; t4 < w / 4; ++t4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(src) + t4);
          reinterpret_cast<float4*>(dst)[t4] = v;
          s = fmaf(v.x, v.x, s);
          s = fmaf(v.y, v.y, s);
          s = fmaf(v.z, v.z, s);
          s = fmaf(v.w, v.w, s);
        }
      } else {
        for (int t = 0; t < w; ++t) {
          const float v = __ldg(src + t);
          dst[t] = v;
          s = fmaf(v, v, s);
        }
      }
      c2_s[j] = s;
    }
    __syncthreads();
    int j = 0;
    for (; j + kGroup <= kn; j += kGroup) {
      float dot[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) dot[g] = 0.f;
      if (VEC) {
#pragma unroll
        for (int t4 = 0; t4 < MAXW / 4; ++t4) {
          if (4 * t4 < w) {
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              const float4 cv = reinterpret_cast<const float4*>(c_s + (j + g) * ws)[t4];
              dot[g] = fmaf(xv[4 * t4], cv.x, dot[g]);
              dot[g] = fmaf(xv[4 * t4 + 1], cv.y, dot[g]);
              dot[g] = fmaf(xv[4 * t4 + 2], cv.z, dot[g]);
              dot[g] = fmaf(xv[4 * t4 + 3], cv.w, dot[g]);
            }
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < MAXW; ++t) {
          if (t < w) {
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
              dot[g] = fmaf(xv[t], c_s[(j + g) * ws + t], dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {  // in index order: the first index wins
        const float v = fmaxf((x2 + c2_s[j + g]) - 2.0f * dot[g], 0.0f);
        if (v < best_d) {
          best_d = v;
          best = j0 + j + g;
        }
      }
    }
    for (; j < kn; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < MAXW; ++t) {
        if (t < w) dot = fmaf(xv[t], c_s[j * ws + t], dot);
      }
      const float v = fmaxf((x2 + c2_s[j]) - 2.0f * dot, 0.0f);
      if (v < best_d) {
        best_d = v;
        best = j0 + j;
      }
    }
  }
  if (live) {
    assign[base + p] = best;
    dmin[base + p] = best_d;
  }
}

template <int MAXW, bool VEC>
int launch_tiled(const float* xs, const float* cs, int* assign, float* dmin,
                 int n_pairs, int n, int k, int w, cudaStream_t stream) {
  auto kernel = assign_pairs_tiled_kernel<MAXW, VEC>;
  const int ws = VEC ? w + 4 : (w | 1);
  const int tile_k = std::min(k, kMaxSmem / (4 * (ws + 1)));
  const size_t smem = static_cast<size_t>(tile_k) * (ws + 1) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), n_pairs);
  kernel<<<grid, kThreads, smem, stream>>>(xs, cs, assign, dmin, n, k, w, ws, tile_k);
  return static_cast<int>(cudaGetLastError());
}

int launch_tiled_any(const float* xs, const float* cs, int* assign, float* dmin,
                     int n_pairs, int n, int k, int w, cudaStream_t stream) {
  if (w % 4 == 0) {
    if (w <= 16) return launch_tiled<16, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
    if (w <= 32) return launch_tiled<32, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
    if (w <= 64) return launch_tiled<64, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
    return launch_tiled<128, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  }
  if (w <= 16) return launch_tiled<16, false>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  if (w <= 32) return launch_tiled<32, false>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  if (w <= 64) return launch_tiled<64, false>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  return launch_tiled<128, false>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
}

template <int MAXW, bool EXACT, bool VEC>
int launch(const float* xs, const float* cs, int* assign, float* dmin,
           int n_pairs, int n, int k, int w, cudaStream_t stream) {
  auto kernel = assign_pairs_kernel<MAXW, EXACT, VEC>;
  const size_t smem = static_cast<size_t>(k) * (w + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long per_block = static_cast<long long>(kThreads) * points_per_thread<MAXW>();
  dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block), n_pairs);
  kernel<<<grid, kThreads, smem, stream>>>(xs, cs, assign, dmin, n, k, w);
  return static_cast<int>(cudaGetLastError());
}

int launch_pairs(const float* xs, const float* cs, int* assign, float* dmin,
                 int n_pairs, int n, int k, int w, cudaStream_t stream) {
  if (n <= 0 || n_pairs <= 0) return 0;
  if (k <= 0 || w <= 0 || w > 128 || n_pairs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(k) * (w + 1) * sizeof(float) > kMaxSmem)
    return launch_tiled_any(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  if (w % 4 == 0) {
    switch (w) {
      case 4: return launch<4, true, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
      case 8: return launch<8, true, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
      case 12: return launch<12, true, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
      case 16: return launch<16, true, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
      default: break;
    }
    if (w <= 32) return launch<32, false, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
    if (w <= 64) return launch<64, false, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
    return launch<128, false, true>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  }
  if (w <= 4) return launch<4, false, false>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  if (w <= 8) return launch<8, false, false>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  if (w <= 16) return launch<16, false, false>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  if (w <= 32) return launch<32, false, false>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  if (w <= 64) return launch<64, false, false>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
  return launch<128, false, false>(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
}

}  // namespace

extern "C" {

const char* kmeans_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, d), c (k, d) float32; assign (n,) int32, dmin (n,) float32; d <= 128,
// any k (tiled past shared memory).
int kmeans_assign_f32(const float* x, const float* c, int* assign,
                      float* dmin, int n, int k, int d, cudaStream_t stream) {
  return launch_pairs(x, c, assign, dmin, 1, n, k, d, stream);
}

// xs (n_pairs, n, w), cs (n_pairs, k, w) float32, each pair zero-padded to
// w <= 128; assign (n_pairs, n) int32, dmin (n_pairs, n) float32.
int kmeans_assign_pairs_f32(const float* xs, const float* cs, int* assign,
                            float* dmin, int n_pairs, int n, int k, int w,
                            cudaStream_t stream) {
  return launch_pairs(xs, cs, assign, dmin, n_pairs, n, k, w, stream);
}

}  // extern "C"
