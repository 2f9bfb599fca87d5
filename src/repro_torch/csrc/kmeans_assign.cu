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
#include <cuda_runtime.h>
#include <math_constants.h>

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

// x (n, d), c (k, d) float32; assign (n,) int32, dmin (n,) float32; d <= 128.
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
