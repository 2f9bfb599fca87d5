// Fused k-means assignment: for each point, the index of its nearest
// centroid (first index on ties, as jnp.argmin) and that squared distance.
//
// Replaces: kmeans_assign_pallas / _assign_kernel in
// src/repro/kernels/kmeans_assign.py.
//
// Bound on the H100: reading the points once. In the build's Lloyd loop a
// call sees n = 10^6 points of d = 4 floats (16 MB) against k = 32
// centroids: 2 k d = 256 FLOPs per 16-byte point, 16 FLOP/byte, just under
// the card's float32 balance point, so the memory side bounds it.
//
// Design: all k centroids and their norms live in shared memory (k (d + 1)
// floats; 32 x 5 here). One thread owns one point: it holds the point's
// coordinates in registers (the MAXD template unrolls the feature loop so
// they stay there), walks the k centroids in order with a strict '<', and
// writes (argmin, min). Threads of a warp read neighbouring points, and
// every thread of a warp reads the same centroid at the same time, which
// shared memory broadcasts. The TPU kernel's padded centroids at 1e15 are
// not needed: the loop stops at k. Distances use the reference's
// |x|^2 + |c|^2 - 2 x.c form in float32 FMA, clamped at 0.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

template <int MAXD>
__global__ void assign_kernel(const float* __restrict__ x,
                              const float* __restrict__ c,
                              int* __restrict__ assign,
                              float* __restrict__ dmin, int n, int k, int d) {
  extern __shared__ float smem[];
  float* cs = smem;          // (k, d)
  float* c2 = smem + k * d;  // (k,)
  for (int i = threadIdx.x; i < k * d; i += blockDim.x) cs[i] = c[i];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < d; ++t) s = fmaf(cs[j * d + t], cs[j * d + t], s);
    c2[j] = s;
  }
  __syncthreads();
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < static_cast<size_t>(n); p += stride) {
    float xv[MAXD];
    float x2 = 0.f;
#pragma unroll
    for (int t = 0; t < MAXD; ++t) {
      if (t < d) {
        xv[t] = __ldg(x + p * d + t);
        x2 = fmaf(xv[t], xv[t], x2);
      }
    }
    int best = 0;
    float best_d = CUDART_INF_F;
    for (int j = 0; j < k; ++j) {
      const float* cj = cs + j * d;
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < MAXD; ++t) {
        if (t < d) dot = fmaf(xv[t], cj[t], dot);
      }
      const float v = fmaxf((x2 + c2[j]) - 2.0f * dot, 0.0f);
      if (v < best_d) {
        best_d = v;
        best = j;
      }
    }
    assign[p] = best;
    dmin[p] = best_d;
  }
}

template <int MAXD>
int launch(const float* x, const float* c, int* a, float* dm, int n, int k,
           int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * (d + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        assign_kernel<MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = 256;
  long long blocks = (static_cast<long long>(n) + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  assign_kernel<MAXD><<<static_cast<int>(blocks), threads, smem, stream>>>(
      x, c, a, dm, n, k, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kmeans_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n, d), c (k, d) float32; assign (n,) int32, dmin (n,) float32; d <= 128.
int kmeans_assign_f32(const float* x, const float* c, int* assign,
                      float* dmin, int n, int k, int d, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k <= 0 || d <= 0 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 4) return launch<4>(x, c, assign, dmin, n, k, d, stream);
  if (d <= 8) return launch<8>(x, c, assign, dmin, n, k, d, stream);
  if (d <= 16) return launch<16>(x, c, assign, dmin, n, k, d, stream);
  if (d <= 32) return launch<32>(x, c, assign, dmin, n, k, d, stream);
  if (d <= 64) return launch<64>(x, c, assign, dmin, n, k, d, stream);
  return launch<128>(x, c, assign, dmin, n, k, d, stream);
}

}  // extern "C"
