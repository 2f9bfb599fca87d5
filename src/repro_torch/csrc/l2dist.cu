// Squared-L2 distance matrix D[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0).
//
// Replaces: l2dist_pallas / _l2dist_kernel in src/repro/kernels/l2dist.py.
//
// Bound on the H100: writing the (M, N) float32 result. On the main path it
// computes query-to-centroid distances with d = s/2 = 4 and N = sqrt_k = 32,
// so each output costs 3 d = 12 FMAs against 4 bytes written: far below the
// card's 20 FLOP/byte balance point, and no tensor core is worth it at
// d = 4.
//
// Design: one thread per output element, threads of a warp on neighbouring
// columns j so the store is coalesced; the rows of x and y are read through
// L1 (the whole y fits in it). Row norms are computed in the kernel in plain
// float32 FMA, in feature order, and the result is clamped at 0 as in the
// reference's x2 + y2 - 2 x.y form. No TF32 anywhere.
#include <cuda_runtime.h>

namespace {

__global__ void l2dist_kernel(const float* __restrict__ x,
                              const float* __restrict__ y,
                              float* __restrict__ out, int m, int n, int d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float* yr = y + static_cast<size_t>(j) * d;
  for (int i = blockIdx.y; i < m; i += gridDim.y) {
    const float* xr = x + static_cast<size_t>(i) * d;
    float x2 = 0.f, y2 = 0.f, dot = 0.f;
    for (int t = 0; t < d; ++t) {
      const float a = __ldg(xr + t);
      const float b = __ldg(yr + t);
      x2 = fmaf(a, a, x2);
      y2 = fmaf(b, b, y2);
      dot = fmaf(a, b, dot);
    }
    const float v = (x2 + y2) - 2.0f * dot;
    out[static_cast<size_t>(i) * n + j] = fmaxf(v, 0.0f);
  }
}

}  // namespace

extern "C" {

const char* l2dist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (m, d), y (n, d), out (m, n): float32, contiguous, on the device.
int l2dist_f32(const float* x, const float* y, float* out, int m, int n,
               int d, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  const int threads = n >= 128 ? 128 : ((n + 31) / 32) * 32;
  dim3 grid((n + threads - 1) / threads, m < 65535 ? m : 65535);
  l2dist_kernel<<<grid, threads, 0, stream>>>(x, y, out, m, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
