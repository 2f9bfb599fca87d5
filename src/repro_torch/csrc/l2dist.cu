// Squared-L2 distances D[p, i, j] = max(|x_i|^2 + |y_pj|^2 - 2 x_i.y_pj, 0)
// for a list of pairs p, each a column slice of one query matrix against its
// own centroid set: the query's centroid distances for every (subspace,
// half) of an index in one launch.
//
// Replaces: l2dist_pallas / _l2dist_kernel in src/repro/kernels/l2dist.py
// (which the reference calls once per (subspace, half)).
//
// Bound on the H100: writing the float32 result. On the main path a batch
// has 2 N_s = 12 pairs with half-dim d = 4 and sqrt_k = 32 centroids, so each
// output costs 3 d = 12 FMAs against 4 bytes written: far below the card's
// 20 FLOP/byte balance point, and no tensor core is worth it at d = 4. The
// whole batch is 1.5 MB of output, so one launch per batch (not one per
// pair) is what its time comes down to.
//
// Design: a block owns one pair and a tile of kRows query rows. The pair's
// centroids are staged in shared memory at an odd stride (no bank
// conflicts); a warp takes one query row at a time with its lanes on
// neighbouring centroids, so the row is read once per thread as a broadcast
// and the store is coalesced. Each output keeps the single-pair kernel's
// arithmetic exactly: x2, y2 and dot by fmaf in feature order over the
// pair's own dims, then (x2 + y2) - 2 dot, clamped at 0. No TF32 anywhere.
// The single-pair entry point launches the same kernel with one pair.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPairs = 32;
constexpr int kThreads = 128;
constexpr int kRows = 32;                  // query rows per block
constexpr int kStageBytes = 48 * 1024;     // centroids staged up to this size

struct Pairs {
  int col[kMaxPairs];  // first column of the pair's slice of x
  int dim[kMaxPairs];  // the pair's half-dim
};

__global__ void __launch_bounds__(kThreads)
l2dist_pairs_kernel(const float* __restrict__ x, int ldx, Pairs pairs,
                    const float* __restrict__ y, int ny, int ldy,
                    float* __restrict__ out, int m, bool stage) {
  extern __shared__ float ys[];
  const int pair = blockIdx.y;
  const int d = pairs.dim[pair];
  const float* yp = y + static_cast<size_t>(pair) * ny * ldy;
  // the centroids at stride d + 1 in shared memory, or read through L1
  const float* yr = yp;
  int stride = ldy;
  if (stage) {
    for (int i = threadIdx.x; i < ny * d; i += blockDim.x)
      ys[(i / d) * (d + 1) + i % d] = __ldg(yp + static_cast<size_t>(i / d) * ldy + i % d);
    __syncthreads();
    yr = ys;
    stride = d + 1;
  }
  const float* xc = x + pairs.col[pair];
  float* op = out + static_cast<size_t>(pair) * m * ny;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r1 = min(m, (blockIdx.x + 1) * kRows);
  for (int i = blockIdx.x * kRows + warp; i < r1; i += kThreads / 32) {
    const float* xr = xc + static_cast<size_t>(i) * ldx;
    for (int j = lane; j < ny; j += 32) {
      const float* yj = yr + static_cast<size_t>(j) * stride;
      float x2 = 0.f, y2 = 0.f, dot = 0.f;
      for (int t = 0; t < d; ++t) {
        const float a = __ldg(xr + t);
        const float b = yj[t];
        x2 = fmaf(a, a, x2);
        y2 = fmaf(b, b, y2);
        dot = fmaf(a, b, dot);
      }
      const float v = (x2 + y2) - 2.0f * dot;
      op[static_cast<size_t>(i) * ny + j] = fmaxf(v, 0.0f);
    }
  }
}

int launch(const float* x, int ldx, const Pairs& pairs, int n_pairs,
           const float* y, int ny, int ldy, float* out, int m, int d_max,
           cudaStream_t stream) {
  if (m <= 0 || ny <= 0 || n_pairs <= 0) return 0;
  if (n_pairs > kMaxPairs || d_max > ldy) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(ny) * (d_max + 1) * sizeof(float);
  const bool stage = smem <= kStageBytes;
  dim3 grid((m + kRows - 1) / kRows, n_pairs);
  l2dist_pairs_kernel<<<grid, kThreads, stage ? smem : 0, stream>>>(
      x, ldx, pairs, y, ny, ldy, out, m, stage);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* l2dist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (m, d), y (n, d), out (m, n): float32, contiguous, on the device.
int l2dist_f32(const float* x, const float* y, float* out, int m, int n,
               int d, cudaStream_t stream) {
  Pairs pairs{};
  pairs.col[0] = 0;
  pairs.dim[0] = d;
  return launch(x, d, pairs, 1, y, n, d, out, m, d, stream);
}

// x (m, ldx); pair p reads columns [col[p], col[p] + dim[p]) of x against
// y[p, :, :dim[p]] of y (n_pairs, n, d_max); out (n_pairs, m, n). col and
// dim are host arrays of n_pairs <= 32 ints. Float32, contiguous, on the
// device.
int l2dist_pairs_f32(const float* x, int ldx, const int* col, const int* dim,
                     int n_pairs, const float* y, int n, int d_max, float* out,
                     int m, cudaStream_t stream) {
  if (n_pairs > kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  Pairs pairs{};
  for (int p = 0; p < n_pairs; ++p) {
    if (dim[p] < 0 || dim[p] > d_max || col[p] < 0 || col[p] + dim[p] > ldx)
      return static_cast<int>(cudaErrorInvalidValue);
    pairs.col[p] = col[p];
    pairs.dim[p] = dim[p];
  }
  return launch(x, ldx, pairs, n_pairs, y, n, d_max, out, m, d_max, stream);
}

}  // extern "C"
