// Full SC-score matrix (the gather query's collision count):
// out[q, p] = #subspaces s whose IMI cell of p is activated for q.
//
// Replaces: scscore_pallas / _scscore_kernel in src/repro/kernels/scscore.py.
//
// Bound on the H100: the bytes of the output. It is Q x n int32, 4.0 GB
// at Q = 1000, n = 10^6, about 1.2 ms at 3.35 TB/s; the N_s collision
// tests per (query, point) pair, 6e9 per batch, take about 0.09 ms at the
// 32-bit rate. The (N_s, n) cell ids (24 MB at n = 10^6) fit in the 50 MB
// L2, so the query tiles after the first read them from there.
//
// Design: as in schist.cu, the TPU kernel's one-hot matmul gather is
// dropped. The wrapper passes the per-batch collision table packed with
// the QUERY axis in the bits (collision.cuh); a block keeps one 32-query
// tile of it in shared memory (N_s x sqrt_k^2 words, 24 KB at 6 x 1024)
// and walks a chunk of points, one point per lane. A lane reads one word
// per subspace for its point and adds the words in carry-save form into
// bit-planes of SC for the tile's 32 queries (sc_planes). It then writes
// one int32 per query: for query j, SC = sum_b ((plane_b >> j) & 1) << b,
// stored at out[(32 t + j) * n + p]. Neighbouring lanes hold neighbouring
// points, so each of the 32 stores of a warp is one coalesced 128-byte row
// segment. Rows past Q are skipped.
#include "collision.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void scscore_kernel(const uint32_t* __restrict__ bits,
                               const int* __restrict__ cells,
                               int* __restrict__ out, int q, int n, int n_sub,
                               int k2, int chunk) {
  extern __shared__ uint32_t tab[];  // (n_sub, k2)
  const int tid = threadIdx.x;
  const int tile = blockIdx.y;
  const uint32_t* src = bits + static_cast<size_t>(tile) * n_sub * k2;
  for (int i = tid; i < n_sub * k2; i += blockDim.x) tab[i] = src[i];
  __syncthreads();

  const int rows = min(32, q - tile * 32);
  int* dst = out + static_cast<size_t>(tile) * 32 * n;
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(n, p0 + chunk);
  for (int p = p0 + tid; p < p1; p += kWarps * 32) {
    int cell[kMaxSub];
#pragma unroll
    for (int s = 0; s < kMaxSub; ++s) {
      if (s < n_sub) cell[s] = __ldg(cells + static_cast<size_t>(s) * n + p);
    }
    uint32_t planes[kPlanes];
    sc_planes(tab, k2, cell, n_sub, true, planes);
    for (int j = 0; j < rows; ++j) {
      int sc = 0;
#pragma unroll
      for (int b = 0; b < kPlanes; ++b) sc |= static_cast<int>((planes[b] >> j) & 1u) << b;
      dst[static_cast<size_t>(j) * n + p] = sc;
    }
  }
}

}  // namespace

extern "C" {

const char* scscore_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bits (ceil(q/32), n_sub, k2) int32; cells (n_sub, n) int32 in [0, k2);
// out (q, n) int32, every element written. n_sub <= 16.
int scscore_i32(const uint32_t* bits, const int* cells, int* out, int q, int n,
                int n_sub, int k2, int chunk, cudaStream_t stream) {
  if (n_sub <= 0 || n_sub > kMaxSub || chunk <= 0 || q <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const size_t smem = static_cast<size_t>(n_sub) * k2 * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scscore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((n + chunk - 1) / chunk, (q + 31) / 32);
  scscore_kernel<<<grid, kWarps * 32, smem, stream>>>(bits, cells, out, q, n,
                                                      n_sub, k2, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
