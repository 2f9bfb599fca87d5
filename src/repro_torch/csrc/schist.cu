// Per-query SC-score histogram (pass 1 of the masked-full query):
// hist[q, l] = #points p with SC[q, p] == l, where
// SC[q, p] = #subspaces s whose IMI cell of p is activated for q.
//
// Replaces: schist_pallas / _schist_kernel / block_sc_scores in
// src/repro/kernels/schist.py.
//
// Bound on the H100: the collision tests, N_s per (query, point) pair:
// 6 x 1000 x 10^6 = 6e9 per 1000-query batch. The bytes are small by
// comparison: the (N_s, n) int32 cell ids are 24 MB at n = 10^6 and fit in
// the 50 MB L2, so the query tiles after the first read them from there.
//
// Design: the TPU kernel gathered centroid distances with one-hot matmuls
// because its vector unit cannot gather; that is dropped. The wrapper builds
// the per-batch collision table once (N_s x sqrt_k^2 bits per query) and
// packs it with the QUERY axis in the bits (collision.cuh). A block keeps
// one 32-query tile of the table in shared memory (N_s x sqrt_k^2 words,
// 24 KB at 6 x 1024) and walks a chunk of points, 32 points per warp step,
// one per lane. A lane reads one word per subspace for its point, which
// holds 32 collision tests, and adds the words in carry-save form into
// bit-planes of SC (about 10 logic operations per subspace for 32 queries).
// A warp-wide 32 x 32 bit transpose of each plane then gives every lane
// the SC bits of ITS query over the warp's 32 points, and one popcount per
// level counts them into per-lane registers. At the end the warps' counts
// are summed in shared memory and added into the (Q, N_s + 1) output with
// integer atomicAdd, so the result is deterministic.
#include "collision.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxLevels = kMaxSub + 1;

__global__ void schist_kernel(const uint32_t* __restrict__ bits,
                              const int* __restrict__ cells,
                              int* __restrict__ out, int q, int n, int n_sub,
                              int k2, int chunk) {
  extern __shared__ uint32_t smem[];
  const int n_levels = n_sub + 1;
  uint32_t* tab = smem;                                  // (n_sub, k2)
  int* red = reinterpret_cast<int*>(smem + n_sub * k2);  // (warps, levels, 32)
  const int tid = threadIdx.x;
  const int tile = blockIdx.y;
  const uint32_t* src = bits + static_cast<size_t>(tile) * n_sub * k2;
  for (int i = tid; i < n_sub * k2; i += blockDim.x) tab[i] = src[i];
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int n_planes = 32 - __clz(n_sub);  // bits of the largest SC
  int cnt[kMaxLevels];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) cnt[l] = 0;
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(n, p0 + chunk);
  for (int base = p0 + warp * 32; base < p1; base += kWarps * 32) {
    const int p = base + lane;
    const bool valid = p < p1;
    int cell[kMaxSub];
#pragma unroll
    for (int s = 0; s < kMaxSub; ++s) {
      if (s < n_sub) cell[s] = valid ? __ldg(cells + static_cast<size_t>(s) * n + p) : 0;
    }
    uint32_t planes[kPlanes];
    sc_planes(tab, k2, cell, n_sub, valid, planes);
    const uint32_t vmask = __ballot_sync(kFull, valid);
#pragma unroll
    for (int b = 0; b < kPlanes; ++b) {
      if (b < n_planes) planes[b] = transpose32(planes[b], lane);
    }
    // lane = query: bit j of planes[b] is bit b of SC(query, base + j)
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l <= n_sub) {
        uint32_t m = vmask;
#pragma unroll
        for (int b = 0; b < kPlanes; ++b) {
          if (b < n_planes) m &= ((l >> b) & 1) ? planes[b] : ~planes[b];
        }
        cnt[l] += __popc(m);
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l <= n_sub) red[(warp * n_levels + l) * 32 + lane] = cnt[l];
  }
  __syncthreads();
  for (int i = tid; i < n_levels * 32; i += blockDim.x) {
    const int qg = tile * 32 + (i % 32);
    if (qg >= q) continue;
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += red[w * n_levels * 32 + i];
    if (total) atomicAdd(out + static_cast<size_t>(qg) * n_levels + i / 32, total);
  }
}

}  // namespace

extern "C" {

const char* schist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bits (ceil(q/32), n_sub, k2) int32; cells (n_sub, n) int32 in [0, k2);
// out (q, n_sub + 1) int32, zeroed here. n_sub <= 16.
int schist_i32(const uint32_t* bits, const int* cells, int* out, int q, int n,
               int n_sub, int k2, int chunk, cudaStream_t stream) {
  if (n_sub <= 0 || n_sub > kMaxSub || chunk <= 0 || q <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(
      out, 0, static_cast<size_t>(q) * (n_sub + 1) * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n <= 0) return 0;
  const size_t smem = (static_cast<size_t>(n_sub) * k2 +
                       static_cast<size_t>(kWarps) * (n_sub + 1) * 32) * 4;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(schist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((n + chunk - 1) / chunk, (q + 31) / 32);
  schist_kernel<<<grid, kWarps * 32, smem, stream>>>(bits, cells, out, q, n,
                                                     n_sub, k2, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
