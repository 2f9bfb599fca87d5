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
// the QUERY axis in the bits (collision.cuh). A block takes one 32-query
// tile and walks a chunk of points, one point per lane. The tile's table
// (N_s x sqrt_k^2 words, 24 KB at 6 x 1024) sits in shared memory where it
// fits, else the kernel reads it from global memory, where the L2 holds it
// (all tiles of a 1000-query batch at 20 x 4096 words are 10 MB of the 50
// MB); the host picks once a launch (``table_in``). A lane reads its
// point's cell id and word a subspace at a time and adds the words in
// carry-save form into NP = 5, 7 or 32 bit-planes of SC for the tile's 32
// queries (sc_planes_wide: N_s up to 31, 127, or any). It then writes one
// int32 per query: for query j, SC = sum_b ((plane_b >> j) & 1) << b,
// stored at out[(32 t + j) * n + p]. Neighbouring lanes hold neighbouring
// points, so each of the 32 stores of a warp is one coalesced 128-byte row
// segment. Rows past Q are skipped. One kernel serves every shape: a
// separate kernel for N_s <= 16 with the cell ids in registers took the
// same time at the main path's shapes (PERF.md §6), so it was dropped.
#include "collision.cuh"

namespace {

constexpr int kWarps = 4;

template <int NP>
__global__ void scscore_kernel(const uint32_t* __restrict__ bits,
                               const int* __restrict__ cells,
                               int* __restrict__ out, int q, int n, int n_sub,
                               int k2, int chunk, bool table_in) {
  extern __shared__ uint32_t tab_s[];  // (n_sub, k2) when table_in
  const int tid = threadIdx.x;
  const int tile = blockIdx.y;
  const uint32_t* tab = bits + static_cast<size_t>(tile) * n_sub * k2;
  if (table_in) {
    for (int i = tid; i < n_sub * k2; i += blockDim.x) tab_s[i] = tab[i];
    __syncthreads();
    tab = tab_s;
  }
  const int rows = min(32, q - tile * 32);
  int* dst = out + static_cast<size_t>(tile) * 32 * n;
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(n, p0 + chunk);
  for (int p = p0 + tid; p < p1; p += kWarps * 32) {
    uint32_t planes[NP];
    sc_planes_wide<NP>(tab, k2, cells, n, p, n_sub, true, planes);
    for (int j = 0; j < rows; ++j) {
      uint32_t sc = 0u;
#pragma unroll
      for (int b = 0; b < NP; ++b) sc |= ((planes[b] >> j) & 1u) << b;
      dst[static_cast<size_t>(j) * n + p] = static_cast<int>(sc);
    }
  }
}

template <typename K>
int launch(K kernel, size_t smem, const uint32_t* bits, const int* cells, int* out, int q,
           int n, int n_sub, int k2, int chunk, bool table_in, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((n + chunk - 1) / chunk, (q + 31) / 32);
  kernel<<<grid, kWarps * 32, smem, stream>>>(bits, cells, out, q, n, n_sub, k2, chunk,
                                              table_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* scscore_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bits (ceil(q/32), n_sub, k2) int32; cells (n_sub, n) int32 in [0, k2);
// out (q, n) int32, every element written. table_in: the tile's table is
// staged in shared memory (n_sub * k2 words within the block's 227 KB);
// else it is read from global memory.
int scscore_i32(const uint32_t* bits, const int* cells, int* out, int q, int n,
                int n_sub, int k2, int chunk, int table_in, cudaStream_t stream) {
  if (n_sub <= 0 || k2 <= 0 || chunk <= 0 || q <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const size_t smem = table_in ? static_cast<size_t>(n_sub) * k2 * 4 : 0;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  switch (wide_planes(n_sub)) {
    case 5:
      return launch(scscore_kernel<5>, smem, bits, cells, out, q, n, n_sub, k2, chunk,
                    table_in != 0, stream);
    case 7:
      return launch(scscore_kernel<7>, smem, bits, cells, out, q, n, n_sub, k2, chunk,
                    table_in != 0, stream);
    default:
      return launch(scscore_kernel<32>, smem, bits, cells, out, q, n, n_sub, k2, chunk,
                    table_in != 0, stream);
  }
}

}  // extern "C"
