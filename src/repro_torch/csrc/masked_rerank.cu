// Masked re-rank (pass 2 of the masked-full query): for each query, the k
// points with SC >= thresh[q] nearest to it, ordered by the compound key
// (squared distance, id), lowest id first on equal distances.
//
// Replaces: masked_rerank_pallas / _masked_rerank_kernel / _merge_topk /
// _bitonic_sort / _compare_exchange / _partner in
// src/repro/kernels/masked_rerank.py.
//
// Bound on the H100: the collision tests that decide the mask, N_s per
// (query, point) pair (6e9 per 1000 queries over 10^6 points), as in
// schist. The distances are needed only where the mask passes, about
// beta n = 5000 points per query, so their 2 d FLOPs are a small share; the
// TPU kernel computed all Q x n of them because a dense matmul was what its
// matrix unit did well.
//
// Design: the TPU walked the point axis in order and carried its top-k in
// scratch memory from one grid step to the next. Blocks on Hopper run in no
// order, so the point axis is split into chunks and there are two launches.
//  Pass a: a block takes a tile of up to 32 queries and one chunk of
//  points, which its 1-4 warps split between them; the warps share one copy
//  of the packed collision table (the same as schist's) in shared memory.
//  For 32 points at a time, one per lane, a lane computes its point's SC
//  for all 32 queries of the tile as bit-planes (collision.cuh) and
//  compares them with the thresholds in bit-sliced form, which gives a
//  word whose bit i says whether the point passes for query i. The warp
//  starts fetching the rows of the points that pass for some query, then
//  walks the 32 points; where a point passes for some queries, the
//  warp computes each passing pair's dot product together: lanes take
//  strided features (coalesced reads of the query row and the point row,
//  through L1), a butterfly of shuffles sums them, and the lane that owns
//  the query forms |q|^2 - 2 q.x + |x|^2 in IEEE float32 (no TF32). Each
//  such lane keeps its query's k best in a bounded max-heap on the compound
//  key in shared memory (one state per warp, slot-major so the lanes hit
//  distinct banks): a candidate that beats the heap's top replaces it and
//  sifts down, O(log k). Empty slots hold (+inf, INT_MAX), which every real
//  entry beats. At the end each lane heapsorts its slots ascending and each
//  warp writes its k best per query to (Q, n_chunks * warps, k) partials.
//  Pass b: one block per query merges the sorted partial lists into a
//  running top-k in shared memory: each element's place in the merged list
//  is its index plus its rank in the other list (binary search on the
//  compound key), so one step needs no sort. The lists' heads are loaded
//  first, and a list whose head does not beat the current k-th entry is
//  skipped without being read.
// k <= 1024; above k = 512 the query tile shrinks to 16 lanes so the top-k
// state fits in shared memory, and the wrapper gives a block as many warps
// (at most 4) as keep its shared memory near 100 KB.
#include <math_constants.h>

#include "collision.cuh"

namespace {

constexpr int kEmptyId = 0x7fffffff;

__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Replace the top (largest) entry of a max-heap of `len` slots on the
// compound key, strided by `stride`, with (d, i) and sift it down.
__device__ __forceinline__ void heap_replace_top(float* hd, int* hi, int len,
                                                 int stride, float d, int i) {
  int pos = 0;
  while (true) {
    int c = 2 * pos + 1;
    if (c >= len) break;
    if (c + 1 < len && key_less(hd[c * stride], hi[c * stride],
                                hd[(c + 1) * stride], hi[(c + 1) * stride]))
      ++c;
    if (!key_less(d, i, hd[c * stride], hi[c * stride])) break;
    hd[pos * stride] = hd[c * stride];
    hi[pos * stride] = hi[c * stride];
    pos = c;
  }
  hd[pos * stride] = d;
  hi[pos * stride] = i;
}

__global__ void rerank_chunk_kernel(
    const uint32_t* __restrict__ bits, const int* __restrict__ cells,
    const int* __restrict__ thresh, const float* __restrict__ queries,
    const float* __restrict__ data, const float* __restrict__ norms,
    float* __restrict__ part_d, int* __restrict__ part_i, int q, int n, int d,
    int n_sub, int k2, int k, int chunk, int n_parts, int lanes) {
  extern __shared__ uint32_t smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* tab = smem;  // (n_sub, k2)
  // per-warp top-k state, (k, lanes) each, slot-major
  float* st_d = reinterpret_cast<float*>(smem + n_sub * k2) + warp * k * lanes;
  int* st_i = reinterpret_cast<int*>(reinterpret_cast<float*>(smem + n_sub * k2) +
                                     warps * k * lanes) + warp * k * lanes;
  const int q0 = blockIdx.y * lanes;
  const int tile = q0 / 32;
  const uint32_t* src = bits + static_cast<size_t>(tile) * n_sub * k2;
  for (int i = threadIdx.x; i < n_sub * k2; i += blockDim.x) tab[i] = src[i];
  for (int i = lane; i < k * lanes; i += 32) {
    st_d[i] = CUDART_INF_F;
    st_i[i] = kEmptyId;
  }
  // this lane's max-heap on (dist, id): slot i at hd[i * lanes]
  float* hd = st_d + lane;
  int* hi = st_i + lane;
  const int qg = q0 + lane;
  const bool active = lane < lanes && qg < q;
  float qn = 0.f;
  if (active) {
    const float* qrow = queries + static_cast<size_t>(qg) * d;
    for (int t = 0; t < d; ++t) qn = fmaf(__ldg(qrow + t), __ldg(qrow + t), qn);
  }
  // thresholds as bit-planes over the lanes, for a bit-sliced SC >= thresh
  const int th = active ? thresh[qg] : 0;
  uint32_t th_planes[kPlanes];
#pragma unroll
  for (int b = 0; b < kPlanes; ++b) th_planes[b] = __ballot_sync(kFull, (th >> b) & 1);
  const uint32_t act = __ballot_sync(kFull, active);
  const int shift = q0 % 32;  // a 16-lane tile may sit in the upper half
  __syncthreads();

  // this warp's slice of the block's chunk
  const int c0 = blockIdx.x * chunk;
  const int c1 = min(n, c0 + chunk);
  const int slice = (chunk + warps - 1) / warps;
  const int p0 = c0 + warp * slice;
  const int p1 = min(c1, p0 + slice);
  for (int base = p0; base < p1; base += 32) {
    // lane = point: which of the tile's queries pass for this lane's point
    const int p = base + lane;
    const bool valid = p < p1;
    int cell[kMaxSub];
#pragma unroll
    for (int s = 0; s < kMaxSub; ++s) {
      if (s < n_sub) cell[s] = valid ? __ldg(cells + static_cast<size_t>(s) * n + p) : 0;
    }
    uint32_t sc[kPlanes];
    sc_planes(tab, k2, cell, n_sub, valid, sc);
    uint32_t gt = 0u, eq = kFull;
#pragma unroll
    for (int b = kPlanes - 1; b >= 0; --b) {
      const uint32_t v = sc[b] >> shift;
      gt |= eq & v & ~th_planes[b];
      eq &= ~(v ^ th_planes[b]);
    }
    // bit i: the point passes for lane i's query (a threshold of 0 passes
    // every point, so the points past the slice's end are cleared here)
    const uint32_t pass_word = valid ? ((gt | eq) & act) : 0u;
    // a point with candidates starts fetching its row and norm now, so the
    // fetches of the group's candidate points overlap
    float my_norm = 0.f;
    if (pass_word) {
      const char* row = reinterpret_cast<const char*>(data + static_cast<size_t>(p) * d);
      for (int off = 0; off < d * 4; off += 128)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(row + off));
      my_norm = __ldg(norms + p);
    }
    const int cnt = min(32, p1 - base);
    for (int j = 0; j < cnt; ++j) {
      unsigned mask = __shfl_sync(kFull, pass_word, j);
      if (mask == 0) continue;
      const float norm = __shfl_sync(kFull, my_norm, j);
      const bool pass = (mask >> lane) & 1u;
      // one warp-wide dot product per passing (query, point) pair: lanes
      // take strided features, then a butterfly sum; every lane ends with
      // the total and the owning lane keeps it
      const int pj = base + j;
      const float* xrow = data + static_cast<size_t>(pj) * d;
      float dot = 0.f;
      while (mask) {
        const int qi = __ffs(mask) - 1;
        mask &= mask - 1;
        const float* qrow = queries + static_cast<size_t>(q0 + qi) * d;
        float part = 0.f;
        for (int t = lane; t < d; t += 32) part = fmaf(__ldg(qrow + t), __ldg(xrow + t), part);
#pragma unroll
        for (int off = 16; off; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
        if (lane == qi) dot = part;
      }
      if (!pass) continue;
      const float dist = fmaxf((qn - 2.0f * dot) + norm, 0.0f);
      if (key_less(dist, pj, hd[0], hi[0])) heap_replace_top(hd, hi, k, lanes, dist, pj);
    }
  }
  if (!active) return;  // lanes past a 16-lane tile own no column
  // heapsort: repeatedly move the largest to the end, ascending on the key
  for (int end = k - 1; end > 0; --end) {
    const float td = hd[end * lanes];
    const int ti = hi[end * lanes];
    hd[end * lanes] = hd[0];
    hi[end * lanes] = hi[0];
    heap_replace_top(hd, hi, end, lanes, td, ti);
  }
  const size_t off =
      (static_cast<size_t>(qg) * n_parts + blockIdx.x * warps + warp) * k;
  for (int s = 0; s < k; ++s) {
    part_d[off + s] = st_d[s * lanes + lane];
    part_i[off + s] = st_i[s * lanes + lane];
  }
}

// Number of entries of the sorted list (ld, li)[0, len) that are < key
// (strict) or <= key (inclusive), on the compound key.
__device__ int rank_in(const float* ld, const int* li, int len, float d, int i,
                       bool inclusive) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const bool before = inclusive ? !key_less(d, i, ld[mid], li[mid])
                                  : key_less(ld[mid], li[mid], d, i);
    if (before) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void merge_chunks_kernel(const float* __restrict__ part_d,
                                    const int* __restrict__ part_i,
                                    float* __restrict__ out_d,
                                    int* __restrict__ out_i, int k,
                                    int n_parts) {
  extern __shared__ uint32_t smem[];
  float* ad = reinterpret_cast<float*>(smem);
  int* ai = reinterpret_cast<int*>(ad + k);
  float* bd = reinterpret_cast<float*>(ai + k);
  int* bi = reinterpret_cast<int*>(bd + k);
  float* cd = reinterpret_cast<float*>(bi + k);
  int* ci = reinterpret_cast<int*>(cd + k);
  float* hd = reinterpret_cast<float*>(ci + k);  // head of each list
  int* hi = reinterpret_cast<int*>(hd + n_parts);
  const size_t base = static_cast<size_t>(blockIdx.x) * n_parts * k;
  for (int c = threadIdx.x; c < n_parts; c += blockDim.x) {
    hd[c] = part_d[base + static_cast<size_t>(c) * k];
    hi[c] = part_i[base + static_cast<size_t>(c) * k];
  }
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    ad[s] = part_d[base + s];
    ai[s] = part_i[base + s];
  }
  __syncthreads();
  for (int c = 1; c < n_parts; ++c) {
    // a sorted list whose head does not beat the current k-th entry cannot
    // change the top-k (same value in every thread: A is stable here)
    if (!key_less(hd[c], hi[c], ad[k - 1], ai[k - 1])) continue;
    for (int s = threadIdx.x; s < k; s += blockDim.x) {
      bd[s] = part_d[base + static_cast<size_t>(c) * k + s];
      bi[s] = part_i[base + static_cast<size_t>(c) * k + s];
    }
    __syncthreads();
    for (int s = threadIdx.x; s < k; s += blockDim.x) {
      // stable merge: A before B on equal keys
      int pos = s + rank_in(bd, bi, k, ad[s], ai[s], false);
      if (pos < k) {
        cd[pos] = ad[s];
        ci[pos] = ai[s];
      }
      pos = s + rank_in(ad, ai, k, bd[s], bi[s], true);
      if (pos < k) {
        cd[pos] = bd[s];
        ci[pos] = bi[s];
      }
    }
    __syncthreads();
    float* td = ad; ad = cd; cd = td;
    int* ti = ai; ai = ci; ci = ti;
  }
  __syncthreads();
  const size_t o = static_cast<size_t>(blockIdx.x) * k;
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    out_d[o + s] = ad[s];
    out_i[o + s] = ai[s] == kEmptyId ? -1 : ai[s];
  }
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

const char* masked_rerank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bits (ceil(q/32), n_sub, k2) int32; cells (n_sub, n) int32; thresh (q,)
// int32; queries (q, d), data (n, d), norms (n,) float32; part_d/part_i
// (q, n_chunks * warps, k) scratch; out_d/out_i (q, k). lanes is 32 or 16;
// warps (1..4) per block of pass a, each with its own top-k state.
int masked_rerank_f32(const uint32_t* bits, const int* cells,
                      const int* thresh, const float* queries,
                      const float* data, const float* norms, float* part_d,
                      int* part_i, float* out_d, int* out_i, int q, int n,
                      int d, int n_sub, int k2, int k, int chunk,
                      int n_chunks, int lanes, int warps,
                      cudaStream_t stream) {
  if (n_sub <= 0 || n_sub > kMaxSub || k <= 0 || k > 1024 || chunk <= 0 ||
      n_chunks <= 0 || (lanes != 32 && lanes != 16) || warps < 1 || warps > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q <= 0) return 0;
  const size_t smem_a = (static_cast<size_t>(n_sub) * k2) * 4 +
                        static_cast<size_t>(warps) * k * lanes * 8;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(rerank_chunk_kernel), smem_a);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_parts = n_chunks * warps;
  dim3 grid_a(n_chunks, (q + lanes - 1) / lanes);
  rerank_chunk_kernel<<<grid_a, 32 * warps, smem_a, stream>>>(
      bits, cells, thresh, queries, data, norms, part_d, part_i, q, n, d,
      n_sub, k2, k, chunk, n_parts, lanes);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem_b = static_cast<size_t>(k) * 24 + static_cast<size_t>(n_parts) * 8;
  e = allow_smem(reinterpret_cast<const void*>(merge_chunks_kernel), smem_b);
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_chunks_kernel<<<q, 128, smem_b, stream>>>(part_d, part_i, out_d,
                                                  out_i, k, n_parts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
