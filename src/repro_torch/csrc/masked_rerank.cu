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
//  points. The grid is (query tiles, chunks) with the tile fastest, so the
//  blocks of every tile that read one chunk are dispatched together and
//  walk it at the same pace: a row fetched from HBM for one tile is an L2
//  hit for the others. The block loads the tile's packed collision table
//  (the same as schist's), its query rows (stride d + 4 floats, so lanes
//  reading different queries at one feature hit different banks) and |q|^2
//  into shared memory once. Its warps take turns over the chunk's groups
//  of 32 points, one point a lane: a lane computes its point's SC for the
//  tile's queries as bit-planes (collision.cuh) and compares them with the
//  thresholds in bit-sliced form, which gives a word whose bit i says
//  whether the point passes for query i. The warp appends the passing
//  (point, query) pairs to its ring in shared memory, one pair a lane per
//  step, placed by ballot and popc prefixes. Whenever 32 are queued, and
//  once at the end, each lane takes one pair and computes its dot product
//  alone: the point row by float4 loads through L1, the query row from
//  shared memory, no shuffles; then |q|^2 - 2 q.x + |x|^2 in IEEE float32
//  (no TF32), so integer corpora stay bitwise in any summation order. The
//  block keeps one bounded max-heap per query on the compound key in
//  shared memory (entries of 8 bytes, (dist, id), so a root read is one
//  access): a pair that does not beat its query's root is dropped without a
//  lock; the survivors of a warp elect one lane per query (match_any) and
//  take that query's lock, so no heap is written by two lanes at once, and
//  sift down, O(log k). Empty slots hold (+inf, INT_MAX), which every real
//  entry beats. At the end one thread per query heapsorts its heap
//  ascending and writes it to (Q, n_chunks, k) partials.
//  Pass b: one block per query merges the sorted partial lists into a
//  running top-k in shared memory: each element's place in the merged list
//  is its index plus its rank in the other list (binary search on the
//  compound key), so one step needs no sort. The lists' heads are loaded
//  first, and a list whose head does not beat the current k-th entry is
//  skipped without being read.
// HBM traffic of pass a at 10^6 x 128, 1000 queries, N_s 6, 33.5k
// candidates per query: the chunk-fastest grid of the first design ran the
// 32 tiles of a chunk far apart in time, so a row came back from HBM once
// for every tile in which some query passed it (P ~ 0.66 a tile, ~21M row
// reads, ~10.8 GB) and the cell ids once a tile (~0.77 GB). With the tile
// fastest a row and its cell ids come from HBM about once (~0.51 GB of
// rows, 24 MB of ids); the ~17 GB of row reads per pair are L2 and L1
// traffic. The rows in flight at once are the few groups that each of the
// ~8 chunks held by resident blocks is at, far below half of L2.
// k <= 1024; above k = 512 the query tile shrinks to 16 lanes so the top-k
// state fits in shared memory. A block has up to 8 warps, fewer only where
// their rings would not fit; the query rows stay in global memory where
// they do not fit either.
#include <math_constants.h>

#include "collision.cuh"

namespace {

constexpr int kEmptyId = 0x7fffffff;
constexpr int kMaxWarps = 8;
constexpr int kRing = 64;  // (point, query) pairs in a warp's ring
constexpr size_t kMaxSmem = 232448;

// A top-k entry: the distance's bits low, the id high.
typedef unsigned long long Entry;

__device__ __forceinline__ Entry make_entry(float d, int i) {
  return (static_cast<Entry>(static_cast<uint32_t>(i)) << 32) | __float_as_uint(d);
}
__device__ __forceinline__ float entry_d(Entry e) {
  return __uint_as_float(static_cast<uint32_t>(e));
}
__device__ __forceinline__ int entry_i(Entry e) { return static_cast<int>(e >> 32); }

__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}
__device__ __forceinline__ bool entry_less(Entry a, Entry b) {
  return key_less(entry_d(a), entry_i(a), entry_d(b), entry_i(b));
}

// Replace the top (largest) entry of a max-heap of `len` slots on the
// compound key, strided by `stride`, with e and sift it down.
__device__ __forceinline__ void heap_replace_top(Entry* h, int len, int stride, Entry e) {
  int pos = 0;
  while (true) {
    int c = 2 * pos + 1;
    if (c >= len) break;
    Entry ec = h[c * stride];
    if (c + 1 < len) {
      const Entry e2 = h[(c + 1) * stride];
      if (entry_less(ec, e2)) {
        ++c;
        ec = e2;
      }
    }
    if (!entry_less(e, ec)) break;
    h[pos * stride] = ec;
    pos = c;
  }
  h[pos * stride] = e;
}

// q . x over d features; kVec reads both rows as float4 (d % 4 == 0 and
// 16-byte aligned rows).
template <bool kVec>
__device__ __forceinline__ float dot_row(const float* qrow, const float* __restrict__ xrow,
                                         int d) {
  if (kVec) {
    const float4* q4 = reinterpret_cast<const float4*>(qrow);
    const float4* x4 = reinterpret_cast<const float4*>(xrow);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int t = 0; t < d / 4; ++t) {
      const float4 a = q4[t];
      const float4 b = __ldg(x4 + t);
      acc.x = fmaf(a.x, b.x, acc.x);
      acc.y = fmaf(a.y, b.y, acc.y);
      acc.z = fmaf(a.z, b.z, acc.z);
      acc.w = fmaf(a.w, b.w, acc.w);
    }
    return (acc.x + acc.y) + (acc.z + acc.w);
  }
  float acc = 0.f;
  for (int t = 0; t < d; ++t) acc = fmaf(qrow[t], __ldg(xrow + t), acc);
  return acc;
}

// Floats between two query rows in shared memory.
__host__ __device__ __forceinline__ int query_stride(int d) { return d % 4 == 0 ? d + 4 : d + 1; }

// Shared memory of pass a without the query rows: top-k heaps, the warps'
// rings, |q|^2 and the locks, the collision table (in that order).
__host__ __device__ __forceinline__ size_t smem_base(int k, int lanes, int warps, int n_sub,
                                                     int k2) {
  return static_cast<size_t>(k) * lanes * 8 + static_cast<size_t>(warps) * kRing * 8 + 256 +
         static_cast<size_t>(n_sub) * k2 * 4;
}
__host__ __device__ __forceinline__ size_t smem_rows(int lanes, int d) {
  return static_cast<size_t>(lanes) * query_stride(d) * 4;
}

__global__ void __launch_bounds__(kMaxWarps * 32, 2) rerank_chunk_kernel(
    const uint32_t* __restrict__ bits, const int* __restrict__ cells,
    const int* __restrict__ thresh, const float* __restrict__ queries,
    const float* __restrict__ data, const float* __restrict__ norms,
    float* __restrict__ part_d, int* __restrict__ part_i, int q, int n, int d,
    int n_sub, int k2, int k, int chunk, int n_chunks, int lanes, bool rows_in, bool vec) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qstride = query_stride(d);
  Entry* heap = reinterpret_cast<Entry*>(dyn);  // (k, lanes), slot-major
  float* qs = reinterpret_cast<float*>(heap + k * lanes);  // (lanes, qstride) if rows_in
  int2* ring = reinterpret_cast<int2*>(qs + (rows_in ? lanes * qstride : 0)) + warp * kRing;
  float* qn = reinterpret_cast<float*>(
      reinterpret_cast<int2*>(qs + (rows_in ? lanes * qstride : 0)) + warps * kRing);
  int* locks = reinterpret_cast<int*>(qn + 32);
  uint32_t* tab = reinterpret_cast<uint32_t*>(locks + 32);  // (n_sub, k2)
  const int q0 = blockIdx.x * lanes;
  const int nq = min(lanes, q - q0);  // queries of this tile
  const int shift = q0 % 32;  // a 16-lane tile may sit in the upper half
  const uint32_t* src = bits + static_cast<size_t>(q0 / 32) * n_sub * k2;
  for (int i = threadIdx.x; i < n_sub * k2; i += blockDim.x) tab[i] = src[i];
  for (int i = threadIdx.x; i < k * lanes; i += blockDim.x)
    heap[i] = make_entry(CUDART_INF_F, kEmptyId);
  const float* qtile = queries + static_cast<size_t>(q0) * d;
  if (rows_in) {
    for (int i = threadIdx.x; i < nq * d; i += blockDim.x) {
      const int s = i / d;
      qs[s * qstride + (i - s * d)] = qtile[i];
    }
  }
  if (threadIdx.x < 32) {
    float v = 0.f;
    if (lane < nq)
      for (int t = 0; t < d; ++t) v = fmaf(qtile[lane * d + t], qtile[lane * d + t], v);
    qn[lane] = v;
    locks[lane] = 0;
  }
  // thresholds as bit-planes over the lanes, for a bit-sliced SC >= thresh
  const bool active = lane < nq;
  const int th = active ? thresh[q0 + lane] : 0;
  uint32_t th_planes[kPlanes];
#pragma unroll
  for (int b = 0; b < kPlanes; ++b) th_planes[b] = __ballot_sync(kFull, (th >> b) & 1);
  const uint32_t act = __ballot_sync(kFull, active);
  __syncthreads();

  // dot product, distance, root filter and locked insert of one pair a lane
  auto score = [&](int p, int s, bool valid) {
    bool cand = false;
    Entry e = 0;
    if (valid) {
      const float* xrow = data + static_cast<size_t>(p) * d;
      float dot;
      if (rows_in) {
        const float* qr = qs + s * qstride;
        dot = vec ? dot_row<true>(qr, xrow, d) : dot_row<false>(qr, xrow, d);
      } else {
        const float* qr = qtile + static_cast<size_t>(s) * d;
        dot = vec ? dot_row<true>(qr, xrow, d) : dot_row<false>(qr, xrow, d);
      }
      e = make_entry(fmaxf((qn[s] - 2.0f * dot) + __ldg(norms + p), 0.0f), p);
      // the root only falls, so a stale read lets through too much, never
      // too little
      cand = entry_less(e, *reinterpret_cast<volatile Entry*>(heap + s));
    }
    while (__any_sync(kFull, cand)) {
      const unsigned peers = __match_any_sync(kFull, cand ? s : -1);
      if (cand && lane == __ffs(peers) - 1) {
        while (atomicCAS(locks + s, 0, 1) != 0) {
        }
        __threadfence_block();
        if (entry_less(e, heap[s])) heap_replace_top(heap + s, k, lanes, e);
        __threadfence_block();
        atomicExch(locks + s, 0);
        cand = false;
      }
    }
  };

  const unsigned below = (1u << lane) - 1u;
  int head = 0, tail = 0;  // the ring's pairs [head, tail), warp-uniform
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(n, c0 + chunk);
  for (int base = c0 + warp * 32; base < c1; base += warps * 32) {
    // lane = point: which of the tile's queries pass for this lane's point
    const int p = base + lane;
    const bool valid = p < c1;
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
    // bit i: the point passes for query i (a threshold of 0 passes every
    // point, so the points past the chunk's end are cleared here)
    uint32_t rest = valid ? ((gt | eq) & act) : 0u;
    // each step queues one pair of every lane that has one left
    while (__any_sync(kFull, rest != 0)) {
      const unsigned offer = __ballot_sync(kFull, rest != 0);
      if (rest) {
        ring[(tail + __popc(offer & below)) % kRing] = make_int2(p, __ffs(rest) - 1);
        rest &= rest - 1;
      }
      tail += __popc(offer);
      if (tail - head >= 32) {
        __syncwarp();
        const int2 pr = ring[(head + lane) % kRing];
        head += 32;
        __syncwarp();
        score(pr.x, pr.y, true);
      }
    }
  }
  while (tail > head) {
    __syncwarp();
    const int m = min(32, tail - head);
    const int2 pr = lane < m ? ring[(head + lane) % kRing] : make_int2(0, 0);
    head += m;
    score(pr.x, pr.y, lane < m);
  }
  __syncthreads();
  if (threadIdx.x >= nq) return;
  // heapsort: repeatedly move the largest to the end, ascending on the key
  Entry* h = heap + threadIdx.x;
  for (int end = k - 1; end > 0; --end) {
    const Entry t = h[end * lanes];
    h[end * lanes] = h[0];
    heap_replace_top(h, end, lanes, t);
  }
  const size_t off =
      (static_cast<size_t>(q0 + threadIdx.x) * n_chunks + blockIdx.y) * k;
  for (int s = 0; s < k; ++s) {
    const Entry e = h[s * lanes];
    part_d[off + s] = entry_d(e);
    part_i[off + s] = entry_i(e);
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

// Shared memory of pass a, and whether the query rows are in it; 0 if even
// the rest does not fit.
size_t pass_a_smem(int d, int n_sub, int k2, int k, int lanes, int warps, bool* rows_in) {
  const size_t base = smem_base(k, lanes, warps, n_sub, k2);
  *rows_in = base + smem_rows(lanes, d) <= kMaxSmem;
  if (base > kMaxSmem) return 0;
  return base + (*rows_in ? smem_rows(lanes, d) : 0);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

const char* masked_rerank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bits (ceil(q/32), n_sub, k2) int32; cells (n_sub, n) int32; thresh (q,)
// int32; queries (q, d), data (n, d), norms (n,) float32; part_d/part_i
// (q, n_chunks, k) scratch; out_d/out_i (q, k). lanes is 32 or 16 queries
// a block; warps (1..8) a block of pass a, sharing one top-k state.
int masked_rerank_f32(const uint32_t* bits, const int* cells,
                      const int* thresh, const float* queries,
                      const float* data, const float* norms, float* part_d,
                      int* part_i, float* out_d, int* out_i, int q, int n,
                      int d, int n_sub, int k2, int k, int chunk,
                      int n_chunks, int lanes, int warps,
                      cudaStream_t stream) {
  if (n_sub <= 0 || n_sub > kMaxSub || k <= 0 || k > 1024 || chunk <= 0 ||
      n_chunks <= 0 || n_chunks > 65535 || (lanes != 32 && lanes != 16) || warps < 1 ||
      warps > kMaxWarps || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q <= 0) return 0;
  bool rows_in = false;
  const size_t smem_a = pass_a_smem(d, n_sub, k2, k, lanes, warps, &rows_in);
  if (smem_a == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && aligned16(data) && (rows_in || aligned16(queries));
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(rerank_chunk_kernel), smem_a);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid_a((q + lanes - 1) / lanes, n_chunks);
  rerank_chunk_kernel<<<grid_a, 32 * warps, smem_a, stream>>>(
      bits, cells, thresh, queries, data, norms, part_d, part_i, q, n, d,
      n_sub, k2, k, chunk, n_chunks, lanes, rows_in, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem_b = static_cast<size_t>(k) * 24 + static_cast<size_t>(n_chunks) * 8;
  e = allow_smem(reinterpret_cast<const void*>(merge_chunks_kernel), smem_b);
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_chunks_kernel<<<q, 128, smem_b, stream>>>(part_d, part_i, out_d,
                                                  out_i, k, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of pass a that fit on one SM at once, at the launch's geometry.
int masked_rerank_occupancy(int d, int n_sub, int k2, int k, int lanes, int warps,
                            int* blocks) {
  bool rows_in = false;
  const size_t smem_a = pass_a_smem(d, n_sub, k2, k, lanes, warps, &rows_in);
  if (smem_a == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(rerank_chunk_kernel), smem_a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rerank_chunk_kernel, 32 * warps, smem_a));
}

}  // extern "C"
