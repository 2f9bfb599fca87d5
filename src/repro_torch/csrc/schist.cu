// Per-query SC-score histogram (pass 1 of the masked-full query):
// hist[q, l] = #points p with SC[q, p] == l, where
// SC[q, p] = #subspaces s whose IMI cell of p is activated for q.
//
// Replaces: schist_pallas / _schist_kernel / block_sc_scores in
// src/repro/kernels/schist.py.
//
// Bound on the H100: operations. The collision tests are N_s per (query,
// point) pair: 6 x 1000 x 10^6 = 6e9 per 1000-query batch, 0.09 ms at the
// 67 T/s 32-bit rate. The bytes are small by comparison: the (N_s, n) int32
// cell ids are 24 MB at n = 10^6 and fit in the 50 MB L2.
//
// Design: the TPU kernel gathered centroid distances with one-hot matmuls
// because its vector unit cannot gather; that is dropped. The wrapper builds
// the per-batch collision table once (N_s x K bits per query) and packs it
// with the QUERY axis in the bits (collision.cuh), 32 queries a word.
// - Several query tiles a block. A block keeps T tiles' tables in shared
//   memory, interleaved as (N_s, K + 1, T) words, so a lane reads a point's
//   word of all T tiles with one or two 16-byte loads (T = 8 at 6 x 1024:
//   197 KB). A warp step takes 32 points, one a lane: it reads the points'
//   cell ids once for T tiles (cell-id traffic from L2 falls T-fold) and
//   runs T independent lookup -> add -> transpose chains. Row K of each
//   subspace is zero, the cell of a lane without a point.
// - Carry-save count: the N_s words of a tile are added two at a time (a
//   full adder, then the carry ripples) into NP = bits(N_s) planes. A
//   32 x 32 bit transpose of each plane (Transpose32: shuffle, rotate,
//   select; all T x NP planes round by round, so the shuffles overlap)
//   gives each lane the SC bits of ITS query over the warp's 32 points, and
//   one popcount per level counts them into registers.
// - A persistent grid: about one block an SM walks a contiguous range of
//   (tile group, 2048-point chunk) work items, group-major, so it loads a
//   group's tables once (usually one or two groups a block), not once per
//   chunk.
// - Cell ids are streamed into a per-warp shared-memory ring by cp.async,
//   two steps ahead, so no step waits on L2 at its top.
// - Determinism: when the block leaves a group (and at its end), the warps'
//   counts are summed in shared memory with integer atomics and added into
//   the (Q, N_s + 1) output with integer atomicAdd.
//
// Wide path (N_s from 17 to 127, the reference's bound, or a tile's table
// past shared memory, e.g. 20 x 4096 words = 320 KB): schist_wide_kernel<NP>
// takes one 32-query tile a block (grid: point chunks x tiles). Its table
// sits in shared memory where it fits beside the counts, else the kernel
// reads it from global memory, where the L2 holds it; the host decides
// once a launch. A lane adds its point's words as it reads their cell ids
// (sc_planes_wide) into NP = 5 or 7 planes, the warp transposes the planes
// (lane = query), and each lane adds its query's SC for each of the warp's
// points into the block's (N_s + 1, 32) counts in shared memory with an
// atomicAdd (lane = column, so a warp's 32 adds fall in 32 banks). Count
// registers a level, as the fast path keeps, would take up to 128 a lane.
// At the end the block adds its counts into the output with atomicAdd.
// Run at the fast path's shapes (N_s 6, K 1024) it takes 2.5-3.9x the fast
// kernel's time (PERF.md §6), so both stay.
#include "collision.cuh"

namespace {

constexpr int kStages = 3;  // ring depth: a step reads one, two are in flight

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int T>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&w)[T]) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int i = 0; i < T; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
    }
  } else if constexpr (T == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

template <int T>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&w)[T]) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int i = 0; i < T; i += 4)
      *reinterpret_cast<uint4*>(p + i) = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  } else if constexpr (T == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *p = w[0];
  }
}

// A warp's place in its block's walk: work item (tile group g, point chunk c)
// and step j of the item, advanced without a division.
struct Walk {
  int g, c, j;
  __device__ __forceinline__ void next(int steps, int n_chunks) {
    if (++j == steps) {
      j = 0;
      if (++c == n_chunks) {
        c = 0;
        ++g;
      }
    }
  }
  // the first point of the warp's 32 at this step
  __device__ __forceinline__ int base(int chunk, int warps, int warp) const {
    return c * chunk + (j * warps + warp) * 32;
  }
};

// T query tiles a block; NP = bit-planes of the largest SC (bits of N_s).
template <int T, int NP>
__global__ void __launch_bounds__(256)
schist_kernel(const uint32_t* __restrict__ bits, const int* __restrict__ cells,
              int* __restrict__ out, int q, int n, int n_sub, int k2, int chunk,
              int n_chunks, int n_items) {
  constexpr int kLv = (1 << NP) < kMaxSub + 1 ? (1 << NP) : kMaxSub + 1;
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_levels = n_sub + 1;
  const int row = k2 + 1;  // row k2 of each subspace: zeros
  const int warps = blockDim.x / 32;
  uint32_t* tab = smem;                                        // (n_sub, row, T)
  int* hist = reinterpret_cast<int*>(tab + n_sub * row * T);  // (T, levels, 32)
  int* ring = hist + T * n_levels * 32;                       // (warps, stages, n_sub, 32)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = (q + 31) / 32;
  const int steps = chunk / (warps * 32);  // warp steps a work item
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.x) * n_items / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n_items / gridDim.x);
  const int n_slots = (i1 - i0) * steps;
  int* my_ring = ring + warp * kStages * n_sub * 32 + lane;

  // cp.async this lane's cell ids of the step at w into ring slot k, one group
  auto issue = [&](const Walk& w, int k) {
    if (k < n_slots) {
      const int p = w.base(chunk, warps, warp) + lane;
      if (p < n) {
        int* dst = my_ring + (k % kStages) * n_sub * 32;
        for (int s = 0; s < n_sub; ++s)
          cp_async4(dst + s * 32, cells + static_cast<size_t>(s) * n + p);
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < T * n_levels * 32; i += blockDim.x) hist[i] = 0;
  const Transpose32 transpose(lane);
  int cnt[T][kLv];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int l = 0; l < kLv; ++l) cnt[t][l] = 0;
  int empty = 0;  // lane slots without a point: SC 0 for every query

  // add the warps' counts of group g into the output; block-wide
  auto flush = [&](int g) {
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int l = 0; l < kLv; ++l) {
        if (l <= n_sub) {
          const int v = cnt[t][l] - (l == 0 ? empty : 0);
          if (v) atomicAdd(hist + (t * n_levels + l) * 32 + lane, v);
        }
        cnt[t][l] = 0;
      }
    empty = 0;
    __syncthreads();
    for (int i = tid; i < T * n_levels * 32; i += blockDim.x) {
      const int t = i / (n_levels * 32), l = (i / 32) % n_levels;
      const int qg = (g * T + t) * 32 + i % 32;
      const int v = hist[i];
      hist[i] = 0;
      if (v && qg < q) atomicAdd(out + static_cast<size_t>(qg) * n_levels + l, v);
    }
  };
  // the T tables of group g into shared memory (tiles past the last: zeros)
  auto load_table = [&](int g) {
    __syncthreads();
    for (int i = tid; i < n_sub * row; i += blockDim.x) {
      const int s = i / row, c = i % row;
      uint32_t w[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int gt = g * T + t;
        w[t] = (c < k2 && gt < qt)
                   ? __ldg(bits + (static_cast<size_t>(gt) * n_sub + s) * k2 + c)
                   : 0u;
      }
      store_words<T>(tab + static_cast<size_t>(i) * T, w);
    }
    __syncthreads();
  };

  Walk at{i0 / n_chunks, i0 % n_chunks, 0};
  Walk ahead = at;
  issue(ahead, 0);
  ahead.next(steps, n_chunks);
  issue(ahead, 1);
  ahead.next(steps, n_chunks);
  int cur = -1;
  for (int k = 0; k < n_slots; ++k, at.next(steps, n_chunks)) {
    if (at.g != cur) {  // the same step for every warp of the block
      if (cur >= 0) flush(cur);
      load_table(at.g);
      cur = at.g;
    }
    issue(ahead, k + 2);
    ahead.next(steps, n_chunks);
    cp_async_wait<kStages - 1>();
    const int base = at.base(chunk, warps, warp);
    if (base >= n) continue;
    const int p = base + lane;
    const bool valid = p < n;
    empty += 32 - __popc(__ballot_sync(kFull, valid));
    const int* slot = my_ring + (k % kStages) * n_sub * 32;
    int cell[kMaxSub];
#pragma unroll
    for (int s = 0; s < kMaxSub; ++s)
      if (s < n_sub) cell[s] = valid ? slot[s * 32] : k2;

    uint32_t planes[T][NP];
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int b = 0; b < NP; ++b) planes[t][b] = 0u;
#pragma unroll
    for (int s = 0; s < kMaxSub; s += 2) {
      if (s < n_sub) {
        uint32_t a[T], b[T];
        load_words<T>(tab + (static_cast<size_t>(s) * row + cell[s]) * T, a);
        if (s + 1 < n_sub) {
          load_words<T>(tab + (static_cast<size_t>(s + 1) * row + cell[s + 1]) * T, b);
        } else {
#pragma unroll
          for (int t = 0; t < T; ++t) b[t] = 0u;
        }
#pragma unroll
        for (int t = 0; t < T; ++t) add2_planes<NP>(planes[t], a[t], b[t]);
      }
    }
    // lane = query: bit j of planes[t][b] is bit b of SC(query, base + j)
    transpose(planes);
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int l = 0; l < kLv; ++l) {
        if (l <= n_sub) {
          uint32_t m = kFull;
#pragma unroll
          for (int b = 0; b < NP; ++b) m &= ((l >> b) & 1) ? planes[t][b] : ~planes[t][b];
          cnt[t][l] += __popc(m);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (cur >= 0) flush(cur);
}

template <int T, int NP>
int launch(const uint32_t* bits, const int* cells, int* out, int q, int n,
           int n_sub, int k2, int warps, int chunk, int smem, cudaStream_t stream) {
  auto kernel = schist_kernel<T, NP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, device = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = (n + chunk - 1) / chunk;
  const int n_groups = ((q + 31) / 32 + T - 1) / T;
  const int n_items = n_chunks * n_groups;
  const int grid = min(n_items, max(per_sm, 1) * sms);
  kernel<<<grid, warps * 32, smem, stream>>>(bits, cells, out, q, n, n_sub, k2,
                                             chunk, n_chunks, n_items);
  return static_cast<int>(cudaGetLastError());
}

// The (T, NP) pairs schist_geometry can choose: T x levels <= 64 counts.
template <int T>
int launch_planes(int n_planes, const uint32_t* bits, const int* cells, int* out,
                  int q, int n, int n_sub, int k2, int warps, int chunk, int smem,
                  cudaStream_t stream) {
  switch (n_planes) {
    case 1: return launch<T, 1>(bits, cells, out, q, n, n_sub, k2, warps, chunk, smem, stream);
    case 2: return launch<T, 2>(bits, cells, out, q, n, n_sub, k2, warps, chunk, smem, stream);
    case 3: return launch<T, 3>(bits, cells, out, q, n, n_sub, k2, warps, chunk, smem, stream);
    case 4:
      if constexpr (T <= 4)
        return launch<T, 4>(bits, cells, out, q, n, n_sub, k2, warps, chunk, smem, stream);
      break;
    case 5:
      if constexpr (T <= 2)
        return launch<T, 5>(bits, cells, out, q, n, n_sub, k2, warps, chunk, smem, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int NP>
__global__ void __launch_bounds__(256)
schist_wide_kernel(const uint32_t* __restrict__ bits, const int* __restrict__ cells,
                   int* __restrict__ out, int q, int n, int n_sub, int k2, int chunk,
                   bool table_in) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_levels = n_sub + 1;
  int* hist = reinterpret_cast<int*>(smem);  // (levels, 32)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warps = blockDim.x / 32;
  const int tile = blockIdx.y;
  const uint32_t* tab = bits + static_cast<size_t>(tile) * n_sub * k2;
  for (int i = tid; i < n_levels * 32; i += blockDim.x) hist[i] = 0;
  if (table_in) {
    uint32_t* tab_s = smem + n_levels * 32;  // (n_sub, k2)
    for (int i = tid; i < n_sub * k2; i += blockDim.x) tab_s[i] = tab[i];
    tab = tab_s;
  }
  __syncthreads();
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(n, p0 + chunk);
  for (int base = p0 + warp * 32; base < p1; base += warps * 32) {
    const int p = base + lane;
    uint32_t planes[NP];
    sc_planes_wide<NP>(tab, k2, cells, n, p, n_sub, p < p1, planes);
#pragma unroll
    for (int b = 0; b < NP; ++b) planes[b] = transpose32(planes[b], lane);
    // lane = query: bit j of planes[b] is bit b of SC(query, base + j)
    const int pts = min(32, p1 - base);
    for (int j = 0; j < pts; ++j) {
      int sc = 0;
#pragma unroll
      for (int b = 0; b < NP; ++b) sc |= static_cast<int>((planes[b] >> j) & 1u) << b;
      atomicAdd(hist + sc * 32 + lane, 1);
    }
  }
  __syncthreads();
  for (int i = tid; i < n_levels * 32; i += blockDim.x) {
    const int qg = tile * 32 + i % 32;
    const int v = hist[i];
    if (v && qg < q) atomicAdd(out + static_cast<size_t>(qg) * n_levels + i / 32, v);
  }
}

template <int NP>
int launch_wide(const uint32_t* bits, const int* cells, int* out, int q, int n, int n_sub,
                int k2, int warps, int chunk, int smem, bool table_in, cudaStream_t stream) {
  auto kernel = schist_wide_kernel<NP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((n + chunk - 1) / chunk, (q + 31) / 32);
  kernel<<<grid, warps * 32, smem, stream>>>(bits, cells, out, q, n, n_sub, k2, chunk,
                                             table_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* schist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bits (ceil(q/32), n_sub, k2) int32; cells (n_sub, n) int32 in [0, k2);
// out (q, n_sub + 1) int32, zeroed here. n_sub <= 127. tiles (1, 2, 4 or 8),
// warps, chunk (a multiple of 32 warps) and smem (bytes: the tables, the
// block's counts and the rings) come from kernels/schist.py:schist_geometry.
// wide (0 or 1) takes the wide kernel, with the table in shared memory when
// table_in (tiles must be 1 there; smem: the counts and the table if in).
int schist_i32(const uint32_t* bits, const int* cells, int* out, int q, int n,
               int n_sub, int k2, int tiles, int warps, int chunk, int smem, int wide,
               int table_in, cudaStream_t stream) {
  if (n_sub <= 0 || n_sub > 127 || q <= 0 || k2 <= 0 || warps <= 0 ||
      warps > 8 || chunk <= 0 || chunk % (warps * 32) != 0 ||
      (!wide && (n_sub > kMaxSub || !table_in)) || (wide && tiles != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(
      out, 0, static_cast<size_t>(q) * (n_sub + 1) * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n <= 0) return 0;
  if (wide) {
    if (wide_planes(n_sub) == 5)
      return launch_wide<5>(bits, cells, out, q, n, n_sub, k2, warps, chunk, smem,
                            table_in != 0, stream);
    return launch_wide<7>(bits, cells, out, q, n, n_sub, k2, warps, chunk, smem,
                          table_in != 0, stream);
  }
  const int n_planes = 32 - __builtin_clz(static_cast<unsigned>(n_sub));
  switch (tiles) {
    case 1: return launch_planes<1>(n_planes, bits, cells, out, q, n, n_sub, k2, warps, chunk, smem, stream);
    case 2: return launch_planes<2>(n_planes, bits, cells, out, q, n, n_sub, k2, warps, chunk, smem, stream);
    case 4: return launch_planes<4>(n_planes, bits, cells, out, q, n, n_sub, k2, warps, chunk, smem, stream);
    case 8: return launch_planes<8>(n_planes, bits, cells, out, q, n, n_sub, k2, warps, chunk, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
