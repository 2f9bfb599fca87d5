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
//
// Past shared memory (k (w + 1) floats above 227 KB, e.g. IVF's k = 1024
// lists of w = 128: 528 KB) the tiled path takes over: a TF32 tensor-core
// screen that decides nothing, and exact rechecks that decide everything.
// Its answer is, bit for bit, the one-tile kernel's arithmetic above over
// all k centroids: for point i the first j minimising
//   d_ij = fmaxf((x2_i + c2_j) - 2 dot_ij, 0)
// with x2, c2 and dot fmaf chains in feature order. The lexicographic
// minimum of (d_ij, j) does not depend on the order the work is done in.
//
// Bound at IVF's shape (n = 10^6, w = 128, k = 1024): the dot products,
// 2 n k w = 2.68e11 FLOP, ~0.54 ms at 495 TFLOP/s TF32; the points read
// once, 512 MB, ~0.155 ms; on the CUDA cores the same work is ~3.96 ms at
// 67 TFLOP/s (2 k w + 3 k FLOP a point), which is what the screen avoids.
// At IVF-Flat's wide shape (10^6 x 960 against 1024 lists): 2 n k w =
// 1.97e12 FLOP, ~3.97 ms TF32; 3.84 GB of points, ~1.15 ms; ~29.4 ms on the
// CUDA cores. Widths past 128 take the wide path (namespace wide, below).
//
// Design. A block owns R = 192 points of one pair: three warpgroups of 64
// rows. It loads its points once into shared memory in the 128-byte-
// swizzled K-major layout wgmma reads (32 floats a swizzled row, one box
// per 32 features, zero past w), takes each row's exact x2 chain from the
// raw values, then centres them in place (x - mu, mu the pair's centroid
// mean). A pre-pass kernel (prep_kernel) writes, once a launch, each
// centroid's exact c2 chain and each tile of N = 64 centred centroids
// c' = c - mu (zero-padded to the box width and to a whole tile) as the
// very image its ring stage holds, followed by the tile's record: its
// columns' centred chains c'2 and its largest norm bounds b = |c'| and
// q = |c|, all in scratch the wrapper allocates. One thread streams the
// images through a 2-stage ring, one bulk copy a tile; blocks start at
// different tiles, so that the SMs do not all read the same centroids from
// L2 at once. Each warpgroup runs wgmma m64n64k8 .tf32 (both operands
// K-major in shared memory; the tensor core reads the top 19 bits of each
// f32, i.e. truncates, so the stored f32 tiles need no conversion pass);
// the warpgroups take the tensor cores in turns (named barriers), so that
// one's products run while the others' epilogues do. (Two accumulators a
// warpgroup, to overlap its own epilogue too, made ptxas serialise every
// wgmma, at 168 registers and at 255.) The epilogue forms the screened
// distance
//   e_ij = fmaxf(fl(fl(x'2_i + c'2_j) - 2 S_ij), 0),
// S_ij the tensor-core product of the centred rows, and a per-(row, tile)
// bound E_i >= |e_ij - d_ij| (below). Each row keeps U_i, an upper bound
// on its exact minimum: the least e_ij + E_i seen so far and the exact best
// found so far. Every column with e_ij <= U_i + E_i joins its warp's queue
// with its lower bound e_ij - E_i. When the queue fills, and once at the
// end, the candidates whose lower bound still reaches their row's U_i are
// rechecked: d_ij from the raw point and centroid rows (global memory, in
// L2) by the chain above, folded into the row's (d, j)
// key, a 64-bit shared-memory atomicMin on (float bits, index) (d >= +0,
// so its bits order as the floats do). A row's exact minimiser j* passes
// both tests: e_ij* - E_i <= d_ij* <= d_ij <= e_ij + E_i for every j, and
// U_i only falls; ties at the minimum all pass and the key keeps the first
// index, in whatever order the rechecks run. The survivors are compacted
// so that lanes take whole rounds of 32, one a lane (a round costs one
// chain however many lanes hold one). Each block adds its recheck count to
// one device counter once.
//
// The bound. u = 2^-24; a chain of m terms (any order) errs by at most
// gamma_m = m u / (1 - m u) times its sum of |terms|, and Cauchy-Schwarz
// bounds sum |x_t c_t| by |x| |c|. With D = |x - c|^2, at any width w:
// - exact chain: |d - D| <= gamma_{w+2} (|x| + |c|)^2 + u D;
// - screen: TF32 truncation errs by < 2^-10 an operand, so a product by
//   < 2^-9 + 2^-20; tensor-core accumulation is undocumented and is taken
//   to err by up to 2^-20 of the running sum of |products| at each of the
//   w + 1 additions (8 ulps, several times truncation's one), and that sum
//   is at most (1 + 2^-9 + 2^-20) |x'| |c'|, so |S - x'.c'| <= G(w) |x'| |c'|
//   with G(w) = 2^-9 + ceil((w + 1)(1 + 2^-8) + 2) 2^-20 (131 2^-20 past
//   2^-9 at w = 128, 967 at w = 960); the chunks of the wide path add into
//   one accumulator, so they are the same w + 1 additions;
// - centring: x' = fl(x - mu) errs by u |x'| a component, which moves
//   |x' - c'|^2 from D by at most 2 u (|x'| + |c'|)^2 (1 + u); the screen's
//   own norms and subtraction add gamma_{w+4} (|x'| + |c'|)^2, and u D is
//   below u (|x'| + |c'|)^2.
// So |e - d| <= 2 G a b + EPS ((a + b)^2 + (p + q)^2) with a >= |x'|,
// b >= |c'|, p >= |x|, q >= |c|, for any EPS >= gamma_{w+16} (the spare
// u's cover the window's own float additions, each below u (a + b)^2).
// The norms are sqrtf of the computed chains times KAPPA, which must cover
// the chains' (1 - gamma_w)^-1/2 <= 1 + gamma_w / 2 (1 + gamma_w) and two
// roundings. kernels/kmeans_assign.py:screen_window(w) gives all three,
// each exact in f32 and rounded up: G(w) above but at least 2^-9 + 2^-12;
// EPS(w) = gamma_{w+16} up to a multiple of 16 u, at least 2^-16; KAPPA(w)
// = 1 + (gamma_w / 2u + 3) u up to a multiple of 2^-16 (1 + 2^-16 up to
// w = 505, 1 + 2^-15 at w = 960). Up to w = 239 they are the constants the
// w <= 128 path always had. They come in as arguments; slack in them costs
// rechecks, never the answer. Taking b and q as their tile's largest gives
// E_i per row and tile. On data with a large common offset the last term,
// the exact chain's own rounding, dominates and the window widens: the f32
// answer is itself rounding-bound there, and the rechecks decide it as
// exactly.
// Inputs are taken finite, with squares that stay normal floats.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and fences

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

// shared memory a block may hold (H100: 227 KB)
constexpr int kMaxSmem = 232448;

// ----------------------------------------------------------- tiled path --
namespace tiled {

constexpr int WGS = 3;        // warpgroups a block, 64 rows each
constexpr int R = 64 * WGS;   // points a block
constexpr int N = 64;         // centroids a tile: wgmma m64n64k8
constexpr int STAGES = 2;     // centroid tiles in flight
constexpr int THREADS = 128 * WGS;
constexpr int PRODUCER = THREADS - 128;  // the last warpgroup's first thread issues the loads
constexpr int BOX = 32;       // floats a swizzled row (128 bytes): a box of features
constexpr int ROW = 128;      // bytes a swizzled row
constexpr int CAP = 256;      // recheck queue entries a warp
constexpr int MAX_WP = 128;
constexpr int REC = N + 4;    // floats of a tile's record: c'2 of its N columns, b, q, pad
constexpr unsigned long long START = 0x7f80000000000000ull;  // (+inf, index 0)

// Byte offsets from the 1 KB-aligned base (the 128-byte swizzle repeats
// every 1 KB): the points, the centroid ring (a stage: the tile, then its
// record in the next 1 KB), then each row's key, its x2, x'2, |x'| and |x|
// bounds and its U as last published, the warps' recheck queues
// (candidates, then their lower bounds), the block's recheck count and the
// ring's mbarriers.
struct Layout {
  int pts, tile, stage, best, rows, queue, count, bars, bytes;
  __host__ __device__ explicit Layout(int wp)
      : pts(R * wp * 4), tile(N * wp * 4), stage(tile + 1024), best(pts + STAGES * stage),
        rows(best + 8 * R),
        queue(rows + 20 * R), count(queue + 8 * (THREADS / 32) * CAP), bars(count + 8),
        bytes(bars + 16 * STAGES + 1024) {}
};

// Byte offset of (row r, feature f) in a box-major tile of `rows` rows:
// box f / 32, its 16-byte chunk (f % 32) / 4 stored at chunk ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int f, int rows) {
  return (f / BOX) * rows * ROW + r * ROW + ((((f % BOX) >> 2) ^ (r & 7)) << 4) + ((f & 3) << 2);
}

// D (64 x 64, f32) [+]= A (64 x 8, shared, K-major) * B (8 x 64, shared,
// K-major) in TF32; `accumulate` = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Scratch (floats): the centred centroids as the tiles' stage images (P,
// tiles, N wp + 256): each tile exactly as its ring stage holds it (box-
// major, 128-byte swizzled), then its record (REC floats: its columns' c'2,
// its largest |c'| and |c| bounds), so that one bulk copy moves both; then
// c2 (P, k_pad) and mu (P, wp). The wrapper allocates
// tiled_scratch_floats(...) of them.
struct Scratch {
  float *stages, *c2, *mu;
  long long floats;
  Scratch(float* s, int n_pairs, int k_pad, int wp) {
    const long long p = n_pairs, tiles = k_pad / N;
    stages = s;
    c2 = stages + p * tiles * (N * wp + 256);
    mu = c2 + p * k_pad;
    floats = (mu + p * wp) - s;
  }
};

// One block a (tile of N centroids, pair), one thread a centroid: the
// pair's mean mu (every block sums it alike, in index order), then the
// tile's rows staged in shared memory and, from them, each centroid's
// exact c2 chain, its centred row and c'2, and the tile's largest bounds.
__global__ void __launch_bounds__(N)
prep_kernel(const float* __restrict__ cs, Scratch sc, int k, int w, int wp, int k_pad,
            float kappa) {
  __shared__ float mu[MAX_WP];
  __shared__ float rows[N][MAX_WP + 1];
  __shared__ float red[2][2];
  const int pair = blockIdx.y, tile = blockIdx.x, j0 = tile * N;
  const float* c = cs + static_cast<size_t>(pair) * k * w;
  for (int f = threadIdx.x; f < wp; f += N) {
    float m = 0.f;
    if (f < w) {
      float s = 0.f;
#pragma unroll 8
      for (int j = 0; j < k; ++j) s += __ldg(c + static_cast<size_t>(j) * w + f);
      m = s / static_cast<float>(k);
    }
    mu[f] = m;
    if (tile == 0) sc.mu[pair * wp + f] = m;
  }
  for (int idx = threadIdx.x; idx < N * w; idx += N) {
    const int jj = idx / w, t = idx - jj * w;
    rows[jj][t] = j0 + jj < k ? __ldg(c + static_cast<size_t>(j0) * w + idx) : 0.f;
  }
  __syncthreads();
  float* out = sc.stages + (static_cast<size_t>(pair) * gridDim.x + tile) * (N * wp + 256);
  for (int idx = threadIdx.x; idx < N * wp; idx += N) {
    const int jj = idx / wp, t = idx - jj * wp;
    out[swz(jj, t, N) / 4] = t < w && j0 + jj < k ? rows[jj][t] - mu[t] : 0.f;
  }
  const int jj = threadIdx.x;
  float c2 = 0.f, cb2 = 0.f;
  for (int t = 0; t < w; ++t) {
    const float v = rows[jj][t];
    c2 = fmaf(v, v, c2);
    const float vb = j0 + jj < k ? v - mu[t] : 0.f;
    cb2 = fmaf(vb, vb, cb2);
  }
  float* rec = out + N * wp;
  sc.c2[static_cast<size_t>(pair) * k_pad + j0 + jj] = c2;
  rec[jj] = cb2;
  float b = sqrtf(cb2) * kappa, q = sqrtf(c2) * kappa;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
    q = fmaxf(q, __shfl_xor_sync(0xffffffffu, q, o));
  }
  if (jj % 32 == 0) {
    red[jj / 32][0] = b;
    red[jj / 32][1] = q;
  }
  __syncthreads();
  if (jj < REC - N) rec[N + jj] = jj == 0 ? fmaxf(red[0][0], red[1][0])
                                 : jj == 1 ? fmaxf(red[0][1], red[1][1]) : 0.f;
}

// Named barriers between two warpgroups, one waiting and one arriving
// (0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// A tile's centred norms c'2 for this thread's 16 columns and its largest
// |c'| and |c| bounds.
struct TileVals {
  float cb2[16];
  float b, q;
};

// acc[idx] for an index known only at run time, without moving acc to
// local memory (candidates are rare).
__device__ __forceinline__ float pick(const float (&acc)[32], int idx) {
  float v = acc[0];
#pragma unroll
  for (int i = 1; i < 32; ++i) v = idx == i ? acc[i] : v;
  return v;
}

// The screen and the rechecks (see the header). VEC: w % 4 == 0, so rows
// load as float4. BOXES: wp / 32, so that the k-steps (4 a box, zero past
// w) unroll and every wgmma of a tile stays in flight at once.
template <bool VEC, int BOXES>
__global__ void __launch_bounds__(THREADS, 1)
screen_kernel(const float* __restrict__ xs,
              const float* __restrict__ cs, const Scratch sc, int* __restrict__ assign,
              float* __restrict__ dmin, unsigned long long* __restrict__ rechecks, int n, int k,
              int w, int wp, int k_pad, float gamma, float eps, float kappa) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_u32(smem_raw));
  const Layout L(wp);
  uint8_t* xc = sm;  // the points: raw until their x2 chains are taken, then centred
  const uint32_t ring = base + L.pts;
  unsigned long long* best = reinterpret_cast<unsigned long long*>(sm + L.best);
  float* x2s = reinterpret_cast<float*>(sm + L.rows);
  float* xb2s = x2s + R;
  float* as = xb2s + R;
  float* ps = as + R;
  float* urow = ps + R;
  uint32_t* queue = reinterpret_cast<uint32_t*>(sm + L.queue);
  unsigned int* count = reinterpret_cast<unsigned int*>(sm + L.count);
  const uint32_t full = base + L.bars, empty = full + 8 * STAGES;

  const int tid = threadIdx.x, pair = blockIdx.y, tiles = k_pad / N;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const size_t pbase = static_cast<size_t>(pair) * n;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);  // one arrival per warp
    }
    *count = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the block's points, zero past w and past n: every load of a thread
  // first (so they are in flight together), then the stores; first raw,
  // for each row's exact x2 chain, then centred in place
  const float* mu = sc.mu + pair * wp;
  constexpr int C4 = 8 * BOXES;  // float4 a row
  constexpr int LOADS = (R * C4 + THREADS - 1) / THREADS;
  float4 v[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int idx = tid + i * THREADS, r = idx / C4, f = 4 * (idx % C4);
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx < R * C4 && row0 + r < n && f < w) {
      const float* src = xs + (pbase + row0 + r) * w + f;
      if (VEC) {
        v[i] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        v[i].x = __ldg(src);
        if (f + 1 < w) v[i].y = __ldg(src + 1);
        if (f + 2 < w) v[i].z = __ldg(src + 2);
        if (f + 3 < w) v[i].w = __ldg(src + 3);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int idx = tid + i * THREADS;
    if (idx < R * C4) *reinterpret_cast<float4*>(xc + swz(idx / C4, 4 * (idx % C4), R)) = v[i];
  }
  __syncthreads();
  // a row's chain over its zero-padded width: the zeros past w add nothing
  auto row_chain = [&](int r) {
    float s2 = 0.f;
#pragma unroll
    for (int t4 = 0; t4 < C4; ++t4) {
      const float4 a = *reinterpret_cast<const float4*>(xc + swz(r, 4 * t4, R));
      s2 = fmaf(a.x, a.x, s2);
      s2 = fmaf(a.y, a.y, s2);
      s2 = fmaf(a.z, a.z, s2);
      s2 = fmaf(a.w, a.w, s2);
    }
    return s2;
  };
  if (tid < R) {  // each row's exact x2 chain
    const float x2 = row_chain(tid);
    x2s[tid] = x2;
    ps[tid] = sqrtf(x2) * kappa;
    best[tid] = START;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int idx = tid + i * THREADS, r = idx / C4, f = 4 * (idx % C4);
    if (idx < R * C4) {
      float4 vb = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < n) {  // zero past w, where mu is zero too
        vb.x = f < w ? v[i].x - mu[f] : 0.f;
        vb.y = f + 1 < w ? v[i].y - mu[f + 1] : 0.f;
        vb.z = f + 2 < w ? v[i].z - mu[f + 2] : 0.f;
        vb.w = f + 3 < w ? v[i].w - mu[f + 3] : 0.f;
      }
      *reinterpret_cast<float4*>(xc + swz(r, f, R)) = vb;
    }
  }
  fence_proxy_async();  // the centred tile is wgmma's A operand
  __syncthreads();
  if (tid < R) {  // and its centred x'2
    const float xb2 = row_chain(tid);
    xb2s[tid] = xb2;
    as[tid] = sqrtf(xb2) * kappa;
  }
  __syncthreads();

  // Blocks walk the tiles from different starts, so that the card's SMs
  // read different centroids from L2 at a time, not all the same ones (the
  // key, and so the answer, does not depend on the order).
  const int start = blockIdx.x % tiles;
  auto rotated = [&](int t) { return t + start < tiles ? t + start : t + start - tiles; };

  // one thread streams the centred centroid tiles, one bulk copy a tile
  // and its record: the block's t-th into stage t % STAGES once every warp
  // has released the one before it there
  auto load_tile = [&](int t) {
    const int s = t % STAGES;
    if (t >= STAGES) mbar_wait(empty + 8 * s, (t / STAGES - 1) & 1);
    mbar_expect_tx(full + 8 * s, L.tile + REC * 4);
    bulk_load(ring + s * L.stage,
              sc.stages + (static_cast<size_t>(pair) * tiles + rotated(t)) * (N * wp + 256),
              L.tile + REC * 4, full + 8 * s);
  };
  if (tid == PRODUCER)
    for (int t = 0; t < min(STAGES, tiles); ++t) load_tile(t);

  // ---- warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
  // accumulator layout: this thread holds rows r0 and r0 + 8, columns
  // 8 i + cq + {0, 1} (element 4 i + 2 h + e is row r0 + 8 h, column
  // 8 i + cq + e)
  const int wg = tid / 128, lane = tid % 32;
  const int cq = 2 * (lane % 4);
  const int r0 = 64 * wg + 16 * ((tid / 32) % 4) + lane / 4;  // rows r0 and r0 + 8
  bool live[2];
  float xb2[2], a[2], p[2], U[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    live[h] = row0 + r0 + 8 * h < n;
    xb2[h] = xb2s[r0 + 8 * h];
    a[h] = as[r0 + 8 * h];
    p[h] = ps[r0 + 8 * h];
    U[h] = CUDART_INF_F;
  }
  const uint32_t xa = base + 64 * wg * ROW;  // this warpgroup's centred rows
  uint32_t* myq = queue + (tid / 32) * CAP;        // candidates: j << 8 | row
  float* mylb = reinterpret_cast<float*>(queue + (THREADS / 32) * CAP) + (tid / 32) * CAP;
  const float* c2p = sc.c2 + static_cast<size_t>(pair) * k_pad;
  const float* craw = cs + static_cast<size_t>(pair) * k * w;
  unsigned int done = 0;  // rechecks this thread ran

  // S = X' C'^T for the block's t-th tile: a k-step moves 32 bytes along
  // the swizzled row, or to the next box every 4 steps. The tile's record
  // (its c'2 and bounds) came with it into the stage: read before release.
  auto issue = [&](int t, float(&acc)[32], TileVals& tv) {
    const int s = t % STAGES;
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    const uint32_t cb = ring + s * L.stage;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * BOXES; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_tf32(acc, sw128_desc(xa + (kk / 4) * R * ROW + col, 16, 1024),
                 sw128_desc(cb + (kk / 4) * N * ROW + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    const float* rec = reinterpret_cast<const float*>(sm + (cb - base) + L.tile);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(rec + 8 * i + cq);
      tv.cb2[2 * i] = v.x;
      tv.cb2[2 * i + 1] = v.y;
    }
    tv.b = rec[N];
    tv.q = rec[N + 1];
  };

  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % STAGES));
    // the last warpgroup takes its turn last: its first thread refills
    if (tid == PRODUCER && t + STAGES < tiles) load_tile(t + STAGES);
  };

  // d_ij by the one-tile kernel's chain from the raw rows (global memory,
  // in L2), folded into row r's key
  auto recheck = [&](int r, int j) {
    const float* xi = xs + (pbase + row0 + r) * w;
    const float* cj = craw + static_cast<size_t>(j) * w;
    float dot = 0.f;
    if (VEC) {
#pragma unroll 16
      for (int t4 = 0; t4 < w / 4; ++t4) {
        const float4 xv = __ldg(reinterpret_cast<const float4*>(xi) + t4);
        const float4 cv = __ldg(reinterpret_cast<const float4*>(cj) + t4);
        dot = fmaf(xv.x, cv.x, dot);
        dot = fmaf(xv.y, cv.y, dot);
        dot = fmaf(xv.z, cv.z, dot);
        dot = fmaf(xv.w, cv.w, dot);
      }
    } else {
#pragma unroll 8
      for (int t = 0; t < w; ++t) dot = fmaf(__ldg(xi + t), __ldg(cj + t), dot);
    }
    const float d = fmaxf((x2s[r] + __ldg(c2p + j)) - 2.0f * dot, 0.0f);
    atomicMin(best + r, (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
                            static_cast<unsigned int>(j));
  };

  // Recheck the queued candidates whose lower bound e_ij - E_i still
  // reaches their row's bound U (every minimiser does: see the header),
  // compacted first so that lanes take whole rounds of 32; then lower each
  // row's bound to its exact best.
  int pending = 0;  // candidates queued, warp-uniform
  auto flush = [&]() {
    if (lane % 4 == 0) {
      urow[r0] = U[0];
      urow[r0 + 8] = U[1];
    }
    __syncwarp();
    int kept = 0;
    for (int b0 = 0; b0 < pending; b0 += 32) {
      const int q = b0 + lane;
      const uint32_t item = q < pending ? myq[q] : 0u;
      const bool keep = q < pending && mylb[q] <= urow[item & 255];
      const unsigned int ballot = __ballot_sync(0xffffffffu, keep);
      __syncwarp();
      if (keep) myq[kept + __popc(ballot & ((1u << lane) - 1u))] = item;
      kept += __popc(ballot);
      __syncwarp();
    }
    for (int q = lane; q < kept; q += 32) {
      const uint32_t item = myq[q];
      recheck(static_cast<int>(item & 255), static_cast<int>(item >> 8));
      ++done;
    }
    __syncwarp();
    pending = 0;
    const volatile unsigned long long* vbest = best;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      U[h] = fminf(U[h], __uint_as_float(static_cast<uint32_t>(vbest[r0 + 8 * h] >> 32)));
  };

  auto epilogue = [&](int t, float(&acc)[32], const TileVals& tv) {
    const int j0 = rotated(t) * N;
    const bool ragged = j0 + N > k;  // the last tile's columns past k
    uint32_t mine = 0;  // bit 4 i + 2 h + e: that element is a candidate
    float eh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ab = a[h] + tv.b, pq = p[h] + tv.q;
      eh[h] = fmaf(2.0f * gamma * a[h], tv.b, eps * fmaf(ab, ab, pq * pq));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = acc[4 * i + 2 * h + e];
          v = fmaxf(fmaf(-2.0f, v, xb2[h] + tv.cb2[2 * i + e]), 0.0f);
        }
      if (ragged) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (j0 + 8 * i + cq + e >= k) acc[4 * i + 2 * h + e] = CUDART_INF_F;
      }
      float m[2] = {CUDART_INF_F, CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) m[e] = fminf(m[e], acc[4 * i + 2 * h + e]);
      m[0] = fminf(m[0], m[1]);
      m[0] = fminf(m[0], __shfl_xor_sync(0xffffffffu, m[0], 1));
      m[0] = fminf(m[0], __shfl_xor_sync(0xffffffffu, m[0], 2));
      U[h] = fminf(U[h], m[0] + eh[h]);
      const float thr = live[h] ? U[h] + eh[h] : -1.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (acc[4 * i + 2 * h + e] <= thr) mine |= 1u << (4 * i + 2 * h + e);
    }
    // queue the candidates with their lower bounds, one a lane a step
    // (slots by ballot); a queue that would overflow is flushed first
    for (;;) {
      const unsigned int ballot = __ballot_sync(0xffffffffu, mine != 0);
      if (ballot == 0) break;
      if (pending + __popc(ballot) > CAP) flush();
      if (mine != 0) {
        const int idx = __ffs(mine) - 1;
        mine &= mine - 1;
        const int h = (idx >> 1) & 1;
        const int slot = pending + __popc(ballot & ((1u << lane) - 1u));
        myq[slot] = (static_cast<uint32_t>(j0 + 8 * (idx >> 2) + cq + (idx & 1)) << 8) |
                    (r0 + 8 * h);
        mylb[slot] = pick(acc, idx) - (h ? eh[1] : eh[0]);
      }
      pending += __popc(ballot);
      __syncwarp();
    }
  };

  // The warpgroups take the tensor cores in turns (named barrier 2 + wg:
  // each waits on its own and arrives on the next one's), so that one's
  // products run while the others' epilogues do; free-running warpgroups
  // measured slower.
  const int mine_bar = 2 + wg, next_bar = 2 + (wg + 1) % WGS;
  float acc[32];
  TileVals tv;
  for (int t = 0; t < tiles; ++t) {
    if (t > 0 || wg > 0) bar_sync(mine_bar);
    issue(t, acc, tv);
    wgmma_wait<0>();
    fence_regs(acc);
    release(t);
    bar_arrive(next_bar);
    epilogue(t, acc, tv);
    __syncwarp();
  }
  if (wg == 0) bar_sync(mine_bar);  // the last warpgroup's last arrival
  flush();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (live[h] && lane % 4 == 0) {
      const unsigned long long key = best[r0 + 8 * h];
      assign[pbase + row0 + r0 + 8 * h] = static_cast<int>(key & 0xffffffffu);
      dmin[pbase + row0 + r0 + 8 * h] = __uint_as_float(static_cast<uint32_t>(key >> 32));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) done += __shfl_xor_sync(0xffffffffu, done, o);
  if (lane == 0) atomicAdd(count, done);
  __syncthreads();
  if (tid == 0) atomicAdd(rechecks, static_cast<unsigned long long>(*count));
}

template <bool VEC, int BOXES>
int launch_vec(const float* xs, const float* cs, int* assign, float* dmin, int n_pairs, int n,
               int k, int w, float gamma, float eps, float kappa, const Scratch& sc, int wp,
               int k_pad, unsigned long long* rechecks, cudaStream_t stream) {
  auto kernel = screen_kernel<VEC, BOXES>;
  const Layout L(wp);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>((n + R - 1) / R), n_pairs);
  kernel<<<grid, THREADS, L.bytes, stream>>>(xs, cs, sc, assign, dmin, rechecks, n, k, w,
                                             wp, k_pad, gamma, eps, kappa);
  return static_cast<int>(cudaGetLastError());
}

template <typename... A>
int launch_any(bool vec, int boxes, A... a) {
  if (vec) {
    switch (boxes) {
      case 1: return launch_vec<true, 1>(a...);
      case 2: return launch_vec<true, 2>(a...);
      case 3: return launch_vec<true, 3>(a...);
      default: return launch_vec<true, 4>(a...);
    }
  }
  switch (boxes) {
    case 1: return launch_vec<false, 1>(a...);
    case 2: return launch_vec<false, 2>(a...);
    case 3: return launch_vec<false, 3>(a...);
    default: return launch_vec<false, 4>(a...);
  }
}

int launch(const float* xs, const float* cs, int* assign, float* dmin, int n_pairs, int n, int k,
           int w, float gamma, float eps, float kappa, float* scratch, long long scratch_floats,
           unsigned long long* rechecks, cudaStream_t stream) {
  const int wp = (w + BOX - 1) / BOX * BOX;
  const int k_pad = (k + N - 1) / N * N;
  if (scratch == nullptr || rechecks == nullptr ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc(scratch, n_pairs, k_pad, wp);
  if (sc.floats > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  prep_kernel<<<dim3(k_pad / N, n_pairs), N, 0, stream>>>(cs, sc, k, w, wp, k_pad, kappa);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_any(w % 4 == 0, wp / BOX, xs, cs, assign, dmin, n_pairs, n, k, w, gamma, eps,
                    kappa, sc, wp, k_pad, rechecks, stream);
}

}  // namespace tiled

// ----------------------------------------------------- wide tiled path --
// Rows wider than 128 floats (e.g. GIST's 960). A block's 192 points no
// longer fit in shared memory (737 KB at w = 960), so they are streamed too:
// a pre-pass (prep_points_kernel) writes each block's points centred, as
// the very images a ring stage holds, one image of 64 features (two
// 128-byte-swizzled boxes) a chunk, with each row's exact x2 and x'2 chains
// beside them; prep_wide_kernel writes the centroid tiles as prep_kernel
// does, at the width rounded up to 64. A stage holds one chunk of the
// block's points (48 KB) and of one centroid tile (16 KB); the producer
// streams (tile, chunk) items through three stages, two bulk copies an
// item, and each warpgroup accumulates its rows' wgmma m64n64k8 products
// over the chunks of a tile before its epilogue, which is tiled::'s: the
// same screen, queue, rechecks and key, with the window G(w), EPS(w) and
// KAPPA(w) the wrapper passes. The warpgroups run free (no turns): a stage
// is released when all twelve warps are done with it. The points' scratch
// holds a bounded run of row blocks (about 1 GB; the wrapper sizes it), and
// the launch runs the pre-pass and the screen once a run. Run at w = 128
// (IVF's 10^6 points against 1024 lists) this path takes 1.5x the
// resident-points one (PERF.md §6), so both stay.
namespace wide {

using tiled::BOX;
using tiled::CAP;
using tiled::N;
using tiled::PRODUCER;
using tiled::R;
using tiled::ROW;
using tiled::START;
using tiled::THREADS;
using tiled::wgmma_tf32;

constexpr int CB = 2;                   // boxes a chunk
constexpr int CF = CB * BOX;            // features a chunk
constexpr int STAGES = 3;               // (tile, chunk) items in flight
constexpr int A_BYTES = R * CB * ROW;   // a chunk of the block's points
constexpr int B_BYTES = N * CB * ROW;   // a chunk of a centroid tile
constexpr int STAGE = A_BYTES + B_BYTES;

// Byte offsets from the 1 KB-aligned base: the ring, then as tiled::Layout
// each row's key, its x2, x'2, |x'| and |x| bounds and U, the warps' queues,
// the block's recheck count and the ring's mbarriers.
struct Layout {
  int best, rows, queue, count, bars, bytes;
  __host__ __device__ Layout()
      : best(STAGES * STAGE), rows(best + 8 * R), queue(rows + 20 * R),
        count(queue + 8 * (THREADS / 32) * CAP), bars(count + 8),
        bytes(bars + 16 * STAGES + 1024) {}
};

// Scratch (floats): the centroid part as tiled::Scratch at width wq (w up
// to a multiple of CF), then a run of n_rb row blocks of points: their
// images (P, n_rb, chunks, R CF) and each row's (x2, x'2) (P, n_rb R, 2).
struct Scratch {
  tiled::Scratch cen;
  float *pts, *rows;
  long long floats;
  Scratch(float* s, int n_pairs, int k_pad, int wq, int n_rb)
      : cen(s, n_pairs, k_pad, wq) {
    const long long p = n_pairs;
    pts = s + cen.floats;
    rows = pts + p * n_rb * (wq / CF) * R * CF;
    floats = (rows + p * n_rb * R * 2) - s;
  }
};

// Each pair's centroid mean mu (zero past w), one thread a feature, summed
// in index order as prep_kernel sums it.
__global__ void mean_kernel(const float* __restrict__ cs, tiled::Scratch sc, int k, int w,
                            int wq) {
  const int pair = blockIdx.y, f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= wq) return;
  float m = 0.f;
  if (f < w) {
    const float* c = cs + static_cast<size_t>(pair) * k * w;
    float s = 0.f;
#pragma unroll 8
    for (int j = 0; j < k; ++j) s += __ldg(c + static_cast<size_t>(j) * w + f);
    m = s / static_cast<float>(k);
  }
  sc.mu[static_cast<size_t>(pair) * wq + f] = m;
}

// prep_kernel at any width: each centroid's row read from global memory as
// its chains are taken, mu from mean_kernel.
__global__ void __launch_bounds__(N)
prep_wide_kernel(const float* __restrict__ cs, tiled::Scratch sc, int k, int w, int wq,
                 int k_pad, float kappa) {
  __shared__ float red[2][2];
  const int pair = blockIdx.y, tile = blockIdx.x, j0 = tile * N;
  const float* c = cs + static_cast<size_t>(pair) * k * w;
  const float* mu = sc.mu + static_cast<size_t>(pair) * wq;
  float* out = sc.stages + (static_cast<size_t>(pair) * gridDim.x + tile) * (N * wq + 256);
  const int jj = threadIdx.x;
  const bool alive = j0 + jj < k;
  const float* row = c + static_cast<size_t>(alive ? j0 + jj : 0) * w;
  float c2 = 0.f, cb2 = 0.f;
  for (int t = 0; t < wq; ++t) {
    const float v = alive && t < w ? __ldg(row + t) : 0.f;
    const float vb = alive && t < w ? v - __ldg(mu + t) : 0.f;
    c2 = fmaf(v, v, c2);
    cb2 = fmaf(vb, vb, cb2);
    out[tiled::swz(jj, t, N) / 4] = vb;
  }
  float* rec = out + N * wq;
  sc.c2[static_cast<size_t>(pair) * k_pad + j0 + jj] = c2;
  rec[jj] = cb2;
  float b = sqrtf(cb2) * kappa, q = sqrtf(c2) * kappa;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
    q = fmaxf(q, __shfl_xor_sync(0xffffffffu, q, o));
  }
  if (jj % 32 == 0) {
    red[jj / 32][0] = b;
    red[jj / 32][1] = q;
  }
  __syncthreads();
  if (jj < tiled::REC - N) rec[N + jj] = jj == 0 ? fmaxf(red[0][0], red[1][0])
                                        : jj == 1 ? fmaxf(red[0][1], red[1][1]) : 0.f;
}

// One block a (row block of R points, pair), row block rb0 + blockIdx.x of
// the pair and slot blockIdx.x of the scratch's n_rb: each chunk of CF
// features loaded raw into a shared-memory image (coalesced), each row's x2
// and x'2 chains carried on in feature order by its thread, the chunk
// centred in place (zero past w and past n) and copied out as its stage
// image.
template <bool VEC>
__global__ void __launch_bounds__(256)
prep_points_kernel(const float* __restrict__ xs, Scratch sc, int n, int w, int wq, int n_rb,
                   int rb0) {
  extern __shared__ __align__(16) uint8_t img[];  // A_BYTES, then the chunk's mu
  float* muc = reinterpret_cast<float*>(img + A_BYTES);
  const int tid = threadIdx.x, pair = blockIdx.y, rb = blockIdx.x, chunks = wq / CF;
  const long long row0 = static_cast<long long>(rb0 + rb) * R;
  const float* x = xs + static_cast<size_t>(pair) * n * w;
  const float* mu = sc.cen.mu + static_cast<size_t>(pair) * wq;
  const bool live = tid < R && row0 + tid < n;
  float x2 = 0.f, xb2 = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    const int f0 = ch * CF;
    if (tid < CF) muc[tid] = mu[f0 + tid];
    for (int idx = tid; idx < R * (CF / 4); idx += blockDim.x) {
      const int r = idx / (CF / 4), f = 4 * (idx % (CF / 4)), g = f0 + f;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < n && g < w) {
        const float* src = x + static_cast<size_t>(row0 + r) * w + g;
        if (VEC) {
          v = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          v.x = __ldg(src);
          if (g + 1 < w) v.y = __ldg(src + 1);
          if (g + 2 < w) v.z = __ldg(src + 2);
          if (g + 3 < w) v.w = __ldg(src + 3);
        }
      }
      *reinterpret_cast<float4*>(img + tiled::swz(r, f, R)) = v;
    }
    __syncthreads();
    if (tid < R) {
#pragma unroll 4
      for (int f = 0; f < CF; f += 4) {
        float4* at = reinterpret_cast<float4*>(img + tiled::swz(tid, f, R));
        const float4 a = *at;
        x2 = fmaf(a.x, a.x, x2);
        x2 = fmaf(a.y, a.y, x2);
        x2 = fmaf(a.z, a.z, x2);
        x2 = fmaf(a.w, a.w, x2);
        float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live) {
          b.x = f0 + f < w ? a.x - muc[f] : 0.f;
          b.y = f0 + f + 1 < w ? a.y - muc[f + 1] : 0.f;
          b.z = f0 + f + 2 < w ? a.z - muc[f + 2] : 0.f;
          b.w = f0 + f + 3 < w ? a.w - muc[f + 3] : 0.f;
        }
        xb2 = fmaf(b.x, b.x, xb2);
        xb2 = fmaf(b.y, b.y, xb2);
        xb2 = fmaf(b.z, b.z, xb2);
        xb2 = fmaf(b.w, b.w, xb2);
        *at = b;
      }
    }
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(
        sc.pts + ((static_cast<size_t>(pair) * n_rb + rb) * chunks + ch) * (R * CF));
    for (int i = tid; i < A_BYTES / 16; i += blockDim.x)
      dst[i] = reinterpret_cast<const float4*>(img)[i];
    __syncthreads();
  }
  if (tid < R) {
    float* rv = sc.rows + ((static_cast<size_t>(pair) * n_rb + rb) * R + tid) * 2;
    rv[0] = x2;
    rv[1] = xb2;
  }
}

// The screen and the rechecks of tiled::screen_kernel, its points streamed
// from the pre-pass's images (see above): row block rb0 + blockIdx.x of the
// pair, slot blockIdx.x of the scratch's n_rb.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
wide_kernel(const float* __restrict__ xs, const float* __restrict__ cs, const Scratch sc,
            int* __restrict__ assign, float* __restrict__ dmin,
            unsigned long long* __restrict__ rechecks, int n, int k, int w, int wq, int k_pad,
            int n_rb, int rb0, float gamma, float eps, float kappa) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_u32(smem_raw));
  const Layout L;
  const uint32_t ring = base;
  unsigned long long* best = reinterpret_cast<unsigned long long*>(sm + L.best);
  float* x2s = reinterpret_cast<float*>(sm + L.rows);
  float* xb2s = x2s + R;
  float* as = xb2s + R;
  float* ps = as + R;
  float* urow = ps + R;
  uint32_t* queue = reinterpret_cast<uint32_t*>(sm + L.queue);
  unsigned int* count = reinterpret_cast<unsigned int*>(sm + L.count);
  const uint32_t full = base + L.bars, empty = full + 8 * STAGES;

  const int tid = threadIdx.x, pair = blockIdx.y, tiles = k_pad / N;
  const int chunks = wq / CF, items = tiles * chunks;
  const long long row0 = static_cast<long long>(rb0 + blockIdx.x) * R;
  const size_t pbase = static_cast<size_t>(pair) * n;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);  // one arrival per warp
    }
    *count = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < R) {  // the pre-pass's chains
    const float* rv = sc.rows + ((static_cast<size_t>(pair) * n_rb + blockIdx.x) * R + tid) * 2;
    x2s[tid] = rv[0];
    xb2s[tid] = rv[1];
    ps[tid] = sqrtf(rv[0]) * kappa;
    as[tid] = sqrtf(rv[1]) * kappa;
    best[tid] = START;
  }
  __syncthreads();

  const int start = (rb0 + blockIdx.x) % tiles;
  auto rotated = [&](int t) { return t + start < tiles ? t + start : t + start - tiles; };
  const float* cen = sc.cen.stages + static_cast<size_t>(pair) * tiles * (N * wq + 256);
  const float* pts = sc.pts + (static_cast<size_t>(pair) * n_rb + blockIdx.x) * chunks * (R * CF);

  // one thread streams item i = (tile i / chunks, chunk i % chunks): the
  // block's points' chunk and the tile's, into stage i % STAGES once every
  // warp has released the item before it there
  auto load_item = [&](int i) {
    const int s = i % STAGES, t = i / chunks, ch = i % chunks;
    if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
    mbar_expect_tx(full + 8 * s, STAGE);
    bulk_load(ring + s * STAGE, pts + static_cast<size_t>(ch) * (R * CF), A_BYTES, full + 8 * s);
    bulk_load(ring + s * STAGE + A_BYTES,
              cen + static_cast<size_t>(rotated(t)) * (N * wq + 256) + static_cast<size_t>(ch) * N * CF,
              B_BYTES, full + 8 * s);
  };
  if (tid == PRODUCER)
    for (int i = 0; i < min(STAGES, items); ++i) load_item(i);

  // ---- warpgroup wg owns rows 64 wg .. 64 wg + 63 (tiled::screen_kernel's
  // accumulator layout) ----
  const int wg = tid / 128, lane = tid % 32;
  const int cq = 2 * (lane % 4);
  const int r0 = 64 * wg + 16 * ((tid / 32) % 4) + lane / 4;  // rows r0 and r0 + 8
  bool live[2];
  float xb2[2], a[2], p[2], U[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    live[h] = row0 + r0 + 8 * h < n;
    xb2[h] = xb2s[r0 + 8 * h];
    a[h] = as[r0 + 8 * h];
    p[h] = ps[r0 + 8 * h];
    U[h] = CUDART_INF_F;
  }
  uint32_t* myq = queue + (tid / 32) * CAP;        // candidates: j << 8 | row
  float* mylb = reinterpret_cast<float*>(queue + (THREADS / 32) * CAP) + (tid / 32) * CAP;
  const float* c2p = sc.cen.c2 + static_cast<size_t>(pair) * k_pad;
  const float* craw = cs + static_cast<size_t>(pair) * k * w;
  unsigned int done = 0;  // rechecks this thread ran

  auto recheck = [&](int r, int j) {
    const float* xi = xs + (pbase + row0 + r) * w;
    const float* cj = craw + static_cast<size_t>(j) * w;
    float dot = 0.f;
    if (VEC) {
#pragma unroll 16
      for (int t4 = 0; t4 < w / 4; ++t4) {
        const float4 xv = __ldg(reinterpret_cast<const float4*>(xi) + t4);
        const float4 cv = __ldg(reinterpret_cast<const float4*>(cj) + t4);
        dot = fmaf(xv.x, cv.x, dot);
        dot = fmaf(xv.y, cv.y, dot);
        dot = fmaf(xv.z, cv.z, dot);
        dot = fmaf(xv.w, cv.w, dot);
      }
    } else {
#pragma unroll 8
      for (int t = 0; t < w; ++t) dot = fmaf(__ldg(xi + t), __ldg(cj + t), dot);
    }
    const float d = fmaxf((x2s[r] + __ldg(c2p + j)) - 2.0f * dot, 0.0f);
    atomicMin(best + r, (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
                            static_cast<unsigned int>(j));
  };

  int pending = 0;  // candidates queued, warp-uniform
  auto flush = [&]() {
    if (lane % 4 == 0) {
      urow[r0] = U[0];
      urow[r0 + 8] = U[1];
    }
    __syncwarp();
    int kept = 0;
    for (int b0 = 0; b0 < pending; b0 += 32) {
      const int q = b0 + lane;
      const uint32_t item = q < pending ? myq[q] : 0u;
      const bool keep = q < pending && mylb[q] <= urow[item & 255];
      const unsigned int ballot = __ballot_sync(0xffffffffu, keep);
      __syncwarp();
      if (keep) myq[kept + __popc(ballot & ((1u << lane) - 1u))] = item;
      kept += __popc(ballot);
      __syncwarp();
    }
    for (int q = lane; q < kept; q += 32) {
      const uint32_t item = myq[q];
      recheck(static_cast<int>(item & 255), static_cast<int>(item >> 8));
      ++done;
    }
    __syncwarp();
    pending = 0;
    const volatile unsigned long long* vbest = best;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      U[h] = fminf(U[h], __uint_as_float(static_cast<uint32_t>(vbest[r0 + 8 * h] >> 32)));
  };

  auto epilogue = [&](int t, float(&acc)[32], const tiled::TileVals& tv) {
    const int j0 = rotated(t) * N;
    const bool ragged = j0 + N > k;
    uint32_t mine = 0;
    float eh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ab = a[h] + tv.b, pq = p[h] + tv.q;
      eh[h] = fmaf(2.0f * gamma * a[h], tv.b, eps * fmaf(ab, ab, pq * pq));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = acc[4 * i + 2 * h + e];
          v = fmaxf(fmaf(-2.0f, v, xb2[h] + tv.cb2[2 * i + e]), 0.0f);
        }
      if (ragged) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (j0 + 8 * i + cq + e >= k) acc[4 * i + 2 * h + e] = CUDART_INF_F;
      }
      float m[2] = {CUDART_INF_F, CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) m[e] = fminf(m[e], acc[4 * i + 2 * h + e]);
      m[0] = fminf(m[0], m[1]);
      m[0] = fminf(m[0], __shfl_xor_sync(0xffffffffu, m[0], 1));
      m[0] = fminf(m[0], __shfl_xor_sync(0xffffffffu, m[0], 2));
      U[h] = fminf(U[h], m[0] + eh[h]);
      const float thr = live[h] ? U[h] + eh[h] : -1.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (acc[4 * i + 2 * h + e] <= thr) mine |= 1u << (4 * i + 2 * h + e);
    }
    for (;;) {
      const unsigned int ballot = __ballot_sync(0xffffffffu, mine != 0);
      if (ballot == 0) break;
      if (pending + __popc(ballot) > CAP) flush();
      if (mine != 0) {
        const int idx = __ffs(mine) - 1;
        mine &= mine - 1;
        const int h = (idx >> 1) & 1;
        const int slot = pending + __popc(ballot & ((1u << lane) - 1u));
        myq[slot] = (static_cast<uint32_t>(j0 + 8 * (idx >> 2) + cq + (idx & 1)) << 8) |
                    (r0 + 8 * h);
        mylb[slot] = tiled::pick(acc, idx) - (h ? eh[1] : eh[0]);
      }
      pending += __popc(ballot);
      __syncwarp();
    }
  };

  float acc[32];
  for (int t = 0; t < tiles; ++t) {
    for (int ch = 0; ch < chunks; ++ch) {
      const int i = t * chunks + ch, s = i % STAGES;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      const uint32_t st = ring + s * STAGE;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * CB; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_tf32(acc, sw128_desc(st + (kk / 4) * R * ROW + 64 * wg * ROW + col, 16, 1024),
                   sw128_desc(st + A_BYTES + (kk / 4) * N * ROW + col, 16, 1024),
                   ch > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (tid == PRODUCER && i + STAGES < items) load_item(i + STAGES);
    }
    // the tile's record (its c'2 and bounds), from global memory
    const float* rec = cen + static_cast<size_t>(rotated(t)) * (N * wq + 256) + N * wq;
    tiled::TileVals tv;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      tv.cb2[2 * i] = __ldg(rec + 8 * i + cq);
      tv.cb2[2 * i + 1] = __ldg(rec + 8 * i + cq + 1);
    }
    tv.b = __ldg(rec + N);
    tv.q = __ldg(rec + N + 1);
    epilogue(t, acc, tv);
    __syncwarp();
  }
  flush();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (live[h] && lane % 4 == 0) {
      const unsigned long long key = best[r0 + 8 * h];
      assign[pbase + row0 + r0 + 8 * h] = static_cast<int>(key & 0xffffffffu);
      dmin[pbase + row0 + r0 + 8 * h] = __uint_as_float(static_cast<uint32_t>(key >> 32));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) done += __shfl_xor_sync(0xffffffffu, done, o);
  if (lane == 0) atomicAdd(count, done);
  __syncthreads();
  if (tid == 0) atomicAdd(rechecks, static_cast<unsigned long long>(*count));
}

// The points' pre-pass and the screen over each run of n_rb row blocks
// that the scratch holds in turn (every row block is independent, so the
// answer does not depend on the runs).
template <bool VEC>
int launch_vec(const float* xs, const float* cs, int* assign, float* dmin, int n_pairs, int n,
               int k, int w, int wq, int k_pad, int n_rb, float gamma, float eps, float kappa,
               const Scratch& sc, unsigned long long* rechecks, cudaStream_t stream) {
  const int pts_smem = A_BYTES + CF * 4;
  auto prep = prep_points_kernel<VEC>;
  cudaError_t e =
      cudaFuncSetAttribute(prep, cudaFuncAttributeMaxDynamicSharedMemorySize, pts_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = wide_kernel<VEC>;
  const Layout L;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = (n + R - 1) / R;
  for (int rb0 = 0; rb0 < total; rb0 += n_rb) {
    const int run = min(n_rb, total - rb0);
    prep<<<dim3(run, n_pairs), 256, pts_smem, stream>>>(xs, sc, n, w, wq, n_rb, rb0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3(run, n_pairs), THREADS, L.bytes, stream>>>(
        xs, cs, sc, assign, dmin, rechecks, n, k, w, wq, k_pad, n_rb, rb0, gamma, eps, kappa);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

int launch(const float* xs, const float* cs, int* assign, float* dmin, int n_pairs, int n, int k,
           int w, float gamma, float eps, float kappa, float* scratch, long long scratch_floats,
           unsigned long long* rechecks, cudaStream_t stream) {
  const int wq = (w + CF - 1) / CF * CF;
  const int k_pad = (k + N - 1) / N * N;
  if (scratch == nullptr || rechecks == nullptr ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the row blocks of points the scratch holds past the centroids, at most
  // the pairs' own: the launch walks the rows in runs of that many
  const long long per_rb = static_cast<long long>(n_pairs) * R * (wq + 2);
  const long long room = scratch_floats - tiled::Scratch(scratch, n_pairs, k_pad, wq).floats;
  const long long fit = room / per_rb, rbs = (n + R - 1) / R;
  const int n_rb = static_cast<int>(fit < rbs ? fit : rbs);
  if (n_rb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc(scratch, n_pairs, k_pad, wq, n_rb);
  if (sc.floats > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  mean_kernel<<<dim3((wq + 255) / 256, n_pairs), 256, 0, stream>>>(cs, sc.cen, k, w, wq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  prep_wide_kernel<<<dim3(k_pad / N, n_pairs), N, 0, stream>>>(cs, sc.cen, k, w, wq, k_pad,
                                                               kappa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (w % 4 == 0)
    return launch_vec<true>(xs, cs, assign, dmin, n_pairs, n, k, w, wq, k_pad, n_rb, gamma,
                            eps, kappa, sc, rechecks, stream);
  return launch_vec<false>(xs, cs, assign, dmin, n_pairs, n, k, w, wq, k_pad, n_rb, gamma, eps,
                           kappa, sc, rechecks, stream);
}

}  // namespace wide

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
                 int n_pairs, int n, int k, int w, float gamma, float eps, float kappa,
                 float* scratch, long long scratch_floats, unsigned long long* rechecks,
                 cudaStream_t stream) {
  if (n <= 0 || n_pairs <= 0) return 0;
  if (k <= 0 || w <= 0 || n_pairs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (w > tiled::MAX_WP)
    return wide::launch(xs, cs, assign, dmin, n_pairs, n, k, w, gamma, eps, kappa, scratch,
                        scratch_floats, rechecks, stream);
  if (static_cast<size_t>(k) * (w + 1) * sizeof(float) > kMaxSmem)
    return tiled::launch(xs, cs, assign, dmin, n_pairs, n, k, w, gamma, eps, kappa, scratch,
                         scratch_floats, rechecks, stream);
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

// x (n, d), c (k, d) float32; assign (n,) int32, dmin (n,) float32; any d
// and k. Past shared memory or past d = 128 (the tiled paths) gamma, eps
// and kappa are the screen's window at this width, scratch holds
// scratch_floats floats (16-byte aligned; tiled_scratch_floats in
// kernels/kmeans_assign.py) and *rechecks, zeroed by the caller, gains the
// launch's recheck count; the one-tile path ignores the five.
int kmeans_assign_f32(const float* x, const float* c, int* assign, float* dmin, int n, int k,
                      int d, float gamma, float eps, float kappa, float* scratch,
                      long long scratch_floats, unsigned long long* rechecks,
                      cudaStream_t stream) {
  return launch_pairs(x, c, assign, dmin, 1, n, k, d, gamma, eps, kappa, scratch,
                      scratch_floats, rechecks, stream);
}

// xs (n_pairs, n, w), cs (n_pairs, k, w) float32, each pair zero-padded to
// w; assign (n_pairs, n) int32, dmin (n_pairs, n) float32; the rest as
// above.
int kmeans_assign_pairs_f32(const float* xs, const float* cs, int* assign, float* dmin,
                            int n_pairs, int n, int k, int w, float gamma, float eps,
                            float kappa, float* scratch, long long scratch_floats,
                            unsigned long long* rechecks, cudaStream_t stream) {
  return launch_pairs(xs, cs, assign, dmin, n_pairs, n, k, w, gamma, eps, kappa, scratch,
                      scratch_floats, rechecks, stream);
}

}  // extern "C"
