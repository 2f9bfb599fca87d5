// Fused softmax attention O = softmax(Q K^T * hd^-1/2) V, forward, with an
// optional causal mask (key position <= query position, top-left aligned).
//
// Replaces: flash_attention_pallas / _flash_kernel in
// src/repro/kernels/flash_attention.py (grid (BH, S/128, T/128), (m, l, acc)
// carried in VMEM scratch across the key axis, f32 dots).
//
// Bound on the H100: operations. Every unmasked (query, key) pair costs
// 2 hd FLOPs for the score and 2 hd for the P.V product, so at S = T = 4096
// and hd = 64 the work is ~4 * 4096^2/2 * 64 FLOPs per head against
// 3 * 4096 * 64 elements read and 4096 * 64 written: over a thousand FLOPs
// per byte, far above both the float32 and the bf16 tensor-core balance
// points. The (S, T) score matrix never reaches device memory.
//
// Design, common to both kernels: one block owns one (batch*head, query tile) pair
// and loops over key tiles, keeping the running row max m, row sum l and
// the output accumulator in registers (the online-softmax recurrence), so
// nothing carries over between blocks. The grid is (BH, query tiles) and
// query tiles are issued last first, so every head's heaviest causal tiles
// start in the first wave. Under the causal mask a block stops at its
// diagonal key tile; the per-element mask runs only on a tile that crosses
// the diagonal or the ragged end of T. Ragged S and T are masked in the
// kernel; rows >= S are never stored. The scale is folded into exp2:
// p = exp2(s * scale * log2(e) - m * scale * log2(e)), with m the running
// max of the raw scores. A row whose keys are all masked outputs 0.
// Inputs are (bh, len, ld) with ld = hd rounded up to 16 bytes (zero past
// hd) and 16-byte aligned bases; the output is (bh, s, hd).
//
// bf16 (flash_bf16_kernel): tensor cores. 384 threads: two consumer
// warpgroups of 64 query rows each (BQ = 128) and one producer warpgroup
// whose one thread issues TMA loads. Q is loaded once per block; K and V
// tiles of BK keys (128 at hd <= 64, 64 at hd <= 128) fill a ring of 4
// stages, tracked by full/empty mbarriers, so the next tiles' loads
// overlap this tile's products. The tensor maps are (ld, len, BH) with
// 64-column boxes in the 128-byte swizzle (two boxes per row at hd > 64;
// TMA zero-fills columns past ld and rows past len). S = Q K^T is wgmma
// m64n{BK}k16 with both operands K-major in shared memory; P.V is wgmma
// m64n{HD}k16 with P from registers (the S accumulator's layout is the A
// operand's, so P never leaves registers) and V MN-major through the
// descriptor's transpose bit. Row max and row sum reduce across the 4
// threads that share an accumulator row. P enters P.V as two bf16 terms,
// hi = bf16(p) and lo = bf16(p - hi), so its relative error is ~2^-16
// instead of 2^-8: one rounding of P breaks the check against the f32
// plain version where outputs are near 0. That costs 6 hd instead of
// 4 hd FLOPs per pair. Q K^T is exact per product with f32 sums; the
// output is acc / l in f32, rounded once to bf16.
//
// f32 (flash_f32_kernel): IEEE float32 FMA on the CUDA cores (no TF32).
// 256 threads as 16 x 16; BQ = 128, BK = 64. A thread owns 8 query rows
// (ty + 16 i) x 4 keys (tx + 16 j) of the score tile and the same 8 rows x
// hd/16 columns (float4 at 4 tx + 64 e) of the accumulator. Q, K and V
// tiles are row-major in shared memory, rows padded by 4 floats so the
// float4 reads are conflict-free; Q.K^T reads 4 + 8 float4 per 128 FMAs and
// P.V reads P and V as float4. K and V have one buffer each, filled by
// cp.async (16 B a thread, zero-fill past T): V(kt) loads while S(kt) is
// computed and K(kt+1) while P.V(kt) runs.
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers --
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait of more
// than ~2^34 cycles (about 10 s) means a lost arrival: trap, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: box (c0, c1, c2) of `map` into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------- wgmma --
// Shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) [+]= A (64 x 16, shared, K-major) * B (16 x N, shared,
// K-major); `accumulate` = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x N, f32) += A (64 x 16 bf16, registers: the m16n8k16 A fragment
// of each warp's 16 rows) * B (16 x N, shared, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (BK == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// ------------------------------------------------------------------ bf16 --
namespace bf16k {

constexpr int BQ = 128;        // two consumer warpgroups of 64 rows
constexpr int THREADS = 384;   // + one producer warpgroup
constexpr int BOX = 64;        // columns per TMA box: 128 bytes, one swizzle row
constexpr int ROW = 128;       // bytes per box row

template <int HD>
struct Layout {
  // keys per tile: 64 at hd 128 keeps S, O and P in registers without spills
  static constexpr int BK = HD == 64 ? 128 : 64;
  static constexpr int STAGES = BK * HD == 128 * 128 ? 2 : 4;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int TILE_BYTES = BK * HD * 2;  // one K or one V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * TILE_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]; + 1 KB to align
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                  int s_len, int t_len, int hd, int causal, float scale_log2) {
  using L = Layout<HD>;
  constexpr int STAGES = L::STAGES;
  constexpr int BK = L::BK;
  constexpr int SUB = HD / BOX;  // boxes per row
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1 KB: tiles start 1 KB aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + L::Q_BYTES;
  const uint32_t sv = sk + STAGES * L::TILE_BYTES;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  int n_kt = (t_len + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, s_len) - 1) / BK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < SUB; ++c) tma_load_3d(sq + c * BQ * ROW, &tq, q_full, c * BOX, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        const int round = kt / STAGES;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const uint32_t kb = sk + s * L::TILE_BYTES, vb = sv + s * L::TILE_BYTES;
        mbar_expect_tx(k_full + 8 * s, L::TILE_BYTES);
        for (int c = 0; c < SUB; ++c)
          tma_load_3d(kb + c * BK * ROW, &tk, k_full + 8 * s, c * BOX, kt * BK, bh);
        mbar_expect_tx(v_full + 8 * s, L::TILE_BYTES);
        for (int c = 0; c < SUB; ++c)
          tma_load_3d(vb + c * BK * ROW, &tv, v_full + 8 * s, c * BOX, kt * BK, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * wg;
    // accumulator layout: this thread holds rows r and r + 8, columns
    // 8 j + cq + {0, 1} (element 4 j + 2 h + e is row r + 8 h, column 8 j + cq + e)
    const int r = row0 + 16 * warp + lane / 4;
    const int cq = 2 * (lane % 4);
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    const uint32_t qa = sq + 64 * wg * ROW;
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const uint32_t parity = (kt / STAGES) & 1;
      const int k0 = kt * BK;
      const uint32_t kb = sk + s * L::TILE_BYTES, vb = sv + s * L::TILE_BYTES;

      // S = Q K^T: hd / 16 steps of 16 columns; a step moves 32 bytes along
      // the swizzled row, or to the next box every 4 steps
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      mbar_wait(k_full + 8 * s, parity);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_qk<BK>(sc, sw128_desc(qa + (kk / 4) * BQ * ROW + col, 16, 1024),
                     sw128_desc(kb + (kk / 4) * BK * ROW + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      if (k0 + BK > t_len || (causal && k0 + BK - 1 > row0)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + 8 * j + cq + e;
              if (kpos >= t_len || (causal && kpos > r + 8 * h)) sc[4 * j + 2 * h + e] = -INFINITY;
            }
      }

      // online softmax on the two rows; P as hi + lo bf16 A fragments
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_use = mx == -INFINITY ? 0.f : mx;  // every key so far masked
        const float alpha = exp2f((m[h] - m_use) * scale_log2);  // 0 on the first keys
        const float shift = -m_use * scale_log2;
        m[h] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h + e];
            x = exp2f(fmaf(x, scale_log2, shift));  // masked: exp2(-inf) = 0
            sum += x;
          }
        l[h] = l[h] * alpha + sum;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[4 * j + 2 * h] *= alpha;
          acc[4 * j + 2 * h + 1] *= alpha;
        }
      }
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x0 = sc[8 * kk + 2 * i], x1 = sc[8 * kk + 2 * i + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi));
          p_hi[kk][i] = bf16x2_bits(hi);
          p_lo[kk][i] = bf16x2_bits(lo);
        }

      // O += P V: 16 keys a step, 16 rows (2 KB) down the V tile
      mbar_wait(v_full + 8 * s, parity);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = sw128_desc(vb + kk * 16 * ROW, BK * ROW, 1024);
        wgmma_pv<HD>(acc, p_hi[kk], dv);
        wgmma_pv<HD>(acc, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = r + 8 * h;
      if (row >= s_len) continue;
      __nv_bfloat16* out = o + (static_cast<size_t>(bh) * s_len + row) * hd;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + cq;
        if (col >= hd) continue;
        const float y0 = sum > 0.f ? acc[4 * j + 2 * h] / sum : 0.f;
        const float y1 = sum > 0.f ? acc[4 * j + 2 * h + 1] / sum : 0.f;
        if (col + 1 < hd && (hd & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(y0, y1);
        } else {
          out[col] = __float2bfloat16(y0);
          if (col + 1 < hd) out[col + 1] = __float2bfloat16(y1);
        }
      }
    }
  }
}

}  // namespace bf16k

// ------------------------------------------------------------------- f32 --
namespace f32k {

constexpr int BQ = 128;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PS = BK + 4;  // row stride of the P tile

template <int HD>
constexpr int smem_bytes() {
  return 4 * ((BQ + 2 * BK) * (HD + 4) + BQ * PS);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + n) of a (len, ld) matrix into an (n, LDS) tile; rows past
// len are zero-filled.
template <int LDS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int n, int len,
                                          int ld) {
  const int c4 = ld / 4;
  for (int idx = threadIdx.x; idx < n * c4; idx += THREADS) {
    const int rr = idx / c4, c = idx - rr * c4;
    const bool ok = r0 + rr < len;
    cp_async16(dst + rr * LDS + 4 * c, src + static_cast<size_t>(ok ? r0 + rr : 0) * ld + 4 * c,
               ok);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, HD == 64 ? 2 : 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int s_len, int t_len,
                 int hd, int ld, int causal, float scale_log2) {
  constexpr int LDS = HD + 4;  // row stride of the Q, K and V tiles
  constexpr int NV = HD / 64;  // accumulator float4 per row
  // unrolling twice spills at hd 64 under the 2-blocks-per-SM register cap
  constexpr int UNROLL = HD == 64 ? 1 : 2;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (BQ, LDS)
  float* ks = qs + BQ * LDS;                     // (BK, LDS)
  float* vs = ks + BK * LDS;                     // (BK, LDS)
  float* ps = vs + BK * LDS;                     // (BQ, PS)

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const float* qg = q + static_cast<size_t>(bh) * s_len * ld;
  const float* kg = k + static_cast<size_t>(bh) * t_len * ld;
  const float* vg = v + static_cast<size_t>(bh) * t_len * ld;

  // columns ld .. HD-1 of Q, K and V stay zero: cp.async never writes them
  if (ld < HD) {
    const int w = HD - ld;
    for (int idx = threadIdx.x; idx < (BQ + 2 * BK) * w; idx += THREADS)
      qs[(idx / w) * LDS + ld + idx % w] = 0.f;
  }
  load_tile<LDS>(qs, qg, q0, BQ, s_len, ld);
  load_tile<LDS>(ks, kg, 0, BK, t_len, ld);
  cp_async_commit();

  float acc[8][NV][4], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NV; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][e][u] = 0.f;
  }
  int n_kt = (t_len + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, s_len) - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();  // K(kt)
    __syncthreads();      // ... visible to all; every thread is done with V(kt-1) and P
    load_tile<LDS>(vs, vg, k0, BK, t_len, ld);
    cp_async_commit();

    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll UNROLL
    for (int d = 0; d < HD; d += 4) {
      float4 b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LDS + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LDS + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(a.x, b[j].x, sc[i][j]);
          sc[i][j] = fmaf(a.y, b[j].y, sc[i][j]);
          sc[i][j] = fmaf(a.z, b[j].z, sc[i][j]);
          sc[i][j] = fmaf(a.w, b[j].w, sc[i][j]);
        }
      }
    }

    const bool mask = k0 + BK > t_len || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (mask && (kpos >= t_len || (causal && kpos > qpos))) sc[i][j] = -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_use = mx == -INFINITY ? 0.f : mx;  // every key so far masked
      const float alpha = exp2f((m[i] - m_use) * scale_log2);
      const float shift = -m_use * scale_log2;
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(fmaf(sc[i][j], scale_log2, shift));
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < NV; ++e)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][e][u] *= alpha;
    }

    cp_async_wait_all();  // V(kt)
    __syncthreads();      // ... and P visible to all; every thread is done with K(kt)
    if (kt + 1 < n_kt) {
      load_tile<LDS>(ks, kg, k0 + BK, BK, t_len, ld);
      cp_async_commit();
    }
#pragma unroll UNROLL
    for (int c = 0; c < BK; c += 4) {
      float4 p4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p4[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          const float4 x = *reinterpret_cast<const float4*>(vs + (c + cc) * LDS + 4 * tx + 64 * e);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float p = lane_of(p4[i], cc);
            acc[i][e][0] = fmaf(p, x.x, acc[i][e][0]);
            acc[i][e][1] = fmaf(p, x.y, acc[i][e][1]);
            acc[i][e][2] = fmaf(p, x.z, acc[i][e][2]);
            acc[i][e][3] = fmaf(p, x.w, acc[i][e][3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = q0 + ty + 16 * i;
    if (row >= s_len) continue;
    float* out = o + (static_cast<size_t>(bh) * s_len + row) * hd;
#pragma unroll
    for (int e = 0; e < NV; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = 4 * tx + 64 * e + u;
        if (col < hd) out[col] = sum > 0.f ? acc[i][e][u] / sum : 0.f;
      }
  }
}

}  // namespace f32k

// ------------------------------------------------------------------ host --
// cuTensorMapEncodeTiled comes through the runtime's driver entry point, so
// the library links no libcuda and shares the other kernels' nvcc flags.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (ld, len, bh) bf16 tensor, boxes of 64 columns x box_rows rows, 128-byte
// swizzle; out-of-bounds elements read as zero.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int ld, int len, int bh, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(ld) * 2 * len};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(bf16k::BOX), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        __nv_bfloat16* o, int bh, int s_len, int t_len, int hd, int ld,
                        int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map(&tq, q, ld, s_len, bh, bf16k::BQ);
  constexpr int BK = bf16k::Layout<HD>::BK;
  if (err == cudaSuccess) err = tensor_map(&tk, k, ld, t_len, bh, BK);
  if (err == cudaSuccess) err = tensor_map(&tv, v, ld, t_len, bh, BK);
  if (err != cudaSuccess) return err;
  const int bytes = bf16k::Layout<HD>::BYTES;
  err = cudaFuncSetAttribute(bf16k::flash_bf16_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s_len + bf16k::BQ - 1) / bf16k::BQ);
  bf16k::flash_bf16_kernel<HD><<<grid, bf16k::THREADS, bytes, stream>>>(
      tq, tk, tv, o, s_len, t_len, hd, causal, scale * LOG2E);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* o, int bh,
                       int s_len, int t_len, int hd, int ld, int causal, float scale,
                       cudaStream_t stream) {
  const int bytes = f32k::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(f32k::flash_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s_len + f32k::BQ - 1) / f32k::BQ);
  f32k::flash_f32_kernel<HD><<<grid, f32k::THREADS, bytes, stream>>>(
      q, k, v, o, s_len, t_len, hd, ld, causal, scale * LOG2E);
  return cudaGetLastError();
}

// The checks both entry points share; ld is hd rounded up to 16 bytes.
bool valid(const void* q, const void* k, const void* v, const void* o, int bh, int s_len,
           int t_len, int hd) {
  const auto aligned = [](const void* p, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  return bh > 0 && s_len > 0 && t_len > 0 && hd > 0 && hd <= 128 && bh <= 65535 &&
         aligned(q, 16) && aligned(k, 16) && aligned(v, 16) && aligned(o, 4);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (bh, s, ld), k and v (bh, t, ld), o (bh, s, hd): float32, on the
// device. ld is hd rounded up to a multiple of 4 (16 bytes), the columns
// past hd zero; q, k and v 16-byte aligned. scale is hd^-1/2; causal is 0
// or 1.
int flash_attention_f32(const float* q, const float* k, const float* v, float* o, int bh,
                        int s_len, int t_len, int hd, int causal, float scale,
                        cudaStream_t stream) {
  if (!valid(q, k, v, o, bh, s_len, t_len, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = (hd + 3) / 4 * 4;
  const cudaError_t err =
      hd <= 64 ? launch_f32<64>(q, k, v, o, bh, s_len, t_len, hd, ld, causal, scale, stream)
               : launch_f32<128>(q, k, v, o, bh, s_len, t_len, hd, ld, causal, scale, stream);
  return static_cast<int>(err);
}

// The same with bfloat16 q, k, v and o, ld = hd rounded up to a multiple
// of 8; arithmetic as the header describes.
int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o, int bh, int s_len,
                         int t_len, int hd, int causal, float scale, cudaStream_t stream) {
  if (!valid(q, k, v, o, bh, s_len, t_len, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = (hd + 7) / 8 * 8;
  const cudaError_t err =
      hd <= 64 ? launch_bf16<64>(q, k, v, o, bh, s_len, t_len, hd, ld, causal, scale, stream)
               : launch_bf16<128>(q, k, v, o, bh, s_len, t_len, hd, ld, causal, scale, stream);
  return static_cast<int>(err);
}

}  // extern "C"
