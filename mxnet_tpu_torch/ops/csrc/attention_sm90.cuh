// The Hopper (sm_90a) tile loop shared by the two bf16 attention kernels:
// K1 (`flash_attention_fwd.cu`) and K2 (`flash_block_partials.cu`).
//
// One CTA of 256 threads takes 128 query rows of one (batch, head) pair, as
// two warpgroups of 64 rows each. Q is loaded once into shared memory; K and
// V tiles of 64 keys stream through a ring of Policy::kStages stages. All
// three are loaded by TMA (`cp.async.bulk.tensor`) from rank-4 tensor maps
// over the strided [B, L, H, D] views, so nothing is copied before the
// launch; rows past L are zero-filled by the hardware. Each stage's arrival
// is signalled on its mbarrier. Thread 0 issues Q and the first stages'
// tiles; after that the last of the CTA's 8 warps to finish reading a stage
// (a count in shared memory) issues the stage's next tile, so there is no
// producer warp. A policy may also give each warpgroup a buffer of its own
// (a Slot: K2's bias tile), filled by TMA from a fourth tensor map.
//
// Per key tile each warpgroup computes
//   S = Q K^T           wgmma m64n64k16, bf16 in, fp32 accumulator; Q and K
//                       from shared memory, both K-major;
//   policy scores       K1's causal mask, or K2's scale and additive bias;
//   online softmax      on the accumulator fragment: a thread holds parts of
//                       two rows; the row max reduces over the four lanes of
//                       a quad, m in fp32, l the thread's partial fp32 sum of
//                       p (reduced over the quad once, at the end);
//   O = O * alpha + P V wgmma m64nDk16 with A = P from registers (the fp32 S
//                       fragment packed to bf16x2 is already the A-operand
//                       layout) and B = V from shared memory, MN-major;
// the products of S_t and of P_{t-1} V_{t-1} are issued together, so the
// softmax of tile t runs while P V is on the tensor cores. At the end the
// policy's epilogue stores (o, m, l).
//
// Layouts in shared memory. A "slab" is 64 columns (D = 64 and 128, 128-byte
// rows, 128-byte swizzle) or 32 (D = 32, 64-byte rows, 64-byte swizzle); D =
// 128 is two slabs, one TMA box and one wgmma descriptor base each. Every
// slab starts on a 1024-byte boundary, so the descriptors' base offset is 0.
// K-major descriptors (Q, K): SBO = 8 rows x the row bytes, LBO unused; a
// k-step of 16 columns adds 32 bytes to the start address inside the
// swizzled row. MN-major descriptors (V): SBO = 8 rows x the row bytes (the
// stride between 8-key groups), and N = one slab, so LBO is unused; D = 128
// issues one m64n64 product per slab. A k-step of 16 keys adds 16 rows.
//
// Occupancy. With D <= 64 two CTAs share an SM: at most 128 registers a
// thread (each of the SM's four sub-partitions holds 16,384 registers for
// its four warps) and at most 113 KB of shared memory each (K1 at D = 64:
// 81 KB; K2, with its bias tiles and a 3-deep ring: 97 KB). A CTA of 9
// warps (a separate producer warp) would put three warps on one
// sub-partition and allow two CTAs only at 96 registers, which spills.
//
// Policy (a struct of static members; see the two .cu files):
//   kStages, kExtraBytes       the K/V ring's depth; each Slot's bytes;
//   q_tile(y, ny)              the query tile of grid row y;
//   kv_tiles(p, q0, rows)      how many 64-key tiles rows q0 .. q0+rows-1
//                              read (the CTA's count with rows = 128);
//   exp_scale(p), kFusedExp    p = 2^((s - m) * c), or 2^(s*c - m*c) by one
//                              FFMA where that is exact enough;
//   make_extra_map(map, p)     the Slot's tensor map, on the host;
//   load(p, slot, t)           start the Slot's load for key tile t;
//   scores(p, slot, s, row0, t, c0)  turn the raw fragment into scores;
//   epilogue(p, o, m, l, ...)  store the results.
// Warp specialisation with register reallocation, ping-pong between the two
// warpgroups and persistent CTAs are left for later.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace sm90 {

constexpr int kBlockM = 128;            // query rows per CTA
constexpr int kBlockN = 64;             // keys per K/V tile
constexpr int kThreads = 256;           // two warpgroups
constexpr int kConsumerWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
// An error of cuTensorMapEncodeTiled (or its absence) is returned to the
// wrapper as kTensorMapError + its CUresult, apart from the CUDA errors.
constexpr int kTensorMapError = 100000;

// A warpgroup's own shared-memory buffer for a policy's extra tile (K2's
// bias), filled by TMA and signalled on `full`, released by the
// warpgroup's 128 threads on `empty`.
struct Slot {
  uint32_t smem, full, empty;
  const CUtensorMap* map;
  int row0;     // the warpgroup's first query row
  int n_tiles;  // its key tiles
  bool leader;  // thread 0 of the warpgroup, which issues the loads
};

// Everything the two policies read. K1 uses causal; K2 bias, m and l.
struct Params {
  int H, Lq, Lk;
  float scale;
  __nv_bfloat16* o;
  long long so_b, so_l, so_h;  // element strides of o
  int causal;
  const float* bias;           // row-major (Lq, Lk) fp32, or null
  long long bias_pitch;        // elements from one bias row to the next
  float* m;                    // [B, H, Lq] fp32
  float* l;
};

template <int D>
struct Geometry {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int kSlabCols = D < 64 ? D : 64;
  static constexpr int kSlabs = D / kSlabCols;
  static constexpr int kRowBytes = kSlabCols * 2;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kQSlabBytes = kBlockM * kRowBytes;
  static constexpr int kKVSlabBytes = kBlockN * kRowBytes;
  static constexpr int kQBytes = kQSlabBytes * kSlabs;
  static constexpr int kKVBytes = kKVSlabBytes * kSlabs;  // K or V, one tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  // Registers a thread: 128 lets two CTAs share an SM (see the top);
  // D = 128 runs one CTA an SM.
  static constexpr int kMaxRegs = D <= 64 ? 128 : 255;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// some seconds (a load that never lands, a protocol fault) traps, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 33)) __trap();
}

// One TMA box of a rank-4 map, coordinates innermost first (d, h, l, b).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of an accumulator above the wait that
// completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor with a swizzled layout: start address,
// LBO = 1 (unused by these layouts), SBO, layout type; base offset 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: A and B from shared memory,
// both K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A from registers (the bf16
// fragment of mma.m16n8k16 for each warp's 16 rows), B from shared memory,
// MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float* d, const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32]: A from registers (the bf16
// fragment of mma.m16n8k16 for each warp's 16 rows), B from shared memory,
// MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_m64n32_tb(float* d, const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t (&a)[4],
                                         uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float* d, const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  wgmma_rs_m64n64_tb(d, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_pv<32>(float* d, const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  wgmma_rs_m64n32_tb(d, a, desc_b);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int D, class Policy>
__global__ void __maxnreg__(Geometry<D>::kMaxRegs)
attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_x,
                      const Params p) {
  using G = Geometry<D>;
  constexpr int kStages = Policy::kStages;
  extern __shared__ uint8_t smem_raw[];
  // the stages' barriers, Q's, and each warpgroup's full and empty
  __shared__ __align__(8) uint64_t bars[kStages + 5];
  __shared__ int released[kStages];  // warps done with a stage, ever

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  const uint32_t kv_smem = base + G::kQBytes;  // stage s: K slabs, V slabs
  const uint32_t x_smem = kv_smem + kStages * G::kStageBytes;  // + wg
  const uint32_t full_bar = smem_u32(&bars[0]);  // + 8 * stage
  const uint32_t q_bar = smem_u32(&bars[kStages]);
  const uint32_t x_bar = smem_u32(&bars[kStages + 1]);  // + 16 wg (+ 8)

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = Policy::q_tile(blockIdx.y, gridDim.y) * kBlockM;
  const int n_tiles = Policy::kv_tiles(p, q0, kBlockM);
  const int tid = threadIdx.x;

  // K and V of tile t into its stage, signalled on the stage's barrier
  auto load_tile = [&](int t) {
    const int st = t % kStages;
    const uint32_t k_dst = kv_smem + st * G::kStageBytes;
    const uint32_t v_dst = k_dst + G::kKVBytes;
    mbar_expect_tx(full_bar + 8 * st, G::kStageBytes);
#pragma unroll
    for (int sl = 0; sl < G::kSlabs; ++sl) {
      tma_load(k_dst + sl * G::kKVSlabBytes, &tm_k, full_bar + 8 * st,
               sl * G::kSlabCols, h, t * kBlockN, b);
      tma_load(v_dst + sl * G::kKVSlabBytes, &tm_v, full_bar + 8 * st,
               sl * G::kSlabCols, h, t * kBlockN, b);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      released[st] = 0;
    }
    mbar_init(q_bar, 1);
    for (int w = 0; w < 2; ++w) {
      mbar_init(x_bar + 16 * w, 1);
      mbar_init(x_bar + 16 * w + 8, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, G::kQBytes);
#pragma unroll
    for (int sl = 0; sl < G::kSlabs; ++sl)
      tma_load(q_smem + sl * G::kQSlabBytes, &tm_q, q_bar, sl * G::kSlabCols,
               h, q0, b);
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_tile(t);
  }

  // The consumers. Thread (warpgroup wg, warp w, lane) holds rows row0 and
  // row0 + 8 of the tile and, in each 8-column group j of a fragment,
  // columns 8j + c0 and 8j + c0 + 1: fragment element 4j + 2i + c is
  // (row0 + 8i, 8j + c0 + c).
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int my_tiles = Policy::kv_tiles(p, q0 + 64 * wg, 64);
  const uint32_t q_wg = q_smem + 64 * wg * G::kRowBytes;
  const float c = Policy::exp_scale(p);  // p = 2^((s - m) * c)

  float o[D / 2];
  float s[kBlockN / 2];
  uint32_t pa[kBlockN / 16][4];  // P in bf16, the A operand of P V
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};
  const Slot slot{x_smem + wg * Policy::kExtraBytes, x_bar + 16 * wg,
                  x_bar + 16 * wg + 8, &tm_x, q0 + 64 * wg, my_tiles,
                  tid % 128 == 0};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;

  auto k_tile = [&](int t) { return kv_smem + (t % kStages) * G::kStageBytes; };

  // This warp's products have read tile t: the last of the CTA's 8 warps
  // to say so refills the stage with tile t + kStages.
  auto release = [&](int t) {
    if (lane == 0 && t + kStages < n_tiles &&
        atomicAdd(&released[t % kStages], 1) % kConsumerWarps ==
            kConsumerWarps - 1)
      load_tile(t + kStages);
  };

  // S = Q K^T over D in k-steps of 16 columns
  auto issue_s = [&](int t) {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const int sl = kd * 16 / G::kSlabCols;
      const int off = (kd * 16 % G::kSlabCols) * 2;
      wgmma_ss_m64n64(
          s,
          smem_desc(q_wg + sl * G::kQSlabBytes + off, 8 * G::kRowBytes,
                    G::kLayout),
          smem_desc(k_tile(t) + sl * G::kKVSlabBytes + off, 8 * G::kRowBytes,
                    G::kLayout),
          kd > 0);
    }
    wgmma_commit();
  };

  // O += P V, P from pa
  auto issue_pv = [&](int t) {
    const uint32_t v_tile = k_tile(t) + G::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int sl = 0; sl < G::kSlabs; ++sl)
        wgmma_pv<G::kSlabCols>(
            o + sl * (G::kSlabCols / 2), pa[kk],
            smem_desc(v_tile + sl * G::kKVSlabBytes + kk * 16 * G::kRowBytes,
                      8 * G::kRowBytes, G::kLayout));
    wgmma_commit();
  };

  // The online-softmax update of the scores in s, which become p. Returns
  // the rescale of the rows' earlier sums in alpha.
  auto softmax = [&](float (&alpha)[2]) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // (m - m_new) before the scale: exactly 0 when equal, even at -1e30
      alpha[i] = ex2((m[i] - mx[i]) * c);
      m[i] = mx[i];
      l[i] *= alpha[i];
      mc[i] = m[i] * c;
    }
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        float& x = s[4 * j + e];
        x = Policy::kFusedExp ? ex2(fmaf(x, c, -mc[i])) : ex2((x - m[i]) * c);
        l[i] += x;
      }
  };

  // P in bf16 as the A operand: k-step kk covers fragment groups 2kk and
  // 2kk + 1, elements 8kk .. 8kk + 7, in the order a0..a3 wants them
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };

  Policy::load(p, slot, 0);
  mbar_wait(q_bar, 0);

  // Tile 0 alone; then for each tile t the products S_t = Q K_t^T and
  // O += P_{t-1} V_{t-1} are issued together, the softmax of tile t runs
  // while P V is on the tensor cores, and O is rescaled once P V is done.
  float alpha[2];
  mbar_wait(full_bar, 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(s);
  Policy::scores(p, slot, s, row0, 0, c0);
  softmax(alpha);
  pack_p();

  for (int t = 1; t < my_tiles; ++t) {
    mbar_wait(full_bar + 8 * (t % kStages), (t / kStages) & 1);
    wgmma_fence();
    issue_s(t);
    issue_pv(t - 1);
    wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
    fence_regs(s);
    Policy::scores(p, slot, s, row0, t, c0);
    softmax(alpha);
    wgmma_wait<0>();
    fence_regs(o);
    release(t - 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    pack_p();
  }
  wgmma_fence();
  issue_pv(my_tiles - 1);
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  Policy::template epilogue<D>(p, o, m, l, b, h, row0, c0, lane % 4 == 0);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A rank-4 map (d, h, l, b) over a strided [B, L, H, D] bf16 view with
// element strides st = {b, l, h}, boxes of one slab of `rows` rows.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int B, int L, int H,
             const long long* st, int rows) {
  using G = Geometry<D>;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::kSlabCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// Launch over q [B, Lq, H, D], k and v [B, Lk, H, D] (bf16, element strides
// st[0..8] = the (B, L, H) strides of q, k and v). Returns 0, a CUDA error,
// or kTensorMapError + a CUresult.
// A rank-2 map over a row-major (rows, cols) fp32 array whose rows are
// `pitch` elements apart, boxes of 32 columns (128 bytes, 128-byte swizzle)
// by `box_rows` rows.
inline int make_map_f32(CUtensorMap* map, const void* ptr, int rows,
                        int cols, long long pitch, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

template <int D, class Policy>
constexpr int smem_bytes() {
  using G = Geometry<D>;
  return G::kQBytes + Policy::kStages * G::kStageBytes +
         2 * Policy::kExtraBytes + 1024;  // + alignment to 1024 bytes
}

template <int D, class Policy>
int launch(const void* q, const void* k, const void* v, int B, int Lq,
           int Lk, const long long* st, const Params& p,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tx{};
  int err = make_map<D>(&tq, q, B, Lq, p.H, st, kBlockM);
  if (err == 0) err = make_map<D>(&tk, k, B, Lk, p.H, st + 3, kBlockN);
  if (err == 0) err = make_map<D>(&tv, v, B, Lk, p.H, st + 6, kBlockN);
  if (err == 0) err = Policy::make_extra_map(&tx, p);
  if (err != 0) return err;
  constexpr int kSmem = smem_bytes<D, Policy>();
  auto kernel = attention_sm90_kernel<D, Policy>;
  // the shared-memory limit, raised once per instantiation and device
  static unsigned long long raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !(raised >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return e;
    if (dev < 64) raised |= 1ull << dev;
  }
  const dim3 grid(B * p.H, (Lq + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, kSmem, stream>>>(tq, tk, tv, tx, p);
  return cudaGetLastError();
}

template <class Policy>
int dispatch(const void* q, const void* k, const void* v, int B, int Lq,
             int Lk, int D, const long long* st, const Params& p,
             cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, Policy>(q, k, v, B, Lq, Lk, st, p, stream);
    case 64: return launch<64, Policy>(q, k, v, B, Lq, Lk, st, p, stream);
    case 128: return launch<128, Policy>(q, k, v, B, Lq, Lk, st, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The message of a code that `launch` returned.
inline const char* error_string(int err) {
  static thread_local char buf[96];
  if (err >= kTensorMapError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - kTensorMapError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace sm90
