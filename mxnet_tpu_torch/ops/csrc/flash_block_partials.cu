// One ring hop of partial attention for Hopper (sm_90a): bf16 on the tensor
// cores, fp32 on the FMA pipes.
//
// Replaces the TPU kernel `_partial_kernel` of
// mxnet_tpu/ops/pallas_attention.py (launched by `flash_block_partials`
// through `pl.pallas_call`). It computes the same function, the contract of
// the ring's `_block_attn`, for one query block against one K/V block:
//   s = (Q K^T) * scale + bias            fp32 scores, bias[q, k] additive
//   m = max_k s                           row max, fp32, from -1e30
//   l = sum_k exp(s - m)                  row sum-exp, fp32
//   o = sum_k exp(s - m) V                UNNORMALIZED, written in Q's type
// with the online-softmax rescale over key tiles, all in fp32.
//
// Layout. Q, K, V and O are [B, L, H, D] tensors read and written through
// the element strides the wrapper passes for the B, L and H axes; the D axis
// must be contiguous. The ring's shards are views of the transformer's fused
// QKV projection, so nothing is copied before the launch. m and l are
// [B, H, Lq] fp32, contiguous. The bias is one row-major (Lq, Lk) fp32 array
// shared by every batch row and head, read as bias[q, k] in place; a null
// pointer means zero bias.
//
// What differs from K1 (both kernels, both dtypes):
//  - every key tile is computed. The bias is data: a row whose bias is -1e30
//    everywhere (a hop whose K/V block lies wholly in the query's future)
//    must give m = -1e30, p = exp(0) = 1, l = Lk and o = sum of V, as the
//    reference does, so that the ring's combine drops it with the weight
//    exp(-1e30 - m) = 0. Nothing is skipped;
//  - keys past Lk are excluded outright (p = 0, no part in the max), not
//    masked with -1e30, which would give them weight 1 in such a row;
//  - the output is the unnormalized accumulator, with m and l beside it.
//
// bf16: the tile loop of `attention_sm90.cuh` (TMA K/V ring, wgmma for Q K^T
// and P V, online softmax on the accumulator fragment) with
// FlashBlockPartialsPolicy below. The fp32 bias reaches the score fragment
// through shared memory: each warpgroup's 64 rows x 64 keys of it (16 KB) are
// loaded by TMA from a 2-D map with the 128-byte swizzle, so the fragment's
// float2 reads are free of bank conflicts, and the buffer is refilled with
// the next tile's as soon as its scores are read, so the load lands during
// the softmax and the next products. (Read into registers from L2 just
// before its use instead, its latency was exposed and its 32 registers
// spilled: the hop took 45 % longer on an H100.) Keys past Lk get -inf, and
// the epilogue stores o in bf16 and m, l in fp32. TMA needs 16-byte aligned
// bases and (B, L, H) strides, and bias rows a multiple of 16 bytes apart;
// the wrappers raise on other q, k, v and pad the bias rows.
//
// fp32: the first port's FMA kernel, unchanged: K1's fp32 tile loop, one
// block of 256 threads per (batch*head, 64-row query tile), K/V tiles of 64
// keys staged through shared memory. It keeps full fp32 products for the
// small fp32 checks (TF32 keeps about three digits).
//
// Bound at the slice shape (one hop: B=8, Lq=Lk=512, H=8, D=64, bf16, with a
// bias): bytes  Q, K, V and O once (16.8 MB), the bias (1.05 MB), m and l
// (0.26 MB): 18.1 MB -> 5.4 us at 3.35 TB/s; operations 4*D FLOP for each of
// the B*H*Lq*Lk pairs (every tile is computed): 4.29e9 -> 4.3 us at 989
// TFLOP/s. So the function is bound by bytes. What keeps the tensor-core
// kernel from it: the bias is read 64 times over (once per batch row and
// head) through L2, 64 MB against the bound's 1 MB; the 256 CTAs of 8 key
// tiles each fill the card's 264 CTA slots once, so the prologue (Q and the
// first tiles) and the epilogue are not overlapped by other CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>

#include "attention_sm90.cuh"

namespace {

constexpr int kBlockQ = 64;                 // query rows per thread block
constexpr int kBlockK = 64;                 // keys per K/V tile
constexpr int kTX = 16;                     // threads along keys / head dim
constexpr int kTY = 16;                     // threads along query rows
constexpr int kRowsPerThread = kBlockQ / kTY;   // 4
constexpr int kKeysPerThread = kBlockK / kTX;   // 4
constexpr int kThreads = kTX * kTY;         // 256
constexpr int kPStride = kBlockK + 1;       // padded row of the P tile
constexpr float kNegInf = -1e30f;           // the Pallas kernel's _NEG_INF

struct Strides {
  long long b, l, h;  // element strides of the B, L and H axes
};

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <int D>
constexpr size_t smem_bytes() {
  // Q and K rows padded by one float so the 16 threads of a row group read
  // 16 different banks; V rows are read along D and need no pad.
  return sizeof(float) *
         (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
          kBlockQ * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_block_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ bias,
                            T* __restrict__ o, float* __restrict__ m_out,
                            float* __restrict__ l_out, int H, int Lq, int Lk,
                            Strides sq, Strides sk, Strides sv, Strides so,
                            float scale) {
  static_assert(D % kTX == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int kColsPerThread = D / kTX;

  extern __shared__ float smem[];
  float* qs = smem;                   // [kBlockQ][DP]
  float* ks = qs + kBlockQ * DP;      // [kBlockK][DP]
  float* vs = ks + kBlockK * DP;      // [kBlockK][D]
  float* ps = vs + kBlockK * D;       // [kBlockQ][kPStride]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    qs[r * DP + c] = qi < Lq ? to_float(qb[qi * sq.l + c]) : 0.f;
  }

  float acc[kRowsPerThread][kColsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (Lk + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int ki = k0 + r;
      const bool in = ki < Lk;
      ks[r * DP + c] = in ? to_float(kb[ki * sk.l + c]) : 0.f;
      vs[r * D + c] = in ? to_float(vb[ki * sv.l + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 rows x 4 keys (keys tx + 16 j).
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = qs[(ty * kRowsPerThread + i) * DP + d];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kv[j] = ks[(tx + j * kTX) * DP + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Scale, add the bias, and the running-softmax update of each row.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = ty * kRowsPerThread + i;
      const int qi = q0 + row;
      const float* brow =
          bias != nullptr && qi < Lq ? bias + (long long)qi * Lk : nullptr;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int ki = k0 + tx + j * kTX;
        // scaled, then biased, each rounded once, as the reference does
        float sc = __fmul_rn(s[i][j], scale);
        if (brow != nullptr && ki < Lk) sc = __fadd_rn(sc, brow[ki]);
        // a key past Lk takes no part: -inf leaves the max alone, and its
        // p is set to 0 below
        s[i][j] = ki < Lk ? sc : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = kTX / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int ki = k0 + tx + j * kTX;
        const float p = ki < Lk ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[row * kPStride + tx + j * kTX] = p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V for this thread's 4 rows x D/16 columns (tx + 16 c).
#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRowsPerThread], vv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = ps[(ty * kRowsPerThread + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) vv[c] = vs[kk * D + tx + c * kTX];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + b * so.b + h * so.h;
  const long long stat0 = (long long)bh * Lq;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qi = q0 + ty * kRowsPerThread + i;
    if (qi >= Lq) continue;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c)
      ob[qi * so.l + tx + c * kTX] = from_float<T>(acc[i][c]);
    if (tx == 0) {
      m_out[stat0 + qi] = m[i];
      l_out[stat0 + qi] = l[i];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* o, float* m, float* l, int B,
                   int H, int Lq, int Lk, const long long* st, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_block_partials_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), m, l, H, Lq, Lk,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const float* bias, void* o, float* m, float* l, int B,
                       int H, int Lq, int Lk, int D, const long long* st,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, bias, o, m, l, B, H, Lq, Lk, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, bias, o, m, l, B, H, Lq, Lk, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, bias, o, m, l, B, H, Lq, Lk, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 tensor-core kernel's policy: the additive bias, every key tile,
// and the partials epilogue.
struct FlashBlockPartialsPolicy {
  static constexpr int kN = sm90::kBlockN;

  static __device__ __forceinline__ int q_tile(int y, int) { return y; }

  static __device__ __forceinline__ int kv_tiles(const sm90::Params& p, int,
                                                 int) {
    return (p.Lk + kN - 1) / kN;
  }

  // Scores in natural units, p = 2^((s - m) * log2(e)): s - m is exactly 0
  // where a fully masked row's s equals its m = -1e30.
  static constexpr bool kFusedExp = false;
  static __device__ __forceinline__ float exp_scale(const sm90::Params&) {
    return sm90::kLog2e;
  }

  // The K/V ring is 3 deep, to leave room for each warpgroup's bias tile
  // (64 rows x 64 keys fp32, 16 KB) with two CTAs an SM at D = 64.
  static constexpr int kStages = 3;
  static constexpr int kExtraBytes = 64 * kN * 4;

  static int make_extra_map(CUtensorMap* map, const sm90::Params& p) {
    if (p.bias == nullptr) return 0;
    return sm90::make_map_f32(map, p.bias, p.Lq, p.Lk, p.bias_pitch, 64);
  }

  // The leader of a warpgroup loads its rows' bias for key tile t: two
  // boxes of 32 keys, each 64 rows of 128 bytes with the 128-byte swizzle.
  static __device__ __forceinline__ void load(const sm90::Params& p,
                                              const sm90::Slot& x, int t) {
    if (p.bias == nullptr || !x.leader || t >= x.n_tiles) return;
    sm90::mbar_expect_tx(x.full, kExtraBytes);
#pragma unroll
    for (int box = 0; box < 2; ++box)
      sm90::tma_load_2d(x.smem + box * (kExtraBytes / 2), x.map, x.full,
                        t * kN + 32 * box, x.row0);
  }

  static __device__ __forceinline__ void scores(const sm90::Params& p,
                                                const sm90::Slot& x,
                                                float (&s)[kN / 2], int row0,
                                                int t, int c0) {
    const int k0 = t * kN;
    const bool biased = p.bias != nullptr;
    // this thread's float2 of a bias row: row r (local, r % 8 = lane / 4 =
    // (row0 - x.row0) % 8) holds the 16-byte chunk c of a box at c ^ (r % 8)
    const int r0 = row0 - x.row0;
    const int lane_row = r0 % 8;
    if (biased) sm90::mbar_wait(x.full, t & 1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int key = k0 + 8 * j + c0;  // even; the pair is key, key + 1
        float2 b = make_float2(0.f, 0.f);
        if (biased) {
          const int chunk = 2 * (j % 4) + c0 / 4;
          b = sm90::ld_shared_f2(x.smem + (j / 4) * (kExtraBytes / 2) +
                                 (r0 + 8 * i) * 128 +
                                 ((chunk ^ lane_row) * 16) + (c0 % 4) * 4);
        }
        // scaled, then biased, each rounded once, as the reference does; a
        // key past Lk takes no part: -inf leaves the max alone and gives p 0
        float& s0 = s[4 * j + 2 * i];
        float& s1 = s[4 * j + 2 * i + 1];
        s0 = key < p.Lk ? __fadd_rn(__fmul_rn(s0, p.scale), b.x)
                        : -CUDART_INF_F;
        s1 = key + 1 < p.Lk ? __fadd_rn(__fmul_rn(s1, p.scale), b.y)
                            : -CUDART_INF_F;
      }
    if (biased) {
      // the warpgroup is done with this tile's bias: its leader refills the
      // buffer with the next tile's, which lands during the softmax and the
      // next products
      sm90::mbar_arrive(x.empty);
      if (x.leader && t + 1 < x.n_tiles) {
        sm90::mbar_wait(x.empty, t & 1);
        load(p, x, t + 1);
      }
    }
  }

  template <int D>
  static __device__ __forceinline__ void epilogue(
      const sm90::Params& p, const float (&o)[D / 2], const float (&m)[2],
      const float (&l)[2], int b, int h, int row0, int c0, bool leader) {
    const long long stat0 = (long long)(b * p.H + h) * p.Lq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= p.Lq) continue;
      __nv_bfloat16* dst = p.o + b * p.so_b + row * p.so_l + h * p.so_h + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      if (leader) {
        p.m[stat0 + row] = m[i];
        p.l[stat0 + row] = l[i];
      }
    }
  }
};

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// kernel). bias: a row-major (Lq, Lk) fp32 array or null, its rows
// strides[12] elements apart (Lk for the FMA kernel; a multiple of 4, its
// base 16-byte aligned, for the tensor-core kernel's TMA). m, l: [B, H, Lq]
// fp32, contiguous. strides: 13 element strides, the (B, L, H) strides of
// q, k, v and o in that order, then the bias's row pitch. Returns 0 when the launch was accepted, else a
// CUDA error or a tensor-map error; `mxtt_cuda_error_string` names either.
extern "C" int mxtt_flash_block_partials(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         void* o, void* m, void* l, int dtype,
                                         int B, int H, int Lq, int Lk, int D,
                                         const long long* strides, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, bf, o, mf, lf, B, H, Lq, Lk, D, strides, scale, s);
  if (dtype == 1) {
    sm90::Params p{};
    p.H = H;
    p.Lq = Lq;
    p.Lk = Lk;
    p.scale = scale;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.so_b = strides[9];
    p.so_l = strides[10];
    p.so_h = strides[11];
    p.bias = bf;
    p.bias_pitch = strides[12];
    p.m = mf;
    p.l = lf;
    return sm90::dispatch<FlashBlockPartialsPolicy>(q, k, v, B, Lq, Lk, D, strides, p, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return sm90::error_string(err);
}
