// One ring hop of partial attention for Hopper (sm_90a), plain fp32 FMAs.
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
// Design. K1's tile loop (`flash_attention_fwd.cu`): one block of 256
// threads takes one (batch*head, 64-row query tile); the 16x16 threads each
// own a 4x4 patch of the 64x64 score tile and 4 rows x D/16 columns of the
// accumulator, so a thread's running max and sum-exp stay in registers; K/V
// tiles of 64 keys are staged through shared memory in fp32. What differs
// from K1:
//  - every key tile is computed. The bias is data: a row whose bias is -1e30
//    everywhere (a hop whose K/V block lies wholly in the query's future)
//    must give m = -1e30, p = exp(0) = 1, l = Lk and o = sum of V, as the
//    reference does, so that the ring's combine drops it with the weight
//    exp(-1e30 - m) = 0. Nothing is skipped;
//  - keys past Lk are excluded outright (p = 0, no part in the max), not
//    masked with -1e30, which would give them weight 1 in such a row;
//  - the output is the unnormalized accumulator, with m and l beside it.
//
// Bound at the slice shape (one hop: B=8, Lq=Lk=512, H=8, D=64, bf16, with a
// bias): bytes  Q, K, V and O once (16.8 MB), the bias (1.05 MB), m and l
// (0.26 MB): 18.1 MB -> 5.4 us at 3.35 TB/s; operations 4*D FLOP for each of
// the B*H*Lq*Lk pairs (every tile is computed): 4.29e9 -> 4.3 us at 989
// TFLOP/s. So the function is bound by bytes. Like K1, this first kernel
// runs on the fp32 FMA pipes, limited by shared-memory loads, far above that
// bound; tensor cores (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>

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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias: a row-major (Lq, Lk) fp32 array or
// null. m, l: [B, H, Lq] fp32, contiguous. strides: 12 element strides, the
// (B, L, H) strides of q, k, v and o in that order. Returns the CUDA error of
// the launch (0 when it was accepted); the wrapper raises on any other.
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
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, bf, o, mf, lf, B, H, Lq, Lk, D, strides, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
