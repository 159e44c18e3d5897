// Flash-attention forward for Hopper (sm_90a), plain fp32 FMAs.
//
// Replaces the TPU kernel `_fwd_kernel` of mxnet_tpu/ops/pallas_attention.py
// (launched by `_pallas_forward` through `pl.pallas_call`). It computes the
// same function: out = softmax(Q K^T * scale [+ causal mask -1e30]) V, with
// the running row max, the running sum-exp and the accumulator in fp32, and
// out = acc / max(l, 1e-30) written in the input type (fp32 or bf16).
//
// Layout. Q, K, V and O are [B, L, H, D] tensors read and written in place
// through the element strides the wrapper passes for the B, L and H axes;
// the D axis must be contiguous. The transformer's q, k and v are strided
// views of one [B, L, 3*d_model] projection, so nothing is copied or
// transposed before the launch.
//
// Design. One thread block of 256 threads takes one (batch*head, 64-row
// query tile). The 16x16 threads each own a 4x4 patch of the 64x64 score
// tile and 4 rows x D/16 columns of the output accumulator, so a thread's
// score rows and output rows are the same rows and its running max and
// sum-exp stay in registers. K/V tiles of 64 keys are staged through shared
// memory, converted to fp32 on load; the loop over them replaces the Pallas
// `fori_loop`. Row maxima and sums are reduced across the 16 threads of a
// row with warp shuffles. Under the causal mask the loop stops after the
// diagonal tile: every key past it has a score of -1e30, whose exp(-1e30-m)
// is exactly 0, so the result is the same function. Keys and query rows past
// the end of L are masked inside the kernel, so any L works. Query tiles are
// launched in reverse order so the longest causal rows start first.
//
// Bound at the slice shape (B=8, L=2048, H=8, D=64, bf16, causal):
//   operations  two products (QK^T and PV) of 2*D FLOP for each of the
//               L*(L+1)/2 unmasked (query, key) pairs of each of B*H heads:
//               2 * 2*64 * 64 * 2048*2049/2 = 3.44e10 FLOP
//               -> 34.8 us at 989 TFLOP/s (the bf16 peak);
//   bytes       Q, K, V read once and O written once:
//               4 * 8*2048*8*64 * 2 B = 67.1 MB -> 20.0 us at 3.35 TB/s;
// so the function is bound by operations. This first kernel does not use
// the tensor cores (no mma.sync / wgmma, no TMA); its arithmetic runs on the
// fp32 FMA pipes and its inner loops are limited by shared-memory loads.
// Making it fast (wgmma on bf16 tiles, a TMA ring) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;                 // query rows per thread block
constexpr int kBlockK = 64;                 // keys per K/V tile
constexpr int kTX = 16;                     // threads along keys / head dim
constexpr int kTY = 16;                     // threads along query rows
constexpr int kRowsPerThread = kBlockQ / kTY;   // 4
constexpr int kKeysPerThread = kBlockK / kTX;   // 4
constexpr int kThreads = kTX * kTY;         // 256
constexpr int kPStride = kBlockK + 1;       // padded row of the P tile
constexpr float kNegInf = -1e30f;           // the Pallas kernel's mask value

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
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H,
                           int Lq, int Lk, Strides sq, Strides sk, Strides sv,
                           Strides so, float scale, int causal) {
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
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = q_tile * kBlockQ;

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

  // Under the causal mask no row of this tile sees a key past its last row.
  const int k_end = causal ? min(Lk, q0 + kBlockQ) : Lk;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

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

    // Scale, mask, and the running-softmax update of each row.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = ty * kRowsPerThread + i;
      const int qi = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int ki = k0 + tx + j * kTX;
        const bool keep = ki < Lk && (!causal || ki <= qi);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
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
        const float p = expf(s[i][j] - m_new);
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
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qi = q0 + ty * kRowsPerThread + i;
    if (qi >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c)
      ob[qi * so.l + tx + c * kTX] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int Lq, int Lk, const long long* st, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Lq, Lk,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Lq, int Lk, int D,
                       const long long* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Lq, Lk, st, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Lq, Lk, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Lq, Lk, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, the
// (B, L, H) strides of q, k, v and o in that order. Returns the CUDA error
// of the launch (0 when it was accepted); the wrapper raises on any other.
extern "C" int mxtt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, int dtype,
                                        int B, int H, int Lq, int Lk, int D,
                                        const long long* strides, float scale,
                                        int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, H, Lq, Lk, D, strides, scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, Lq, Lk, D, strides, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
