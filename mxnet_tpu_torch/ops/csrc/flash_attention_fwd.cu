// Flash-attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// fp32 on the FMA pipes.
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
// bf16: the tile loop of `attention_sm90.cuh` (TMA K/V ring, wgmma for Q K^T
// and P V, online softmax on the accumulator fragment) with
// FlashAttentionFwdPolicy below: a CTA of 128 query rows reads key tiles up
// to its last row only and
// each warpgroup stops after its own diagonal tile, whose keys past a row are
// masked to -1e30 element by element (every key past the diagonal has a
// score of -1e30, whose exp(-1e30 - m) is exactly 0, so skipping them is the
// same function); keys past Lk are masked too, so any L works; the query
// tiles are launched longest first; the epilogue divides by max(l, 1e-30)
// and stores bf16. TMA needs 16-byte aligned bases and (B, L, H) strides;
// the wrapper raises on other inputs.
//
// fp32: the first port's kernel, unchanged: one block of 256 threads takes
// one (batch*head, 64-row query tile). The 16x16 threads each own a 4x4
// patch of the 64x64 score tile and 4 rows x D/16 columns of the output
// accumulator, so a thread's score rows and output rows are the same rows and
// its running max and sum-exp stay in registers. K/V tiles of 64 keys are
// staged through shared memory; row maxima and sums are reduced across the
// 16 threads of a row with warp shuffles. It keeps full fp32 products (the
// TF32 tensor cores keep about three digits, the JAX package's fp32 kernel
// bound is 1e-5), and serves the small fp32 checks, not the bf16 main path.
//
// Bound at the slice shape (B=8, L=2048, H=8, D=64, bf16, causal):
//   operations  two products (QK^T and PV) of 2*D FLOP for each of the
//               L*(L+1)/2 unmasked (query, key) pairs of each of B*H heads:
//               2 * 2*64 * 64 * 2048*2049/2 = 3.44e10 FLOP
//               -> 34.8 us at 989 TFLOP/s (the bf16 peak);
//   bytes       Q, K, V read once and O written once:
//               4 * 8*2048*8*64 * 2 B = 67.1 MB -> 20.0 us at 3.35 TB/s;
// so the function is bound by operations, which the bf16 path now runs on
// the tensor cores. What keeps it from the bound: at D = 64 the softmax's
// exponentials (one MUFU op per score, 16 an SM a cycle) take as long as
// the products, and within a warpgroup the softmax of a tile still waits
// for its Q K^T product; only the other warpgroups of the SM (two CTAs of
// two) overlap it. The diagonal tiles also compute their masked halves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
constexpr float kNegInf = -1e30f;           // the Pallas kernel's mask value

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

// The bf16 tensor-core kernel's policy: the causal mask with diagonal skip,
// and the normalized epilogue.
struct FlashAttentionFwdPolicy {
  static constexpr int kN = sm90::kBlockN;

  // the longest causal query tiles first
  static __device__ __forceinline__ int q_tile(int y, int ny) {
    return ny - 1 - y;
  }

  // key tiles read by rows r0 .. r0 + rows - 1
  static __device__ __forceinline__ int kv_tiles(const sm90::Params& p,
                                                 int r0, int rows) {
    const int end = p.causal ? min(p.Lk, r0 + rows) : p.Lk;
    return (end + kN - 1) / kN;
  }

  // Scores stay unscaled: the scale is folded into the exponent,
  // p = 2^(s * c - m * c) with c = scale * log2(e), one FFMA an element.
  // Every row keeps its key 0, so m is never the mask value and the fused
  // form is exact enough.
  static constexpr bool kFusedExp = true;
  static __device__ __forceinline__ float exp_scale(const sm90::Params& p) {
    return p.scale * sm90::kLog2e;
  }

  static constexpr int kStages = 4;     // the K/V ring
  static constexpr int kExtraBytes = 0;  // no tile beside K and V
  static int make_extra_map(CUtensorMap*, const sm90::Params&) { return 0; }
  static __device__ __forceinline__ void load(const sm90::Params&,
                                              const sm90::Slot&, int) {}

  static __device__ __forceinline__ void scores(const sm90::Params& p,
                                                const sm90::Slot&,
                                                float (&s)[kN / 2], int row0,
                                                int t, int c0) {
    const int k0 = t * kN;
    // a tile wholly below the diagonal and inside Lk needs no mask; row0 is
    // the thread's lower row
    const bool edge = k0 + kN > p.Lk || (p.causal && k0 + kN - 1 > row0);
    if (!edge) return;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + c0 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        const bool keep = key < p.Lk && (!p.causal || key <= row);
        if (!keep) s[4 * j + e] = kNegInf;
      }
  }

  template <int D>
  static __device__ __forceinline__ void epilogue(
      const sm90::Params& p, const float (&o)[D / 2], const float (&m)[2],
      const float (&l)[2], int b, int h, int row0, int c0, bool leader) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= p.Lq) continue;
      // one division a row; the product differs from o / l by at most an
      // ulp of fp32 before the rounding to bf16
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* dst = p.o + b * p.so_b + row * p.so_l + h * p.so_h + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                  o[4 * j + 2 * i + 1] * inv);
    }
  }
};

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// kernel). strides: 12 element strides, the (B, L, H) strides of q, k, v and
// o in that order. Returns 0 when the launch was accepted, else a CUDA error
// or a tensor-map error; `mxtt_cuda_error_string` names either.
extern "C" int mxtt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, int dtype,
                                        int B, int H, int Lq, int Lk, int D,
                                        const long long* strides, float scale,
                                        int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, H, Lq, Lk, D, strides, scale, causal, s);
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
    p.causal = causal;
    return sm90::dispatch<FlashAttentionFwdPolicy>(q, k, v, B, Lq, Lk, D, strides, p, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return sm90::error_string(err);
}
