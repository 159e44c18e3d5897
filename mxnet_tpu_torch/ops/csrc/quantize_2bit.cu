// 2-bit error-feedback gradient quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside `quantize_2bit_pallas` of
// mxnet_tpu/gradient_compression.py (launched through `pl.pallas_call`). It
// computes the same function, value by value:
//
//   r = residual + grad                       (fp32)
//   r >=  t:  code 3 (binary 11), residual = r - t
//   r <= -t:  code 2 (binary 10), residual = r + t
//   else:     code 0,             residual = r
//
// with t the threshold rounded to fp32, as jnp rounds a weak-typed Python
// float; the comparisons and the subtraction are fp32, never double. A NaN
// in r fails both comparisons, so it gives code 0 and stays in the residual,
// as in jnp. Sixteen codes pack into one 32-bit word, LSB-first: value
// 16*w + j of the flat input lands at bits 2j and 2j+1 of word w. A ragged
// last word has zeros in its high codes, as the Pallas kernel's zero padding
// gives.
//
// Layout. grad is a flat fp32 or bf16 array of n values, read as it is (a
// bf16 value converts to fp32 exactly in the kernel, so a bf16 gradient
// needs no cast copy); residual is a flat fp32 array of n values, updated in
// place; packed receives ceil(n/16) words.
//
// Design. One thread per value, so the loads of grad and residual and the
// store of the residual are fully coalesced. Each half-warp owns one word:
// its 16 lanes OR their shifted codes together with a four-step XOR shuffle
// tree, and the half-warp's first lane stores the word. Threads past
// n contribute code 0 and touch no memory.
//
// Bound. The function is elementwise: it must read grad (2 or 4 bytes a
// value) and residual (4), and write residual (4) and a quarter byte of
// packed words per value, about two operations a value. At the largest key
// of the slice (embed's gradient, 32768 x 512 bf16) that is 172 MB, 51 us at
// 3.35 TB/s, and far fewer operations than the card's rate would make
// visible: the kernel is bound by bytes. The simple one-value-per-thread
// design issues 2- and 4-byte loads; wider vector loads and one launch over
// all keys of a step are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kValsPerWord = 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_2bit_kernel(const T* __restrict__ grad, float* __restrict__ residual,
                     uint32_t* __restrict__ packed, long long n,
                     float threshold) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  uint32_t code = 0u;
  if (i < n) {
    const float r = residual[i] + to_float(grad[i]);
    float nr = r;
    if (r >= threshold) {
      code = 3u;
      nr = r - threshold;
    } else if (r <= -threshold) {
      code = 2u;
      nr = r + threshold;
    }
    residual[i] = nr;
  }
  // Lane j of a half-warp holds value 16*w + j (blocks start at multiples of
  // 256, so half-warps start at multiples of 16). XOR offsets below 16 stay
  // inside the half-warp; every lane of the warp takes part, so the full
  // mask holds.
  const unsigned sub = threadIdx.x & (kValsPerWord - 1);
  uint32_t word = code << (2u * sub);
#pragma unroll
  for (int off = 1; off < kValsPerWord; off *= 2)
    word |= __shfl_xor_sync(0xffffffffu, word, off);
  if (sub == 0u && i < n) packed[i / kValsPerWord] = word;
}

template <typename T>
cudaError_t launch(const void* grad, float* residual, uint32_t* packed,
                   long long n, float threshold, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_2bit_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(static_cast<const T*>(grad), residual,
                                      packed, n, threshold);
  return cudaGetLastError();
}

}  // namespace

// grad_dtype: 0 = float32, 1 = bfloat16. n >= 1 values. Returns the CUDA
// error of the launch (0 when it was accepted); the wrapper raises on any
// other.
extern "C" int mxtt_quantize_2bit(const void* grad, int grad_dtype,
                                  void* residual, void* packed, long long n,
                                  float threshold, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* res = static_cast<float*>(residual);
  uint32_t* out = static_cast<uint32_t*>(packed);
  if (n < 1) return cudaErrorInvalidValue;
  if (grad_dtype == 0) return launch<float>(grad, res, out, n, threshold, s);
  if (grad_dtype == 1)
    return launch<__nv_bfloat16>(grad, res, out, n, threshold, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
