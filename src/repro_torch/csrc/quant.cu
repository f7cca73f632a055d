// Symmetric int8 boundary codec for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/quant.py:
//   * quantize_kernel   <- _quantize_kernel (L70-76), launched there by
//                          _quantize_pallas_2d;
//   * dequantize_kernel <- _dequantize_kernel (L79-80), launched there by
//                          _dequantize_pallas_2d.
//
// What bounds it on an H100: a few operations per element against 5 bytes
// moved (fp32 in, int8 out), so both kernels are bound by memory.  The
// design reads the tensor in place, in its (B, C, S) layout -- no moveaxis
// copy as the JAX wrapper makes -- and, for quantize, keeps each channel's
// two passes (absmax, then quantize) inside one CTA, so the second pass
// finds the channel in L2.
//
// The int8 contract is bitwise: absmax is order-free, the scale is a true
// division absmax / 127 (1.0 for an all-zero channel), and each value is
// rintf(x / scale) -- a round-to-nearest division and round-half-even,
// never a reciprocal multiply -- clipped to +-127.  bf16 input is widened
// to fp32 first; dequantize is (float)q * scale, rounded to bf16 with
// __float2bfloat16_rn for bf16 storage.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int Q_THREADS = 512;
constexpr int DQ_THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x viewed as (B, C, S): channel c owns x[b, c, :] for every b.  One CTA
// per channel; per-tensor quantization is the case C = 1.
template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int B, int C, long long S) {
  __shared__ float warp_max[Q_THREADS / 32];
  const int c = blockIdx.x;
  float m = 0.f;
  for (int b = 0; b < B; ++b) {
    const T* row = x + ((long long)b * C + c) * S;
    for (long long s = threadIdx.x; s < S; s += Q_THREADS)
      m = fmaxf(m, fabsf(to_f(row[s])));
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.f;
  for (int i = 0; i < Q_THREADS / 32; ++i) m = fmaxf(m, warp_max[i]);
  const float scale = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
  if (threadIdx.x == 0) scales[c] = scale;
  for (int b = 0; b < B; ++b) {
    const long long base = ((long long)b * C + c) * S;
    for (long long s = threadIdx.x; s < S; s += Q_THREADS) {
      const float v = rintf(__fdiv_rn(to_f(x[base + s]), scale));
      q[base + s] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(DQ_THREADS)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, T* __restrict__ out,
                  int C, long long S, long long total) {
  const long long i = (long long)blockIdx.x * DQ_THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)((i / S) % C);
  out[i] = from_f<T>((float)q[i] * scales[c]);
}

}  // namespace

extern "C" {

// dtype 0 = fp32, 1 = bf16.  Returns the cudaError_t of the launch.
int quantize_launch(const void* x, void* q, void* scales, int B, int C,
                    long long S, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  if (dtype == 1)
    quantize_kernel<__nv_bfloat16><<<C, Q_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), qt, st, B, C, S);
  else
    quantize_kernel<float><<<C, Q_THREADS, 0, s>>>(
        static_cast<const float*>(x), qt, st, B, C, S);
  return (int)cudaGetLastError();
}

int dequantize_launch(const void* q, const void* scales, void* out, int C,
                      long long S, long long total, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(scales);
  const unsigned blocks = (unsigned)((total + DQ_THREADS - 1) / DQ_THREADS);
  if (dtype == 1)
    dequantize_kernel<__nv_bfloat16><<<blocks, DQ_THREADS, 0, s>>>(
        qt, st, static_cast<__nv_bfloat16*>(out), C, S, total);
  else
    dequantize_kernel<float><<<blocks, DQ_THREADS, 0, s>>>(
        qt, st, static_cast<float*>(out), C, S, total);
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
