// RWKV6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/rwkv6_wkv.py: _wkv_kernel
// (L21-41), launched there by rwkv6_wkv (L44).  Per (batch, head), from
// S = 0 (hd x hd, fp32), for t = 0 .. T-1:
//   out_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j]  = S[i][j] w_t[i] + k_t[i] v_t[j]
// Every input is widened to fp32 as it is read; out is stored in the
// inputs' dtype.  T needs no padding here (the ops wrapper pads with decay
// 1, as the JAX one does, and slices).
//
// What bounds it on an H100: the function needs ~5 hd^2 fp32 operations
// per (b, h, t) (k v^T, the decayed update, r^T S; the bonus term factors
// as v_j sum_i r_i u_i k_i, O(hd)) against 5 hd elements moved, so at
// hd = 64 its bound is the bytes.  This kernel keeps the TPU body's form,
// 7 hd^2 operations a step -- but the recurrence is sequential in t, and
// only B*H CTAs exist (128 at RWKV6-7B widths, batch 2), so the kernel is
// bound by the latency of one step.  Its design: one CTA per (b, h) with hd*hd/16
// threads; thread (j, q) holds rows q*16 .. q*16+15 of column j of S in
// registers, so a step is 16 FMA-chains a thread and a reduction over
// hd/16 neighbouring lanes (shuffles, no shared memory).  r, k, v and w
// are staged in shared memory 2048/hd steps at a time (32 KiB).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int R = 16;                  // state rows a thread holds

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

// r, k, v, w, out: (B, T, H, HD); u: (H, HD) fp32.  Grid B*H.
template <typename T, int HD>
__global__ void __launch_bounds__(HD * HD / R)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const float* __restrict__ u, T* __restrict__ out, int T_, int H) {
  constexpr int NS = HD / R;           // lanes sharing a column (1..8)
  constexpr int NT = HD * NS;          // threads
  constexpr int TB = 2048 / HD;        // steps staged at once
  __shared__ __align__(16) float rs[TB][HD];
  __shared__ __align__(16) float ks[TB][HD];
  __shared__ __align__(16) float vs[TB][HD];
  __shared__ __align__(16) float ws[TB][HD];

  const int tid = threadIdx.x;
  const int j = tid / NS;              // the column of S this thread holds
  const int i0 = (tid % NS) * R;       // its first row
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long step = (long long)H * HD;
  const long long base = ((long long)b * T_ * H + h) * HD;

  float S[R], uu[R];
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    S[ii] = 0.f;
    uu[ii] = u[h * HD + i0 + ii];
  }

  for (int t0 = 0; t0 < T_; t0 += TB) {
    const int tn = min(TB, T_ - t0);
    __syncthreads();                   // the last block's steps are done
    for (int idx = tid; idx < tn * HD; idx += NT) {
      const int tt = idx / HD, i = idx % HD;
      const long long g = base + (t0 + tt) * step + i;
      rs[tt][i] = to_f(r[g]);
      ks[tt][i] = to_f(k[g]);
      vs[tt][i] = to_f(v[g]);
      ws[tt][i] = to_f(w[g]);
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      const float vj = vs[tt][j];
      float o = 0.f;
#pragma unroll
      for (int i4 = 0; i4 < R / 4; ++i4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[tt][i0 + 4 * i4]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[tt][i0 + 4 * i4]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[tt][i0 + 4 * i4]);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kv4[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = 4 * i4 + e;
          const float kv = kv4[e] * vj;
          o += rv[e] * (S[ii] + uu[ii] * kv);
          S[ii] = S[ii] * wv[e] + kv;
        }
      }
#pragma unroll
      for (int off = NS / 2; off > 0; off >>= 1)
        o += __shfl_xor_sync(0xffffffffu, o, off);
      if (i0 == 0) out[base + (t0 + tt) * step + j] = from_f<T>(o);
    }
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, int B, int T_, int H, cudaStream_t s) {
  wkv_kernel<T, HD><<<B * H, HD * HD / R, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<T*>(out), T_, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* out, int B, int T_, int H, int hd,
              cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, out, B, T_, H, s);
    case 32: return launch<T, 32>(r, k, v, w, u, out, B, T_, H, s);
    case 64: return launch<T, 64>(r, k, v, w, u, out, B, T_, H, s);
    case 128: return launch<T, 128>(r, k, v, w, u, out, B, T_, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// hd in {16, 32, 64, 128}; dtype 0 = fp32, 1 = bf16 (r, k, v, w and out);
// u is fp32.  Returns the cudaError_t of the launch.
int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* out, int B, int T_,
                     int H, int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(r, k, v, w, u, out, B, T_, H, hd, s);
  return launch_hd<float>(r, k, v, w, u, out, B, T_, H, hd, s);
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
