// Mamba2 SSD (state-space dual) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/mamba2_ssd.py: _ssd_kernel
// (L24-62), launched there by mamba2_ssd (L65), which forms la = dt * A
// (L71) -- here la = float(dt) * A is formed in the kernel, the same fp32
// product.  Per (batch, head), from h = 0 (hp x ds, fp32), for each chunk
// of L steps, in fp32:
//   cs      = cumsum(la)                              (L,)
//   att     = (C B^T) o [u <= t] exp(cs_t - cs_u)     (L, L); the mask
//             selects before it multiplies, so exp's overflow above the
//             diagonal never meets a 0
//   y       = att @ (dt x) + exp(cs) o (C h^T)        (L, hp)
//   h       = exp(cs_L) h + (x o w)^T B,  w_u = exp(cs_L - cs_u) dt_u
// y is stored in x's dtype.  T must be a multiple of L (the ops wrapper
// pads with zeros and slices); there is no D term and no final state,
// as in the TPU kernel.  The shared-memory plan is the caller's
// (kernels/mamba2_ssd.py::plan_ssd): its row stride ld for B and h and its
// byte count come in with the launch, and this file computes neither.
//
// What bounds it on an H100: per chunk ~2 L^2 (ds + hp) + 4 L hp ds fp32
// operations against L (2 hp + 2 ds) elements moved, so at Zamba2-7B widths
// (hp = ds = L = 64) it is bound by operations.  The chunks of one (b, h)
// are sequential and only B*H CTAs exist (224 at batch 2), so each CTA
// walks its chunks with 256 threads: every product is register-blocked 4x4
// per thread over 64x64 output tiles, its operands in shared memory, with
// the state kept in shared memory across chunks (16 KiB at hp = ds = 64).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

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

// out(r, c, sum_k a(r, k) b(k, c)) for r < M, c < N.  The 16x16 threads
// cover a 64x64 output tile, each the rows ti + 16x and columns tj + 16y,
// and walk the tiles; every (r, c) is owned by one thread, the same one in
// every call with the same M and N.
template <typename FA, typename FB, typename FO>
__device__ __forceinline__ void tile_product(int M, int N, int K, FA a, FB b,
                                             FO out) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  for (int r0 = 0; r0 < M; r0 += 64)
    for (int c0 = 0; c0 < N; c0 += 64) {
      float acc[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int rr = r0 + ti + 16 * x;
          av[x] = rr < M ? a(rr, kk) : 0.f;
        }
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int cc = c0 + tj + 16 * y;
          bv[y] = cc < N ? b(kk, cc) : 0.f;
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int rr = r0 + ti + 16 * x, cc = c0 + tj + 16 * y;
          if (rr < M && cc < N) out(rr, cc, acc[x][y]);
        }
    }
}

// x, y: (Bb, T, H, hp); dt: (Bb, T, H); A: (H,) fp32; Bm, Cm: (Bb, T, H, ds).
// Grid Bb*H; dynamic shared memory laid out as below, ld >= ds the row
// stride of B and h (odd in the plan, so their columns read conflict-free).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, int T_, int H,
           int hp, int ds, int L, int ld) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [L][hp]
  float* Bs = xs + L * hp;               // [L][ld]
  float* Cs = Bs + L * ld;               // [L][ds]
  float* hs = Cs + L * ds;               // [hp][ld]  the carried state
  float* att = hs + hp * ld;             // [L][L]
  float* yi = att + L * L;               // [L][hp]  intra-chunk term
  float* cs = yi + L * hp;               // [L] cumsum(la)
  float* dts = cs + L;                   // [L]
  float* ecs = dts + L;                  // [L] exp(cs_t)
  float* wts = ecs + L;                  // [L] exp(cs_L - cs_u) dt_u

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a_h = A[h];
  const long long x_step = (long long)H * hp, b_step = (long long)H * ds;
  const T* xb = x + ((long long)b * T_ * H + h) * hp;
  const T* bb = Bm + ((long long)b * T_ * H + h) * ds;
  const T* cb = Cm + ((long long)b * T_ * H + h) * ds;
  const T* db = dt + (long long)b * T_ * H + h;
  T* yb = y + ((long long)b * T_ * H + h) * hp;

  for (int idx = tid; idx < hp * ld; idx += THREADS) hs[idx] = 0.f;

  for (int t0 = 0; t0 < T_; t0 += L) {
    __syncthreads();                     // the last chunk is done with smem
    for (int idx = tid; idx < L * hp; idx += THREADS) {
      const int t = idx / hp, p = idx % hp;
      xs[t * hp + p] = to_f(xb[(t0 + t) * x_step + p]);
    }
    for (int idx = tid; idx < L * ds; idx += THREADS) {
      const int t = idx / ds, n = idx % ds;
      Bs[t * ld + n] = to_f(bb[(t0 + t) * b_step + n]);
      Cs[t * ds + n] = to_f(cb[(t0 + t) * b_step + n]);
    }
    for (int t = tid; t < L; t += THREADS)
      dts[t] = to_f(db[(long long)(t0 + t) * H]);
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int t = 0; t < L; ++t) {
        c = __fadd_rn(c, __fmul_rn(dts[t], a_h));
        cs[t] = c;
      }
    }
    __syncthreads();
    for (int t = tid; t < L; t += THREADS) {
      ecs[t] = expf(cs[t]);
      wts[t] = expf(cs[L - 1] - cs[t]) * dts[t];
    }
    // att = (C B^T) o decay, masked above the diagonal
    tile_product(
        L, L, ds, [&](int t, int n) { return Cs[t * ds + n]; },
        [&](int n, int u) { return Bs[u * ld + n]; },
        [&](int t, int u, float v) {
          att[t * L + u] = u <= t ? v * expf(cs[t] - cs[u]) : 0.f;
        });
    __syncthreads();
    // y = att @ (dt x) + exp(cs) o (C h^T); both products give each (t, p)
    // to the same thread, so yi needs no barrier between them
    tile_product(
        L, hp, L, [&](int t, int u) { return att[t * L + u]; },
        [&](int u, int p) { return xs[u * hp + p] * dts[u]; },
        [&](int t, int p, float v) { yi[t * hp + p] = v; });
    tile_product(
        L, hp, ds, [&](int t, int n) { return Cs[t * ds + n]; },
        [&](int n, int p) { return hs[p * ld + n]; },
        [&](int t, int p, float v) {
          yb[(t0 + t) * x_step + p] = from_f<T>(yi[t * hp + p] + ecs[t] * v);
        });
    __syncthreads();                     // h is read above, updated below
    const float decay = expf(cs[L - 1]);
    tile_product(
        hp, ds, L, [&](int p, int u) { return xs[u * hp + p] * wts[u]; },
        [&](int u, int n) { return Bs[u * ld + n]; },
        [&](int p, int n, float v) { hs[p * ld + n] = hs[p * ld + n] * decay + v; });
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, int Bb, int T_, int H, int hp, int ds,
           int L, int ld, int smem, cudaStream_t s) {
  static int configured = 0;   // the largest size set so far
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  ssd_kernel<T><<<Bb * H, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), T_, H, hp, ds, L, ld);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = fp32, 1 = bf16 (x, dt, B, C and y); A is fp32.  T a multiple
// of L; ld and smem (bytes) from the caller's plan.  Returns the
// cudaError_t of the launch.
int mamba2_ssd_launch(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, void* y, int Bb,
                      int T_, int H, int hp, int ds, int L, int ld, int smem,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, Bb, T_, H, hp, ds, L,
                                 ld, smem, s);
  return launch<float>(x, dt, A, Bm, Cm, y, Bb, T_, H, hp, ds, L, ld, smem,
                       s);
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
