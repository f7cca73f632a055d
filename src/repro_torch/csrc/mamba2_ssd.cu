// Mamba2 SSD (state-space dual) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/mamba2_ssd.py: _ssd_kernel
// (L24-62), launched there by mamba2_ssd (L65), which forms la = dt * A
// (L71) -- here la = float(dt) * A is formed in the kernels, the same fp32
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
// as in the TPU kernel.
//
// What bounds it on an H100: per chunk ~2 L^2 (ds + hp) + 4 L hp ds
// operations against L (2 hp + 2 ds) elements moved.  At Zamba2-7B widths
// (hp = ds = L = 64) the products on the tensor cores (three TF32 passes,
// 495/3 TFLOP/s) take less time than the bytes (3.35 TB/s), so it is
// bound by bytes -- and by the chunk-state traffic below, which the
// TPU's sequential grid never had.
//
// Design: the chunk-parallel form of the same arithmetic, three kernels
// of one warpgroup (128 threads) each, one launch after the other:
//   1. ssd_states_kernel, one CTA per (b, h, chunk): cs (the sequential
//      fp32 sum above, thread 0), the chunk's own state contribution
//      s_c = (x o w)^T B (hp x ds) and its decay exp(cs_L), into a scratch
//      the caller allocates (fp32, Bb x H x chunks x hp x ds);
//   2. ssd_scan_kernel, one thread per (b, h, state element): over the
//      chunks in order, h_c = h_{c-1} exp(cs_L) + s_c, the TPU kernel's
//      update (L61) in its order, overwriting s_c with the state that
//      enters chunk c;
//   3. ssd_output_kernel, one CTA per (b, h, chunk): cs again (the same
//      code, the same bits), att = (C B^T) o decay, then
//      y = att @ (dt x) + exp(cs) o (C h^T) with h the entering state.
// Each CTA stages its tiles with 16-byte cp.async copies, all in flight
// at once, in the stored dtype.  Every product runs on the tensor cores
// as mma.sync m16n8k8 tf32, each warp a 16-row strip of the output, its
// operands read from shared memory in the fragment layout through row
// strides picked (by the planner, per dtype) so that a warp's 32 reads
// fall in 32 banks; dt x and x o w are formed as the fragments are read.
// An fp32 operand is split with cvt.rna into big + small and a product
// sums small*big, big*small, big*big; a bf16 input is exact in tf32 (its
// small half is 0), so with bf16 storage C B^T runs one pass, C h^T and
// the states' product two.  Above-diagonal blocks of att are skipped.
// The states' scratch is 16 KiB a chunk at hp = ds = 64 (117 MB at
// Zamba2-7B widths, more than the 50 MB L2): pass 1 writes it, pass 2
// reads and writes it, pass 3 reads it.  One state per chunk, not per
// group of chunks, keeps the scan the TPU kernel's update in its order.
// The shared-memory plan and the grids are the caller's
// (kernels/mamba2_ssd.py::plan_ssd), passed as the int array below; this
// file computes none of them.  The kernels need hp % 16 == 0, L % 16 == 0
// and ds % 8 == 0 (the wrapper checks).
#include <math.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;      // one warpgroup: 4 warps of 16 rows

// Index of each field in the int array the Python wrapper passes (kept
// in step with repro_torch/kernels/mamba2_ssd.py::PARAM_FIELDS; SsdArgs
// holds the same fields in the same order).  Row strides (ld*) are in
// elements of the tile's type (the stored dtype for x, B and C; fp32 for
// att and h), offsets (off_*) and sizes in bytes.
enum Param {
  P_BB, P_T, P_H, P_HP, P_DS, P_L, P_NC, P_LDX1, P_LDB1, P_OFF_B1,
  P_OFF_CS1, P_SMEM1, P_LDC3, P_LDB3, P_LDX3, P_LDA3, P_LDH3, P_OFF_B3,
  P_OFF_X3, P_OFF_A3, P_OFF_H3, P_OFF_CS3, P_SMEM3, P_SCAN_THREADS,
  P_SCAN_BLOCKS, P_COUNT
};

struct SsdArgs {
  int Bb, T, H, hp, ds, L, nc, ldx1, ldb1, off_b1, off_cs1, smem1, ldc3,
      ldb3, ldx3, lda3, ldh3, off_b3, off_x3, off_a3, off_h3, off_cs3, smem3,
      scan_threads, scan_blocks;
};
static_assert(sizeof(SsdArgs) == P_COUNT * sizeof(int),
              "SsdArgs must mirror enum Param");

__device__ __forceinline__ void split(float v, bool exact, uint32_t& big,
                                      uint32_t& small) {
  if (exact) {                    // a bf16 value: already a tf32 value
    big = __float_as_uint(v);
    small = 0u;
  } else {
    tf32_split(v, big, small);
  }
}

// acc[nb] += A (16 rows of this warp) x B (columns 8 nb .. 8 nb + 7)
// over k < K (a multiple of 8).  a(r, k) reads A's row r in {g, g + 8}
// of the strip, b(k, n) B's column n of the group.  Blocks nb >= nblocks
// read block nblocks - 1 again and are never stored: no branch, so the
// eight blocks' products interleave.  A product sums small*big over the
// blocks, then big*small, then big*big; an exact operand (EA, EB) has no
// small half and its pass is skipped.
template <bool EA, bool EB, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[8][4], int nblocks,
                                         int K, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int col[8];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) col[nb] = 8 * min(nb, nblocks - 1) + g;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ab[4], as[4], bb[8][2], bs[8][2];
    split(a(g, k0 + t), EA, ab[0], as[0]);
    split(a(g + 8, k0 + t), EA, ab[1], as[1]);
    split(a(g, k0 + t + 4), EA, ab[2], as[2]);
    split(a(g + 8, k0 + t + 4), EA, ab[3], as[3]);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      split(b(k0 + t, col[nb]), EB, bb[nb][0], bs[nb][0]);
      split(b(k0 + t + 4, col[nb]), EB, bb[nb][1], bs[nb][1]);
    }
    if (!EA) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mma_sync_tf32(acc[nb], as, bb[nb]);          // small * big
    }
    if (!EB) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mma_sync_tf32(acc[nb], ab, bs[nb]);          // big * small
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) mma_sync_tf32(acc[nb], ab, bb[nb]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nb][q] = 0.f;
}

// cs = cumsum(dt * a) over the chunk, the TPU kernel's fp32 order (one
// thread: the sum is sequential), from dt staged in cs itself (16-byte
// aligned, L a multiple of 16: read and written 16 values at a time).
__device__ __forceinline__ void chunk_cumsum(float* cs, int L, float a_h) {
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int t0 = 0; t0 < L; t0 += 16) {
      float4* p = reinterpret_cast<float4*>(cs + t0);
      float d[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = p[q];
        d[4 * q] = v.x; d[4 * q + 1] = v.y; d[4 * q + 2] = v.z;
        d[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        c = __fadd_rn(c, __fmul_rn(d[j], a_h));
        d[j] = c;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        p[q] = make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2],
                           d[4 * q + 3]);
    }
  }
}

// rows x cols elements of T (cols * sizeof(T) a multiple of 16), row r
// at src + r * stride, into dst + r * ld elements with 16-byte cp.async
// copies; the caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_async(unsigned char* dst, int ld,
                                            const T* src, long long stride,
                                            int rows, int cols) {
  constexpr int V = 16 / (int)sizeof(T);
  const int cv = cols / V, n = rows * cv;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int r = idx / cv, c = idx - r * cv;
    cp_async16(dst + ((long long)r * ld + c * V) * sizeof(T),
               src + r * stride + c * V, true);
  }
}

// Pass 1.  x: (Bb, T, H, hp); dt: (Bb, T, H); B: (Bb, T, H, ds).  Grid
// (nc, Bb*H).  Shared: x [L][ldx1] and B [L][ldb1] as stored, cs and w
// [L] fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_states_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  float* __restrict__ states, float* __restrict__ decay,
                  const SsdArgs a) {
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const T* xs = reinterpret_cast<const T*>(sm);
  const T* bs = reinterpret_cast<const T*>(sm + a.off_b1);
  float* cs = reinterpret_cast<float*>(sm + a.off_cs1);
  float* ws = cs + a.L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int L = a.L, hp = a.hp, ds = a.ds, ldx = a.ldx1, ldb = a.ldb1;
  const long long row = ((long long)b * a.T + (long long)c * L) * a.H + h;
  STAMP(0);
  stage_async<T>(sm, ldx, x + row * hp, (long long)a.H * hp, L, hp);
  stage_async<T>(sm + a.off_b1, ldb, Bm + row * ds, (long long)a.H * ds, L,
                 ds);
  cp_async_commit();
  const T* db = dt + row;
  for (int u = tid; u < L; u += THREADS) {
    const float d = to_f(db[(long long)u * a.H]);
    cs[u] = d;
    ws[u] = d;
  }
  __syncthreads();
  STAMP(1);
  chunk_cumsum(cs, L, A[h]);
  __syncthreads();
  STAMP(2);
  // w_u = exp(cs_L - cs_u) dt_u
  const float cl = cs[L - 1];
  for (int u = tid; u < L; u += THREADS) ws[u] = expf(cl - cs[u]) * ws[u];
  if (tid == 0) decay[(long long)bh * a.nc + c] = expf(cl);
  cp_async_wait<0>();
  __syncthreads();
  STAMP(3);
  // s_c (hp x ds) = (x o w)^T B: M = hp, N = ds, K = L
  float* sc = states + ((long long)bh * a.nc + c) * hp * ds;
  for (int m0 = 16 * warp; m0 < hp; m0 += 64)
    for (int n0 = 0; n0 < ds; n0 += 64) {
      float acc[8][4];
      zero(acc);
      const T* xa = xs + m0;
      const T* bb = bs + n0;
      warp_mma<false, BF16>(
          acc, min(8, (ds - n0) / 8), L,
          [=](int r, int k) { return to_f(xa[k * ldx + r]) * ws[k]; },
          [=](int k, int n) { return to_f(bb[k * ldb + n]); });
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (8 * nb < ds - n0) {
          const int n = n0 + 8 * nb + 2 * t4;
          *reinterpret_cast<float2*>(sc + (m0 + g) * ds + n) =
              make_float2(acc[nb][0], acc[nb][1]);
          *reinterpret_cast<float2*>(sc + (m0 + g + 8) * ds + n) =
              make_float2(acc[nb][2], acc[nb][3]);
        }
      }
    }
  STAMP_ALL(4);
}

// Pass 2.  states: (Bb*H, nc, E) with E = hp * ds; decay: (Bb*H, nc).
// Grid (scan_blocks, Bb*H), scan_threads a block, one state element a
// thread: s_c is replaced by the state entering chunk c.  Loads run
// eight chunks ahead of the chain that consumes them.
__global__ void __launch_bounds__(256)
ssd_scan_kernel(float* __restrict__ states, const float* __restrict__ decay,
                int nc, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long bh = blockIdx.y;
  float* s = states + bh * nc * E + e;
  const float* dec = decay + bh * nc;
  float hcur = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float v[8], d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = c0 + j < nc ? s[(long long)(c0 + j) * E] : 0.f;
      d[j] = c0 + j < nc ? dec[c0 + j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < nc) {
        s[(long long)(c0 + j) * E] = hcur;
        hcur = __fadd_rn(__fmul_rn(hcur, d[j]), v[j]);
      }
    }
  }
}

// Pass 3.  y: (Bb, T, H, hp); C like B.  Grid (nc, Bb*H).  Shared: C
// [L][ldc3], B [L][ldb3] and x [L][ldx3] as stored, att [L][lda3] fp32
// (over B where the plan says so: off_a3 == off_b3), h [hp][ldh3] fp32,
// then cs, dt and exp(cs) [L] fp32 each.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_output_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ states,
                  T* __restrict__ y, const SsdArgs a) {
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const T* cm = reinterpret_cast<const T*>(sm);
  const T* bs = reinterpret_cast<const T*>(sm + a.off_b3);
  const T* xs = reinterpret_cast<const T*>(sm + a.off_x3);
  float* at = reinterpret_cast<float*>(sm + a.off_a3);
  const float* hs = reinterpret_cast<const float*>(sm + a.off_h3);
  float* cs = reinterpret_cast<float*>(sm + a.off_cs3);
  float* dts = cs + a.L;
  float* ecs = dts + a.L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int L = a.L, hp = a.hp, ds = a.ds, H = a.H;
  const int ldc = a.ldc3, ldb = a.ldb3, ldx = a.ldx3, lda = a.lda3,
            ldh = a.ldh3;
  const long long row = ((long long)b * a.T + (long long)c * L) * H + h;
  STAMP(8);
  const long long xstep = (long long)H * hp, bstep = (long long)H * ds;
  stage_async<T>(sm, ldc, Cm + row * ds, bstep, L, ds);
  stage_async<T>(sm + a.off_b3, ldb, Bm + row * ds, bstep, L, ds);
  stage_async<T>(sm + a.off_x3, ldx, x + row * hp, xstep, L, hp);
  stage_async<float>(sm + a.off_h3, ldh,
                     states + ((long long)bh * a.nc + c) * hp * ds, ds, hp,
                     ds);
  cp_async_commit();
  const T* db = dt + row;
  T* yb = y + row * hp;
  for (int u = tid; u < L; u += THREADS) {
    const float d = to_f(db[(long long)u * H]);
    cs[u] = d;
    dts[u] = d;
  }
  __syncthreads();
  STAMP(9);
  chunk_cumsum(cs, L, A[h]);
  __syncthreads();
  STAMP(10);
  for (int u = tid; u < L; u += THREADS) ecs[u] = expf(cs[u]);
  cp_async_wait<0>();
  __syncthreads();
  STAMP(11);

  // att = (C B^T) o decay: M = N = L, K = ds.  A strip of rows m0 ..
  // m0 + 15 needs the columns u <= m0 + 15 only (the rest of att is 0 and
  // never read).  Where the plan puts att over B (L <= 64: one strip and
  // one column group a warp), every warp's product is done before any
  // warp writes.
  auto att_block = [&](float (&acc)[8][4], int m0, int n0, int nbs) {
    zero(acc);
    const T* ca = cm + m0 * ldc;
    const T* bb = bs + n0 * ldb;
    warp_mma<BF16, BF16>(
        acc, nbs, ds, [=](int r, int k) { return to_f(ca[r * ldc + k]); },
        [=](int k, int n) { return to_f(bb[n * ldb + k]); });
  };
  auto store_att = [&](const float (&acc)[8][4], int m0, int n0, int nbs) {
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      if (nb < nbs) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int tr = m0 + g + 8 * (q >> 1);
          const int u = n0 + 8 * nb + 2 * t4 + (q & 1);
          at[tr * lda + u] =
              u <= tr ? acc[nb][q] * expf(cs[tr] - cs[u]) : 0.f;
        }
      }
    }
  };
  if (a.off_a3 == a.off_b3) {
    const int m0 = 16 * warp, nbs = min(8, (m0 + 16) / 8);
    float acc[8][4];
    if (m0 < L) att_block(acc, m0, 0, nbs);
    __syncthreads();                  // B is read; att goes over it
    if (m0 < L) store_att(acc, m0, 0, nbs);
  } else {
    for (int m0 = 16 * warp; m0 < L; m0 += 64)
      for (int n0 = 0; n0 < m0 + 16; n0 += 64) {
        const int nbs = min(8, (m0 + 16 - n0) / 8);
        float acc[8][4];
        att_block(acc, m0, n0, nbs);
        store_att(acc, m0, n0, nbs);
      }
  }
  __syncthreads();
  STAMP(12);

  // y = exp(cs) o (C h^T) + att @ (dt x): M = L, N = hp; the inter-chunk
  // term first, scaled by its row's exp(cs) in the accumulator, then the
  // intra-chunk products summed onto it
  for (int m0 = 16 * warp; m0 < L; m0 += 64)
    for (int n0 = 0; n0 < hp; n0 += 64) {
      const int nbs = min(8, (hp - n0) / 8);
      float acc[8][4];
      zero(acc);
      const T* ca = cm + m0 * ldc;
      const float* hb = hs + n0 * ldh;
      warp_mma<BF16, false>(
          acc, nbs, ds,
          [=](int r, int k) { return to_f(ca[r * ldc + k]); },
          [=](int k, int n) { return hb[n * ldh + k]; });
      const float e0 = ecs[m0 + g], e1 = ecs[m0 + g + 8];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        acc[nb][0] *= e0;
        acc[nb][1] *= e0;
        acc[nb][2] *= e1;
        acc[nb][3] *= e1;
      }
      const float* aa = at + m0 * lda;
      const T* xb = xs + n0;
      warp_mma<false, false>(
          acc, nbs, m0 + 16,            // att is 0 past the strip's rows
          [=](int r, int k) { return aa[r * lda + k]; },
          [=](int k, int n) { return to_f(xb[k * ldx + n]) * dts[k]; });
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (nb < nbs) {
          const int p = n0 + 8 * nb + 2 * t4;
          T* y0 = yb + (long long)(m0 + g) * xstep + p;
          T* y1 = yb + (long long)(m0 + g + 8) * xstep + p;
          if constexpr (BF16) {
            *reinterpret_cast<__nv_bfloat162*>(y0) =
                __floats2bfloat162_rn(acc[nb][0], acc[nb][1]);
            *reinterpret_cast<__nv_bfloat162*>(y1) =
                __floats2bfloat162_rn(acc[nb][2], acc[nb][3]);
          } else {
            *reinterpret_cast<float2*>(y0) = make_float2(acc[nb][0],
                                                         acc[nb][1]);
            *reinterpret_cast<float2*>(y1) = make_float2(acc[nb][2],
                                                         acc[nb][3]);
          }
        }
      }
    }
  STAMP_ALL(13);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* states, void* decay,
           const SsdArgs& a, cudaStream_t s) {
  static int set1 = 0, set3 = 0;   // the largest sizes set so far
  if (a.smem1 > set1) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_states_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        a.smem1);
    if (err != cudaSuccess) return (int)err;
    set1 = a.smem1;
  }
  if (a.smem3 > set3) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_output_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        a.smem3);
    if (err != cudaSuccess) return (int)err;
    set3 = a.smem3;
  }
  const dim3 grid(a.nc, a.Bb * a.H);
  ssd_states_kernel<T><<<grid, THREADS, a.smem1, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<float*>(states), static_cast<float*>(decay), a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<dim3(a.scan_blocks, a.Bb * a.H), a.scan_threads, 0, s>>>(
      static_cast<float*>(states), static_cast<const float*>(decay), a.nc,
      a.hp * a.ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_output_kernel<T><<<grid, THREADS, a.smem3, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(states),
      static_cast<T*>(y), a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = fp32, 1 = bf16 (x, dt, B, C and y); A is fp32.  params: the
// P_COUNT ints of enum Param from the caller's plan; states (fp32,
// Bb*H*nc*hp*ds) and decay (fp32, Bb*H*nc) the caller's scratch.  Three
// launches on one stream; returns the first non-zero cudaError_t.
int mamba2_ssd_launch(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, void* y, void* states,
                      void* decay, const int* params, int dtype,
                      void* stream) {
  SsdArgs a;
  static_assert(sizeof(a) == P_COUNT * sizeof(int), "");
  memcpy(&a, params, sizeof(a));
  if (a.hp % 16 || a.L % 16 || a.ds % 8 || a.T % a.L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, states, decay, a, s);
  return launch<float>(x, dt, A, Bm, Cm, y, states, decay, a, s);
}

// The number of ints mamba2_ssd_launch reads from params.
int mamba2_ssd_param_count() { return P_COUNT; }

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
