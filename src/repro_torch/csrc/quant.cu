// Symmetric int8 boundary codec for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/quant.py:
//   * quantize_kernel   <- _quantize_kernel (L70-76), launched there by
//                          _quantize_pallas_2d;
//   * dequantize_kernel <- _dequantize_kernel (L79-80), launched there by
//                          _dequantize_pallas_2d.
//
// What bounds it on an H100: a few operations per element against 5 bytes
// moved (fp32 in, int8 out), so both kernels are bound by memory; at the
// boundary sizes the main path serves (25k-1.6M elements) the launch and
// each CTA's chain of dependent steps count as much.  The design reads each
// byte of HBM once, in one pass:
//
// * quantize: a scale group (channel c: B rows of S elements at stride
//   C*S; the whole tensor when C = 1) is split over k CTAs (k in 1, 2, 4,
//   8), a thread-block cluster when k > 1 -- for few groups, where one CTA
//   a group would leave most SMs idle.  Each thread loads its chunks of the
//   slice into registers at once (16-byte loads where the rows allow it),
//   the CTA takes its absmax, and the cluster's CTAs exchange theirs
//   through distributed shared memory after one barrier; each thread then
//   quantizes what it holds and stores int8 4 or 16 bytes at a time.  A
//   slice larger than a CTA's registers hold is read a second time.
// * dequantize: the values are read flat, 4 int8 values a thread at a time
//   written as one float4 or 4-wide bf16 store, every warp access
//   contiguous; each thread steps its chunks' place in their rows and
//   their channels' scales from one chunk to the next: 32-bit indices, two
//   divisions a thread, none an element, and no lane idle at a short row.
//
// The launch geometry (k, slices, vector widths, threads, blocks) comes
// from plan_quantize / plan_dequantize in repro_torch/kernels/quant.py, its
// only copy; the entry points refuse what the kernels do not take.
//
// The int8 contract is bitwise that of the JAX package's quantize_boundary
// under jit, which is what its wire ships: absmax is order-free; the scale
// is absmax * fl32(1/127), one round-to-nearest multiply (XLA's rewrite of
// absmax / 127), 1.0 for an all-zero group; each value is round-half-even
// of the round-to-nearest quotient x / scale, clipped to +-127.  bf16 input
// is widened to fp32 first; dequantize is (float)q * scale, rounded to bf16
// with __float2bfloat16_rn for bf16 storage.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int Q_MAX_THREADS = 512;
// chunks of VEC elements a quantize thread holds in registers
__host__ __device__ constexpr int held_chunks(int v) {
  return v == 16 ? 4 : v == 4 ? 8 : 16;
}
constexpr int DQ_THREADS = 256;
// fl32(1/127): the constant XLA multiplies by for absmax / 127
constexpr float INV127 = 0x1.020408p-7f;

// Cluster barriers: arrive with release (publishing this CTA's shared
// memory) or relaxed (only saying this CTA is done reading the others'),
// wait with acquire.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// fp32 of the bf16 halves of a 32-bit word (element 0 in the low half)
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// VEC elements at global p (VEC * sizeof(T)-byte aligned up to 16),
// widened to fp32: 16-byte loads where VEC * sizeof(T) allows, else 8 or 4.
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float (&v)[VEC]) {
  if constexpr (sizeof(T) == 4 && VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = f.x; v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
    }
  } else if constexpr (sizeof(T) == 2 && VEC % 8 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 8; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[8 * i + 2 * e] = bf_lo(w[e]);
        v[8 * i + 2 * e + 1] = bf_hi(w[e]);
      }
    }
  } else if constexpr (sizeof(T) == 2 && VEC == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf_lo(u.x); v[1] = bf_hi(u.x);
    v[2] = bf_lo(u.y); v[3] = bf_hi(u.y);
  } else if constexpr (sizeof(T) == 2) {
    v[0] = __uint_as_float(
        (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  } else {
    v[0] = __ldg(p);
  }
}

// round(a / b) clipped to +-127, as an int8 bit pattern.  The division is
// IEEE round-to-nearest (div.rn).  FAST, for 2^-60 <= b <= 2^60: from r =
// 1/b rounded to nearest, q0 = a r, then twice q += (a - q b) r with the
// residual exact by fma and the sum rounded once (Markstein's correction):
// div.rn's quotient wherever |a / b| >= 2^-40 (every residual then keeps
// its low bit above 2^-149), and under 1/2 where it is not, so the same
// rint.  Else div.rn itself.
template <bool FAST>
__device__ __forceinline__ uint32_t quant1(float a, float b, float r) {
  float qt;
  if constexpr (FAST) {
    const float q0 = __fmul_rn(a, r);
    const float q1 = __fmaf_rn(__fmaf_rn(-b, q0, a), r, q0);
    qt = __fmaf_rn(__fmaf_rn(-b, q1, a), r, q1);
  } else {
    qt = __fdiv_rn(a, b);
  }
  return (uint32_t)(int)fminf(fmaxf(rintf(qt), -127.f), 127.f) & 0xffu;
}
template <bool FAST>
__device__ __forceinline__ uint32_t quant4(const float* v, float b,
                                           float r) {
  return quant1<FAST>(v[0], b, r) | quant1<FAST>(v[1], b, r) << 8 |
         quant1<FAST>(v[2], b, r) << 16 | quant1<FAST>(v[3], b, r) << 24;
}

// VEC int8 values of v / b to q (VEC-byte aligned): one 16-, 4- or 1-byte
// store.
template <bool FAST, int VEC>
__device__ __forceinline__ void store_chunk(int8_t* q, const float (&v)[VEC],
                                            float b, float r) {
  if constexpr (VEC == 16) {
    *reinterpret_cast<uint4*>(q) = make_uint4(
        quant4<FAST>(v, b, r), quant4<FAST>(v + 4, b, r),
        quant4<FAST>(v + 8, b, r), quant4<FAST>(v + 12, b, r));
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(q) = quant4<FAST>(v, b, r);
  } else {
    q[0] = (int8_t)quant1<FAST>(v[0], b, r);
  }
}

// x viewed as (B, C, S).  Group c is x[:, c, :], flattened as j = b*S + s
// (0 <= j < n = B*S), its element j at x[(b*C + c)*S + s].  The k CTAs of
// cluster c take it (k = 1: one CTA, no cluster); rank r the slice j in
// [r*slice, min((r+1)*slice, n)).  A thread takes the VEC-element chunks
// starting at lo + VEC*threadIdx.x, then every VEC*blockDim.x.  The plan
// keeps slice and S multiples of VEC (a single group, C = 1, is passed as
// one row, S = n), so a chunk never crosses a row and starts VEC-aligned.
//
// Resident (slice <= held_chunks(VEC) * VEC * blockDim.x): a thread loads
// its chunks into registers once -- every load in flight at once -- takes
// the absmax, and quantizes what it holds.  Else, and where the scale lies
// outside the fast division's range, the slice is read a second time.
template <typename T, int VEC>
__global__ void __launch_bounds__(Q_MAX_THREADS)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int C, int S, int n, int slice) {
  constexpr int HELD = held_chunks(VEC);
  __shared__ float warp_maxima[Q_MAX_THREADS / 32];
  __shared__ float partial;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c = (int)blockIdx.x / k;
  const int lo = rank * slice;
  const int hi = min(lo + slice, n);
  const int first = lo + VEC * (int)threadIdx.x;
  const int step = VEC * (int)blockDim.x;
  const bool resident = slice <= HELD * step;
  const int lane = (int)threadIdx.x & 31;
  // where a thread's chunks of the group lie in x and q, stepped from one
  // to the next without a division (and none at all for one row, B = 1)
  const bool one_row = n == S;
  int b = one_row ? 0 : first / S, s = first - b * S;
  const int db = one_row ? 0 : step / S, ds = step - db * S;
  auto next = [&]() {
    const int off = (b * C + c) * S + s;
    s += ds;
    b += db;
    if (s >= S) { s -= S; ++b; }
    return off;
  };

  float v[HELD][VEC];
  int at[HELD];
  int live = 0;   // chunks this thread holds
  float m = 0.f;
  if (resident) {
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      if (first + i * step >= hi) break;
      at[i] = next();
      load_chunk<T, VEC>(x + at[i], v[i]);
      live = i + 1;
    }
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      if (i >= live) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(v[i][e]));
    }
  } else {
    for (int j = first; j < hi; j += step) {
      load_chunk<T, VEC>(x + next(), v[0]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(v[0][e]));
    }
  }
  m = warp_max(m);
  if (lane == 0) warp_maxima[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max(lane < (int)(blockDim.x >> 5) ? warp_maxima[lane] : 0.f);
  if (k > 1) {
    // publish the CTA's absmax; every warp reads the k partials through
    // distributed shared memory, one a lane
    if (threadIdx.x == 0) partial = m;
    cluster_arrive_release();
    cluster_wait();
    m = warp_max(lane < k ? *cluster.map_shared_rank(&partial, lane) : 0.f);
    cluster_arrive_relaxed();
  }
  const float scale = m > 0.f ? __fmul_rn(m, INV127) : 1.f;
  if (rank == 0 && threadIdx.x == 0) scales[c] = scale;
  const float r = __frcp_rn(scale);
  const bool fast = scale >= 0x1p-60f && scale <= 0x1p60f;
  if (resident && fast) {
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      if (i >= live) break;
      store_chunk<true, VEC>(q + at[i], v[i], scale, r);
    }
  } else {
    b = one_row ? 0 : first / S;
    s = first - b * S;
    for (int j = first; j < hi; j += step) {
      const int a = next();
      load_chunk<T, VEC>(x + a, v[0]);
      if (fast) store_chunk<true, VEC>(q + a, v[0], scale, r);
      else store_chunk<false, VEC>(q + a, v[0], scale, r);
    }
  }
  if (k > 1) cluster_wait();   // no CTA leaves while another may read it
}

__device__ __forceinline__ float dq1(uint32_t w, int e, float scale) {
  return __fmul_rn((float)(int8_t)(w >> (8 * e)), scale);
}

// q viewed as R = B*C rows of S: row r = b*C + c, scaled by scales[c],
// read flat.  Thread t takes the VEC-element chunks from VEC*t, then
// every stride = VEC * (its grid's threads), and steps (s, c) -- the
// chunk's place in its row and the row's channel -- from one to the next
// by (ds, dc) = (stride % S, (stride / S) % C) without a division.  VEC 4:
// a 4-byte load and a float4 or 8-byte bf16 store; a row ends inside a
// chunk at most once (S >= 4), and the elements past it take the next
// row's scale.  VEC 1: one element.
template <typename T, int VEC>
__global__ void __launch_bounds__(DQ_THREADS)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, T* __restrict__ out,
                  int C, int S, int n, int ds, int dc) {
  int p = VEC * ((int)blockIdx.x * DQ_THREADS + (int)threadIdx.x);
  if (p >= n) return;
  const int stride = VEC * (int)gridDim.x * DQ_THREADS;
  const int row = p / S;
  int s = p - row * S, c = row % C;
  for (; p < n; p += stride) {
    const float sc = __ldg(scales + c);
    if constexpr (VEC == 1) {
      out[p] = from_f<T>(__fmul_rn((float)q[p], sc));
    } else {
      const float sn =
          s + VEC > S ? __ldg(scales + (c + 1 == C ? 0 : c + 1)) : sc;
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(q + p));
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = __fmul_rn((float)(int8_t)(w >> (8 * e)), s + e < S ? sc : sn);
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(out + p) = make_float4(f[0], f[1], f[2],
                                                          f[3]);
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
        *reinterpret_cast<uint2*>(out + p) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
    s += ds;
    c += dc;
    if (c >= C) c -= C;
    if (s >= S) {
      s -= S;
      if (++c == C) c = 0;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_quantize(const void* x, void* q, void* scales, int C,
                            int S, int n, int k, int slice, int threads,
                            cudaStream_t stream) {
  auto kernel = quantize_kernel<T, VEC>;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  if (k == 1) {
    kernel<<<C, threads, 0, stream>>>(xt, qt, st, C, S, n, slice);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * k));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, xt, qt, st, C, S, n, slice);
}

template <typename T>
cudaError_t quantize_vec(int vec, const void* x, void* q, void* scales,
                         int C, int S, int n, int k, int slice, int threads,
                         cudaStream_t stream) {
  if (vec == 16)
    return launch_quantize<T, 16>(x, q, scales, C, S, n, k, slice, threads,
                                  stream);
  if (vec == 4)
    return launch_quantize<T, 4>(x, q, scales, C, S, n, k, slice, threads,
                                 stream);
  return launch_quantize<T, 1>(x, q, scales, C, S, n, k, slice, threads,
                               stream);
}

template <typename T, int VEC>
cudaError_t launch_dequantize(const void* q, const void* scales, void* out,
                              int C, int S, int n, int blocks,
                              cudaStream_t stream) {
  const long long stride = (long long)VEC * blocks * DQ_THREADS;
  const int ds = (int)(stride % S), dc = (int)((stride / S) % C);
  dequantize_kernel<T, VEC><<<blocks, DQ_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<T*>(out), C, S, n, ds, dc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, C, S) in dtype 0 = fp32 or 1 = bf16 -> q int8 (B, C, S), scales
// fp32 (C,); k CTAs a group (a cluster when k > 1), slice elements a CTA,
// vec elements a chunk, threads a CTA.  Returns the cudaError_t of the
// launch.
int quantize_launch(const void* x, void* q, void* scales, int B, int C,
                    int S, int k, int slice, int vec, int threads, int dtype,
                    void* stream) {
  const long long n = (long long)B * S;
  if (B < 1 || C < 1 || S < 1 || n * C >= (1LL << 31) ||
      !(k == 1 || k == 2 || k == 4 || k == 8) ||
      !(vec == 1 || vec == 4 || vec == 16) || S % vec || slice < 1 ||
      slice % vec || (long long)slice * k < n || threads < 32 ||
      threads > Q_MAX_THREADS || threads % 32 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1
          ? quantize_vec<__nv_bfloat16>(vec, x, q, scales, C, S, (int)n, k,
                                        slice, threads, s)
          : quantize_vec<float>(vec, x, q, scales, C, S, (int)n, k, slice,
                                threads, s);
  return (int)err;
}

// q int8 (B, C, S) and scales fp32 (C,) -> out (B, C, S) in dtype; vec
// values a thread at a time (4 needs S >= 4 and 4 | B*C*S), blocks of
// DQ_THREADS threads.
int dequantize_launch(const void* q, const void* scales, void* out, int B,
                      int C, int S, int vec, int blocks, int dtype,
                      void* stream) {
  const long long n = (long long)B * C * S;
  const long long stride = (long long)vec * blocks * DQ_THREADS;
  if (B < 1 || C < 1 || S < 1 || blocks < 1 || n + stride >= (1LL << 31) ||
      !(vec == 1 || (vec == 4 && S >= 4 && n % 4 == 0)) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vec == 4 ? launch_dequantize<__nv_bfloat16, 4>(q, scales, out, C,
                                                         S, (int)n, blocks, s)
                   : launch_dequantize<__nv_bfloat16, 1>(q, scales, out, C,
                                                         S, (int)n, blocks, s);
  else
    err = vec == 4 ? launch_dequantize<float, 4>(q, scales, out, C, S, (int)n,
                                                 blocks, s)
                   : launch_dequantize<float, 1>(q, scales, out, C, S, (int)n,
                                                 blocks, s);
  return (int)err;
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
