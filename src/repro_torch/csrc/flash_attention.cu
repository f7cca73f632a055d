// Flash attention (online softmax, causal or not, GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
// _flash_kernel (L23-66), launched there by flash_attention (L69) after
// ops.py::_flash_attention_gqa (L49-65) repeats K/V over the query heads.
//
// Contract, as the TPU kernel computes it:
//   s     = (q . k) * scale            fp32 dot, scale = 1/sqrt(hd) rounded
//                                      once to fp32, applied after the dot
//   s     = -1e30 where a key is masked (causal, end-aligned:
//           key > query + Sk - Sq) -- a finite fill, so a query row with no
//           visible key (Sq > Sk) gets p = 1 for every key: the mean of V
//   out   = sum_j exp(s_j - m) v_j / sum_j exp(s_j - m), fp32, stored in
//           q's dtype; a zero denominator is taken as 1.
// Inputs are read in their (B, S, heads, hd) layout; the query head h reads
// the K/V head h / (H / KV), in place of materialising the repeat.  The
// launch geometry is the caller's (kernels/flash_attention.py::plan_flash):
// the grid, the dynamic shared memory and, per query tile, how many key
// tiles it walks (an int32 table on the device).  This file computes none
// of it; flash_attention_tiles reports the tile constants it is compiled
// with, so the caller can check they are the planner's.
//
// What bounds it on an H100: at the served shapes (Sq = Sk = 2048) the
// work is ~4 hd FLOPs per visible (query, key) pair against 2 hd bytes
// per row read once, so it is bound by operations.  This first version does
// fp32 FMAs on the CUDA cores (the bound for bf16 storage is the tensor
// cores' rate, out of its reach).  Its design: one CTA per (b*h, 64-query
// tile), 256 threads; the Q tile stays in shared memory (d-major), K and V
// tiles of 64 keys take turns in one buffer; S = Q K^T is register-blocked
// 4x4 per thread (2 vector shared loads per 16 FMAs); P V is blocked 4 rows
// x hd/16 columns per thread, so a row's accumulator is split over 16
// threads and hd = 128 needs 32 accumulators a thread.  Key tiles wholly
// above the diagonal are skipped, except in a query tile that holds a row
// with no visible key, which must average every key.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per staged tile
constexpr int THREADS = 256;
constexpr int LDT = BQ + 4;      // Q^T / K^T rows (d-major), 16-byte aligned
constexpr int LDS = BQ + 8;      // S^T rows (key-major): conflict-free softmax
constexpr float MASKED = -1e30f;

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

// q, o: (B, Sq, H, HD); k, v: (B, Sk, KV, HD).  Grid (ceil(Sq/BQ), B*H);
// query tile x walks k_tiles[x] key tiles.  Shared memory, in floats: Q^T
// and the K^T / V buffer (HD * LDT each), S^T (BK * LDS), then m, l, alpha
// (BQ each).
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
             int H, int KV, float scale, int causal,
             const int* __restrict__ k_tiles) {
  constexpr int HD = 16 * NC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [HD][LDT]: Q^T
  float* KVs = Qs + HD * LDT;                     // K^T [HD][LDT] / V [BK][HD]
  float* Ss = KVs + HD * LDT;                     // S^T, then P^T [BK][LDS]
  float* m_s = Ss + BK * LDS;                     // running max per row
  float* l_s = m_s + BQ;                          // running denominator
  float* a_s = l_s + BQ;                          // this tile's rescale

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const long long q_step = (long long)H * HD;    // one sequence position
  const long long kv_step = (long long)KV * HD;
  const T* qb = q + ((long long)b * Sq * H + h) * HD;
  const T* kb = k + ((long long)b * Sk * KV + kvh) * HD;
  const T* vb = v + ((long long)b * Sk * KV + kvh) * HD;
  T* ob = o + ((long long)b * Sq * H + h) * HD;
  const int diag = Sk - Sq;                       // query r sees keys <= r+diag

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int i = idx / HD, d = idx % HD;
    Qs[d * LDT + i] = q0 + i < Sq ? to_f(qb[(q0 + i) * q_step + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = MASKED;
    l_s[tid] = 0.f;
  }

  const int nk = k_tiles[blockIdx.x];

  const int ti = tid >> 4, tj = tid & 15;         // 16 x 16 thread grid
  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    const int kn = min(BK, Sk - k0);
    __syncthreads();                              // last tile's P V is done
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      KVs[d * LDT + j] = j < kn ? to_f(kb[(k0 + j) * kv_step + d]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T: rows 4ti..4ti+3, keys 4tj..4tj+3
    {
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(&Qs[d * LDT + 4 * ti]);
        const float4 bk = *reinterpret_cast<const float4*>(&KVs[d * LDT + 4 * tj]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * tj + c;
        float out[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = q0 + 4 * ti + r;
          float sv = s[r][c] * scale;
          if (j >= kn)
            sv = -INFINITY;                       // past the end: no weight
          else if (causal && k0 + j > row + diag)
            sv = MASKED;
          out[r] = sv;
        }
        *reinterpret_cast<float4*>(&Ss[j * LDS + 4 * ti]) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();

    // online softmax: 4 threads a row, 16 keys each
    {
      const int row = tid >> 2, l4 = tid & 3;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c)
        mx = fmaxf(mx, Ss[(l4 + 4 * c) * LDS + row]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) {
        float* p = &Ss[(l4 + 4 * c) * LDS + row];
        const float e = expf(*p - m_new);
        *p = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (l4 == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[row] = alpha;
        l_s[row] = alpha * l_s[row] + sum;
        m_s[row] = m_new;
      }
    }
    // V replaces K^T in the shared buffer (S is done with it)
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      KVs[j * HD + d] = j < kn ? to_f(vb[(k0 + j) * kv_step + d]) : 0.f;
    }
    __syncthreads();

    // O = alpha O + P V: rows 4ti..4ti+3, columns tj + 16c
    {
      float al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) al[r] = a_s[4 * ti + r];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] *= al[r];
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(&Ss[j * LDS + 4 * ti]);
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = KVs[j * HD + tj + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ti + r;
    if (q0 + i >= Sq) continue;
    float l = l_s[i];
    if (l == 0.f) l = 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(q0 + i) * q_step + tj + 16 * c] = from_f<T>(acc[r][c] / l);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int Sq, Sk, H, KV;
  float scale;
  int causal;
  dim3 grid;
  int smem;
  const int* k_tiles;
  cudaStream_t s;
};

template <typename T, int NC>
int launch(const Args& a) {
  static int configured = 0;   // the largest size set so far
  if (a.smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        a.smem);
    if (err != cudaSuccess) return (int)err;
    configured = a.smem;
  }
  flash_kernel<T, NC><<<a.grid, THREADS, a.smem, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.Sq, a.Sk, a.H,
      a.KV, a.scale, a.causal, a.k_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const Args& a, int hd) {
  switch (hd / 16) {
    case 1: return launch<T, 1>(a);
    case 2: return launch<T, 2>(a);
    case 3: return launch<T, 3>(a);
    case 4: return launch<T, 4>(a);
    case 5: return launch<T, 5>(a);
    case 6: return launch<T, 6>(a);
    case 7: return launch<T, 7>(a);
    case 8: return launch<T, 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// hd a multiple of 16 up to 128; dtype 0 = fp32, 1 = bf16; grid, shared
// bytes and the device table k_tiles (grid_x ints) from the caller's plan.
// Returns the cudaError_t of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int Sq, int Sk, int H, int KV, int hd,
                           float scale, int causal, int dtype,
                           int grid_x, int grid_y, int smem,
                           const void* k_tiles, void* stream) {
  if (hd % 16 != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, Sq, Sk, H, KV, scale, causal,
               dim3(grid_x, grid_y), smem,
               static_cast<const int*>(k_tiles),
               static_cast<cudaStream_t>(stream)};
  return dtype == 1 ? launch_hd<__nv_bfloat16>(a, hd) : launch_hd<float>(a, hd);
}

// The tile constants this file is compiled with: BQ, BK, LDT, LDS, THREADS.
void flash_attention_tiles(int* out) {
  out[0] = BQ;
  out[1] = BK;
  out[2] = LDT;
  out[3] = LDS;
  out[4] = THREADS;
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
