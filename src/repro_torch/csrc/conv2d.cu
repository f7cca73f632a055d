// Fused conv2d (+bias)(+relu/relu6)(+VALID maxpool) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py::_conv_kernel:
//   * conv2d_dense_kernel   <- its dense/grouped branch (L464-477) and the
//                              bias/activation/pool epilogue (L478-497);
//   * conv2d_depthwise_kernel <- its depthwise branch (L451-463).
//
// What bounds it on an H100: the dense convs of AlexNet/VGG/MobileNetV2 do
// 10-200 FLOPs per byte they must move, above the fp32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/B), so the dense kernel is bound by arithmetic.
// This first version does that arithmetic on the CUDA cores in fp32 (for
// bf16 storage too: inputs are widened on the way into shared memory), so
// its ceiling is the 67 TFLOP/s fp32 rate, not the tensor cores; wgmma and
// TMA staging are later work.  Short of that ceiling, what limits it is the
// shared-memory loads each FMA needs and, on the deep 7x7-14x14 layers, too
// few outputs to give every SM enough CTAs.  The depthwise 3x3 stencil does
// ~2 FLOPs per byte: it is bound by memory, and runs on the CUDA cores with
// no shared memory, each thread reading its 3x3 window through the L1
// cache.
//
// Design of the dense kernel.  One CTA per (spatial tile, channel block of
// one group, image).  It loops over the group's input channels in chunks:
// each chunk stages the haloed input tile (zero outside the image, which
// replaces the TPU wrapper's jnp.pad and slice-off) and the weight slice
// (channel-minor, so a warp reads its weights as broadcast vector loads) in
// shared memory as fp32; each thread keeps COT x PT fp32 accumulators in
// registers (COT output channels x PT pixels of the conv tile).  The
// planner picks (COT, PT) per launch: 8x2 where the output is large enough
// to fill the card with CTAs, down to 2x1 for the deep 7x7 and 13x13
// layers, whose few outputs would otherwise occupy a handful of SMs (the
// order of each output's sum does not depend on the choice).  When a
// maxpool is fused, the CTA writes its activated conv tile to shared memory
// and takes the max over the pool windows from there; overlapping windows
// (k=3 > s=2) are covered because the conv tile spans (tile-1)*s + k
// rows and columns, and pooled tiles start on window starts.  The launch
// geometry (tiles, chunk, shared-memory bytes) is computed in Python
// (repro_torch/kernels/conv2d.py::plan_conv), where the CPU tests check it.
//
// Invariant: every conv output is summed in fp32 in one fixed order --
// input channel, then kh, then kw, each term one fmaf -- whatever the tile
// geometry, chunking, batch size or pool fusion.  So a fused
// conv->act->pool equals the unfused conv+act followed by a maxpool
// bitwise, and split and monolithic runs give bitwise equal logits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// Index of each field in the int array the Python wrapper passes
// (kept in step with repro_torch/kernels/conv2d.py::_PARAM_FIELDS).
enum Param {
  P_N, P_CIN, P_H, P_W, P_COUT, P_CIN_PG, P_COUT_PG, P_K, P_STRIDE, P_PAD,
  P_ACT, P_POOL_K, P_POOL_S, P_PO, P_PW, P_TILE_OH, P_TILE_OW, P_CONV_TH,
  P_CONV_TW, P_IN_TH, P_IN_TW, P_CI_CHUNK, P_TILES_H, P_TILES_W,
  P_CO_BLOCKS, P_GROUPS, P_SMEM, P_DTYPE, P_DEPTHWISE, P_COT, P_PT, P_COUNT
};

struct ConvArgs {
  int N, Cin, H, W, Cout, cin_pg, cout_pg, K, stride, pad, act, pool_k,
      pool_s, Po, Pw, tile_oh, tile_ow, conv_th, conv_tw, in_th, in_tw,
      ci_chunk, tiles_h, tiles_w, co_blocks, groups;
};

constexpr int TP = 64;              // pixel lanes per CTA
constexpr int TC = 4;               // channel lanes per CTA
constexpr int THREADS = TP * TC;    // 256
constexpr int DW_THREADS = 256;

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

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

// COT output channels x PT conv-tile pixels per thread; a CTA covers
// TC * COT channels and up to TP * PT pixels.  KT is the kernel size when
// it is known at compile time (1 or 3, the taps then unroll), else 0.
template <typename T, int COT, int PT, int KT>
__global__ void __launch_bounds__(THREADS, 2)
conv2d_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y,
                    ConvArgs a) {
  constexpr int CO_BLK = TC * COT;
  constexpr int SB = 4;               // staging loads in flight per thread
  extern __shared__ float smem[];
  const int K = KT ? KT : a.K;
  const int tid = threadIdx.x;
  const int tp = tid % TP;            // a warp shares one channel lane
  const int tc = tid / TP;
  const int th_i = blockIdx.x / a.tiles_w;
  const int tw_i = blockIdx.x % a.tiles_w;
  const int g = blockIdx.y / a.co_blocks;
  const int co_g0 = (blockIdx.y % a.co_blocks) * CO_BLK;  // within group
  const int n = blockIdx.z;
  const int ps = a.pool_k ? a.pool_s : 1;
  // origin of the output tile, of the conv tile, and of the input tile
  const int oh0 = th_i * a.tile_oh, ow0 = tw_i * a.tile_ow;
  const int ih0 = oh0 * ps * a.stride - a.pad;
  const int iw0 = ow0 * ps * a.stride - a.pad;
  const int npix = a.conv_th * a.conv_tw;
  const int in_plane = a.in_th * a.in_tw;
  const int KK = K * K;

  int off[PT];
  bool pvalid[PT];
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int p = tp + k * TP;
    pvalid[k] = p < npix;
    const int r = pvalid[k] ? p / a.conv_tw : 0;
    const int c = pvalid[k] ? p % a.conv_tw : 0;
    off[k] = r * a.stride * a.in_tw + c * a.stride;
  }
  float acc[COT][PT];
#pragma unroll
  for (int j = 0; j < COT; ++j)
#pragma unroll
    for (int k = 0; k < PT; ++k) acc[j][k] = 0.f;

  const T* xn = x + ((size_t)n * a.Cin + (size_t)g * a.cin_pg) * a.H * a.W;
  // weights sit after the input tile, 16-byte aligned, channel-minor:
  // ws[(ci * KK + kk) * CO_BLK + col], so a thread's COT weights for one
  // tap are one or two vector loads (the same address across a warp)
  float* xs = smem;
  float* ws = smem + ((a.ci_chunk * in_plane + 3) & ~3);
  for (int cc = 0; cc < a.cin_pg; cc += a.ci_chunk) {
    const int nci = min(a.ci_chunk, a.cin_pg - cc);
    __syncthreads();                  // previous chunk fully consumed
    // stage the haloed input tile; SB global loads in flight per thread
    // before their stores (few warps per SM: latency must overlap here)
    const int n_in = nci * in_plane;
    for (int i0 = tid; i0 < n_in; i0 += SB * THREADS) {
      float v[SB];
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int i = i0 + u * THREADS;
        v[u] = 0.f;
        if (i < n_in) {
          const int ci = i / in_plane;
          const int rem = i - ci * in_plane;
          const int ih = ih0 + rem / a.in_tw;
          const int iw = iw0 + rem % a.in_tw;
          if (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W)
            v[u] = to_f(xn[((size_t)(cc + ci) * a.H + ih) * a.W + iw]);
        }
      }
#pragma unroll
      for (int u = 0; u < SB; ++u)
        if (i0 + u * THREADS < n_in) xs[i0 + u * THREADS] = v[u];
    }
    const int wrow = nci * KK;        // (ci, kk) taps of this chunk
    // a warp stages 8 channels x 4 taps: 16-byte runs of each global row,
    // and a 4-way (not 32-way) bank conflict on the transposed store
    const int span = CO_BLK * ((wrow + 3) / 4) * 4;
    for (int i0 = tid; i0 < span; i0 += SB * THREADS) {
      float v[SB];
      int dst[SB];
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int i = i0 + u * THREADS;
        const int lane = i & 31, blk = i >> 5;
        const int col = (blk % (CO_BLK / 8)) * 8 + (lane & 7);
        const int tap = (blk / (CO_BLK / 8)) * 4 + (lane >> 3);
        const int co = co_g0 + col;
        v[u] = 0.f;
        dst[u] = (i < span && tap < wrow) ? tap * CO_BLK + col : -1;
        if (dst[u] >= 0 && co < a.cout_pg)
          v[u] = to_f(w[((size_t)(g * a.cout_pg + co) * a.cin_pg + cc) * KK
                        + tap]);
      }
#pragma unroll
      for (int u = 0; u < SB; ++u)
        if (dst[u] >= 0) ws[dst[u]] = v[u];
    }
    __syncthreads();
#pragma unroll (KT == 1 ? 4 : 1)
    for (int ci = 0; ci < nci; ++ci) {
      const float* xc = xs + ci * in_plane;
      const float* wc = ws + ci * KK * CO_BLK + tc * COT;
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const int xo = kh * a.in_tw + kw;
          const float* wt = wc + (kh * K + kw) * CO_BLK;
          float wv[COT], xv[PT];
          if constexpr (COT % 4 == 0) {
#pragma unroll
            for (int j = 0; j < COT; j += 4) {
              const float4 v4 = *reinterpret_cast<const float4*>(wt + j);
              wv[j] = v4.x; wv[j + 1] = v4.y; wv[j + 2] = v4.z;
              wv[j + 3] = v4.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < COT; j += 2) {
              const float2 v2 = *reinterpret_cast<const float2*>(wt + j);
              wv[j] = v2.x; wv[j + 1] = v2.y;
            }
          }
#pragma unroll
          for (int k = 0; k < PT; ++k) xv[k] = xc[off[k] + xo];
#pragma unroll
          for (int j = 0; j < COT; ++j)
#pragma unroll
            for (int k = 0; k < PT; ++k)
              acc[j][k] = fmaf(wv[j], xv[k], acc[j][k]);
        }
      }
    }
  }

  // epilogue: fp32 bias, then the activation
#pragma unroll
  for (int j = 0; j < COT; ++j) {
    const int co = co_g0 + tc * COT + j;
    const float b = (bias != nullptr && co < a.cout_pg)
                        ? bias[g * a.cout_pg + co] : 0.f;
#pragma unroll
    for (int k = 0; k < PT; ++k) acc[j][k] = activate(acc[j][k] + b, a.act);
  }
  T* yn = y + ((size_t)n * a.Cout + (size_t)g * a.cout_pg) * a.Po * a.Pw;
  if (!a.pool_k) {
#pragma unroll
    for (int j = 0; j < COT; ++j) {
      const int co = co_g0 + tc * COT + j;
      if (co >= a.cout_pg) continue;
#pragma unroll
      for (int k = 0; k < PT; ++k) {
        if (!pvalid[k]) continue;
        const int p = tp + k * TP;
        const int oh = oh0 + p / a.conv_tw, ow = ow0 + p % a.conv_tw;
        if (oh < a.Po && ow < a.Pw)
          yn[((size_t)co * a.Po + oh) * a.Pw + ow] = from_f<T>(acc[j][k]);
      }
    }
    return;
  }
  // fused maxpool from the activated fp32 conv tile in shared memory
  __syncthreads();
  float* tile = smem;                 // CO_BLK x npix
#pragma unroll
  for (int j = 0; j < COT; ++j)
#pragma unroll
    for (int k = 0; k < PT; ++k)
      if (pvalid[k]) tile[(tc * COT + j) * npix + tp + k * TP] = acc[j][k];
  __syncthreads();
  const int tile_np = a.tile_oh * a.tile_ow;
  for (int i = tid; i < CO_BLK * tile_np; i += THREADS) {
    const int col = i / tile_np;
    const int rem = i - col * tile_np;
    const int pr = rem / a.tile_ow, pc = rem % a.tile_ow;
    const int co = co_g0 + col;
    const int oh = oh0 + pr, ow = ow0 + pc;
    if (co >= a.cout_pg || oh >= a.Po || ow >= a.Pw) continue;
    const float* t = tile + col * npix + (pr * ps) * a.conv_tw + pc * ps;
    float m = -INFINITY;
    for (int ph = 0; ph < a.pool_k; ++ph)
      for (int pw = 0; pw < a.pool_k; ++pw)
        m = fmaxf(m, t[ph * a.conv_tw + pw]);
    yn[((size_t)co * a.Po + oh) * a.Pw + ow] = from_f<T>(m);
  }
}

// One thread per output element (pooled when a pool is fused; each pool
// window's conv values are recomputed, which the stencil's low arithmetic
// cost allows).  Channel c reads input channel c: multiplier 1 only.
template <typename T>
__device__ __forceinline__ float dw_point(const T* __restrict__ xc,
                                          const float* wk, float b, int r,
                                          int col, const ConvArgs& a) {
  float acc = 0.f;
  const int ih0 = r * a.stride - a.pad, iw0 = col * a.stride - a.pad;
  for (int kh = 0; kh < a.K; ++kh) {
    const int ih = ih0 + kh;
    for (int kw = 0; kw < a.K; ++kw) {
      const int iw = iw0 + kw;
      const float v = (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W)
                          ? to_f(__ldg(xc + (size_t)ih * a.W + iw)) : 0.f;
      acc = fmaf(wk[kh * a.K + kw], v, acc);
    }
  }
  return activate(acc + b, a.act);
}

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
conv2d_depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ bias, T* __restrict__ y,
                        ConvArgs a) {
  const size_t total = (size_t)a.N * a.Cout * a.Po * a.Pw;
  const size_t i = (size_t)blockIdx.x * DW_THREADS + threadIdx.x;
  if (i >= total) return;
  const int ow = (int)(i % a.Pw);
  const int oh = (int)((i / a.Pw) % a.Po);
  const size_t nc = i / ((size_t)a.Pw * a.Po);
  const int c = (int)(nc % a.Cout);
  const T* xc = x + nc * a.H * a.W;
  float wk[49];                        // K <= 7, checked by the wrapper
  for (int k = 0; k < a.K * a.K; ++k) wk[k] = to_f(w[(size_t)c * a.K * a.K + k]);
  const float b = bias != nullptr ? bias[c] : 0.f;
  float out;
  if (!a.pool_k) {
    out = dw_point(xc, wk, b, oh, ow, a);
  } else {
    out = -INFINITY;
    for (int ph = 0; ph < a.pool_k; ++ph)
      for (int pw = 0; pw < a.pool_k; ++pw)
        out = fmaxf(out, dw_point(xc, wk, b, oh * a.pool_s + ph,
                                  ow * a.pool_s + pw, a));
  }
  y[i] = from_f<T>(out);
}

template <typename T, int COT, int PT, int KT>
cudaError_t launch_dense_k(const T* x, const T* w, const float* b, T* y,
                           const ConvArgs& a, int smem, cudaStream_t stream) {
  // raise the kernel's dynamic shared-memory cap once per new high-water
  // mark (not on every launch: a launch may be under CUDA-graph capture)
  static int smem_cap = 48 * 1024;
  if (smem > smem_cap) {
    cudaError_t err = cudaFuncSetAttribute(
        conv2d_dense_kernel<T, COT, PT, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_cap = smem;
  }
  dim3 grid(a.tiles_h * a.tiles_w, a.groups * a.co_blocks, a.N);
  conv2d_dense_kernel<T, COT, PT, KT><<<grid, THREADS, smem, stream>>>(
      x, w, b, y, a);
  return cudaGetLastError();
}

template <typename T, int COT, int PT>
cudaError_t launch_dense(const T* x, const T* w, const float* b, T* y,
                         const ConvArgs& a, int smem, cudaStream_t stream) {
  if (a.K == 1)
    return launch_dense_k<T, COT, PT, 1>(x, w, b, y, a, smem, stream);
  if (a.K == 3)
    return launch_dense_k<T, COT, PT, 3>(x, w, b, y, a, smem, stream);
  return launch_dense_k<T, COT, PT, 0>(x, w, b, y, a, smem, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   const ConvArgs& a, const int* p, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  if (p[P_DEPTHWISE]) {
    const size_t total = (size_t)a.N * a.Cout * a.Po * a.Pw;
    const unsigned blocks = (unsigned)((total + DW_THREADS - 1) / DW_THREADS);
    conv2d_depthwise_kernel<T><<<blocks, DW_THREADS, 0, stream>>>(
        xt, wt, bt, yt, a);
    return cudaGetLastError();
  }
  const int smem = p[P_SMEM];
  // the (COT, PT) blockings the planner may pick
  switch (p[P_COT] * 10 + p[P_PT]) {
    case 82: return launch_dense<T, 8, 2>(xt, wt, bt, yt, a, smem, stream);
    case 81: return launch_dense<T, 8, 1>(xt, wt, bt, yt, a, smem, stream);
    case 41: return launch_dense<T, 4, 1>(xt, wt, bt, yt, a, smem, stream);
    case 21: return launch_dense<T, 2, 1>(xt, wt, bt, yt, a, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// p: the P_COUNT ints of enum Param; dtype 0 = fp32, 1 = bf16.
// Returns the cudaError_t of the launch (0 when it was accepted).
int conv2d_launch(const void* x, const void* w, const void* bias, void* y,
                  const int* p, void* stream) {
  ConvArgs a;
  a.N = p[P_N]; a.Cin = p[P_CIN]; a.H = p[P_H]; a.W = p[P_W];
  a.Cout = p[P_COUT]; a.cin_pg = p[P_CIN_PG]; a.cout_pg = p[P_COUT_PG];
  a.K = p[P_K]; a.stride = p[P_STRIDE]; a.pad = p[P_PAD]; a.act = p[P_ACT];
  a.pool_k = p[P_POOL_K]; a.pool_s = p[P_POOL_S]; a.Po = p[P_PO];
  a.Pw = p[P_PW]; a.tile_oh = p[P_TILE_OH]; a.tile_ow = p[P_TILE_OW];
  a.conv_th = p[P_CONV_TH]; a.conv_tw = p[P_CONV_TW]; a.in_th = p[P_IN_TH];
  a.in_tw = p[P_IN_TW]; a.ci_chunk = p[P_CI_CHUNK]; a.tiles_h = p[P_TILES_H];
  a.tiles_w = p[P_TILES_W]; a.co_blocks = p[P_CO_BLOCKS];
  a.groups = p[P_GROUPS];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p[P_DTYPE] == 1)
    return (int)launch<__nv_bfloat16>(x, w, bias, y, a, p, s);
  return (int)launch<float>(x, w, bias, y, a, p, s);
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
