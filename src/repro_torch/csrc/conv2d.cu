// Fused conv2d (+bias)(+relu/relu6)(+VALID maxpool) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py::_conv_kernel:
//   * conv2d_dense_kernel     <- its dense/grouped branch (L464-477) and
//                                the bias/activation/pool epilogue
//                                (L478-497);
//   * conv2d_dense_ws_kernel  <- the same, for the bf16 convs whose tiles
//                                fill (VGG's 3x3 convs with Cin >= 64);
//   * conv2d_depthwise_kernel <- its depthwise branch (L451-463).
//
// What bounds them on an H100.  The dense convs of AlexNet and
// MobileNetV2 do 10-200 FLOPs per byte they must move, VGG's 3x3 convs
// ~250-1000.  In fp32 storage the products run as three TF32 tensor-core
// passes (495 TFLOP/s each, 165 effective), in bf16 as one bf16 pass
// (989 TFLOP/s): VGG's and AlexNet's convs are then bound by operations,
// MobileNetV2's pointwise convs by bytes (3.35 TB/s), and the deep
// 7x7-14x14 layers by having too few output tiles to fill 132 SMs.  The
// depthwise 3x3 stencil does ~2 FLOPs per byte: it is bound by memory.
// Measured, the one-warpgroup dense kernel is far from its bound: a stage
// is bound by the latency of its own staging, barriers and gather, which
// one warpgroup runs in turn.  The warp-specialised kernel takes the
// staging off the threads that multiply; what bounds it is shared memory
// (each stage's weight slice is read by both consumers' wgmma and written
// by TMA, and the im2col gather reads 2 bytes a lane) and, on the 28- and
// 14-wide layers, the producers' cp.async (PERF.md).
//
// Dense design: an implicit GEMM on wgmma.  M = the BM=64 pixels of one
// rectangular conv tile of one image (for a fused pool the tile covers
// whole pool windows), N = a block of BN output channels of one group
// (BN = 16, 32 or 64, picked per launch by the planner), K = the
// cin_pg*K*K taps in OIHW's flat (ci, kh, kw) order, so a weight row is
// K-major as it lies in memory.  One warpgroup (128 threads) per CTA.  K
// is walked in stages of BK=64 taps through a ring of nstage (2-4) shared
// slots: nstage - 1 stages are in flight while one is multiplied.  A slot
// holds the haloed input planes of the channels its taps read (copied
// with cp.async, zero-filled outside the image, which replaces the TPU
// wrapper's jnp.pad and every bounds check), a table of each tap's
// offset in those planes, and the BN x BK weight slice in wgmma's
// no-swizzle K-major layout (8x16-byte core matrices).  Each thread walks
// the taps by adding per-conv constants, never dividing.  The A operand
// (im2col) is gathered from the staged planes straight into registers in
// wgmma's A-fragment layout (tf32 wgmma wants K-major shared operands,
// which im2col is not): element (m, k) is plane[pix(m) + tap(k)].  A
// stage's gather is unrolled without a branch, then its products issue
// back to back under one wait.  B is read by the descriptor.  fp32
// storage: each value is split with cvt.rna.tf32.f32 into big = tf32(v)
// and small = tf32(v - big) (A in registers; B into the slot and a second
// buffer, from registers loaded a stage early where weight rows are
// 16-byte runs, else by a pass over the slot), and each k-step issues
// small*big, big*small, big*big, in that order, into one fp32
// accumulator.  bf16 storage: one bf16 wgmma a k-step, fp32 accumulation
// (its products are exact in fp32).  Epilogue: fp32 bias, activation,
// then the tile goes through shared memory (channel-major) for coalesced
// stores, or for the maxpool over the tile's windows (overlapping windows
// included).  Where rows, planes and weights are aligned, the planner
// picks 16- or 8-byte copies (vec_x, vec_b); this kernel uses no TMA: the
// 13-, 27-, 55-, 7- and 14-wide NCHW rows and the Cin=3 weight rows break
// its 16-byte stride rule.  The launch geometry (tiles, K decomposition, ring
// depth, slot layout, shared bytes, the divisors' magic numbers) is
// computed in Python (repro_torch/kernels/conv2d.py::plan_conv), where
// the CPU tests check it; this file computes none of it.
//
// Warp-specialised design (bf16 storage): one CTA of three warpgroups
// computes a tile of WS_BM = 128 conv pixels (two consumers of 64 rows)
// by BN = 64, 128 or 256 channels, K in the same stages of BK = 64 taps
// through a ring of nstage slots, each slot the stage's weight slice and
// its planes, handed over by full and empty mbarriers (no block-wide
// barrier in the loop).  The producer warpgroup fills the ring ahead of
// the consumers: thread 0 has TMA copy the weight slice (a (Cout, ktot)
// tensor map, 128-byte swizzle, zero past Cout) and, where image rows are
// whole 16-byte copies (W % 8 == 0), the stage's planes (an (N, Cin, H, W)
// map's box; TMA zero-fills outside the image); else every producer copies
// the planes with cp.async (4- or 8-byte copies, counted on the slot's
// mbarrier).  Each consumer gathers its rows of the stage's im2col tile
// from the planes into registers in wgmma's A-fragment layout, k-step by
// k-step, each k-step's gather running under the previous k-step's
// product (two stages' fragments, so a stage's gather also runs under
// the previous stage), and issues m64nBNk16 bf16 wgmma with B by the
// swizzled descriptor; wgmma_wait<1> keeps one stage's products in flight.
// Each stage's tap offsets come from one of tperiod tables made once a
// CTA (the taps repeat, shifted by whole channels, every lcm(BK, K*K)
// taps).  The epilogue is the one-warpgroup kernel's over 128 pixels and
// eight warps.  The tensor maps are encoded on the host at each launch
// (cuTensorMapEncodeTiled from the driver the runtime loaded).
//
// Summation contract (dense).  Each output is its fp32 sum over the flat
// tap index k, in k-steps of the wgmma depth (8 taps for tf32, 16 for
// bf16) taken in ascending order from tap 0, zero-padded at the end to a
// whole stage (the padding adds exact zeros); each fp32 k-step adds its
// three TF32 passes in the order above.  The k-steps, the stage
// boundaries (whole k-steps, every BK taps) and the split-K segments
// (one: there is no split-K) are functions of the weight shape and dtype
// alone, never of batch, spatial tile, BN, ring depth or pool fusion; the
// tensor cores sum an element the same way whatever its row or column in
// the tile, the wgmma's N, and whether A comes from registers or shared
// memory.  So a fused conv->act->pool equals the unfused conv+act
// followed by a maxpool bitwise, a batch-4 launch equals four batch-1
// launches bitwise, split and monolithic runs give bitwise equal logits,
// and the warp-specialised kernel's outputs equal the one-warpgroup
// kernel's bitwise (both sum each output in the same k-steps).
//
// Depthwise design: a shared-memory stencil.  One CTA (256 threads) per
// (spatial tile, block of cb channels, image) stages each channel's
// haloed input tile once (cp.async zero-fill for fp32; bf16 is widened
// on the way in) and its weights; each thread computes strips of 4
// outputs along a row, its K*K weights and its window rows in registers
// (K=3 at stride 1 or 2 is compiled for its shape, reading the window as
// float4s; other K <= 7 take a generic path).  A fused pool reads the
// activated conv tile from shared memory.  Per output the arithmetic is
// fmaf over kh then kw from 0, then + bias, then the activation, as in
// the CUDA-core kernel it replaces, so its outputs are bitwise the same.
#include <math.h>
#include <string.h>

#include <cuda.h>   // CUtensorMap; the encoder is found at run time

#include "hopper.cuh"

namespace {

// Index of each field in the int array the Python wrapper passes (kept
// in step with repro_torch/kernels/conv2d.py::_PARAM_FIELDS; ConvArgs
// holds the same fields in the same order).
enum Param {
  P_N, P_CIN, P_H, P_W, P_COUT, P_CIN_PG, P_COUT_PG, P_K, P_STRIDE, P_PAD,
  P_ACT, P_POOL_K, P_POOL_S, P_HO, P_WO, P_PO, P_PW, P_GROUPS, P_DTYPE,
  P_DEPTHWISE, P_TILE_OH, P_TILE_OW, P_CONV_TH, P_CONV_TW, P_IN_TH, P_IN_TW,
  P_TILES_H, P_TILES_W, P_CO_BLOCKS, P_SMEM, P_BN, P_KTOT, P_BK, P_STAGES,
  P_NSTAGE, P_CHMAX, P_PITCH, P_MAGIC, P_VEC_X, P_VEC_B, P_SLOT, P_OFF_B,
  P_OFF_BS, P_OFF_TAB, P_OFF_PX, P_OFF_TOFF, P_KQ, P_KR, P_CI_LAST, P_CB,
  P_KT, P_PITCH_W, P_OFF_W, P_OFF_CT, P_MAGIC_W, P_MAGIC_PC, P_MAGIC_NS,
  P_WS, P_RP, P_EC, P_RC, P_MAGIC_RC, P_MAGIC_CR, P_OFF_PL, P_PSLOT,
  P_OFF_BAR, P_TPERIOD,
  P_COUNT
};

struct ConvArgs {
  int N, Cin, H, W, Cout, cin_pg, cout_pg, K, stride, pad, act, pool_k,
      pool_s, Ho, Wo, Po, Pw, groups, dtype, depthwise, tile_oh, tile_ow,
      conv_th, conv_tw, in_th, in_tw, tiles_h, tiles_w, co_blocks, smem, bn,
      ktot, bk, stages, nstage, chmax, pitch, magic, vec_x, vec_b, slot,
      off_b, off_bs, off_tab, off_px, off_toff, kq, kr, ci_last, cb, kt,
      pitch_w, off_w, off_ct, magic_w, magic_pc, magic_ns, ws, rp, ec, rc,
      magic_rc, magic_cr, off_pl, pslot, off_bar, tperiod;
};
static_assert(sizeof(ConvArgs) == P_COUNT * sizeof(int),
              "ConvArgs must mirror enum Param");

constexpr int BM = 64;              // dense: conv pixels a CTA
static_assert(BM == 4 * 16, "one warpgroup: 4 warps of 16 A rows");
constexpr int THREADS = 128;        // dense: one warpgroup
constexpr int BK = 64;              // dense: taps a stage
constexpr int EPI_PITCH = 68;       // dense: floats per epilogue row
constexpr int DW_THREADS = 256;
constexpr int DW_VEC = 4;           // depthwise: outputs a strip

template <typename T> struct Store;
template <> struct Store<float> {
  static constexpr int KSTEP = 8;   // taps of one tf32 wgmma
  static constexpr int E = 4;       // elements of a 16-byte copy
};
template <> struct Store<__nv_bfloat16> {
  static constexpr int KSTEP = 16;
  static constexpr int E = 8;
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

// Up to U elements into shared memory, zero where !valid (a null dst is
// skipped): cp.async for 4-byte elements; for bf16 (cp.async copies 4
// bytes at least) U loads in flight, then U stores.
template <typename T, int U> struct Staged;
template <int U> struct Staged<float, U> {
  __device__ __forceinline__ void put(int, float* dst, const float* src,
                                      bool valid) {
    if (dst != nullptr) cp_async4(dst, src, valid);
  }
  __device__ __forceinline__ void land() {}
};
template <int U> struct Staged<__nv_bfloat16, U> {
  unsigned short v[U];
  unsigned short* d[U];
  __device__ __forceinline__ void put(int u, __nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool valid) {
    d[u] = reinterpret_cast<unsigned short*>(dst);
    v[u] = (dst != nullptr && valid)
               ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
  }
  __device__ __forceinline__ void land() {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (d[u] != nullptr) *d[u] = v[u];
  }
};

// Where a stage's taps lie, walked one stage at a time without a
// division: (channel, tap within the channel) of its first tap, its last
// tap and this thread's tap (k0 + tid, tid < BK).
struct TapWalk {
  int c_lo, r_lo, c_hi, r_hi, cj, rj;
  __device__ __forceinline__ void init(const ConvArgs& a, int tid) {
    const int KK = a.K * a.K;
    c_lo = 0; r_lo = 0;
    c_hi = (BK - 1) / KK; r_hi = (BK - 1) % KK;
    cj = tid / KK; rj = tid % KK;
  }
  __device__ __forceinline__ static void step(int& c, int& r,
                                              const ConvArgs& a, int KK) {
    c += a.kq; r += a.kr;             // BK = kq * KK + kr
    if (r >= KK) { r -= KK; ++c; }
  }
  __device__ __forceinline__ void next(const ConvArgs& a) {
    const int KK = a.K * a.K;
    step(c_lo, r_lo, a, KK); step(c_hi, r_hi, a, KK); step(cj, rj, a, KK);
  }
};

// Copy the stage of taps [k0, k0 + BK) into slot `slot`: the input
// planes of the channels those taps read, the taps' offsets in them, and
// the BN x BK weight slice.  Issued by all threads; fp32 copies and the
// 16-byte ones are cp.async.
template <typename T, int BN>
__device__ __forceinline__ void issue_stage(
    unsigned char* smem, const ConvArgs& a, int slot, int k0,
    const TapWalk& tw, const T* __restrict__ xg, const T* __restrict__ wg,
    int co0, const int* pxtab, const int* toff, size_t hw, bool with_b) {
  constexpr int ES = sizeof(T), E = Store<T>::E, KSTEP = Store<T>::KSTEP;
  constexpr int SB = 8;               // bf16: loads in flight per thread
  const int tid = threadIdx.x;
  unsigned char* sl = smem + slot * a.slot;
  T* xs = reinterpret_cast<T*>(sl);
  int* tab = reinterpret_cast<int*>(sl + a.off_tab);
  const int c_lo = tw.c_lo;
  const int nch = min(tw.c_hi, a.ci_last) + 1 - c_lo;
  const int in_plane = a.in_th * a.in_tw;
  const uint32_t magic = static_cast<uint32_t>(a.magic);
  const T* xc = xg + (size_t)c_lo * hw;
  const int total = nch * in_plane;
  if (a.vec_x == 2) {
    // whole images, planes back to back: the stage is one aligned run
    for (int i = tid * E; i + E <= total; i += THREADS * E)
      cp_async16(xs + i, xc + i, true);
    const int tail = total - total % E;
    Staged<T, 1> st;
    const int i = tail + tid;
    st.put(0, i < total ? xs + i : nullptr, xc + i, true);
    st.land();
  } else if (a.vec_x == 1) {
    // whole image rows: a plane's staged elements are aligned runs
    for (int i = tid * E; i < total; i += THREADS * E) {
      const int cl = in_plane == 1 ? i : __umulhi(i, magic);
      const int e = i - cl * in_plane;
      const int go = pxtab[e];
      cp_async16(xs + cl * a.pitch + e, xc + cl * hw + max(go, 0), go >= 0);
    }
  } else if (a.vec_x == 3) {
    // the same in 8-byte runs (rows and planes 8- but not 16-byte aligned)
    constexpr int E8 = 8 / ES;
    for (int i = tid * E8; i < total; i += THREADS * E8) {
      const int cl = in_plane == 1 ? i : __umulhi(i, magic);
      const int e = i - cl * in_plane;
      const int go = pxtab[e];
      cp_async8(xs + cl * a.pitch + e, xc + cl * hw + max(go, 0), go >= 0);
    }
  } else {
    for (int i0 = tid; i0 < total; i0 += SB * THREADS) {
      Staged<T, SB> st;
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int i = i0 + u * THREADS;
        const int cl = in_plane == 1 ? i : __umulhi(i, magic);
        const int e = i - cl * in_plane;
        const int go = i < total ? pxtab[e] : -1;
        st.put(u, i < total ? xs + cl * a.pitch + e : nullptr,
               xc + cl * hw + max(go, 0), go >= 0);
      }
      st.land();
    }
  }
  if (tid < BK)                       // -1: a padding tap, reads as zero
    tab[tid] = k0 + tid < a.ktot ? (tw.cj - c_lo) * a.pitch + toff[tw.rj]
                                 : -1;
  unsigned char* bs = sl + a.off_b;
  if (!with_b) return;
  if (a.vec_b) {
    // lanes take 8 rows x 16 bytes: one core matrix, no bank conflict
    for (int i = tid; i < BN * BK / E; i += THREADS) {
      const int rest = i >> 3;
      const int n = (rest / (BK / E)) * 8 + (i & 7);
      const int kl = (rest % (BK / E)) * E, k = k0 + kl;
      const bool ok = co0 + n < a.cout_pg && k < a.ktot;
      cp_async16(bs + b_off<BN, ES, KSTEP>(n, kl),
                 wg + (ok ? (size_t)n * a.ktot + k : 0), ok);
    }
  } else {
    for (int i0 = tid; i0 < BN * BK; i0 += SB * THREADS) {
      Staged<T, SB> st;
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int i = i0 + u * THREADS;
        const int rest = i / (8 * E);
        const int n = (rest / (BK / E)) * 8 + (i / E) % 8;
        const int kl = (rest % (BK / E)) * E + i % E, k = k0 + kl;
        const bool ok = co0 + n < a.cout_pg && k < a.ktot;
        st.put(u, i < BN * BK
                      ? reinterpret_cast<T*>(bs + b_off<BN, ES, KSTEP>(n, kl))
                      : nullptr,
               wg + (ok ? (size_t)n * a.ktot + k : 0), ok);
      }
      st.land();
    }
  }
}

// fp32 weights with 16-byte rows skip the slot's split pass: a stage's
// slice is loaded into registers one stage early (while the current stage
// is multiplied), then split into big and small and stored.  Thread tid
// holds chunks tid + q * THREADS of the slice, 4 taps of one row each.
template <int BN>
struct WeightRegs {
  static constexpr int NQ = BN * BK / 4 / THREADS;
  float4 v[NQ];
  unsigned ok = 0;                    // bit q: chunk q is real weights
  __device__ __forceinline__ static void at(int q, int& n, int& kl) {
    const int i = threadIdx.x + q * THREADS, rest = i >> 3;
    n = (rest / (BK / 4)) * 8 + (i & 7);
    kl = (rest % (BK / 4)) * 4;
  }
  __device__ __forceinline__ void load(const ConvArgs& a, const float* wg,
                                       int co0, int k0) {
    // load from a valid address either way and zero at store time: a
    // select here would wait for the load
    ok = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      int n, kl;
      at(q, n, kl);
      const int k = k0 + kl;
      const bool real = co0 + n < a.cout_pg && k < a.ktot;
      ok |= (unsigned)real << q;
      v[q] = __ldg(reinterpret_cast<const float4*>(
          wg + (real ? (size_t)n * a.ktot + k : 0)));
    }
  }
  __device__ __forceinline__ void store(const ConvArgs& a,
                                        unsigned char* sl) const {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      int n, kl;
      at(q, n, kl);
      const int off = b_off<BN, 4, 8>(n, kl);
      const float4 x = (ok >> q) & 1 ? v[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 big, small;
      big.x = __uint_as_float(tf32_rna(x.x));
      big.y = __uint_as_float(tf32_rna(x.y));
      big.z = __uint_as_float(tf32_rna(x.z));
      big.w = __uint_as_float(tf32_rna(x.w));
      small.x = __uint_as_float(tf32_rna(x.x - big.x));
      small.y = __uint_as_float(tf32_rna(x.y - big.y));
      small.z = __uint_as_float(tf32_rna(x.z - big.z));
      small.w = __uint_as_float(tf32_rna(x.w - big.w));
      *reinterpret_cast<float4*>(sl + a.off_b + off) = big;
      *reinterpret_cast<float4*>(sl + a.off_bs + off) = small;
    }
  }
};

// One stage's products: gather the A fragments of its k-steps (all loads
// independent), then issue their wgmmas back to back under one commit.
// The caller waits.
template <typename T, int BN, int SK>
__device__ __forceinline__ void stage_mma(float* acc, const T* xs,
                                          const int* tab, const int* pix,
                                          int t4, uint32_t bbig,
                                          uint32_t bsmall) {
  constexpr bool F32 = sizeof(T) == 4;
    // gather the stage's A fragments (all loads independent), then
    // issue its products back to back under one wait
    uint32_t fb[SK][4], fs[SK][4];
#pragma unroll
    for (int j = 0; j < SK; ++j) {
      if constexpr (F32) {
        const int o0 = tab[j * 8 + t4], o1 = tab[j * 8 + t4 + 4];
        float v[4];
        v[0] = o0 >= 0 ? xs[pix[0] + o0] : 0.f;
        v[1] = o0 >= 0 ? xs[pix[1] + o0] : 0.f;
        v[2] = o1 >= 0 ? xs[pix[0] + o1] : 0.f;
        v[3] = o1 >= 0 ? xs[pix[1] + o1] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fb[j][q] = tf32_rna(v[q]);
          fs[j][q] = tf32_rna(v[q] - __uint_as_float(fb[j][q]));
        }
      } else {
        const unsigned short* xu =
            reinterpret_cast<const unsigned short*>(xs);
        const int kb = j * 16 + 2 * t4;
        const int o[4] = {tab[kb], tab[kb + 1], tab[kb + 8], tab[kb + 9]};
        uint32_t u[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            u[h][q] = o[q] >= 0 ? xu[pix[h] + o[q]] : 0u;
        fb[j][0] = u[0][0] | (u[0][1] << 16);
        fb[j][1] = u[1][0] | (u[1][1] << 16);
        fb[j][2] = u[0][2] | (u[0][3] << 16);
        fb[j][3] = u[1][2] | (u[1][3] << 16);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < SK; ++j) {
      const uint64_t db = b_desc(bbig + j * BN * 32);
      if constexpr (F32) {
        const uint64_t ds = b_desc(bsmall + j * BN * 32);
        mma_tf32<BN>(acc, fs[j], db);   // small * big
        mma_tf32<BN>(acc, fb[j], ds);   // big * small
        mma_tf32<BN>(acc, fb[j], db);   // big * big
      } else {
        mma_bf16<BN>(acc, fb[j], db);
      }
    }
    wgmma_commit();
}

// One CTA: a BM-pixel conv tile x BN output channels of group g, image n.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
conv2d_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y,
                    ConvArgs a) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int KSTEP = Store<T>::KSTEP;
  constexpr int SK = BK / KSTEP;      // k-steps a stage
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  const int th_i = blockIdx.x / a.tiles_w, tw_i = blockIdx.x % a.tiles_w;
  const int g = blockIdx.y / a.co_blocks;
  const int co0 = (blockIdx.y % a.co_blocks) * BN;     // within group
  const int n = blockIdx.z;
  const int ps = a.pool_k ? a.pool_s : 1;
  const int oh0 = th_i * a.tile_oh, ow0 = tw_i * a.tile_ow;
  const int ih0 = oh0 * ps * a.stride - a.pad;
  const int iw0 = ow0 * ps * a.stride - a.pad;
  const int npix = a.conv_th * a.conv_tw;
  const int in_plane = a.in_th * a.in_tw;
  const size_t hw = (size_t)a.H * a.W;
  const T* xg = x + ((size_t)n * a.Cin + (size_t)g * a.cin_pg) * hw;
  const T* wg = w + ((size_t)g * a.cout_pg + co0) * a.ktot;

  // where each staged element of a plane lies in the image (-1: outside),
  // and each tap's offset inside a plane
  int* pxtab = reinterpret_cast<int*>(smem + a.off_px);
  int* toff = reinterpret_cast<int*>(smem + a.off_toff);
  for (int e = tid; e < in_plane; e += THREADS) {
    const int r = e / a.in_tw;
    const int ih = ih0 + r, iw = iw0 + e - r * a.in_tw;
    pxtab[e] = (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W)
                   ? ih * a.W + iw : -1;
  }
  for (int r = tid; r < a.K * a.K; r += THREADS)
    toff[r] = (r / a.K) * a.in_tw + r % a.K;
  // this thread's two A rows: offsets of their windows in a plane
  int pix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = warp * 16 + (lane >> 2) + 8 * h;
    const int r = m < npix ? m / a.conv_tw : 0;
    const int c = m < npix ? m - r * a.conv_tw : 0;
    pix[h] = r * a.stride * a.in_tw + c * a.stride;
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  TapWalk walk;
  walk.init(a, tid);
  __syncthreads();

  // the ring: nstage - 1 stages in flight while one is multiplied; one
  // copy group per stage (empty past the last), so waiting for all but
  // the newest nstage - 2 groups waits for stage s
  const int ns = a.nstage;
  int fill = 0;                       // the next stage to copy, its slot
  int fill_slot = 0;
  // fp32 weights through registers where their rows are 16-byte runs
  const bool wregs = F32 && a.vec_b;
  WeightRegs<BN> wr;
  // iterations -(ns - 1) .. -1 only fill the ring (one issue site keeps
  // the loop's code small)
  int slot = 0;
  for (int s = 1 - ns; s < a.stages; ++s) {
    if (s >= 0) {
      cp_async_wait_upto(ns - 2);
      fence_proxy_async();            // this thread's copies, to wgmma
      __syncthreads();                // everyone's; the last slot is free
    }
    const bool filling = fill < a.stages;
    unsigned char* fsl = smem + fill_slot * a.slot;
    if (filling) {
      issue_stage<T, BN>(smem, a, fill_slot, fill * BK, walk, xg, wg, co0,
                         pxtab, toff, hw, !wregs);
      if constexpr (F32) {
        if (wregs)
          wr.load(a, reinterpret_cast<const float*>(wg), co0, fill * BK);
      }
    }
    walk.next(a);
    ++fill;
    fill_slot = fill_slot + 1 == ns ? 0 : fill_slot + 1;
    cp_async_commit();
    if (s < 0) {
      if constexpr (F32) {
        if (wregs && filling) wr.store(a, fsl);
      }
      continue;
    }
    unsigned char* sl = smem + slot * a.slot;
    slot = slot + 1 == ns ? 0 : slot + 1;
    if (F32 && !wregs) {
      // split B into big (in place) and small halves for 3xTF32
      float4* bb = reinterpret_cast<float4*>(sl + a.off_b);
      float4* bsm = reinterpret_cast<float4*>(sl + a.off_bs);
      for (int i = tid; i < BN * BK / 4; i += THREADS) {
        const float4 v = bb[i];
        float4 big, small;
        big.x = __uint_as_float(tf32_rna(v.x));
        big.y = __uint_as_float(tf32_rna(v.y));
        big.z = __uint_as_float(tf32_rna(v.z));
        big.w = __uint_as_float(tf32_rna(v.w));
        small.x = __uint_as_float(tf32_rna(v.x - big.x));
        small.y = __uint_as_float(tf32_rna(v.y - big.y));
        small.z = __uint_as_float(tf32_rna(v.z - big.z));
        small.w = __uint_as_float(tf32_rna(v.w - big.w));
        bb[i] = big;
        bsm[i] = small;
      }
      fence_proxy_async();
      __syncthreads();
    }

    const T* xs = reinterpret_cast<const T*>(sl);
    const int* tab = reinterpret_cast<const int*>(sl + a.off_tab);
    const uint32_t bbig = smem_addr(sl + a.off_b);
    const uint32_t bsmall = smem_addr(sl + a.off_bs);
    // every stage runs its SK k-steps unrolled without a branch; past
    // the last tap the table and the weights are zero
    stage_mma<T, BN, SK>(acc, xs, tab, pix, t4, bbig, bsmall);
    wgmma_wait<0>();
    // land the registers' weights; seen after the next barrier
    if constexpr (F32) {
      if (wregs && filling) wr.store(a, fsl);
    }
  }
  __syncthreads();                    // the epilogue tile overlays the ring

  // epilogue: fp32 bias and activation into a channel-major fp32 tile
  float* ot = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = j * 8 + 2 * t4 + q;
      const int co = co0 + col;
      const float b = (bias != nullptr && co < a.cout_pg)
                          ? bias[g * a.cout_pg + co] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = warp * 16 + (lane >> 2) + 8 * h;
        ot[col * EPI_PITCH + m] = activate(acc[4 * j + 2 * h + q] + b, a.act);
      }
    }
  // each lane's (at most two) outputs of a channel: where they go, and
  // for a pool where their window starts in the tile
  const int plane = a.Po * a.Pw;
  int dst[2], win[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = lane + 32 * q;
    const int tw_o = a.pool_k ? a.tile_ow : a.conv_tw;
    const int np = a.pool_k ? a.tile_oh * a.tile_ow : npix;
    const int r = p / tw_o, c = p - r * tw_o;
    const int oh = oh0 + r, ow = ow0 + c;
    dst[q] = (p < np && oh < a.Po && ow < a.Pw) ? oh * a.Pw + ow : -1;
    win[q] = a.pool_k ? (r * ps) * a.conv_tw + c * ps : p;
  }
  __syncthreads();
  T* yn = y + ((size_t)n * a.Cout + (size_t)g * a.cout_pg + co0) * plane;
  for (int col = warp; col < BN && co0 + col < a.cout_pg; col += 4) {
    const float* t = ot + col * EPI_PITCH;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (dst[q] < 0) continue;
      float v;
      if (!a.pool_k) {
        v = t[win[q]];
      } else {
        v = -INFINITY;
        for (int ph = 0; ph < a.pool_k; ++ph)
          for (int pw = 0; pw < a.pool_k; ++pw)
            v = fmaxf(v, t[win[q] + ph * a.conv_tw + pw]);
      }
      yn[(size_t)col * plane + dst[q]] = from_f<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// The warp-specialised dense kernel (bf16 storage).
constexpr int WS_BM = 128;            // conv pixels a CTA: 64 a consumer
constexpr int WS_THREADS = 384;       // a producer warpgroup, two consumers
constexpr int WS_EPI_PITCH = 132;     // floats per epilogue row

// Copy the input planes of one stage's channels (rows of rc copies of EC
// elements from column iws, zero outside the image) into a slot, copies
// i0, i0 + step, ...  EC-element copies never straddle the image's
// edge: W % EC == 0.
template <int EC>
__device__ __forceinline__ void ws_planes(
    __nv_bfloat16* xs, const ConvArgs& a, const __nv_bfloat16* xc, int nch,
    int ih0, int iws, size_t hw, int i0, int step) {
  const int per_ch = a.in_th * a.rc;
  const int total = nch * per_ch;
  const uint32_t mcr = static_cast<uint32_t>(a.magic_cr);
  const uint32_t mrc = static_cast<uint32_t>(a.magic_rc);
  for (int i = i0; i < total; i += step) {
    const int cl = per_ch == 1 ? i : __umulhi(i, mcr);
    const int e = i - cl * per_ch;
    const int r = a.rc == 1 ? e : __umulhi(e, mrc);
    const int q = e - r * a.rc;
    const int ih = ih0 + r, iw = iws + q * EC;
    const bool ok = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
    __nv_bfloat16* dst = xs + cl * a.pitch + r * a.rp + q * EC;
    const __nv_bfloat16* src = xc + cl * hw + (ok ? ih * a.W + iw : 0);
    if constexpr (EC == 8) cp_async16(dst, src, ok);
    else if constexpr (EC == 4) cp_async8(dst, src, ok);
    else cp_async4(dst, src, ok);
  }
}

// One CTA: a WS_BM-pixel conv tile x BN output channels of image n.
// Threads 0-127 produce: for every stage, once its ring slot is free,
// thread 0 has TMA bring the weight slice (and, where image rows are
// whole 16-byte copies, the stage's planes), else every producer copies
// planes with cp.async.  Threads 128-383 consume: each gathers its two A
// rows of the stage's im2col tile from the planes into registers (two
// stages' fragments, so one stage's gather runs under the other's
// products) and issues the stage's wgmma; then the epilogue.
template <typename T, int BN>
__global__ void __launch_bounds__(WS_THREADS, 1)
conv2d_dense_ws_kernel(const T* __restrict__ x,
                       const float* __restrict__ bias, T* __restrict__ y,
                       ConvArgs a, const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap xmap) {
  static_assert(sizeof(T) == 2, "bf16 storage only");
  extern __shared__ __align__(1024) unsigned char ws_raw[];
  // the 128-byte swizzle is laid out from 1024-byte aligned addresses
  unsigned char* smem =
      ws_raw + ((1024 - (smem_addr(ws_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int th_i = blockIdx.x / a.tiles_w, tw_i = blockIdx.x % a.tiles_w;
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z;
  const int ps = a.pool_k ? a.pool_s : 1;
  const int oh0 = th_i * a.tile_oh, ow0 = tw_i * a.tile_ow;
  const int ih0 = oh0 * ps * a.stride - a.pad;
  const int iw0 = ow0 * ps * a.stride - a.pad;
  const int iws = iw0 & -a.ec;        // the staged rows' first column
  const int npix = a.conv_th * a.conv_tw;
  const int ns = a.nstage;
  // each ring slot: full (the TMA's bytes; the producers' cp.async),
  // empty (every consumer)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.off_bar);
  uint64_t* empty = full + ns;
  if (tid == 0) {
    for (int i = 0; i < ns; ++i) {
      mbar_init(full + i, a.ec == 8 ? 1 : 129);
      mbar_init(empty + i, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the tap tables: stage s reads table s % tperiod (the stages' taps
  // repeat, shifted by whole channels, every tperiod stages), entry j
  // the offset of tap s * BK + j in the stage's planes
  int* tabs = reinterpret_cast<int*>(smem + a.off_toff);
  for (int k = tid; k < a.tperiod * BK; k += WS_THREADS) {
    const int KK = a.K * a.K, r = k % KK;
    tabs[k] = (k / KK - (k - k % BK) / KK) * a.pitch + (r / a.K) * a.rp
              + r % a.K;
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer ----
    if constexpr (BN == 256)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const size_t hw = (size_t)a.H * a.W;
    const __nv_bfloat16* xn =
        reinterpret_cast<const __nv_bfloat16*>(x) + (size_t)n * a.Cin * hw;
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
      if (a.ec == 8)
        asm volatile("prefetch.tensormap [%0];\n"
                     :: "l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
    }
    // the weight slice: rows of the stage's 64 taps, 128 bytes, chunk c
    // at c ^ (row % 8) (the map's 128-byte swizzle), zero past Cout; the
    // planes' box: rp columns from iws, in_th rows from ih0, chmax
    // channels from the stage's first, zero outside the image
    const uint32_t bytes =
        BN * BK * 2 + (a.ec == 8 ? a.chmax * a.in_th * a.rp * 2 : 0);
    TapWalk walk;
    walk.init(a, 0);
    int slot = 0, use = 0;
    for (int t = 0; t < a.stages; ++t) {
      unsigned char* sl = smem + slot * a.slot;
      if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
      if (tid == 0) {
        mbar_arrive_expect_tx(full + slot, bytes);
        tma_load_2d(sl, &wmap, t * BK, co0, full + slot);
        if (a.ec == 8)
          tma_load_4d(sl + a.off_pl, &xmap, iws, ih0, walk.c_lo, n,
                      full + slot);
      }
      if (a.ec != 8) {
        const int nch = min(walk.c_hi, a.ci_last) + 1 - walk.c_lo;
        __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(sl + a.off_pl);
        const __nv_bfloat16* xc = xn + (size_t)walk.c_lo * hw;
        if (a.ec == 4) ws_planes<4>(xs, a, xc, nch, ih0, iws, hw, tid, 128);
        else ws_planes<2>(xs, a, xc, nch, ih0, iws, hw, tid, 128);
        cp_async_mbar_arrive(full + slot);
      }
      walk.next(a);
      if (++slot == ns) { slot = 0; ++use; }
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumers: consumer c multiplies A rows 64c..64c+63 ----
  if constexpr (BN == 256)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = tid - 128;
  const int c = ct >> 7;
  const int lane = tid & 31, t4 = lane & 3, wq = (ct >> 5) & 3;
  // this thread's two A rows (wgmma's fragment: rows g and g + 8 of its
  // warp's 16): their windows' offsets in a plane
  int pix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = c * 64 + wq * 16 + (lane >> 2) + 8 * h;
    const int r = m < npix ? m / a.conv_tw : 0;
    const int cc = m < npix ? m - r * a.conv_tw : 0;
    pix[h] = m < npix ? r * a.stride * a.rp + cc * a.stride + (iw0 - iws)
                      : 0;
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t fa[2][BK / 16][4];         // two stages' A fragments
  int slot = 0, use = 0, prev = 0, tq = 0;
  // stage s: gather its A fragments into f from the slot's planes (taps
  // 2t, 2t+1, 2t+8, 2t+9 of each k-step), then its products
  auto stage = [&](uint32_t (&f)[BK / 16][4], int s) {
    mbar_wait(full + slot, use & 1);
    __syncwarp();
    const unsigned char* sl = smem + slot * a.slot;
    const unsigned short* xu =
        reinterpret_cast<const unsigned short*>(sl + a.off_pl);
    const int* tab = tabs + tq * BK;
    const uint64_t db = sw128_desc(smem_addr(sl));
    // each k-step's fragments, then its product: the next k-step's
    // gather runs under it (and both consumers' gathers under the tensor
    // cores' work)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const int kb = j * 16 + 2 * t4;
      const int2 o0 = *reinterpret_cast<const int2*>(tab + kb);
      const int2 o1 = *reinterpret_cast<const int2*>(tab + kb + 8);
      uint32_t u[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        u[h][0] = xu[pix[h] + o0.x];
        u[h][1] = xu[pix[h] + o0.y];
        u[h][2] = xu[pix[h] + o1.x];
        u[h][3] = xu[pix[h] + o1.y];
      }
      f[j][0] = u[0][0] | (u[0][1] << 16);
      f[j][1] = u[1][0] | (u[1][1] << 16);
      f[j][2] = u[0][2] | (u[0][3] << 16);
      f[j][3] = u[1][2] | (u[1][3] << 16);
      wgmma_fence();
      mma_rs_bf16<BN>(acc, f[j], db + 2 * j);
    }
    wgmma_commit();
    wgmma_wait<1>();                  // stage s-1's products are done,
                                      // and its fragments free
    if (s > 0) mbar_arrive(empty + prev);
    prev = slot;
    if (++slot == ns) { slot = 0; ++use; }
    if (++tq == a.tperiod) tq = 0;
  };
  for (int s = 0; s < a.stages; s += 2) {
    stage(fa[0], s);
    if (s + 1 < a.stages) stage(fa[1], s + 1);
  }
  wgmma_wait<0>();
  bar_sync(2, 256);                   // the epilogue tile overlays the ring

  // epilogue: fp32 bias and activation into a channel-major fp32 tile
  float* ot = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = j * 8 + 2 * t4 + q;
      const int co = co0 + col;
      const float b = (bias != nullptr && co < a.cout_pg) ? bias[co] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = c * 64 + wq * 16 + (lane >> 2) + 8 * h;
        ot[col * WS_EPI_PITCH + m] =
            activate(acc[4 * j + 2 * h + q] + b, a.act);
      }
    }
  // each lane's (at most four) outputs of a channel: where they go, and
  // for a pool where their window starts in the tile
  const int plane = a.Po * a.Pw;
  int dst[4], win[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int p = lane + 32 * q;
    const int tw_o = a.pool_k ? a.tile_ow : a.conv_tw;
    const int np = a.pool_k ? a.tile_oh * a.tile_ow : npix;
    const int r = p / tw_o, cc = p - r * tw_o;
    const int oh = oh0 + r, ow = ow0 + cc;
    dst[q] = (p < np && oh < a.Po && ow < a.Pw) ? oh * a.Pw + ow : -1;
    win[q] = a.pool_k ? (r * ps) * a.conv_tw + cc * ps : p;
  }
  bar_sync(2, 256);
  T* yn = y + ((size_t)n * a.Cout + co0) * plane;
  for (int col = ct >> 5; col < BN && co0 + col < a.cout_pg; col += 8) {
    const float* t = ot + col * WS_EPI_PITCH;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (dst[q] < 0) continue;
      float v;
      if (!a.pool_k) {
        v = t[win[q]];
      } else {
        v = -INFINITY;
        for (int ph = 0; ph < a.pool_k; ++ph)
          for (int pw = 0; pw < a.pool_k; ++pw)
            v = fmaxf(v, t[win[q] + ph * a.conv_tw + pw]);
      }
      yn[(size_t)col * plane + dst[q]] = from_f<T>(v);
    }
  }
}

// One CTA: a conv tile of cb channels of image n.  KT, ST: the compiled
// kernel size and stride (0: read from the arguments).
template <typename T, int KT, int ST>
__global__ void __launch_bounds__(DW_THREADS)
conv2d_depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ bias, T* __restrict__ y,
                        ConvArgs a) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  float* xs = reinterpret_cast<float*>(dw_smem);
  float* ws = reinterpret_cast<float*>(dw_smem + a.off_w);
  float* ct = reinterpret_cast<float*>(dw_smem + a.off_ct);
  const int K = KT ? KT : a.K, S = ST ? ST : a.stride, KK = K * K;
  const int tid = threadIdx.x;
  const int th_i = blockIdx.x / a.tiles_w, tw_i = blockIdx.x % a.tiles_w;
  const int c0 = blockIdx.y * a.cb;
  const int nc = min(a.cb, a.Cout - c0);
  const int n = blockIdx.z;
  const int ps = a.pool_k ? a.pool_s : 1;
  const int oh0 = th_i * a.tile_oh, ow0 = tw_i * a.tile_ow;
  const int ih0 = oh0 * ps * S - a.pad, iw0 = ow0 * ps * S - a.pad;
  const size_t hw = (size_t)a.H * a.W;
  const T* xn = x + ((size_t)n * a.Cout + c0) * hw;

  // stage each channel's haloed input tile once, as fp32, zero outside
  // (divisions by multiply-shift: the planner's magic numbers)
  const int in_plane = a.in_th * a.in_tw;
  const uint32_t mp = a.magic, mw = a.magic_w;
  constexpr int U = 4;                // bf16: loads in flight per thread
  for (int i0 = tid; i0 < nc * in_plane; i0 += U * DW_THREADS) {
    float v[U];
    float* d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * DW_THREADS;
      const int cl = in_plane == 1 ? i : __umulhi(i, mp);
      const int e = i - cl * in_plane;
      const int r = a.in_tw == 1 ? e : __umulhi(e, mw);
      const int c = e - r * a.in_tw;
      const int ih = ih0 + r, iw = iw0 + c;
      const bool ok = i < nc * in_plane && ih >= 0 && ih < a.H && iw >= 0
                      && iw < a.W;
      const T* src = xn + cl * hw + (ok ? (size_t)ih * a.W + iw : 0);
      d[u] = i < nc * in_plane ? xs + (cl * a.in_th + r) * a.pitch_w + c
                               : nullptr;
      if constexpr (sizeof(T) == 4) {
        if (d[u] != nullptr) cp_async4(d[u], src, ok);
      } else {
        v[u] = ok ? to_f(src[0]) : 0.f;
      }
    }
    if constexpr (sizeof(T) != 4) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (d[u] != nullptr) *d[u] = v[u];
    }
  }
  for (int i = tid; i < nc * KK; i += DW_THREADS)
    ws[i] = to_f(w[(size_t)c0 * KK + i]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int nstrip = (a.conv_tw + DW_VEC - 1) / DW_VEC;
  const int per_ch = a.conv_th * nstrip;
  T* yn = y + ((size_t)n * a.Cout + c0) * a.Po * a.Pw;
  for (int it = tid; it < nc * per_ch; it += DW_THREADS) {
    const int cl = per_ch == 1 ? it : __umulhi(it, a.magic_pc);
    const int rem = it - cl * per_ch;
    const int r = nstrip == 1 ? rem : __umulhi(rem, a.magic_ns);
    const int sc = rem - r * nstrip;
    const float* xr = xs + (cl * a.in_th + r * S) * a.pitch_w
                      + sc * DW_VEC * S;
    const float* wk = ws + cl * KK;
    const float b = bias != nullptr ? bias[c0 + cl] : 0.f;
    float acc[DW_VEC];
#pragma unroll
    for (int v = 0; v < DW_VEC; ++v) acc[v] = 0.f;
    if constexpr (KT != 0) {
      constexpr int WIN = (DW_VEC - 1) * ST + KT;
      constexpr int WIN4 = (WIN + 3) / 4;
      float wr[KT * KT];
#pragma unroll
      for (int k = 0; k < KT * KT; ++k) wr[k] = wk[k];
#pragma unroll
      for (int kh = 0; kh < KT; ++kh) {
        float xv[WIN4 * 4];
        const float4* row = reinterpret_cast<const float4*>(
            xr + kh * a.pitch_w);
#pragma unroll
        for (int q = 0; q < WIN4; ++q) {
          const float4 f = row[q];
          xv[4 * q] = f.x; xv[4 * q + 1] = f.y;
          xv[4 * q + 2] = f.z; xv[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int kw = 0; kw < KT; ++kw)
#pragma unroll
          for (int v = 0; v < DW_VEC; ++v)
            acc[v] = fmaf(wr[kh * KT + kw], xv[v * ST + kw], acc[v]);
      }
    } else {
      for (int kh = 0; kh < K; ++kh)
        for (int kw = 0; kw < K; ++kw) {
          const float wv = wk[kh * K + kw];
#pragma unroll
          for (int v = 0; v < DW_VEC; ++v)
            acc[v] = fmaf(wv, xr[kh * a.pitch_w + v * S + kw], acc[v]);
        }
    }
    const int cc0 = sc * DW_VEC;
    if (a.pool_k) {
      float* t = ct + (cl * a.conv_th + r) * a.conv_tw;
#pragma unroll
      for (int v = 0; v < DW_VEC; ++v)
        if (cc0 + v < a.conv_tw) t[cc0 + v] = activate(acc[v] + b, a.act);
      continue;
    }
    const int oh = oh0 + r, ow = ow0 + cc0;
    if (oh >= a.Po) continue;
    T* dst = yn + ((size_t)cl * a.Po + oh) * a.Pw + ow;
    T o[DW_VEC];
#pragma unroll
    for (int v = 0; v < DW_VEC; ++v) o[v] = from_f<T>(activate(acc[v] + b,
                                                                a.act));
    const bool whole = cc0 + DW_VEC <= a.conv_tw && ow + DW_VEC <= a.Pw;
    if (whole && reinterpret_cast<uintptr_t>(dst) % (DW_VEC * sizeof(T))
                     == 0) {
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            __bfloat16_as_ushort(o[0]) | (__bfloat16_as_ushort(o[1]) << 16),
            __bfloat16_as_ushort(o[2]) | (__bfloat16_as_ushort(o[3]) << 16));
    } else {
#pragma unroll
      for (int v = 0; v < DW_VEC; ++v)
        if (cc0 + v < a.conv_tw && ow + v < a.Pw) dst[v] = o[v];
    }
  }
  if (!a.pool_k) return;
  // fused maxpool from the activated conv tile
  __syncthreads();
  const int tile_np = a.tile_oh * a.tile_ow;
  for (int i = tid; i < nc * tile_np; i += DW_THREADS) {
    const int cl = i / tile_np, rem = i - cl * tile_np;
    const int pr = rem / a.tile_ow, pc = rem - pr * a.tile_ow;
    const int oh = oh0 + pr, ow = ow0 + pc;
    if (oh >= a.Po || ow >= a.Pw) continue;
    const float* t = ct + (cl * a.conv_th + pr * ps) * a.conv_tw + pc * ps;
    float mx = -INFINITY;
    for (int ph = 0; ph < a.pool_k; ++ph)
      for (int pw = 0; pw < a.pool_k; ++pw)
        mx = fmaxf(mx, t[ph * a.conv_tw + pw]);
    yn[((size_t)cl * a.Po + oh) * a.Pw + ow] = from_f<T>(mx);
  }
}

template <typename K>
cudaError_t raise_smem_cap(K kernel, int smem, int& cap) {
  // raise a kernel's dynamic shared-memory cap once per new high-water
  // mark (not on every launch: a launch may be under CUDA-graph capture)
  if (smem <= cap) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) cap = smem;
  return err;
}

template <typename T, int BN>
cudaError_t launch_dense(const T* x, const T* w, const float* b, T* y,
                         const ConvArgs& a, cudaStream_t stream) {
  static int cap = 48 * 1024;
  cudaError_t err = raise_smem_cap(conv2d_dense_kernel<T, BN>, a.smem, cap);
  if (err != cudaSuccess) return err;
  dim3 grid(a.tiles_h * a.tiles_w, a.groups * a.co_blocks, a.N);
  conv2d_dense_kernel<T, BN><<<grid, THREADS, a.smem, stream>>>(x, w, b, y,
                                                                a);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver the runtime loaded (nothing
// links libcuda)
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T, int BN>
cudaError_t launch_ws(const T* x, const T* w, const float* b, T* y,
                      const ConvArgs& a, cudaStream_t stream) {
  static int cap = 48 * 1024;
  cudaError_t err = raise_smem_cap(conv2d_dense_ws_kernel<T, BN>, a.smem,
                                   cap);
  if (err != cudaSuccess) return err;
  // the weights as a (Cout, ktot) matrix of bf16, read in boxes of BN
  // rows by one stage of taps, in the 128-byte swizzle wgmma reads
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)a.ktot, (cuuint64_t)a.Cout};
  const cuuint64_t strides[1] = {(cuuint64_t)a.ktot * sizeof(T)};
  const cuuint32_t box[2] = {BK, BN};
  const cuuint32_t step[2] = {1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<T*>(w), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // the input as an (N, Cin, H, W) tensor of bf16 read in boxes of a
  // stage's planes, where its rows are whole 16-byte copies (else the
  // producers copy the planes themselves and the map is not read)
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof(xmap));
  if (a.ec == 8) {
    const cuuint64_t xdims[4] = {(cuuint64_t)a.W, (cuuint64_t)a.H,
                                 (cuuint64_t)a.Cin, (cuuint64_t)a.N};
    const cuuint64_t xstrides[3] = {
        (cuuint64_t)a.W * sizeof(T), (cuuint64_t)a.H * a.W * sizeof(T),
        (cuuint64_t)a.Cin * a.H * a.W * sizeof(T)};
    const cuuint32_t xbox[4] = {(cuuint32_t)a.rp, (cuuint32_t)a.in_th,
                                (cuuint32_t)a.chmax, 1};
    const cuuint32_t xstep[4] = {1, 1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<T*>(x), xdims, xstrides, xbox, xstep,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  dim3 grid(a.tiles_h * a.tiles_w, a.co_blocks, a.N);
  conv2d_dense_ws_kernel<T, BN><<<grid, WS_THREADS, a.smem, stream>>>(
      x, b, y, a, wmap, xmap);
  return cudaGetLastError();
}

template <typename T, int KT, int ST>
cudaError_t launch_dw(const T* x, const T* w, const float* b, T* y,
                      const ConvArgs& a, cudaStream_t stream) {
  dim3 grid(a.tiles_h * a.tiles_w, a.co_blocks, a.N);
  conv2d_depthwise_kernel<T, KT, ST><<<grid, DW_THREADS, a.smem, stream>>>(
      x, w, b, y, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   ConvArgs a, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  if (a.depthwise) {
    if (a.kt == 3 && a.stride == 1)
      return launch_dw<T, 3, 1>(xt, wt, bt, yt, a, stream);
    if (a.kt == 3 && a.stride == 2)
      return launch_dw<T, 3, 2>(xt, wt, bt, yt, a, stream);
    return launch_dw<T, 0, 0>(xt, wt, bt, yt, a, stream);
  }
  if (a.ws) {
    // the wrapper checked the copies' alignment
    if constexpr (sizeof(T) == 2) {
      switch (a.bn) {
        case 256: return launch_ws<T, 256>(xt, wt, bt, yt, a, stream);
        case 128: return launch_ws<T, 128>(xt, wt, bt, yt, a, stream);
        case 64: return launch_ws<T, 64>(xt, wt, bt, yt, a, stream);
        default: return cudaErrorInvalidValue;
      }
    }
    return cudaErrorInvalidValue;
  }
  // the 16-byte copies need 16-byte aligned tensors (a batch slice of an
  // aligned tensor may not be)
  if (reinterpret_cast<uintptr_t>(x) % (a.vec_x == 3 ? 8 : 16)) a.vec_x = 0;
  if (reinterpret_cast<uintptr_t>(w) % 16) a.vec_b = 0;
  switch (a.bn) {
    case 64: return launch_dense<T, 64>(xt, wt, bt, yt, a, stream);
    case 32: return launch_dense<T, 32>(xt, wt, bt, yt, a, stream);
    case 16: return launch_dense<T, 16>(xt, wt, bt, yt, a, stream);
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
  memcpy(&a, p, sizeof(a));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dtype == 1) return (int)launch<__nv_bfloat16>(x, w, bias, y, a, s);
  return (int)launch<float>(x, w, bias, y, a, s);
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
