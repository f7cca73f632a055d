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
//           q's dtype; a zero denominator is taken as 1.  The weights
//           p_j = exp(s_j - m) multiply v_j in fp32 there; here in fp32
//           storage as three TF32 passes, in bf16 storage as a bf16 pair
//           hi + lo (16 of fp32's 24 significant bits).  One bf16
//           rounding of p would move a row by over 1e-3 of its scale,
//           near what storing the output in bf16 does; the pair keeps it
//           within 2e-5 of fp32 p (tests/test_torch_ops.py).  The
//           denominator is the sum of the fp32 p in both.
// Inputs are read in their (B, S, heads, hd) layout; the query head h reads
// the K/V head h / (H / KV), in place of materialising the repeat.  The
// launch geometry is the caller's (kernels/flash_attention.py::plan_flash):
// the grid, the dynamic shared memory and, per query tile, how many key
// tiles it walks (an int32 table on the device).  This file computes none
// of it; flash_attention_tiles and flash_attention_smem report the tile
// constants and the shared bytes it is compiled with, so the caller can
// check they are the planner's.
//
// What bounds it on an H100: at the served shapes (Sq = Sk = 2048) the
// work is ~4 hd FLOPs per visible (query, key) pair against 2 hd bytes
// per row read once, so it is bound by operations: the tensor cores' rate
// of the arithmetic it runs, three TF32 passes (495/3 TFLOP/s) in fp32,
// bf16 (989) in bf16, where P V's second pass adds half the work again.
//
// Design: one CTA per (b*h, query tile), heaviest causal tiles first: in
// fp32 a tile of 64 queries, one warpgroup (128 threads); in bf16 128
// queries, two warpgroups of 64 rows each on the same K/V tiles (half the
// K/V traffic a query; bf16 tiles are read from L2 at a rate that
// otherwise bounds the kernel).  A warpgroup's wgmmas, softmax and O
// are its own; the copies and barriers are the CTA's.  Q is staged once
// with cp.async into wgmma's no-swizzle K-major layout (rows of hd
// contiguous, as they lie); K and V tiles of BK keys (32 in fp32, 64 in
// bf16) come through rings of two slots (three for bf16 keys), the next
// tiles' copies in flight while this one is multiplied.  S = Q K^T is a
// wgmma with both operands in shared memory (K is K-major as it lies);
// the online softmax runs on the S accumulator in registers (a row's BK
// keys over the 4 threads of a quad; masks only on edge tiles); O += P V
// takes P from registers as the A operand, O (hd/2 floats a thread) stays
// in registers across the key tiles, its hd columns issued as wgmmas of
// N = 64, 32 and 16.
//   fp32: every product is three TF32 passes (small*big, big*small,
//   big*big, split with cvt.rna): Q's big and small halves are written
//   once, each K tile's in place and beside it.  tf32 wgmma takes only
//   K-major operands, so V (keys the K dimension of P V) is transposed
//   from its staged rows into V^T halves, and within each 8-key k-step
//   the keys are stored in the order 0 2 4 6 1 3 5 7: the accumulator of
//   S holds columns (2t, 2t+1) of each 8-column block where the tf32 A
//   fragment wants (t, t+4), so with that order a thread's S registers
//   are its A fragment as they lie (the sum over keys does not care).
//   bf16: S in one bf16 pass, fp32 accumulation (Q.K products of bf16
//   values are exact in fp32); P V in two, P split into bf16 hi and lo;
//   pairs of S registers pack into the bf16 A fragments directly, and V
//   is staged as it lies, MN-major, read through the B transpose bit.
// Key tiles wholly above the diagonal are skipped, except in a query tile
// that holds a row with no visible key, which must average every key;
// keys past Sk are zero-filled by the copies and weigh exp(-inf) = 0.
#include <math.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int NVSLOT = 2;        // V tiles in the ring
constexpr int VPAD = 4;          // fp32: floats past hd in a staged V row
constexpr float MASKED = -1e30f;

// A CTA: BQ query rows, one warpgroup (128 threads) per 64 of them.
template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int BQ = 64;  // query rows a CTA
  static constexpr int BK = 32;  // keys a tile
  static constexpr int KSTEP = 8;
  static constexpr int THREADS = 128;
  static constexpr int NKSLOT = 2;  // K tiles in the ring
};
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BQ = 128;
  static constexpr int BK = 64;
  static constexpr int KSTEP = 16;
  static constexpr int THREADS = 256;
  static constexpr int NKSLOT = 3;
};

// Shared memory of one CTA, in bytes: Q (big; small after it in fp32),
// the K ring (NKSLOT tiles in the K-major layout), the V ring (NVSLOT
// tiles: fp32 rows of HD + VPAD floats, bf16 MN-major core matrices),
// then fp32's K small half and V^T's big and small halves, twice (tile kt
// uses set kt % 2, so the next tile's are written while P V reads these).
template <typename T, int HD> struct Layout {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BK = Tile<T>::BK;
  static constexpr int Q = Tile<T>::BQ * HD * (int)sizeof(T);
  static constexpr int KT = BK * HD * (int)sizeof(T);
  static constexpr int VT = F32 ? BK * (HD + VPAD) * 4 : KT;
  static constexpr int NK = Tile<T>::NKSLOT;
  static constexpr int OFF_QS = Q;
  static constexpr int OFF_KR = F32 ? 2 * Q : Q;
  static constexpr int OFF_VR = OFF_KR + NK * KT;
  static constexpr int OFF_KS = OFF_VR + NVSLOT * VT;
  static constexpr int OFF_VTB = OFF_KS + KT;
  static constexpr int OFF_VTS = OFF_VTB + KT;
  static constexpr int BUF = 3 * KT;  // fp32: the second K small / V^T set
  static constexpr int BYTES = F32 ? OFF_KS + 2 * BUF : OFF_KS;
};

// R rows of HD elements, row r at src + r * stride, into the K-major
// no-swizzle layout of an R-row operand; rows >= nvalid are zero.  Eight
// neighbouring threads fill one 128-byte core-matrix column pair.
template <typename T, int R, int HD>
__device__ __forceinline__ void stage_kmajor(unsigned char* dst,
                                             const T* src, long long stride,
                                             int nvalid) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int CH = HD / E;               // 16-byte chunks a row (even)
  constexpr int NT = Tile<T>::THREADS;
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int m = (i & 7) | (((i >> 4) % (R / 8)) << 3);
    const int c = ((i >> 3) & 1) | (((i >> 4) / (R / 8)) << 1);
    const bool ok = m < nvalid;
    cp_async16(dst + (c >> 1) * R * 32 + (m >> 3) * 256 + (c & 1) * 128
                   + (m & 7) * 16,
               src + (ok ? m * stride : 0) + c * E, ok);
  }
}

// V tile: fp32 rows as they lie (pitch HD + VPAD); bf16 MN-major core
// matrices, element (key, d) at (key/16)*HD*32 + (d/8)*256
// + ((key%16)/8)*128 + (key%8)*16 + (d%8)*2.
template <typename T, int HD>
__device__ __forceinline__ void stage_v(unsigned char* dst, const T* src,
                                        long long stride, int nvalid) {
  constexpr int BK = Tile<T>::BK;
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int NT = Tile<T>::THREADS;
  if constexpr (sizeof(T) == 4) {
    for (int i = threadIdx.x; i < BK * (HD / E); i += NT) {
      const int key = i / (HD / E), c = i % (HD / E);
      const bool ok = key < nvalid;
      cp_async16(dst + key * (HD + VPAD) * 4 + c * 16,
                 src + (ok ? key * stride : 0) + c * E, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BK * (HD / E); i += NT) {
      const int key_lo = i & 15;           // 8 keys, then the other 8
      const int nb = (i >> 4) % (HD / 8), ks = (i >> 4) / (HD / 8);
      const int key = ks * 16 + key_lo;
      const bool ok = key < nvalid;
      cp_async16(dst + ks * HD * 32 + nb * 256 + (key_lo >> 3) * 128
                     + (key_lo & 7) * 16,
                 src + (ok ? key * stride : 0) + nb * 8, ok);
    }
  }
}

// Calls f(N0, W) for the wgmma column chunks of HD: widths 64, then 32,
// then 16.
template <int N0, int HD, typename F>
__device__ __forceinline__ void for_chunks(F&& f) {
  if constexpr (N0 < HD) {
    constexpr int W = HD - N0 >= 64 ? 64 : (HD - N0 >= 32 ? 32 : 16);
    f(std::integral_constant<int, N0>{}, std::integral_constant<int, W>{});
    for_chunks<N0 + W, HD>(f);
  }
}

// q, o: (B, Sq, H, HD); k, v: (B, Sk, KV, HD).  Grid (ceil(Sq/BQ), B*H);
// block x takes query tile gridDim.x - 1 - x and walks k_tiles[tile] key
// tiles; warpgroup w of the CTA owns its query rows 64 w .. 64 w + 63.
template <typename T, int NC>
__global__ void __launch_bounds__(Tile<T>::THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
             int H, int KV, float scale, int causal,
             const int* __restrict__ k_tiles) {
  constexpr int HD = 16 * NC;
  using Lay = Layout<T, HD>;
  constexpr bool F32 = Lay::F32;
  constexpr int BK = Lay::BK;
  constexpr int BQ = Tile<T>::BQ;
  constexpr int NT = Tile<T>::THREADS;
  constexpr int KSTEP = Tile<T>::KSTEP;
  extern __shared__ __align__(1024) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int q0 = qi * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const long long q_step = (long long)H * HD;    // one sequence position
  const long long kv_step = (long long)KV * HD;
  const T* qb = q + ((long long)b * Sq * H + h) * HD;
  const T* kb = k + ((long long)b * Sk * KV + kvh) * HD;
  const T* vb = v + ((long long)b * Sk * KV + kvh) * HD;
  T* ob = o + ((long long)b * Sq * H + h) * HD;
  const int diag = Sk - Sq;                       // query r sees keys <= r+diag
  const int nk = k_tiles[qi];

  unsigned char* qs = smem;
  stage_kmajor<T, BQ, HD>(qs, qb + (long long)q0 * q_step, q_step, Sq - q0);
  auto kslot = [&](int kt) {
    return smem + Lay::OFF_KR + (kt % Lay::NK) * Lay::KT;
  };
  auto vslot = [&](int kt) {
    return smem + Lay::OFF_VR + (kt % NVSLOT) * Lay::VT;
  };
  // copy tile kt's keys (values) into their slot: one copy group each,
  // empty past nk
  auto issue_k = [&](int kt) {
    if (kt < nk)
      stage_kmajor<T, BK, HD>(kslot(kt), kb + kt * BK * kv_step, kv_step,
                              Sk - kt * BK);
    cp_async_commit();
  };
  auto issue_v = [&](int kt) {
    if (kt < nk)
      stage_v<T, HD>(vslot(kt), vb + kt * BK * kv_step, kv_step,
                     Sk - kt * BK);
    cp_async_commit();
  };
  // fp32: tile kt's K small half (its big half in place) and V^T's halves
  // into buffer kt % 2.  V^T keys 0 2 4 6 1 3 5 7 within each 8-key
  // k-step; a thread writes 4 keys of one column, 16 bytes a half.
  auto prep = [&](int kt) {
    const int buf = (kt & 1) * Lay::BUF;
    float4* kv4 = reinterpret_cast<float4*>(kslot(kt));
    float4* ksm = reinterpret_cast<float4*>(smem + Lay::OFF_KS + buf);
#pragma unroll 4
    for (int it = 0; it < BK * HD / 4 / NT; ++it) {
      const int i = tid + it * NT;
      const float4 x = kv4[i], bg = tf32_big4(x);
      kv4[i] = bg;
      ksm[i] = tf32_small4(x, bg);
    }
    const float* vr = reinterpret_cast<const float*>(vslot(kt));
    unsigned char* vtb = smem + Lay::OFF_VTB + buf;
    unsigned char* vts = smem + Lay::OFF_VTS + buf;
    constexpr int P = HD + VPAD;
#pragma unroll 4
    for (int it = 0; it < BK * HD / 4 / NT; ++it) {
      const int i = tid + it * NT;
      const int d = i % HD, kq = i / HD;
      const int key = 8 * (kq >> 1) + (kq & 1);
      const float4 x = make_float4(vr[key * P + d], vr[(key + 2) * P + d],
                                   vr[(key + 4) * P + d],
                                   vr[(key + 6) * P + d]);
      const float4 bg = tf32_big4(x);
      const int off = b_off<HD, 4, 8>(d, 4 * kq);
      *reinterpret_cast<float4*>(vtb + off) = bg;
      *reinterpret_cast<float4*>(vts + off) = tf32_small4(x, bg);
    }
  };
  issue_k(0);                         // with Q: one group
  issue_v(0);
  issue_k(1);
  if constexpr (F32) issue_v(1);

  // this thread's rows: 64 * wg + 16 * warp + g and + 8
  const int row0 = q0 + 64 * wg + 16 * warp + g;
  float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.f, 0.f};
  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;

  if constexpr (F32) {
    cp_async_wait<2>();               // Q and tile 0 have landed
    __syncthreads();
    float4* qv = reinterpret_cast<float4*>(qs);
    float4* qsm = reinterpret_cast<float4*>(smem + Lay::OFF_QS);
    for (int i = tid; i < BQ * HD / 4; i += NT) {
      const float4 x = qv[i], bg = tf32_big4(x);
      qv[i] = bg;                     // Q's halves: big in place, small
      qsm[i] = tf32_small4(x, bg);
    }
    prep(0);
    fence_proxy_async();              // stores, to wgmma
    __syncthreads();
  }

  // The ring.  fp32: while P V(kt) runs, tile kt + 2 is copied into tile
  // kt's slots and tile kt + 1's halves are built (two sets; S, which
  // reads both operands from shared memory, runs alone: building them
  // beside it was slower).  bf16: while S(kt) runs, tile kt + 2's keys
  // are copied (three K slots) and tile kt + 1's values (P V(kt - 1) is
  // done with their slot).
  for (int kt = 0; kt < nk; ++kt) {
    const unsigned char* sl = kslot(kt);
    const int buf = (kt & 1) * Lay::BUF;
    STAMP(0);
    if constexpr (!F32) {
      cp_async_wait<1>();             // Q and this tile's K and V landed
      fence_proxy_async();            // copies, to wgmma
      __syncthreads();
    }

    STAMP(1);
    // S = Q K^T, (64 x BK) a warpgroup, fp32 accumulation; the
    // warpgroup's 64 rows of Q start 8 row groups of 256 bytes in
    float sacc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
    wgmma_fence();
    {
      const uint32_t qa = smem_addr(qs) + wg * 2048, ka = smem_addr(sl);
#pragma unroll
      for (int ks = 0; ks < HD / KSTEP; ++ks) {
        const uint64_t dq = b_desc(qa + ks * BQ * 32);
        const uint64_t dk = b_desc(ka + ks * BK * 32);
        if constexpr (F32) {
          const uint64_t dqs = b_desc(smem_addr(smem + Lay::OFF_QS)
                                      + wg * 2048 + ks * BQ * 32);
          const uint64_t dks = b_desc(smem_addr(smem + Lay::OFF_KS + buf)
                                      + ks * BK * 32);
          wgmma_ss_tf32_n32(sacc, dqs, dk);     // small * big
          wgmma_ss_tf32_n32(sacc, dq, dks);     // big * small
          wgmma_ss_tf32_n32(sacc, dq, dk);      // big * big
        } else {
          wgmma_ss_bf16_n64(sacc, dq, dk);
        }
      }
    }
    wgmma_commit();
    if constexpr (!F32) {
      issue_v(kt + 1);                // P V(kt - 1) is done: its V slot
      issue_k(kt + 2);                // S(kt - 1) is done: its K slot
    }
    wgmma_wait<0>();

    STAMP(2);
    // scale, mask (only where the tile has keys past Sk or, causal, above
    // the diagonal of one of this CTA's rows), online softmax
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + diag);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      float s = sacc[i] * scale;
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (key >= Sk)
          s = -INFINITY;              // past the end: no weight
        else if (causal && key > row0 + 8 * r + diag)
          s = MASKED;
      }
      sacc[i] = s;
      mx[r] = fmaxf(mx[r], s);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = __expf(sacc[i] - m_run[r]);
      sacc[i] = p;
      sum[r] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = alpha[r] * l_run[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    STAMP(3);
    // O += P V, P from registers: every k-step's fragments first, so that
    // the products issue back to back after one fence
    if constexpr (F32) {
      // keys stored 0 2 4 6 1 3 5 7: (t, t+4) of a k-step are this
      // thread's columns (2t, 2t+1)
      uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        tf32_split(sacc[4 * j + 0], pb[j][0], ps[j][0]);
        tf32_split(sacc[4 * j + 2], pb[j][1], ps[j][1]);
        tf32_split(sacc[4 * j + 1], pb[j][2], ps[j][2]);
        tf32_split(sacc[4 * j + 3], pb[j][3], ps[j][3]);
      }
      const uint32_t vtb = smem_addr(smem + Lay::OFF_VTB + buf);
      const uint32_t vts = smem_addr(smem + Lay::OFF_VTS + buf);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        for_chunks<0, HD>([&](auto n0c, auto wc) {
          constexpr int N0 = decltype(n0c)::value, W = decltype(wc)::value;
          const uint32_t off = j * HD * 32 + (N0 / 8) * 256;
          mma_tf32<W>(oacc + N0 / 2, ps[j], b_desc(vtb + off));
          mma_tf32<W>(oacc + N0 / 2, pb[j], b_desc(vts + off));
          mma_tf32<W>(oacc + N0 / 2, pb[j], b_desc(vtb + off));
        });
      }
    } else {
      // P as a bf16 pair hi + lo (p - hi is exact in fp32), two passes,
      // lo first: P keeps ~16 bits, as the TPU kernel's fp32 P nearly does
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float p0 = sacc[8 * j + 2 * q], p1 = sacc[8 * j + 2 * q + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
          ph[j][q] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[j][q] = *reinterpret_cast<const uint32_t*>(&lo);
        }
      const uint32_t va = smem_addr(vslot(kt));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        for_chunks<0, HD>([&](auto n0c, auto wc) {
          constexpr int N0 = decltype(n0c)::value, W = decltype(wc)::value;
          const uint64_t dv = b_desc(va + j * HD * 32 + (N0 / 8) * 256);
          mma_bf16<W, 1>(oacc + N0 / 2, pl[j], dv);
          mma_bf16<W, 1>(oacc + N0 / 2, ph[j], dv);
        });
      }
    }
    wgmma_commit();
    STAMP(4);
    if constexpr (F32) {
      // while P V runs: the copies of tile kt + 2 into tile kt's slots
      // (S(kt) is done with its keys, prep(kt) with its values), and the
      // halves of tile kt + 1
      if (kt + 1 < nk) {
        cp_async_wait<0>();           // tile kt + 1 has landed
        __syncthreads();              // everyone's copies; S(kt) is done
        issue_k(kt + 2);
        issue_v(kt + 2);
        prep(kt + 1);
        fence_proxy_async();          // stores, to wgmma
      }
    }
    STAMP(5);
    wgmma_wait<0>();
    // fp32: set kt % 2 is free for prep(kt + 2).  bf16 needs no barrier
    // here: the next tile's top barrier orders P V(kt) and S(kt) before
    // the copies into their slots.
    if constexpr (F32) __syncthreads();
    STAMP(6);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / (l_run[r] == 0.f ? 1.f : l_run[r]);
    T* orow = ob + row * q_step + 2 * t4;
#pragma unroll
    for (int J = 0; J < HD / 8; ++J) {
      const float x0 = oacc[4 * J + 2 * r] * inv;
      const float x1 = oacc[4 * J + 2 * r + 1] * inv;
      if constexpr (F32) {
        *reinterpret_cast<float2*>(orow + 8 * J) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * J) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
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
  if (a.smem != Layout<T, 16 * NC>::BYTES) return (int)cudaErrorInvalidValue;
  static int configured = 0;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        a.smem);
    if (err != cudaSuccess) return (int)err;
    configured = 1;
  }
  flash_kernel<T, NC><<<a.grid, Tile<T>::THREADS, a.smem, a.s>>>(
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

template <typename T, int NC = 1>
int smem_of(int hd) {
  if constexpr (NC > 8) {
    return -1;
  } else {
    return hd == 16 * NC ? Layout<T, 16 * NC>::BYTES : smem_of<T, NC + 1>(hd);
  }
}

}  // namespace

extern "C" {

// hd a multiple of 16 up to 128; dtype 0 = fp32, 1 = bf16; grid, shared
// bytes and the device table k_tiles (grid_x ints) from the caller's plan.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for an hd
// or a shared-memory size this file does not have).
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

// The tile constants this file is compiled with: BQ, BK, THREADS and
// NKSLOT of fp32 then of bf16, NVSLOT, VPAD.
void flash_attention_tiles(int* out) {
  out[0] = Tile<float>::BQ;
  out[1] = Tile<float>::BK;
  out[2] = Tile<float>::THREADS;
  out[3] = Tile<float>::NKSLOT;
  out[4] = Tile<__nv_bfloat16>::BQ;
  out[5] = Tile<__nv_bfloat16>::BK;
  out[6] = Tile<__nv_bfloat16>::THREADS;
  out[7] = Tile<__nv_bfloat16>::NKSLOT;
  out[8] = NVSLOT;
  out[9] = VPAD;
}

// The dynamic shared bytes of one CTA for (dtype, hd); -1 for an hd it
// does not have.
int flash_attention_smem(int dtype, int hd) {
  return dtype == 1 ? smem_of<__nv_bfloat16>(hd) : smem_of<float>(hd);
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
