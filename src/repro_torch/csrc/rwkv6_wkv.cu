// RWKV6 WKV recurrence for Hopper (sm_90a): a column-parallel scan fed by
// cp.async.
//
// Replaces the TPU kernel of src/repro/kernels/rwkv6_wkv.py: _wkv_kernel
// (L21-41), launched there by rwkv6_wkv (L44).  Per (batch, head), from
// S = 0 (hd x hd, fp32), for t = 0 .. T-1:
//   out_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j]  = S[i][j] w_t[i] + k_t[i] v_t[j]
// Inputs (u too) are read in their stored dtype (fp32 or bf16) and
// widened to fp32; state and sums are fp32; out is stored in the inputs'
// dtype.  Any T: the last stage is partial, and steps past T are neither
// read nor written, so no caller pads.
//
// What bounds it on an H100: the function moves 5 hd elements a (b, h, t)
// (r, k, v, w in, out out) and needs ~5 hd^2 fp32 operations (the bonus
// term factors through sum_i r_i u_i k_i).  At RWKV6-7B widths (B 2, T
// 2000, H 64, hd 64) that is 0.098 ms of bytes in fp32 and 0.049 in bf16,
// against 0.080 ms of operations on the CUDA cores (67 TFLOP/s): bytes
// bound fp32, the CUDA cores bf16.  Only S = S w + k v^T depends on the
// step before; the rest of a step can overlap across steps and warps.
// The call holds B*H*hd*hd state elements (524k at those widths): ~4k an
// SM, so few warps, and the design keeps each warp's step short.
//
// The design:
// * Columns in parallel.  Each column j of S evolves on its own, so a CTA
//   takes jc columns of one (b, h) (grid B*H*(hd/jc), the CTAs of one head
//   adjacent, so their reads of r, k and w meet in L2).  Thread q G + g
//   (G = jc/COLS column groups) holds a ROWS x COLS tile of S in
//   registers: columns g COLS .. g COLS + COLS - 1 of the CTA's, rows in
//   the float4 chunks q, q + NS, q + 2 NS, ... (NS = hd/ROWS lanes a
//   group).  A tile reads (3 ROWS + COLS) floats from shared memory a
//   step for ROWS COLS elements, where one column a thread would read 3
//   floats an element; and since g runs fastest, the lanes of a
//   quarter-warp read r, k and w at one address (a 16-byte load of 8
//   distinct chunks costs a warp 4 shared-memory cycles, of one address
//   a quarter-warp at most half that: PERF.md §6, run 8).
// * Staging.  A ring of `stages` slots in shared memory, each `steps`
//   steps of r, k, w (hd each) and v (the CTA's jc columns), filled by
//   16-byte cp.async as stored; stage s + stages - 1 is in flight while
//   stage s runs (cp.async.wait_group).  bf16 slots are widened once a
//   stage into an fp32 buffer, not once a column.
// * A step: the bonus factored out, out_j = sum_i r_i S_ij + v_j
//   sum_i r_i u_i k_i, so an element costs o_j += r_i S_ij and S_ij =
//   S_ij w_i + k_i v_j: 3 fp32 instructions where the TPU body's form
//   r_i (S_ij + u_i k_i v_j) takes 4 (a CPU test holds the factored form
//   to the TPU form within 1e-4 of a row's scale).  Each column's o in
//   two accumulators.  The thread's partial sums (its rows' share of its
//   columns' out) go to shared memory; nothing crosses lanes within a
//   step, so a warp's step is loads, products and one store.
// * A stage's passes.  Before its steps, a warp a step sums r u k over
//   hd (shuffles); after them, each thread adds the NS partials of a
//   group's columns at some steps and the bonus term, into shared
//   memory; those outputs are written with 16-byte stores at the start of
//   the next stage.
#include "hopper.cuh"

namespace {

constexpr int MAX_THREADS = 256;

// The state tile a thread holds, per head dim and storage dtype: {hd,
// rows fp32, cols fp32, rows bf16, cols bf16}.  One tile is compiled per
// (hd, dtype); kernels/rwkv6_wkv.py's TILES is the same table.
constexpr int TILES[4][5] = {
    {16, 4, 2, 4, 2}, {32, 4, 4, 8, 2}, {64, 4, 4, 8, 2}, {128, 8, 4, 8, 2}};

constexpr int tile_row(int hd) {
  return hd == 16 ? 0 : hd == 32 ? 1 : hd == 64 ? 2 : 3;
}
template <typename T>
constexpr int tile_rows(int hd) {
  return TILES[tile_row(hd)][sizeof(T) == 2 ? 3 : 1];
}
template <typename T>
constexpr int tile_cols(int hd) {
  return TILES[tile_row(hd)][sizeof(T) == 2 ? 4 : 2];
}

// The copies of one stage (steps t0 .. t0+steps-1): a step's record is r,
// k, w (HD each) then v's columns j0 .. j0+jc-1, 16 bytes a copy, so copy
// idx lands at byte 16 idx of the slot.  Steps past T are zero-filled and
// read nothing.
template <typename T, int HD>
__device__ __forceinline__ void load_stage(
    char* slot, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ w, const T* __restrict__ v, long long base,
    long long step, int j0, int t0, int T_, int steps, int jc) {
  constexpr int EPC = 16 / sizeof(T);        // elements a copy
  constexpr int HC = HD / EPC;               // copies of an hd row
  const int cps = 3 * HC + jc / EPC;         // copies of a step
  for (int idx = threadIdx.x; idx < steps * cps; idx += blockDim.x) {
    const int tt = idx / cps, c = idx - tt * cps;
    const bool valid = t0 + tt < T_;
    const long long g = base + (valid ? (long long)(t0 + tt) * step : 0);
    const T* src = c < HC ? r + g + c * EPC
                 : c < 2 * HC ? k + g + (c - HC) * EPC
                 : c < 3 * HC ? w + g + (c - 2 * HC) * EPC
                 : v + g + j0 + (c - 3 * HC) * EPC;
    cp_async16(slot + 16 * idx, src, valid);
  }
}

// bf16 slot -> fp32 buffer of the same layout, 8 elements a thread a turn.
__device__ __forceinline__ void widen(float* dst, const char* slot, int n) {
  for (int idx = threadIdx.x; idx < n / 8; idx += blockDim.x) {
    const uint4 p = reinterpret_cast<const uint4*>(slot)[idx];
    const uint32_t x[4] = {p.x, p.y, p.z, p.w};
    float f[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(x[e] << 16);
      f[2 * e + 1] = __uint_as_float(x[e] & 0xffff0000u);
    }
    reinterpret_cast<float4*>(dst)[2 * idx] =
        make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[2 * idx + 1] =
        make_float4(f[4], f[5], f[6], f[7]);
  }
}

// A stage's outputs (steps x jc in obuf) to out, 16 bytes a store.
template <typename T>
__device__ __forceinline__ void store_stage(
    T* __restrict__ out, const T* obuf, long long base, long long step,
    int j0, int t0, int T_, int steps, int jc) {
  constexpr int EPC = 16 / sizeof(T);
  const int oc = jc / EPC;                   // stores of a step
  for (int idx = threadIdx.x; idx < steps * oc; idx += blockDim.x) {
    const int tt = idx / oc, c = idx - tt * oc;
    if (t0 + tt < T_)
      *reinterpret_cast<uint4*>(out + base + (long long)(t0 + tt) * step +
                                j0 + c * EPC) =
          reinterpret_cast<const uint4*>(obuf)[idx];
  }
}

// out[tt][g COLS + c] = bonus[tt] v[tt][g COLS + c] + the sum over q of
// part[tt][g][q][c] (group rows padded by 4 floats: a quarter-warp's
// 16-byte accesses fall in distinct banks both when a step's lanes write
// and here), into obuf, for tt < tn; wk the stage's widened records.
template <typename T, int HD, int NS, int COLS>
__device__ __forceinline__ void reduce_stage(T* obuf, const float* part,
                                             const float* bonus,
                                             const float* wk, int jc,
                                             int tn) {
  constexpr int GS = NS * COLS + 4;          // floats of a group's row
  const int groups = jc / COLS;
  for (int idx = threadIdx.x; idx < tn * groups; idx += blockDim.x) {
    const int tt = idx / groups, g = idx - tt * groups;
    const float* p = part + (tt * groups + g) * GS;
    float acc[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      if constexpr (COLS == 2) {
        const float2 x = *reinterpret_cast<const float2*>(p + 2 * q);
        acc[0] += x.x, acc[1] += x.y;
      } else {
        const float4 x = *reinterpret_cast<const float4*>(p + 4 * q);
        acc[0] += x.x, acc[1] += x.y, acc[2] += x.z, acc[3] += x.w;
      }
    }
    const float* vt = wk + tt * (3 * HD + jc) + 3 * HD + g * COLS;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      obuf[tt * jc + g * COLS + c] = from_f<T>(fmaf(bonus[tt], vt[c], acc[c]));
  }
}

// bonus[tt] = sum_i r_i u_i k_i of each step tt < tn of the stage: warp w
// takes steps w, w + warps, ...; lane l rows l, l + 32, ... (ub holds
// u there), summed over the warp by shuffles.
template <int HD>
__device__ __forceinline__ void bonus_stage(float* bonus, const float* wk,
                                            const float* ub, int jc,
                                            int tn) {
  constexpr int NB = (HD + 31) / 32;
  const int lane = threadIdx.x & 31, warps = blockDim.x / 32;
  for (int tt = threadIdx.x / 32; tt < tn; tt += warps) {
    const float* x = wk + tt * (3 * HD + jc);
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (lane + 32 * j < HD)
        a = fmaf(x[lane + 32 * j] * ub[j], x[HD + lane + 32 * j], a);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) bonus[tt] = a;
  }
}

// One step's operands of a thread, from a widened record x: r, k, w at
// its rows (float4 chunks q, q + ns, ...), v at its columns.
template <int ROWS, int COLS>
struct Operands {
  float4 r[ROWS / 4], k[ROWS / 4], w[ROWS / 4];
  float v[COLS];
  __device__ __forceinline__ void load(const float* x, int hd, int cg,
                                       int q, int ns) {
#pragma unroll
    for (int m = 0; m < ROWS / 4; ++m) {
      const int i4 = 4 * (q + ns * m);
      r[m] = *reinterpret_cast<const float4*>(x + i4);
      k[m] = *reinterpret_cast<const float4*>(x + hd + i4);
      w[m] = *reinterpret_cast<const float4*>(x + 2 * hd + i4);
    }
    const float* xv = x + 3 * hd + cg * COLS;
    if constexpr (COLS == 2) {
      const float2 v2 = *reinterpret_cast<const float2*>(xv);
      v[0] = v2.x, v[1] = v2.y;
    } else {
      const float4 v4 = *reinterpret_cast<const float4*>(xv);
      v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
    }
  }
};

// r, k, v, w, out: (B, T, H, HD); u: (H, HD), fp32 or (u_bf16) bf16.
// Grid B*H*(HD/jc), blockDim (jc/COLS)*(HD/ROWS); dynamic shared
// memory (smem_bytes): stages slots of steps records (3 HD + jc elements),
// bf16's fp32 work buffer of one slot, the partial sums of steps steps,
// two output buffers of steps x jc.
template <typename T, int HD, int ROWS, int COLS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const void* __restrict__ u, int u_bf16, T* __restrict__ out,
           int T_, int H, int jc, int steps, int stages) {
  constexpr int NS = HD / ROWS;              // lanes a column group
  constexpr int NM = ROWS / 4;               // float4 chunks a thread
  constexpr int GS = NS * COLS + 4;          // partials of a group a step
  constexpr bool WIDEN = sizeof(T) == 2;
  static_assert(COLS == 2 || COLS == 4, "COLS");
  extern __shared__ __align__(16) char smem[];
  const int ncb = HD / jc;
  const int bh = blockIdx.x / ncb, j0 = (blockIdx.x - bh * ncb) * jc;
  const int b = bh / H, h = bh - b * H;
  // the column group runs fastest over the threads: the 8 lanes of a
  // quarter-warp share their rows, so a 16-byte load of r, k or w reads
  // one address a quarter-warp (a broadcast, not 8 chunks)
  const int groups = jc / COLS;
  const int q = threadIdx.x / groups, cg = threadIdx.x - q * groups;
  const int rec = 3 * HD + jc;               // elements of a step
  const int slot_bytes = steps * rec * (int)sizeof(T);
  const int part_step = jc / COLS * GS;      // partial floats a step
  char* ring = smem;
  float* work = reinterpret_cast<float*>(smem + stages * slot_bytes);
  float* part = work + (WIDEN ? steps * rec : 0);
  float* bonus = part + steps * part_step;
  T* obuf = reinterpret_cast<T*>(bonus + ((steps + 3) & ~3));
  const long long step = (long long)H * HD;
  const long long base = ((long long)b * T_ * H + h) * HD;

  float S[ROWS][COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) S[i][c] = 0.f;
  // u at the rows this thread's lane takes in the bonus pass
  float ub[(HD + 31) / 32];
#pragma unroll
  for (int j = 0; j < (HD + 31) / 32; ++j) {
    const int i = min(h * HD + (int)(threadIdx.x & 31) + 32 * j, H * HD - 1);
    ub[j] = u_bf16 ? to_f(static_cast<const __nv_bfloat16*>(u)[i])
                   : static_cast<const float*>(u)[i];
  }

  const int nstage = (T_ + steps - 1) / steps;
  for (int g = 0; g < stages - 1; ++g) {
    if (g < nstage)
      load_stage<T, HD>(ring + g * slot_bytes, r, k, w, v, base, step, j0,
                        g * steps, T_, steps, jc);
    cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    // stage s landed (this thread's copies, then everyone's); every
    // thread is done with stage s - 1, so its slot and buffers are free
    cp_async_wait_upto(stages - 2);
    __syncthreads();
    const int g = s + stages - 1;
    if (g < nstage)
      load_stage<T, HD>(ring + (g % stages) * slot_bytes, r, k, w, v, base,
                        step, j0, g * steps, T_, steps, jc);
    cp_async_commit();
    if (s > 0)
      store_stage<T>(out, obuf + ((s - 1) & 1) * steps * jc, base, step, j0,
                     (s - 1) * steps, T_, steps, jc);
    const char* slot = ring + (s % stages) * slot_bytes;
    const float* wk = reinterpret_cast<const float*>(slot);
    if constexpr (WIDEN) {
      widen(work, slot, steps * rec);
      __syncthreads();
      wk = work;
    }
    const int tn = min(steps, T_ - s * steps);
    bonus_stage<HD>(bonus, wk, ub, jc, tn);
    float* my_part = part + cg * GS + q * COLS;
    Operands<ROWS, COLS> cur, nxt;
    cur.load(wk, HD, cg, q, NS);
#pragma unroll 2
    for (int tt = 0; tt < tn; ++tt) {
      nxt.load(wk + min(tt + 1, tn - 1) * rec, HD, cg, q, NS);
      float o[COLS][2];
#pragma unroll
      for (int c = 0; c < COLS; ++c) o[c][0] = o[c][1] = 0.f;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float rv[4] = {cur.r[m].x, cur.r[m].y, cur.r[m].z, cur.r[m].w};
        const float kv4[4] = {cur.k[m].x, cur.k[m].y, cur.k[m].z,
                              cur.k[m].w};
        const float wv[4] = {cur.w[m].x, cur.w[m].y, cur.w[m].z, cur.w[m].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * m + e;
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            o[c][e & 1] = fmaf(rv[e], S[i][c], o[c][e & 1]);
            S[i][c] = fmaf(S[i][c], wv[e], kv4[e] * cur.v[c]);
          }
        }
      }
      float* dst = my_part + tt * part_step;
      if constexpr (COLS == 2) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(o[0][0] + o[0][1], o[1][0] + o[1][1]);
      } else {
        *reinterpret_cast<float4*>(dst) =
            make_float4(o[0][0] + o[0][1], o[1][0] + o[1][1],
                        o[2][0] + o[2][1], o[3][0] + o[3][1]);
      }
      cur = nxt;
    }
    __syncthreads();
    reduce_stage<T, HD, NS, COLS>(obuf + (s & 1) * steps * jc, part, bonus,
                                  wk, jc, tn);
  }
  __syncthreads();
  if (nstage > 0)
    store_stage<T>(out, obuf + ((nstage - 1) & 1) * steps * jc, base, step,
                   j0, (nstage - 1) * steps, T_, steps, jc);
}

// The dynamic shared bytes of a launch; the Python planner computes the
// same (WkvPlan.smem) and the launch refuses any other.
int smem_bytes(int esize, int hd, int rows, int cols, int jc, int steps,
               int stages) {
  const int rec = 3 * hd + jc;
  const int part = jc / cols * (hd / rows * cols + 4);
  return stages * steps * rec * esize + (esize == 2 ? steps * rec * 4 : 0) +
         (steps * part + ((steps + 3) & ~3)) * 4 + 2 * steps * jc * esize;
}

struct Args {
  const void *r, *k, *v, *w, *u;
  void* out;
  int u_bf16, B, T, H, jc, steps, stages, smem;
  cudaStream_t s;
};

template <typename T, int HD>
int launch(const Args& a) {
  constexpr int ROWS = tile_rows<T>(HD), COLS = tile_cols<T>(HD);
  static int configured = 0;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<T, HD, ROWS, COLS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return (int)err;
    configured = 1;
  }
  wkv_kernel<T, HD, ROWS, COLS>
      <<<a.B * a.H * (HD / a.jc), a.jc / COLS * (HD / ROWS), a.smem, a.s>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.w),
      a.u, a.u_bf16, static_cast<T*>(a.out), a.T, a.H, a.jc, a.steps,
      a.stages);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const Args& a, int hd) {
  switch (hd) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// hd in {16, 32, 64, 128}; dtype 0 = fp32, 1 = bf16 (r, k, v, w and out);
// u_dtype the same for u.  jc (columns a CTA), rows and cols (of the
// state a thread holds: the compiled tile of TILES), steps (a stage),
// stages (2-4) and smem are the Python planner's (WkvPlan).  Returns the
// cudaError_t of the launch, cudaErrorInvalidValue for a geometry this
// file does not take.
int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* out, int B, int T_,
                     int H, int hd, int dtype, int u_dtype, int jc, int rows,
                     int cols, int steps, int stages, int smem,
                     void* stream) {
  const int esize = dtype == 1 ? 2 : 4;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128)
    return (int)cudaErrorInvalidValue;
  const int* tile = TILES[tile_row(hd)] + (dtype == 1 ? 3 : 1);
  if (rows != tile[0] || cols != tile[1] || jc < 1 || hd % jc ||
      (jc * esize) % 16 || jc % cols || (jc / cols * (hd / rows)) % 32 ||
      jc / cols * (hd / rows) > MAX_THREADS || steps < 1 || stages < 2 ||
      stages > 4 || T_ < 1 ||
      smem != smem_bytes(esize, hd, rows, cols, jc, steps, stages))
    return (int)cudaErrorInvalidValue;
  const Args a{r, k, v, w, u, out, u_dtype == 1, B, T_, H, jc, steps,
               stages, smem, static_cast<cudaStream_t>(stream)};
  return dtype == 1 ? launch_hd<__nv_bfloat16>(a, hd)
                    : launch_hd<float>(a, hd);
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
