// Mamba2 SSD chunked scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces src/repro/kernels/ssd_scan.py:ssd_scan (the Pallas kernel
// _ssd_kernel).  With chunks of L steps, cum_i the inclusive cumsum of
// dt_t * A_h inside a chunk and tot = cum_{L-1}:
//
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) * C_i . state_in
//   state'  = exp(tot) state_in + sum_i dt_i exp(tot - cum_i) x_i B_i^T
//
// with grouped B/C (head h reads group h / (heads per group)).  Positions
// past the sequence end load as x = B = C = dt = 0: dt = 0 keeps cum flat
// and contributes nothing, exactly the Pallas kernel's dt = 0 padding.
// y comes out in x's dtype, the final state in f32.
//
// What bounds it on an H100: x and y (b*s*h*p each) dominate the bytes;
// at hymba-1.5b's shape (b 8, s 2048, h 50, p 64, n 16, L 128, bf16) that
// is 210 MB, 0.064 ms at 3.35 TB/s, against ~35 GFLOP of tensor-core work
// (the bf16 pairs below included), so the bound is the bytes.
//
// The design is the chunk-parallel SSD of Dao & Gu (arXiv:2405.21060), the
// form src/repro/models/ssm.py:ssd_chunked computes, in three launches on
// one stream; every chunk of every head is independent in (a) and (c):
//
//  (a) ssd_state_kernel, one CTA per (batch, chunk, group, block of <= 5
//      heads of the group): for each head, the chunk's own state
//      contribution sum_i dt_i exp(tot - cum_i) x_i B_i^T and tot, to a
//      workspace.  The CTA of head block 0 also computes C.B^T of its
//      (batch, chunk, group) - once, for all heads of the group - and
//      stores its lower triangle of 16 x 16 tiles in the mma accumulator
//      fragment order, so (c) reads each lane's values as two float4.
//  (b) ssd_pass_kernel, one thread per (batch, head, state entry): the
//      recurrence state = state * exp(tot_c) + S_c over the chunks, in f32;
//      it writes the state entering each chunk (for bf16, as a bf16 pair
//      hi + lo) and the final state.
//  (c) ssd_scan_kernel, the grid of (a): for each head, M = C.B^T *
//      exp(cum_i - cum_j) * dt_j (j <= i) built in registers from the
//      stored C.B^T, y = exp(cum_i) * C . state_in + M . x, rounded to y's
//      dtype once.
//
// Why three launches and not one with a decoupled look-back: the chunk
// states cross memory either way, (b) is 2 x 26 MB at hymba's shape, and
// three launches need no flags, no tile counter and no state that outlives
// a call; x is read twice (by (a) and (c)), which puts the byte floor at
// ~1.5x the one-pass bound.
//
// Inside (a) and (c):
//  - The cumsum is a warp scan (four rows a lane, then shuffles), one
//    warp per head, for all heads of the CTA before the head loop; (a) and
//    (c) run the same code, so both see the same cum.
//  - The heads of a CTA stream through a ring of one or two buffers: x (and
//    in (c) the entering state) by 16-byte cp.async, the next head's copy
//    in flight while the current head computes when two buffers keep as
//    many CTAs on an SM as one.  The launcher sizes the head blocks for
//    about four waves of CTAs (at most 5 heads a CTA).
//  - bf16 runs every product on the tensor cores (mma.sync m16n8k16, f32
//    accumulate): C.B^T from bf16 C and B (exact products); M.x with M as
//    a bf16 pair hi + lo (two products) and x from shared memory by
//    ldmatrix.trans; C.state with the state as a pair; the chunk state as
//    x^T (ldmatrix.trans) times (w_i B_i) as a pair.  An f32 operand is
//    never rounded to one bf16: the pair keeps ~16 bits, so y lands within
//    one bf16 ulp and the state within 1e-4 of the f32 plain version.
//  - f32 runs the same grid on the CUDA cores: C.B^T and the chunk state
//    as register-tiled FMA over shared memory, M written to a per-warp
//    slab of shared memory and M.x read from it.
//  - M below the diagonal tile takes exp(cum_i - cum_j) as exp(cum_i -
//    cum_e) * exp(cum_e - cum_j), e the 16-column tile's last column: both
//    factors are <= 1, the second (times dt_j) is kept per column, so a
//    lane takes 2 exponentials per tile, not 8.  The diagonal tile uses a
//    select, so exp(cum_i - cum_j) above the diagonal (which overflows;
//    inf * 0 = NaN) never reaches a sum.
//  - Rows are padded to a multiple of 16 (Lp) and d_state to a multiple of
//    16 with zeros in shared memory.  In (c) warp w takes the 16-row slabs
//    w and 7 - w, so the causal work is even over the four warps, and a
//    bf16 row of y leaves as 16-byte pieces gathered across the quad of
//    lanes that holds it (shuffles), so every row is written in whole
//    sectors.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): at hymba's shape
// (a) ~0.07 ms, (b) ~0.02 ms and (c) ~0.16 ms, about 4x the one-pass
// byte bound; (c) is held by the mma.sync issue (704 tensor-core products
// per head and chunk, half of them for the lo halves) and the
// exponentials, not by bytes.
//
// ssd_forward enqueues the three launches on the given stream and returns
// cudaGetLastError(); ssd_workspace_bytes gives the workspace a call of
// that shape needs (chunk states, entering states, tot, C.B^T).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;          // (a) and (c): four warps
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 256;
constexpr int kMaxSmem = 232448;       // bytes a block may use on sm_90
constexpr int kMaxN = 128;             // d_state the kernel takes
constexpr int kMaxL = 128;             // chunk length the kernel takes
constexpr int kMaxHeads = 5;           // heads per CTA at most
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ constexpr int n_tiles(int Lp) { return (Lp / 16) * (Lp / 16 + 1) / 2; }

// elements of padding after each shared-memory row: 16 bytes, so that
// ldmatrix's eight row addresses fall in eight distinct bank groups
template <typename T> struct Pad { static constexpr int V = 16 / sizeof(T); };

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16_rn(0.0f); }

// ---------------------------------------------------------------------------
// shared-memory layouts (host and device); nb buffers of the per-head data,
// hpc heads per CTA
// ---------------------------------------------------------------------------

struct StateSmem { int xs, bs, cs, w, tot, bytes; };
struct ScanSmem { int xs, cs, st, cb, ms, dts, cum, fj, bytes; };

template <typename T>
__host__ __device__ StateSmem state_smem(int P, int n, int L, int nb, int hpc) {
  const int Lp = round16(L), ldx = P + Pad<T>::V, ldk = round16(n) + Pad<T>::V;
  const int e = static_cast<int>(sizeof(T));
  StateSmem s;
  int o = 0;
  s.xs = o; o += nb * Lp * ldx * e;          // x of a head (per buffer)
  s.bs = o; o += Lp * ldk * e;               // B of the group
  s.cs = o; o += Lp * ldk * e;               // C of the group (head block 0)
  s.w = o; o += hpc * Lp * 4;                // dt, then w_i = dt_i exp(tot - cum_i)
  s.tot = o; o += round16(hpc * 4);          // tot per head
  s.bytes = o;
  return s;
}

template <typename T>
__host__ __device__ ScanSmem scan_smem(int P, int n, int L, int nb, int hpc) {
  const int Lp = round16(L), ldx = P + Pad<T>::V, ldk = round16(n) + Pad<T>::V;
  const int e = static_cast<int>(sizeof(T));
  ScanSmem s;
  int o = 0;
  s.xs = o; o += nb * Lp * ldx * e;          // x of a head (per buffer)
  s.cs = o; o += Lp * ldk * e;               // C of the group
  s.st = o; o += nb * P * ldk * 4;           // entering state: bf16 hi and lo planes, or f32
  s.cb = o; o += n_tiles(Lp) * 1024;         // C.B^T tiles in fragment order
  s.ms = o; o += e == 4 ? kWarps * 16 * (Lp + 4) * 4 : 0;   // f32: a warp's slab of M
  s.dts = o; o += hpc * Lp * 4;              // dt per head
  s.cum = o; o += hpc * Lp * 4;              // cum per head
  s.fj = o; o += hpc * Lp * 4;               // dt_j exp(cum_{j | 15} - cum_j) per head
  s.bytes = o;
  return s;
}

// ---------------------------------------------------------------------------
// tensor-core and copy helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// two f32 as a bf16 pair (x0 in the low half), and the pair of what
// rounding left over, so that hi + lo carries ~16 bits of each value
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 16 bytes global -> shared, bypassing L1; zeros when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0 or 1: the ring has at most two
// buffers) of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending > 0)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// y for one row of a 16-row slab from the mma accumulators of a quad (the
// four lanes that hold the row, two columns of each 8-column tile apiece):
// lane q of the quad gathers tile 4g + q's eight columns from the quad by
// shuffles and stores them as one 16-byte piece (when `ok`), so every row
// leaves in whole sectors.  v[t] is the lane's bf16 pair of tile 4g + t;
// every lane of the warp calls it.
__device__ __forceinline__ void store_row_quad(bf16* row, bool ok, int g,
                                               const uint32_t (&v)[4], int lane) {
  const int q = lane & 3;
  uint32_t out[4];
#pragma unroll
  for (int sft = 0; sft < 4; ++sft) {
    const int t = q ^ sft;   // the tile this lane sends on this round
    const uint32_t send = t == 0 ? v[0] : t == 1 ? v[1] : t == 2 ? v[2] : v[3];
    const uint32_t got = __shfl_xor_sync(kFull, send, sft);
    // lane q ^ sft sent its pair of tile q: columns 2 (q ^ sft) .. + 1
    const int src = q ^ sft;
    if (src == 0) out[0] = got;
    if (src == 1) out[1] = got;
    if (src == 2) out[2] = got;
    if (src == 3) out[3] = got;
  }
  if (ok)
    *reinterpret_cast<uint4*>(row + (4 * g + q) * 8) = make_uint4(out[0], out[1], out[2], out[3]);
}

// rows [0, rows) of `width` T values into dst (row stride ld), from src +
// r * stride; rows at or past `valid` arrive as zeros.  width * sizeof(T)
// is a multiple of 16.
template <typename T>
__device__ __forceinline__ void async_rows(T* dst, int ld, const T* src, long long stride,
                                           int rows, int valid, int width) {
  constexpr int V = 16 / sizeof(T);
  const int per = width / V;
  for (int idx = threadIdx.x; idx < rows * per; idx += kThreads) {
    const int r = idx / per, v = idx - r * per;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + v * V, ok ? src + r * stride + v * V : src, ok);
  }
}

// columns [n, np) of `rows` rows set to zero (the d_state padding)
template <typename T>
__device__ __forceinline__ void zero_cols(T* dst, int ld, int rows, int n, int np) {
  const int w = np - n;
  for (int idx = threadIdx.x; idx < rows * w; idx += kThreads)
    dst[(idx / w) * ld + n + idx % w] = zero<T>();
}

// dt of the CTA's heads h0 .. h0 + nh - 1 for the chunk's rows (0 past
// `valid`): out[hc * Lp + i]
__device__ __forceinline__ void load_dt(float* out, const float* __restrict__ dt, long long row0,
                                        int h, int h0, int nh, int Lp, int valid) {
  for (int idx = threadIdx.x; idx < Lp * nh; idx += kThreads) {
    const int i = idx / nh, hc = idx - i * nh;
    out[hc * Lp + i] = i < valid ? dt[(row0 + i) * h + h0 + hc] : 0.0f;
  }
}

// Inclusive cumsum of dt_i * a over rows 0 .. Lp - 1 by one warp (Lp a
// multiple of 16, at most 128): lane l sums rows 4l .. 4l + 3 in order,
// then the lanes' totals are scanned by shuffles.  Each step rounds
// (no contraction).  Returns the four values of the lane's rows.
__device__ __forceinline__ void warp_cumsum(const float* dts, float a, int Lp, int lane,
                                            float (&v)[4]) {
  float run = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * lane + e;
    run = __fadd_rn(run, __fmul_rn(i < Lp ? dts[i] : 0.0f, a));
    v[e] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc = __fadd_rn(inc, t);
  }
  float excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(excl, v[e]);
}

// which head block, heads and chunk rows a CTA of (a) or (c) owns
struct Cta {
  int gi, c, bi, h0, nh, t0, valid;
  long long row0;
  __device__ Cta(int s, int h, int g, int L, int nhb) {
    gi = blockIdx.x / nhb;
    const int hb = blockIdx.x - gi * nhb, hpg = h / g;
    c = blockIdx.y;
    bi = blockIdx.z;
    h0 = gi * hpg + hb * hpg / nhb;
    nh = gi * hpg + (hb + 1) * hpg / nhb - h0;
    t0 = c * L;
    valid = min(L, s - t0);
    row0 = static_cast<long long>(bi) * s + t0;
  }
};

// ---------------------------------------------------------------------------
// (a) chunk states, and C.B^T once per (batch, chunk, group)
// ---------------------------------------------------------------------------

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(float* __restrict__ states, float* __restrict__ totals, float* __restrict__ cbuf,
                 const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, int s, int h, int g, int n, int L, int nhb, int nb,
                 int hpc) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Cta k(s, h, g, L, nhb);
  const int nc = gridDim.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Lp = round16(L), np = round16(n), ntiles = n_tiles(Lp);
  const int ldx = P + Pad<T>::V, ldk = np + Pad<T>::V;
  const StateSmem lay = state_smem<T>(P, n, L, nb, hpc);
  T* xs = reinterpret_cast<T*>(smem + lay.xs);
  T* bs = reinterpret_cast<T*>(smem + lay.bs);
  T* cs = reinterpret_cast<T*>(smem + lay.cs);
  float* ws = reinterpret_cast<float*>(smem + lay.w);
  float* tots = reinterpret_cast<float*>(smem + lay.tot);
  const bool with_cb = blockIdx.x % nhb == 0;

  zero_cols(bs, ldk, Lp, n, np);
  if (with_cb) zero_cols(cs, ldk, Lp, n, np);
  load_dt(ws, dt, k.row0, h, k.h0, k.nh, Lp, k.valid);
  const long long gstride = static_cast<long long>(g) * n;
  async_rows<T>(bs, ldk, Bm + k.row0 * gstride + k.gi * n, gstride, Lp, k.valid, n);
  if (with_cb) async_rows<T>(cs, ldk, Cm + k.row0 * gstride + k.gi * n, gstride, Lp, k.valid, n);
  const long long xstride = static_cast<long long>(h) * P;
  auto issue_x = [&](int hc) {
    async_rows<T>(xs + (hc % nb) * Lp * ldx, ldx, x + (k.row0 * h + k.h0 + hc) * P, xstride,
                  Lp, k.valid, P);
    cp_async_commit();
  };
  for (int hc = 0; hc < min(nb, k.nh); ++hc) issue_x(hc);   // B and C ride with head 0
  __syncthreads();

  // cum, tot and w_i = dt_i exp(tot - cum_i) per head, one warp a head
  for (int hc = warp; hc < k.nh; hc += kWarps) {
    float* w = ws + hc * Lp;
    float v[4], d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = 4 * lane + e < Lp ? w[4 * lane + e] : 0.0f;
    warp_cumsum(w, A[k.h0 + hc], Lp, lane, v);
    const float tot = __shfl_sync(kFull, v[3], (Lp - 1) / 4);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * lane + e < Lp) w[4 * lane + e] = d[e] * expf(tot - v[e]);
    if (lane == 0) tots[hc] = tot;
  }

  // x of head 0 (and B, C) in shared memory
  cp_async_wait(min(nb, k.nh) - 1);
  __syncthreads();
  // C.B^T of the (batch, chunk, group): lower tiles (slab, kb), kb <= slab,
  // each lane's 2 x 4 accumulator values as two float4
  if (with_cb) {
    float4* cbo = reinterpret_cast<float4*>(cbuf) +
                  ((static_cast<long long>(k.bi) * nc + k.c) * g + k.gi) * ntiles * 64;
    for (int t = warp; t < ntiles; t += kWarps) {
      int sl = 0;
      while ((sl + 1) * (sl + 2) / 2 <= t) ++sl;
      const int kb = t - sl * (sl + 1) / 2;
      float d[2][4] = {};
      if constexpr (kMma) {
        for (int ks = 0; ks < np / 16; ++ks) {
          uint32_t a[4], b[4];
          ldsm_x4(a, cs + (sl * 16 + (lane & 15)) * ldk + ks * 16 + (lane >> 4) * 8);
          ldsm_x4(b, bs + (kb * 16 + (lane & 7) + (lane >> 4) * 8) * ldk + ks * 16 +
                         ((lane >> 3) & 1) * 8);
          mma_bf16(d[0], a, b[0], b[1]);
          mma_bf16(d[1], a, b[2], b[3]);
        }
      } else {
        const int ia = sl * 16 + (lane >> 2), jb = kb * 16 + 2 * (lane & 3);
        for (int kk = 0; kk < n; kk += 4) {
          const float4 ca = *reinterpret_cast<const float4*>(cs + ia * ldk + kk);
          const float4 cb = *reinterpret_cast<const float4*>(cs + (ia + 8) * ldk + kk);
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float4 bj =
                  *reinterpret_cast<const float4*>(bs + (jb + 8 * half + e) * ldk + kk);
              d[half][e] = fmaf(ca.w, bj.w, fmaf(ca.z, bj.z, fmaf(ca.y, bj.y,
                                fmaf(ca.x, bj.x, d[half][e]))));
              d[half][2 + e] = fmaf(cb.w, bj.w, fmaf(cb.z, bj.z, fmaf(cb.y, bj.y,
                                    fmaf(cb.x, bj.x, d[half][2 + e]))));
            }
        }
      }
      cbo[t * 64 + lane] = make_float4(d[0][0], d[0][1], d[0][2], d[0][3]);
      cbo[t * 64 + 32 + lane] = make_float4(d[1][0], d[1][1], d[1][2], d[1][3]);
    }
  }

  // a ring of nb head buffers: head hc + nb is fetched while heads hc + 1
  // .. hc + nb - 1 are in flight and head hc computes
  for (int hc = 0; hc < k.nh; ++hc) {
    if (hc > 0) {
      cp_async_wait(min(nb, k.nh - hc) - 1);
      __syncthreads();
    }
    const T* xb = xs + (hc % nb) * Lp * ldx;
    const float* w = ws + hc * Lp;
    const long long blk = (static_cast<long long>(k.bi) * nc + k.c) * h + k.h0 + hc;
    float* out = states + blk * P * n;
    if constexpr (kMma) {
      // S (P x n) = x^T (P x Lp) . (w B) (Lp x n): x^T by ldmatrix.trans,
      // w B as a bf16 pair built in registers
      // work items: (16 rows of S, 16 columns of S)
      for (int it = warp; it < (P / 16) * (np / 16); it += kWarps) {
        const int mt = it / (np / 16), nq = it % (np / 16);
        float acc[2][4] = {};
        const bf16* xa = xb + ((lane & 7) + (lane >> 4) * 8) * ldx + mt * 16 + ((lane >> 3) & 1) * 8;
        const bf16* bc = bs + 2 * (lane & 3) * ldk + nq * 16 + (lane >> 2);
        const float* wq = w + 2 * (lane & 3);
#pragma unroll 4
        for (int ks = 0; ks < Lp / 16; ++ks) {
          uint32_t a[4];
          ldsm_x4_trans(a, xa + ks * 16 * ldx);
          const float* wk = wq + ks * 16;
          const float w0 = wk[0], w1 = wk[1], w8 = wk[8], w9 = wk[9];
          const bf16* bk = bc + ks * 16 * ldk;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t h0, l0, h1, l1;
            split_bf16(w0 * to_f32(bk[nt * 8]), w1 * to_f32(bk[ldk + nt * 8]), h0, l0);
            split_bf16(w8 * to_f32(bk[8 * ldk + nt * 8]), w9 * to_f32(bk[9 * ldk + nt * 8]), h1,
                       l1);
            mma_bf16(acc[nt], a, h0, h1);
            mma_bf16(acc[nt], a, l0, l1);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = nq * 16 + nt * 8 + 2 * (lane & 3);
          if (col < n) {
            const int row = mt * 16 + (lane >> 2);
            *reinterpret_cast<float2*>(out + row * n + col) = make_float2(acc[nt][0], acc[nt][1]);
            *reinterpret_cast<float2*>(out + (row + 8) * n + col) =
                make_float2(acc[nt][2], acc[nt][3]);
          }
        }
      }
    } else {
      // thread item: a 4 x 4 block of S, sum over the chunk's valid rows of
      // (w_i x_i) B_i^T
      const int nq = n / 4;
      for (int it = tid; it < (P / 4) * nq; it += kThreads) {
        const int pr = it / nq, q4 = it - pr * nq;
        float acc[4][4] = {};
        for (int i = 0; i < k.valid; ++i) {
          const float4 xv = *reinterpret_cast<const float4*>(xb + i * ldx + pr * 4);
          const float4 bv = *reinterpret_cast<const float4*>(bs + i * ldk + q4 * 4);
          const float wi = w[i];
          const float xw[4] = {xv.x * wi, xv.y * wi, xv.z * wi, xv.w * wi};
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(xw[r], bb[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(out + (pr * 4 + r) * n + q4 * 4) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    if (tid == 0) totals[blk] = tots[hc];
    if (hc + nb < k.nh) {
      __syncthreads();   // the slot is refilled next
      issue_x(hc + nb);
    }
  }
}

// ---------------------------------------------------------------------------
// (b) the recurrence over the chunk states
// ---------------------------------------------------------------------------

template <bool kSplit>
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(void* __restrict__ enter, float* __restrict__ fin,
                const float* __restrict__ states, const float* __restrict__ totals, int nc,
                int h, int pn) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x, bi = blockIdx.y;
  if (e >= h * pn) return;
  const int hh = e / pn, f = e - hh * pn;
  float st = 0.0f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const long long blk = (static_cast<long long>(bi) * nc + c) * h + hh;
    const float S = states[blk * pn + f];
    const float dec = expf(totals[blk]);
    if constexpr (kSplit) {
      bf16* en = static_cast<bf16*>(enter) + blk * 2 * pn;
      const bf16 hi = __float2bfloat16_rn(st);
      en[f] = hi;
      en[pn + f] = __float2bfloat16_rn(st - __bfloat162float(hi));
    } else {
      static_cast<float*>(enter)[blk * pn + f] = st;
    }
    st = __fadd_rn(__fmul_rn(st, dec), S);
  }
  fin[static_cast<long long>(bi) * h * pn + e] = st;
}

// ---------------------------------------------------------------------------
// (c) y from the stored C.B^T, the entering state and x
// ---------------------------------------------------------------------------

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(T* __restrict__ y, const void* __restrict__ enter,
                const float* __restrict__ cbuf, const T* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ Cm, int s, int h, int g, int n, int L, int nhb, int nb,
                int hpc) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Cta k(s, h, g, L, nhb);
  const int nc = gridDim.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Lp = round16(L), np = round16(n), nsl = Lp / 16, ntiles = n_tiles(Lp);
  const int ldx = P + Pad<T>::V, ldk = np + Pad<T>::V, ldm = Lp + 4;
  const ScanSmem lay = scan_smem<T>(P, n, L, nb, hpc);
  T* xs = reinterpret_cast<T*>(smem + lay.xs);
  T* cs = reinterpret_cast<T*>(smem + lay.cs);
  T* sts = reinterpret_cast<T*>(smem + lay.st);
  const float4* cbs = reinterpret_cast<const float4*>(smem + lay.cb);
  float* ms = reinterpret_cast<float*>(smem + lay.ms) + warp * 16 * ldm;
  float* dts = reinterpret_cast<float*>(smem + lay.dts);
  float* cums = reinterpret_cast<float*>(smem + lay.cum);
  float* fjs = reinterpret_cast<float*>(smem + lay.fj);
  // one state buffer: P x ldk floats (bf16: the hi plane, then the lo plane)
  const int st_elems = P * ldk * 4 / static_cast<int>(sizeof(T));
  const bool with_state = k.c > 0;   // the first chunk enters with state 0

  zero_cols(cs, ldk, Lp, n, np);
  if (with_state) zero_cols(sts, ldk, nb * P * 4 / static_cast<int>(sizeof(T)), n, np);
  load_dt(dts, dt, k.row0, h, k.h0, k.nh, Lp, k.valid);
  const long long gstride = static_cast<long long>(g) * n;
  async_rows<T>(cs, ldk, Cm + k.row0 * gstride + k.gi * n, gstride, Lp, k.valid, n);
  {
    const float4* src = reinterpret_cast<const float4*>(cbuf) +
                        ((static_cast<long long>(k.bi) * nc + k.c) * g + k.gi) * ntiles * 64;
    float4* dst = reinterpret_cast<float4*>(smem + lay.cb);
    for (int i = tid; i < ntiles * 64; i += kThreads) cp_async16(dst + i, src + i, true);
  }
  const long long xstride = static_cast<long long>(h) * P;
  auto issue = [&](int hc) {
    const int buf = hc % nb;
    async_rows<T>(xs + buf * Lp * ldx, ldx, x + (k.row0 * h + k.h0 + hc) * P, xstride, Lp,
                  k.valid, P);
    if (with_state) {
      const long long blk = (static_cast<long long>(k.bi) * nc + k.c) * h + k.h0 + hc;
      const T* src = static_cast<const T*>(enter) + blk * P * n * 4 / sizeof(T);
      T* dst = sts + buf * st_elems;
      // bf16: the hi plane's P rows, then the lo plane's, each n wide
      async_rows<T>(dst, ldk, src, n, st_elems / ldk, st_elems / ldk, n);
    }
    cp_async_commit();
  };
  for (int hc = 0; hc < min(nb, k.nh); ++hc) issue(hc);   // C and C.B^T ride with head 0
  __syncthreads();
  // cum, and fj = dt_j exp(cum_e - cum_j) with e = j | 15 the last row of
  // j's 16-row block, per head, one warp a head
  for (int hc = warp; hc < k.nh; hc += kWarps) {
    float v[4];
    warp_cumsum(dts + hc * Lp, A[k.h0 + hc], Lp, lane, v);
    const float ce = __shfl_sync(kFull, v[3], lane | 3);   // lane 4q + 3 holds row 16q + 15
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * lane + e;
      if (i < Lp) {
        cums[hc * Lp + i] = v[e];
        fjs[hc * Lp + i] = dts[hc * Lp + i] * expf(ce - v[e]);
      }
    }
  }

  for (int hc = 0; hc < k.nh; ++hc) {
    cp_async_wait(min(nb, k.nh - hc) - 1);
    __syncthreads();
    const int buf = hc % nb;
    const T* xb = xs + buf * Lp * ldx;
    const T* sb = sts + buf * st_elems;
    const float* cum = cums + hc * Lp;
    const float* dtv = dts + hc * Lp;
    const float* fj = fjs + hc * Lp;
    T* yh = y + (k.row0 * h + k.h0 + hc) * P;
    // warp w takes slabs w and 2 * kWarps - 1 - w (and so on), so that the
    // causal work is even
    for (int r = 0; r * kWarps < nsl; ++r) {
      const int sl = (r & 1) ? (r + 1) * kWarps - 1 - warp : r * kWarps + warp;
      if (sl >= nsl) continue;
      const int ia = sl * 16 + (lane >> 2), ib = ia + 8;
      const float cia = cum[ia], cib = cum[ib];
      float acc[P / 8][4] = {};
      if (with_state) {
        // acc = exp(cum_i) * C_i . state_in
        if constexpr (kMma) {
          const bf16* shi = sb;
          const bf16* slo = sb + P * ldk;
          for (int ks = 0; ks < np / 16; ++ks) {
            uint32_t a[4];
            ldsm_x4(a, cs + (sl * 16 + (lane & 15)) * ldk + ks * 16 + (lane >> 4) * 8);
            const int soff = ((lane & 7) + (lane >> 4) * 8) * ldk + ks * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int pt = 0; pt < P / 16; ++pt) {
              uint32_t bh[4], bl[4];
              ldsm_x4(bh, shi + pt * 16 * ldk + soff);
              ldsm_x4(bl, slo + pt * 16 * ldk + soff);
              mma_bf16(acc[2 * pt], a, bh[0], bh[1]);
              mma_bf16(acc[2 * pt], a, bl[0], bl[1]);
              mma_bf16(acc[2 * pt + 1], a, bh[2], bh[3]);
              mma_bf16(acc[2 * pt + 1], a, bl[2], bl[3]);
            }
          }
        } else {
          for (int kk = 0; kk < n; ++kk) {
            const float ca = cs[ia * ldk + kk], cb = cs[ib * ldk + kk];
#pragma unroll
            for (int nt = 0; nt < P / 8; ++nt) {
              const int c0 = nt * 8 + 2 * (lane & 3);
              const float s0 = sb[c0 * ldk + kk], s1 = sb[(c0 + 1) * ldk + kk];
              acc[nt][0] = fmaf(ca, s0, acc[nt][0]);
              acc[nt][1] = fmaf(ca, s1, acc[nt][1]);
              acc[nt][2] = fmaf(cb, s0, acc[nt][2]);
              acc[nt][3] = fmaf(cb, s1, acc[nt][3]);
            }
          }
        }
        const float ea = expf(cia), eb = expf(cib);
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          acc[nt][0] *= ea;
          acc[nt][1] *= ea;
          acc[nt][2] *= eb;
          acc[nt][3] *= eb;
        }
      }
      // acc += M . x over the column tiles kb <= sl, M[i][j] = (C_i . B_j)
      // * exp(cum_i - cum_j) * dt_j for j <= i, else 0.  Below the diagonal
      // tile exp(cum_i - cum_j) = exp(cum_i - cum_e) * exp(cum_e - cum_j)
      // with e the tile's last column (both factors <= 1), so a lane takes
      // two exponentials per tile and the per-column factor from fj; the
      // diagonal tile takes the select, since exp above it overflows.
      auto tile = [&](int kb, float m0, float m1, float m2, float m3, float m4, float m5,
                      float m6, float m7) {
        if constexpr (kMma) {
          uint32_t ah[4], al[4];
          split_bf16(m0, m1, ah[0], al[0]);
          split_bf16(m2, m3, ah[1], al[1]);
          split_bf16(m4, m5, ah[2], al[2]);
          split_bf16(m6, m7, ah[3], al[3]);
          const bf16* xr = xb + (kb * 16 + (lane & 15)) * ldx + (lane >> 4) * 8;
#pragma unroll
          for (int pt = 0; pt < P / 16; ++pt) {
            uint32_t bx[4];
            ldsm_x4_trans(bx, xr + pt * 16);
            mma_bf16(acc[2 * pt], ah, bx[0], bx[1]);
            mma_bf16(acc[2 * pt], al, bx[0], bx[1]);
            mma_bf16(acc[2 * pt + 1], ah, bx[2], bx[3]);
            mma_bf16(acc[2 * pt + 1], al, bx[2], bx[3]);
          }
        } else {
          float* ra = ms + (lane >> 2) * ldm + kb * 16 + 2 * (lane & 3);
          float* rb = ra + 8 * ldm;
          ra[0] = m0; ra[1] = m1; ra[8] = m4; ra[9] = m5;
          rb[0] = m2; rb[1] = m3; rb[8] = m6; rb[9] = m7;
        }
      };
      const int tbase = sl * (sl + 1) / 2;
      const float* fq = fj + 2 * (lane & 3);
#pragma unroll 2
      for (int kb = 0; kb < sl; ++kb) {
        const float4 c0 = cbs[(tbase + kb) * 64 + lane], c1 = cbs[(tbase + kb) * 64 + 32 + lane];
        const float ce = cum[kb * 16 + 15];
        const float ra = expf(cia - ce), rb = expf(cib - ce);
        const float* f = fq + kb * 16;
        const float f0 = f[0], f1 = f[1], f8 = f[8], f9 = f[9];
        tile(kb, c0.x * (ra * f0), c0.y * (ra * f1), c0.z * (rb * f0), c0.w * (rb * f1),
             c1.x * (ra * f8), c1.y * (ra * f9), c1.z * (rb * f8), c1.w * (rb * f9));
      }
      {
        const float4 c0 = cbs[(tbase + sl) * 64 + lane], c1 = cbs[(tbase + sl) * 64 + 32 + lane];
        const int j = sl * 16 + 2 * (lane & 3);
        const float cj0 = cum[j], cj1 = cum[j + 1], cj8 = cum[j + 8], cj9 = cum[j + 9];
        const float dj0 = dtv[j], dj1 = dtv[j + 1], dj8 = dtv[j + 8], dj9 = dtv[j + 9];
        tile(sl, j <= ia ? c0.x * expf(cia - cj0) * dj0 : 0.0f,
             j + 1 <= ia ? c0.y * expf(cia - cj1) * dj1 : 0.0f,
             j <= ib ? c0.z * expf(cib - cj0) * dj0 : 0.0f,
             j + 1 <= ib ? c0.w * expf(cib - cj1) * dj1 : 0.0f,
             j + 8 <= ia ? c1.x * expf(cia - cj8) * dj8 : 0.0f,
             j + 9 <= ia ? c1.y * expf(cia - cj9) * dj9 : 0.0f,
             j + 8 <= ib ? c1.z * expf(cib - cj8) * dj8 : 0.0f,
             j + 9 <= ib ? c1.w * expf(cib - cj9) * dj9 : 0.0f);
      }
      if constexpr (!kMma) {
        __syncwarp();
        const float* ra = ms + (lane >> 2) * ldm;
        const float* rb = ra + 8 * ldm;
        const int jn = min((sl + 1) * 16, k.valid);
        for (int jj = 0; jj < jn; ++jj) {
          const float ma = ra[jj], mb = rb[jj];
          const float* xr = xb + jj * ldx + 2 * (lane & 3);
#pragma unroll
          for (int nt = 0; nt < P / 8; ++nt) {
            const float2 xv = *reinterpret_cast<const float2*>(xr + nt * 8);
            acc[nt][0] = fmaf(ma, xv.x, acc[nt][0]);
            acc[nt][1] = fmaf(ma, xv.y, acc[nt][1]);
            acc[nt][2] = fmaf(mb, xv.x, acc[nt][2]);
            acc[nt][3] = fmaf(mb, xv.y, acc[nt][3]);
          }
        }
        __syncwarp();   // the slab is rewritten next
      }
      // y rounded once to its dtype; bf16 rows leave as 16-byte pieces
      if constexpr (kMma) {
#pragma unroll
        for (int gq = 0; gq < P / 32; ++gq) {
          uint32_t va[4], vb[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float* a4 = acc[4 * gq + t];
            const __nv_bfloat162 pa = __floats2bfloat162_rn(a4[0], a4[1]);
            const __nv_bfloat162 pb = __floats2bfloat162_rn(a4[2], a4[3]);
            va[t] = *reinterpret_cast<const uint32_t*>(&pa);
            vb[t] = *reinterpret_cast<const uint32_t*>(&pb);
          }
          store_row_quad(yh + ia * xstride, ia < k.valid, gq, va, lane);
          store_row_quad(yh + ib * xstride, ib < k.valid, gq, vb, lane);
        }
      }
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        const int col = nt * 8 + 2 * (lane & 3);
        if constexpr (!kMma) {
          if (ia < k.valid)
            *reinterpret_cast<float2*>(yh + ia * xstride + col) =
                make_float2(acc[nt][0], acc[nt][1]);
          if (ib < k.valid)
            *reinterpret_cast<float2*>(yh + ib * xstride + col) =
                make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    }
    if (hc + nb < k.nh) {
      __syncthreads();   // the slot is refilled next
      issue(hc + nb);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

constexpr long long align256(long long v) { return (v + 255) & ~255LL; }

struct Work {   // byte offsets of the workspace's parts
  long long states, totals, enter, cbuf, bytes;
};

Work work_layout(int b, int s, int h, int p, int g, int n, int L) {
  const long long nc = (s + L - 1) / L;
  const long long cells = static_cast<long long>(b) * nc * h;
  Work w;
  long long o = 0;
  w.states = o; o += align256(cells * p * n * 4);
  w.totals = o; o += align256(cells * 4);
  w.enter = o; o += align256(cells * p * n * 4);
  w.cbuf = o; o += align256(static_cast<long long>(b) * nc * g * n_tiles(round16(L)) * 1024);
  w.bytes = o;
  return w;
}

struct Plan { int nc, nhb, hpc, nb1, nb3, smem1, smem3; };

// Heads per CTA: enough CTAs for about four waves at the scan kernel's
// occupancy, at most kMaxHeads heads a CTA.
template <typename T>
bool make_plan(Plan& pl, int b, int s, int h, int P, int g, int n, int L) {
  pl.nc = (s + L - 1) / L;
  const int hpg = h / g;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int est = scan_smem<T>(P, n, L, 2, kMaxHeads).bytes;
  if (est > kMaxSmem) est = scan_smem<T>(P, n, L, 1, kMaxHeads).bytes;
  const int per_sm = std::max(1, std::min(kMaxSmem / (est + 1024), 2048 / kThreads));
  const long long units = static_cast<long long>(b) * pl.nc * g;
  const long long want = (4LL * per_sm * sms + units - 1) / units;
  pl.nhb = static_cast<int>(std::min<long long>(
      hpg, std::max<long long>(want, (hpg + kMaxHeads - 1) / kMaxHeads)));
  pl.hpc = (hpg + pl.nhb - 1) / pl.nhb;
  // ring depth: two buffers where that keeps as many CTAs on an SM as one
  auto pick = [&](int one, int two, int& nb, int& smem) {
    const auto per_sm = [](int bytes) { return kMaxSmem / (bytes + 1024); };
    nb = pl.hpc > 1 && two <= kMaxSmem && per_sm(two) >= per_sm(one) ? 2 : 1;
    smem = nb == 2 ? two : one;
    return smem <= kMaxSmem;
  };
  return pick(state_smem<T>(P, n, L, 1, pl.hpc).bytes, state_smem<T>(P, n, L, 2, pl.hpc).bytes,
              pl.nb1, pl.smem1) &&
         pick(scan_smem<T>(P, n, L, 1, pl.hpc).bytes, scan_smem<T>(P, n, L, 2, pl.hpc).bytes,
              pl.nb3, pl.smem3);
}

template <typename T, int P>
int launch(void* y, float* fin, const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, int b, int s, int h, int g, int n, int L, void* ws,
           cudaStream_t stream) {
  Plan pl;
  if (!make_plan<T>(pl, b, s, h, P, g, n, L)) return static_cast<int>(cudaErrorInvalidValue);
  const Work w = work_layout(b, s, h, P, g, n, L);
  auto base = static_cast<unsigned char*>(ws);
  float* states = reinterpret_cast<float*>(base + w.states);
  float* totals = reinterpret_cast<float*>(base + w.totals);
  void* enter = base + w.enter;
  float* cbuf = reinterpret_cast<float*>(base + w.cbuf);
  cudaError_t err = cudaFuncSetAttribute(ssd_state_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g * pl.nhb, pl.nc, b);
  const T* xt = static_cast<const T*>(x);
  ssd_state_kernel<T, P><<<grid, kThreads, pl.smem1, stream>>>(
      states, totals, cbuf, xt, dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), s,
      h, g, n, L, pl.nhb, pl.nb1, pl.hpc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr bool kSplit = std::is_same<T, bf16>::value;
  const int pn = P * n;
  const dim3 pgrid((h * pn + kPassThreads - 1) / kPassThreads, b);
  ssd_pass_kernel<kSplit><<<pgrid, kPassThreads, 0, stream>>>(enter, fin, states, totals, pl.nc,
                                                             h, pn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, P><<<grid, kThreads, pl.smem3, stream>>>(
      static_cast<T*>(y), enter, cbuf, xt, dt, A, static_cast<const T*>(Cm), s, h, g, n, L,
      pl.nhb, pl.nb3, pl.hpc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(void* y, float* fin, const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, int b, int s, int h, int p, int g, int n, int L, void* ws,
             cudaStream_t stream) {
  switch (p) {
    case 32: return launch<T, 32>(y, fin, x, dt, A, Bm, Cm, b, s, h, g, n, L, ws, stream);
    case 64: return launch<T, 64>(y, fin, x, dt, A, Bm, Cm, b, s, h, g, n, L, ws, stream);
    case 128: return launch<T, 128>(y, fin, x, dt, A, Bm, Cm, b, s, h, g, n, L, ws, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool shape_ok(int b, int s, int h, int p, int g, int n, int chunk) {
  return b > 0 && s > 0 && h > 0 && g > 0 && h % g == 0 && n > 0 && n <= kMaxN && n % 8 == 0 &&
         chunk > 0 && chunk <= kMaxL && (p == 32 || p == 64 || p == 128);
}

}  // namespace

extern "C" {

// bytes of the workspace a call of this shape needs, -1 for a shape
// ssd_forward refuses
long long ssd_workspace_bytes(int b, int s, int h, int p, int g, int n, int chunk) {
  if (!shape_ok(b, s, h, p, g, n, chunk)) return -1;
  return work_layout(b, s, h, p, g, n, chunk).bytes;
}

// dtype 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt, A, final
// f32).  ws: ssd_workspace_bytes of scratch, 256-byte aligned; nothing in
// it outlives the call.
int ssd_forward(void* y, void* fin, const void* x, const void* dt, const void* A,
                const void* Bm, const void* Cm, int b, int s, int h, int p, int g, int n,
                int chunk, int dtype, void* ws, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(b, s, h, p, g, n, chunk) || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto finf = static_cast<float*>(fin);
  auto dtf = static_cast<const float*>(dt);
  auto af = static_cast<const float*>(A);
  if (dtype == 0)
    return dispatch<float>(y, finf, x, dtf, af, Bm, Cm, b, s, h, p, g, n, chunk, ws, st);
  if (dtype == 1)
    return dispatch<bf16>(y, finf, x, dtf, af, Bm, Cm, b, s, h, p, g, n, chunk, ws, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
