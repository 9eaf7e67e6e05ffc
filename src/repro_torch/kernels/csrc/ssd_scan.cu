// Mamba2 SSD chunked scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces src/repro/kernels/ssd_scan.py:ssd_scan (the Pallas kernel
// _ssd_kernel).  For every (batch b, head h) it walks the chunks of L steps
// in order, carrying the f32 (p, n) state:
//
//   cum_i   = sum_{t <= i} dt_t * A_h                        (inclusive)
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) * C_i . state_in
//   state'  = exp(cum_L) state_in + sum_i dt_i exp(cum_L - cum_i) x_i B_i^T
//
// with grouped B/C (head h reads group h / (heads per group)).  Positions
// past the sequence end load as x = B = C = dt = 0: dt = 0 keeps cum flat
// and contributes nothing, exactly the Pallas kernel's dt = 0 padding.
// y comes out in x's dtype, the final state in f32.
//
// What bounds it on an H100: per (b, h) and chunk it reads L*(p + 2n) inputs
// and writes L*p outputs for about L*L*(n + p) + 4*L*p*n operations; at
// hymba-1.5b's shapes (L = 128, p = 64, n = 16, bf16) that is about 90
// operations per byte, below the ~295 at which bf16 tensor-core products
// would bind, so the card's bound is the bytes of x and y.  This FMA
// version runs its products in f32 on the CUDA cores (~20 operations per
// byte of bandwidth), so it is limited by its arithmetic, not the bound.
//
// What the design does about it (the simple first version, FMA in f32):
//  - One block of 256 threads per (h, b); the chunk axis, which the TPU
//    walks as its sequential grid axis, is a loop inside the block, and the
//    state stays in shared memory from one chunk to the next.  x, B, C and
//    dt are read from device memory exactly once and y written once; every
//    intermediate (the L x L decay-masked C.B^T, the state) stays on chip.
//    b*h = 400 blocks at hymba's shapes fill the 132 SMs.
//  - The decay mask is a select: exp(cum_i - cum_j) is only evaluated for
//    j <= i, where its argument is <= 0, so the overflow to inf above the
//    diagonal (and inf * 0 = NaN) cannot happen.
//  - Each chunk's x, B and C are staged with 16-byte loads, four in flight
//    per thread (B and C rows must be a multiple of 16 bytes: d_state a
//    multiple of 8).
//  - Products are register-tiled: warp w takes 4 rows of a 32-row slab and
//    lane l the columns l + 32q, so each thread carries 16 (C.B^T) or
//    4 * p/32 (M.x, C.state) independent sums, every shared-memory value
//    feeds 4 FMAs, and the FMA chains overlap instead of waiting on each
//    other; the state update owns (l + 32q, w + 8k) entries the same way.
//    The head size p is a template parameter (32, 64 or 128), d_state and
//    the chunk at most 128.
//  - The L x L matrix M = (C.B^T) * decay * dt is built 32 rows at a time,
//    so that mamba2's n = 128 fits: x (L*p), B and C (L*(n+1) each, rows
//    padded to an odd stride for conflict-free column reads), 32 rows of M
//    and the (p, n+1) state make 216,320 bytes at L = 128, p = 64,
//    n = 128, under the 232,448 a block may use; hymba's n = 16 needs
//    72,960 (3 blocks per SM).
//  - cum is a sequential f32 prefix sum taken by one thread with
//    non-contracting _rn intrinsics: dA_t = dt_t * A rounded, then each
//    partial sum rounded.  XLA's and torch's cumsum may add in another
//    order (torch on the card scans in parallel), so y and the state agree
//    with the plain version to within f32 rounding of cum, not bitwise.
// Tensor-core products (C.B^T and M.x as bf16 mma) are later work.
//
// ssd_forward enqueues on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMB = 32;               // rows of M held at once
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr int kMaxN = 128;            // d_state the kernel takes
constexpr int kMaxL = 128;            // chunk length the kernel takes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Copy `rows` rows of `width` T values (width a multiple of 16 bytes) from
// src + r * row_stride into dst + r * ld as floats; rows at or past `valid`
// read as zero.  Each thread issues four 16-byte loads before it uses any,
// so the chunk's loads overlap instead of waiting one after another.
template <typename T>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int ld,
                                           const T* __restrict__ src, long long row_stride,
                                           int rows, int valid, int width) {
  constexpr int VN = 16 / sizeof(T);
  const int per_row = width / VN;
  const int total = rows * per_row;
  for (int base = 0; base < total; base += 4 * kThreads) {
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * kThreads + static_cast<int>(threadIdx.x);
      const int r = idx / per_row, v = idx % per_row;
      raw[u] = idx < total && r < valid
                   ? __ldg(reinterpret_cast<const uint4*>(src + r * row_stride + v * VN))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * kThreads + static_cast<int>(threadIdx.x);
      if (idx >= total) continue;
      const int r = idx / per_row, v = idx % per_row;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      float* d = dst + r * ld + v * VN;
#pragma unroll
      for (int j = 0; j < VN; ++j) d[j] = to_f32(e[j]);
    }
  }
}

size_t smem_floats(int L, int p, int n) {
  const size_t ldn = n + 1;
  return static_cast<size_t>(L) * p + 2 * L * ldn + kMB * L + p * ldn + 4 * L;
}

template <typename T, int CY>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(T* __restrict__ y, float* __restrict__ fin, const T* __restrict__ x,
           const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, int s, int h, int g,
           int n, int L) {
  constexpr int p = 32 * CY;
  extern __shared__ __align__(16) float sm[];
  const int ldn = n + 1;
  float* xs = sm;                  // L x p      x of the chunk (then w = cw * x)
  float* bs = xs + L * p;          // L x ldn    B
  float* cs = bs + L * ldn;        // L x ldn    C
  float* ms = cs + L * ldn;        // kMB x L    rows of M
  float* st = ms + kMB * L;        // p x ldn    carried state
  float* cum = st + p * ldn;       // L          inclusive cumsum of dt*A
  float* dts = cum + L;            // L          dt
  float* cw = dts + L;             // L          dt_i * exp(cum_L - cum_i)
  float* ec = cw + L;              // L          exp(cum_i)

  const int hi = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gi = hi / (h / g);
  const float a = A[hi];
  for (int e = tid; e < p * ldn; e += kThreads) st[e] = 0.0f;

  const int nc = (s + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    __syncthreads();   // the previous chunk is no longer read
    const int valid = min(L, s - t0);
    const long long row0 = static_cast<long long>(bi) * s + t0;
    stage_rows<T>(xs, p, x + (row0 * h + hi) * p, static_cast<long long>(h) * p, L, valid, p);
    stage_rows<T>(bs, ldn, Bm + (row0 * g + gi) * n, static_cast<long long>(g) * n, L, valid, n);
    stage_rows<T>(cs, ldn, Cm + (row0 * g + gi) * n, static_cast<long long>(g) * n, L, valid, n);
    for (int i = tid; i < L; i += kThreads) {
      const int t = t0 + i;
      dts[i] = t < s ? dt[(static_cast<long long>(bi) * s + t) * h + hi] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int i = 0; i < L; ++i) {
        run = __fadd_rn(run, __fmul_rn(dts[i], a));
        cum[i] = run;
      }
    }
    __syncthreads();
    const float total = cum[L - 1];
    for (int i = tid; i < L; i += kThreads) {
      cw[i] = dts[i] * expf(total - cum[i]);
      ec[i] = expf(cum[i]);
    }

    // Rows i0 .. i0 + mb - 1 at a time.  Warp w owns rows rb .. rb + 3
    // (rb = i0 + 4w); lane l owns the columns l + 32q of M and of y.
    // Every thread keeps 16 (M) or 4*CY (y) independent sums in registers,
    // so the FMA chains overlap and each shared-memory value feeds 4 FMAs.
    for (int i0 = 0; i0 < L; i0 += kMB) {
      const int mb = min(kMB, L - i0);
      const int rb = i0 + warp * 4;
      const bool rows = warp * 4 < mb;
      // column groups holding some j <= the warp's last row (M is zero past
      // the diagonal, so later groups are skipped)
      const int rlast = min(rb + 3, i0 + mb - 1);
      const int ng = rows ? min((L + 31) / 32, rlast / 32 + 1) : 0;
      float mac[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) mac[r][q] = 0.0f;
      if (rows) {
        for (int k = 0; k < n; ++k) {
          float cr[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cr[r] = rb + r < L ? cs[(rb + r) * ldn + k] : 0.0f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q < ng) {
              const int j = lane + 32 * q;
              const float bj = j < L ? bs[j * ldn + k] : 0.0f;
#pragma unroll
              for (int r = 0; r < 4; ++r) mac[r][q] = fmaf(cr[r], bj, mac[r][q]);
            }
          }
        }
      }
      // M[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i, else 0
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = rb + r;
        if (i >= i0 + mb) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = lane + 32 * q;
          if (j >= L) continue;
          float val = 0.0f;
          if (q < ng && j <= i) val = mac[r][q] * expf(cum[i] - cum[j]) * dts[j];
          ms[(i - i0) * L + j] = val;
        }
      }
      __syncthreads();
      // y_i = M_i . x + exp(cum_i) * C_i . state_in
      if (rows) {
        float acc[4][CY], cst[4][CY];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < CY; ++q) acc[r][q] = cst[r][q] = 0.0f;
        const float* mrow = ms + (rb - i0) * L;
        for (int j = 0; j <= rlast; ++j) {
          float mv[4], xv[CY];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = mrow[r * L + j];
#pragma unroll
          for (int q = 0; q < CY; ++q) xv[q] = xs[j * p + lane + 32 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < CY; ++q) acc[r][q] = fmaf(mv[r], xv[q], acc[r][q]);
        }
        for (int k = 0; k < n; ++k) {
          float cr[4], sv[CY];
#pragma unroll
          for (int r = 0; r < 4; ++r) cr[r] = rb + r < L ? cs[(rb + r) * ldn + k] : 0.0f;
#pragma unroll
          for (int q = 0; q < CY; ++q) sv[q] = st[(lane + 32 * q) * ldn + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < CY; ++q) cst[r][q] = fmaf(cr[r], sv[q], cst[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = rb + r, t = t0 + i;
          if (i >= i0 + mb || t >= s) continue;
          T* yrow = y + ((static_cast<long long>(bi) * s + t) * h + hi) * p;
#pragma unroll
          for (int q = 0; q < CY; ++q)
            yrow[lane + 32 * q] = from_f32<T>(acc[r][q] + ec[i] * cst[r][q]);
        }
      }
      __syncthreads();   // M is rewritten next; the state is read no more
    }

    // state' = exp(total) * state_in + sum_i (cw_i x_i) B_i^T.  x is read
    // no more in this chunk, so it turns into w = cw * x in place; thread
    // (warp, lane) then owns the state entries (lane + 32q, warp + 8k).
    for (int e = tid; e < L * p; e += kThreads) xs[e] *= cw[e / p];
    __syncthreads();
    const float etot = expf(total);
    float acc[kMaxN / 8][CY];
#pragma unroll
    for (int kk = 0; kk < kMaxN / 8; ++kk)
#pragma unroll
      for (int q = 0; q < CY; ++q) acc[kk][q] = 0.0f;
    for (int i = 0; i < L; ++i) {
      float wv[CY];
#pragma unroll
      for (int q = 0; q < CY; ++q) wv[q] = xs[i * p + lane + 32 * q];
#pragma unroll
      for (int kk = 0; kk < kMaxN / 8; ++kk) {
        const int k = warp + 8 * kk;
        if (k < n) {
          const float bk = bs[i * ldn + k];
#pragma unroll
          for (int q = 0; q < CY; ++q) acc[kk][q] = fmaf(wv[q], bk, acc[kk][q]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kMaxN / 8; ++kk) {
      const int k = warp + 8 * kk;
      if (k >= n) continue;
#pragma unroll
      for (int q = 0; q < CY; ++q) {
        float* sp = st + (lane + 32 * q) * ldn + k;
        *sp = *sp * etot + acc[kk][q];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < p * n; e += kThreads) {
    const int pp = e / n, k = e % n;
    fin[((static_cast<long long>(bi) * h + hi) * p + pp) * n + k] = st[pp * ldn + k];
  }
}

template <typename T, int CY>
int launch(void* y, float* fin, const void* x, const float* dt, const float* A,
           const void* Bm, const void* Cm, int b, int s, int h, int g, int n, int L,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(L, 32 * CY, n) * sizeof(float);
  if (bytes > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T, CY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<T, CY><<<dim3(h, b), kThreads, bytes, stream>>>(
      static_cast<T*>(y), fin, static_cast<const T*>(x), dt, A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), s, h, g, n, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(void* y, float* fin, const void* x, const float* dt, const float* A,
             const void* Bm, const void* Cm, int b, int s, int h, int p, int g, int n,
             int L, cudaStream_t stream) {
  switch (p) {
    case 32: return launch<T, 1>(y, fin, x, dt, A, Bm, Cm, b, s, h, g, n, L, stream);
    case 64: return launch<T, 2>(y, fin, x, dt, A, Bm, Cm, b, s, h, g, n, L, stream);
    case 128: return launch<T, 4>(y, fin, x, dt, A, Bm, Cm, b, s, h, g, n, L, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt, A, final f32)
int ssd_forward(void* y, void* fin, const void* x, const void* dt, const void* A,
                const void* Bm, const void* Cm, int b, int s, int h, int p, int g,
                int n, int chunk, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || h <= 0 || g <= 0 || n <= 0 || n > kMaxN || n % 8 || chunk <= 0 ||
      chunk > kMaxL || h % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto finf = static_cast<float*>(fin);
  auto dtf = static_cast<const float*>(dt);
  auto af = static_cast<const float*>(A);
  if (dtype == 0)
    return dispatch<float>(y, finf, x, dtf, af, Bm, Cm, b, s, h, p, g, n, chunk, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(y, finf, x, dtf, af, Bm, Cm, b, s, h, p, g, n, chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
