// Causal GQA flash attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// kernel _flash_kernel): online-softmax attention over q (B, S, H, hd) and
// k/v (B, T, KH, hd), q head h reading kv head h / G (G = H / KH), with the
// run-time scalars q_offset (position of q[0] relative to k[0]), window
// (keys with qpos - window < kpos <= qpos) and kv_len (keys at or past it
// are masked).  f32 compute, output in q's dtype; a row with no valid key
// gives 0, as the Pallas kernel's explicit zeroing and max(l, 1e-30) do.
//
// What bounds it on an H100: prefill (S in the thousands) does 4*hd
// operations per unmasked (query, key) pair on 4*hd bytes per key row, so
// it is bound by operations (about 107 GFLOP for one global hymba-1.5b
// layer at batch 8, prompt 2048); decode (S = 1) reads every valid cache
// row once for 4*hd operations, so it is bound by the bytes of K and V.
//
// What the design does about it (the simple first version, FMA in f32):
//  - One block per (q-row tile, kv head, batch).  A "row" is one (query
//    position, q head of the group) pair, so in prefill the G q heads that
//    share a kv head share every K/V tile the block stages in shared
//    memory: K and V are read once per tile for all G heads, not G times.
//    Decode does not share them (see below): each of its blocks holds one
//    row, so the G blocks of a kv head each read the same K/V rows, G = 5
//    reads per layer for hymba-1.5b (the 50 MB L2 may serve the repeats
//    of a layer's 21.6 MB of K/V at batch 8; not measured).
//  - Only the key range some row of the tile can see is visited: tiles
//    outside [qpos_min - window + 1, min(qpos_max, kv_len - 1)] are never
//    loaded.  That is exact (a masked key adds nothing: m stays, p = 0) and
//    is what makes sliding-window layers and decode cheap: decode against
//    a 2112-long cache reads only the cache_len + 1 valid rows, or the last
//    `window` of them.
//  - Each row is split over W workers (each worker takes every W-th key of
//    a tile) and each worker over D threads (each holds an interleaved 32-
//    float slice of hd: q, and the f32 output accumulator, live in
//    registers).  A worker keeps its own running max m and normaliser l
//    and rescales its accumulator only when m grows.  The workers of a row
//    are merged once, at the end (butterfly shuffles inside a warp, shared
//    memory across warps).
//  - Prefill tiles hold 64 rows (32 at hd = 128), 2 to 4 workers per row;
//    decode (S * G <= 16) gives each row a block of its own whose workers
//    take one key each per tile, so a single query still spreads over 64
//    to 256 threads.  That buys threads per query at the price of the G-
//    fold K/V re-read above; putting a kv head's G rows in one block would
//    end the re-read but leave B * KH blocks (40 for hymba-1.5b) on 132
//    SMs, so it waits for the split over keys below.
//  - Masked entries never enter the exponent: a worker skips a masked key
//    outright, so -inf - -inf never happens and no -1e30 arithmetic can
//    leak into l.  Shared-memory rows are padded so the float4 reads of one
//    quarter-warp fall on distinct banks.
//  - bf16 prefill at hd 64 or 128 (the serve path's prefill) runs instead on
//    the tensor cores (fa_mma_kernel): mma.sync m16n8k16 with f32
//    accumulators, 16 rows per warp, K and V^T staged as bf16, the online
//    softmax on the S fragments in registers (masked scores held at -1e30
//    and their weights zeroed explicitly, as the Pallas kernel does), and P
//    fed to P.V as a bf16 pair hi + lo so it keeps ~16 bits.
// wgmma, TMA and, for decode, a split over keys across blocks with the G
// rows of a kv head in one block are later work.
//
// fa_forward enqueues on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T as floats
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) dst[j] = to_f32(e[j]);
}

template <int HD, int R, int W>
struct Cfg {
  static constexpr int SL = HD < 32 ? HD : 32;       // hd floats per thread
  static constexpr int D = HD / SL;                  // threads per worker
  static constexpr int CH = SL / 4;                  // float4 chunks per thread
  static constexpr int NT = R * W * D;               // threads per block
  static constexpr int BK = 4096 / HD;               // keys per tile
  static constexpr int PAD = HD / 8 > 4 ? HD / 8 : 4;
  static constexpr int LD = HD + PAD;                // smem row stride (floats)
  static constexpr int IN_WARP = W * D < 32 ? W * D : 32;
  static constexpr int WPR = (W * D + 31) / 32;      // warps per row
  static_assert(BK % W == 0, "every worker takes the same number of keys");
  static_assert(W * D <= 32 || R == 1, "a row spans warps only when alone");
};

template <typename T, int HD, int R, int W>
__global__ void __launch_bounds__(Cfg<HD, R, W>::NT)
fa_kernel(T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, int S, int Tk, int H, int KH, int G,
          int q_offset, int window, int kv_len, float scale) {
  using C = Cfg<HD, R, W>;
  __shared__ __align__(16) float ks[C::BK * C::LD];
  __shared__ __align__(16) float vs[C::BK * C::LD];
  __shared__ float red[C::WPR > 1 ? C::WPR * (HD + 2) : 1];

  const int tid = threadIdx.x;
  const int d = tid % C::D;
  const int w = (tid / C::D) % W;
  const int row = tid / (C::D * W);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = S * G;
  const int r0 = blockIdx.x * R;
  const int rg = r0 + row;
  const bool active = rg < n_rows;
  const int s_idx = active ? rg / G : 0;
  const int hh = kvh * G + (active ? rg % G : 0);
  const int qpos = q_offset + s_idx;

  // this thread's slice of the query row, scaled in f32 before Q·K^T as
  // the Pallas kernel scales it
  float qv[C::SL], acc[C::SL];
  const T* qrow = q + ((static_cast<long long>(b) * S + s_idx) * H + hh) * HD;
#pragma unroll
  for (int c = 0; c < C::CH; ++c) {
    const int dim = (c * C::D + d) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qv[c * 4 + e] = active ? to_f32(qrow[dim + e]) * scale : 0.0f;
      acc[c * 4 + e] = 0.0f;
    }
  }

  // the keys some row of this block can see
  const int s_first = r0 / G;
  const int s_last = (min(r0 + R, n_rows) - 1) / G;
  const int lo = max(0, q_offset + s_first - window + 1);
  const int hi = min(min(q_offset + s_last, kv_len - 1), Tk - 1);

  float m = kNegInf, l = 0.0f;
  const long long kv_stride = static_cast<long long>(KH) * HD;
  const T* kbase = k + (static_cast<long long>(b) * Tk * KH + kvh) * HD;
  const T* vbase = v + (static_cast<long long>(b) * Tk * KH + kvh) * HD;
  constexpr int VN = Vec<T>::N;
  constexpr int VPR = HD / VN;

  for (int t0 = lo; t0 <= hi; t0 += C::BK) {
    __syncthreads();   // the previous tile is no longer read
    for (int i = tid; i < C::BK * VPR; i += C::NT) {
      const int j = i / VPR, c = i % VPR;
      const int key = t0 + j;
      float kf[VN], vf[VN];
      if (key <= hi) {
        load_vec<T>(kbase + key * kv_stride + c * VN, kf);
        load_vec<T>(vbase + key * kv_stride + c * VN, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kf[e] = vf[e] = 0.0f;
      }
      float* kd = ks + j * C::LD + c * VN;
      float* vd = vs + j * C::LD + c * VN;
#pragma unroll
      for (int e = 0; e < VN; e += 4) {
        *reinterpret_cast<float4*>(kd + e) = make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(vd + e) = make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    __syncthreads();

    // the same trip count for every thread, so the shuffles stay converged
    for (int j = w; j < C::BK; j += W) {
      const int key = t0 + j;
      const float* kr = ks + j * C::LD;
      // four independent partial sums, so the FMA chain is a quarter long
      float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < C::CH; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + (c * C::D + d) * 4);
        s4[0] = fmaf(qv[c * 4 + 0], kk.x, s4[0]);
        s4[1] = fmaf(qv[c * 4 + 1], kk.y, s4[1]);
        s4[2] = fmaf(qv[c * 4 + 2], kk.z, s4[2]);
        s4[3] = fmaf(qv[c * 4 + 3], kk.w, s4[3]);
      }
      float sdot = (s4[0] + s4[1]) + (s4[2] + s4[3]);
#pragma unroll
      for (int off = 1; off < C::D; off <<= 1) sdot += __shfl_xor_sync(kFull, sdot, off);

      const bool valid = active && key <= hi && key <= qpos && key > qpos - window &&
                         key < kv_len;
      if (valid) {
        if (sdot > m) {
          const float a = expf(m - sdot);
          l *= a;
#pragma unroll
          for (int i = 0; i < C::SL; ++i) acc[i] *= a;
          m = sdot;
        }
        const float pr = expf(sdot - m);
        l += pr;
        const float* vr = vs + j * C::LD;
#pragma unroll
        for (int c = 0; c < C::CH; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + (c * C::D + d) * 4);
          acc[c * 4 + 0] = fmaf(pr, vv.x, acc[c * 4 + 0]);
          acc[c * 4 + 1] = fmaf(pr, vv.y, acc[c * 4 + 1]);
          acc[c * 4 + 2] = fmaf(pr, vv.z, acc[c * 4 + 2]);
          acc[c * 4 + 3] = fmaf(pr, vv.w, acc[c * 4 + 3]);
        }
      }
    }
  }

  // merge the W workers of each row: inside a warp by a butterfly over the
  // worker bits of the lane index (every lane ends with the merged values)
#pragma unroll
  for (int off = C::D; off < C::IN_WARP; off <<= 1) {
    const float mo = __shfl_xor_sync(kFull, m, off);
    const float lo2 = __shfl_xor_sync(kFull, l, off);
    const float mn = fmaxf(m, mo);
    const float a = expf(m - mn), bb = expf(mo - mn);
    l = l * a + lo2 * bb;
#pragma unroll
    for (int i = 0; i < C::SL; ++i) {
      const float ao = __shfl_xor_sync(kFull, acc[i], off);
      acc[i] = acc[i] * a + ao * bb;
    }
    m = mn;
  }
  // ... and across the warps of a row (decode blocks: one row per block)
  if constexpr (C::WPR > 1) {
    const int warp = tid / 32, lane = tid % 32;
    if (lane < C::D) {
      float* slot = red + warp * (HD + 2);
      if (lane == 0) {
        slot[0] = m;
        slot[1] = l;
      }
#pragma unroll
      for (int c = 0; c < C::CH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) slot[2 + (c * C::D + d) * 4 + e] = acc[c * 4 + e];
    }
    __syncthreads();
    if (tid < C::D) {
      float mt = kNegInf;
      for (int wi = 0; wi < C::WPR; ++wi) mt = fmaxf(mt, red[wi * (HD + 2)]);
      l = 0.0f;
#pragma unroll
      for (int i = 0; i < C::SL; ++i) acc[i] = 0.0f;
      for (int wi = 0; wi < C::WPR; ++wi) {
        const float* slot = red + wi * (HD + 2);
        const float a = expf(slot[0] - mt);
        l += slot[1] * a;
#pragma unroll
        for (int c = 0; c < C::CH; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[c * 4 + e] += slot[2 + (c * C::D + d) * 4 + e] * a;
      }
    }
  }

  const bool writer = C::WPR > 1 ? tid < C::D : w == 0;
  if (writer && active) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((static_cast<long long>(b) * S + s_idx) * H + hh) * HD;
#pragma unroll
    for (int c = 0; c < C::CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[(c * C::D + d) * 4 + e] = from_f32<T>(acc[c * 4 + e] / denom);
  }
}

template <typename T, int HD, int R, int W>
int launch(void* out, const void* q, const void* k, const void* v, int B, int S,
           int Tk, int H, int KH, int q_offset, int window, int kv_len,
           cudaStream_t stream) {
  using C = Cfg<HD, R, W>;
  const int G = H / KH;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  const dim3 grid((S * G + R - 1) / R, KH, B);
  fa_kernel<T, HD, R, W><<<grid, C::NT, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), S, Tk, H, KH, G, q_offset, window, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 prefill on the tensor cores: mma.sync m16n8k16, f32 accumulators
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 as a bf16 pair (lo in the low half), and the pair of what
// rounding left over, so that hi + lo carries ~16 bits of the value
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <int HD>
struct MmaCfg {
  static constexpr int WARPS = 4;
  static constexpr int ROWS = 16 * WARPS;   // rows per block, 16 per warp
  static constexpr int NT = 32 * WARPS;     // threads per block
  static constexpr int BK = 64;             // keys per tile
  static constexpr int KS = HD / 16;        // k-steps of Q.K^T
  static constexpr int SN = BK / 8;         // 8-key column tiles of S
  static constexpr int ON = HD / 8;         // 8-dim column tiles of O
  static constexpr int LDK = HD + 8;        // bf16 stride of a K row in smem
  static constexpr int LDV = BK + 8;        // bf16 stride of a V^T row in smem
  static constexpr int VPR = HD / 8;        // 16-byte vectors per key row
  static constexpr int PER = BK * VPR / NT; // vectors of K (and of V) per thread
};

// Rows, masks and key range as in fa_kernel; each warp owns 16 rows.  S =
// Q.K^T comes from bf16 products (exact in f32) accumulated in f32 and is
// scaled afterwards; P.V takes P as a bf16 pair hi + lo, so P keeps ~16
// bits and the output tracks the f32 plain version to within its own bf16
// rounding.  The fragments follow PTX's m16n8k16 layout: a thread (g =
// lane / 4, t = lane % 4) holds rows g and g + 8, columns 2t, 2t + 1 (+ 8).
template <int HD>
__global__ void __launch_bounds__(MmaCfg<HD>::NT)
fa_mma_kernel(__nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
              int S, int Tk, int H, int KH, int G, int q_offset, int window, int kv_len,
              float scale) {
  using C = MmaCfg<HD>;
  __shared__ __align__(16) __nv_bfloat16 ks[C::BK * C::LDK];
  __shared__ __align__(16) __nv_bfloat16 vt[HD * C::LDV];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = S * G;
  const int r0 = blockIdx.x * C::ROWS;

  bool act[2];
  int qpos[2];
  long long orow[2];
  uint32_t qa[C::KS][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rg = r0 + warp * 16 + g + 8 * i;
    act[i] = rg < n_rows;
    const int s_idx = act[i] ? rg / G : 0;
    const int hh = kvh * G + (act[i] ? rg % G : 0);
    qpos[i] = q_offset + s_idx;
    orow[i] = ((static_cast<long long>(b) * S + s_idx) * H + hh) * HD;
  }
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk) {
    const int d0 = kk * 16 + 2 * t;
    qa[kk][0] = act[0] ? ld32(q + orow[0] + d0) : 0u;
    qa[kk][1] = act[1] ? ld32(q + orow[1] + d0) : 0u;
    qa[kk][2] = act[0] ? ld32(q + orow[0] + d0 + 8) : 0u;
    qa[kk][3] = act[1] ? ld32(q + orow[1] + d0 + 8) : 0u;
  }

  const int s_first = r0 / G;
  const int s_last = (min(r0 + C::ROWS, n_rows) - 1) / G;
  const int lo = max(0, q_offset + s_first - window + 1);
  const int hi = min(min(q_offset + s_last, kv_len - 1), Tk - 1);

  float o[C::ON][4];
#pragma unroll
  for (int n = 0; n < C::ON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const long long kv_stride = static_cast<long long>(KH) * HD;
  const __nv_bfloat16* kbase = k + (static_cast<long long>(b) * Tk * KH + kvh) * HD;
  const __nv_bfloat16* vbase = v + (static_cast<long long>(b) * Tk * KH + kvh) * HD;

  for (int t0 = lo; t0 <= hi; t0 += C::BK) {
    __syncthreads();   // the previous tile is no longer read
    uint4 kr[C::PER], vr[C::PER];
#pragma unroll
    for (int u = 0; u < C::PER; ++u) {
      const int idx = tid + u * C::NT, j = idx / C::VPR, c = idx % C::VPR;
      const int key = t0 + j;
      const bool in = key <= hi;
      kr[u] = in ? __ldg(reinterpret_cast<const uint4*>(kbase + key * kv_stride + c * 8))
                 : make_uint4(0u, 0u, 0u, 0u);
      vr[u] = in ? __ldg(reinterpret_cast<const uint4*>(vbase + key * kv_stride + c * 8))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < C::PER; ++u) {
      const int idx = tid + u * C::NT, j = idx / C::VPR, c = idx % C::VPR;
      *reinterpret_cast<uint4*>(ks + j * C::LDK + c * 8) = kr[u];
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&vr[u]);
#pragma unroll
      for (int x = 0; x < 8; ++x) vt[(c * 8 + x) * C::LDV + j] = e[x];
    }
    __syncthreads();

    // S = Q.K^T for the warp's 16 rows and the tile's BK keys
    float sc[C::SN][4];
#pragma unroll
    for (int n = 0; n < C::SN; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        const __nv_bfloat16* kp = ks + (n * 8 + g) * C::LDK + kk * 16 + 2 * t;
        mma_bf16(sc[n], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }
    // mask and scale; the new running max of each row (4 threads per row)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < C::SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, key = t0 + n * 8 + 2 * t + (e & 1);
        const bool valid = act[i] && key <= hi && key <= qpos[i] &&
                           key > qpos[i] - window && key < kv_len;
        sc[n][e] = valid ? sc[n][e] * scale : kNegInf;
        mx[i] = fmaxf(mx[i], sc[n][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float alpha = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < C::ON; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
    // p = exp(s - m), zero where masked
#pragma unroll
    for (int n = 0; n < C::SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const float pr = sc[n][e] > kNegInf ? expf(sc[n][e] - m[i]) : 0.0f;
        l[i] += pr;
        sc[n][e] = pr;
      }
    // O += P.V, P as bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < C::ON; ++n) {
        const __nv_bfloat16* vp = vt + (n * 8 + g) * C::LDV + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(vp), b1 = ld32(vp + 8);
        mma_bf16(o[n], ph, b0, b1);
        mma_bf16(o[n], pl, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    if (!act[i]) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < C::ON; ++n) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(o[n][2 * i] / denom, o[n][2 * i + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(out + orow[i] + n * 8 + 2 * t) = pair;
    }
  }
}

template <int HD>
int launch_mma(void* out, const void* q, const void* k, const void* v, int B, int S, int Tk,
               int H, int KH, int q_offset, int window, int kv_len, cudaStream_t stream) {
  using C = MmaCfg<HD>;
  const int G = H / KH;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  const dim3 grid((S * G + C::ROWS - 1) / C::ROWS, KH, B);
  fa_mma_kernel<HD><<<grid, C::NT, 0, stream>>>(
      static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), S, Tk, H,
      KH, G, q_offset, window, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// decode (S * G <= 16): one row per block, one key per worker per tile;
// bf16 prefill at hd 64 or 128: the tensor-core kernel; other prefill:
// FMA tiles of 64 rows (32 at hd 128), 256 threads
template <typename T, int HD>
int dispatch(void* out, const void* q, const void* k, const void* v, int B, int S,
             int Tk, int H, int KH, int q_offset, int window, int kv_len,
             cudaStream_t stream) {
  constexpr int D = Cfg<HD, 1, 1>::D;
  constexpr int BK = Cfg<HD, 1, 1>::BK;
  constexpr int RP = HD == 128 ? 32 : 64;
  constexpr int WP = 256 / (RP * D);
  if (S * (H / KH) <= 16)
    return launch<T, HD, 1, BK>(out, q, k, v, B, S, Tk, H, KH, q_offset, window, kv_len,
                                stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value && (HD == 64 || HD == 128))
    return launch_mma<HD>(out, q, k, v, B, S, Tk, H, KH, q_offset, window, kv_len, stream);
  return launch<T, HD, RP, WP>(out, q, k, v, B, S, Tk, H, KH, q_offset, window, kv_len,
                               stream);
}

template <typename T>
int dispatch_hd(void* out, const void* q, const void* k, const void* v, int B, int S,
                int Tk, int H, int KH, int hd, int q_offset, int window, int kv_len,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return dispatch<T, 16>(out, q, k, v, B, S, Tk, H, KH, q_offset, window, kv_len, stream);
    case 32: return dispatch<T, 32>(out, q, k, v, B, S, Tk, H, KH, q_offset, window, kv_len, stream);
    case 64: return dispatch<T, 64>(out, q, k, v, B, S, Tk, H, KH, q_offset, window, kv_len, stream);
    case 128: return dispatch<T, 128>(out, q, k, v, B, S, Tk, H, KH, q_offset, window, kv_len, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16 (q, k, v and out share it)
int fa_forward(void* out, const void* q, const void* k, const void* v, int B, int S,
               int Tk, int H, int KH, int hd, int q_offset, int window, int kv_len,
               int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0 || kv_len > Tk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<float>(out, q, k, v, B, S, Tk, H, KH, hd, q_offset, window, kv_len, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(out, q, k, v, B, S, Tk, H, KH, hd, q_offset, window,
                                      kv_len, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
