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
// row once for 4*hd operations, so it is bound by the bytes of K and V
// (21.6 MB for a global hymba-1.5b layer at batch 8 and cache 2112).
//
// A "row" is one (query position, q head of the group) pair; the G rows of
// one query position share a kv head, so every design below keeps a kv
// head's rows in one block and reads each K/V row once for all G heads.
// Only the key range some row of a block can see is visited: keys outside
// [qpos_min - window + 1, min(qpos_max, kv_len - 1)] are never loaded.
// That is exact (a masked key adds nothing) and is what makes sliding-
// window layers and decode cheap.  Three paths, chosen in dispatch:
//
//  - Decode, S * G <= 16 (fa_split_kernel; the serve path's decode has
//    S = 1, G = 5).  n_split * B * KH blocks: one block holds all S * G
//    rows of a kv head and one chunk of key positions, in group-major
//    order (consecutive blocks take one split of different (kv head,
//    batch) groups), so the chunks a window can see spread over all SMs.
//    n_split and the chunk come from the cache's capacity T and B * KH
//    (about four blocks per SM, at most 64 splits), never from the cache
//    length, so the grid is the same at every step of a generate; a chunk
//    no row can see writes an empty partial (m = -1e30, l = 0) and goes
//    straight to the merge.  K/V tiles of 64 keys stay in the cache's
//    dtype in shared memory, loaded by 16-byte cp.async (.cg) into a 2- or
//    3-stage ring, keys outside the chunk's visible range zero-filled.
//    The decode is bound by latency as much as by bytes: a launch, the
//    first tile's arrival, and the merge's atomic and loads are each about
//    a microsecond.  bf16: each of the 4 warps takes 16
//    keys of a tile for the 16 (padded) rows on the tensor cores
//    (mma.sync m16n8k16: S = Q.K^T from bf16 products in f32, P.V with V^T
//    read by ldmatrix.trans and P as a bf16 pair hi + lo), then the warps
//    merge through shared memory.  f32: the CUDA cores, in three block-wide
//    phases per tile (scores, the row softmax, P.V).  Each split writes its
//    rows' partial (m, l, acc[hd]) in f32 to a workspace; the last block
//    of each (kv head, batch) - a __threadfence and an atomic ticket, the
//    top-k threshold's handoff - merges them in the same launch and resets
//    its ticket, so a call is one launch and needs no memset.  The tickets
//    lie in a buffer apart from the partials, whose layout follows B * KH:
//    a call of another batch never writes over them.  A row no split saw
//    has l = 0 everywhere and gives 0.
//  - bf16 prefill at hd 64 or 128 (fa_wgmma_kernel).  Two consumer
//    warpgroups of 64 rows each and one producer warp.  The producer
//    streams K/V tiles of 64 keys by TMA (cp.async.bulk.tensor, a 4-D map
//    over (hd, KH, kv_len, B), box (64, 1, 64, 1), 128-byte swizzle; hd 128
//    takes two boxes) into a 3- or 4-stage ring with full/empty mbarriers;
//    keys at or past kv_len arrive as zeros.  Each consumer warpgroup runs
//    S = Q.K^T as wgmma m64n64k16 with Q in registers and K through a
//    K-major shared-memory descriptor, the online softmax on the
//    accumulator fragment (exp2 of scores pre-scaled by log2 e), and
//    O += P.V as wgmma with P from registers and V through the descriptor's
//    transpose bit, so V is never transposed by hand.  P is fed as a bf16
//    pair hi + lo (two products), which keeps ~16 bits of P: a single bf16
//    P errs by up to 2^-9 of each weight, about 1e-3 of a typical output's
//    scale over a thousand keys, which for outputs near 0 is more than the
//    tolerance of one bf16 ulp of |ref| + 2e-5 leaves.
//    Tiles are classified per warpgroup: a tile no row of the warpgroup
//    can see is skipped, a tile inside every row's range takes no
//    per-element compare, and only the tiles that cross the diagonal, the
//    window's edge or kv_len are masked.  Row blocks are issued longest
//    first, so the short causal blocks fill the tail.
//  - Other prefill (f32, or hd 16/32; fa_kernel): FMA tiles of 64 rows
//    (32 at hd 128), each row split over 2-4 workers with their own running
//    max, merged at the end; masked keys never enter the exponent.
//
// fa_forward enqueues on the given stream and returns a cudaError_t code;
// fa_workspace_bytes gives the size of the decode's partials; the caller
// keeps them and a zero-filled ticket buffer, one pair per stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// ---------------------------------------------------------------------------
// prefill on the CUDA cores (f32, or hd 16 / 32)
// ---------------------------------------------------------------------------

template <int HD, int R, int W>
struct Cfg {
  static constexpr int SL = HD < 32 ? HD : 32;       // hd floats per thread
  static constexpr int D = HD / SL;                  // threads per worker
  static constexpr int CH = SL / 4;                  // float4 chunks per thread
  static constexpr int NT = R * W * D;               // threads per block
  static constexpr int BK = 4096 / HD;               // keys per tile
  static constexpr int PAD = HD / 8 > 4 ? HD / 8 : 4;
  static constexpr int LD = HD + PAD;                // smem row stride (floats)
  static_assert(BK % W == 0, "every worker takes the same number of keys");
  static_assert(W * D <= 32, "a row's workers share one warp");
};

template <typename T, int HD, int R, int W>
__global__ void __launch_bounds__(Cfg<HD, R, W>::NT)
fa_kernel(T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, int S, int Tk, int H, int KH, int G,
          int q_offset, int window, int kv_len, float scale) {
  using C = Cfg<HD, R, W>;
  __shared__ __align__(16) float ks[C::BK * C::LD];
  __shared__ __align__(16) float vs[C::BK * C::LD];

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

  // merge the W workers of each row by a butterfly over the worker bits of
  // the lane index (every lane ends with the merged values)
#pragma unroll
  for (int off = C::D; off < W * C::D; off <<= 1) {
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

  if (w == 0 && active) {
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
// tensor-core helpers: mma.sync, ldmatrix, cp.async
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

// four 8x8 bf16 matrices from shared memory, each transposed: lanes 8i..8i+7
// give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// two f32 as a bf16 pair (lo in the low half), and the pair of what
// rounding left over, so that hi + lo carries ~16 bits of the value
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
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// decode (S * G <= 16): split over keys, a kv head's rows in one block
// ---------------------------------------------------------------------------

constexpr int kSplitRows = 16;      // rows of a split block (S * G <= 16)
constexpr int kSplitBK = 64;        // keys per tile
constexpr int kSplitThreads = 128;
constexpr int kMaxSplits = 64;

template <typename T, int HD>
struct SplitCfg {
  static constexpr int VN = 16 / sizeof(T);            // elements per 16 bytes
  static constexpr int LDS = HD + VN;                  // smem row stride: +16 B
  static constexpr int TILE = kSplitBK * LDS;          // elements of a K (or V) tile
  static constexpr int STAGE_BYTES = 2 * TILE * static_cast<int>(sizeof(T));
  static constexpr int STAGES = STAGE_BYTES <= 20480 ? 3 : 2;
  static constexpr int VPR = HD / VN;                  // 16-byte vectors per key row
  // f32 path: q rows, the tile's scores, (m, l, alpha) per row
  static constexpr int FMA_EXTRA = (kSplitRows * HD + kSplitRows * kSplitBK + kSplitRows * 4) * 4;
  // bf16 path: the 4 warps' (m, l), acc and weights in the in-block merge
  static constexpr int WARP_MERGE = 4 * kSplitRows * (3 + HD) * 4;
  // the last block's merge: the weight of every split, L per row
  static constexpr int LAST_MERGE = (kMaxSplits * kSplitRows + kSplitRows) * 4;
  static constexpr int EXTRA = std::is_same<T, float>::value ? FMA_EXTRA : 0;
  // a chunk of fewer tiles than STAGES never touches the ring's other
  // slots, so a launch asks only for the stages its chunk uses
  static constexpr int smem_bytes(int tiles_per_chunk) {
    const int ring = (tiles_per_chunk < STAGES ? tiles_per_chunk : STAGES) * STAGE_BYTES;
    const int need = ring + EXTRA > WARP_MERGE ? ring + EXTRA : WARP_MERGE;
    return need > LAST_MERGE ? need : LAST_MERGE;
  }
  static constexpr int SMEM = smem_bytes(STAGES);
  static_assert(kSplitThreads == 2 * kSplitBK, "two row groups per key in the f32 scores");
  static_assert(kMaxSplits <= 64, "two splits per lane in the merge");
};

struct SplitPlan {
  int n_split, chunk;
};

int sm_count() {
  static int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
    return sms > 0 ? sms : 132;
  }();
  return n;
}

// about four blocks per SM over the B * KH (kv head, batch) groups, at most
// kMaxSplits, each chunk a whole number of tiles; from the cache's capacity
SplitPlan split_plan(int B, int KH, int Tk) {
  const int n_tiles = (Tk + kSplitBK - 1) / kSplitBK;
  const int groups = B * KH;
  const int want = std::max(1, std::min(kMaxSplits, (4 * sm_count() + groups - 1) / groups));
  const int tpc = (n_tiles + want - 1) / want;
  return {(n_tiles + tpc - 1) / tpc, tpc * kSplitBK};
}

// the decode's workspace: partials, (m, l) and acc[hd] per (group, split,
// row), all f32, and a ticket per group.  The tickets lie in a buffer of
// their own, so ticket g sits at the same place whatever the call's shape
// and is 0 between calls, while the partials' layout changes with B * KH.
struct SplitWs {
  void* partials;
  unsigned* tickets;
};
long long split_ws_bytes(int groups, int n_split, int hd) {
  return static_cast<long long>(groups) * n_split * kSplitRows * (2 + hd) * 4;
}

template <typename T, int HD>
__device__ __forceinline__ void split_load_tile(T* ks, T* vs, const T* kb, const T* vb,
                                                long long kv_stride, int t0, int bnd) {
  using C = SplitCfg<T, HD>;
  for (int i = threadIdx.x; i < kSplitBK * C::VPR; i += kSplitThreads) {
    const int j = i / C::VPR, c = i % C::VPR;
    const int key = t0 + j;
    const bool in = key <= bnd;
    const long long off = static_cast<long long>(in ? key : t0) * kv_stride + c * C::VN;
    cp_async16(ks + j * C::LDS + c * C::VN, kb + off, in);
    cp_async16(vs + j * C::LDS + c * C::VN, vb + off, in);
  }
}

struct SplitRows {
  int R, G, q_offset, window, kv_len;
  __device__ __forceinline__ bool sees(int r, int key) const {
    const int qpos = q_offset + r / G;
    return r < R && key <= qpos && key > qpos - window && key < kv_len;
  }
};

// bf16: the chunk's keys [a, bnd] on the tensor cores; writes the block's
// partial (m, l, acc) for rows < R
template <int HD>
__device__ void split_tiles_mma(unsigned char* smem, const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                long long kv_stride, int H, int S, int b,
                                int kvh, const SplitRows& rows, float scale_log2, int a,
                                int bnd, float* __restrict__ ml, float* __restrict__ acc) {
  using T = __nv_bfloat16;
  using C = SplitCfg<T, HD>;
  T* ring = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = rows.G;

  // the Q fragment of rows g and g + 8 (all 16 rows in every warp)
  uint32_t qa[HD / 16][4];
  long long qrow[2];
  bool act[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    act[i] = r < rows.R;
    const int s = act[i] ? r / G : 0;
    qpos[i] = rows.q_offset + s;
    qrow[i] = ((static_cast<long long>(b) * S + s) * H + kvh * G + (act[i] ? r % G : 0)) * HD;
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int d0 = kk * 16 + 2 * t;
    qa[kk][0] = act[0] ? ld32(q + qrow[0] + d0) : 0u;
    qa[kk][1] = act[1] ? ld32(q + qrow[1] + d0) : 0u;
    qa[kk][2] = act[0] ? ld32(q + qrow[0] + d0 + 8) : 0u;
    qa[kk][3] = act[1] ? ld32(q + qrow[1] + d0 + 8) : 0u;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  const int n_tiles = (bnd - a) / kSplitBK + 1;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_tiles)
      split_load_tile<T, HD>(ring + s * 2 * C::TILE, ring + s * 2 * C::TILE + C::TILE, kb, vb,
                             kv_stride, a + s * kSplitBK, bnd);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int pre = it + C::STAGES - 1;
    if (pre < n_tiles) {
      T* dst = ring + (pre % C::STAGES) * 2 * C::TILE;
      split_load_tile<T, HD>(dst, dst + C::TILE, kb, vb, kv_stride, a + pre * kSplitBK, bnd);
    }
    cp_async_commit();
    cp_async_wait<C::STAGES - 1>();
    __syncthreads();
    const T* ks = ring + (it % C::STAGES) * 2 * C::TILE;
    const T* vs = ks + C::TILE;
    const int t0 = a + it * kSplitBK;

    // S for the 16 rows and this warp's 16 keys
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const T* kp = ks + (warp * 16 + j * 8 + g) * C::LDS + kk * 16 + 2 * t;
        mma_bf16(sc[j], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, key = t0 + warp * 16 + j * 8 + 2 * t + (e & 1);
        const bool valid = act[i] && key <= bnd && key <= qpos[i] &&
                           key > qpos[i] - rows.window && key < rows.kv_len;
        sc[j][e] = valid ? sc[j][e] * scale_log2 : kNegInf;
        mx[i] = fmaxf(mx[i], sc[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float alpha = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const float pr = sc[j][e] > kNegInf ? exp2f(sc[j][e] - m[i]) : 0.0f;
        l[i] += pr;
        sc[j][e] = pr;
      }
    // O += P.V over the warp's 16 keys, P as bf16 hi + lo
    uint32_t ph[4], pl[4];
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
    const int vkey = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int n2 = 0; n2 < HD / 16; ++n2) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, vs + vkey * C::LDS + n2 * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * n2], ph, bv[0], bv[1]);
      mma_bf16(o[2 * n2], pl, bv[0], bv[1]);
      mma_bf16(o[2 * n2 + 1], ph, bv[2], bv[3]);
      mma_bf16(o[2 * n2 + 1], pl, bv[2], bv[3]);
    }
    __syncthreads();   // the slot is refilled next
  }
  cp_async_wait<0>();

  // merge the 4 warps through shared memory (the ring is free now)
  float* wm = reinterpret_cast<float*>(smem);        // [4][16] m, then l
  float* wl = wm + 4 * kSplitRows;
  float* wo = wl + 4 * kSplitRows;                    // [4][16][HD]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const int r = g + 8 * i;
    if (t == 0) {
      wm[warp * kSplitRows + r] = m[i];
      wl[warp * kSplitRows + r] = l[i];
    }
    float* orow = wo + (warp * kSplitRows + r) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
  }
  __syncthreads();
  // each row's weight per warp, once; then the weighted sums, 4 columns a
  // thread
  float* wgt = wo + 4 * kSplitRows * HD;              // [4][16]
  if (tid < kSplitRows) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (wl[w * kSplitRows + tid] > 0.0f) M = fmaxf(M, wm[w * kSplitRows + tid]);
    float L = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float lw = wl[w * kSplitRows + tid];
      const float e = lw > 0.0f ? exp2f(wm[w * kSplitRows + tid] - M) : 0.0f;
      wgt[w * kSplitRows + tid] = e;
      L += lw * e;
    }
    if (tid < rows.R) {
      ml[2 * tid] = M;
      ml[2 * tid + 1] = L;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows.R * (HD / 4); idx += kSplitThreads) {
    const int r = idx / (HD / 4), c = idx % (HD / 4);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float e = wgt[w * kSplitRows + r];
      const float4 x = *reinterpret_cast<const float4*>(wo + (w * kSplitRows + r) * HD + 4 * c);
      sum.x = fmaf(e, x.x, sum.x);
      sum.y = fmaf(e, x.y, sum.y);
      sum.z = fmaf(e, x.z, sum.z);
      sum.w = fmaf(e, x.w, sum.w);
    }
    *reinterpret_cast<float4*>(acc + r * HD + 4 * c) = sum;
  }
}

// f32: the chunk's keys [a, bnd] on the CUDA cores, three block-wide phases
// per tile; writes the block's partial (m, l, acc) for rows < R
template <int HD>
__device__ void split_tiles_fma(unsigned char* smem, const float* __restrict__ q,
                                const float* kb, const float* vb, long long kv_stride,
                                int H, int S, int b, int kvh, const SplitRows& rows,
                                float scale_log2, int a, int bnd, float* __restrict__ ml,
                                float* __restrict__ acc) {
  using C = SplitCfg<float, HD>;
  float* qs = reinterpret_cast<float*>(smem);             // [16][HD], scaled
  float* sc = qs + kSplitRows * HD;                        // [16][BK]
  float* st = sc + kSplitRows * kSplitBK;                  // [16][4]: m, l, alpha
  float* ring = reinterpret_cast<float*>(smem + C::FMA_EXTRA);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int R = rows.R, G = rows.G;

  for (int idx = tid; idx < R * HD; idx += kSplitThreads) {
    const int r = idx / HD, dd = idx % HD;
    qs[idx] = q[((static_cast<long long>(b) * S + r / G) * H + kvh * G + r % G) * HD + dd] *
              scale_log2;
  }
  if (tid < kSplitRows) {
    st[tid * 4] = kNegInf;
    st[tid * 4 + 1] = 0.0f;
  }

  // P.V: each thread owns one float4 column of HD for NR rows
  constexpr int COLS = HD / 4, SLOTS = kSplitThreads / COLS;
  constexpr int NR = (kSplitRows + SLOTS - 1) / SLOTS;
  const int col = tid % COLS, slot = tid / COLS;
  float4 o[NR];
#pragma unroll
  for (int u = 0; u < NR; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int n_tiles = (bnd - a) / kSplitBK + 1;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_tiles)
      split_load_tile<float, HD>(ring + s * 2 * C::TILE, ring + s * 2 * C::TILE + C::TILE, kb,
                                 vb, kv_stride, a + s * kSplitBK, bnd);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int pre = it + C::STAGES - 1;
    if (pre < n_tiles) {
      float* dst = ring + (pre % C::STAGES) * 2 * C::TILE;
      split_load_tile<float, HD>(dst, dst + C::TILE, kb, vb, kv_stride, a + pre * kSplitBK,
                                 bnd);
    }
    cp_async_commit();
    cp_async_wait<C::STAGES - 1>();
    __syncthreads();
    const float* ks = ring + (it % C::STAGES) * 2 * C::TILE;
    const float* vs = ks + C::TILE;
    const int t0 = a + it * kSplitBK;

    // scores: key j, rows rg, rg + 2, ...
    {
      const int j = tid % kSplitBK, rg = tid / kSplitBK;
      const int key = t0 + j;
      float s[kSplitRows / 2];
#pragma unroll
      for (int u = 0; u < kSplitRows / 2; ++u) s[u] = 0.0f;
      const float* kr = ks + j * C::LDS;
#pragma unroll 4
      for (int c = 0; c < HD / 4; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + 4 * c);
#pragma unroll
        for (int u = 0; u < kSplitRows / 2; ++u) {
          if (rg + 2 * u < R) {
            const float4 qq = *reinterpret_cast<const float4*>(qs + (rg + 2 * u) * HD + 4 * c);
            s[u] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, fmaf(qq.z, kk.z, fmaf(qq.w, kk.w, s[u]))));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSplitRows / 2; ++u) {
        const int r = rg + 2 * u;
        if (r < R)
          sc[r * kSplitBK + j] = key <= bnd && rows.sees(r, key) ? s[u] : kNegInf;
      }
    }
    __syncthreads();
    // the row softmax: warp w takes rows w, w + 4, ...
    for (int r = warp; r < R; r += 4) {
      const float x0 = sc[r * kSplitBK + lane], x1 = sc[r * kSplitBK + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float mo = st[r * 4], mn = fmaxf(mo, mx);
      const float p0 = x0 > kNegInf ? exp2f(x0 - mn) : 0.0f;
      const float p1 = x1 > kNegInf ? exp2f(x1 - mn) : 0.0f;
      sc[r * kSplitBK + lane] = p0;
      sc[r * kSplitBK + lane + 32] = p1;
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(mo - mn);
        st[r * 4] = mn;
        st[r * 4 + 1] = st[r * 4 + 1] * alpha + ps;
        st[r * 4 + 2] = alpha;
      }
    }
    __syncthreads();
    // O = alpha * O + P.V
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const int r = slot + u * SLOTS;
      if (r < R) {
        const float al = st[r * 4 + 2];
        float4 acc4 = make_float4(o[u].x * al, o[u].y * al, o[u].z * al, o[u].w * al);
        const float* pr = sc + r * kSplitBK;
#pragma unroll 8
        for (int j = 0; j < kSplitBK; ++j) {
          const float p = pr[j];
          const float4 vv = *reinterpret_cast<const float4*>(vs + j * C::LDS + 4 * col);
          acc4.x = fmaf(p, vv.x, acc4.x);
          acc4.y = fmaf(p, vv.y, acc4.y);
          acc4.z = fmaf(p, vv.z, acc4.z);
          acc4.w = fmaf(p, vv.w, acc4.w);
        }
        o[u] = acc4;
      }
    }
    __syncthreads();   // the slot and the scores are rewritten next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < NR; ++u) {
    const int r = slot + u * SLOTS;
    if (r < R) {
      *reinterpret_cast<float4*>(acc + r * HD + 4 * col) = o[u];
      if (col == 0) {
        ml[2 * r] = st[r * 4];
        ml[2 * r + 1] = st[r * 4 + 1];
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kSplitThreads)
fa_split_kernel(T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, unsigned* __restrict__ tickets,
                float* __restrict__ ws_ml, float* __restrict__ ws_acc, int S, int Tk, int H,
                int KH, int G, int q_offset, int window, int kv_len, float scale_log2,
                int chunk, int n_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  // group-major block order: consecutive blocks take the same split of
  // different (kv head, batch) groups, so the splits a window can see, and
  // with them the work, spread over all SMs
  const int groups = gridDim.x / n_split;
  const int split = blockIdx.x / groups, group = blockIdx.x % groups;
  const int b = group / KH, kvh = group % KH;
  const int tid = threadIdx.x;
  const SplitRows rows{S * G, G, q_offset, window, kv_len};

  // the keys some row sees (row 0 has the lowest bound), cut to the chunk
  const int lo = max(0, q_offset - window + 1);
  const int hi = min(min(q_offset + S - 1, kv_len - 1), Tk - 1);
  const int a = max(lo, split * chunk);
  const int bnd = min(hi, split * chunk + chunk - 1);
  const long long part = static_cast<long long>(group) * n_split + split;
  float* ml = ws_ml + part * kSplitRows * 2;
  float* acc = ws_acc + part * kSplitRows * HD;

  if (a <= bnd) {
    const long long kv_stride = static_cast<long long>(KH) * HD;
    const T* kb = k + (static_cast<long long>(b) * Tk * KH + kvh) * HD;
    const T* vb = v + (static_cast<long long>(b) * Tk * KH + kvh) * HD;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      split_tiles_mma<HD>(smem, q, kb, vb, kv_stride, H, S, b, kvh, rows, scale_log2, a, bnd,
                          ml, acc);
    else
      split_tiles_fma<HD>(smem, q, kb, vb, kv_stride, H, S, b, kvh, rows, scale_log2, a, bnd,
                          ml, acc);
  } else if (tid < rows.R) {
    ml[2 * tid] = kNegInf;   // an empty partial: the merge skips l = 0
    ml[2 * tid + 1] = 0.0f;
  }

  // the last block of this (kv head, batch) merges every split's partial
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[group], 1u) == static_cast<unsigned>(n_split - 1);
  __syncthreads();
  if (!last) return;
  if (tid == 0) tickets[group] = 0u;   // ready for the next call

  const int R = rows.R;
  const float* gml = ws_ml + static_cast<long long>(group) * n_split * kSplitRows * 2;
  const float* gacc = ws_acc + static_cast<long long>(group) * n_split * kSplitRows * HD;
  float* sw = reinterpret_cast<float*>(smem);          // [n_split][16] weights
  float* sL = sw + kMaxSplits * kSplitRows;            // [16]
  // a thread's output items are (row, 4 columns); it loads the acc of up
  // to kBatch splits at once, and the first batch of its first item goes
  // out before the weights exist, so the merge costs about one round trip
  constexpr int kBatch = 16;
  const int items = R * (HD / 4);
  float4 x[kBatch];
  auto load_batch = [&](int i, int s0) {
    const int r = i / (HD / 4), c = i % (HD / 4);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (s0 + u < n_split)
        x[u] = __ldcg(reinterpret_cast<const float4*>(
            gacc + (static_cast<long long>(s0 + u) * kSplitRows + r) * HD + 4 * c));
  };
  if (tid < items) load_batch(tid, 0);
  // the weights: warp w takes rows w, w + 4, ..., its lanes the splits
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < R; r += kSplitThreads / 32) {
    float mv[2], lv[2];
    float M = kNegInf;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = lane + 32 * j;
      mv[j] = kNegInf;
      lv[j] = 0.0f;
      if (s < n_split) {
        mv[j] = __ldcg(gml + (s * kSplitRows + r) * 2);
        lv[j] = __ldcg(gml + (s * kSplitRows + r) * 2 + 1);
      }
      if (lv[j] > 0.0f) M = fmaxf(M, mv[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
    float L = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = lane + 32 * j;
      const float w = lv[j] > 0.0f ? exp2f(mv[j] - M) : 0.0f;
      if (s < n_split) sw[s * kSplitRows + r] = w;
      L += lv[j] * w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(kFull, L, off);
    if (lane == 0) sL[r] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < items; i += kSplitThreads) {
    const int r = i / (HD / 4), c = i % (HD / 4);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_split; s0 += kBatch) {
      if (i != tid || s0 != 0) load_batch(i, s0);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s0 + u < n_split) {
          // a split whose l is 0 never wrote its acc: selected away
          const float w = sw[(s0 + u) * kSplitRows + r];
          const float4 xv = w > 0.0f ? x[u] : make_float4(0.f, 0.f, 0.f, 0.f);
          sum.x = fmaf(w, xv.x, sum.x);
          sum.y = fmaf(w, xv.y, sum.y);
          sum.z = fmaf(w, xv.z, sum.z);
          sum.w = fmaf(w, xv.w, sum.w);
        }
      }
    }
    const float inv = sL[r];
    T* orow = out + ((static_cast<long long>(b) * S + r / G) * H + kvh * G + r % G) * HD + 4 * c;
    orow[0] = from_f32<T>(sum.x / inv);
    orow[1] = from_f32<T>(sum.y / inv);
    orow[2] = from_f32<T>(sum.z / inv);
    orow[3] = from_f32<T>(sum.w / inv);
  }
}

template <typename T, int HD>
int launch_split(void* out, const void* q, const void* k, const void* v, SplitWs ws, int B,
                 int S, int Tk, int H, int KH, int q_offset, int window, int kv_len,
                 cudaStream_t stream) {
  using C = SplitCfg<T, HD>;
  if (ws.partials == nullptr || ws.tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_split_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const SplitPlan plan = split_plan(B, KH, Tk);
  const int groups = B * KH;
  float* ml = static_cast<float*>(ws.partials);
  float* acc = ml + static_cast<long long>(groups) * plan.n_split * kSplitRows * 2;
  const float scale_log2 =
      static_cast<float>(kLog2e / sqrt(static_cast<double>(HD)));
  fa_split_kernel<T, HD><<<plan.n_split * groups, kSplitThreads,
                           C::smem_bytes(plan.chunk / kSplitBK), stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ws.tickets, ml, acc, S, Tk, H, KH,
      H / KH, q_offset, window, kv_len, scale_log2, plan.chunk, plan.n_split);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 prefill at hd 64 / 128: wgmma + TMA
// ---------------------------------------------------------------------------

template <int HD>
struct WgCfg {
  static constexpr int BK = 64;                   // keys per tile
  static constexpr int NWG = 2;                   // consumer warpgroups
  static constexpr int ROWS = 64 * NWG;           // rows per block
  static constexpr int NT = 128 * NWG + 32;       // + the producer warp
  static constexpr int HALVES = HD / 64;          // 128-byte column boxes per row
  static constexpr int SUB = BK * 128;            // bytes of one [BK][64] bf16 box
  static constexpr int STAGE = 2 * HALVES * SUB;  // K and V of one tile
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + room to align to 1024
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// a shared-memory matrix descriptor for a 128-byte-swizzled operand of
// 128-byte rows: start address >> 4, the leading byte offset, a stride of
// 1024 B between 8-row groups, swizzle mode 1 (128 B).  K (K-major) does
// not read the leading offset; V (N-major, 64 columns: one swizzle atom
// wide) steps over keys by 8-row groups, which PTX's canonical N-major
// layout strides by SBO; LBO = 1024 too keeps that stride whichever of the
// two offsets the hardware reads for it.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving register reads or writes of an
// accumulator across the asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16 bf16, registers) . B (16 x 64 bf16, shared
// memory); TRANS_B = 0: B is K-major (k contiguous), 1: N-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TRANS_B));
}

// Rows, masks and key range as in fa_kernel.  A consumer thread (warp wq of
// its warpgroup, g = lane / 4, t = lane % 4) holds rows 16 wq + g and
// 16 wq + g + 8 of the warpgroup's 64, and columns 8 j + 2 t, 8 j + 2 t + 1
// of every accumulator (PTX's wgmma D fragment); the same thread gives the
// A fragment of those rows, so S's fragment becomes P's without a shuffle.
template <int HD>
__global__ void __launch_bounds__(WgCfg<HD>::NT, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
                __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ q, int S,
                int Tk, int H, int KH, int G, int q_offset, int window, int kv_len,
                float scale_log2) {
  using C = WgCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = S * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * C::ROWS;   // longest blocks first
  const int s_first = r0 / G, s_last = (min(r0 + C::ROWS, n_rows) - 1) / G;
  const int lo = max(0, q_offset + s_first - window + 1);
  const int hi = min(min(q_offset + s_last, kv_len - 1), Tk - 1);
  const int n_tiles = hi >= lo ? (hi - lo) / C::BK + 1 : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::NWG) {   // the producer
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        mbar_wait(smem_u32(&empty[s]), ((i / C::STAGES) & 1) ^ 1);
        const uint32_t fb = smem_u32(&full[s]);
        mbar_expect_tx(fb, C::STAGE);
        const uint32_t kd = base + s * C::STAGE, vd = kd + C::HALVES * C::SUB;
        const int t0 = lo + i * C::BK;
#pragma unroll
        for (int h = 0; h < C::HALVES; ++h) {
          tma_load_4d(kd + h * C::SUB, &tmk, fb, 64 * h, kvh, t0, b);
          tma_load_4d(vd + h * C::SUB, &tmv, fb, 64 * h, kvh, t0, b);
        }
      }
    }
    return;
  }

  const int wg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int rw = r0 + wg * 64;                 // the warpgroup's first row
  bool act[2];
  int qpos[2];
  long long orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rw + wq * 16 + g + 8 * i;
    act[i] = r < n_rows;
    const int s = act[i] ? r / G : 0;
    qpos[i] = q_offset + s;
    orow[i] = ((static_cast<long long>(b) * S + s) * H + kvh * G + (act[i] ? r % G : 0)) * HD;
  }
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int d0 = kk * 16 + 2 * t;
    qa[kk][0] = act[0] ? ld32(q + orow[0] + d0) : 0u;
    qa[kk][1] = act[1] ? ld32(q + orow[1] + d0) : 0u;
    qa[kk][2] = act[0] ? ld32(q + orow[0] + d0 + 8) : 0u;
    qa[kk][3] = act[1] ? ld32(q + orow[1] + d0 + 8) : 0u;
  }
  // the warpgroup's positions: which tiles it skips, which it takes whole
  const bool none = rw >= n_rows;
  const int q_min = q_offset + rw / G;
  const int q_max = q_offset + (min(rw + 63, n_rows - 1)) / G;
  const int vis_hi = min(q_max, kv_len - 1), vis_lo = q_min - window + 1;
  const int all_hi = min(q_min, kv_len - 1), all_lo = q_max - window + 1;

  float o[C::HALVES][32];
#pragma unroll
  for (int h = 0; h < C::HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % C::STAGES;
    const int t0 = lo + it * C::BK, t1 = t0 + C::BK - 1;
    mbar_wait(smem_u32(&full[s]), (it / C::STAGES) & 1);
    if (!none && t0 <= vis_hi && t1 >= vis_lo) {
      const bool interior = t1 <= all_hi && t0 >= all_lo;
      const uint32_t kd = base + s * C::STAGE, vd = kd + C::HALVES * C::SUB;
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_64x64<0>(sc, qa[kk], sw128_desc(kd + (kk / 4) * C::SUB + (kk % 4) * 32, 16), kk > 0);
      wg_commit();
      wg_wait0();
      fence_regs(sc);

      // scale (log2 domain), mask the edge tiles, the new running max
      float mx[2] = {m[0], m[1]};
      if (interior) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] *= scale_log2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1, key = t0 + (i >> 2) * 8 + 2 * t + (i & 1);
          const bool valid = key <= qpos[r] && key > qpos[r] - window && key < kv_len;
          sc[i] = valid ? sc[i] * scale_log2 : kNegInf;
          mx[r] = fmaxf(mx[r], sc[i]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      if (interior) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
          l[(i >> 1) & 1] += sc[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = sc[i] > kNegInf ? exp2f(sc[i] - m[r]) : 0.0f;
          l[r] += sc[i];
        }
      }
      // P as the A fragment of 4 k-steps of 16 keys, bf16 hi + lo
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1], ph[kk][x], pl[kk][x]);
#pragma unroll
      for (int h = 0; h < C::HALVES; ++h) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[h][i] *= alpha[(i >> 1) & 1];
        fence_regs(o[h]);
      }
      wg_fence();
#pragma unroll
      for (int h = 0; h < C::HALVES; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv = sw128_desc(vd + h * C::SUB + kk * 2048, 1024);
          wgmma_64x64<1>(o[h], ph[kk], dv, 1);
          wgmma_64x64<1>(o[h], pl[kk], dv, 1);
        }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int h = 0; h < C::HALVES; ++h) fence_regs(o[h]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    if (!act[r]) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int h = 0; h < C::HALVES; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(o[h][4 * j + 2 * r] / denom,
                                                          o[h][4 * j + 2 * r + 1] / denom);
        *reinterpret_cast<__nv_bfloat162*>(out + orow[r] + h * 64 + j * 8 + 2 * t) = pair;
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links against nothing but the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// k or v (B, Tk, KH, hd) bf16 as a 4-D map (hd, KH, kv_len, B): a box of 64
// columns of one kv head over 64 keys of one batch row; keys at or past
// kv_len come as zeros
bool kv_map(CUtensorMap* map, const void* base, int B, int Tk, int KH, int hd, int kv_len) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(KH),
                              static_cast<cuuint64_t>(std::max(kv_len, 1)),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(KH) * hd * 2,
                                 static_cast<cuuint64_t>(Tk) * KH * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(void* out, const void* q, const void* k, const void* v, int B, int S, int Tk,
                 int H, int KH, int q_offset, int window, int kv_len, cudaStream_t stream) {
  using C = WgCfg<HD>;
  static_assert(WgCfg<HD>::BK == 64, "the map's box is 64 keys");
  CUtensorMap tmk, tmv;
  if (!kv_map(&tmk, k, B, Tk, KH, HD, kv_len) || !kv_map(&tmv, v, B, Tk, KH, HD, kv_len))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int G = H / KH;
  const float scale_log2 = static_cast<float>(kLog2e / sqrt(static_cast<double>(HD)));
  const dim3 grid((S * G + C::ROWS - 1) / C::ROWS, KH, B);
  fa_wgmma_kernel<HD><<<grid, C::NT, C::SMEM, stream>>>(
      tmk, tmv, static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(q), S, Tk,
      H, KH, G, q_offset, window, kv_len, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// decode (S * G <= 16): the split kernel; bf16 prefill at hd 64 or 128: the
// wgmma kernel; other prefill: FMA tiles of 64 rows (32 at hd 128), 256
// threads
template <typename T, int HD>
int dispatch(void* out, const void* q, const void* k, const void* v, SplitWs ws, int B, int S,
             int Tk, int H, int KH, int q_offset, int window, int kv_len,
             cudaStream_t stream) {
  constexpr int D = Cfg<HD, 1, 1>::D;
  constexpr int RP = HD == 128 ? 32 : 64;
  constexpr int WP = 256 / (RP * D);
  if (S * (H / KH) <= kSplitRows)
    return launch_split<T, HD>(out, q, k, v, ws, B, S, Tk, H, KH, q_offset, window, kv_len,
                               stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value && (HD == 64 || HD == 128))
    return launch_wgmma<HD>(out, q, k, v, B, S, Tk, H, KH, q_offset, window, kv_len, stream);
  return launch<T, HD, RP, WP>(out, q, k, v, B, S, Tk, H, KH, q_offset, window, kv_len,
                               stream);
}

template <typename T>
int dispatch_hd(void* out, const void* q, const void* k, const void* v, SplitWs ws, int B,
                int S, int Tk, int H, int KH, int hd, int q_offset, int window, int kv_len,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return dispatch<T, 16>(out, q, k, v, ws, B, S, Tk, H, KH, q_offset, window, kv_len, stream);
    case 32: return dispatch<T, 32>(out, q, k, v, ws, B, S, Tk, H, KH, q_offset, window, kv_len, stream);
    case 64: return dispatch<T, 64>(out, q, k, v, ws, B, S, Tk, H, KH, q_offset, window, kv_len, stream);
    case 128: return dispatch<T, 128>(out, q, k, v, ws, B, S, Tk, H, KH, q_offset, window, kv_len, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// bytes of the partials a decode call of this shape needs (0 for
// prefill), -1 for a shape fa_forward refuses; its tickets are B * KH
// unsigned words of their own
int fa_workspace_bytes(int B, int S, int Tk, int H, int KH, int hd) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0 || hd <= 0) return -1;
  if (S * (H / KH) > kSplitRows) return 0;
  const long long bytes = split_ws_bytes(B * KH, split_plan(B, KH, Tk).n_split, hd);
  return bytes > INT_MAX ? -1 : static_cast<int>(bytes);
}

// dtype 0 = float32, 1 = bfloat16 (q, k, v and out share it).  A decode
// call takes ws, the fa_workspace_bytes of its partials, and tickets, at
// least B * KH words that are 0 before its first use and that every call
// leaves at 0; prefill ignores both.
int fa_forward(void* out, const void* q, const void* k, const void* v, int B, int S,
               int Tk, int H, int KH, int hd, int q_offset, int window, int kv_len,
               int dtype, void* ws, void* tickets, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const SplitWs sw{ws, static_cast<unsigned*>(tickets)};
  if (B <= 0 || S <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0 || kv_len > Tk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<float>(out, q, k, v, sw, B, S, Tk, H, KH, hd, q_offset, window, kv_len,
                              st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(out, q, k, v, sw, B, S, Tk, H, KH, hd, q_offset, window,
                                      kv_len, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
