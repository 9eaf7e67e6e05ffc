// Client-upload kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Each kernel replaces one piece of the JAX package's client upload:
//
//   up_compress_delta   <- src/repro/kernels/fused_update.py:_compress_delta_kernel
//                          (wrapper compress_delta)
//       x <- d*[|d| >= tau] (topk);  per 128-lane row:
//       scale = bf16(amax/qmax * (1 + 2^-6)),  c = clip(rint(x/scale), +-qmax)*scale
//       (bits 8 or 16; bits 32 keeps x), residual r = d - c
//   up_topk_threshold   <- src/repro/fl/compression.py:topk_threshold (jnp, not
//                          Pallas: a 31-step greedy search over the bits of |d|)
//       tau = the k-th largest |d|, exactly
//   up_topk_compress    <- the two above in sequence (FlatParamOps.compress_delta
//                          with top-k): tau, then compress_delta at tau, in one
//                          launch up to the cut
//   up_dp_clip_noise    <- src/repro/kernels/fused_update.py:_dp_clip_noise_kernel
//                          (wrapper dp_clip_noise)
//       u = clip_scale*d (+ noise_scale*z)
//   up_dp_clip_noise_rows <- the same kernel once per client of a round, with
//                          the subtraction that made each d (wrapper
//                          dp_clip_noise_rows)
//       u[k] = clip_scales[k]*(w[k] - p) (+ noise_scale*z[k]), k = 0..K-1
//
// What bounds them on an H100: all of them stream their operands once and do
// a few operations per element, so device-memory bytes bound them:
// compress_delta reads 4 B and writes 8 B per element (c and r; 4 B without
// the residual), topk_threshold reads 4 B per element once (this design reads
// it into shared memory once up to the cut and four times above it, one
// pass per byte of the key; at the main path's 137,216 elements the launch
// and four rounds of exchange between the CTAs of its cluster, not the
// 0.16 us of bytes, bound it), topk_compress the same 12 B as compress_delta
// (its second read of d comes from L2), dp_clip_noise reads 8 B
// (d and z) and writes 4 B.  At LeNet-5 size (137,216 padded elements) each
// is far below a microsecond of bytes and the launch dominates.  The rows
// form reads 8 B per element of each of the K rows (w in f32, z) and writes
// 4 B, plus p once: 17 MB at K 10, about 5 us of bytes, where the K
// subtractions, K launches and the stack of the uploads it replaces moved
// more than twice that.
//
// What the design does:
//  * compress_delta: one warp per 128-lane row (the JAX kernel's block rows
//    start at element 0 of the buffer, and so do these), 4 lanes per thread
//    as one float4 when the length is a multiple of 128 and the pointers are
//    16-byte aligned, otherwise bounds-checked scalar loads with zeros past
//    the end (the JAX wrapper's zero padding).  The row's |max| is a
//    __shfl_xor_sync butterfly: a max is exact in any order.  tau arrives as
//    a device pointer and is never read on the host.  It is launched with
//    programmatic dependent launch (launch_pdl): griddepcontrol.wait before
//    any access to global memory, then griddepcontrol.launch_dependents, so
//    its blocks may be staged while the kernel before it drains (behind the
//    cluster threshold, which triggers at its start, while that runs).
//  * topk_threshold: a radix select over the f32 bit pattern of |d| (a
//    non-negative float orders like its bits), one 8-bit digit per pass,
//    most significant first.  Pass p builds a 256-bin histogram of digit p
//    among the elements whose higher digits equal the prefix found so far;
//    a suffix scan of it gives the next digit and the rank left to find.
//    After four passes the prefix is the k-th largest value's bit pattern,
//    which is what the greedy bit search of the JAX package finds.  Counts
//    are integers, so the result is exact whatever order anything lands in.
//    Two kernels, chosen by n (a size dispatch, never a fallback):
//    - up to kCluster * kClusterSliceMax keys, topk_cluster_kernel: ONE
//      launch of one thread-block cluster of kCluster = 16 CTAs x 1024
//      threads.  Each CTA loads its slice of the keys bits(|d|) into shared
//      memory once (slices of a multiple of 128 keys; past n a key is
//      0xFFFFFFFF, whose set sign bit matches no prefix).  Per pass each CTA
//      counts its slice into a 256-bin shared histogram by shared atomics
//      (faster on the card than aggregating a warp's equal digits with
//      __match_any_sync first, or than per-warp histograms), then sends it to every
//      CTA of the cluster with st.async: 16 bytes per thread into the
//      receiver's staging row for the sender, completing the receiver's
//      mbarrier by bytes.  Each CTA waits only on its own mbarrier, sums
//      the 16 rows and runs the same suffix scan, so all agree on the digit
//      with no broadcast and no cluster barrier inside the loop.  Staging
//      and mbarriers alternate by pass parity: a CTA sends pass p + 2 only
//      after it received every CTA's pass p + 1, which each CTA sends only
//      after reading its own pass-p staging.  Cluster barriers: one after
//      the mbarriers are initialized (its wait after the keys are loaded),
//      one before exit so that no CTA leaves while its stores are in
//      flight.  The launch also takes programmatic dependent launch: the
//      set-up runs while the kernel before it drains, and
//      griddepcontrol.wait comes before the first read of d.  No
//      workspace, no global atomics, no memset.
//      With BITS != 0 the same launch is the top-k compressed upload
//      (up_topk_compress), replacing the threshold launch plus a
//      compress_delta launch that read d again.  After the last pass every
//      CTA holds tau with no further exchange, and it compresses 128-lane
//      rows of its own slice (a slice starts at a multiple of 128 keys, so
//      no row crosses CTAs), one warp per row, with compress_delta's
//      arithmetic (compress_row).  d is rebuilt from the keys and one sign
//      bit per key, gathered by warp ballots during the load and kept in
//      shared memory (slice / 8 bytes more), so it is not read again.  On
//      16 SMs of an H100 the epilogue was slower than compress_delta on all
//      of them (the stores of c and r bound it), so the launch holds G
//      independent clusters, as many as the card runs at once (7 there) but
//      no more than a slice has rows: each finds the same tau (an exact
//      count, the work of a cluster is no slower beside the others) and
//      cluster g compresses rows g, g + G, ... of every slice.  Only block
//      0 writes tau; places past n are written by nothing.
//    - above it, topk_pass_kernel: four launches, one per digit, each over
//      the whole of |d| in a grid-stride pass (per-block shared histogram,
//      warp-aggregated, merged with global atomics); the last block to
//      finish (a __threadfence plus an atomic ticket) runs the scan and
//      leaves the prefix and rank for the next launch in a workspace that
//      is zeroed by one memset per call.
//    up_topk_compress above the cut is the four passes and then compress_delta,
//    chosen by the Python wrapper (five launches).
//  * dp_clip_noise: a grid-stride elementwise pass, float4 loads and stores,
//    launched with programmatic dependent launch: griddepcontrol.wait before
//    any access to global memory (out too: the allocator may hand it over
//    from a kernel still running), then griddepcontrol.launch_dependents.
//    The rows form is one such launch for all K clients of a round (per
//    bucket): a 2-D grid, blockIdx.y the client row, x a grid-stride pass
//    over the row with 16-byte loads of w (float4, or 8 x bf16) and p (read
//    once per row, from L2 after the first), f32 z and out as float4.  Each
//    element is rounded as the subtraction and dp_clip_noise it replaces
//    round it (__fsub_rn, __fmul_rn, __fadd_rn), and the rows land straight
//    in the (K, n) stack that weighted_delta reads.
//
// Rounding: every step uses the _rn intrinsics (__fdiv_rn, __fmul_rn,
// __fsub_rn, __fadd_rn), which nvcc never contracts into an FMA, rintf rounds
// half to even, and __float2bfloat16_rn rounds the scale to nearest even, so
// each kernel is bit-equal to its plain PyTorch version in
// repro_torch/kernels/fused_update.py.  An all-zero row keeps scale 0 and
// skips the division: it emits exact zeros.
//
// Each up_* launcher enqueues on the given stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;   // one warp per 128-lane row
constexpr long long kMaxBlocks = 132LL * 16;   // 16 blocks per SM, grid-stride
constexpr float kScalePad = 1.015625f;         // 1 + 2^-6, exact in f32

// topk_threshold workspace, in 32-bit words: four 256-bin histograms, four
// done-tickets, then (prefix, rank left) before passes 1..3
constexpr int kBins = 256;
constexpr int kTicket = 4 * kBins;
constexpr int kState = kTicket + 4;
constexpr int kWorkspaceWords = kState + 8;

// topk_cluster_kernel: threads per CTA, CTAs per cluster (a non-portable
// size: measured faster than 8 CTAs at the main path's bucket), the granule of a CTA's slice (one float4 per lane of a warp), the most keys a
// CTA holds (160 KB of shared memory, beside 33 KB of histograms), the key
// past n
constexpr int kClusterThreads = 1024;
constexpr int kCluster = 16;
constexpr int kSliceGranule = 128;
constexpr int kClusterSliceMax = 40 * 1024;
constexpr unsigned kNoKey = 0xFFFFFFFFu;
static_assert(kClusterThreads / 64 >= kCluster, "64 senders per destination CTA");
static_assert(kSliceGranule % kLanes == 0, "a CTA's slice holds whole 128-lane rows");

__host__ __device__ inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

inline int grid_for(long long n_items, int per_block) {
  long long blocks = (n_items + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename F>
void dispatch_bool(bool b, F&& f) {
  if (b) f(std::true_type{});
  else f(std::false_type{});
}

// `kernel` on `grid` blocks of kThreads, with programmatic dependent launch
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, cudaStream_t stream,
                       Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---------------------------------------------------------------------------
// compress_delta
// ---------------------------------------------------------------------------

// compress_delta's arithmetic on one 128-lane row, 4 lanes per thread of a
// warp: x = d*[|d| >= tau] (TOPK; compared in float, so a NaN is dropped),
// the row's |max| by a __shfl_xor_sync butterfly, scale = bf16(amax/qmax *
// (1 + 2^-6)), c = clip(rint(x/scale), +-qmax)*scale (BITS 8 or 16; 32 keeps
// x; a zero scale gives zeros).  Every lane of the warp calls it together.
template <int BITS, bool TOPK>
__device__ __forceinline__ void compress_row(const float (&d0)[4], float tau,
                                             float (&x)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j] = d0[j];
    if constexpr (TOPK) x[j] = fabsf(d0[j]) >= tau ? d0[j] : 0.0f;
  }
  if constexpr (BITS != 32) {
    constexpr float qmax = BITS == 8 ? 127.0f : 32767.0f;
    float amax = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])),
                       fmaxf(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __bfloat162float(
        __float2bfloat16_rn(__fmul_rn(__fdiv_rn(amax, qmax), kScalePad)));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (scale > 0.0f) {
        // a zero x (every element top-k drops) quantizes to itself, +0 or
        // -0: skip its division, whose range check sends a zero dividend
        // down the slow path
        if (x[j] != 0.0f) {
          float q = rintf(__fdiv_rn(x[j], scale));
          q = fminf(fmaxf(q, -qmax), qmax);
          x[j] = __fmul_rn(q, scale);
        }
      } else {
        x[j] = 0.0f;
      }
    }
  }
}

// this lane's 4 elements of a compressed row at `base`: c = x and r = d - c,
// as float4 stores when VEC (the row lies inside n, the pointers are 16-byte
// aligned; streaming stores, st.global.cs, when STREAM), otherwise one by
// one where they lie inside n
template <bool RES, bool VEC, bool STREAM = false>
__device__ __forceinline__ void store_row(float* __restrict__ c, float* __restrict__ r,
                                          long long n, long long base,
                                          const float (&d0)[4], const float (&x)[4]) {
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) res[j] = __fsub_rn(d0[j], x[j]);
  if constexpr (VEC) {
    const float4 cv = make_float4(x[0], x[1], x[2], x[3]);
    const float4 rv = make_float4(res[0], res[1], res[2], res[3]);
    float4* cp = reinterpret_cast<float4*>(c + base);
    float4* rp = reinterpret_cast<float4*>(r + base);
    if constexpr (STREAM) {
      __stcs(cp, cv);
      if constexpr (RES) __stcs(rp, rv);
    } else {
      *cp = cv;
      if constexpr (RES) *rp = rv;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (base + j < n) {
        c[base + j] = x[j];
        if constexpr (RES) r[base + j] = res[j];
      }
    }
  }
}

// one 128-lane row of d at `row0`, 4 elements per lane: as one float4 when
// VEC, otherwise bounds-checked with zeros past n (the JAX wrapper's
// padding); then compress_row and store_row
template <int BITS, bool TOPK, bool RES, bool VEC>
__device__ __forceinline__ void compress_row_at(const float* __restrict__ d, float tau,
                                                float* __restrict__ c,
                                                float* __restrict__ r, long long n,
                                                long long row0) {
  const long long base = row0 + (threadIdx.x & 31) * 4;
  float d0[4], x[4];
  if constexpr (VEC) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(d + base));
    d0[0] = v.x; d0[1] = v.y; d0[2] = v.z; d0[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) d0[j] = base + j < n ? __ldg(d + base + j) : 0.0f;
  }
  compress_row<BITS, TOPK>(d0, tau, x);
  store_row<RES, VEC>(c, r, n, base, d0, x);
}

template <int BITS, bool TOPK, bool RES, bool VEC>
__global__ void __launch_bounds__(kThreads)
compress_delta_kernel(const float* __restrict__ d, const float* __restrict__ tau_p,
                      float* __restrict__ c, float* __restrict__ r, long long n,
                      long long rows) {
  const long long stride = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  // PDL: the kernel before this one may have written d or tau, or still
  // read the memory that c and r now hold
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  float tau = 0.0f;
  if constexpr (TOPK) tau = *tau_p;
  // the row loop is uniform across a warp, so every lane reaches the shuffles
  for (long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                       (threadIdx.x >> 5);
       row < rows; row += stride)
    compress_row_at<BITS, TOPK, RES, VEC>(d, tau, c, r, n, row * kLanes);
}

int launch_compress_delta(const float* d, const float* tau, float* c, float* r,
                          long long n, int bits, bool topk, cudaStream_t stream) {
  const bool res = r != nullptr;
  const bool vec = (n % kLanes == 0) && aligned16(d) && aligned16(c) &&
                   (!res || aligned16(r));
  const long long rows = (n + kLanes - 1) / kLanes;
  const int grid = grid_for(rows, kRowsPerBlock);
  cudaError_t err = cudaSuccess;
  auto go = [&](auto BITS_C, auto TK, auto RS, auto VC) {
    err = launch_pdl(compress_delta_kernel<decltype(BITS_C)::value, decltype(TK)::value,
                                           decltype(RS)::value, decltype(VC)::value>,
                     grid, stream, d, tau, c, r, n, rows);
  };
  auto with_bits = [&](auto TK, auto RS, auto VC) {
    if (bits == 8) go(std::integral_constant<int, 8>{}, TK, RS, VC);
    else if (bits == 16) go(std::integral_constant<int, 16>{}, TK, RS, VC);
    else go(std::integral_constant<int, 32>{}, TK, RS, VC);
  };
  dispatch_bool(topk, [&](auto TK) {
    dispatch_bool(res, [&](auto RS) {
      dispatch_bool(vec, [&](auto VC) { with_bits(TK, RS, VC); });
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// topk_threshold: radix select, one 8-bit digit of |d|'s bits per launch
// ---------------------------------------------------------------------------

// Called by every lane of the warp together (the loops below give all 32
// lanes the same trip count), so the full mask names converged lanes;
// a lane past the end of the data passes valid = false and counts nothing.
__device__ __forceinline__ void count_key(bool valid, unsigned bits,
                                          unsigned hi_mask, unsigned prefix,
                                          int shift, unsigned* hist) {
  const unsigned key = valid && (bits & hi_mask) == prefix
                           ? (bits >> shift) & 0xFFu
                           : static_cast<unsigned>(kBins);
  // lanes with the same digit add once, by their lowest lane
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
  if (key < kBins && (__ffs(peers) - 1) == static_cast<int>(threadIdx.x & 31))
    atomicAdd(&hist[key], static_cast<unsigned>(__popc(peers)));
}

template <int PASS, bool VEC>
__global__ void __launch_bounds__(kThreads)
topk_pass_kernel(const float* __restrict__ d, long long n, unsigned k,
                 unsigned* __restrict__ ws, float* __restrict__ tau) {
  constexpr int shift = 24 - 8 * PASS;
  __shared__ unsigned hist[kBins];
  __shared__ unsigned scan[kBins];
  __shared__ bool last;
  unsigned prefix = 0, rank = k;       // rank: which largest, among matches
  if constexpr (PASS > 0) {
    prefix = ws[kState + 2 * (PASS - 1)];
    rank = ws[kState + 2 * (PASS - 1) + 1];
  }
  unsigned hi_mask = 0u;                // the digits already fixed
  if constexpr (PASS > 0) hi_mask = 0xFFFFFFFFu << (shift + 8);
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  // warp-uniform trip counts: i0 is the warp's first index
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          (threadIdx.x & ~31);
  if constexpr (VEC) {
    const long long n_vec = n / 4;
    for (long long i0 = first; i0 < n_vec; i0 += stride) {
      const long long i = i0 + lane;
      const bool valid = i < n_vec;
      const float4 v = valid ? *reinterpret_cast<const float4*>(d + 4 * i)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      count_key(valid, __float_as_uint(fabsf(v.x)), hi_mask, prefix, shift, hist);
      count_key(valid, __float_as_uint(fabsf(v.y)), hi_mask, prefix, shift, hist);
      count_key(valid, __float_as_uint(fabsf(v.z)), hi_mask, prefix, shift, hist);
      count_key(valid, __float_as_uint(fabsf(v.w)), hi_mask, prefix, shift, hist);
    }
  } else {
    for (long long i0 = first; i0 < n; i0 += stride) {
      const long long i = i0 + lane;
      const bool valid = i < n;
      count_key(valid, valid ? __float_as_uint(fabsf(d[i])) : 0u, hi_mask,
                prefix, shift, hist);
    }
  }
  __syncthreads();
  unsigned* g = ws + PASS * kBins;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x)
    if (hist[i]) atomicAdd(&g[i], hist[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&ws[kTicket + PASS], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: suffix sums S(b) = #matches with digit >= b; the digit
  // of the rank-th largest is the one b with S(b) >= rank > S(b + 1)
  const int t = threadIdx.x;             // kThreads == kBins
  scan[t] = __ldcg(&g[t]);
  __syncthreads();
  for (int off = 1; off < kBins; off <<= 1) {
    const unsigned v = t + off < kBins ? scan[t + off] : 0u;
    __syncthreads();
    scan[t] += v;
    __syncthreads();
  }
  const unsigned above = t + 1 < kBins ? scan[t + 1] : 0u;
  if (scan[t] >= rank && above < rank) {
    const unsigned next = prefix | (static_cast<unsigned>(t) << shift);
    if constexpr (PASS < 3) {
      ws[kState + 2 * PASS] = next;
      ws[kState + 2 * PASS + 1] = rank - above;
    } else {
      *tau = __uint_as_float(next);
    }
  }
}

int launch_topk_threshold(const float* d, long long n, long long k, float* tau,
                          unsigned* ws, cudaStream_t stream) {
  if (k < 1 || k > n || n > 0xFFFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(ws, 0, kWorkspaceWords * sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (n % 4 == 0) && aligned16(d);
  const int grid = grid_for(vec ? n / 4 : n, kThreads);
  const unsigned kk = static_cast<unsigned>(k);
  auto go = [&](auto VC) {
    constexpr bool V = decltype(VC)::value;
    topk_pass_kernel<0, V><<<grid, kThreads, 0, stream>>>(d, n, kk, ws, tau);
    topk_pass_kernel<1, V><<<grid, kThreads, 0, stream>>>(d, n, kk, ws, tau);
    topk_pass_kernel<2, V><<<grid, kThreads, 0, stream>>>(d, n, kk, ws, tau);
    topk_pass_kernel<3, V><<<grid, kThreads, 0, stream>>>(d, n, kk, ws, tau);
  };
  dispatch_bool(vec, go);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// topk_threshold up to the cut: one launch on a thread-block cluster
// ---------------------------------------------------------------------------

// keys per CTA: ceil(n / kCluster) rounded up to kSliceGranule (0 when too
// many)
inline long long cluster_slice(long long n) {
  const long long per = (n + kCluster - 1) / kCluster;
  const long long slice = (per + kSliceGranule - 1) / kSliceGranule * kSliceGranule;
  return slice <= kClusterSliceMax ? (slice > 0 ? slice : kSliceGranule) : 0;
}

// dynamic shared memory of one CTA: the local histogram, the staging of
// every CTA's histogram by pass parity, the keys, and when compressing
// (`signs`) one word of d's sign bits per 32 keys
inline size_t cluster_smem_bytes(long long slice, bool signs = false) {
  return sizeof(unsigned) * (kBins + 2 * kCluster * kBins + static_cast<size_t>(slice) +
                             (signs ? static_cast<size_t>(slice) / 32 : 0));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the epilogue of a compressing launch: this CTA's share of the rows of its
// slice, dealt round-robin over the G clusters (cluster g takes rows g,
// g + G, ...), one row per warp at a time (the loop is warp-uniform, so
// all lanes reach the shuffles), d rebuilt from its key and sign bit, zero
// past n.  On an H100 the stores of c and r set its time, not the
// arithmetic, so every SM takes as few rows as it can, and full rows go
// out as streaming stores (st.global.cs), which were faster there where
// the slice fills shared memory.
template <int BITS, bool RES, bool VEC>
__device__ __forceinline__ void compress_slice(const unsigned* keys, const unsigned* signs,
                                               int slice, long long base, long long n,
                                               float tau, float* c, float* r) {
  const int lane = threadIdx.x & 31;
  const int n_clusters = gridDim.x / kCluster;
  const uint4* kv4 = reinterpret_cast<const uint4*>(keys);
  for (int row = blockIdx.x / kCluster + n_clusters * (threadIdx.x >> 5);
       row < slice / kLanes; row += n_clusters * (kClusterThreads / 32)) {
    const long long row0 = base + static_cast<long long>(row) * kLanes;
    if (row0 >= n) break;
    const uint4 q = kv4[row * 32 + lane];
    const uint4 sg = *reinterpret_cast<const uint4*>(signs + 4 * row);
    const unsigned kq[4] = {q.x, q.y, q.z, q.w}, sq[4] = {sg.x, sg.y, sg.z, sg.w};
    const long long at = row0 + 4 * lane;
    float d0[4], x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d0[e] = at + e < n ? __uint_as_float(kq[e] | (((sq[e] >> lane) & 1u) << 31)) : 0.0f;
    compress_row<BITS, true>(d0, tau, x);
    if (VEC && row0 + kLanes <= n) store_row<RES, true, true>(c, r, n, at, d0, x);
    else store_row<RES, false>(c, r, n, at, d0, x);
  }
}

// BITS 0: the threshold alone, on one cluster.  BITS 8/16/32: the grid is
// gridDim.x / kCluster independent clusters that each find the same tau
// (an exact count), then compress_slice.  VEC: d (and c, r) are 16-byte
// aligned.
template <bool VEC, int BITS, bool RES>
__global__ void __launch_bounds__(kClusterThreads, 1)
topk_cluster_kernel(const float* __restrict__ d, long long n, unsigned k, int slice,
                    float* __restrict__ tau, float* __restrict__ c,
                    float* __restrict__ r) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned me = cluster.block_rank();
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* hist = smem;                                // [kBins]
  unsigned* stage = hist + kBins;                       // [2][kCluster][kBins]
  unsigned* keys = stage + 2 * kCluster * kBins;
  // BITS != 0: signs[4 * row + e] bit l = the sign of d at key 128 * row +
  // 4 * l + e of the slice (the lanes of one warp's float4 loads)
  unsigned* signs = keys + slice;
  __shared__ __align__(8) unsigned long long staged[2]; // mbarriers, by parity
  __shared__ unsigned warp_sum[kBins / 32];
  __shared__ unsigned pick[2];                          // next prefix, rank
  const int t = threadIdx.x;

  // the mbarriers must be initialized before any CTA stores into them: one
  // cluster barrier, whose wait comes after the keys are loaded
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&staged[0])),
                 "r"(1u));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&staged[1])),
                 "r"(1u));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (t < kBins) hist[t] = 0u;
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  // PDL: d may have been written by the kernel before this one
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // the slice, loaded once: keys[j] = bits(|d[me * slice + j]|), the sign
  // bit cleared (IEEE abs); a warp's 128 keys per step are one row, so its
  // trip count is uniform and its ballots gather the row's sign bits
  const long long base = static_cast<long long>(me) * slice;
  for (int j = 4 * t; j < slice; j += 4 * kClusterThreads) {
    const long long i = base + j;
    unsigned raw[4];
    if (VEC && i + 3 < n) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(d + i));
      raw[0] = __float_as_uint(v.x); raw[1] = __float_as_uint(v.y);
      raw[2] = __float_as_uint(v.z); raw[3] = __float_as_uint(v.w);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) raw[e] = i + e < n ? __float_as_uint(d[i + e]) : kNoKey;
    }
    *reinterpret_cast<uint4*>(keys + j) =
        make_uint4(i < n ? raw[0] & 0x7FFFFFFFu : kNoKey,
                   i + 1 < n ? raw[1] & 0x7FFFFFFFu : kNoKey,
                   i + 2 < n ? raw[2] & 0x7FFFFFFFu : kNoKey,
                   i + 3 < n ? raw[3] & 0x7FFFFFFFu : kNoKey);
    if constexpr (BITS != 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned b = __ballot_sync(0xFFFFFFFFu, i + e < n && (raw[e] >> 31));
        if ((t & 31) == e) signs[4 * (j / kLanes) + e] = b;
      }
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");

  unsigned prefix = 0u, rank = k;       // rank: which largest, among matches
#pragma unroll 1
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    // the digits already fixed, and the sign bit, which only kNoKey has
    const unsigned match_mask =
        (pass ? 0xFFFFFFFFu << (shift + 8) : 0u) | 0x80000000u;
    const int buf = pass & 1;
    unsigned* stg = stage + buf * kCluster * kBins;
    const uint4* kv4 = reinterpret_cast<const uint4*>(keys);
    for (int j = t; j < slice / 4; j += kClusterThreads) {
      const uint4 q = kv4[j];
      const unsigned kv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((kv[e] & match_mask) == prefix) atomicAdd(&hist[(kv[e] >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    // send: 64 threads per destination CTA, 16 bytes each, into its
    // staging row `me`; the bytes complete its mbarrier of this parity
    if (t == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                       smem_addr(&staged[buf])), "r"(kCluster * kBins * 4u) : "memory");
    const unsigned dst = t >> 6, quad = t & 63;
    if (dst < kCluster) {
      const uint4 v = *reinterpret_cast<const uint4*>(hist + 4 * quad);
      unsigned raddr, rbar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(raddr) : "r"(smem_addr(stg + me * kBins + 4 * quad)), "r"(dst));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(rbar) : "r"(smem_addr(&staged[buf])), "r"(dst));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
          "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(raddr), "r"(v.x), "r"(v.y), "r"(v.z),
          "r"(v.w), "r"(rbar) : "memory");
    }
    // receive: this parity's mbarrier completes its ((pass >> 1) & 1)-th
    // phase when every CTA's histogram has landed here
    asm volatile(
        "{\n .reg .pred P;\n WAIT_%=:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
        " @!P bra WAIT_%=;\n}" ::"r"(smem_addr(&staged[buf])), "r"((pass >> 1) & 1)
        : "memory");
    // after the last exchange: no CTA exits before every CTA has received
    // all it was sent (this arrive, the wait before exit)
    if (pass == 3) asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
    // bin t's count over the cluster, and the suffix sum S(t) = #matches
    // with digit >= t: within each warp's 32 bins by shuffles, then across
    // the 8 warps of bins
    unsigned total = 0u, s = 0u;
    if (t < kBins) {
      for (int r = 0; r < kCluster; ++r) total += stg[r * kBins + t];
      const int lane = t & 31;
      s = total;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_down_sync(0xFFFFFFFFu, s, o);
        if (lane + o < 32) s += v;
      }
      if (lane == 0) warp_sum[t >> 5] = s;
    }
    __syncthreads();                    // every sender has read hist
    if (t < kBins) {
      hist[t] = 0u;
      for (int w = (t >> 5) + 1; w < kBins / 32; ++w) s += warp_sum[w];
      const unsigned above = s - total;   // S(t + 1)
      // the digit of the rank-th largest: S(t) >= rank > S(t + 1)
      if (s >= rank && above < rank) {
        pick[0] = prefix | (static_cast<unsigned>(t) << shift);
        pick[1] = rank - above;
      }
    }
    __syncthreads();
    prefix = pick[0];
    rank = pick[1];
  }
  if (blockIdx.x == 0 && t == 0) *tau = __uint_as_float(prefix);
  if constexpr (BITS != 0)
    compress_slice<BITS, RES, VEC>(keys, signs, slice, base, n, __uint_as_float(prefix), c, r);
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// the launch configuration of `clusters` kCluster-CTA clusters with `smem`
// bytes of dynamic shared memory per CTA, and programmatic dependent launch
// when `pdl`
struct ClusterLaunch {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = {};
  ClusterLaunch(size_t smem, cudaStream_t stream, bool pdl, int clusters = 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.gridDim = dim3(kCluster * clusters);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 2 : 1;
  }
};

// once per device and instance, under a lock: shared memory above 48 KB,
// clusters above 8 CTAs, and how many clusters at the largest slice the
// card runs at once (cudaOccupancyMaxActiveClusters; fewer than 1 refuses)
template <bool VEC, int BITS, bool RES>
cudaError_t prepare_topk_cluster(int device, int* max_clusters) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static cudaError_t state[kMaxDevices];
  static int active[kMaxDevices];
  static bool done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[device]) {
    auto kernel = topk_cluster_kernel<VEC, BITS, RES>;
    const size_t smem = cluster_smem_bytes(kClusterSliceMax, BITS != 0);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int clusters = 0;
    if (e == cudaSuccess) {
      ClusterLaunch launch(smem, nullptr, false);
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg);
      if (e == cudaSuccess && clusters < 1) e = cudaErrorLaunchOutOfResources;
    }
    state[device] = e;
    active[device] = clusters;
    done[device] = true;
  }
  *max_clusters = active[device];
  return state[device];
}

// the clusters of a compressing launch: as many as the card runs at once,
// but no more than a CTA's slice has rows
inline int compress_clusters(long long slice, int max_clusters) {
  const long long rows = slice / kLanes;
  return static_cast<int>(rows < max_clusters ? rows : max_clusters);
}

template <bool VEC, int BITS, bool RES>
int launch_topk_cluster_as(const float* d, long long n, unsigned k, int slice,
                           float* tau, float* c, float* r, cudaStream_t stream) {
  int device = 0, max_clusters = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = prepare_topk_cluster<VEC, BITS, RES>(device, &max_clusters);
  if (e != cudaSuccess) return static_cast<int>(e);
  ClusterLaunch launch(cluster_smem_bytes(slice, BITS != 0), stream, true,
                       BITS != 0 ? compress_clusters(slice, max_clusters) : 1);
  e = cudaLaunchKernelEx(&launch.cfg, topk_cluster_kernel<VEC, BITS, RES>, d, n, k, slice,
                         tau, c, r);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// bits 0: the threshold alone; 8/16/32: the top-k compressed upload into c
// (and r when it is not NULL)
int launch_topk_cluster(const float* d, long long n, long long k, int bits, float* tau,
                        float* c, float* r, cudaStream_t stream) {
  if (k < 1 || k > n || n > 0xFFFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long slice = cluster_slice(n);
  if (slice == 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned kk = static_cast<unsigned>(k);
  const int sl = static_cast<int>(slice);
  const bool vec = aligned16(d) && (bits == 0 || (aligned16(c) && aligned16(r)));
  int err = static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto VC, auto BC, auto RC) {
    err = launch_topk_cluster_as<decltype(VC)::value, decltype(BC)::value,
                                 decltype(RC)::value>(d, n, kk, sl, tau, c, r, stream);
  };
  dispatch_bool(vec, [&](auto VC) {
    if (bits == 0) {
      go(VC, std::integral_constant<int, 0>{}, std::false_type{});
      return;
    }
    dispatch_bool(r != nullptr, [&](auto RC) {
      if (bits == 8) go(VC, std::integral_constant<int, 8>{}, RC);
      else if (bits == 16) go(VC, std::integral_constant<int, 16>{}, RC);
      else if (bits == 32) go(VC, std::integral_constant<int, 32>{}, RC);
    });
  });
  return err;
}

// ---------------------------------------------------------------------------
// dp_clip_noise
// ---------------------------------------------------------------------------

template <int V, bool HAS_Z>
__global__ void __launch_bounds__(kThreads)
dp_clip_noise_kernel(float* __restrict__ out, const float* __restrict__ d,
                     const float* __restrict__ z, const float* __restrict__ scalars,
                     long long n_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // PDL: nothing is read, and out (which the allocator may have just
  // recycled) not written, before the kernel this one follows is done
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const float cs = scalars[0];
  const float ns = scalars[1];
  for (long long i = first; i < n_vec; i += stride) {
    if constexpr (V == 4) {
      const float4 dv = reinterpret_cast<const float4*>(d)[i];
      float4 u = make_float4(__fmul_rn(cs, dv.x), __fmul_rn(cs, dv.y),
                             __fmul_rn(cs, dv.z), __fmul_rn(cs, dv.w));
      if constexpr (HAS_Z) {
        const float4 zv = reinterpret_cast<const float4*>(z)[i];
        u.x = __fadd_rn(u.x, __fmul_rn(ns, zv.x));
        u.y = __fadd_rn(u.y, __fmul_rn(ns, zv.y));
        u.z = __fadd_rn(u.z, __fmul_rn(ns, zv.z));
        u.w = __fadd_rn(u.w, __fmul_rn(ns, zv.w));
      }
      reinterpret_cast<float4*>(out)[i] = u;
    } else {
      float u = __fmul_rn(cs, d[i]);
      if constexpr (HAS_Z) u = __fadd_rn(u, __fmul_rn(ns, z[i]));
      out[i] = u;
    }
  }
}

int launch_dp_clip_noise(float* out, const float* d, const float* z,
                         const float* scalars, long long n, cudaStream_t stream) {
  const bool has_z = z != nullptr;
  const bool vec = (n % 4 == 0) && aligned16(out) && aligned16(d) &&
                   (!has_z || aligned16(z));
  cudaError_t err = cudaSuccess;
  auto go = [&](auto VC, auto HZ) {
    constexpr int V = decltype(VC)::value ? 4 : 1;
    const long long n_vec = n / V;
    err = launch_pdl(dp_clip_noise_kernel<V, decltype(HZ)::value>,
                     grid_for(n_vec, kThreads), stream, out, d, z, scalars, n_vec);
  };
  dispatch_bool(vec, [&](auto VC) {
    dispatch_bool(has_z, [&](auto HZ) { go(VC, HZ); });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// V elements of T (f32 or bf16) as f32: one 16-byte load when V * sizeof(T)
// is 16, else one element
template <typename T, int V>
__device__ __forceinline__ void load_as_f32(const T* __restrict__ src, float (&dst)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) dst[0] = src[0];
    else dst[0] = __bfloat162float(src[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "vector path moves 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (std::is_same<T, float>::value) dst[j] = e[j];
      else dst[j] = __bfloat162float(e[j]);
    }
  }
}

// V f32 values, as V / 4 float4 loads or stores when V is a multiple of 4
template <int V>
__device__ __forceinline__ void load_f32v(const float* __restrict__ src, float (&dst)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int h = 0; h < V; h += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + h);
      dst[h] = v.x;
      dst[h + 1] = v.y;
      dst[h + 2] = v.z;
      dst[h + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = src[j];
  }
}

template <int V>
__device__ __forceinline__ void store_f32v(float* __restrict__ dst, const float (&src)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int h = 0; h < V; h += 4)
      *reinterpret_cast<float4*>(dst + h) =
          make_float4(src[h], src[h + 1], src[h + 2], src[h + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = src[j];
  }
}

// the rows form: row k of out = cs[k]*(f32(w[k]) - f32(p)) (+ ns*z[k]) for
// the K client end states w (K, n) in T over the start buffer p (n), with
// the rounding of the subtraction and dp_clip_noise it replaces.  Block
// row y takes the rows y, y + gridDim.y, ...; x strides over the row.
template <typename T, int V, bool HAS_Z>
__global__ void __launch_bounds__(kThreads)
dp_clip_noise_rows_kernel(float* __restrict__ out, const T* __restrict__ w,
                          const T* __restrict__ p, const float* __restrict__ z,
                          const float* __restrict__ clip_scales,
                          const float* __restrict__ noise_scale, long long n, int K,
                          long long n_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // PDL: as dp_clip_noise_kernel
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  float ns = 0.0f;
  if constexpr (HAS_Z) ns = noise_scale[0];
  for (int k = blockIdx.y; k < K; k += gridDim.y) {
    const float cs = clip_scales[k];
    const long long row = static_cast<long long>(k) * n;
    for (long long i = first; i < n_vec; i += stride) {
      const long long off = i * V;
      float wv[V], pv[V], u[V];
      load_as_f32<T, V>(w + row + off, wv);
      load_as_f32<T, V>(p + off, pv);
#pragma unroll
      for (int j = 0; j < V; ++j) u[j] = __fmul_rn(cs, __fsub_rn(wv[j], pv[j]));
      if constexpr (HAS_Z) {
        float zv[V];
        load_f32v<V>(z + row + off, zv);
#pragma unroll
        for (int j = 0; j < V; ++j) u[j] = __fadd_rn(u[j], __fmul_rn(ns, zv[j]));
      }
      store_f32v<V>(out + row + off, u);
    }
  }
}

template <typename T>
int launch_dp_clip_noise_rows(float* out, const void* w, const void* p, const float* z,
                              const float* clip_scales, const float* noise_scale,
                              long long n, int K, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool has_z = z != nullptr;
  const bool vec = (n % VW == 0) && aligned16(out) && aligned16(w) && aligned16(p) &&
                   (!has_z || aligned16(z));
  const unsigned rows = static_cast<unsigned>(K < 65535 ? K : 65535);
  cudaError_t err = cudaSuccess;
  auto go = [&](auto VC, auto HZ) {
    constexpr int V = decltype(VC)::value ? VW : 1;
    const long long n_vec = n / V;
    err = launch_pdl(dp_clip_noise_rows_kernel<T, V, decltype(HZ)::value>,
                     dim3(grid_for(n_vec, kThreads), rows), stream, out,
                     static_cast<const T*>(w), static_cast<const T*>(p), z, clip_scales,
                     noise_scale, n, K, n_vec);
  };
  dispatch_bool(vec, [&](auto VC) {
    dispatch_bool(has_z, [&](auto HZ) { go(VC, HZ); });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C interface (every buffer f32)
// ---------------------------------------------------------------------------

extern "C" {

int up_compress_delta(const void* d, const void* tau, void* c, void* r,
                      long long n, int bits, int topk, void* stream) {
  if (bits != 8 && bits != 16 && bits != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (topk && tau == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_compress_delta(static_cast<const float*>(d), static_cast<const float*>(tau),
                               static_cast<float*>(c), static_cast<float*>(r), n, bits,
                               topk != 0, static_cast<cudaStream_t>(stream));
}

int up_topk_threshold(const void* d, long long n, long long k, void* tau, void* ws,
                      void* stream) {
  return launch_topk_threshold(static_cast<const float*>(d), n, k, static_cast<float*>(tau),
                               static_cast<unsigned*>(ws), static_cast<cudaStream_t>(stream));
}

// the workspace up_topk_threshold needs, in 32-bit words
int up_topk_workspace_words() { return kWorkspaceWords; }

// the threshold up to the cut, in one launch of one 16-CTA cluster
int up_topk_cluster(const void* d, long long n, long long k, void* tau, void* stream) {
  return launch_topk_cluster(static_cast<const float*>(d), n, k, 0, static_cast<float*>(tau),
                             nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// the top-k compressed upload up to the cut, in the same one launch: tau,
// then c (and r = d - c when r is not NULL) at bits 8, 16 or 32
int up_topk_compress(const void* d, long long n, long long k, int bits, void* tau, void* c,
                     void* r, void* stream) {
  if ((bits != 8 && bits != 16 && bits != 32) || c == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_topk_cluster(static_cast<const float*>(d), n, k, bits, static_cast<float*>(tau),
                             static_cast<float*>(c), static_cast<float*>(r),
                             static_cast<cudaStream_t>(stream));
}

// the dynamic shared memory per CTA of up_topk_cluster on n elements, in
// bytes; 0 above the cut
int up_topk_cluster_smem_bytes(long long n) {
  const long long slice = cluster_slice(n);
  return slice ? static_cast<int>(cluster_smem_bytes(slice)) : 0;
}

// the same for up_topk_compress (the keys and d's sign bits)
int up_topk_compress_smem_bytes(long long n) {
  const long long slice = cluster_slice(n);
  return slice ? static_cast<int>(cluster_smem_bytes(slice, true)) : 0;
}

// the clusters of one up_topk_compress launch on n elements on the current
// device (each of kCluster CTAs); 0 above the cut, below 0 a CUDA error
int up_topk_compress_clusters(long long n) {
  const long long slice = cluster_slice(n);
  if (slice == 0) return 0;
  int device = 0, max_clusters = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = prepare_topk_cluster<true, 8, true>(device, &max_clusters);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return compress_clusters(slice, max_clusters);
}

int up_dp_clip_noise(void* out, const void* d, const void* z, const void* scalars,
                     long long n, void* stream) {
  return launch_dp_clip_noise(static_cast<float*>(out), static_cast<const float*>(d),
                              static_cast<const float*>(z),
                              static_cast<const float*>(scalars), n,
                              static_cast<cudaStream_t>(stream));
}

// the rows form: out (K, n) f32 from w (K, n) and p (n) in dtype 0 = f32 or
// 1 = bf16, z (K, n) f32 or NULL, clip_scales (K,) and noise_scale (1,) f32
int up_dp_clip_noise_rows(void* out, const void* w, const void* p, const void* z,
                          const void* clip_scales, const void* noise_scale, long long n,
                          int K, int dtype, void* stream) {
  if (K < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto o = static_cast<float*>(out);
  auto zf = static_cast<const float*>(z);
  auto cs = static_cast<const float*>(clip_scales);
  auto ns = static_cast<const float*>(noise_scale);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dp_clip_noise_rows<float>(o, w, p, zf, cs, ns, n, K, s);
  if (dtype == 1)
    return launch_dp_clip_noise_rows<__nv_bfloat16>(o, w, p, zf, cs, ns, n, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
