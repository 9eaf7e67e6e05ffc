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
//   up_dp_clip_noise    <- src/repro/kernels/fused_update.py:_dp_clip_noise_kernel
//                          (wrapper dp_clip_noise)
//       u = clip_scale*d (+ noise_scale*z)
//
// What bounds them on an H100: all three stream their operands once and do a
// few operations per element, so device-memory bytes bound them:
// compress_delta reads 4 B and writes 8 B per element (c and r; 4 B without
// the residual), topk_threshold reads 4 B per element once (this design reads
// it into shared memory once up to the cut and four times above it, one
// pass per byte of the key; at the main path's 137,216 elements the launch
// and four rounds of exchange between the CTAs of its cluster, not the
// 0.16 us of bytes, bound it),
// dp_clip_noise reads 8 B
// (d and z) and writes 4 B.  At LeNet-5 size (137,216 padded elements) each
// is far below a microsecond of bytes and the launch dominates.
//
// What the design does:
//  * compress_delta: one warp per 128-lane row (the JAX kernel's block rows
//    start at element 0 of the buffer, and so do these), 4 lanes per thread
//    as one float4 when the length is a multiple of 128 and the pointers are
//    16-byte aligned, otherwise bounds-checked scalar loads with zeros past
//    the end (the JAX wrapper's zero padding).  The row's |max| is a
//    __shfl_xor_sync butterfly: a max is exact in any order.  tau arrives as
//    a device pointer and is never read on the host.
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
//    - above it, topk_pass_kernel: four launches, one per digit, each over
//      the whole of |d| in a grid-stride pass (per-block shared histogram,
//      warp-aggregated, merged with global atomics); the last block to
//      finish (a __threadfence plus an atomic ticket) runs the scan and
//      leaves the prefix and rank for the next launch in a workspace that
//      is zeroed by one memset per call.
//  * dp_clip_noise: a grid-stride elementwise pass, float4 loads and stores.
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

// ---------------------------------------------------------------------------
// compress_delta
// ---------------------------------------------------------------------------

template <int BITS, bool TOPK, bool RES, bool VEC>
__global__ void __launch_bounds__(kThreads)
compress_delta_kernel(const float* __restrict__ d, const float* __restrict__ tau_p,
                      float* __restrict__ c, float* __restrict__ r, long long n,
                      long long rows) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  float tau = 0.0f;
  if constexpr (TOPK) tau = *tau_p;
  // the row loop is uniform across a warp, so every lane reaches the shuffles
  for (long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                       (threadIdx.x >> 5);
       row < rows; row += stride) {
    const long long base = row * kLanes + lane * 4;
    float d0[4];
    if constexpr (VEC) {
      const float4 v = *reinterpret_cast<const float4*>(d + base);
      d0[0] = v.x; d0[1] = v.y; d0[2] = v.z; d0[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) d0[j] = base + j < n ? d[base + j] : 0.0f;
    }
    float x[4];
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
          float q = rintf(__fdiv_rn(x[j], scale));
          q = fminf(fmaxf(q, -qmax), qmax);
          x[j] = __fmul_rn(q, scale);
        } else {
          x[j] = 0.0f;
        }
      }
    }
    float res[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) res[j] = __fsub_rn(d0[j], x[j]);
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(c + base) = make_float4(x[0], x[1], x[2], x[3]);
      if constexpr (RES)
        *reinterpret_cast<float4*>(r + base) =
            make_float4(res[0], res[1], res[2], res[3]);
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
}

int launch_compress_delta(const float* d, const float* tau, float* c, float* r,
                          long long n, int bits, bool topk, cudaStream_t stream) {
  const bool res = r != nullptr;
  const bool vec = (n % kLanes == 0) && aligned16(d) && aligned16(c) &&
                   (!res || aligned16(r));
  const long long rows = (n + kLanes - 1) / kLanes;
  const int grid = grid_for(rows, kRowsPerBlock);
  auto go = [&](auto BITS_C, auto TK, auto RS, auto VC) {
    compress_delta_kernel<decltype(BITS_C)::value, decltype(TK)::value,
                          decltype(RS)::value, decltype(VC)::value>
        <<<grid, kThreads, 0, stream>>>(d, tau, c, r, n, rows);
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
// every CTA's histogram by pass parity, the keys
inline size_t cluster_smem_bytes(long long slice) {
  return sizeof(unsigned) * (kBins + 2 * kCluster * kBins + static_cast<size_t>(slice));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <bool VEC>
__global__ void __launch_bounds__(kClusterThreads, 1)
topk_cluster_kernel(const float* __restrict__ d, long long n, unsigned k, int slice,
                    float* __restrict__ tau) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned me = cluster.block_rank();
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* hist = smem;                                // [kBins]
  unsigned* stage = hist + kBins;                       // [2][kCluster][kBins]
  unsigned* keys = stage + 2 * kCluster * kBins;
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

  // the slice, loaded once: keys[j] = bits(|d[me * slice + j]|)
  const long long base = static_cast<long long>(me) * slice;
  for (int j = 4 * t; j < slice; j += 4 * kClusterThreads) {
    const long long i = base + j;
    uint4 kv;
    if (VEC && i + 3 < n) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(d + i));
      kv = make_uint4(__float_as_uint(fabsf(v.x)), __float_as_uint(fabsf(v.y)),
                      __float_as_uint(fabsf(v.z)), __float_as_uint(fabsf(v.w)));
    } else {
      kv.x = i < n ? __float_as_uint(fabsf(d[i])) : kNoKey;
      kv.y = i + 1 < n ? __float_as_uint(fabsf(d[i + 1])) : kNoKey;
      kv.z = i + 2 < n ? __float_as_uint(fabsf(d[i + 2])) : kNoKey;
      kv.w = i + 3 < n ? __float_as_uint(fabsf(d[i + 3])) : kNoKey;
    }
    *reinterpret_cast<uint4*>(keys + j) = kv;
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
  if (me == 0 && t == 0) *tau = __uint_as_float(prefix);
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// the launch configuration of a kCluster-CTA cluster with `smem` bytes of
// dynamic shared memory per CTA, and programmatic dependent launch when `pdl`
struct ClusterLaunch {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = {};
  ClusterLaunch(size_t smem, cudaStream_t stream, bool pdl) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 2 : 1;
  }
};

// once per device and instance, under a lock: shared memory above 48 KB,
// clusters above 8 CTAs, and the guard that one cluster at the largest
// slice fits the card (cudaOccupancyMaxActiveClusters >= 1)
template <bool VEC>
cudaError_t prepare_topk_cluster(int device) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static cudaError_t state[kMaxDevices];
  static bool done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (done[device]) return state[device];
  auto kernel = topk_cluster_kernel<VEC>;
  const size_t smem = cluster_smem_bytes(kClusterSliceMax);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) {
    ClusterLaunch launch(smem, nullptr, false);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg);
    if (e == cudaSuccess && clusters < 1) e = cudaErrorLaunchOutOfResources;
  }
  state[device] = e;
  done[device] = true;
  return e;
}

template <bool VEC>
int launch_topk_cluster_as(const float* d, long long n, unsigned k, int slice,
                           float* tau, cudaStream_t stream) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = prepare_topk_cluster<VEC>(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  ClusterLaunch launch(cluster_smem_bytes(slice), stream, true);
  e = cudaLaunchKernelEx(&launch.cfg, topk_cluster_kernel<VEC>, d, n, k, slice, tau);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int launch_topk_cluster(const float* d, long long n, long long k, float* tau,
                        cudaStream_t stream) {
  if (k < 1 || k > n || n > 0xFFFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long slice = cluster_slice(n);
  if (slice == 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned kk = static_cast<unsigned>(k);
  const int sl = static_cast<int>(slice);
  return aligned16(d) ? launch_topk_cluster_as<true>(d, n, kk, sl, tau, stream)
                      : launch_topk_cluster_as<false>(d, n, kk, sl, tau, stream);
}

// ---------------------------------------------------------------------------
// dp_clip_noise
// ---------------------------------------------------------------------------

template <int V, bool HAS_Z>
__global__ void __launch_bounds__(kThreads)
dp_clip_noise_kernel(float* __restrict__ out, const float* __restrict__ d,
                     const float* __restrict__ z, const float* __restrict__ scalars,
                     long long n_vec) {
  const float cs = scalars[0];
  const float ns = scalars[1];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
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
  auto go = [&](auto VC, auto HZ) {
    constexpr int V = decltype(VC)::value ? 4 : 1;
    const long long n_vec = n / V;
    dp_clip_noise_kernel<V, decltype(HZ)::value>
        <<<grid_for(n_vec, kThreads), kThreads, 0, stream>>>(out, d, z, scalars, n_vec);
  };
  dispatch_bool(vec, [&](auto VC) {
    dispatch_bool(has_z, [&](auto HZ) { go(VC, HZ); });
  });
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
  return launch_topk_cluster(static_cast<const float*>(d), n, k, static_cast<float*>(tau),
                             static_cast<cudaStream_t>(stream));
}

// the dynamic shared memory per CTA of up_topk_cluster on n elements, in
// bytes; 0 above the cut
int up_topk_cluster_smem_bytes(long long n) {
  const long long slice = cluster_slice(n);
  return slice ? static_cast<int>(cluster_smem_bytes(slice)) : 0;
}

int up_dp_clip_noise(void* out, const void* d, const void* z, const void* scalars,
                     long long n, void* stream) {
  return launch_dp_clip_noise(static_cast<float*>(out), static_cast<const float*>(d),
                              static_cast<const float*>(z),
                              static_cast<const float*>(scalars), n,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
