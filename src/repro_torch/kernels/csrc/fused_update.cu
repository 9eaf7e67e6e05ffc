// Fused FL-update kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Each kernel replaces one Pallas kernel of src/repro/kernels/fused_update.py:
//
//   fu_local_step      <- fused_update.py:_local_step_kernel (wrapper local_step)
//       g <- g*clip_scale (+c) (+wd*p);  m <- g + beta*m;  p <- p - step*(m or g)
//   fu_weighted_delta  <- fused_update.py:_weighted_delta_kernel (weighted_delta)
//       out <- cast(p32 + e + sum_k w[k]*(s[k] - p32))   (deltas: drop the -p)
//   fu_server_update   <- fused_update.py:_server_update_kernel (server_update)
//       none: p + d;  momentum: m <- beta*m - d, p <- p - lr*m;
//       adam: mu, nu moments, p <- p - lr*(mu/bc1)/(sqrt(nu/bc2)+eps)
//
// What bounds them on an H100: all three are elementwise passes that do a
// handful of flops per element, so they are bound by device-memory bytes:
// local_step moves 12 B/element (f32, no momentum; 20 with momentum),
// weighted_delta (4K + 8) B/element, server_update 20 B/element under
// momentum (reads p, d, m; writes p, m) and 28 B/element under adam
// (reads p, d, mu, nu; writes p, mu, nu), all in f32.  At LeNet-5 size (137,216 padded elements) every one of them
// is far below a microsecond of bytes, so on the main path the launch
// itself dominates; batching launches is later work.
//
// What the design does about the bytes: one grid-stride pass per call,
// every operand read once and every output written once, 16-byte vector
// loads and stores (float4, or 8 x bf16) when every pointer is 16-byte
// aligned and the length is a multiple of the vector width (the carried
// buffers are padded to GRID_ALIGN = 1024 elements, so the main path
// always takes it), otherwise one element per thread.  Compute is f32;
// results are cast on store with round-to-nearest-even.  The traced
// scalars (clip scale, step size, lr, bias corrections, client weights)
// are read from a small f32 device buffer, the counterpart of Pallas's
// SMEM scalar prefetch, so no scalar ever crosses to the host.
//
// Rounding: every arithmetic step uses the _rn intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which the compiler never
// contracts into an FMA, so each step rounds exactly where the plain
// PyTorch version in repro_torch/kernels/fused_update.py rounds and the
// two agree bit for bit on the card.
//
// Updates are in place for the carried state (p and momentum in
// local_step, p and moments in server_update); weighted_delta writes a
// separate output.  Pad lanes stay zero through all three: every term is
// zero or a multiple of a zero operand there.
//
// Each fu_* launcher enqueues on the given stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 blocks per SM, grid-stride

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V elements of T starting at src (V * sizeof(T) == 16 for the vector path).
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ src, float (&dst)[V]) {
  if constexpr (V == 1) {
    dst[0] = to_f32(src[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "vector path moves 16 bytes");
    uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = to_f32(e[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ dst, const float (&src)[V]) {
  if constexpr (V == 1) {
    dst[0] = from_f32<T>(src[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f32<T>(src[j]);
    *reinterpret_cast<uint4*>(dst) = raw;
  }
}

// V f32 values (the f32 operands of a bf16 pass span two float4 loads).
template <int V>
__device__ __forceinline__ void load_f32(const float* __restrict__ src, float (&dst)[V]) {
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

__host__ __device__ inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

inline int grid_for(long long n_items) {
  long long blocks = (n_items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename F>
void dispatch_bool(bool b, F&& f) {
  if (b) f(std::true_type{});
  else f(std::false_type{});
}

// ---------------------------------------------------------------------------
// local_step
// ---------------------------------------------------------------------------

template <typename T, int V, bool HAS_M, bool HAS_C, bool HAS_WD>
__global__ void __launch_bounds__(kThreads)
local_step_kernel(T* __restrict__ p, const T* __restrict__ g, T* __restrict__ m,
                  const T* __restrict__ c, const float* __restrict__ scalars,
                  float wd, float beta, long long n_vec) {
  const float clip_scale = scalars[0];
  const float step_size = scalars[1];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const long long off = i * V;
    float pv[V], gv[V], mv[V], cv[V];
    load<T, V>(p + off, pv);
    load<T, V>(g + off, gv);
    if constexpr (HAS_M) load<T, V>(m + off, mv);
    if constexpr (HAS_C) load<T, V>(c + off, cv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float gg = __fmul_rn(gv[j], clip_scale);
      if constexpr (HAS_C) gg = __fadd_rn(gg, cv[j]);
      if constexpr (HAS_WD) gg = __fadd_rn(gg, __fmul_rn(wd, pv[j]));
      float eff = gg;
      if constexpr (HAS_M) {
        mv[j] = __fadd_rn(gg, __fmul_rn(beta, mv[j]));
        eff = mv[j];
      }
      pv[j] = __fsub_rn(pv[j], __fmul_rn(step_size, eff));
    }
    if constexpr (HAS_M) store<T, V>(m + off, mv);
    store<T, V>(p + off, pv);
  }
}

template <typename T>
int launch_local_step(void* p, const void* g, void* m, const void* c,
                      const float* scalars, long long n, bool has_m, bool has_c,
                      float wd, float beta, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool vec = (n % VW == 0) && aligned16(p) && aligned16(g) &&
                   (!has_m || aligned16(m)) && (!has_c || aligned16(c));
  auto go = [&](auto VEC, auto HM, auto HC, auto HW) {
    constexpr int V = decltype(VEC)::value ? VW : 1;
    const long long n_vec = n / V;
    local_step_kernel<T, V, decltype(HM)::value, decltype(HC)::value, decltype(HW)::value>
        <<<grid_for(n_vec), kThreads, 0, stream>>>(
            static_cast<T*>(p), static_cast<const T*>(g), static_cast<T*>(m),
            static_cast<const T*>(c), scalars, wd, beta, n_vec);
  };
  dispatch_bool(vec, [&](auto VEC) {
    dispatch_bool(has_m, [&](auto HM) {
      dispatch_bool(has_c, [&](auto HC) {
        dispatch_bool(wd != 0.0f, [&](auto HW) { go(VEC, HM, HC, HW); });
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// weighted_delta (runtime K, ascending k, per-element register accumulator)
// ---------------------------------------------------------------------------

template <typename T, int V, bool HAS_EXTRA, bool DELTAS>
__global__ void __launch_bounds__(kThreads)
weighted_delta_kernel(T* __restrict__ out, const T* __restrict__ stacked,
                      const T* __restrict__ p, const float* __restrict__ w,
                      const float* __restrict__ extra, long long n, int K,
                      long long n_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const long long off = i * V;
    float pv[V], acc[V], sv[V];
    load<T, V>(p + off, pv);
    if constexpr (HAS_EXTRA) {
      load_f32<V>(extra + off, acc);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    }
    for (int k = 0; k < K; ++k) {
      const float wk = w[k];
      load<T, V>(stacked + static_cast<long long>(k) * n + off, sv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float term = DELTAS ? sv[j] : __fsub_rn(sv[j], pv[j]);
        acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, term));
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(pv[j], acc[j]);
    store<T, V>(out + off, acc);
  }
}

template <typename T>
int launch_weighted_delta(void* out, const void* stacked, const void* p,
                          const float* w, const float* extra, long long n, int K,
                          bool deltas, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool has_extra = extra != nullptr;
  const bool vec = (n % VW == 0) && aligned16(out) && aligned16(stacked) &&
                   aligned16(p) && (!has_extra || aligned16(extra));
  auto go = [&](auto VEC, auto HE, auto DL) {
    constexpr int V = decltype(VEC)::value ? VW : 1;
    const long long n_vec = n / V;
    weighted_delta_kernel<T, V, decltype(HE)::value, decltype(DL)::value>
        <<<grid_for(n_vec), kThreads, 0, stream>>>(
            static_cast<T*>(out), static_cast<const T*>(stacked),
            static_cast<const T*>(p), w, extra, n, K, n_vec);
  };
  dispatch_bool(vec, [&](auto VEC) {
    dispatch_bool(has_extra, [&](auto HE) {
      dispatch_bool(deltas, [&](auto DL) { go(VEC, HE, DL); });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// server_update: opt 0 = none, 1 = momentum, 2 = adam
// ---------------------------------------------------------------------------

struct ServerConsts {
  float beta, b1, b2, one_minus_b1, one_minus_b2, eps;
};

template <typename T, int V, int OPT>
__global__ void __launch_bounds__(kThreads)
server_update_kernel(T* __restrict__ p, const float* __restrict__ d,
                     T* __restrict__ m1, T* __restrict__ m2,
                     const float* __restrict__ scalars, ServerConsts k,
                     long long n_vec) {
  const float lr = scalars[0];
  float bc1 = 1.0f, bc2 = 1.0f;
  if constexpr (OPT == 2) {
    bc1 = scalars[1];
    bc2 = scalars[2];
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const long long off = i * V;
    float pv[V], dv[V], av[V], bv[V];
    load<T, V>(p + off, pv);
    load_f32<V>(d + off, dv);
    if constexpr (OPT >= 1) load<T, V>(m1 + off, av);
    if constexpr (OPT == 2) load<T, V>(m2 + off, bv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (OPT == 0) {
        pv[j] = __fadd_rn(pv[j], dv[j]);
      } else if constexpr (OPT == 1) {
        const float g = -dv[j];                       // pseudo-gradient
        av[j] = __fadd_rn(__fmul_rn(k.beta, av[j]), g);
        pv[j] = __fsub_rn(pv[j], __fmul_rn(lr, av[j]));
      } else {
        const float g = -dv[j];
        av[j] = __fadd_rn(__fmul_rn(k.b1, av[j]), __fmul_rn(k.one_minus_b1, g));
        bv[j] = __fadd_rn(__fmul_rn(k.b2, bv[j]),
                          __fmul_rn(__fmul_rn(k.one_minus_b2, g), g));
        const float u = __fdiv_rn(__fdiv_rn(av[j], bc1),
                                  __fadd_rn(__fsqrt_rn(__fdiv_rn(bv[j], bc2)), k.eps));
        pv[j] = __fsub_rn(pv[j], __fmul_rn(lr, u));
      }
    }
    if constexpr (OPT >= 1) store<T, V>(m1 + off, av);
    if constexpr (OPT == 2) store<T, V>(m2 + off, bv);
    store<T, V>(p + off, pv);
  }
}

template <typename T>
int launch_server_update(void* p, const float* d, void* m1, void* m2,
                         const float* scalars, long long n, int opt,
                         ServerConsts k, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool vec = (n % VW == 0) && aligned16(p) && aligned16(d) &&
                   (opt < 1 || aligned16(m1)) && (opt < 2 || aligned16(m2));
  auto go = [&](auto VEC, auto OPTC) {
    constexpr int V = decltype(VEC)::value ? VW : 1;
    const long long n_vec = n / V;
    server_update_kernel<T, V, decltype(OPTC)::value>
        <<<grid_for(n_vec), kThreads, 0, stream>>>(
            static_cast<T*>(p), d, static_cast<T*>(m1), static_cast<T*>(m2),
            scalars, k, n_vec);
  };
  dispatch_bool(vec, [&](auto VEC) {
    if (opt == 0) go(VEC, std::integral_constant<int, 0>{});
    else if (opt == 1) go(VEC, std::integral_constant<int, 1>{});
    else go(VEC, std::integral_constant<int, 2>{});
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C interface (dtype 0 = float32, 1 = bfloat16)
// ---------------------------------------------------------------------------

extern "C" {

int fu_local_step(void* p, const void* g, void* m, const void* c,
                  const void* scalars, long long n, int dtype, int has_m,
                  int has_c, float wd, float beta, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scalars);
  if (dtype == 0)
    return launch_local_step<float>(p, g, m, c, sc, n, has_m, has_c, wd, beta, s);
  if (dtype == 1)
    return launch_local_step<__nv_bfloat16>(p, g, m, c, sc, n, has_m, has_c, wd, beta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int fu_weighted_delta(void* out, const void* stacked, const void* p,
                      const void* w, const void* extra, long long n, int K,
                      int dtype, int deltas, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto ef = static_cast<const float*>(extra);
  if (dtype == 0)
    return launch_weighted_delta<float>(out, stacked, p, wf, ef, n, K, deltas, s);
  if (dtype == 1)
    return launch_weighted_delta<__nv_bfloat16>(out, stacked, p, wf, ef, n, K, deltas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int fu_server_update(void* p, const void* d, void* m1, void* m2,
                     const void* scalars, long long n, int dtype, int opt,
                     float beta, float b1, float b2, float one_minus_b1,
                     float one_minus_b2, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto df = static_cast<const float*>(d);
  auto sc = static_cast<const float*>(scalars);
  ServerConsts k{beta, b1, b2, one_minus_b1, one_minus_b2, eps};
  if (opt < 0 || opt > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_server_update<float>(p, df, m1, m2, sc, n, opt, k, s);
  if (dtype == 1)
    return launch_server_update<__nv_bfloat16>(p, df, m1, m2, sc, n, opt, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
