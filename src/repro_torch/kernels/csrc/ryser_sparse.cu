// SpaRyser (padded-CCS sparse) Gray-code Ryser block partials for Hopper
// (sm_90a), real and split-plane complex, f64 and f32 (f32 and complex64
// values, whose dtype the reference keeps through kernel, partials and
// epilogue: the _f32 entries).
//
// Replaces the four TPU kernels of kernels/ryser_sparse.py:
//   * ryser_sparse_pallas_call (_ryser_sp_kernel -> _ryser_block_sp, grid over
//     blocks, u64 chunk base) and ryser_sparse_pallas_call_batched
//     (_ryser_sp_kernel_batched, grid over (batch, block), chunk base 0):
//     ryser_kernel<NPAD, P, true, T>, entries ryser_sparse_scalar /
//     ryser_sparse_batched (and _f32);
//   * ryser_sparse_pallas_call_complex (_ryser_sp_kernel_cx ->
//     _ryser_block_sp_cx) and ryser_sparse_pallas_call_complex_batched:
//     ryser_cx_kernel<NPAD, P, true, T>, entries ryser_sparse_complex_scalar
//     / ryser_sparse_complex_batched (and _f32).
// A scalar entry launches grid (num_blocks, 1) from a uint64_t chunk base, a
// batched entry grid (num_blocks, B) from 0; both run one body, so a scalar
// leaf equals its bucket entry bit for bit.
//
// The bodies are ryser_kernels.cuh's, shared with the dense kernels: what
// the TPU sparse body computes is the dense batched mode with the window
// states taken from the kw = log2(Wu) low CCS columns, densified once per CTA
// into shared U[NPAD][kw] (one thread per column, entries in order, no
// atomics; entries at row n == NPAD skipped), while dense A stays in shared
// memory for the chunk init and the boundary column.  rows/vals have leading
// dimension n (not NPAD); maxdeg is a runtime argument (in a bucket the
// bucket-wide maximum, whose extra padding is inert).  X[NPAD] lives in
// registers, indexed only by a compile-time i: the paper's Alg. 2 scatter by
// a runtime row would push X into local memory, so the column updates are
// folded into D as on the TPU.
//
// Numerics mirror _ryser_block_sp(_cx) step for step and the plain PyTorch
// versions kernels/ryser_sparse_cuda.py::block_partials_plain_sparse(_complex)
// op for op.  U equals A[:, :kw] exactly, so these kernels also equal the
// dense batched mode (ryser_dense.cu, ryser_complex.cu) bit for bit.
//
// Bound: FP64 instruction throughput over the work SpaRyser needs, which the
// data sets: per Gray step deg(j) adds for the changed column j and n - 1
// multiplies for the product (complex: 2 deg(j) + 6 (n - 1)).  The dense
// body adds a window state to all n rows a step, whatever the density.  The
// real sparse body adds it only to the rows below RPAD: the rows its low
// columns touch, rounded up to 8 (ryser_kernels.cuh).  The host glue
// (kernels/ops.py::order_sparse_leaves) permutes each real leaf so that its
// kw low columns touch few rows and those rows come first: about 8-10 of
// 24-32 on a banded matrix of degree 5-7, so a step does RPAD adds and
// n - 1 multiplies, still at least the bound's count.  The complex body
// keeps the dense step.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "ryser_kernels.cuh"

namespace {

template <typename T, int NPAD>
size_t smem_real(int TB, int Wu_log2) {
  const size_t Wu = (size_t)1 << Wu_log2;
  return sizeof(T) *
      ((size_t)NPAD * NPAD + (size_t)NPAD * Wu_log2 + (size_t)NPAD * (Wu - 1) +
       2 * (size_t)TB) + sizeof(int) * (size_t)Wu_log2;
}

template <typename T, int NPAD>
size_t smem_cx(int TB, int Wu_log2) {
  const size_t Wu = (size_t)1 << Wu_log2;
  return sizeof(T) *
      (2 * (size_t)NPAD * NPAD + 2 * (size_t)NPAD * Wu_log2 +
       2 * (size_t)NPAD * (Wu - 1) + 4 * (size_t)TB);
}

template <typename T, int NPAD, int P>
int launch_real(const T* A, const int* rows, const T* vals, const T* xb,
                const T* c0, T* out, uint64_t base, int n, int maxdeg, int TB,
                int C_log2, int Wu_log2, int num_blocks, int B,
                cudaStream_t stream) {
  return launch_kernel(ryser_kernel<NPAD, P, true, T>,
                       smem_real<T, NPAD>(TB, Wu_log2), num_blocks, B, TB,
                       stream, A, rows, vals, xb, c0, out, base, n, maxdeg,
                       C_log2, Wu_log2, num_blocks, (int)M_BATCHED);
}

template <typename T, int NPAD, int P>
int launch_cx(const T* Ar, const T* Ai, const int* rows, const T* vr,
              const T* vi, const T* xbr, const T* xbi, const T* c0, T* out,
              uint64_t base, int n, int maxdeg, int TB, int C_log2,
              int Wu_log2, int num_blocks, int B, cudaStream_t stream) {
  return launch_kernel(ryser_cx_kernel<NPAD, P, true, T>,
                       smem_cx<T, NPAD>(TB, Wu_log2), num_blocks, B, TB,
                       stream, Ar, Ai, rows, vr, vi, xbr, xbi, c0, out, base,
                       n, maxdeg, C_log2, Wu_log2, num_blocks);
}

// CTAs of TB threads of the f64 real instantiation one SM holds at once
// (registers and shared memory).
template <int NPAD, int P>
int occupancy(int TB, int Wu_log2, int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, ryser_kernel<NPAD, P, true, double>, TB,
      smem_real<double, NPAD>(TB, Wu_log2));
}

}  // namespace

// One launcher pair per NPAD and scalar type, compiled as in ryser_dense.cu:
// one nvcc process per -DRYSER_NPAD=k (with -DRYSER_F32 also, f32) and one
// more for the C entry points (-DRYSER_API_ONLY).
#if defined(RYSER_NPAD) == defined(RYSER_API_ONLY)
#error "define exactly one of RYSER_NPAD=k and RYSER_API_ONLY"
#endif

#define RYSER_SP_LAUNCHER_SIG(K, T, TAG)                                       \
  extern "C" int ryser_sp_launch_##TAG##npad_##K(                              \
      const T* A, const int* rows, const T* vals, const T* xb, const T* c0,   \
      T* out, uint64_t base, int n, int maxdeg, int TB, int C_log2,           \
      int Wu_log2, int num_blocks, int B, int precision, cudaStream_t stream)

#define RYSER_SPX_LAUNCHER_SIG(K, T, TAG)                                      \
  extern "C" int ryser_spx_launch_##TAG##npad_##K(                             \
      const T* Ar, const T* Ai, const int* rows, const T* vr, const T* vi,    \
      const T* xbr, const T* xbi, const T* c0, T* out, uint64_t base, int n,  \
      int maxdeg, int TB, int C_log2, int Wu_log2, int num_blocks, int B,     \
      int precision, cudaStream_t stream)

#define RYSER_SP_OCCUPANCY_SIG(K)                                              \
  extern "C" int ryser_sp_occupancy_npad_##K(int precision, int TB,           \
                                             int Wu_log2, int* ctas)

#define RYSER_SP_CASE_P(K, T, PV)                                              \
  case PV:                                                                     \
    return launch_real<T, K, PV>(A, rows, vals, xb, c0, out, base, n, maxdeg,  \
                                 TB, C_log2, Wu_log2, num_blocks, B, stream);

#define RYSER_SPX_CASE_P(K, T, PV)                                             \
  case PV:                                                                     \
    return launch_cx<T, K, PV>(Ar, Ai, rows, vr, vi, xbr, xbi, c0, out, base,  \
                               n, maxdeg, TB, C_log2, Wu_log2, num_blocks, B,  \
                               stream);

#define RYSER_SP_DEFINE_LAUNCHERS(K, T, TAG)                                   \
  RYSER_SP_LAUNCHER_SIG(K, T, TAG) {                                           \
    switch (precision) {                                                       \
      RYSER_SP_CASE_P(K, T, P_DD)                                              \
      RYSER_SP_CASE_P(K, T, P_KAHAN)                                           \
      RYSER_SP_CASE_P(K, T, P_DQ_ACC)                                          \
      RYSER_SP_CASE_P(K, T, P_DQ_FAST)                                         \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }                                                                            \
  RYSER_SPX_LAUNCHER_SIG(K, T, TAG) {                                          \
    switch (precision) {                                                       \
      RYSER_SPX_CASE_P(K, T, P_DD)                                             \
      RYSER_SPX_CASE_P(K, T, P_KAHAN)                                          \
      RYSER_SPX_CASE_P(K, T, P_DQ_ACC)                                         \
      RYSER_SPX_CASE_P(K, T, P_DQ_FAST)                                        \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }

#define RYSER_SP_DEFINE_OCCUPANCY(K)                                           \
  RYSER_SP_OCCUPANCY_SIG(K) {                                                  \
    switch (precision) {                                                       \
      case P_DD: return occupancy<K, P_DD>(TB, Wu_log2, ctas);                 \
      case P_KAHAN: return occupancy<K, P_KAHAN>(TB, Wu_log2, ctas);           \
      case P_DQ_ACC: return occupancy<K, P_DQ_ACC>(TB, Wu_log2, ctas);         \
      case P_DQ_FAST: return occupancy<K, P_DQ_FAST>(TB, Wu_log2, ctas);       \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }

#define RYSER_SP_EXPAND(M, ...) M(__VA_ARGS__)

#if defined(RYSER_NPAD)
#if defined(RYSER_F32)
RYSER_SP_EXPAND(RYSER_SP_DEFINE_LAUNCHERS, RYSER_NPAD, float, f32_)
#else
RYSER_SP_EXPAND(RYSER_SP_DEFINE_LAUNCHERS, RYSER_NPAD, double, )
RYSER_SP_EXPAND(RYSER_SP_DEFINE_OCCUPANCY, RYSER_NPAD)
#endif
#else
#define RYSER_SP_DECLARE(K)                \
  RYSER_SP_LAUNCHER_SIG(K, double, );      \
  RYSER_SPX_LAUNCHER_SIG(K, double, );     \
  RYSER_SP_LAUNCHER_SIG(K, float, f32_);   \
  RYSER_SPX_LAUNCHER_SIG(K, float, f32_);  \
  RYSER_SP_OCCUPANCY_SIG(K);
RYSER_SP_DECLARE(8)
RYSER_SP_DECLARE(16)
RYSER_SP_DECLARE(24)
RYSER_SP_DECLARE(32)
RYSER_SP_DECLARE(40)
RYSER_SP_DECLARE(48)
RYSER_SP_DECLARE(56)
RYSER_SP_DECLARE(64)

namespace {

bool bad_geometry(uint64_t base, int n, int n_pad, int maxdeg, int TB,
                  int C_log2, int Wu_log2, int num_blocks, int B) {
  return n < 3 || n > 64 || n > n_pad || maxdeg < 1 || TB < 1 ||
         TB > kMaxThreads || (TB & (TB - 1)) != 0 || Wu_log2 < 1 ||
         Wu_log2 >= n || C_log2 < Wu_log2 || num_blocks < 1 || B < 1 ||
         B > 65535 || !chunks_in_space(base, n, TB, C_log2, num_blocks);
}

template <typename T>
int dispatch(const T* A, const int* rows, const T* vals, const T* xb,
             const T* c0, T* out, uint64_t base, int n, int n_pad, int maxdeg,
             int TB, int C_log2, int Wu_log2, int num_blocks, int B,
             int precision, void* stream) {
  if (bad_geometry(base, n, n_pad, maxdeg, TB, C_log2, Wu_log2, num_blocks,
                   B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool F32 = std::is_same_v<T, float>;
#define RYSER_SP_CASE(K)                                                       \
  case K:                                                                      \
    if constexpr (F32)                                                         \
      return ryser_sp_launch_f32_npad_##K(A, rows, vals, xb, c0, out, base, n, \
                                          maxdeg, TB, C_log2, Wu_log2,         \
                                          num_blocks, B, precision, s);        \
    else                                                                       \
      return ryser_sp_launch_npad_##K(A, rows, vals, xb, c0, out, base, n,     \
                                      maxdeg, TB, C_log2, Wu_log2, num_blocks, \
                                      B, precision, s);
  switch (n_pad) {
    RYSER_SP_CASE(8) RYSER_SP_CASE(16) RYSER_SP_CASE(24) RYSER_SP_CASE(32)
    RYSER_SP_CASE(40) RYSER_SP_CASE(48) RYSER_SP_CASE(56) RYSER_SP_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RYSER_SP_CASE
}

template <typename T>
int dispatch_cx(const T* Ar, const T* Ai, const int* rows, const T* vr,
                const T* vi, const T* xbr, const T* xbi, const T* c0, T* out,
                uint64_t base, int n, int n_pad, int maxdeg, int TB,
                int C_log2, int Wu_log2, int num_blocks, int B, int precision,
                void* stream) {
  if (bad_geometry(base, n, n_pad, maxdeg, TB, C_log2, Wu_log2, num_blocks,
                   B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool F32 = std::is_same_v<T, float>;
#define RYSER_SPX_CASE(K)                                                      \
  case K:                                                                      \
    if constexpr (F32)                                                         \
      return ryser_spx_launch_f32_npad_##K(Ar, Ai, rows, vr, vi, xbr, xbi, c0, \
                                           out, base, n, maxdeg, TB, C_log2,   \
                                           Wu_log2, num_blocks, B, precision,  \
                                           s);                                 \
    else                                                                       \
      return ryser_spx_launch_npad_##K(Ar, Ai, rows, vr, vi, xbr, xbi, c0,     \
                                       out, base, n, maxdeg, TB, C_log2,       \
                                       Wu_log2, num_blocks, B, precision, s);
  switch (n_pad) {
    RYSER_SPX_CASE(8) RYSER_SPX_CASE(16) RYSER_SPX_CASE(24) RYSER_SPX_CASE(32)
    RYSER_SPX_CASE(40) RYSER_SPX_CASE(48) RYSER_SPX_CASE(56) RYSER_SPX_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RYSER_SPX_CASE
}

}  // namespace

// The entries: f64 as named, f32 with the _f32 suffix, the same arguments.
#define RYSER_SP_ENTRIES(T, SUFFIX)                                            \
  extern "C" int ryser_sparse_scalar##SUFFIX(                                  \
      const T* A, const int* rows, const T* vals, const T* xb, const T* c0,   \
      T* out, uint64_t chunk_base, int n, int n_pad, int maxdeg, int TB,      \
      int C_log2, int Wu_log2, int num_blocks, int precision, void* stream) { \
    return dispatch(A, rows, vals, xb, c0, out, chunk_base, n, n_pad, maxdeg,  \
                    TB, C_log2, Wu_log2, num_blocks, 1, precision, stream);    \
  }                                                                            \
  extern "C" int ryser_sparse_batched##SUFFIX(                                 \
      const T* A, const int* rows, const T* vals, const T* xb, const T* c0,   \
      T* out, int B, int n, int n_pad, int maxdeg, int TB, int C_log2,        \
      int Wu_log2, int num_blocks, int precision, void* stream) {             \
    return dispatch(A, rows, vals, xb, c0, out, 0, n, n_pad, maxdeg, TB,       \
                    C_log2, Wu_log2, num_blocks, B, precision, stream);        \
  }                                                                            \
  extern "C" int ryser_sparse_complex_scalar##SUFFIX(                          \
      const T* Ar, const T* Ai, const int* rows, const T* vr, const T* vi,    \
      const T* xbr, const T* xbi, const T* c0, T* out, uint64_t chunk_base,   \
      int n, int n_pad, int maxdeg, int TB, int C_log2, int Wu_log2,          \
      int num_blocks, int precision, void* stream) {                          \
    return dispatch_cx(Ar, Ai, rows, vr, vi, xbr, xbi, c0, out, chunk_base, n, \
                       n_pad, maxdeg, TB, C_log2, Wu_log2, num_blocks, 1,      \
                       precision, stream);                                     \
  }                                                                            \
  extern "C" int ryser_sparse_complex_batched##SUFFIX(                         \
      const T* Ar, const T* Ai, const int* rows, const T* vr, const T* vi,    \
      const T* xbr, const T* xbi, const T* c0, T* out, int B, int n,          \
      int n_pad, int maxdeg, int TB, int C_log2, int Wu_log2, int num_blocks, \
      int precision, void* stream) {                                          \
    return dispatch_cx(Ar, Ai, rows, vr, vi, xbr, xbi, c0, out, 0, n, n_pad,   \
                       maxdeg, TB, C_log2, Wu_log2, num_blocks, B, precision,  \
                       stream);                                                \
  }

RYSER_SP_ENTRIES(double, )
RYSER_SP_ENTRIES(float, _f32)

// CTAs of TB threads of the f64 real n_pad instantiation one SM holds at
// once, into *ctas (the tuner's cost model reads it).
extern "C" int ryser_sparse_occupancy(int n_pad, int precision, int TB,
                                      int Wu_log2, int* ctas) {
  if (TB < 1 || TB > kMaxThreads || Wu_log2 < 1 || ctas == nullptr)
    return (int)cudaErrorInvalidValue;
#define RYSER_SP_OCC_CASE(K)                                          \
  case K:                                                             \
    return ryser_sp_occupancy_npad_##K(precision, TB, Wu_log2, ctas);
  switch (n_pad) {
    RYSER_SP_OCC_CASE(8) RYSER_SP_OCC_CASE(16) RYSER_SP_OCC_CASE(24)
    RYSER_SP_OCC_CASE(32) RYSER_SP_OCC_CASE(40) RYSER_SP_OCC_CASE(48)
    RYSER_SP_OCC_CASE(56) RYSER_SP_OCC_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RYSER_SP_OCC_CASE
}
#endif
