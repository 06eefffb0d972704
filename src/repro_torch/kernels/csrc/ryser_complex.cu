// Split-plane complex Gray-code Ryser block partials for Hopper (sm_90a), f64
// planes and f32 planes (complex64 input, whose dtype the reference keeps
// through kernel, partials and epilogue).
//
// Replaces the TPU kernels kernels/ryser_complex.py::ryser_pallas_call_complex
// (_ryser_kernel_cx -> _ryser_block_cx, grid over blocks, u64 chunk base) and
// kernels/ryser_complex.py::ryser_pallas_call_complex_batched
// (_ryser_kernel_cx_batched, grid over (batch, block), chunk base 0).  One
// block body serves both C entry points: ryser_complex_scalar launches grid
// (num_blocks, 1) from a uint64_t chunk base, ryser_complex_batched grid
// (num_blocks, B) from 0; the _f32 entries are the same launches on f32
// planes.  Blocks stay on gridDim.x (n = 30 has 65 536).  The split-plane
// kernel runs the window-batched mode only, as the Pallas one does.  The
// body is ryser_kernels.cuh's ryser_cx_kernel<NPAD, P, false, T>, which
// ryser_sparse.cu instantiates with SPARSE = true.
//
// Design (the dense kernel's layout, ryser_dense.cu, with two planes):
//   * one thread per chunk: TB threads per CTA, each runs C Gray steps as
//     M = C / Wu windows;
//   * Ar and Ai sit in shared memory, column-major; Dr = Ar @ cumsig and
//     Di = Ai @ cumsig are computed once per CTA into shared memory;
//   * the row-sum planes live in registers as double Xr[NPAD], Xi[NPAD],
//     indexed only by a compile-time i inside #pragma unroll loops;
//   * an inner step streams the product row by row from
//     Xr[i] + Dr[i][idx] (+ cm_r[i] * corr), never materialising the state,
//     with no branch between the rows at NPAD 16-32 (cx_chain);
//   * the boundary step reads the per-lane column jb straight from shared
//     memory (the Pallas one-hot matmul is exact, so nothing changes).
//
// Numerics mirror _ryser_block_cx step for step and the plain PyTorch
// version kernels/ryser_complex_cuda.py::block_partials_plain_complex op for
// op.  The product is (pr, pi) <- (pr*xr - pi*xi, pr*xi + pi*xr) over rows
// 1..n-1 from row 0 (padded rows are 1 + 0i and skipped).  Built with
// --fmad=false so it is never contracted into an FMA; the only __fma_rn
// sites multiply an entry of A by 0, +-1 or -2, where the product is exact.
// Accumulation is per component: (re_hi, re_err, im_hi, im_err) per block.
//
// Bound: FP64 instruction throughput.  A complex step is about 8n FP64
// instructions (2n adds for the two column updates, 6(n - 1) for the complex
// product) with nothing to fuse, over half the data-sheet FP64 FLOP/s.  What
// the design does about it: no global memory traffic inside the step loop,
// one instruction per operation, and rows free of branches so that loads
// and states overlap the product chain (the note at the top of
// ryser_kernels.cuh).  Not done: at NPAD 32 the two planes take 128 of the
// registers, so an SM holds 8 warps; NPAD >= 56 spills (4 * NPAD registers
// for X alone), which only the campaign sizes reach.  f32 planes run the
// same instructions on the FP32 pipe, over half its data-sheet rate.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "ryser_kernels.cuh"

namespace {

template <typename T, int NPAD>
size_t smem_bytes(int TB, int Wu_log2) {
  const size_t Wu = (size_t)1 << Wu_log2;
  return sizeof(T) *
      (2 * (size_t)NPAD * NPAD + 2 * (size_t)NPAD * (Wu - 1) + 4 * (size_t)TB);
}

template <typename T, int NPAD, int P>
int launch(const T* Ar, const T* Ai, const T* xbr, const T* xbi, const T* c0,
           T* out, uint64_t base, int n, int TB, int C_log2, int Wu_log2,
           int num_blocks, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, NPAD>(TB, Wu_log2);
  return launch_kernel(ryser_cx_kernel<NPAD, P, false, T>, smem, num_blocks,
                       B, TB, stream, Ar, Ai, (const int*)nullptr,
                       (const T*)nullptr, (const T*)nullptr, xbr, xbi, c0,
                       out, base, n, 0, C_log2, Wu_log2, num_blocks);
}

// CTAs of TB threads one SM holds at once (registers and shared memory).
template <typename T, int NPAD, int P>
int occupancy(int TB, int Wu_log2, int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, ryser_cx_kernel<NPAD, P, false, T>, TB,
      smem_bytes<T, NPAD>(TB, Wu_log2));
}

}  // namespace

// One launcher per NPAD and scalar type, compiled as in ryser_dense.cu: one
// nvcc process per -DRYSER_NPAD=k (with -DRYSER_F32 also, f32) and one more
// for the C entry points (-DRYSER_API_ONLY).
#if defined(RYSER_NPAD) == defined(RYSER_API_ONLY)
#error "define exactly one of RYSER_NPAD=k and RYSER_API_ONLY"
#endif

#define RYSER_CX_LAUNCHER_SIG(K, T, TAG)                                       \
  extern "C" int ryser_cx_launch_##TAG##npad_##K(                              \
      const T* Ar, const T* Ai, const T* xbr, const T* xbi, const T* c0,      \
      T* out, uint64_t base, int n, int TB, int C_log2, int Wu_log2,          \
      int num_blocks, int B, int precision, cudaStream_t stream)

#define RYSER_CX_OCCUPANCY_SIG(K)                                              \
  extern "C" int ryser_cx_occupancy_npad_##K(int precision, int TB,           \
                                             int Wu_log2, int* ctas)

#define RYSER_CX_CASE_P(K, T, PV)                                              \
  case PV:                                                                     \
    return launch<T, K, PV>(Ar, Ai, xbr, xbi, c0, out, base, n, TB, C_log2,    \
                            Wu_log2, num_blocks, B, stream);

#define RYSER_CX_DEFINE_LAUNCHER(K, T, TAG)                                    \
  RYSER_CX_LAUNCHER_SIG(K, T, TAG) {                                           \
    switch (precision) {                                                       \
      RYSER_CX_CASE_P(K, T, P_DD)                                              \
      RYSER_CX_CASE_P(K, T, P_KAHAN)                                           \
      RYSER_CX_CASE_P(K, T, P_DQ_ACC)                                          \
      RYSER_CX_CASE_P(K, T, P_DQ_FAST)                                         \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }

// the occupancy query of the f64 instantiations (the campaign's wave width
// and the tuner's cost model read it)
#define RYSER_CX_DEFINE_OCCUPANCY(K)                                           \
  RYSER_CX_OCCUPANCY_SIG(K) {                                                  \
    switch (precision) {                                                       \
      case P_DD: return occupancy<double, K, P_DD>(TB, Wu_log2, ctas);         \
      case P_KAHAN: return occupancy<double, K, P_KAHAN>(TB, Wu_log2, ctas);   \
      case P_DQ_ACC:                                                           \
        return occupancy<double, K, P_DQ_ACC>(TB, Wu_log2, ctas);             \
      case P_DQ_FAST:                                                          \
        return occupancy<double, K, P_DQ_FAST>(TB, Wu_log2, ctas);            \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }

#define RYSER_CX_EXPAND(M, ...) M(__VA_ARGS__)

#if defined(RYSER_NPAD)
#if defined(RYSER_F32)
RYSER_CX_EXPAND(RYSER_CX_DEFINE_LAUNCHER, RYSER_NPAD, float, f32_)
#else
RYSER_CX_EXPAND(RYSER_CX_DEFINE_LAUNCHER, RYSER_NPAD, double, )
RYSER_CX_EXPAND(RYSER_CX_DEFINE_OCCUPANCY, RYSER_NPAD)
#endif
#else
#define RYSER_CX_DECLARE(K)                 \
  RYSER_CX_LAUNCHER_SIG(K, double, );       \
  RYSER_CX_LAUNCHER_SIG(K, float, f32_);    \
  RYSER_CX_OCCUPANCY_SIG(K);
RYSER_CX_DECLARE(8)
RYSER_CX_DECLARE(16)
RYSER_CX_DECLARE(24)
RYSER_CX_DECLARE(32)
RYSER_CX_DECLARE(40)
RYSER_CX_DECLARE(48)
RYSER_CX_DECLARE(56)
RYSER_CX_DECLARE(64)

namespace {

template <typename T>
int dispatch(const T* Ar, const T* Ai, const T* xbr, const T* xbi,
             const T* c0, T* out, uint64_t base, int n, int n_pad, int TB,
             int C_log2, int Wu_log2, int num_blocks, int B, int precision,
             void* stream) {
  if (n < 3 || n > 64 || n > n_pad || TB < 1 || TB > kMaxThreads ||
      (TB & (TB - 1)) != 0 || Wu_log2 < 1 || C_log2 < Wu_log2 ||
      num_blocks < 1 || B < 1 || B > 65535 ||
      !chunks_in_space(base, n, TB, C_log2, num_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool F32 = std::is_same_v<T, float>;
#define RYSER_CX_CASE(K)                                                       \
  case K:                                                                      \
    if constexpr (F32)                                                         \
      return ryser_cx_launch_f32_npad_##K(Ar, Ai, xbr, xbi, c0, out, base, n,  \
                                          TB, C_log2, Wu_log2, num_blocks, B,  \
                                          precision, s);                       \
    else                                                                       \
      return ryser_cx_launch_npad_##K(Ar, Ai, xbr, xbi, c0, out, base, n, TB,  \
                                      C_log2, Wu_log2, num_blocks, B,          \
                                      precision, s);
  switch (n_pad) {
    RYSER_CX_CASE(8) RYSER_CX_CASE(16) RYSER_CX_CASE(24) RYSER_CX_CASE(32)
    RYSER_CX_CASE(40) RYSER_CX_CASE(48) RYSER_CX_CASE(56) RYSER_CX_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RYSER_CX_CASE
}

}  // namespace

extern "C" int ryser_complex_scalar(const double* Ar, const double* Ai,
                                    const double* xbr, const double* xbi,
                                    const double* c0, double* out,
                                    uint64_t chunk_base, int n, int n_pad,
                                    int TB, int C_log2, int Wu_log2,
                                    int num_blocks, int precision,
                                    void* stream) {
  return dispatch(Ar, Ai, xbr, xbi, c0, out, chunk_base, n, n_pad, TB, C_log2,
                  Wu_log2, num_blocks, 1, precision, stream);
}

extern "C" int ryser_complex_batched(const double* Ar, const double* Ai,
                                     const double* xbr, const double* xbi,
                                     const double* c0, double* out, int B,
                                     int n, int n_pad, int TB, int C_log2,
                                     int Wu_log2, int num_blocks,
                                     int precision, void* stream) {
  return dispatch(Ar, Ai, xbr, xbi, c0, out, 0, n, n_pad, TB, C_log2, Wu_log2,
                  num_blocks, B, precision, stream);
}

extern "C" int ryser_complex_scalar_f32(const float* Ar, const float* Ai,
                                        const float* xbr, const float* xbi,
                                        const float* c0, float* out,
                                        uint64_t chunk_base, int n, int n_pad,
                                        int TB, int C_log2, int Wu_log2,
                                        int num_blocks, int precision,
                                        void* stream) {
  return dispatch(Ar, Ai, xbr, xbi, c0, out, chunk_base, n, n_pad, TB, C_log2,
                  Wu_log2, num_blocks, 1, precision, stream);
}

extern "C" int ryser_complex_batched_f32(const float* Ar, const float* Ai,
                                         const float* xbr, const float* xbi,
                                         const float* c0, float* out, int B,
                                         int n, int n_pad, int TB, int C_log2,
                                         int Wu_log2, int num_blocks,
                                         int precision, void* stream) {
  return dispatch(Ar, Ai, xbr, xbi, c0, out, 0, n, n_pad, TB, C_log2, Wu_log2,
                  num_blocks, B, precision, stream);
}

// CTAs of TB threads of the f64 n_pad instantiation one SM holds at once,
// into *ctas (the campaign's wave width and the tuner's cost model read it).
extern "C" int ryser_complex_occupancy(int n_pad, int precision, int TB,
                                       int Wu_log2, int* ctas) {
  if (TB < 1 || TB > kMaxThreads || Wu_log2 < 1 || ctas == nullptr)
    return (int)cudaErrorInvalidValue;
#define RYSER_CX_OCC_CASE(K) \
  case K: return ryser_cx_occupancy_npad_##K(precision, TB, Wu_log2, ctas);
  switch (n_pad) {
    RYSER_CX_OCC_CASE(8) RYSER_CX_OCC_CASE(16) RYSER_CX_OCC_CASE(24)
    RYSER_CX_OCC_CASE(32) RYSER_CX_OCC_CASE(40) RYSER_CX_OCC_CASE(48)
    RYSER_CX_OCC_CASE(56) RYSER_CX_OCC_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RYSER_CX_OCC_CASE
}
#endif
