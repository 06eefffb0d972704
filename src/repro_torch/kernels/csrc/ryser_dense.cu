// Dense real Gray-code Ryser block partials for Hopper (sm_90a), f64 and
// f32 (the reference's dtype follows its input through kernel, partials
// and epilogue).
//
// Replaces the TPU kernels kernels/ryser_pallas.py::ryser_pallas_call
// (_ryser_kernel -> _ryser_block, grid over blocks, u64 chunk base) and
// kernels/ryser_pallas.py::ryser_pallas_call_batched (_ryser_kernel_batched,
// grid over (batch, block), chunk base 0).  One block body serves both C
// entry points: ryser_dense_scalar launches grid (num_blocks, 1) from a
// uint64_t chunk base, ryser_dense_batched grid (num_blocks, B) from 0; the
// _f32 entries are the same launches on float input.  Modes: baseline and
// batched in both entries, schedmat in the scalar entry only (its signed
// schedule columns C0 = A @ Sel are per matrix, so the batch grid, which
// shares one schedule input, refuses it as ryser_pallas_call_batched does).
// Blocks stay on gridDim.x: n = 30 has 65 536 of them and gridDim.y stops
// at 65 535.  The body is ryser_kernels.cuh's ryser_kernel<NPAD, P, false>,
// which ryser_sparse.cu instantiates with SPARSE = true.
//
// Design (the paper's GPU layout, not the Pallas block layout):
//   * one thread per chunk: TB = Geometry.lanes threads per CTA, each runs
//     C = steps_per_chunk Gray steps as M = C / Wu windows;
//   * A sits in shared memory, column-major (As[j * NPAD + i] = A[i][j]):
//     an inner step reads the same column in every lane (a broadcast); the
//     boundary step reads a per-lane column jb, which bank-conflicts;
//   * the row-sum vector X lives in registers as double X[NPAD], always
//     indexed by a compile-time i inside #pragma unroll loops, so only A
//     is indexed by a runtime column and nothing falls into local memory;
//   * step indices are native uint64_t (the TPU needed u32-pair emulation);
//     `live` (g <= 2^(n-1) - 1) is exact up to n = 64.
//
// The schedmat mode (ryser_pallas.py::_ryser_block's schedmat arm) reads
// the wrapper's C0 from shared memory, as the batched mode reads its window
// states: an inner step is X += C0[:, idx], the mid step also
// X += col_mid * (-2 bitk), then the product; it is its own instantiation
// (SCHED), so the other modes' code is untouched.
//
// Numerics mirror _ryser_block step for step and the plain PyTorch version
// kernels/ryser_cuda.py::block_partials_plain op for op.  Built with
// --fmad=false: the last product of the chain must round before it meets the
// compensated accumulation (two_sum is error-free only on rounded inputs).
// The sites that do use fma_rn (__fma_rn, __fmaf_rn) multiply an entry of
// A by 0, +-1 or -2, so the product is exact and fma(a, s, x) == x + a * s
// bit for bit.
//
// Bound: FP64 instruction throughput.  A Ryser step is about 2n FP64 ops
// (n adds for the column update, n - 1 multiplies for the product) with
// nothing to fuse, so the least time is ryser_flops(n) over half the
// data-sheet FP64 FLOP/s (which counts an FMA as two); f32 input runs the
// same instructions on the FP32 pipe, over half its data-sheet rate (67
// TFLOP/s on the H100 SXM).  What the design
// does about it: no global memory traffic inside the step loop (A in shared
// memory, X in registers), each update is one DFMA, and the product runs
// its rows without a branch up to NPAD 48, dropping the padded ones by a
// select (ryser_kernels.cuh::re_chain), so the rows' loads and states
// overlap the chain; one pass over the rows carries two steps' chains
// (RealForm).  The campaign's wave body (NPAD 40, batched mode) holds
// 168 registers, 3 CTAs of 128 an SM, with its baseline steps one a pass
// and its boundary step a branch a row: in the two-chain form throughout
// it took 198 (2 CTAs), and capped at 168 it spilled.  Not done: a step's
// product is one serial DMUL chain; splitting it would change the
// reference's association order.

#include <cstdint>
#include <cuda_runtime.h>

#include "ryser_kernels.cuh"

namespace {

template <typename T, int NPAD>
size_t smem_bytes(int TB, int Wu_log2, int mode) {
  const size_t Wu = (size_t)1 << Wu_log2;
  return sizeof(T) *
      ((size_t)NPAD * NPAD + (mode != M_BASELINE ? (size_t)NPAD * (Wu - 1) : 0) +
       2 * (size_t)TB);
}

template <typename T, int NPAD, int P>
int launch(const T* A, const T* xb, const T* c0, T* out, uint64_t base, int n,
           int TB, int C_log2, int Wu_log2, int num_blocks, int B, int mode,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, NPAD>(TB, Wu_log2, mode);
  if (mode == M_SCHEDMAT)
    return launch_kernel(ryser_kernel<NPAD, P, false, T, true>, smem,
                         num_blocks, B, TB, stream, A, (const int*)nullptr,
                         (const T*)nullptr, xb, c0, out, base, n, 0,
                         C_log2, Wu_log2, num_blocks, mode);
  return launch_kernel(ryser_kernel<NPAD, P, false, T>, smem, num_blocks, B,
                       TB, stream, A, (const int*)nullptr,
                       (const T*)nullptr, xb, c0, out, base, n, 0,
                       C_log2, Wu_log2, num_blocks, mode);
}

// CTAs of TB threads one SM holds at once (registers and shared memory).
template <typename T, int NPAD, int P>
int occupancy(int TB, int Wu_log2, int mode, int* ctas) {
  const size_t smem = smem_bytes<T, NPAD>(TB, Wu_log2, mode);
  if (mode == M_SCHEDMAT)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, ryser_kernel<NPAD, P, false, T, true>, TB, smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, ryser_kernel<NPAD, P, false, T>, TB, smem);
}

}  // namespace

// One launcher per NPAD and scalar type.  build.py compiles each in its own
// nvcc process (-DRYSER_NPAD=k, f64; with -DRYSER_F32 also, f32) and one
// more for the C entry points (-DRYSER_API_ONLY), in parallel; every unit
// defines exactly one of RYSER_NPAD=k and RYSER_API_ONLY.
#if defined(RYSER_NPAD) == defined(RYSER_API_ONLY)
#error "define exactly one of RYSER_NPAD=k and RYSER_API_ONLY"
#endif

#define RYSER_LAUNCHER_SIG(K, T, TAG)                                          \
  extern "C" int ryser_launch_##TAG##npad_##K(                                 \
      const T* A, const T* xb, const T* c0, T* out, uint64_t base, int n,     \
      int TB, int C_log2, int Wu_log2, int num_blocks, int B, int precision,  \
      int mode, cudaStream_t stream)

#define RYSER_OCCUPANCY_SIG(K, TAG)                                            \
  extern "C" int ryser_occupancy_##TAG##npad_##K(int precision, int TB,       \
                                                 int Wu_log2, int mode,       \
                                                 int* ctas)

#define RYSER_DEFINE_LAUNCHER(K, T, TAG)                                       \
  RYSER_LAUNCHER_SIG(K, T, TAG) {                                              \
    switch (precision) {                                                       \
      case P_DD: return launch<T, K, P_DD>(A, xb, c0, out, base, n, TB,        \
                                           C_log2, Wu_log2, num_blocks, B,     \
                                           mode, stream);                      \
      case P_KAHAN: return launch<T, K, P_KAHAN>(A, xb, c0, out, base, n, TB,  \
                                                 C_log2, Wu_log2, num_blocks,  \
                                                 B, mode, stream);             \
      case P_DQ_ACC: return launch<T, K, P_DQ_ACC>(A, xb, c0, out, base, n,    \
                                                   TB, C_log2, Wu_log2,        \
                                                   num_blocks, B, mode,        \
                                                   stream);                    \
      case P_DQ_FAST: return launch<T, K, P_DQ_FAST>(A, xb, c0, out, base, n,  \
                                                     TB, C_log2, Wu_log2,      \
                                                     num_blocks, B, mode,      \
                                                     stream);                  \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }                                                                            \
  RYSER_OCCUPANCY_SIG(K, TAG) {                                                \
    switch (precision) {                                                       \
      case P_DD: return occupancy<T, K, P_DD>(TB, Wu_log2, mode, ctas);        \
      case P_KAHAN: return occupancy<T, K, P_KAHAN>(TB, Wu_log2, mode, ctas);  \
      case P_DQ_ACC:                                                           \
        return occupancy<T, K, P_DQ_ACC>(TB, Wu_log2, mode, ctas);            \
      case P_DQ_FAST:                                                          \
        return occupancy<T, K, P_DQ_FAST>(TB, Wu_log2, mode, ctas);           \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }

#define RYSER_EXPAND(M, K, T, TAG) M(K, T, TAG)

#if defined(RYSER_NPAD)
#if defined(RYSER_F32)
RYSER_EXPAND(RYSER_DEFINE_LAUNCHER, RYSER_NPAD, float, f32_)
#else
RYSER_EXPAND(RYSER_DEFINE_LAUNCHER, RYSER_NPAD, double, )
#endif
#else
#define RYSER_DECLARE(K)             \
  RYSER_LAUNCHER_SIG(K, double, );   \
  RYSER_OCCUPANCY_SIG(K, );          \
  RYSER_LAUNCHER_SIG(K, float, f32_); \
  RYSER_OCCUPANCY_SIG(K, f32_);
RYSER_DECLARE(8)
RYSER_DECLARE(16)
RYSER_DECLARE(24)
RYSER_DECLARE(32)
RYSER_DECLARE(40)
RYSER_DECLARE(48)
RYSER_DECLARE(56)
RYSER_DECLARE(64)

namespace {

// The scalar entry takes every mode; the batch entry (B rows of the grid,
// one shared schedule input) baseline and batched only.
template <typename T>
int dispatch(const T* A, const T* xb, const T* c0, T* out, uint64_t base,
             int n, int n_pad, int TB, int C_log2, int Wu_log2,
             int num_blocks, int B, int precision, int mode, bool scalar,
             void* stream) {
  const bool mode_ok = mode == M_BASELINE || mode == M_BATCHED ||
                       (scalar && mode == M_SCHEDMAT);
  if (n < 3 || n > 64 || n > n_pad || TB < 1 || TB > kMaxThreads ||
      (TB & (TB - 1)) != 0 || Wu_log2 < 1 || C_log2 < Wu_log2 ||
      num_blocks < 1 || B < 1 || B > 65535 || !mode_ok ||
      (mode != M_BASELINE && c0 == nullptr) ||
      !chunks_in_space(base, n, TB, C_log2, num_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool F32 = std::is_same_v<T, float>;
#define RYSER_CASE(K)                                                        \
  case K:                                                                    \
    if constexpr (F32)                                                       \
      return ryser_launch_f32_npad_##K(A, xb, c0, out, base, n, TB, C_log2,  \
                                       Wu_log2, num_blocks, B, precision,    \
                                       mode, s);                             \
    else                                                                     \
      return ryser_launch_npad_##K(A, xb, c0, out, base, n, TB, C_log2,      \
                                   Wu_log2, num_blocks, B, precision, mode,  \
                                   s);
  switch (n_pad) {
    RYSER_CASE(8) RYSER_CASE(16) RYSER_CASE(24) RYSER_CASE(32)
    RYSER_CASE(40) RYSER_CASE(48) RYSER_CASE(56) RYSER_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RYSER_CASE
}

}  // namespace

extern "C" int ryser_dense_scalar(const double* A, const double* xb,
                                  const double* c0, double* out,
                                  uint64_t chunk_base, int n, int n_pad, int TB,
                                  int C_log2, int Wu_log2, int num_blocks,
                                  int precision, int mode, void* stream) {
  return dispatch(A, xb, c0, out, chunk_base, n, n_pad, TB, C_log2, Wu_log2,
                  num_blocks, 1, precision, mode, true, stream);
}

extern "C" int ryser_dense_batched(const double* A, const double* xb,
                                   const double* c0, double* out, int B, int n,
                                   int n_pad, int TB, int C_log2, int Wu_log2,
                                   int num_blocks, int precision, int mode,
                                   void* stream) {
  return dispatch(A, xb, c0, out, 0, n, n_pad, TB, C_log2, Wu_log2,
                  num_blocks, B, precision, mode, false, stream);
}

extern "C" int ryser_dense_scalar_f32(const float* A, const float* xb,
                                      const float* c0, float* out,
                                      uint64_t chunk_base, int n, int n_pad,
                                      int TB, int C_log2, int Wu_log2,
                                      int num_blocks, int precision, int mode,
                                      void* stream) {
  return dispatch(A, xb, c0, out, chunk_base, n, n_pad, TB, C_log2, Wu_log2,
                  num_blocks, 1, precision, mode, true, stream);
}

extern "C" int ryser_dense_batched_f32(const float* A, const float* xb,
                                       const float* c0, float* out, int B,
                                       int n, int n_pad, int TB, int C_log2,
                                       int Wu_log2, int num_blocks,
                                       int precision, int mode, void* stream) {
  return dispatch(A, xb, c0, out, 0, n, n_pad, TB, C_log2, Wu_log2,
                  num_blocks, B, precision, mode, false, stream);
}

// CTAs of TB threads of the f64 n_pad instantiation one SM holds at once,
// into *ctas (the campaign's wave width reads it).
extern "C" int ryser_dense_occupancy(int n_pad, int precision, int TB,
                                     int Wu_log2, int mode, int* ctas) {
  if (TB < 1 || TB > kMaxThreads || Wu_log2 < 1 || ctas == nullptr)
    return (int)cudaErrorInvalidValue;
#define RYSER_OCC_CASE(K) \
  case K: return ryser_occupancy_npad_##K(precision, TB, Wu_log2, mode, ctas);
  switch (n_pad) {
    RYSER_OCC_CASE(8) RYSER_OCC_CASE(16) RYSER_OCC_CASE(24) RYSER_OCC_CASE(32)
    RYSER_OCC_CASE(40) RYSER_OCC_CASE(48) RYSER_OCC_CASE(56) RYSER_OCC_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RYSER_OCC_CASE
}

extern "C" const char* ryser_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
