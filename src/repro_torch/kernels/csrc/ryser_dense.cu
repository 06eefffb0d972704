// Dense real f64 Gray-code Ryser block partials for Hopper (sm_90a).
//
// Replaces the TPU kernels kernels/ryser_pallas.py::ryser_pallas_call
// (_ryser_kernel -> _ryser_block, grid over blocks, u64 chunk base) and
// kernels/ryser_pallas.py::ryser_pallas_call_batched (_ryser_kernel_batched,
// grid over (batch, block), chunk base 0).  One block body serves both C
// entry points: ryser_dense_scalar launches grid (num_blocks, 1) from a
// uint64_t chunk base, ryser_dense_batched grid (num_blocks, B) from 0.
// Blocks stay on gridDim.x: n = 30 has 65 536 of them and gridDim.y stops
// at 65 535.
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
// Numerics mirror _ryser_block step for step and the plain PyTorch version
// kernels/ryser_cuda.py::block_partials_plain op for op.  Built with
// --fmad=false: the last product of the chain must round before it meets the
// compensated accumulation (two_sum is error-free only on rounded inputs).
// The sites that do use __fma_rn multiply an entry of A by 0, +-1 or -2, so
// the product is exact and fma(a, s, x) == x + a * s bit for bit.
//
// Bound: FP64 instruction throughput.  A Ryser step is about 2n FP64 ops
// (n adds for the column update, n - 1 multiplies for the product) with
// nothing to fuse, so the least time is ryser_flops(n) over half the
// data-sheet FP64 FLOP/s (which counts an FMA as two).  What the design
// does about it: no global memory traffic inside the step loop (A in shared
// memory, X in registers), each update is one DFMA, and the product skips
// the padded rows (exactly 1).  Not done yet: the product is one serial
// DMUL chain, so at the occupancy a 2 * NPAD register array allows the
// step is latency-bound; splitting the chain would change the reference's
// association order.

#include <cstdint>
#include <cuda_runtime.h>

#include "ryser_common.cuh"

namespace {

enum Mode { M_BASELINE = 0, M_BATCHED = 1 };

// Sequential product over the n live rows; padded rows are exactly 1.
template <int NPAD>
__device__ __forceinline__ double chain_prod(const double (&X)[NPAD], int n) {
  double p = X[0];
#pragma unroll
  for (int i = 1; i < NPAD; ++i) {
    if (i < n) p = p * X[i];
  }
  return p;
}

template <int NPAD, int P>
__global__ void __launch_bounds__(kMaxThreads)
ryser_dense_kernel(const double* __restrict__ A, const double* __restrict__ xb,
                   const double* __restrict__ c0, double* __restrict__ out,
                   uint64_t chunk_base, int n, int C_log2, int Wu_log2,
                   int num_blocks, int mode) {
  extern __shared__ double smem[];
  const int TB = blockDim.x;
  const int lane = threadIdx.x;
  const int Wu = 1 << Wu_log2;
  const int kw = Wu_log2;
  const int M = 1 << (C_log2 - Wu_log2);
  const uint64_t space = 1ull << (n - 1);

  double* As = smem;                                   // NPAD * NPAD
  double* Ds = As + NPAD * NPAD;                       // NPAD * (Wu - 1)
  double* red = Ds + (mode == M_BATCHED ? NPAD * (Wu - 1) : 0);  // 2 * TB

  const int b = blockIdx.y;
  const double* Ab = A + (size_t)b * NPAD * NPAD;
  const double* xbb = xb + (size_t)b * NPAD;
  for (int t = lane; t < NPAD * NPAD; t += TB) {
    const int i = t / NPAD, j = t % NPAD;
    As[j * NPAD + i] = Ab[t];
  }
  if (mode == M_BATCHED) {
    __syncthreads();
    // D = A @ cumsig, once per CTA.  cumsig rows >= kw are zero, and its
    // entries are 0 or 1, so each fma adds an exact product.
    for (int t = lane; t < NPAD * (Wu - 1); t += TB) {
      const int idx = t / NPAD, i = t % NPAD;
      double acc = 0.0;
      for (int k = 0; k < kw; ++k)
        acc = __fma_rn(As[k * NPAD + i], c0[k * (Wu - 1) + idx], acc);
      Ds[idx * NPAD + i] = acc;
    }
  }
  __syncthreads();

  // ---- chunk id, start step, init X = xb + sum_j A[:, j] * graybit_j ----
  const uint64_t chunk = chunk_base + (uint64_t)blockIdx.x * TB + lane;
  const uint64_t start = chunk << C_log2;
  const uint64_t gs = start ^ (start >> 1);
  double X[NPAD];
#pragma unroll
  for (int i = 0; i < NPAD; ++i) X[i] = xbb[i];
  for (int j = 0; j < n; ++j) {
    const double bit = (double)((gs >> j) & 1ull);
    const double* col = As + j * NPAD;
#pragma unroll
    for (int i = 0; i < NPAD; ++i) X[i] = __fma_rn(col[i], bit, X[i]);  // exact: bit is 0 or 1
  }

  const double* col_mid = As + (kw - 1) * NPAD;
  const int mid_idx = Wu / 2 - 1;
  double s_acc = 0.0, c_acc = 0.0;
  for (int m = 0; m < M; ++m) {
    const uint64_t macro = start + ((uint64_t)m << Wu_log2);
    const double bitk = (double)((macro >> kw) & 1ull);
    if (mode == M_BASELINE) {
      const double mid_flip = 1.0 - 2.0 * bitk;
      for (int w = 1; w < Wu; ++w) {
        const int j = __ffs(w) - 1;
        // host-constant sign, except the mid step's per-lane flip
        const double s = (j + 1 < kw)
            ? (double)(2 * (((w >> j) ^ (w >> (j + 1))) & 1) - 1)
            : mid_flip;
        const double* col = As + j * NPAD;
#pragma unroll
        for (int i = 0; i < NPAD; ++i) X[i] = __fma_rn(col[i], s, X[i]);  // exact: s is +-1
        const double prod = chain_prod<NPAD>(X, n);
        accum_add<P>(s_acc, c_acc, (w & 1) ? -prod : prod);
      }
    } else {
      // states (X + D[:, idx]) + corr, corr = col_mid * (-2 * bitk) from the
      // mid step on; X itself is advanced once per window
      const double cm = -2.0 * bitk;
      for (int idx = 0; idx < Wu - 1; ++idx) {
        const double* Dc = Ds + idx * NPAD;
        const bool after_mid = idx >= mid_idx;
        double p = 1.0;
#pragma unroll
        for (int i = 0; i < NPAD; ++i) {
          if (i < n) {
            double st = X[i] + Dc[i];
            if (after_mid) st = __fma_rn(col_mid[i], cm, st);  // exact: cm is 0 or -2
            p = (i == 0) ? st : p * st;
          }
        }
        accum_add<P>(s_acc, c_acc, ((idx + 1) & 1) ? -p : p);
      }
      const double* Dl = Ds + (Wu - 2) * NPAD;
#pragma unroll
      for (int i = 0; i < NPAD; ++i) {
        X[i] = X[i] + Dl[i];
        X[i] = __fma_rn(col_mid[i], cm, X[i]);
      }
    }

    // ---- boundary step w = Wu: per-lane column jb, no sign on the term ----
    const uint64_t gb = macro + (uint64_t)Wu;
    const int jb = __ffsll((long long)gb) - 1;
    const uint64_t ggb = gb ^ (gb >> 1);
    const double sb = (double)(2 * (int)((ggb >> jb) & 1ull) - 1);
    const double live = (gb <= space - 1) ? 1.0 : 0.0;
    const double f = sb * live;
    const double* colb = As + jb * NPAD;  // jb <= n - 1 < NPAD
#pragma unroll
    for (int i = 0; i < NPAD; ++i) X[i] = __fma_rn(colb[i], f, X[i]);  // exact: f is 0 or +-1
    const double prod = chain_prod<NPAD>(X, n);
    accum_add<P>(s_acc, c_acc, prod * live);
  }

  // ---- fixed-order lane tree over hi and lo (no atomics) ----
  const bool two_limb = (P == P_DQ_ACC || P == P_DQ_FAST);
  red[lane] = s_acc;
  red[TB + lane] = two_limb ? c_acc : 0.0;
  __syncthreads();
  for (int stride = TB / 2; stride > 0; stride >>= 1) {
    if (lane < stride) {
      red[lane] = red[lane] + red[lane + stride];
      red[TB + lane] = red[TB + lane] + red[TB + lane + stride];
    }
    __syncthreads();
  }
  if (lane == 0) {
    const size_t o = ((size_t)b * num_blocks + blockIdx.x) * 2;
    out[o] = red[0];
    out[o + 1] = red[TB];
  }
}

template <int NPAD, int P>
int launch(const double* A, const double* xb, const double* c0, double* out,
           uint64_t base, int n, int TB, int C_log2, int Wu_log2,
           int num_blocks, int B, int mode, cudaStream_t stream) {
  const int Wu = 1 << Wu_log2;
  const size_t smem = sizeof(double) *
      ((size_t)NPAD * NPAD + (mode == M_BATCHED ? (size_t)NPAD * (Wu - 1) : 0) +
       2 * (size_t)TB);
  auto kern = ryser_dense_kernel<NPAD, P>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((unsigned)num_blocks, (unsigned)B), TB, smem, stream>>>(
      A, xb, c0, out, base, n, C_log2, Wu_log2, num_blocks, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// One launcher per NPAD.  build.py compiles each in its own nvcc process
// (-DRYSER_NPAD=k) and one more for the C entry points (-DRYSER_API_ONLY),
// in parallel; every unit defines exactly one of the two macros.
#if defined(RYSER_NPAD) == defined(RYSER_API_ONLY)
#error "define exactly one of RYSER_NPAD=k and RYSER_API_ONLY"
#endif

#define RYSER_LAUNCHER_SIG(K)                                                  \
  extern "C" int ryser_launch_npad_##K(                                        \
      const double* A, const double* xb, const double* c0, double* out,       \
      uint64_t base, int n, int TB, int C_log2, int Wu_log2, int num_blocks,  \
      int B, int precision, int mode, cudaStream_t stream)

#define RYSER_DEFINE_LAUNCHER(K)                                               \
  RYSER_LAUNCHER_SIG(K) {                                                      \
    switch (precision) {                                                       \
      case P_DD: return launch<K, P_DD>(A, xb, c0, out, base, n, TB, C_log2,   \
                                        Wu_log2, num_blocks, B, mode, stream); \
      case P_KAHAN: return launch<K, P_KAHAN>(A, xb, c0, out, base, n, TB,     \
                                              C_log2, Wu_log2, num_blocks, B,  \
                                              mode, stream);                   \
      case P_DQ_ACC: return launch<K, P_DQ_ACC>(A, xb, c0, out, base, n, TB,   \
                                                C_log2, Wu_log2, num_blocks,   \
                                                B, mode, stream);              \
      case P_DQ_FAST: return launch<K, P_DQ_FAST>(A, xb, c0, out, base, n, TB, \
                                                  C_log2, Wu_log2, num_blocks, \
                                                  B, mode, stream);            \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }

#define RYSER_EXPAND(M, K) M(K)

#if defined(RYSER_NPAD)
RYSER_EXPAND(RYSER_DEFINE_LAUNCHER, RYSER_NPAD)
#else
RYSER_LAUNCHER_SIG(8);
RYSER_LAUNCHER_SIG(16);
RYSER_LAUNCHER_SIG(24);
RYSER_LAUNCHER_SIG(32);
RYSER_LAUNCHER_SIG(40);
RYSER_LAUNCHER_SIG(48);
RYSER_LAUNCHER_SIG(56);
RYSER_LAUNCHER_SIG(64);

namespace {

int dispatch(const double* A, const double* xb, const double* c0, double* out,
             uint64_t base, int n, int n_pad, int TB, int C_log2, int Wu_log2,
             int num_blocks, int B, int precision, int mode, void* stream) {
  if (n < 3 || n > 64 || n > n_pad || TB < 1 || TB > kMaxThreads ||
      (TB & (TB - 1)) != 0 || Wu_log2 < 1 || C_log2 < Wu_log2 ||
      num_blocks < 1 || B < 1 || B > 65535 || (mode != M_BASELINE && mode != M_BATCHED))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RYSER_CASE(K)                                                        \
  case K:                                                                    \
    return ryser_launch_npad_##K(A, xb, c0, out, base, n, TB, C_log2,        \
                                 Wu_log2, num_blocks, B, precision, mode, s);
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
                  num_blocks, 1, precision, mode, stream);
}

extern "C" int ryser_dense_batched(const double* A, const double* xb,
                                   const double* c0, double* out, int B, int n,
                                   int n_pad, int TB, int C_log2, int Wu_log2,
                                   int num_blocks, int precision, int mode,
                                   void* stream) {
  return dispatch(A, xb, c0, out, 0, n, n_pad, TB, C_log2, Wu_log2,
                  num_blocks, B, precision, mode, stream);
}

extern "C" const char* ryser_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
