// Split-plane complex f64 Gray-code Ryser block partials for Hopper (sm_90a).
//
// Replaces the TPU kernels kernels/ryser_complex.py::ryser_pallas_call_complex
// (_ryser_kernel_cx -> _ryser_block_cx, grid over blocks, u64 chunk base) and
// kernels/ryser_complex.py::ryser_pallas_call_complex_batched
// (_ryser_kernel_cx_batched, grid over (batch, block), chunk base 0).  One
// block body serves both C entry points: ryser_complex_scalar launches grid
// (num_blocks, 1) from a uint64_t chunk base, ryser_complex_batched grid
// (num_blocks, B) from 0.  Blocks stay on gridDim.x (n = 30 has 65 536).
// The split-plane kernel runs the window-batched mode only, as the Pallas
// one does.
//
// Design (the dense kernel's layout, ryser_dense.cu, with two planes):
//   * one thread per chunk: TB threads per CTA, each runs C Gray steps as
//     M = C / Wu windows;
//   * Ar and Ai sit in shared memory, column-major; Dr = Ar @ cumsig and
//     Di = Ai @ cumsig are computed once per CTA into shared memory;
//   * the row-sum planes live in registers as double Xr[NPAD], Xi[NPAD],
//     indexed only by a compile-time i inside #pragma unroll loops;
//   * an inner step streams the product row by row from
//     Xr[i] + Dr[i][idx] (+ cm_r[i] * corr), never materialising the state;
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
// the design does about it: no global memory traffic inside the step loop
// and one instruction per operation.  Not done yet: at NPAD 32 the two
// planes take 128 of the registers, so occupancy is low and the serial
// product chain is latency-bound; NPAD >= 48 spills (4 * NPAD registers for
// X alone), which only the campaign sizes reach.

#include <cstdint>
#include <cuda_runtime.h>

#include "ryser_common.cuh"

namespace {

// Complex product over the n live rows of (Xr, Xi).
template <int NPAD>
__device__ __forceinline__ void chain_prod_cx(const double (&Xr)[NPAD],
                                              const double (&Xi)[NPAD], int n,
                                              double& pr, double& pi) {
  pr = Xr[0];
  pi = Xi[0];
#pragma unroll
  for (int i = 1; i < NPAD; ++i) {
    if (i < n) {
      const double r = pr * Xr[i] - pi * Xi[i];
      const double m = pr * Xi[i] + pi * Xr[i];
      pr = r;
      pi = m;
    }
  }
}

template <int NPAD, int P>
__global__ void __launch_bounds__(kMaxThreads)
ryser_complex_kernel(const double* __restrict__ Ar,
                     const double* __restrict__ Ai,
                     const double* __restrict__ xbr,
                     const double* __restrict__ xbi,
                     const double* __restrict__ c0, double* __restrict__ out,
                     uint64_t chunk_base, int n, int C_log2, int Wu_log2,
                     int num_blocks) {
  extern __shared__ double smem[];
  const int TB = blockDim.x;
  const int lane = threadIdx.x;
  const int Wu = 1 << Wu_log2;
  const int kw = Wu_log2;
  const int M = 1 << (C_log2 - Wu_log2);
  const uint64_t space = 1ull << (n - 1);

  double* Ars = smem;                                  // NPAD * NPAD
  double* Ais = Ars + NPAD * NPAD;                     // NPAD * NPAD
  double* Drs = Ais + NPAD * NPAD;                     // NPAD * (Wu - 1)
  double* Dis = Drs + NPAD * (Wu - 1);                 // NPAD * (Wu - 1)
  double* red = Dis + NPAD * (Wu - 1);                 // 4 * TB

  const int b = blockIdx.y;
  const double* Arb = Ar + (size_t)b * NPAD * NPAD;
  const double* Aib = Ai + (size_t)b * NPAD * NPAD;
  const double* xbrb = xbr + (size_t)b * NPAD;
  const double* xbib = xbi + (size_t)b * NPAD;
  for (int t = lane; t < NPAD * NPAD; t += TB) {
    const int i = t / NPAD, j = t % NPAD;
    Ars[j * NPAD + i] = Arb[t];
    Ais[j * NPAD + i] = Aib[t];
  }
  __syncthreads();
  // D = A @ cumsig per plane, once per CTA.  cumsig rows >= kw are zero and
  // its entries are 0 or 1, so each fma adds an exact product.
  for (int t = lane; t < NPAD * (Wu - 1); t += TB) {
    const int idx = t / NPAD, i = t % NPAD;
    double dr = 0.0, di = 0.0;
    for (int k = 0; k < kw; ++k) {
      const double c = c0[k * (Wu - 1) + idx];
      dr = __fma_rn(Ars[k * NPAD + i], c, dr);
      di = __fma_rn(Ais[k * NPAD + i], c, di);
    }
    Drs[idx * NPAD + i] = dr;
    Dis[idx * NPAD + i] = di;
  }
  __syncthreads();

  // ---- chunk id, start step, init X = xb + sum_j A[:, j] * graybit_j ----
  const uint64_t chunk = chunk_base + (uint64_t)blockIdx.x * TB + lane;
  const uint64_t start = chunk << C_log2;
  const uint64_t gs = start ^ (start >> 1);
  double Xr[NPAD], Xi[NPAD];
#pragma unroll
  for (int i = 0; i < NPAD; ++i) {
    Xr[i] = xbrb[i];
    Xi[i] = xbib[i];
  }
  for (int j = 0; j < n; ++j) {
    const double bit = (double)((gs >> j) & 1ull);
    const double* cr = Ars + j * NPAD;
    const double* ci = Ais + j * NPAD;
#pragma unroll
    for (int i = 0; i < NPAD; ++i) {
      Xr[i] = __fma_rn(cr[i], bit, Xr[i]);  // exact: bit is 0 or 1
      Xi[i] = __fma_rn(ci[i], bit, Xi[i]);
    }
  }

  const double* cmr = Ars + (kw - 1) * NPAD;
  const double* cmi = Ais + (kw - 1) * NPAD;
  const int mid_idx = Wu / 2 - 1;
  double sr = 0.0, cr_acc = 0.0, si = 0.0, ci_acc = 0.0;
  for (int m = 0; m < M; ++m) {
    const uint64_t macro = start + ((uint64_t)m << Wu_log2);
    // states (X + D[:, idx]) + corr, corr = cm_col * (-2 * bitk) from the mid
    // step on; X itself is advanced once per window
    const double cm = -2.0 * (double)((macro >> kw) & 1ull);
    for (int idx = 0; idx < Wu - 1; ++idx) {
      const double* Dr = Drs + idx * NPAD;
      const double* Di = Dis + idx * NPAD;
      const bool after_mid = idx >= mid_idx;
      double pr = 0.0, pi = 0.0;
#pragma unroll
      for (int i = 0; i < NPAD; ++i) {
        if (i < n) {
          double xr = Xr[i] + Dr[i];
          double xi = Xi[i] + Di[i];
          if (after_mid) {
            xr = __fma_rn(cmr[i], cm, xr);  // exact: cm is 0 or -2
            xi = __fma_rn(cmi[i], cm, xi);
          }
          if (i == 0) {
            pr = xr;
            pi = xi;
          } else {
            const double r = pr * xr - pi * xi;
            const double q = pr * xi + pi * xr;
            pr = r;
            pi = q;
          }
        }
      }
      const bool neg = ((idx + 1) & 1) != 0;
      accum_add<P>(sr, cr_acc, neg ? -pr : pr);
      accum_add<P>(si, ci_acc, neg ? -pi : pi);
    }
    const double* Drl = Drs + (Wu - 2) * NPAD;
    const double* Dil = Dis + (Wu - 2) * NPAD;
#pragma unroll
    for (int i = 0; i < NPAD; ++i) {
      Xr[i] = Xr[i] + Drl[i];
      Xr[i] = __fma_rn(cmr[i], cm, Xr[i]);
      Xi[i] = Xi[i] + Dil[i];
      Xi[i] = __fma_rn(cmi[i], cm, Xi[i]);
    }

    // ---- boundary step w = Wu: per-lane column jb, no sign on the term ----
    const uint64_t gb = macro + (uint64_t)Wu;
    const int jb = __ffsll((long long)gb) - 1;
    const uint64_t ggb = gb ^ (gb >> 1);
    const double sb = (double)(2 * (int)((ggb >> jb) & 1ull) - 1);
    const double live = (gb <= space - 1) ? 1.0 : 0.0;
    const double f = sb * live;
    const double* cbr = Ars + jb * NPAD;  // jb <= n - 1 < NPAD
    const double* cbi = Ais + jb * NPAD;
#pragma unroll
    for (int i = 0; i < NPAD; ++i) {
      Xr[i] = __fma_rn(cbr[i], f, Xr[i]);  // exact: f is 0 or +-1
      Xi[i] = __fma_rn(cbi[i], f, Xi[i]);
    }
    double pr, pi;
    chain_prod_cx<NPAD>(Xr, Xi, n, pr, pi);
    accum_add<P>(sr, cr_acc, pr * live);
    accum_add<P>(si, ci_acc, pi * live);
  }

  // ---- fixed-order lane tree over the four sums (no atomics) ----
  const bool two_limb = (P == P_DQ_ACC || P == P_DQ_FAST);
  red[lane] = sr;
  red[TB + lane] = two_limb ? cr_acc : 0.0;
  red[2 * TB + lane] = si;
  red[3 * TB + lane] = two_limb ? ci_acc : 0.0;
  __syncthreads();
  for (int stride = TB / 2; stride > 0; stride >>= 1) {
    if (lane < stride) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[q * TB + lane] = red[q * TB + lane] + red[q * TB + lane + stride];
    }
    __syncthreads();
  }
  if (lane == 0) {
    const size_t o = ((size_t)b * num_blocks + blockIdx.x) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) out[o + q] = red[q * TB];
  }
}

template <int NPAD, int P>
int launch(const double* Ar, const double* Ai, const double* xbr,
           const double* xbi, const double* c0, double* out, uint64_t base,
           int n, int TB, int C_log2, int Wu_log2, int num_blocks, int B,
           cudaStream_t stream) {
  const int Wu = 1 << Wu_log2;
  const size_t smem = sizeof(double) *
      (2 * (size_t)NPAD * NPAD + 2 * (size_t)NPAD * (Wu - 1) + 4 * (size_t)TB);
  auto kern = ryser_complex_kernel<NPAD, P>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((unsigned)num_blocks, (unsigned)B), TB, smem, stream>>>(
      Ar, Ai, xbr, xbi, c0, out, base, n, C_log2, Wu_log2, num_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// One launcher per NPAD, compiled as in ryser_dense.cu: one nvcc process per
// -DRYSER_NPAD=k and one more for the C entry points (-DRYSER_API_ONLY).
#if defined(RYSER_NPAD) == defined(RYSER_API_ONLY)
#error "define exactly one of RYSER_NPAD=k and RYSER_API_ONLY"
#endif

#define RYSER_CX_LAUNCHER_SIG(K)                                               \
  extern "C" int ryser_cx_launch_npad_##K(                                     \
      const double* Ar, const double* Ai, const double* xbr,                  \
      const double* xbi, const double* c0, double* out, uint64_t base, int n, \
      int TB, int C_log2, int Wu_log2, int num_blocks, int B, int precision,  \
      cudaStream_t stream)

#define RYSER_CX_CASE_P(K, PV)                                                 \
  case PV:                                                                     \
    return launch<K, PV>(Ar, Ai, xbr, xbi, c0, out, base, n, TB, C_log2,       \
                         Wu_log2, num_blocks, B, stream);

#define RYSER_CX_DEFINE_LAUNCHER(K)                                            \
  RYSER_CX_LAUNCHER_SIG(K) {                                                   \
    switch (precision) {                                                       \
      RYSER_CX_CASE_P(K, P_DD)                                                 \
      RYSER_CX_CASE_P(K, P_KAHAN)                                              \
      RYSER_CX_CASE_P(K, P_DQ_ACC)                                             \
      RYSER_CX_CASE_P(K, P_DQ_FAST)                                            \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }

#define RYSER_CX_EXPAND(M, K) M(K)

#if defined(RYSER_NPAD)
RYSER_CX_EXPAND(RYSER_CX_DEFINE_LAUNCHER, RYSER_NPAD)
#else
RYSER_CX_LAUNCHER_SIG(8);
RYSER_CX_LAUNCHER_SIG(16);
RYSER_CX_LAUNCHER_SIG(24);
RYSER_CX_LAUNCHER_SIG(32);
RYSER_CX_LAUNCHER_SIG(40);
RYSER_CX_LAUNCHER_SIG(48);
RYSER_CX_LAUNCHER_SIG(56);
RYSER_CX_LAUNCHER_SIG(64);

namespace {

int dispatch(const double* Ar, const double* Ai, const double* xbr,
             const double* xbi, const double* c0, double* out, uint64_t base,
             int n, int n_pad, int TB, int C_log2, int Wu_log2, int num_blocks,
             int B, int precision, void* stream) {
  if (n < 3 || n > 64 || n > n_pad || TB < 1 || TB > kMaxThreads ||
      (TB & (TB - 1)) != 0 || Wu_log2 < 1 || C_log2 < Wu_log2 ||
      num_blocks < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RYSER_CX_CASE(K)                                                       \
  case K:                                                                      \
    return ryser_cx_launch_npad_##K(Ar, Ai, xbr, xbi, c0, out, base, n, TB,    \
                                    C_log2, Wu_log2, num_blocks, B, precision, \
                                    s);
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
#endif
