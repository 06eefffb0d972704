// The two Gray-code Ryser block bodies every kernel source instantiates:
// ryser_kernel (real) and ryser_cx_kernel (split-plane complex), each in
// f64 and in f32 (the _f32 entries: f32 and complex64 input, whose dtype
// the reference keeps through kernel, partials and epilogue).  ryser_dense.cu
// and ryser_complex.cu instantiate them with SPARSE = false, ryser_sparse.cu
// with SPARSE = true; ryser_dense.cu also instantiates the real body's
// schedmat mode (SCHED).
//
// SPARSE says where the kw = log2(Wu) low columns come from, the columns the
// window states D = low @ cumsig[:kw] and the mid correction read:
//   * false: the matrix's own columns in shared memory, A[:, :kw];
//   * true: the padded-CCS arrays (rows, vals; leading dimension n, runtime
//     maxdeg), densified once per CTA into shared U[NPAD][kw] as the TPU
//     sparse body _ryser_block_sp(_cx) does (_scatter_low_columns).
// Everything else -- the init from dense A, the inner window steps, the
// boundary column, the lane tree -- is one code path.  Within a CCS column
// the live rows are distinct, so every live U entry is one exact add to 0
// and U equals A[:, :kw]: a sparse kernel equals the dense batched mode bit
// for bit on the same matrix.
//
// Layout (the paper's GPU layout, not the Pallas block layout): one thread
// per chunk, TB threads per CTA, each running C Gray steps as M = C / Wu
// windows; A column-major in shared memory; the row sums X[NPAD] (complex:
// Xr, Xi) in registers, indexed only by a compile-time i inside #pragma
// unroll loops; native uint64_t step indices (`live`, g <= 2^(n-1) - 1, is
// exact up to n = 64); a fixed shared-memory lane tree, no atomics.
// Built with --fmad=false; the only __fma_rn sites multiply an entry of A
// by 0, +-1 or -2, where the product is exact.
//
// What bounds the bodies on the H100, and what their design does about it.
// The work is FP64 instructions: per live row and step a state add (real;
// complex 2) and the product's multiply (complex 4 multiplies and 2 adds),
// plus the mid correction's fused op on half the steps.  The product chain
// serialises the rows, one or two dependent FP64 latencies a row, so a
// warp needs other work ready beside it: the next rows' shared loads and
// states.  A branch a row (i < n) makes every row a block of its own and
// serialises those too, which left the FP64 pipe at a third of its rate.
// So both bodies run their rows without a branch (re_chain, cx_chain): rows
// past n are dropped by a select, and the compiler issues the loads and
// states ahead of the chain.  A real row gives the chain one multiply and
// little else to overlap it, so the real body also takes its inner steps
// two at a time up to NPAD 32: one pass over the rows carries two
// independent chains, each step's product and accumulation op for op and
// in order as before.  Splitting a complex chunk's rows over a lagged
// thread pair, for 16 warps at 128 registers, costs more in selects,
// unpaired loads and per-step work than the extra warps win, so a chunk
// stays on one thread; capping the real body at 128 registers (16 warps)
// spills.
//
// The sparse real body also skips the rows no window state touches.  On a
// row that none of the kw low columns reaches, D and the mid column are
// exactly +0 and the state is X[i] itself, so the host glue
// (kernels/ops.py::order_sparse_leaves) permutes each real leaf so that few
// rows are touched and those come first, each CTA reads R = 1 + the largest
// live row of its member's low columns, and one CTA-uniform switch picks
// the window loop compiled for RPAD = R rounded up to 8: rows from RPAD on
// enter each product as X[i], with no add and no correction.  This leaves
// every bit as it was: X[i] + (+0) == X[i] for every X[i] but -0, and a row
// sum is never -0.  It starts from x_i = a[i][n-1] - rowsum_i / 2 and adds
// terms a[i][j] * {0, 1}; in round to nearest a sum is -0 only when both
// addends are, x_i is -0 only when rowsum_i / 2 is +0, and such a row
// holds an entry that is +0 or positive, whose terms are too.  So the
// sparse kernels still equal their plain versions and the dense batched
// mode.
//
// The window count.  The entries refuse C > 2^(n-1) (chunks_in_space), and
// Wu >= 2, so a chunk holds M = C / Wu <= 2^(n-2) windows: at most 2^30 up
// to NPAD 32, where both bodies count them in an int, as they always did.
// A campaign chunk above NPAD 32 can hold 2^31 or more (C / Wu = 2^(n-21)
// at the default campaign spec and window, from n = 52 on), so there the
// real body steps its windows' first steps in 64 bits, one window a call
// of its window loop, and the complex body counts its windows in 64 bits.
// Of the forms tried on the card these are the ones ptxas compiles without
// a spill at NPAD 40-48 (the real body at 126-140 registers at NPAD 40,
// where a pass loop around the 32-bit loop took 166 and ran a campaign
// 1.8x slower); NPAD <= 32 keeps the 32-bit loop because every change to
// it moved ptxas there (spills at NPAD 8-24, #5 17% slower).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "ryser_common.cuh"

namespace {

enum Mode { M_BASELINE = 0, M_BATCHED = 1, M_SCHEDMAT = 2 };

// U[j * npad + r] += vals[j][d] over d in order, one thread per column
// j < kw, no atomics.  Padded entries carry row n: with n < npad they add 0
// to a padded row, which stays 0; with n == npad they lie past U and are
// skipped.
template <typename T>
__device__ __forceinline__ void scatter_low_columns(
    T* Us, const int* rows, const T* vals, int kw, int maxdeg, int npad,
    int lane, int TB) {
  for (int j = lane; j < kw; j += TB) {
    for (int d = 0; d < maxdeg; ++d) {
      const int r = rows[j * maxdeg + d];
      if ((unsigned)r < (unsigned)npad) Us[j * npad + r] += vals[j * maxdeg + d];
    }
  }
}

// Ds[idx][i] = sum_{k < kw} low[k][i] * cumsig[k][idx] in ascending k from
// 0, once per CTA.  cumsig rows >= kw are zero and its entries are 0 or 1,
// so each fma adds an exact product.
template <typename T, int NPAD>
__device__ __forceinline__ void window_states(T* Ds, const T* low,
                                              const T* c0, int kw,
                                              int Wu, int lane, int TB) {
  for (int t = lane; t < NPAD * (Wu - 1); t += TB) {
    const int idx = t / NPAD, i = t % NPAD;
    T acc = 0;
    for (int k = 0; k < kw; ++k)
      acc = fma_rn(low[k * NPAD + i], c0[k * (Wu - 1) + idx], acc);  // torchlint: disable=PC003 exact: c0 entries are 0 or 1
    Ds[idx * NPAD + i] = acc;
  }
}

// The schedmat mode's signed schedule columns, C0 = A @ Sel (n_pad, Wu-1)
// row-major as the wrapper builds them, into Ds[idx][i], once per CTA.
template <typename T, int NPAD>
__device__ __forceinline__ void sched_columns(T* Ds, const T* c0, int Wu,
                                              int lane, int TB) {
  for (int t = lane; t < NPAD * (Wu - 1); t += TB) {
    const int idx = t / NPAD, i = t % NPAD;
    Ds[idx * NPAD + i] = c0[i * (Wu - 1) + idx];
  }
}

// Where the state of row i of a real step comes from: X[i] + D[i][idx]
// before the window's mid step, plus the mid correction col_mid[i] * cm from
// it on; X[i] itself, advanced beforehand (the boundary step); or X[i]
// advanced in place by the step's signed column (the baseline mode); or
// X[i] advanced in place by the step's signed schedule column C0[i][idx],
// and at the mid step also by col_mid[i] * cm (the schedmat mode).
enum ReState { RE_WINDOW = 0, RE_WINDOW_CORR = 1, RE_X = 2, RE_STEP = 3,
               RE_SCHED = 4, RE_SCHED_MID = 5 };

// The real products of K consecutive steps over rows 0..n-1, in one pass
// over the rows: p[k] = step k's state of row 0, then p[k] <- p[k] * state.
// Each product is the plain version's chain op for op; K = 2 gives the warp
// two independent chains to issue.  src[k] is step k's window states
// (RE_WINDOW*) or column (RE_STEP, sign f[k]; steps in order).  Rows from
// RPAD on take X[i] itself in the window states (the sparse body's
// untouched rows).  No branch splits the rows (ROW_BRANCHES false), so the
// compiler runs their loads and states ahead of the chains: rows below
// LIVE_FROM are live (i < n) by the caller's promise, and a later row past
// n has its product computed and dropped by select -- never a multiply by a
// padded row's 1, which could flip the sign of a zero.  With ROW_BRANCHES
// each row's product sits behind its own i < n branch.
template <typename T, int NPAD, int STATE, int RPAD, int K, int LIVE_FROM,
          bool ROW_BRANCHES>
__device__ __forceinline__ void re_chain(T (&X)[NPAD],
                                         const T* const (&src)[K],
                                         const T (&f)[K],
                                         const T* cmc, T cm, int n,
                                         T (&p)[K]) {
#pragma unroll
  for (int i = 0; i < NPAD; ++i) {
    T x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (STATE == RE_STEP) {
        X[i] = fma_rn(src[k][i], f[k], X[i]);  // torchlint: disable=PC003 exact: f is +-1
        x[k] = X[i];
      } else if (STATE == RE_SCHED || STATE == RE_SCHED_MID) {
        X[i] = X[i] + src[k][i];
        if (STATE == RE_SCHED_MID) X[i] = fma_rn(cmc[i], cm, X[i]);  // torchlint: disable=PC003 exact: cm is 0 or -2
        x[k] = X[i];
      } else {
        x[k] = X[i];
        if (STATE != RE_X && i < RPAD) {
          x[k] = x[k] + src[k][i];
          if (STATE == RE_WINDOW_CORR) x[k] = fma_rn(cmc[i], cm, x[k]);  // torchlint: disable=PC003 exact: cm is 0 or -2
        }
      }
    }
    if (ROW_BRANCHES && i >= n) continue;
    const bool live = ROW_BRANCHES || i < LIVE_FROM || i < n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (i == 0) {
        p[k] = x[k];
      } else {
        const T q = p[k] * x[k];
        p[k] = live ? q : p[k];
      }
    }
  }
}

// re_chain for any n, as cx_chain_rows: up to NPAD 32 the rows run
// branch-free -- all unconditional when n == NPAD, those below NPAD - 8
// when n > NPAD - 8 (every caller pads to the least multiple of 8 >= n), a
// select on every row otherwise; above NPAD 32 each row keeps its branch.
template <typename T, int NPAD, int STATE, int RPAD, int K>
__device__ __forceinline__ void re_chain_rows(T (&X)[NPAD],
                                              const T* const (&src)[K],
                                              const T (&f)[K],
                                              const T* cmc, T cm,
                                              int n, T (&p)[K]) {
  if constexpr (NPAD > 32)
    re_chain<T, NPAD, STATE, RPAD, K, 0, true>(X, src, f, cmc, cm, n, p);
  else if (n == NPAD)
    re_chain<T, NPAD, STATE, RPAD, K, NPAD, false>(X, src, f, cmc, cm, n, p);
  else if (n > NPAD - 8)
    re_chain<T, NPAD, STATE, RPAD, K, NPAD - 8, false>(X, src, f, cmc, cm, n,
                                                       p);
  else
    re_chain<T, NPAD, STATE, RPAD, K, 0, false>(X, src, f, cmc, cm, n, p);
}

// K window steps idx.. from their states into (s_acc, c_acc), in order.
template <typename T, int NPAD, int P, int STATE, int RPAD, int K>
__device__ __forceinline__ void window_steps(T (&X)[NPAD],
                                             const T* Ds, int idx,
                                             const T* col_mid, T cm,
                                             int n, T& s_acc,
                                             T& c_acc) {
  const T* src[K];
  T f[K], p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    src[k] = Ds + (idx + k) * NPAD;
    f[k] = 0;
  }
  re_chain_rows<T, NPAD, STATE, RPAD, K>(X, src, f, col_mid, cm, n, p);
#pragma unroll
  for (int k = 0; k < K; ++k)
    accum_add<P>(s_acc, c_acc, ((idx + k + 1) & 1) ? -p[k] : p[k]);
}

// K baseline steps w.. (X advanced in place) into (s_acc, c_acc), in order.
template <typename T, int NPAD, int P, int K>
__device__ __forceinline__ void baseline_steps(T (&X)[NPAD],
                                               const T* As, int w,
                                               int kw, T mid_flip, int n,
                                               T& s_acc, T& c_acc) {
  const T* src[K];
  T f[K], p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int wk = w + k;
    const int j = __ffs(wk) - 1;
    // host-constant sign, except the mid step's per-lane flip
    f[k] = (j + 1 < kw) ? (T)(2 * (((wk >> j) ^ (wk >> (j + 1))) & 1) - 1)
                        : mid_flip;
    src[k] = As + j * NPAD;
  }
  re_chain_rows<T, NPAD, RE_STEP, NPAD, K>(X, src, f, nullptr, T(0), n, p);
#pragma unroll
  for (int k = 0; k < K; ++k)
    accum_add<P>(s_acc, c_acc, ((w + k) & 1) ? -p[k] : p[k]);
}

// The M windows of one chunk from X (its start state) into (s_acc, c_acc),
// the inner steps K at a time: two up to NPAD 32, so each pass over the
// rows issues two independent product chains; one above, where a second
// chain spills (600-700 B at NPAD 64).  Rows from RPAD on are untouched by
// D and col_mid (RPAD = NPAD unless the sparse body found fewer rows in its
// low columns): they neither take the window states nor advance with them.
template <typename T, int NPAD, int P, bool SPARSE, int RPAD>
__device__ __forceinline__ void real_windows(
    T (&X)[NPAD], const T* As, const T* Ds,
    const T* col_mid, uint64_t start, int M, int Wu_log2, int n,
    bool batched, T& s_acc, T& c_acc) {
  const int Wu = 1 << Wu_log2;
  const int kw = Wu_log2;
  const int mid_idx = Wu / 2 - 1;
  const uint64_t space = 1ull << (n - 1);
  constexpr int K = NPAD <= 32 ? 2 : 1;
  for (int m = 0; m < M; ++m) {
    if constexpr (SPARSE) {
      // With the mode fixed at compile time the compiler hoists the
      // window-invariant columns col_mid and D[:, Wu-2] out of this loop
      // into 4 NPAD more registers (232 at NPAD 32, spills from NPAD 40);
      // the barrier keeps the dense kernel's reload from shared memory.
      asm volatile("" ::: "memory");
    }
    const uint64_t macro = start + ((uint64_t)m << Wu_log2);
    const T bitk = (T)((macro >> kw) & 1ull);
    if (!batched) {
      const T mid_flip = T(1) - T(2) * bitk;
      int w = 1;
      for (; w + K - 1 < Wu; w += K)
        baseline_steps<T, NPAD, P, K>(X, As, w, kw, mid_flip, n, s_acc,
                                      c_acc);
      if constexpr (K == 2)     // Wu - 1 steps: one is left
        baseline_steps<T, NPAD, P, 1>(X, As, w, kw, mid_flip, n, s_acc,
                                      c_acc);
    } else {
      // states (X + D[:, idx]) + corr, corr = col_mid * (-2 * bitk) from the
      // mid step on; X itself is advanced once per window
      const T cm = T(-2) * bitk;
      if constexpr (K == 1) {
        // one loop over the steps: split in two as below, the sparse
        // NPAD 40-64 instantiations took 43-74 more registers and spilled
        // at NPAD 56-64
        for (int idx = 0; idx < Wu - 1; ++idx) {
          if (idx >= mid_idx)
            window_steps<T, NPAD, P, RE_WINDOW_CORR, RPAD, 1>(
                X, Ds, idx, col_mid, cm, n, s_acc, c_acc);
          else
            window_steps<T, NPAD, P, RE_WINDOW, RPAD, 1>(X, Ds, idx, col_mid,
                                                      cm, n, s_acc, c_acc);
        }
      } else {
        int idx = 0;
        for (; idx + 1 < mid_idx; idx += 2)
          window_steps<T, NPAD, P, RE_WINDOW, RPAD, 2>(X, Ds, idx, col_mid, cm,
                                                    n, s_acc, c_acc);
        if (idx < mid_idx)
          window_steps<T, NPAD, P, RE_WINDOW, RPAD, 1>(X, Ds, idx++, col_mid, cm,
                                                    n, s_acc, c_acc);
        for (; idx + 1 < Wu - 1; idx += 2)
          window_steps<T, NPAD, P, RE_WINDOW_CORR, RPAD, 2>(X, Ds, idx, col_mid,
                                                         cm, n, s_acc, c_acc);
        if (idx < Wu - 1)
          window_steps<T, NPAD, P, RE_WINDOW_CORR, RPAD, 1>(X, Ds, idx, col_mid,
                                                         cm, n, s_acc, c_acc);
      }
      const T* Dl = Ds + (Wu - 2) * NPAD;
#pragma unroll
      for (int i = 0; i < RPAD; ++i) {
        X[i] = X[i] + Dl[i];
        X[i] = fma_rn(col_mid[i], cm, X[i]);  // torchlint: disable=PC003 exact: cm is 0 or -2
      }
    }

    // ---- boundary step w = Wu: per-lane column jb, no sign on the term ----
    const uint64_t gb = macro + (uint64_t)Wu;
    const int jb = __ffsll((long long)gb) - 1;
    const uint64_t ggb = gb ^ (gb >> 1);
    const T sb = (T)(2 * (int)((ggb >> jb) & 1ull) - 1);
    const T live = (gb <= space - 1) ? T(1) : T(0);
    const T f = sb * live;
    const T* colb = As + jb * NPAD;  // jb <= n - 1 < NPAD
#pragma unroll
    for (int i = 0; i < NPAD; ++i) X[i] = fma_rn(colb[i], f, X[i]);  // torchlint: disable=PC003 exact: f is 0 or +-1
    // a separate pass: folded into the chain as an RE_STEP, ptxas takes
    // 174 registers at NPAD 32 (8 warps/SM) and spills at NPAD 24 and 64
    const T* none[1] = {nullptr};
    T p[1];
    re_chain_rows<T, NPAD, RE_X, NPAD, 1>(X, none, {T(0)}, nullptr, T(0), n,
                                          p);
    accum_add<P>(s_acc, c_acc, p[0] * live);
  }
}

// The M windows of one chunk in the schedmat mode (_ryser_block's schedmat
// arm): an inner step adds its signed schedule column C0[:, idx] (Ds, from
// the wrapper's A @ Sel) to X in place, the mid step also col_mid * cm with
// cm = -2 bitk, then takes the product; the inner steps run two at a time
// up to NPAD 32 (the mid step alone), as the baseline mode's do, and one
// at a time in one loop above, as the batched mode's do there (split
// around the mid step, NPAD 40-48 took 236 registers and spilled).  The
// boundary step is real_windows' own, written out again here so that the
// baseline and batched modes' window loop stays the code it was.
template <typename T, int NPAD, int P>
__device__ __forceinline__ void sched_windows(
    T (&X)[NPAD], const T* As, const T* Ds, const T* col_mid, uint64_t start,
    int M, int Wu_log2, int n, T& s_acc, T& c_acc) {
  const int Wu = 1 << Wu_log2;
  const int kw = Wu_log2;
  const int mid_idx = Wu / 2 - 1;
  const uint64_t space = 1ull << (n - 1);
  constexpr int K = NPAD <= 32 ? 2 : 1;
  for (int m = 0; m < M; ++m) {
    const uint64_t macro = start + ((uint64_t)m << Wu_log2);
    const T cm = T(-2) * (T)((macro >> kw) & 1ull);
    if constexpr (K == 1) {
      for (int idx = 0; idx < Wu - 1; ++idx) {
        if (idx == mid_idx)
          window_steps<T, NPAD, P, RE_SCHED_MID, NPAD, 1>(X, Ds, idx, col_mid,
                                                          cm, n, s_acc,
                                                          c_acc);
        else
          window_steps<T, NPAD, P, RE_SCHED, NPAD, 1>(X, Ds, idx, col_mid,
                                                      cm, n, s_acc, c_acc);
      }
    } else {
      int idx = 0;
      for (; idx + 1 < mid_idx; idx += 2)
        window_steps<T, NPAD, P, RE_SCHED, NPAD, 2>(X, Ds, idx, col_mid, cm,
                                                    n, s_acc, c_acc);
      if (idx < mid_idx)
        window_steps<T, NPAD, P, RE_SCHED, NPAD, 1>(X, Ds, idx++, col_mid,
                                                    cm, n, s_acc, c_acc);
      window_steps<T, NPAD, P, RE_SCHED_MID, NPAD, 1>(X, Ds, idx++, col_mid,
                                                      cm, n, s_acc, c_acc);
      for (; idx + 1 < Wu - 1; idx += 2)
        window_steps<T, NPAD, P, RE_SCHED, NPAD, 2>(X, Ds, idx, col_mid, cm,
                                                    n, s_acc, c_acc);
      if (idx < Wu - 1)
        window_steps<T, NPAD, P, RE_SCHED, NPAD, 1>(X, Ds, idx, col_mid, cm,
                                                    n, s_acc, c_acc);
    }

    // ---- boundary step w = Wu: per-lane column jb, no sign on the term ----
    const uint64_t gb = macro + (uint64_t)Wu;
    const int jb = __ffsll((long long)gb) - 1;
    const uint64_t ggb = gb ^ (gb >> 1);
    const T sb = (T)(2 * (int)((ggb >> jb) & 1ull) - 1);
    const T live = (gb <= space - 1) ? T(1) : T(0);
    const T f = sb * live;
    const T* colb = As + jb * NPAD;  // jb <= n - 1 < NPAD
#pragma unroll
    for (int i = 0; i < NPAD; ++i) X[i] = fma_rn(colb[i], f, X[i]);  // torchlint: disable=PC003 exact: f is 0 or +-1
    const T* none[1] = {nullptr};
    T p[1];
    re_chain_rows<T, NPAD, RE_X, NPAD, 1>(X, none, {T(0)}, nullptr, T(0), n,
                                          p);
    accum_add<P>(s_acc, c_acc, p[0] * live);
  }
}

// The sparse body's CTA-uniform switch on R, the rows its low columns
// touch: the window loop compiled for RPAD, the least multiple of 8 >= R,
// found by a chain of uniform branches from RPAD = 8 up.
template <typename T, int NPAD, int P, int RPAD>
__device__ __forceinline__ void sparse_windows(
    int R, T (&X)[NPAD], const T* As, const T* Ds, const T* col_mid,
    uint64_t start, int M, int Wu_log2, int n, T& s_acc, T& c_acc) {
  if constexpr (RPAD >= NPAD) {
    real_windows<T, NPAD, P, true, NPAD>(X, As, Ds, col_mid, start, M,
                                         Wu_log2, n, true, s_acc, c_acc);
  } else {
    if (R <= RPAD)
      real_windows<T, NPAD, P, true, RPAD>(X, As, Ds, col_mid, start, M,
                                           Wu_log2, n, true, s_acc, c_acc);
    else
      sparse_windows<T, NPAD, P, RPAD + 8>(R, X, As, Ds, col_mid, start, M,
                                           Wu_log2, n, s_acc, c_acc);
  }
}

// The real block body.  T is the scalar type: double, or float for the
// f32 input of the dense and sparse entries (the reference's dtype follows
// its input).  SCHED instantiates the schedmat
// mode (the scalar dense entry only), whose window loop is its own, so the
// other instantiations keep their code; mode picks baseline or batched.
template <int NPAD, int P, bool SPARSE, typename T = double,
          bool SCHED = false>
__global__ void __launch_bounds__(kMaxThreads)
ryser_kernel(const T* __restrict__ A, const int* __restrict__ rows,
             const T* __restrict__ vals, const T* __restrict__ xb,
             const T* __restrict__ c0, T* __restrict__ out,
             uint64_t chunk_base, int n, int maxdeg, int C_log2, int Wu_log2,
             int num_blocks, int mode) {
  static_assert(!SPARSE || !SCHED, "the sparse body is batched mode only");
  extern __shared__ double smem[];
  const int TB = blockDim.x;
  const int lane = threadIdx.x;
  const int Wu = 1 << Wu_log2;
  const int kw = Wu_log2;
  // windows a call of the window loop: the chunk's all up to NPAD 32, one
  // above (the chunk's windows stepped in 64 bits there)
  const int M = 1 << (NPAD <= 32 ? C_log2 - Wu_log2 : 0);
  const bool batched = SPARSE || mode == M_BATCHED;    // sparse: batched only

  T* As = reinterpret_cast<T*>(smem);                  // NPAD * NPAD
  T* Us = As + NPAD * NPAD;                            // NPAD * kw if SPARSE
  T* Ds = Us + (SPARSE ? NPAD * kw : 0);               // NPAD * (Wu - 1)
  T* red = Ds + (batched || SCHED ? NPAD * (Wu - 1) : 0);  // 2 * TB
  int* Rs = reinterpret_cast<int*>(red + 2 * TB);      // kw if SPARSE
  const T* low = SPARSE ? Us : As;                     // the kw low columns

  const int b = blockIdx.y;
  const T* Ab = A + (size_t)b * NPAD * NPAD;
  const T* xbb = xb + (size_t)b * NPAD;
  for (int t = lane; t < NPAD * NPAD; t += TB) {
    const int i = t / NPAD, j = t % NPAD;
    As[j * NPAD + i] = Ab[t];
  }
  if constexpr (SPARSE) {
    const int* rb = rows + (size_t)b * n * maxdeg;
    for (int t = lane; t < NPAD * kw; t += TB) Us[t] = T(0);
    __syncthreads();
    scatter_low_columns(Us, rb, vals + (size_t)b * n * maxdeg, kw, maxdeg,
                        NPAD, lane, TB);
    // R of each low column: 1 + its largest live row (0 if it has none)
    for (int j = lane; j < kw; j += TB) {
      int r1 = 0;
      for (int d = 0; d < maxdeg; ++d) {
        const int r = rb[j * maxdeg + d];
        if (r < n) r1 = max(r1, r + 1);
      }
      Rs[j] = r1;
    }
  }
  if (batched) {
    __syncthreads();
    window_states<T, NPAD>(Ds, low, c0, kw, Wu, lane, TB);
  }
  if constexpr (SCHED) sched_columns<T, NPAD>(Ds, c0, Wu, lane, TB);
  __syncthreads();

  // ---- chunk id, start step, init X = xb + sum_j A[:, j] * graybit_j ----
  const uint64_t chunk = chunk_base + (uint64_t)blockIdx.x * TB + lane;
  const uint64_t start = chunk << C_log2;
  [[maybe_unused]] const uint64_t stop = start + (1ull << C_log2);  // <= 2^63
  const uint64_t gs = start ^ (start >> 1);
  T X[NPAD];
#pragma unroll
  for (int i = 0; i < NPAD; ++i) X[i] = xbb[i];
  for (int j = 0; j < n; ++j) {
    const T bit = (T)((gs >> j) & 1ull);
    const T* col = As + j * NPAD;
#pragma unroll
    for (int i = 0; i < NPAD; ++i) X[i] = fma_rn(col[i], bit, X[i]);  // torchlint: disable=PC003 exact: bit is 0 or 1
  }

  const T* col_mid = low + (kw - 1) * NPAD;
  T s_acc = 0, c_acc = 0;
  if constexpr (SPARSE) {
    int R = 0;                  // every thread, the same fixed order
    for (int j = 0; j < kw; ++j) R = max(R, Rs[j]);
    if constexpr (NPAD <= 32)
      sparse_windows<T, NPAD, P, 8>(R, X, As, Ds, col_mid, start, M, Wu_log2,
                                    n, s_acc, c_acc);
    else
      for (uint64_t macro = start; macro < stop; macro += (uint64_t)Wu)
        sparse_windows<T, NPAD, P, 8>(R, X, As, Ds, col_mid, macro, M,
                                      Wu_log2, n, s_acc, c_acc);
  } else if constexpr (SCHED) {
    if constexpr (NPAD <= 32)
      sched_windows<T, NPAD, P>(X, As, Ds, col_mid, start, M, Wu_log2, n,
                                s_acc, c_acc);
    else
      for (uint64_t macro = start; macro < stop; macro += (uint64_t)Wu)
        sched_windows<T, NPAD, P>(X, As, Ds, col_mid, macro, M, Wu_log2, n,
                                  s_acc, c_acc);
  } else {
    if constexpr (NPAD <= 32)
      real_windows<T, NPAD, P, false, NPAD>(X, As, Ds, col_mid, start, M,
                                            Wu_log2, n, batched, s_acc,
                                            c_acc);
    else
      for (uint64_t macro = start; macro < stop; macro += (uint64_t)Wu)
        real_windows<T, NPAD, P, false, NPAD>(X, As, Ds, col_mid, macro, M,
                                              Wu_log2, n, batched, s_acc,
                                              c_acc);
  }

  // ---- fixed-order lane tree over hi and lo (no atomics) ----
  const bool two_limb = (P == P_DQ_ACC || P == P_DQ_FAST);
  red[lane] = s_acc;
  red[TB + lane] = two_limb ? c_acc : T(0);
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

// Where the state of row i of a complex step comes from: X[i] + D[i][idx]
// before the window's mid step, plus the mid correction cm_col[i] * cm from
// it on, or X[i] itself at the boundary step (X advanced beforehand).
enum CxState { CX_WINDOW = 0, CX_WINDOW_CORR = 1, CX_X = 2 };

// One complex product over rows 0..n-1 of a step's states:
// (pr, pi) = row 0's state, then (pr, pi) <- (pr*xr - pi*xi, pr*xi + pi*xr).
// No branch splits the rows (ROW_BRANCHES false), so the compiler runs
// their loads and states ahead of the chain: rows below LIVE_FROM are live
// (i < n) by the caller's promise, and a later row past n has its product
// computed and dropped by select -- never a multiply by a padded row's
// 1 + 0i, which could flip the sign of a zero.  With ROW_BRANCHES each row
// sits behind its own i < n branch, which keeps every row's loads and
// states in place: fewer registers, no overlap.
template <typename T, int NPAD, int STATE, int LIVE_FROM, bool ROW_BRANCHES>
__device__ __forceinline__ void cx_chain(
    const T (&Xr)[NPAD], const T (&Xi)[NPAD], const T* Dr, const T* Di,
    const T* cmr, const T* cmi, T cm, int n, T& pr, T& pi) {
  if constexpr (NPAD == 8) {
    // keeps the step's loads after the previous step's accumulation: with
    // them hoisted, ptxas fits the sparse instantiation into 128 registers
    // and spills 48-60 B; fenced, it takes 79 and none
    asm volatile("" ::: "memory");
  }
#pragma unroll
  for (int i = 0; i < NPAD; ++i) {
    if (ROW_BRANCHES && i >= n) continue;
    T xr = Xr[i], xi = Xi[i];
    if (STATE != CX_X) {
      xr = xr + Dr[i];
      xi = xi + Di[i];
    }
    if (STATE == CX_WINDOW_CORR) {
      xr = fma_rn(cmr[i], cm, xr);  // torchlint: disable=PC003 exact: cm is 0 or -2
      xi = fma_rn(cmi[i], cm, xi);  // torchlint: disable=PC003 exact: cm is 0 or -2
    }
    if (i == 0) {
      pr = xr;
      pi = xi;
      continue;
    }
    const T r = pr * xr - pi * xi;
    const T q = pr * xi + pi * xr;
    const bool live = ROW_BRANCHES || i < LIVE_FROM || i < n;
    pr = live ? r : pr;
    pi = live ? q : pi;
  }
}

// cx_chain for any n.  Up to NPAD 32 (the main path's sizes) the rows run
// branch-free, those below NPAD - 8 unconditional when n > NPAD - 8 (n_pad
// the least multiple of 8 >= n, as every caller pads).  Above NPAD 32
// (campaign sizes, where X alone takes 4 NPAD registers and rows run ahead
// would spill) each row keeps its branch -- in f64.  f32 planes take half
// the registers, so their rows run branch-free up to NPAD 48: with a
// branch a row, ptxas fits the f32 NPAD 40 instantiations into 128
// registers and spills 12-48 B; branch-free they take 134-144 and none.
template <typename T, int NPAD, int STATE>
__device__ __forceinline__ void cx_chain_rows(
    const T (&Xr)[NPAD], const T (&Xi)[NPAD], const T* Dr, const T* Di,
    const T* cmr, const T* cmi, T cm, int n, T& pr, T& pi) {
  if constexpr (NPAD > (sizeof(T) == 8 ? 32 : 48))
    cx_chain<T, NPAD, STATE, 0, true>(Xr, Xi, Dr, Di, cmr, cmi, cm, n, pr,
                                      pi);
  else if (n > NPAD - 8)
    cx_chain<T, NPAD, STATE, NPAD - 8, false>(Xr, Xi, Dr, Di, cmr, cmi, cm, n,
                                              pr, pi);
  else
    cx_chain<T, NPAD, STATE, 0, false>(Xr, Xi, Dr, Di, cmr, cmi, cm, n, pr,
                                       pi);
}

// The split-plane body runs the window-batched mode only, as the Pallas
// complex kernels do.  An inner step streams the product row by row from
// Xr[i] + Dr[i][idx] (+ cm_r[i] * corr), never materialising the state.
// T is the planes' scalar type: double, or float for complex64 input (the
// reference keeps f32 planes for it).
template <int NPAD, int P, bool SPARSE, typename T = double>
__global__ void __launch_bounds__(kMaxThreads)
ryser_cx_kernel(const T* __restrict__ Ar, const T* __restrict__ Ai,
                const int* __restrict__ rows, const T* __restrict__ vals_r,
                const T* __restrict__ vals_i, const T* __restrict__ xbr,
                const T* __restrict__ xbi, const T* __restrict__ c0,
                T* __restrict__ out, uint64_t chunk_base, int n, int maxdeg,
                int C_log2, int Wu_log2, int num_blocks) {
  extern __shared__ double smem[];
  const int TB = blockDim.x;
  const int lane = threadIdx.x;
  const int Wu = 1 << Wu_log2;
  const int kw = Wu_log2;
  // the window count: 32 bits up to NPAD 32, 64 above
  using Count = std::conditional_t<(NPAD <= 32), int, uint64_t>;
  const Count M = Count(1) << (C_log2 - Wu_log2);
  const uint64_t space = 1ull << (n - 1);

  T* Ars = reinterpret_cast<T*>(smem);                 // NPAD * NPAD
  T* Ais = Ars + NPAD * NPAD;                          // NPAD * NPAD
  T* Urs = Ais + NPAD * NPAD;                          // NPAD * kw if SPARSE
  T* Uis = Urs + (SPARSE ? NPAD * kw : 0);             // NPAD * kw if SPARSE
  T* Drs = Uis + (SPARSE ? NPAD * kw : 0);             // NPAD * (Wu - 1)
  T* Dis = Drs + NPAD * (Wu - 1);                      // NPAD * (Wu - 1)
  T* red = Dis + NPAD * (Wu - 1);                      // 4 * TB
  const T* low_r = SPARSE ? Urs : Ars;                 // the kw low columns
  const T* low_i = SPARSE ? Uis : Ais;

  const int b = blockIdx.y;
  const T* Arb = Ar + (size_t)b * NPAD * NPAD;
  const T* Aib = Ai + (size_t)b * NPAD * NPAD;
  const int* rb = rows + (size_t)b * n * maxdeg;       // maxdeg 0 if dense
  const T* vrb = vals_r + (size_t)b * n * maxdeg;
  const T* vib = vals_i + (size_t)b * n * maxdeg;
  const T* xbrb = xbr + (size_t)b * NPAD;
  const T* xbib = xbi + (size_t)b * NPAD;
  for (int t = lane; t < NPAD * NPAD; t += TB) {
    const int i = t / NPAD, j = t % NPAD;
    Ars[j * NPAD + i] = Arb[t];
    Ais[j * NPAD + i] = Aib[t];
  }
  if constexpr (SPARSE) {
    for (int t = lane; t < NPAD * kw; t += TB) {
      Urs[t] = T(0);
      Uis[t] = T(0);
    }
    __syncthreads();
    scatter_low_columns(Urs, rb, vrb, kw, maxdeg, NPAD, lane, TB);
    scatter_low_columns(Uis, rb, vib, kw, maxdeg, NPAD, lane, TB);
  }
  __syncthreads();
  // D = low @ cumsig per plane.  The sparse instantiation keeps one helper
  // pass per plane: with the dense instantiation's fused pass ptxas spills
  // it at NPAD 8 (dq_fast) and NPAD 48.
  if constexpr (SPARSE) {
    window_states<T, NPAD>(Drs, low_r, c0, kw, Wu, lane, TB);
    window_states<T, NPAD>(Dis, low_i, c0, kw, Wu, lane, TB);
  } else {
    for (int t = lane; t < NPAD * (Wu - 1); t += TB) {
      const int idx = t / NPAD, i = t % NPAD;
      T dr = 0, di = 0;
      for (int k = 0; k < kw; ++k) {
        const T c = c0[k * (Wu - 1) + idx];
        dr = fma_rn(low_r[k * NPAD + i], c, dr);  // torchlint: disable=PC003 exact: c (a cumsig entry) is 0 or 1
        di = fma_rn(low_i[k * NPAD + i], c, di);  // torchlint: disable=PC003 exact: c (a cumsig entry) is 0 or 1
      }
      Drs[idx * NPAD + i] = dr;
      Dis[idx * NPAD + i] = di;
    }
  }
  __syncthreads();

  // ---- chunk id, start step, init X = xb + sum_j A[:, j] * graybit_j ----
  const uint64_t chunk = chunk_base + (uint64_t)blockIdx.x * TB + lane;
  const uint64_t start = chunk << C_log2;
  const uint64_t gs = start ^ (start >> 1);
  T Xr[NPAD], Xi[NPAD];
#pragma unroll
  for (int i = 0; i < NPAD; ++i) {
    Xr[i] = xbrb[i];
    Xi[i] = xbib[i];
  }
  for (int j = 0; j < n; ++j) {
    const T bit = (T)((gs >> j) & 1ull);
    const T* cr = Ars + j * NPAD;
    const T* ci = Ais + j * NPAD;
#pragma unroll
    for (int i = 0; i < NPAD; ++i) {
      Xr[i] = fma_rn(cr[i], bit, Xr[i]);  // torchlint: disable=PC003 exact: bit is 0 or 1
      Xi[i] = fma_rn(ci[i], bit, Xi[i]);  // torchlint: disable=PC003 exact: bit is 0 or 1
    }
  }

  const T* cmr = low_r + (kw - 1) * NPAD;
  const T* cmi = low_i + (kw - 1) * NPAD;
  const int mid_idx = Wu / 2 - 1;
  T sr = 0, cr_acc = 0, si = 0, ci_acc = 0;
  for (Count m = 0; m < M; ++m) {
    const uint64_t macro = start + ((uint64_t)m << Wu_log2);
    // states (X + D[:, idx]) + corr, corr = cm_col * (-2 * bitk) from the mid
    // step on; X itself is advanced once per window
    const T cm = T(-2) * (T)((macro >> kw) & 1ull);
    for (int idx = 0; idx < Wu - 1; ++idx) {
      const T* Dr = Drs + idx * NPAD;
      const T* Di = Dis + idx * NPAD;
      T pr, pi;
      if (idx >= mid_idx)
        cx_chain_rows<T, NPAD, CX_WINDOW_CORR>(Xr, Xi, Dr, Di, cmr, cmi, cm,
                                               n, pr, pi);
      else
        cx_chain_rows<T, NPAD, CX_WINDOW>(Xr, Xi, Dr, Di, cmr, cmi, cm, n, pr,
                                          pi);
      const bool neg = ((idx + 1) & 1) != 0;
      accum_add<P>(sr, cr_acc, neg ? -pr : pr);
      accum_add<P>(si, ci_acc, neg ? -pi : pi);
    }
    const T* Drl = Drs + (Wu - 2) * NPAD;
    const T* Dil = Dis + (Wu - 2) * NPAD;
#pragma unroll
    for (int i = 0; i < NPAD; ++i) {
      Xr[i] = Xr[i] + Drl[i];
      Xr[i] = fma_rn(cmr[i], cm, Xr[i]);  // torchlint: disable=PC003 exact: cm is 0 or -2
      Xi[i] = Xi[i] + Dil[i];
      Xi[i] = fma_rn(cmi[i], cm, Xi[i]);  // torchlint: disable=PC003 exact: cm is 0 or -2
    }

    // ---- boundary step w = Wu: per-lane column jb, no sign on the term ----
    const uint64_t gb = macro + (uint64_t)Wu;
    const int jb = __ffsll((long long)gb) - 1;
    const uint64_t ggb = gb ^ (gb >> 1);
    const T sb = (T)(2 * (int)((ggb >> jb) & 1ull) - 1);
    const T live = (gb <= space - 1) ? T(1) : T(0);
    const T f = sb * live;
    const T* cbr = Ars + jb * NPAD;  // jb <= n - 1 < NPAD
    const T* cbi = Ais + jb * NPAD;
#pragma unroll
    for (int i = 0; i < NPAD; ++i) {
      Xr[i] = fma_rn(cbr[i], f, Xr[i]);  // torchlint: disable=PC003 exact: f is 0 or +-1
      Xi[i] = fma_rn(cbi[i], f, Xi[i]);  // torchlint: disable=PC003 exact: f is 0 or +-1
    }
    T pr, pi;
    cx_chain_rows<T, NPAD, CX_X>(Xr, Xi, nullptr, nullptr, nullptr, nullptr,
                                 T(0), n, pr, pi);
    accum_add<P>(sr, cr_acc, pr * live);
    accum_add<P>(si, ci_acc, pi * live);
  }

  // ---- fixed-order lane tree over the four sums (no atomics) ----
  const bool two_limb = (P == P_DQ_ACC || P == P_DQ_FAST);
  red[lane] = sr;
  red[TB + lane] = two_limb ? cr_acc : T(0);
  red[2 * TB + lane] = si;
  red[3 * TB + lane] = two_limb ? ci_acc : T(0);
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

// Opt in above 48 KB of dynamic shared memory, then launch grid
// (num_blocks, B) of TB threads.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kern, size_t smem, int num_blocks, int B, int TB,
                  cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((unsigned)num_blocks, (unsigned)B), TB, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
