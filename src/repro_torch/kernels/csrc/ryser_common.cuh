// What the Ryser kernels share: accumulator codes, the block size cap, the
// entries' step-space guard, fma_rn (the correctly rounded fused op of the
// scalar type) and _accum_add (kernels/ryser_pallas.py), one product term
// into a lane's (s, c) accumulator, in the scalar type T of the body (f64,
// or f32 for the _f32 entries).  Included by
// ryser_kernels.cuh, the block bodies every source instantiates, which also
// holds the row products.
#pragma once

#include <cstdint>

namespace {

enum Prec { P_DD = 0, P_KAHAN = 1, P_DQ_ACC = 2, P_DQ_FAST = 3 };

constexpr int kMaxThreads = 256;

// The launch's chunks [base, base + num_blocks * TB) of 2^C_log2 steps lie
// in the 2^(n-1) step space, C_log2 <= n - 1 (the entries' guard, checked
// before any shift can overflow; n <= 64).
inline bool chunks_in_space(uint64_t base, int n, int TB, int C_log2,
                            int num_blocks) {
  if (C_log2 < 1 || C_log2 > n - 1 || TB < 1 || num_blocks < 1) return false;
  const uint64_t chunks = 1ull << (n - 1 - C_log2);
  return base <= chunks && (uint64_t)num_blocks * (uint64_t)TB <= chunks - base;
}

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

template <int P, typename T>
__device__ __forceinline__ void accum_add(T& s, T& c, T term) {
  if (P == P_KAHAN) {
    const T y = term - c;
    const T t = s + y;
    c = (t - s) - y;
    s = t;
  } else if (P == P_DQ_ACC) {
    const T hi = s + term;
    const T bp = hi - s;
    const T e = (s - (hi - bp)) + (term - bp);
    s = hi;
    c = c + e;
  } else if (P == P_DQ_FAST) {
    const T hi = s + term;
    const T bp = hi - s;
    const T e = ((s - (hi - bp)) + (term - bp)) + c;
    const T s2 = hi + e;
    c = e - (s2 - hi);
    s = s2;
  } else {
    s = s + term;  // dd, and qq (no twofloat product in the kernel)
  }
}

}  // namespace
