// What the Ryser kernels share: accumulator codes, the block size cap and
// _accum_add (kernels/ryser_pallas.py), one product term into a lane's
// (s, c) accumulator.  Included by ryser_kernels.cuh, the block bodies every
// source instantiates, which also holds the row products.
#pragma once

namespace {

enum Prec { P_DD = 0, P_KAHAN = 1, P_DQ_ACC = 2, P_DQ_FAST = 3 };

constexpr int kMaxThreads = 256;

template <int P>
__device__ __forceinline__ void accum_add(double& s, double& c, double term) {
  if (P == P_KAHAN) {
    const double y = term - c;
    const double t = s + y;
    c = (t - s) - y;
    s = t;
  } else if (P == P_DQ_ACC) {
    const double hi = s + term;
    const double bp = hi - s;
    const double e = (s - (hi - bp)) + (term - bp);
    s = hi;
    c = c + e;
  } else if (P == P_DQ_FAST) {
    const double hi = s + term;
    const double bp = hi - s;
    const double e = ((s - (hi - bp)) + (term - bp)) + c;
    const double s2 = hi + e;
    c = e - (s2 - hi);
    s = s2;
  } else {
    s = s + term;  // dd, and qq (no twofloat product in the kernel)
  }
}

}  // namespace
