// The body of mod_batch_inv (inv_kernels.cu): one column's Montgomery-trick
// inversion, one thread a column over field.cuh's core.  Shared with
// csrc/host_check.cpp, which runs it on the host.
//
// A column is rows elements at x, x + stride, ..., each 2N stored limbs.
// Forward, the inclusive prefix products P_0 .. P_(rows-2) are kept in the
// output's own rows (P_i in row i: no scratch), the total P_(rows-1) in
// registers; one Fermat inversion of the total; backward, row i's inverse
// is inv P_(i-1) (P_(i-1) read back from row i - 1, which is overwritten
// only later) and inv <- inv x_i strips x_i.  Every value is a canonical
// residue, so row i ends as x_i^-1 exactly, whatever the order of the
// products: the limbs of dkg_tpu_torch/fields/device.py batch_inv (the
// JAX package's batch_inv) over the same column.  A column holding a zero
// has a zero total, whose "inverse" is 0, and reads 0 in every row, as
// there.
//
// The Fermat inversion total^(p-2) runs the addition chain the wrapper
// derives from p (ops/field_kernels.py inv_chain), a table of ints read
// by every thread alike: chain[0] picks the first odd power, then each
// entry is a squaring (-1) or a multiply by odd power j (x^(2j+1)).  The
// odd powers x, x^3, .., x^(2 npow - 1) come first (npow - 1 multiplies
// by x^2, and x^2 itself).
#pragma once

#include "field.cuh"

namespace dkg {

constexpr int kInvMaxPowers = 16;  // the odd powers of a window of at most 5 bits

// x^e for the chain's exponent: r <- the chain over x (r may not alias x).
template <int F>
__device__ __forceinline__ void fermat_chain(uint32_t r[], const uint32_t x[], const int32_t* chain,
                                             int chain_len, int npow) {
  constexpr int N = Field<F>::N;
  uint32_t pw[kInvMaxPowers][N], t[N];
  copy<N>(pw[0], x);
  if (npow > 1) fmul<F>(t, x, x);
#pragma unroll 1
  for (int j = 1; j < npow; ++j) fmul<F>(pw[j], pw[j - 1], t);
  copy<N>(r, pw[chain[0]]);
#pragma unroll 1
  for (int c = 1; c < chain_len; ++c) {
    const int op = chain[c];
    if (op < 0) {
      copy<N>(t, r);
    } else {
      copy<N>(t, pw[op]);
    }
    fmul<F>(r, r, t);
  }
}

// The column at x (rows elements, stride limbs apart) inverted into the
// column at out (the same layout).
template <int F>
__device__ __forceinline__ void batch_inv_column(const int32_t* x, int32_t* out, int64_t rows,
                                                 int64_t stride, const int32_t* chain, int chain_len,
                                                 int npow) {
  constexpr int N = Field<F>::N;
  uint32_t acc[N], xi[N], t[N];
  load_elem<N>(x, acc);
#pragma unroll 1
  for (int64_t i = 1; i < rows; ++i) {
    store_elem<N>(out + (i - 1) * stride, acc);  // P_(i-1)
    load_elem<N>(x + i * stride, xi);
    fmul<F>(acc, acc, xi);
  }
  fermat_chain<F>(t, acc, chain, chain_len, npow);
  copy<N>(acc, t);  // the inverse of P_(rows-1)
#pragma unroll 1
  for (int64_t i = rows - 1; i >= 1; --i) {
    load_elem<N>(out + (i - 1) * stride, t);
    fmul<F>(t, acc, t);  // x_i^-1 = P_i^-1 P_(i-1)
    load_elem<N>(x + i * stride, xi);
    fmul<F>(acc, acc, xi);  // P_(i-1)^-1
    store_elem<N>(out + i * stride, t);
  }
  store_elem<N>(out, acc);
}

}  // namespace dkg
