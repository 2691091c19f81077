// Complete projective point formulas on the short Weierstrass a = 0
// curves y^2 = x^3 + b, one point per thread, over the base-field core
// in field.cuh: secp256k1 (b = 7) and BLS12-381 G1 (b = 4).
//
// The formulas are Renes-Costello-Batina 2015 algorithms 7 (add), 8
// (mixed add, q affine) and 9 (double), the ones the JAX package runs
// (dkg_tpu/groups/device.py _ws_add/_ws_madd/_ws_double).  Each output
// coordinate is the same polynomial in the inputs, and every field op is
// exact and canonical, so the projective X, Y, Z equal the JAX package's
// limb for limb.
//
// A curve is a template parameter C: its base field C::F, the element's
// words C::N, and C::mul_b3, the multiply by b3 = 3b that RCB15 needs
// canonical.  Cost in 32x32->64-bit multiply-adds:
//   secp256k1 (a multiply 86, a multiply by b3 = 21 through the fold 12):
//     add 12*86 + 2*12 = 1056, madd 11*86 + 2*12 = 970,
//     double 8*86 + 12 = 700;
//   BLS12-381 G1 (a multiply 403, Barrett; b3 = 12 as four exact adds,
//     no multiply): add 12*403 = 4836, madd 11*403 = 4433,
//     double 8*403 = 3224.
// The Edwards formulas are in edwards.cuh.
#pragma once

#include "field.cuh"

namespace dkg {

constexpr int kCoords = 3;  // X, Y, Z

struct Secp256k1 {
  static constexpr int F = kSecpP;
  static constexpr int N = Field<F>::N;  // 8
  // b3 = 21: one small-constant multiply through the fold.
  static __device__ __forceinline__ void mul_b3(uint32_t r[N], const uint32_t a[N]) {
    fmul_small<F>(r, a, 21u);
  }
};

struct Bls12381 {
  static constexpr int F = kBlsP;
  static constexpr int N = Field<F>::N;  // 12
  // b3 = 12: ((a + a) + a) doubled twice, four exact canonical adds (p has
  // no fold, so a small-constant multiply would need a whole Barrett).
  // r may alias a: a is last read before r is written.
  static __device__ __forceinline__ void mul_b3(uint32_t r[N], const uint32_t a[N]) {
    uint32_t t[N];
    fadd<F>(t, a, a);
    fadd<F>(t, t, a);
    fadd<F>(t, t, t);
    fadd<F>(r, t, t);
  }
};

template <class C>
struct Point {
  uint32_t x[C::N], y[C::N], z[C::N];
};

// int32 words of a stored point: 3 coordinates of 2N limbs.  __device__
// too, so that a kernel may take it as a local constant.
template <class C>
__host__ __device__ constexpr int point_words() {
  return kCoords * 2 * C::N;
}

template <class C>
__device__ __forceinline__ void load_point(const int32_t* src, Point<C>& p) {
  load_elem<C::N>(src, p.x);
  load_elem<C::N>(src + 2 * C::N, p.y);
  load_elem<C::N>(src + 4 * C::N, p.z);
}

template <class C>
__device__ __forceinline__ void store_point(int32_t* dst, const Point<C>& p) {
  store_elem<C::N>(dst, p.x);
  store_elem<C::N>(dst + 2 * C::N, p.y);
  store_elem<C::N>(dst + 4 * C::N, p.z);
}

template <class C>
__device__ __forceinline__ void set_identity(Point<C>& p) {
#pragma unroll
  for (int k = 0; k < C::N; ++k) {
    p.x[k] = 0;
    p.y[k] = 0;
    p.z[k] = 0;
  }
  p.y[0] = 1;
}

// RCB15 algorithm 7: complete addition.  o may alias p or q.
template <class C>
__device__ __forceinline__ void pt_add(Point<C>& o, const Point<C>& p, const Point<C>& q) {
  constexpr int F = C::F, N = C::N;
  uint32_t t0[N], t1[N], t2[N], t3[N], t4[N];
  uint32_t u[N], v[N], x3[N], y3[N], z3[N];
  fmul<F>(t0, p.x, q.x);
  fmul<F>(t1, p.y, q.y);
  fmul<F>(t2, p.z, q.z);
  fadd<F>(u, p.x, p.y);
  fadd<F>(v, q.x, q.y);
  fmul<F>(t3, u, v);
  fsub<F>(t3, t3, t0);
  fsub<F>(t3, t3, t1);  // t3 = x1 y2 + x2 y1
  fadd<F>(u, p.y, p.z);
  fadd<F>(v, q.y, q.z);
  fmul<F>(t4, u, v);
  fsub<F>(t4, t4, t1);
  fsub<F>(t4, t4, t2);  // t4 = y1 z2 + y2 z1
  fadd<F>(u, p.x, p.z);
  fadd<F>(v, q.x, q.z);
  fmul<F>(y3, u, v);
  fsub<F>(y3, y3, t0);
  fsub<F>(y3, y3, t2);  // y3 = x1 z2 + x2 z1
  fadd<F>(x3, t0, t0);
  fadd<F>(x3, x3, t0);  // x3 = 3 t0
  C::mul_b3(t2, t2);
  fadd<F>(z3, t1, t2);
  fsub<F>(t1, t1, t2);
  C::mul_b3(y3, y3);
  fmul<F>(u, t3, t1);
  fmul<F>(v, t4, y3);
  fsub<F>(o.x, u, v);   // X = t3 t1 - t4 y3
  fmul<F>(u, t1, z3);
  fmul<F>(v, x3, y3);
  fadd<F>(o.y, u, v);   // Y = t1 z3 + x3 y3
  fmul<F>(u, z3, t4);
  fmul<F>(v, x3, t3);
  fadd<F>(o.z, u, v);   // Z = z3 t4 + x3 t3
}

// RCB15 algorithm 8: mixed addition with q affine (Z = 1).  Complete for
// every p, but NOT for q = identity: callers mask those lanes.
template <class C>
__device__ __forceinline__ void pt_madd(Point<C>& o, const Point<C>& p, const Point<C>& q) {
  constexpr int F = C::F, N = C::N;
  uint32_t t0[N], t1[N], t2[N], t3[N], t4[N];
  uint32_t u[N], v[N], x3[N], y3[N], z3[N];
  fmul<F>(t0, p.x, q.x);
  fmul<F>(t1, p.y, q.y);
  fadd<F>(u, p.x, p.y);
  fadd<F>(v, q.x, q.y);
  fmul<F>(t3, u, v);
  fsub<F>(t3, t3, t0);
  fsub<F>(t3, t3, t1);
  fmul<F>(t4, q.y, p.z);
  fadd<F>(t4, t4, p.y);  // t4 = y2 z1 + y1
  fmul<F>(y3, q.x, p.z);
  fadd<F>(y3, y3, p.x);  // y3 = x2 z1 + x1
  fadd<F>(x3, t0, t0);
  fadd<F>(x3, x3, t0);
  C::mul_b3(t2, p.z);
  fadd<F>(z3, t1, t2);
  fsub<F>(t1, t1, t2);
  C::mul_b3(y3, y3);
  fmul<F>(u, t3, t1);
  fmul<F>(v, t4, y3);
  fsub<F>(o.x, u, v);
  fmul<F>(u, t1, z3);
  fmul<F>(v, x3, y3);
  fadd<F>(o.y, u, v);
  fmul<F>(u, z3, t4);
  fmul<F>(v, x3, t3);
  fadd<F>(o.z, u, v);
}

// RCB15 algorithm 9: complete doubling, in place.
template <class C>
__device__ __forceinline__ void pt_double(Point<C>& p) {
  constexpr int F = C::F, N = C::N;
  uint32_t t0[N], t1[N], t2[N], x3[N], y3[N], z3[N];
  fmul<F>(t0, p.y, p.y);
  fadd<F>(z3, t0, t0);
  fadd<F>(z3, z3, z3);
  fadd<F>(z3, z3, z3);   // z3 = 8 t0
  fmul<F>(t1, p.y, p.z);
  fmul<F>(t2, p.z, p.z);
  C::mul_b3(t2, t2);
  fmul<F>(x3, t2, z3);
  fadd<F>(y3, t0, t2);
  fmul<F>(z3, t1, z3);
  fadd<F>(t1, t2, t2);
  fadd<F>(t2, t1, t2);   // t2 = 3 b3 z^2
  fsub<F>(t0, t0, t2);
  fmul<F>(t1, t0, y3);
  fadd<F>(y3, x3, t1);
  fmul<F>(t1, p.x, p.y);
  fmul<F>(x3, t0, t1);
  fadd<F>(p.x, x3, x3);
  copy<N>(p.y, y3);
  copy<N>(p.z, z3);
}

// o <- take_a ? a : b, word by word through a mask (o may alias a or b).
// Branchless, like the Pallas kernel's select; the same selection written
// with ?: inside the ladder loop crashed nvcc 12.9's cicc.
template <class C>
__device__ __forceinline__ void select_point(Point<C>& o, bool take_a, const Point<C>& a,
                                             const Point<C>& b) {
  const uint32_t mk = 0u - (uint32_t)take_a;
#pragma unroll
  for (int k = 0; k < C::N; ++k) {
    o.x[k] = (a.x[k] & mk) | (b.x[k] & ~mk);
    o.y[k] = (a.y[k] & mk) | (b.y[k] & ~mk);
    o.z[k] = (a.z[k] & mk) | (b.z[k] & ~mk);
  }
}

// The per-lane bodies of the kernels in point_kernels.cu, bls_kernels.cu
// and double_kernels.cu: one lane's points in, one out, the stored
// (C, L) = (3, 2N) limb layout at both ends.

template <class C>
__device__ __forceinline__ void add_lane(const int32_t* p, const int32_t* q, int32_t* out) {
  Point<C> a, b;
  load_point(p, a);
  load_point(q, b);
  pt_add(a, a, b);
  store_point(out, a);
}

template <class C>
__device__ __forceinline__ void madd_lane(const int32_t* p, const int32_t* q, int32_t* out) {
  Point<C> a, b;
  load_point(p, a);
  load_point(q, b);
  pt_madd(a, a, b);
  store_point(out, a);
}

// out = 2^n_doubles * p
template <class C>
__device__ __forceinline__ void double_lane(const int32_t* p, int n_doubles, int32_t* out) {
  Point<C> a;
  load_point(p, a);
  for (int i = 0; i < n_doubles; ++i) pt_double(a);
  store_point(out, a);
}

// out = 2^n_doubles * acc + entry
template <class C>
__device__ __forceinline__ void window_step_lane(const int32_t* acc, const int32_t* entry,
                                                 int n_doubles, int32_t* out) {
  Point<C> a, e;
  load_point(acc, a);
  for (int i = 0; i < n_doubles; ++i) pt_double(a);
  load_point(entry, e);
  pt_add(a, a, e);
  store_point(out, a);
}

// out = x * P + A, MSB-first over the low nbits bits of x: each step a
// doubling and a complete add, the sum kept where the bit is set (both
// are computed, as in the Pallas kernel's select).
template <class C>
__device__ __forceinline__ void ladder_lane(const int32_t* p, const int32_t* addend, uint32_t x,
                                            int nbits, int32_t* out) {
  Point<C> base, m, t;
  load_point(p, base);
  set_identity(m);
  for (int i = nbits - 1; i >= 0; --i) {
    pt_double(m);
    pt_add(t, m, base);
    select_point(m, (x >> i) & 1u, t, m);
  }
  load_point(addend, base);
  pt_add(m, m, base);
  store_point(out, m);
}

}  // namespace dkg
