// Complete projective point formulas on secp256k1 (y^2 = x^3 + 7), one
// point per thread, over the base-field core in field.cuh.
//
// The formulas are Renes-Costello-Batina 2015 algorithms 7 (add), 8
// (mixed add, q affine) and 9 (double), the ones the JAX package runs
// (dkg_tpu/groups/device.py _ws_add/_ws_madd/_ws_double).  Each output
// coordinate is the same polynomial in the inputs, and every field op is
// exact and canonical, so the projective X, Y, Z equal the JAX package's
// limb for limb.
//
// Cost in 32x32->64-bit multiply-adds (a full multiply is 86, a multiply
// by b3 = 21 is 12): add 12*86 + 2*12 = 1056, madd 11*86 + 2*12 = 970,
// double 8*86 + 12 = 700.  The Edwards formulas are in edwards.cuh.
#pragma once

#include "field.cuh"

namespace dkg {

constexpr uint32_t kB3 = 21;  // 3 * b for secp256k1
constexpr int kCoords = 3;    // X, Y, Z

struct Point {
  uint32_t x[kWords], y[kWords], z[kWords];
};

__device__ __forceinline__ void load_point(const int32_t* src, Point& p) {
  load16(src, p.x);
  load16(src + kLimbs, p.y);
  load16(src + 2 * kLimbs, p.z);
}

__device__ __forceinline__ void store_point(int32_t* dst, const Point& p) {
  store16(dst, p.x);
  store16(dst + kLimbs, p.y);
  store16(dst + 2 * kLimbs, p.z);
}

__device__ __forceinline__ void set_identity(Point& p) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    p.x[k] = 0;
    p.y[k] = 0;
    p.z[k] = 0;
  }
  p.y[0] = 1;
}

// RCB15 algorithm 7: complete addition.  o may alias p or q.
__device__ __forceinline__ void pt_add(Point& o, const Point& p, const Point& q) {
  constexpr int F = kSecpP;
  uint32_t t0[kWords], t1[kWords], t2[kWords], t3[kWords], t4[kWords];
  uint32_t u[kWords], v[kWords], x3[kWords], y3[kWords], z3[kWords];
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
  fmul_small<F>(t2, t2, kB3);
  fadd<F>(z3, t1, t2);
  fsub<F>(t1, t1, t2);
  fmul_small<F>(y3, y3, kB3);
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
__device__ __forceinline__ void pt_madd(Point& o, const Point& p, const Point& q) {
  constexpr int F = kSecpP;
  uint32_t t0[kWords], t1[kWords], t2[kWords], t3[kWords], t4[kWords];
  uint32_t u[kWords], v[kWords], x3[kWords], y3[kWords], z3[kWords];
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
  fmul_small<F>(t2, p.z, kB3);
  fadd<F>(z3, t1, t2);
  fsub<F>(t1, t1, t2);
  fmul_small<F>(y3, y3, kB3);
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
__device__ __forceinline__ void pt_double(Point& p) {
  constexpr int F = kSecpP;
  uint32_t t0[kWords], t1[kWords], t2[kWords], x3[kWords], y3[kWords], z3[kWords];
  fmul<F>(t0, p.y, p.y);
  fadd<F>(z3, t0, t0);
  fadd<F>(z3, z3, z3);
  fadd<F>(z3, z3, z3);   // z3 = 8 t0
  fmul<F>(t1, p.y, p.z);
  fmul<F>(t2, p.z, p.z);
  fmul_small<F>(t2, t2, kB3);
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
  copy(p.y, y3);
  copy(p.z, z3);
}

// o <- take_a ? a : b, word by word through a mask (o may alias a or b).
// Branchless, like the Pallas kernel's select; the same selection written
// with ?: inside the ladder loop crashed nvcc 12.9's cicc.
__device__ __forceinline__ void select_point(Point& o, bool take_a, const Point& a,
                                             const Point& b) {
  const uint32_t mk = 0u - (uint32_t)take_a;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    o.x[k] = (a.x[k] & mk) | (b.x[k] & ~mk);
    o.y[k] = (a.y[k] & mk) | (b.y[k] & ~mk);
    o.z[k] = (a.z[k] & mk) | (b.z[k] & ~mk);
  }
}

// The per-lane bodies of the kernels in point_kernels.cu: one lane's
// points in, one out, the stored (C, L) = (3, 16) limb layout at both ends.

__device__ __forceinline__ void add_lane(const int32_t* p, const int32_t* q, int32_t* out) {
  Point a, b;
  load_point(p, a);
  load_point(q, b);
  pt_add(a, a, b);
  store_point(out, a);
}

__device__ __forceinline__ void madd_lane(const int32_t* p, const int32_t* q, int32_t* out) {
  Point a, b;
  load_point(p, a);
  load_point(q, b);
  pt_madd(a, a, b);
  store_point(out, a);
}

// out = 2^n_doubles * p
__device__ __forceinline__ void double_lane(const int32_t* p, int n_doubles, int32_t* out) {
  Point a;
  load_point(p, a);
  for (int i = 0; i < n_doubles; ++i) pt_double(a);
  store_point(out, a);
}

// out = 2^n_doubles * acc + entry
__device__ __forceinline__ void window_step_lane(const int32_t* acc, const int32_t* entry,
                                                 int n_doubles, int32_t* out) {
  Point a, e;
  load_point(acc, a);
  for (int i = 0; i < n_doubles; ++i) pt_double(a);
  load_point(entry, e);
  pt_add(a, a, e);
  store_point(out, a);
}

// out = x * P + A, MSB-first over the low nbits bits of x: each step a
// doubling and a complete add, the sum kept where the bit is set (both
// are computed, as in the Pallas kernel's select).
__device__ __forceinline__ void ladder_lane(const int32_t* p, const int32_t* addend, uint32_t x,
                                            int nbits, int32_t* out) {
  Point base, m, t;
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
