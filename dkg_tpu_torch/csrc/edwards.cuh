// Extended twisted Edwards point formulas on edwards25519 (a = -1, the
// curve under ristretto255), one point per thread, over the ed25519 base
// field core in field.cuh (F = kEdP, reduce_fold255).
//
// The formulas are the ones the JAX package runs
// (dkg_tpu/groups/device.py _ed_add/_ed_madd/_ed_double) and the port's
// plain versions (ops/point_kernels.py _ed_add/_ed_madd/_ed_double):
// unified addition add-2008-hwcd-3 with 2d from __constant__ memory, the
// mixed addition with Z2 = 1, and doubling dbl-2008-hwcd.  Each output
// coordinate is the same polynomial in the inputs, and every field op is
// exact and canonical, so the extended X, Y, Z, T equal the JAX package's
// limb for limb.  All three are complete for every input (d is not a
// square), the identity (0, 1, 1, 0) included, so no lane is masked.
//
// Cost in 32x32->64-bit multiply-adds (a base-field multiply is 73): add
// 9*73 = 657, madd 8*73 = 584, double 8*73 = 584 (four squarings, four
// products).  A point is four coordinates of eight words: 32 registers
// for the point alone, against 24 on secp256k1 (point.cuh).
#pragma once

#include "field.cuh"

namespace dkg {

constexpr int kEdCoords = 4;  // X, Y, Z, T
constexpr int kEdN = Field<kEdP>::N;  // 8 words a coordinate
constexpr int kEdLimbs = 2 * kEdN;     // 16 limbs a stored coordinate

// 2d mod p, d = -121665/121666 (the CurveSpec's const)
__constant__ uint32_t kEd2D[kEdN] = {
    0x26B2F159u, 0xEBD69B94u, 0x8283B156u, 0x00E0149Au,
    0xEEF3D130u, 0x198E80F2u, 0x56DFFCE7u, 0x2406D9DCu,
};

struct EdPoint {
  uint32_t x[kEdN], y[kEdN], z[kEdN], t[kEdN];
};

__device__ __forceinline__ void load_ed(const int32_t* src, EdPoint& p) {
  load_elem<kEdN>(src, p.x);
  load_elem<kEdN>(src + kEdLimbs, p.y);
  load_elem<kEdN>(src + 2 * kEdLimbs, p.z);
  load_elem<kEdN>(src + 3 * kEdLimbs, p.t);
}

__device__ __forceinline__ void store_ed(int32_t* dst, const EdPoint& p) {
  store_elem<kEdN>(dst, p.x);
  store_elem<kEdN>(dst + kEdLimbs, p.y);
  store_elem<kEdN>(dst + 2 * kEdLimbs, p.z);
  store_elem<kEdN>(dst + 3 * kEdLimbs, p.t);
}

__device__ __forceinline__ void ed_set_identity(EdPoint& p) {
#pragma unroll
  for (int k = 0; k < kEdN; ++k) {
    p.x[k] = 0;
    p.y[k] = 0;
    p.z[k] = 0;
    p.t[k] = 0;
  }
  p.y[0] = 1;
  p.z[0] = 1;
}

// The shared tail of add and madd: (E, F, G, H) = (B - A, D - C, D + C,
// B + A), then X = E F, Y = G H, Z = F G, T = E H.
__device__ __forceinline__ void ed_finish(EdPoint& o, const uint32_t a[kEdN],
                                          const uint32_t b[kEdN], const uint32_t c[kEdN],
                                          const uint32_t d[kEdN]) {
  constexpr int F = kEdP;
  uint32_t e[kEdN], f[kEdN], g[kEdN], h[kEdN];
  fsub<F>(e, b, a);
  fsub<F>(f, d, c);
  fadd<F>(g, d, c);
  fadd<F>(h, b, a);
  fmul<F>(o.x, e, f);
  fmul<F>(o.y, g, h);
  fmul<F>(o.z, f, g);
  fmul<F>(o.t, e, h);
}

// C = (T1 * 2d) * T2
__device__ __forceinline__ void ed_c(uint32_t c[kEdN], const uint32_t t1[kEdN],
                                     const uint32_t t2[kEdN]) {
  constexpr int F = kEdP;
  uint32_t k2d[kEdN];
#pragma unroll
  for (int k = 0; k < kEdN; ++k) k2d[k] = kEd2D[k];
  fmul<F>(c, t1, k2d);
  fmul<F>(c, c, t2);
}

// add-2008-hwcd-3, unified.  o may alias p or q.
__device__ __forceinline__ void ed_add(EdPoint& o, const EdPoint& p, const EdPoint& q) {
  constexpr int F = kEdP;
  uint32_t a[kEdN], b[kEdN], c[kEdN], d[kEdN], u[kEdN], v[kEdN];
  fsub<F>(u, p.y, p.x);
  fsub<F>(v, q.y, q.x);
  fmul<F>(a, u, v);  // A = (Y1 - X1)(Y2 - X2)
  fadd<F>(u, p.y, p.x);
  fadd<F>(v, q.y, q.x);
  fmul<F>(b, u, v);  // B = (Y1 + X1)(Y2 + X2)
  ed_c(c, p.t, q.t);
  fadd<F>(u, p.z, p.z);
  fmul<F>(d, u, q.z);  // D = 2 Z1 Z2
  ed_finish(o, a, b, c, d);
}

// Mixed unified addition, q affine (Z2 = 1): D = 2 Z1.  o may alias p.
__device__ __forceinline__ void ed_madd(EdPoint& o, const EdPoint& p, const EdPoint& q) {
  constexpr int F = kEdP;
  uint32_t a[kEdN], b[kEdN], c[kEdN], d[kEdN], u[kEdN], v[kEdN];
  fsub<F>(u, p.y, p.x);
  fsub<F>(v, q.y, q.x);
  fmul<F>(a, u, v);
  fadd<F>(u, p.y, p.x);
  fadd<F>(v, q.y, q.x);
  fmul<F>(b, u, v);
  ed_c(c, p.t, q.t);
  fadd<F>(d, p.z, p.z);
  ed_finish(o, a, b, c, d);
}

// dbl-2008-hwcd (a = -1), in place: A = X^2, B = Y^2, C = 2 Z^2, D = -A,
// E = (X + Y)^2 - A - B, G = D + B, H = D - B, F = G - C.
__device__ __forceinline__ void ed_double(EdPoint& p) {
  constexpr int F = kEdP;
  uint32_t a[kEdN], b[kEdN], c[kEdN], d[kEdN], e[kEdN], f[kEdN], g[kEdN],
      h[kEdN];
  fmul<F>(a, p.x, p.x);
  fmul<F>(b, p.y, p.y);
  fmul<F>(c, p.z, p.z);
  fadd<F>(c, c, c);
#pragma unroll
  for (int k = 0; k < kEdN; ++k) d[k] = 0;
  fsub<F>(d, d, a);
  fadd<F>(e, p.x, p.y);
  fmul<F>(e, e, e);
  fsub<F>(e, e, a);
  fsub<F>(e, e, b);
  fadd<F>(g, d, b);
  fsub<F>(h, d, b);
  fsub<F>(f, g, c);
  fmul<F>(p.x, e, f);
  fmul<F>(p.y, g, h);
  fmul<F>(p.z, f, g);
  fmul<F>(p.t, e, h);
}

// o <- take_a ? a : b, word by word through a mask (see point.cuh
// select_point).
__device__ __forceinline__ void ed_select(EdPoint& o, bool take_a, const EdPoint& a,
                                          const EdPoint& b) {
  const uint32_t mk = 0u - (uint32_t)take_a;
#pragma unroll
  for (int k = 0; k < kEdN; ++k) {
    o.x[k] = (a.x[k] & mk) | (b.x[k] & ~mk);
    o.y[k] = (a.y[k] & mk) | (b.y[k] & ~mk);
    o.z[k] = (a.z[k] & mk) | (b.z[k] & ~mk);
    o.t[k] = (a.t[k] & mk) | (b.t[k] & ~mk);
  }
}

// The per-lane bodies of the kernels in edwards_kernels.cu and
// double_kernels.cu: one lane's points in, one out, the stored
// (C, L) = (4, 16) limb layout at both ends.

__device__ __forceinline__ void ed_add_lane(const int32_t* p, const int32_t* q, int32_t* out) {
  EdPoint a, b;
  load_ed(p, a);
  load_ed(q, b);
  ed_add(a, a, b);
  store_ed(out, a);
}

__device__ __forceinline__ void ed_madd_lane(const int32_t* p, const int32_t* q, int32_t* out) {
  EdPoint a, b;
  load_ed(p, a);
  load_ed(q, b);
  ed_madd(a, a, b);
  store_ed(out, a);
}

// out = 2^n_doubles * p
__device__ __forceinline__ void ed_double_lane(const int32_t* p, int n_doubles, int32_t* out) {
  EdPoint a;
  load_ed(p, a);
  for (int i = 0; i < n_doubles; ++i) ed_double(a);
  store_ed(out, a);
}

// out = 2^n_doubles * acc + entry: the doublings, then the unified add,
// with acc in registers throughout.  The loop stays rolled: unrolled
// doublings gain nothing at a runtime count and cost registers.
__device__ __forceinline__ void ed_window_step_lane(const int32_t* acc, const int32_t* entry,
                                                    int n_doubles, int32_t* out) {
  EdPoint a, e;
  load_ed(acc, a);
#pragma unroll 1
  for (int i = 0; i < n_doubles; ++i) ed_double(a);
  load_ed(entry, e);
  ed_add(a, a, e);
  store_ed(out, a);
}

// out = x * P + A, MSB-first over the low nbits bits of x: each step a
// doubling and a unified add, the sum kept where the bit is set (both
// are computed, as in the Pallas kernel's select).
__device__ __forceinline__ void ed_ladder_lane(const int32_t* p, const int32_t* addend,
                                               uint32_t x, int nbits, int32_t* out) {
  EdPoint base, m, t;
  load_ed(p, base);
  ed_set_identity(m);
  for (int i = nbits - 1; i >= 0; --i) {
    ed_double(m);
    ed_add(t, m, base);
    ed_select(m, (x >> i) & 1u, t, m);
  }
  load_ed(addend, base);
  ed_add(m, m, base);
  store_ed(out, m);
}

}  // namespace dkg
