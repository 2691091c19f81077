// dkg_native — the host-side native arithmetic runtime of dkg_tpu_torch.
//
// The port's own copy of the JAX package's native/dkg_native.cpp (the
// same code): batched host arithmetic callable from Python through
// ctypes (dkg_tpu_torch/native/__init__.py, no pybind11).  Its role in
// the port is the constant-structure scalar ladder every secret scalar
// of the host groups goes through (groups/host.py), and the single-buffer
// ChaCha20 of the recipients' opens.
//
// Design: fixed-prime contexts with 64-bit limbs and Barrett reduction.
// The Barrett constant mu = floor(2^(128*L) / p) is precomputed by the
// Python side, so no bignum division lives in C++.  All loops are over
// runtime limb counts n <= MAXL.  unsigned __int128 provides the
// 64x64->128 MAC.

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

constexpr int MAXL = 8;       // up to 512-bit fields (BLS12-381 base: 6)
typedef unsigned __int128 u128;

struct FieldCtx {
    uint64_t nlimbs;          // L
    uint64_t p[MAXL + 1];     // modulus, little-endian (L used, +1 pad)
    uint64_t mu[MAXL + 2];    // floor(b^(2L) / p), L+1 limbs (b = 2^64)
};

// ---------------------------------------------------------------- helpers

// All helpers below are branchless on limb VALUES: carries/borrows are
// carried as arithmetic 0/1 words (no data-dependent control flow), the
// compare runs over every limb (no early exit), and conditional
// reductions are masked subtracts.  Loop bounds depend only on the limb
// count, so the ct ladders inherit a value-independent operation
// sequence end to end.

// 1 iff a >= b over n limbs (constant-time: full borrow chain, no exit)
static inline uint64_t geq_ct(const uint64_t* a, const uint64_t* b, int n) {
    uint64_t borrow = 0;
    for (int i = 0; i < n; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        borrow = (uint64_t)(d >> 64) & 1;
    }
    return 1 - borrow;
}

static inline void sub_n(uint64_t* a, const uint64_t* b, int n) {
    uint64_t borrow = 0;
    for (int i = 0; i < n; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        a[i] = (uint64_t)d;
        borrow = (uint64_t)(d >> 64) & 1;
    }
}

static inline void add_n(uint64_t* a, const uint64_t* b, int n) {
    uint64_t carry = 0;
    for (int i = 0; i < n; ++i) {
        u128 s = (u128)a[i] + b[i] + carry;
        a[i] = (uint64_t)s;
        carry = (uint64_t)(s >> 64);
    }
}

// a -= p if cond (branchless masked subtract; cond is 0 or 1)
static inline void cond_sub(uint64_t* a, const uint64_t* p, int n,
                            uint64_t cond) {
    const uint64_t mask = (uint64_t)0 - cond;
    uint64_t borrow = 0;
    for (int i = 0; i < n; ++i) {
        u128 d = (u128)a[i] - (p[i] & mask) - borrow;
        a[i] = (uint64_t)d;
        borrow = (uint64_t)(d >> 64) & 1;
    }
}

// full product: out[0..an+bn) = a * b
static void mul_wide(const uint64_t* a, int an, const uint64_t* b, int bn,
                     uint64_t* out) {
    std::memset(out, 0, sizeof(uint64_t) * (an + bn));
    for (int i = 0; i < an; ++i) {
        u128 carry = 0;
        for (int j = 0; j < bn; ++j) {
            u128 cur = (u128)a[i] * b[j] + out[i + j] + carry;
            out[i + j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        out[i + bn] = (uint64_t)carry;
    }
}

// Barrett reduce x (2L limbs) mod p -> out (L limbs).  HAC 14.42, b=2^64.
static void barrett(const FieldCtx* c, const uint64_t* x, uint64_t* out) {
    const int L = (int)c->nlimbs;
    // q1 = x >> 64*(L-1): L+1 limbs
    uint64_t q1[MAXL + 1];
    for (int i = 0; i < L + 1; ++i) q1[i] = x[L - 1 + i];
    // q2 = q1 * mu (2L+2 limbs); q3 = q2 >> 64*(L+1)
    uint64_t q2[2 * MAXL + 3];
    mul_wide(q1, L + 1, c->mu, L + 1, q2);
    const uint64_t* q3 = q2 + (L + 1);
    // r1 = x mod b^(L+1); r2 = q3*p mod b^(L+1); r = r1 - r2 (mod b^(L+1))
    uint64_t r[MAXL + 1];
    for (int i = 0; i < L + 1; ++i) r[i] = x[i];
    uint64_t q3p[2 * MAXL + 3];
    mul_wide(q3, L + 1, c->p, L + 1, q3p);
    sub_n(r, q3p, L + 1);  // wraparound == + b^(L+1), same as device path
    // at most two conditional subtractions of p (p has L+1 limbs w/ pad),
    // always executed as masked subtracts so the op sequence is fixed
    for (int k = 0; k < 2; ++k)
        cond_sub(r, c->p, L + 1, geq_ct(r, c->p, L + 1));
    for (int i = 0; i < L; ++i) out[i] = r[i];
}

static void f_mul_one(const FieldCtx* c, const uint64_t* a, const uint64_t* b,
                      uint64_t* out) {
    const int L = (int)c->nlimbs;
    uint64_t wide[2 * MAXL];
    mul_wide(a, L, b, L, wide);
    barrett(c, wide, out);
}

static void f_add_one(const FieldCtx* c, const uint64_t* a, const uint64_t* b,
                      uint64_t* out) {
    const int L = (int)c->nlimbs;
    uint64_t s[MAXL + 1];
    for (int i = 0; i < L; ++i) s[i] = a[i];
    s[L] = 0;
    uint64_t bb[MAXL + 1];
    for (int i = 0; i < L; ++i) bb[i] = b[i];
    bb[L] = 0;
    add_n(s, bb, L + 1);
    cond_sub(s, c->p, L + 1, geq_ct(s, c->p, L + 1));
    for (int i = 0; i < L; ++i) out[i] = s[i];
}

static void f_sub_one(const FieldCtx* c, const uint64_t* a, const uint64_t* b,
                      uint64_t* out) {
    const int L = (int)c->nlimbs;
    uint64_t s[MAXL + 1];
    for (int i = 0; i < L; ++i) s[i] = a[i];
    s[L] = 0;
    add_n(s, c->p, L + 1);  // a + p
    uint64_t bb[MAXL + 1];
    for (int i = 0; i < L; ++i) bb[i] = b[i];
    bb[L] = 0;
    sub_n(s, bb, L + 1);
    cond_sub(s, c->p, L + 1, geq_ct(s, c->p, L + 1));
    for (int i = 0; i < L; ++i) out[i] = s[i];
}

// ------------------------------------------------------------- public API

void f_add_batch(const FieldCtx* c, const uint64_t* a, const uint64_t* b,
                 uint64_t* out, size_t count) {
    const int L = (int)c->nlimbs;
    for (size_t k = 0; k < count; ++k)
        f_add_one(c, a + k * L, b + k * L, out + k * L);
}

void f_sub_batch(const FieldCtx* c, const uint64_t* a, const uint64_t* b,
                 uint64_t* out, size_t count) {
    const int L = (int)c->nlimbs;
    for (size_t k = 0; k < count; ++k)
        f_sub_one(c, a + k * L, b + k * L, out + k * L);
}

void f_mul_batch(const FieldCtx* c, const uint64_t* a, const uint64_t* b,
                 uint64_t* out, size_t count) {
    const int L = (int)c->nlimbs;
    for (size_t k = 0; k < count; ++k)
        f_mul_one(c, a + k * L, b + k * L, out + k * L);
}

// out = a^e mod p; e is elimbs little-endian 64-bit limbs
void f_pow(const FieldCtx* c, const uint64_t* a, const uint64_t* e,
           uint64_t elimbs, uint64_t* out) {
    const int L = (int)c->nlimbs;
    uint64_t base[MAXL], acc[MAXL];
    std::memcpy(base, a, sizeof(uint64_t) * L);
    std::memset(acc, 0, sizeof(uint64_t) * L);
    acc[0] = 1;
    int topbit = -1;
    for (int i = (int)elimbs * 64 - 1; i >= 0 && topbit < 0; --i)
        if ((e[i / 64] >> (i % 64)) & 1) topbit = i;
    for (int i = topbit; i >= 0; --i) {
        f_mul_one(c, acc, acc, acc);
        if ((e[i / 64] >> (i % 64)) & 1) f_mul_one(c, acc, base, acc);
    }
    std::memcpy(out, acc, sizeof(uint64_t) * L);
}

// ------------------------------------------------- curve: twisted Edwards

struct EdCtx {
    FieldCtx f;
    uint64_t d2[MAXL];  // 2d
};

// unified extended addition (a=-1, add-2008-hwcd-3); in/out (X,Y,Z,T)x L
static void ed_add_one(const EdCtx* c, const uint64_t* p, const uint64_t* q,
                       uint64_t* out) {
    const FieldCtx* f = &c->f;
    const int L = (int)f->nlimbs;
    const uint64_t *x1 = p, *y1 = p + L, *z1 = p + 2 * L, *t1 = p + 3 * L;
    const uint64_t *x2 = q, *y2 = q + L, *z2 = q + 2 * L, *t2 = q + 3 * L;
    uint64_t a[MAXL], b[MAXL], cc[MAXL], d[MAXL], u[MAXL], v[MAXL];
    f_sub_one(f, y1, x1, a);
    f_sub_one(f, y2, x2, b);
    f_mul_one(f, a, b, a);          // A = (y1-x1)(y2-x2)
    f_add_one(f, y1, x1, b);
    f_add_one(f, y2, x2, cc);
    f_mul_one(f, b, cc, b);         // B = (y1+x1)(y2+x2)
    f_mul_one(f, t1, c->d2, cc);
    f_mul_one(f, cc, t2, cc);       // C = 2d t1 t2
    f_add_one(f, z1, z1, d);
    f_mul_one(f, d, z2, d);         // D = 2 z1 z2
    f_sub_one(f, b, a, u);          // E
    f_add_one(f, b, a, v);          // H
    uint64_t ff[MAXL], g[MAXL];
    f_sub_one(f, d, cc, ff);        // F
    f_add_one(f, d, cc, g);         // G
    f_mul_one(f, u, ff, out);            // X3 = E*F
    f_mul_one(f, g, v, out + L);         // Y3 = G*H
    f_mul_one(f, ff, g, out + 2 * L);    // Z3 = F*G
    f_mul_one(f, u, v, out + 3 * L);     // T3 = E*H
}

void ed_add_batch(const EdCtx* c, const uint64_t* p, const uint64_t* q,
                  uint64_t* out, size_t count) {
    const int stride = 4 * (int)c->f.nlimbs;
    for (size_t k = 0; k < count; ++k)
        ed_add_one(c, p + k * stride, q + k * stride, out + k * stride);
}

// batched variable-base scalar mult, binary ladder MSB-first.
// scalars: count x slimbs 64-bit limbs
void ed_scalar_mul_batch(const EdCtx* c, const uint64_t* scalars,
                         uint64_t slimbs, const uint64_t* points,
                         uint64_t* out, size_t count) {
    const int L = (int)c->f.nlimbs;
    const int stride = 4 * L;
    for (size_t k = 0; k < count; ++k) {
        uint64_t acc[4 * MAXL];
        std::memset(acc, 0, sizeof(uint64_t) * stride);
        acc[L] = 1;       // Y = 1
        acc[2 * L] = 1;   // Z = 1  (identity (0,1,1,0))
        const uint64_t* e = scalars + k * slimbs;
        int topbit = -1;
        for (int i = (int)slimbs * 64 - 1; i >= 0 && topbit < 0; --i)
            if ((e[i / 64] >> (i % 64)) & 1) topbit = i;
        for (int i = topbit; i >= 0; --i) {
            ed_add_one(c, acc, acc, acc);
            if ((e[i / 64] >> (i % 64)) & 1)
                ed_add_one(c, acc, points + k * stride, acc);
        }
        std::memcpy(out + k * stride, acc, sizeof(uint64_t) * stride);
    }
}

// Constant-structure Montgomery ladder, twisted Edwards.
//
// Secret-scalar path: iteration count is the caller-supplied nbits (the
// scalar field's bit length) regardless of the value, and every
// iteration performs exactly one cswap + one add + one double + one
// cswap.  The swap is a branchless masked exchange, and the underlying
// field helpers (geq_ct/cond_sub/add_n/sub_n above) carry borrows as
// arithmetic words with no early exits, so neither the operation
// sequence nor the memory-access pattern depends on the scalar OR on
// intermediate limb values — unlike ed_scalar_mul_batch above (vartime,
// public data only; f_pow likewise branches on its public exponent).
// Mirrors the op-for-op sequence of the Python ladder
// (groups/host.py _scalar_mul_ladder) so outputs are limb-exact identical.
static inline void cswap_limbs(uint64_t* a, uint64_t* b, int n, uint64_t bit) {
    const uint64_t mask = (uint64_t)0 - bit;
    for (int i = 0; i < n; ++i) {
        uint64_t t = mask & (a[i] ^ b[i]);
        a[i] ^= t;
        b[i] ^= t;
    }
}

void ed_scalar_mul_ct_batch(const EdCtx* c, const uint64_t* scalars,
                            uint64_t slimbs, uint64_t nbits,
                            const uint64_t* points, uint64_t* out,
                            size_t count) {
    const int L = (int)c->f.nlimbs;
    const int stride = 4 * L;
    for (size_t k = 0; k < count; ++k) {
        uint64_t r0[4 * MAXL], r1[4 * MAXL];
        std::memset(r0, 0, sizeof(uint64_t) * stride);
        r0[L] = 1;       // identity (0,1,1,0)
        r0[2 * L] = 1;
        std::memcpy(r1, points + k * stride, sizeof(uint64_t) * stride);
        const uint64_t* e = scalars + k * slimbs;
        for (int i = (int)nbits - 1; i >= 0; --i) {
            uint64_t bit =
                ((uint64_t)i / 64 < slimbs) ? (e[i / 64] >> (i % 64)) & 1 : 0;
            cswap_limbs(r0, r1, stride, bit);
            ed_add_one(c, r0, r1, r1);
            ed_add_one(c, r0, r0, r0);
            cswap_limbs(r0, r1, stride, bit);
        }
        std::memcpy(out + k * stride, r0, sizeof(uint64_t) * stride);
    }
}

// -------------------------------------------- curve: short Weierstrass a=0

struct WsCtx {
    FieldCtx f;
    uint64_t b3[MAXL];  // 3b
};

// complete projective addition (RCB15 algorithm 7); (X,Y,Z) x L
static void ws_add_one(const WsCtx* c, const uint64_t* p, const uint64_t* q,
                       uint64_t* out) {
    const FieldCtx* f = &c->f;
    const int L = (int)f->nlimbs;
    const uint64_t *x1 = p, *y1 = p + L, *z1 = p + 2 * L;
    const uint64_t *x2 = q, *y2 = q + L, *z2 = q + 2 * L;
    uint64_t t0[MAXL], t1[MAXL], t2[MAXL], t3[MAXL], t4[MAXL];
    uint64_t x3[MAXL], y3[MAXL], z3[MAXL], tmp[MAXL];
    f_mul_one(f, x1, x2, t0);
    f_mul_one(f, y1, y2, t1);
    f_mul_one(f, z1, z2, t2);
    f_add_one(f, x1, y1, t3);
    f_add_one(f, x2, y2, tmp);
    f_mul_one(f, t3, tmp, t3);
    f_sub_one(f, t3, t0, t3);
    f_sub_one(f, t3, t1, t3);            // t3 = x1y2 + x2y1
    f_add_one(f, y1, z1, t4);
    f_add_one(f, y2, z2, tmp);
    f_mul_one(f, t4, tmp, t4);
    f_sub_one(f, t4, t1, t4);
    f_sub_one(f, t4, t2, t4);            // t4 = y1z2 + y2z1
    f_add_one(f, x1, z1, y3);
    f_add_one(f, x2, z2, tmp);
    f_mul_one(f, y3, tmp, y3);
    f_sub_one(f, y3, t0, y3);
    f_sub_one(f, y3, t2, y3);            // y3 = x1z2 + x2z1
    f_add_one(f, t0, t0, x3);
    f_add_one(f, x3, t0, x3);            // x3 = 3 t0
    f_mul_one(f, c->b3, t2, t2);
    f_add_one(f, t1, t2, z3);
    f_sub_one(f, t1, t2, t1);
    f_mul_one(f, c->b3, y3, y3);
    uint64_t w1[MAXL], w2[MAXL];
    f_mul_one(f, t3, t1, w1);
    f_mul_one(f, t4, y3, w2);
    f_sub_one(f, w1, w2, out);           // X3
    f_mul_one(f, t1, z3, w1);
    f_mul_one(f, x3, y3, w2);
    f_add_one(f, w1, w2, out + L);       // Y3
    f_mul_one(f, z3, t4, w1);
    f_mul_one(f, x3, t3, w2);
    f_add_one(f, w1, w2, out + 2 * L);   // Z3
}

void ws_add_batch(const WsCtx* c, const uint64_t* p, const uint64_t* q,
                  uint64_t* out, size_t count) {
    const int stride = 3 * (int)c->f.nlimbs;
    for (size_t k = 0; k < count; ++k)
        ws_add_one(c, p + k * stride, q + k * stride, out + k * stride);
}

void ws_scalar_mul_batch(const WsCtx* c, const uint64_t* scalars,
                         uint64_t slimbs, const uint64_t* points,
                         uint64_t* out, size_t count) {
    const int L = (int)c->f.nlimbs;
    const int stride = 3 * L;
    for (size_t k = 0; k < count; ++k) {
        uint64_t acc[3 * MAXL];
        std::memset(acc, 0, sizeof(uint64_t) * stride);
        acc[L] = 1;  // identity (0,1,0)
        const uint64_t* e = scalars + k * slimbs;
        int topbit = -1;
        for (int i = (int)slimbs * 64 - 1; i >= 0 && topbit < 0; --i)
            if ((e[i / 64] >> (i % 64)) & 1) topbit = i;
        for (int i = topbit; i >= 0; --i) {
            ws_add_one(c, acc, acc, acc);
            if ((e[i / 64] >> (i % 64)) & 1)
                ws_add_one(c, acc, points + k * stride, acc);
        }
        std::memcpy(out + k * stride, acc, sizeof(uint64_t) * stride);
    }
}

// Constant-structure Montgomery ladder, short Weierstrass a=0 (see the
// Edwards twin above for the discipline; same op-for-op mirror of
// the Python ladder).
void ws_scalar_mul_ct_batch(const WsCtx* c, const uint64_t* scalars,
                            uint64_t slimbs, uint64_t nbits,
                            const uint64_t* points, uint64_t* out,
                            size_t count) {
    const int L = (int)c->f.nlimbs;
    const int stride = 3 * L;
    for (size_t k = 0; k < count; ++k) {
        uint64_t r0[3 * MAXL], r1[3 * MAXL];
        std::memset(r0, 0, sizeof(uint64_t) * stride);
        r0[L] = 1;  // identity (0,1,0)
        std::memcpy(r1, points + k * stride, sizeof(uint64_t) * stride);
        const uint64_t* e = scalars + k * slimbs;
        for (int i = (int)nbits - 1; i >= 0; --i) {
            uint64_t bit =
                ((uint64_t)i / 64 < slimbs) ? (e[i / 64] >> (i % 64)) & 1 : 0;
            cswap_limbs(r0, r1, stride, bit);
            ws_add_one(c, r0, r1, r1);
            ws_add_one(c, r0, r0, r0);
            cswap_limbs(r0, r1, stride, bit);
        }
        std::memcpy(out + k * stride, r0, sizeof(uint64_t) * stride);
    }
}

// ------------------------------------------------------------- ChaCha20

static inline uint32_t rotl32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

#define QR(a, b, c, d)                                                     \
    a += b; d ^= a; d = rotl32(d, 16);                                     \
    c += d; b ^= c; b = rotl32(b, 12);                                     \
    a += b; d ^= a; d = rotl32(d, 8);                                      \
    c += d; b ^= c; b = rotl32(b, 7);

void chacha20_xor(const uint8_t* key, const uint8_t* nonce, uint32_t counter,
                  const uint8_t* in, uint8_t* out, size_t len) {
    uint32_t st[16];
    st[0] = 0x61707865; st[1] = 0x3320646e; st[2] = 0x79622d32; st[3] = 0x6b206574;
    for (int i = 0; i < 8; ++i)
        std::memcpy(&st[4 + i], key + 4 * i, 4);
    st[12] = counter;
    for (int i = 0; i < 3; ++i)
        std::memcpy(&st[13 + i], nonce + 4 * i, 4);
    size_t off = 0;
    while (off < len) {
        uint32_t w[16];
        std::memcpy(w, st, sizeof(w));
        for (int r = 0; r < 10; ++r) {
            QR(w[0], w[4], w[8], w[12]) QR(w[1], w[5], w[9], w[13])
            QR(w[2], w[6], w[10], w[14]) QR(w[3], w[7], w[11], w[15])
            QR(w[0], w[5], w[10], w[15]) QR(w[1], w[6], w[11], w[12])
            QR(w[2], w[7], w[8], w[13]) QR(w[3], w[4], w[9], w[14])
        }
        uint8_t ks[64];
        for (int i = 0; i < 16; ++i) {
            uint32_t v = w[i] + st[i];
            std::memcpy(ks + 4 * i, &v, 4);
        }
        size_t chunk = len - off < 64 ? len - off : 64;
        for (size_t i = 0; i < chunk; ++i) out[off + i] = in[off + i] ^ ks[i];
        st[12]++;
        off += chunk;
    }
}

}  // extern "C"
