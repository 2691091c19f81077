"""Host-side (Python-int) group arithmetic for the ceremony slices.

A JAX-free copy of what the port needs from ``dkg_tpu/groups/host.py``:
the short Weierstrass a=0 groups secp256k1 and BLS12-381 G1 (complete
RCB15 addition, scalar multiplication, SEC-style encoding and decoding,
try-and-increment hash-to-curve with cofactor clearing for the Pedersen
base ``h``, the subgroup check) and the ristretto255 group over
edwards25519 (unified extended addition, the RFC 9496 encode, decode,
equality and one-way map, hash-to-group for ``h``).  ``scalar_mul`` is
the secret-scalar path (recipients' keys in ``dkg/hybrid_batch.open_share``
and ``crypto/elgamal.py``'s opens, KEM randomness, the committee's
phases): it runs the native constant-structure Montgomery ladder
(``native.NativeCurve.scalar_mul_ct``: a fixed iteration count over the
scalar field's bit length, a branchless masked swap, limb arithmetic
with no value-dependent branch), over one context a group, as the JAX
package routes it.  There is no Python fallback: a runtime that cannot
be built raises.  The pure-Python ladder stays as the oracle,
``_scalar_mul_ladder`` (the JAX package's name); it is limb for limb the
native one, but Python ints are not constant-time, so it is for tests
only.  ``random_scalar`` draws a scalar from the caller's ``rng``.
The public-scalar API the signing path verifies with (``neg``, ``sub``,
``scalar_mul_vartime``, ``msm``, ``is_identity``) and the scalar codec
the wire protocol seals shares with (``scalar_to_bytes``,
``scalar_from_bytes``, ``hash_to_scalar``) are the JAX package's
``HostGroup``'s, and ``_person`` its BLAKE2b personalisation.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

from ..fields import spec as fspec
from ..fields.spec import FieldSpec

# ---------------------------------------------------------------------------
# Edwards25519 / ristretto255 constants
# ---------------------------------------------------------------------------

P = (1 << 255) - 19
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1), the even root
BASE_Y = (4 * pow(5, P - 2, P)) % P

# Ristretto helper constants (RFC 9496 §4.1)
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = ((D - 1) * (D - 1)) % P


def _recover_x(y: int, sign: int) -> Optional[int]:
    """x with x**2 = (y**2-1)/(d*y**2+1), choosing parity = sign."""
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


BASE_X = _recover_x(BASE_Y, 0)

# Extended twisted Edwards coordinates (X, Y, Z, T), T = X*Y/Z, a = -1.
EdPoint = tuple

ED_IDENTITY: EdPoint = (0, 1, 1, 0)
ED_GENERATOR: EdPoint = (BASE_X, BASE_Y, 1, BASE_X * BASE_Y % P)


def ed_add(p: EdPoint, q: EdPoint) -> EdPoint:
    """Unified extended addition (complete for a=-1, d non-square)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * D * t1 % P * t2 % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = (b - a) % P, (dd - c) % P, (dd + c) % P, (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def ed_neg(p: EdPoint) -> EdPoint:
    x, y, z, t = p
    return ((P - x) % P, y, z, (P - t) % P)


def _sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """RFC 9496 §4.2 SQRT_RATIO_M1: non-negative sqrt of u/v (or i*u/v)."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u_neg = (P - u) % P
    correct_sign = check == u % P
    flipped_sign = check == u_neg
    flipped_sign_i = check == u_neg * SQRT_M1 % P
    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P
    if r & 1:
        r = P - r
    return (correct_sign or flipped_sign), r


_, INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, (-1 - D) % P)
_, SQRT_AD_MINUS_ONE = _sqrt_ratio_m1((-D - 1) % P, 1)


def ristretto_encode(p: EdPoint) -> bytes:
    """RFC 9496 §4.3.2 ENCODE."""
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    ix0 = x0 * SQRT_M1 % P
    iy0 = y0 * SQRT_M1 % P
    enchanted = den1 * INVSQRT_A_MINUS_D % P
    if (t0 * z_inv % P) & 1:  # rotate
        x, y, den_inv = iy0, ix0, enchanted
    else:
        x, y, den_inv = x0, y0, den2
    if (x * z_inv % P) & 1:
        y = (P - y) % P
    s = den_inv * ((z0 - y) % P) % P
    if s & 1:
        s = P - s
    return s.to_bytes(32, "little")


def ristretto_decode(data: bytes) -> Optional[EdPoint]:
    """RFC 9496 §4.3.1 DECODE; None for non-canonical encodings."""
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= P or s & 1:
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = ((P - D) * u1 % P * u1 + P - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = 2 * s % P * den_x % P
    if x & 1:
        x = P - x
    y = u1 * den_y % P
    t = x * y % P
    if (not was_square) or t & 1 or y == 0:
        return None
    return (x, y, 1, t)


def ristretto_eq(p: EdPoint, q: EdPoint) -> bool:
    """Torsion-safe equality (RFC 9496 §4.3.3): X1Y2==Y1X2 or Y1Y2==X1X2."""
    x1, y1, _, _ = p
    x2, y2, _, _ = q
    return (x1 * y2 - y1 * x2) % P == 0 or (y1 * y2 - x1 * x2) % P == 0


def ristretto_map(t: int) -> EdPoint:
    """RFC 9496 §4.3.4 MAP: field element -> group element."""
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = ((P - 1) + P - r * D % P) % P * ((r + D) % P) % P
    was_square, s = _sqrt_ratio_m1(u, v)
    s_prime = s * t % P
    if not s_prime & 1:
        s_prime = P - s_prime  # -ABS(s*t)
    if not was_square:
        s, c = s_prime, r
    else:
        c = P - 1
    n = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ + P - v) % P
    w0 = 2 * s * v % P
    w1 = n * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return (w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)

# ---------------------------------------------------------------------------
# Short Weierstrass (a = 0): projective (X, Y, Z), identity (0, 1, 0)
# ---------------------------------------------------------------------------

WsPoint = tuple


def ws_add(p: WsPoint, q: WsPoint, prime: int, b3: int) -> WsPoint:
    """Complete projective addition for y^2 = x^3 + b (Renes-Costello-Batina
    2015, algorithm 7): handles the identity and doubling."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = x1 * x2 % prime
    t1 = y1 * y2 % prime
    t2 = z1 * z2 % prime
    t3 = (x1 + y1) * (x2 + y2) % prime
    t3 = (t3 - t0 - t1) % prime
    t4 = (y1 + z1) * (y2 + z2) % prime
    t4 = (t4 - t1 - t2) % prime
    x3 = (x1 + z1) * (x2 + z2) % prime
    y3 = (x3 - t0 - t2) % prime
    x3 = t0 * 3 % prime
    t2 = b3 * t2 % prime
    z3 = (t1 + t2) % prime
    t1 = (t1 - t2) % prime
    y3 = b3 * y3 % prime
    x_out = (t3 * t1 - y3 * t4) % prime
    y_out = (t1 * z3 + x3 * y3) % prime
    z_out = (z3 * t4 + x3 * t3) % prime
    return (x_out, y_out, z_out)


def ws_neg(p: WsPoint, prime: int) -> WsPoint:
    x, y, z = p
    return (x, (prime - y) % prime, z)


def ws_eq(p: WsPoint, q: WsPoint, prime: int) -> bool:
    """Projective equality by cross-multiplication (identity-correct)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    if z1 % prime == 0 or z2 % prime == 0:
        return z1 % prime == z2 % prime
    return (x1 * z2 - x2 * z1) % prime == 0 and (y1 * z2 - y2 * z1) % prime == 0


def _scalar_mul_ladder(group, k: int, p):
    """k·P by the fixed-length Montgomery ladder over the scalar field's
    bit length (uniform add + double per bit): the oracle of the native
    ladder, limb for limb.  Python ints are not constant-time, so tests
    only."""
    k %= group.scalar_field.modulus
    r0, r1 = group.identity(), p
    for i in reversed(range(group.scalar_field.modulus.bit_length())):
        bit = (k >> i) & 1
        if bit:
            r0, r1 = r1, r0
        r1 = group.add(r0, r1)
        r0 = group.add(r0, r0)
        if bit:
            r0, r1 = r1, r0
    return r0


# Per-group native curve contexts of the secret-scalar path, made at a
# group's first scalar_mul.
_NATIVE_CURVES: dict = {}


def _native_curve(group):
    """The group's native context: ``"edwards"`` with 2d for ristretto255,
    ``"weierstrass_a0"`` with 3b for secp256k1 and BLS12-381 G1."""
    nc = _NATIVE_CURVES.get(group.name)
    if nc is None:
        from .. import native

        if isinstance(group, Ristretto255):
            nc = native.NativeCurve("edwards", P, 2 * D)
        else:
            nc = native.NativeCurve("weierstrass_a0", group.prime, 3 * group.b)
        _NATIVE_CURVES[group.name] = nc
    return nc


def _scalar_mul_ct(group, k: int, p):
    """k·P through the native constant-structure ladder (k reduced mod n)."""
    nc = _native_curve(group)
    out = nc.scalar_mul_ct([k % group.scalar_field.modulus], nc.encode_points([tuple(p)]),
                           group.scalar_field.modulus)
    return nc.decode_points(out)[0]


def _person(domain: bytes) -> bytes:
    """BLAKE2b personalisation from a domain tag (its first 16 bytes)."""
    return domain[:16]


class _PublicOps:
    """What both groups share with the JAX package's ``HostGroup``: the
    scalar byte codec and hash, and the operations on public scalars
    (variable-time double-and-add, so for verification data only, never
    a secret)."""

    def hash_to_scalar(self, data: bytes, domain: bytes = b"") -> int:
        """BLAKE2b-512 of ``data`` reduced mod the group order."""
        h = hashlib.blake2b(data, digest_size=64, person=_person(domain)).digest()
        return int.from_bytes(h, "little") % self.scalar_field.modulus

    def scalar_to_bytes(self, s: int) -> bytes:
        """s mod the order as ``scalar_field.nbytes`` little-endian bytes."""
        return int(s % self.scalar_field.modulus).to_bytes(self.scalar_field.nbytes, "little")

    def scalar_from_bytes(self, data: bytes) -> Optional[int]:
        """The scalar of :meth:`scalar_to_bytes`; None for a wrong length
        or a value not below the order."""
        if len(data) != self.scalar_field.nbytes:
            return None
        x = int.from_bytes(data, "little")
        return x if x < self.scalar_field.modulus else None

    def sub(self, p, q):
        return self.add(p, self.neg(q))

    def scalar_mul_vartime(self, k: int, p):
        """k·P by double-and-add from the low bit, k reduced mod n."""
        k %= self.scalar_field.modulus
        acc, base = self.identity(), p
        while k:
            if k & 1:
                acc = self.add(acc, base)
            base = self.add(base, base)
            k >>= 1
        return acc

    def msm(self, scalars, points):
        """Σ k_j·P_j, one :meth:`scalar_mul_vartime` a term, added in order."""
        acc = self.identity()
        for k, p in zip(scalars, points):
            acc = self.add(acc, self.scalar_mul_vartime(k, p))
        return acc

    def is_identity(self, p) -> bool:
        return self.eq(p, self.identity())


def _sqrt_mod(a: int, p: int) -> Optional[int]:
    """Square root mod p for p % 4 == 3 (secp256k1, BLS12-381)."""
    if p % 4 != 3:
        raise ValueError("_sqrt_mod needs p % 4 == 3")
    r = pow(a, (p + 1) // 4, p)
    return r if r * r % p == a % p else None


@dataclass(frozen=True)
class WeierstrassGroup(_PublicOps):
    """y^2 = x^3 + b over F_p (a = 0), the group of prime order n generated
    by (gen_x, gen_y), with the compressed SEC-style encoding (parity byte
    || big-endian x).  ``cofactor`` is the curve's order over n: 1 for
    secp256k1; BLS12-381 G1 clears its cofactor on hash and checks the
    subgroup on decode."""

    name: str
    base_field: FieldSpec
    scalar_field: FieldSpec
    b: int
    gen_x: int
    gen_y: int
    cofactor: int = 1

    @property
    def prime(self) -> int:
        return self.base_field.modulus

    @property
    def b3(self) -> int:
        return 3 * self.b % self.prime

    def identity(self) -> WsPoint:
        return (0, 1, 0)

    def generator(self) -> WsPoint:
        return (self.gen_x, self.gen_y, 1)

    def add(self, p, q):
        return ws_add(p, q, self.prime, self.b3)

    def neg(self, p):
        return ws_neg(p, self.prime)

    def eq(self, p, q) -> bool:
        return ws_eq(p, q, self.prime)

    def scalar_mul(self, k: int, p):
        """k·P for a SECRET k: the native constant-structure ladder."""
        return _scalar_mul_ct(self, k, p)

    def _scalar_mul_ladder(self, k: int, p):
        """The Python ladder, the native one's oracle (tests only)."""
        return _scalar_mul_ladder(self, k, p)

    def random_scalar(self, rng) -> int:
        return self.scalar_field.rand_int(rng)

    def to_affine(self, p) -> Optional[tuple[int, int]]:
        x, y, z = p
        if z % self.prime == 0:
            return None
        zi = pow(z, self.prime - 2, self.prime)
        return (x * zi % self.prime, y * zi % self.prime)

    def encode(self, p) -> bytes:
        aff = self.to_affine(p)
        nb = self.base_field.nbytes
        if aff is None:  # identity: all-zero encoding
            return bytes(1 + nb)
        x, y = aff
        return bytes([2 + (y & 1)]) + x.to_bytes(nb, "big")

    def decode(self, data: bytes):
        """The affine point of an :meth:`encode` output; None for a bad
        length or tag, an x off the curve or not below p, or (cofactor
        above 1) a point outside the order-n subgroup."""
        nb = self.base_field.nbytes
        if len(data) != 1 + nb:
            return None
        if data == bytes(1 + nb):
            return self.identity()
        tag = data[0]
        if tag not in (2, 3):
            return None
        x = int.from_bytes(data[1:], "big")
        if x >= self.prime:
            return None
        y = self.lift_x(x, tag & 1)
        if y is None:
            return None
        pt = (x, y, 1)
        if self.cofactor != 1 and not self.in_subgroup(pt):
            return None
        return pt

    def lift_x(self, x: int, parity: int) -> Optional[int]:
        rhs = (x * x % self.prime * x + self.b) % self.prime
        y = _sqrt_mod(rhs, self.prime)
        if y is None:
            return None
        if y & 1 != parity:
            y = self.prime - y
        return y

    def in_subgroup(self, p) -> bool:
        """n·P is the identity."""
        return ws_eq(self.mul_int(self.scalar_field.modulus, p), self.identity(), self.prime)

    def mul_int(self, k: int, p):
        """k·P for any non-negative integer k (not reduced mod n), by
        double-and-add from the low bit: the JAX package's ``_mul_int``,
        whose projective coordinates the commitment key inherits."""
        acc, base = self.identity(), p
        while k:
            if k & 1:
                acc = self.add(acc, base)
            base = self.add(base, base)
            k >>= 1
        return acc

    def hash_to_group(self, data: bytes, domain: bytes = b""):
        """Try-and-increment with cofactor clearing (public inputs only:
        the commitment key).  The first x with a square root gives the
        point (x, y even); its cofactor multiple is returned unless it is
        the identity."""
        ctr = 0
        while True:
            h = hashlib.blake2b(
                data + ctr.to_bytes(4, "little"),
                digest_size=self.base_field.nbytes + 16,
                person=_person(domain),
            ).digest()
            x = int.from_bytes(h, "little") % self.prime
            y = self.lift_x(x, 0)
            if y is not None:
                pt = self.mul_int(self.cofactor, (x, y, 1))
                if not self.eq(pt, self.identity()):
                    return pt
            ctr += 1


@dataclass(frozen=True)
class Ristretto255(_PublicOps):
    """The ristretto255 prime-order group over edwards25519, extended
    coordinates (X, Y, Z, T), identity (0, 1, 1, 0)."""

    name: str
    base_field: FieldSpec
    scalar_field: FieldSpec

    def identity(self) -> EdPoint:
        return ED_IDENTITY

    def generator(self) -> EdPoint:
        return ED_GENERATOR

    def add(self, p, q):
        return ed_add(p, q)

    def neg(self, p):
        return ed_neg(p)

    def eq(self, p, q) -> bool:
        return ristretto_eq(p, q)

    def scalar_mul(self, k: int, p):
        """k·P for a SECRET k: the native constant-structure ladder."""
        return _scalar_mul_ct(self, k, p)

    def _scalar_mul_ladder(self, k: int, p):
        """The Python ladder, the native one's oracle (tests only)."""
        return _scalar_mul_ladder(self, k, p)

    def random_scalar(self, rng) -> int:
        return self.scalar_field.rand_int(rng)

    def encode(self, p) -> bytes:
        return ristretto_encode(p)

    def decode(self, data: bytes):
        return ristretto_decode(data)

    def hash_to_group(self, data: bytes, domain: bytes = b"") -> EdPoint:
        """One-way map: BLAKE2b-512 -> two field elements -> MAP -> add
        (RFC 9496 §4.3.4)."""
        h = hashlib.blake2b(data, digest_size=64, person=_person(domain)).digest()
        mask = (1 << 255) - 1
        t0 = (int.from_bytes(h[:32], "little") & mask) % P
        t1 = (int.from_bytes(h[32:], "little") & mask) % P
        return ed_add(ristretto_map(t0), ristretto_map(t1))


RISTRETTO255 = Ristretto255("ristretto255", fspec.P25519, fspec.L25519)

SECP256K1 = WeierstrassGroup(
    "secp256k1",
    fspec.SECP256K1_P,
    fspec.SECP256K1_N,
    b=7,
    gen_x=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gen_y=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

BLS12_381_G1 = WeierstrassGroup(
    "bls12_381_g1",
    fspec.BLS12_381_P,
    fspec.BLS12_381_R,
    b=4,
    gen_x=0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    gen_y=0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
)

ALL_GROUPS = {g.name: g for g in (RISTRETTO255, SECP256K1, BLS12_381_G1)}
