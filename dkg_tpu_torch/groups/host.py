"""Host-side (Python-int) group arithmetic for the ceremony slice.

A JAX-free copy of what the port needs from ``dkg_tpu/groups/host.py``:
the short Weierstrass a=0 group secp256k1 (complete RCB15 addition,
scalar multiplication, SEC encoding, try-and-increment hash-to-curve
for the Pedersen base ``h``) and the Edwards25519 constants behind the
ristretto255 curve spec.  Scalar multiplication is the pure-Python
fixed-length Montgomery ladder; only public data (table bases, test
oracles) goes through it on this path.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

from ..fields import spec as fspec
from ..fields.spec import FieldSpec

# ---------------------------------------------------------------------------
# Edwards25519 constants (the ristretto255 curve spec's base point and d)
# ---------------------------------------------------------------------------

P = (1 << 255) - 19
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
BASE_Y = (4 * pow(5, P - 2, P)) % P


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


def ws_eq(p: WsPoint, q: WsPoint, prime: int) -> bool:
    """Projective equality by cross-multiplication (identity-correct)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    if z1 % prime == 0 or z2 % prime == 0:
        return z1 % prime == z2 % prime
    return (x1 * z2 - x2 * z1) % prime == 0 and (y1 * z2 - y2 * z1) % prime == 0


def _sqrt_mod(a: int, p: int) -> Optional[int]:
    """Square root mod p for p % 4 == 3 (secp256k1)."""
    if p % 4 != 3:
        raise ValueError("_sqrt_mod needs p % 4 == 3")
    r = pow(a, (p + 1) // 4, p)
    return r if r * r % p == a % p else None


@dataclass(frozen=True)
class WeierstrassGroup:
    """y^2 = x^3 + b over F_p, prime order n (a = 0), cofactor 1, with the
    compressed SEC encoding (parity byte || big-endian x)."""

    name: str
    base_field: FieldSpec
    scalar_field: FieldSpec
    b: int
    gen_x: int
    gen_y: int

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

    def eq(self, p, q) -> bool:
        return ws_eq(p, q, self.prime)

    def scalar_mul(self, k: int, p):
        """k·P by the fixed-length Montgomery ladder (uniform add + double
        per bit; Python ints are not constant-time, so public data only)."""
        k %= self.scalar_field.modulus
        r0, r1 = self.identity(), p
        for i in reversed(range(self.scalar_field.modulus.bit_length())):
            bit = (k >> i) & 1
            if bit:
                r0, r1 = r1, r0
            r1 = self.add(r0, r1)
            r0 = self.add(r0, r0)
            if bit:
                r0, r1 = r1, r0
        return r0

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

    def lift_x(self, x: int, parity: int) -> Optional[int]:
        rhs = (x * x % self.prime * x + self.b) % self.prime
        y = _sqrt_mod(rhs, self.prime)
        if y is None:
            return None
        if y & 1 != parity:
            y = self.prime - y
        return y

    def hash_to_group(self, data: bytes, domain: bytes = b""):
        """Try-and-increment (public inputs only: the commitment key)."""
        ctr = 0
        while True:
            h = hashlib.blake2b(
                data + ctr.to_bytes(4, "little"),
                digest_size=self.base_field.nbytes + 16,
                person=domain[:16],
            ).digest()
            x = int.from_bytes(h, "little") % self.prime
            y = self.lift_x(x, 0)
            if y is not None:
                # cofactor clearing by 1 (identity + P), kept so the
                # projective coordinates equal the JAX package's
                return self.add(self.identity(), (x, y, 1))
            ctr += 1


SECP256K1 = WeierstrassGroup(
    "secp256k1",
    fspec.SECP256K1_P,
    fspec.SECP256K1_N,
    b=7,
    gen_x=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gen_y=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

ALL_GROUPS = {g.name: g for g in (SECP256K1,)}
