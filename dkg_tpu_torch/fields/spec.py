"""Field specifications for the PyTorch limb arithmetic.

A field element is ``L`` little-endian 16-bit limbs, the layout of the
JAX package (``dkg_tpu/fields/spec.py``), so tensors compare limb for
limb across the two.  The port stores limbs in ``int32`` tensors: every
limb is < 2**16, so the values are exact, and PyTorch's CPU build has
signed ``add`` and ``>>`` where it has none for ``uint32``.  The CUDA
kernels read the same memory as ``uint32_t``.

What the ported ceremonies need is here: the moduli of secp256k1,
ristretto255 and BLS12-381 G1 (its 381-bit base field takes L = 24
limbs), the Barrett constants the plain multiply uses, and the limb
conversions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, n_limbs: int) -> np.ndarray:
    """Little-endian 16-bit limb decomposition of a non-negative int."""
    if x < 0:
        raise ValueError("int_to_limbs expects non-negative input")
    out = np.zeros(n_limbs, dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x != 0:
        raise ValueError(f"value does not fit in {n_limbs} limbs")
    return out


def limbs_to_int(limbs) -> int:
    """Inverse of :func:`int_to_limbs` (accepts any 1-D integer array)."""
    acc = 0
    for i, limb in enumerate(np.asarray(limbs, dtype=np.uint64).tolist()):
        acc += int(limb) << (LIMB_BITS * i)
    return acc


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field with its limb-representation parameters."""

    name: str
    modulus: int
    limbs: int  # number of 16-bit limbs; modulus < 2**(16*limbs)

    def __post_init__(self):
        if self.modulus >= 1 << (LIMB_BITS * self.limbs):
            raise ValueError("modulus does not fit in the limb budget")
        # Barrett needs the top limb of p non-zero (p >= b**(L-1)).
        if self.modulus < 1 << (LIMB_BITS * (self.limbs - 1)):
            raise ValueError("modulus too small for limb count (Barrett)")

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def nbytes(self) -> int:
        """Canonical little-endian encoding length."""
        return (self.bits + 7) // 8

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.limbs)

    @functools.cached_property
    def p_limbs_ext(self) -> np.ndarray:
        """p padded to L+1 limbs (Barrett remainders live mod b**(L+1))."""
        return int_to_limbs(self.modulus, self.limbs + 1)

    @functools.cached_property
    def barrett_mu(self) -> np.ndarray:
        """floor(b**(2L) / p) as L+1 limbs."""
        mu = (1 << (2 * LIMB_BITS * self.limbs)) // self.modulus
        return int_to_limbs(mu, self.limbs + 1)

    def rand_int(self, rng) -> int:
        """Uniform field element by rejection sampling from ``rng.getrandbits``
        (the same draw sequence as the JAX package, so one
        ``random.Random(seed)`` gives both packages the same values)."""
        while True:
            x = rng.getrandbits(self.bits)
            if x < self.modulus:
                return x


P25519 = FieldSpec("ed25519_base", (1 << 255) - 19, 16)
L25519 = FieldSpec(
    "ed25519_scalar",
    (1 << 252) + 27742317777372353535851937790883648493,
    16,
)
SECP256K1_P = FieldSpec("secp256k1_base", (1 << 256) - (1 << 32) - 977, 16)
SECP256K1_N = FieldSpec(
    "secp256k1_scalar",
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    16,
)

BLS12_381_P = FieldSpec(
    "bls12_381_base",
    0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    24,
)
BLS12_381_R = FieldSpec(
    "bls12_381_scalar",
    0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    16,
)

ALL_FIELDS = {
    fs.name: fs for fs in (P25519, L25519, SECP256K1_P, SECP256K1_N, BLS12_381_P, BLS12_381_R)
}
