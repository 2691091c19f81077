"""ElGamal over a host group: key pairs, lifted homomorphic ElGamal, and
the hybrid (KEM + DEM) encryption of shares: the ElGamal KEM to a group
element, a BLAKE2b KDF to a ChaCha20 key and nonce, and the
stream-cipher DEM.

A JAX-free copy of ``dkg_tpu/crypto/elgamal.py``, the same values and
the same bytes on the wire.  ``group`` is a ``groups.host`` group.  A
(share, hiding) pair is sealed under one KEM point with two KDF
personalisations (:data:`PERSON_SHARE`, :data:`PERSON_RAND`); the
batched dealing round is ``dkg/hybrid_batch.py``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .chacha import chacha20_xor


@dataclass(frozen=True)
class Keypair:
    """sk, pk = g·sk."""

    sk: int
    pk: tuple

    @classmethod
    def generate(cls, group, rng) -> "Keypair":
        sk = group.random_scalar(rng)
        return cls(sk, group.scalar_mul(sk, group.generator()))

    @classmethod
    def from_secret(cls, group, sk: int) -> "Keypair":
        return cls(sk, group.scalar_mul(sk, group.generator()))


@dataclass(frozen=True)
class Ciphertext:
    """Lifted-ElGamal ciphertext (e1, e2) = (r·G, m·G + r·PK).

    It carries its group (left out of equality), so ``a + b``, ``a - b``,
    ``a * k`` and ``k * a`` work on it; ``add``, ``sub`` and
    ``mul_scalar`` take the group for a ciphertext without one."""

    e1: tuple
    e2: tuple
    group: object = None

    def add(self, group, other: "Ciphertext") -> "Ciphertext":
        """The homomorphic sum."""
        return Ciphertext(group.add(self.e1, other.e1), group.add(self.e2, other.e2), group)

    def sub(self, group, other: "Ciphertext") -> "Ciphertext":
        return Ciphertext(group.sub(self.e1, other.e1), group.sub(self.e2, other.e2), group)

    def mul_scalar(self, group, k: int) -> "Ciphertext":
        """The homomorphic scalar multiple."""
        return Ciphertext(group.scalar_mul(k, self.e1), group.scalar_mul(k, self.e2), group)

    def _require_group(self):
        if self.group is None:
            raise TypeError("operator form needs a group-carrying Ciphertext; use "
                            ".add/.sub/.mul_scalar(group, ...) or dataclasses.replace(ct, group=g)")
        return self.group

    def __add__(self, other):
        if not isinstance(other, Ciphertext):
            return NotImplemented
        return self.add(self._require_group(), other)

    def __sub__(self, other):
        if not isinstance(other, Ciphertext):
            return NotImplemented
        return self.sub(self._require_group(), other)

    def __mul__(self, k):
        if not isinstance(k, int):
            return NotImplemented
        return self.mul_scalar(self._require_group(), k)

    __rmul__ = __mul__

    def __eq__(self, other):  # the group is context, not content
        if not isinstance(other, Ciphertext):
            return NotImplemented
        return self.e1 == other.e1 and self.e2 == other.e2

    def __hash__(self):
        return hash((self.e1, self.e2))


def encrypt_point(group, pk: tuple, m_point: tuple, rng) -> Ciphertext:
    """ElGamal on a group element, r drawn from ``rng``."""
    return encrypt_point_with_random(group, pk, m_point, group.random_scalar(rng))


def encrypt_point_with_random(group, pk: tuple, m_point: tuple, r: int) -> Ciphertext:
    e1 = group.scalar_mul(r, group.generator())
    e2 = group.add(m_point, group.scalar_mul(r, pk))
    return Ciphertext(e1, e2, group)


def encrypt(group, pk: tuple, m: int, rng) -> Ciphertext:
    """Lifted ElGamal: encrypts m·G."""
    return encrypt_point(group, pk, group.scalar_mul(m, group.generator()), rng)


def decrypt_point(group, sk: int, c: Ciphertext) -> tuple:
    """m·G = e2 − sk·e1."""
    return group.sub(c.e2, group.scalar_mul(sk, c.e1))


# ---------------------------------------------------------------------------
# hybrid encryption: the share-delivery scheme
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HybridCiphertext:
    """(e1 = r·G, the ChaCha20-encrypted payload)."""

    e1: tuple
    ciphertext: bytes


@dataclass(frozen=True)
class SymmetricKey:
    """The KEM group element pk·r == sk·e1."""

    point: tuple


# KDF personalisation tags: the share and the hiding of a pair share one
# KEM point, domain-separated by the tag.
PERSON_SHARE = b"dkgtpu-kdf"
PERSON_RAND = b"dkgtpu-kd2"


def keystream_from_kem_bytes(kem_bytes: bytes, person: bytes) -> tuple[bytes, bytes]:
    """BLAKE2b-512(kem_bytes) -> (32-byte key, 12-byte nonce): the one
    definition of the KDF layout (``crypto.blake2.kdf_batch`` is its array
    twin)."""
    digest = hashlib.blake2b(kem_bytes, digest_size=64, person=person).digest()
    return digest[:32], digest[32:44]


def _keystream_params(group, kem_point: tuple, person: bytes = PERSON_SHARE) -> tuple[bytes, bytes]:
    return keystream_from_kem_bytes(group.encode(kem_point), person)


def hybrid_encrypt(group, pk: tuple, message: bytes, rng) -> HybridCiphertext:
    """KEM pk·r, DEM ChaCha20, r drawn from ``rng``."""
    return hybrid_encrypt_with_random(group, pk, message, group.random_scalar(rng))


def hybrid_encrypt_with_random(group, pk: tuple, message: bytes, r: int,
                               person: bytes = PERSON_SHARE) -> HybridCiphertext:
    """KEM pk·r, DEM ChaCha20, with the caller's randomness r."""
    e1 = group.scalar_mul(r, group.generator())
    kem = group.scalar_mul(r, pk)
    key, nonce = _keystream_params(group, kem, person)
    return HybridCiphertext(e1, chacha20_xor(key, nonce, message))


def recover_symmetric_key(group, sk: int, c: HybridCiphertext) -> SymmetricKey:
    """sk·e1."""
    return SymmetricKey(group.scalar_mul(sk, c.e1))


def hybrid_decrypt_with_key(group, symm: SymmetricKey, c: HybridCiphertext,
                            person: bytes = PERSON_SHARE) -> bytes:
    """Decrypt with a disclosed KEM key (the complaint check's path)."""
    key, nonce = _keystream_params(group, symm.point, person)
    return chacha20_xor(key, nonce, c.ciphertext)


def hybrid_decrypt(group, sk: int, c: HybridCiphertext, person: bytes = PERSON_SHARE) -> bytes:
    return hybrid_decrypt_with_key(group, recover_symmetric_key(group, sk, c), c, person)


# ---------------------------------------------------------------------------
# pair sealing: the wire format of share delivery
# ---------------------------------------------------------------------------


def rand_person(group, share_ct: HybridCiphertext, rand_ct: HybridCiphertext) -> bytes:
    """The KDF tag of a pair's randomness ciphertext: PERSON_RAND when it
    shares the share ciphertext's KEM point (the sealed-pair format),
    PERSON_SHARE for two independently encrypted halves."""
    return PERSON_RAND if group.eq(share_ct.e1, rand_ct.e1) else PERSON_SHARE


def seal_pair(group, pk: tuple, share_bytes: bytes, rand_bytes: bytes, rng
              ) -> tuple[HybridCiphertext, HybridCiphertext]:
    """Seal a (share, randomness) pair under one KEM exponentiation."""
    r = group.random_scalar(rng)
    e1 = group.scalar_mul(r, group.generator())
    kem = group.scalar_mul(r, pk)
    k1, n1 = _keystream_params(group, kem, PERSON_SHARE)
    k2, n2 = _keystream_params(group, kem, PERSON_RAND)
    return (HybridCiphertext(e1, chacha20_xor(k1, n1, share_bytes)),
            HybridCiphertext(e1, chacha20_xor(k2, n2, rand_bytes)))


def open_pair(group, sk: int, share_ct: HybridCiphertext, rand_ct: HybridCiphertext) -> tuple[bytes, bytes]:
    """Decrypt a pair in either layout (see :func:`rand_person`): one sk·e1
    for a shared KEM point, two for independent halves."""
    kem1 = recover_symmetric_key(group, sk, share_ct)
    kem2 = kem1 if group.eq(share_ct.e1, rand_ct.e1) else recover_symmetric_key(group, sk, rand_ct)
    return open_pair_with_kems(group, kem1, kem2, share_ct, rand_ct)


def open_pair_with_kems(group, kem1: SymmetricKey, kem2: SymmetricKey, share_ct: HybridCiphertext,
                        rand_ct: HybridCiphertext) -> tuple[bytes, bytes]:
    """The DEM half of :func:`open_pair`, with the KEM points given."""
    pt1 = hybrid_decrypt_with_key(group, kem1, share_ct, PERSON_SHARE)
    pt2 = hybrid_decrypt_with_key(group, kem2, rand_ct, rand_person(group, share_ct, rand_ct))
    return pt1, pt2
