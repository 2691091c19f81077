"""Hybrid (KEM + DEM) encryption of shares over a host group: the
ElGamal KEM to a group element, a BLAKE2b KDF to a ChaCha20 key and
nonce, and the stream-cipher DEM.

Counterpart of the hybrid half of ``dkg_tpu/crypto/elgamal.py``, the
same bytes on the wire.  ``group`` is a ``groups.host`` group.  A
(share, hiding) pair is sealed under one KEM point with two KDF
personalisations (:data:`PERSON_SHARE`, :data:`PERSON_RAND`); the
batched dealing round is ``dkg/hybrid_batch.py``.  Plain lifted ElGamal
and key pairs are not ported.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .chacha import chacha20_xor


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
