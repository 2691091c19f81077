"""The key roles of the DKG procedure and the canonical committee order.

A JAX-free copy of ``dkg_tpu/dkg/procedure_keys.py``: a party's final
secret share and its public share, the long-term communication key pair
that shares are sealed to, the byte-lexicographic order of the encoded
communication keys every party indexes the committee by, the opening
and decoding of a sealed (share, hiding) pair with the reason a value
failed, and the master public key with its two cross-checks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..crypto.elgamal import HybridCiphertext, Keypair, open_pair
from .errors import DkgError, DkgErrorKind


@dataclass(frozen=True)
class MemberSecretShare:
    """The party's final secret share x_i."""

    value: int


@dataclass(frozen=True)
class MemberPublicShare:
    """g·x_i."""

    point: tuple


@dataclass(frozen=True)
class MemberCommunicationKey:
    """The long-term key pair shares are sealed to."""

    keypair: Keypair

    @classmethod
    def generate(cls, group, rng) -> "MemberCommunicationKey":
        return cls(Keypair.generate(group, rng))

    @property
    def sk(self) -> int:
        return self.keypair.sk

    def public(self) -> "MemberCommunicationPublicKey":
        return MemberCommunicationPublicKey(self.keypair.pk)


@dataclass(frozen=True)
class MemberCommunicationPublicKey:
    point: tuple

    def sort_key(self, group) -> bytes:
        """The committee order: byte-lexicographic on the encoded key."""
        return group.encode(self.point)


def sort_committee(group, pks: list[MemberCommunicationPublicKey]) -> list[MemberCommunicationPublicKey]:
    """The sorted committee: every party derives the same indices."""
    return sorted(pks, key=lambda k: k.sort_key(group))


def decrypt_shares(group, sk: MemberCommunicationKey, share_ct: HybridCiphertext,
                   randomness_ct: HybridCiphertext) -> tuple[Optional[int], Optional[int]]:
    """The (share, hiding) pair addressed to us; None for a value that is
    not a canonical scalar."""
    (s, r), _ = decrypt_shares_detailed(group, sk, share_ct, randomness_ct)
    return s, r


def decrypt_shares_detailed(group, sk: MemberCommunicationKey, share_ct: HybridCiphertext,
                            randomness_ct: HybridCiphertext):
    """:func:`decrypt_shares` with the reason a value failed:
    ((s | None, r | None), kind | None), see :func:`decode_scalar_pair`."""
    pt1, pt2 = open_pair(group, sk.sk, share_ct, randomness_ct)
    return decode_scalar_pair(group, pt1, pt2)


def decode_scalar_pair(group, pt1: bytes, pt2: bytes):
    """Decode two plaintexts to scalars, the one classification of the
    serial and batched paths: ((s | None, r | None), kind | None), the kind
    of the first failure, DECODING_TO_SCALAR_FAILED for a wrong length,
    SCALAR_OUT_OF_BOUNDS for a value not below the order."""
    fs = group.scalar_field
    kind = None
    out = []
    for pt in (pt1, pt2):
        if len(pt) != fs.nbytes:
            out.append(None)
            kind = kind or DkgErrorKind.DECODING_TO_SCALAR_FAILED
            continue
        v = int.from_bytes(pt, "little")
        if v >= fs.modulus:
            out.append(None)
            kind = kind or DkgErrorKind.SCALAR_OUT_OF_BOUNDS
            continue
        out.append(v)
    return (out[0], out[1]), kind


@dataclass(frozen=True)
class MasterPublicKey:
    """The ceremony's output: the sum of the qualified parties' public
    shares."""

    point: tuple

    @classmethod
    def from_shares(cls, group, shares: list) -> "MasterPublicKey":
        acc = group.identity()
        for p in shares:
            acc = group.add(acc, p.point if isinstance(p, MemberPublicShare) else p)
        return cls(acc)

    def check_consistent(self, group, others: list):
        """None when every other party's master key equals this one, else
        DkgError(INCONSISTENT_MASTER_KEY) at the first that differs."""
        for i, other in enumerate(others):
            pt = other.point if isinstance(other, MasterPublicKey) else other
            if not group.eq(self.point, pt):
                return DkgError(DkgErrorKind.INCONSISTENT_MASTER_KEY, index=i)
        return None

    def check_reproduced_by(self, group, scalar: int):
        """None when g·scalar is this key (an interpolated secret), else
        DkgError(INCONSISTENT_MASTER_KEY)."""
        if not group.eq(self.point, group.scalar_mul(scalar, group.generator())):
            return DkgError(DkgErrorKind.INCONSISTENT_MASTER_KEY)
        return None
