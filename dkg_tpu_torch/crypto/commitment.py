"""Pedersen commitments over a host group: the commitment key (the second
base ``h``, derived from the ceremony's shared string by hash-to-group,
no trusted setup), commit = g·m + h·r, its opening and its check.

A JAX-free copy of ``dkg_tpu/crypto/commitment.py``.  The batched
commitments g·a + h·b of a dealing round live in the ceremony engine."""

from __future__ import annotations

from dataclasses import dataclass

from ..groups.host import Ristretto255, WeierstrassGroup

DOMAIN_COMMITMENT_KEY = b"dkgtpu-ck"


@dataclass(frozen=True)
class CommitmentKey:
    """The second Pedersen base ``h``."""

    h: tuple

    @classmethod
    def generate(cls, group: WeierstrassGroup | Ristretto255, shared_string: bytes) -> "CommitmentKey":
        """Deterministic from the shared string: every party derives the
        same ``h``, in the JAX package's projective coordinates (the
        Edwards table for ``h`` is built from its affine x, y)."""
        return cls(group.hash_to_group(shared_string, DOMAIN_COMMITMENT_KEY))


@dataclass(frozen=True)
class Open:
    """A commitment's opening (m, r)."""

    m: int
    r: int


def commit_with_random(group, ck: CommitmentKey, m: int, r: int):
    """g·m + h·r."""
    return group.add(group.scalar_mul(m, group.generator()), group.scalar_mul(r, ck.h))


def commit(group, ck: CommitmentKey, m: int, rng) -> tuple:
    """Commit with r drawn from ``rng``: (commitment, Open)."""
    r = group.random_scalar(rng)
    return commit_with_random(group, ck, m, r), Open(m, r)


def verify(group, ck: CommitmentKey, commitment, o: Open) -> bool:
    """Recompute and compare."""
    return group.eq(commitment, commit_with_random(group, ck, o.m, o.r))
