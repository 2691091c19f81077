"""Pedersen commitment key: the second base ``h`` derived from the
ceremony's shared string by hash-to-group (no trusted setup).  The
batched commitments g·a + h·b live in the ceremony engine."""

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
