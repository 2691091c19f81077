"""Chaum-Pedersen discrete-log-equality proof, Fiat-Shamir over BLAKE2b.

A JAX-free copy of ``dkg_tpu/crypto/dleq.py``: it proves knowledge of x
with point1 = base1·x and point2 = base2·x.  The proof is (challenge,
response); the challenge hashes both bases, both statement points and
both announcements, each by the group's canonical encoding, so the
transcript is the JAX package's byte for byte.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

DOMAIN_DLEQ = b"dkgtpu-dleq"


def _challenge(group, base1, base2, point1, point2, a1, a2) -> int:
    """e = BLAKE2b-512 over the six encodings, reduced mod the group order."""
    h = hashlib.blake2b(digest_size=64, person=DOMAIN_DLEQ)
    for p in (base1, base2, point1, point2, a1, a2):
        h.update(group.encode(p))
    return int.from_bytes(h.digest(), "little") % group.scalar_field.modulus


@dataclass(frozen=True)
class DleqZkp:
    """(challenge, response)."""

    challenge: int
    response: int

    @classmethod
    def generate(cls, group, base1, base2, point1, point2, dlog: int, rng) -> "DleqZkp":
        """Announce a_i = base_i·w, challenge e = H(transcript), response
        z = w + e·dlog.  The host ladder on Python ints is not
        constant-time: for tests and public replays."""
        w = group.random_scalar(rng)
        a1 = group.scalar_mul(w, base1)
        a2 = group.scalar_mul(w, base2)
        e = _challenge(group, base1, base2, point1, point2, a1, a2)
        return cls(e, (w + e * dlog) % group.scalar_field.modulus)

    def verify(self, group, base1, base2, point1, point2) -> bool:
        """Recompute a_i = base_i·z − point_i·e (public scalars, variable
        time) and check the challenge."""
        a1 = group.sub(group.scalar_mul_vartime(self.response, base1),
                       group.scalar_mul_vartime(self.challenge, point1))
        a2 = group.sub(group.scalar_mul_vartime(self.response, base2),
                       group.scalar_mul_vartime(self.challenge, point2))
        return self.challenge == _challenge(group, base1, base2, point1, point2, a1, a2)
