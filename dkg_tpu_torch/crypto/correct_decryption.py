"""Proof that a disclosed KEM key is the right one.

A JAX-free copy of ``dkg_tpu/crypto/correct_decryption.py``.  A party
that complains about a hybrid ciphertext (e1, payload) discloses the KEM
point D and proves D = e1·sk and pk = g·sk, one DLEQ over the bases
(g, e1) and the points (pk, D), so any third party can decrypt the
payload again and re-check the share.  The statement order is the JAX
package's (its canonical order), on generation and verification alike.
"""

from __future__ import annotations

from dataclasses import dataclass

from .dleq import DleqZkp
from .elgamal import HybridCiphertext, SymmetricKey


@dataclass(frozen=True)
class CorrectHybridDecrKeyZkp:
    proof: DleqZkp

    @classmethod
    def generate(cls, group, c: HybridCiphertext, pk: tuple, symm_key: SymmetricKey, sk: int,
                 rng) -> "CorrectHybridDecrKeyZkp":
        return cls(DleqZkp.generate(group, group.generator(), c.e1, pk, symm_key.point, sk, rng))

    def verify(self, group, c: HybridCiphertext, pk: tuple, symm_key: SymmetricKey) -> bool:
        return self.proof.verify(group, group.generator(), c.e1, pk, symm_key.point)
