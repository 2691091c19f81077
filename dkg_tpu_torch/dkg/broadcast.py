"""The broadcast channel's messages, complaints and their evidence.

A JAX-free copy of ``dkg_tpu/dkg/broadcast.py``: every message that
crosses the authenticated broadcast channel in rounds 1-5, the two share
equations, the complaint types and ``ProofOfMisbehaviour``, whose
disclosed KEM keys any third party can check.  Each ``check`` returns
the JAX package's ``DkgError`` kind and index for every rejection.

As in the JAX package, the misbehaviour proof's share check uses the
canonical base order g·share + h·randomness (the reference crate swaps
the bases there), and an undecodable plaintext upholds a complaint (the
dealer sent garbage) where the reference rejects it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

from ..crypto.commitment import CommitmentKey
from ..crypto.correct_decryption import CorrectHybridDecrKeyZkp
from ..crypto.elgamal import (PERSON_SHARE, HybridCiphertext, SymmetricKey, hybrid_decrypt_with_key, rand_person,
                              recover_symmetric_key)
from .errors import DkgError, DkgErrorKind
from .procedure_keys import MemberCommunicationKey, MemberCommunicationPublicKey

# ---------------------------------------------------------------------------
# the protocol's two share equations
# ---------------------------------------------------------------------------


def check_randomized_share(group, ck: CommitmentKey, index: int, share: int, rand: int, coeffs) -> bool:
    """g·s + h·s' == Σ_l index^l·E_l.  The share is still secret when its
    recipient runs this, so the left side takes the ladder; the Horner
    side is public."""
    lhs = group.add(group.scalar_mul(share, group.generator()), group.scalar_mul(rand, ck.h))
    return group.eq(lhs, _eval_comm(group, index, coeffs))


def check_bare_share(group, index: int, share: int, coeffs) -> bool:
    """g·s == Σ_l index^l·A_l."""
    return group.eq(group.scalar_mul(share, group.generator()), _eval_comm(group, index, coeffs))


def _eval_comm(group, index: int, coeffs):
    """Horner evaluation of a point polynomial at ``index`` (public data:
    variable time)."""
    acc = group.identity()
    for c in reversed(coeffs):
        acc = group.add(group.scalar_mul_vartime(index, acc), c)
    return acc


# ---------------------------------------------------------------------------
# round 1: dealing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EncryptedShares:
    """The sealed (share, hiding) pair for one recipient."""

    recipient_index: int  # 1-based
    share_ct: HybridCiphertext
    randomness_ct: HybridCiphertext


@dataclass(frozen=True)
class BroadcastPhase1:
    """The randomized coefficient commitments E_l = g·a_l + h·b_l and one
    EncryptedShares a committee member."""

    committed_coefficients: tuple  # (t+1) points
    encrypted_shares: tuple  # n EncryptedShares, recipient order

    def shares_for(self, index: int) -> Optional[EncryptedShares]:
        """The first EncryptedShares addressed to ``index``, or None."""
        return self._first_for.get(index)

    @functools.cached_property
    def _first_for(self) -> dict:
        """recipient index -> its first EncryptedShares, built once: a
        committee of n looks up n (n - 1) pairs in round 2."""
        first: dict = {}
        for es in self.encrypted_shares:
            first.setdefault(es.recipient_index, es)
        return first


# ---------------------------------------------------------------------------
# round 2: complaints with evidence
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProofOfMisbehaviour:
    """The disclosed KEM keys of a pair and their correctness proofs: any
    third party can decrypt the accused's ciphertexts again and re-run the
    share check."""

    symm_key_share: SymmetricKey
    symm_key_rand: SymmetricKey
    proof_share: CorrectHybridDecrKeyZkp
    proof_rand: CorrectHybridDecrKeyZkp

    @classmethod
    def generate(cls, group, shares: EncryptedShares, comm_key: MemberCommunicationKey,
                 rng) -> "ProofOfMisbehaviour":
        k1 = recover_symmetric_key(group, comm_key.sk, shares.share_ct)
        k2 = recover_symmetric_key(group, comm_key.sk, shares.randomness_ct)
        pk = comm_key.public().point
        p1 = CorrectHybridDecrKeyZkp.generate(group, shares.share_ct, pk, k1, comm_key.sk, rng)
        p2 = CorrectHybridDecrKeyZkp.generate(group, shares.randomness_ct, pk, k2, comm_key.sk, rng)
        return cls(k1, k2, p1, p2)

    def decrypt_scalars(self, group, shares: EncryptedShares) -> tuple[Optional[int], Optional[int]]:
        fs = group.scalar_field
        rp = rand_person(group, shares.share_ct, shares.randomness_ct)
        out = []
        for key, ct, person in ((self.symm_key_share, shares.share_ct, PERSON_SHARE),
                                (self.symm_key_rand, shares.randomness_ct, rp)):
            pt = hybrid_decrypt_with_key(group, key, ct, person)
            v = int.from_bytes(pt, "little") if len(pt) == fs.nbytes else None
            out.append(v if v is None or v < fs.modulus else None)
        return out[0], out[1]


@dataclass(frozen=True)
class MisbehavingPartiesRound1:
    """A round-2 complaint: the accused dealer, the claimed error, the
    evidence."""

    accused_index: int  # 1-based
    error: DkgErrorKind
    proof: ProofOfMisbehaviour

    def verify(self, group, ck: CommitmentKey, accuser_index: int, accuser_pk: MemberCommunicationPublicKey,
               accused_broadcast: BroadcastPhase1) -> bool:
        """True iff the accusation is upheld (the accused misbehaved)."""
        return self.check(group, ck, accuser_index, accuser_pk, accused_broadcast) is None

    def check(self, group, ck: CommitmentKey, accuser_index: int, accuser_pk: MemberCommunicationPublicKey,
              accused_broadcast: BroadcastPhase1) -> Optional[DkgError]:
        """None iff the accusation is upheld, else why it is rejected: find
        the ciphertexts addressed to the accuser, verify both disclosed-key
        proofs, decrypt again and re-run the commitment check at the
        accuser's index.  A rejection blames the accuser, so it carries
        ``index=accuser_index``."""
        shares = accused_broadcast.shares_for(accuser_index)
        if shares is None:
            return DkgError(DkgErrorKind.INVALID_PROOF_OF_MISBEHAVIOUR, index=accuser_index,
                            detail="no ciphertext addressed to the accuser")
        if not self.proof.proof_share.verify(group, shares.share_ct, accuser_pk.point, self.proof.symm_key_share) \
                or not self.proof.proof_rand.verify(group, shares.randomness_ct, accuser_pk.point,
                                                    self.proof.symm_key_rand):
            return DkgError(DkgErrorKind.INVALID_PROOF_OF_MISBEHAVIOUR, index=accuser_index,
                            detail=DkgErrorKind.ZKP_VERIFICATION_FAILED.value)
        s, r = self.proof.decrypt_scalars(group, shares)
        if s is None or r is None:
            return None  # upheld: the plaintext is not a scalar
        if check_randomized_share(group, ck, accuser_index, s, r, accused_broadcast.committed_coefficients):
            # the share verifies: the claimed inequality is false
            return DkgError(DkgErrorKind.FALSE_CLAIMED_INEQUALITY, index=accuser_index)
        return None


@dataclass(frozen=True)
class BroadcastPhase2:
    misbehaving_parties: tuple  # MisbehavingPartiesRound1


# ---------------------------------------------------------------------------
# rounds 3-5
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BroadcastPhase3:
    """The bare coefficient commitments A_l = g·a_l."""

    committed_coefficients: tuple  # (t+1) points


@dataclass(frozen=True)
class MisbehavingPartiesRound3:
    """A round-4 complaint: the accuser discloses the (share, randomness)
    it received from the accused, so third parties see that the bare
    commitments do not hold for it."""

    accused_index: int
    share: int
    randomness: int

    def verify(self, group, ck: CommitmentKey, accuser_index: int, randomized_coeffs,
               bare_coeffs: Optional[tuple]) -> bool:
        """Upheld iff the disclosed pair matches the round-1 randomized
        commitments and the round-3 bare ones fail for it (or are
        missing)."""
        return self.check(group, ck, accuser_index, randomized_coeffs, bare_coeffs) is None

    def check(self, group, ck: CommitmentKey, accuser_index: int, randomized_coeffs,
              bare_coeffs: Optional[tuple]) -> Optional[DkgError]:
        """None iff upheld, else why the complaint is rejected (blaming the
        accuser)."""
        if not check_randomized_share(group, ck, accuser_index, self.share, self.randomness, randomized_coeffs):
            # not the dealt pair: the claimed round-1 equality is false
            return DkgError(DkgErrorKind.FALSE_CLAIMED_EQUALITY, index=accuser_index)
        if bare_coeffs is not None and check_bare_share(group, accuser_index, self.share, bare_coeffs):
            # the bare commitments hold too: the claimed inequality is false
            return DkgError(DkgErrorKind.FALSE_CLAIMED_INEQUALITY, index=accuser_index)
        return None


@dataclass(frozen=True)
class BroadcastPhase4:
    misbehaving_parties: tuple  # MisbehavingPartiesRound3


@dataclass(frozen=True)
class DisclosedShare:
    """A share of ``accused_index``'s polynomial held by ``holder_index``,
    published for its reconstruction."""

    accused_index: int
    holder_index: int
    share: int


@dataclass(frozen=True)
class BroadcastPhase5:
    disclosed_shares: tuple  # DisclosedShare
