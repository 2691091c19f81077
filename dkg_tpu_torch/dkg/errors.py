"""Protocol error taxonomy: a copy of ``dkg_tpu/dkg/errors.py``
(``DkgErrorKind``, ``DkgError``, ``ProofError``; the reference crate's
src/errors.rs).

Errors are returned, not raised: ``BatchedCeremony.run`` puts a
``DkgError`` under ``"error"`` when it aborts, and a phase transition of
``dkg/committee.py`` returns one in place of the next phase, since a
failing party may still have complaint evidence to publish."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class DkgErrorKind(enum.Enum):
    SHARE_VALIDITY_FAILED = "share validity check failed"
    FETCHED_INVALID_DATA = "fetched data addressed to a different recipient"
    SCALAR_OUT_OF_BOUNDS = "decrypted share is not a canonical scalar"
    MISBEHAVIOUR_HIGHER_THRESHOLD = "more misbehaving parties than threshold"
    NOT_ENOUGH_MEMBERS = "fewer honest members than threshold requires"
    INSUFFICIENT_SHARES_FOR_RECOVERY = "not enough disclosed shares to recover"
    INVALID_PROOF_OF_MISBEHAVIOUR = "proof of misbehaviour failed to verify"
    DUPLICATE_SENDER = "two broadcasts claim the same sender index"
    ZKP_VERIFICATION_FAILED = "zkp verification failed"
    DECODING_TO_SCALAR_FAILED = "decoding bytes to scalar failed"
    INCONSISTENT_MASTER_KEY = "inconsistent master key generation"
    FALSE_CLAIMED_EQUALITY = "complaint verification: false claimed equality"
    FALSE_CLAIMED_INEQUALITY = "complaint verification: false claimed inequality"
    PARTY_SHOULD_BE_DISQUALIFIED = "qualified member should have been dismissed"


@dataclass(frozen=True)
class DkgError(Exception):
    kind: DkgErrorKind
    index: int | None = None  # the party the error refers to, when meaningful
    detail: str = field(default="")

    def __str__(self) -> str:
        where = f" (party {self.index})" if self.index is not None else ""
        return f"{self.kind.value}{where}{': ' + self.detail if self.detail else ''}"

    @classmethod
    def from_proof(cls, err: "ProofError") -> "DkgError":
        """A ZKP failure as a DKG error."""
        return cls(DkgErrorKind.ZKP_VERIFICATION_FAILED, detail=err.detail)


@dataclass(frozen=True)
class ProofError(Exception):
    """A zero-knowledge proof failed to verify."""

    detail: str = ""
