"""Epoch wire messages and their deterministic byte codecs: a copy of
``dkg_tpu/epoch/messages.py``, the same bytes.

Three broadcast rounds an epoch operation (deal, complaints, confirm),
with the ceremony's wire discipline: fixed-width little-endian integers,
length-prefixed bytes, the group's point encodings; decoding untrusted
bytes never executes anything and malformed input raises ValueError
(the manager quarantines it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..dkg.broadcast import EncryptedShares
from ..utils import serde
from .state import KIND_REFRESH, KIND_RESHARE

_KINDS = (KIND_REFRESH, KIND_RESHARE)


@dataclass(frozen=True)
class EpochDeal:
    """One dealer's epoch-round-1 broadcast.

    ``commitments`` are the BARE Feldman commitments (g*c_l) of the
    dealt polynomial — epochs never need the Pedersen hiding leg, the
    dealt values are already bound by the previous epoch's commitments.
    For a refresh the constant term commits to zero (identity point);
    for a reshare it commits to the dealer's share of the current
    aggregate, and ``prev_commitments`` carries the dealer's claim of
    that aggregate so JOINERS (who hold no state yet) can bootstrap by
    t+1-majority over the claims.
    """

    kind: int
    epoch: int  # the epoch this deal CREATES (state.epoch + 1)
    commitments: tuple  # (t'+1) bare commitment points
    encrypted_shares: tuple  # EncryptedShares, one per new-committee member
    prev_commitments: tuple = ()  # reshare only: claimed current aggregate

    def shares_for(self, index: int) -> Optional[EncryptedShares]:
        for es in self.encrypted_shares:
            if es.recipient_index == index:
                return es
        return None


@dataclass(frozen=True)
class EpochComplaints:
    """Epoch-round-2 broadcast: dealers (old-committee indices) whose
    sealed share failed this member's decryption or bare-commitment
    check.  Always published (possibly empty) by every member of the
    NEW committee, so the round never times out structurally."""

    kind: int
    epoch: int
    accused: tuple  # old-committee dealer indices


@dataclass(frozen=True)
class EpochConfirm:
    """Epoch-round-3 broadcast: 16-byte digest of the resulting epoch
    state (state.confirm_digest).  An op concludes only when >= t'+1
    members published the same digest — agreement on the new aggregate
    before anyone discards old-epoch material."""

    kind: int
    epoch: int
    digest: bytes


def encode_epoch_deal(group, b: EpochDeal) -> bytes:
    w = serde.Writer(group)
    w.u8(b.kind)
    w.u16(b.epoch)
    w.u16(len(b.commitments))
    for c in b.commitments:
        w.point(c)
    w.u16(len(b.encrypted_shares))
    for es in b.encrypted_shares:
        serde._w_shares(w, es)
    w.u16(len(b.prev_commitments))
    for c in b.prev_commitments:
        w.point(c)
    return w.bytes()


def decode_epoch_deal(group, data: bytes) -> EpochDeal:
    r = serde.Reader(group, data)
    kind = r.u8()
    if kind not in _KINDS:
        raise ValueError("unknown epoch deal kind")
    epoch = r.u16()
    commitments = tuple(r.point() for _ in range(r.u16()))
    shares = tuple(serde._r_shares(r) for _ in range(r.u16()))
    prev = tuple(r.point() for _ in range(r.u16()))
    r.done()
    return EpochDeal(kind, epoch, commitments, shares, prev)


def encode_epoch_complaints(group, b: EpochComplaints) -> bytes:
    w = serde.Writer(group)
    w.u8(b.kind)
    w.u16(b.epoch)
    w.u16(len(b.accused))
    for j in b.accused:
        w.u16(j)
    return w.bytes()


def decode_epoch_complaints(group, data: bytes) -> EpochComplaints:
    r = serde.Reader(group, data)
    kind = r.u8()
    if kind not in _KINDS:
        raise ValueError("unknown epoch complaints kind")
    epoch = r.u16()
    accused = tuple(r.u16() for _ in range(r.u16()))
    r.done()
    return EpochComplaints(kind, epoch, accused)


def encode_epoch_confirm(group, b: EpochConfirm) -> bytes:
    w = serde.Writer(group)
    w.u8(b.kind)
    w.u16(b.epoch)
    w.lp(b.digest)
    return w.bytes()


def decode_epoch_confirm(group, data: bytes) -> EpochConfirm:
    r = serde.Reader(group, data)
    kind = r.u8()
    if kind not in _KINDS:
        raise ValueError("unknown epoch confirm kind")
    epoch = r.u16()
    digest = r.lp()
    if len(digest) != 16:
        raise ValueError("epoch confirm digest must be 16 bytes")
    r.done()
    return EpochConfirm(kind, epoch, digest)
