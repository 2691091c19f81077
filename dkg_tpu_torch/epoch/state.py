"""Per-party epoch state: the aggregate sharing a committee holds now.

A copy of ``dkg_tpu/epoch/state.py``.  An epoch is one lifetime of one
(n, t) Shamir sharing of the master secret: epoch 0 is the ceremony's
output, and each successful refresh or reshare makes epoch k + 1.  All
of the state is public except ``share``: ``commitments`` are the Feldman
commitments (A_0 .. A_t) of the aggregate sharing polynomial F, so

* ``commitments[0] == g*F(0)`` is the master public key, the same in
  every epoch;
* ``g*share == eval(commitments, index)`` for every honest holder.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

from ..utils import serde

KIND_REFRESH = 1
KIND_RESHARE = 2
KIND_NAMES = {KIND_REFRESH: "refresh", KIND_RESHARE: "reshare"}


@dataclass(frozen=True)
class EpochState:
    """One party's view of the current epoch's sharing.

    ``index``/``share`` are None for observers (e.g. a joiner
    bootstrapping into a reshare, who holds no share of the CURRENT
    epoch); ``commitments`` is None only for a joiner before it has
    learned the current aggregate from the reshare deals.
    """

    epoch: int
    n: int
    t: int
    index: Optional[int]  # 1-based index in the current committee
    share: Optional[int]  # share of the aggregate polynomial F
    commitments: Optional[tuple]  # (t+1) aggregate bare commitments

    @property
    def master(self):
        """The master public key point (A_0), None for bootstrapping
        observers."""
        return self.commitments[0] if self.commitments else None

    @property
    def holds_share(self) -> bool:
        return self.index is not None and self.share is not None


def genesis_from_party_result(env, res) -> EpochState:
    """Epoch-0 state from a successful ceremony's party result ``res``
    (duck-typed: ``ok``, ``index``, ``share.value``, ``commitments``).

    Requires the aggregate commitments (the pointwise sum of the
    qualified dealers' bare commitments, defined when no dealer went
    through share reconstruction); raises EpochError otherwise, since
    epoch operations verify deals against them.
    """
    from .errors import EpochError

    if not res.ok or res.share is None:
        raise EpochError("NO_GENESIS", f"party {res.index} has no ceremony outcome")
    if res.commitments is None:
        raise EpochError(
            "NO_GENESIS",
            f"party {res.index} has no aggregate commitments "
            "(reconstruction-path ceremonies cannot seed epochs)",
        )
    return EpochState(
        epoch=0,
        n=env.nr_members,
        t=env.threshold,
        index=res.index,
        share=res.share.value,
        commitments=res.commitments,
    )


def confirm_digest(
    group, kind: int, epoch: int, n: int, t: int, commitments: tuple
) -> bytes:
    """16-byte digest every member of the NEW committee must agree on
    before an epoch op concludes: binds the op kind, the epoch number,
    the committee shape and the full aggregate commitment tuple (and
    therefore the master key)."""
    h = hashlib.blake2b(digest_size=16, person=b"dkgepoch")
    h.update(bytes([kind]))
    h.update(epoch.to_bytes(4, "little"))
    h.update(n.to_bytes(2, "little"))
    h.update(t.to_bytes(2, "little"))
    for c in commitments:
        h.update(group.encode(c))
    return h.digest()


def encode_epoch_state(group, st: EpochState) -> bytes:
    """Deterministic byte encoding (WAL confirm records pin this)."""
    w = serde.Writer(group)
    w.u32(st.epoch)
    w.u16(st.n)
    w.u16(st.t)
    w.u8(1 if st.index is not None else 0)
    if st.index is not None:
        w.u16(st.index)
    w.u8(1 if st.share is not None else 0)
    if st.share is not None:
        w.scalar(st.share)
    w.u8(1 if st.commitments is not None else 0)
    if st.commitments is not None:
        w.u16(len(st.commitments))
        for c in st.commitments:
            w.point(c)
    return w.bytes()


def decode_epoch_state(group, data: bytes) -> EpochState:
    """Inverse of :func:`encode_epoch_state`; raises ValueError on
    malformed bytes."""
    r = serde.Reader(group, data)
    epoch = r.u32()
    n = r.u16()
    t = r.u16()
    index = r.u16() if r.u8() else None
    share = r.scalar() if r.u8() else None
    commitments = None
    if r.u8():
        commitments = tuple(r.point() for _ in range(r.u16()))
    r.done()
    return EpochState(epoch, n, t, index, share, commitments)
