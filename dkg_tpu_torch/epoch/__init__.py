"""Epoch subsystem: proactive share refresh and committee resharing.

Counterpart of ``dkg_tpu/epoch/``.  The ceremony produces epoch 0, an
(n, t) sharing of the master secret; this package evolves that sharing
without ever changing the master public key:

* :class:`EpochManager`: the networked protocol, three broadcast rounds
  an operation over the ceremony's channel and WAL, crash resumable,
  churn and deadline bounded (``epoch.manager``);
* :mod:`.inprocess`: a serving lane's form, the same algebra as one
  batched device computation over a locally held share vector.
"""

from .errors import EpochError
from .manager import EPOCH_ROUND_BASE, ROUNDS_PER_OP, EpochManager, epoch_rounds
from .state import (
    KIND_NAMES,
    KIND_REFRESH,
    KIND_RESHARE,
    EpochState,
    confirm_digest,
    decode_epoch_state,
    encode_epoch_state,
    genesis_from_party_result,
)

__all__ = [
    "EPOCH_ROUND_BASE",
    "ROUNDS_PER_OP",
    "EpochError",
    "EpochManager",
    "EpochState",
    "KIND_NAMES",
    "KIND_REFRESH",
    "KIND_RESHARE",
    "confirm_digest",
    "decode_epoch_state",
    "encode_epoch_state",
    "epoch_rounds",
    "genesis_from_party_result",
]
