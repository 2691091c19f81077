"""Threshold signing over the ceremony's keys, on the card.

Counterpart of ``dkg_tpu/sign/`` with the same exported names, and no
pairing anywhere:

* :mod:`.hash2curve`: H(m), the host oracle and the batched BLAKE2b leg;
* :mod:`.partial`: the (messages x signers) grid of partial signatures in
  one ``scalar_mul`` a chunk, with DLEQ proofs made and checked in batch
  (``crypto.dleq_batch``);
* :mod:`.aggregate`: Lagrange aggregation at zero, one shared-weight
  Pippenger MSM over the message batch;
* :mod:`.verify`: a grid (or a convoy of grids) accepted in one
  random-linear-combination MSM, with bisecting blame;
* :mod:`.cache`: the quorum-stable material of a serving lane, with the
  folded sigma behind ``partial.sign_folded``'s one-lane signature.

The port reads no environment variable: the message chunk (256), the
partial-sign leg (``"device"``) and the RLC leg (``"device"``) are
arguments.
"""

from .aggregate import aggregate, aggregate_host, signature_encode
from .cache import CeremonyMaterial, SignCache
from .hash2curve import hash_to_curve_batch, hash_to_curve_host
from .partial import (
    PartialSignatures,
    folded_collect,
    partial_sign,
    partial_sign_host,
    public_keys,
    sign_folded,
    verify_partials,
)
from .verify import ConvoyReport, RlcReport, rlc_verify, rlc_verify_convoy

__all__ = [
    "CeremonyMaterial",
    "ConvoyReport",
    "PartialSignatures",
    "RlcReport",
    "SignCache",
    "aggregate",
    "aggregate_host",
    "folded_collect",
    "hash_to_curve_batch",
    "hash_to_curve_host",
    "partial_sign",
    "partial_sign_host",
    "public_keys",
    "rlc_verify",
    "rlc_verify_convoy",
    "sign_folded",
    "signature_encode",
    "verify_partials",
]
