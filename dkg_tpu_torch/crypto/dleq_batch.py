"""Batched DLEQ proof generation and verification on the card.

Counterpart of ``dkg_tpu/crypto/dleq_batch.py``: all 2k announcements of
k proofs are one ``groups.device.scalar_mul`` (14 ``pt_add`` launches for
the per-lane tables, one ``pt_scalar_mul``), and all k verifications one
batched ``groups.device.msm`` with per-row m = 2 scalars (z, q − e)
against points (b_i, h_i) a leg.  Only the Fiat-Shamir transcripts,
BLAKE2b over canonical encodings, stay on the host.  The proof
convention is :mod:`.dleq`'s: e = H(b1, b2, h1, h2, a1, a2), z = w + e·x,
a verifier recomputes a_i = b_i·z − h_i·e.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dkg.ceremony import resolve_device
from ..fields import host as fh
from ..groups import device as gd
from .dleq import DleqZkp, _challenge


def _pairs_to_device(cs, points_a, points_b, device):
    """Two length-k host point lists -> one (k, 2, C, L) tensor."""
    interleaved = [p for pair in zip(points_a, points_b) for p in pair]
    return gd.from_host(cs, interleaved, device=device).reshape(len(points_a), 2, cs.ncoords, cs.field.limbs)


def generate_batch(group, cs, statements: list[tuple], rng, *, return_announcements: bool = False,
                   device="cuda"):
    """Prove every (base1, base2, point1, point2, dlog) statement: the
    nonces w drawn from ``rng`` in statement order (the JAX package's
    draws), the 2k announcements b_i·w in one ``scalar_mul`` on
    ``device``, challenges and responses on the host.  With
    ``return_announcements`` also the (a1, a2) host point pairs, which
    ``sign.verify.rlc_verify`` checks z against."""
    if not statements:
        return ([], []) if return_announcements else []
    dev = resolve_device(device)
    fs = group.scalar_field
    ws = [group.random_scalar(rng) for _ in statements]
    bases = _pairs_to_device(cs, [s[0] for s in statements], [s[1] for s in statements], dev)
    w_limbs = fh.to_tensor(fh.encode(fs, [[w, w] for w in ws]), dev)
    ann = gd.to_host(cs, gd.scalar_mul(cs, w_limbs, bases).reshape(-1, cs.ncoords, cs.field.limbs))
    proofs, anns = [], []
    for i, (b1, b2, h1, h2, x) in enumerate(statements):
        a1, a2 = ann[2 * i], ann[2 * i + 1]
        e = _challenge(group, b1, b2, h1, h2, a1, a2)
        proofs.append(DleqZkp(e, (ws[i] + e * x) % fs.modulus))
        anns.append((a1, a2))
    return (proofs, anns) if return_announcements else proofs


def msm_operands(group, cs, proofs: list[DleqZkp], statements: list[tuple], device) -> tuple:
    """:func:`verify_batch`'s MSM: scalars (k, 2 legs, m = 2, L) = (z, q − e)
    a leg, against points (k, 2 legs, m = 2, C, L) = (b_i, h_i)."""
    fs = group.scalar_field
    q = fs.modulus
    bases = _pairs_to_device(cs, [s[0] for s in statements], [s[1] for s in statements], device)
    points = _pairs_to_device(cs, [s[2] for s in statements], [s[3] for s in statements], device)
    z = fh.encode(fs, [[p.response] * 2 for p in proofs])
    ne = fh.encode(fs, [[(q - p.challenge) % q] * 2 for p in proofs])
    return fh.to_tensor(np.stack([z, ne], axis=2), device), torch.stack([bases, points], dim=2)


def verify_batch(group, cs, proofs: list[DleqZkp], statements: list[tuple], *, device="cuda") -> np.ndarray:
    """Check every proof against its (base1, base2, point1, point2) ->
    bool array, one entry a proof: a_i = b_i·z + h_i·(q − e) for all
    proofs and both legs in one ``gd.msm`` over (k, 2 legs, m = 2), then
    the challenges on the host."""
    if not proofs:
        return np.zeros((0,), dtype=bool)
    ann = gd.msm(cs, *msm_operands(group, cs, proofs, statements, resolve_device(device)))
    ann_host = gd.to_host(cs, ann.reshape(-1, cs.ncoords, cs.field.limbs))
    ok = np.zeros((len(proofs),), dtype=bool)
    for i, (proof, (b1, b2, h1, h2)) in enumerate(zip(proofs, statements)):
        ok[i] = proof.challenge == _challenge(group, b1, b2, h1, h2, ann_host[2 * i], ann_host[2 * i + 1])
    return ok
