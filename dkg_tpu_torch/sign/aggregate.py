"""Lagrange aggregation of partial signatures at zero.

Counterpart of ``dkg_tpu/sign/aggregate.py``.  A threshold signature
over shares s_i on nodes x_i is

    sig(m) = Σ_i λ_i(0)·sig_i(m),   sig_i(m) = s_i·H(m),

since interpolation at zero recovers f(0) in the exponent.  The
coefficients come from ``poly.device.lagrange_at_zero_coeffs`` (or the
caller's cache), and the point sum of every message is one Pippenger
MSM with the weights shared by the message batch: one ``pt_bucket_sum``
launch scatters, one ``pt_bucket_close`` closes, one ``pt_window_step``
a window combines.  :func:`aggregate_host` is the big-int oracle;
:func:`signature_encode` gives ``group.encode``'s bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import host as fh
from ..groups import device as gd
from ..poly import device as pd
from ..poly import host as ph
from .partial import PartialSignatures


def aggregate(ps: PartialSignatures, subset: list[int] | None = None, lam=None) -> torch.Tensor:
    """Aggregate a t + 1 subset of the partials into full signatures:
    canonical affine limbs (B, C, L) where ``ps.sigs`` lie.

    ``subset``: positions into ``ps.indices`` (default all).  ``lam``:
    the subset's (M, L) Lagrange-at-zero limbs when the caller holds them
    (``sign.cache.SignCache.lagrange_at_zero``, limb for limb the device
    derivation's); by default derived on the device."""
    cs = gd.ALL_CURVES[ps.curve]
    dev = ps.sigs.device
    pos = list(range(len(ps.indices))) if subset is None else list(subset)
    sigs = ps.sigs[:, pos]  # (B, M, C, L)
    if lam is None:
        xs = fh.to_tensor(fh.encode(cs.scalar, [ps.indices[p] for p in pos]), dev)
        lam = pd.lagrange_at_zero_coeffs(cs.scalar, xs)
    elif not isinstance(lam, torch.Tensor):
        lam = fh.to_tensor(lam, dev)
    return gd.affine_canon(cs, gd.msm_pippenger(cs, lam, sigs))


def aggregate_host(group, indices: list[int], sig_rows: list[list]) -> list:
    """Big-int oracle: each message's Lagrange-weighted host MSM over the
    subset's partials (``sig_rows``: [message][signer] host tuples in
    ``indices`` order).  Compare through ``group.encode``."""
    fs = group.scalar_field
    xs = [i % fs.modulus for i in indices]
    lams = [ph.lagrange_coefficient(fs, 0, i, xs) for i in range(len(xs))]
    return [group.msm(lams, row) for row in sig_rows]


def signature_encode(curve: str, sigs) -> list[bytes]:
    """Signature wire bytes of a (B, C, L) batch, ``HostGroup.encode``'s
    row by row (``groups.device.encode_batch``: on a CUDA tensor one
    canonical affine form on the card)."""
    enc = gd.encode_batch(gd.ALL_CURVES[curve], sigs)
    return [row.tobytes() for row in np.asarray(enc)]
