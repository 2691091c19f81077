"""Batched polynomial evaluation over limb tensors.

Counterpart of ``dkg_tpu/poly/device.py`` ``eval_many``, its Horner leg,
``acc <- acc·x + c`` over the coefficients: one ``mod_madd_horner``
launch, which composes ``mod_madd``'s step T times.  (On a TPU the JAX
package takes an int8 Vandermonde matmul instead; both legs give the
canonical residue, so the values are the same.)
"""

from __future__ import annotations

import torch

from ..fields.spec import FieldSpec
from ..ops import field_kernels as fk


def eval_many(fs: FieldSpec, coeffs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Evaluate polynomials at many points.

    coeffs (..., T, L) low-order first, xs (..., N, L) -> (..., N, L);
    batch axes broadcast."""
    return fk.mod_madd_horner(fs, coeffs, xs)
