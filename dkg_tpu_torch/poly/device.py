"""Batched polynomial evaluation over limb tensors.

Counterpart of ``dkg_tpu/poly/device.py`` ``eval_many``, its Horner leg:
one ``mod_madd`` launch per coefficient, ``acc <- acc·x + c``.  (On a TPU
the JAX package takes an int8 Vandermonde matmul instead; both legs give
the canonical residue, so the values are the same.)
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields.spec import FieldSpec
from ..ops import field_kernels as fk


def eval_many(fs: FieldSpec, coeffs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Evaluate polynomials at many points.

    coeffs (..., T, L) low-order first, xs (..., N, L) -> (..., N, L);
    batch axes broadcast."""
    batch = torch.broadcast_shapes(coeffs.shape[:-2], xs.shape[:-2])
    acc = fd.zeros(fs, batch + (xs.shape[-2],), device=coeffs.device)
    for l in reversed(range(coeffs.shape[-2])):
        acc = fk.mod_madd(fs, acc, xs, coeffs[..., l, None, :])
    return acc
