"""Batched polynomial evaluation and Lagrange interpolation over limb
tensors.

Counterpart of ``dkg_tpu/poly/device.py``.  ``eval_many`` runs its Horner
leg, ``acc <- acc·x + c`` over the coefficients: one ``mod_madd_horner``
launch, which composes ``mod_madd``'s step T times; or, under
``matmul=True``, its Vandermonde leg through ``fields.matmul.matmul_mod``
(the JAX package's default on a TPU).  Both give the canonical residue,
so the values are the same.  ``powers`` and the
Lagrange pair chain ``mod_mul``: every product is one launch (its plain
version on CPU tensors), and the denominators invert in one
``fields.device.batch_inv`` whose steps are ``mod_mul`` launches too, as
no one-launch batch inversion is built over the scalar fields.
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields import matmul as fmm
from ..fields.spec import FieldSpec
from ..ops import field_kernels as fk
from ..utils.scanchunk import map_chunked
from .host import DuplicateEvaluationPoints


# Bytes of eval_many's Vandermonde route a point may take (its powers and
# their 2L digit columns); the point axis is chunked to stay under it.
# Module-level so tests can shrink it to force the chunked route.
EVAL_VAND_BUDGET_BYTES = 1 << 30


def eval_many(fs: FieldSpec, coeffs: torch.Tensor, xs: torch.Tensor, *, matmul: bool = False) -> torch.Tensor:
    """Evaluate polynomials at many points.

    coeffs (..., T, L) low-order first, xs (..., N, L) -> (..., N, L);
    batch axes broadcast.  One ``mod_madd_horner`` launch; with ``matmul``
    (the JAX package's DKG_TPU_MXU=1), where the shapes allow it (coeffs
    (m, T, L) with T <= ``fields.matmul.MAX_K``, xs (N, L)), the
    Vandermonde form instead: V[i, l] = x_i^l (:func:`powers`) and one
    ``fields.matmul.matmul_mod`` C @ V^T, the point axis in chunks of
    EVAL_VAND_BUDGET_BYTES (a power of two of points, the last ragged).
    Both give the canonical residues."""
    t_coef = coeffs.shape[-2]
    if not (matmul and coeffs.dim() == 3 and xs.dim() == 2 and t_coef <= fmm.MAX_K):
        return fk.mod_madd_horner(fs, coeffs, xs)
    per_point = t_coef * 3 * fs.limbs * 4  # its powers and their 2L digit columns
    chunk = max(1, EVAL_VAND_BUDGET_BYTES // per_point)
    chunk = 1 << (chunk.bit_length() - 1)
    return map_chunked(xs.shape[-2], chunk,
                       lambda off, w: fmm.matmul_mod(fs, coeffs, powers(fs, xs[off : off + w], t_coef)), axis=-2)


def powers(fs: FieldSpec, x: torch.Tensor, count: int) -> torch.Tensor:
    """(1, x, x^2, ..., x^(count-1)): x (..., L) -> (..., count, L), one
    ``mod_mul`` launch a power above the first."""
    out = [fd.ones(fs, x.shape[:-1], device=x.device)]
    for _ in range(count - 1):
        out.append(fk.mod_mul(fs, out[-1], x))
    return torch.stack(out[:count], dim=-2)


def _check_distinct_nodes_device(fs: FieldSpec, xs: torch.Tensor) -> None:
    """Raise :class:`~dkg_tpu_torch.poly.host.DuplicateEvaluationPoints`
    if two nodes of a batch row are equal.  Comparing limb rows is exact
    for canonical limbs (every field op emits values < p)."""
    m = xs.shape[-2]
    if m <= 1:
        return
    flat = xs.reshape(-1, m, xs.shape[-1])
    for b in range(flat.shape[0]):
        if torch.unique(flat[b], dim=0).shape[0] != m:
            raise DuplicateEvaluationPoints(f"duplicate evaluation point among {m} Lagrange nodes (batch {b})")


def _prod_axis(fs: FieldSpec, terms: torch.Tensor) -> torch.Tensor:
    """The product over axis -2 of (..., M, M, L): M - 1 ``mod_mul``
    launches, each over every row at once."""
    acc = terms[..., 0, :]
    for j in range(1, terms.shape[-2]):
        acc = fk.mod_mul(fs, acc, terms[..., j, :])
    return acc


def lagrange_at_zero_coeffs(fs: FieldSpec, xs: torch.Tensor) -> torch.Tensor:
    """Lagrange coefficients λ_i(0) = Π_{j≠i} x_j / (x_j − x_i) for nodes
    xs: (..., M, L) -> the same shape.

    The numerators and denominators are products over the masked (M, M)
    grid of x_j and x_j − x_i (ones on the diagonal), 2 (M − 1) ``mod_mul``
    launches; the denominators invert in one Montgomery-trick
    ``fields.device.batch_inv`` down the M nodes (3 (M − 1) launches and a
    Fermat chain), and one launch multiplies.  Duplicate nodes would put a
    zero in a denominator, so they raise up front."""
    _check_distinct_nodes_device(fs, xs)
    m = xs.shape[-2]
    xi = xs[..., :, None, :]
    xj = xs[..., None, :, :]
    diff = fd.sub(fs, xj, xi)  # (..., M, M, L): x_j - x_i
    eye = torch.eye(m, dtype=torch.bool, device=xs.device)
    one = fd.ones(fs, device=xs.device)
    nums = _prod_axis(fs, fd.select(eye, one, xj.expand(diff.shape)))
    dens = _prod_axis(fs, fd.select(eye, one, diff))
    return fk.mod_mul(fs, nums, fd.batch_inv(fs, dens, axis=-2, mul=fk.mod_mul))


def lagrange_at_zero(fs: FieldSpec, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Interpolate through (xs, ys) and evaluate at 0: (..., M, L) ->
    (..., L), batched over the leading axes."""
    terms = fk.mod_mul(fs, lagrange_at_zero_coeffs(fs, xs), ys)
    acc = terms[..., 0, :]
    for j in range(1, terms.shape[-2]):
        acc = fd.add(fs, acc, terms[..., j, :])
    return acc
