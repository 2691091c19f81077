"""Modular matrix multiply as int8 matrix products.

Counterpart of ``dkg_tpu/fields/matmul.py``.  The dealing round's share
matrix s[d, i] = f_d(x_i) is a Vandermonde product s = C @ V^T (mod p),
C[d, l] the coefficients and V[i, l] = x_i^l, and the scalar side of the
batch verification a one-row product; both are a contraction over K
terms of 16-bit-limb field elements.  :func:`matmul_mod` runs the
contraction as int8 matrix products with int32 accumulation and defers
every modular reduction to one pass per output element:

1. each 16-bit limb splits into two base-256 digits (:func:`_to_digits`);
2. the digits, shifted by -128 to int8, multiply over the contraction
   axis (``torch._int_mm`` on the card, the tensor cores' int8 product;
   on the CPU its plain version, an int64 ``torch.matmul``), exact since
   |sum| <= K * 128**2;
3. rank-1 corrections (row and column digit sums) undo the shift;
4. the digit products add into base-256 columns of the unreduced sum
   (:func:`_block_cols`), carry-normalised (:func:`_normalize_base256`);
5. the 2**(32L)-and-up tail folds back through 2**(32L) mod p
   (:func:`_fold_const`) and :func:`fields.device.reduce_wide` finishes
   (:func:`_reduce_block`).

The JAX package computes step 2 with ``lax.dot_general`` outside any
Pallas kernel and leaves steps 1 and 3-5 to XLA; here they are PyTorch
ops too.  The result is the canonical residue, equal limb for limb to
``mod_madd_horner`` / ``mod_madd_dot``'s.  ``poly.device.eval_many`` and
``dkg.ceremony._field_dot`` take this route under ``matmul=True``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.scanchunk import map_chunked
from . import device as fd
from .spec import FieldSpec, int_to_limbs

# Contraction chunk: keeps every base-256 column of a chunk's digit
# products below 2L * 255**2 * KCHUNK = 32 * 65025 * 1024 < 2**31 (the
# JAX package's uint32 bound; the port's columns are int64).
KCHUNK = 1024

# Output blocking: bounds a block's live column accumulator (M, NB, 4L-1)
# int64, its int32 products and their int64 copy, and its digits.
BLOCK_BYTES = 256 << 20

# Largest contraction: the 4L+2-byte accumulator holds values below
# 2**(32L+16) >= K * p**2, and _reduce_block's two folds assume K <= 2**14.
# Callers route a longer contraction elsewhere.
MAX_K = 16384

# torch._int_mm's shape rules on the card: M > 16, K and N multiples of 8
_MM_MIN_M, _MM_ALIGN = 17, 8


@functools.lru_cache(maxsize=None)
def _fold_const(fs: FieldSpec) -> np.ndarray:
    """2**(32L) mod p as L limbs: folds the b**(2L) tail of an over-wide
    accumulator back into the reducer's range."""
    return np.asarray(int_to_limbs(pow(2, 32 * fs.limbs, fs.modulus), fs.limbs), np.int64)


def _normalize_base256(cols: torch.Tensor, out_len: int) -> torch.Tensor:
    """Carry-propagate non-negative int64 base-256 columns into ``out_len``
    8-bit limbs, one column after another from the bottom."""
    k = cols.shape[-1]
    carry = torch.zeros(cols.shape[:-1], dtype=torch.int64, device=cols.device)
    out = torch.empty(cols.shape[:-1] + (out_len,), dtype=torch.int64, device=cols.device)
    for j in range(out_len):
        s = cols[..., j] + carry if j < k else carry
        out[..., j] = s & 0xFF
        carry = s >> 8
    return out


def _to_digits(a: torch.Tensor) -> torch.Tensor:
    """(..., L) 16-bit limbs -> (..., 2L) base-256 digits, little-endian,
    int32."""
    a = a.to(torch.int32)
    return torch.stack([a & 0xFF, (a >> 8) & 0xFF], dim=-1).reshape(a.shape[:-1] + (2 * a.shape[-1],))


def _int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 matrices a (M, K) and b (K, N), padded
    with zeros to ``torch._int_mm``'s shapes (M to 17 rows, K and N to
    multiples of 8: the zeros of the shifted operands add nothing): on the
    card ``torch._int_mm``, on the CPU its plain version, an int64
    ``torch.matmul`` of the same padded operands."""
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(m, _MM_MIN_M), -(-k // _MM_ALIGN) * _MM_ALIGN, -(-n // _MM_ALIGN) * _MM_ALIGN
    if (pm, pk) != (m, k):
        a = torch.nn.functional.pad(a, (0, pk - k, 0, pm - m))
    if (pk, pn) != (k, n):
        b = torch.nn.functional.pad(b, (0, pn - n, 0, pk - k))
    if a.device.type == "cpu":
        return (a.to(torch.int64) @ b.to(torch.int64)).to(torch.int32)[:m, :n]
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def _block_cols(fs: FieldSpec, a_dig: torch.Tensor, b_dig: torch.Tensor) -> torch.Tensor:
    """Base-256 columns of Σ_k a[m, k]·b[n, k] for one output block: a_dig
    (M, K, D), b_dig (NB, K, D) digits -> (M, NB, 4L+2) 8-bit limbs (int64)
    of the exact unreduced sums."""
    m, k, d = a_dig.shape
    nb = b_dig.shape[0]
    l = d // 2
    w = 2 * d - 1
    nlimb8 = 4 * l + 2  # value < K * p**2 < 2**(32L + 14)
    acc8 = None
    for k0 in range(0, k, KCHUNK):
        a_c = a_dig[:, k0 : k0 + KCHUNK]
        b_c = b_dig[:, k0 : k0 + KCHUNK]
        kc = a_c.shape[1]
        a_s = (a_c - 128).to(torch.int8)
        b_s = (b_c - 128).to(torch.int8)
        # rank-1 zero-point corrections over the kc real terms
        sa = a_c.sum(dim=1, dtype=torch.int64) - 128 * kc  # (M, D)
        sb = b_c.sum(dim=1, dtype=torch.int64) - 128 * kc  # (NB, D)
        b_flat = b_s.movedim(1, 0).reshape(kc, nb * d)  # (K, NB*D)
        corr_b = (128 * sb.reshape(nb * d) + 16384 * kc)[None, :]
        cols = torch.zeros((m, nb, w), dtype=torch.int64, device=a_dig.device)
        for u in range(d):
            g = _int8_dot(a_s[:, :, u], b_flat).to(torch.int64)  # (M, NB*D) shifted products
            g += 128 * sa[:, u][:, None] + corr_b  # exact unshifted digit products
            cols[:, :, u : u + d] += g.reshape(m, nb, d)
        part = _normalize_base256(cols, nlimb8)
        acc8 = part if acc8 is None else acc8 + part
    # chunk partials are 8-bit limbs (< 256 each); one more carry pass
    return _normalize_base256(acc8, nlimb8) if k > KCHUNK else acc8


def _reduce_block(fs: FieldSpec, total8: torch.Tensor) -> torch.Tensor:
    """(..., 4L+2) 8-bit limbs -> (..., L) canonical field elements, int32.

    Two folds of the top limb with c = 2**(32L) mod p: y0 < 2**(32L+14),
    y1 = lo + top·c < b**(2L) + 2**16·p, y2 < b**(2L) (top limb 0); then
    the field's reducer (:func:`fields.device.reduce_wide`)."""
    l = fs.limbs
    y = total8[..., 0::2] + (total8[..., 1::2] << 8)  # (..., 2L+1) 16-bit limbs
    c = torch.as_tensor(_fold_const(fs), device=y.device)
    pad = torch.nn.functional.pad
    for _ in range(2):
        folded = fd.mul_wide(y[..., 2 * l :], c)  # (..., L+1)
        cols = pad(y[..., : 2 * l], (0, 1)) + pad(folded[..., : 2 * l + 1], (0, max(0, 2 * l + 1 - folded.shape[-1])))
        y = fd.normalize(cols, 2 * l + 1, bits=18)
    return fd.reduce_wide(fs, y[..., : 2 * l]).to(torch.int32)


def matmul_mod(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a[m, k]·b[n, k] mod p: a (M, K, L), b (N, K, L) int32 limbs ->
    (M, N, L) canonical residues, equal to the Horner and dot kernels'.

    K <= MAX_K.  The N axis runs in blocks sized by BLOCK_BYTES, each
    block's digits made inside it (never for the whole N)."""
    m, k, l = a.shape
    if k > MAX_K:
        raise ValueError(f"matmul_mod contraction K={k} exceeds the 2**14 accumulator bound; "
                         "chunk the contraction and add partial sums mod p")
    n = b.shape[0]
    if not (m and n):
        return torch.empty((m, n, l), dtype=torch.int32, device=a.device)
    a_dig = _to_digits(a)
    # a block's bytes a column: int64 columns, int32 products and their
    # int64 copy, its int32 digits and their int8 shift
    per_col = m * (4 * l - 1) * 8 + m * 2 * l * (4 + 8) + k * 2 * l * (4 + 1)
    nb = max(1, min(n, BLOCK_BYTES // per_col))
    return map_chunked(n, nb, lambda n0, w: _reduce_block(fs, _block_cols(fs, a_dig, _to_digits(b[n0 : n0 + w]))),
                       axis=1)
