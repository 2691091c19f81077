"""Batched modular arithmetic on 16-bit limb tensors (plain PyTorch).

The counterpart of ``dkg_tpu/fields/device.py``: a field element is
``L`` little-endian 16-bit limbs in an ``int32`` tensor of shape
``(..., L)``, batched over the leading axes, and every operation returns
the canonical residue in ``[0, p)``.  So the results equal the JAX
package's limb for limb, whichever reduction either side runs.

Public functions take and return ``int32`` limbs.  Inside, limbs widen
to ``int64``: schoolbook columns reach ``L * 2**32`` and a borrow is
``s < 0`` rather than the JAX package's ``uint32`` wrap ``s >> 31``.
These functions are also the plain versions that the CUDA kernels in
``dkg_tpu_torch/ops`` are held against: :func:`mul` of ``mod_mul``,
:func:`_mul_gemm` of ``mxu_mod_mul``.

:func:`pow_const`, :func:`inv` and :func:`batch_inv` chain a multiply
given as ``mul=`` (default :func:`mul`, resolved when called): the device
path passes a kernel wrapper, so each step is one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from .spec import FieldSpec, int_to_limbs

MASK16 = 0xFFFF


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def _limb_const(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(limbs.astype(np.int64), device=like.device)


# ---------------------------------------------------------------------------
# carry / borrow primitives (int64 in, int64 out)
# ---------------------------------------------------------------------------


def _carry(cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Propagate signed column carries: (..., K) int64 columns ->
    (16-bit limbs, the carry out of the top limb).

    Each round moves every column's carry (an arithmetic shift, so a
    borrow is -1) one limb up, all columns at once, until none is left:
    a few rounds for random values, at most K when a carry ripples
    through a run of 0xFFFF (or a borrow through a run of 0) limbs."""
    out = torch.zeros_like(cols[..., -1])
    while True:
        carry = cols >> 16
        out = out + carry[..., -1]
        if not bool(carry[..., :-1].any()):
            return cols & MASK16, out
        cols = (cols & MASK16) + torch.nn.functional.pad(carry[..., :-1], (1, 0))


def normalize(cols: torch.Tensor, out_len: int) -> torch.Tensor:
    """Carry-propagate non-negative columns into ``out_len`` 16-bit limbs,
    taken mod ``2**(16*out_len)``."""
    k = cols.shape[-1]
    cols = torch.nn.functional.pad(cols, (0, out_len - k)) if k < out_len else cols[..., :out_len]
    return _carry(cols)[0]


def sub_with_borrow(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a - b) mod 2**(16K) and the final borrow (1 iff a < b)."""
    limbs, top = _carry(a - b)
    return limbs, (top < 0).to(torch.int64)


def cond_sub(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Branchless ``x - m if x >= m else x`` on equal-length limbs."""
    d, borrow = sub_with_borrow(x, m)
    return torch.where((borrow != 0)[..., None], x, d)


# ---------------------------------------------------------------------------
# multiply and Barrett reduction
# ---------------------------------------------------------------------------


def _mul_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unnormalized schoolbook product columns of int64 limb tensors:
    (..., La) x (..., Lb) -> (..., La+Lb), column i+j taking the low 16
    bits of a_i·b_j and column i+j+1 its high 16 bits (each column < 2**22
    for L <= 24)."""
    la, lb = a.shape[-1], b.shape[-1]
    prod = (a[..., :, None] * b[..., None, :]).flatten(-2)  # 16x16 -> 32 bits, exact
    col = (torch.arange(la, device=a.device)[:, None] + torch.arange(lb, device=a.device)).flatten()
    cols = torch.zeros(prod.shape[:-1] + (la + lb,), dtype=torch.int64, device=prod.device)
    cols.index_add_(-1, col, prod & MASK16)
    cols.index_add_(-1, col + 1, prod >> 16)
    return cols


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of int64 limb tensors: (..., La) x (..., Lb) -> (..., La+Lb)."""
    return normalize(_mul_columns(a, b), a.shape[-1] + b.shape[-1])


def barrett_reduce(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Reduce a normalized 2L-limb int64 value mod p (HAC 14.42, b = 2**16):
    the quotient estimate is short by at most 2, fixed by two conditional
    subtractions."""
    L = fs.limbs
    mu = _limb_const(fs.barrett_mu, x)
    p_ext = _limb_const(fs.p_limbs_ext, x)
    q3 = mul_wide(x[..., L - 1 :], mu)[..., L + 1 :]
    r2 = mul_wide(q3, p_ext)[..., : L + 1]
    r, _ = sub_with_borrow(x[..., : L + 1], r2)  # mod b**(L+1): r in [0, 3p)
    r = cond_sub(r, p_ext)
    r = cond_sub(r, p_ext)
    return r[..., :L]


# ---------------------------------------------------------------------------
# the modular ops (int32 limbs in, canonical int32 limbs out)
# ---------------------------------------------------------------------------


def zeros(fs: FieldSpec, batch: tuple = (), *, device) -> torch.Tensor:
    return torch.zeros(batch + (fs.limbs,), dtype=torch.int32, device=device)


def ones(fs: FieldSpec, batch: tuple = (), *, device) -> torch.Tensor:
    out = zeros(fs, batch, device=device)
    out[..., 0] = 1
    return out


def constant(fs: FieldSpec, value: int, *, device) -> torch.Tensor:
    limbs = int_to_limbs(value % fs.modulus, fs.limbs)
    return torch.as_tensor(limbs.astype(np.int32), device=device)


def add(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = normalize(_wide(a) + _wide(b), fs.limbs + 1)  # limb sums < 2**17
    return cond_sub(s, _limb_const(fs.p_limbs_ext, s))[..., : fs.limbs].to(torch.int32)


def sub(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # (a + p) - b stays non-negative: [0, 2p), then one conditional subtract
    ap = normalize(_wide(a) + _limb_const(fs.p_limbs, a), fs.limbs + 1)
    b_ext = torch.nn.functional.pad(_wide(b), (0, 1))
    d, _ = sub_with_borrow(ap, b_ext)
    return cond_sub(d, _limb_const(fs.p_limbs_ext, d))[..., : fs.limbs].to(torch.int32)


def neg(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(fs, torch.zeros_like(a), a)


def mul(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return barrett_reduce(fs, mul_wide(_wide(a), _wide(b))).to(torch.int32)


def _mul_gemm(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a·b) mod p by the fused multiply-reduce (``fs.mulred``): the plain
    version of the ``mxu_mod_mul`` kernel, the JAX package's
    ``fields.device._mul_gemm`` step for step.

    1. the unnormalized product columns (:func:`_mul_columns`);
    2. the high half's three byte planes and P_{L-1}'s spill, 3L+1 digits
       in :class:`~dkg_tpu_torch.fields.spec.MulReduceSpec`'s order,
       folded against the byte matrix ``foldm`` as an int64 sum of
       digit x byte products (exact: every column sum is < 2**24 by the
       admission proof), never a floating-point product;
    3. ``n_split`` scan-free column folds through c = b**L mod p, one
       normalize into L+1 limbs, the quotient from ``qtable`` indexed by
       the top bits, w = v - q·p, one conditional subtraction.

    The result is the canonical residue, equal to :func:`mul`'s."""
    mr = fs.mulred
    if mr is None:
        raise ValueError(f"{fs.name} does not admit the fused multiply-reduce")
    L = fs.limbs
    cols = _mul_columns(_wide(a), _wide(b))
    plo, phi = cols[..., :L], cols[..., L:]
    digits = torch.cat([phi & 0xFF, (phi >> 8) & 0xFF, phi >> 16, plo[..., L - 1 :] >> 16], dim=-1)
    foldm = _limb_const(mr.foldm, cols)  # (3L+1, 2L) bytes
    cols8 = torch.zeros_like(cols)
    for i in range(3 * L + 1):
        cols8 += digits[..., i : i + 1] * foldm[i]
    keep = torch.cat([plo[..., : L - 1], plo[..., L - 1 :] & MASK16], dim=-1)
    cols = keep + cols8[..., 0::2] + (cols8[..., 1::2] << 8)
    c = _limb_const(mr.c_limbs, cols)
    for _ in range(mr.n_split):
        hi16 = cols >> 16
        cols = (cols & MASK16) + torch.nn.functional.pad(hi16[..., :-1], (1, 0)) + hi16[..., L - 1 :] * c
    v = normalize(cols, L + 1)
    u = (v[..., L - 1] >> mr.shift_e) | (v[..., L] << (16 - mr.shift_e))
    q = _limb_const(mr.qtable, v)[u]
    w = normalize(v + q[..., None] * _limb_const(mr.np_limbs, v), L + 1)
    return cond_sub(w, _limb_const(fs.p_limbs_ext, w))[..., :L].to(torch.int32)


def square(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mul(fs, a, a)


def pow_const(fs: FieldSpec, x: torch.Tensor, e: int, *, mul=None) -> torch.Tensor:
    """x**e mod p for a public exponent, MSB first: one squaring a bit and
    one multiply by x a set bit (the exponent is public, so a zero bit
    skips its multiply; the value equals the JAX package's
    square-and-select).  ``mul(fs, a, b)`` is the multiply chained."""
    if e < 0:
        raise ValueError("negative exponent")
    mul = globals()["mul"] if mul is None else mul
    if e == 0:
        return ones(fs, x.shape[:-1], device=x.device)
    acc = x
    for bit in bin(e)[3:]:
        acc = mul(fs, acc, acc)
        if bit == "1":
            acc = mul(fs, acc, x)
    return acc


def inv(fs: FieldSpec, x: torch.Tensor, *, mul=None) -> torch.Tensor:
    """Fermat inverse x**(p-2); maps 0 to 0 (callers guard zero)."""
    return pow_const(fs, x, fs.modulus - 2, mul=mul)


def batch_inv(fs: FieldSpec, x: torch.Tensor, axis: int = 0, *, mul=None) -> torch.Tensor:
    """Montgomery-trick inversion along ``axis``: one Fermat inversion and
    3(k-1) multiplies for k elements, each over the other axes at once.
    A zero input spoils its own lane only (callers never invert zero)."""
    mul = globals()["mul"] if mul is None else mul
    x = x.movedim(axis, 0)
    k = x.shape[0]
    prefix = [ones(fs, x.shape[1:-1], device=x.device)]  # exclusive prefix products
    total = x[0]
    for i in range(1, k):
        prefix.append(total)
        total = mul(fs, total, x[i])
    run = inv(fs, total, mul=mul)
    out = [None] * k
    for i in reversed(range(k)):
        out[i] = mul(fs, run, prefix[i]) if i else run
        if i:
            run = mul(fs, run, x[i])  # strip x_i from the running inverse
    return torch.stack(out).movedim(0, axis)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Branchless limb select; ``pred`` has the batch shape."""
    return torch.where(pred[..., None], a, b)
