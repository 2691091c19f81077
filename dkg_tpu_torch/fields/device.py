"""Batched modular arithmetic on 16-bit limb tensors (plain PyTorch).

The counterpart of ``dkg_tpu/fields/device.py``: a field element is
``L`` little-endian 16-bit limbs in an ``int32`` tensor of shape
``(..., L)``, batched over the leading axes, and every operation returns
the canonical residue in ``[0, p)``.  So the results equal the JAX
package's limb for limb, whichever reduction either side runs.

Public functions take and return ``int32`` limbs.  Inside, limbs widen
to ``int64``: schoolbook columns reach ``L * 2**32`` and a borrow is
``s < 0`` rather than the JAX package's ``uint32`` wrap ``s >> 31``.
:func:`reduce_wide` picks the reducer of a 2L-limb value as the JAX
package's does (pseudo-Mersenne fold, linear fold, Barrett; the same
residue from each).  These functions are also the plain versions that the CUDA kernels in
``dkg_tpu_torch/ops`` are held against: :func:`mul` of ``mod_mul``,
:func:`_mul_gemm` of ``mxu_mod_mul``.

:func:`pow_const`, :func:`inv` and :func:`batch_inv` chain a multiply
given as ``mul=`` (default :func:`mul`, resolved when called): the device
path passes a kernel wrapper, so each step is one launch.
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from .spec import FieldSpec, int_to_limbs

MASK16 = 0xFFFF


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


@functools.lru_cache(maxsize=None)
def _const(fs: FieldSpec, name: str, device: torch.device) -> torch.Tensor:
    """One of ``fs``'s constant arrays as int64 on ``device``, made once:
    an attribute path (``p_limbs``, ``barrett_mu``, ``mulred.foldm``, ...),
    or ``kp_limbs_ext``, the rows 0, p and 2p of ``p_limbs_ext``."""
    if name == "kp_limbs_ext":
        return torch.as_tensor(np.outer([0, 1, 2], fs.p_limbs_ext.astype(np.int64)), device=device)
    return torch.as_tensor(operator.attrgetter(name)(fs).astype(np.int64), device=device)


# ---------------------------------------------------------------------------
# carry / borrow primitives (int64 in, int64 out)
# ---------------------------------------------------------------------------

MAX_CARRY_LIMBS = 62  # the lookahead packs one carry bit a limb, and the carry out, into an int64


def _local_rounds(hi: int) -> int:
    """Rounds of x <- (x & 0xFFFF) + (x >> 16 shifted up a limb) that bring
    non-negative columns of at most ``hi`` into [0, 2**16]."""
    rounds = 0
    while hi > 1 << 16:
        hi, rounds = MASK16 + (hi >> 16), rounds + 1
    return rounds


@functools.lru_cache(maxsize=None)
def _carry_consts(k: int, bits: int, signed: bool, device: torch.device) -> tuple:
    """For k columns of magnitude < 2**bits: the local rounds, the powers
    of two that pack one bit a limb, the limb indices 0..k, and for signed
    columns the offset that makes them non-negative with its worth in
    units of 2**(16k).  The offset is 2**B, then 2**B - 2**(B-16) a column
    (B = max(bits + 1, 16)), a telescoping sum of 2**(16k) · 2**(B-16)."""
    b = max(bits + 1, 16)
    pow2 = torch.tensor([1 << j for j in range(k)], dtype=torch.int64, device=device)
    idx = torch.arange(k + 1, device=device)
    if not signed:
        return _local_rounds((1 << bits) - 1), pow2, idx, None, 0
    off = torch.full((k,), (1 << b) - (1 << (b - 16)), dtype=torch.int64, device=device)
    off[0] = 1 << b
    return _local_rounds((1 << bits) - 1 + (1 << b)), pow2, idx, off, 1 << (b - 16)


def _carry(cols: torch.Tensor, bits: int = 61, *, signed: bool = True, top: bool = True):
    """Propagate column carries: (..., K) int64 columns, each of magnitude
    < 2**bits (bits <= 61, K <= 62; ``signed=False`` promises them
    non-negative) -> (16-bit limbs, the carry out of the top limb), or the
    limbs alone with ``top=False``; no loop whose length depends on the
    data.

    An offset worth a whole multiple of 2**(16K) makes signed columns
    non-negative.  A fixed number of local rounds, each moving every
    column's carry one limb up at once, brings every limb into [0, 2**16].
    What is left is a carry of 1 out of each 2**16 limb that ripples on
    through runs of 0xFFFF limbs, settled in one lookahead pass: with one
    bit a limb, G the limbs that send a carry (2**16) and P those that pass
    one on (0xFFFF), the carries into the limbs are the carry bits of the
    binary sum G + (G | P), ((G << 1) + P) ^ P."""
    k = cols.shape[-1]
    if k > MAX_CARRY_LIMBS or bits > 61:
        raise ValueError(f"_carry takes at most {MAX_CARRY_LIMBS} columns below 2**61, got {k} below 2**{bits}")
    rounds, pow2, idx, off, off_top = _carry_consts(k, bits, signed, cols.device)
    x = cols if off is None else cols + off
    out = None
    for _ in range(rounds):
        c = x >> 16
        if top:
            out = c[..., -1] if out is None else out + c[..., -1]
        x = (x & MASK16) + torch.nn.functional.pad(c[..., :-1], (1, 0))
    g = ((x >> 16) * pow2).sum(-1)  # limbs at 2**16
    e = (((x + 1) >> 16) * pow2).sum(-1)  # limbs at 0xFFFF or 2**16
    cin = (e + g) ^ (e - g)  # ((G << 1) + P) ^ P with P = E - G
    cbits = (cin[..., None] >> idx) & 1  # the carry into limb j, j = 0..K
    limbs = (x + cbits[..., :k]) & MASK16
    if not top:
        return limbs
    out = cbits[..., k] if out is None else out + cbits[..., k]
    return limbs, out - off_top


def normalize(cols: torch.Tensor, out_len: int, bits: int = 61) -> torch.Tensor:
    """Carry-propagate non-negative columns below 2**bits into ``out_len``
    16-bit limbs, taken mod ``2**(16*out_len)``."""
    k = cols.shape[-1]
    cols = torch.nn.functional.pad(cols, (0, out_len - k)) if k < out_len else cols[..., :out_len]
    return _carry(cols, bits, signed=False, top=False)


def sub_with_borrow(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a - b) mod 2**(16K) of equal-length limbs, and the final borrow (1
    iff a < b)."""
    limbs, top = _carry(a - b, 16)
    return limbs, (top < 0).to(torch.int64)


def cond_sub(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Branchless ``x - m if x >= m else x`` on equal-length limbs."""
    d, borrow = sub_with_borrow(x, m)
    return torch.where((borrow != 0)[..., None], x, d)


# ---------------------------------------------------------------------------
# multiply and Barrett reduction
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _column_index(la: int, lb: int, device: torch.device) -> torch.Tensor:
    """Column i+j of each product a_i·b_j (low halves), then i+j+1 (high)."""
    col = (torch.arange(la, device=device)[:, None] + torch.arange(lb, device=device)).flatten()
    return torch.cat([col, col + 1])


def _mul_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unnormalized schoolbook product columns of int64 limb tensors:
    (..., La) x (..., Lb) -> (..., La+Lb), column i+j taking the low 16
    bits of a_i·b_j and column i+j+1 its high 16 bits (each column < 2**22
    for L <= 24)."""
    la, lb = a.shape[-1], b.shape[-1]
    prod = (a[..., :, None] * b[..., None, :]).flatten(-2)  # 16x16 -> 32 bits, exact
    cols = torch.zeros(prod.shape[:-1] + (la + lb,), dtype=torch.int64, device=prod.device)
    return cols.index_add_(-1, _column_index(la, lb, prod.device), torch.cat([prod & MASK16, prod >> 16], -1))


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of int64 limb tensors: (..., La) x (..., Lb) -> (..., La+Lb)."""
    return normalize(_mul_columns(a, b), a.shape[-1] + b.shape[-1], bits=22)


def barrett_reduce(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Reduce a normalized 2L-limb int64 value mod p (HAC 14.42, b = 2**16).

    The quotient estimate q3 is short by at most 2, so r = x - q3·p mod
    b**(L+1) lies in [0, 3p).  One carry pass settles r, r - p and r - 2p
    together from the product's columns: with R = x - (q3·p's low L+1
    columns), each candidate R - kp normalizes to its limbs and a carry
    out, and r >= kp exactly when R - kp's carry out is at least R's."""
    L = fs.limbs
    q3 = mul_wide(x[..., L - 1 :], _const(fs, "barrett_mu", x.device))[..., L + 1 :]
    r = x[..., : L + 1] - _mul_columns(q3, _const(fs, "p_limbs_ext", x.device))[..., : L + 1]
    kp = _const(fs, "kp_limbs_ext", x.device)  # 0, p, 2p as (3, L+1) columns
    limbs, top = _carry(r - kp.reshape((3,) + (1,) * (r.dim() - 1) + (L + 1,)), 23)
    ge1, ge2 = (top[1] >= top[0])[..., None], (top[2] >= top[0])[..., None]
    return torch.where(ge2, limbs[2], torch.where(ge1, limbs[1], limbs[0]))[..., :L]


def fold_reduce(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Pseudo-Mersenne reduction of a normalized 2L-limb int64 value to L
    limbs (``fs.fold_limbs``: c = b**L mod p in lc <= 4 limbs): twice
    hi·b**L = hi·c (mod p), y1 = lo + hi·c in L+lc+1 limbs, y2 = lo' +
    hi'·c in L+1 limbs, y2 < 3p, then two conditional subtractions."""
    L = fs.limbs
    c = _const(fs, "fold_limbs", x.device)

    def fold(lo, hi, out_len):
        prod = _mul_columns(hi, c)
        w = max(prod.shape[-1], lo.shape[-1])
        pad = torch.nn.functional.pad
        return normalize(pad(prod, (0, w - prod.shape[-1])) + pad(lo, (0, w - lo.shape[-1])), out_len, bits=24)

    y = fold(x[..., :L], x[..., L:], L + c.shape[-1] + 1)
    y = fold(y[..., :L], y[..., L:], L + 1)
    p_ext = _const(fs, "p_limbs_ext", x.device)
    return cond_sub(cond_sub(y, p_ext), p_ext)[..., :L]


def linear_reduce(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Linear-fold reduction of a normalized 2L-limb int64 value to L limbs
    (``fs.linred``): the high half's 2L bytes against the byte matrix
    ``fold8`` (an int64 sum of byte products, exact), ``n_split`` scan-free
    column folds through c = b**L mod p, one normalize into L+1 limbs, the
    quotient from ``qtable`` by the top bits, one conditional subtraction."""
    lr = fs.linred
    if lr is None:
        raise ValueError(f"{fs.name} does not admit linear_reduce")
    L = fs.limbs
    if x.shape[-1] != 2 * L:
        raise ValueError("linear_reduce expects a full 2L-limb value")
    lo, hi = x[..., :L], x[..., L:]
    d8 = torch.stack([hi & 0xFF, hi >> 8], dim=-1).reshape(hi.shape[:-1] + (2 * L,))
    fold8 = _const(fs, "linred.fold8", x.device)
    cols8 = torch.zeros_like(d8)
    for k in range(2 * L):
        cols8 += d8[..., k : k + 1] * fold8[k]
    cols = lo + cols8[..., 0::2] + (cols8[..., 1::2] << 8)
    c = _const(fs, "linred.c_limbs", x.device)
    for _ in range(lr.n_split):
        hi16 = cols >> 16
        cols = (cols & MASK16) + torch.nn.functional.pad(hi16[..., :-1], (1, 0)) + hi16[..., L - 1 :] * c
    v = normalize(cols, L + 1)
    u = (v[..., L - 1] >> lr.shift_e) | (v[..., L] << (16 - lr.shift_e))
    q = _const(fs, "linred.qtable", v.device)[u]
    w = normalize(v + q[..., None] * _const(fs, "linred.np_limbs", v.device), L + 1)
    return cond_sub(w, _const(fs, "p_limbs_ext", w.device))[..., :L]


def reduce_wide(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Reduce a normalized 2L-limb int64 value to L limbs mod p by the
    cheapest reducer the field admits: the pseudo-Mersenne fold, then the
    linear fold, then Barrett.  All three give the canonical residue, so
    the choice never changes a limb."""
    if fs.fold_limbs is not None:
        return fold_reduce(fs, x)
    if fs.linred is not None:
        return linear_reduce(fs, x)
    return barrett_reduce(fs, x)


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
    """(a + b) mod p: a + b and a + b - p in one carry pass, the second
    kept unless it borrowed."""
    s = _wide(a) + _wide(b)
    limbs, top = _carry(torch.stack([s, s - _const(fs, "p_limbs", s.device)]), 18)
    return torch.where((top[1] < 0)[..., None], limbs[0], limbs[1]).to(torch.int32)


def sub(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p: a - b and a - b + p in one carry pass, the first kept
    unless it borrowed."""
    d = _wide(a) - _wide(b)
    limbs, top = _carry(torch.stack([d, d + _const(fs, "p_limbs", d.device)]), 18)
    return torch.where((top[0] < 0)[..., None], limbs[1], limbs[0]).to(torch.int32)


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
    foldm = _const(fs, "mulred.foldm", cols.device)  # (3L+1, 2L) bytes
    cols8 = torch.zeros_like(cols)
    for i in range(3 * L + 1):
        cols8 += digits[..., i : i + 1] * foldm[i]
    keep = torch.cat([plo[..., : L - 1], plo[..., L - 1 :] & MASK16], dim=-1)
    cols = keep + cols8[..., 0::2] + (cols8[..., 1::2] << 8)
    c = _const(fs, "mulred.c_limbs", cols.device)
    for _ in range(mr.n_split):
        hi16 = cols >> 16
        cols = (cols & MASK16) + torch.nn.functional.pad(hi16[..., :-1], (1, 0)) + hi16[..., L - 1 :] * c
    v = normalize(cols, L + 1)
    u = (v[..., L - 1] >> mr.shift_e) | (v[..., L] << (16 - mr.shift_e))
    q = _const(fs, "mulred.qtable", v.device)[u]
    w = normalize(v + q[..., None] * _const(fs, "mulred.np_limbs", v.device), L + 1)
    return cond_sub(w, _const(fs, "p_limbs_ext", w.device))[..., :L].to(torch.int32)


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
