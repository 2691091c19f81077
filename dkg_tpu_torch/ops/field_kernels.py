"""The ``mod_madd`` and ``mod_mul`` kernels: ``(a * b + c) mod p`` and
``(a * b) mod p`` in one launch; ``mod_madd``'s two multi-step forms,
each one launch: :func:`mod_madd_horner` (Horner over T coefficients,
``poly.device.eval_many``) and :func:`mod_madd_dot` (a sum of m products,
``dkg.ceremony._field_dot``); and ``mod_mul``'s: :func:`mod_batch_inv`
(a whole ``fields.device.batch_inv`` in one launch,
``csrc/inv_kernels.cu``, over the three base fields whose points
``groups.device.affine_canon`` makes affine; plain version
``fields.device.batch_inv``).

Counterparts of ``dkg_tpu/ops/pallas_field.py`` ``mod_madd`` and
``mod_mul``; the multi-step forms compose their steps.  On a
CUDA tensor each wrapper launches ``csrc/field_kernels.cu`` over the
field of its operands (secp256k1's base and scalar fields, ed25519's
base field, the ristretto255 scalar field, BLS12-381's 24-limb base
field and its scalar field; any other field raises); on a CPU tensor it
runs its plain PyTorch version, which the kernel is held against:
:func:`mod_madd_plain`, ``fields.device.mul``, and the loops of
``mod_madd_plain`` in :func:`mod_madd_horner_plain` and
:func:`mod_madd_dot_plain`.  Operands broadcast over their batch axes.

The three field families count their launches apart: ``MOD_MADD``,
``MOD_MUL``, ``MOD_MADD_HORNER``, ``MOD_MADD_DOT`` and ``MOD_BATCH_INV``
for secp256k1's fields, the ``_ED`` kernels for ed25519's, the ``_BLS``
ones for BLS12-381's.
"""

from __future__ import annotations

import functools

import torch

from ..fields import device as fd
from ..fields.spec import BLS12_381_P, BLS12_381_R, L25519, P25519, SECP256K1_N, SECP256K1_P, FieldSpec
from . import build

_ARGS = [build.PTR, build.PTR, build.PTR, build.PTR, build.I64, build.INT, build.PTR]
MOD_MADD = build.Kernel("mod_madd", "field_kernels.cu", "dkg_mod_madd", _ARGS)
MOD_MADD_ED = build.Kernel("mod_madd[ed25519]", "field_kernels.cu", "dkg_mod_madd", _ARGS)
MOD_MADD_BLS = build.Kernel("mod_madd[bls12_381]", "field_kernels.cu", "dkg_mod_madd", _ARGS)
_MUL_ARGS = [build.PTR, build.PTR, build.PTR, build.I64, build.INT, build.PTR]
MOD_MUL = build.Kernel("mod_mul", "field_kernels.cu", "dkg_mod_mul", _MUL_ARGS)
MOD_MUL_ED = build.Kernel("mod_mul[ed25519]", "field_kernels.cu", "dkg_mod_mul", _MUL_ARGS)
MOD_MUL_BLS = build.Kernel("mod_mul[bls12_381]", "field_kernels.cu", "dkg_mod_mul", _MUL_ARGS)
_HORNER_ARGS = [build.PTR, build.I64, build.PTR, build.I64, build.PTR, build.I64, build.I64, build.INT,
                build.INT, build.PTR]
MOD_MADD_HORNER = build.Kernel("mod_madd_horner", "field_kernels.cu", "dkg_mod_madd_horner", _HORNER_ARGS)
MOD_MADD_HORNER_ED = build.Kernel("mod_madd_horner[ed25519]", "field_kernels.cu", "dkg_mod_madd_horner",
                                  _HORNER_ARGS)
MOD_MADD_HORNER_BLS = build.Kernel("mod_madd_horner[bls12_381]", "field_kernels.cu", "dkg_mod_madd_horner",
                                   _HORNER_ARGS)
_DOT_ARGS = [build.PTR, build.PTR, build.PTR, build.I64, build.I64, build.INT, build.PTR]
MOD_MADD_DOT = build.Kernel("mod_madd_dot", "field_kernels.cu", "dkg_mod_madd_dot", _DOT_ARGS)
MOD_MADD_DOT_ED = build.Kernel("mod_madd_dot[ed25519]", "field_kernels.cu", "dkg_mod_madd_dot", _DOT_ARGS)
MOD_MADD_DOT_BLS = build.Kernel("mod_madd_dot[bls12_381]", "field_kernels.cu", "dkg_mod_madd_dot", _DOT_ARGS)
_INV_ARGS = [build.PTR, build.PTR, build.I64, build.I64, build.PTR, build.INT, build.INT, build.INT, build.PTR]
MOD_BATCH_INV = build.Kernel("mod_batch_inv", "inv_kernels.cu", "dkg_mod_batch_inv", _INV_ARGS)
MOD_BATCH_INV_ED = build.Kernel("mod_batch_inv[ed25519]", "inv_kernels.cu", "dkg_mod_batch_inv", _INV_ARGS)
MOD_BATCH_INV_BLS = build.Kernel("mod_batch_inv[bls12_381]", "inv_kernels.cu", "dkg_mod_batch_inv", _INV_ARGS)
KERNELS = (MOD_MADD, MOD_MADD_ED, MOD_MADD_BLS, MOD_MUL, MOD_MUL_ED, MOD_MUL_BLS,
           MOD_MADD_HORNER, MOD_MADD_HORNER_ED, MOD_MADD_HORNER_BLS, MOD_MADD_DOT, MOD_MADD_DOT_ED,
           MOD_MADD_DOT_BLS, MOD_BATCH_INV, MOD_BATCH_INV_ED, MOD_BATCH_INV_BLS)

# field -> (mod_madd kernel, field id of csrc/field.cuh)
_FIELDS = {
    SECP256K1_P: (MOD_MADD, 0),
    SECP256K1_N: (MOD_MADD, 1),
    P25519: (MOD_MADD_ED, 2),
    L25519: (MOD_MADD_ED, 3),
    BLS12_381_P: (MOD_MADD_BLS, 4),
    BLS12_381_R: (MOD_MADD_BLS, 5),
}
_MUL_KERNELS = {MOD_MADD: MOD_MUL, MOD_MADD_ED: MOD_MUL_ED, MOD_MADD_BLS: MOD_MUL_BLS}
_HORNER_KERNELS = {MOD_MADD: MOD_MADD_HORNER, MOD_MADD_ED: MOD_MADD_HORNER_ED, MOD_MADD_BLS: MOD_MADD_HORNER_BLS}
_DOT_KERNELS = {MOD_MADD: MOD_MADD_DOT, MOD_MADD_ED: MOD_MADD_DOT_ED, MOD_MADD_BLS: MOD_MADD_DOT_BLS}
# mod_batch_inv is built for the base fields whose points affine_canon makes affine
_INV_KERNELS = {SECP256K1_P: MOD_BATCH_INV, P25519: MOD_BATCH_INV_ED, BLS12_381_P: MOD_BATCH_INV_BLS}
INV_WINDOW_MAX = 5  # csrc/inv.cuh kInvMaxPowers = 2**(INV_WINDOW_MAX - 1) odd powers


def _kernel_for(op: str, table: dict, fs: FieldSpec) -> build.Kernel:
    if fs not in _FIELDS:
        raise NotImplementedError(f"{op} has no CUDA kernel for {fs.name}")
    return table[_FIELDS[fs][0]]


def mul_kernel_for(fs: FieldSpec) -> build.Kernel:
    """The ``mod_mul`` kernel of field ``fs``; raises if there is none."""
    return _kernel_for("mod_mul", _MUL_KERNELS, fs)


def horner_kernel_for(fs: FieldSpec) -> build.Kernel:
    """The ``mod_madd_horner`` kernel of field ``fs``; raises if there is none."""
    return _kernel_for("mod_madd_horner", _HORNER_KERNELS, fs)


def dot_kernel_for(fs: FieldSpec) -> build.Kernel:
    """The ``mod_madd_dot`` kernel of field ``fs``; raises if there is none."""
    return _kernel_for("mod_madd_dot", _DOT_KERNELS, fs)


def batch_inv_kernel_for(fs: FieldSpec) -> build.Kernel:
    """The ``mod_batch_inv`` kernel of field ``fs``; raises if there is none."""
    if fs not in _INV_KERNELS:
        raise NotImplementedError(f"mod_batch_inv has no CUDA kernel for {fs.name}")
    return _INV_KERNELS[fs]


def sliding_chain(e: int, window: int) -> tuple[list, int]:
    """x**e (e >= 1) as a sliding-window chain: ``[first, op, op, ...]``,
    ``first`` the odd power x**(2 first + 1) the chain starts from, each op
    a squaring (-1) or a multiply by the odd power x**(2 j + 1) (j >= 0);
    and the count of odd powers it reads.  Windows of at most ``window``
    bits, each ending in a set bit, MSB first."""
    if e < 1 or window < 1:
        raise ValueError("sliding_chain takes e >= 1 and window >= 1")
    bits = bin(e)[2:]
    chain: list = []
    i = 0
    while i < len(bits):
        if bits[i] == "0":
            chain.append(-1)
            i += 1
            continue
        j = min(i + window, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        odd = (int(bits[i:j], 2) - 1) // 2
        if chain:
            chain += [-1] * (j - i)
        chain.append(odd)
        i = j
    return chain, max(op for op in chain) + 1


def chain_multiplies(chain: list, npow: int) -> int:
    """Multiplies a chain runs: its ops, and x**2 and the odd powers
    above x."""
    return len(chain) - 1 + (npow if npow > 1 else 0)


@functools.lru_cache(maxsize=None)
def inv_chain(fs: FieldSpec) -> tuple[tuple, int]:
    """The Fermat inversion x**(p - 2) that ``mod_batch_inv`` runs: the
    sliding-window chain of :func:`sliding_chain` with the window (at most
    INV_WINDOW_MAX bits) of fewest multiplies."""
    e = fs.modulus - 2
    best = min((sliding_chain(e, w) for w in range(1, INV_WINDOW_MAX + 1)),
               key=lambda c: chain_multiplies(*c))
    return tuple(best[0]), best[1]


@functools.lru_cache(maxsize=None)
def _chain_table(fs: FieldSpec, device: torch.device) -> torch.Tensor:
    """``inv_chain(fs)``'s ops as an int32 tensor on ``device``, made once."""
    return torch.tensor(inv_chain(fs)[0], dtype=torch.int32, device=device)


def mod_batch_inv(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """``fields.device.batch_inv(fs, x, axis=0)`` in one launch: x (k, ...,
    L) -> the same shape, each column x[:, c] inverted by the Montgomery
    trick.  A column holding a zero reads 0 in every row (its total has no
    inverse); the others read the canonical inverses."""
    if x.device.type == "cpu":
        return fd.batch_inv(fs, x, axis=0)
    kernel = batch_inv_kernel_for(fs)
    L = fs.limbs
    if x.dim() < 2:
        raise ValueError(f"mod_batch_inv takes x (k, ..., L), got {tuple(x.shape)}")
    dev = build.check_operands([(x, (L,))])
    rows = x.shape[0]
    xs = build.aligned(x.reshape(rows, -1, L).contiguous())
    out = torch.empty_like(xs)
    cols = xs.shape[1]
    if rows and cols:
        chain, npow = _chain_table(fs, dev), inv_chain(fs)[1]
        kernel(xs.data_ptr(), out.data_ptr(), rows, cols, chain.data_ptr(), len(chain), npow, _FIELDS[fs][1],
               build.stream_ptr(dev))
    return out.reshape(x.shape)


def mod_madd_plain(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return fd.add(fs, fd.mul(fs, a, b), c)


def mod_madd(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(a * b + c) mod p on (..., L) int32 limbs, batch axes broadcast."""
    if a.device.type == "cpu":
        return mod_madd_plain(fs, a, b, c)
    if fs not in _FIELDS:
        raise NotImplementedError(f"mod_madd has no CUDA kernel for {fs.name}")
    kernel, field = _FIELDS[fs]
    tail = (fs.limbs,)
    (a, b, c), out, n = build.lanes([(a, tail), (b, tail), (c, tail)], tail)
    if n:
        kernel(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), n, field,
               build.stream_ptr(out.device))
    return out


def mod_mul(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p on (..., L) int32 limbs, batch axes broadcast."""
    if a.device.type == "cpu":
        return fd.mul(fs, a, b)
    kernel = mul_kernel_for(fs)
    tail = (fs.limbs,)
    (a, b), out, n = build.lanes([(a, tail), (b, tail)], tail)
    if n:
        kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _FIELDS[fs][1], build.stream_ptr(out.device))
    return out


def mod_madd_horner_plain(fs: FieldSpec, coeffs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """T one-step plain versions: acc <- acc·x + c_l from the top."""
    batch = torch.broadcast_shapes(coeffs.shape[:-2], xs.shape[:-2])
    acc = fd.zeros(fs, batch + (xs.shape[-2],), device=coeffs.device)
    for l in reversed(range(coeffs.shape[-2])):
        acc = mod_madd_plain(fs, acc, xs, coeffs[..., l, None, :])
    return acc


def mod_madd_horner(fs: FieldSpec, coeffs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Σ_l coeffs[..., l]·x^l mod p at every x in one launch: coeffs
    (..., T, L) low-order first, xs (..., N, L) -> (..., N, L), batch axes
    broadcast (a shared operand is read, never copied to the batch)."""
    if coeffs.device.type == "cpu":
        return mod_madd_horner_plain(fs, coeffs, xs)
    kernel, field = horner_kernel_for(fs), _FIELDS[fs][1]
    L = fs.limbs
    if coeffs.dim() < 2 or xs.dim() < 2:
        raise ValueError("mod_madd_horner takes coeffs (..., T, L) and xs (..., N, L)")
    T, npts = coeffs.shape[-2], xs.shape[-2]
    dev = build.check_operands([(coeffs, (T, L)), (xs, (npts, L))])
    batch = torch.broadcast_shapes(coeffs.shape[:-2], xs.shape[:-2])
    out = torch.empty(batch + (npts, L), dtype=torch.int32, device=dev)
    n_rows = out.numel() // max(1, npts * L)
    if n_rows and npts:
        c, c_share = build.rows(coeffs, batch, (T, L))
        x, x_share = build.rows(xs, batch, (npts, L))
        if c_share not in (1, n_rows) or x_share not in (1, n_rows):  # a mixed broadcast: copy to the batch
            c, x = (t.expand(batch + t.shape[-2:]).reshape(-1, *t.shape[-2:]).contiguous() for t in (coeffs, xs))
            c_share = x_share = 1
        kernel(c.data_ptr(), 0 if c_share > 1 else T * L, x.data_ptr(), 0 if x_share > 1 else npts * L,
               out.data_ptr(), n_rows, npts, T, field, build.stream_ptr(dev))
    return out


def mod_madd_dot_plain(fs: FieldSpec, weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """m one-step plain versions: acc <- w_j·v_j + acc."""
    acc = fd.zeros(fs, values.shape[1:-1], device=values.device)
    for j in range(values.shape[0]):
        acc = mod_madd_plain(fs, weights[j], values[j], acc)
    return acc


def mod_madd_dot(fs: FieldSpec, weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Σ_j weights[j]·values[j, ...] mod p in one launch: weights (m, L),
    values (m, ..., L) -> (..., L)."""
    if weights.device.type == "cpu":
        return mod_madd_dot_plain(fs, weights, values)
    kernel, field = dot_kernel_for(fs), _FIELDS[fs][1]
    L = fs.limbs
    if weights.dim() != 2 or values.dim() < 2 or values.shape[0] != weights.shape[0]:
        raise ValueError("mod_madd_dot takes weights (m, L) and values (m, ..., L)")
    m = weights.shape[0]
    dev = build.check_operands([(weights, (m, L)), (values, (L,))])
    out = torch.empty(values.shape[1:], dtype=torch.int32, device=dev)
    K = out.numel() // L
    if K:
        w, v = weights.contiguous(), values.reshape(m, K, L).contiguous()
        kernel(w.data_ptr(), v.data_ptr(), out.data_ptr(), m, K, field, build.stream_ptr(dev))
    return out
