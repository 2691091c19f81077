"""Point kernels: ``pt_add``, ``pt_madd``, ``pt_double``,
``pt_window_step``, ``pt_ladder_mul_add`` and ``pt_ladder_horner`` (the
whole point Horner of ``groups.device.eval_point_poly`` in one launch),
with their plain PyTorch versions.

Counterpart of ``dkg_tpu/ops/pallas_point.py``.  Points are int32 limb
tensors of shape ``(..., C, L)``: C projective coordinates (3 for short
Weierstrass a = 0, 4 for extended Edwards) of L 16-bit limbs (16, or
24 on BLS12-381 G1).  On a CUDA tensor each wrapper launches the kernel
of its curve: secp256k1's in ``csrc/point_kernels.cu``, edwards25519's
(ristretto255) in ``csrc/edwards_kernels.cu``, ``pt_double`` for both in
``csrc/double_kernels.cu``, and every BLS12-381 G1 kernel in
``csrc/bls_kernels.cu``, and ``pt_ladder_horner`` for all three in
``csrc/ladder_kernels.cu``; a curve with no kernel raises.  On a CPU
tensor it runs the plain version below.  The plain versions are the
formulas of the JAX package's ``groups/device.py`` (RCB15 algorithms 7,
8 and 9 for Weierstrass, HWCD add and doubling for Edwards) in the same
order, so their projective coordinates equal the JAX package's limb for
limb.

Each variant is its own :class:`build.Kernel`, with its own C entry and
launch count; the variants of one op take the same arguments.  ``cs`` is
a ``groups.device.CurveSpec``.
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..groups import host as gh
from . import build

_WS, _ED, _DBL, _BLS = "point_kernels.cu", "edwards_kernels.cu", "double_kernels.cu", "bls_kernels.cu"
_P, _I, _INT = build.PTR, build.I64, build.INT
_BINARY = [_P, _P, _P, _I, _P]
_LADDER = [_P, _P, _P, _P, _I, _INT, _P]

PT_ADD = build.Kernel("pt_add", _WS, "dkg_pt_add", _BINARY)
PT_MADD = build.Kernel("pt_madd", _WS, "dkg_pt_madd", _BINARY)
PT_WINDOW_STEP = build.Kernel("pt_window_step", _WS, "dkg_pt_window_step", [_P, _P, _P, _I, _INT, _P])
PT_LADDER_MUL_ADD = build.Kernel("pt_ladder_mul_add", _WS, "dkg_pt_ladder_mul_add", _LADDER)
ED_PT_ADD = build.Kernel("pt_add[edwards]", _ED, "dkg_ed_pt_add", _BINARY)
ED_PT_MADD = build.Kernel("pt_madd[edwards]", _ED, "dkg_ed_pt_madd", _BINARY)
ED_PT_WINDOW_STEP = build.Kernel("pt_window_step[edwards]", _ED, "dkg_ed_pt_window_step",
                                 [_P, _P, _P, _I, _INT, _P])
ED_PT_LADDER_MUL_ADD = build.Kernel("pt_ladder_mul_add[edwards]", _ED, "dkg_ed_pt_ladder_mul_add", _LADDER)
_DOUBLE = [_P, _P, _I, _INT, _P]
PT_DOUBLE = build.Kernel("pt_double", _DBL, "dkg_pt_double", _DOUBLE)
ED_PT_DOUBLE = build.Kernel("pt_double[edwards]", _DBL, "dkg_ed_pt_double", _DOUBLE)
BLS_PT_ADD = build.Kernel("pt_add[bls12_381]", _BLS, "dkg_bls_pt_add", _BINARY)
BLS_PT_MADD = build.Kernel("pt_madd[bls12_381]", _BLS, "dkg_bls_pt_madd", _BINARY)
BLS_PT_DOUBLE = build.Kernel("pt_double[bls12_381]", _BLS, "dkg_bls_pt_double", _DOUBLE)
BLS_PT_WINDOW_STEP = build.Kernel("pt_window_step[bls12_381]", _BLS, "dkg_bls_pt_window_step",
                                  [_P, _P, _P, _I, _INT, _P])
BLS_PT_LADDER_MUL_ADD = build.Kernel("pt_ladder_mul_add[bls12_381]", _BLS, "dkg_bls_pt_ladder_mul_add",
                                     _LADDER)
_HORNER = [_P, _I, _I, _P, _P, _I, _INT, _INT, _P]
_LAD = "ladder_kernels.cu"
PT_LADDER_HORNER = build.Kernel("pt_ladder_horner", _LAD, "dkg_pt_ladder_horner", _HORNER)
ED_PT_LADDER_HORNER = build.Kernel("pt_ladder_horner[edwards]", _LAD, "dkg_ed_pt_ladder_horner", _HORNER)
BLS_PT_LADDER_HORNER = build.Kernel("pt_ladder_horner[bls12_381]", _LAD, "dkg_bls_pt_ladder_horner", _HORNER)
KERNELS = (PT_ADD, PT_MADD, PT_WINDOW_STEP, PT_LADDER_MUL_ADD,
           ED_PT_ADD, ED_PT_MADD, ED_PT_WINDOW_STEP, ED_PT_LADDER_MUL_ADD, PT_DOUBLE, ED_PT_DOUBLE,
           BLS_PT_ADD, BLS_PT_MADD, BLS_PT_DOUBLE, BLS_PT_WINDOW_STEP, BLS_PT_LADDER_MUL_ADD,
           PT_LADDER_HORNER, ED_PT_LADDER_HORNER, BLS_PT_LADDER_HORNER)

# The curves the kernels cover, by (kind, base field, curve constant): the
# constants (b3 = 21 and 12, 2d) are compiled into csrc/point.cuh and
# edwards.cuh.
_WS_KEY = ("weierstrass_a0", "secp256k1_base", 21)
_ED_KEY = ("edwards", "ed25519_base", 2 * gh.D % gh.P)
_BLS_KEY = ("weierstrass_a0", "bls12_381_base", 12)
_VARIANTS = {
    "pt_add": {_WS_KEY: PT_ADD, _ED_KEY: ED_PT_ADD, _BLS_KEY: BLS_PT_ADD},
    "pt_madd": {_WS_KEY: PT_MADD, _ED_KEY: ED_PT_MADD, _BLS_KEY: BLS_PT_MADD},
    "pt_window_step": {_WS_KEY: PT_WINDOW_STEP, _ED_KEY: ED_PT_WINDOW_STEP, _BLS_KEY: BLS_PT_WINDOW_STEP},
    "pt_ladder_mul_add": {_WS_KEY: PT_LADDER_MUL_ADD, _ED_KEY: ED_PT_LADDER_MUL_ADD,
                          _BLS_KEY: BLS_PT_LADDER_MUL_ADD},
    "pt_double": {_WS_KEY: PT_DOUBLE, _ED_KEY: ED_PT_DOUBLE, _BLS_KEY: BLS_PT_DOUBLE},
    "pt_ladder_horner": {_WS_KEY: PT_LADDER_HORNER, _ED_KEY: ED_PT_LADDER_HORNER, _BLS_KEY: BLS_PT_LADDER_HORNER},
}


def kernel_for(op: str, cs) -> build.Kernel:
    """The kernel that runs ``op`` on curve ``cs``; raises if there is none."""
    kernel = _VARIANTS[op].get((cs.kind, cs.field.name, cs.const))
    if kernel is None:
        raise NotImplementedError(f"{op} has no CUDA kernel for {cs.name}")
    return kernel


# ---------------------------------------------------------------------------
# plain versions: the complete formulas
# ---------------------------------------------------------------------------


def _unstack(p: torch.Tensor, n: int):
    return tuple(p[..., i, :] for i in range(n))


def _stack(*coords) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(*coords), dim=-2)


def _ws_add(cs, p, q):
    """Complete projective addition for y^2 = x^3 + b (RCB15 algorithm 7)."""
    f = cs.field
    b3 = fd.constant(f, cs.const, device=p.device)
    x1, y1, z1 = _unstack(p, 3)
    x2, y2, z2 = _unstack(q, 3)
    t0 = fd.mul(f, x1, x2)
    t1 = fd.mul(f, y1, y2)
    t2 = fd.mul(f, z1, z2)
    t3 = fd.mul(f, fd.add(f, x1, y1), fd.add(f, x2, y2))
    t3 = fd.sub(f, fd.sub(f, t3, t0), t1)
    t4 = fd.mul(f, fd.add(f, y1, z1), fd.add(f, y2, z2))
    t4 = fd.sub(f, fd.sub(f, t4, t1), t2)
    xz = fd.mul(f, fd.add(f, x1, z1), fd.add(f, x2, z2))
    y3 = fd.sub(f, fd.sub(f, xz, t0), t2)
    x3 = fd.add(f, fd.add(f, t0, t0), t0)
    t2 = fd.mul(f, b3, t2)
    z3 = fd.add(f, t1, t2)
    t1 = fd.sub(f, t1, t2)
    y3 = fd.mul(f, b3, y3)
    x_out = fd.sub(f, fd.mul(f, t3, t1), fd.mul(f, t4, y3))
    y_out = fd.add(f, fd.mul(f, t1, z3), fd.mul(f, x3, y3))
    z_out = fd.add(f, fd.mul(f, z3, t4), fd.mul(f, x3, t3))
    return _stack(x_out, y_out, z_out)


def _ws_madd(cs, p, q):
    """Mixed addition, q affine (RCB15 algorithm 8): complete for every p,
    NOT for q = identity (callers mask those lanes)."""
    f = cs.field
    b3 = fd.constant(f, cs.const, device=p.device)
    x1, y1, z1 = _unstack(p, 3)
    x2, y2, _ = _unstack(q, 3)
    t0 = fd.mul(f, x1, x2)
    t1 = fd.mul(f, y1, y2)
    t3 = fd.mul(f, fd.add(f, x1, y1), fd.add(f, x2, y2))
    t3 = fd.sub(f, fd.sub(f, t3, t0), t1)
    t4 = fd.add(f, fd.mul(f, y2, z1), y1)
    y3 = fd.add(f, fd.mul(f, x2, z1), x1)
    x3 = fd.add(f, fd.add(f, t0, t0), t0)
    t2 = fd.mul(f, b3, z1)
    z3 = fd.add(f, t1, t2)
    t1 = fd.sub(f, t1, t2)
    y3 = fd.mul(f, b3, y3)
    x_out = fd.sub(f, fd.mul(f, t3, t1), fd.mul(f, t4, y3))
    y_out = fd.add(f, fd.mul(f, t1, z3), fd.mul(f, x3, y3))
    z_out = fd.add(f, fd.mul(f, z3, t4), fd.mul(f, x3, t3))
    return _stack(x_out, y_out, z_out)


def _ws_double(cs, p):
    """Complete doubling for y^2 = x^3 + b (RCB15 algorithm 9)."""
    f = cs.field
    b3 = fd.constant(f, cs.const, device=p.device)
    x, y, z = _unstack(p, 3)
    t0 = fd.square(f, y)
    z3 = fd.add(f, t0, t0)
    z3 = fd.add(f, z3, z3)
    z3 = fd.add(f, z3, z3)
    t1 = fd.mul(f, y, z)
    t2 = fd.mul(f, b3, fd.square(f, z))
    x3 = fd.mul(f, t2, z3)
    y3 = fd.add(f, t0, t2)
    z3 = fd.mul(f, t1, z3)
    t1 = fd.add(f, t2, t2)
    t2 = fd.add(f, t1, t2)
    t0 = fd.sub(f, t0, t2)
    y3 = fd.add(f, x3, fd.mul(f, t0, y3))
    x3 = fd.mul(f, t0, fd.mul(f, x, y))
    x3 = fd.add(f, x3, x3)
    return _stack(x3, y3, z3)


def _ed_add(cs, p, q):
    """Unified extended twisted Edwards addition, a = -1 (add-2008-hwcd-3)."""
    f = cs.field
    x1, y1, z1, t1 = _unstack(p, 4)
    x2, y2, z2, t2 = _unstack(q, 4)
    a = fd.mul(f, fd.sub(f, y1, x1), fd.sub(f, y2, x2))
    b = fd.mul(f, fd.add(f, y1, x1), fd.add(f, y2, x2))
    c = fd.mul(f, fd.mul(f, t1, fd.constant(f, cs.const, device=p.device)), t2)
    d = fd.mul(f, fd.add(f, z1, z1), z2)
    e, ff, g, h = fd.sub(f, b, a), fd.sub(f, d, c), fd.add(f, d, c), fd.add(f, b, a)
    return _stack(fd.mul(f, e, ff), fd.mul(f, g, h), fd.mul(f, ff, g), fd.mul(f, e, h))


def _ed_madd(cs, p, q):
    """Mixed unified Edwards add, q affine (Z2 = 1): 2*Z1*Z2 becomes 2*Z1."""
    f = cs.field
    x1, y1, z1, t1 = _unstack(p, 4)
    x2, y2, _, t2 = _unstack(q, 4)
    a = fd.mul(f, fd.sub(f, y1, x1), fd.sub(f, y2, x2))
    b = fd.mul(f, fd.add(f, y1, x1), fd.add(f, y2, x2))
    c = fd.mul(f, fd.mul(f, t1, fd.constant(f, cs.const, device=p.device)), t2)
    d = fd.add(f, z1, z1)
    e, ff, g, h = fd.sub(f, b, a), fd.sub(f, d, c), fd.add(f, d, c), fd.add(f, b, a)
    return _stack(fd.mul(f, e, ff), fd.mul(f, g, h), fd.mul(f, ff, g), fd.mul(f, e, h))


def _ed_double(cs, p):
    """Dedicated doubling (dbl-2008-hwcd), a = -1."""
    f = cs.field
    x1, y1, z1, _ = _unstack(p, 4)
    a = fd.square(f, x1)
    b = fd.square(f, y1)
    zz = fd.square(f, z1)
    c = fd.add(f, zz, zz)
    d = fd.neg(f, a)
    e = fd.sub(f, fd.sub(f, fd.square(f, fd.add(f, x1, y1)), a), b)
    g = fd.add(f, d, b)
    h = fd.sub(f, d, b)
    ff = fd.sub(f, g, c)
    return _stack(fd.mul(f, e, ff), fd.mul(f, g, h), fd.mul(f, ff, g), fd.mul(f, e, h))


def identity_plain(cs, batch: tuple, device) -> torch.Tensor:
    """The identity, (0, 1, 0) Weierstrass or (0, 1, 1, 0) Edwards."""
    pt = torch.zeros((cs.ncoords, cs.field.limbs), dtype=torch.int32, device=device)
    pt[1, 0] = 1
    if cs.kind == "edwards":
        pt[2, 0] = 1
    return pt.expand(batch + pt.shape)


def pt_add_plain(cs, p, q):
    return _ed_add(cs, p, q) if cs.kind == "edwards" else _ws_add(cs, p, q)


def pt_madd_plain(cs, p, q):
    return _ed_madd(cs, p, q) if cs.kind == "edwards" else _ws_madd(cs, p, q)


def pt_double_plain(cs, p, n_doubles: int = 1):
    """2^n_doubles·P, one doubling at a time."""
    double = _ed_double if cs.kind == "edwards" else _ws_double
    for _ in range(n_doubles):
        p = double(cs, p)
    return p


def pt_window_step_plain(cs, acc, entry, n_doubles: int):
    return pt_add_plain(cs, pt_double_plain(cs, acc, n_doubles), entry)


def pt_ladder_mul_add_plain(cs, p, addend, x, nbits: int):
    """x·P + A, MSB-first double and select-add over nbits bits of x."""
    batch = torch.broadcast_shapes(p.shape[:-2], addend.shape[:-2], x.shape)
    acc = identity_plain(cs, batch, p.device)
    for i in reversed(range(nbits)):
        acc = pt_double_plain(cs, acc)
        bit = ((x >> i) & 1) != 0
        acc = torch.where(bit[..., None, None], pt_add_plain(cs, acc, p), acc)
    return pt_add_plain(cs, acc, addend)


def pt_ladder_horner_plain(cs, coeffs, x, nbits: int):
    """T one-step plain ladders: acc <- x·acc + C_l from the top, from the
    identity."""
    acc = identity_plain(cs, torch.broadcast_shapes(coeffs.shape[:-3], x.shape), coeffs.device)
    for l in reversed(range(coeffs.shape[-3])):
        acc = pt_ladder_mul_add_plain(cs, acc, coeffs[..., l, :, :], x, nbits)
    return acc


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _launch(op: str, cs, operands, extra=()) -> torch.Tensor:
    """Launch ``op``'s kernel for ``cs`` over the broadcast batch of
    ``operands``, a list of (tensor, tail) pairs: points with tail (C, L),
    per-lane ints with ()."""
    kernel = kernel_for(op, cs)
    flat, out, n = build.lanes(operands, (cs.ncoords, cs.field.limbs))
    if n:
        kernel(*(t.data_ptr() for t in flat), out.data_ptr(), n, *extra,
               build.stream_ptr(out.device))
    return out


def pt_add(cs, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete projective p + q, batch axes broadcast."""
    if p.device.type == "cpu":
        return pt_add_plain(cs, p, q)
    point = (cs.ncoords, cs.field.limbs)
    return _launch("pt_add", cs, [(p, point), (q, point)])


def pt_madd(cs, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q with q affine (Z = 1); a Weierstrass q must not be the identity."""
    if p.device.type == "cpu":
        return pt_madd_plain(cs, p, q)
    point = (cs.ncoords, cs.field.limbs)
    return _launch("pt_madd", cs, [(p, point), (q, point)])


def pt_double(cs, p: torch.Tensor, n_doubles: int = 1) -> torch.Tensor:
    """2^n_doubles · P in one launch."""
    if p.device.type == "cpu":
        return pt_double_plain(cs, p, n_doubles)
    if n_doubles < 0:
        raise ValueError("n_doubles must be >= 0")
    return _launch("pt_double", cs, [(p, (cs.ncoords, cs.field.limbs))], (n_doubles,))


def pt_window_step(cs, acc: torch.Tensor, entry: torch.Tensor, n_doubles: int = 4) -> torch.Tensor:
    """2^n_doubles · acc + entry in one launch."""
    if acc.device.type == "cpu":
        return pt_window_step_plain(cs, acc, entry, n_doubles)
    if n_doubles < 0:
        raise ValueError("n_doubles must be >= 0")
    point = (cs.ncoords, cs.field.limbs)
    return _launch("pt_window_step", cs, [(acc, point), (entry, point)], (n_doubles,))


def pt_ladder_mul_add(cs, p: torch.Tensor, addend: torch.Tensor, x: torch.Tensor, nbits: int) -> torch.Tensor:
    """x·P + A for small public per-lane ints 0 <= x < 2**nbits (int32)."""
    if p.device.type == "cpu":
        return pt_ladder_mul_add_plain(cs, p, addend, x, nbits)
    if not 0 <= nbits <= 31:
        raise ValueError("nbits must be in [0, 31]")
    point = (cs.ncoords, cs.field.limbs)
    return _launch("pt_ladder_mul_add", cs, [(p, point), (addend, point), (x, ())], (nbits,))


def pt_ladder_horner(cs, coeffs: torch.Tensor, x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Σ_l x^l·C_l in one launch, Horner from the top with one
    ``pt_ladder_mul_add`` step per coefficient: coeffs (..., T, C, L)
    low-order first, x (...,) int32 small public ints 0 <= x < 2**nbits ->
    (..., C, L), batch axes broadcast.  Coefficients shared by the trailing
    batch axes are read once a row, never copied to the batch."""
    if coeffs.device.type == "cpu":
        return pt_ladder_horner_plain(cs, coeffs, x, nbits)
    if not 0 <= nbits <= 31:
        raise ValueError("nbits must be in [0, 31]")
    kernel = kernel_for("pt_ladder_horner", cs)
    point = (cs.ncoords, cs.field.limbs)
    if coeffs.dim() < 3:
        raise ValueError(f"pt_ladder_horner takes coeffs (..., T, C, L), got {tuple(coeffs.shape)}")
    T = coeffs.shape[-3]
    dev = build.check_operands([(coeffs, (T,) + point), (x, ())])
    batch = torch.broadcast_shapes(coeffs.shape[:-3], x.shape)
    out = torch.empty(batch + point, dtype=torch.int32, device=dev)
    n = out.numel() // (cs.ncoords * cs.field.limbs)
    if n:
        rows, per_row = build.rows(coeffs, batch, (T,) + point)
        xs = x.expand(batch).contiguous()
        kernel(rows.data_ptr(), len(rows), per_row, xs.data_ptr(), out.data_ptr(), n, T, nbits,
               build.stream_ptr(dev))
    return out
