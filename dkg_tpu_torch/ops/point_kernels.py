"""Point kernels: ``pt_add``, ``pt_madd``, ``pt_double``,
``pt_window_step``, ``pt_ladder_mul_add``, ``pt_ladder_horner`` (the
whole point Horner of ``groups.device.eval_point_poly`` in one launch),
``pt_fixed_base`` (every window of ``groups.device.fixed_base_mul`` in one
launch), ``pt_scalar_mul`` (every window of ``groups.device.scalar_mul``
in one launch) and ``pt_tree_sum`` (a whole ``groups.device._tree_reduce``
in one launch), with their plain PyTorch versions.

Counterpart of ``dkg_tpu/ops/pallas_point.py``.  Points are int32 limb
tensors of shape ``(..., C, L)``: C projective coordinates (3 for short
Weierstrass a = 0, 4 for extended Edwards) of L 16-bit limbs (16, or
24 on BLS12-381 G1).  On a CUDA tensor each wrapper launches the kernel
of its curve: secp256k1's in ``csrc/point_kernels.cu``, edwards25519's
(ristretto255) in ``csrc/edwards_kernels.cu``, ``pt_double`` for both in
``csrc/double_kernels.cu``, and every BLS12-381 G1 kernel in
``csrc/bls_kernels.cu``, ``pt_ladder_horner`` for all three in
``csrc/ladder_kernels.cu``, and ``pt_fixed_base``, ``pt_scalar_mul`` and
``pt_tree_sum`` for all three in ``csrc/chain_kernels.cu``; a curve with
no kernel raises.  On a CPU
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
# the chained kernels: (table, k, out, n, nw, window, klimbs, group) and
# (src, sb, sj, digits, dsb, dsj, out, cols, m, levels, group)
_CHAIN = "chain_kernels.cu"
_FIXED = [_P, _P, _P, _I, _INT, _INT, _INT, _INT, _P]
_TREE = [_P, _I, _I, _P, _I, _I, _P, _I, _I, _INT, _INT, _P]
PT_FIXED_BASE = build.Kernel("pt_fixed_base", _CHAIN, "dkg_pt_fixed_base", _FIXED)
ED_PT_FIXED_BASE = build.Kernel("pt_fixed_base[edwards]", _CHAIN, "dkg_ed_pt_fixed_base", _FIXED)
BLS_PT_FIXED_BASE = build.Kernel("pt_fixed_base[bls12_381]", _CHAIN, "dkg_bls_pt_fixed_base", _FIXED)
# (table, rows, per_row, k, out, n, nw, window, klimbs, group)
_SCALAR = [_P, _I, _I, _P, _P, _I, _INT, _INT, _INT, _INT, _P]
PT_SCALAR_MUL = build.Kernel("pt_scalar_mul", _CHAIN, "dkg_pt_scalar_mul", _SCALAR)
ED_PT_SCALAR_MUL = build.Kernel("pt_scalar_mul[edwards]", _CHAIN, "dkg_ed_pt_scalar_mul", _SCALAR)
BLS_PT_SCALAR_MUL = build.Kernel("pt_scalar_mul[bls12_381]", _CHAIN, "dkg_bls_pt_scalar_mul", _SCALAR)
PT_TREE_SUM = build.Kernel("pt_tree_sum", _CHAIN, "dkg_pt_tree_sum", _TREE)
ED_PT_TREE_SUM = build.Kernel("pt_tree_sum[edwards]", _CHAIN, "dkg_ed_pt_tree_sum", _TREE)
BLS_PT_TREE_SUM = build.Kernel("pt_tree_sum[bls12_381]", _CHAIN, "dkg_bls_pt_tree_sum", _TREE)
KERNELS = (PT_ADD, PT_MADD, PT_WINDOW_STEP, PT_LADDER_MUL_ADD,
           ED_PT_ADD, ED_PT_MADD, ED_PT_WINDOW_STEP, ED_PT_LADDER_MUL_ADD, PT_DOUBLE, ED_PT_DOUBLE,
           BLS_PT_ADD, BLS_PT_MADD, BLS_PT_DOUBLE, BLS_PT_WINDOW_STEP, BLS_PT_LADDER_MUL_ADD,
           PT_LADDER_HORNER, ED_PT_LADDER_HORNER, BLS_PT_LADDER_HORNER,
           PT_FIXED_BASE, ED_PT_FIXED_BASE, BLS_PT_FIXED_BASE, PT_TREE_SUM, ED_PT_TREE_SUM, BLS_PT_TREE_SUM,
           PT_SCALAR_MUL, ED_PT_SCALAR_MUL, BLS_PT_SCALAR_MUL)

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
    "pt_fixed_base": {_WS_KEY: PT_FIXED_BASE, _ED_KEY: ED_PT_FIXED_BASE, _BLS_KEY: BLS_PT_FIXED_BASE},
    "pt_tree_sum": {_WS_KEY: PT_TREE_SUM, _ED_KEY: ED_PT_TREE_SUM, _BLS_KEY: BLS_PT_TREE_SUM},
    "pt_scalar_mul": {_WS_KEY: PT_SCALAR_MUL, _ED_KEY: ED_PT_SCALAR_MUL, _BLS_KEY: BLS_PT_SCALAR_MUL},
}
# The chained kernels' lane rules.  A lane runs on one thread or, on the
# curves where csrc/chain_kernels.cu builds a group variant of the kernel
# (its DKG_CHAIN_TPI_* set the sizes), below a count of lanes (or
# columns) on a group of threads; a curve missing here has no group
# variant, and a group asked of one raises.
# pt_fixed_base: below 2**15 lanes on secp256k1 and BLS12-381 (one thread
# a lane leaves most of the card idle at the verifier's 1024 lanes; from
# 2**15 on, one thread a lane needs no Montgomery conversion); on
# edwards25519 one thread a lane was as fast at 256 lanes.  pt_tree_sum:
# one thread a lane was faster at a Straus window's 342 and 86 columns on
# every curve and at the master key's one column on the 8-word fields; on
# BLS12-381 one column (one block: its 1023 adds' latency) went faster on
# groups of 4 (ops/chain_bench.py; PERF.md has the table).
FIXED_BASE_GROUP_BELOW = {_WS_KEY: 1 << 15, _BLS_KEY: 1 << 15}
TREE_GROUP_BELOW = {_BLS_KEY: 2}
# pt_scalar_mul: below 2**15 lanes on every curve: a recipient's opens
# (1024 or 256 lanes) and a default seal chunk's KEM (4096 lanes), where
# one thread a lane leaves the card idle and waits on one multiply at a
# time; the unchunked KEM's 65,536 and more fill the card at one thread a
# lane (ops/chain_bench.py; PERF.md has the table).
SCALAR_MUL_GROUP_BELOW = {_WS_KEY: 1 << 15, _BLS_KEY: 1 << 15, _ED_KEY: 1 << 15}
# pt_tree_sum: leaves a block sums at most (2^TREE_CHUNK_LOG); a longer
# column sums aligned chunks of that many, then their tops.
TREE_CHUNK_LOG = 10


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


def window_digits(k, window: int):
    """(..., L) scalar limbs -> (..., L * 16/window) little-endian digits;
    ``window`` divides the 16-bit limb."""
    shifts = torch.arange(0, 16, window, dtype=torch.int32, device=k.device)
    digits = (k[..., :, None] >> shifts) & ((1 << window) - 1)
    return digits.reshape(k.shape[:-1] + (k.shape[-1] * (16 // window),))


def pt_fixed_base_plain(cs, table, k, madd=pt_madd_plain):
    """k·B for a fixed B: one gathered mixed add per window of the affine
    table (NW, 2**w, C, L), no doublings; on Weierstrass curves a gathered
    entry with Z = 0 (the identity, which the mixed add cannot take) keeps
    the accumulator.  ``madd`` (cs, p, q) is the step: given ``pt_madd``,
    this loop is the kernel's one-step route."""
    window = int(table.shape[1]).bit_length() - 1
    digits = window_digits(k, window)
    acc = identity_plain(cs, k.shape[:-1], k.device)
    for w in range(table.shape[0]):
        entry = table[w][digits[..., w].long()]
        nxt = madd(cs, acc, entry)
        if cs.kind != "edwards":
            nxt = torch.where(fd.is_zero(entry[..., 2, :])[..., None, None], acc, nxt)
        acc = nxt
    return acc


def _gather_table(table, digit):
    """Window entries: table (..., E, C, L) batch-matched to ``digit``
    (...,), or one shared (E, C, L) table -> (..., C, L)."""
    if table.dim() == 3:
        return table[digit.long()]
    idx = digit.long()[..., None, None, None].expand(digit.shape + (1,) + table.shape[-2:])
    return torch.gather(table, -3, idx)[..., 0, :, :]


def pt_scalar_mul_plain(cs, table, k, step=pt_window_step_plain):
    """k·P from P's window table (..., 2**w, C, L) (entry d = d·P, its
    batch broadcast to k's), k (..., L) scalar limbs: from the identity,
    for each w-bit digit MSB first, one window step (w doublings, then +
    the gathered entry).  ``step`` (cs, acc, entry, w) is the step: given
    ``pt_window_step``, this loop is the kernel's one-step route."""
    window = int(table.shape[-3]).bit_length() - 1
    batch = k.shape[:-1]
    if table.dim() > 3:
        table = table.expand(batch + table.shape[-3:])
    digits = window_digits(k, window)
    acc = identity_plain(cs, batch, k.device)
    for d in reversed(range(digits.shape[-1])):
        acc = step(cs, acc, _gather_table(table, digits[..., d]), window)
    return acc


def _gather_entries(tables, digits):
    """tables (..., m, E, C, L), digits broadcast to (..., m) ->
    (..., m, C, L): entry digits[..., j] of point j's table."""
    batch = torch.broadcast_shapes(tables.shape[:-3], digits.shape)
    idx = digits.long().expand(batch)[..., None, None, None].expand(batch + (1,) + tables.shape[-2:])
    return torch.gather(tables.expand(batch + tables.shape[-3:]), -3, idx)[..., 0, :, :]


def pt_tree_sum_plain(cs, pts, digits=None, add=pt_add_plain):
    """The pairwise add tree over axis -3 of pts (..., m, C, L), the
    identity appended at each odd level; with ``digits``, over the entries
    ``pts[..., j, digits[..., j]]`` of per-point tables (..., m, E, C, L).
    ``add`` (cs, p, q) is the step: given ``pt_add``, this loop is the
    kernel's one-step route."""
    if digits is not None:
        pts = _gather_entries(pts, digits)
    m = pts.shape[-3]
    if m < 1:
        raise ValueError("pt_tree_sum needs at least one point")
    while m > 1:
        if m % 2 == 1:
            pts = torch.cat([pts, identity_plain(cs, pts.shape[:-3] + (1,), pts.device)], dim=-3)
            m += 1
        pts = add(cs, pts[..., 0::2, :, :], pts[..., 1::2, :, :])
        m //= 2
    return pts[..., 0, :, :]


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


def fixed_base_group(cs, lanes: int) -> bool:
    """Whether pt_fixed_base's call over ``lanes`` lanes spreads a lane
    over a group of threads."""
    return lanes < FIXED_BASE_GROUP_BELOW.get((cs.kind, cs.field.name, cs.const), 0)


def scalar_mul_group(cs, lanes: int) -> bool:
    """Whether pt_scalar_mul's call over ``lanes`` lanes spreads a lane
    over a group of threads."""
    return lanes < SCALAR_MUL_GROUP_BELOW.get((cs.kind, cs.field.name, cs.const), 0)


def tree_group(cs, columns: int) -> bool:
    """Whether pt_tree_sum's call over ``columns`` columns spreads a lane
    over a group of threads."""
    return columns < TREE_GROUP_BELOW.get((cs.kind, cs.field.name, cs.const), 0)


def pt_fixed_base(cs, table: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k·B for a fixed B in one launch: table (NW, 2**w, C, L) affine
    entries T[w][d] = d·2**(w·j)·B (w divides 16), k (..., L) scalar limbs
    -> (..., C, L), equal to NW gathered ``pt_madd`` steps from the
    identity.  A lane runs on one thread or a group by
    :func:`fixed_base_group`."""
    if k.device.type == "cpu":
        return pt_fixed_base_plain(cs, table, k)
    kernel = kernel_for("pt_fixed_base", cs)
    point = (cs.ncoords, cs.field.limbs)
    if table.dim() != 4:
        raise ValueError(f"pt_fixed_base takes a table (NW, 2**w, C, L), got {tuple(table.shape)}")
    nw, entries = table.shape[:2]
    window = entries.bit_length() - 1
    if entries != 1 << window or window < 1 or 16 % window or nw * window > 16 * k.shape[-1]:
        raise ValueError(f"pt_fixed_base: a table of {nw} windows of {entries} entries does not fit "
                         f"{k.shape[-1]}-limb scalars")
    dev = build.check_operands([(table, (nw, entries) + point), (k, (k.shape[-1],))])
    tab = build.aligned(table.contiguous())
    ks = k.reshape(-1, k.shape[-1]).contiguous()
    out = torch.empty(k.shape[:-1] + point, dtype=torch.int32, device=dev)
    n = ks.shape[0]
    if n:
        kernel(tab.data_ptr(), ks.data_ptr(), out.data_ptr(), n, nw, window, ks.shape[-1],
               int(fixed_base_group(cs, n)), build.stream_ptr(dev))
    return out


def table_rows(table: torch.Tensor, batch: tuple, tail: tuple) -> tuple[torch.Tensor, int, int]:
    """``table`` (a batch broadcast to ``batch``, then ``tail``) as
    contiguous rows (R, *tail) and the lane map row(i) = (i // per_row) %
    R over the lanes of ``batch``: the batch axes before its first and
    after its last axis of size > 1 are broadcast and read in place (a key
    shared by every dealer, a point shared by every scalar); only a
    broadcast axis between those is copied.  Returns (rows, R, per_row)."""
    nlead = table.dim() - len(tail)
    lead = (1,) * (len(batch) - nlead) + tuple(table.shape[:nlead])
    live = [i for i, d in enumerate(lead) if d > 1]
    lo, hi = (live[0], live[-1] + 1) if live else (0, 0)
    per_row = 1
    for d in batch[hi:]:
        per_row *= d
    block = tuple(batch[lo:hi])
    rows = table.reshape(lead + tuple(tail))[(0,) * lo + (slice(None),) * (hi - lo) + (0,) * (len(lead) - hi)]
    rows = build.aligned(rows.expand(block + tuple(tail)).reshape((-1,) + tuple(tail)).contiguous())
    return rows, rows.shape[0], per_row


def pt_scalar_mul(cs, table: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k·P for every window of ``groups.device.scalar_mul`` in one launch:
    table (..., 2**w, C, L) window tables (entry d = d·P, w divides 16),
    their batch broadcast to k's and read in place, k (..., L) scalar limbs
    -> (..., C, L), equal to the L·16/w ``pt_window_step`` steps of
    :func:`pt_scalar_mul_plain` from the identity.  A lane runs on one
    thread or a group by :func:`scalar_mul_group`."""
    if k.device.type == "cpu":
        return pt_scalar_mul_plain(cs, table, k)
    kernel = kernel_for("pt_scalar_mul", cs)
    point = (cs.ncoords, cs.field.limbs)
    if table.dim() < 3:
        raise ValueError(f"pt_scalar_mul takes tables (..., 2**w, C, L), got {tuple(table.shape)}")
    entries = table.shape[-3]
    window = entries.bit_length() - 1
    klimbs = k.shape[-1]
    if entries != 1 << window or window < 1 or 16 % window:
        raise ValueError(f"pt_scalar_mul: a table of {entries} entries is not a window that divides 16")
    dev = build.check_operands([(table, (entries,) + point), (k, (klimbs,))])
    batch = k.shape[:-1]
    if torch.broadcast_shapes(table.shape[:-3], batch) != batch:
        raise ValueError(f"pt_scalar_mul: tables {tuple(table.shape)} do not broadcast to the scalars' batch {batch}")
    out = torch.empty(batch + point, dtype=torch.int32, device=dev)
    n = out.numel() // (cs.ncoords * cs.field.limbs)
    if n:
        rows, n_rows, per_row = table_rows(table, batch, (entries,) + point)
        ks = k.reshape(-1, klimbs).contiguous()
        kernel(rows.data_ptr(), n_rows, per_row, ks.data_ptr(), out.data_ptr(), n, klimbs * 16 // window, window,
               klimbs, int(scalar_mul_group(cs, n)), build.stream_ptr(dev))
    return out


def tree_levels(m: int, chunk_log: int) -> int:
    """Levels of pt_tree_sum's first launch over m points: the whole tree
    (ceil(log2 m)) where it fits a block, else chunk_log."""
    return min((m - 1).bit_length(), chunk_log)


def _strided(t: torch.Tensor, tail: tuple) -> torch.Tensor:
    """t (cols, m, *tail) as the kernel reads it: tail contiguous, the two
    leading strides free, 16-byte aligned points."""
    want = torch.empty(tail).stride()
    if tuple(t.stride()[2:]) != want or any(s % 4 for s in t.stride()[:2]):
        t = t.contiguous()
    return build.aligned(t)


def pt_tree_sum(cs, pts: torch.Tensor, digits: torch.Tensor | None = None) -> torch.Tensor:
    """The pairwise add tree of ``groups.device._tree_reduce`` over axis -3
    in one launch (two where a column has more than 2**TREE_CHUNK_LOG
    points): pts (..., m, C, L) -> (..., C, L).  With ``digits`` (..., m),
    pts are per-point tables (..., m, E, C, L) and the tree sums entry
    digits[..., j] of each, read in place (digits in [0, E)).  Strided views
    are read as they are; a lane runs on one thread or a group by
    :func:`tree_group`."""
    if pts.device.type == "cpu":
        return pt_tree_sum_plain(cs, pts, digits)
    kernel = kernel_for("pt_tree_sum", cs)
    point = (cs.ncoords, cs.field.limbs)
    tail = point if digits is None else (pts.shape[-3],) + point
    if pts.dim() < len(tail) + 1:
        raise ValueError(f"pt_tree_sum takes points (..., m, C, L), got {tuple(pts.shape)}")
    lead = pts.shape[: pts.dim() - len(tail)]
    dev = build.check_operands([(pts, tail)] + ([] if digits is None else [(digits.to(torch.int32), ())]))
    batch = lead if digits is None else torch.broadcast_shapes(lead, digits.shape)
    m = batch[-1]
    if m < 1:
        raise ValueError("pt_tree_sum needs at least one point")
    src = _strided(pts.expand(batch + tail).reshape((-1, m) + tail), tail)
    dig = None if digits is None else digits.to(torch.int32).expand(batch).reshape(-1, m)
    group, stream = int(tree_group(cs, src.shape[0])), build.stream_ptr(dev)
    out = tree_sum_passes(lambda *args: kernel(*args, group, stream), src, dig, point, TREE_CHUNK_LOG)
    return out.reshape(batch[:-1] + point)


def tree_sum_passes(launch, src, dig, point: tuple, chunk_log: int) -> torch.Tensor:
    """pt_tree_sum's launches over src (cols, m, ...) (with dig (cols, m),
    table entries): ``launch(src, sb, sj, digits, dsb, dsj, out, cols, m,
    levels)`` (pointers and strides in int32 words) sums each column's
    aligned chunks of 2**levels points into out (cols, chunks, *point);
    while there is more than one chunk, their tops are summed the same way.
    Returns (cols, *point)."""
    cols, m = src.shape[:2]
    levels = tree_levels(m, chunk_log)
    chunks = ((m - 1) >> levels) + 1
    out = torch.empty((cols, chunks) + point, dtype=torch.int32, device=src.device)
    if cols:
        launch(src.data_ptr(), src.stride(0), src.stride(1), None if dig is None else dig.data_ptr(),
               0 if dig is None else dig.stride(0), 0 if dig is None else dig.stride(1),
               out.data_ptr(), cols, m, levels)
    if chunks == 1:
        return out[:, 0]
    return tree_sum_passes(launch, out, None, point, chunk_log)
