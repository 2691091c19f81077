"""Batched elliptic-curve arithmetic on int32 limb tensors.

Counterpart of ``dkg_tpu/groups/device.py``.  Points are tensors of
shape ``(..., C, L)``: C projective coordinates of L 16-bit limbs,
batched over the leading axes.  Every formula is complete, so adding the
identity, adding a point to itself and doubling all take the same
branchless path.  Point adds go through the kernels of
``ops/point_kernels.py`` (CUDA tensors) or their plain versions (CPU
tensors); the schedules around them (window tables, gathers, bucket
closes) are plain PyTorch, in the JAX package's order, and the chained
ones (tree reductions, fixed-base windows, Horner) one kernel each, in
the same order, so the projective coordinates equal the JAX package's
limb for limb.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fields import device as fd
from ..fields import host as fh
from ..fields.spec import L25519, P25519, FieldSpec
from ..ops import bucket_kernels as bk
from ..ops import field_kernels as fk
from ..ops import mxu_kernels as mk
from ..ops import point_kernels as pk
from . import host as gh
from . import ristretto_device as rd

WINDOW = 4  # variable-base window bits (16-entry per-lane tables)
FIXED_WINDOW = 8  # fixed-base tables: 256-entry windows


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    """Device-side curve description (ints and strings only)."""

    name: str
    kind: str  # "edwards" | "weierstrass_a0"
    field: FieldSpec
    scalar: FieldSpec
    const: int  # 2d (edwards) or 3b (weierstrass_a0)
    gen_affine: tuple  # (x, y) ints

    @property
    def ncoords(self) -> int:
        return 4 if self.kind == "edwards" else 3


SECP256K1 = CurveSpec(
    "secp256k1",
    "weierstrass_a0",
    gh.SECP256K1.base_field,
    gh.SECP256K1.scalar_field,
    21,
    (gh.SECP256K1.gen_x, gh.SECP256K1.gen_y),
)

RISTRETTO255 = CurveSpec(
    "ristretto255",
    "edwards",
    P25519,
    L25519,
    2 * gh.D % gh.P,
    (gh.BASE_X, gh.BASE_Y),
)

BLS12_381_G1 = CurveSpec(
    "bls12_381_g1",
    "weierstrass_a0",
    gh.BLS12_381_G1.base_field,
    gh.BLS12_381_G1.scalar_field,
    12,
    (gh.BLS12_381_G1.gen_x, gh.BLS12_381_G1.gen_y),
)

ALL_CURVES = {c.name: c for c in (SECP256K1, RISTRETTO255, BLS12_381_G1)}


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------


def identity(cs: CurveSpec, batch: tuple = (), *, device) -> torch.Tensor:
    """The identity broadcast to ``batch`` (a read-only expanded view)."""
    return pk.identity_plain(cs, tuple(batch), device)


def gen_host(cs: CurveSpec) -> tuple:
    """The curve generator as a host point tuple."""
    x, y = cs.gen_affine
    if cs.kind == "edwards":
        return (x, y, 1, x * y % cs.field.modulus)
    return (x, y, 1)


def generator(cs: CurveSpec, batch: tuple = (), *, device) -> torch.Tensor:
    """The generator broadcast to ``batch`` (a read-only expanded view)."""
    g = from_host(cs, [gen_host(cs)], device=device)[0]
    return g.expand(tuple(batch) + g.shape)


def base_key(cs: CurveSpec, point) -> tuple:
    """Hashable key for a host point: its affine (x, y), or ("identity",)
    for the Weierstrass identity."""
    if cs.kind == "edwards":
        pm = cs.field.modulus
        x, y, z, _ = point
        zi = pow(z, pm - 2, pm)
        return (x * zi % pm, y * zi % pm)
    aff = gh.ALL_GROUPS[cs.name].to_affine(point)
    return aff if aff is not None else ("identity",)


def base_key_to_point(cs: CurveSpec, key: tuple):
    """The host point of a :func:`base_key`."""
    if key == ("identity",):
        return gh.ALL_GROUPS[cs.name].identity()
    x, y = key
    if cs.kind == "edwards":
        return (x, y, 1, x * y % cs.field.modulus)
    return (x, y, 1)


def from_host(cs: CurveSpec, points, *, device) -> torch.Tensor:
    """Host point tuples -> (n, C, L) int32 limbs."""
    arr = np.asarray([[int(c) for c in p] for p in points], dtype=object)
    return fh.to_tensor(fh.encode(cs.field, arr), device)


def to_host(cs: CurveSpec, pts: torch.Tensor) -> list:
    """(n, C, L) limbs -> host point tuples."""
    dec = fh.decode(cs.field, fh.from_tensor(pts))
    return [tuple(int(c) for c in row) for row in dec]


# ---------------------------------------------------------------------------
# point ops
# ---------------------------------------------------------------------------


def add(cs: CurveSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return pk.pt_add(cs, p, q)


def double(cs: CurveSpec, p: torch.Tensor) -> torch.Tensor:
    return pk.pt_double(cs, p)


def madd(cs: CurveSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q with q affine (Z = 1).  Weierstrass callers must not pass
    q = identity."""
    return pk.pt_madd(cs, p, q)


def eq(cs: CurveSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Projective equality -> bool over the batch shape: cross-multiplied
    for Weierstrass (identity-correct), torsion-safe ristretto equality
    for Edwards.  Each product is one ``mod_mul`` (its plain version on
    CPU tensors)."""
    f, mul = cs.field, fk.mod_mul
    if cs.kind == "edwards":
        x1, y1 = p[..., 0, :], p[..., 1, :]
        x2, y2 = q[..., 0, :], q[..., 1, :]
        lhs = fd.eq(mul(f, x1, y2), mul(f, y1, x2))
        rhs = fd.eq(mul(f, y1, y2), mul(f, x1, x2))
        return lhs | rhs
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    x2, y2, z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    ex = fd.eq(mul(f, x1, z2), mul(f, x2, z1))
    ey = fd.eq(mul(f, y1, z2), mul(f, y2, z1))
    return ex & ey


def neg(cs: CurveSpec, p: torch.Tensor) -> torch.Tensor:
    """-P: (x, -y, z) Weierstrass, (-x, y, z, -t) Edwards."""
    f = cs.field
    if cs.kind == "edwards":
        return torch.stack([fd.neg(f, p[..., 0, :]), p[..., 1, :], p[..., 2, :], fd.neg(f, p[..., 3, :])], dim=-2)
    return torch.stack([p[..., 0, :], fd.neg(f, p[..., 1, :]), p[..., 2, :]], dim=-2)


def select(pred: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Branchless point select; ``pred`` has the batch shape."""
    return torch.where(pred[..., None, None], p, q)


# ---------------------------------------------------------------------------
# scalar windows, tables, reductions
# ---------------------------------------------------------------------------


def n_windows(cs: CurveSpec, window: int = WINDOW) -> int:
    return cs.scalar.limbs * (16 // window)


def scalar_windows(cs: CurveSpec, k: torch.Tensor, window: int = WINDOW) -> torch.Tensor:
    """(..., L) scalar limbs -> (..., L * 16/window) little-endian digits;
    ``window`` divides 16.  ``ops.point_kernels.window_digits``, the digits
    every windowed kernel's plain version reads."""
    return pk.window_digits(k, window)


def _build_table(cs: CurveSpec, p: torch.Tensor) -> torch.Tensor:
    """Per-lane window table [0P, 1P, ..., 15P]: (..., 16, C, L), each
    entry the previous one plus P (14 batched adds)."""
    entries = [identity(cs, p.shape[:-2], device=p.device), p]
    prev = p
    for _ in range(14):
        prev = add(cs, prev, p)
        entries.append(prev)
    return torch.stack(entries, dim=-3)


def _tree_reduce(cs: CurveSpec, pts: torch.Tensor, axis_len: int) -> torch.Tensor:
    """Pairwise point-add reduction over axis -3 (of length ``axis_len``),
    padding odd levels with the identity: one ``pt_tree_sum`` launch (its
    plain version, the level loop, on CPU tensors)."""
    if axis_len != pts.shape[-3]:
        raise ValueError(f"axis_len {axis_len} is not the length {pts.shape[-3]} of axis -3")
    return pk.pt_tree_sum(cs, pts)


def window_step(cs: CurveSpec, acc: torch.Tensor, entry: torch.Tensor, window: int) -> torch.Tensor:
    """One Straus window: ``window`` doublings of acc, then + entry, in one
    ``pt_window_step`` launch on every curve (its plain version on CPU
    tensors)."""
    return pk.pt_window_step(cs, acc, entry, window)


# ---------------------------------------------------------------------------
# variable-base, fixed-base and small-scalar multiplication
# ---------------------------------------------------------------------------


def scalar_mul(cs: CurveSpec, k: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Batched k·P: k (..., L) scalar limbs, p (..., C, L) points broadcast
    to k's batch -> (..., C, L); the JAX package's ``scalar_mul`` and
    ``_scalar_mul_core`` in one (its power-of-two padding of eager batches
    bounds its compiles, and the padded lanes are dropped).

    A fixed-window MSB-first double-and-add: per-lane 16-entry tables, then
    one window step per 4-bit digit from the top (a digit 0 adds the
    identity through the complete formulas), every window in one
    ``pt_scalar_mul`` launch (its plain version, the window loop, on CPU
    tensors).  The tables are built over p's own batch and read where they
    lie, so a point shared by many scalars (a recipient's key under every
    dealer's randomness) builds its table once and is never copied to k's
    batch; the entries are the same values either way."""
    return pk.pt_scalar_mul(cs, _build_table(cs, p), k)


def fixed_base_mul(cs: CurveSpec, table: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Batched k·B for a fixed B: table (NW, 2**w, C, L) of affine entries
    T[w][d] = d·(2**w)^w·B, k (..., L) -> (..., C, L).

    One gathered mixed add per window, no doublings, all windows in one
    ``pt_fixed_base`` launch (its plain version, the window loop, on CPU
    tensors).  A Weierstrass identity entry is stored (0, 1, 0), which the
    mixed add cannot take, so lanes whose gathered entry has Z = 0 keep
    their accumulator."""
    return pk.pt_fixed_base(cs, table, k)


def scalar_mul_small(cs: CurveSpec, k: torch.Tensor, p: torch.Tensor, nbits: int) -> torch.Tensor:
    """k·P for small public ints 0 <= k < 2**nbits: k (...,) int32, p (...,
    C, L), batch axes broadcast -> (..., C, L).

    One ``pt_ladder_mul_add`` launch against the identity addend, the JAX
    package's fused branch (its plain version, the MSB-first double and
    select-add ladder and then + identity, on CPU tensors).  The JAX
    package's unfused ladder stops before that last add, which rescales
    the projective limbs; the group elements, and so the canonical affine
    forms, are equal."""
    batch = torch.broadcast_shapes(tuple(k.shape), tuple(p.shape[:-2]))
    p = p.expand(batch + tuple(p.shape[-2:]))
    return pk.pt_ladder_mul_add(cs, p, identity(cs, batch, device=p.device), k.expand(batch), nbits)


def eval_point_poly(cs: CurveSpec, coeffs: torch.Tensor, x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Horner evaluation of a point-coefficient polynomial at small public
    x: coeffs (..., T, C, L) low-order first, x (...,) int32 -> (..., C, L).

    acc <- x·acc + C_l per step, each step ``pt_ladder_mul_add``'s ladder:
    all T steps are one ``pt_ladder_horner`` launch."""
    return pk.pt_ladder_horner(cs, coeffs, x, nbits)


# ---------------------------------------------------------------------------
# multi-scalar multiplication
# ---------------------------------------------------------------------------


def msm(cs: CurveSpec, scalars: torch.Tensor, points: torch.Tensor, mode: str | None = None) -> torch.Tensor:
    """Batched MSM Σ_j k_j·P_j over axis -2 of scalars / -3 of points:
    scalars (..., m, L), points (..., m, C, L) -> (..., C, L).

    ``mode`` picks the schedule, ``"straus"`` (:func:`msm_straus`) or
    ``"pippenger"`` (:func:`msm_pippenger`); the two agree in canonical
    affine form.  Its default is the JAX package's on an accelerator:
    Straus, but Pippenger on Edwards curves, whose one-launch window step
    the JAX package does not run there."""
    if mode is None:
        mode = "pippenger" if cs.kind == "edwards" else "straus"
    if mode == "pippenger":
        return msm_pippenger(cs, scalars, points)
    if mode == "straus":
        return msm_straus(cs, scalars, points)
    raise ValueError(f"msm mode must be 'straus' or 'pippenger', got {mode!r}")


def msm_straus(cs: CurveSpec, scalars: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Straus shared-doubling MSM: per-point 16-entry tables, then per
    4-bit window from the top, tree-sum each point's entry under its digit
    (one ``pt_tree_sum`` launch, the entries read in place), and one window
    step."""
    scalars = scalars.expand(points.shape[:-2] + scalars.shape[-1:])
    tables = _build_table(cs, points)  # (..., m, 16, C, L)
    digits = pk.window_digits(scalars, WINDOW)  # (..., m, NW)
    acc = identity(cs, points.shape[:-3], device=points.device)
    for d in reversed(range(digits.shape[-1])):
        total = pk.pt_tree_sum(cs, tables, digits[..., d])  # the entries read in place
        acc = window_step(cs, acc, total, WINDOW)
    return acc


# Measured c=4 -> c=8 crossover per curve in the JAX package (its CPU
# probe); the 16-limb curves default to m = 448.  Which width the H100
# wants is not measured yet.
_PIPPENGER_CROSSOVER: dict[str, int] = {"bls12_381_g1": 512}


def pippenger_window(m: int, curve: str | None = None) -> int:
    """Bucket width (bits) from the MSM batch shape (and curve), the JAX
    package's rule: the scatter pass costs m adds a window whatever c is,
    closing the buckets about 2**(c+1), so c = 8 halves the windows once
    m passes the crossover.  Widths divide the 16-bit limb."""
    return 8 if m >= _PIPPENGER_CROSSOVER.get(curve, 448) else 4


def msm_pippenger(cs: CurveSpec, scalars: torch.Tensor, points: torch.Tensor, nbits: int | None = None
                  ) -> torch.Tensor:
    """Bucket-method MSM: scalars (..., m, L), points (..., m, C, L) ->
    (..., C, L).  ``nbits`` bounds the scalars' bit width (128-bit RLC
    weights); windows above it are dropped.  Scalars broadcast to the
    points' batch; an (m, L) block stays shared, so the kernel reads one
    digit block for the whole batch, and so does a convoy of blocks
    (K..., 1..., m, L) over points (K..., B..., m, C, L) with B... not all
    1 (the service's stacked verify: each ceremony's weights shared by its
    own columns), one digit block a ceremony."""
    if nbits is None:
        nbits = cs.scalar.limbs * 16
    if scalars.dim() > 2 and _convoy_lead(scalars.shape[:-2], points.shape[:-3]) is None:
        scalars = scalars.expand(points.shape[:-2] + scalars.shape[-1:])
    return _msm_pippenger_core(cs, scalars, points, nbits)


def _convoy_lead(scalar_batch: tuple, point_batch: tuple) -> int | None:
    """The number c of leading axes that make ``scalar_batch`` a convoy of
    digit blocks over ``point_batch``: equal to it on the first c axes, 1
    on the rest, which in ``point_batch`` are not all 1; None otherwise
    (shared, per-row or broadcast elsewhere)."""
    if len(scalar_batch) != len(point_batch):
        return None
    c = len(scalar_batch)
    while c > 0 and scalar_batch[c - 1] == 1:
        c -= 1
    if c == 0 or tuple(scalar_batch[:c]) != tuple(point_batch[:c]):
        return None
    rest = 1
    for d in point_batch[c:]:
        rest *= d
    return c if rest > 1 else None


def _msm_pippenger_core(cs: CurveSpec, scalars: torch.Tensor, points: torch.Tensor, nbits: int) -> torch.Tensor:
    """Three passes, batched over the leading axes and all windows at once:

    1. scatter: each window's points summed into buckets 1 .. 2**c - 1 (a
       digit-0 point into none), each bucket in order of j: scalars (m, L)
       shared by the batch (the point RLC's weights) take one
       ``pt_bucket_sum`` launch over their sorted lists; per-row scalars
       take ``bucket_accumulate`` (which also forms bucket 0, dropped);
    2. bucket close: a descending suffix sum over buckets 2**c - 1 .. 1,
       ``run = run + B_b; tot = tot + run``, gives Σ_b b·B_b per window in
       two adds a bucket, one ``pt_bucket_close`` launch;
    3. window combine: MSB first, ``window_step`` (c doublings, one add).

    A convoy of scalar blocks (K..., 1..., m, L) (:func:`_convoy_lead`)
    takes one ``pt_bucket_sum`` launch too, block k's digits sorted on their
    own and shared by ceremony k's columns.  On CPU tensors each pass runs
    its plain version."""
    m = points.shape[-3]
    batch = points.shape[:-3]
    window = pippenger_window(m, cs.name)
    nw = min(n_windows(cs, window), -(-nbits // window))
    digits = pk.window_digits(scalars, window)[..., :nw]  # (..., m, nw)
    c = _convoy_lead(digits.shape[:-2], batch) if digits.dim() > 2 else None
    if digits.dim() == 2:  # shared by the batch
        buckets = bk.pt_bucket_sum(cs, points, digits, window)  # (..., nw, 2**c - 1, C, L)
    elif c is not None:  # one block a ceremony of the convoy
        blocks = digits.reshape(digits.shape[:c] + digits.shape[-2:])
        buckets = bk.pt_bucket_sum(cs, points, blocks, window)
    else:
        buckets = bk.bucket_accumulate(cs, points, digits, window, nw)[..., 1:, :, :]
    tot = bk.pt_bucket_close(cs, buckets)  # (..., nw, C, L)
    acc = identity(cs, batch, device=points.device)
    for w in reversed(range(nw)):
        acc = window_step(cs, acc, tot[..., w, :, :], window)
    return acc


_bucket_scan = bk.bucket_accumulate_plain  # the JAX package's name for the scatter pass


# ---------------------------------------------------------------------------
# canonical affine form
# ---------------------------------------------------------------------------

MUL_MODES = ("classic", "gemm")


def field_mul(mode: str):
    """The field multiply of a ``mul=`` mode, as ``f(fs, a, b)``:
    ``"classic"`` is ``mod_mul`` (``csrc/field_kernels.cu`` over
    ``field.cuh``'s core), ``"gemm"`` is ``mxu_mod_mul`` (the fused
    multiply-reduce); on CPU tensors their plain versions.  The two stand
    for the JAX package's ``DKG_TPU_MUL=classic|gemm``; both give the
    canonical residue."""
    if mode == "classic":
        return fk.mod_mul
    if mode == "gemm":
        return mk.mxu_mod_mul
    raise ValueError(f"mul must be one of {MUL_MODES}, got {mode!r}")


# The rows of affine_canon's batch inversion under mul="classic": one
# mod_batch_inv launch inverts columns of INV_ROWS lanes, each a chain of
# INV_ROWS - 1 + Fermat + 2 (INV_ROWS - 1) dependent multiplies, so fewer
# rows make more columns and a shorter chain.  Every lane inverted is
# non-zero (zero Z is replaced by one first) and has one inverse, so the
# rows change no limb.  Of 256, 64 and 16, 16 took the least device time
# over each path's calls on the H100 (a ceremony's two, the unchunked
# seal's, and the default-chunk seal's 256 or 16 chunks of 4096 lanes);
# 64 was faster at 1,048,576 lanes and on BLS12-381 at 350,208
# (ops/inv_bench.py; PERF.md).  GEMM_INV_ROWS is the same choice for
# mul="gemm"'s one mxu_batch_inv launch (a warp of 32 columns): of 64, 16,
# 8 and 4 rows, 16 took the least device time summed over the three
# paths' canonical forms (4.51 ms against 5.08 at 64 and 6.28 at 8; 64 was
# 9 % faster on secp256k1 alone, 4 14 % on ristretto255's 22,016 lanes:
# ops/inv_bench.py --gemm).
INV_ROWS = 16
GEMM_INV_ROWS = 16


def affine_canon(cs: CurveSpec, pts: torch.Tensor, *, mul: str = "classic") -> torch.Tensor:
    """Canonical affine limbs of a point batch, where the points live:
    (..., C, L) -> (..., C, L) with X/Z, Y/Z, Z = 1 (Edwards T = XY);
    zero-Z lanes map to the canonical identity.  Any schedule that yields
    the same group elements yields the same limbs, which is why the
    transcript digest hashes this form.

    The lanes (padded with ones to a multiple of the rows) invert in one
    Montgomery-trick batch inversion down the rows: under ``"classic"``
    one ``mod_batch_inv`` launch over INV_ROWS rows, under ``"gemm"`` one
    ``mxu_batch_inv`` launch over GEMM_INV_ROWS rows; then x·zi, y·zi (and
    t = x·y) over all lanes, each one launch of the mode's multiply.  The
    selects and the padding are plain tensor ops, as the JAX package
    leaves them to XLA."""
    f = cs.field
    mulf = field_mul(mul)
    z = pts[..., 2, :]
    z_is_zero = fd.is_zero(z)
    z_safe = fd.select(z_is_zero, fd.ones(f, z.shape[:-1], device=z.device), z)
    flat = z_safe.reshape(-1, f.limbs)
    n_lanes = flat.shape[0]
    k = INV_ROWS if mul == "classic" else GEMM_INV_ROWS
    pad = (-n_lanes) % k
    if pad:
        flat = torch.cat([flat, fd.ones(f, (pad,), device=z.device)])
    flat = flat.reshape(k, -1, f.limbs)
    zi = fk.mod_batch_inv(f, flat) if mul == "classic" else mk.mxu_batch_inv(f, flat)
    zi = zi.reshape(-1, f.limbs)[:n_lanes].reshape(z.shape)
    x_a = mulf(f, pts[..., 0, :], zi)
    y_a = mulf(f, pts[..., 1, :], zi)
    coords = [x_a, y_a, fd.ones(f, x_a.shape[:-1], device=z.device)]
    if cs.kind == "edwards":
        coords.append(mulf(f, x_a, y_a))
    out = torch.stack(coords, dim=-2)
    return torch.where(z_is_zero[..., None, None], identity(cs, device=z.device), out)


def _batch_zinv_host(zs: list[int], p: int) -> list[int]:
    """Montgomery-trick inversion of host ints; zero lanes -> 0."""
    prefix = [1] * len(zs)
    acc = 1
    for i, z in enumerate(zs):
        prefix[i] = acc
        if z:
            acc = acc * z % p
    inv_acc = pow(acc, p - 2, p)
    out = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        z = zs[i]
        if z:
            out[i] = inv_acc * prefix[i] % p
            inv_acc = inv_acc * z % p
    return out


def affine_canon_host(cs: CurveSpec, pts) -> np.ndarray:
    """(..., C, L) limbs -> (..., C, L) uint32 canonical affine limbs:
    X/Z, Y/Z, Z = 1 (Edwards T = XY), zero-Z lanes the canonical
    identity.  The same digits as the JAX package's ``affine_canon_host``
    for the same points."""
    f = cs.field
    arr = np.asarray(pts)
    shape = arr.shape
    nb = 2 * f.limbs
    flat = np.ascontiguousarray(arr.reshape((-1,) + shape[-2:]), dtype="<u2")
    raw = flat.tobytes()
    n_pts, step = flat.shape[0], cs.ncoords * nb
    p = f.modulus

    def coord(c):
        return [
            int.from_bytes(raw[i * step + c * nb : i * step + (c + 1) * nb], "little")
            for i in range(n_pts)
        ]

    xs, ys, zs = coord(0), coord(1), coord(2)
    zinv = _batch_zinv_host(zs, p)
    ident = [int(v) for v in pk.identity_plain(cs, (), "cpu")[:, 0]]
    rows = []
    for x, y, zi in zip(xs, ys, zinv):
        if not zi:
            row = ident
        else:
            xa, ya = x * zi % p, y * zi % p
            row = [xa, ya, 1] + ([xa * ya % p] if cs.kind == "edwards" else [])
        rows.append(b"".join(v.to_bytes(nb, "little") for v in row))
    out = np.frombuffer(b"".join(rows), dtype="<u2").astype(np.uint32)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# fixed-base window tables
# ---------------------------------------------------------------------------


def fixed_table_host(cs: CurveSpec, key: tuple, window: int = FIXED_WINDOW) -> np.ndarray:
    """The host-built window table of the base ``key`` (:func:`base_key`):
    (NW, 2**window, C, L) uint32, T[w][d] = d·(2**window)^w·B, every entry
    affine (Z = 1; Edwards (x, y, 1, x·y)) but the Weierstrass identity,
    which stays (0, 1, 0): the limbs of the JAX package's
    ``_fixed_table_np``.  Uncached: ``groups.precompute.host_table`` keeps
    it, in the process and on disk."""
    group = gh.ALL_GROUPS[cs.name]
    window_base = base_key_to_point(cs, key)
    nw, entries = n_windows(cs, window), 1 << window
    pts = []
    for _ in range(nw):
        acc = group.identity()
        for _ in range(entries):
            pts.append(acc)
            acc = group.add(acc, window_base)
        for _ in range(window):
            window_base = group.add(window_base, window_base)
    proj = fh.encode(cs.field, np.asarray(pts, dtype=object))  # (nw * entries, C, L)
    return affine_canon_host(cs, proj).reshape(nw, entries, cs.ncoords, cs.field.limbs)


def fixed_base_table_dev(cs: CurveSpec, base, window: int = 16, *, device) -> torch.Tensor:
    """The window table of a fixed host point ``base`` built where it will
    be read: (NW, 2**window, C, L) int32 on ``device``, the same canonical
    affine entries as :func:`fixed_table_host`.  Windows of at most 8 bits
    build as one :func:`scalar_mul_small` over (NW, 2**window) lanes
    against the host-made window bases; wider ones compose two entries of
    the half-width table, itself built so, with one add
    (:func:`_compose_table_dev`).  Both end in one :func:`affine_canon`.
    Uncached: ``groups.precompute.base_table`` keeps the tables, per
    (curve, base, window, device)."""
    if window > 8:
        return composed_table(cs, lambda half: fixed_base_table_dev(cs, base, half, device=device), window)
    if 16 % window:
        raise ValueError(f"unsupported fixed-base window width {window}")
    group = gh.ALL_GROUPS[cs.name]
    nw, entries = n_windows(cs, window), 1 << window
    bases, pt = [], base
    for _ in range(nw):  # the window bases (2**window)^w·B: public host doublings
        bases.append(pt)
        for _ in range(window):
            pt = group.add(pt, pt)
    bases_dev = from_host(cs, bases, device=device)  # (nw, C, L)
    digits = torch.arange(entries, dtype=torch.int32, device=device).expand(nw, entries)
    pts = scalar_mul_small(cs, digits, bases_dev[:, None], window)  # (nw, entries, C, L) projective
    return affine_canon(cs, pts)


def composed_table(cs: CurveSpec, half_table, window: int) -> torch.Tensor:
    """A window table wider than 8 bits in canonical affine form, composed
    where ``half_table(window // 2)`` (the half-width table as a tensor)
    lies: :func:`_compose_table_dev`, then one :func:`affine_canon`.  The
    window must be even, its half at most 8, and divide 16."""
    half = window // 2
    if window % 2 or half > 8 or 16 % window:
        raise ValueError(f"unsupported fixed-base window width {window}")
    return affine_canon(cs, _compose_table_dev(cs, half_table(half), window))


def _compose_table_dev(cs: CurveSpec, t_half: torch.Tensor, window: int) -> torch.Tensor:
    """Wide-window entries by composition: from the half-width table
    T[v][e] = e·(2**h)^v·B (h = window/2, (2·NW, 2**h, C, L)), entry d = lo +
    2**h·hi of window w is ``T[2w][lo] + T[2w+1][hi]``, one complete add a
    lane: one ``pt_add`` launch over NW·2**window lanes (1,048,576 at
    window 16 on a 16-limb scalar), each half broadcast to the lanes.  The
    sums are projective; identity lanes flow through the complete
    formulas."""
    lo = t_half[0::2][:, None, :, :, :]  # (nw, 1, 2**h, C, L)
    hi = t_half[1::2][:, :, None, :, :]  # (nw, 2**h, 1, C, L)
    pts = add(cs, lo, hi)  # (nw, 2**h, 2**h, C, L); d = hi·2**h + lo
    return pts.reshape(n_windows(cs, window), 1 << window, cs.ncoords, cs.field.limbs)


def encode_batch(cs: CurveSpec, pts) -> np.ndarray:
    """Canonical compressed encodings of a point batch: (..., C, L) ->
    (..., enc_len) uint8, each row bit-identical to ``HostGroup.encode``
    (SEC bytes for Weierstrass, all zero for the identity; ristretto255's
    32 bytes for Edwards).

    Where the work runs follows where the points are, as the JAX
    package's follows its backend: a tensor on the card takes the device
    leg (:func:`encode_batch_device`), a CPU tensor or a numpy array the
    host leg (:func:`affine_canon_host`, one Montgomery-trick inversion
    over big ints, then :func:`encode_affine`).  Both give the same
    bytes."""
    if isinstance(pts, torch.Tensor) and pts.device.type != "cpu":
        return encode_batch_device(cs, pts)
    return encode_affine(cs, affine_canon_host(cs, pts))


def encode_batch_device(cs: CurveSpec, pts: torch.Tensor) -> np.ndarray:
    """:func:`encode_batch`'s device leg, where the points are, then one
    transfer.  Weierstrass: :func:`affine_canon` (one ``mod_batch_inv``
    launch and the affine coordinates' ``mod_mul``), then the bytes on
    the host.  Edwards: the ristretto255 encoding of every lane at once
    (``ristretto_device.ristretto_encode_batch``, 526 ``mod_mul``
    launches for the batch) and its bytes, where the JAX package encodes
    point by point on the host: on the H100 at 65,536 points the batched
    inverse square root takes milliseconds and the host loop seconds
    (``PERF.md``).  On CPU tensors it runs the plain versions."""
    if cs.kind == "edwards":
        return rd.limbs_to_bytes_u8(rd.ristretto_encode_batch(pts)).cpu().numpy()
    return encode_affine(cs, fh.from_tensor(affine_canon(cs, pts)))


def encode_affine(cs: CurveSpec, aff: np.ndarray) -> np.ndarray:
    """The encodings of canonical affine limbs (..., C, L), the identity
    as :func:`affine_canon` gives it (Z = 0 on Weierstrass, (0, 1, 1, 0) on
    Edwards).  Weierstrass: the parity of y and big-endian x, all lanes at
    once.  Edwards: one ristretto255 encoding a point on the host (the
    host leg's; :func:`encode_batch_device` batches it on the card)."""
    batch = aff.shape[:-2]
    flat = aff.reshape((-1,) + aff.shape[-2:])
    if cs.kind != "edwards":
        nb = cs.field.nbytes
        x_le = np.ascontiguousarray(flat[:, 0, :].astype("<u2")).view(np.uint8)
        out = np.empty((flat.shape[0], 1 + nb), dtype=np.uint8)
        out[:, 0] = 2 + (flat[:, 1, 0] & 1).astype(np.uint8)
        out[:, 1:] = x_le[:, nb - 1 :: -1]
        out[(flat[:, 2, :] == 0).all(axis=1)] = 0  # the identity's all-zero SEC encoding
        return out.reshape(batch + (1 + nb,))
    le = np.ascontiguousarray(flat.astype("<u2")).view(np.uint8)
    out = np.empty((flat.shape[0], 32), dtype=np.uint8)
    for i in range(flat.shape[0]):
        pt = tuple(int.from_bytes(le[i, c].tobytes(), "little") for c in range(cs.ncoords))
        out[i] = np.frombuffer(gh.ristretto_encode(pt), dtype=np.uint8)
    return out.reshape(batch + (32,))
