"""dkg_tpu_torch.groups and the point kernels' plain versions against
dkg_tpu.groups on the CPU.

The plain ``pt_add``, ``pt_madd``, ``pt_window_step`` and
``pt_ladder_mul_add`` are what the CUDA kernels are held against on the
card; here they are held against the JAX package's XLA formulas
(``_add_xla``, ``_madd_xla``, ``window_step(..., fused=False)``,
``scalar_mul_small`` and ``eval_point_poly``), projective limbs equal, so
the tolerance is zero.  The JAX package's own Pallas point tests skip
Mosaic off-chip; its XLA formulas are the reference here as there."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import field_limbs, point_limbs, point_tuples, to_np, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.crypto.commitment import CommitmentKey as JCommitmentKey
from dkg_tpu.dkg import ceremony as jce
from dkg_tpu.groups import device as jgd
from dkg_tpu.groups import host as jgh
from dkg_tpu_torch.crypto.commitment import CommitmentKey as TCommitmentKey
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.groups import precompute as tgp
from dkg_tpu_torch.ops import point_kernels as pk

CURVES = ["secp256k1", "ristretto255", "bls12_381_g1"]
B = 8


def _cs(curve):
    return tgd.ALL_CURVES[curve], jgd.ALL_CURVES[curve]


def _same(got: torch.Tensor, want) -> bool:
    return got.dtype == torch.int32 and np.array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("curve", CURVES)
def test_add_madd_double_match(curve):
    tcs, jcs = _cs(curve)
    p, q = point_limbs(curve, 11, B), point_limbs(curve, 12, B)
    q[3] = p[3]  # the complete add doubles
    qa = point_limbs(curve, 13, B, projective=False)
    qa = qa[np.asarray(qa)[:, 2, 0] == 1]  # mixed add takes affine, non-identity q
    assert _same(pk.pt_add(tcs, to_torch(p), to_torch(q)), jgd._add_xla(jcs, jnp.asarray(p), jnp.asarray(q)))
    k = len(qa)
    assert _same(pk.pt_madd(tcs, to_torch(p[:k]), to_torch(qa)),
                 jgd._madd_xla(jcs, jnp.asarray(p[:k]), jnp.asarray(qa)))
    assert _same(pk.pt_double_plain(tcs, to_torch(p)), jgd._double_xla(jcs, jnp.asarray(p)))


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("n_doubles", [0, 4])
def test_window_step_matches(curve, n_doubles):
    tcs, jcs = _cs(curve)
    acc, entry = point_limbs(curve, 21, B), point_limbs(curve, 22, B)
    got = tgd.window_step(tcs, to_torch(acc), to_torch(entry), n_doubles)
    want = jgd.window_step(jcs, jnp.asarray(acc), jnp.asarray(entry), n_doubles, False)
    assert _same(got, want)


@pytest.mark.parametrize("curve", CURVES)
def test_ladder_mul_add_matches(curve):
    """x·P + A in one ladder == the JAX package's scalar_mul_small then add."""
    tcs, jcs = _cs(curve)
    nbits = 4
    p, a = point_limbs(curve, 31, B), point_limbs(curve, 32, B)
    x = np.array([0, 1, 2, 5, 15, 9, 8, 3], np.uint32)
    got = pk.pt_ladder_mul_add(tcs, to_torch(p), to_torch(a), torch.from_numpy(x.astype(np.int32)), nbits)
    want = jgd._add_xla(jcs, jgd.scalar_mul_small(jcs, jnp.asarray(x), jnp.asarray(p), nbits), jnp.asarray(a))
    assert _same(got, want)


@pytest.mark.parametrize("curve", CURVES)
def test_eval_point_poly_matches(curve):
    tcs, jcs = _cs(curve)
    coeffs = point_limbs(curve, 41, 3 * 4).reshape(4, 3, -1, tcs.field.limbs)  # (batch, T, C, L)
    x = np.array([1, 2, 3, 4], np.uint32)
    got = tgd.eval_point_poly(tcs, to_torch(coeffs), torch.from_numpy(x.astype(np.int32)), 3)
    want = jgd.eval_point_poly(jcs, jnp.asarray(coeffs), jnp.asarray(x), 3)
    assert _same(got, want)
    # one shared coefficient column broadcast over the evaluation points
    got = tgd.eval_point_poly(tcs, to_torch(coeffs[0]), torch.from_numpy(x.astype(np.int32)), 3)
    want = jgd.eval_point_poly(jcs, jnp.asarray(coeffs[0]), jnp.asarray(x), 3)
    assert _same(got, want)


@pytest.mark.parametrize("curve", CURVES)
def test_eq_select_tree_reduce_match(curve):
    tcs, jcs = _cs(curve)
    p = point_limbs(curve, 51, 5)
    q = point_limbs(curve, 52, 5)
    q[1] = point_limbs(curve, 51, 5)[1]  # same points, same lambda
    tp, tq, jp, jq = to_torch(p), to_torch(q), jnp.asarray(p), jnp.asarray(q)
    assert tgd.eq(tcs, tp, tq).tolist() == np.asarray(jgd.eq(jcs, jp, jq)).tolist()
    assert tgd.eq(tcs, tp, tp).all()
    pred = np.array([True, False, True, False, False])
    assert _same(tgd.select(torch.from_numpy(pred), tp, tq), jgd.select(jnp.asarray(pred), jp, jq))
    assert _same(tgd._tree_reduce(tcs, tp, 5), jgd._tree_reduce(jcs, jp, 5))  # odd: padded


@pytest.mark.parametrize("curve", CURVES)
def test_affine_canon_host_matches(curve):
    tcs, jcs = _cs(curve)
    pts = point_limbs(curve, 61, 10)
    got = tgd.affine_canon_host(tcs, pts)
    assert got.dtype == np.uint32 and np.array_equal(got, jgd.affine_canon_host(jcs, pts))
    batched = pts.reshape(2, 5, *pts.shape[1:])
    assert np.array_equal(tgd.affine_canon_host(tcs, batched), jgd.affine_canon_host(jcs, batched))


def test_host_group_and_commitment_key_match():
    t, j = tgh.SECP256K1, jgh.SECP256K1
    rng = random.Random(71)
    pts = point_tuples("secp256k1", 72, 6)
    for a, b in zip(pts, pts[1:] + pts[:1]):
        assert t.add(a, b) == j.add(a, b) and t.eq(a, b) == j.eq(a, b)
        k = rng.randrange(j.scalar_field.modulus)
        assert t.scalar_mul(k, a) == j._scalar_mul_ladder(k, a)
        assert t.encode(a) == j.encode(a)
    for shared in (b"", b"ceremony", b"chip-smoke"):
        assert TCommitmentKey.generate(t, shared).h == JCommitmentKey.generate(j, shared).h


@pytest.mark.parametrize("curve", ["secp256k1", "bls12_381_g1"])
def test_tables_and_fixed_base_mul_match(curve):
    """The 8-bit host-built g/h tables (32 windows of 256 affine entries
    for both curves' 255/256-bit scalars), and fixed_base_mul over them."""
    tcs, jcs = _cs(curve)
    h = TCommitmentKey.generate(tgh.ALL_GROUPS[curve], b"tables").h
    for base in ((tcs.gen_affine[0], tcs.gen_affine[1], 1), h):
        key = tgp.base_key(tcs, base)
        assert key == jgd.base_key(jcs, base)
        table = tgp.host_table(tcs, key)
        assert table.dtype == np.uint32
        assert np.array_equal(table, jgd._fixed_table_np.__wrapped__(jcs, key, jgd.FIXED_WINDOW))
    g_t = tgp.generator_table(tcs, device="cpu")
    k = field_limbs(jcs.scalar, 81, 6)  # 0, 1, 2, q-1, ... exercise the masked digit-0 windows
    got = tgd.fixed_base_mul(tcs, g_t, to_torch(k))
    want = jgd.fixed_base_mul(jcs, jnp.asarray(to_np(g_t)), jnp.asarray(k))
    assert _same(got, want)


def test_point_rlc_straus_matches(monkeypatch):
    """The ceremony's point RLC, windowed Straus, against the JAX package's
    straus schedule: same tables, gathers, tree sums and window steps."""
    monkeypatch.setenv("DKG_TPU_RLC", "straus")
    tcs, jcs = _cs("secp256k1")
    pts = point_limbs("secp256k1", 91, 5 * 2).reshape(5, 2, 3, tcs.field.limbs)
    w = np.zeros((5, tcs.scalar.limbs), np.uint32)
    w[:, 0] = [0, 1, 255, 17, 128]
    got = tce._point_rlc(tcs, to_torch(w), to_torch(pts), 8)
    want = jce._point_rlc(jcs, jnp.asarray(w), jnp.asarray(pts), 8)
    assert _same(got, want)


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("n_doubles", [1, 4])
def test_double_and_pt_double_match(curve, n_doubles):
    """groups.device.double and the pt_double wrapper (2^k·P in one call)
    against the JAX package's double, repeated."""
    tcs, jcs = _cs(curve)
    p = point_limbs(curve, 25, B, edge_lambdas=True)
    want = jnp.asarray(p)
    for _ in range(n_doubles):
        want = jgd.double(jcs, want)
    assert _same(pk.pt_double(tcs, to_torch(p), n_doubles), want)
    assert _same(tgd.double(tcs, to_torch(p)), jgd.double(jcs, jnp.asarray(p)))


def test_ristretto_host_group_matches():
    t, j = tgh.RISTRETTO255, jgh.RISTRETTO255
    assert (t.base_field.modulus, t.scalar_field.modulus) == (j.base_field.modulus, j.scalar_field.modulus)
    assert t.identity() == j.identity() and t.generator() == j.generator()
    rng = random.Random(73)
    pts = point_tuples("ristretto255", 74, 6)
    for a, b in zip(pts, pts[1:] + pts[:1]):
        assert t.add(a, b) == j.add(a, b) and t.neg(a) == j.neg(a)
        assert t.eq(a, b) == j.eq(a, b) and t.eq(a, a)
        k = rng.randrange(j.scalar_field.modulus)
        assert t.scalar_mul(k, a) == j._scalar_mul_ladder(k, a)
        enc = t.encode(a)
        assert enc == j.encode(a)
        back = t.decode(enc)
        assert back == j.decode(enc) and t.eq(back, a)
    assert t.decode(b"\x01" + bytes(31)) is None and t.decode(bytes(31)) is None
    for shared, domain in ((b"", b""), (b"ceremony", b"dkgtpu-ck"), (b"chip-smoke-r255", b"x" * 20)):
        assert t.hash_to_group(shared, domain) == j.hash_to_group(shared, domain)
    for shared in (b"", b"engine-test", b"chip-smoke-r255"):
        h = TCommitmentKey.generate(t, shared).h
        assert h == JCommitmentKey.generate(j, shared).h  # the same (X, Y, Z, T)
        assert tgp.base_key(tgd.RISTRETTO255, h) == jgd.base_key(jgd.RISTRETTO255, h)


def test_edwards_tables_and_fixed_base_mul_match():
    tcs, jcs = _cs("ristretto255")
    h = TCommitmentKey.generate(tgh.RISTRETTO255, b"tables").h
    for base in (tgh.RISTRETTO255.generator(), h):
        key = tgp.base_key(tcs, base)
        assert key == jgd.base_key(jcs, base)
        table = tgp.host_table(tcs, key)
        assert table.dtype == np.uint32
        assert np.array_equal(table, jgd._fixed_table_np.__wrapped__(jcs, key, jgd.FIXED_WINDOW))
    g_t = tgp.generator_table(tcs, device="cpu")
    assert np.array_equal(to_np(g_t[0, 0]), np.asarray(jgd.identity(jcs)))  # (0, 1, 1, 0)
    assert np.array_equal(to_np(g_t[0, 1]), np.asarray(jgd.from_host(jcs, [tgh.RISTRETTO255.generator()]))[0])
    k = field_limbs(jcs.scalar, 82, 6)  # 0, 1, 2, l-1, ...: the identity entry flows through
    got = tgd.fixed_base_mul(tcs, g_t, to_torch(k))
    want = jgd.fixed_base_mul(jcs, jnp.asarray(to_np(g_t)), jnp.asarray(k))
    assert _same(got, want)


def test_bls_host_group_matches():
    """BLS12-381 G1 on the host: the generator has order r, hash_to_group
    clears the cofactor into the subgroup (the same projective point as the
    JAX package's), encode/decode round trip, and decode refuses a curve
    point outside the subgroup."""
    t, j = tgh.BLS12_381_G1, jgh.BLS12_381_G1
    assert (t.base_field.modulus, t.scalar_field.modulus, t.b, t.cofactor) == (
        j.base_field.modulus, j.scalar_field.modulus, j.b, j.cofactor)
    assert t.generator() == j.generator() and t.identity() == j.identity()
    assert tgh.ALL_GROUPS["bls12_381_g1"] is t
    g = t.generator()
    assert t.in_subgroup(g) and t.eq(t.mul_int(t.scalar_field.modulus, g), t.identity())
    assert not t.eq(t.mul_int(t.scalar_field.modulus - 1, g), t.identity())
    rng = random.Random(75)
    pts = point_tuples("bls12_381_g1", 76, 6)
    for a, b in zip(pts, pts[1:] + pts[:1]):
        assert t.add(a, b) == j.add(a, b) and t.eq(a, b) == j.eq(a, b)
        k = rng.randrange(j.scalar_field.modulus)
        assert t.scalar_mul(k, a) == j._scalar_mul_ladder(k, a)
        enc = t.encode(a)
        assert enc == j.encode(a) and len(enc) == 49
        back = t.decode(enc)
        assert back == j.decode(enc) and t.eq(back, a)
    for shared, domain in ((b"", b""), (b"ceremony", b"dkgtpu-ck"), (b"chip-smoke-bls", b"x" * 20)):
        h = t.hash_to_group(shared, domain)
        assert h == j.hash_to_group(shared, domain) and t.in_subgroup(h)
        assert TCommitmentKey.generate(t, shared).h == JCommitmentKey.generate(j, shared).h
    # a curve point outside the order-r subgroup: on the curve, refused
    x = next(x for x in range(1, 100) if t.lift_x(x, 0) is not None and not t.in_subgroup((x, t.lift_x(x, 0), 1)))
    bad = bytes([2]) + x.to_bytes(48, "big")
    assert t.decode(bad) is None and j.decode(bad) is None
    assert t.decode(bytes(49)) == t.identity() and t.decode(bytes(48)) is None
    assert t.decode(bytes([4]) + bytes(48)) is None


@pytest.mark.parametrize("curve", CURVES)
def test_affine_canon_matches(curve):
    """The device canonical affine form under both multiplies (mod_mul's
    and mxu_mod_mul's plain versions) against the JAX package's
    gd.affine_canon (one shape) and affine_canon_host (more shapes), with
    identity (zero-Z) lanes; past 256 lanes the inversion runs down 256
    rows, as the JAX package's does."""
    tcs, jcs = _cs(curve)
    pts = point_limbs(curve, 62, 10)  # every 5th point the identity
    want = np.asarray(jgd.affine_canon(jcs, jnp.asarray(pts)))
    assert np.array_equal(want, jgd.affine_canon_host(jcs, pts))
    for mul in ("classic", "gemm"):
        got = tgd.affine_canon(tcs, to_torch(pts), mul=mul)
        assert _same(got, want), mul
    wide = point_limbs(curve, 63, 300).reshape(3, 100, *pts.shape[1:])
    got = tgd.affine_canon(tcs, to_torch(wide), mul="gemm")
    assert _same(got, jgd.affine_canon_host(jcs, wide))
    assert np.array_equal(to_np(got[0, 2]), np.asarray(jgd.identity(jcs)))
    with pytest.raises(ValueError, match="mul"):
        tgd.affine_canon(tcs, to_torch(pts), mul="fast")
