"""The signing path's building blocks in dkg_tpu_torch against dkg_tpu on
the CPU: Lagrange at zero on the device, the host polynomial oracle, the
host group's public-scalar API, batched DLEQ proofs, and both schedules
of ``gd.msm`` at the per-row m = 2 scalars ``verify_batch`` gives it.

Every comparison is exact: limbs, big ints, host point tuples, booleans.
"""

import dataclasses
import random

import jax.numpy as jnp
import pytest
import torch
from torch_port_util import one_thread, same, to_torch  # noqa: F401

from dkg_tpu.crypto import dleq as jdleq
from dkg_tpu.crypto import dleq_batch as jdb
from dkg_tpu.fields import host as jfh
from dkg_tpu.fields.spec import BLS12_381_R, L25519, SECP256K1_N
from dkg_tpu.groups import device as jgd
from dkg_tpu.groups import host as jgh
from dkg_tpu.poly import device as jpd
from dkg_tpu.poly import host as jph
from dkg_tpu_torch.crypto import dleq as tdleq
from dkg_tpu_torch.crypto import dleq_batch as tdb
from dkg_tpu_torch.fields import host as tfh
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.poly import device as tpd
from dkg_tpu_torch.poly import host as tph

FIELDS = [SECP256K1_N, L25519, BLS12_381_R]
CURVES = ["secp256k1", "ristretto255", "bls12_381_g1"]


def _nodes(fs) -> list[list[int]]:
    """Two rows of four nodes: the edges 1 and q - 1 beside 2 and 3, and
    four consecutive indices."""
    q = fs.modulus
    return [[1, q - 1, 2, 3], [5, 6, 7, 8]]


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_powers_matches(fs):
    rng = random.Random(0x90)
    xs = jfh.encode(fs, [1, fs.modulus - 1, rng.randrange(fs.modulus)])
    assert same(tpd.powers(fs, to_torch(xs), 6), jpd.powers(fs, jnp.asarray(xs), 6))


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_lagrange_at_zero_matches(fs):
    """λ_i(0) and the interpolation at zero over a (2, 4) batch of nodes:
    the JAX package's limbs and the host oracle's ints."""
    rng = random.Random(0x91)
    nodes = _nodes(fs)
    ys = [[rng.randrange(fs.modulus) for _ in row] for row in nodes]
    xs_l, ys_l = jfh.encode(fs, nodes), jfh.encode(fs, ys)
    lam = tpd.lagrange_at_zero_coeffs(fs, to_torch(xs_l))
    assert same(lam, jpd.lagrange_at_zero_coeffs(fs, jnp.asarray(xs_l)))
    assert [[int(v) for v in row] for row in jfh.decode(fs, lam.numpy())] == [
        [tph.lagrange_coefficient(fs, 0, i, row) for i in range(len(row))] for row in nodes]
    got = tpd.lagrange_at_zero(fs, to_torch(xs_l), to_torch(ys_l))
    assert same(got, jpd.lagrange_at_zero(fs, jnp.asarray(xs_l), jnp.asarray(ys_l)))
    assert [int(v) for v in jfh.decode(fs, got.numpy())] == [
        jph.lagrange_interpolation(fs, 0, y, x) for x, y in zip(nodes, ys)]
    one = tpd.lagrange_at_zero_coeffs(fs, to_torch(jfh.encode(fs, [[7]])))
    assert [int(v) for v in jfh.decode(fs, one.numpy())[0]] == [1]


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_duplicate_nodes_raise(fs):
    dup = to_torch(jfh.encode(fs, [[1, 2, 3], [4, 5, fs.modulus + 4]]))  # row 1 repeats 4 mod q
    ys = torch.zeros_like(dup)
    for call in (lambda: tpd.lagrange_at_zero_coeffs(fs, dup), lambda: tpd.lagrange_at_zero(fs, dup, ys),
                 lambda: tph.lagrange_coefficient(fs, 0, 0, [1, 2, 1]),
                 lambda: tph.interpolate(fs, [3, 3], [1, 2])):
        with pytest.raises(tph.DuplicateEvaluationPoints, match="duplicate"):
            call()
    assert issubclass(tph.DuplicateEvaluationPoints, ValueError)


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_poly_host_matches(fs):
    """Polynomial, interpolation and Lagrange coefficients: the JAX
    package's ints."""
    t_poly = tph.Polynomial.random(fs, 3, random.Random(0x92))
    j_poly = jph.Polynomial.random(fs, 3, random.Random(0x92))
    assert t_poly.coeffs == j_poly.coeffs and t_poly.degree == 3 and t_poly.at_zero() == j_poly.at_zero()
    xs = [1, 2, 3, fs.modulus - 1]
    ys = [t_poly.evaluate(x) for x in xs]
    assert ys == [j_poly.evaluate(x) for x in xs]
    assert tph.interpolate(fs, xs, ys).coeffs == jph.interpolate(fs, xs, ys).coeffs == t_poly.coeffs
    assert tph.lagrange_interpolation(fs, 0, ys, xs) == jph.lagrange_interpolation(fs, 0, ys, xs) == t_poly.at_zero()
    other = tph.Polynomial.from_ints(fs, [5, fs.modulus + 1])
    assert (t_poly + other).coeffs == (j_poly + jph.Polynomial.from_ints(fs, [5, fs.modulus + 1])).coeffs
    assert (t_poly * other).coeffs == (j_poly * jph.Polynomial.from_ints(fs, [5, 1])).coeffs
    with pytest.raises(ValueError, match="equal length"):
        tph.lagrange_interpolation(fs, 0, [1], [1, 2])


@pytest.mark.parametrize("curve", CURVES)
def test_host_group_public_ops_match(curve):
    """neg, sub, scalar_mul_vartime, msm, is_identity: the JAX package's
    host tuples, the identity among the points."""
    tg, jg = tgh.ALL_GROUPS[curve], jgh.ALL_GROUPS[curve]
    rng = random.Random(0x93)
    q = tg.scalar_field.modulus
    pts = [tg.identity()] + [tg.scalar_mul(rng.randrange(1, 1 << 64), tg.generator()) for _ in range(3)]
    ks = [0, 1, q - 1, rng.randrange(q)]
    for p in pts:
        assert tg.neg(p) == jg.neg(p)
        assert tg.is_identity(tg.add(p, tg.neg(p))) and jg.is_identity(jg.add(p, jg.neg(p)))
        for k in ks:
            assert tg.scalar_mul_vartime(k, p) == jg.scalar_mul_vartime(k, p)
    assert tg.sub(pts[1], pts[2]) == jg.sub(pts[1], pts[2])
    assert tg.msm(ks, pts) == jg.msm(ks, pts)
    assert not tg.is_identity(pts[1]) and tg.is_identity(tg.msm([q - 1, 1], [pts[1], pts[1]]))
    assert tgh._person(b"x" * 20) == jgh._person(b"x" * 20)


def _statements(group, k: int, seed: int) -> list[tuple]:
    rng = random.Random(seed)
    out = []
    for _ in range(k):
        x = group.random_scalar(rng)
        b1 = group.scalar_mul(group.random_scalar(rng), group.generator())
        b2 = group.scalar_mul(group.random_scalar(rng), group.generator())
        out.append((b1, b2, group.scalar_mul(x, b1), group.scalar_mul(x, b2), x))
    return out


def test_dleq_batch_matches():
    """secp256k1, k = 3: generate_batch's proofs and announcements from the
    same draws, verify_batch's verdicts with one forged response, and the
    single-proof host prover and verifier: the JAX package's."""
    group, cs, jcs = tgh.SECP256K1, tgd.SECP256K1, jgd.SECP256K1
    stmts = _statements(group, 3, 0xD1E0)
    got = tdb.generate_batch(group, cs, stmts, random.Random(5), return_announcements=True, device="cpu")
    want = jdb.generate_batch(jgh.SECP256K1, jcs, stmts, random.Random(5), return_announcements=True)
    assert [(p.challenge, p.response) for p in got[0]] == [(p.challenge, p.response) for p in want[0]]
    assert got[1] == want[1]
    proofs = list(got[0])
    proofs[1] = tdleq.DleqZkp(proofs[1].challenge, (proofs[1].response + 1) % group.scalar_field.modulus)
    ok = tdb.verify_batch(group, cs, proofs, [s[:4] for s in stmts], device="cpu")
    jproofs = [jdleq.DleqZkp(p.challenge, p.response) for p in proofs]
    assert ok.tolist() == jdb.verify_batch(jgh.SECP256K1, jcs, jproofs, [s[:4] for s in stmts]).tolist() \
        == [True, False, True]
    b1, b2, h1, h2, x = stmts[0]
    p = tdleq.DleqZkp.generate(group, b1, b2, h1, h2, x, random.Random(6))
    assert p == tdleq.DleqZkp(*dataclasses.astuple(jdleq.DleqZkp.generate(jgh.SECP256K1, b1, b2, h1, h2, x,
                                                                          random.Random(6))))
    assert p.verify(group, b1, b2, h1, h2) and not p.verify(group, b1, b2, h2, h1)
    assert tdleq._challenge(group, b1, b2, h1, h2, b1, b2) == jdleq._challenge(jgh.SECP256K1, b1, b2, h1, h2, b1, b2)
    assert tdb.generate_batch(group, cs, [], random.Random(5), device="cpu") == []
    assert tdb.generate_batch(group, cs, [], random.Random(5), return_announcements=True, device="cpu") == ([], [])
    assert tdb.verify_batch(group, cs, [], [], device="cpu").shape == (0,)


@pytest.mark.parametrize("curve", CURVES)
def test_msm_schedules_agree_on_per_row_pairs(curve):
    """verify_batch's MSM shape, (k, 2 legs, m = 2) with scalars a row:
    Straus and Pippenger (bucket_accumulate's per-row digits) give the
    same canonical affine limbs, each row the host MSM."""
    cs, group = tgd.ALL_CURVES[curve], tgh.ALL_GROUPS[curve]
    rng = random.Random(0x94)
    q = cs.scalar.modulus
    pts = [group.identity()] + [group.scalar_mul(rng.randrange(1, 1 << 64), group.generator()) for _ in range(7)]
    ks = [0, 1, q - 1] + [rng.randrange(q) for _ in range(5)]
    sc = tfh.to_tensor(tfh.encode(cs.scalar, ks), "cpu").reshape(2, 2, 2, -1)
    pp = tgd.from_host(cs, pts, device="cpu").reshape(2, 2, 2, cs.ncoords, -1)
    straus = tgd.affine_canon(cs, tgd.msm(cs, sc, pp, "straus"))
    pippenger = tgd.affine_canon(cs, tgd.msm(cs, sc, pp, "pippenger"))
    assert torch.equal(straus, pippenger)
    want = [group.msm(ks[2 * i : 2 * i + 2], pts[2 * i : 2 * i + 2]) for i in range(4)]
    assert [group.encode(p) for p in tgd.to_host(cs, straus.reshape(4, cs.ncoords, -1))] == [
        group.encode(p) for p in want]
