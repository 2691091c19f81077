"""The KEM's group operations on the CPU: groups.device.scalar_mul, the
Edwards window step and encode_batch of dkg_tpu_torch against dkg_tpu's
and the host big-int oracles.

scalar_mul runs 64 window steps a call (all of them one
``pt_scalar_mul`` launch, on the CPU its plain version, the loop of
``pt_window_step_plain``), so each case is one batched call covering its
edge scalars (0, 1, order - 1), the identity and projective points with
Z != 1; a table a lane and the KEM's tables shared by dealers are both
held against the JAX package's limbs.  Everything is compared by exact equality: limbs against the JAX
package, group elements against the host ladder, bytes against
``HostGroup.encode``."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import point_limbs, point_tuples, same, to_np, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import device as jgd
from dkg_tpu.groups import host as jgh
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.ops import point_kernels as pk

CURVES = ["ristretto255", "secp256k1", "bls12_381_g1"]


def _edge_scalars(fs, seed: int, n: int) -> list:
    rng = random.Random(seed)
    return ([0, 1, fs.modulus - 1, 2] + [rng.randrange(fs.modulus) for _ in range(n)])[:n]


@pytest.mark.parametrize("curve", CURVES)
def test_scalar_mul_reaches_the_host_ladder(curve):
    """k (2, 3) against points (3,) broadcast to k's batch: the edge
    scalars, the identity (every 5th point of point_tuples) and Z != 1
    scalings, each lane equal to the host ladder's k·P."""
    tcs, g = tgd.ALL_CURVES[curve], jgh.ALL_GROUPS[curve]
    ks = _edge_scalars(tcs.scalar, 1, 6)
    pts = point_tuples(curve, 2, 3, projective=True, edge_lambdas=True)
    pts[0] = g.identity() if curve == "ristretto255" else (0, 7, 0)  # a scaled Weierstrass identity
    k = to_torch(jfh.encode(tcs.scalar, ks)).reshape(2, 3, -1)
    out = tgd.scalar_mul(tcs, k, tgd.from_host(tcs, pts, device="cpu"))
    assert out.shape == (2, 3, tcs.ncoords, tcs.field.limbs)
    got = tgd.to_host(tcs, out.reshape(6, tcs.ncoords, -1))
    for j, (kk, q) in enumerate(zip(ks, got)):
        assert g.eq(q, g.scalar_mul(kk, pts[j % 3])), j


@pytest.fixture(scope="module")
def r255_lanes():
    """Four ristretto255 lanes, k = 0, 1, l - 1 and a random scalar, one of
    them the identity, through both packages' scalar_mul."""
    jcs, tcs = jgd.RISTRETTO255, tgd.RISTRETTO255
    ks = jfh.encode(jcs.scalar, _edge_scalars(jcs.scalar, 3, 4))
    pts = point_limbs("ristretto255", 4, 4, projective=True, edge_lambdas=True)
    want = np.asarray(jgd.scalar_mul(jcs, jnp.asarray(ks), jnp.asarray(pts)))
    return ks, pts, want, tgd.scalar_mul(tcs, to_torch(ks), to_torch(pts))


def test_scalar_mul_matches_the_jax_package_limb_for_limb(r255_lanes):
    _, _, want, got = r255_lanes
    assert same(got, want)


def test_scalar_mul_shares_one_point_across_scalars(r255_lanes):
    """A single point (C, L) against a batch of scalars takes the shared
    table: the same limbs as that point broadcast lane by lane."""
    ks, pts, _, _ = r255_lanes
    tcs = tgd.RISTRETTO255
    one = to_torch(pts[1])
    got = tgd.scalar_mul(tcs, to_torch(ks[:2]), one)
    lanes = tgd.scalar_mul(tcs, to_torch(ks[:2]), one.expand(2, *one.shape))
    assert torch.equal(got, lanes)


def test_scalar_mul_kem_broadcast_matches_the_jax_package(r255_lanes):
    """The KEM's layout: scalars (2, 4) over 4 recipients' points, each
    point's table read by both dealers' lanes (pt_scalar_mul's table rows,
    never copied to the batch); every dealer's row equals the JAX
    package's scalar_mul of the same (scalar, point) lanes, limb for limb."""
    ks, pts, want, _ = r255_lanes
    tcs = tgd.RISTRETTO255
    k2 = to_torch(np.stack([ks, ks]))
    got = tgd.scalar_mul(tcs, k2, to_torch(pts))
    assert got.shape == (2, 4, tcs.ncoords, tcs.field.limbs)
    assert same(got[0], want) and same(got[1], want)


@pytest.mark.parametrize("k", [0, 1, 4, 8])
def test_edwards_window_step_matches_the_jax_package(k):
    """2^k·acc + entry through the port's window_step (one pt_window_step,
    its plain version here) against the JAX package's unfused step."""
    jcs, tcs = jgd.RISTRETTO255, tgd.RISTRETTO255
    acc = point_limbs("ristretto255", 10 + k, 5, projective=True, edge_lambdas=True)
    entry = point_limbs("ristretto255", 20 + k, 5, projective=True)
    want = np.asarray(jgd.window_step(jcs, jnp.asarray(acc), jnp.asarray(entry), k, False))
    got = tgd.window_step(tcs, to_torch(acc), to_torch(entry), k)
    assert same(got, want)
    assert same(pk.pt_window_step_plain(tcs, to_torch(acc), to_torch(entry), k), want)


@pytest.mark.parametrize("curve", CURVES)
def test_encode_batch_both_legs_match_the_host_encoding(curve):
    """encode_batch's host leg (CPU tensors and numpy arrays) and its
    device leg (affine_canon, run here through the plain multiply) give
    HostGroup.encode's bytes and the JAX package's encode_batch's, the
    identity (Z = 0 on Weierstrass, a scaled (0, 1, 1, 0) on Edwards)
    included, and keep the batch shape."""
    tcs, jcs, g = tgd.ALL_CURVES[curve], jgd.ALL_CURVES[curve], tgh.ALL_GROUPS[curve]
    pts = point_limbs(curve, 30, 6, projective=True, edge_lambdas=True).reshape(2, 3, tcs.ncoords, -1)
    want = np.asarray(jgd.encode_batch(jcs, pts))
    assert want.shape[:2] == (2, 3)
    hosts = [g.encode(p) for p in point_tuples(curve, 30, 6, projective=True, edge_lambdas=True)]
    assert [want[i // 3, i % 3].tobytes() for i in range(6)] == hosts
    if curve != "ristretto255":
        assert not want[0, 2].any()  # point 2 is the identity: the all-zero SEC bytes
    device_leg = tgd.encode_affine(tcs, to_np(tgd.affine_canon(tcs, to_torch(pts))))
    for leg in (tgd.encode_batch(tcs, to_torch(pts)), tgd.encode_batch(tcs, pts), device_leg):
        assert leg.dtype == np.uint8 and np.array_equal(leg, want)


def test_encode_batch_dispatches_by_where_the_points_are(monkeypatch):
    """A CPU tensor or a numpy array takes the host leg; any other device
    the device leg (whose multiplies then launch kernels or raise): on
    Weierstrass affine_canon, on Edwards the batched ristretto255
    encoding."""
    calls = []
    ident = tgd.identity(tgd.RISTRETTO255, (2,), device="cpu")
    monkeypatch.setattr(tgd, "affine_canon_host", lambda cs, p: calls.append("host") or to_np(ident))
    monkeypatch.setattr(tgd.rd, "ristretto_encode_batch", lambda p: calls.append("device") or ident[:, 0])
    pts = torch.zeros((2, 4, 16), dtype=torch.int32)
    for p in (pts, to_np(pts), pts.to("meta")):
        assert tgd.encode_batch(tgd.RISTRETTO255, p).shape == (2, 32)
    assert calls == ["host", "host", "device"]
    secp = tgd.SECP256K1
    ident = tgd.identity(secp, (2,), device="cpu")
    monkeypatch.setattr(tgd, "affine_canon", lambda cs, p: calls.append("canon") or ident)
    assert tgd.encode_batch(secp, torch.zeros((2, 3, 16), dtype=torch.int32).to("meta")).shape == (2, 33)
    assert calls[-1] == "canon"
