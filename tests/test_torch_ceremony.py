"""The whole secp256k1 (n=4, t=1) ceremony: dkg_tpu_torch on the CPU
against dkg_tpu's BatchedCeremony from the same seed.

Every output tensor is compared limb for limb (bare and randomized
commitments, share and hiding matrices, batch checks, final shares,
master key), on the honest path and through the blame path, under both of
the port's point RLC schedules, Straus and Pippenger.  The JAX side runs
Straus (``DKG_TPU_RLC=straus``); no output but the timings depends on the
schedule."""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import to_np, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.dkg import ceremony as jce
from dkg_tpu.fields import device as jfd
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.dkg.errors import DkgError, DkgErrorKind
from dkg_tpu_torch.fields import device as tfd

CURVE, N, T, SEED, SHARED = "secp256k1", 4, 1, 5, b"torch-parity"
TENSORS = ("bare", "randomized", "shares", "hidings", "ok", "qualified")


def _jax_tamper(bad):
    fs = jce.CeremonyConfig(CURVE, N, T).cs.scalar

    def tamper(a, e, s, r):
        for dealer, recipient in bad:
            s = s.at[dealer, recipient].set(jfd.add(fs, s[dealer, recipient], jfd.ones(fs)))
        return a, e, s, r

    return tamper


def _torch_tamper(bad):
    fs = tce.CeremonyConfig(CURVE, N, T).cs.scalar

    def tamper(a, e, s, r):
        s = s.clone()
        for dealer, recipient in bad:
            s[dealer, recipient] = tfd.add(fs, s[dealer, recipient], tfd.ones(fs, device=s.device))
        return a, e, s, r

    return tamper


HONEST, ONE_BAD, TOO_MANY = (), ((1, 2),), ((1, 2), (3, 0))
RLC = pytest.mark.parametrize("rlc", ["straus", "pippenger"])


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's ceremony, run once per tamper plan for the file."""
    old = os.environ.get("DKG_TPU_RLC")
    os.environ["DKG_TPU_RLC"] = "straus"
    try:
        runs = {}
        for bad in (HONEST, ONE_BAD, TOO_MANY):
            c = jce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED))
            runs[bad] = (c, c.run(tamper=_jax_tamper(bad) if bad else None))
        return runs
    finally:
        if old is None:
            os.environ.pop("DKG_TPU_RLC", None)
        else:
            os.environ["DKG_TPU_RLC"] = old


def _assert_same(tout, jout, keys):
    for k in keys:
        got, want = tout[k], np.asarray(jout[k])
        if got.dtype == torch.bool:
            assert got.tolist() == want.tolist(), k
        else:
            assert np.array_equal(to_np(got), want), k


@RLC
def test_honest_ceremony_matches_jax(jax_runs, rlc):
    jc, jout = jax_runs[HONEST]
    tc = tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")
    assert np.array_equal(to_np(tc.coeffs_a), np.asarray(jc.coeffs_a))
    assert np.array_equal(to_np(tc.coeffs_b), np.asarray(jc.coeffs_b))
    assert np.array_equal(to_np(tc.g_table), np.asarray(jc.g_table))
    assert np.array_equal(to_np(tc.h_table), np.asarray(jc.h_table))
    tout = tc.run(rlc=rlc)
    assert bool(tout["ok"].all()) and tout["complaints"] == jout["complaints"] == []
    _assert_same(tout, jout, TENSORS + ("final_shares", "master"))
    assert set(tout["phase_seconds"]) == {"tables", "deal", "fiat_shamir", "verify", "finalise"}


def test_from_arrays_matches_jax(jax_runs):
    """The JAX package's coefficient arrays and tables carried across."""
    jc, jout = jax_runs[HONEST]
    tc = tce.BatchedCeremony.from_arrays(
        CURVE, N, T, SHARED, np.asarray(jc.coeffs_a), np.asarray(jc.coeffs_b),
        g_table=np.asarray(jc.g_table), h_table=np.asarray(jc.h_table), device="cpu",
    )
    _assert_same(tc.run(), jout, TENSORS + ("final_shares", "master"))
    with pytest.raises(ValueError, match="shape"):
        tce.BatchedCeremony.from_arrays(CURVE, N, T, SHARED, np.asarray(jc.coeffs_a)[:2],
                                        np.asarray(jc.coeffs_b), device="cpu")


@RLC
def test_tampered_share_is_blamed_like_jax(jax_runs, rlc):
    _, jout = jax_runs[ONE_BAD]
    tc = tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")
    tout = tc.run(tamper=_torch_tamper(ONE_BAD), rlc=rlc)
    assert tout["ok"].tolist() == [True, True, False, True]
    assert tout["complaints"] == jout["complaints"] == [(3, 2)]
    assert tout["qualified"].tolist() == [True, False, True, True]
    _assert_same(tout, jout, TENSORS + ("final_shares", "master"))
    assert "blame" in tout["phase_seconds"]


@RLC
def test_more_than_t_guilty_aborts_like_jax(jax_runs, rlc):
    _, jout = jax_runs[TOO_MANY]
    tc = tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")
    tout = tc.run(tamper=_torch_tamper(TOO_MANY), rlc=rlc)
    assert isinstance(tout["error"], DkgError)
    assert tout["error"].kind is DkgErrorKind.MISBEHAVIOUR_HIGHER_THRESHOLD
    assert tout["error"].kind.value == jout["error"].kind.value
    assert tout["complaints"] == jout["complaints"]
    assert "master" not in tout and "master" not in jout
    _assert_same(tout, jout, TENSORS)


@pytest.mark.parametrize("half", ["deal_commitments", "deal_shares"])
def test_deal_halves_match_jax(jax_runs, half):
    """Each half of dealing on the JAX package's coefficients and tables."""
    jc, _ = jax_runs[HONEST]
    cfg = tce.CeremonyConfig(CURVE, N, T)
    args = [np.asarray(jc.coeffs_a), np.asarray(jc.coeffs_b)]
    if half == "deal_commitments":
        args += [np.asarray(jc.g_table), np.asarray(jc.h_table)]
    got = getattr(tce, half)(cfg, *map(to_torch, args))
    want = getattr(jce, half)(jce.CeremonyConfig(CURVE, N, T), *(jnp.asarray(a) for a in args))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.array_equal(to_np(g), np.asarray(w))


def test_field_dot_and_aggregate_match_jax():
    cfg = tce.CeremonyConfig(CURVE, 5, 2)
    fs = cfg.cs.scalar
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << 16, size=(5, 3, fs.limbs)).astype(np.uint32)
    vals[..., -1] &= 0x7FFF  # canonical: below the modulus
    w = np.zeros((5, fs.limbs), np.uint32)
    w[:, :8] = rng.integers(0, 1 << 16, size=(5, 8))
    jcfg = jce.CeremonyConfig(CURVE, 5, 2)
    assert np.array_equal(to_np(tce._field_dot(fs, to_torch(w), to_torch(vals))),
                          np.asarray(jce._field_dot(jcfg.cs.scalar, jnp.asarray(w), jnp.asarray(vals))))
    qual = np.array([True, False, True, True, False])
    got = tce.aggregate_shares(cfg, to_torch(vals), torch.from_numpy(qual))
    want = jce.aggregate_shares(jcfg, jnp.asarray(vals), jnp.asarray(qual))
    assert np.array_equal(to_np(got), np.asarray(want))


def _jax_rho(jcfg, jout, rho_bits=128):
    return np.asarray(jce.derive_rho(jcfg, *(jout[k] for k in ("bare", "randomized", "shares", "hidings")), rho_bits))


@pytest.mark.parametrize("digest,mul", [("host", "classic"), ("device", "gemm")])
def test_digest_legs_and_gemm_match_jax(jax_runs, digest, mul):
    """run(digest=, mul=): the host leg of the transcript digest, and the
    device leg with mxu_mod_mul's multiply, give the JAX run's outputs and
    rho (the default device leg with mod_mul's is the honest test's)."""
    jc, jout = jax_runs[HONEST]
    tc = tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")
    tout = tc.run(digest=digest, mul=mul)
    _assert_same(tout, jout, TENSORS + ("final_shares", "master"))
    assert np.array_equal(to_np(tout["rho"]), _jax_rho(jc.cfg, jout))
    with pytest.raises(ValueError, match="digest"):
        tc.run(digest="gpu")
    with pytest.raises(ValueError, match="mul"):
        tc.run(mul="fast")


def test_audit_transcript_digest_matches_jax(jax_runs):
    """The byte-level audit digest (transcript_digest, derive_rho(device=False))
    of the JAX run's round-1 tensors, canonicalised where they are."""
    jc, jout = jax_runs[ONE_BAD]
    arrays = [np.asarray(jout[k]) for k in ("bare", "randomized", "shares", "hidings")]
    want = jce.transcript_digest(jc.cfg, *(jnp.asarray(x) for x in arrays))
    cfg = tce.CeremonyConfig(CURVE, N, T)
    assert tce.transcript_digest(cfg, *map(to_torch, arrays)) == want
    rho = tce.derive_rho(cfg, *map(to_torch, arrays), 128, device=False, mul="gemm")
    assert np.array_equal(rho, np.asarray(jce.derive_rho(jc.cfg, *(jnp.asarray(x) for x in arrays), 128,
                                                         device=False)))


# ---------------------------------------------------------------------------
# the party-sharded ceremony (parallel.mesh) over gloo ranks
# ---------------------------------------------------------------------------

MESH_PLANS = {2: (HONEST, ONE_BAD, TOO_MANY), 4: (HONEST,)}


@pytest.fixture(scope="module")
def mesh_runs():
    """run_sharded_ceremony on every rank of one spawn a world size, per
    tamper plan, on the coefficients and tables the honest test holds
    equal to the JAX package's."""
    from torch_mesh_util import run_plans

    from dkg_tpu_torch.parallel import hostmesh

    tc = tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")
    return {world: dict(zip(plans, zip(*hostmesh.spawn(
        run_plans, world, device="cpu", threads=1,
        args=(CURVE, N, T, tc.coeffs_a, tc.coeffs_b, tc.g_table, tc.h_table, plans)))))
        for world, plans in MESH_PLANS.items()}


@pytest.mark.parametrize("world,plan", [(2, HONEST), (4, HONEST), (2, ONE_BAD)])
def test_sharded_ceremony_matches_jax(jax_runs, mesh_runs, world, plan):
    """rho, ok, the final shares and the qualified mask exactly, and the
    master key limb for limb (at n = 4 over 2 or 4 ranks the tree pairs the
    points as the JAX package's tree of 4 does)."""
    jc, jout = jax_runs[plan]
    ranks = mesh_runs[world][plan]
    for out in ranks:
        assert np.array_equal(to_np(out["rho"]), _jax_rho(jc.cfg, jout))
        assert out["qualified"].tolist() == np.asarray(jout["qualified"]).tolist()
        assert np.array_equal(to_np(out["master"]), np.asarray(jout["master"]))
    assert torch.cat([o["ok"] for o in ranks]).tolist() == np.asarray(jout["ok"]).tolist()
    assert np.array_equal(to_np(torch.cat([o["final_shares"] for o in ranks])), np.asarray(jout["final_shares"]))


def test_sharded_ceremony_aborts_past_t_like_jax(jax_runs, mesh_runs):
    _, jout = jax_runs[TOO_MANY]
    guilty = sorted({dealer for _, dealer in jout["complaints"]})
    for out in mesh_runs[2][TOO_MANY]:
        assert out["error"] == jout["error"].kind.value == DkgErrorKind.MISBEHAVIOUR_HIGHER_THRESHOLD.value
        assert out["detail"] == "guilty dealers (1-based): " + ", ".join(map(str, guilty))
