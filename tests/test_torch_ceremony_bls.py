"""The whole BLS12-381 G1 (n=3, t=1) ceremony: dkg_tpu_torch on the CPU
against dkg_tpu's BatchedCeremony from the same seed.

The shape, shared string and rho width of the JAX package's own
BLS12-381 engine test (``tests/test_ceremony.py``
``test_engine_other_curves_smoke``): 24-limb base field, 16-limb scalar
field r, the commitment key's h cleared of the cofactor.  Every output
tensor is compared limb for limb (bare and randomized commitments, share
and hiding matrices, batch checks, final shares, master key, and rho
against the JAX package's derive_rho of the same transcript), on the
honest path and through the blame path, under both of the port's point
RLC schedules, Straus and Pippenger.  The JAX side runs Straus
(``DKG_TPU_RLC=straus``), once per tamper plan for the whole file; no
output but the timings depends on the schedule."""

import os
import random

import numpy as np
import pytest
import torch
from torch_port_util import to_np
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.dkg import ceremony as jce
from dkg_tpu.fields import device as jfd
from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import host as jgh
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.fields import device as tfd
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh

CURVE, N, T, SEED, SHARED, RHO_BITS = "bls12_381_g1", 3, 1, 0xB15, b"engine-curve", 64
TENSORS = ("bare", "randomized", "shares", "hidings", "ok", "qualified", "final_shares", "master")
BAD = ((1, 2),)  # (dealer, recipient) of the corrupted share
RLC = pytest.mark.parametrize("rlc", ["straus", "pippenger"])


def _jax_tamper(a, e, s, r):
    fs = jce.CeremonyConfig(CURVE, N, T).cs.scalar
    for dealer, recipient in BAD:
        s = s.at[dealer, recipient].set(jfd.add(fs, s[dealer, recipient], jfd.ones(fs)))
    return a, e, s, r


def _torch_tamper(a, e, s, r):
    fs = tce.CeremonyConfig(CURVE, N, T).cs.scalar
    s = s.clone()
    for dealer, recipient in BAD:
        s[dealer, recipient] = tfd.add(fs, s[dealer, recipient], tfd.ones(fs, device=s.device))
    return a, e, s, r


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's ceremony, honest and tampered, run once for the file."""
    old = os.environ.get("DKG_TPU_RLC")
    os.environ["DKG_TPU_RLC"] = "straus"
    try:
        runs = {}
        for tamper in (None, _jax_tamper):
            c = jce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED))
            runs[tamper is not None] = (c, c.run(rho_bits=RHO_BITS, tamper=tamper))
        return runs
    finally:
        if old is None:
            os.environ.pop("DKG_TPU_RLC", None)
        else:
            os.environ["DKG_TPU_RLC"] = old


@pytest.fixture(scope="module")
def port():
    """The port's ceremony object on the CPU (tables built once)."""
    return tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")


def _assert_same(tout, jout, jcfg):
    for k in TENSORS:
        got, want = tout[k], np.asarray(jout[k])
        if got.dtype == torch.bool:
            assert got.tolist() == want.tolist(), k
        else:
            assert np.array_equal(to_np(got), want), k
    # the Fiat-Shamir randomizers of the same round-1 transcript
    rho = jce.derive_rho(jcfg, *(jout[k] for k in ("bare", "randomized", "shares", "hidings")), RHO_BITS)
    assert np.array_equal(to_np(tout["rho"]), np.asarray(rho))


def test_bls_setup_matches_jax(jax_runs, port):
    """Coefficients, the 24-limb g/h tables (32 windows of 256 entries) and
    the cofactor-cleared h."""
    jc, _ = jax_runs[False]
    for name in ("coeffs_a", "coeffs_b", "g_table", "h_table"):
        assert np.array_equal(to_np(getattr(port, name)), np.asarray(getattr(jc, name))), name
    assert tuple(port.g_table.shape) == (32, 256, 3, 24) and tuple(port.coeffs_a.shape) == (N, T + 1, 16)
    assert port.ck.h == jc.ck.h and tgh.BLS12_381_G1.in_subgroup(port.ck.h)


@RLC
def test_honest_bls_ceremony_matches_jax(jax_runs, port, rlc):
    jc, jout = jax_runs[False]
    tout = port.run(rho_bits=RHO_BITS, rlc=rlc)
    assert bool(tout["ok"].all()) and tout["complaints"] == jout["complaints"] == []
    _assert_same(tout, jout, jc.cfg)
    # the master key is g·(Σ_j a_j0), on the host
    g = tgh.BLS12_381_G1
    secret = sum(int(x) for x in jfh.decode(jc.cfg.cs.scalar, np.asarray(jc.coeffs_a))[:, 0])
    master = tgd.to_host(tgd.BLS12_381_G1, tout["master"][None])[0]
    assert g.eq(master, g.scalar_mul(secret, g.generator()))
    assert jgh.BLS12_381_G1.eq(master, jgh.BLS12_381_G1.scalar_mul(secret, g.generator()))


@RLC
def test_tampered_bls_share_is_blamed_like_jax(jax_runs, port, rlc):
    jc, jout = jax_runs[True]
    tout = port.run(rho_bits=RHO_BITS, tamper=_torch_tamper, rlc=rlc)
    assert tout["ok"].tolist() == [True, True, False]
    assert tout["complaints"] == jout["complaints"] == [(3, 2)]
    assert tout["qualified"].tolist() == [True, False, True]
    _assert_same(tout, jout, jc.cfg)
    assert "blame" in tout["phase_seconds"]


@pytest.mark.parametrize("digest,mul", [("host", "classic"), ("device", "gemm")])
def test_bls_digest_legs_match_jax(jax_runs, port, digest, mul):
    """The host leg, and the device leg through mxu_mod_mul's 24-limb
    multiply, give the JAX run's outputs and rho (the default device leg
    with mod_mul's is the honest test's)."""
    jc, jout = jax_runs[False]
    tout = port.run(rho_bits=RHO_BITS, digest=digest, mul=mul)
    _assert_same(tout, jout, jc.cfg)


def test_bls_audit_digest_matches_jax(jax_runs):
    jc, jout = jax_runs[True]
    arrays = [np.asarray(jout[k]) for k in ("bare", "randomized", "shares", "hidings")]
    cfg = tce.CeremonyConfig(CURVE, N, T)
    tensors = [torch.from_numpy(x.astype(np.int32)) for x in arrays]
    assert tce.transcript_digest(cfg, *tensors) == jce.transcript_digest(jc.cfg, *arrays)


@pytest.fixture(scope="module")
def mesh_runs(port):
    """run_sharded_ceremony over 3 gloo ranks (one dealer each), honest
    and tampered, in one spawn."""
    from torch_mesh_util import run_plans

    from dkg_tpu_torch.parallel import hostmesh

    plans = ((), BAD)
    ranks = hostmesh.spawn(run_plans, 3, device="cpu", threads=1, args=(CURVE, N, T, port.coeffs_a, port.coeffs_b,
                                                          port.g_table, port.h_table, plans, RHO_BITS))
    return {plan is BAD: [outs[k] for outs in ranks] for k, plan in enumerate(plans)}


@pytest.mark.parametrize("tampered", [False, True])
def test_sharded_bls_ceremony_over_three_ranks_matches_jax(jax_runs, mesh_runs, tampered):
    """rho, ok, the final shares and the qualified mask exactly; the master
    key limb for limb too (each rank's tree of one dealer is its point, so
    the gathered tree of 3 is the JAX package's)."""
    jc, jout = jax_runs[tampered]
    ranks = mesh_runs[tampered]
    rho = np.asarray(jce.derive_rho(jc.cfg, *(jout[k] for k in ("bare", "randomized", "shares", "hidings")),
                                    RHO_BITS))
    for out in ranks:
        assert np.array_equal(to_np(out["rho"]), rho)
        assert out["qualified"].tolist() == np.asarray(jout["qualified"]).tolist()
        assert np.array_equal(to_np(out["master"]), np.asarray(jout["master"]))
        assert ("blame" in out["phases_s"]) == tampered
    assert torch.cat([o["ok"] for o in ranks]).tolist() == np.asarray(jout["ok"]).tolist()
    assert np.array_equal(to_np(torch.cat([o["final_shares"] for o in ranks])), np.asarray(jout["final_shares"]))
