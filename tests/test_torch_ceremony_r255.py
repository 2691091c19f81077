"""The whole ristretto255 (n=5, t=2) ceremony: dkg_tpu_torch on the CPU
against dkg_tpu's BatchedCeremony from the same seed.

The shape, seed, shared string and rho width of the JAX package's own
engine test (``tests/test_ceremony.py``).  Every output tensor is compared
limb for limb (bare and randomized commitments, share and hiding
matrices, batch checks, final shares, master key), on the honest path and
through the blame path, under both of the port's point RLC schedules,
Straus and Pippenger.  The JAX side runs Straus (``DKG_TPU_RLC=straus``;
its Edwards window step there is four XLA doublings and an add, the
port's one ``pt_window_step``); no output but the timings depends on the
schedule."""

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

CURVE, N, T, SEED, SHARED, RHO_BITS = "ristretto255", 5, 2, 0xBA7C4, b"engine-test", 64
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


def _assert_same(tout, jout):
    for k in TENSORS:
        got, want = tout[k], np.asarray(jout[k])
        if got.dtype == torch.bool:
            assert got.tolist() == want.tolist(), k
        else:
            assert np.array_equal(to_np(got), want), k


@RLC
def test_honest_ristretto_ceremony_matches_jax(jax_runs, rlc):
    jc, jout = jax_runs[False]
    tc = tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")
    for name in ("coeffs_a", "coeffs_b", "g_table", "h_table"):
        assert np.array_equal(to_np(getattr(tc, name)), np.asarray(getattr(jc, name))), name
    assert tc.ck.h == jc.ck.h
    tout = tc.run(rho_bits=RHO_BITS, rlc=rlc)
    assert bool(tout["ok"].all()) and tout["complaints"] == jout["complaints"] == []
    _assert_same(tout, jout)
    # the master key is g·(Σ_j a_j0) by ristretto equality, on the host
    g = tgh.RISTRETTO255
    secret = sum(int(x) for x in jfh.decode(jc.cfg.cs.scalar, np.asarray(jc.coeffs_a))[:, 0])
    master = tgd.to_host(tgd.RISTRETTO255, tout["master"][None])[0]
    assert g.eq(master, g.scalar_mul(secret, g.generator()))
    assert jgh.RISTRETTO255.eq(master, jgh.RISTRETTO255._scalar_mul_ladder(secret, g.generator()))


@RLC
def test_tampered_ristretto_share_is_blamed_like_jax(jax_runs, rlc):
    _, jout = jax_runs[True]
    tc = tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")
    tout = tc.run(rho_bits=RHO_BITS, tamper=_torch_tamper, rlc=rlc)
    assert tout["ok"].tolist() == [True, True, False, True, True]
    assert tout["complaints"] == jout["complaints"] == [(3, 2)]
    assert tout["qualified"].tolist() == [True, False, True, True, True]
    _assert_same(tout, jout)
    assert "blame" in tout["phase_seconds"]


@pytest.mark.parametrize("digest,mul", [("device", "classic"), ("host", "classic"), ("device", "gemm")])
def test_ristretto_digest_legs_match_jax(jax_runs, digest, mul):
    """rho and every output under each leg of the transcript digest and
    each multiply of its canonical affine form (Edwards: t = x·y too)
    equal the JAX run's, rho its derive_rho of the same transcript."""
    jc, jout = jax_runs[False]
    tc = tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")
    tout = tc.run(rho_bits=RHO_BITS, digest=digest, mul=mul)
    _assert_same(tout, jout)
    rho = jce.derive_rho(jc.cfg, *(jout[k] for k in ("bare", "randomized", "shares", "hidings")), RHO_BITS)
    assert np.array_equal(to_np(tout["rho"]), np.asarray(rho))


def test_ristretto_audit_digest_matches_jax(jax_runs):
    jc, jout = jax_runs[True]
    arrays = [np.asarray(jout[k]) for k in ("bare", "randomized", "shares", "hidings")]
    cfg = tce.CeremonyConfig(CURVE, N, T)
    tensors = [torch.from_numpy(x.astype(np.int32)) for x in arrays]
    assert tce.transcript_digest(cfg, *tensors, mul="gemm") == jce.transcript_digest(jc.cfg, *arrays)
