"""Threshold signing in dkg_tpu_torch against dkg_tpu on the CPU: secp256k1.

The JAX package's own test shape (``tests/test_sign.py``): 2 messages x
3 signers on a seeded (n = 5, t = 2) sharing, the same messages.  The JAX
package's device legs (``partial_sign``, ``verify_partials``,
``aggregate``, ``rlc_verify(dispatch="device")``) run once, in a module
fixture, on secp256k1 only, as its default tier does; the port runs its
plain versions on CPU tensors.  Every comparison is exact: H(m) limbs,
the partial grid, public keys, proofs and announcements under one seeded
``random.Random``, λ_i(0), aggregates and folded signatures, the
``RlcReport``s and ``ConvoyReport``s, and grids carried from one package
to the other.  ristretto255 and BLS12-381 G1 are in
``tests/test_torch_sign_curves.py``, against the JAX package's host
oracles.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch
from torch_port_util import MESSAGES, QUORUM, QUORUM2, one_thread, same, sharing, to_jax, to_port, z_tampered  # noqa: F401

from dkg_tpu import sign as js
from dkg_tpu.groups import host as jgh
from dkg_tpu.sign import cache as jsc
from dkg_tpu.sign import partial as jsp
from dkg_tpu_torch import sign as ts
from dkg_tpu_torch.fields import host as tfh
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.poly import device as tpd
from dkg_tpu_torch.poly.host import DuplicateEvaluationPoints
from dkg_tpu_torch.sign import cache as tsc
from dkg_tpu_torch.sign import verify as tsv

CURVE = "secp256k1"


@pytest.fixture(scope="module")
def ctx():
    secret, shares = sharing(CURVE)
    group = jgh.ALL_GROUPS[CURVE]
    signers = [shares[i - 1] for i in QUORUM]
    jpts, jh = js.hash_to_curve_batch(CURVE, MESSAGES)
    tpts, th = ts.hash_to_curve_batch(CURVE, MESSAGES, device="cpu")
    jps = js.partial_sign(CURVE, signers, QUORUM, jpts, rng=random.Random(7), prove=True)
    tps = ts.partial_sign(CURVE, signers, QUORUM, tpts, rng=random.Random(7), prove=True, device="cpu")
    return {
        "secret": secret, "shares": shares, "group": group, "signers": signers,
        "jpts": jpts, "jh": np.asarray(jh), "tpts": tpts, "th": th, "jps": jps, "tps": tps,
        "expected": [group.encode(group.scalar_mul_vartime(secret, h)) for h in jpts],
    }


def test_hash_to_curve_matches(ctx):
    """H(m): the same host points as both packages' oracles, the same
    canonical limbs as the JAX package's batch leg."""
    group = ctx["group"]
    assert ctx["tpts"] == ctx["jpts"]
    assert same(ctx["th"], ctx["jh"])
    assert [ts.hash_to_curve_host(group, m) for m in MESSAGES] == [js.hash_to_curve_host(group, m) for m in MESSAGES]
    a, b = (ts.hash_to_curve_host(group, b"msg", d) for d in (b"domain-a", b"domain-b"))
    assert group.encode(a) != group.encode(b)


def test_partial_grid_proofs_and_announcements_match(ctx):
    """The (2, 3) grid, the public keys, and the proofs and announcements
    drawn from the same random.Random(7): the JAX package's, exactly."""
    tps, jps = ctx["tps"], ctx["jps"]
    assert tps.sigs.shape == (2, 3, 3, 16)
    assert same(tps.sigs, jps.sigs)
    assert tps.pks == jps.pks and tps.indices == jps.indices and tps.h_points == jps.h_points
    assert [(p.challenge, p.response) for p in tps.proofs] == [(p.challenge, p.response) for p in jps.proofs]
    assert tps.announcements == jps.announcements
    canon, host = ts.public_keys(CURVE, ctx["signers"], device="cpu")
    assert host == jps.pks
    assert tgd.to_host(tgd.SECP256K1, canon) == jps.pks


def test_partial_sign_host_leg_and_chunks(ctx):
    """dispatch="host" and a one-message chunk give the device leg's limbs."""
    tps = ctx["tps"]
    host = ts.partial_sign(CURVE, ctx["signers"], QUORUM, ctx["tpts"], dispatch="host", pks=(None, tps.pks),
                           device="cpu")
    assert torch.equal(host.sigs, tps.sigs) and host.proofs is None
    chunked = ts.partial_sign(CURVE, ctx["signers"], QUORUM, ctx["tpts"], chunk=1, pks=(None, tps.pks), device="cpu")
    assert torch.equal(chunked.sigs, tps.sigs)
    oracle = [ts.partial_sign_host(ctx["group"], ctx["signers"], h) for h in ctx["tpts"]]
    assert oracle == [jsp.partial_sign_host(ctx["group"], ctx["signers"], h) for h in ctx["jpts"]]


def test_verify_partials_both_ways(ctx):
    """Each package verifies the other's honest grid (the two are equal,
    ``test_partial_grid_proofs_and_announcements_match``); a swapped-in
    partial fails at its cell and nowhere else in both."""
    tps, jps = ctx["tps"], ctx["jps"]
    assert ts.verify_partials(to_port(jps)).tolist() == [[True] * 3] * 2
    assert js.verify_partials(to_jax(tps)).all()
    forged = dataclasses.replace(tps, sigs=tps.sigs.clone())
    forged.sigs[1, 1] = tps.sigs[1, 0]
    want = np.ones((2, 3), dtype=bool)
    want[1, 1] = False
    assert np.array_equal(ts.verify_partials(forged), want)
    assert np.array_equal(js.verify_partials(to_jax(forged)), want)


def test_lagrange_aggregate_and_folded_match(ctx):
    """λ_i(0) on the device against SignCache's host limbs (both
    packages), the aggregate against the JAX package's device aggregate
    and secret·H(m), sign_folded with the cached sigma the same limbs."""
    tps, jps = ctx["tps"], ctx["jps"]
    cs = tgd.SECP256K1
    lam = tpd.lagrange_at_zero_coeffs(cs.scalar, tfh.to_tensor(tfh.encode(cs.scalar, QUORUM), "cpu"))
    jcache, tcache = js.SignCache(), ts.SignCache()
    assert same(lam, jcache.lagrange_at_zero(CURVE, tuple(QUORUM))[1])
    lams, limbs = tcache.lagrange_at_zero(CURVE, tuple(QUORUM))
    jlams, jlimbs = jcache.lagrange_at_zero(CURVE, tuple(QUORUM))
    assert lams == jlams and np.array_equal(limbs, jlimbs)
    assert tcache.lagrange_at_zero(CURVE, tuple(QUORUM))[1] is limbs and tcache.hits == 1
    agg = ts.aggregate(tps)
    assert same(agg, js.aggregate(jps))
    assert ts.signature_encode(CURVE, agg) == ctx["expected"] == js.signature_encode(CURVE, js.aggregate(jps))
    mat = tcache.ceremony("cid", 0, CURVE, tfh.encode(cs.scalar, ctx["shares"]))
    jmat = jcache.ceremony("cid", 0, CURVE, tfh.encode(cs.scalar, ctx["shares"]))
    assert mat.shares == jmat.shares
    sigma = tcache.fold_limbs(mat, QUORUM)
    assert np.array_equal(sigma, jcache.fold_limbs(jmat, QUORUM))
    assert tsc.sigma_limb_count(CURVE) == jsc.sigma_limb_count(CURVE) == 16
    folded = ts.folded_collect(CURVE, [ts.sign_folded(CURVE, sigma, ctx["th"])])
    assert torch.equal(folded, agg)
    rows = tps.sigs_host()
    assert ([ctx["group"].encode(p) for p in ts.aggregate_host(ctx["group"], QUORUM, rows)]
            == [ctx["group"].encode(p) for p in js.aggregate_host(ctx["group"], QUORUM, rows)] == ctx["expected"])


def test_rlc_honest_grid_one_pass_both_legs(ctx):
    """An honest grid is accepted in one pass: the port's device leg, its
    host leg and the JAX package's device leg give one report, on their
    own grids and on each other's."""
    want = js.rlc_verify(ctx["jps"], rng=random.Random(41), dispatch="device")
    assert want == js.RlcReport(ok=True, bad_cells=(), passes=1, grid=6)
    got = ts.rlc_verify(ctx["tps"], rng=random.Random(41))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert dataclasses.astuple(ts.rlc_verify(to_port(ctx["jps"]), rng=random.Random(41), dispatch="host")) \
        == dataclasses.astuple(want)
    assert js.rlc_verify(to_jax(ctx["tps"]), rng=random.Random(41)) == want


@pytest.mark.parametrize("cells", [[(1, 2)], [(0, 0), (1, 1)]], ids=["one", "two"])
def test_rlc_blames_forged_responses(ctx, cells):
    """One and two forged responses: the same blamed cells and passes as
    the JAX package's (host legs, the same weights), within pass_bound."""
    tps, jps = ctx["tps"], ctx["jps"]
    for bi, si in cells:
        tps, jps = z_tampered(tps, bi, si), z_tampered(jps, bi, si)
    got = ts.rlc_verify(tps, rng=random.Random(42), dispatch="host")
    want = js.rlc_verify(jps, rng=random.Random(42))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.bad_cells == tuple(cells) and not got.ok and got.passes <= got.pass_bound()
    if len(cells) == 1:
        assert got.passes == 5  # a failing accept-all, 3 search passes, a clean accept-all


def test_rlc_hash_screen_blames_a_forged_sig_for_free(ctx):
    tps = ctx["tps"]
    forged = dataclasses.replace(tps, sigs=tps.sigs.clone())
    forged.sigs[1, 1] = tps.sigs[1, 0]
    got = ts.rlc_verify(forged, rng=random.Random(44), dispatch="host")
    assert got == ts.RlcReport(ok=False, bad_cells=((1, 1),), passes=1, grid=6)
    assert dataclasses.astuple(got) == dataclasses.astuple(js.rlc_verify(to_jax(forged), rng=random.Random(44)))


def test_rlc_convoy_matches(ctx):
    """Two honest grids (the second over quorum [2, 3, 4]) in one pass on
    the port's device leg; a screened-out grid, and a forged response that
    implicates every survivor; each report the JAX package's."""
    tps, jps = ctx["tps"], ctx["jps"]
    signers2 = [ctx["shares"][i - 1] for i in QUORUM2]
    tps2 = ts.partial_sign(CURVE, signers2, QUORUM2, ctx["tpts"], rng=random.Random(11), prove=True, device="cpu")
    jps2 = js.partial_sign(CURVE, signers2, QUORUM2, ctx["jpts"], rng=random.Random(11), prove=True)
    assert same(tps2.sigs, jps2.sigs)
    got = ts.rlc_verify_convoy([tps, tps2], rng=random.Random(51))
    assert got == ts.ConvoyReport(ok=True, grid_ok=(True, True), passes=1, cells=12)
    assert dataclasses.astuple(got) == dataclasses.astuple(
        js.rlc_verify_convoy([jps, jps2], rng=random.Random(51), dispatch="host"))
    forged = dataclasses.replace(tps, sigs=tps.sigs.clone())
    forged.sigs[0, 1] = tps.sigs[0, 0]
    z_bad = z_tampered(tps, 0, 1)
    for batch, seed, want in (([tps2, forged], 52, (True, False)), ([z_bad, tps2], 53, (False, False))):
        got = ts.rlc_verify_convoy(batch, rng=random.Random(seed), dispatch="host")
        assert got.grid_ok == want and got.passes == 1
        assert dataclasses.astuple(got) == dataclasses.astuple(
            js.rlc_verify_convoy([to_jax(p) for p in batch], rng=random.Random(seed), dispatch="host"))
    assert ts.rlc_verify(z_bad, rng=random.Random(54), dispatch="host").bad_cells == ((0, 1),)


def test_input_checks(ctx):
    """The JAX package's ValueErrors, and duplicate Lagrange nodes."""
    tps, shares, pts = ctx["tps"], ctx["shares"], ctx["tpts"]
    with pytest.raises(ValueError, match="pair up"):
        ts.partial_sign(CURVE, shares[:2], [1], pts, device="cpu")
    with pytest.raises(ValueError, match="requires rng"):
        ts.partial_sign(CURVE, shares[:1], [1], pts, prove=True, device="cpu")
    with pytest.raises(ValueError, match="device\\|host"):
        ts.partial_sign(CURVE, shares[:1], [1], pts, dispatch="tpu", device="cpu")
    with pytest.raises(ValueError, match="positive"):
        ts.partial_sign(CURVE, shares[:1], [1], pts, chunk=0, device="cpu")
    with pytest.raises(ValueError, match="no proofs"):
        ts.verify_partials(dataclasses.replace(tps, proofs=None))
    for stripped in (dataclasses.replace(tps, proofs=None), dataclasses.replace(tps, announcements=None)):
        with pytest.raises(ValueError, match="announcements"):
            ts.rlc_verify(stripped)
        with pytest.raises(ValueError, match="announcements"):
            ts.rlc_verify_convoy([stripped])
    with pytest.raises(ValueError, match="host\\|device"):
        ts.rlc_verify(tps, dispatch="tpu")
    with pytest.raises(ValueError, match="curves"):
        ts.rlc_verify_convoy([tps, dataclasses.replace(tps, curve="ristretto255")])
    assert ts.rlc_verify_convoy([]) == ts.ConvoyReport(ok=True, grid_ok=(), passes=0, cells=0)
    assert tsv._rlc_dispatch("host") == "host"
    with pytest.raises(DuplicateEvaluationPoints):
        ts.aggregate(dataclasses.replace(tps, indices=(1, 2, 1)))
    with pytest.raises(DuplicateEvaluationPoints):
        ts.aggregate_host(ctx["group"], [1, 2, 1], tps.sigs_host())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.public_keys(CURVE, shares[:1])  # the entry points run on the card unless asked


def test_sign_cache_entries(ctx):
    """SignCache: the decoded shares of a (ceremony, epoch), a new epoch
    dropping the ceremony's old one, the LRU bound, and a quorum's public
    keys built once (``public_keys``'), as the JAX package's cache keeps them."""
    cs, tps = tgd.SECP256K1, ctx["tps"]
    limbs = tfh.encode(cs.scalar, ctx["shares"])
    tcache, jcache = ts.SignCache(capacity=2), js.SignCache(capacity=2)
    for cache in (tcache, jcache):
        first = cache.ceremony("a", 0, CURVE, limbs)
        assert cache.ceremony("a", 0, CURVE, limbs) is first and cache.hits == 1 and cache.misses == 1
        assert first.shares == tuple(ctx["shares"])
        cache.ceremony("a", 1, CURVE, limbs)  # a refresh: epoch 0 goes
        cache.ceremony("b", 0, CURVE, limbs)
        cache.ceremony("c", 0, CURVE, limbs)  # capacity 2: ("a", 1) goes
        assert list(cache._ceremonies) == [("b", 0), ("c", 0)]
    mat = tcache.ceremony("c", 0, CURVE, tfh.to_tensor(limbs, "cpu"))
    pks = tcache.quorum_pks(mat, QUORUM, device="cpu")
    assert pks[1] == tps.pks and torch.equal(pks[0], ts.public_keys(CURVE, ctx["signers"], device="cpu")[0])
    assert tcache.quorum_pks(mat, QUORUM, device="cpu") is pks
