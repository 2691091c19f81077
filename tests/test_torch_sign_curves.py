"""Threshold signing in dkg_tpu_torch on ristretto255 and BLS12-381 G1,
against dkg_tpu's host oracles on the CPU.

The shape of ``tests/test_torch_sign.py`` (2 messages x 3 signers on the
seeded (n = 5, t = 2) sharing): the JAX package's device legs run on
secp256k1 there; here its oracles, which compile nothing, hold the port
on the two other curves: ``hash_to_curve_host`` and the batch leg's
limbs, ``partial_sign(dispatch="host")``, ``DleqZkp.generate`` with the
same ``random.Random`` draws and ``DleqZkp.verify``, ``aggregate_host``,
``SignCache`` and ``rlc_verify``'s host leg.  Exact equality throughout.
"""

import dataclasses
import functools
import random

import numpy as np
import pytest
import torch
from torch_port_util import MESSAGES, QUORUM, one_thread, same, sharing, to_jax, z_tampered  # noqa: F401

from dkg_tpu import sign as js
from dkg_tpu.crypto.dleq import DleqZkp
from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import device as jgd
from dkg_tpu.groups import host as jgh
from dkg_tpu_torch import sign as ts
from dkg_tpu_torch.fields import host as tfh
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.poly import device as tpd

CURVES = ["ristretto255", "bls12_381_g1"]


@functools.lru_cache(maxsize=None)
def ctx(curve: str) -> dict:
    secret, shares = sharing(curve)
    group = jgh.ALL_GROUPS[curve]
    signers = [shares[i - 1] for i in QUORUM]
    tpts, th = ts.hash_to_curve_batch(curve, MESSAGES, device="cpu")
    tps = ts.partial_sign(curve, signers, QUORUM, tpts, rng=random.Random(7), prove=True, device="cpu")
    return {"secret": secret, "shares": shares, "group": group, "signers": signers, "tpts": tpts, "th": th,
            "tps": tps, "expected": [group.encode(group.scalar_mul_vartime(secret, h)) for h in tpts]}


def canon(curve: str, pts: list) -> np.ndarray:
    """Canonical affine limbs of host points, by the JAX package."""
    cs = jgd.ALL_CURVES[curve]
    return jgd.affine_canon_host(cs, jfh.encode(cs.field, np.asarray(pts, dtype=object)))


@pytest.mark.parametrize("curve", CURVES)
def test_hash_to_curve_matches_host_oracle(curve):
    c = ctx(curve)
    jpts, jh = js.hash_to_curve_batch(curve, MESSAGES)
    assert c["tpts"] == [js.hash_to_curve_host(c["group"], m) for m in MESSAGES] == jpts
    assert same(c["th"], np.asarray(jh))


@pytest.mark.parametrize("curve", CURVES)
def test_partial_grid_and_proofs_match_host_oracles(curve):
    """The grid is partial_sign(dispatch="host")'s, the proofs
    DleqZkp.generate's under the same draws of random.Random(7), each
    announcement pair z·g − e·pk and z·H − e·sig, and every proof
    verifies on the host."""
    c = ctx(curve)
    group, tps = c["group"], c["tps"]
    g = group.generator()
    host_pks = [group.scalar_mul(s, g) for s in c["signers"]]
    jps = js.partial_sign(curve, c["signers"], QUORUM, c["tpts"], dispatch="host", pks=(None, host_pks))
    assert same(tps.sigs, jps.sigs)
    assert tps.pks == [tuple(int(v) for v in row) for row in jfh.decode(jgd.ALL_CURVES[curve].field,
                                                                        canon(curve, host_pks))]
    rng = random.Random(7)
    sigs_host = tps.sigs_host()
    for bi, h in enumerate(c["tpts"]):
        for si, (pk, s) in enumerate(zip(tps.pks, c["signers"])):
            got, (a1, a2) = tps.proofs[bi * 3 + si], tps.announcements[bi * 3 + si]
            want = DleqZkp.generate(group, g, h, pk, sigs_host[bi][si], s, rng)
            assert (got.challenge, got.response) == (want.challenge, want.response)
            assert want.verify(group, g, h, pk, sigs_host[bi][si])
            e, z = got.challenge, got.response
            assert group.eq(a1, group.sub(group.scalar_mul_vartime(z, g), group.scalar_mul_vartime(e, pk)))
            assert group.eq(a2, group.sub(group.scalar_mul_vartime(z, h), group.scalar_mul_vartime(e, sigs_host[bi][si])))


@pytest.mark.parametrize("curve", CURVES)
def test_verify_partials_flags_the_forged_cell(curve):
    """The port's batched verification: a forged response fails its cell
    and no other; the host verifier agrees cell by cell."""
    c = ctx(curve)
    group, forged = c["group"], z_tampered(c["tps"], 1, 2)
    got = ts.verify_partials(forged)
    g, sigs_host = group.generator(), forged.sigs_host()
    want = [[forged.proofs[bi * 3 + si].verify(group, g, h, forged.pks[si], sigs_host[bi][si])
             for si in range(3)] for bi, h in enumerate(forged.h_points)]
    assert got.tolist() == want == [[True] * 3, [True, True, False]]


@pytest.mark.parametrize("curve", CURVES)
def test_lagrange_aggregate_and_folded_match(curve):
    """λ_i(0) on the device = SignCache's host limbs (both packages); the
    aggregate (λ derived on the device on ristretto255, the cached limbs on
    BLS12-381) = aggregate_host's points and secret·H(m); the folded
    signature the same group element."""
    c = ctx(curve)
    cs = tgd.ALL_CURVES[curve]
    jlams, jlimbs = js.SignCache().lagrange_at_zero(curve, tuple(QUORUM))
    tcache = ts.SignCache()
    lams, limbs = tcache.lagrange_at_zero(curve, tuple(QUORUM))
    assert lams == jlams and np.array_equal(limbs, jlimbs)
    assert same(tpd.lagrange_at_zero_coeffs(cs.scalar, tfh.to_tensor(tfh.encode(cs.scalar, QUORUM), "cpu")), jlimbs)
    agg = ts.aggregate(c["tps"], lam=limbs if curve == "bls12_381_g1" else None)
    want = js.aggregate_host(c["group"], QUORUM, c["tps"].sigs_host())
    assert same(agg, canon(curve, want))
    assert ts.signature_encode(curve, agg) == c["expected"]
    mat = tcache.ceremony("cid", 0, curve, torch.from_numpy(tfh.encode(cs.scalar, c["shares"]).astype(np.int32)))
    sigma = tcache.fold_limbs(mat, QUORUM)
    assert np.array_equal(sigma, js.SignCache().fold_limbs(
        js.SignCache().ceremony("cid", 0, curve, jfh.encode(cs.scalar, c["shares"])), QUORUM))
    folded = ts.folded_collect(curve, [ts.sign_folded(curve, sigma, c["th"])])
    assert ts.signature_encode(curve, folded) == c["expected"]
    if curve == "bls12_381_g1":
        # G1 points are equal limb for limb; a ristretto255 element's Edwards
        # representative carries H(m)'s torsion times the integer scalar,
        # which differs between sigma and the Lagrange sum: equal by encoding
        assert torch.equal(folded, agg)


@pytest.mark.parametrize("curve", CURVES)
def test_rlc_reports_match_host_leg(curve):
    """The honest grid is accepted in one pass, a forged response blamed in
    the same passes: the reports of the JAX package's host leg.  The honest
    check takes the port's device leg on ristretto255 (its Pippenger MSM;
    the Weierstrass curves' Straus leg is held on secp256k1), the rest its
    host leg."""
    tps = ctx(curve)["tps"]
    got = ts.rlc_verify(tps, rng=random.Random(41), dispatch="device" if curve == "ristretto255" else "host")
    assert got == ts.RlcReport(ok=True, bad_cells=(), passes=1, grid=6)
    assert dataclasses.astuple(got) == dataclasses.astuple(js.rlc_verify(to_jax(tps), rng=random.Random(41)))
    forged = z_tampered(tps, 0, 1)
    got = ts.rlc_verify(forged, rng=random.Random(42), dispatch="host")
    assert got.bad_cells == ((0, 1),) and got.passes <= got.pass_bound()
    assert dataclasses.astuple(got) == dataclasses.astuple(js.rlc_verify(to_jax(forged), rng=random.Random(42)))
