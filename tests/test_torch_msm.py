"""Pippenger's MSM in dkg_tpu_torch against dkg_tpu on the CPU.

``bucket_accumulate_plain`` (what the CUDA ``bucket_accumulate`` kernels
are held against on the card) against the JAX package's ``_bucket_scan``,
``msm_pippenger`` against its JAX twin at both bucket widths,
``pippenger_window``, ``msm_straus`` and the ``msm`` dispatcher.  Every
comparison is of projective limbs, by exact equality.  The ceremony's
point RLC schedules are in ``tests/test_torch_rlc.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import field_limbs, point_limbs, same, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.groups import device as jgd
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.ops import bucket_kernels as bk

CURVES = ["secp256k1", "ristretto255", "bls12_381_g1"]


def _cs(curve):
    return tgd.ALL_CURVES[curve], jgd.ALL_CURVES[curve]


def _digits(seed, shape, entries):
    """Window digits with zeros in the first lanes and then random."""
    d = np.random.default_rng(seed).integers(0, entries, size=shape).astype(np.int32)
    d[..., 0, :] = 0  # the first point lands in bucket 0 of every window
    d[..., 1, ::2] = 0
    return d


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("window", [4, 8])
def test_bucket_accumulate_plain_matches_bucket_scan(curve, window):
    """The scatter pass, identity points mid-stream (every 5th) and
    digit-0 lanes, one batch axis."""
    tcs, jcs = _cs(curve)
    entries, m, nw = 1 << window, 7, 3
    pts = point_limbs(curve, 101 + window, m)
    digs = _digits(window, (m, nw), entries)
    got = bk.bucket_accumulate_plain(tcs, to_torch(pts), torch.from_numpy(digs), entries)
    want = jgd._bucket_scan(jcs, jnp.asarray(pts), jnp.asarray(digs), entries)
    assert got.shape == (nw, entries, tcs.ncoords, tcs.field.limbs)
    assert same(got, want)
    assert torch.equal(got, tgd._bucket_scan(tcs, to_torch(pts), torch.from_numpy(digs), entries))


@pytest.mark.parametrize("curve", CURVES)
def test_bucket_accumulate_plain_two_axis_batch(curve):
    """A (2, 3) batch with its own digits per row, and the same batch
    under one shared (m, nw) digit block, which broadcasts."""
    tcs, jcs = _cs(curve)
    entries, m, nw = 16, 5, 2
    pts = point_limbs(curve, 111, 2 * 3 * m).reshape(2, 3, m, tcs.ncoords, tcs.field.limbs)
    digs = _digits(3, (2, 3, m, nw), entries)
    got = bk.bucket_accumulate_plain(tcs, to_torch(pts), torch.from_numpy(digs), entries)
    assert same(got, jgd._bucket_scan(jcs, jnp.asarray(pts), jnp.asarray(digs), entries))
    shared = digs[0, 0]
    got = bk.bucket_accumulate_plain(tcs, to_torch(pts), torch.from_numpy(shared), entries)
    want = jgd._bucket_scan(jcs, jnp.asarray(pts), jnp.broadcast_to(jnp.asarray(shared), digs.shape), entries)
    assert same(got, want)


@pytest.mark.parametrize("m", [447, 448, 512])
def test_pippenger_window_matches(m):
    for curve in ("secp256k1", "ristretto255", "bls12_381_g1"):
        assert tgd.pippenger_window(m, curve) == jgd.pippenger_window(m, curve)
    assert tgd._PIPPENGER_CROSSOVER == jgd._PIPPENGER_CROSSOVER


@pytest.mark.parametrize("curve", CURVES)
def test_msm_pippenger_matches(curve):
    """m = 6 (window 4), full-width scalars (the edge values 0, 1, 2,
    q - 1, ... first), all 64 windows."""
    tcs, jcs = _cs(curve)
    pts = point_limbs(curve, 121, 6)
    ks = field_limbs(jcs.scalar, 122, 6)
    got = tgd.msm_pippenger(tcs, to_torch(ks), to_torch(pts))
    assert same(got, jgd.msm_pippenger(jcs, jnp.asarray(ks), jnp.asarray(pts)))


def test_msm_pippenger_window_8_matches():
    """m = 448 points take the 8-bit window: secp256k1, batch 1,
    128-bit scalars with nbits = 128, as the RLC runs it."""
    tcs, jcs = _cs("secp256k1")
    m = 448
    assert tgd.pippenger_window(m, "secp256k1") == 8
    pts = point_limbs("secp256k1", 131, m)[None]
    ks = field_limbs(jcs.scalar, 132, m, nbits=128)[None]
    got = tgd.msm_pippenger(tcs, to_torch(ks), to_torch(pts), nbits=128)
    assert got.shape == (1, 3, 16)
    assert same(got, jgd.msm_pippenger(jcs, jnp.asarray(ks), jnp.asarray(pts), 128))


@pytest.mark.parametrize("curve", CURVES)
def test_msm_straus_and_msm_match(curve, monkeypatch):
    """Full-width scalars: msm_straus, and msm's straus mode against the
    JAX package's msm under DKG_TPU_MSM=straus; msm's default mode is the
    JAX package's on an accelerator (Pippenger on Edwards only)."""
    tcs, jcs = _cs(curve)
    pts = point_limbs(curve, 141, 6)
    ks = field_limbs(jcs.scalar, 142, 6)
    tp, tk, jp, jk = to_torch(pts), to_torch(ks), jnp.asarray(pts), jnp.asarray(ks)
    assert same(tgd.msm_straus(tcs, tk, tp), jgd.msm_straus(jcs, jk, jp))
    monkeypatch.setenv("DKG_TPU_MSM", "straus")
    assert same(tgd.msm(tcs, tk, tp, "straus"), jgd.msm(jcs, jk, jp))
    with pytest.raises(ValueError, match="mode"):
        tgd.msm(tcs, tk, tp, "bits")
    monkeypatch.setattr(tgd, "msm_straus", lambda *a: "straus")
    monkeypatch.setattr(tgd, "msm_pippenger", lambda *a: "pippenger")
    assert tgd.msm(tcs, tk, tp) == ("pippenger" if curve == "ristretto255" else "straus")
    assert tgd.msm(tcs, tk, tp, "pippenger") == "pippenger"
