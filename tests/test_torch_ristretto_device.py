"""ristretto255's batched encode and decode (groups/ristretto_device.py)
of dkg_tpu_torch against dkg_tpu's, limb for limb, on the points and
candidates of tests/test_ristretto_device.py (the same jitted shapes: 6
random points and the identity; 5 encodings; 5 candidates), and
encode_batch's two legs against each other and the host encoding.

On the CPU every mod_mul runs its plain version; the encode is 526 and
the decode 523 mod_mul calls (chip_smoke.py counts the same launches on
the card).  Exact equality throughout.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import device as jgd
from dkg_tpu.groups import host as jgh
from dkg_tpu.groups import ristretto_device as jrd
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.groups import ristretto_device as trd
from dkg_tpu_torch.ops import field_kernels as fk
from torch_port_util import one_thread, point_limbs, point_tuples, same, to_np, to_torch  # noqa: F401

G = jgh.RISTRETTO255
TG = tgh.RISTRETTO255
CS = tgd.RISTRETTO255


def _points() -> list:
    """tests/test_ristretto_device.py's encode inputs: 6 random multiples
    of g and the identity."""
    rng = random.Random(0x215)
    pts = [G.scalar_mul(G.random_scalar(rng), G.generator()) for _ in range(6)]
    return pts + [G.identity()]


def _scaled(pts: list, seed: int) -> list:
    """The same elements in projective coordinates scaled by random λ."""
    rng, p = random.Random(seed), jgh.P
    out = []
    for pt in pts:
        lam = rng.randrange(1, p)
        out.append(tuple(c * lam % p for c in pt))
    return out


@pytest.mark.parametrize("scale", [False, True], ids=["as_dealt", "rescaled"])
def test_encode_batch_equals_the_jax_package(scale):
    pts = _points()
    if scale:
        pts = _scaled(pts, 7)
    limbs = jfh.encode(CS.field, np.asarray(pts, dtype=object))  # (7, 4, 16)
    want = np.asarray(jrd.ristretto_encode_batch(jnp.asarray(limbs)))
    got = trd.ristretto_encode_batch(to_torch(limbs))
    assert same(got, want)
    by = trd.limbs_to_bytes_u8(got)
    assert by.dtype == torch.uint8
    assert [bytes(row.tolist()) for row in by] == [G.encode(p) for p in pts]
    assert not by[-1].any()  # the identity, whichever representative


def test_decode_batch_equals_the_jax_package():
    rng = random.Random(0x216)
    pts = [G.scalar_mul(G.random_scalar(rng), G.generator()) for _ in range(5)]
    s = jfh.encode(CS.field, [int.from_bytes(G.encode(p), "little") for p in pts])
    j_pts, j_valid = jrd.ristretto_decode_batch(jnp.asarray(s))
    t_pts, t_valid = trd.ristretto_decode_batch(to_torch(s))
    assert t_valid.tolist() == np.asarray(j_valid).tolist() == [True] * 5
    assert same(t_pts, np.asarray(j_pts))
    for a, b in zip(tgd.to_host(CS, t_pts), pts):
        assert G.eq(a, b)


def test_decode_batch_rejects_what_the_jax_package_rejects():
    """Non-canonical s = p and s >= 2**255, odd s, and small even values
    some of which are not squares: the same validity as the JAX package's
    (on its candidates) and the host decoder's; the valid lanes decode to
    the JAX package's limbs."""
    bad = [jgh.P, 1, 4, 2, 6]  # tests/test_ristretto_device.py's candidates, unreduced
    s = np.stack([jfh.int_to_limbs(v % (1 << 255), CS.field.limbs) for v in bad])
    j_pts, j_valid = jrd.ristretto_decode_batch(jnp.asarray(s))
    t_pts, t_valid = trd.ristretto_decode_batch(to_torch(s))
    want = [G.decode(int(v % (1 << 255)).to_bytes(32, "little")) is not None for v in bad]
    assert t_valid.tolist() == np.asarray(j_valid).tolist() == want
    ok = np.asarray(want)
    assert np.array_equal(to_np(t_pts)[ok], np.asarray(j_pts)[ok])
    top = np.full((2, CS.field.limbs), 0xFFFF, dtype=np.uint32)  # 2**256 - 1 and 2**256 - 2, both above p
    top[1, 0] = 0xFFFE
    assert trd.ristretto_decode_batch(to_torch(top))[1].tolist() == [False, False]


def test_mod_mul_counts(monkeypatch):
    """One encode is 526 mod_mul calls and one decode 523: the power
    (p - 5)/8's 251 squarings and 250 multiplies, then 25 and 22 other
    products, whatever the batch (chip_smoke.py's launch counts)."""
    calls = []
    mul = fk.mod_mul
    monkeypatch.setattr(fk, "mod_mul", lambda fs, a, b: calls.append(fs) or mul(fs, a, b))
    pts = to_torch(point_limbs("ristretto255", 3, 4))
    trd.ristretto_encode_batch(pts)
    assert len(calls) == 526 and set(calls) == {CS.field}
    calls.clear()
    trd.ristretto_decode_batch(to_torch(jfh.encode(CS.field, [0, 2, 4])))
    assert len(calls) == 523


def test_encode_batch_legs_agree():
    """encode_batch's card leg (encode_batch_device: the batched ristretto255
    encoding, here on a CPU tensor through the plain multiply) and its host
    leg (encode_batch on a CPU tensor or a numpy array) give the same bytes
    as HostGroup.encode and the JAX package's encode_batch, edge
    projective scalings and the identity (scaled) included, in the batch's
    shape."""
    pts = point_limbs("ristretto255", 30, 10, projective=True, edge_lambdas=True).reshape(2, 5, 4, -1)
    hosts = [TG.encode(p) for p in point_tuples("ristretto255", 30, 10, projective=True, edge_lambdas=True)]
    want = np.asarray(jgd.encode_batch(jgd.RISTRETTO255, pts))
    assert [want[i // 5, i % 5].tobytes() for i in range(10)] == hosts
    assert not want[0, 2].any() and not want[1, 2].any()  # points 2 and 7 are the identity
    card = tgd.encode_batch_device(CS, to_torch(pts))
    for leg in (card, tgd.encode_batch(CS, to_torch(pts)), tgd.encode_batch(CS, pts)):
        assert leg.dtype == np.uint8 and leg.shape == (2, 5, 32) and np.array_equal(leg, want)
