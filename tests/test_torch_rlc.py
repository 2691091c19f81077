"""The ceremony's point RLC schedules of dkg_tpu_torch against dkg_tpu
on the CPU.

The three schedules of ``_point_rlc`` (``straus``, ``bits``,
``pippenger``) against the JAX package's, called eagerly under each
``DKG_TPU_RLC``: its jitted ``verify_batch`` reads the variable only when
it traces.  Every comparison is of projective limbs, by exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_util import field_limbs, point_limbs, same, to_np, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.dkg import ceremony as jce
from dkg_tpu.groups import device as jgd
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.groups import device as tgd

CURVES = ["secp256k1", "ristretto255", "bls12_381_g1"]


def _cs(curve):
    return tgd.ALL_CURVES[curve], jgd.ALL_CURVES[curve]


@pytest.mark.parametrize("curve", CURVES)
def test_point_rlc_schedules_match(curve, monkeypatch):
    """_point_rlc on an (n, t+1) = (6, 3) commitment tensor, 128-bit
    weights (the edge values 0, 1, 2 first), each schedule against the
    JAX package's under the same DKG_TPU_RLC; all three agree in
    canonical affine form."""
    tcs, jcs = _cs(curve)
    pts = point_limbs(curve, 151, 18).reshape(6, 3, tcs.ncoords, tcs.field.limbs)
    w = field_limbs(jcs.scalar, 152, 6, nbits=128)
    affine = []
    for mode in tce.RLC_MODES:
        monkeypatch.setenv("DKG_TPU_RLC", mode)
        got = tce._point_rlc(tcs, to_torch(w), to_torch(pts), 128, mode)
        assert same(got, jce._point_rlc(jcs, jnp.asarray(w), jnp.asarray(pts), 128)), mode
        affine.append(tgd.affine_canon_host(tcs, to_np(got)))
    assert all(np.array_equal(a, affine[0]) for a in affine[1:])
    with pytest.raises(ValueError, match="rlc"):
        tce._point_rlc(tcs, to_torch(w), to_torch(pts), 128, "ladder")
