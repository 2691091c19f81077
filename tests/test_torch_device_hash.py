"""The port's device leg of the transcript digest against dkg_tpu's.

dkg_tpu_torch.crypto.device_hash (the BLAKE2s Merkle tree as tensor ops)
against dkg_tpu.crypto.device_hash under both of its legs (the jitted
device tree and the numpy host batch) and the port's own host leg, bit
for bit: word counts 0, 1, 16, 17, powers of two and not, several rows
and domains, words past 2**31 given as int32.  Then the whole transcript
digest and rho of the JAX package's pinned golden ceremonies under each
of the port's digest legs."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_digest_dispatch import GOLDEN_DIGEST, GOLDEN_RHO

from dkg_tpu.crypto import device_hash as jdh
from dkg_tpu_torch.crypto import blake2s as tb2s
from dkg_tpu_torch.crypto import device_hash as tdh
from dkg_tpu_torch.dkg import ceremony as tce
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)


def _words(rows, width, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=(rows, width), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("rows,width,domain", [(1, 0, 0), (2, 1, 1), (3, 16, 2), (2, 17, 3), (4, 32, 1),
                                               (3, 100, 0xFFFFFFFF), (2, 513, 7), (5, 1000, 2)])
def test_row_digests_match_both_jax_legs(rows, width, domain):
    words = _words(rows, width, rows * 1000 + width)
    got = tdh.row_digests(torch.from_numpy(words.view(np.int32)), domain)  # int32 storage, words >= 2**31
    assert got.dtype == torch.int64 and tuple(got.shape) == (rows, 8)
    got = tdh.to_numpy(got)
    for leg in ("device", "host"):
        assert np.array_equal(got, np.asarray(jdh.row_digests(words, domain, dispatch=leg))), leg
    assert np.array_equal(got, tb2s.row_digests_np(words, domain))
    # a row of a (R, ...) tensor is flattened, as the JAX package's is
    got3 = tdh.row_digests(torch.from_numpy(words.astype(np.int64)).reshape(rows, 1, width), domain)
    assert np.array_equal(tdh.to_numpy(got3), got)


@pytest.mark.parametrize("shape", [(0,), (1,), (16,), (2, 17), (5, 13, 3)])
def test_tree_digest_matches_both_jax_legs(shape):
    words = _words(1, int(np.prod(shape)), 7).reshape(shape)
    got = tdh.to_numpy(tdh.tree_digest(torch.from_numpy(words.astype(np.int64)), 9))
    assert got.shape == (8,)
    for leg in ("device", "host"):
        assert np.array_equal(got, np.asarray(jdh.tree_digest(jnp.asarray(words), 9, dispatch=leg))), leg
    assert list(got) == jdh.tree_digest_host(list(words.reshape(-1)), 9)


@pytest.mark.parametrize("curve,digest,mul", [("secp256k1", "device", "classic"), ("secp256k1", "host", "classic"),
                                              ("ristretto255", "device", "gemm"),
                                              ("ristretto255", "host", "classic")])
def test_ceremony_digest_and_rho_match_pinned_goldens(curve, digest, mul):
    """The JAX package's pinned goldens (tests/test_digest_dispatch.py)
    from the port's own deal on the CPU, under each digest leg."""
    c = tce.BatchedCeremony(curve, 4, 1, b"golden", random.Random(0xD16), device="cpu")
    a, e, s, r = tce.deal(c.cfg, c.coeffs_a, c.coeffs_b, c.g_table, c.h_table)
    digest_bytes = tce.transcript_digest_device(c.cfg, a, e, s, r, digest=digest, mul=mul)
    assert digest_bytes.hex() == GOLDEN_DIGEST[curve]
    rho = tce.fiat_shamir_rho(c.cfg, digest_bytes, 128)
    assert rho.astype("<u4").tobytes().hex() == GOLDEN_RHO[curve]
