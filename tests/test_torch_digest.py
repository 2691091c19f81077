"""The port's transcript digest and Fiat-Shamir randomizers against
dkg_tpu: BLAKE2b randomizer rows, BLAKE2s Merkle rows, the canonical transcript
digest and rho, byte for byte (one differing bit would change every
tensor downstream)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
from test_digest_dispatch import GOLDEN_DIGEST, GOLDEN_RHO
from torch_port_util import point_limbs, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.crypto import blake2 as jb2
from dkg_tpu.crypto import blake2s as jb2s
from dkg_tpu.crypto import device_hash as jdh
from dkg_tpu.dkg import ceremony as jce
from dkg_tpu_torch.crypto import blake2s as tb2s
from dkg_tpu_torch.dkg import ceremony as tce


@pytest.mark.parametrize("n,tlen,rho_bits", [(1, 32, 128), (5, 32, 17), (64, 32, 128), (7, 0, 256),
                                              (3, 100, 64)])
def test_rho_digests_match_blake2b_batch(n, tlen, rho_bits):
    """The randomizer rows, hashed per row with hashlib, against the JAX
    package's vectorised BLAKE2b on the same messages; then rho itself."""
    transcript = np.random.default_rng(n * 1000 + tlen).integers(0, 256, size=tlen, dtype=np.uint8).tobytes()
    nbytes = (rho_bits + 7) // 8
    msgs = np.zeros((n, tlen + 4), np.uint8)
    msgs[:, :tlen] = np.frombuffer(transcript, np.uint8)
    msgs[:, tlen:] = np.arange(n, dtype="<u4").reshape(n, 1).view(np.uint8)
    got = tce.rho_digests(transcript, n, nbytes)
    assert got.shape == (n, nbytes)
    assert np.array_equal(got, jb2.blake2b_batch(msgs, digest_size=nbytes, person=b"dkgtpu-rlc"))
    tcfg, jcfg = tce.CeremonyConfig("secp256k1", n, 0), jce.CeremonyConfig("secp256k1", n, 0)
    assert np.array_equal(tce.fiat_shamir_rho(tcfg, transcript, rho_bits),
                          np.asarray(jce.fiat_shamir_rho(jcfg, transcript, rho_bits)))


@pytest.mark.parametrize("rows,width,domain", [(1, 0, 0), (1, 1, 5), (3, 16, 1), (2, 17, 2),
                                               (4, 100, 3), (2, 1000, 0xFFFFFFFF)])
def test_row_digests_match(rows, width, domain):
    words = np.random.default_rng(width).integers(0, 1 << 32, size=(rows, width), dtype=np.uint64)
    words = words.astype(np.uint32)
    got = tb2s.row_digests_np(words, domain)
    assert got.dtype == np.uint32 and got.shape == (rows, 8)
    assert np.array_equal(got, jb2s.row_digests_np(words, domain))
    assert list(tb2s.tree_digest_np(words[0], domain)) == jdh.tree_digest_host(list(words[0]), domain)


def _round1(cfg, seed):
    """Random round-1 tensors of the ceremony's shapes (points need not be
    on the curve for the digest; every Z is invertible or zero)."""
    cs = cfg.cs
    a = point_limbs(cfg.curve, seed, cfg.n * (cfg.t + 1)).reshape(cfg.n, cfg.t + 1, 3, -1)
    e = point_limbs(cfg.curve, seed + 1, cfg.n * (cfg.t + 1)).reshape(cfg.n, cfg.t + 1, 3, -1)
    rng = np.random.default_rng(seed)
    s, r = (rng.integers(0, 1 << 15, size=(cfg.n, cfg.n, cs.scalar.limbs)).astype(np.uint32)
            for _ in range(2))
    return a, e, s, r


@pytest.mark.parametrize("rho_bits", [128, 64, 17, 256])
def test_transcript_digest_and_rho_match(rho_bits):
    tcfg, jcfg = tce.CeremonyConfig("secp256k1", 5, 2), jce.CeremonyConfig("secp256k1", 5, 2)
    arrays = _round1(tcfg, rho_bits)
    got_t = tce.transcript_digest_device(tcfg, *map(to_torch, arrays))
    want_t = jce.transcript_digest_device(jcfg, *(jnp.asarray(x) for x in arrays))
    assert got_t == want_t
    got = tce.derive_rho(tcfg, *map(to_torch, arrays), rho_bits)
    want = jce.derive_rho(jcfg, *(jnp.asarray(x) for x in arrays), rho_bits)
    assert got.dtype == np.uint32 and np.array_equal(got, np.asarray(want))
    assert np.array_equal(tce.fiat_shamir_rho(tcfg, got_t, rho_bits), jce.fiat_shamir_rho(jcfg, got_t, rho_bits))


def test_ceremony_digest_and_rho_match_pinned_goldens():
    """The JAX package's pinned secp256k1 goldens (tests/test_digest_dispatch.py),
    from the port's own deal on the CPU."""
    c = tce.BatchedCeremony("secp256k1", 4, 1, b"golden", random.Random(0xD16), device="cpu")
    a, e, s, r = tce.deal(c.cfg, c.coeffs_a, c.coeffs_b, c.g_table, c.h_table)
    assert tce.transcript_digest_device(c.cfg, a, e, s, r).hex() == GOLDEN_DIGEST["secp256k1"]
    rho = tce.derive_rho(c.cfg, a, e, s, r, 128)
    assert rho.astype("<u4").tobytes().hex() == GOLDEN_RHO["secp256k1"]
