"""The dealing round's share encryption on the CPU: dkg_tpu_torch's
kem_batch, seal_shares_batch, seal_shares, seal_shares_pipeline,
open_share and open_shares_batch against dkg_tpu's hybrid_batch on the
same seeded inputs.

ristretto255 at (2, 3) (dealer, recipient) pairs runs both packages'
KEM (the JAX one compiled once, in a module fixture) and compares limbs;
every seal is compared by wire bytes (the e1 encoding and the
ciphertext), and every open by value.  secp256k1 and BLS12-381 G1 run the
port's KEM against the host oracle and seal against the JAX package's
DEM on the same KEM points.  Pairs sealed by either package open in the
other."""

import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_util import same, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.crypto.elgamal import HybridCiphertext as JaxHybridCiphertext
from dkg_tpu.dkg import ceremony as jce
from dkg_tpu.dkg import hybrid_batch as jhb
from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import device as jgd
from dkg_tpu.groups import host as jgh
from dkg_tpu.groups import precompute as jgp
from dkg_tpu_torch.crypto.elgamal import HybridCiphertext
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.dkg import hybrid_batch as thb
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.groups import precompute as tgp


def _inputs(curve: str, n_d: int, n_r: int, seed: int):
    """Recipient keys, shares, hidings and KEM randomness from one seed, as
    the JAX package's uint32 arrays."""
    g, rng = tgh.ALL_GROUPS[curve], random.Random(seed)
    fs = g.scalar_field
    sks = [g.random_scalar(rng) for _ in range(n_r)]
    pks = [g.scalar_mul(sk, g.generator()) for sk in sks]

    def scalars():
        return jfh.encode(fs, [[fs.rand_int(rng) for _ in range(n_r)] for _ in range(n_d)])

    return types.SimpleNamespace(
        curve=curve, group=g, jgroup=jgh.ALL_GROUPS[curve], sks=sks,
        pks=jfh.encode(g.base_field, np.asarray(pks, dtype=object)),
        shares=scalars(), hidings=scalars(), r=scalars(),
        tcfg=tce.CeremonyConfig(curve, n_r, 1), jcfg=jce.CeremonyConfig(curve, n_r, 1))


def _wire(group, sealed) -> list:
    """A sealed matrix as its wire bytes: (e1 encoding, ciphertext) of both
    halves of every pair."""
    return [tuple(b for ct in pair for b in (group.encode(ct.e1), ct.ciphertext)) for row in sealed for pair in row]


def _dealt(case, d: int, i: int) -> tuple[int, int]:
    fs = case.group.scalar_field
    return jfh.decode_int(fs, case.shares[d, i]), jfh.decode_int(fs, case.hidings[d, i])


@pytest.fixture(scope="module")
def r255():
    """ristretto255, (2, 3) pairs: both packages' KEM over the JAX package's
    generator table, and the port's batch seal of its KEM."""
    case = _inputs("ristretto255", 2, 3, 0x5EA1)
    case.g_table = np.asarray(jgp.generator_table(jgd.RISTRETTO255))
    case.jc1, case.jkem = (np.asarray(x) for x in jhb.kem_batch(
        case.jcfg, jnp.asarray(case.pks), jnp.asarray(case.r), jnp.asarray(case.g_table)))
    case.c1, case.kem = thb.kem_batch(case.tcfg, to_torch(case.pks), to_torch(case.r), to_torch(case.g_table))
    case.sealed = thb.seal_shares_batch(case.group, case.tcfg, case.shares, case.hidings, case.c1, case.kem)
    return case


def test_kem_batch_matches_the_jax_package_limb_for_limb(r255):
    assert r255.c1.shape == r255.kem.shape == (2, 3, 4, 16)
    assert same(r255.c1, r255.jc1) and same(r255.kem, r255.jkem)


def test_kem_points_reach_the_host_oracle(r255):
    """kem[d, i] = r[d, i]·pk_i = sk_i·c1[d, i], c1[d, i] = r[d, i]·g."""
    g, cs = r255.group, tgd.RISTRETTO255
    c1 = tgd.to_host(cs, r255.c1.reshape(6, 4, 16))
    kem = tgd.to_host(cs, r255.kem.reshape(6, 4, 16))
    for d in range(2):
        for i in range(3):
            r = jfh.decode_int(cs.scalar, r255.r[d, i])
            assert g.eq(c1[3 * d + i], g.scalar_mul(r, g.generator()))
            assert g.eq(kem[3 * d + i], g.scalar_mul(r255.sks[i], c1[3 * d + i]))


def test_seal_shares_batch_matches_the_jax_package(r255):
    """The same KEM points into both packages' batch DEM: the same e1
    tuples and ciphertext bytes."""
    want = jhb.seal_shares_batch(r255.jgroup, r255.jcfg, r255.shares, r255.hidings, r255.jc1, r255.jkem)
    assert [(c.e1, c.ciphertext) for row in r255.sealed for p in row for c in p] == \
        [(c.e1, c.ciphertext) for row in want for p in row for c in p]


def test_scalar_leg_equals_batch_leg(r255):
    """seal_shares (per pair, host encodings) and seal_shares_batch
    (encode_batch, kdf_batch, chacha20_xor_batch) give the same pairs,
    from tensors or from numpy arrays."""
    scalar = thb.seal_shares(r255.group, r255.tcfg, to_torch(r255.shares), r255.hidings, r255.c1,
                             r255.kem.numpy())
    assert scalar == r255.sealed
    assert _wire(r255.group, scalar) == _wire(r255.jgroup, jhb.seal_shares(
        r255.jgroup, r255.jcfg, r255.shares, r255.hidings, r255.jc1, r255.jkem))


def test_pipeline_chunked_and_unchunked_equal_one_seal(r255):
    """One dealer a chunk under the scalar DEM, and unchunked under the
    batch DEM (chunk=0, and the default, which covers both dealers here),
    all equal the single kem_batch + seal."""
    args = (r255.group, r255.tcfg, r255.shares, r255.hidings, to_torch(r255.pks), to_torch(r255.r),
            to_torch(r255.g_table))
    assert thb.seal_shares_pipeline(*args, chunk=1, dem="scalar") == r255.sealed
    assert thb.seal_shares_pipeline(*args, chunk=0) == r255.sealed
    with pytest.raises(ValueError, match="dem"):
        thb.seal_shares_pipeline(*args, dem="turbo")
    with pytest.raises(ValueError, match="chunk"):
        thb.seal_shares_pipeline(*args, chunk=-1)


def test_recipients_open_their_shares(r255):
    """open_shares_batch (one scalar_mul for the recipient's column) and
    open_share give back every dealt share and hiding, as the JAX
    package's open_share does on the port's pairs."""
    for i in (0, 2):
        pairs = [r255.sealed[d][i] for d in range(2)]
        want = [_dealt(r255, d, i) for d in range(2)]
        assert thb.open_shares_batch(r255.group, r255.tcfg, r255.sks[i], pairs, device="cpu") == want
        assert [thb.open_share(r255.group, r255.sks[i], p) for p in pairs] == want
        assert [jhb.open_share(r255.jgroup, r255.sks[i], p) for p in pairs] == want
    assert thb.open_shares_batch(r255.group, r255.tcfg, r255.sks[0], [], device="cpu") == []


def test_jax_sealed_pairs_open_in_the_port(r255):
    sealed = jhb.seal_shares_batch(r255.jgroup, r255.jcfg, r255.shares, r255.hidings, r255.jc1, r255.jkem)
    assert all(isinstance(c, JaxHybridCiphertext) for c in sealed[0][0])
    for d in range(2):
        for i in range(3):
            assert thb.open_share(r255.group, r255.sks[i], sealed[d][i]) == _dealt(r255, d, i)


def test_a_tampered_or_misdirected_ciphertext_does_not_open_to_the_share(r255):
    g = r255.group
    share_ct, hiding_ct = r255.sealed[1][2]
    flipped = bytes([share_ct.ciphertext[0] ^ 1]) + share_ct.ciphertext[1:]
    got = thb.open_share(g, r255.sks[2], (HybridCiphertext(share_ct.e1, flipped), hiding_ct))
    want = _dealt(r255, 1, 2)
    assert got[0] != want[0] and got[1] == want[1]
    assert thb.open_share(g, r255.sks[0], r255.sealed[1][2])[0] != want[0]


def test_open_shares_batch_matches_open_share_on_garbage():
    """Wrong lengths and payloads not below the order give None, exactly as
    open_share does in both packages, never an exception."""
    g, jg = tgh.RISTRETTO255, jgh.RISTRETTO255
    rng = random.Random(0x6A4)
    fs = g.scalar_field
    sk = g.random_scalar(rng)
    e1 = g.scalar_mul(fs.rand_int(rng), g.generator())
    pairs = [(HybridCiphertext(e1, b"short"), HybridCiphertext(e1, b"x" * fs.nbytes)),
             (HybridCiphertext(e1, rng.randbytes(fs.nbytes)), HybridCiphertext(e1, rng.randbytes(fs.nbytes + 1)))]
    cfg = tce.CeremonyConfig("ristretto255", 4, 1)
    got = thb.open_shares_batch(g, cfg, sk, pairs, device="cpu")
    assert got == [thb.open_share(g, sk, p) for p in pairs] == [jhb.open_share(jg, sk, p) for p in pairs]
    assert got[0][0] is None and got[1][1] is None
    assert None in (got[0][1], got[1][0])  # a random 32-byte payload is >= l with probability 15/16


@pytest.mark.parametrize("curve", ["secp256k1", "bls12_381_g1"])
def test_weierstrass_seal_and_open(curve):
    """(1, 2) pairs: the port's KEM against the host oracle, its batch seal
    against the JAX package's on the same KEM points, and both packages'
    open_share on it."""
    case = _inputs(curve, 1, 2, 0x5EA2)
    cs, g = tgd.ALL_CURVES[curve], case.group
    table = tgp.generator_table(cs, device="cpu")
    c1, kem = thb.kem_batch(case.tcfg, to_torch(case.pks), to_torch(case.r), table)
    kem_host = tgd.to_host(cs, kem.reshape(2, cs.ncoords, -1))
    for i in range(2):
        r = jfh.decode_int(cs.scalar, case.r[0, i])
        assert g.eq(kem_host[i], g.scalar_mul(r * case.sks[i], g.generator()))
    sealed = thb.seal_shares_batch(g, case.tcfg, case.shares, case.hidings, c1, kem)
    want = jhb.seal_shares_batch(case.jgroup, case.jcfg, case.shares, case.hidings, c1.numpy().astype(np.uint32),
                                 kem.numpy().astype(np.uint32))
    assert _wire(g, sealed) == _wire(case.jgroup, want)
    assert thb.seal_shares(g, case.tcfg, case.shares, case.hidings, c1, kem) == sealed
    for i in range(2):
        assert thb.open_share(g, case.sks[i], sealed[0][i]) == _dealt(case, 0, i)
        assert jhb.open_share(case.jgroup, case.sks[i], sealed[0][i]) == _dealt(case, 0, i)
