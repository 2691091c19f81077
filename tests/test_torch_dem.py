"""The port's DEM primitives against the RFC vectors, hashlib and the JAX
package: ChaCha20 (crypto/chacha.py), batched BLAKE2b and the KDF
(crypto/blake2.py), the hybrid half of crypto/elgamal.py and the host
groups' random_scalar.  All host numpy and Python ints, compared by exact
equality of bytes."""

import hashlib
import random

import numpy as np
import pytest

from dkg_tpu.crypto import blake2 as jb2
from dkg_tpu.crypto import chacha as jcc
from dkg_tpu.crypto import elgamal as jel
from dkg_tpu.groups import host as jgh
from dkg_tpu_torch.crypto import blake2 as tb2
from dkg_tpu_torch.crypto import chacha as tcc
from dkg_tpu_torch.crypto import elgamal as tel
from dkg_tpu_torch.groups import host as tgh
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

RNG = random.Random(0xD3A)
_RFC_KEY = bytes(range(32))


def _rows(nbytes: int, rows: int) -> np.ndarray:
    return np.frombuffer(RNG.randbytes(nbytes * rows), np.uint8).reshape(rows, nbytes)


def test_chacha20_rfc8439_block_vector():
    """RFC 8439 §2.3.2: the block function at counter 1."""
    nonce = bytes.fromhex("000000090000004a00000000")
    expect = bytes.fromhex(
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
    ks = tcc.chacha20_block_batch(np.frombuffer(_RFC_KEY, "<u4").reshape(1, 8), np.array([1], np.uint32),
                                  np.frombuffer(nonce, "<u4").reshape(1, 3))
    assert ks.shape == (1, 64) and ks[0].tobytes() == expect


def test_chacha20_rfc8439_encryption_vector():
    """RFC 8439 §2.4.2: the sunscreen plaintext at counter 1, both forms."""
    nonce = bytes.fromhex("000000000000004a00000000")
    plaintext = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
                 b"only one tip for the future, sunscreen would be it.")
    expect = bytes.fromhex(
        "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0b"
        "f91b65c5524733ab8f593dabcd62b3571639d624e65152ab8f530c359f0861d8"
        "07ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab7793736"
        "5af90bbf74a35be6b40b8eedf2785e42874d")
    assert tcc.chacha20_xor(_RFC_KEY, nonce, plaintext, counter=1) == expect
    got = tcc.chacha20_xor_batch(np.frombuffer(_RFC_KEY, np.uint8).reshape(1, 32),
                                 np.frombuffer(nonce, np.uint8).reshape(1, 12),
                                 np.frombuffer(plaintext, np.uint8).reshape(1, -1), counter=1)
    assert got[0].tobytes() == expect


@pytest.mark.parametrize("mlen", [0, 1, 31, 32, 48, 63, 64, 65, 130])
def test_chacha20_batch_matches_the_jax_package_and_the_scalar_form(mlen):
    rows = 5
    keys, nonces, data = _rows(32, rows), _rows(12, rows), _rows(mlen, rows)
    got = tcc.chacha20_xor_batch(keys, nonces, data, counter=3)
    assert np.array_equal(got, jcc.chacha20_xor_batch(keys, nonces, data, counter=3))
    for r in range(rows):
        want = jcc.chacha20_xor(keys[r].tobytes(), nonces[r].tobytes(), data[r].tobytes(), counter=3)
        assert got[r].tobytes() == want == tcc.chacha20_xor(keys[r].tobytes(), nonces[r].tobytes(),
                                                            data[r].tobytes(), counter=3)


@pytest.mark.parametrize("block", [1, 2, 3])
def test_batches_in_row_blocks_match_the_jax_package(monkeypatch, block):
    """BLAKE2b and ChaCha20 over 7 rows in blocks of 1, 2 and 3 rows (the
    last block ragged): the same bytes as the JAX package's one pass."""
    monkeypatch.setattr(tb2, "ROW_BLOCK", block)
    monkeypatch.setattr(tcc, "ROW_BLOCK", block)
    msgs, keys, nonces, data = _rows(33, 7), _rows(32, 7), _rows(12, 7), _rows(70, 7)
    assert np.array_equal(tb2.blake2b_batch(msgs, person=b"dkgtpu-kdf"), jb2.blake2b_batch(msgs, person=b"dkgtpu-kdf"))
    assert np.array_equal(tcc.chacha20_xor_batch(keys, nonces, data, counter=2),
                          jcc.chacha20_xor_batch(keys, nonces, data, counter=2))


def test_chacha20_rejects_bad_keys_and_nonces():
    with pytest.raises(ValueError, match="key"):
        tcc.chacha20_xor(b"k" * 31, b"n" * 12, b"x")
    with pytest.raises(ValueError, match="nonce"):
        tcc.chacha20_xor(b"k" * 32, b"n" * 8, b"x")
    with pytest.raises(ValueError, match="nonces"):
        tcc.chacha20_xor_batch(_rows(32, 2), _rows(12, 1), _rows(4, 2))
    with pytest.raises(ValueError, match="rows"):
        tcc.chacha20_xor_batch(_rows(32, 2), _rows(12, 2), _rows(4, 3))


@pytest.mark.parametrize("mlen", [0, 1, 32, 33, 49, 127, 128, 129, 300])
def test_blake2b_batch_matches_hashlib_and_the_jax_package(mlen):
    msgs = _rows(mlen, 3)
    for person in (b"", b"dkgtpu-kdf", b"dkgtpu-kd2", b"p" * 16):
        for digest_size in (1, 32, 64):
            got = tb2.blake2b_batch(msgs, digest_size=digest_size, person=person)
            assert got.shape == (3, digest_size)
            assert np.array_equal(got, jb2.blake2b_batch(msgs, digest_size=digest_size, person=person))
            for r in range(3):
                want = hashlib.blake2b(msgs[r].tobytes(), digest_size=digest_size, person=person).digest()
                assert got[r].tobytes() == want


def test_blake2b_batch_rejects_bad_parameters():
    with pytest.raises(ValueError, match="digest_size"):
        tb2.blake2b_batch(_rows(4, 1), digest_size=65)
    with pytest.raises(ValueError, match="person"):
        tb2.blake2b_batch(_rows(4, 1), person=b"p" * 17)


@pytest.mark.parametrize("enc_len", [32, 33, 49])
def test_kdf_batch_matches_both_packages_keystreams(enc_len):
    kem_enc = _rows(enc_len, 6)
    for person in (tel.PERSON_SHARE, tel.PERSON_RAND):
        keys, nonces = tb2.kdf_batch(kem_enc, person)
        jkeys, jnonces = jb2.kdf_batch(kem_enc, person)
        assert np.array_equal(keys, jkeys) and np.array_equal(nonces, jnonces)
        for r in range(6):
            want = jel.keystream_from_kem_bytes(kem_enc[r].tobytes(), person)
            assert tel.keystream_from_kem_bytes(kem_enc[r].tobytes(), person) == want
            assert (keys[r].tobytes(), nonces[r].tobytes()) == want


def test_the_tags_are_the_jax_packages():
    assert (tel.PERSON_SHARE, tel.PERSON_RAND) == (jel.PERSON_SHARE, jel.PERSON_RAND)


@pytest.mark.parametrize("curve", ["ristretto255", "secp256k1", "bls12_381_g1"])
def test_random_scalar_draws_the_jax_packages_scalars(curve):
    tg, jg = tgh.ALL_GROUPS[curve], jgh.ALL_GROUPS[curve]
    a, b = random.Random(curve), random.Random(curve)
    got = [tg.random_scalar(a) for _ in range(8)]
    assert got == [jg.random_scalar(b) for _ in range(8)]
    assert all(0 <= v < tg.scalar_field.modulus for v in got)


@pytest.mark.parametrize("curve", ["ristretto255", "secp256k1"])
def test_hybrid_encryption_bytes_match_and_round_trip(curve):
    """hybrid_encrypt_with_random gives the JAX package's ciphertext; the
    port decrypts it, with the key and with the recovered KEM point."""
    tg, jg = tgh.ALL_GROUPS[curve], jgh.ALL_GROUPS[curve]
    sk, r = tg.random_scalar(RNG), tg.random_scalar(RNG)
    pk = tg.scalar_mul(sk, tg.generator())
    msg = RNG.randbytes(32)
    ct = tel.hybrid_encrypt_with_random(tg, pk, msg, r, tel.PERSON_RAND)
    want = jel.hybrid_encrypt_with_random(jg, pk, msg, r, jel.PERSON_RAND)
    assert ct.ciphertext == want.ciphertext and tg.eq(ct.e1, want.e1)
    assert tel.hybrid_decrypt(tg, sk, ct, tel.PERSON_RAND) == msg
    symm = tel.recover_symmetric_key(tg, sk, ct)
    assert tel.hybrid_decrypt_with_key(tg, symm, ct, tel.PERSON_RAND) == msg
    assert tel.hybrid_decrypt(tg, sk, ct) != msg  # the other tag's keystream


def test_sealed_pairs_open_in_both_packages():
    """A pair sealed by either package opens in both, in the shared-KEM
    layout; two independently encrypted halves open by the legacy tag."""
    tg, jg = tgh.RISTRETTO255, jgh.RISTRETTO255
    sk = tg.random_scalar(RNG)
    pk = tg.scalar_mul(sk, tg.generator())
    share, rand = RNG.randbytes(32), RNG.randbytes(32)
    seed = RNG.randrange(1 << 30)
    ours = tel.seal_pair(tg, pk, share, rand, random.Random(seed))
    theirs = jel.seal_pair(jg, pk, share, rand, random.Random(seed))
    assert [c.ciphertext for c in ours] == [c.ciphertext for c in theirs]
    assert tel.rand_person(tg, *ours) == tel.PERSON_RAND
    assert tel.open_pair(tg, sk, *ours) == jel.open_pair(jg, sk, *ours) == (share, rand)
    assert tel.open_pair(tg, sk, *theirs) == (share, rand)
    r1, r2 = tg.random_scalar(RNG), tg.random_scalar(RNG)
    legacy = (tel.hybrid_encrypt_with_random(tg, pk, share, r1), tel.hybrid_encrypt_with_random(tg, pk, rand, r2))
    assert tel.rand_person(tg, *legacy) == tel.PERSON_SHARE
    assert tel.open_pair(tg, sk, *legacy) == jel.open_pair(jg, sk, *legacy) == (share, rand)
