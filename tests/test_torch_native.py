"""The port's native host runtime (``dkg_tpu_torch.native``, its own copy
of the C++ source, built with g++ at first use) and the host groups'
secret-scalar path through it.

Field ops against Python ints; the constant-structure ladder
``scalar_mul_ct`` against the JAX package's ``_scalar_mul_ladder`` and
the port's, limb for limb, on all three curves at the edge scalars (0, 1,
n - 1, 2) and seeded ones; ``scalar_mul`` reaching it; the
variable-time ladder and point addition; ChaCha20 against
``crypto/chacha.py`` and RFC 8439 §2.4.2, and the opens through it; a
broken source raising, with no Python fallback."""

import random

import pytest
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.groups import host as jgh
from dkg_tpu_torch import native
from dkg_tpu_torch.crypto import chacha as tcc
from dkg_tpu_torch.crypto import elgamal as tel
from dkg_tpu_torch.dkg import hybrid_batch as hb
from dkg_tpu_torch.groups import host as tgh

CURVES = ["ristretto255", "secp256k1", "bls12_381_g1"]


def _scalars(q: int, seed: int, n: int = 6) -> list:
    rng = random.Random(seed)
    return [0, 1, q - 1, 2] + [rng.randrange(q) for _ in range(n)]


@pytest.mark.parametrize("curve", CURVES)
def test_field_ops_match_python_ints(curve):
    g = tgh.ALL_GROUPS[curve]
    for mod in (g.base_field.modulus, g.scalar_field.modulus):
        f = native.NativeField(mod)
        xs, ys = _scalars(mod, 1), _scalars(mod, 2)[::-1]
        a, b = f.encode(xs), f.encode(ys)
        assert f.decode(f.add(a, b)) == [(x + y) % mod for x, y in zip(xs, ys)]
        assert f.decode(f.sub(a, b)) == [(x - y) % mod for x, y in zip(xs, ys)]
        assert f.decode(f.mul(a, b)) == [x * y % mod for x, y in zip(xs, ys)]
        assert f.decode(f.pow(a[5], 12345))[0] == pow(xs[5], 12345, mod)
        assert f.decode(f.inv(a[5]))[0] * xs[5] % mod == 1


@pytest.mark.parametrize("curve", CURVES)
def test_scalar_mul_ct_matches_both_python_ladders(curve):
    """Limb for limb: the native ladder, the JAX package's and the port's
    Python ladders, from a projective point (Z != 1) and the identity."""
    tg, jg = tgh.ALL_GROUPS[curve], jgh.ALL_GROUPS[curve]
    q = tg.scalar_field.modulus
    base = tg._scalar_mul_ladder(0xC0FFEE, tg.generator())
    nc = tgh._native_curve(tg)
    for k in _scalars(q, 7):
        for p in (base, tg.identity()):
            got = nc.decode_points(nc.scalar_mul_ct([k], nc.encode_points([p]), q))[0]
            assert got == tg._scalar_mul_ladder(k, p) == jg._scalar_mul_ladder(k, p), k
            assert tg.scalar_mul(k, p) == got
    ks = _scalars(q, 8)
    batch = nc.scalar_mul_ct(ks, nc.encode_points([base] * len(ks)), q)
    assert nc.decode_points(batch) == [tg._scalar_mul_ladder(k, base) for k in ks]


@pytest.mark.parametrize("curve", CURVES)
def test_scalar_mul_goes_through_the_native_ladder(curve, monkeypatch):
    g = tgh.ALL_GROUPS[curve]
    calls = []
    real = native.NativeCurve.scalar_mul_ct

    def counted(self, *args):
        calls.append(args[0])
        return real(self, *args)

    monkeypatch.setattr(native.NativeCurve, "scalar_mul_ct", counted)
    monkeypatch.setattr(tgh, "_scalar_mul_ladder", lambda *a: pytest.fail("the Python ladder ran"))
    k = g.scalar_field.modulus + 5  # reduced mod n first
    out = g.scalar_mul(k, g.generator())
    assert calls == [[5]]
    assert g.eq(out, g.scalar_mul_vartime(5, g.generator()))


@pytest.mark.parametrize("curve", CURVES)
def test_vartime_ladder_and_add(curve):
    g = tgh.ALL_GROUPS[curve]
    q = g.scalar_field.modulus
    nc = tgh._native_curve(g)
    p = g.scalar_mul_vartime(99, g.generator())
    for k in _scalars(q, 9, 3):
        got = nc.decode_points(nc.scalar_mul([k], nc.encode_points([p]), q))[0]
        assert g.eq(got, g.scalar_mul_vartime(k, p))
    r = g.scalar_mul_vartime(7, g.generator())
    assert nc.decode_points(nc.add(nc.encode_points([p]), nc.encode_points([r])))[0] == g.add(p, r)


def test_chacha20_matches_rfc8439_and_the_numpy_cipher():
    key = bytes(range(32))
    nonce = bytes.fromhex("000000000000004a00000000")
    plaintext = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
                 b"only one tip for the future, sunscreen would be it.")
    expect = bytes.fromhex(
        "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0b"
        "f91b65c5524733ab8f593dabcd62b3571639d624e65152ab8f530c359f0861d8"
        "07ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab7793736"
        "5af90bbf74a35be6b40b8eedf2785e42874d")
    assert native.chacha20_xor(key, nonce, plaintext, counter=1) == expect
    rng = random.Random(4)
    for n in (0, 1, 63, 64, 65, 200):
        k, iv, data = rng.randbytes(32), rng.randbytes(12), rng.randbytes(n)
        assert native.chacha20_xor(k, iv, data, 3) == tcc.chacha20_xor(k, iv, data, counter=3)
    with pytest.raises(ValueError):
        native.chacha20_xor(key[:31], nonce, b"x")


def test_opens_run_the_native_cipher(monkeypatch):
    """hybrid_decrypt and hybrid_batch.open_share decrypt through
    native.chacha20_xor and recover what was sealed."""
    g = tgh.SECP256K1
    rng = random.Random(5)
    kp = tel.Keypair.generate(g, rng)
    calls = []
    real = native.chacha20_xor
    monkeypatch.setattr(native, "chacha20_xor", lambda *a: calls.append(1) or real(*a))
    ct = tel.hybrid_encrypt(g, kp.pk, b"a secret share", rng)
    assert tel.hybrid_decrypt(g, kp.sk, ct) == b"a secret share"
    share, hiding = 12345, 67890
    pair = tel.seal_pair(g, kp.pk, g.scalar_to_bytes(share), g.scalar_to_bytes(hiding), rng)
    assert hb.open_share(g, kp.sk, pair) == (share, hiding)
    assert len(calls) == 3


def test_a_broken_source_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    bad = tmp_path / "dkg_native.cpp"
    bad.write_text(native.SRC.read_text() + "\nthis is not C++;\n")
    with pytest.raises(native.NativeBuildError, match="error"):
        native.build(bad, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError):
        tgh.SECP256K1.scalar_mul(3, tgh.SECP256K1.generator())
