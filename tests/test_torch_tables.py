"""The fixed-base table family and its digest-checked disk cache
(``dkg_tpu_torch.groups.device`` / ``groups.precompute``) against the JAX
package's.

``scalar_mul_small`` (one ``pt_ladder_mul_add`` against the identity
addend on the card, its plain ladder here) equals the JAX package's in
canonical affine form; the device-built tables at windows 4 and 8 and the
window-8 table composed from a half-4 one equal ``_fixed_table_np`` limb
for limb; the disk cache rejects truncated, mis-shaped and tampered files
and survives an unwritable directory, counting each case in ``stats()``;
and a table file either package writes loads in the other.  All by exact
equality; the full window-16 build (a million adds) runs on the card only
(``chip_smoke.py``'s tables phase).
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import one_thread, point_limbs, to_np, to_torch  # noqa: F401

from dkg_tpu.groups import device as jgd
from dkg_tpu.groups import precompute as jgp
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.groups import precompute as tgp

CURVES = ["secp256k1", "ristretto255", "bls12_381_g1"]


@pytest.fixture()
def table_cache(tmp_path, monkeypatch):
    """A fresh empty disk cache for both packages, process caches zeroed."""
    monkeypatch.setenv("DKG_TPU_TABLE_CACHE", str(tmp_path))
    tgp.reset()
    jgp.reset()
    yield tmp_path
    tgp.reset()
    jgp.reset()


def _cs(curve):
    return tgd.ALL_CURVES[curve], jgd.ALL_CURVES[curve]


def _h(curve):
    """A base other than g: a seeded multiple of the generator."""
    g = tgh.ALL_GROUPS[curve]
    return g.scalar_mul(random.Random(curve).randrange(2, 1 << 62), g.generator())


@pytest.mark.parametrize("nbits", [4, 8])
@pytest.mark.parametrize("curve", CURVES)
def test_scalar_mul_small_matches_jax(curve, nbits):
    """k·P for public k < 2**nbits (0, 1, the top and seeded values): the
    port's one-launch form (a ladder, then + identity) and the JAX
    package's unfused ladder give the same canonical affine limbs; their
    projective limbs differ on every curve (the last complete add
    rescales)."""
    tcs, jcs = _cs(curve)
    rng = random.Random(nbits)
    ks = np.array([0, 1, (1 << nbits) - 1] + [rng.randrange(1 << nbits) for _ in range(5)], np.uint32)
    pts = point_limbs(curve, 31 + nbits, len(ks))
    got = tgd.scalar_mul_small(tcs, torch.from_numpy(ks.astype(np.int32)), to_torch(pts), nbits)
    want = jgd.scalar_mul_small(jcs, jnp.asarray(ks), jnp.asarray(pts), nbits)
    assert np.array_equal(to_np(tgd.affine_canon(tcs, got)), np.asarray(jgd.affine_canon(jcs, want)))
    assert not np.array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("curve, window", [(c, 4) for c in CURVES] + [("ristretto255", 8)])
def test_fixed_base_table_dev_matches_host_table(curve, window):
    """The device route (host window bases, one scalar_mul_small over (NW,
    2**w) lanes, one affine_canon) equals the JAX package's host-built
    table, for a seeded h at window 4 on every curve and g at window 8 (8192
    plain ladder lanes, ~40 s here: one curve; the card builds all three in
    chip_smoke.py).  Uncached: precompute.base_table keeps the tables
    (test_card_route_builds_persists_and_caches)."""
    tcs, jcs = _cs(curve)
    base = tgd.gen_host(tcs) if window == 8 else _h(curve)
    key = tgd.base_key(tcs, base)
    assert key == jgd.base_key(jcs, base)
    got = tgd.fixed_base_table_dev(tcs, base, window, device="cpu")
    assert got.shape == (tgd.n_windows(tcs, window), 1 << window, tcs.ncoords, tcs.field.limbs)
    assert np.array_equal(to_np(got), jgd._fixed_table_np.__wrapped__(jcs, key, window))


def test_compose_table_dev_matches_host_table():
    """_compose_table_dev from a half-4 host table to window 8 (one add a
    lane, then affine_canon) equals _fixed_table_np(..., 8) on secp256k1,
    whose identity entries (0, 1, 0) go through the complete add: the
    window-16 build's schedule at a size the CPU runs."""
    tcs, jcs = _cs("secp256k1")
    key = tgd.base_key(tcs, _h("secp256k1"))
    half = to_torch(tgd.fixed_table_host(tcs, key, 4))
    got = tgd.affine_canon(tcs, tgd._compose_table_dev(tcs, half, 8))
    assert np.array_equal(to_np(got), jgd._fixed_table_np.__wrapped__(jcs, key, 8))


@pytest.mark.parametrize("curve", CURVES)
def test_generator_neg_and_windows_match(curve):
    tcs, jcs = _cs(curve)
    assert np.array_equal(to_np(tgd.generator(tcs, (2,), device="cpu")), np.asarray(jgd.generator(jcs, (2,))))
    pts = point_limbs(curve, 77, 5)
    assert np.array_equal(to_np(tgd.neg(tcs, to_torch(pts))), np.asarray(jgd.neg(jcs, jnp.asarray(pts))))
    k = point_limbs(curve, 78, 3)[:, 0, : tcs.scalar.limbs]
    for w in (4, 8, 16):
        assert np.array_equal(to_np(tgd.scalar_windows(tcs, to_torch(k), w)),
                              np.asarray(jgd.scalar_windows(jcs, jnp.asarray(k), w)))


def test_disk_round_trip_and_process_cache(table_cache):
    """A first host_table builds and persists one file; after reset it
    loads (bit-equal), then the process cache serves the repeat."""
    cs = tgd.SECP256K1
    key = tgd.base_key(cs, tgd.gen_host(cs))
    fresh = tgp.host_table(cs, key, 4)
    assert tgp.stats()["builds"] == 1 and len(list(table_cache.glob("*.npz"))) == 1
    tgp.reset()
    loaded = tgp.host_table(cs, key, 4)
    st = tgp.stats()
    assert st["disk_loads"] == 1 and st["builds"] == 0 and loaded.dtype == np.uint32
    assert np.array_equal(fresh, loaded)
    assert tgp.host_table(cs, key, 4) is loaded and tgp.stats()["proc_hits"] == 1


def _wrong_shape(path, cs, key):
    """A file whose digest is valid for its own table, of the wrong shape."""
    bad = np.zeros((2, 16, cs.ncoords, cs.field.limbs), np.uint32)
    with open(path, "wb") as f:
        np.savez(f, table=bad, digest=np.frombuffer(tgp._digest(cs, key, 4, bad), np.uint8))


def _tampered_digest(path, cs, key):
    with np.load(path) as z:
        table, digest = z["table"], z["digest"].copy()
    digest[0] ^= 1
    with open(path, "wb") as f:
        np.savez(f, table=table, digest=digest)


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "wrong_shape", "tampered_digest"])
def test_damaged_file_is_rejected_and_rebuilt(table_cache, damage):
    """Every damaged file counts one disk_reject and one build, the rebuilt
    table equals the fresh one, and the rebuild re-persists a good file."""
    cs = tgd.SECP256K1
    key = tgd.base_key(cs, tgd.gen_host(cs))
    fresh = tgp.host_table(cs, key, 4)
    [path] = table_cache.glob("*.npz")
    raw = path.read_bytes()
    if damage == "truncate":
        path.write_bytes(raw[: len(raw) // 2])
    elif damage == "bitflip":
        flipped = bytearray(raw)
        flipped[len(raw) // 2] ^= 0x40
        path.write_bytes(bytes(flipped))
    elif damage == "wrong_shape":
        _wrong_shape(path, cs, key)
    else:
        _tampered_digest(path, cs, key)
    tgp.reset()
    rebuilt = tgp.host_table(cs, key, 4)
    st = tgp.stats()
    assert st["disk_rejects"] == 1 and st["builds"] == 1 and st["disk_loads"] == 0
    assert np.array_equal(fresh, rebuilt)
    tgp.reset()
    assert np.array_equal(tgp.host_table(cs, key, 4), fresh) and tgp.stats()["disk_loads"] == 1


def test_unwritable_directory_degrades_to_builds(tmp_path, monkeypatch):
    """A cache directory that cannot be made (a file stands in its place):
    every process builds, no error, no file, no reject."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_bytes(b"x")
    monkeypatch.setenv("DKG_TPU_TABLE_CACHE", str(blocker / "tables"))
    tgp.reset()
    cs = tgd.SECP256K1
    key = tgd.base_key(cs, tgd.gen_host(cs))
    try:
        first = tgp.host_table(cs, key, 4)
        tgp.reset()
        second = tgp.host_table(cs, key, 4)
        st = tgp.stats()
        assert st["builds"] == 1 and st["disk_loads"] == 0 and st["disk_rejects"] == 0
        assert np.array_equal(first, second) and blocker.read_bytes() == b"x"
    finally:
        tgp.reset()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_table_files_load_across_packages(table_cache, writer):
    """A file either package writes loads in the other, bit for bit: the
    same name, format and digest."""
    tcs, jcs = _cs("ristretto255")
    key = tgd.base_key(tcs, _h("ristretto255"))
    if writer == "jax":
        made = np.asarray(jgp.host_table(jcs, key, 4))
        got = tgp.host_table(tcs, key, 4)
        st = tgp.stats()
    else:
        made = tgp.host_table(tcs, key, 4)
        got = np.asarray(jgp.host_table(jcs, key, 4))
        st = jgp.stats()
    assert [p.name for p in table_cache.glob("*.npz")] == [tgp._table_path(tcs, key, 4).name]
    assert st["disk_loads"] == 1 and st["builds"] == 0
    assert np.array_equal(made, got)


def test_base_table_windows_and_default(table_cache, monkeypatch):
    """base_table at the default (8 on the CPU), at 4, and at 16 composed
    from the persisted half-8 table; each served from the process cache on
    a repeat; DKG_TPU_FB_WINDOW is validated."""
    cs = tgd.SECP256K1
    g = tgd.gen_host(cs)
    key = tgd.base_key(cs, g)
    t8 = tgp.generator_table(cs, device="cpu")
    assert np.array_equal(to_np(t8), tgd.fixed_table_host(cs, key, 8))
    t4 = tgp.base_table(cs, g, 4, device="cpu")
    assert np.array_equal(to_np(t4), tgd.fixed_table_host(cs, key, 4))
    hits = tgp.stats()["proc_hits"]
    assert tgp.base_table(cs, g, 4, device="cpu") is t4 and tgp.stats()["proc_hits"] == hits + 1
    monkeypatch.setenv("DKG_TPU_FB_WINDOW", "4")
    assert tgp._default_window() == 4 and tgp.generator_table(cs, device="cpu") is t4
    monkeypatch.setenv("DKG_TPU_FB_WINDOW", "12")
    with pytest.raises(ValueError, match="DKG_TPU_FB_WINDOW"):
        tgp._default_window()
    monkeypatch.delenv("DKG_TPU_FB_WINDOW")
    with pytest.raises(ValueError, match="window width"):
        tgp.base_table(cs, g, 12, device="cpu")
    k = to_torch(point_limbs("secp256k1", 5, 4)[:, 0, : cs.scalar.limbs])
    assert np.array_equal(to_np(tgd.affine_canon(cs, tgp.comb_mul(cs, t4, k))),
                          to_np(tgd.affine_canon(cs, tgp.comb_mul(cs, t8, k))))


def test_card_route_builds_persists_and_caches(table_cache, monkeypatch):
    """base_table's card route (here on its plain versions, the route
    forced for the CPU): a missing table builds through
    fixed_base_table_dev, counts one build, persists the file the JAX
    package loads bit for bit, and the repeat is a process-cache hit; after
    reset it is a disk load with no build."""
    monkeypatch.setattr(tgp, "_builds_on_card", lambda device: True)
    monkeypatch.setattr(tgd, "fixed_table_host", None)  # the card route never builds on the host
    tcs, jcs = _cs("secp256k1")
    h = _h("secp256k1")
    key = tgd.base_key(tcs, h)
    built = tgp.base_table(tcs, h, 4, device="cpu")
    st = tgp.stats()
    assert st["builds"] == 1 and st["disk_loads"] == 0 and st["proc_hits"] == 0
    assert tgp.base_table(tcs, h, 4, device="cpu") is built and tgp.stats()["proc_hits"] == 1
    assert [p.name for p in table_cache.glob("*.npz")] == [tgp._table_path(tcs, key, 4).name]
    assert np.array_equal(np.asarray(jgp.host_table(jcs, key, 4)), to_np(built))
    assert jgp.stats()["disk_loads"] == 1 and jgp.stats()["builds"] == 0
    tgp.reset()
    loaded = tgp.base_table(tcs, h, 4, device="cpu")
    st = tgp.stats()
    assert st["disk_loads"] == 1 and st["builds"] == 0 and torch.equal(loaded, built)
