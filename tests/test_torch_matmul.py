"""fields/matmul.py and the ceremony's matmul routes: dkg_tpu_torch on the
CPU against dkg_tpu and host big ints.

``matmul_mod`` is held against the JAX package's on each scalar field and
secp256k1's base field at a contraction past KCHUNK (K = 1030, two
chunks) with the field's edges, run eagerly under ``jax.disable_jit``
(one eager compile of its ops for the first 16-limb field, ~13 s, then
~0.4 s a field); other shapes, BLOCK_BYTES forced small and BLS12-381's
24-limb base field against Python ints.  ``eval_many``'s Vandermonde
route against the JAX package's under DKG_TPU_MXU=1 and against the
Horner route with EVAL_VAND_BUDGET_BYTES forced small; ``_field_dot``'s one-row route against ``mod_madd_dot``'s plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import edge_ints, one_thread, to_np, to_torch  # noqa: F401

from dkg_tpu.fields import matmul as jmm
from dkg_tpu.fields import spec as jspec
from dkg_tpu.poly import device as jpd
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.fields import device as tfd
from dkg_tpu_torch.fields import matmul as tmm
from dkg_tpu_torch.fields.spec import ALL_FIELDS, BLS12_381_P
from dkg_tpu_torch.ops import field_kernels as fk
from dkg_tpu_torch.poly import device as tpd

SCALARS = ("secp256k1_scalar", "ed25519_scalar", "bls12_381_scalar")


def _limbs(fs, values, shape) -> np.ndarray:
    """ints -> uint32 limbs of ``shape`` + (L,)."""
    flat = [(int(v) % fs.modulus) for v in values]
    arr = np.array([[(v >> (16 * i)) & 0xFFFF for i in range(fs.limbs)] for v in flat], np.uint32)
    return arr.reshape(shape + (fs.limbs,))


def _ints(limbs) -> list:
    return [sum(int(x) << (16 * i) for i, x in enumerate(row)) for row in np.asarray(limbs).reshape(-1, limbs.shape[-1])]


def _operands(fs, seed: int, m: int, k: int, n: int):
    """a (m, k, L), b (n, k, L): the field's edges first, the rest random."""
    rng = np.random.default_rng(seed)
    edges = edge_ints(fs)

    def vals(count, off):
        rand = [int.from_bytes(rng.bytes(2 * fs.limbs), "little") % fs.modulus for _ in range(count)]
        return [edges[(i + off) % len(edges)] if i < 2 * len(edges) else rand[i] for i in range(count)]

    return _limbs(fs, vals(m * k, 0), (m, k)), _limbs(fs, vals(n * k, 3), (n, k))


def _oracle(fs, a, b) -> np.ndarray:
    """Σ_k a[m, k]·b[n, k] mod p by Python ints."""
    ai = np.array(_ints(a), dtype=object).reshape(a.shape[:2])
    bi = np.array(_ints(b), dtype=object).reshape(b.shape[:2])
    out = [[sum(int(x) * int(y) for x, y in zip(ai[i], bi[j])) % fs.modulus for j in range(bi.shape[0])]
           for i in range(ai.shape[0])]
    return _limbs(fs, [v for row in out for v in row], (ai.shape[0], bi.shape[0]))


@pytest.mark.parametrize("name", (*SCALARS, "secp256k1_base"))
def test_matmul_mod_matches_jax_past_kchunk(name):
    """K = 1030 > KCHUNK: two contraction chunks, the second ragged, with
    0, 1, p - 1 and the 2**255 / 2**256 edges in the operands."""
    fs = ALL_FIELDS[name]
    a, b = _operands(fs, 7, 2, 1030, 2)
    got = to_np(tmm.matmul_mod(fs, to_torch(a), to_torch(b)))
    with jax.disable_jit():
        want = np.asarray(jmm.matmul_mod(jspec.ALL_FIELDS[name], jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _oracle(fs, a, b))


@pytest.mark.parametrize("name", (*SCALARS, "secp256k1_base", "bls12_381_base"))
def test_matmul_mod_blocks_and_edges_match_ints(name, monkeypatch):
    """BLOCK_BYTES forced to one output column a block (N = 5 blocks, each
    its own digits), M = 3 rows, K = 9 (a multiple of 8 plus one), every
    operand an edge value, against Python ints; the all-(p - 1) product at
    K = 1030 reaches the accumulator's largest sums."""
    fs = ALL_FIELDS[name]
    monkeypatch.setattr(tmm, "BLOCK_BYTES", 1)
    a, b = _operands(fs, 11, 3, 9, 5)
    assert np.array_equal(to_np(tmm.matmul_mod(fs, to_torch(a), to_torch(b))), _oracle(fs, a, b))
    top_a = _limbs(fs, [fs.modulus - 1] * 1030, (1, 1030))
    top_b = _limbs(fs, [fs.modulus - 1] * 2060, (2, 1030))
    assert np.array_equal(to_np(tmm.matmul_mod(fs, to_torch(top_a), to_torch(top_b))), _oracle(fs, top_a, top_b))


def test_matmul_mod_bounds_and_reducers():
    """MAX_K is the audit's 2**14; a longer contraction raises; every
    reducer a field admits (reduce_wide picks one) gives the same residues."""
    fs = ALL_FIELDS["secp256k1_base"]
    assert (tmm.KCHUNK, tmm.MAX_K) == (jmm.KCHUNK, jmm.MAX_K) == (1024, 16384)
    with pytest.raises(ValueError, match="exceeds"):
        tmm.matmul_mod(fs, torch.zeros((1, tmm.MAX_K + 1, 16), dtype=torch.int32),
                       torch.zeros((1, tmm.MAX_K + 1, 16), dtype=torch.int32))
    rng = np.random.default_rng(2)
    for f in (fs, BLS12_381_P, ALL_FIELDS["bls12_381_scalar"]):
        x = torch.from_numpy(rng.integers(0, 1 << 16, size=(6, 2 * f.limbs)).astype(np.int64))
        outs = [tfd.reduce_wide(f, x), tfd.linear_reduce(f, x), tfd.barrett_reduce(f, x)]
        if f.fold_limbs is not None:
            outs.append(tfd.fold_reduce(f, x))
        assert all(torch.equal(o, outs[0]) for o in outs)
        assert np.array_equal(to_np(outs[0].to(torch.int32)),
                              _limbs(f, [v % f.modulus for v in _ints(x.numpy())], (6,)))
    assert (fs.fold_limbs is not None, BLS12_381_P.fold_limbs) == (True, None)


def test_int8_dot_pads_to_int_mm_shapes():
    """The shifted int8 operands padded with zeros (M = 1 to 17 rows, K = 13
    and N = 6 to multiples of 8) give the unpadded exact product."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-128, 128, size=(1, 13)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, size=(13, 6)).astype(np.int8))
    got = tmm._int8_dot(a, b)
    assert got.dtype == torch.int32 and got.shape == (1, 6)
    assert torch.equal(got.long(), a.long() @ b.long())


@pytest.mark.parametrize("name", SCALARS)
def test_eval_many_vandermonde_matches_jax_and_horner(name, monkeypatch):
    """eval_many(matmul=True) at coefficients (2, 9) and 3 points (1, p - 1,
    2): the JAX package's eval_many under DKG_TPU_MXU=1 (its Vandermonde
    form, eagerly) and the Horner route; with EVAL_VAND_BUDGET_BYTES
    forced to one point a chunk, three chunks, the same values."""
    fs = ALL_FIELDS[name]
    coeffs, _ = _operands(fs, 21, 2, 9, 1)
    xs = _limbs(fs, [1, fs.modulus - 1, 2], (3,))
    horner = tpd.eval_many(fs, to_torch(coeffs), to_torch(xs))
    got = tpd.eval_many(fs, to_torch(coeffs), to_torch(xs), matmul=True)
    assert torch.equal(got, horner)
    monkeypatch.setenv("DKG_TPU_MXU", "1")
    with jax.disable_jit():
        want = np.asarray(jpd.eval_many(jspec.ALL_FIELDS[name], jnp.asarray(coeffs), jnp.asarray(xs)))
    assert np.array_equal(to_np(got), want)
    monkeypatch.setattr(tpd, "EVAL_VAND_BUDGET_BYTES", 1)
    assert torch.equal(tpd.eval_many(fs, to_torch(coeffs), to_torch(xs), matmul=True), horner)


@pytest.mark.parametrize("name", SCALARS)
def test_field_dot_one_row_matches_mod_madd_dot(name):
    """_field_dot(matmul=True), the one-row matmul_mod (M = 1 padded to 17
    rows), equals mod_madd_dot's plain version at m = 7 weights of up to
    128 bits over (7, 5) values; the default route is mod_madd_dot."""
    fs = ALL_FIELDS[name]
    w, vals = _operands(fs, 33, 1, 7, 5)
    w = w[0].copy()
    w[:, 8:] = 0  # 128-bit RLC weights
    vals = vals.transpose(1, 0, 2).copy()  # (m, K, L)
    got = tce._field_dot(fs, to_torch(w), to_torch(vals), matmul=True)
    assert torch.equal(got, fk.mod_madd_dot_plain(fs, to_torch(w), to_torch(vals)))
    assert torch.equal(tce._field_dot(fs, to_torch(w), to_torch(vals)), got)
