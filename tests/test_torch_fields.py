"""dkg_tpu_torch.fields and the mod_madd plain version against dkg_tpu.fields.

Same limbs in, same canonical limbs out: the field ops are exact, so
the tolerance is zero, on the secp256k1 base and scalar fields, the
Edwards fields the plain point formulas use, and BLS12-381's 24-limb
base field and its scalar field."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import field_ints, field_limbs, to_np, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.fields import device as jfd
from dkg_tpu.fields import host as jfh
from dkg_tpu.fields import spec as jspec
from dkg_tpu_torch.fields import device as tfd
from dkg_tpu_torch.fields import host as tfh
from dkg_tpu_torch.fields import spec as tspec
from dkg_tpu_torch.ops import field_kernels as fk

FIELDS = ["secp256k1_base", "secp256k1_scalar", "ed25519_base", "ed25519_scalar", "bls12_381_base",
          "bls12_381_scalar"]
N = 24


def _specs(name):
    return tspec.ALL_FIELDS[name], jspec.ALL_FIELDS[name]


@pytest.mark.parametrize("name", FIELDS)
def test_spec_constants_match(name):
    t, j = _specs(name)
    assert (t.modulus, t.limbs, t.bits, t.nbytes) == (j.modulus, j.limbs, j.bits, j.nbytes)
    for attr in ("p_limbs", "p_limbs_ext", "barrett_mu"):
        assert np.array_equal(getattr(t, attr), getattr(j, attr)), attr
    assert tspec.limbs_to_int(tspec.int_to_limbs(j.modulus - 1, j.limbs)) == j.modulus - 1


@pytest.mark.parametrize("name", FIELDS)
def test_host_encode_decode_match(name):
    t, j = _specs(name)
    ints = field_ints(j, 1, N) + [j.modulus, j.modulus + 5]  # reduced on encode
    enc = tfh.encode(t, ints)
    assert enc.dtype == np.uint32 and np.array_equal(enc, jfh.encode(j, ints))
    assert np.array_equal(tfh.encode(t, 7), jfh.encode(j, 7))
    nested = [ints[:4], ints[4:8]]
    assert np.array_equal(tfh.encode(t, nested), jfh.encode(j, nested))
    assert list(tfh.decode(t, enc)) == list(jfh.decode(j, enc))
    back = tfh.from_tensor(tfh.to_tensor(enc, "cpu"))
    assert back.dtype == np.uint32 and np.array_equal(back, enc)


def _binary_cases():
    return [("add", tfd.add, jfd.add), ("sub", tfd.sub, jfd.sub), ("mul", tfd.mul, jfd.mul)]


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match(name, op):
    t, j = _specs(name)
    tf, jf = {k: (a, b) for k, a, b in _binary_cases()}[op]
    a, b = field_limbs(j, 2, N), field_limbs(j, 3, N)
    b[1] = a[1]  # x op x
    got = tf(t, to_torch(a), to_torch(b))
    assert got.dtype == torch.int32
    assert np.array_equal(to_np(got), np.asarray(jf(j, jnp.asarray(a), jnp.asarray(b))))
    # broadcast of one operand over the batch
    got = tf(t, to_torch(a), to_torch(b[5]))
    assert np.array_equal(to_np(got), np.asarray(jf(j, jnp.asarray(a), jnp.asarray(b[5]))))


@pytest.mark.parametrize("name", FIELDS)
def test_unary_and_predicates_match(name):
    t, j = _specs(name)
    a = field_limbs(j, 4, N)
    ta, ja = to_torch(a), jnp.asarray(a)
    assert np.array_equal(to_np(tfd.neg(t, ta)), np.asarray(jfd.neg(j, ja)))
    assert np.array_equal(to_np(tfd.square(t, ta)), np.asarray(jfd.square(j, ja)))
    assert tfd.is_zero(ta).tolist() == np.asarray(jfd.is_zero(ja)).tolist()
    assert tfd.eq(ta, ta.roll(1, 0)).tolist() == np.asarray(jfd.eq(ja, jnp.roll(ja, 1, 0))).tolist()
    pred = np.arange(N) % 3 == 0
    got = tfd.select(torch.from_numpy(pred), ta, ta.flip(0))
    assert np.array_equal(to_np(got), np.asarray(jfd.select(jnp.asarray(pred), ja, ja[::-1])))
    assert np.array_equal(to_np(tfd.zeros(t, (2,), device="cpu")), np.asarray(jfd.zeros(j, (2,))))
    assert np.array_equal(to_np(tfd.ones(t, (2,), device="cpu")), np.asarray(jfd.ones(j, (2,))))
    assert np.array_equal(to_np(tfd.constant(t, 21, device="cpu")), np.asarray(jfd.constant(j, 21)))


@pytest.mark.parametrize("name", FIELDS)
def test_normalize_and_cond_sub_match(name):
    t, j = _specs(name)
    rng = np.random.default_rng(5)
    # unnormalised uint32 columns (the JAX package's column type), one lane
    # with a carry that ripples through a run of 0xFFFF limbs
    cols = rng.integers(0, 1 << 32, size=(N, t.limbs), dtype=np.int64)
    cols[0] = 0xFFFF
    cols[0, 0] = 0x10000
    got = tfd.normalize(torch.from_numpy(cols), t.limbs + 1)
    want = jfd.normalize(jnp.asarray(cols.astype(np.uint32)), t.limbs + 1)
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    assert got[0, t.limbs].item() == 1 and not got[0, : t.limbs].any()
    x = np.concatenate([field_limbs(j, 6, N), np.zeros((N, 1), np.uint32)], axis=1)
    x[:, 0] += 3  # some lanes >= p
    x = np.asarray(jfd.normalize(jnp.asarray(x), t.limbs + 1))
    pe = t.p_limbs_ext.astype(np.int64)
    got = tfd.cond_sub(torch.from_numpy(x.astype(np.int64)), torch.from_numpy(pe))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(jfd.cond_sub(jnp.asarray(x), t.p_limbs_ext)))


def _carry_loop(cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The carry that fields.device._carry replaced: rounds that move every
    column's carry one limb up until none is left, a number of rounds that
    depends on the data."""
    out = torch.zeros_like(cols[..., -1])
    while True:
        carry = cols >> 16
        out = out + carry[..., -1]
        if not bool(carry[..., :-1].any()):
            return cols & 0xFFFF, out
        cols = (cols & 0xFFFF) + torch.nn.functional.pad(carry[..., :-1], (1, 0))


@pytest.mark.parametrize("bits", [1, 16, 17, 23, 40, 61])
def test_carry_matches_the_round_loop(bits):
    """_carry (fixed rounds, one lookahead pass) gives the round loop's
    limbs and carry out, over random signed columns below 2**bits and runs
    of 0xFFFF and 0 limbs, where a carry (from a 2**16 limb) or a borrow
    (from a -1 limb) ripples through the whole run; the non-negative ones
    also through its unsigned form."""
    rng = np.random.default_rng(bits)
    hi = (1 << bits) - 1
    for k in (1, 2, 17, 25, 33, 50, 62):
        cols = rng.integers(-hi, hi + 1, size=(96, k), dtype=np.int64)
        runs = rng.random((96, k)) < 0.7
        cols[runs] = rng.choice([0, 0xFFFF], size=int(runs.sum()))
        cols[0], cols[1], cols[2], cols[3] = 0xFFFF, 0, 0xFFFF, 0
        cols[0, 0], cols[1, 0] = 1 << 16, -1  # a carry through 0xFFFF..., a borrow through 0...
        cols[2, k // 2], cols[3, k // 2] = -1, 1 << 16  # a borrow and a carry meeting mid-run
        t = torch.from_numpy(np.clip(cols, -hi, hi))
        limbs, top = tfd._carry(t, bits)
        want = _carry_loop(t)
        assert torch.equal(limbs, want[0]) and torch.equal(top, want[1]), k
        pos = t.clamp(min=0)
        limbs, top = tfd._carry(pos, bits, signed=False)
        want = _carry_loop(pos)
        assert torch.equal(limbs, want[0]) and torch.equal(top, want[1]), k
        assert torch.equal(tfd._carry(pos, bits, signed=False, top=False), want[0])
    with pytest.raises(ValueError, match="columns"):
        tfd._carry(torch.zeros((1, 63), dtype=torch.int64))


@pytest.mark.parametrize("name", FIELDS)
def test_mod_madd_plain_matches_jax(name):
    """mod_madd's plain version is what the CUDA kernel is held against on
    the card; here it is held against the JAX package's a·b + c."""
    t, j = _specs(name)
    a, b, c = (field_limbs(j, s, N) for s in (7, 8, 9))
    want = jfd.add(j, jfd.mul(j, jnp.asarray(a), jnp.asarray(b)), jnp.asarray(c))
    got = fk.mod_madd(t, to_torch(a), to_torch(b), to_torch(c))  # CPU tensors: the plain version
    assert np.array_equal(to_np(got), np.asarray(want))
    ints = [(x * y + z) % j.modulus for x, y, z in zip(*(field_ints(j, s, N) for s in (7, 8, 9)))]
    assert list(tfh.decode(t, to_np(got))) == ints
    # the Horner step's broadcast: acc (m, n, L), x (n, L), c (m, 1, L)
    acc = to_torch(a[:12]).reshape(3, 4, -1)
    got = fk.mod_madd(t, acc, to_torch(b[:4]), to_torch(c[:3]).reshape(3, 1, -1))
    want = jfd.add(j, jfd.mul(j, jnp.asarray(a[:12]).reshape(3, 4, -1), jnp.asarray(b[:4])),
                   jnp.asarray(c[:3]).reshape(3, 1, -1))
    assert np.array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("name", FIELDS)
def test_barrett_reduce_worst_cases_match(name):
    """barrett_reduce (the plain multiply's reduction) at its largest
    inputs, (m-1-i)·(m-1-j) for i, j < 4 and the top of the 2L-limb range,
    against the JAX package's and big ints."""
    t, j = _specs(name)
    m = j.modulus
    big = [m - 1 - i for i in range(4)]
    prods = [x * y for x in big for y in big] + [(1 << (32 * t.limbs)) - 1, m * m - 1, m * (m - 1)]
    x = np.stack([tspec.int_to_limbs(v, 2 * t.limbs) for v in prods])
    got = tfd.barrett_reduce(t, torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(jfd.barrett_reduce(j, jnp.asarray(x))))
    assert list(tfh.decode(t, got.numpy().astype(np.uint32))) == [v % m for v in prods]


@pytest.mark.parametrize("name", FIELDS)
def test_mulred_constants_match(name):
    """The fused multiply-reduce's constants and admission, the port's own
    copy of the proof, equal the JAX package's (foldm as bytes there as
    float32, here as uint8: the same values)."""
    t, j = _specs(name)
    tm, jm = t.mulred, j.mulred
    assert tm is not None and jm is not None
    assert (tm.n_split, tm.shift_e) == (jm.n_split, jm.shift_e)
    assert tm.foldm.dtype == np.uint8 and tm.foldm.shape == (3 * t.limbs + 1, 2 * t.limbs)
    for attr in ("foldm", "c_limbs", "qtable", "np_limbs"):
        assert np.array_equal(getattr(tm, attr), getattr(jm, attr)), attr


@pytest.mark.parametrize("name", FIELDS)
def test_mul_gemm_matches_jax(name):
    """_mul_gemm (mxu_mod_mul's plain version) against the JAX package's
    _mul_gemm, the MXU kernel's row core at XLA level (mxu_mul_rows), its
    classic mul and big ints, at the edge values and random elements."""
    from dkg_tpu.ops import pallas_mxu as jpm

    t, j = _specs(name)
    a, b = field_limbs(j, 12, N), field_limbs(j, 13, N)
    b[:8] = a[:8][::-1]  # edge x edge pairs
    got = tfd._mul_gemm(t, to_torch(a), to_torch(b))
    assert got.dtype == torch.int32
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(to_np(got), np.asarray(jfd._mul_gemm(j, ja, jb)))
    rows = jpm.mxu_mul_rows(j, [ja.T[i : i + 1] for i in range(j.limbs)], [jb.T[i : i + 1] for i in range(j.limbs)])
    assert np.array_equal(to_np(got), np.asarray(jnp.concatenate(rows, axis=0).T))
    assert torch.equal(got, tfd.mul(t, to_torch(a), to_torch(b)))
    assert list(tfh.decode(t, to_np(got))) == [int(x) * int(y) % j.modulus
                                              for x, y in zip(jfh.decode(j, a), jfh.decode(j, b))]
    # broadcast of one operand over a two-axis batch
    got = tfd._mul_gemm(t, to_torch(a).reshape(4, 6, -1), to_torch(b[3]))
    assert np.array_equal(to_np(got), np.asarray(jfd.mul(j, ja.reshape(4, 6, -1), jb[3])))


@pytest.mark.parametrize("name", FIELDS)
def test_mod_mul_plain_matches_jax_mul(name):
    """mod_mul's plain version (fd.mul, on a CPU tensor) against the JAX
    package's fields.device.mul, which pallas_field.mod_mul is held to."""
    t, j = _specs(name)
    a, b = field_limbs(j, 14, N), field_limbs(j, 15, N)
    got = fk.mod_mul(t, to_torch(a), to_torch(b))
    assert np.array_equal(to_np(got), np.asarray(jfd.mul(j, jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("name", FIELDS)
def test_pow_inv_batch_inv_match(name):
    """pow_const, inv and batch_inv, chaining either multiply (mod_mul's
    and mxu_mod_mul's plain versions), against the JAX package's
    (square-and-select, Fermat, Montgomery's trick)."""
    from dkg_tpu_torch.groups import device as tgd

    t, j = _specs(name)
    a = field_limbs(j, 16, 6)  # lane 0 holds 0, which inverts to 0
    x = field_limbs(j, 17, 12)
    x[x.sum(-1) == 0] = jfh.encode(j, 3)  # batch_inv: no zero lanes
    ja = jnp.asarray(a)
    want_pow = {e: np.asarray(jfd.pow_const(j, ja, e)) for e in (0, 1, 0x10001)}
    want_inv = np.asarray(jfd.inv(j, ja))
    assert list(jfh.decode(j, want_inv)) == [pow(v, -1, j.modulus) if v else 0 for v in field_ints(j, 16, 6)]
    cases = (((3, 4), 1),)
    want_binv = [np.asarray(jfd.batch_inv(j, jnp.asarray(x.reshape(s + (-1,))), axis=ax)) for s, ax in cases]
    for mul in ("classic", "gemm"):
        mulf = tgd.field_mul(mul)
        for e, want in want_pow.items():
            assert np.array_equal(to_np(tfd.pow_const(t, to_torch(a), e, mul=mulf)), want), (mul, e)
        assert np.array_equal(to_np(tfd.inv(t, to_torch(a), mul=mulf)), want_inv), mul
        for (shape, axis), want in zip(cases, want_binv):
            got = tfd.batch_inv(t, to_torch(x.reshape(shape + (-1,))), axis=axis, mul=mulf)
            assert np.array_equal(to_np(got), want), (mul, shape)
