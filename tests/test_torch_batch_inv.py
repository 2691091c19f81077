"""mod_batch_inv: a whole Montgomery-trick batch inversion in one launch.

On the CPU: the Fermat chains the kernel runs (derived from p, checked
against pow(x, p - 2, p) on edge and random x, and the table the kernel
reads); fk.mod_batch_inv's plain version against the JAX package's
batch_inv at (k, cols) in {(256, 3), (16, 5), (1, 4)}; gd.affine_canon,
whose classic inversion is one mod_batch_inv over INV_ROWS rows, against
the JAX package's (256 rows) with zero-Z lanes at a lane count that is a
multiple of neither; and the kernel's column body built from
csrc/host_check.cpp with the host compiler, at the edges (1 and p - 1, a
column of one repeated element, a column holding a zero, k = 1), against
the plain version.  On a CUDA machine (marker ``cuda``; skipped
elsewhere): the kernel itself.  Everything by exact equality."""

import ctypes
import random
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import field_ints, point_limbs, same, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.fields import device as jfd
from dkg_tpu.groups import device as jgd
from dkg_tpu_torch.fields import device as tfd
from dkg_tpu_torch.fields import host as tfh
from dkg_tpu_torch.fields.spec import BLS12_381_P, L25519, P25519, SECP256K1_N, SECP256K1_P
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import field_kernels as fk

FIELDS = [SECP256K1_P, P25519, BLS12_381_P]
IDS = [fs.name for fs in FIELDS]
HOST_FIELD = {SECP256K1_P: 0, P25519: 2, BLS12_381_P: 4}  # csrc/field.cuh's ids
PTR, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _nonzero(fs, seed: int, shape: tuple) -> torch.Tensor:
    """Non-zero elements (*shape, L): field_ints' edges (0 replaced by 3)
    first, then random ones."""
    n = int(np.prod(shape, dtype=int))
    vals = [v or 3 for v in field_ints(fs, seed, n)]
    return to_torch(tfh.encode(fs, vals)).reshape(shape + (fs.limbs,))


# ---------------------------------------------------------------------------
# the Fermat chain
# ---------------------------------------------------------------------------


def _run_chain(chain: list, npow: int, x: int, modulus: int) -> int:
    """A chain of fk.sliding_chain's form evaluated at x over Python ints,
    as csrc/inv.cuh fermat_chain runs it: the odd powers x, x^3, ... first,
    then each op a squaring (-1) or a multiply by odd power op."""
    x2 = x * x % modulus
    pw = [x]
    for _ in range(1, npow):
        pw.append(pw[-1] * x2 % modulus)
    acc = pw[chain[0]]
    for op in chain[1:]:
        acc = acc * (acc if op < 0 else pw[op]) % modulus
    return acc


@pytest.mark.parametrize("fs", FIELDS, ids=IDS)
def test_inv_chain_is_fermat(fs):
    """The chain the kernel runs gives x**(p - 2) at edge and random x (0
    to 0), in fewer multiplies than pow_const's square-and-multiply; the
    table the wrapper hands the kernel holds exactly its ops."""
    chain, npow = fk.inv_chain(fs)
    p = fs.modulus
    rng = random.Random(7)
    for x in [0, 1, 2, 3, p - 1, p - 2, (1 << 255) % p] + [rng.randrange(p) for _ in range(20)]:
        assert _run_chain(list(chain), npow, x, p) == pow(x, p - 2, p), x
    e = p - 2
    assert fk.chain_multiplies(list(chain), npow) < e.bit_length() - 1 + bin(e).count("1") - 1
    assert 1 <= npow <= 1 << (fk.INV_WINDOW_MAX - 1) and all(-1 <= op < npow for op in chain)
    table = fk._chain_table(fs, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.tolist() == list(chain)


def test_sliding_chain_reaches_every_small_exponent():
    """sliding_chain at every window up to the kernel's largest, for every
    exponent below 600 (runs of zeros, windows cut short by the end)."""
    m = SECP256K1_N.modulus
    for w in range(1, fk.INV_WINDOW_MAX + 1):
        for e in range(1, 600):
            chain, npow = fk.sliding_chain(e, w)
            assert npow <= 1 << (w - 1)
            assert _run_chain(chain, npow, 5, m) == pow(5, e, m), (w, e)
    with pytest.raises(ValueError):
        fk.sliding_chain(0, 4)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", FIELDS, ids=IDS)
def test_mod_batch_inv_matches_jax(fs):
    """fk.mod_batch_inv (its plain version on the CPU) against the JAX
    package's batch_inv down axis 0, at 256, 16 and 1 rows; a column holding
    a zero reads 0 on both sides."""
    for k, cols in ((256, 3), (16, 5), (1, 4)):
        x = _nonzero(fs, 10 + k, (k, cols))
        if k == 16:
            x[9, 2] = 0
        got = fk.mod_batch_inv(fs, x)
        assert same(got, jfd.batch_inv(fs, jnp.asarray(x.numpy().astype(np.uint32)))), (k, cols)
        if k == 16:
            assert not got[:, 2].any() and got[:, 1].any()


def test_mod_batch_inv_refuses_other_fields():
    with pytest.raises(NotImplementedError, match="mod_batch_inv"):
        fk.batch_inv_kernel_for(L25519)
    assert [fk.batch_inv_kernel_for(fs).name for fs in FIELDS] == [
        "mod_batch_inv", "mod_batch_inv[ed25519]", "mod_batch_inv[bls12_381]"]


@pytest.mark.parametrize("curve", ["secp256k1", "ristretto255", "bls12_381_g1"])
def test_affine_canon_matches_jax_at_the_chosen_rows(curve):
    """37 lanes (a multiple of neither 16 nor 256), every 5th point the
    identity (zero Z on Weierstrass curves): the classic canonical affine
    form (one mod_batch_inv over INV_ROWS rows) equals the JAX package's
    (256 rows) limb for limb, and so does the gemm form (256 rows)."""
    tcs, jcs = tgd.ALL_CURVES[curve], jgd.ALL_CURVES[curve]
    pts = point_limbs(curve, 64, 37)
    want = np.asarray(jgd.affine_canon(jcs, jnp.asarray(pts)))
    assert 37 % tgd.INV_ROWS and 37 % tgd.GEMM_INV_ROWS
    assert same(tgd.affine_canon(tcs, to_torch(pts)), want)
    assert same(tgd.affine_canon(tcs, to_torch(pts), mul="gemm"), want)


def test_affine_canon_inverts_through_one_mod_batch_inv(monkeypatch):
    """Under mul="classic" the inversion is one mod_batch_inv call over
    (INV_ROWS, lanes / INV_ROWS) (the lanes padded with ones) and the
    only mod_mul calls are x·zi and y·zi (and t = x·y on Edwards); under
    "gemm" neither is called."""
    calls = []
    real_inv, real_mul = fk.mod_batch_inv, fk.mod_mul
    monkeypatch.setattr(fk, "mod_batch_inv", lambda fs, x: calls.append(("inv", tuple(x.shape))) or real_inv(fs, x))
    monkeypatch.setattr(fk, "mod_mul", lambda fs, a, b: calls.append("mul") or real_mul(fs, a, b))
    rows = tgd.INV_ROWS
    for curve, muls in (("secp256k1", 2), ("ristretto255", 3)):
        cs = tgd.ALL_CURVES[curve]
        pts = to_torch(point_limbs(curve, 65, 40))
        calls.clear()
        tgd.affine_canon(cs, pts)
        assert calls == [("inv", (rows, -(-40 // rows), 16))] + ["mul"] * muls, curve
        calls.clear()
        tgd.affine_canon(cs, pts, mul="gemm")
        assert calls == [], curve


# ---------------------------------------------------------------------------
# the kernel's body, built for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/host_check.cpp")
    out = tmp_path_factory.mktemp("host_check") / "host_check.so"
    subprocess.run([cxx, "-O0", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o", str(out),
                    str(build.CSRC / "host_check.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.host_mod_batch_inv.argtypes = [PTR, PTR, I64, I64, PTR, INT, INT, INT]
    lib.host_mod_batch_inv.restype = INT
    return lib


def _host_inv(lib, fs, x: torch.Tensor) -> torch.Tensor:
    chain, npow = fk.inv_chain(fs)
    table = torch.tensor(chain, dtype=torch.int32)
    xs = x.contiguous()
    out = torch.full_like(xs, -1)
    assert lib.host_mod_batch_inv(xs.data_ptr(), out.data_ptr(), xs.shape[0], xs.numel() // (xs.shape[0] * fs.limbs),
                                  table.data_ptr(), len(table), npow, HOST_FIELD[fs]) == 0
    return out


@pytest.mark.parametrize("fs", FIELDS, ids=IDS)
def test_host_compiled_batch_inv_matches_plain(host_lib, fs):
    """inv.cuh batch_inv_column over 1, p - 1, 2 and p - 2 down a column, a
    column of one repeated element, a column holding a zero (it reads 0),
    k = 1 and k = 16 and 64 over a few columns, against the plain version
    (fd.batch_inv with the plain multiply)."""
    p = fs.modulus
    ends = to_torch(tfh.encode(fs, [1, p - 1, 2, p - 2])).reshape(4, 1, fs.limbs)
    cols = _nonzero(fs, 20, (16, 4))
    cols[:, 1] = cols[5, 1]
    cols[7, 2] = 0
    cases = [ends, cols, _nonzero(fs, 21, (1, 5)), _nonzero(fs, 22, (64, 2))]
    for x in cases:
        assert torch.equal(_host_inv(host_lib, fs, x), tfd.batch_inv(fs, x)), tuple(x.shape)
    got = _host_inv(host_lib, fs, cols)
    assert not got[:, 2].any()
    assert torch.equal(tfd.mul(fs, got[:, 1], cols[:, 1]), tfd.ones(fs, (16,), device="cpu"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fs", FIELDS, ids=IDS)
def test_cuda_batch_inv_matches_plain(cuda, fs):
    """One launch a call, equal to the plain version at 256, 16 and 1 rows,
    a zero column included."""
    kernel = fk.batch_inv_kernel_for(fs)
    for k, cols in ((256, 3), (16, 5), (1, 4)):
        x = _nonzero(fs, 30 + k, (k, cols))
        x[0, 0] = 0
        before = kernel.launches
        got = fk.mod_batch_inv(fs, x.to(cuda))
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(got.cpu(), tfd.batch_inv(fs, x))
