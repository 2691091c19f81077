"""mxu_batch_inv and the tensor-core fold of the fused multiply-reduce.

On the CPU: mxu_batch_inv's plain version (fields.device.batch_inv with
_mul_gemm as every multiply, at any row count) against the JAX package's
batch_inv at the edges (1, p - 1, 2 and p - 2 down a column, a column of
one repeated element, a column holding a zero, k = 1); gd.affine_canon
under mul="gemm", whose inversion is one mxu_batch_inv over GEMM_INV_ROWS
rows, against the JAX package's affine_canon on all three curves; and,
built from csrc/host_check.cpp with the host compiler, the warp fold of
csrc/mxu_warp.cuh (32 lanes as fibers, each mma built from the PTX ISA's
m16n8k32 fragment tables) against mxu.cuh's __dp4a lane body at every
pair of field edges and at the admission proof's worst columns, on all
six fields, and mxu_batch_inv's column chain on a warp of 32 columns
(padded with ones, as the wrapper pads) against the plain version.  On a
CUDA machine (marker ``cuda``; skipped elsewhere): the kernels.
Everything by exact equality."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import edge_operands, field_ints, point_limbs, same, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.fields import device as jfd
from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import device as jgd
from dkg_tpu_torch.fields import device as tfd
from dkg_tpu_torch.fields import host as tfh
from dkg_tpu_torch.fields.spec import (BLS12_381_P, BLS12_381_R, L25519, LIMB_BITS, P25519, SECP256K1_N,
                                       SECP256K1_P)
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import field_kernels as fk
from dkg_tpu_torch.ops import mxu_kernels as mk

BASE_FIELDS = [SECP256K1_P, P25519, BLS12_381_P]
ALL_FIELDS = [SECP256K1_P, SECP256K1_N, P25519, L25519, BLS12_381_P, BLS12_381_R]
PTR, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _nonzero(fs, seed: int, shape: tuple) -> torch.Tensor:
    """Non-zero elements (*shape, L): field_ints' edges (0 replaced by 3)
    first, then random ones."""
    n = int(np.prod(shape, dtype=int))
    vals = [v or 3 for v in field_ints(fs, seed, n)]
    return to_torch(tfh.encode(fs, vals)).reshape(shape + (fs.limbs,))


def _edge_columns(fs, seed: int) -> torch.Tensor:
    """(4, 5, L): 1, p - 1, 2, p - 2 down column 0; one repeated element
    down column 1; a zero in column 2; random non-zero elsewhere."""
    p = fs.modulus
    x = _nonzero(fs, seed, (4, 5))
    x[:, 0] = to_torch(tfh.encode(fs, [1, p - 1, 2, p - 2]))
    x[:, 1] = x[2, 1]
    x[1, 2] = 0
    return x


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", BASE_FIELDS, ids=[fs.name for fs in BASE_FIELDS])
def test_mxu_batch_inv_plain_matches_jax(fs):
    """mk.mxu_batch_inv (its plain version on the CPU: the gemm chain at
    the rows it is given) against the JAX package's batch_inv down axis 0,
    at the edge columns (4 rows), 16 rows and k = 1; a column holding a
    zero reads 0 on both sides."""
    for x in (_nonzero(fs, 2, (16, 3)), _nonzero(fs, 3, (1, 4)), _edge_columns(fs, 1)):
        got = mk.mxu_batch_inv(fs, x)
        assert same(got, jfd.batch_inv(fs, jnp.asarray(x.numpy().astype(np.uint32)))), tuple(x.shape)
    assert not got[:, 2].any() and got[:, 1].any()
    p = fs.modulus
    assert [int(v) for v in tfh.decode(fs, got[:, 0])] == [1, p - 1, (p + 1) // 2, pow(p - 2, p - 2, p)]


def test_mxu_batch_inv_refuses_other_fields():
    for fs in (L25519, SECP256K1_N, BLS12_381_R):
        with pytest.raises(NotImplementedError, match="mxu_batch_inv"):
            mk.batch_inv_kernel_for(fs)
    assert [mk.batch_inv_kernel_for(fs).name for fs in BASE_FIELDS] == [
        "mxu_batch_inv", "mxu_batch_inv[ed25519]", "mxu_batch_inv[bls12_381]"]
    assert all(mk.batch_inv_kernel_for(fs).source == "mxu_kernels.cu" for fs in BASE_FIELDS)


@pytest.mark.parametrize("curve", ["secp256k1", "ristretto255", "bls12_381_g1"])
def test_affine_canon_gemm_matches_jax(curve):
    """45 lanes in a (3, 15) batch (a multiple of neither the rows nor a
    warp), every 5th point the identity (zero Z on Weierstrass curves):
    the gemm canonical affine form (one mxu_batch_inv over GEMM_INV_ROWS
    rows, then mxu_mod_mul's coordinates) equals the JAX package's limb
    for limb, and the classic form's."""
    tcs, jcs = tgd.ALL_CURVES[curve], jgd.ALL_CURVES[curve]
    pts = point_limbs(curve, 71, 45).reshape(3, 15, tcs.ncoords, tcs.field.limbs)
    want = np.asarray(jgd.affine_canon(jcs, jnp.asarray(pts)))
    assert 45 % tgd.GEMM_INV_ROWS and 45 % mk.WARP
    got = tgd.affine_canon(tcs, to_torch(pts), mul="gemm")
    assert same(got, want)
    assert torch.equal(got, tgd.affine_canon(tcs, to_torch(pts)))


def test_affine_canon_gemm_inverts_through_one_mxu_batch_inv(monkeypatch):
    """Under mul="gemm" the inversion is one mxu_batch_inv call over
    (GEMM_INV_ROWS, lanes / GEMM_INV_ROWS) (the lanes padded with ones)
    and the only other multiplies are mxu_mod_mul's x·zi and y·zi (and
    t = x·y on Edwards); no classic kernel is called."""
    calls = []
    real_inv, real_mul = mk.mxu_batch_inv, mk.mxu_mod_mul
    monkeypatch.setattr(mk, "mxu_batch_inv", lambda fs, x: calls.append(("inv", tuple(x.shape))) or real_inv(fs, x))
    monkeypatch.setattr(mk, "mxu_mod_mul", lambda fs, a, b: calls.append("mul") or real_mul(fs, a, b))
    for name in ("mod_batch_inv", "mod_mul"):
        monkeypatch.setattr(fk, name, lambda *a, name=name: calls.append(name))
    rows = tgd.GEMM_INV_ROWS
    for curve, muls in (("secp256k1", 2), ("ristretto255", 3)):
        cs = tgd.ALL_CURVES[curve]
        calls.clear()
        tgd.affine_canon(cs, to_torch(point_limbs(curve, 65, 40)), mul="gemm")
        assert calls == [("inv", (rows, -(-40 // rows), 16))] + ["mul"] * muls, curve


# ---------------------------------------------------------------------------
# the kernels' bodies, built for the host
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
    for name in ("host_mxu_mod_mul", "host_mxu_warp_mod_mul"):
        fn = getattr(lib, name)
        fn.argtypes = [INT, PTR, PTR, PTR, I64, INT, PTR, PTR, PTR, PTR, INT, INT]
        fn.restype = INT
    lib.host_mxu_batch_inv.argtypes = [PTR, PTR, I64, I64, INT, PTR, PTR, PTR, PTR, INT, INT, PTR, INT, INT]
    lib.host_mxu_batch_inv.restype = INT
    return lib


def _consts(fs) -> list:
    mr = fs.mulred
    return [np.ascontiguousarray(x) for x in (mk.packed_foldm(fs), mr.qtable.astype(np.uint32),
                                              mr.c_limbs.astype(np.uint32), mr.np_limbs.astype(np.uint32))]


def _host_mul(lib, entry: str, fs, mode: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n, mr, consts = a.shape[0], fs.mulred, _consts(fs)
    out = torch.full((n, fs.limbs), -1, dtype=torch.int32)
    rc = getattr(lib, entry)(mode, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, fs.limbs,
                             *(c.ctypes.data for c in consts), mr.n_split, mr.shift_e)
    assert rc == 0
    return out


def _col_caps(L):
    """The admission proof's column caps of an unnormalized L-limb product."""
    def n_lo(c):
        return 0 if c < 0 or c > 2 * L - 2 else L - abs(c - (L - 1))
    return [(n_lo(c) + n_lo(c - 1)) * 0xFFFF for c in range(2 * L)]


@pytest.mark.parametrize("fs", ALL_FIELDS, ids=[fs.name for fs in ALL_FIELDS])
def test_host_warp_fold_matches_dp4a(host_lib, fs):
    """mxu_warp.cuh's warp multiply (staging, the mma fragments as the ISA
    lays them out, the read-back) against mxu.cuh's dp4a lane: at every
    pair of field edges and 8 random pairs (a lane count that is not a
    multiple of 32: the last warp's spare lanes store nothing), and from
    the admission proof's worst columns (every digit at its cap), where a
    sum off by one index would show."""
    a, b = edge_operands(fs, 9, 2)
    ta, tb = (to_torch(jfh.encode(fs, col)) for col in (a, b))
    assert len(a) % 32
    warp = _host_mul(host_lib, "host_mxu_warp_mod_mul", fs, 0, ta, tb)
    assert torch.equal(warp, _host_mul(host_lib, "host_mxu_mod_mul", fs, 0, ta, tb))
    assert torch.equal(warp, tfd._mul_gemm(fs, ta, tb))
    assert [int(v) for v in jfh.decode(fs, warp.numpy().astype(np.uint32))] == [
        x * y % fs.modulus for x, y in zip(a, b)]
    L = fs.limbs
    caps = _col_caps(L)
    full = [(caps[c] >> 16 << 16) | 0xFFFF if c >= L - 1 else caps[c] for c in range(2 * L)]
    rng = np.random.default_rng(4)
    rows = [full, caps, [min(v, 0xFFFF) for v in caps], [0] * (2 * L - 1) + [caps[-1]]]
    rows += [[int(rng.integers(0, cap + 1)) for cap in caps] for _ in range(33)]
    cols = torch.tensor(rows, dtype=torch.int64).to(torch.int32)
    warp = _host_mul(host_lib, "host_mxu_warp_mod_mul", fs, 1, cols, cols)
    assert torch.equal(warp, _host_mul(host_lib, "host_mxu_mod_mul", fs, 1, cols, cols))
    want = [sum(v << (LIMB_BITS * c) for c, v in enumerate(row)) % fs.modulus for row in rows]
    assert [int(v) for v in jfh.decode(fs, warp.numpy().astype(np.uint32))] == want


def _host_batch_inv(lib, fs, x: torch.Tensor) -> torch.Tensor:
    """mxu_batch_inv's column chain over warps of 32 columns, the columns
    padded with ones as the wrapper pads them; the padding dropped after
    checking that it inverted to ones."""
    rows, cols, L = x.shape
    pad = (-cols) % mk.WARP
    xs = torch.cat([x, tfd.ones(fs, (rows, pad), device="cpu")], dim=1).contiguous()
    out = torch.full_like(xs, -1)
    chain, npow = fk.inv_chain(fs)
    table = torch.tensor(chain, dtype=torch.int32)
    mr, consts = fs.mulred, _consts(fs)
    rc = lib.host_mxu_batch_inv(xs.data_ptr(), out.data_ptr(), rows, xs.shape[1], L, *(c.ctypes.data for c in consts),
                                mr.n_split, mr.shift_e, table.data_ptr(), len(table), npow)
    assert rc == 0
    assert torch.equal(out[:, cols:], xs[:, cols:])
    return out[:, :cols]


@pytest.mark.parametrize("fs", BASE_FIELDS, ids=[fs.name for fs in BASE_FIELDS])
def test_host_mxu_batch_inv_column_matches_plain(host_lib, fs):
    """The column chain with every multiply a warp's tensor-core
    multiply-reduce, at the edge columns (a zero column reads 0), k = 1 and
    16 rows, against the plain version; the inverses times the inputs are
    one."""
    for x in (_edge_columns(fs, 5), _nonzero(fs, 6, (1, 3)), _nonzero(fs, 7, (16, 2))):
        got = _host_batch_inv(host_lib, fs, x)
        assert torch.equal(got, mk.mxu_batch_inv_plain(fs, x)), tuple(x.shape)
    x = _nonzero(fs, 7, (16, 2))
    got = _host_batch_inv(host_lib, fs, x)
    assert torch.equal(tfd.mul(fs, got, x), tfd.ones(fs, (16, 2), device="cpu"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fs", BASE_FIELDS, ids=[fs.name for fs in BASE_FIELDS])
def test_cuda_mxu_batch_inv_matches_plain(cuda, fs):
    """One launch a call, equal to the plain version at the edge columns,
    16 rows and k = 1."""
    kernel = mk.batch_inv_kernel_for(fs)
    for x in (_edge_columns(fs, 8), _nonzero(fs, 9, (16, 40)), _nonzero(fs, 10, (1, 5))):
        before = kernel.launches
        got = mk.mxu_batch_inv(fs, x.to(cuda))
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(got.cpu(), mk.mxu_batch_inv_plain(fs, x))
