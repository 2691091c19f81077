"""pt_scalar_mul: every window of groups.device.scalar_mul in one launch.

On the CPU: the kernel's lane body (chain.cuh scalar_mul_lane) built from
csrc/host_check.cpp with the host compiler, on all three curves, at one
thread a lane and on the curve's group of threads, against
the plain version (the window loop of pt_window_step_plain) through the
wrapper's own table layout (pk.table_rows: a recipient's table read by
every dealer, a table shared by every lane, one table a dealer), at k = 0,
1, order - 1 and scalars with all-zero digit windows, over the identity's
table and projective points; and the lane map itself against an expanded
copy.  gd.scalar_mul against the JAX package, a table a lane and the KEM's
shared tables, is in test_torch_scalar_mul.py.  On a CUDA machine (marker
``cuda``; skipped elsewhere): the kernel itself.  Everything by exact
equality."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch_port_util import field_limbs, point_limbs, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import point_kernels as pk

CURVES = ["secp256k1", "ristretto255", "bls12_381_g1"]
HOST_CURVE = {"secp256k1": 0, "bls12_381_g1": 1, "ristretto255": 2}  # host_check's curve ids
GROUP_TPI = {"secp256k1": 8, "bls12_381_g1": 4, "ristretto255": 8}  # chain_kernels.cu's DKG_CHAIN_TPI_*
PTR, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/host_check.cpp")
    out = tmp_path_factory.mktemp("host_check") / "host_check.so"
    subprocess.run([cxx, "-O0", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o", str(out),
                    str(build.CSRC / "host_check.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.host_pt_scalar_mul.argtypes = [INT, INT, PTR, I64, I64, PTR, PTR, I64, INT, INT, INT]
    lib.host_pt_scalar_mul.restype = INT
    return lib


def _scalars(cs, seed: int, shape: tuple) -> torch.Tensor:
    """Scalars (*shape, L): 0, 1, 2, order - 1, ... (field_limbs' edges),
    then random ones, every third with its odd digit windows zeroed and
    the last all zero but its lowest window."""
    n = int(np.prod(shape, dtype=int))
    k = field_limbs(cs.scalar, seed, n)
    k[4::3] &= 0x0F0F
    k[-1] = 0
    k[-1, 0] = 0x000B
    return to_torch(k).reshape(shape + (cs.scalar.limbs,))


def _tables(curve, seed: int, n: int) -> torch.Tensor:
    """n window tables (n, 16, C, L) of projective points, the first the
    identity's."""
    cs = tgd.ALL_CURVES[curve]
    pts = to_torch(point_limbs(curve, seed, n, edge_lambdas=True))
    pts[0] = pk.identity_plain(cs, (), "cpu")
    return tgd._build_table(cs, pts)


def test_table_rows_map_every_lane_to_its_table():
    """pk.table_rows over the layouts scalar_mul gives it: each lane's row
    is the expanded table's, and only a broadcast axis between two
    non-broadcast ones is copied."""
    tail = (16, 3, 2)
    for tshape, batch, want in (((5,), (2, 5), (5, 1)), ((), (2, 5), (1, 10)), ((2, 1), (2, 5), (2, 5)),
                                ((2, 1, 3, 1), (2, 4, 3, 7), (24, 7)), ((4,), (4,), (4, 1))):
        t = torch.arange(int(np.prod(tshape + tail)), dtype=torch.int32).reshape(tshape + tail)
        rows, n_rows, per_row = pk.table_rows(t, batch, tail)
        full = t.expand(batch + tail).reshape((-1,) + tail)
        assert (n_rows, per_row) == want and rows.shape == (n_rows,) + tail, tshape
        assert all(torch.equal(rows[(i // per_row) % n_rows], full[i]) for i in range(full.shape[0])), tshape


def _host_scalar_mul(lib, curve, tpi, t, k):
    """pt_scalar_mul's launch on the host: tables t and scalars k laid out
    as the wrapper lays them."""
    cs = tgd.ALL_CURVES[curve]
    point = (cs.ncoords, cs.field.limbs)
    rows, n_rows, per_row = pk.table_rows(t, k.shape[:-1], (16,) + point)
    ks = k.reshape(-1, k.shape[-1]).contiguous()
    out = torch.full((ks.shape[0],) + point, -1, dtype=torch.int32)
    assert lib.host_pt_scalar_mul(HOST_CURVE[curve], tpi, rows.data_ptr(), n_rows, per_row, ks.data_ptr(),
                                  out.data_ptr(), ks.shape[0], ks.shape[-1] * 4, 4, ks.shape[-1]) == 0
    return out


@pytest.mark.parametrize("curve", CURVES)
def test_host_compiled_scalar_mul_matches_plain(host_lib, curve):
    """scalar_mul_lane at 4-bit windows over three layouts of the wrapper
    (3 recipients' tables read by 2 dealers each, the first table the
    identity's; one table shared by 6 lanes; 2 dealers' tables each read by
    3 lanes), k = 0, 1, order - 1 and zero digit windows among the
    scalars, against the plain version of the same lanes; and on the
    curve's group of threads (host fibers) over 3 lanes with a table a
    lane (a warp's groups past the last lane store nothing)."""
    cs = tgd.ALL_CURVES[curve]
    tables = _tables(curve, 3, 3)  # (3, 16, C, L)
    k = _scalars(cs, 4, (2, 3))
    layouts = [(tables, k), (tables[1], k.reshape(6, -1)), (tables[:2, None], k)]
    want = pk.pt_scalar_mul_plain(cs, torch.cat([t.expand(kk.shape[:-1] + t.shape[-3:]).reshape(-1, *t.shape[-3:])
                                                 for t, kk in layouts]),
                                  torch.cat([kk.reshape(-1, kk.shape[-1]) for _, kk in layouts]))
    got = torch.cat([_host_scalar_mul(host_lib, curve, 1, t, kk) for t, kk in layouts])
    assert torch.equal(got, want)
    assert torch.equal(want[0], pk.identity_plain(cs, (), "cpu")) or cs.kind == "edwards"  # k = 0
    grouped = _host_scalar_mul(host_lib, curve, GROUP_TPI[curve], tables, k.reshape(6, -1)[:3])
    assert torch.equal(grouped, want[:3])


def test_scalar_mul_lane_rule():
    """A group of threads a lane at a recipient's opens (1024 or 256
    lanes) and a default seal chunk's KEM (4096 lanes), one thread a lane
    at the unchunked KEM's 65,536 and more, on every curve."""
    for curve in CURVES:
        cs = tgd.ALL_CURVES[curve]
        assert pk.scalar_mul_group(cs, 1024) and pk.scalar_mul_group(cs, 256) and pk.scalar_mul_group(cs, 4096)
        assert not pk.scalar_mul_group(cs, 1 << 16) and not pk.scalar_mul_group(cs, 1 << 20)


def test_scalar_mul_is_one_pt_scalar_mul(monkeypatch):
    """gd.scalar_mul builds the points' own tables and hands them, with the
    scalars, to pt_scalar_mul (no window step of its own)."""
    calls = []
    real = pk.pt_scalar_mul
    monkeypatch.setattr(pk, "pt_scalar_mul", lambda cs, t, k: calls.append((tuple(t.shape), tuple(k.shape)))
                        or real(cs, t, k))
    monkeypatch.setattr(pk, "pt_window_step", lambda *a: pytest.fail("a window step outside pt_scalar_mul"))
    cs = tgd.RISTRETTO255
    pts = to_torch(point_limbs("ristretto255", 5, 3))
    k = _scalars(cs, 6, (2, 3))
    out = tgd.scalar_mul(cs, k, pts)
    assert out.shape == (2, 3, 4, 16)
    assert calls == [((3, 16, 4, 16), (2, 3, 16))]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("curve", CURVES)
def test_cuda_scalar_mul_matches_plain(cuda, curve, monkeypatch):
    """One launch a call over the KEM's layout (tables shared by dealers),
    at one thread a lane and in a group (the lane rule forced either way),
    equal to the plain version."""
    cs = tgd.ALL_CURVES[curve]
    tables = _tables(curve, 7, 3)
    k = _scalars(cs, 8, (2, 3))
    want = pk.pt_scalar_mul_plain(cs, tables, k)
    kernel = pk.kernel_for("pt_scalar_mul", cs)
    for group in (False, True):
        monkeypatch.setitem(pk.SCALAR_MUL_GROUP_BELOW, (cs.kind, cs.field.name, cs.const), 1 << 62 if group else 0)
        before = kernel.launches
        got = pk.pt_scalar_mul(cs, tables.to(cuda), k.to(cuda))
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(got.cpu(), want), group
