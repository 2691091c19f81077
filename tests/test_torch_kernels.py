"""The CUDA kernels' arithmetic against their plain PyTorch versions.

On the CPU: csrc/host_check.cpp, the kernels' per-lane bodies (the same
field.cuh and point.cuh code the .cu kernels run), built with the host
compiler and called lane by lane.  On a CUDA machine (marker ``cuda``;
skipped elsewhere): the kernels themselves, built with nvcc.  Both are
held to the plain versions bit for bit."""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch_port_util import field_limbs, point_limbs

from dkg_tpu.groups import host as jgh
from dkg_tpu_torch.fields.spec import SECP256K1_N, SECP256K1_P
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import field_kernels as fk
from dkg_tpu_torch.ops import point_kernels as pk

CS = tgd.SECP256K1
LANES = 40
PTR, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/host_check.cpp")
    out = tmp_path_factory.mktemp("host_check") / "host_check.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
                    str(build.CSRC / "host_check.cpp")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(out))


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr).astype(np.int32)))


def _inputs(name):
    """(plain function, operand tensors, extra int args) for one kernel."""
    p, q = _t(point_limbs("secp256k1", 1, LANES)), _t(point_limbs("secp256k1", 2, LANES))
    q[4] = p[4]  # doubling through the complete add
    if name.startswith("mod_madd"):
        fs = SECP256K1_P if name.endswith("base") else SECP256K1_N
        ops = [_t(field_limbs(fs, s, LANES)) for s in (3, 4, 5)]
        return (lambda a, b, c: fk.mod_madd_plain(fs, a, b, c)), ops, [0 if fs is SECP256K1_P else 1]
    if name == "pt_add":
        return (lambda a, b: pk.pt_add_plain(CS, a, b)), [p, q], []
    if name == "pt_madd":
        qa = _t(point_limbs("secp256k1", 6, LANES * 2, projective=False))
        qa = qa[qa[:, 2, 0] == 1][:LANES]  # affine, non-identity
        return (lambda a, b: pk.pt_madd_plain(CS, a, b)), [p, qa], []
    if name == "pt_window_step":
        return (lambda a, b: pk.pt_window_step_plain(CS, a, b, 4)), [p, q], [4]
    x = torch.tensor([random.Random(7).randrange(1 << 11) for _ in range(LANES)], dtype=torch.int32)
    x[:3] = torch.tensor([0, 1, (1 << 11) - 1])
    return (lambda a, b, c: pk.pt_ladder_mul_add_plain(CS, a, b, c, 11)), [p, q, x], [11]


NAMES = ["mod_madd_base", "mod_madd_scalar", "pt_add", "pt_madd", "pt_window_step", "pt_ladder_mul_add"]


@pytest.mark.parametrize("name", NAMES)
def test_host_compiled_lane_bodies_match_plain(host_lib, name):
    plain, ops, extra = _inputs(name)
    want = plain(*ops)
    out = torch.empty_like(want)
    fn = getattr(host_lib, "host_" + name.removesuffix("_base").removesuffix("_scalar"))
    fn.argtypes = [PTR] * (len(ops) + 1) + [I64] + [INT] * len(extra)
    fn.restype = None
    fn(*(o.data_ptr() for o in ops), out.data_ptr(), len(ops[0]), *extra)
    assert torch.equal(out, want)


def test_host_compiled_ladder_reaches_the_host_oracle(host_lib):
    """x·P + A from the lane body equals the big-int group law."""
    g = jgh.SECP256K1
    pts = [g.scalar_mul(k, g.generator()) for k in (3, 5)]
    p, a = (_t(np.stack([np.asarray(tgd.from_host(CS, [pt], device="cpu")[0])])) for pt in pts)
    x = torch.tensor([1000], dtype=torch.int32)
    out = torch.empty_like(p)
    fn = host_lib.host_pt_ladder_mul_add
    fn.argtypes = [PTR] * 4 + [I64, INT]
    fn(p.data_ptr(), a.data_ptr(), x.data_ptr(), out.data_ptr(), 1, 11)
    got = tgd.to_host(CS, out)[0]
    assert g.eq(got, g.scalar_mul(1000 * 3 + 5, g.generator()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_kernels_match_plain(cuda, name):
    plain, ops, extra = _inputs(name)
    ops = [o.to(cuda) for o in ops]
    if name.startswith("mod_madd"):
        fs = SECP256K1_P if name.endswith("base") else SECP256K1_N
        kernel, got = fk.MOD_MADD, None
        before = kernel.launches
        got = fk.mod_madd(fs, *ops)
    else:
        kernel = {k.name: k for k in pk.KERNELS}[name]
        before = kernel.launches
        wrapper = getattr(pk, name)
        got = wrapper(CS, *ops, *extra) if extra else wrapper(CS, *ops)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got.cpu(), plain(*(o.cpu() for o in ops)))
