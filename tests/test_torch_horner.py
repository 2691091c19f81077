"""The one-launch Horner kernels: pt_ladder_horner (eval_point_poly),
mod_madd_horner (eval_many) and mod_madd_dot (_field_dot).

On the CPU: their plain versions against the loops of the one-step
plain versions and against the JAX package's eval_point_poly, eval_many
and _field_dot on all three curves, at small shapes (T <= 4) with x = 0
and 2^nbits - 1, identity coefficients and field-edge values, by exact
equality; the fact the point kernel's leading-zero skip rests on
(doubling fixes the stored identity on the Weierstrass curves, not on
ristretto255); and the kernels' lane bodies built from
csrc/host_check.cpp with the host compiler (the point kernel's TPI
threads a lane as TPI host threads), at every group size the source
takes, with the coefficients staged once or read per lane, against the
plain versions and host big-int oracles.  On a CUDA machine (marker
``cuda``; skipped elsewhere): the kernels themselves."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import edge_operands, field_limbs, point_limbs, same, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.dkg import ceremony as jce
from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import device as jgd
from dkg_tpu.groups import host as jgh
from dkg_tpu.poly import device as jpd
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.fields.spec import BLS12_381_P, BLS12_381_R, L25519, P25519, SECP256K1_N, SECP256K1_P
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import field_kernels as fk
from dkg_tpu_torch.ops import point_kernels as pk
from dkg_tpu_torch.poly import device as tpd

CURVES = ["secp256k1", "ristretto255", "bls12_381_g1"]
FIELDS = {  # field -> id of csrc/field.cuh
    "secp256k1_base": (SECP256K1_P, 0), "secp256k1_scalar": (SECP256K1_N, 1), "ed25519_base": (P25519, 2),
    "ed25519_scalar": (L25519, 3), "bls12_381_base": (BLS12_381_P, 4), "bls12_381_scalar": (BLS12_381_R, 5),
}
HOST_CURVE = {"secp256k1": 0, "bls12_381_g1": 1, "ristretto255": 2}  # host_pt_ladder_horner's ids
PTR, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _cs(curve):
    return tgd.ALL_CURVES[curve], jgd.ALL_CURVES[curve]


def _coeffs(curve, seed, batch: tuple, T: int) -> np.ndarray:
    """(*batch, T, C, L) points with identities and edge-lambda scalings."""
    n = int(np.prod(batch, dtype=int)) * T
    pts = point_limbs(curve, seed, n, edge_lambdas=True)
    return pts.reshape(batch + (T,) + pts.shape[1:])


def _xs(nbits: int, n: int) -> np.ndarray:
    """n public x in [0, 2^nbits): 0 and 2^nbits - 1 first."""
    rest = np.random.default_rng(nbits).integers(0, 1 << nbits, size=n)
    return np.concatenate([[0, (1 << nbits) - 1], rest])[:n].astype(np.uint32)


def _one_step_ladders(cs, coeffs, x, nbits):
    acc = pk.identity_plain(cs, torch.broadcast_shapes(coeffs.shape[:-3], x.shape), "cpu")
    for l in reversed(range(coeffs.shape[-3])):
        acc = pk.pt_ladder_mul_add_plain(cs, acc, coeffs[..., l, :, :], x, nbits)
    return acc


@pytest.mark.parametrize("curve", CURVES)
def test_doubling_fixes_the_identity_only_on_weierstrass(curve):
    """The leading-zero skip of pt_ladder_horner (csrc/group.cuh
    ladder_horner_lane) rests on this: RCB15 doubling maps the stored
    identity (0:1:0) to itself limb for limb; hwcd doubling maps (0:1:1:0)
    to (0:-1:-1:0), so the Edwards kernel keeps its leading doublings."""
    cs, _ = _cs(curve)
    ident = pk.identity_plain(cs, (), "cpu")
    doubled = pk.pt_double_plain(cs, ident)
    if curve == "ristretto255":
        p = cs.field.modulus
        want = tgd.from_host(cs, [(0, p - 1, p - 1, 0)], device="cpu")[0]
        assert torch.equal(doubled, want) and not torch.equal(doubled, ident)
    else:
        assert torch.equal(doubled, ident)
        assert torch.equal(pk.pt_double_plain(cs, ident, 11), ident)


@pytest.mark.parametrize("curve", CURVES)
def test_ladder_horner_plain_is_the_one_step_loop(curve):
    """Shared and per-lane coefficients, x = 0 and 2^nbits - 1."""
    cs, _ = _cs(curve)
    nbits = 3
    x = torch.from_numpy(_xs(nbits, 4).astype(np.int32))
    for coeffs in (to_torch(_coeffs(curve, 1, (), 3)), to_torch(_coeffs(curve, 2, (4,), 2))):
        assert torch.equal(pk.pt_ladder_horner(cs, coeffs, x, nbits), _one_step_ladders(cs, coeffs, x, nbits))
    assert torch.equal(pk.pt_ladder_horner(cs, coeffs[:, :0], x, nbits), pk.identity_plain(cs, (4,), "cpu"))


@pytest.mark.parametrize("curve", CURVES)
def test_eval_point_poly_matches_jax_at_the_edges(curve):
    """verify_pairwise's shape, (dealers, 1, T) coefficients with identity
    entries and edge scalings at x (dealers, recipients) including 0 and
    2^nbits - 1, against the JAX package's eval_point_poly."""
    tcs, jcs = _cs(curve)
    nbits = 2
    coeffs = _coeffs(curve, 3, (2, 1), 2)
    x = np.stack([_xs(nbits, 4), _xs(nbits, 4)[::-1]])
    got = tgd.eval_point_poly(tcs, to_torch(coeffs), torch.from_numpy(x.astype(np.int32)), nbits)
    assert same(got, jgd.eval_point_poly(jcs, jnp.asarray(coeffs), jnp.asarray(x), nbits))


@pytest.mark.parametrize("curve", CURVES)
def test_field_horner_and_dot_match_jax_at_the_edges(curve):
    """eval_many (per-row coefficients over shared points, and shared ones
    over per-row points) and _field_dot on the scalar field's edge values,
    against the JAX package's, and their plain versions against the loops
    of mod_madd's."""
    tcs, jcs = _cs(curve)
    fs, jfs = tcs.scalar, jcs.scalar
    a, b, c = edge_operands(fs, 9, 3)
    enc = lambda v: jfh.encode(fs, list(v))  # noqa: E731
    coeffs, xs = enc(a[:12]).reshape(3, 4, -1), enc(b[:5])
    got = tpd.eval_many(fs, to_torch(coeffs), to_torch(xs))
    assert same(got, jpd.eval_many(jfs, jnp.asarray(coeffs), jnp.asarray(xs)))
    loop = torch.zeros((3, 5, fs.limbs), dtype=torch.int32)
    for l in reversed(range(4)):
        loop = fk.mod_madd_plain(fs, loop, to_torch(xs), to_torch(coeffs)[:, l, None, :])
    assert torch.equal(got, loop)
    shared, per_row = enc(c[:2]), enc(b[5:17]).reshape(3, 4, -1)
    got = tpd.eval_many(fs, to_torch(shared), to_torch(per_row))
    assert same(got, jpd.eval_many(jfs, jnp.asarray(shared), jnp.asarray(per_row)))
    w, v = enc(a[:6]), enc(c[:18]).reshape(6, 3, -1)
    got = tce._field_dot(fs, to_torch(w), to_torch(v))
    assert same(got, jce._field_dot(jfs, jnp.asarray(w), jnp.asarray(v)))
    loop = torch.zeros((3, fs.limbs), dtype=torch.int32)
    for j in range(6):
        loop = fk.mod_madd_plain(fs, to_torch(w)[j], to_torch(v)[j], loop)
    assert torch.equal(got, loop)


# ---------------------------------------------------------------------------
# the lane bodies, built for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/host_check.cpp")
    out = tmp_path_factory.mktemp("host_check") / "host_check.so"
    subprocess.run([cxx, "-O0", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o", str(out),
                    str(build.CSRC / "host_check.cpp")], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(out))


def _host_ladder(host_lib, curve, tpi, coeffs, x, nbits, staged):
    """host_pt_ladder_horner: coeffs (rows, T, C, L), x (n,), rows 1 or n."""
    cs, _ = _cs(curve)
    rows, T = coeffs.shape[:2]
    coeffs, x = coeffs.contiguous(), x.contiguous()
    out = torch.empty((len(x), cs.ncoords, cs.field.limbs), dtype=torch.int32)
    fn = host_lib.host_pt_ladder_horner
    fn.argtypes = [INT, INT, PTR, I64, I64, PTR, PTR, I64, INT, INT, INT]
    fn.restype = INT
    assert fn(HOST_CURVE[curve], tpi, coeffs.data_ptr(), rows, len(x) // rows, x.data_ptr(), out.data_ptr(),
              len(x), T, nbits, int(staged)) == 0
    return out


LADDER_CASES = [(c, tpi, staged) for c in CURVES for tpi in ((2, 4) if c == "bls12_381_g1" else (2, 4, 8))
                for staged in (True, False)]


@pytest.mark.parametrize("case", LADDER_CASES, ids=[f"{c}-tpi{t}-{'staged' if s else 'per_lane'}"
                                                    for c, t, s in LADDER_CASES])
def test_host_compiled_ladder_horner_matches_plain(host_lib, case):
    """pt_ladder_horner's lane body (group.cuh) with its TPI ranks as host
    threads: shared coefficients staged once as Montgomery words, or
    per-lane ones converted at each step; identity coefficients, edge
    scalings, x = 0 and 2^nbits - 1."""
    curve, tpi, staged = case
    cs, _ = _cs(curve)
    nbits, n, T = 4, 6, 3
    x = torch.from_numpy(_xs(nbits, n).astype(np.int32))
    coeffs = to_torch(_coeffs(curve, 10 + tpi, (1,) if staged else (n,), T))
    want = pk.pt_ladder_horner_plain(cs, coeffs[0] if staged else coeffs, x, nbits)
    assert torch.equal(_host_ladder(host_lib, curve, tpi, coeffs, x, nbits, staged), want)


@pytest.mark.parametrize("curve", CURVES)
def test_host_compiled_ladder_horner_reaches_the_host_oracle(host_lib, curve):
    """At the ceremony's width (nbits = 11, x up to 2047) the lane body's
    Σ_l x^l (k_l G) equals (Σ_l x^l k_l) G by the big-int group law."""
    g = jgh.ALL_GROUPS[curve]
    cs, _ = _cs(curve)
    ks = [3, 0, 5]  # a zero coefficient: the identity
    pts = [g.scalar_mul(k, g.generator()) for k in ks]
    coeffs = tgd.from_host(cs, pts, device="cpu")[None]
    xs = [0, 1, 1024, 2047]
    out = _host_ladder(host_lib, curve, 4, coeffs, torch.tensor(xs, dtype=torch.int32), 11, True)
    q = g.scalar_field.modulus
    for got, x in zip(tgd.to_host(cs, out), xs):
        want = g.scalar_mul(sum(k * x**i for i, k in enumerate(ks)) % q, g.generator())
        assert g.eq(got, want)


@pytest.mark.parametrize("name", list(FIELDS))
def test_host_compiled_field_horner_and_dot_match_plain(host_lib, name):
    """mod_madd_horner's lane body over T = 130 coefficients (two of the
    kernel's 128-coefficient chunks), with per-row and shared coefficients,
    and mod_madd_dot's slices and their sum, at every pair of field edges,
    against the plain versions."""
    fs, fid = FIELDS[name]
    L, T = fs.limbs, 130
    a, b = edge_operands(fs, 4, 2)
    co = to_torch(jfh.encode(fs, (a * 3)[: 2 * T])).reshape(2, T, L)
    xs = to_torch(jfh.encode(fs, b[:14])).reshape(2, 7, L)
    out = torch.empty((2, 7, L), dtype=torch.int32)
    fn = host_lib.host_mod_madd_horner
    fn.argtypes = [PTR, I64, PTR, I64, PTR, I64, I64, INT, INT]
    fn.restype = INT
    for stride, c in ((T * L, co), (0, co[0])):
        assert fn(co.data_ptr(), stride, xs.data_ptr(), 7 * L, out.data_ptr(), 2, 7, T, fid) == 0
        assert torch.equal(out, fk.mod_madd_horner_plain(fs, c, xs))
    m, K = 20, 9
    w = to_torch(jfh.encode(fs, a[:m]))
    v = to_torch(jfh.encode(fs, (b * 3)[: m * K])).reshape(m, K, L)
    dot = torch.empty((K, L), dtype=torch.int32)
    fn = host_lib.host_mod_madd_dot
    fn.argtypes = [PTR, PTR, PTR, I64, I64, INT, INT]
    fn.restype = INT
    assert fn(w.data_ptr(), v.data_ptr(), dot.data_ptr(), m, K, 8, fid) == 0
    assert torch.equal(dot, fk.mod_madd_dot_plain(fs, w, v))
    want = [sum(int(x) * int(y) for x, y in zip(jfh.decode(fs, w.numpy().astype(np.uint32)),
                                                 jfh.decode(fs, v[:, k].numpy().astype(np.uint32)))) % fs.modulus
            for k in range(K)]
    assert [int(z) for z in jfh.decode(fs, dot.numpy().astype(np.uint32))] == want


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_multi_step_kernels_per_curve_and_field():
    """Each curve and field has its own multi-step kernel and launch count;
    the point kernels build from csrc/ladder_kernels.cu, the field ones
    from csrc/field_kernels.cu, and every one is in its module's KERNELS."""
    ladders = {pk.kernel_for("pt_ladder_horner", tgd.ALL_CURVES[c]) for c in CURVES}
    assert ladders == {pk.PT_LADDER_HORNER, pk.ED_PT_LADDER_HORNER, pk.BLS_PT_LADDER_HORNER}
    assert {k.source for k in ladders} == {"ladder_kernels.cu"} and ladders <= set(pk.KERNELS)
    for fs, _ in FIELDS.values():
        h, d = fk.horner_kernel_for(fs), fk.dot_kernel_for(fs)
        assert {h.source, d.source} == {"field_kernels.cu"} and {h, d} <= set(fk.KERNELS)
        assert h is not fk._FIELDS[fs][0] and d is not h
    assert fk.horner_kernel_for(BLS12_381_R) is fk.MOD_MADD_HORNER_BLS
    assert fk.dot_kernel_for(L25519) is fk.MOD_MADD_DOT_ED


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
def test_cuda_multi_step_kernels_match_plain(cuda, curve):
    cs, _ = _cs(curve)
    nbits = 4
    x = torch.from_numpy(_xs(nbits, 6).astype(np.int32))
    for coeffs in (to_torch(_coeffs(curve, 20, (), 3)), to_torch(_coeffs(curve, 21, (6,), 2))):
        kernel = pk.kernel_for("pt_ladder_horner", cs)
        before = kernel.launches
        got = pk.pt_ladder_horner(cs, coeffs.to(cuda), x.to(cuda), nbits)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(got.cpu(), pk.pt_ladder_horner_plain(cs, coeffs, x, nbits))
    fs = cs.scalar
    co, xs = to_torch(field_limbs(fs, 22, 12)).reshape(3, 4, -1), to_torch(field_limbs(fs, 23, 5))
    assert torch.equal(fk.mod_madd_horner(fs, co.to(cuda), xs.to(cuda)).cpu(), fk.mod_madd_horner_plain(fs, co, xs))
    w, v = to_torch(field_limbs(fs, 24, 6)), to_torch(field_limbs(fs, 25, 18)).reshape(6, 3, -1)
    assert torch.equal(fk.mod_madd_dot(fs, w.to(cuda), v.to(cuda)).cpu(), fk.mod_madd_dot_plain(fs, w, v))
