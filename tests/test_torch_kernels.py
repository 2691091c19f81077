"""The CUDA kernels' arithmetic against their plain PyTorch versions.

On the CPU: csrc/host_check.cpp, the kernels' per-lane bodies (the same
field.cuh, point.cuh and edwards.cuh code the .cu kernels run), built
with the host compiler and called lane by lane, at the field edge values
(0, 1, m - 1, near 2**255 and 2**256 - 1, near 2**383 and 2**384 - 1 at
24 limbs) of all six fields, the Barrett fields' worst cases, the
bucket kernels' per-bucket fold over every bucket of small scatter
passes, for secp256k1, ristretto255 and BLS12-381 G1 (the Edwards
window step at k = 0, 1, 4 and 8), and mod_mul and
the fused multiply-reduce of mxu_mod_mul (csrc/mxu.cuh) over all six
fields, the latter also at the worst cases of its admission proof.  On a CUDA machine (marker ``cuda``; skipped elsewhere): the
kernels themselves, built with nvcc.  Both are held to the plain versions
bit for bit."""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch_port_util import edge_ints, edge_operands, point_limbs
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import host as jgh
from dkg_tpu_torch.fields.spec import BLS12_381_P, BLS12_381_R, L25519, P25519, SECP256K1_N, SECP256K1_P
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.ops import bucket_kernels as bk
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.fields import device as tfd
from dkg_tpu_torch.fields.spec import LIMB_BITS, int_to_limbs
from dkg_tpu_torch.ops import field_kernels as fk
from dkg_tpu_torch.ops import mxu_kernels as mk
from dkg_tpu_torch.ops import point_kernels as pk

CS, ED, BLS = tgd.SECP256K1, tgd.RISTRETTO255, tgd.BLS12_381_G1
# case prefix -> (curve, CurveSpec, host_check prefix)
PREFIXES = {"": ("secp256k1", CS, "host_"), "ed_": ("ristretto255", ED, "host_ed_"),
            "bls_": ("bls12_381_g1", BLS, "host_bls_")}
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


FIELD_CASES = {  # case -> (field, field id of csrc/field.cuh)
    "mod_madd_base": (SECP256K1_P, 0),
    "mod_madd_scalar": (SECP256K1_N, 1),
    "mod_madd_ed_base": (P25519, 2),
    "mod_madd_ed_scalar": (L25519, 3),
    "mod_madd_bls_base": (BLS12_381_P, 4),
    "mod_madd_bls_scalar": (BLS12_381_R, 5),
}


def _points(curve, seed, n=LANES, projective=True):
    return _t(point_limbs(curve, seed, n, projective=projective, edge_lambdas=projective))


def _affine_points(curve, seed):
    """Affine points; Weierstrass ones without the identity (the mixed
    add does not take it), the Edwards identity (0, 1, 1, 0) kept."""
    qa = _points(curve, seed, LANES * 2, projective=False)
    if curve != "ristretto255":
        qa = qa[qa[:, 2, 0] == 1]
    return qa[:LANES]


def _ladder_x(nbits):
    x = torch.tensor([random.Random(7).randrange(1 << nbits) for _ in range(LANES)], dtype=torch.int32)
    x[:3] = torch.tensor([0, 1, (1 << nbits) - 1])
    return x


def _op(case):
    """The wrapper of a point case: pt_double_1 and pt_double_4 are pt_double."""
    return case.removesuffix("_1").removesuffix("_4")


def _split(name):
    """A point case's (curve, CurveSpec, host_check prefix, op)."""
    prefix = next((k for k in ("ed_", "bls_") if name.startswith(k)), "")
    return (*PREFIXES[prefix], name.removeprefix(prefix))


def _inputs(name):
    """(plain function, operand tensors, extra int args, host_check entry)
    for one kernel case."""
    if name in FIELD_CASES:
        fs, fid = FIELD_CASES[name]
        ops = [_t(jfh.encode(fs, col)) for col in edge_operands(fs, 3, 3)]
        return (lambda a, b, c: fk.mod_madd_plain(fs, a, b, c)), ops, [fid], "host_mod_madd"
    curve, cs, host, op = _split(name)
    host += _op(op)
    p, q = _points(curve, 1), _points(curve, 2)
    q[4] = p[4]  # doubling through the complete add
    if op == "pt_add":
        return (lambda a, b: pk.pt_add_plain(cs, a, b)), [p, q], [], host
    if op == "pt_madd":
        return (lambda a, b: pk.pt_madd_plain(cs, a, b)), [p, _affine_points(curve, 6)], [], host
    if op in ("pt_double_1", "pt_double_4"):
        k = int(op[-1])
        return (lambda a: pk.pt_double_plain(cs, a, k)), [p], [k], host
    if op == "pt_window_step":
        return (lambda a, b: pk.pt_window_step_plain(cs, a, b, 4)), [p, q], [4], host
    nbits = 11
    return (lambda a, b, c: pk.pt_ladder_mul_add_plain(cs, a, b, c, nbits)), [p, q, _ladder_x(nbits)], [nbits], host


_WS_OPS = ["pt_add", "pt_madd", "pt_window_step", "pt_ladder_mul_add", "pt_double_1", "pt_double_4"]
NAMES = [*FIELD_CASES, *_WS_OPS, "ed_pt_add", "ed_pt_madd", "ed_pt_double_1", "ed_pt_double_4",
         "ed_pt_ladder_mul_add", *("bls_" + op for op in _WS_OPS)]


# scatter passes: (curve, window, digits shared by the batch)
BUCKET_CASES = [("secp256k1", 4, True), ("secp256k1", 8, False), ("ristretto255", 4, False),
                ("ristretto255", 8, True), ("bls12_381_g1", 4, True), ("bls12_381_g1", 8, False)]
BUCKET_IDS = [f"{c}-w{w}-{'shared' if s else 'per_row'}" for c, w, s in BUCKET_CASES]
BUCKET_HOST = {"secp256k1": "host_bucket_accumulate", "ristretto255": "host_ed_bucket_accumulate",
               "bls12_381_g1": "host_bls_bucket_accumulate"}


def _bucket_inputs(curve, window, shared):
    """(cs, points (2, 9, C, L) with identities and edge scalings, int32
    digits (9, 3) or (2, 9, 3) with digit-0 lanes, window, nw)."""
    cs = tgd.ALL_CURVES[curve]
    rows, m, nw = 2, 9, 3
    pts = _points(curve, 40 + window, rows * m).reshape(rows, m, cs.ncoords, cs.field.limbs)
    digs = np.random.default_rng(window).integers(0, 1 << window, size=(m, nw) if shared else (rows, m, nw))
    digs[..., 0, :] = 0
    digs[..., 4, 1] = 0
    return cs, pts, _t(digs), window, nw


@pytest.mark.parametrize("case", BUCKET_CASES, ids=BUCKET_IDS)
def test_host_compiled_bucket_fold_matches_plain(host_lib, case):
    cs, pts, digs, window, nw = _bucket_inputs(*case)
    want = bk.bucket_accumulate_plain(cs, pts, digs, 1 << window)
    out = torch.empty_like(want)
    fn = getattr(host_lib, BUCKET_HOST[case[0]])
    fn.argtypes = [PTR, PTR, PTR, I64, I64, INT, INT, I64]
    fn.restype = None
    rows, m = pts.shape[:2]
    fn(pts.data_ptr(), digs.data_ptr(), out.data_ptr(), rows, m, nw, window, 0 if digs.dim() == 2 else m * nw)
    assert torch.equal(out, want)


@pytest.mark.parametrize("name", NAMES)
def test_host_compiled_lane_bodies_match_plain(host_lib, name):
    plain, ops, extra, host = _inputs(name)
    want = plain(*ops)
    out = torch.empty_like(want)
    fn = getattr(host_lib, host)
    fn.argtypes = [PTR] * (len(ops) + 1) + [I64] + [INT] * len(extra)
    fn.restype = INT if host == "host_mod_madd" else None
    rc = fn(*(o.data_ptr() for o in ops), out.data_ptr(), len(ops[0]), *extra)
    assert rc in (0, None)
    assert torch.equal(out, want)


@pytest.mark.parametrize("k", [0, 1, 4, 8])
def test_host_compiled_ed_window_step_matches_plain(host_lib, k):
    """The one-launch Edwards window step's lane body (edwards.cuh
    ed_window_step_lane: k doublings, then the unified add) at k = 0, 1, 4
    and 8, over identities, Z != 1 scalings by the field's edge values and
    an entry equal to 2^k·acc (the add as a doubling), against
    pt_window_step_plain."""
    acc, entry = _points("ristretto255", 50 + k), _points("ristretto255", 60 + k)
    entry[4] = pk.pt_double_plain(ED, acc[4], k)
    want = pk.pt_window_step_plain(ED, acc, entry, k)
    out = torch.empty_like(want)
    fn = host_lib.host_ed_pt_window_step
    fn.argtypes = [PTR, PTR, PTR, I64, INT]
    fn.restype = None
    fn(acc.data_ptr(), entry.data_ptr(), out.data_ptr(), len(acc), k)
    assert torch.equal(out, want)


BARRETT = {"ed25519_scalar": (L25519, 3), "bls12_381_scalar": (BLS12_381_R, 5),
           "bls12_381_base": (BLS12_381_P, 4)}


@pytest.mark.parametrize("name", list(BARRETT))
def test_host_compiled_barrett_worst_cases(host_lib, name):
    """The Barrett fields at their largest products: (m-1-i)·(m-1-j) + c
    for i, j < 4 and c in {0, 1, m-2, m-1}, where one conditional
    subtraction must land in [0, m) (csrc/field.cuh reduce_barrett's
    bound), against big ints and the plain version."""
    fs, fid = BARRETT[name]
    m = fs.modulus
    big = [m - 1 - i for i in range(4)]
    cs_ = [0, 1, m - 2, m - 1]
    a, b, c = zip(*[(x, y, z) for x in big for y in big for z in cs_])
    ops = [_t(jfh.encode(fs, list(col))) for col in (a, b, c)]
    out = torch.empty_like(ops[0])
    fn = host_lib.host_mod_madd
    fn.argtypes = [PTR] * 4 + [I64, INT]
    fn.restype = INT
    assert fn(*(o.data_ptr() for o in ops), out.data_ptr(), len(a), fid) == 0
    want = [(x * y + z) % m for x, y, z in zip(a, b, c)]
    assert [int(v) for v in jfh.decode(fs, out.numpy().astype(np.uint32))] == want
    assert torch.equal(out, fk.mod_madd_plain(fs, *ops))


MUL_FIELDS = {name.removeprefix("mod_madd_"): case for name, case in FIELD_CASES.items()}


def _host_mxu(host_lib, fs, mode, a, b, n):
    """host_mxu_mod_mul over n lanes: mode 0 multiplies a and b, mode 1
    reduces 2L columns at a, mode 2 reduces L + 1 limbs at a."""
    mr = fs.mulred
    consts = [np.ascontiguousarray(x) for x in (mk.packed_foldm(fs), mr.qtable.astype(np.uint32),
                                                mr.c_limbs.astype(np.uint32), mr.np_limbs.astype(np.uint32))]
    out = torch.empty((n, fs.limbs), dtype=torch.int32)
    fn = host_lib.host_mxu_mod_mul
    fn.argtypes = [INT, PTR, PTR, PTR, I64, INT, PTR, PTR, PTR, PTR, INT, INT]
    fn.restype = INT
    rc = fn(mode, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, fs.limbs, *(c.ctypes.data for c in consts),
            mr.n_split, mr.shift_e)
    assert rc == 0
    return out


@pytest.mark.parametrize("name", list(MUL_FIELDS))
def test_host_compiled_mod_mul_and_mxu_match_plain(host_lib, name):
    """mod_mul's lane body (field.cuh's fmul) and mxu_mod_mul's (mxu.cuh)
    at every pair of field edges and random elements: equal to their
    plain versions (fd.mul, fd._mul_gemm) and to big ints."""
    fs, fid = MUL_FIELDS[name]
    a, b = edge_operands(fs, 5, 2)
    ta, tb = (_t(jfh.encode(fs, col)) for col in (a, b))
    want = [x * y % fs.modulus for x, y in zip(a, b)]
    out = torch.empty_like(ta)
    fn = host_lib.host_mod_mul
    fn.argtypes = [PTR, PTR, PTR, I64, INT]
    fn.restype = INT
    assert fn(ta.data_ptr(), tb.data_ptr(), out.data_ptr(), len(a), fid) == 0
    assert torch.equal(out, tfd.mul(fs, ta, tb))
    mxu = _host_mxu(host_lib, fs, 0, ta, tb, len(a))
    assert torch.equal(mxu, tfd._mul_gemm(fs, ta, tb)) and torch.equal(mxu, out)
    assert [int(v) for v in jfh.decode(fs, out.numpy().astype(np.uint32))] == want


def _col_caps(L):
    """The admission proof's column caps of an unnormalized L-limb product."""
    def n_lo(c):
        return 0 if c < 0 or c > 2 * L - 2 else L - abs(c - (L - 1))
    return [(n_lo(c) + n_lo(c - 1)) * 0xFFFF for c in range(2 * L)]


@pytest.mark.parametrize("name", list(MUL_FIELDS))
def test_host_compiled_mxu_worst_cases(host_lib, name):
    """The fused multiply-reduce at its admission proof's worst cases, where
    uint32 overflow would show: columns whose every digit is at its cap
    (bytes 0 and 1 at 0xFF, byte 2 and the spill at the cap's top bits, the
    kept columns at theirs), and normalized values whose quotient index is
    the table's last entry; each against big ints."""
    fs, _ = MUL_FIELDS[name]
    L, p = fs.limbs, fs.modulus
    caps = _col_caps(L)
    full = [(caps[c] >> 16 << 16) | 0xFFFF if c >= L - 1 else caps[c] for c in range(2 * L)]
    rows = [full, caps, [min(v, 0xFFFF) for v in caps], [0] * (2 * L - 1) + [caps[-1]]]
    cols = torch.tensor(rows, dtype=torch.int64).to(torch.int32)
    out = _host_mxu(host_lib, fs, 1, cols, cols, len(rows))
    want = [sum(v << (LIMB_BITS * c) for c, v in enumerate(row)) % p for row in rows]
    assert [int(v) for v in jfh.decode(fs, out.numpy().astype(np.uint32))] == want
    mr = fs.mulred
    s = LIMB_BITS * (L - 1) + mr.shift_e
    u_max = len(mr.qtable) - 1
    vals = [u_max << s, (u_max << s) + (1 << s) - 1, (u_max << s) + p // 3, p - 1, p, 2 * p - 1, 0]
    vals = [v for v in vals if v < 1 << (LIMB_BITS * (L + 1)) and v >> s <= u_max]
    v = torch.from_numpy(np.stack([int_to_limbs(x, L + 1) for x in vals]).astype(np.int32))
    out = _host_mxu(host_lib, fs, 2, v, v, len(vals))
    assert [int(x) for x in jfh.decode(fs, out.numpy().astype(np.uint32))] == [x % p for x in vals]


def test_edge_operands_cover_the_field_edges():
    """The field cases see 0, 1, m - 1 and the values near 2**255 and
    2**256 - 1 reduced, in every pair of the first two operands."""
    for fs, _ in FIELD_CASES.values():
        a, b, c = edge_operands(fs, 3, 3)
        edges = edge_ints(fs)
        assert {fs.modulus - 1, 0, 1, ((1 << 256) - 1) % fs.modulus} <= set(edges)
        if fs.limbs == 24:
            assert {fs.modulus - 2, ((1 << 384) - 1) % fs.modulus} <= set(edges)
        assert set(zip(a, b)) >= {(x, y) for x in edges for y in edges}
        assert max(a + b + c) < fs.modulus


def _host_ladder(host_lib, symbol, cs, p, a, x, nbits):
    p, a = tgd.from_host(cs, [p], device="cpu"), tgd.from_host(cs, [a], device="cpu")
    xs = torch.tensor([x], dtype=torch.int32)
    out = torch.empty_like(p)
    fn = getattr(host_lib, symbol)
    fn.argtypes = [PTR] * 4 + [I64, INT]
    fn(p.data_ptr(), a.data_ptr(), xs.data_ptr(), out.data_ptr(), 1, nbits)
    return tgd.to_host(cs, out)[0]


def test_host_compiled_ladder_reaches_the_host_oracle(host_lib):
    """x·P + A from the lane body equals the big-int group law."""
    g = jgh.SECP256K1
    p, a = (g.scalar_mul(k, g.generator()) for k in (3, 5))
    got = _host_ladder(host_lib, "host_pt_ladder_mul_add", CS, p, a, 1000, 11)
    assert g.eq(got, g.scalar_mul(1000 * 3 + 5, g.generator()))


def test_host_compiled_bls_ladder_reaches_the_host_oracle(host_lib):
    """The 24-limb lane body: x·P + A on BLS12-381 G1 equals the group law."""
    g = jgh.BLS12_381_G1
    p, a = (g.scalar_mul(k, g.generator()) for k in (3, 5))
    got = _host_ladder(host_lib, "host_bls_pt_ladder_mul_add", BLS, p, a, 1000, 11)
    assert g.eq(got, g.scalar_mul(1000 * 3 + 5, g.generator()))


def test_host_compiled_edwards_ladder_reaches_the_host_oracle(host_lib):
    g = jgh.RISTRETTO255
    p, a = (g._scalar_mul_ladder(k, g.generator()) for k in (3, 5))
    got = _host_ladder(host_lib, "host_ed_pt_ladder_mul_add", ED, p, a, 1000, 11)
    assert g.eq(got, g._scalar_mul_ladder(1000 * 3 + 5, g.generator()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_kernels_match_plain(cuda, name):
    plain, ops, extra, _ = _inputs(name)
    ops = [o.to(cuda) for o in ops]
    if name in FIELD_CASES:
        fs = FIELD_CASES[name][0]
        kernel = fk._FIELDS[fs][0]
        before = kernel.launches
        got = fk.mod_madd(fs, *ops)
    else:
        _, cs, _, op = _split(name)
        op = _op(op)
        kernel = pk.kernel_for(op, cs)
        before = kernel.launches
        got = getattr(pk, op)(cs, *ops, *extra)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got.cpu(), plain(*(o.cpu() for o in ops)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", BUCKET_CASES, ids=BUCKET_IDS)
def test_cuda_bucket_kernels_match_plain(cuda, case):
    cs, pts, digs, window, nw = _bucket_inputs(*case)
    kernel = bk.kernel_for(cs)
    before = kernel.launches
    got = bk.bucket_accumulate(cs, pts.to(cuda), digs.to(cuda), window, nw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got.cpu(), bk.bucket_accumulate_plain(cs, pts, digs, 1 << window))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MUL_FIELDS))
def test_cuda_mod_mul_and_mxu_match_plain(cuda, name):
    fs, _ = MUL_FIELDS[name]
    ta, tb = (_t(jfh.encode(fs, col)) for col in edge_operands(fs, 5, 2))
    want = tfd.mul(fs, ta, tb)
    for wrapper, kernel in ((fk.mod_mul, fk.mul_kernel_for(fs)), (mk.mxu_mod_mul, mk.kernel_for(fs))):
        before = kernel.launches
        got = wrapper(fs, ta.to(cuda), tb.to(cuda))
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 4, 8])
def test_cuda_ed_window_step_matches_plain(cuda, k):
    acc, entry = _points("ristretto255", 50 + k), _points("ristretto255", 60 + k)
    before = pk.ED_PT_WINDOW_STEP.launches
    got = tgd.window_step(ED, acc.to(cuda), entry.to(cuda), k)
    torch.cuda.synchronize()
    assert pk.ED_PT_WINDOW_STEP.launches == before + 1
    assert torch.equal(got.cpu(), pk.pt_window_step_plain(ED, acc, entry, k))


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["ristretto255", "secp256k1", "bls12_381_g1"])
def test_cuda_kem_batch_matches_plain(cuda, curve):
    """kem_batch on the card (fixed_base_mul's pt_madd, scalar_mul's table
    adds and 64 window steps) against the same call on CPU tensors."""
    from dkg_tpu_torch.dkg import ceremony as tce
    from dkg_tpu_torch.dkg import hybrid_batch as hb
    from dkg_tpu_torch.groups import precompute as tgp

    cs = tgd.ALL_CURVES[curve]
    cfg = tce.CeremonyConfig(curve, 3, 1)
    pks = _points(curve, 70, 3, projective=False)
    r = _t(jfh.encode(cs.scalar, [random.Random(curve).randrange(cs.scalar.modulus) for _ in range(6)]))
    r = r.reshape(2, 3, -1)
    table = tgp.generator_table(cs, device="cpu")
    window = pk.kernel_for("pt_window_step", cs)
    before = window.launches
    got = hb.kem_batch(cfg, pks.to(cuda), r.to(cuda), table.to(cuda))
    torch.cuda.synchronize()
    assert window.launches == before + 64
    for g, w in zip(got, hb.kem_batch(cfg, pks, r, table)):
        assert torch.equal(g.cpu(), w)
