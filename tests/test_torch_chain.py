"""The chained point kernels: pt_fixed_base (every window of
fixed_base_mul in one launch) and pt_tree_sum (a whole _tree_reduce in
one launch, the Straus windows' gathered entries read in place).

On the CPU: gd.fixed_base_mul, gd._tree_reduce, gd.msm_straus and the
three _point_rlc schedules against the JAX package's at small shapes on
all three curves (digit-0 windows, an identity-base table, m not a power
of two and m = 1), by exact equality; the plain versions against the
loops of the one-step plain versions; and the kernels' bodies built from
csrc/host_check.cpp with the host compiler (a lane on one thread or a
group of TPI host threads, a block's threads meeting at a barrier for
each __syncthreads), at every group size the source takes, driven
through the wrapper's own pass schedule with the chunk rule forced at a
small cap, against the plain versions.  On a CUDA machine (marker
``cuda``; skipped elsewhere): the kernels themselves.

Each curve's gathered tree against the JAX package at m not a power of
two is also in test_torch_msm.py (msm_straus, m = 6) and
test_torch_rlc.py (_point_rlc's Straus schedule, m = 6)."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import field_limbs, point_limbs, same, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu.dkg import ceremony as jce
from dkg_tpu.groups import device as jgd
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import point_kernels as pk

CURVES = ["secp256k1", "ristretto255", "bls12_381_g1"]
HOST_CURVE = {"secp256k1": 0, "bls12_381_g1": 1, "ristretto255": 2}  # host_check's curve ids
# the group sizes chain_kernels.cu builds (its defaults and
# ops/chain_bench.py's variants), per kernel and curve: one thread a lane
# everywhere, groups only where the lane rule can take them
FIXED_TPIS = {"secp256k1": (1, 2, 4, 8), "ristretto255": (1,), "bls12_381_g1": (1, 2, 4)}
TREE_TPIS = {"secp256k1": (1,), "ristretto255": (1,), "bls12_381_g1": (1, 2, 4)}
PTR, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _cs(curve):
    return tgd.ALL_CURVES[curve], jgd.ALL_CURVES[curve]


def _points(curve, seed, shape: tuple) -> torch.Tensor:
    """Projective points (*shape, C, L): identities and edge scalings."""
    n = int(np.prod(shape, dtype=int))
    pts = to_torch(point_limbs(curve, seed, n, edge_lambdas=True))
    return pts.reshape(shape + pts.shape[1:])


def _table(curve, seed, nw: int, window: int, identity_base: bool = False) -> torch.Tensor:
    """An affine fixed-base table (nw, 2**window, C, L): entry 0 of every
    window the identity, as the built tables hold it, the rest drawn from
    a pool of affine points (the kernel's arithmetic does not need
    d·2**(w·j)·B); with ``identity_base``, every entry the identity."""
    cs, _ = _cs(curve)
    pool = to_torch(point_limbs(curve, seed, 16, projective=False))
    pool = pool[[i for i in range(16) if i % 5 != 2]]  # no identities among the non-zero digits
    idx = np.random.default_rng(seed).integers(0, len(pool), size=(nw, 1 << window))
    table = pool[torch.from_numpy(idx)]
    ident = pk.identity_plain(cs, (), "cpu")
    table[:, 0] = ident
    if identity_base:
        table[:] = ident
    return table.contiguous()


def _scalars(fs, seed, n: int) -> torch.Tensor:
    """n scalars: 0, 1, 2, q - 1, ... (field_limbs' edges: digit-0 windows),
    then one with every other byte 0."""
    k = field_limbs(fs, seed, n)
    k[-1] = 0xAB00
    return to_torch(k)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("curve", CURVES)
def test_fixed_base_mul_matches_jax(curve):
    """32 windows of 8 bits: scalars with digit-0 windows, over a table
    and over the identity's table (every entry (0, 1, 0), or (0, 1, 1, 0)),
    against the JAX package's fixed_base_mul; the plain version against
    the loop of one-step pt_madd_plain."""
    tcs, jcs = _cs(curve)
    k = _scalars(tcs.scalar, 31, 6)
    for identity_base in (False, True):
        table = _table(curve, 32, 32, 8, identity_base)
        got = tgd.fixed_base_mul(tcs, table, k)
        assert same(got, jgd.fixed_base_mul(jcs, jnp.asarray(table.numpy().astype(np.uint32)), jnp.asarray(k.numpy().astype(np.uint32))))
        assert torch.equal(got, pk.pt_fixed_base_plain(tcs, table, k))
    assert torch.equal(got, pk.identity_plain(tcs, (6,), "cpu")) or curve == "ristretto255"


# m per curve against the JAX package: every m of the set on secp256k1,
# fewer on the others (each m's levels compile a JAX add of their own
# shape, seconds each on this CPU); the host-compiled tree below runs the
# whole set on every curve
TREE_M = {"secp256k1": (1, 2, 3, 5, 7, 12), "ristretto255": (1, 3, 5), "bls12_381_g1": (1, 2, 3)}


@pytest.mark.parametrize("curve", CURVES)
def test_tree_reduce_matches_jax(curve):
    """_tree_reduce over (2, m) points against the JAX package's: the
    identity pads of odd levels, the lone last node added to the identity
    at each of them, no add at m = 1."""
    tcs, jcs = _cs(curve)
    for m in TREE_M[curve]:
        pts = _points(curve, 40 + m, (2, m))
        got = tgd._tree_reduce(tcs, pts, m)
        assert same(got, jgd._tree_reduce(jcs, jnp.asarray(pts.numpy().astype(np.uint32)), m)), m
    assert torch.equal(tgd._tree_reduce(tcs, pts[:, :1], 1), pts[:, 0])
    with pytest.raises(ValueError, match="axis_len"):
        tgd._tree_reduce(tcs, pts, 11)


def test_msm_straus_and_point_rlc_match_jax_at_m_1(monkeypatch):
    """ristretto255 at m = 1, where the gathered tree adds nothing:
    msm_straus with full-width scalars, and _point_rlc's Straus schedule
    over two columns with 16-bit weights, against the JAX package's (m = 5
    and 6 are in test_torch_groups.py and test_torch_rlc.py)."""
    tcs, jcs = _cs("ristretto255")
    pts = to_torch(point_limbs("ristretto255", 51, 2))
    k = to_torch(field_limbs(jcs.scalar, 61, 1))
    got = tgd.msm_straus(tcs, k, pts[:1])
    assert same(got, jgd.msm_straus(jcs, jnp.asarray(k.numpy().astype(np.uint32)),
                                    jnp.asarray(pts[:1].numpy().astype(np.uint32))))
    monkeypatch.setenv("DKG_TPU_RLC", "straus")
    w = field_limbs(jcs.scalar, 81, 1, nbits=16)
    cols = pts.reshape(1, 2, tcs.ncoords, tcs.field.limbs)
    got = tce._point_rlc(tcs, to_torch(w), cols, 16, "straus")
    assert same(got, jce._point_rlc(jcs, jnp.asarray(w), jnp.asarray(cols.numpy().astype(np.uint32)), 16))


@pytest.mark.parametrize("curve", CURVES)
def test_tree_sum_plain_gathered_and_strided(curve):
    """pt_tree_sum_plain with digits is the tree of the gathered entries,
    for tables shared by a digit batch and digits shared by a table batch
    (the Straus RLC's layout), and the level loop of pt_add_plain."""
    cs, _ = _cs(curve)
    tables = _points(curve, 90, (3, 5, 4))  # (m = 3, 5 columns, E = 4)
    digits = torch.tensor([3, 0, 2], dtype=torch.int32)
    got = pk.pt_tree_sum_plain(cs, tables.movedim(0, -4), digits)  # (5, 3, 4, C, L), digits shared
    gathered = tables[torch.arange(3), :, digits.long()]  # (3, 5, C, L)
    want = pk.pt_add_plain(cs, pk.pt_add_plain(cs, gathered[0], gathered[1]),
                           pk.pt_add_plain(cs, gathered[2], pk.identity_plain(cs, (5,), "cpu")))
    assert torch.equal(got, want)
    per_row = torch.tensor([[1, 2, 3], [0, 0, 1]], dtype=torch.int32)
    got = pk.pt_tree_sum_plain(cs, tables[:, 0], per_row)  # one (3, 4) table set, two digit rows
    assert torch.equal(got[1], pk.pt_tree_sum_plain(cs, tables[[0, 1, 2], 0, [0, 0, 1]]))
    with pytest.raises(ValueError, match="at least one"):
        pk.pt_tree_sum_plain(cs, tables[:0, 0, 0])


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
    lib.host_pt_fixed_base.argtypes = [INT, INT, PTR, PTR, PTR, I64, INT, INT, INT]
    lib.host_pt_fixed_base.restype = INT
    lib.host_pt_tree_sum.argtypes = [INT, INT, INT, PTR, I64, I64, PTR, I64, I64, PTR, I64, I64, INT]
    lib.host_pt_tree_sum.restype = INT
    return lib


FIXED_CASES = [(c, t) for c in CURVES for t in FIXED_TPIS[c]]


@pytest.mark.parametrize("case", FIXED_CASES, ids=[f"{c}-tpi{t}" for c, t in FIXED_CASES])
def test_host_compiled_fixed_base_matches_plain(host_lib, case):
    """pt_fixed_base's lane (chain.cuh fixed_base_lane) at one thread a
    lane or TPI host threads, the low windows of 4 and of 8 bits (the
    kernel takes any count of them), digit-0 windows and the identity's
    table, against the plain version; a group past the last lane (n = 5 is
    not a multiple of 32 / TPI) stores nothing."""
    curve, tpi = case
    cs, _ = _cs(curve)
    k = _scalars(cs.scalar, 100 + tpi, 5)
    for nw, window, identity_base in ((6, 4, False), (4, 8, False), (3, 8, True)):
        table = _table(curve, 110 + window, nw, window, identity_base)
        out = torch.full((5, cs.ncoords, cs.field.limbs), -1, dtype=torch.int32)
        assert host_lib.host_pt_fixed_base(HOST_CURVE[curve], tpi, table.data_ptr(), k.data_ptr(),
                                           out.data_ptr(), 5, nw, window, k.shape[-1]) == 0
        assert torch.equal(out, pk.pt_fixed_base_plain(cs, table, k)), (nw, window, identity_base)


def _host_tree(host_lib, curve, tpi, threads, chunk_log):
    """pt_tree_sum's launches as the wrapper schedules them, each block of
    ``threads`` host threads."""
    cs, _ = _cs(curve)

    def launch(*args):
        assert host_lib.host_pt_tree_sum(HOST_CURVE[curve], tpi, threads, *args) == 0

    return lambda src, dig: pk.tree_sum_passes(launch, src, dig, (cs.ncoords, cs.field.limbs), chunk_log)


# one thread a lane at every m; BLS12-381's group of 4 at four, its group
# of 2 (slices of 6 words) at two
TREE_M_HOST = {1: (1, 2, 3, 5, 7, 12, 37), 4: (1, 3, 12, 37), 2: (1, 12)}
TREE_CASES = [(c, t, TREE_M_HOST[t]) for c in CURVES for t in TREE_TPIS[c]]


@pytest.mark.parametrize("case", TREE_CASES, ids=[f"{c}-tpi{t}" for c, t, _ in TREE_CASES])
def test_host_compiled_tree_sum_matches_plain(host_lib, case):
    """pt_tree_sum's block (chain.cuh tree_block) at m up to 37 (several
    rounds of a level: blocks of 4 lanes), direct over a strided view and
    gathered under per-column or shared digits, whole (chunk_log 10) and
    chunked at a cap of 4 points (the lone last chunk padded to its
    levels, more passes over the tops), against the plain version."""
    curve, tpi, ms = case
    cs, _ = _cs(curve)
    threads = 4 * tpi
    for m in ms:
        cols = _points(curve, 120 + m, (m, 2))  # (m, cols): the Straus RLC's points, read by a view
        tables = _points(curve, 130 + m, (2, m, 3))  # (cols, m, E = 3)
        digits = torch.from_numpy(np.random.default_rng(m).integers(0, 3, size=(2, m)).astype(np.int32))
        want_direct = pk.pt_tree_sum_plain(cs, cols.movedim(0, -3))
        want_gathered = pk.pt_tree_sum_plain(cs, tables, digits)
        want_shared = pk.pt_tree_sum_plain(cs, tables, digits[0])
        for chunk_log in (10, 2):
            run = _host_tree(host_lib, curve, tpi, threads, chunk_log)
            assert torch.equal(run(cols.movedim(0, 1), None), want_direct), (m, chunk_log)
            assert torch.equal(run(tables, digits), want_gathered), (m, chunk_log)
            assert torch.equal(run(tables, digits[0].expand(2, m)), want_shared), (m, chunk_log)


def test_tree_levels_and_lane_rules():
    """The first launch's levels: the whole tree where it fits a block, else
    the cap; the chained kernels' lane rules, a group only where the
    kernel has one."""
    assert [pk.tree_levels(m, 10) for m in (1, 2, 3, 4, 5, 1000, 1024, 1025, 4096)] == [0, 1, 2, 2, 3, 10, 10, 10, 10]
    assert pk.tree_levels(12, 2) == 2
    secp, r255, bls = (tgd.ALL_CURVES[c] for c in ("secp256k1", "ristretto255", "bls12_381_g1"))
    assert [pk.fixed_base_group(cs, 350_208) for cs in (secp, r255, bls)] == [False] * 3
    assert [pk.fixed_base_group(cs, 1024) for cs in (secp, r255, bls)] == [True, False, True]
    assert [pk.tree_group(cs, 342) for cs in (secp, r255, bls)] == [False] * 3
    assert [pk.tree_group(cs, 1) for cs in (secp, r255, bls)] == [False, False, True]


@pytest.mark.parametrize("curve", CURVES)
def test_one_step_routes_are_the_plain_loops(curve):
    """The plain versions with a one-step kernel's op as their step (the
    routes the kernels are held and timed against on the card) are the
    plain versions on CPU tensors, where that op runs its plain version."""
    cs, _ = _cs(curve)
    k = _scalars(cs.scalar, 150, 4)
    table = _table(curve, 151, 4, 4)
    assert torch.equal(pk.pt_fixed_base_plain(cs, table, k, madd=pk.pt_madd), pk.pt_fixed_base_plain(cs, table, k))
    tables = _points(curve, 152, (2, 5, 3))
    digits = torch.tensor([[0, 2, 1, 1, 0], [2, 2, 0, 1, 1]], dtype=torch.int32)
    want = pk.pt_tree_sum_plain(cs, tables, digits)
    assert torch.equal(pk.pt_tree_sum_plain(cs, tables, digits, add=pk.pt_add), want)


def test_chained_kernels_per_curve():
    """Each curve has its own chained kernels and launch counts, built from
    csrc/chain_kernels.cu, every one in point_kernels.KERNELS and the
    source in build.SOURCES."""
    for op in ("pt_fixed_base", "pt_tree_sum"):
        ks = {pk.kernel_for(op, tgd.ALL_CURVES[c]) for c in CURVES}
        assert len(ks) == 3 and {k.source for k in ks} == {"chain_kernels.cu"} and ks <= set(pk.KERNELS)
    assert "chain_kernels.cu" in build.SOURCES


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
def test_cuda_chained_kernels_match_plain(cuda, curve, monkeypatch):
    """Each kernel at one thread a lane and, where it has one, in a group
    (the lane rule forced either way), against the plain version: the fixed
    base over a table and the identity's; the tree at m = 37 whole and past
    a chunk cap of 4 (three launches), and at m = 1, 2, 3 direct and
    gathered."""
    cs, _ = _cs(curve)
    key = (cs.kind, cs.field.name, cs.const)
    k = _scalars(cs.scalar, 140, 6)
    tables = _points(curve, 142, (2, 37, 3))
    digits = torch.from_numpy(np.random.default_rng(1).integers(0, 3, size=(2, 37)).astype(np.int32))
    kernel = pk.kernel_for("pt_tree_sum", cs)
    for group in (False, True):
        rules = [r for r in (pk.FIXED_BASE_GROUP_BELOW, pk.TREE_GROUP_BELOW) if key in r]
        if group and not rules:
            continue
        for rule in rules:
            monkeypatch.setitem(rule, key, 1 << 62 if group else 0)
        for identity_base in (False, True):
            table = _table(curve, 141, 32, 8, identity_base)
            got = pk.pt_fixed_base(cs, table.to(cuda), k.to(cuda))
            assert torch.equal(got.cpu(), pk.pt_fixed_base_plain(cs, table, k))
        for chunk_log, launches in ((10, 1), (2, 3)):
            monkeypatch.setattr(pk, "TREE_CHUNK_LOG", chunk_log)
            before = kernel.launches
            got = pk.pt_tree_sum(cs, tables.to(cuda), digits.to(cuda))
            torch.cuda.synchronize()
            assert kernel.launches == before + launches
            assert torch.equal(got.cpu(), pk.pt_tree_sum_plain(cs, tables, digits))
        monkeypatch.setattr(pk, "TREE_CHUNK_LOG", 10)
        for m in (1, 2, 3):  # one leaf: no add, the leaf itself
            pts = _points(curve, 143 + m, (m, 4)).movedim(0, -3)
            assert torch.equal(pk.pt_tree_sum(cs, pts.to(cuda)).cpu(), pk.pt_tree_sum_plain(cs, pts))
            got = pk.pt_tree_sum(cs, tables[:, :m].to(cuda), digits[:, :m].to(cuda))
            assert torch.equal(got.cpu(), pk.pt_tree_sum_plain(cs, tables[:, :m], digits[:, :m]))
        monkeypatch.undo()
