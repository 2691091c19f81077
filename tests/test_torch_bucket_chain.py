"""pt_bucket_sum and pt_bucket_close: Pippenger's scatter from sorted
bucket lists and the bucket close, one launch each.

On the CPU: bucket_lists (the stable counting sort); pt_bucket_sum's plain
version (ordered adds down the sorted lists) against bucket_accumulate_plain
and the JAX package's _bucket_scan at c = 4 (and 8 on secp256k1), and at the edges (an
empty bucket, all digits zero, one bucket holding every point, m = 1,
B = 1 and B not a multiple of 32, identity points among the inputs);
pt_bucket_close's plain version against the JAX package's close (its
suffix sum over jgd.add); _point_rlc(mode="pippenger") end to end against
the JAX package, and which scatter each digit layout takes; and, built
from csrc/host_check.cpp with the host compiler, both kernels' lanes
(csrc/pippenger.cuh) with the kernels' lane maps, at one thread a lane
and the close on the kernel's groups of 4 threads (as fibers), the points
read through the ceremony's (m, B) strides, against the plain versions.
On a CUDA machine (marker ``cuda``; skipped elsewhere): the kernels.
Everything by exact equality of projective limbs."""

import ctypes
import dataclasses
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import field_limbs, point_limbs, same, to_torch

from dkg_tpu.dkg import ceremony as jce
from dkg_tpu.groups import device as jgd
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.ops import bucket_kernels as bk
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import point_kernels as pk

CURVES = ["secp256k1", "ristretto255", "bls12_381_g1"]
HOST_CURVE = {"secp256k1": 0, "bls12_381_g1": 1, "ristretto255": 2}  # host_check's curve ids
PTR, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _cs(curve):
    return tgd.ALL_CURVES[curve], jgd.ALL_CURVES[curve]


def _points(curve, seed: int, batch: int, m: int) -> torch.Tensor:
    """(batch, m, C, L) points, every 5th the identity."""
    cs = tgd.ALL_CURVES[curve]
    return to_torch(point_limbs(curve, seed, batch * m)).reshape(batch, m, cs.ncoords, cs.field.limbs)


def _digits(seed: int, m: int, nw: int, window: int) -> torch.Tensor:
    """(m, nw) digits: the first point's 0 in every window, then random."""
    d = np.random.default_rng(seed).integers(0, 1 << window, size=(m, nw)).astype(np.int32)
    d[0] = 0
    return torch.from_numpy(d)


def _edge_digit_cases(m: int, nw: int, window: int) -> list:
    """(label, digits (m, nw)): all zero; every point in bucket 3 (one
    bucket holding every point, every other bucket empty); and a mix
    whose window 0 leaves buckets empty."""
    mixed = _digits(5, m, nw, window)
    mixed[:, 0] = torch.arange(m, dtype=torch.int32) % 2 + 1
    return [("all zero", torch.zeros(m, nw, dtype=torch.int32)),
            ("one bucket", torch.full((m, nw), 3, dtype=torch.int32)), ("mixed", mixed)]


def test_bucket_lists_are_a_stable_counting_sort():
    d = torch.tensor([[2, 0], [0, 0], [2, 1], [1, 0], [2, 3]], dtype=torch.int32)
    order, starts = bk.bucket_lists(d, 2)
    assert order.dtype == starts.dtype == torch.int32
    assert order.tolist() == [[1, 3, 0, 2, 4], [0, 1, 3, 2, 4]]
    assert starts.tolist() == [[0, 1, 2, 5, 5], [0, 3, 4, 4, 5]]


@pytest.mark.parametrize("curve,window", [(c, 4) for c in CURVES] + [("secp256k1", 8)])
def test_bucket_sum_plain_matches_bucket_scan(curve, window):
    """Buckets 1 .. 2**c - 1 of (3, 9) points (identity points among them)
    under shared (9, 2) digits: the sorted lists' ordered adds equal
    bucket_accumulate_plain's buckets and the JAX package's _bucket_scan."""
    tcs, jcs = _cs(curve)
    pts, digs = _points(curve, 20 + window, 3, 9), _digits(window, 9, 2, window)
    got = bk.pt_bucket_sum(tcs, pts, digs, window)
    assert got.shape == (3, 2, (1 << window) - 1, tcs.ncoords, tcs.field.limbs)
    want = bk.bucket_accumulate_plain(tcs, pts, digs, 1 << window)
    assert torch.equal(got, want[..., 1:, :, :])
    jd = jnp.broadcast_to(jnp.asarray(digs.numpy()), (3, 9, 2))
    assert same(got, jgd._bucket_scan(jcs, jnp.asarray(pts.numpy().astype(np.uint32)), jd, 1 << window)[..., 1:, :, :])


@pytest.mark.parametrize("curve", CURVES)
def test_bucket_sum_plain_edges(curve):
    """At c = 4: every digit 0 (every bucket the identity), every point in
    one bucket, empty buckets; m = 1; B = 1; a (2, 3) batch; against
    bucket_accumulate_plain."""
    tcs, _ = _cs(curve)
    cases = [(lbl, _points(curve, 30, 5, 6), d) for lbl, d in _edge_digit_cases(6, 3, 4)]
    cases += [("m = 1", _points(curve, 31, 3, 1), _digits(6, 1, 3, 4)),
              ("B = 1", _points(curve, 32, 1, 6), _digits(7, 6, 3, 4)),
              ("no batch", _points(curve, 32, 1, 6)[0], _digits(7, 6, 3, 4)),
              ("(2, 3) batch", _points(curve, 33, 6, 4).reshape(2, 3, 4, tcs.ncoords, -1), _digits(8, 4, 3, 4))]
    for label, pts, digs in cases:
        got = bk.pt_bucket_sum(tcs, pts, digs, 4)
        assert torch.equal(got, bk.bucket_accumulate_plain(tcs, pts, digs, 16)[..., 1:, :, :]), label
    ident = pk.identity_plain(tcs, (5, 3, 15), "cpu")
    assert torch.equal(bk.pt_bucket_sum(tcs, cases[0][1], cases[0][2], 4), ident)


def _jax_close(jcs, buckets):
    """The JAX package's bucket close, eagerly: its scan body over jgd.add."""
    run = tot = jgd.identity(jcs, buckets.shape[:-3])
    for e in reversed(range(buckets.shape[-3])):
        run = jgd.add(jcs, run, buckets[..., e, :, :])
        tot = jgd.add(jcs, tot, run)
    return tot


@pytest.mark.parametrize("curve", CURVES)
def test_bucket_close_plain_matches_jax(curve):
    """The close of (2, 3) windows of 15 buckets (identity buckets among
    them) against the JAX package's suffix sum; and over
    bucket_accumulate's layout (buckets from 1 on, a strided view)."""
    tcs, jcs = _cs(curve)
    buckets = to_torch(point_limbs(curve, 40, 2 * 3 * 15)).reshape(2, 3, 15, tcs.ncoords, tcs.field.limbs)
    got = bk.pt_bucket_close(tcs, buckets)
    assert got.shape == (2, 3, tcs.ncoords, tcs.field.limbs)
    assert same(got, _jax_close(jcs, jnp.asarray(buckets.numpy().astype(np.uint32))))
    wide = torch.cat([pk.identity_plain(tcs, (2, 3, 1), "cpu"), buckets], dim=-3)
    assert torch.equal(bk.pt_bucket_close(tcs, wide[..., 1:, :, :]), got)


def test_point_rlc_pippenger_matches_jax(monkeypatch):
    """_point_rlc's Pippenger schedule (msm_pippenger with the weights
    shared by every column: pt_bucket_sum, pt_bucket_close) on an (n, t+1)
    = (7, 4) ristretto255 commitment tensor (the points moved to (t+1, n)
    as a view, read in place) against the JAX package's under
    DKG_TPU_RLC=pippenger.  tests/test_torch_rlc.py holds it on all three
    curves, tests/test_torch_msm.py msm_pippenger with per-row scalars."""
    tcs, jcs = _cs("ristretto255")
    pts = point_limbs("ristretto255", 60, 28).reshape(7, 4, tcs.ncoords, tcs.field.limbs)
    w = field_limbs(jcs.scalar, 61, 7, nbits=128)
    monkeypatch.setenv("DKG_TPU_RLC", "pippenger")
    got = tce._point_rlc(tcs, to_torch(w), to_torch(pts), 128, "pippenger")
    assert same(got, jce._point_rlc(jcs, jnp.asarray(w), jnp.asarray(pts), 128))


def test_pippenger_takes_the_sorted_scatter_for_shared_digits(monkeypatch):
    """Shared (m, L) scalars take one pt_bucket_sum and no
    bucket_accumulate; per-row scalars the other way round; both one
    pt_bucket_close and no pt_add for the close."""
    calls = []
    for name in ("pt_bucket_sum", "bucket_accumulate", "pt_bucket_close"):
        real = getattr(bk, name)
        monkeypatch.setattr(bk, name, lambda *a, real=real, name=name: calls.append(name) or real(*a))
    real_add = pk.pt_add
    monkeypatch.setattr(pk, "pt_add", lambda *a: calls.append("pt_add") or real_add(*a))
    cs = tgd.SECP256K1
    pts = _points("secp256k1", 70, 2, 5)
    ks = to_torch(field_limbs(cs.scalar, 71, 10, nbits=16)).reshape(2, 5, -1)
    tgd.msm_pippenger(cs, ks[0], pts, nbits=16)
    assert calls == ["pt_bucket_sum", "pt_bucket_close"]
    calls.clear()
    tgd.msm_pippenger(cs, ks, pts, nbits=16)
    assert calls == ["bucket_accumulate", "pt_bucket_close"]


def test_bucket_wrappers_refuse_what_the_kernels_do_not_take():
    cs = tgd.SECP256K1
    with pytest.raises(ValueError, match="window"):
        bk.pt_bucket_sum(cs, _points("secp256k1", 1, 2, 3), torch.zeros(3, 2, dtype=torch.int32), 3)
    meta = torch.zeros((2, 3, 3, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="shared by the batch"):
        bk.pt_bucket_sum(cs, meta, torch.zeros((5, 3, 2), dtype=torch.int32, device="meta"), 4)
    with pytest.raises(ValueError, match="2\\*\\*c - 1"):
        bk.pt_bucket_close(cs, torch.zeros((2, 3, 5, 3, 16), dtype=torch.int32, device="meta"))
    ed = tgd.ALL_CURVES["ristretto255"]
    other = dataclasses.replace(ed, name="other", const=ed.const + 1)
    for fn in (bk.sum_kernel_for, bk.close_kernel_for):
        with pytest.raises(NotImplementedError, match="pt_bucket"):
            fn(other)


# ---------------------------------------------------------------------------
# the kernels' lanes, built for the host
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
    lib.host_pt_bucket_sum.argtypes = [INT, PTR, I64, I64, PTR, PTR, PTR, I64, I64, INT, INT]
    lib.host_pt_bucket_sum_convoy.argtypes = [INT, PTR, I64, I64, PTR, PTR, PTR, I64, I64, INT, INT, I64]
    lib.host_pt_bucket_sum_convoy.restype = INT
    lib.host_pt_bucket_close.argtypes = [INT, INT, PTR, I64, I64, I64, PTR, I64, INT, INT]
    lib.host_pt_bucket_sum.restype = lib.host_pt_bucket_close.restype = INT
    return lib


def _host_sum(lib, curve, pts_mb: torch.Tensor, digits: torch.Tensor, window: int) -> torch.Tensor:
    """pt_bucket_sum's lanes over points held (m, B, C, L), read as (B, m)
    through strides -> (B, nw, nb, C, L)."""
    m, B = pts_mb.shape[:2]
    nw, nb = digits.shape[1], (1 << window) - 1
    order, starts = bk.bucket_lists(digits, window)
    view = pts_mb.movedim(0, 1)
    out = torch.full((nw, nb, B) + tuple(pts_mb.shape[2:]), -1, dtype=torch.int32)
    rc = lib.host_pt_bucket_sum(HOST_CURVE[curve], view.data_ptr(), view.stride(0), view.stride(1),
                                order.data_ptr(), starts.data_ptr(), out.data_ptr(), B, m, nw, nb)
    assert rc == 0
    return out.movedim(2, 0)


def _host_close(lib, curve, tpi, buckets: torch.Tensor) -> torch.Tensor:
    B, nw, nb = buckets.shape[:3]
    out = torch.full((B, nw) + tuple(buckets.shape[3:]), -1, dtype=torch.int32)
    rc = lib.host_pt_bucket_close(HOST_CURVE[curve], tpi, buckets.data_ptr(), buckets.stride(0), buckets.stride(1),
                                  buckets.stride(2), out.data_ptr(), B, nw, nb)
    assert rc == 0
    return out


@pytest.mark.parametrize("curve", CURVES)
def test_host_compiled_bucket_sum_and_close_match_plain(host_lib, curve):
    """pt_bucket_sum's lane (one thread) and pt_bucket_close's (on the
    kernel's group where the curve has one, and at mixed digits on one
    thread): 5 batch rows (not a multiple of a warp's lanes: the padding
    lanes store nothing) of 5 points in the ceremony's (m, B) layout, at
    c = 2 over 2 windows, digits with empty buckets, every point in one
    bucket and all zero; the close over pt_bucket_sum's layout and over
    bucket_accumulate's (bucket 0 skipped by the strides)."""
    tcs, _ = _cs(curve)
    group = {"secp256k1": 4, "bls12_381_g1": 4, "ristretto255": 1}[curve]
    pts = _points(curve, 80, 5, 5)
    pts_mb = pts.movedim(0, 1).contiguous()
    for label, digs in _edge_digit_cases(5, 2, 2):
        want = bk.pt_bucket_sum_plain(tcs, pts, *bk.bucket_lists(digs, 2))
        close = bk.pt_bucket_close_plain(tcs, want)
        got = _host_sum(host_lib, curve, pts_mb, digs, 2)
        assert torch.equal(got, want), label
        for tpi in {1, group} if label == "mixed" else (group,):
            assert torch.equal(_host_close(host_lib, curve, tpi, got), close), (label, tpi)
    wide = bk.bucket_accumulate_plain(tcs, pts, _digits(9, 5, 2, 2), 4)
    assert torch.equal(_host_close(host_lib, curve, group, wide[..., 1:, :, :]),
                       bk.pt_bucket_close_plain(tcs, wide[..., 1:, :, :]))


@pytest.mark.parametrize("curve", CURVES)
def test_host_compiled_bucket_sum_convoy_lanes_match_plain(host_lib, curve):
    """pt_bucket_sum's lane map over a convoy of digit blocks (the
    service's stacked verify): k = 3 blocks of B/k = 1 and of B/k = 33
    rows (each block padded to a warp on its own), one block's digits all
    zero, points read through the convoy's (k, B/k) rows by strides,
    against the plain version; k = 1 is the shared-digit launch."""
    tcs, _ = _cs(curve)
    for per, seed in ((1, 100), (33, 101)):
        pts = _points(curve, seed, 3 * per, 5).reshape(3, per, 5, tcs.ncoords, tcs.field.limbs)
        digs = torch.stack([_digits(seed + i, 5, 2, 2) for i in range(3)])
        digs[1] = 0
        order, starts = bk.bucket_lists(digs, 2)
        flat = pts.reshape(3 * per, 5, tcs.ncoords, tcs.field.limbs)
        out = torch.full((2, 3, 3 * per) + tuple(pts.shape[-2:]), -1, dtype=torch.int32)
        rc = host_lib.host_pt_bucket_sum_convoy(HOST_CURVE[curve], flat.data_ptr(), flat.stride(0), flat.stride(1),
                                                order.data_ptr(), starts.data_ptr(), out.data_ptr(), 3 * per, 5, 2,
                                                3, 3)
        assert rc == 0
        got = out.movedim(2, 0).reshape(3, per, 2, 3, tcs.ncoords, tcs.field.limbs)
        want = bk.pt_bucket_sum_plain(tcs, pts, order, starts)
        assert torch.equal(got, want), per
    assert host_lib.host_pt_bucket_sum_convoy(HOST_CURVE[curve], flat.data_ptr(), flat.stride(0), flat.stride(1),
                                              order.data_ptr(), starts.data_ptr(), out.data_ptr(), 3 * per, 5, 2,
                                              3, 2) == 1  # rows not a multiple of the blocks: refused


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
def test_cuda_bucket_sum_and_close_match_plain(cuda, curve):
    """One launch each (the close on its curve's group, or one thread on
    ristretto255), points in the (m, B) layout, against the plain
    versions."""
    tcs, _ = _cs(curve)
    pts = _points(curve, 90, 37, 9)
    digs = _digits(91, 9, 3, 4)
    want = bk.pt_bucket_sum_plain(tcs, pts, *bk.bucket_lists(digs, 4))
    close = bk.pt_bucket_close_plain(tcs, want)
    view = pts.movedim(0, 1).contiguous().to(cuda).movedim(0, 1)
    got = bk.pt_bucket_sum(tcs, view, digs.to(cuda), 4)
    assert torch.equal(got.cpu(), want)
    kernel = bk.close_kernel_for(tcs)
    before = kernel.launches
    assert torch.equal(bk.pt_bucket_close(tcs, got).cpu(), close)
    assert kernel.launches == before + 1
