"""The convoy axis of mod_madd_dot and pt_bucket_sum (the ceremony
service's stacked verify) on the CPU, and launch counting under threads.

* ``mod_madd_dot_plain`` over a convoy of weight blocks (k, m, L) equals a
  per-block loop of today's shared-weights plain version, on the three
  scalar fields: k = 1, k = 3 with an all-zero weight block and m = 37
  (not a multiple of a warp), K = 1, extra value axes;
* ``bucket_lists`` of digit blocks (k, m, nw) equals per-block sorts, and
  ``pt_bucket_sum_plain`` over a convoy (k, B/k, m, C, L) equals a
  per-block loop of the shared-digit plain version on the three curves:
  k = 1, k = 3 with an all-zero digit block, B/k = 1;
* ``gd.msm_pippenger`` with a (k, 1, m, L) scalar block routes to one
  ``pt_bucket_sum`` (no ``bucket_accumulate``) and equals each
  ceremony's own shared-weight MSM (per-row scalars keep
  ``bucket_accumulate``);
* ``build.Kernel.launches`` and its count by route count exactly when 8
  threads launch at once (the scheduler's workers), through a stub entry
  point.

Everything by exact equality of limbs."""

import threading

import numpy as np
import pytest
import torch
from torch_port_util import field_limbs, point_limbs, to_torch
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu_torch.fields.spec import BLS12_381_R, L25519, SECP256K1_N
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.ops import bucket_kernels as bk
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import field_kernels as fk

SCALAR_FIELDS = [SECP256K1_N, L25519, BLS12_381_R]
CURVES = ["secp256k1", "ristretto255", "bls12_381_g1"]


def _field(fs, seed: int, shape: tuple) -> torch.Tensor:
    n = int(np.prod(shape))
    return to_torch(field_limbs(fs, seed, n)).reshape(shape + (fs.limbs,))


@pytest.mark.parametrize("fs", SCALAR_FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("k,m,tail,zero_block", [(1, 5, (7,), None), (3, 37, (4, 2), 1), (3, 5, (1,), None),
                                                 (2, 4, (), 0)])
def test_dot_convoy_plain_equals_per_block_loops(fs, k, m, tail, zero_block):
    w = _field(fs, 10 + k, (k, m))
    if zero_block is not None:
        w[zero_block] = 0
    v = _field(fs, 20 + m, (k, m) + tail)
    got = fk.mod_madd_dot(fs, w, v)  # a CPU tensor: the plain version
    want = torch.stack([fk.mod_madd_dot_plain(fs, w[i], v[i]) for i in range(k)])
    assert got.shape == (k,) + tail + (fs.limbs,)
    assert torch.equal(got, want)
    if zero_block is not None:
        assert not got[zero_block].any()


def test_dot_convoy_refuses_mismatched_blocks():
    meta = torch.zeros((3, 4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="convoy|weights"):
        fk.mod_madd_dot(SECP256K1_N, meta, torch.zeros((2, 4, 5, 16), dtype=torch.int32, device="meta"))


def _points(curve, seed: int, shape: tuple) -> torch.Tensor:
    cs = tgd.ALL_CURVES[curve]
    n = int(np.prod(shape))
    return to_torch(point_limbs(curve, seed, n)).reshape(shape + (cs.ncoords, cs.field.limbs))


def _digits(seed: int, shape: tuple, window: int) -> torch.Tensor:
    d = np.random.default_rng(seed).integers(0, 1 << window, size=shape).astype(np.int32)
    return torch.from_numpy(d)


def test_bucket_lists_of_blocks_equal_per_block_sorts():
    d = _digits(3, (3, 9, 2), 2)
    d[1] = 0
    order, starts = bk.bucket_lists(d, 2)
    assert order.shape == (3, 2, 9) and starts.shape == (3, 2, 5)
    for i in range(3):
        o1, s1 = bk.bucket_lists(d[i], 2)
        assert torch.equal(order[i], o1) and torch.equal(starts[i], s1)


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("k,rows,m,zero_block", [(1, 2, 5, None), (3, 1, 6, 2), (2, 2, 4, 0)])
def test_bucket_sum_convoy_plain_equals_per_block_loops(curve, k, rows, m, zero_block):
    cs = tgd.ALL_CURVES[curve]
    window, nw = 2, 2
    pts = _points(curve, 40 + k, (k, rows, m))
    digs = _digits(50 + m, (k, m, nw), window)
    if zero_block is not None:
        digs[zero_block] = 0
    got = bk.pt_bucket_sum(cs, pts, digs, window)
    want = torch.stack([bk.pt_bucket_sum_plain(cs, pts[i], *bk.bucket_lists(digs[i], window)) for i in range(k)])
    assert got.shape == (k, rows, nw, 3, cs.ncoords, cs.field.limbs)
    assert torch.equal(got, want)
    if zero_block is not None:
        ident = tgd.identity(cs, (rows, nw, 3), device="cpu")
        assert torch.equal(got[zero_block], ident)


def test_msm_pippenger_routes_a_convoy_block_to_one_bucket_sum(monkeypatch):
    curve = "secp256k1"
    cs = tgd.ALL_CURVES[curve]
    k, cols, m = 2, 3, 4
    pts = _points(curve, 60, (k, cols, m))
    ks = to_torch(field_limbs(cs.scalar, 61, k * m, nbits=16)).reshape(k, 1, m, -1)
    calls = []
    for name in ("pt_bucket_sum", "bucket_accumulate", "pt_bucket_close"):
        orig = getattr(bk, name)
        monkeypatch.setattr(bk, name, lambda *a, _o=orig, _n=name: (calls.append(_n), _o(*a))[1])
    got = tgd.msm_pippenger(cs, ks, pts, nbits=16)
    assert calls == ["pt_bucket_sum", "pt_bucket_close"]
    for i in range(k):
        assert torch.equal(got[i], tgd.msm_pippenger(cs, ks[i, 0], pts[i], nbits=16))
    calls.clear()
    tgd.msm_pippenger(cs, ks.expand(k, cols, m, -1), pts, nbits=16)  # per-row scalars: the other route
    assert calls == ["bucket_accumulate", "pt_bucket_close"]


def test_convoy_lead_rule():
    lead = tgd._convoy_lead
    assert lead((3, 1), (3, 5)) == 1
    assert lead((3, 1), (3, 1)) is None  # one row a block: per-row scalars
    assert lead((3, 5), (3, 5)) is None
    assert lead((1, 1), (1, 5)) is None  # a single block: the shared (m, L) route's
    assert lead((2, 3, 1), (2, 3, 4)) == 2
    assert lead((2, 1, 1), (2, 3, 4)) == 1
    assert lead((3,), (3, 5)) is None


def test_kernel_launch_count_is_exact_under_threads():
    kernel = build.Kernel("stub", "field_kernels.cu", "dkg_stub", [])
    kernel._fn = lambda *args: 0  # a stub entry point: no library, no card
    per_thread, threads = 5000, 8
    barrier = threading.Barrier(threads)

    def launch():
        barrier.wait()
        for i in range(per_thread):
            kernel(route="convoy" if i % 2 else None)

    ts = [threading.Thread(target=launch) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert kernel.launches == threads * per_thread
    assert kernel.route_launches == {"convoy": threads * per_thread // 2}
