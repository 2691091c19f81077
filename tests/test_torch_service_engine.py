"""The port's service engine on the CPU (the kernels' plain versions),
held to the JAX package's engine and to the port's own unpadded ceremony.

At ristretto255 (5, 2) -> bucket (8, 2), the shape tests/test_service.py
uses, rho_bits 32:

* the port's padded width-1 convoy equals the JAX engine's
  ``run_convoy`` for the same request: the padded round-1 tensors, rho
  (the JAX engine's, captured where its finish derives it), master bytes,
  ``qualified``, ``complaints`` and final shares (one module-scoped JAX
  convoy, its deal, verify and finalise compiled at the bucket shape:
  about 60-120 s of the file's time);
* the padded convoy equals the port's unpadded ``BatchedCeremony``;
* a stacked width-2 convoy equals two width-1 runs, lane by lane, and
  ``derive_rho_convoy`` equals ``derive_rho`` on each lane;
* a tampered lane takes the blame path while its convoy-mate completes;
* ``wire_broadcasts`` (ristretto255 (5, 1): both axes padded) equals the
  port's unpadded seal and ``broadcasts_from_batch`` bytes;
* a ``concurrency=1`` scheduler runs three requests end to end, each
  master and share equal to the host big-int oracle.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from dkg_tpu.service import engine as jengine
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.dkg.hybrid_batch import broadcasts_from_batch, seal_shares_pipeline
from dkg_tpu_torch.fields import host as tfh
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.service import buckets, engine
from dkg_tpu_torch.service.scheduler import CeremonyScheduler
from dkg_tpu_torch.utils import serde
from torch_port_util import one_thread  # noqa: F401

CURVE = "ristretto255"
N, T, RHO_BITS = 5, 2, 32
SEED = 0xC0FFEE


@pytest.fixture(scope="module")
def runtime():
    return engine.WarmRuntime(device="cpu")


@pytest.fixture(scope="module")
def jax_convoy():
    """The JAX engine's width-1 convoy of the request: its in-flight
    tensors, the rho its finish derived, and its outcomes."""
    req = jengine.CeremonyRequest(CURVE, N, T, seed=SEED, rho_bits=RHO_BITS)
    rt = jengine.WarmRuntime()
    fl = jengine.start_convoy(rt, [req])
    seen = {}
    orig = jengine.derive_rho_convoy

    def capture(*args):
        seen["rho"] = orig(*args)
        return seen["rho"]

    jengine.derive_rho_convoy = capture
    try:
        outs = jengine.finish_convoy(rt, fl)
    finally:
        jengine.derive_rho_convoy = orig
    return fl, np.asarray(seen["rho"]), outs


@pytest.fixture(scope="module")
def convoy1(runtime):
    req = engine.CeremonyRequest(CURVE, N, T, seed=SEED, rho_bits=RHO_BITS)
    fl = engine.start_convoy(runtime, [req])
    rho = engine.derive_rho_convoy(fl.cfg_pad, fl.a, fl.e, fl.s, fl.r, RHO_BITS)
    return req, fl, rho, engine.finish_convoy(runtime, fl)


@pytest.fixture(scope="module")
def convoy2(runtime):
    reqs = [engine.CeremonyRequest(CURVE, N, T, seed=700 + i, rho_bits=RHO_BITS) for i in range(2)]
    fl = engine.start_convoy(runtime, reqs)
    rho = engine.derive_rho_convoy(fl.cfg_pad, fl.a, fl.e, fl.s, fl.r, RHO_BITS)
    return reqs, fl, rho, engine.finish_convoy(runtime, fl)


def test_width1_convoy_equals_the_jax_engines(convoy1, jax_convoy):
    req, fl, rho, (out,) = convoy1
    jfl, jrho, (jout,) = jax_convoy
    assert req.bucket() == buckets.Bucket(8, 2)
    for name in ("a", "e", "s", "r"):
        np.testing.assert_array_equal(tfh.from_tensor(getattr(fl, name)), np.asarray(getattr(jfl, name)))
    np.testing.assert_array_equal(rho, jrho)  # rho at the bucket shape, not the unpadded run's
    assert out.ceremony_id == jout.ceremony_id and out.status == jout.status == "done"
    assert (out.bucket_n, out.bucket_t) == (jout.bucket_n, jout.bucket_t)
    assert out.master == jout.master
    assert out.qualified == jout.qualified == (True,) * N
    assert out.complaints == jout.complaints == ()
    np.testing.assert_array_equal(out.final_shares, np.asarray(jout.final_shares))


def test_padded_convoy_equals_the_unpadded_batched_ceremony(convoy1):
    req, fl, _, (out,) = convoy1
    c = tce.BatchedCeremony(CURVE, N, T, req.shared_string, engine.rng_for(req), device="cpu")
    ref = c.run(rho_bits=RHO_BITS)
    assert out.master == tgd.encode_batch(c.cfg.cs, ref["master"][None])[0].tobytes()
    np.testing.assert_array_equal(out.final_shares, tfh.from_tensor(ref["final_shares"]))
    np.testing.assert_array_equal(tfh.from_tensor(fl.s[0])[:N, :N], tfh.from_tensor(ref["shares"]))
    assert not tfh.from_tensor(fl.s[0])[N:].any() and not tfh.from_tensor(fl.r[0])[N:].any()


def test_stacked_width2_equals_two_width1_runs(runtime, convoy2):
    reqs, fl, _, outs = convoy2
    for i, (req, out) in enumerate(zip(reqs, outs)):
        (one,) = engine.run_convoy(runtime, [req])
        assert out.status == one.status == "done"
        assert out.master == one.master and out.qualified == one.qualified and out.complaints == one.complaints
        np.testing.assert_array_equal(out.final_shares, one.final_shares)
        assert out.ceremony_id == engine.request_id(req, i)


def test_derive_rho_convoy_equals_per_ceremony_derive_rho(convoy2):
    _, fl, rho, _ = convoy2
    for i in range(2):
        one = tce.derive_rho(fl.cfg_pad, fl.a[i], fl.e[i], fl.s[i], fl.r[i], RHO_BITS)
        np.testing.assert_array_equal(rho[i], one)
    assert not np.array_equal(rho[0], rho[1])


def test_tampered_lane_takes_the_blame_path(runtime):
    reqs = [engine.CeremonyRequest(CURVE, N, T, seed=800 + i, rho_bits=RHO_BITS) for i in range(2)]
    fl = engine.start_convoy(runtime, reqs)
    dealer, recipient = 3, 1
    fl.s[1, dealer, recipient, 0] ^= 1  # lane 1: dealer 4's share to recipient 2 off its commitments
    outs = engine.finish_convoy(runtime, fl)
    clean = engine.run_convoy(runtime, [reqs[0]])[0]
    assert outs[0].status == "done" and outs[0].complaints == () and outs[0].master == clean.master
    bad = outs[1]
    assert bad.status == "done" and bad.complaints == ((recipient + 1, dealer + 1),)
    assert bad.qualified == tuple(j != dealer for j in range(N))
    master, _, _ = host_oracle(reqs[1], skip=dealer)
    assert bad.master == master


def host_oracle(req, skip: int | None = None):
    """(encoded master g·Σ_j a_j0, final shares Σ_j f_j(i), secret) over the
    qualified dealers, from the request's seeded coefficients."""
    group = tgh.ALL_GROUPS[req.curve]
    fs = group.scalar_field
    q = fs.modulus
    rng = engine.rng_for(req)
    a = [[fs.rand_int(rng) for _ in range(req.t + 1)] for _ in range(req.n)]
    col = [sum(row[l] for j, row in enumerate(a) if j != skip) % q for l in range(req.t + 1)]
    finals = [sum(c * pow(i, l, q) for l, c in enumerate(col)) % q for i in range(1, req.n + 1)]
    return group.encode(group.scalar_mul(col[0], group.generator())), finals, col[0]


def test_wire_broadcasts_equal_the_unpadded_seal(runtime):
    n, t = 5, 1
    req = engine.CeremonyRequest(CURVE, n, t, seed=31337, rho_bits=RHO_BITS)
    assert req.bucket() == buckets.Bucket(8, 2)  # n and t both pad
    group = tgh.ALL_GROUPS[CURVE]
    pks = [group.scalar_mul(i + 7, group.generator()) for i in range(n)]
    fl = engine.start_convoy(runtime, [req])
    wire_padded = engine.wire_broadcasts(runtime, req, fl, 0, pks, random.Random(99))

    cfg = tce.CeremonyConfig(CURVE, n, t)
    _, g_table, h_table = runtime.commitment(CURVE, req.shared_string)
    ca, cb = engine.draw_coeffs(cfg, engine.rng_for(req))
    _, e_r, s_r, r_r = tce.deal(cfg, tfh.to_tensor(ca, "cpu"), tfh.to_tensor(cb, "cpu"), g_table, h_table)
    fs = cfg.cs.scalar
    rng = random.Random(99)
    r_enc = tfh.encode(fs, [[fs.rand_int(rng) for _ in range(n)] for _ in range(n)])
    sealed = seal_shares_pipeline(group, cfg, s_r, r_r, tgd.from_host(cfg.cs, pks, device="cpu"),
                                  tfh.to_tensor(r_enc, "cpu"), g_table)
    wire_ref = [serde.encode_phase1(group, b) for b in broadcasts_from_batch(group, cfg, e_r, sealed)]
    assert len(wire_padded) == n and wire_padded == wire_ref


def test_scheduler_at_concurrency_1_runs_three_requests(runtime):
    reqs = [engine.CeremonyRequest(CURVE, N, T, seed=500 + i, rho_bits=RHO_BITS) for i in range(3)]
    with CeremonyScheduler(concurrency=1, queue_depth=8, batch_max=2, runtime=runtime) as sch:
        ids = [sch.submit(r) for r in reqs]
        outs = [sch.result(i, timeout=600) for i in ids]
    fs = tgh.ALL_GROUPS[CURVE].scalar_field
    for req, out in zip(reqs, outs):
        master, finals, _ = host_oracle(req)
        assert out.status == "done" and out.master == master
        assert [int(v) for v in tfh.decode(fs, out.final_shares)] == finals
        assert out.completed_at > 0 and out.seconds > 0


def test_runtime_builds_tables_once(runtime):
    first = runtime.commitment(CURVE, engine.DEFAULT_SHARED_STRING)
    assert runtime.commitment(CURVE, engine.DEFAULT_SHARED_STRING) is first
    assert first[1].device.type == "cpu" and first[1].dtype == torch.int32
    assert dataclasses.replace(engine.CeremonyRequest(CURVE, N, T), seed=1).convoy_key() == (
        CURVE, 8, 2, 128, engine.DEFAULT_SHARED_STRING)
