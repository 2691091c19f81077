"""The party mesh (``dkg_tpu_torch.parallel``) on the CPU over ``gloo``:
ranks started by ``hostmesh.spawn``, one process each.

A ristretto255 (n=4, t=1) ceremony over two ranks, one spawn for every
check of it: the honest run's outputs against the port's unsharded
``BatchedCeremony.run`` (rho, ok, final shares, qualified and the master
key, limb for limb: the tree of two blocks of two pairs its points as the
tree of four does), its seal (``seal_shares_mesh``, the ranks' blocks
joined) byte-equal to one ``seal_shares_pipeline``, the sharded digest
(of the rank's blocks and of replicated tensors) equal to
``transcript_digest_device``, a mixed layout refused, the verify and
finalise at a one-recipient chunk equal to one pass; a tampered share
blamed and re-finalised as the unsharded tampered run, and two tampered
dealers aborting past t.  Then the handle's checks that need no spawn
(the counterparts of ``tests/test_parallel.py``'s fast tests), the
launcher's failure path and the sign lane's device map.  The cases held
against the JAX package's ``BatchedCeremony.run`` are in
``test_torch_ceremony.py`` (secp256k1 over 2 and 4 ranks) and
``test_torch_ceremony_bls.py`` (BLS12-381 G1 over 3), beside their JAX
fixtures."""

import random

import numpy as np
import pytest
import torch
from torch_mesh_util import failing_rank, mesh_checks, tamper_for
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

from dkg_tpu_torch import sign as ts
from dkg_tpu_torch.crypto.elgamal import Keypair
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.dkg import hybrid_batch as hb
from dkg_tpu_torch.dkg.errors import DkgErrorKind
from dkg_tpu_torch.fields import host as tfh
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.parallel import hostmesh, multihost, signmesh
from dkg_tpu_torch.parallel import mesh as pm

CURVE, N, T, SEED, SHARED, WORLD = "ristretto255", 4, 1, 11, b"torch-mesh", 2
HONEST, ONE_BAD, TOO_MANY = (), ((1, 2),), ((0, 3), (2, 1))
PLANS = (HONEST, ONE_BAD, TOO_MANY)


@pytest.fixture(scope="module")
def port():
    """The unsharded port ceremony, its runs per plan, and the seal inputs."""
    c = tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")
    cfg = c.cfg
    runs = {plan: c.run(tamper=tamper_for(cfg, pm.make_mesh(device="cpu"), plan)) for plan in PLANS}
    group = tgh.ALL_GROUPS[CURVE]
    rng = random.Random(SEED + 1)
    pks = [Keypair.generate(group, rng).pk for _ in range(N)]
    pks_dev = tgd.from_host(cfg.cs, pks, device="cpu")
    fs = cfg.cs.scalar
    r_enc = tfh.to_tensor(tfh.encode(fs, [[fs.rand_int(rng) for _ in range(N)] for _ in range(N)]), "cpu")
    return c, runs, (group, pks_dev, r_enc)


@pytest.fixture(scope="module")
def sharded(port):
    """Every rank's results of one spawn (:func:`torch_mesh_util.mesh_checks`)."""
    c, _, seal = port
    return hostmesh.spawn(mesh_checks, WORLD, device="cpu", threads=1,
                          args=(CURVE, N, T, c.coeffs_a, c.coeffs_b, c.g_table, c.h_table, PLANS, seal))


def _joined(ranks, k, key):
    return torch.cat([outs[k][key] for outs, _ in ranks])


@pytest.mark.parametrize("k", [0, 1])
def test_sharded_ceremony_equals_the_unsharded_run(port, sharded, k):
    _, runs, _ = port
    want = runs[PLANS[k]]
    for outs, _ in sharded:
        got = outs[k]
        for key in ("rho", "qualified", "master"):
            assert torch.equal(got[key], want[key]), key
        assert got["transcript"] == want["transcript"]
        assert got["n_devices"] == WORLD and got["mesh_shape"] == (WORLD,)
    for key in ("ok", "final_shares"):
        assert torch.equal(_joined(sharded, k, key), want[key]), key
    phases = set(sharded[0][0][k]["phases_s"])
    assert {"deal_commitments", "deal_shares", "transcript_digest", "verify_finalise"} <= phases
    assert ("blame" in phases) == (k == 1)


def test_tampered_share_is_blamed_and_refinalised(sharded):
    got = sharded[0][0][1]
    assert _joined(sharded, 1, "ok").tolist() == [True, True, False, True]
    assert got["qualified"].tolist() == [True, False, True, True]


def test_past_t_guilty_dealers_abort_on_every_rank(port, sharded):
    _, runs, _ = port
    assert runs[TOO_MANY]["error"].kind is DkgErrorKind.MISBEHAVIOUR_HIGHER_THRESHOLD
    for outs, _ in sharded:
        assert outs[2] == {"error": DkgErrorKind.MISBEHAVIOUR_HIGHER_THRESHOLD.value,
                           "detail": "guilty dealers (1-based): 1, 3"}


def test_seal_shares_mesh_is_byte_equal_to_the_pipeline(port, sharded):
    c, runs, (group, pks_dev, r_enc) = port
    out = runs[HONEST]
    want = hb.seal_shares_pipeline(group, c.cfg, out["shares"], out["hidings"], pks_dev, r_enc, c.g_table)
    got = [row for outs, _ in sharded for row in outs[0]["broadcasts"]]
    assert got == want
    assert "seal_transport" in sharded[0][0][0]["phases_s"]
    with pytest.raises(ValueError, match="dealer rows"):
        hb.seal_shares_mesh(group, c.cfg, pm.PartyMesh(2, 0, torch.device("cpu")), out["shares"],
                            out["hidings"], pks_dev, r_enc, c.g_table)


def test_sharded_transcript_digest_equals_the_device_digest(port, sharded):
    c, runs, _ = port
    out = runs[HONEST]
    want = tce.transcript_digest_device(c.cfg, out["bare"], out["randomized"], out["shares"], out["hidings"])
    for _, extra in sharded:
        assert extra["sharded"] == extra["replicated"] == want
        assert "dealer-axis layout" in extra["mixed"]
        assert extra["chunked_equal"]
        assert extra["collectives"]["all_to_all"]["calls"] > 0


# ---------------------------------------------------------------------------
# the handle, the launcher and the sign lane without a ceremony spawn
# ---------------------------------------------------------------------------


def test_sharded_ceremony_on_one_rank_equals_the_unsharded_run(port):
    """The tuple API on a one-rank mesh with no process group (its
    collectives local copies), through the blame path."""
    c, runs, _ = port
    m = pm.make_mesh(device="cpu")
    ok, finals, master, qualified = pm.sharded_ceremony(c.cfg, m, c.coeffs_a, c.coeffs_b, c.g_table, c.h_table,
                                                        tamper=tamper_for(c.cfg, m, ONE_BAD))
    want = runs[ONE_BAD]
    for got, key in ((ok, "ok"), (finals, "final_shares"), (master, "master"), (qualified, "qualified")):
        assert torch.equal(got, want[key]), key


def test_mesh_shapes_and_backends():
    m = pm.make_mesh(device="cpu")
    assert (m.world, m.rank, m.backend, m.sharing) == (1, 0, None, 1)
    with pytest.raises(RuntimeError, match="2-rank"):
        pm.make_mesh(2, device="cpu")
    assert pm.default_backend("cpu") == "gloo" and pm.default_backend("cuda") == "nccl"
    two = pm.PartyMesh(2, 1, torch.device("cpu"))
    assert two.span(8) == (4, 8)
    c = tce.BatchedCeremony(CURVE, 5, 1, SHARED, random.Random(1), device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        pm.sharded_deal(c.cfg, two, c.coeffs_a, c.coeffs_b, c.g_table, c.h_table)


def test_verify_chunk_default_is_the_128_mib_rule():
    cfg = tce.CeremonyConfig("secp256k1", 4096, 1365)
    assert pm._verify_chunk_default(cfg, 1024) == 512  # 512 recipients' n-long columns fill 128 MiB
    assert pm._verify_chunk_default(cfg, 256) == 256  # clamped to the block
    assert pm._verify_chunk_default(tce.CeremonyConfig("bls12_381_g1", 16384, 5461), 4096) == 128
    assert pm._verify_chunk_default(tce.CeremonyConfig("ristretto255", 4, 1), 2) == 2


def test_all_to_all_recipients_on_one_rank_is_the_chunk():
    m = pm.make_mesh(device="cpu")
    x = torch.arange(2 * 4 * 3, dtype=torch.int32).reshape(2, 4, 3)
    assert torch.equal(m.all_to_all_recipients(x, 1, 2), x[:, 1:3])
    assert m.stats["all_to_all"]["calls"] == 1 and m.stats["all_to_all"]["bytes"] == x[:, 1:3].numel() * 4


def test_multihost_helpers_single_process():
    multihost.init_multihost()  # no-op at one process
    m = multihost.global_party_mesh(device="cpu")
    assert m.world == 1
    assert multihost.process_party_block(16, m) == (0, 16)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.init_multihost(num_processes=2)


def test_party_block_derives_from_mesh_positions():
    """The block is the rank's position on the party axis, the mesh's own
    span; a count that does not shard evenly and anything but a 1-D party
    mesh are refused."""
    third = pm.PartyMesh(4, 2, torch.device("cpu"))
    assert multihost.process_party_block(16, third) == (8, 12) == third.span(16)
    assert [multihost.process_party_block(8, pm.PartyMesh(2, r, torch.device("cpu"))) for r in (0, 1)] == [
        (0, 4), (4, 8)]
    with pytest.raises(ValueError, match="evenly"):
        multihost.process_party_block(17, third)
    with pytest.raises(ValueError, match="1-D"):
        multihost.process_party_block(16, np.zeros((2, 4)))


def test_a_failed_rank_fails_the_spawn_and_stops_every_rank():
    with pytest.raises(hostmesh.RankFailed, match="fails on purpose") as info:
        hostmesh.spawn(failing_rank, 2, device="cpu", args=(1,), threads=1, timeout=120)
    assert 1 in info.value.errors


def test_sign_folded_sharded_over_two_cpu_devices_equals_sign_folded():
    """A batch of 3 over (cpu, cpu): one zero row of padding."""
    curve = "secp256k1"
    cs = tgd.ALL_CURVES[curve]
    rng = random.Random(3)
    group = tgh.ALL_GROUPS[curve]
    pts = [group.scalar_mul_vartime(rng.randrange(1, cs.scalar.modulus), group.generator()) for _ in range(3)]
    h_dev = tgd.from_host(cs, pts, device="cpu")
    sigma = tfh.encode(cs.scalar, rng.randrange(cs.scalar.modulus))
    want = ts.sign_folded(curve, sigma, h_dev)
    got = signmesh.sign_folded_sharded(curve, sigma, h_dev, ("cpu", "cpu"))
    assert torch.equal(got, want)


def test_sign_mesh_knob(monkeypatch):
    monkeypatch.delenv("DKG_TPU_SIGN_MESH", raising=False)
    assert signmesh.sign_mesh() is None
    two = (torch.device("cuda", 0), torch.device("cuda", 1))
    for knob, devices, want in (("0", two, None), ("1", two[:1], None), ("1", two, two)):
        monkeypatch.setenv("DKG_TPU_SIGN_MESH", knob)
        monkeypatch.setattr(signmesh, "_devices", lambda devices=devices: devices)
        assert signmesh.sign_mesh() == want
    for typo in ("yes", "force"):  # the JAX package's force engages CPU meshes, which the port has not
        monkeypatch.setenv("DKG_TPU_SIGN_MESH", typo)
        with pytest.raises(ValueError, match="DKG_TPU_SIGN_MESH"):
            signmesh.sign_mesh()


def test_scheduler_sign_rung_runs_over_the_sign_mesh(monkeypatch):
    """DKG_TPU_SIGN_MESH=1 routes the sign lane's folded rungs through
    sign_folded_sharded (here over two CPU devices standing in for the
    card's): the same signature bytes as the one-device rung, with three
    messages over two devices (one row of padding)."""
    from dkg_tpu_torch.service import engine
    from dkg_tpu_torch.service.scheduler import CeremonyScheduler
    from dkg_tpu_torch.utils.metrics import MetricsRegistry

    msgs = [b"rung-0", b"rung-1", b"rung-2"]
    registry = MetricsRegistry()
    req = engine.CeremonyRequest(CURVE, N, T, seed=SEED, rho_bits=32)
    with CeremonyScheduler(concurrency=1, queue_depth=4, batch_max=1, runtime=engine.WarmRuntime(device="cpu"),
                           metrics=registry) as sch:
        cid = sch.submit(req)
        assert sch.result(cid, timeout=600).status == "done"
        monkeypatch.delenv("DKG_TPU_SIGN_MESH", raising=False)
        want = sch.sign(cid, msgs, prove=False, seed=5)
        assert "sign_mesh_rungs_total" not in str(registry.snapshot()["counters"])
        monkeypatch.setenv("DKG_TPU_SIGN_MESH", "1")
        monkeypatch.setattr(signmesh, "_devices", lambda: (torch.device("cpu"), torch.device("cpu")))
        got = sch.sign(cid, msgs, prove=False, seed=5)
    assert got == want and len(got) == len(msgs)
    snap = registry.snapshot()
    assert snap["counters"]["sign_mesh_rungs_total"] >= 1
    assert snap["gauges"]["sign_mesh_devices"] == 2
