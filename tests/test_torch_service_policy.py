"""The port's ceremony service policy on the CPU, with no device work.

Parity with the JAX package, exactly: the bucket ladder over every
(n, t) of a coarse grid up to n = 4096, ``split_widths``,
``sign_rung_slices`` and ``width_cap``; ``request_id``; and the durability
journal both ways (records the port writes replay under
``dkg_tpu.service.durable.ServiceJournal``, and the reverse, body for
body).  Then ``tests/test_service.py``'s first layer, case for case, over
the port's modules: the bucketing policy, request ids, journal replay and
compaction, and the scheduler's admission, backpressure, deadlines,
convoy formation, shutdown, recovery, knobs, poison bisection, transient
retries, the watchdog, the crash-loop guard and the redaction contract,
with the engine patched out (``start_convoy`` / ``finish_convoy``).
"""

from __future__ import annotations

import json
import random
import threading
import time

import pytest

from dkg_tpu.service import buckets as jbuckets
from dkg_tpu.service import durable as jdurable
from dkg_tpu.service import engine as jengine
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.service import buckets, engine
from dkg_tpu_torch.service import scheduler as scheduler_mod
from dkg_tpu_torch.service.durable import ServiceJournal
from dkg_tpu_torch.service.engine import CeremonyOutcome, CeremonyRequest
from dkg_tpu_torch.service.faultsvc import ServiceFaultPlan
from dkg_tpu_torch.service.scheduler import CeremonyScheduler, QueueFullError
from dkg_tpu_torch.utils.metrics import MetricsRegistry
from dkg_tpu_torch.utils.obslog import ObsLog
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

CURVE = "ristretto255"
N, T = 5, 2  # buckets to (8, 2): the smallest ladder rung


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _grid():
    ns = sorted(set(range(2, 70)) | {96, 100, 127, 128, 129, 200, 255, 256, 257, 500, 511, 512, 513, 1000,
                                     1023, 1024, 1025, 2000, 2047, 2048, 2049, 3000, 4095, 4096})
    for n in ns:
        ts = sorted({1, 2, 3, n // 4, n // 3, (n - 1) // 2, n // 2, n - 2, n - 1} - {0})
        for t in ts:
            if 1 <= t < n:
                yield n, t


def test_bucket_ladder_equals_the_jax_packages():
    for n, t in _grid():
        try:
            want = jbuckets.bucket_for(n, t)
        except ValueError:
            with pytest.raises(ValueError):
                buckets.bucket_for(n, t)
            continue
        got = buckets.bucket_for(n, t)
        assert (got.n, got.t) == (want.n, want.t), (n, t)
        assert buckets.width_cap(got) == jbuckets.width_cap(want)
        assert buckets.t_rungs(got.n) == jbuckets.t_rungs(want.n)
    for bad in ((1, 1), (4097, 2), (5, 5), (5, 0)):
        with pytest.raises(ValueError):
            jbuckets.bucket_for(*bad)
        with pytest.raises(ValueError):
            buckets.bucket_for(*bad)
    assert (buckets.WIDTHS, buckets.SIGN_RUNGS, buckets.WIDTH_CAP_N, buckets.MIN_BUCKET_N, buckets.MAX_BUCKET_N) == (
        jbuckets.WIDTHS, jbuckets.SIGN_RUNGS, jbuckets.WIDTH_CAP_N, jbuckets.MIN_BUCKET_N, jbuckets.MAX_BUCKET_N)


def test_split_widths_and_sign_rungs_equal_the_jax_packages():
    for k in range(0, 70):
        for batch_max in (1, 2, 3, 4, 7, 8, 16):
            assert buckets.split_widths(k, batch_max) == jbuckets.split_widths(k, batch_max)
    for total in list(range(0, 300)) + [511, 512, 1000, 4097]:
        for batch_max in (1, 4, 16, 100, 256):
            assert buckets.sign_rung_slices(total, batch_max) == jbuckets.sign_rung_slices(total, batch_max)


def _request_pairs():
    rng = random.Random(5)
    for i in range(40):
        n = rng.randrange(2, 100)
        t = rng.randrange(1, n)
        seed = None if i % 7 == 0 else rng.getrandbits(40)
        shared = (b"dkg-tpu-service", b"", b"other \x00\xff")[i % 3]
        kw = dict(curve=("secp256k1", "ristretto255", "bls12_381_g1")[i % 3], n=n, t=t, shared_string=shared,
                  seed=seed, rho_bits=(64, 128)[i % 2], deadline_s=(None, 2.5)[i % 2], durable=bool(i % 2),
                  tag=f"tag-{i}")
        yield CeremonyRequest(**kw), jengine.CeremonyRequest(**kw), i


def test_request_id_and_convoy_key_equal_the_jax_packages():
    for req, jreq, seq in _request_pairs():
        assert engine.request_id(req, seq) == jengine.request_id(jreq, seq)
        assert req.convoy_key() == jreq.convoy_key()


def _outcomes(pkg_engine):
    return [pkg_engine.CeremonyOutcome(ceremony_id="cid1", status="done", curve=CURVE, n=5, t=2, bucket_n=8,
                                       bucket_t=2, master=bytes(range(32)), qualified=(True, False, True, True, True),
                                       complaints=((2, 1), (3, 1)), error=""),
            pkg_engine.CeremonyOutcome(ceremony_id="cid3", status="poisoned", curve=CURVE, n=6, t=2,
                                       error="PoisonedRequest: REPLAY_LIMIT (replayed 3x, max 3)")]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_replays_across_packages(tmp_path, writer):
    """A journal either package writes replays in the other to the same
    pending, terminal and replay maps, and the record bodies are the same
    bytes."""
    pkgs = {"port": (ServiceJournal, engine), "jax": (jdurable.ServiceJournal, jengine)}
    dirs = {}
    for name, (journal_cls, pkg_engine) in pkgs.items():
        d = tmp_path / name
        j = journal_cls(d)
        for req, jreq, seq in list(_request_pairs())[:6]:
            if req.seed is None:
                continue
            j.record_request(f"cid{seq}", seq, req if name == "port" else jreq)
        for out in _outcomes(pkg_engine):
            j.record_done(out)
        j.record_replay("cid1", 2)
        j.record_replay("cid5", 1)
        dirs[name] = d
    assert j.wal.replay() == ServiceJournal(dirs["port"]).wal.replay()
    reader = "jax" if writer == "port" else "port"
    src = dirs[writer]
    got = pkgs[reader][0](src).replay()
    want = pkgs[writer][0](src).replay()
    pending, terminal, replays = got
    assert replays == want[2]
    assert sorted(pending) == sorted(want[0])
    for cid in pending:
        (s1, r1), (s2, r2) = pending[cid], want[0][cid]
        assert s1 == s2 and dataclass_fields(r1) == dataclass_fields(r2)
    assert sorted(terminal) == sorted(want[1])
    for cid in terminal:
        assert outcome_fields(terminal[cid]) == outcome_fields(want[1][cid])
    # the reader compacts what the writer wrote; the writer replays it back
    pkgs[reader][0](src).compact(*got)
    again = pkgs[writer][0](src).replay()
    assert sorted(again[0]) == sorted(pending) and sorted(again[1]) == sorted(terminal)
    assert again[2] == {c: v for c, v in replays.items() if c in pending}


def dataclass_fields(req) -> tuple:
    return (req.curve, req.n, req.t, req.shared_string, req.seed, req.rho_bits, req.deadline_s, req.durable, req.tag)


def outcome_fields(out) -> tuple:
    return (out.ceremony_id, out.status, out.curve, out.n, out.t, out.bucket_n, out.bucket_t, out.master,
            out.qualified, out.complaints, out.error)


# ---------------------------------------------------------------------------
# tests/test_service.py's first layer over the port
# ---------------------------------------------------------------------------


def test_bucket_for_rounds_up_to_ladder():
    assert buckets.bucket_for(5, 2) == buckets.Bucket(8, 2)
    assert buckets.bucket_for(8, 2) == buckets.Bucket(8, 2)
    assert buckets.bucket_for(5, 3) == buckets.Bucket(8, 3)
    assert buckets.bucket_for(16, 5) == buckets.Bucket(16, 5)
    assert buckets.bucket_for(9, 3) == buckets.Bucket(16, 4)
    assert buckets.bucket_for(24, 8) == buckets.Bucket(32, 8)
    assert buckets.bucket_for(64, 16) == buckets.Bucket(64, 16)
    # committee sizes below the floor pad up to it
    assert buckets.bucket_for(2, 1) == buckets.Bucket(8, 2)


def test_bucket_for_escalates_degenerate_thresholds():
    # t beyond n_pad's maximal rung escalates to the next n bucket
    b = buckets.bucket_for(8, 4)  # rungs at n=8 are (2, 3)
    assert b.n == 16 and b.t >= 4


def test_bucket_for_rejects_unbucketable_shapes():
    with pytest.raises(ValueError):
        buckets.bucket_for(1, 1)
    with pytest.raises(ValueError):
        buckets.bucket_for(buckets.MAX_BUCKET_N + 1, 2)
    with pytest.raises(ValueError):
        buckets.bucket_for(5, 5)  # t >= n
    with pytest.raises(ValueError):
        buckets.bucket_for(5, 0)


def test_t_rungs_ascend_and_dominate_regimes():
    for n_pad in (8, 16, 32, 64, 4096):
        rungs = buckets.t_rungs(n_pad)
        assert rungs == tuple(sorted(rungs))
        assert rungs[-1] == (n_pad - 1) // 2  # maximal honest-majority


def test_split_widths_greedy_ladder():
    assert buckets.split_widths(7) == [4, 2, 1]
    assert buckets.split_widths(8) == [8]
    assert buckets.split_widths(9) == [8, 1]
    assert buckets.split_widths(0) == []
    assert buckets.split_widths(7, batch_max=2) == [2, 2, 2, 1]
    with pytest.raises(ValueError):
        buckets.split_widths(-1)
    # every decomposition sums back and uses only ladder widths
    for k in range(0, 40):
        ws = buckets.split_widths(k)
        assert sum(ws) == k
        assert all(w in buckets.WIDTHS for w in ws)


def test_width_cap_stops_stacking_past_the_crossover():
    # below the crossover the full ladder is available; at/above it the
    # bucket runs width-1 (stacking is a measured loss there)
    assert buckets.width_cap(buckets.Bucket(8, 2)) == buckets.WIDTHS[0]
    assert buckets.width_cap(buckets.Bucket(16, 5)) == buckets.WIDTHS[0]
    assert buckets.width_cap(buckets.Bucket(32, 8)) == buckets.WIDTHS[0]
    assert buckets.width_cap(buckets.Bucket(64, 16)) == 1
    assert buckets.width_cap(buckets.Bucket(4096, 1365)) == 1


def test_padded_config_requires_domination():
    cfg = tce.CeremonyConfig(CURVE, 5, 2)
    assert cfg.padded(8, 2).n == 8
    with pytest.raises(ValueError):
        cfg.padded(4, 2)
    with pytest.raises(ValueError):
        cfg.padded(8, 1)


def test_request_id_binds_identity_and_sequence():
    req = CeremonyRequest(CURVE, N, T, seed=1)
    assert engine.request_id(req, 0) == engine.request_id(req, 0)
    assert engine.request_id(req, 0) != engine.request_id(req, 1)
    other = CeremonyRequest(CURVE, N, T, seed=2)
    assert engine.request_id(req, 0) != engine.request_id(other, 0)


def test_convoy_key_separates_incompatible_requests():
    a = CeremonyRequest(CURVE, 5, 2, seed=1)
    b = CeremonyRequest(CURVE, 8, 2, seed=2)  # same bucket, same key
    assert a.convoy_key() == b.convoy_key()
    assert a.convoy_key() != CeremonyRequest(CURVE, 5, 2, rho_bits=64).convoy_key()
    assert (
        a.convoy_key()
        != CeremonyRequest(CURVE, 5, 2, shared_string=b"other").convoy_key()
    )


def test_start_convoy_rejects_mixed_keys():
    with pytest.raises(ValueError):
        engine.start_convoy(
            engine.WarmRuntime(device="cpu"),
            [
                CeremonyRequest(CURVE, N, T, seed=1),
                CeremonyRequest(CURVE, N, T, seed=2, rho_bits=64),
            ],
        )


# ---------------------------------------------------------------------------
# durability journal (pure python over PartyWal)
# ---------------------------------------------------------------------------


def test_journal_replay_partitions_pending_and_terminal(tmp_path):
    j = ServiceJournal(tmp_path)
    r1 = CeremonyRequest(CURVE, 5, 2, seed=11, durable=True, tag="one")
    r2 = CeremonyRequest(CURVE, 6, 2, seed=12, durable=True, deadline_s=9.0)
    j.record_request("cid1", 0, r1)
    j.record_request("cid2", 1, r2)
    j.record_done(
        CeremonyOutcome(
            ceremony_id="cid1", status="done", curve=CURVE, n=5, t=2,
            bucket_n=8, bucket_t=2, master=b"\x01\x02",
            qualified=(True,) * 5, complaints=((2, 1),),
        )
    )
    pending, terminal, replays = j.replay()
    assert set(pending) == {"cid2"} and replays == {}
    seq, req = pending["cid2"]
    assert seq == 1
    assert (req.curve, req.n, req.t, req.seed) == (CURVE, 6, 2, 12)
    assert req.durable and req.deadline_s == 9.0
    assert set(terminal) == {"cid1"}
    out = terminal["cid1"]
    assert out.status == "done" and out.master == b"\x01\x02"
    assert out.qualified == (True,) * 5 and out.complaints == ((2, 1),)


def test_journal_skips_unparseable_bodies_and_compacts(tmp_path):
    j = ServiceJournal(tmp_path)
    j.record_request("cid1", 0, CeremonyRequest(CURVE, 5, 2, seed=1, durable=True))
    j.wal.append(b"not json {")  # version skew, not corruption
    j.wal.append(json.dumps({"no": "kind"}).encode())
    pending, terminal, replays = j.replay()
    assert set(pending) == {"cid1"} and not terminal
    j.compact(pending, terminal, replays)
    # compacted journal replays to the identical state, junk dropped
    pending2, terminal2, _ = ServiceJournal(tmp_path).replay()
    assert set(pending2) == {"cid1"} and not terminal2
    assert pending2["cid1"][1] == pending["cid1"][1]


# ---------------------------------------------------------------------------
# scheduler semantics with the engine monkeypatched out (no JAX work)
# ---------------------------------------------------------------------------


class _FakeEngine:
    """Stand-in for start_convoy/finish_convoy: records convoy widths,
    optionally gates the start call on an event so tests can hold a
    worker mid-pipeline while they poke the queue."""

    def __init__(self, gate: threading.Event | None = None):
        self.gate = gate
        self.widths: list[int] = []
        self.starts = 0

    def start(self, runtime, reqs, ids=None):
        self.starts += 1
        self.widths.append(len(reqs))
        if self.gate is not None:
            assert self.gate.wait(timeout=10)
        return {"reqs": list(reqs), "ids": list(ids)}

    def finish(self, runtime, fl):
        return [
            CeremonyOutcome(
                ceremony_id=cid, status="done", curve=r.curve, n=r.n, t=r.t,
                bucket_n=r.bucket().n, bucket_t=r.bucket().t,
                master=b"M:" + cid.encode(),
                qualified=(True,) * r.n,
            )
            for cid, r in zip(fl["ids"], fl["reqs"])
        ]


@pytest.fixture()
def fake_engine(monkeypatch):
    fake = _FakeEngine(gate=threading.Event())
    monkeypatch.setattr(scheduler_mod, "start_convoy", fake.start)
    monkeypatch.setattr(scheduler_mod, "finish_convoy", fake.finish)
    yield fake
    fake.gate.set()  # never leave a worker parked on the gate


def _wait_status(sch, cid, status, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if sch.poll(cid) == status:
            return
        time.sleep(0.005)
    raise AssertionError(f"{cid} never reached {status} (at {sch.poll(cid)})")


def test_submit_validates_before_queueing(fake_engine):
    sch = CeremonyScheduler(concurrency=1, queue_depth=4, batch_max=1, runtime=object())
    try:
        with pytest.raises(ValueError):
            sch.submit(CeremonyRequest(CURVE, 1, 1))  # unbucketable
        with pytest.raises(ValueError):
            sch.submit(CeremonyRequest(CURVE, 5, 2, durable=True))  # no seed
        with pytest.raises(ValueError):  # seeded but scheduler has no WAL
            sch.submit(CeremonyRequest(CURVE, 5, 2, seed=1, durable=True))
        assert sch.poll("nonexistent") == "unknown"
        with pytest.raises(KeyError):
            sch.result("nonexistent")
    finally:
        fake_engine.gate.set()
        sch.close()


def test_backpressure_rejects_when_queue_full(fake_engine):
    reg = MetricsRegistry()
    sch = CeremonyScheduler(
        concurrency=1, queue_depth=2, batch_max=1, runtime=object(), metrics=reg
    )
    try:
        held = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=0))
        _wait_status(sch, held, "running")  # worker parked on the gate
        q1 = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=1))
        sch.submit(CeremonyRequest(CURVE, 5, 2, seed=2))
        with pytest.raises(QueueFullError):
            sch.submit(CeremonyRequest(CURVE, 5, 2, seed=3))
        assert sch.poll(q1) == "queued"
        with pytest.raises(TimeoutError):
            sch.result(q1, timeout=0.01)
        snap = reg.snapshot()["counters"]
        assert snap["service_rejected_total"] == 1
        assert snap["service_submitted_total"] == 3
    finally:
        fake_engine.gate.set()
        sch.close()
    assert sch.result(held).master == b"M:" + held.encode()
    assert sch.result(q1).status == "done"


def test_deadline_expires_queued_ceremonies(fake_engine):
    sch = CeremonyScheduler(concurrency=1, queue_depth=8, batch_max=1, runtime=object())
    try:
        held = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=0))
        _wait_status(sch, held, "running")
        doomed = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=1, deadline_s=0.05))
        time.sleep(0.15)  # expires while the worker is parked
    finally:
        fake_engine.gate.set()
    out = sch.result(doomed, timeout=5)
    assert out.status == "expired"
    assert out.error == "DEADLINE_EXCEEDED"
    assert out.master == b""
    sch.close()


def test_convoys_batch_same_key_in_ladder_widths(fake_engine):
    sch = CeremonyScheduler(concurrency=1, queue_depth=16, batch_max=8, runtime=object())
    try:
        held = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=0, rho_bits=32))
        _wait_status(sch, held, "running")
        # three same-key requests with a different-key one interleaved:
        # the stranger must never ride in their convoy
        ids_a = [
            sch.submit(CeremonyRequest(CURVE, 5, 2, seed=1 + i)) for i in range(2)
        ]
        id_b = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=9, rho_bits=64))
        ids_a.append(sch.submit(CeremonyRequest(CURVE, 5, 2, seed=3)))
    finally:
        fake_engine.gate.set()
    outs = [sch.result(i, timeout=10) for i in ids_a + [id_b, held]]
    assert all(o.status == "done" for o in outs)
    sch.close()
    # ladder truncation: 3 same-key mates pop as width 2 (next rung
    # under 3), then the different-key head as 1, then the leftover
    assert fake_engine.widths == [1, 2, 1, 1]


def test_close_without_drain_fails_queued_work(fake_engine):
    sch = CeremonyScheduler(concurrency=1, queue_depth=8, batch_max=1, runtime=object())
    held = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=0))
    _wait_status(sch, held, "running")
    dropped = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=1))
    fake_engine.gate.set()
    sch.close(drain=False)
    out = sch.result(dropped, timeout=5)
    assert out.status == "failed" and out.error == "SHUTDOWN"
    with pytest.raises(QueueFullError):
        sch.submit(CeremonyRequest(CURVE, 5, 2, seed=2))


def test_recovery_resubmits_pending_and_reserves_terminal(tmp_path, fake_engine):
    reg = MetricsRegistry()
    j = ServiceJournal(tmp_path)
    j.record_request("cidA", 0, CeremonyRequest(CURVE, 5, 2, seed=21, durable=True))
    j.record_request("cidB", 1, CeremonyRequest(CURVE, 5, 2, seed=22, durable=True))
    j.record_done(
        CeremonyOutcome(
            ceremony_id="cidT", status="done", curve=CURVE, n=5, t=2,
            bucket_n=8, bucket_t=2, master=b"\xaa\xbb",
        )
    )
    fake_engine.gate.set()  # recovery runs straight through
    sch = CeremonyScheduler(
        concurrency=1, queue_depth=8, batch_max=8,
        wal_dir=str(tmp_path), runtime=object(), metrics=reg,
    )
    # terminal outcome re-served from the journal, never re-run
    assert sch.poll("cidT") == "done"
    assert sch.result("cidT").master == b"\xaa\xbb"
    # pending ceremonies resubmitted under their ORIGINAL ids and run
    for cid in ("cidA", "cidB"):
        out = sch.result(cid, timeout=10)
        assert out.status == "done" and out.master == b"M:" + cid.encode()
    assert reg.snapshot()["counters"]["service_recovered_total"] == 2
    sch.close()
    starts_after_first = fake_engine.starts
    assert starts_after_first >= 1

    # second restart: everything is terminal now — nothing re-runs
    sch2 = CeremonyScheduler(
        concurrency=1, queue_depth=8, batch_max=8,
        wal_dir=str(tmp_path), runtime=object(),
    )
    for cid, master in (("cidA", b"M:cidA"), ("cidB", b"M:cidB"), ("cidT", b"\xaa\xbb")):
        assert sch2.poll(cid) == sch2.result(cid).status == "done"
        assert sch2.result(cid).master == master
    sch2.close()
    assert fake_engine.starts == starts_after_first


def test_scheduler_reads_envknobs(monkeypatch, fake_engine):
    monkeypatch.delenv("DKG_TPU_SERVICE_WAL_DIR", raising=False)
    monkeypatch.setenv("DKG_TPU_SERVICE_CONCURRENCY", "2")
    monkeypatch.setenv("DKG_TPU_SERVICE_QUEUE_DEPTH", "5")
    monkeypatch.setenv("DKG_TPU_SERVICE_BATCH_MAX", "4")
    monkeypatch.setenv("DKG_TPU_SERVICE_DEADLINE_S", "30.5")
    sch = CeremonyScheduler(runtime=object())
    try:
        assert sch.concurrency == 2
        assert sch.queue_depth == 5
        assert sch.batch_max == 4
        assert sch.default_deadline_s == 30.5
        assert len(sch._workers) == 2
    finally:
        fake_engine.gate.set()
        sch.close()
    monkeypatch.setenv("DKG_TPU_SERVICE_QUEUE_DEPTH", "zero")
    with pytest.raises(ValueError):
        CeremonyScheduler(runtime=object())


def test_default_concurrency_is_one_worker_over_a_card_runtime(monkeypatch, fake_engine):
    """One worker over a runtime on the card (its ``turn`` lock serialises
    the convoys), four over any other; the knob and the argument win."""
    import types

    import torch

    monkeypatch.delenv("DKG_TPU_SERVICE_WAL_DIR", raising=False)
    monkeypatch.delenv("DKG_TPU_SERVICE_CONCURRENCY", raising=False)
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    for runtime, want in ((card, 1), (types.SimpleNamespace(device=torch.device("cpu")), 4), (object(), 4)):
        sch = CeremonyScheduler(runtime=runtime)
        try:
            assert sch.concurrency == len(sch._workers) == want
        finally:
            fake_engine.gate.set()
            sch.close()
    monkeypatch.setenv("DKG_TPU_SERVICE_CONCURRENCY", "3")
    for kw, want in (({}, 3), ({"concurrency": 2}, 2)):
        sch = CeremonyScheduler(runtime=card, **kw)
        try:
            assert sch.concurrency == want
        finally:
            sch.close()


def test_scheduler_reads_resilience_envknobs(monkeypatch, fake_engine):
    monkeypatch.delenv("DKG_TPU_SERVICE_WAL_DIR", raising=False)
    monkeypatch.setenv("DKG_TPU_SERVICE_RETRIES", "0")
    monkeypatch.setenv("DKG_TPU_SERVICE_RETRY_BACKOFF_S", "0.25")
    monkeypatch.setenv("DKG_TPU_SERVICE_MAX_REPLAYS", "7")
    sch = CeremonyScheduler(concurrency=1, runtime=object())
    try:
        assert sch.retries == 0, "0 disables transient retries"
        assert sch.retry_backoff_s == 0.25
        assert sch.max_replays == 7
    finally:
        fake_engine.gate.set()
        sch.close()
    for name, bad in (
        ("DKG_TPU_SERVICE_RETRIES", "-1"),
        ("DKG_TPU_SERVICE_RETRY_BACKOFF_S", "fast"),
        ("DKG_TPU_SERVICE_MAX_REPLAYS", "0"),
    ):
        monkeypatch.setenv(name, bad)
        with pytest.raises(ValueError, match=name):
            CeremonyScheduler(concurrency=1, runtime=object())
        monkeypatch.delenv(name)


# ---------------------------------------------------------------------------
# blast-radius isolation, watchdog, crash-loop guard (engine monkeypatched)
# ---------------------------------------------------------------------------


def test_poison_bisection_isolates_one_request_at_width_4(fake_engine):
    """A width-4 convoy with one poisoned member: the three healthy
    requests complete exactly as a fault-free run would, and only the
    culprit — found by bisecting down the width ladder — ends poisoned."""
    reg = MetricsRegistry()
    plan = ServiceFaultPlan(seed=1).poison("bad")
    sch = CeremonyScheduler(
        concurrency=1, queue_depth=16, batch_max=8, runtime=object(),
        metrics=reg, fault_plan=plan,
    )
    try:
        held = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=0, rho_bits=32))
        _wait_status(sch, held, "running")  # park so a width-4 convoy forms
        ids = [
            sch.submit(
                CeremonyRequest(
                    CURVE, 5, 2, seed=10 + i,
                    tag="bad" if i == 2 else f"ok{i}",
                )
            )
            for i in range(4)
        ]
    finally:
        fake_engine.gate.set()
    outs = [sch.result(i, timeout=10) for i in ids]
    sch.close()
    for i, out in enumerate(outs):
        if i == 2:
            assert out.status == "poisoned"
            assert out.error.startswith("PoisonedRequest: PoisonFault")
        else:
            assert out.status == "done"
            assert out.master == b"M:" + ids[i].encode()
    snap = reg.snapshot()["counters"]
    assert snap["service_poisoned_total"] == 1
    # width 4 -> halves (2, 2) -> the bad half -> (1, 1): two bisections
    assert snap["service_convoy_bisections_total"] == 2
    # the poison refired at widths 4, 2, and 1 — deterministic chaos
    assert plan.injected["poison"] == 3


def test_transient_fault_retries_and_recovers(fake_engine):
    reg = MetricsRegistry()
    plan = ServiceFaultPlan().transient(times=1)
    sch = CeremonyScheduler(
        concurrency=1, queue_depth=8, batch_max=1, runtime=object(),
        metrics=reg, fault_plan=plan, retries=2, retry_backoff_s=0.0,
    )
    fake_engine.gate.set()
    cid = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=0))
    out = sch.result(cid, timeout=10)
    sch.close()
    assert out.status == "done" and out.master == b"M:" + cid.encode()
    snap = reg.snapshot()["counters"]
    assert snap["service_retries_total"] == 1
    assert "service_poisoned_total" not in snap
    assert "service_convoy_bisections_total" not in snap


def test_transient_retries_exhausted_fail_typed(fake_engine):
    reg = MetricsRegistry()
    plan = ServiceFaultPlan().transient(times=10)
    sch = CeremonyScheduler(
        concurrency=1, queue_depth=8, batch_max=1, runtime=object(),
        metrics=reg, fault_plan=plan, retries=1, retry_backoff_s=0.0,
    )
    fake_engine.gate.set()
    cid = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=0))
    out = sch.result(cid, timeout=10)
    sch.close()
    assert out.status == "failed"
    assert out.error.startswith("TransientEngineError")
    snap = reg.snapshot()["counters"]
    assert snap["service_retries_total"] == 1
    assert snap['service_failed_total{kind="TransientEngineError"}'] == 1


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning"
)
def test_watchdog_respawns_crashed_worker_and_requeues(fake_engine):
    """A WorkerCrash (BaseException) kills the worker THREAD; the
    watchdog respawns it and re-queues the orphaned convoy, which then
    completes normally."""
    reg = MetricsRegistry()
    plan = ServiceFaultPlan().crash_worker(at_start=1)
    sch = CeremonyScheduler(
        concurrency=1, queue_depth=8, batch_max=1, runtime=object(),
        metrics=reg, fault_plan=plan, watchdog_interval_s=0.05,
    )
    fake_engine.gate.set()
    cid = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=0))
    out = sch.result(cid, timeout=10)
    sch.close()
    assert out.status == "done" and out.master == b"M:" + cid.encode()
    snap = reg.snapshot()["counters"]
    assert snap["service_worker_restarts_total"] >= 1
    assert snap["service_requeued_total"] == 1


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning"
)
def test_repeated_worker_crashes_fail_the_request_typed(fake_engine):
    """A request whose convoy kills its worker TWICE is treated as the
    probable culprit: failed with WORKER_CRASH instead of crash-looping
    the pool forever."""
    reg = MetricsRegistry()
    plan = ServiceFaultPlan().crash_worker(at_start=1).crash_worker(at_start=2)
    sch = CeremonyScheduler(
        concurrency=1, queue_depth=8, batch_max=1, runtime=object(),
        metrics=reg, fault_plan=plan, watchdog_interval_s=0.05,
    )
    fake_engine.gate.set()
    cid = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=0))
    out = sch.result(cid, timeout=10)
    sch.close()
    assert out.status == "failed"
    assert "WORKER_CRASH" in out.error
    snap = reg.snapshot()["counters"]
    assert snap["service_worker_restarts_total"] >= 2
    assert snap['service_failed_total{kind="WORKER_CRASH"}'] == 1


def test_crash_loop_guard_counts_replays_and_poisons(tmp_path, fake_engine):
    reg = MetricsRegistry()
    j = ServiceJournal(tmp_path)
    j.record_request(
        "cidR", 0, CeremonyRequest(CURVE, 5, 2, seed=31, durable=True)
    )
    fake_engine.gate.set()
    sch = CeremonyScheduler(
        concurrency=1, queue_depth=8, batch_max=1,
        wal_dir=str(tmp_path), runtime=object(), metrics=reg,
    )
    assert sch.result("cidR", timeout=10).status == "done"
    sch.close()
    # the recovery stamped replay #1 into the WAL before re-queueing:
    # the crash-loop guard's memory of this attempt survives compaction
    _, terminal, replays = ServiceJournal(tmp_path).replay()
    assert "cidR" in terminal and replays == {"cidR": 1}

    # a request that already burned max_replays recoveries is the likely
    # CAUSE of those crashes: the next recovery poisons it instead of
    # queueing it for another round of taking the process down
    j2 = ServiceJournal(tmp_path)
    j2.record_request(
        "cidP", 1, CeremonyRequest(CURVE, 5, 2, seed=32, durable=True)
    )
    for count in (1, 2, 3):
        j2.record_replay("cidP", count)
    reg2 = MetricsRegistry()
    sch2 = CeremonyScheduler(
        concurrency=1, queue_depth=8, batch_max=1,
        wal_dir=str(tmp_path), runtime=object(), metrics=reg2,
        max_replays=3,
    )
    assert sch2.poll("cidP") == "poisoned"
    out = sch2.result("cidP")
    assert out.error.startswith("PoisonedRequest") and "REPLAY_LIMIT" in out.error
    assert reg2.snapshot()["counters"]["service_poisoned_total"] == 1
    sch2.close()

    # the poisoned verdict is itself journalled: the NEXT recovery
    # re-serves it terminally without another replay round
    sch3 = CeremonyScheduler(
        concurrency=1, queue_depth=8, batch_max=1,
        wal_dir=str(tmp_path), runtime=object(), max_replays=3,
    )
    assert sch3.poll("cidP") == "poisoned"
    sch3.close()


def test_failure_paths_emit_kind_only_never_payloads(
    tmp_path, fake_engine, monkeypatch
):
    """The obslog redaction contract for the service failure paths:
    reject/expire/poison events carry the error KIND and ceremony id,
    never the exception message (which may embed share or seed
    material).  The caller-facing outcome keeps the full error."""

    canary = "5ecret-c4nary-d34db33f"
    log = ObsLog(path=tmp_path / "svc.jsonl")
    reg = MetricsRegistry()

    # leg 1 (fake engine): backpressure reject + queued-deadline expiry
    sch = CeremonyScheduler(
        concurrency=1, queue_depth=1, batch_max=1, runtime=object(),
        metrics=reg, log=log,
    )
    held = sch.submit(CeremonyRequest(CURVE, 5, 2, seed=0))
    _wait_status(sch, held, "running")
    doomed = sch.submit(
        CeremonyRequest(CURVE, 5, 2, seed=1, deadline_s=0.01)
    )
    with pytest.raises(QueueFullError):
        sch.submit(CeremonyRequest(CURVE, 5, 2, seed=2))
    time.sleep(0.05)
    fake_engine.gate.set()
    assert sch.result(doomed, timeout=10).status == "expired"
    sch.close()

    # leg 2: an engine exploding with secret-bearing text -> poisoned
    def _bomb(runtime, reqs, ids=None):
        raise RuntimeError(f"engine exploded holding {canary}")

    monkeypatch.setattr(scheduler_mod, "start_convoy", _bomb)
    sch2 = CeremonyScheduler(
        concurrency=1, queue_depth=4, batch_max=1, runtime=object(),
        metrics=reg, log=log,
    )
    cid = sch2.submit(CeremonyRequest(CURVE, 5, 2, seed=3))
    out = sch2.result(cid, timeout=10)
    sch2.close()
    assert out.status == "poisoned"
    assert canary in out.error, "the CALLER gets the full error"

    log.close()
    raw = (tmp_path / "svc.jsonl").read_text()
    assert canary not in raw, "the obslog stream must never see payloads"
    events = [json.loads(line) for line in raw.splitlines()]
    kinds = {e["kind"] for e in events}
    assert {"service_rejected", "service_expired", "service_poisoned"} <= kinds
    rej = next(e for e in events if e["kind"] == "service_rejected")
    assert rej["error_kind"] == "QUEUE_FULL"
    pois = next(e for e in events if e["kind"] == "service_poisoned")
    assert pois["error_kind"] == "RuntimeError" and pois["ceremony"] == cid
    # each failure path owns a DISTINCT metric series
    snap = reg.snapshot()["counters"]
    assert snap["service_rejected_total"] == 1
    assert snap['service_expired_total{where="queued"}'] == 1
    assert snap["service_poisoned_total"] == 1
