"""The port's flight recorder (dkg_tpu_torch.utils.obslog) against the JAX
package's: the same event schema, events the JAX package's
``validate_events`` accepts and its ``load_jsonl`` reads back (and the
reverse), the same redaction, file naming and ambient scoping across
threads, and the scheduler's service events, valid under both packages'
validators.  No device work."""

import json
import threading

import pytest

from dkg_tpu.utils import obslog as jobslog
from dkg_tpu_torch.service import scheduler as scheduler_mod
from dkg_tpu_torch.service.engine import CeremonyOutcome, CeremonyRequest
from dkg_tpu_torch.service.faultsvc import ServiceFaultPlan
from dkg_tpu_torch.utils import obslog
from dkg_tpu_torch.utils.metrics import MetricsRegistry
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

SAMPLES = {
    "epoch_head": dict(round=4, op=1, step=1, op_kind="refresh"),
    "epoch_publish": dict(round=4, bytes=120, seq=0),
    "epoch_tail": dict(round=4, present=3, senders=[1, 2, 3], timed_out=False),
    "epoch_quarantine": dict(round=5, peer=2),
    "epoch_wal_record": dict(op=1, step=2, bytes=77),
    "epoch_done": dict(op=1, op_kind="reshare", status="ok", epoch=2),
    "service_fault_injected": dict(fault="poison"),
}


def test_schema_is_the_jax_packages():
    assert obslog.EVENT_SCHEMA == jobslog.EVENT_SCHEMA
    assert obslog._SCHEMA_BASE == jobslog._SCHEMA_BASE


def test_events_validate_under_both_packages_and_round_trip(tmp_path):
    port = obslog.ObsLog(path=tmp_path / "port.jsonl", ceremony_id="c0ffee", party=3)
    jax = jobslog.ObsLog(path=tmp_path / "jax.jsonl", ceremony_id="c0ffee", party=3)
    for log in (port, jax):
        for kind, fields in SAMPLES.items():
            log.emit(kind, **fields)
        log.emit_span("sign_convoy", ts0=1.0, mono0=2.0, dur_s=0.5, subs={"hash_s": 0.1}, curve="secp256k1",
                      requests=2, messages=8, ceremonies=1, proved=False, reason="full", errors=0)
        log.close()
    events = port.events()
    assert jobslog.validate_events(events) == [] and obslog.validate_events(events) == []
    strip = [{k: v for k, v in e.items() if k not in ("ts", "mono")} for e in events]
    assert strip == [{k: v for k, v in e.items() if k not in ("ts", "mono")} for e in jax.events()]
    assert jobslog.load_jsonl(tmp_path / "port.jsonl") == events
    assert obslog.load_jsonl(tmp_path / "jax.jsonl") == jax.events()
    bad = [{"kind": "epoch_head", "ts": 0, "mono": 0, "round": 1}]
    assert obslog.validate_events(bad) == jobslog.validate_events(bad) != []


def test_bytes_are_redacted_to_their_length():
    log = obslog.ObsLog()
    ev = log.emit("publish", round=1, bytes=3, seq=0, payload=b"secret", nested={"k": [b"ab"]})
    assert ev["payload"] == "bytes:6" and ev["nested"] == {"k": ["bytes:2"]}


def test_from_env_names_files_as_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.delenv("DKG_TPU_OBSLOG", raising=False)
    assert obslog.from_env() is None
    monkeypatch.setenv("DKG_TPU_OBSLOG", str(tmp_path))
    for party in (7, "hub", None):
        a = obslog.from_env(ceremony_id="abc", party=party)
        b = jobslog.from_env(ceremony_id="abc", party=party)
        assert a.path == b.path
        a.close()
        b.close()


def test_ambient_recorder_scopes_per_thread_and_nests():
    outer, inner, other = obslog.ObsLog(), obslog.ObsLog(), obslog.ObsLog()
    assert obslog.current() is None and obslog.emit_current("epoch_head", round=1) is None
    seen = {}

    def thread():
        seen["start"] = obslog.current()
        with obslog.use(other):
            obslog.emit_current("epoch_tail", round=2, present=0, senders=[], timed_out=True)
            seen["bound"] = obslog.current()
        seen["end"] = obslog.current()

    with obslog.use(outer):
        t = threading.Thread(target=thread)
        t.start()
        t.join()
        with obslog.use(inner):
            obslog.emit_current("epoch_publish", round=1, bytes=1, seq=0)
            assert obslog.current() is inner
        assert obslog.current() is outer
        with obslog.use(None):
            assert obslog.emit_current("epoch_publish", round=1, bytes=1, seq=1) is None
        obslog.emit_current("epoch_done", op=1, op_kind="refresh", status="ok")
    assert obslog.current() is None
    assert seen == {"start": None, "bound": other, "end": None}
    assert [e["kind"] for e in outer.events()] == ["epoch_done"]
    assert [e["kind"] for e in inner.events()] == ["epoch_publish"]
    assert [e["kind"] for e in other.events()] == ["epoch_tail"]


class _Engine:
    def start(self, runtime, reqs, ids=None):
        return {"reqs": list(reqs), "ids": list(ids)}

    def finish(self, runtime, fl):
        return [CeremonyOutcome(ceremony_id=cid, status="done", curve=r.curve, n=r.n, t=r.t, master=b"M",
                                qualified=(True,) * r.n) for cid, r in zip(fl["ids"], fl["reqs"])]


def test_scheduler_events_validate_under_both_packages(tmp_path, monkeypatch):
    fake = _Engine()
    monkeypatch.setattr(scheduler_mod, "start_convoy", fake.start)
    monkeypatch.setattr(scheduler_mod, "finish_convoy", fake.finish)
    log = obslog.ObsLog(path=tmp_path / "svc.jsonl")
    plan = ServiceFaultPlan(seed=3).poison("bad").transient(times=1)
    sch = scheduler_mod.CeremonyScheduler(concurrency=1, queue_depth=8, batch_max=4, runtime=object(),
                                          metrics=MetricsRegistry(), log=log, fault_plan=plan, retry_backoff_s=0.0)
    with obslog.use(log):  # the fault plan emits into the ambient recorder of the thread that starts
        ids = [sch.submit(CeremonyRequest("ristretto255", 5, 2, seed=i, tag="bad" if i == 1 else "")) for i in range(3)]
        outs = [sch.result(i, timeout=30) for i in ids]
    sch.close()
    assert [o.status for o in outs].count("poisoned") == 1
    events = [json.loads(line) for line in (tmp_path / "svc.jsonl").read_text().splitlines()]
    kinds = {e["kind"] for e in events}
    assert {"service_retry", "service_poisoned"} <= kinds
    assert jobslog.validate_events(events, allow_unknown=True) == []
    assert obslog.validate_events(events, allow_unknown=True) == []
    with pytest.raises(AssertionError):
        assert obslog.validate_events(events) == []  # service_* kinds are the deployment's own
