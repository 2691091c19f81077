"""The port's EpochManager end to end on the CPU (the kernels' plain
versions): tests/test_epoch.py's clean run, a refresh and then a reshare
in which one member leaves and one joins, at ristretto255 n = 4, t = 1,
each party's flight-recorder events (``utils.obslog``, one recorder a
party thread) in the JAX manager's kinds and order, valid under the JAX
package's ``validate_events``.

Genesis is the port's committee phases 1-5 on the host, the aggregate
commitments the pointwise sum of the qualified dealers' bare commitments
(dkg_tpu/net/party.py's rule).  The parties are threads over one
InProcessChannel, each with a PartyWal, taking turns (``TurnTaking``);
then one party is rebuilt from its WAL and replays both operations.
"""

import functools
import pathlib
import random
import re
import threading
from types import SimpleNamespace

from dkg_tpu.utils import obslog as jobslog

from dkg_tpu_torch.dkg import committee as cm
from dkg_tpu_torch.dkg.procedure_keys import MemberCommunicationKey, sort_committee
from dkg_tpu_torch.epoch import EpochManager, EpochState, encode_epoch_state, genesis_from_party_result
from dkg_tpu_torch.groups import host as gh
from dkg_tpu_torch.net import InProcessChannel, wal_path
from dkg_tpu_torch.utils import obslog
from dkg_tpu_torch.utils.metrics import REGISTRY
from torch_port_util import one_thread  # noqa: F401

G = gh.RISTRETTO255
N, T, LEAVER, RESUMED = 4, 1, 2, 3


class TurnTaking:
    """An InProcessChannel whose parties take turns: a party's thread holds
    ``lock`` except while it waits in a fetch (threads that all run many
    small tensor ops slow each other down handing the interpreter lock
    back and forth)."""

    def __init__(self, chan):
        self.chan, self.lock = chan, threading.Lock()

    def publish(self, round_no, sender, payload):
        self.chan.publish(round_no, sender, payload)

    def fetch(self, round_no, expected, timeout=30.0):
        self.lock.release()
        try:
            return self.chan.fetch(round_no, expected, timeout)
        finally:
            self.lock.acquire()


def _genesis(n: int, t: int, seed: int):
    rng = random.Random(seed)
    env = cm.Environment.init(G, t, n, b"epoch-manager-test")
    keys = [MemberCommunicationKey.generate(G, rng) for _ in range(n)]
    pks = sort_committee(G, [k.public() for k in keys])
    by_enc = {k.public().sort_key(G): k for k in keys}
    keys = [by_enc[p.sort_key(G)] for p in pks]
    r1 = [cm.DistributedKeyGeneration.init(env, rng, keys[i], pks, i + 1) for i in range(n)]
    f1 = [cm.FetchedPhase1.from_broadcast(env, j + 1, b) for j, (_, b) in enumerate(r1)]
    r2 = [p.proceed(f1, rng) for p, _ in r1]
    c2 = [cm.FetchedComplaints2(i + 1, b) for i, (_, b) in enumerate(r2)]
    r3 = [p.proceed(c2, f1) for p, _ in r2]
    f3 = [cm.FetchedPhase3.from_broadcast(env, j + 1, b) for j, (_, b) in enumerate(r3)]
    r4 = [p.proceed(f3) for p, _ in r3]
    c4 = [cm.FetchedComplaints4(i + 1, b) for i, (_, b) in enumerate(r4)]
    r5 = [p.proceed(c4) for p, _ in r4]
    f5 = [cm.FetchedPhase5(i + 1, b) for i, (_, b) in enumerate(r5)]
    results = []
    for i, (p, _) in enumerate(r5):
        (master, share), _ = p.finalise(f5)
        st = p._state
        qual = [j for j in range(1, n + 1) if st.qualified[j - 1]]
        agg = tuple(functools.reduce(G.add, [st.bare_coeffs[j][lvl] for j in qual]) for lvl in range(t + 1))
        results.append(SimpleNamespace(ok=True, index=i + 1, share=share, commitments=agg, master=master))
    return env, keys, pks, results


def test_refresh_then_reshare_with_a_leaver_and_a_joiner(tmp_path):
    env, keys, pks, results = _genesis(N, T, 0xA11CE)
    base = {G.encode(r.master.point) for r in results}
    assert len(base) == 1 and all(G.eq(r.commitments[0], r.master.point) for r in results)
    joiner = MemberCommunicationKey.generate(G, random.Random(0x101))
    new_pks = [p for i, p in enumerate(pks) if i + 1 != LEAVER] + [joiner.public()]
    chan = TurnTaking(InProcessChannel())
    outs = {}
    logs = {i: obslog.ObsLog(party=i) for i in range(1, N + 2)}
    before = REGISTRY.snapshot()["counters"]

    def founding(i):
        with chan.lock, obslog.use(logs[i + 1]):
            try:
                mgr = EpochManager(chan, G, genesis_from_party_result(env, results[i]), keys[i], pks,
                                   random.Random(100 + i), timeout=300.0, checkpoint=wal_path(tmp_path, i + 1),
                                   max_churn=2, device="cpu")
                outs[i + 1] = (mgr.refresh(), mgr.reshare(new_pks, T))
            except Exception as exc:  # noqa: BLE001 -- asserted below
                outs[i + 1] = exc

    def joining():
        with chan.lock, obslog.use(logs[N + 1]):
            try:
                observer = EpochState(epoch=1, n=N, t=T, index=None, share=None, commitments=None)
                mgr = EpochManager(chan, G, observer, joiner, pks, random.Random(200), timeout=300.0,
                                   first_fetch_timeout=600.0, checkpoint=wal_path(tmp_path, N + 1), max_churn=2,
                                   ops_done=1, device="cpu")
                outs[N + 1] = (None, mgr.reshare(new_pks, T))
            except Exception as exc:  # noqa: BLE001 -- asserted below
                outs[N + 1] = exc

    threads = [threading.Thread(target=founding, args=(i,)) for i in range(N)] + [threading.Thread(target=joining)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900.0)
    assert not any(th.is_alive() for th in threads)
    assert all(not isinstance(o, Exception) for o in outs.values()), outs
    assert sorted(outs) == list(range(1, N + 2))

    master = base.pop()
    for i in range(1, N + 1):
        assert outs[i][0].epoch == 1 and outs[i][0].holds_share and G.encode(outs[i][0].master) == master
    assert outs[LEAVER][1] is None  # the leaver dealt and holds nothing
    stayers = [s2 for i, (_, s2) in outs.items() if i != LEAVER]
    for st in stayers:
        assert st.epoch == 2 and st.holds_share and G.encode(st.master) == master
    assert sorted(st.index for st in stayers) == list(range(1, N + 1))
    assert len({tuple(G.encode(c) for c in st.commitments) for st in stayers}) == 1
    after = REGISTRY.snapshot()["counters"]
    for kind, ops in (("refresh", N), ("reshare", N + 1)):
        key = f'epoch_ops_total{{kind="{kind}",status="ok"}}'
        assert after.get(key, 0) - before.get(key, 0) == ops

    # the flight recorder: each party's events in the JAX manager's order
    steps = ["epoch_wal_record", "epoch_head", "epoch_publish", "epoch_tail"]
    full = steps * 3 + ["epoch_done"]
    want = {i: full + (full if i != LEAVER else steps[:3] + ["epoch_wal_record", "epoch_done"])
            for i in range(1, N + 1)}
    want[N + 1] = ["epoch_tail"] + steps * 2 + ["epoch_done"]  # the joiner deals nothing
    for i, log in logs.items():
        events = log.events()
        assert [e["kind"] for e in events] == want[i], i
        assert jobslog.validate_events(events) == [] and obslog.validate_events(events) == []
        assert {e["op_kind"] for e in events if e["kind"] == "epoch_done"} <= {"refresh", "reshare"}
        assert all(e["status"] == "ok" for e in events if e["kind"] == "epoch_done")
    jax_src = (pathlib.Path(jobslog.__file__).parents[1] / "epoch" / "manager.py").read_text()
    port_src = (pathlib.Path(obslog.__file__).parents[1] / "epoch" / "manager.py").read_text()
    emits = re.compile(r'emit_current\(\s*"(\w+)"')
    assert emits.findall(port_src) == emits.findall(jax_src)  # every emit site, in the JAX manager's order

    # rebuilt from its WAL with a fresh rng: every step replays to the same states
    resumed = EpochManager(chan.chan, G, genesis_from_party_result(env, results[RESUMED - 1]), keys[RESUMED - 1],
                           pks, random.Random(999), timeout=300.0, checkpoint=wal_path(tmp_path, RESUMED),
                           max_churn=2, device="cpu")
    replayed = (resumed.refresh(), resumed.reshare(new_pks, T))
    assert resumed.resumed_steps == 6
    assert [encode_epoch_state(G, s) for s in replayed] == [encode_epoch_state(G, s) for s in outs[RESUMED]]
