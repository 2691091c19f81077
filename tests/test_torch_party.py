"""``run_party`` and ``run_with_faults`` (``dkg_tpu_torch.net``) against
the JAX package's: the same committee keys and rng seeds give the same
bytes in every round, the same master key and the same secret shares,
over an ``InProcessChannel``; a party that restarts resumes from its WAL
to the same outcome; and a fault plan (garbage, an equivocation, a crash,
a restart) ends in equal outcomes in both packages.  Everything by exact
equality: the committee's host arithmetic is exact on both sides.
"""

from __future__ import annotations

import random
import threading

import pytest
from torch_port_util import one_thread  # noqa: F401

from dkg_tpu.groups import host as jgh
from dkg_tpu.net import channel as jch
from dkg_tpu.net import faults as jfaults
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.net import channel as tch
from dkg_tpu_torch.net import checkpoint as tcp
from dkg_tpu_torch.net import faults as tfaults
from dkg_tpu_torch.net import party as tparty

N, T = 4, 1
PACKAGES = {"port": (tfaults, tch, tgh), "jax": (jfaults, jch, jgh)}


def _ceremony(package: str, curve: str, plan_of, seed: int, timeout: float = 20.0, wal_dir=None):
    """One threaded ceremony of ``package`` over one InProcessChannel:
    (outcomes, the channel)."""
    faults, chan_mod, gh = PACKAGES[package]
    group = gh.ALL_GROUPS[curve]
    env, keys, pks = faults.make_committee(group, N, T, seed)
    chan = chan_mod.InProcessChannel()
    plan = plan_of(faults.FaultPlan(seed))
    out = faults.run_with_faults(env, keys, pks, plan, lambda i: chan, timeout=timeout, seed=seed,
                                 checkpoint_dir=None if wal_dir is None else str(wal_dir / package))
    return out, chan, group, plan


def _summary(group, outcome):
    """A party's outcome as plain values: ok, the master's encoding, the
    share, the aggregate commitments' encodings and the counters."""
    if not hasattr(outcome, "ok"):
        return type(outcome).__name__
    enc = None if outcome.commitments is None else [group.encode(c) for c in outcome.commitments]
    return (outcome.ok, outcome.index, group.encode(outcome.master.point) if outcome.master else None,
            outcome.share.value if outcome.share else None, enc,
            getattr(outcome.error, "kind", None) and outcome.error.kind.name,
            outcome.quarantined, outcome.timeouts, outcome.resumes, outcome.replayed_rounds)


def _same_runs(curve, plan_of, seed, timeout=20.0, wal_dir=None):
    runs = {p: _ceremony(p, curve, plan_of, seed, timeout, wal_dir) for p in PACKAGES}
    (t_out, t_chan, t_group, t_plan), (j_out, j_chan, j_group, j_plan) = runs["port"], runs["jax"]
    assert t_plan.as_dict() == j_plan.as_dict()
    assert t_chan._rounds == j_chan._rounds  # every round's published bytes
    assert t_chan.equivocation_evidence() == j_chan.equivocation_evidence()
    got = [_summary(t_group, o) for o in t_out]
    assert got == [_summary(j_group, o) for o in j_out]
    return t_out, t_chan


@pytest.mark.parametrize("curve", ["ristretto255", "secp256k1"])
def test_run_party_matches_jax(curve):
    """A fault-free (4, 1) ceremony: the same bytes published in each of
    the five rounds, the same master key and shares; every party ok, with
    the aggregate commitments the epochs start from (A_0 = master)."""
    out, chan = _same_runs(curve, lambda plan: plan, seed=0xA11CE)
    group = tgh.ALL_GROUPS[curve]
    assert sorted(chan._rounds) == [1, 2, 3, 4, 5]
    assert all(r.ok and r.quarantined == 0 and r.timeouts == 0 for r in out)
    assert all(group.eq(r.commitments[0], r.master.point) for r in out)
    assert group.eq(group.scalar_mul(out[0].share.value, group.generator()),
                    _eval(group, out[0].commitments, 1))


def _eval(group, comms, x):
    acc = group.identity()
    for c in reversed(comms):
        acc = group.add(group.scalar_mul(x, acc), c)
    return acc


def test_wal_resume_matches_jax(tmp_path):
    """Party 2 dies mid-round 3 and is re-spawned from its WAL with a fresh
    rng: it replays rounds 1-3, publishes nothing new that differs, and
    every outcome (resumes counted) equals the JAX package's."""
    out, _ = _same_runs("ristretto255", lambda plan: plan.restart(sender=2, round_no=3), seed=0xB0B,
                        wal_dir=tmp_path)
    assert all(r.ok for r in out)
    assert out[1].resumes == 1 and out[1].replayed_rounds == 3
    wal = tcp.PartyWal(tcp.wal_path(str(tmp_path / "port"), 2))
    assert len(wal.replay()) == out[1].wal_records == 5


def test_wal_reset_and_unusable_log(tmp_path):
    """A log that exists but replays to nothing is recreated empty, and the
    party runs fresh from round 1."""
    path = tmp_path / "p.wal"
    path.write_bytes(b"garbage, not a WAL")
    wal = tcp.PartyWal(path)
    assert wal.replay() == []
    wal.reset()
    assert path.read_bytes() == b"" and wal.replay() == []
    path.write_bytes(b"garbage again")
    group = tgh.RISTRETTO255
    env, keys, pks = tfaults.make_committee(group, 2, 1, 5)
    chan = tch.InProcessChannel()
    res = [None, None]

    def run(i):
        res[i] = tparty.run_party(chan, env, keys[i], pks, i + 1, random.Random(i), timeout=20.0,
                                  checkpoint=path if i == 0 else None)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert res[0].ok and res[0].resumes == 0 and res[0].wal_records == 5
    assert len(tcp.PartyWal(path).replay()) == 5


def test_run_with_faults_matches_jax(tmp_path):
    """Garbage from party 2 in round 1 (quarantined: it is disqualified),
    party 3 equivocating in round 3 (the first publish kept, evidence
    recorded), party 4 crashing before round 5 and party 1 restarting in
    round 2 from its WAL: the same outcomes, bytes and evidence in both
    packages."""
    def plan_of(plan):
        return plan.garbage(1, sender=2).equivocate(3, sender=3).crash_after(sender=4, round_no=4) \
            .restart(sender=1, round_no=2)

    out, chan = _same_runs("ristretto255", plan_of, seed=0xC4A5, timeout=3.0, wal_dir=tmp_path)
    group = tgh.RISTRETTO255
    assert type(out[3]).__name__ == "CrashFault"
    survivors = [out[0], out[2]]
    assert all(r.ok and r.quarantined == 1 and r.timeouts == 1 for r in survivors) and out[0].resumes == 1
    assert len({group.encode(r.master.point) for r in survivors}) == 1
    # the garbage sender never saw its own round-1 bytes fail: it keeps itself
    # qualified and so ends on another key
    assert out[1].ok and group.encode(out[1].master.point) != group.encode(out[0].master.point)
    assert list(chan.equivocation_evidence()) == [(3, 3)]
    assert tfaults.honest_results(out, plan_of(tfaults.FaultPlan(0xC4A5))) == []  # every party was touched
