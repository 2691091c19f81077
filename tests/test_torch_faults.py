"""Fault injection (``dkg_tpu_torch.net.faults``) against the JAX
package's, and the epoch chaos harness on the CPU.

``FaultPlan``'s seeded corruptions (garbage, bit flips, truncations), its
JSON description, what ``FaultyChannel`` puts on a channel for each fault
kind, and ``churn_schedule`` equal the JAX package's over many seeds: pure
Python, no compile.  Then the port's ``run_epochs_with_faults`` at n = 5,
t = 2 (a ceremony, a refresh, a 1-leave/1-join reshare; the kernels' plain
versions) against the port's ``EpochManager`` driven directly over the
same ceremony: the same states, byte for byte.  The JAX package's
``run_epochs_with_faults`` is not run here: its epoch kernels compile for
minutes on the CPU.
"""

from __future__ import annotations

import random
import threading

import pytest
from torch_port_util import one_thread  # noqa: F401

from dkg_tpu.net import channel as jch
from dkg_tpu.net import faults as jfaults
from dkg_tpu_torch.epoch import EpochManager, EpochState, encode_epoch_state, genesis_from_party_result
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.net import channel as tch
from dkg_tpu_torch.net import faults as tfaults
from dkg_tpu_torch.net import party as tparty

SEEDS = range(64)


def _plans(seed: int):
    """The same random plan in both packages: every payload fault kind."""
    out = []
    for faults in (tfaults, jfaults):
        rng = random.Random(seed)
        plan = faults.FaultPlan(seed)
        for r in range(1, 9):
            sender = rng.randrange(1, 9)
            kind = rng.choice(["garbage", "truncate", "bitflip", "duplicate", "equivocate", "drop", "replace"])
            if kind == "garbage":
                plan.garbage(r, sender, rng.choice([None, 0, 1, 300]))
            elif kind == "truncate":
                plan.truncate(r, sender, rng.choice([None, 0, 5]))
            elif kind == "replace":
                plan.replace(r, sender, rng.randbytes(7))
            else:
                getattr(plan, kind)(r, sender)
        plan.crash_after(sender=rng.randrange(1, 9), round_no=rng.randrange(1, 6))
        plan.restart(sender=rng.randrange(1, 9), round_no=rng.randrange(1, 6))
        out.append(plan)
    return out


@pytest.mark.parametrize("block", range(4))
def test_fault_plan_bytes_match_jax(block):
    """garbage_bytes, flip_one_bit, truncate_bytes and as_dict equal the
    JAX package's for 64 seeds a block, at several rounds and senders."""
    for seed in range(block * 64, (block + 1) * 64):
        t, j = tfaults.FaultPlan(seed), jfaults.FaultPlan(seed)
        payload = random.Random(seed).randbytes(seed % 97)
        for r, s in ((1, 1), (2, 7), (5, 300), (255, 65535)):
            for nbytes in (None, 0, 17):
                assert t.garbage_bytes(r, s, nbytes) == j.garbage_bytes(r, s, nbytes)
            assert t.flip_one_bit(r, s, payload) == j.flip_one_bit(r, s, payload)
            for keep in (None, 3):
                assert t.truncate_bytes(r, s, payload, keep) == j.truncate_bytes(r, s, payload, keep)
        tp, jp = _plans(seed)
        assert tp.as_dict() == jp.as_dict()


def test_faulty_channel_matches_jax():
    """Each seed's plan applied by FaultyChannel to eight senders' publishes
    over eight rounds: the same mailboxes, evidence, crashes and restarts."""
    for seed in SEEDS:
        tp, jp = _plans(seed)
        seen = []
        for faults, chan_mod, plan in ((tfaults, tch, tp), (jfaults, jch, jp)):
            inner = chan_mod.InProcessChannel()
            events = []
            for party in range(1, 9):
                wrapped = faults.FaultyChannel(inner, plan, party)
                for r in range(1, 9):
                    try:
                        wrapped.publish(r, party, b"msg-%d-%d" % (r, party) * (party % 3 + 1))
                        wrapped.fetch(r, 0, timeout=0.0)
                        events.append((party, r, "ok"))
                    except faults.RestartFault:
                        events.append((party, r, "restart"))
                    except faults.CrashFault:
                        events.append((party, r, "crash"))
            seen.append((inner._rounds, inner.equivocation_evidence(), events))
        assert seen[0] == seen[1]


def test_churn_schedule_matches_jax():
    for seed in SEEDS:
        for n in (4, 6, 9):
            for k in range(n + 1):
                t, j = tfaults.churn_schedule(seed, n, k), jfaults.churn_schedule(seed, n, k)
                assert (t.leavers, t.joiners, t.churn) == (j.leavers, j.joiners, j.churn)
    with pytest.raises(ValueError, match="churn"):
        tfaults.churn_schedule(0, 4, 5)


N, T, SEED = 5, 2, 0x5E5


class Turns:
    """A channel whose parties, threads of one process, take turns: a
    thread takes the turn at its first publish and holds it except while it
    waits in a fetch; a turn whose holder has ended is free.  Threads that
    all run many small tensor ops would otherwise hand the interpreter lock
    back and forth at every op."""

    def __init__(self, inner):
        self.inner, self.cond, self.owner = inner, threading.Condition(), None

    def _take(self):
        me = threading.current_thread()
        with self.cond:
            while self.owner not in (None, me) and self.owner.is_alive():
                self.cond.wait(0.05)
            self.owner = me

    def _give(self):
        with self.cond:
            if self.owner is threading.current_thread():
                self.owner = None
                self.cond.notify_all()

    def publish(self, round_no, sender, payload):
        self._take()
        self.inner.publish(round_no, sender, payload)

    def fetch(self, round_no, expected, timeout=30.0):
        self._give()
        try:
            return self.inner.fetch(round_no, expected, timeout)
        finally:
            self._take()


def _direct(chan, env, keys, pks, churn, party: int, timeout: float):
    """Party ``party``'s whole sequence driven directly, on this thread,
    over the harness's channel (its mailboxes retained): run_party, then
    an EpochManager's refresh and reshare for a founding member, the
    reshare alone for a joiner, with the harness's rng recipe.  Its own
    publishes repeat what the channel holds (first-publish-wins), its
    fetches find every round complete."""
    group, n, t = env.group, env.nr_members, env.threshold
    jrng = random.Random(SEED * 7177 + 13)
    joiner_keys = [type(keys[0]).generate(group, jrng) for _ in range(churn.joiners)]
    new_pks = [p for i, p in enumerate(pks) if (i + 1) not in churn.leavers] + [k.public() for k in joiner_keys]
    rng = random.Random(SEED * 6151 + party - 1)
    if party <= n:
        res = tparty.run_party(chan, env, keys[party - 1], pks, party, rng, timeout=timeout)
        mgr = EpochManager(chan, group, genesis_from_party_result(env, res), keys[party - 1], pks, rng,
                           timeout=timeout, max_churn=None, device="cpu")
        return res, mgr.refresh(), mgr.reshare(new_pks, t)
    observer = EpochState(epoch=1, n=n, t=t, index=None, share=None, commitments=None)
    mgr = EpochManager(chan, group, observer, joiner_keys[party - n - 1], pks, rng, timeout=timeout,
                       max_churn=None, ops_done=1, device="cpu")
    return None, None, mgr.reshare(new_pks, t)


def test_run_epochs_with_faults_matches_direct_manager(tmp_path):
    """n = 5, t = 2 on ristretto255, the CPU: a ceremony, a refresh and a
    1-leave/1-join reshare under a plan that duplicates a deal and restarts
    a founding party in a refresh round (re-spawned from its WAL with a
    fresh rng).  The masters never change, the leaver ends with no state,
    the joiner's share verifies against the new commitments; and a
    founding stayer and the joiner driven directly (run_party and an
    EpochManager, the harness's rng recipe) over the harness's channel
    reach its states byte for byte."""
    group = tgh.RISTRETTO255
    env, keys, pks = tfaults.make_committee(group, N, T, SEED)
    churn = tfaults.churn_schedule(SEED, N, 1)
    restarted = 3 if 3 not in churn.leavers else 4
    timeout = 600.0
    plan = tfaults.FaultPlan(SEED).duplicate(6, sender=1).restart(sender=restarted, round_no=7)
    chan = tch.InProcessChannel()
    turns = Turns(chan)
    outs = tfaults.run_epochs_with_faults(env, keys, pks, plan, lambda i: turns, churn=churn, timeout=timeout,
                                          seed=SEED, checkpoint_dir=str(tmp_path), device="cpu")
    assert all(o.error is None for o in outs), [o.error for o in outs]
    master = group.encode(outs[0].base.master.point)
    (leaver,) = churn.leavers
    for o in outs:
        assert all(m == master for m in o.masters)
        assert len(o.masters) == (1 if o.party in (leaver, N + 1) else 2)
        assert o.left == (o.party == leaver) and (o.state is None) == o.left
    assert outs[restarted - 1].resumes == 1 and sum(o.resumes for o in outs) == 1
    joiner = outs[N].state
    acc = group.identity()
    for c in reversed(joiner.commitments):
        acc = group.add(group.scalar_mul(joiner.index, acc), c)
    assert group.eq(group.scalar_mul(joiner.share, group.generator()), acc)
    stayer = next(i for i in range(1, N + 1) if i not in (leaver, restarted))
    for party in (stayer, N + 1):
        res, refreshed, reshared = _direct(chan, env, keys, pks, churn, party, timeout)
        o = outs[party - 1]
        assert encode_epoch_state(group, reshared) == encode_epoch_state(group, o.state)
        if res is not None:
            assert res.share.value == o.base.share.value and res.commitments == o.base.commitments
