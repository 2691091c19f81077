"""The five-phase DKG protocol driven over a broadcast channel.

A copy of ``dkg_tpu/net/party.py``: each party calls :func:`run_party`
with a channel; rounds are published and fetched as ``utils.serde``'s
deterministic wire bytes, and the committee state machine is the port's
``dkg.committee``.  Malformed or missing messages degrade to the
protocol's silent disqualification.

The wire boundary is a trust boundary.  Every peer payload is decoded
inside :func:`_decode_quarantined` (any decode failure is ``None``: the
sender is disqualified as if it had never published) and then shape and
index validated before it reaches the state machine, so a Byzantine
peer cannot crash an honest party with bytes alone.  ``PartyResult``
counts what the transport survived (quarantined peers, round timeouts,
RPC retries) and threads the counters into ``utils.tracing`` and the
metrics registry.

A party that hits a protocol-fatal error still publishes its complaint
evidence first and then publishes empty payloads for the remaining
rounds, so peers never block on it.

Crash recovery: each round r splits into a *head* (state transition, WAL
record, publish) and a *tail* (fetch and decode of round r).  With
``run_party(..., checkpoint=path)`` every head appends one durable record
to a :class:`~dkg_tpu_torch.net.checkpoint.PartyWal` **before** its
publish: rounds 1-2 consume ``rng``, so a recomputed round would publish
different bytes (equivocation under first-publish-wins).  A restarted
process replays the log, re-publishes the recorded rounds (idempotent),
re-fetches closed rounds from the retained mailboxes and continues live
from the first unfinished round: the same master key, no fault budget
consumed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

from ..dkg.committee import (
    DistributedKeyGeneration,
    Environment,
    FetchedComplaints2,
    FetchedComplaints4,
    FetchedPhase1,
    FetchedPhase3,
    FetchedPhase5,
)
from ..dkg.errors import DkgError
from ..dkg.procedure_keys import (
    MasterPublicKey,
    MemberCommunicationKey,
    MemberCommunicationPublicKey,
    MemberSecretShare,
)
from ..utils import metrics, obslog, serde
from ..utils.tracing import CeremonyTrace, phase_span
from .channel import BroadcastChannel
from .checkpoint import PartyWal


@dataclass
class PartyResult:
    index: int
    master: Optional[MasterPublicKey] = None
    share: Optional[MemberSecretShare] = None
    error: Optional[DkgError] = None
    # aggregate bare commitments (A_0..A_t) of the final sharing poly:
    # A_l = sum over qualified dealers of A_{j,l}, so A_0 == master and
    # g*share_i == eval(A, i).  The epoch subsystem (``epoch``) seeds
    # refresh and resharing from this.  None when any dealer's secret
    # was reconstructed (the disclosed-share path changes the effective
    # sharing polynomial, so the aggregate would be stale).
    commitments: Optional[tuple] = None
    # transport/robustness counters (mirrored into ``trace.counters``)
    quarantined: int = 0  # peer messages that failed decode/validation
    timeouts: int = 0  # rounds that closed before all n messages arrived
    retries: int = 0  # channel RPC retries (channels exposing .stats)
    resumes: int = 0  # times this party resumed from its checkpoint WAL
    wal_records: int = 0  # WAL records at completion (replayed + appended)
    replayed_rounds: int = 0  # rounds restored from the WAL at start
    trace: Optional[CeremonyTrace] = field(default=None, repr=False)

    @property
    def ok(self) -> bool:
        return self.error is None and self.master is not None


def _decode_quarantined(decoder, group, payload: bytes):
    """Decode one peer payload; ANY failure means ``None`` (the sender is
    silently disqualified, like a party that never published).  Malformed
    bytes from a Byzantine peer must never raise into ``run_party``."""
    try:
        return decoder(group, payload)
    except (ValueError, struct.error, IndexError, OverflowError):
        return None


def _index_ok(n: int, *indices: int) -> bool:
    return all(1 <= i <= n for i in indices)


def _valid_phase1(b, n: int) -> bool:
    # every recipient 1..n must appear exactly once: a dealing that omits
    # (or duplicates) recipients could otherwise make an honest party
    # abort with FETCHED_INVALID_DATA instead of disqualifying the dealer
    return sorted(es.recipient_index for es in b.encrypted_shares) == list(
        range(1, n + 1)
    )


def _valid_phase2(b, n: int) -> bool:
    return all(_index_ok(n, m.accused_index) for m in b.misbehaving_parties)


def _valid_phase4(b, n: int) -> bool:
    return all(_index_ok(n, m.accused_index) for m in b.misbehaving_parties)


def _valid_phase5(b, n: int) -> bool:
    return all(
        _index_ok(n, d.accused_index, d.holder_index) for d in b.disclosed_shares
    )


def _valid_any(b, n: int) -> bool:
    return True


# Per-round wire handling: decoder, validator, and the Fetched* wrapper
# the committee state machine consumes.
_ROUNDS = {
    1: (serde.decode_phase1, _valid_phase1,
        lambda env, j, b: FetchedPhase1.from_broadcast(env, j, b)),
    2: (serde.decode_phase2, _valid_phase2,
        lambda env, j, b: FetchedComplaints2(j, b)),
    3: (serde.decode_phase3, _valid_any,
        lambda env, j, b: FetchedPhase3.from_broadcast(env, j, b)),
    4: (serde.decode_phase4, _valid_phase4,
        lambda env, j, b: FetchedComplaints4(j, b)),
    5: (serde.decode_phase5, _valid_phase5,
        lambda env, j, b: FetchedPhase5(j, b)),
}


@dataclass(frozen=True)
class _FetchOutcome:
    """What one round's fetch+decode observed — recorded in the NEXT
    round's WAL record so a resumed party restores its counters and can
    reconstruct the exact decode view (present mask) it acted on."""

    present: tuple[int, ...]
    quarantined_delta: int
    timed_out: bool


def _publish(
    channel,
    round_no: int,
    my: int,
    payload: Optional[bytes],
    *,
    seq: Optional[int] = None,
    trace: Optional[CeremonyTrace] = None,
) -> None:
    # flight-recorder events carry LENGTHS only, never payload bytes:
    # round 1/5 payloads hold encrypted shares and disclosures.  ``seq``
    # is the party-local publish ordinal: with the stamped (ceremony_id,
    # round, party) it is the key fetch-side events reference.  Emitted
    # AFTER the channel call, so its timestamp marks when the payload
    # became visible to peers.
    data = payload or b""
    channel.publish(round_no, my, data)
    obslog.emit_current("publish", round=round_no, bytes=len(data), seq=seq)
    if trace is not None:
        trace.bump("net.wire_bytes_out", len(data))


class _PartyRun:
    """One incarnation of one party: per-round head/tail steps over a
    channel, optionally journaled to (and resumed from) a PartyWal."""

    def __init__(self, channel, env, comm_key, pks, my, rng, timeout, trace, wal):
        self.channel = channel
        self.env = env
        self.group = env.group
        self.n = env.nr_members
        self.comm_key = comm_key
        self.pks = pks
        self.my = my
        self.rng = rng
        self.timeout = timeout
        self.trace = trace
        self.wal = wal
        self.others = [j for j in range(1, self.n + 1) if j != my]
        self.result = PartyResult(my, trace=trace)
        self.phase = None  # DkgPhase* driving the next transition
        self.fetched1 = None  # round-1 broadcasts (re-consumed by round 3)
        self.prev = None  # decoded messages the next head consumes
        self.last_outcome: Optional[_FetchOutcome] = None
        self.finished = False
        self.pub_seq = 0  # party-local publish ordinal (causal-flow key)

    # -- shared plumbing ----------------------------------------------------

    def _pub(self, round_no: int, payload: Optional[bytes]) -> None:
        seq = self.pub_seq
        self.pub_seq += 1
        _publish(
            self.channel, round_no, self.my, payload, seq=seq, trace=self.trace
        )

    def _decode_list(self, round_no: int, got: dict[int, bytes], counting: bool):
        decoder, validate, wrap = _ROUNDS[round_no]
        out = []
        for j in self.others:
            payload = got.get(j)
            b = None
            if payload:  # absent or explicit empty: silent disqualification
                b = _decode_quarantined(decoder, self.group, payload)
                if b is not None and not validate(b, self.n):
                    b = None
                if b is None and counting:
                    self.result.quarantined += 1
                    obslog.emit_current("quarantine", round=round_no, peer=j)
            out.append(wrap(self.env, j, b))
        return out

    def _tail(self, round_no: int):
        """Fetch + decode round ``round_no``; records the outcome for the
        next head's WAL record."""
        got = self.channel.fetch(round_no, self.n, self.timeout)
        timed_out = len(got) < self.n
        if timed_out:
            self.result.timeouts += 1
        q0 = self.result.quarantined
        lst = self._decode_list(round_no, got, counting=True)
        self.last_outcome = _FetchOutcome(
            tuple(sorted(got)), self.result.quarantined - q0, timed_out
        )
        if self.trace is not None:
            self.trace.bump(
                "net.wire_bytes_in", sum(len(v) for v in got.values())
            )
        obslog.emit_current(
            "round_tail",
            round=round_no,
            present=len(got),
            senders=sorted(got),
            quarantined_delta=self.result.quarantined - q0,
            timed_out=timed_out,
        )
        if round_no == 1:
            self.fetched1 = lst
        self.prev = lst

    def _record(self, round_no: int, payload: bytes, phase=None,
                error=None, drain_from: int = 0) -> None:
        """Append round ``round_no``'s WAL record.  MUST run before the
        round's publish: the write-ahead ordering is what makes resumed
        re-publishes byte-identical (module docstring)."""
        if self.wal is None:
            return
        o = self.last_outcome
        body = serde.encode_round_record(
            self.group, round_no, payload, phase,
            error=error, drain_from=drain_from,
            present=o.present if o else None,
            quarantined_delta=o.quarantined_delta if o else 0,
            timed_out=o.timed_out if o else False,
        )
        self.wal.append(body)
        self.result.wal_records += 1
        obslog.emit_current(
            "wal_record", round=round_no, bytes=len(body), terminal=error is not None
        )

    def _abort(self, err: DkgError, drain_from: int) -> None:
        # error KIND only — DkgError bodies can reference protocol state
        obslog.emit_current("abort", error=err.kind.name, drain_from=drain_from)
        self.result.error = err
        # publish empties for the remaining rounds so peers never block
        for r in range(drain_from, 6):
            self._pub(r, b"")
        self.finished = True

    def _finish(self) -> PartyResult:
        res = self.result
        stats = getattr(self.channel, "stats", None)
        if isinstance(stats, dict):
            res.retries = int(stats.get("retries", 0))
        if self.trace is not None:
            self.trace.bump("net.quarantined", res.quarantined)
            self.trace.bump("net.round_timeouts", res.timeouts)
            self.trace.bump("net.rpc_retries", res.retries)
            self.trace.bump("net.resumes", res.resumes)
            self.trace.bump("wal.records", res.wal_records)
            self.trace.bump("wal.replayed_rounds", res.replayed_rounds)
            self.trace.meta.setdefault("party_index", self.my)
        obslog.emit_current(
            "party_done",
            ok=res.ok,
            quarantined=res.quarantined,
            timeouts=res.timeouts,
            retries=res.retries,
            resumes=res.resumes,
            wal_records=res.wal_records,
            replayed_rounds=res.replayed_rounds,
        )
        metrics.observe_party_result(res)
        return res

    # -- per-round heads (transition, record, publish) ----------------------

    def _head1(self) -> None:
        phase1, b1 = DistributedKeyGeneration.init(
            self.env, self.rng, self.comm_key, self.pks, self.my
        )
        p1 = serde.encode_phase1(self.group, b1)
        self._record(1, p1, phase=phase1)
        self._pub(1, p1)
        self.phase = phase1

    def _head2(self) -> None:
        nxt, b2 = self.phase.proceed(self.fetched1, self.rng)
        p2 = serde.encode_phase2(self.group, b2) if b2 else b""
        if isinstance(nxt, DkgError):
            # complaint evidence is committed bytes too: pin it in a
            # terminal record before publishing (crash mid-drain must
            # not recompute the proofs with a fresh rng)
            self._record(2, p2, error=nxt, drain_from=3)
            self._pub(2, p2)
            self._abort(nxt, 3)
            return
        self._record(2, p2, phase=nxt)
        self._pub(2, p2)
        self.phase = nxt

    def _head3(self) -> None:
        nxt, b3 = self.phase.proceed(self.prev, self.fetched1)
        if isinstance(nxt, DkgError):
            self._record(3, b"", error=nxt, drain_from=3)
            self._abort(nxt, 3)
            return
        p3 = serde.encode_phase3(self.group, b3) if b3 else b""
        self._record(3, p3, phase=nxt)
        self._pub(3, p3)
        self.phase = nxt

    def _head4(self) -> None:
        nxt, b4 = self.phase.proceed(self.prev)
        p4 = serde.encode_phase4(self.group, b4) if b4 else b""
        if isinstance(nxt, DkgError):
            self._record(4, p4, error=nxt, drain_from=5)
            self._pub(4, p4)
            self._abort(nxt, 5)
            return
        self._record(4, p4, phase=nxt)
        self._pub(4, p4)
        self.phase = nxt

    def _head5(self) -> None:
        nxt, b5 = self.phase.proceed(self.prev)
        p5 = serde.encode_phase5(self.group, b5) if b5 else b""
        if isinstance(nxt, DkgError):
            self._record(5, p5, error=nxt, drain_from=6)
            self._pub(5, p5)
            self._abort(nxt, 6)
            return
        self._record(5, p5, phase=nxt)
        self._pub(5, p5)
        self.phase = nxt

    def _finalise(self) -> None:
        out, _ = self.phase.finalise(self.prev)
        if isinstance(out, DkgError):
            self.result.error = out
        else:
            self.result.master, self.result.share = out
            self.result.commitments = self._aggregate_commitments()
        self.finished = True

    def _aggregate_commitments(self) -> Optional[tuple]:
        """Pointwise sum of the qualified dealers' bare commitment
        tuples — the Feldman commitments of the AGGREGATE sharing
        polynomial the final shares lie on.  Only valid when no dealer
        went through share reconstruction (PartyResult.commitments)."""
        st = self.phase._state
        if st.reconstructable:
            return None
        qual = [j for j in range(1, self.n + 1) if st.qualified[j - 1]]
        if not qual or any(j not in st.bare_coeffs for j in qual):
            return None
        tlen = len(st.bare_coeffs[qual[0]])
        agg = []
        for lvl in range(tlen):
            acc = st.bare_coeffs[qual[0]][lvl]
            for j in qual[1:]:
                acc = self.group.add(acc, st.bare_coeffs[j][lvl])
            agg.append(acc)
        return tuple(agg)

    _HEADS = {1: _head1, 2: _head2, 3: _head3, 4: _head4, 5: _head5}

    # -- resume -------------------------------------------------------------

    def _replay_records(self):
        """Intact, contiguous WAL records 1..R (a terminal record, if
        any, is last) plus their raw bodies.  Anything after the first
        gap/corruption is a torn tail and is discarded — resume falls
        back to the previous round, which the write-ahead ordering
        makes safe.

        Forward compatibility: records whose magic is not ours (e.g.
        the epoch layer's b"DKGE" records, or record types a future
        version introduces) are SKIPPED — not interpreted, not treated
        as corruption — but their bodies are preserved so the torn-tail
        compaction below never deletes another layer's records."""
        records, bodies = [], []
        for body in self.wal.replay():
            if not body.startswith(serde.RECORD_MAGIC):
                bodies.append(body)  # foreign record: preserve, skip
                continue
            try:
                rec = serde.decode_round_record(self.group, body)
            except ValueError:
                break
            if rec.round_no != len(records) + 1:
                break
            records.append(rec)
            bodies.append(body)
            if rec.error is not None:
                break
        return records, bodies

    def _rebuild_fetched1(self, rec2) -> None:
        """Round 3 re-consumes the round-1 broadcasts; rebuild them from
        the retained mailbox filtered to the recorded present mask (late
        stragglers must not change the replayed view).  Decode failures
        were already counted in the record's quarantined_delta."""
        present = rec2.present or ()
        got = self.channel.fetch(1, len(present), self.timeout)
        got = {j: got[j] for j in present if j in got}
        self.fetched1 = self._decode_list(1, got, counting=False)

    def _resume(self) -> int:
        """Replay the WAL; returns the last recorded round R (0 = start
        fresh).  On return the run continues at round R's tail."""
        records, bodies = self._replay_records()
        if not records:
            # a log that exists but replays to nothing is unusable —
            # recreate it so fresh records don't land after garbage, and
            # run from round 1 (dropout semantics if the ceremony moved
            # on).  Foreign-magic records (another layer's, e.g. epoch)
            # are not ours to delete: compact to just those instead.
            if bodies:
                self.wal.rewrite(bodies)
            else:
                self.wal.reset()
            return 0
        # compact away any torn tail before appending new records: bytes
        # from a half-written frame would shadow everything after them
        # on the next replay (the double-crash case)
        self.wal.rewrite(bodies)
        with phase_span(self.trace, "net_resume"):
            obslog.emit_current("wal_resume", replayed_rounds=len(records))
            res = self.result
            res.resumes = 1
            res.replayed_rounds = len(records)
            res.wal_records = len(records)
            for rec in records:
                if rec.present is not None:
                    res.quarantined += rec.quarantined_delta
                    if rec.timed_out:
                        res.timeouts += 1
            # re-publish every recorded round: first-publish-wins makes
            # this an idempotent no-op for rounds that already landed,
            # and delivers the exact recorded bytes for a publish the
            # crash interrupted
            for rec in records:
                self._pub(rec.round_no, rec.payload)
            last = records[-1]
            if last.error is not None:
                self._abort(last.error, last.drain_from)
                return last.round_no
            self.phase = last.phase
            if last.round_no == 2:
                self._rebuild_fetched1(records[1])
        return last.round_no

    # -- the run ------------------------------------------------------------

    def execute(self) -> PartyResult:
        resume_round = 0
        if self.wal is not None:
            resume_round = self._resume()
        if self.finished:
            return self._finish()
        for r in range(max(1, resume_round), 6):
            with phase_span(self.trace, f"net_round{r}"):
                if r != resume_round:
                    obslog.emit_current("round_head", round=r)
                    self._HEADS[r](self)
                    if self.finished:
                        return self._finish()
                self._tail(r)
                if r == 5:
                    self._finalise()
        return self._finish()


def run_party(
    channel: BroadcastChannel,
    env: Environment,
    comm_key: MemberCommunicationKey,
    committee_pks: list[MemberCommunicationPublicKey],
    my: int,
    rng,
    timeout: float = 30.0,
    trace: Optional[CeremonyTrace] = None,
    checkpoint: Optional[object] = None,
    obs: Optional[obslog.ObsLog] = None,
) -> PartyResult:
    """Execute one party's side of the ceremony over ``channel``.

    ``my`` is the party's 1-based index in the byte-sorted committee
    (reference: committee.rs:134-135); returns the master public key and
    this party's secret share on success.  Pass a
    :class:`~dkg_tpu_torch.utils.tracing.CeremonyTrace` to collect per-round
    wall-clock and the quarantine/timeout/retry counters.

    ``checkpoint`` (a path or :class:`~dkg_tpu_torch.net.checkpoint.PartyWal`)
    enables durable crash recovery: protocol state is journaled before
    every publish, and a restarted process pointed at the same WAL
    resumes from the first unfinished round with the byte-identical
    outcome (module docstring).

    ``obs`` is this party's flight recorder; when None and the
    ``DKG_TPU_OBSLOG`` env knob names a directory, one is created with a
    JSONL sink there (``{ceremony_id}-p{my:03d}.jsonl``).  The recorder
    is bound as the thread's ambient log for the run, so channel retries
    and injected faults land in the same event stream.
    """
    wal = None
    if checkpoint is not None:
        wal = checkpoint if isinstance(checkpoint, PartyWal) else PartyWal(checkpoint)
    owned = None
    if obs is None:
        obs = owned = obslog.from_env(
            ceremony_id=obslog.ceremony_id_for(env), party=my
        )
    try:
        with obslog.use(obs):
            return _PartyRun(
                channel, env, comm_key, committee_pks, my, rng, timeout, trace, wal
            ).execute()
    finally:
        if owned is not None:
            owned.close()
