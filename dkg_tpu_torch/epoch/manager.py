"""EpochManager: sequences refresh and reshare operations over a channel.

Counterpart of ``dkg_tpu/epoch/manager.py``, the same messages, WAL
records and decisions.  Epoch operations ride the same broadcast channel
and WAL as the ceremony, in rounds numbered after it: operation k
(1-based, counted over the party's lifetime) takes channel rounds
``6 + 3*(k-1)`` (deal), ``+1`` (complaints) and ``+2`` (confirm), so
first-publish-wins, equivocation evidence and retained mailboxes cover
epochs with no new transport code.

One operation, three steps a party:

1. **deal**: every CURRENT share holder deals a polynomial through the
   batched ceremony (``epoch.dealing``): zero-constant for a refresh,
   share-constant (degree t') for a reshare, sealed to the NEW
   committee's keys.  Written to the WAL before it is published (the
   deal consumes ``rng``).
2. **complaints**: every NEW member decrypts its shares (one batched KEM
   recovery), checks them against the dealt bare commitments (one
   fixed-base batch and one point Horner) and broadcasts the dealers that
   failed.  Publicly invalid deals (bad shape, wrong kind or epoch, a
   refresh constant other than the identity, a reshare constant that does
   not match the previous aggregate) need no complaint: every honest
   party drops them by the same rule.
3. **confirm**: apply the included deals, derive the new EpochState and
   broadcast a 16-byte digest of it; the operation concludes only when
   at least t' + 1 members sent the same digest.  The confirm WAL record
   pins the resulting state, so a crashed party resumes mid-epoch.

A failure leaves ``self.state`` untouched (see epoch.errors).  Churn
(leavers + joiners) is bounded by ``max_churn``, by default the
``DKG_TPU_EPOCH_MAX_CHURN`` knob; round timeouts default to
``DKG_TPU_EPOCH_DEADLINE_S``.  Each operation is one ``phase_span``
(``epoch_<kind>_op<k>``) and feeds ``epoch_ops_total``,
``epoch_op_seconds`` and ``epoch_quarantined_total`` in
``utils.metrics.REGISTRY``, and emits the JAX package's flight-recorder
events into the ambient ``utils.obslog`` recorder (dropped where none is
bound): ``epoch_wal_record``, ``epoch_head``, ``epoch_publish``,
``epoch_tail``, ``epoch_quarantine`` and ``epoch_done``, in its order.
"""

from __future__ import annotations

import struct
import time
from typing import Optional

from ..dkg.ceremony import resolve_device
from ..fields import host as fh
from ..net.checkpoint import PartyWal
from ..poly import device as poly_device
from ..utils import envknobs, obslog, serde
from ..utils.metrics import REGISTRY
from ..utils.tracing import phase_span
from . import dealing
from .errors import EpochError
from .messages import (
    EpochComplaints,
    EpochConfirm,
    EpochDeal,
    decode_epoch_complaints,
    decode_epoch_confirm,
    decode_epoch_deal,
    encode_epoch_complaints,
    encode_epoch_confirm,
    encode_epoch_deal,
)
from .state import (
    KIND_NAMES,
    KIND_REFRESH,
    KIND_RESHARE,
    EpochState,
    confirm_digest,
    encode_epoch_state,
)

EPOCH_ROUND_BASE = 6  # ceremony rounds are 1..5
ROUNDS_PER_OP = 3

_DECODE_ERRORS = (ValueError, struct.error, IndexError, OverflowError)


def epoch_rounds(op_seq: int) -> tuple[int, int, int]:
    """(deal, complaints, confirm) channel rounds of operation
    ``op_seq`` (1-based)."""
    base = EPOCH_ROUND_BASE + ROUNDS_PER_OP * (op_seq - 1)
    return base, base + 1, base + 2


class EpochManager:
    """Drives epoch operations for ONE party over a broadcast channel.

    ``state`` is the party's current :class:`EpochState` (epoch-0 state
    comes from ``state.genesis_from_party_result``); ``committee_pks``
    the byte-sorted communication keys of the CURRENT committee.  A
    joiner bootstrapping into a reshare passes an observer state
    (index/share/commitments None) plus ``ops_done`` = the number of
    epoch ops the committee already ran, so its round numbers line up.

    With ``checkpoint`` set (a path or PartyWal — the party's CEREMONY
    WAL is fine, epoch records carry their own magic and the two record
    streams skip each other), every step is journaled write-ahead and a
    restarted process replays: recorded publishes are re-published
    byte-identically, closed fetches are re-read from the retained
    mailboxes under the recorded present masks, and the op continues
    live from the first unfinished step.

    ``device`` is where the device legs run: the card unless the caller
    asks for the CPU.
    """

    def __init__(
        self,
        channel,
        group,
        state: EpochState,
        comm_key,
        committee_pks: list,
        rng,
        *,
        timeout: Optional[float] = None,
        first_fetch_timeout: Optional[float] = None,
        checkpoint=None,
        max_churn: Optional[int] = None,
        trace=None,
        ops_done: int = 0,
        device="cuda",
    ):
        self.channel = channel
        self.group = group
        self.state = state
        self.comm_key = comm_key
        self.pks = list(committee_pks)
        self.rng = rng
        self.trace = trace
        self.device = device
        if timeout is None:
            timeout = envknobs.pos_float(
                "DKG_TPU_EPOCH_DEADLINE_S", "per-epoch-round fetch timeout (s)"
            )
        self.timeout = 30.0 if timeout is None else float(timeout)
        # one-shot deadline for this manager's first live fetch (joiner
        # bootstrap: must span every round preceding the one it joins at)
        self.first_fetch_timeout = first_fetch_timeout
        if max_churn is None:
            max_churn = envknobs.nonneg_int(
                "DKG_TPU_EPOCH_MAX_CHURN",
                "max leave+join churn per reshare; 0 refuses any churn",
            )
        self.max_churn = max_churn  # None = unbounded
        self.op_seq = int(ops_done)
        self.pub_seq = 0  # party-local publish ordinal (causal-flow key)
        self.finished = False  # True once this party has left the committee
        self.quarantined = 0
        self.resumed_steps = 0
        self.wal: Optional[PartyWal] = None
        self._replayed: dict[int, dict[int, serde.EpochRecord]] = {}
        if checkpoint is not None:
            self.wal = (
                checkpoint
                if isinstance(checkpoint, PartyWal)
                else PartyWal(checkpoint)
            )
            self._replayed = self._replay()
        if state.index is not None:
            me = self.comm_key.public().point
            if not (1 <= state.index <= len(self.pks)) or not group.eq(
                self.pks[state.index - 1].point, me
            ):
                raise EpochError(
                    "BAD_COMMITTEE", "state.index does not match committee_pks"
                )

    # -- public operations --------------------------------------------------

    def refresh(self) -> EpochState:
        """Proactive zero-share refresh: same committee, same (n, t),
        same master key, fresh shares.  Returns the new state."""
        if self.state.commitments is None:
            raise EpochError("NO_GENESIS", "refresh needs the current aggregate")
        return self._run_op(KIND_REFRESH, self.pks, self.state.t)

    def reshare(self, new_pks: list, new_t: int) -> Optional[EpochState]:
        """Reshare to a NEW committee (possibly different membership and
        threshold).  Returns the new state, or None when this party is
        not a member of the new committee (it dealt its share-of-share
        and is done)."""
        n_new = len(new_pks)
        if not (1 <= new_t < (n_new + 1) / 2):
            raise EpochError(
                "BAD_COMMITTEE", f"threshold {new_t} invalid for n'={n_new}"
            )
        enc = self.group.encode
        old = {enc(p.point) for p in self.pks}
        new = {enc(p.point) for p in new_pks}
        if len(new) != n_new:
            raise EpochError("BAD_COMMITTEE", "duplicate keys in new committee")
        churn = len(old - new) + len(new - old)
        if self.max_churn is not None and churn > self.max_churn:
            raise EpochError(
                "CHURN_LIMIT", f"churn {churn} exceeds limit {self.max_churn}"
            )
        ordered = sorted(new_pks, key=lambda p: p.sort_key(self.group))
        return self._run_op(KIND_RESHARE, ordered, new_t)

    # -- WAL plumbing -------------------------------------------------------

    def _replay(self) -> dict:
        """Epoch records in the WAL, grouped {op_seq: {step: record}}.
        Records of other layers (the ceremony's b"DKGR") are skipped by
        magic."""
        out: dict[int, dict[int, serde.EpochRecord]] = {}
        for body in self.wal.replay():
            if not body.startswith(serde.EPOCH_RECORD_MAGIC):
                continue
            try:
                rec = serde.decode_epoch_record(self.group, body)
            except _DECODE_ERRORS:
                continue  # serde-level garbage inside an intact frame
            out.setdefault(rec.op_seq, {})[rec.step] = rec
        return out

    def _record(
        self, op: int, step: int, kind: int, payload: bytes, *,
        present=None, state_bytes=None,
    ) -> None:
        """Append one epoch WAL record.  MUST run before the step's
        publish (write-ahead: the deal step consumes rng, so recomputed
        bytes would equivocate under first-publish-wins)."""
        if self.wal is None:
            return
        body = serde.encode_epoch_record(
            self.group, op, step, kind, payload,
            present=present, state_bytes=state_bytes,
        )
        self.wal.append(body)
        obslog.emit_current("epoch_wal_record", op=op, step=step, bytes=len(body))

    # -- channel plumbing ---------------------------------------------------

    def _publish(self, round_no: int, sender: int, payload: bytes) -> None:
        # emitted after the channel call: the timestamp marks visibility
        seq = self.pub_seq
        self.pub_seq += 1
        self.channel.publish(round_no, sender, payload)
        obslog.emit_current("epoch_publish", round=round_no, bytes=len(payload), seq=seq)
        if self.trace is not None:
            self.trace.bump("net.wire_bytes_out", len(payload))

    def _fetch(self, round_no: int, expected: int, mask) -> dict[int, bytes]:
        """Fetch one epoch round; with a replayed present ``mask`` the
        retained mailbox is filtered to exactly the recorded view (late
        stragglers must not change a resumed step's inputs).

        The FIRST live fetch may use the longer ``first_fetch_timeout``:
        a joiner bootstrapping into a reshare has been waiting since
        before the committee even finished its ceremony, so its opening
        deadline must cover every preceding round, not just one."""
        timeout = self.timeout
        if self.first_fetch_timeout is not None:
            timeout = max(timeout, float(self.first_fetch_timeout))
            self.first_fetch_timeout = None
        if mask is not None:
            got = self.channel.fetch(round_no, len(mask), timeout)
            return {j: got[j] for j in mask if j in got}
        got = self.channel.fetch(round_no, expected, timeout)
        if self.trace is not None:
            self.trace.bump(
                "net.wire_bytes_in", sum(len(v) for v in got.values())
            )
        obslog.emit_current("epoch_tail", round=round_no, present=len(got), senders=sorted(got),
                            timed_out=len(got) < expected)
        return got

    # -- the operation ------------------------------------------------------

    def _run_op(self, kind: int, new_pks: list, t_new: int):
        if self.finished:
            raise EpochError(
                "BAD_COMMITTEE", "this party left the committee in an earlier epoch"
            )
        op = self.op_seq + 1
        kname = KIND_NAMES[kind]
        t0 = time.monotonic()
        with phase_span(self.trace, f"epoch_{kname}_op{op}"):
            try:
                st_new = self._op_body(kind, op, new_pks, t_new)
            except EpochError as e:
                REGISTRY.inc("epoch_ops_total", kind=kname, status=e.kind)
                obslog.emit_current("epoch_done", op=op, op_kind=kname, status=e.kind)
                raise
        REGISTRY.inc("epoch_ops_total", kind=kname, status="ok")
        REGISTRY.observe("epoch_op_seconds", time.monotonic() - t0, kind=kname)
        obslog.emit_current("epoch_done", op=op, op_kind=kname, status="ok",
                            epoch=None if st_new is None else st_new.epoch)
        self.op_seq = op
        if st_new is None:
            self.finished = True  # leaver: dealt, holds nothing in the new epoch
        else:
            self.state = st_new
            self.pks = list(new_pks)
        return st_new

    def _op_body(self, kind: int, op: int, new_pks: list, t_new: int):
        group, fs = self.group, self.group.scalar_field
        kname = KIND_NAMES[kind]
        ra, rb, rc = epoch_rounds(op)
        epoch_new = self.state.epoch + 1
        n_new, n_old, t_old = len(new_pks), self.state.n, self.state.t
        my_old = self.state.index
        me = group.encode(self.comm_key.public().point)
        my_new = next(
            (i + 1 for i, p in enumerate(new_pks) if group.encode(p.point) == me),
            None,
        )
        recs = self._replayed.get(op, {})
        if recs:
            self.resumed_steps += len(recs)
        cfg = dealing.epoch_cfg(group, n_new, t_new)

        # ---- step 1: deal (current share-holders only) --------------------
        if self.state.holds_share:
            if 1 in recs:
                payload1 = recs[1].payload
            else:
                constant = 0 if kind == KIND_REFRESH else self.state.share
                comm, enc_shares = dealing.deal_epoch_poly(
                    group, cfg, constant, self.rng, new_pks, device=self.device
                )
                prev_claim = (
                    self.state.commitments if kind == KIND_RESHARE else ()
                )
                payload1 = encode_epoch_deal(
                    group,
                    EpochDeal(
                        kind, epoch_new, tuple(comm), tuple(enc_shares),
                        tuple(prev_claim),
                    ),
                )
                self._record(op, 1, kind, payload1)
            obslog.emit_current("epoch_head", round=ra, op=op, step=1, op_kind=kname)
            self._publish(ra, my_old, payload1)
        if my_new is None:
            # leaver: its share-of-share is dealt; nothing to receive.
            if serde.EPOCH_STEP_CONFIRM not in recs:
                self._record(op, serde.EPOCH_STEP_CONFIRM, kind, b"")
            return None

        # ---- tail 1: fetch + validate deals -------------------------------
        mask_a = recs[2].present if 2 in recs else None
        got = self._fetch(ra, n_old, mask_a)
        deals: dict[int, EpochDeal] = {}
        for j in sorted(got):
            payload = got[j]
            if not (1 <= j <= n_old) or not payload:
                continue
            try:
                d = decode_epoch_deal(group, payload)
            except _DECODE_ERRORS:
                self.quarantined += 1
                REGISTRY.inc("epoch_quarantined_total")
                obslog.emit_current("epoch_quarantine", round=ra, peer=j)
                continue
            if d.kind != kind or d.epoch != epoch_new:
                continue
            if len(d.commitments) != t_new + 1:
                continue
            if sorted(es.recipient_index for es in d.encrypted_shares) != list(
                range(1, n_new + 1)
            ):
                continue
            if kind == KIND_REFRESH and not group.eq(
                d.commitments[0], group.identity()
            ):
                continue  # non-zero constant would move the master key
            if kind == KIND_RESHARE and len(d.prev_commitments) != t_old + 1:
                continue
            deals[j] = d
        present_a = tuple(sorted(got))

        if kind == KIND_RESHARE:
            prev, deals = self._resolve_prev_commitments(deals, t_old)
        else:
            prev = self.state.commitments

        # ---- step 2: decrypt + verify my shares, broadcast complaints -----
        opened = dealing.open_my_shares(
            group, cfg, self.comm_key.sk, deals, my_new, device=self.device
        )
        valid_j = sorted(deals)
        check_j = [j for j in valid_j if opened.get(j) is not None]
        ok = dealing.check_bare_shares(
            group,
            [my_new] * len(check_j),
            [opened[j] for j in check_j],
            [deals[j].commitments for j in check_j],
            device=self.device,
        )
        accused = sorted(
            {j for j in valid_j if opened.get(j) is None}
            | {j for k, j in enumerate(check_j) if not ok[k]}
        )
        if 2 in recs:
            payload2 = recs[2].payload
        else:
            payload2 = encode_epoch_complaints(
                group, EpochComplaints(kind, epoch_new, tuple(accused))
            )
            self._record(op, 2, kind, payload2, present=present_a)
        obslog.emit_current("epoch_head", round=rb, op=op, step=2, op_kind=kname)
        self._publish(rb, my_new, payload2)

        # ---- tail 2: complaint union -> included dealer set ---------------
        mask_b = recs[3].present if 3 in recs else None
        got_b = self._fetch(rb, n_new, mask_b)
        union: set[int] = set()
        for j, payload in sorted(got_b.items()):
            if not (1 <= j <= n_new) or not payload:
                continue
            try:
                c = decode_epoch_complaints(group, payload)
            except _DECODE_ERRORS:
                self.quarantined += 1
                REGISTRY.inc("epoch_quarantined_total")
                obslog.emit_current("epoch_quarantine", round=rb, peer=j)
                continue
            if c.kind != kind or c.epoch != epoch_new:
                continue
            union |= {a for a in c.accused if 1 <= a <= n_old}
        included = [j for j in valid_j if j not in union]
        if kind == KIND_RESHARE and len(included) < t_old + 1:
            raise EpochError(
                "INSUFFICIENT_DEALERS",
                f"{len(included)} included dealers, need {t_old + 1}",
            )
        if kind == KIND_REFRESH and not included:
            raise EpochError("NO_DEALERS", "no valid refresh deals survived")
        missing = [j for j in included if opened.get(j) is None]
        if missing:
            # an included dealer's share failed only FOR ME and my
            # complaint did not land: liveness loss for this party alone
            raise EpochError(
                "MISSING_SHARE", f"no usable share from included dealers {missing}"
            )

        # ---- step 3: apply, confirm digest --------------------------------
        if kind == KIND_REFRESH:
            new_share = (
                self.state.share + sum(opened[j] for j in included)
            ) % fs.modulus
            new_comm = []
            for lvl in range(t_new + 1):
                acc = prev[lvl]
                for j in included:
                    acc = group.add(acc, deals[j].commitments[lvl])
                new_comm.append(acc)
            new_comm = tuple(new_comm)
        else:
            dev = resolve_device(self.device)
            xs = fh.to_tensor(fh.encode(fs, included), dev)
            ys = fh.to_tensor(fh.encode(fs, [opened[j] for j in included]), dev)
            lam = poly_device.lagrange_at_zero_coeffs(fs, xs)
            new_share = int(
                fh.decode(fs, fh.from_tensor(poly_device.lagrange_at_zero(fs, xs, ys)))
            )
            new_comm = dealing.combine_reshare_commitments(
                group, lam, [deals[j].commitments for j in included]
            )
        if not group.eq(new_comm[0], prev[0]):
            raise EpochError("MASTER_DRIFT", "new aggregate moved the master key")

        st_new = EpochState(epoch_new, n_new, t_new, my_new, new_share, new_comm)
        digest = confirm_digest(group, kind, epoch_new, n_new, t_new, new_comm)
        if 3 in recs:
            payload3 = recs[3].payload
        else:
            payload3 = encode_epoch_confirm(
                group, EpochConfirm(kind, epoch_new, digest)
            )
            self._record(
                op, 3, kind, payload3,
                present=tuple(sorted(got_b)),
                state_bytes=encode_epoch_state(group, st_new),
            )
        obslog.emit_current("epoch_head", round=rc, op=op, step=3, op_kind=kname)
        self._publish(rc, my_new, payload3)

        # ---- tail 3: digest agreement -------------------------------------
        got_c = self._fetch(rc, n_new, None)
        agree = 1  # my own digest
        for j, payload in sorted(got_c.items()):
            if j == my_new or not (1 <= j <= n_new) or not payload:
                continue
            try:
                c = decode_epoch_confirm(group, payload)
            except _DECODE_ERRORS:
                self.quarantined += 1
                continue
            if c.kind == kind and c.epoch == epoch_new and c.digest == digest:
                agree += 1
        if agree < t_new + 1:
            raise EpochError(
                "CONFIRM_DIVERGENCE",
                f"{agree} matching confirms, need {t_new + 1}",
            )
        return st_new

    def _resolve_prev_commitments(self, deals: dict, t_old: int):
        """The previous aggregate a reshare verifies against.

        Stayers hold it and drop dealers whose claim differs; joiners
        bootstrap by t+1-majority over the claims (<= t faulty dealers
        can never assemble a t+1 quorum on a false aggregate).  Then one
        batched check binds every dealer's constant A_{i,0} to
        eval(prev, i) — the step that makes the reshared secret provably
        the current one."""
        group = self.group
        if self.state.commitments is not None:
            prev = self.state.commitments
            prev_enc = tuple(group.encode(c) for c in prev)
            deals = {
                j: d
                for j, d in deals.items()
                if tuple(group.encode(c) for c in d.prev_commitments) == prev_enc
            }
        else:
            counts: dict[tuple, list[int]] = {}
            for j in sorted(deals):
                key = tuple(group.encode(c) for c in deals[j].prev_commitments)
                counts.setdefault(key, []).append(j)
            best = max(
                counts.items(), key=lambda kv: (len(kv[1]), kv[0]), default=None
            )
            if best is None or len(best[1]) < t_old + 1:
                raise EpochError(
                    "NO_PREV_COMMITMENTS",
                    "no t+1-majority claim of the current aggregate",
                )
            prev = deals[best[1][0]].prev_commitments
            deals = {j: deals[j] for j in best[1]}
        idxs = sorted(deals)
        ok = dealing.check_reshare_constants(
            group, prev, idxs, [deals[j].commitments[0] for j in idxs],
            device=self.device,
        )
        return prev, {j: deals[j] for k, j in enumerate(idxs) if ok[k]}
