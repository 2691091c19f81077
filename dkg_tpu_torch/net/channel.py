"""Broadcast channels: publish-once / fetch-all per round.

The in-process part of ``dkg_tpu/net/channel.py``, a copy: the
:class:`BroadcastChannel` protocol, :class:`InProcessChannel` and the
transport error classes that the TCP hub raises (the hub itself is not
ported yet).  Every party
publishes at most one message per round and everyone then fetches the
whole round; a party with nothing to say publishes the empty payload, a
party that never publishes is absent from the fetch.

* **First-publish-wins.**  A second, different publish for the same
  (round, sender) never replaces the first; it is recorded as an
  equivocation attempt.  An identical re-publish is a no-op, which makes
  publish retries idempotent and a resumed party's replay safe.
* **Typed transport errors.**  :class:`TransportError` and its
  subclasses name transport faults, so callers can retry them without
  masking programming errors.
"""

from __future__ import annotations

import threading
import time
from typing import Protocol

# How many distinct payloads (the original + alternates) to retain per
# equivocating (round, sender) as evidence before only counting.
_EVIDENCE_CAP = 8

class TransportError(RuntimeError):
    """A transport-layer failure (retryable; never a protocol error)."""


class TruncatedStream(TransportError):
    """The peer closed the stream mid-message (short read)."""


class RetryBudgetExceeded(TransportError):
    """All RPC attempts failed; carries the last underlying error."""


class BroadcastChannel(Protocol):
    def publish(self, round_no: int, sender: int, payload: bytes) -> None:
        """Publish this party's round message (empty = explicit no-op)."""

    def fetch(
        self, round_no: int, expected: int, timeout: float = 30.0
    ) -> dict[int, bytes]:
        """Block until ``expected`` messages for the round arrived (or
        timeout); returns {sender_index: payload}.  On timeout returns
        whatever arrived — missing parties become silent dropouts."""


class InProcessChannel:
    """Shared-memory channel for in-process multi-party simulation —
    the reference's test transport (committee.rs:1337-1338) with real
    blocking semantics so threaded parties interleave correctly.

    Publishes are first-write-wins: a conflicting second publish for
    the same (round, sender) is recorded in the equivocation log, not
    applied; an identical re-publish (a retry) is a silent no-op."""

    def __init__(self) -> None:
        self._lock = threading.Condition()
        self._rounds: dict[int, dict[int, bytes]] = {}
        # (round, sender) -> [first payload, alternate, ...] (capped)
        self._equivocations: dict[tuple[int, int], list[bytes]] = {}

    def publish(self, round_no: int, sender: int, payload: bytes) -> None:
        with self._lock:
            mailbox = self._rounds.setdefault(round_no, {})
            prev = mailbox.get(sender)
            if prev is None:
                mailbox[sender] = payload
                self._lock.notify_all()
            elif prev != payload:
                ev = self._equivocations.setdefault((round_no, sender), [prev])
                # evidence holds *distinct* payloads: a retry of an
                # already-recorded conflicting publish adds nothing
                if payload not in ev and len(ev) < _EVIDENCE_CAP:
                    ev.append(payload)

    def fetch(self, round_no: int, expected: int, timeout: float = 30.0) -> dict[int, bytes]:
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                got = self._rounds.get(round_no, {})
                if len(got) >= expected:
                    return dict(got)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return dict(got)
                self._lock.wait(remaining)

    def equivocation_evidence(self) -> dict[tuple[int, int], tuple[bytes, ...]]:
        """All observed equivocations: (round, sender) -> distinct payloads,
        first-published first.  Empty dict when every sender was consistent."""
        with self._lock:
            return {k: tuple(v) for k, v in self._equivocations.items()}
