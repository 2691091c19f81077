"""Broadcast channels: publish-once / fetch-all per round.

A copy of ``dkg_tpu/net/channel.py``: the :class:`BroadcastChannel`
protocol, :class:`InProcessChannel`, and the TCP hub (:class:`TcpHub`, the
mailbox server, and :class:`TcpHubChannel`, its client).  Every party
publishes at most one message per round and everyone then fetches the
whole round; a party with nothing to say publishes the empty payload, a
party that never publishes is absent from the fetch.  The hub's frames
are the JAX package's byte for byte, so a port channel talks to a JAX
hub and a JAX channel to a port hub.

* **First-publish-wins.**  A second, different publish for the same
  (round, sender) never replaces the first; it is recorded as an
  equivocation attempt.  An identical re-publish is a no-op, which makes
  publish retries idempotent and a resumed party's replay safe.
* **Typed transport errors.**  Short reads raise :class:`TruncatedStream`
  (a :class:`TransportError`), never a bare ``EOFError``; a payload past
  the u32 length prefix raises :class:`PayloadTooLarge` before packing.
* **Retry with capped exponential backoff and jitter.**  Every
  ``TcpHubChannel`` RPC retries transient socket failures under attempt
  and timeout budgets (the ``DKG_TPU_NET_*`` knobs), optionally clamped
  to one ceremony-wide deadline (``DKG_TPU_NET_BUDGET_S``).
* **Fail-fast hub frames.**  The hub answers unknown opcodes and
  malformed or short frames with an explicit error byte and bounds frame
  reads with a timeout.

Every socket send and receive is counted into
``net_wire_bytes_total{dir,op}``; the hub also counts its RPCs, their
seconds and bytes and its junk frames, and the client its RPCs, retries
and budget clamps (``utils.metrics.REGISTRY``).  Authenticity and
transport security are the deployment's job: the protocol assumes an
authenticated channel.
"""

from __future__ import annotations

import random
import socket
import socketserver
import struct
import threading
import time
from typing import Optional, Protocol

from ..utils import envknobs, obslog
from ..utils.metrics import REGISTRY, SIZE_BUCKETS

_OP_PUB = 1
_OP_FETCH = 2
_OP_EVID = 3
_OP_NAMES = {_OP_PUB: "publish", _OP_FETCH: "fetch", _OP_EVID: "evidence"}

# Largest payload the length-prefixed wire format can carry: lengths are
# packed as little-endian u32 (`<I`/`<III`), so anything bigger must be
# rejected BEFORE packing — struct.error at pack time is opaque and, on
# the hub reply path, would tear the frame mid-stream.
WIRE_MAX_PAYLOAD = 0xFFFFFFFF

# How many distinct payloads (the original + alternates) to retain per
# equivocating (round, sender) as evidence before only counting.
_EVIDENCE_CAP = 8

# Ceiling for one backoff step, regardless of attempt count.
_BACKOFF_CAP_S = 2.0

# Socket-timeout floor for RPCs clamped by an exhausted ceremony budget:
# a healthy local hub answers a publish in well under a second, so the
# clamp bounds a hung hub's post-deadline cost without flaking working
# publishes (which peers' drains depend on).
_POST_BUDGET_IO_FLOOR_S = 1.0

# How long the hub waits for the rest of a frame once a connection
# opens; a well-behaved client sendall()s the whole frame before
# reading, so anything slower is a stalled or malformed sender.
_DEFAULT_FRAME_TIMEOUT_S = 5.0

_ACK_OK = b"\x01"
_ACK_ERR = b"\x00"

# Defaults for the DKG_TPU_NET_* knobs.
_DEFAULT_IO_TIMEOUT_S = 60.0
_DEFAULT_ATTEMPTS = 4
_DEFAULT_BACKOFF_MS = 50.0


class TransportError(RuntimeError):
    """A transport-layer failure (retryable; never a protocol error)."""


class TruncatedStream(TransportError):
    """The peer closed the stream mid-message (short read)."""


class RetryBudgetExceeded(TransportError):
    """All RPC attempts failed; carries the last underlying error."""


class PayloadTooLarge(TransportError):
    """A payload exceeds the u32 length prefix of the wire format.

    Raised BEFORE packing (client publish and hub reply paths both
    guard), carrying the offending size — retrying cannot help, but the
    typed error lets callers distinguish "your message is impossible"
    from a transient socket fault."""

    def __init__(self, size: int, where: str) -> None:
        super().__init__(
            f"payload of {size} bytes exceeds the u32 wire limit "
            f"({WIRE_MAX_PAYLOAD}) at {where}"
        )
        self.size = size
        self.where = where


def _check_wire_size(size: int, where: str) -> None:
    if size > WIRE_MAX_PAYLOAD:
        raise PayloadTooLarge(size, where)


# -- counted wire helpers -----------------------------------------------------
#
# Every socket send and receive in this module flows through these, so
# `net_wire_bytes_total{dir,op}` is the ground truth of what the data
# plane moved.


def _count_wire(direction: str, op: str, n: int) -> None:
    REGISTRY.inc("net_wire_bytes_total", n, dir=direction, op=op)


def _observe_payload(op: str, n: int) -> None:
    """Per-message-type payload-size histogram (op distinguishes the
    message family, e.g. publish vs fetch reply entries)."""
    REGISTRY.observe("net_wire_payload_bytes", n, buckets=SIZE_BUCKETS, op=op)


def _wire_send(sock: socket.socket, data: bytes, op: str) -> None:
    """The counted send: the module's only ``sendall``."""
    sock.sendall(data)
    _count_wire("out", op, len(data))


class _CountedReader:
    """File-like read wrapper counting bytes drained off a socket; the
    total is flushed into ``net_wire_bytes_total{dir="in"}`` by the RPC
    core once the reply is fully consumed."""

    def __init__(self, f) -> None:
        self._f = f
        self.n = 0

    def read(self, n: int) -> bytes:
        chunk = self._f.read(n)
        if chunk:
            self.n += len(chunk)
        return chunk


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


class _HubHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:  # one request per connection
        hub: "TcpHub" = self.server.hub  # type: ignore[attr-defined]
        t0 = time.perf_counter()
        op = None
        try:
            # a sender that opens a connection but never completes its
            # frame must not pin a handler thread forever
            self.connection.settimeout(hub.frame_timeout_s)
            op = _read_exact(self.rfile, 1)[0]
            if op == _OP_PUB:
                round_no, sender, ln = struct.unpack("<III", _read_exact(self.rfile, 12))
                payload = _read_exact(self.rfile, ln)
                _observe_payload("hub_publish", ln)
                hub.channel.publish(round_no, sender, payload)
                self.wfile.write(_ACK_OK)
                hub._observe_rpc("publish", time.perf_counter() - t0, 13 + ln, 1)
            elif op == _OP_FETCH:
                round_no, expected, timeout_ms = struct.unpack(
                    "<III", _read_exact(self.rfile, 12)
                )
                got = hub.channel.fetch(round_no, expected, timeout_ms / 1000.0)
                out = [struct.pack("<I", len(got))]
                for sender, payload in sorted(got.items()):
                    # hub reply path: guard BEFORE packing — a payload
                    # that slipped past the client guard (e.g. published
                    # straight into the backing InProcessChannel) must
                    # not tear the reply frame mid-stream
                    _check_wire_size(len(payload), "hub fetch reply")
                    _observe_payload("hub_fetch", len(payload))
                    out.append(struct.pack("<II", sender, len(payload)))
                    out.append(payload)
                reply = b"".join(out)
                self.wfile.write(reply)
                hub._observe_rpc("fetch", time.perf_counter() - t0, 13, len(reply))
            elif op == _OP_EVID:
                ev = hub.channel.equivocation_evidence()
                out = [struct.pack("<I", len(ev))]
                for (round_no, sender), payloads in sorted(ev.items()):
                    out.append(struct.pack("<III", round_no, sender, len(payloads)))
                reply = b"".join(out)
                self.wfile.write(reply)
                hub._observe_rpc("evidence", time.perf_counter() - t0, 1, len(reply))
            else:
                # unknown opcode: reply with an explicit error byte so
                # the client fails NOW, not at its socket timeout
                self.wfile.write(_ACK_ERR)
                hub._observe_junk("unknown_opcode")
        except (ConnectionError, TransportError, struct.error, OSError):
            # malformed/short/stalled frame: best-effort error byte, then
            # the connection closes — never a silent hang for the client
            hub._observe_junk("malformed_frame", op=op)
            self._best_effort_error()

    def _best_effort_error(self) -> None:
        try:
            self.wfile.write(_ACK_ERR)
            self.wfile.flush()
        except OSError:
            pass


def _read_exact(f, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise TruncatedStream(f"stream closed after {len(buf)}/{n} bytes")
        buf += chunk
    return buf


def _read_ack(f) -> bytes:
    """Read a one-byte hub ack; the explicit error byte (malformed or
    unknown frame) is a retryable transport failure, not a success."""
    ack = _read_exact(f, 1)
    if ack != _ACK_OK:
        raise TransportError(f"hub replied with error ack {ack!r}")
    return ack


class TcpHub:
    """The mailbox server: one per ceremony, any party (or a neutral
    host) can run it.  Threaded: each publish/fetch is one connection.
    First-publish-wins and the equivocation log come from the backing
    :class:`InProcessChannel`.  ``frame_timeout_s`` bounds how long a
    handler waits for the rest of a frame once a connection opens —
    stalled or malformed senders get an error byte, not a pinned
    thread."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        frame_timeout_s: float = _DEFAULT_FRAME_TIMEOUT_S,
    ) -> None:
        self.frame_timeout_s = frame_timeout_s
        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.channel = InProcessChannel()
        self._server = _Server((host, port), _HubHandler)
        self._server.hub = self  # type: ignore[attr-defined]
        self.address = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        # hub-side flight recorder (file sink only when DKG_TPU_OBSLOG
        # is set); handler threads have no ambient party recorder, so
        # the hub owns its own log
        self.obs = obslog.from_env(party="hub")

    def start(self) -> "TcpHub":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self.obs is not None:
            self.obs.close()

    # -- hub-side observability (called from handler threads) ---------------

    def _observe_rpc(self, op: str, dt: float, n_in: int, n_out: int) -> None:
        REGISTRY.inc("dkg_hub_rpcs_total", op=op)
        REGISTRY.observe("dkg_hub_rpc_seconds", dt, op=op)
        REGISTRY.inc("dkg_hub_bytes_total", n_in, direction="in")
        REGISTRY.inc("dkg_hub_bytes_total", n_out, direction="out")
        # the hub's share of the wire ledger: ops are prefixed so the
        # client and hub contributions of one in-process test never
        # merge into a double-counted series
        _count_wire("in", f"hub_{op}", n_in)
        _count_wire("out", f"hub_{op}", n_out)
        if self.obs is not None:
            self.obs.emit("hub_rpc", op=op, dur_s=dt, bytes_in=n_in, bytes_out=n_out)

    def _observe_junk(self, reason: str, op: int | None = None) -> None:
        REGISTRY.inc("dkg_hub_junk_frames_total", reason=reason)
        if self.obs is not None:
            self.obs.emit("hub_junk_frame", reason=reason, op=op)


class TcpHubChannel:
    """Client side of TcpHub; satisfies BroadcastChannel.

    Transient socket failures are retried with capped exponential
    backoff + jitter; ``stats`` counts what happened so ``run_party``
    can surface it (it threads the retries into ``PartyResult`` and the
    trace).

    Knobs (constructor arguments override; validated via
    utils.envknobs):

    * ``DKG_TPU_NET_TIMEOUT_S``  — per-RPC socket I/O timeout (default 60)
    * ``DKG_TPU_NET_ATTEMPTS``   — RPC attempts before giving up (default 4)
    * ``DKG_TPU_NET_BACKOFF_MS`` — base backoff between attempts (default 50)
    * ``DKG_TPU_NET_BUDGET_S``   — whole-ceremony RPC budget (default off)

    When the budget is set, the first operation arms one ceremony-wide
    deadline and EVERY RPC is clamped to the remaining budget: each
    ``fetch``'s hub-side wait shrinks to what is left (k silent parties
    cost one shared budget, not k full per-round timeouts), and
    ``publish``/``equivocation_counts`` socket timeouts are clamped too
    (floored at ~1s so working publishes still land), with no retries
    started past the deadline — a hung hub can no longer charge
    attempts x io_timeout per RPC after the budget is spent.  Every
    clamp is counted in ``stats["budget_clamps"]``.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        attempts: Optional[int] = None,
        io_timeout_s: Optional[float] = None,
        backoff_ms: Optional[float] = None,
        budget_s: Optional[float] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self._addr = (host, port)
        if attempts is None:
            attempts = envknobs.pos_int(
                "DKG_TPU_NET_ATTEMPTS", "RPC attempts before giving up"
            )
        if io_timeout_s is None:
            io_timeout_s = envknobs.pos_float(
                "DKG_TPU_NET_TIMEOUT_S", "per-RPC socket timeout in seconds"
            )
        if backoff_ms is None:
            backoff_ms = envknobs.nonneg_float(
                "DKG_TPU_NET_BACKOFF_MS", "base retry backoff in milliseconds"
            )
        if budget_s is None:
            budget_s = envknobs.pos_float(
                "DKG_TPU_NET_BUDGET_S", "whole-ceremony fetch budget in seconds"
            )
        self._attempts = attempts if attempts is not None else _DEFAULT_ATTEMPTS
        self._io_timeout_s = (
            io_timeout_s if io_timeout_s is not None else _DEFAULT_IO_TIMEOUT_S
        )
        self._backoff_s = (
            backoff_ms if backoff_ms is not None else _DEFAULT_BACKOFF_MS
        ) / 1000.0
        self._budget_s = budget_s
        self._deadline: Optional[float] = None
        self._rng = rng if rng is not None else random.Random()
        self.stats: dict[str, int] = {"rpcs": 0, "retries": 0, "budget_clamps": 0}

    # -- deadline budget ----------------------------------------------------

    def _budget_remaining(self) -> Optional[float]:
        """Arm the ceremony deadline on first use; None when budget is off."""
        if self._budget_s is None:
            return None
        if self._deadline is None:
            self._deadline = time.monotonic() + self._budget_s
        return max(0.0, self._deadline - time.monotonic())

    # -- retrying RPC core --------------------------------------------------

    def _rpc(
        self,
        payload: bytes,
        read_reply,
        io_timeout: float,
        budget_clamp: bool = True,
        op: str = "rpc",
    ) -> object:
        """One RPC with retries.  With ``budget_clamp`` (every RPC except
        ``fetch``, which pre-clamps its hub-side wait itself) the
        per-attempt socket timeout is clamped to the remaining ceremony
        budget — a hung hub costs at most ~the floor per RPC after the
        deadline, not attempts x io_timeout — and no RETRY starts past
        the deadline (the first attempt always runs: peers' drains
        depend on publishes landing even at the buzzer)."""
        self.stats["rpcs"] += 1
        REGISTRY.inc("dkg_client_rpcs_total")
        last: Optional[Exception] = None
        for attempt in range(self._attempts):
            remaining = self._budget_remaining()
            if attempt:
                if remaining is not None and remaining <= 0.0:
                    raise RetryBudgetExceeded(
                        f"ceremony budget exhausted after {attempt} attempt(s) "
                        f"to {self._addr}: {last!r}"
                    )
                self.stats["retries"] += 1
                REGISTRY.inc("dkg_client_rpc_retries_total")
                step = min(_BACKOFF_CAP_S, self._backoff_s * (2 ** (attempt - 1)))
                backoff = step * (0.5 + self._rng.random())
                # backoff_s makes retry time attributable to the retry,
                # not to the transport
                obslog.emit_current(
                    "rpc_retry", attempt=attempt, error=repr(last),
                    backoff_s=backoff, op=op,
                )
                time.sleep(backoff)
            timeout = io_timeout
            if budget_clamp and remaining is not None:
                clamped = min(io_timeout, max(remaining, _POST_BUDGET_IO_FLOOR_S))
                if clamped < timeout:
                    self.stats["budget_clamps"] += 1
                    REGISTRY.inc("dkg_client_budget_clamps_total")
                    obslog.emit_current("budget_clamp", where="rpc", timeout_s=clamped)
                    timeout = clamped
            try:
                with socket.create_connection(self._addr, timeout=timeout) as s:
                    _wire_send(s, payload, op)
                    f = _CountedReader(s.makefile("rb"))
                    try:
                        return read_reply(f)
                    finally:
                        _count_wire("in", op, f.n)
            except (OSError, TransportError) as exc:
                last = exc
        raise RetryBudgetExceeded(
            f"{self._attempts} attempt(s) to {self._addr} failed: {last!r}"
        )

    def publish(self, round_no: int, sender: int, payload: bytes) -> None:
        # guard BEFORE packing: an oversized payload must die as a typed
        # error carrying its size, not as an opaque struct.error
        _check_wire_size(len(payload), "client publish")
        _observe_payload("publish", len(payload))
        msg = bytes([_OP_PUB]) + struct.pack("<III", round_no, sender, len(payload)) + payload
        self._rpc(msg, _read_ack, self._io_timeout_s, op="publish")

    def fetch(self, round_no: int, expected: int, timeout: float = 30.0) -> dict[int, bytes]:
        remaining = self._budget_remaining()
        if remaining is not None and remaining < timeout:
            self.stats["budget_clamps"] += 1
            REGISTRY.inc("dkg_client_budget_clamps_total")
            obslog.emit_current(
                "budget_clamp", where="fetch", round=round_no, timeout_s=remaining
            )
            timeout = remaining
        timeout_ms = min(int(timeout * 1000), 0xFFFFFFFF)
        msg = bytes([_OP_FETCH]) + struct.pack("<III", round_no, expected, timeout_ms)

        def read_reply(f) -> dict[int, bytes]:
            (count,) = struct.unpack("<I", _read_exact(f, 4))
            out: dict[int, bytes] = {}
            for _ in range(count):
                sender, ln = struct.unpack("<II", _read_exact(f, 8))
                out[sender] = _read_exact(f, ln)
                _observe_payload("fetch", ln)
            return out

        # The hub blocks up to ``timeout`` before replying, so the socket
        # deadline must cover the wait *plus* normal I/O slack; the hub
        # wait was already clamped (and counted) above, so _rpc must not
        # clamp — or double-count — again.
        return self._rpc(
            msg, read_reply, timeout + self._io_timeout_s,
            budget_clamp=False, op="fetch",
        )

    def equivocation_counts(self) -> dict[tuple[int, int], int]:
        """(round, sender) -> number of distinct payloads the hub saw
        (>= 2 means the sender equivocated)."""
        msg = bytes([_OP_EVID])

        def read_reply(f) -> dict[tuple[int, int], int]:
            (count,) = struct.unpack("<I", _read_exact(f, 4))
            out: dict[tuple[int, int], int] = {}
            for _ in range(count):
                round_no, sender, n = struct.unpack("<III", _read_exact(f, 12))
                out[(round_no, sender)] = n
            return out

        return self._rpc(msg, read_reply, self._io_timeout_s, op="evidence")
