"""Ceremony flight recorder: structured JSONL events, a copy of
``dkg_tpu/utils/obslog.py`` less its trace converters.

Every interesting transition (an epoch round's head and tail, a publish,
a quarantine, a WAL record, a service convoy span, an injected fault) is
one JSON object with monotonic (``mono``) and wall (``ts``) timestamps and
``ceremony_id`` / ``party`` / ``round`` identity fields.  Events land in a
bounded in-memory ring (:class:`ObsLog`) and, when the ``DKG_TPU_OBSLOG``
knob names a directory, in one append-mode JSONL file per party, in the
JAX package's format (:func:`validate_events` and :func:`load_jsonl`
read either package's logs).

Redaction is structural: instrumentation sites pass only lengths, counts,
indices and error kinds, and every ``bytes`` value reaching
:meth:`ObsLog.emit` is replaced by its length before serialization.

Code deep inside a layer (the epoch manager, the service's fault plan)
emits through an *ambient* recorder (:func:`use` / :func:`emit_current`),
a :class:`contextvars.ContextVar`: every thread starts unbound, and a
binding nests and restores on exit.

The JAX package's Chrome-trace export and critical-path analysis
(``to_chrome_trace``, ``critical_path``) serve its forensics scripts and
are not ported.
"""

from __future__ import annotations

import contextvars
import gzip
import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Iterable

from . import envknobs

# The ambient recorder binding.  A ContextVar instead of threading.local:
# identical semantics for plain threads (every thread starts unbound),
# but copyable per asyncio task / contextvars.Context, so one scheduler
# thread interleaving several ceremonies keeps their streams separate.
_AMBIENT: contextvars.ContextVar["ObsLog | None"] = contextvars.ContextVar(
    "dkg_tpu_torch_obslog", default=None
)


def _sanitize(value: Any) -> Any:
    """Replace bytes payloads with their length, recursively.  The
    instrumentation contract is lengths-only already; this makes an
    accidental ``payload=raw`` emit a harmless ``"bytes:N"``."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        return f"bytes:{len(value)}"
    if isinstance(value, dict):
        return {str(k): _sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitize(v) for v in value]
    return value


class ObsLog:
    """Bounded ring of structured events with an optional JSONL file sink.

    ``ceremony_id`` and ``party`` bind once at construction and stamp
    every event; ``party`` is an int member index or ``"hub"``.
    """

    def __init__(
        self,
        capacity: int = 4096,
        path: str | os.PathLike | None = None,
        ceremony_id: str | None = None,
        party: int | str | None = None,
    ) -> None:
        self.ceremony_id = ceremony_id
        self.party = party
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._path = os.fspath(path) if path is not None else None
        self._fh = open(self._path, "a", encoding="utf-8") if self._path else None

    # -- recording ----------------------------------------------------------

    def emit(self, kind: str, *, round: int | None = None, **fields) -> dict:
        """Record one event; returns the event dict (tests poke at it)."""
        ev: dict[str, Any] = {
            "ts": time.time(),
            "mono": time.monotonic(),
            "kind": kind,
        }
        if self.ceremony_id is not None:
            ev["ceremony_id"] = self.ceremony_id
        if self.party is not None:
            ev["party"] = self.party
        if round is not None:
            ev["round"] = round
        for k, v in fields.items():
            ev[k] = _sanitize(v)
        with self._lock:
            self._ring.append(ev)
            if self._fh is not None:
                self._fh.write(json.dumps(ev, sort_keys=True) + "\n")
                self._fh.flush()
        return ev

    def emit_span(
        self,
        name: str,
        *,
        ts0: float,
        mono0: float,
        dur_s: float,
        subs: dict[str, float] | None = None,
        **fields,
    ) -> dict:
        """Record a completed span (``phase_span`` feeds these): start
        timestamps, duration, and optional sub-phase seconds that the
        trace export renders as nested slices."""
        span_fields: dict[str, Any] = {
            "name": name,
            "ts0": ts0,
            "mono0": mono0,
            "dur_s": dur_s,
        }
        if subs:
            span_fields["subs"] = {k: float(v) for k, v in subs.items()}
        span_fields.update(fields)
        return self.emit("span", **span_fields)

    # -- access -------------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    @property
    def path(self) -> str | None:
        return self._path

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "ObsLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- ambient (context-local) recorder ----------------------------------------


class _Use:
    """Context manager binding ``log`` as the current context's ambient
    recorder; ``use(None)`` is a no-op binding (events are dropped).
    Bindings nest: exit restores whatever was bound on entry."""

    def __init__(self, log: ObsLog | None) -> None:
        self._log = log
        self._token: contextvars.Token | None = None

    def __enter__(self) -> ObsLog | None:
        self._token = _AMBIENT.set(self._log)
        return self._log

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _AMBIENT.reset(self._token)
            self._token = None


def use(log: ObsLog | None) -> _Use:
    return _Use(log)


def current() -> ObsLog | None:
    """The current context's ambient recorder, or None."""
    return _AMBIENT.get()


def emit_current(kind: str, *, round: int | None = None, **fields) -> dict | None:
    """Emit into the ambient recorder if one is bound; else drop."""
    log = current()
    if log is None:
        return None
    return log.emit(kind, round=round, **fields)


# -- construction helpers ----------------------------------------------------


def ceremony_id_for(env) -> str:
    """Deterministic short id for a ceremony Environment: all parties of
    one ceremony derive the same id from the (group, n, t, commitment
    key) tuple, so their logs merge onto one timeline."""
    import hashlib

    h = hashlib.blake2b(digest_size=6)
    h.update(env.group.name.encode())
    h.update(f":{env.nr_members}:{env.threshold}:".encode())
    h.update(env.group.encode(env.commitment_key.h))
    return h.hexdigest()


def from_env(
    *,
    ceremony_id: str | None = None,
    party: int | str | None = None,
    capacity: int = 4096,
) -> ObsLog | None:
    """An :class:`ObsLog` with a file sink under the ``DKG_TPU_OBSLOG``
    directory, or None when the knob is unset.  File name is
    ``{ceremony_id}-p{party:03d}.jsonl`` (``-hub.jsonl`` for the hub)."""
    root = envknobs.string("DKG_TPU_OBSLOG", "flight-recorder log directory")
    if root is None:
        return None
    os.makedirs(root, exist_ok=True)
    cid = ceremony_id if ceremony_id is not None else "proc"
    tag = f"p{party:03d}" if isinstance(party, int) else str(party or "proc")
    path = os.path.join(root, f"{cid}-{tag}.jsonl")
    return ObsLog(capacity=capacity, path=path, ceremony_id=ceremony_id, party=party)


# -- event schema ------------------------------------------------------------

#: The pinned flight-recorder event schema (docs/observability.md, "Event
#: schema").  Every event carries the base fields ``ts``/``mono``/``kind``
#: (plus ``ceremony_id``/``party``/``round`` when bound); per-kind entries
#: list the REQUIRED payload fields and the OPTIONAL extras.  ``None`` for
#: the optional set marks an open kind (runtimeobs and service events whose
#: payloads vary by probe).  scripts/forensics.py and to_chrome_trace parse
#: exactly this schema — tests/test_obslog.py conformance-checks a live
#: ceremony's stream against it, so an emit-site drift fails loudly.
EVENT_SCHEMA: dict[str, dict[str, tuple | None]] = {
    # ceremony data plane (net.party / net.channel / net.faults)
    "round_head": {"required": ("round",), "optional": ()},
    "publish": {"required": ("round", "bytes", "seq"), "optional": ()},
    "round_tail": {
        "required": (
            "round", "present", "senders", "quarantined_delta", "timed_out",
        ),
        "optional": (),
    },
    "quarantine": {"required": ("round", "peer"), "optional": ()},
    "rpc_retry": {
        "required": ("attempt", "error", "backoff_s", "op"), "optional": (),
    },
    "budget_clamp": {"required": ("where", "timeout_s"), "optional": ("round",)},
    "fault_injected": {
        "required": ("round", "fault", "sender"), "optional": ("seconds",),
    },
    "abort": {"required": ("error", "drain_from"), "optional": ()},
    "party_done": {
        "required": (
            "ok", "quarantined", "timeouts", "retries", "resumes",
            "wal_records", "replayed_rounds",
        ),
        "optional": (),
    },
    # durability (net.checkpoint via net.party)
    "wal_record": {"required": ("round", "bytes", "terminal"), "optional": ()},
    "wal_resume": {"required": ("replayed_rounds",), "optional": ()},
    # epoch data plane (epoch.manager) — publish/tail mirror the ceremony
    # kinds field-for-field so forensics parses one format
    "epoch_head": {
        "required": ("round", "op", "step", "op_kind"), "optional": (),
    },
    "epoch_publish": {"required": ("round", "bytes", "seq"), "optional": ()},
    "epoch_tail": {
        "required": ("round", "present", "senders", "timed_out"),
        "optional": (),
    },
    "epoch_quarantine": {"required": ("round", "peer"), "optional": ()},
    "epoch_wal_record": {"required": ("op", "step", "bytes"), "optional": ()},
    "epoch_done": {
        "required": ("op", "op_kind", "status"), "optional": ("epoch",),
    },
    # hub side (net.channel TcpHub)
    "hub_rpc": {
        "required": ("op", "dur_s", "bytes_in", "bytes_out"), "optional": (),
    },
    "hub_junk_frame": {"required": ("reason",), "optional": ("op",)},
    # spans (tracing.phase_span / service scheduler).  The sign lane's
    # ``sign_convoy`` spans annotate the convoy composition: curve,
    # request/message/ceremony counts, proved flag, flush reason, and
    # how many tickets ended in error.
    "span": {
        "required": ("name", "ts0", "mono0", "dur_s"),
        "optional": (
            "subs", "curve", "requests", "messages", "ceremonies",
            "proved", "reason", "errors",
        ),
    },
    # open kinds: payload varies by probe/deployment (utils.runtimeobs,
    # dkg_tpu.service) — base-field conformance only
    "jax_compile": {"required": (), "optional": None},
    "counter_sample": {"required": (), "optional": None},
    "jax_cost_probe": {"required": (), "optional": None},
    "http_error": {"required": (), "optional": None},
    "service_fault_injected": {"required": (), "optional": None},
}

#: Base fields every event may carry regardless of kind.
_SCHEMA_BASE = ("ts", "mono", "kind", "ceremony_id", "party", "round")


def validate_events(
    events: Iterable[dict], *, allow_unknown: bool = False
) -> list[str]:
    """Check events against :data:`EVENT_SCHEMA`; returns a list of
    human-readable problems (empty = conformant).  Unknown kinds are
    errors unless ``allow_unknown`` (service deployments add their own
    ``service_*`` kinds); ``None``-valued fields satisfy presence (e.g.
    ``fault_injected.seconds`` for non-delay faults)."""
    problems: list[str] = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event #{i}: not a dict")
            continue
        kind = ev.get("kind")
        where = f"event #{i} ({kind!r})"
        for base in ("ts", "mono", "kind"):
            if base not in ev:
                problems.append(f"{where}: missing base field {base!r}")
        spec = EVENT_SCHEMA.get(kind) if isinstance(kind, str) else None
        if spec is None:
            if not allow_unknown:
                problems.append(f"{where}: unknown kind")
            continue
        for req in spec["required"]:
            if req not in ev:
                problems.append(f"{where}: missing required field {req!r}")
        optional = spec["optional"]
        if optional is None:
            continue  # open kind: any extras allowed
        allowed = set(_SCHEMA_BASE) | set(spec["required"]) | set(optional)
        for k in ev:
            if k not in allowed:
                problems.append(f"{where}: unexpected field {k!r}")
    return problems


# -- timeline export ---------------------------------------------------------


def load_jsonl(path: str | os.PathLike) -> list[dict]:
    """Events from one JSONL log; malformed lines are skipped (a crash
    mid-write must not poison the whole timeline).  ``.gz`` paths are
    read through gzip — chaos/fleet runs compress their sinks."""
    p = os.fspath(path)
    opener = gzip.open if p.endswith(".gz") else open
    out: list[dict] = []
    with opener(p, "rt", encoding="utf-8") as fh:
        try:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue
                if isinstance(ev, dict):
                    out.append(ev)
        except (EOFError, OSError, zlib.error):
            pass  # torn gzip tail: keep every line that decoded
    return out
