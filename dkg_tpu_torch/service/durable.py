"""WAL-backed ceremony durability, a copy of
``dkg_tpu/service/durable.py``: a restarted server resumes its traffic.

One journal a server process (``net.checkpoint.service_wal_path``) over
:class:`~..net.checkpoint.PartyWal` (append-only, checksummed, fsync'd,
torn-tail tolerant).  Three record kinds, JSON bodies byte-identical to
the JAX package's, so a journal either package writes replays in the
other:

* ``req``, appended at admission before ``submit`` returns: the whole
  seeded request (the seed, not the coefficients: the re-dealt
  polynomials are the same by the engine's draw order);
* ``done``, at any terminal status: the public outcome only, never share
  material;
* ``replay``, each time recovery re-queues a pending ceremony, with its
  count: the crash-loop guard's memory (``max_replays`` poisons it).

:meth:`ServiceJournal.replay` splits the ids into pending, terminal and
the replay counts; the scheduler compacts the journal on recovery
(``PartyWal.rewrite``) so a torn tail never shadows later appends.
"""

from __future__ import annotations

import base64
import json

from ..net.checkpoint import PartyWal, service_wal_path
from .engine import CeremonyOutcome, CeremonyRequest

__all__ = ["ServiceJournal", "service_wal_path"]


def _req_body(cid: str, seq: int, req: CeremonyRequest) -> bytes:
    return json.dumps(
        {
            "kind": "req",
            "id": cid,
            "seq": seq,
            "curve": req.curve,
            "n": req.n,
            "t": req.t,
            "shared_string": base64.b64encode(req.shared_string).decode(),
            "seed": req.seed,
            "rho_bits": req.rho_bits,
            "deadline_s": req.deadline_s,
            "tag": req.tag,
        },
        sort_keys=True,
    ).encode()


def _done_body(out: CeremonyOutcome) -> bytes:
    return json.dumps(
        {
            "kind": "done",
            "id": out.ceremony_id,
            "status": out.status,
            "curve": out.curve,
            "n": out.n,
            "t": out.t,
            "bucket_n": out.bucket_n,
            "bucket_t": out.bucket_t,
            "master": out.master.hex(),
            "qualified": list(out.qualified),
            "complaints": [list(c) for c in out.complaints],
            "error": out.error,
        },
        sort_keys=True,
    ).encode()


def _replay_body(cid: str, count: int) -> bytes:
    return json.dumps(
        {"kind": "replay", "id": cid, "count": count}, sort_keys=True
    ).encode()


class ServiceJournal:
    """The scheduler's durability sink.  All writes happen under the
    scheduler's own locks (admission lock for ``record_request``, the
    completing worker for ``record_done``, recovery for
    ``record_replay``), so the journal itself needs no locking beyond
    PartyWal's single-write appends."""

    def __init__(self, directory) -> None:
        self.wal = PartyWal(service_wal_path(directory))

    def record_request(self, cid: str, seq: int, req: CeremonyRequest) -> None:
        self.wal.append(_req_body(cid, seq, req))

    def record_done(self, out: CeremonyOutcome) -> None:
        self.wal.append(_done_body(out))

    def record_replay(self, cid: str, count: int) -> None:
        """Persist that ``cid`` is being re-queued for the ``count``-th
        time (crash-loop guard; see module docstring)."""
        self.wal.append(_replay_body(cid, count))

    def replay(self):
        """(pending, terminal, replays): ``pending`` maps ceremony id ->
        ``(seq, CeremonyRequest)`` for admitted-but-unfinished
        ceremonies; ``terminal`` maps id -> public
        :class:`CeremonyOutcome`; ``replays`` maps id -> cumulative
        recovery re-queue count (later records win — counts only grow).
        Unparseable bodies are skipped (the frame checksum already
        passed, so these are version skew, not corruption — better to
        recover the rest than refuse)."""
        pending: dict = {}
        terminal: dict = {}
        replays: dict = {}
        for body in self.wal.replay():
            try:
                rec = json.loads(body)
                kind = rec["kind"]
            except (ValueError, KeyError):
                continue
            if kind == "req":
                try:
                    req = CeremonyRequest(
                        curve=rec["curve"],
                        n=rec["n"],
                        t=rec["t"],
                        shared_string=base64.b64decode(rec["shared_string"]),
                        seed=rec["seed"],
                        rho_bits=rec["rho_bits"],
                        deadline_s=rec["deadline_s"],
                        durable=True,
                        tag=rec.get("tag", ""),
                    )
                except (KeyError, ValueError):
                    continue
                pending[rec["id"]] = (rec.get("seq", 0), req)
            elif kind == "done":
                cid = rec.get("id")
                if cid is None:
                    continue
                pending.pop(cid, None)
                terminal[cid] = CeremonyOutcome(
                    ceremony_id=cid,
                    status=rec.get("status", "done"),
                    curve=rec.get("curve", ""),
                    n=rec.get("n", 0),
                    t=rec.get("t", 0),
                    bucket_n=rec.get("bucket_n", 0),
                    bucket_t=rec.get("bucket_t", 0),
                    master=bytes.fromhex(rec.get("master", "")),
                    qualified=tuple(rec.get("qualified", ())),
                    complaints=tuple(
                        tuple(c) for c in rec.get("complaints", ())
                    ),
                    error=rec.get("error", ""),
                )
            elif kind == "replay":
                cid = rec.get("id")
                if cid is None:
                    continue
                try:
                    count = int(rec.get("count", 0))
                except (TypeError, ValueError):
                    continue
                replays[cid] = max(replays.get(cid, 0), count)
        return pending, terminal, replays

    def compact(
        self, pending: dict, terminal: dict, replays: dict | None = None
    ) -> None:
        """Rewrite the journal to exactly the replayed state (pending
        reqs + their replay counts + terminal dones — a ``done`` record
        is self-contained, so terminal ceremonies need no ``req`` twin),
        dropping any torn tail so post-restart appends cannot be
        shadowed by it.  Replay counts for non-pending ids are dropped:
        the guard only ever consults them for pending ceremonies."""
        bodies = [
            _req_body(cid, seq, req) for cid, (seq, req) in pending.items()
        ]
        if replays:
            bodies.extend(
                _replay_body(cid, count)
                for cid, count in replays.items()
                if cid in pending
            )
        bodies.extend(_done_body(out) for out in terminal.values())
        self.wal.rewrite(bodies)
