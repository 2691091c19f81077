"""Admission queue and worker pool: the ceremony service's front door,
the JAX package's ``dkg_tpu/service/scheduler.py`` over the port's engine.

Threads, not asyncio: the work units are kernel launches (``ctypes``
drops the interpreter lock for each call), host transcript digests
(hashlib drops it too) and transfers.  The pool, the sign worker, the
watchdog and the scrape server (``httpobs``) are the only threads.

Flow:

* :meth:`CeremonyScheduler.submit` admits a request into a bounded queue;
  a full queue raises :class:`QueueFullError` at once (HTTP 503).  With a
  WAL directory, a durable request's record is fsync'd before submit
  returns its id;
* workers pop *convoys*: the queue head and up to ``batch_max - 1`` more
  queued requests sharing its convoy key, truncated to the width ladder
  (``buckets.WIDTHS``, capped by ``buckets.width_cap``);
* each worker runs a two-deep pipeline: it *starts* convoy k+1 (its deal
  enqueued on the card) before it *finishes* convoy k (transcript,
  verify, finalise);
* deadlines are enforced at pop (an expired ceremony never starts) and
  at finish (``expired``, not ``done``).

Blast-radius isolation: :class:`~.errors.TransientEngineError` retries the
whole convoy (bounded, exponential backoff); any other exception bisects
the convoy, the healthy halves completing normally and the request that
still fails alone ending ``poisoned`` (:class:`~.errors.PoisonedRequest`).
A CUDA launch error is such an exception: it is never taken for a
transient fault, and nothing here falls back to the CPU.  A watchdog
respawns workers killed by non-``Exception`` escapes and re-queues (once)
the convoys they held; the journal's recovery re-serves terminal outcomes
and poisons a request replayed ``max_replays`` times.

The sign lane: :meth:`sign` is :meth:`sign_submit` + :meth:`sign_wait`;
queued requests of any ceremony coalesce into per-(curve, proved) sign
convoys, flushed at ``sign_batch_max`` messages or after ``sign_flush_ms``.
Unproved traffic takes the folded leg (one ``sign.sign_folded`` a
``buckets.SIGN_RUNGS`` slice), proved traffic the per-request grid with
RLC blame and per-ceremony signer quarantine over ``sign.cache.SignCache``;
either gives the bytes of the single-call path.  :meth:`refresh` and
:meth:`reshare` run ``epoch.inprocess`` on a held outcome's shares.

One worker is the default over a runtime on the card: the engine's
``turn`` lock runs one convoy start or finish at a time, the device is
busy about a tenth of a convoy's wall, and a worker's two-deep pipeline
needs no second worker, so fleet_bench's 1000-ceremony mix took as long
with one worker as with four (an NVIDIA H100 80GB HBM3 at 700 W; PERF.md
§6, ``concurrency_bench``).  Any
other runtime keeps the JAX package's four.

The JAX package's ``runtimeobs.install`` / ``maybe_sample`` calls (its
JAX compile and memory telemetry) have no counterpart: the port has no
``utils/runtimeobs.py`` yet.  Metric names are the JAX package's, in the
port's ``utils.metrics.REGISTRY``.

Knobs (``utils.envknobs``; constructor arguments win):
``DKG_TPU_SERVICE_CONCURRENCY`` (workers; default 1 over a runtime on the
card, 4 otherwise),
``DKG_TPU_SERVICE_QUEUE_DEPTH`` (default 256),
``DKG_TPU_SERVICE_BATCH_MAX`` (default 8), ``DKG_TPU_SERVICE_DEADLINE_S``,
``DKG_TPU_SERVICE_WAL_DIR``, ``DKG_TPU_SERVICE_RETRIES`` (default 2),
``DKG_TPU_SERVICE_RETRY_BACKOFF_S`` (default 0.05),
``DKG_TPU_SERVICE_MAX_REPLAYS`` (default 3), ``DKG_TPU_SERVICE_HTTP_PORT``,
``DKG_TPU_SLO_*``, ``DKG_TPU_SIGN_FLUSH_MS`` (default 25),
``DKG_TPU_SIGN_BATCH_MAX`` (default ``buckets.SIGN_RUNGS[0]``).
"""

from __future__ import annotations

import contextlib
import hashlib
import random
import threading
import time

import numpy as np

from ..epoch import inprocess as epoch_inprocess
from ..fields import host as fh
from ..groups import host as gh
from ..utils import envknobs, obslog
from ..utils.metrics import REGISTRY
from . import buckets, errors, httpobs
from .durable import ServiceJournal
from .slo import SloEvaluator
from .engine import (
    CeremonyOutcome,
    CeremonyRequest,
    WarmRuntime,
    finish_convoy,
    request_id,
    start_convoy,
)
from .errors import QueueFullError  # noqa: F401 — re-exported, as the JAX package does

#: How many times a convoy orphaned by a crashed worker is re-queued
#: before its members fail with WORKER_CRASH.  One: the convoy itself
#: may be what killed the worker, so unbounded re-queueing would turn a
#: poisoned request into a worker crash-loop.
_MAX_CRASH_REQUEUES = 1


class _Pending:
    __slots__ = ("cid", "seq", "req", "deadline_at", "crashes")

    def __init__(self, cid, seq, req, deadline_at):
        self.cid = cid
        self.seq = seq
        self.req = req
        self.deadline_at = deadline_at
        self.crashes = 0  # worker-crash orphanings survived so far


class _SignPending:
    """One queued sign request: the lane's ticket.  ``done`` flips under
    ``_sign_cond`` once ``sigs`` (success) or ``error`` (typed failure,
    re-raised by :meth:`CeremonyScheduler.sign_wait`) is set."""

    __slots__ = (
        "cid", "curve", "msgs", "prove", "seed", "tamper", "enqueued_at",
        "sigs", "error", "done", "rlc_passes", "resigns", "signers",
    )

    def __init__(self, cid, curve, msgs, prove, seed, tamper):
        self.cid = cid
        self.curve = curve
        self.msgs = msgs
        self.prove = prove
        self.seed = seed
        self.tamper = tamper
        self.enqueued_at = time.monotonic()
        self.sigs = None
        self.error = None
        self.done = False
        self.rlc_passes = 0
        self.resigns = 0
        self.signers = 0


def _default_concurrency(runtime) -> int:
    """Worker threads when neither the argument nor the knob sets them:
    1 over a runtime on the card, else 4 (module docstring)."""
    device = getattr(runtime, "device", None)
    return 1 if getattr(device, "type", None) == "cuda" else 4


class CeremonyScheduler:
    """Bounded-admission ceremony scheduler over one warm runtime.

    Use as a context manager or call :meth:`close`.  Thread-safe: any
    thread may submit/poll/result concurrently.
    """

    def __init__(
        self,
        *,
        concurrency: int | None = None,
        queue_depth: int | None = None,
        batch_max: int | None = None,
        deadline_s: float | None = None,
        wal_dir: str | None = None,
        retries: int | None = None,
        retry_backoff_s: float | None = None,
        max_replays: int | None = None,
        sign_flush_ms: float | None = None,
        sign_batch_max: int | None = None,
        sign_cache=None,
        watchdog_interval_s: float = 0.5,
        fault_plan=None,
        log=None,
        runtime: WarmRuntime | None = None,
        metrics=REGISTRY,
        http_port: int | None = None,
        slo_policy=None,
    ) -> None:
        if runtime is None:
            runtime = WarmRuntime()
        if concurrency is None:
            concurrency = envknobs.pos_int(
                "DKG_TPU_SERVICE_CONCURRENCY", "scheduler worker threads"
            ) or _default_concurrency(runtime)
        if queue_depth is None:
            queue_depth = envknobs.pos_int(
                "DKG_TPU_SERVICE_QUEUE_DEPTH", "admission queue bound"
            ) or 256
        if batch_max is None:
            batch_max = envknobs.pos_int(
                "DKG_TPU_SERVICE_BATCH_MAX", "max stacked-convoy width"
            ) or buckets.WIDTHS[0]
        if deadline_s is None:
            deadline_s = envknobs.pos_float(
                "DKG_TPU_SERVICE_DEADLINE_S", "default per-ceremony deadline"
            )
        if wal_dir is None:
            wal_dir = envknobs.string(
                "DKG_TPU_SERVICE_WAL_DIR", "service durability journal directory"
            )
        if retries is None:
            retries = envknobs.nonneg_int(
                "DKG_TPU_SERVICE_RETRIES",
                "transient-fault convoy retries (0 disables)",
            )
            retries = 2 if retries is None else retries
        if retry_backoff_s is None:
            retry_backoff_s = envknobs.nonneg_float(
                "DKG_TPU_SERVICE_RETRY_BACKOFF_S",
                "first transient-retry backoff, doubling per attempt",
            )
            retry_backoff_s = 0.05 if retry_backoff_s is None else retry_backoff_s
        if max_replays is None:
            max_replays = envknobs.pos_int(
                "DKG_TPU_SERVICE_MAX_REPLAYS",
                "journal replays before a pending ceremony is poisoned",
            ) or 3
        if sign_flush_ms is None:
            sign_flush_ms = envknobs.nonneg_float(
                "DKG_TPU_SIGN_FLUSH_MS",
                "sign-lane deadline flush in milliseconds (0 = immediate)",
            )
            sign_flush_ms = 25.0 if sign_flush_ms is None else sign_flush_ms
        if sign_batch_max is None:
            sign_batch_max = envknobs.pos_int(
                "DKG_TPU_SIGN_BATCH_MAX", "max messages per sign convoy"
            ) or buckets.SIGN_RUNGS[0]
        from ..sign.cache import SignCache  # lazy like the sign() leg

        self.concurrency = concurrency
        self.queue_depth = queue_depth
        self.batch_max = min(batch_max, buckets.WIDTHS[0])
        self.sign_flush_s = sign_flush_ms / 1000.0
        self.sign_batch_max = sign_batch_max
        self.sign_cache = sign_cache if sign_cache is not None else SignCache()
        self.default_deadline_s = deadline_s
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.max_replays = max_replays
        self.runtime = runtime
        self.metrics = metrics
        self._fault_plan = fault_plan
        self._own_log = log is None
        self._log = log if log is not None else obslog.from_env()
        self._cond = threading.Condition()
        self._queue: list[_Pending] = []
        self._results: dict[str, CeremonyOutcome] = {}
        self._status: dict[str, str] = {}
        self._quarantine: dict[str, set[int]] = {}
        self._held: dict[int, list] = {}  # worker slot -> convoys in hand
        self._seq = 0
        self._gen = 0  # respawn generation, for unique thread names
        self._running = True
        self._draining = False
        # sign lane state: its OWN condition so coalescing/waking sign
        # traffic never contends with ceremony admission.  Lock order:
        # _cond may be taken while holding nothing; _sign_cond likewise;
        # _cond -> _sign_cond is allowed (watchdog), _sign_cond -> _cond
        # is FORBIDDEN — lane code snapshots under _cond first, releases,
        # then takes _sign_cond to deliver.
        self._sign_cond = threading.Condition()
        self._sign_queue: list[_SignPending] = []
        self._sign_inflight: list[_SignPending] = []
        self._sign_gen = 0
        self._watchdog_interval_s = watchdog_interval_s
        self._journal = ServiceJournal(wal_dir) if wal_dir else None
        if self._journal is not None:
            self._recover()
        # daemon so a crashed main thread never hangs on
        # ceremony workers
        self._workers = [
            threading.Thread(
                target=self._worker, args=(i,), name=f"dkg-svc-{i}", daemon=True
            )
            for i in range(concurrency)
        ]
        for w in self._workers:
            w.start()
        self._sign_thread = threading.Thread(
            target=self._sign_worker, name="dkg-svc-sign", daemon=True
        )
        self._sign_thread.start()
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name="dkg-svc-watchdog", daemon=True
        )
        self._watchdog.start()
        # the scrape surface (off unless http_port /
        # DKG_TPU_SERVICE_HTTP_PORT is configured)
        self.slo = SloEvaluator(registry=metrics, policy=slo_policy)
        self._http = httpobs.maybe_start(
            registry=metrics,
            health_fn=self.health,
            slo_fn=self.slo_report,
            log=self._log,
            port=http_port,
        )

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))

    def close(self, drain: bool = True) -> None:
        """Stop the workers.  ``drain`` finishes everything already
        admitted first; otherwise still-queued ceremonies complete as
        ``failed`` with a shutdown error (durable ones stay pending in
        the journal and are resubmitted on the next recovery)."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            if drain:
                while self._queue:
                    self._cond.wait(timeout=0.1)
        # drain the sign lane BEFORE flipping _running: the lane flushes
        # immediately once _draining is up, and queued tickets complete
        # normally (drain) instead of failing
        with self._sign_cond:
            self._sign_cond.notify_all()
            if drain:
                while self._sign_queue or self._sign_inflight:
                    self._sign_cond.wait(timeout=0.1)
        with self._cond:
            self._running = False
            dropped = list(self._queue)
            self._queue.clear()
            for p in dropped:
                # durable drops are NOT journalled as done: they stay
                # pending in the WAL and the next recovery resubmits them
                self._finish_one(
                    CeremonyOutcome(
                        ceremony_id=p.cid,
                        status="failed",
                        curve=p.req.curve,
                        n=p.req.n,
                        t=p.req.t,
                        error="SHUTDOWN",
                    ),
                )
            self._cond.notify_all()
        with self._sign_cond:
            for p in self._sign_queue:
                if not p.done:
                    p.error = QueueFullError("scheduler is shutting down")
                    p.done = True
            self._sign_queue.clear()
            self._sign_cond.notify_all()
        for w in self._workers:
            w.join(timeout=60)
        self._watchdog.join(timeout=60)
        self._sign_thread.join(timeout=60)
        if self._http is not None:
            self._http.close()
        if self._own_log and self._log is not None:
            self._log.close()

    def _recover(self) -> None:
        """Replay the journal: re-serve terminal outcomes, resubmit
        pending (admitted-but-unfinished) ceremonies under their
        original ids, and compact the log.

        Crash-loop guard: a pending ceremony already replayed
        ``max_replays`` times is the likely CAUSE of the crashes it
        keeps surviving — it completes as ``poisoned`` instead of being
        re-queued for another round of taking the process down."""
        pending, terminal, replays = self._journal.replay()
        self._journal.compact(pending, terminal, replays)
        for cid, out in terminal.items():
            self._results[cid] = out
            self._status[cid] = out.status
        now = time.monotonic()
        recovered = 0
        for cid, (seq, req) in pending.items():
            self._seq = max(self._seq, seq + 1)
            count = replays.get(cid, 0)
            if count >= self.max_replays:
                self.metrics.inc("service_poisoned_total")
                self._emit(
                    "service_replay_poisoned", ceremony=cid, replays=count
                )
                out = CeremonyOutcome(
                    ceremony_id=cid,
                    status="poisoned",
                    curve=req.curve,
                    n=req.n,
                    t=req.t,
                    error=(
                        f"PoisonedRequest: REPLAY_LIMIT "
                        f"(replayed {count}x, max {self.max_replays})"
                    ),
                )
                self._journal.record_done(out)
                self._results[cid] = out
                self._status[cid] = out.status
                continue
            self._journal.record_replay(cid, count + 1)
            deadline = (
                now + req.deadline_s if req.deadline_s is not None else None
            )
            self._queue.append(_Pending(cid, seq, req, deadline))
            self._status[cid] = "queued"
            recovered += 1
        self.metrics.set_gauge("service_queue_depth", len(self._queue))
        if recovered:
            self.metrics.inc("service_recovered_total", recovered)

    def _device_turn(self):
        """The runtime's ``turn`` lock (one thread drives the device at a
        time, see ``engine``), or no lock for a runtime without one (the
        tests' stand-ins)."""
        turn = getattr(self.runtime, "turn", None)
        return turn if turn is not None else contextlib.nullcontext()

    def _emit(self, kind: str, **fields) -> None:
        """Flight-recorder event, KIND-only error attribution — never a
        message payload (redaction contract: an exception string may
        embed share/seed material; the emitted stream must not)."""
        if self._log is not None:
            self._log.emit(kind, **fields)

    # -- client surface -----------------------------------------------------

    def submit(self, req: CeremonyRequest) -> str:
        """Admit a ceremony; returns its id or raises
        :class:`QueueFullError` (backpressure) / ``ValueError`` (bad
        request — including unbucketable shapes and unseeded durable
        requests, both rejected before touching the queue)."""
        buckets.bucket_for(req.n, req.t)  # validates; raises ValueError
        if req.durable and req.seed is None:
            raise ValueError(
                "durable ceremonies must be seeded: the journal replays "
                "the seed, not the coefficients"
            )
        if req.durable and self._journal is None:
            raise ValueError(
                "durable ceremony submitted but the scheduler has no WAL "
                "dir (DKG_TPU_SERVICE_WAL_DIR / wal_dir=)"
            )
        deadline_s = (
            req.deadline_s
            if req.deadline_s is not None
            else self.default_deadline_s
        )
        with self._cond:
            if not self._running or self._draining:
                self.metrics.inc("service_rejected_total")
                self._emit("service_rejected", error_kind="SHUTTING_DOWN")
                raise QueueFullError("scheduler is shutting down")
            if len(self._queue) >= self.queue_depth:
                self.metrics.inc("service_rejected_total")
                self._emit("service_rejected", error_kind="QUEUE_FULL")
                raise QueueFullError(
                    f"admission queue full ({self.queue_depth})"
                )
            seq = self._seq
            self._seq += 1
            cid = request_id(req, seq)
            if req.durable:
                self._journal.record_request(cid, seq, req)
            deadline_at = (
                time.monotonic() + deadline_s if deadline_s is not None else None
            )
            self._queue.append(_Pending(cid, seq, req, deadline_at))
            self._status[cid] = "queued"
            self.metrics.inc("service_submitted_total")
            self.metrics.set_gauge("service_queue_depth", len(self._queue))
            self._cond.notify()
        return cid

    def health(self) -> dict:
        """Liveness dict (the ``/healthz`` payload — service/httpobs):
        ``ok`` means accepting work with a live pool.  Dead workers are
        watchdog-respawned, so the bar is "any worker alive", not "all";
        a fully dead pool or a closed/draining scheduler reads not-ok."""
        with self._cond:
            alive = sum(1 for w in self._workers if w.is_alive())
            total = len(self._workers)
            depth = len(self._queue)
            running = self._running
            draining = self._draining
        return {
            "ok": bool(running and not draining and alive > 0),
            "running": running,
            "draining": draining,
            "workers_alive": alive,
            "workers_total": total,
            "queue_depth": depth,
            "queue_capacity": self.queue_depth,
            "wal": "ok" if self._journal is not None else "off",
        }

    def slo_report(self) -> dict:
        """Rolling-window SLO judgment (the ``/slo`` payload — see
        service/slo.py for the window/quantile/error-budget math)."""
        return self.slo.report()

    def poll(self, cid: str) -> str:
        """Current status: queued | running | done | failed | expired |
        poisoned — or ``unknown`` for an id this scheduler never
        admitted."""
        with self._cond:
            return self._status.get(cid, "unknown")

    def manifest(self) -> dict[str, str]:
        """Every ceremony id this scheduler knows, with its current
        status — the post-recovery inventory a fleet parent uses to
        repopulate its placement map after respawning a worker from a
        slot journal (service/fleet.py's ``manifest`` pipe op).  Covers
        queued/running work and terminal outcomes alike; an id absent
        here after a journal recovery was genuinely never accepted (or
        was non-durable) and is reported lost, not resurrected."""
        with self._cond:
            return dict(self._status)

    def result(self, cid: str, timeout: float | None = None) -> CeremonyOutcome:
        """Block until ``cid`` reaches a terminal status and return its
        outcome (TimeoutError on timeout, KeyError for unknown ids)."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._cond:
            if cid not in self._status:
                raise KeyError(f"unknown ceremony id {cid!r}")
            while cid not in self._results:
                remain = None
                if deadline is not None:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        raise TimeoutError(
                            f"ceremony {cid} still {self._status[cid]}"
                        )
                self._cond.wait(timeout=remain)
            return self._results[cid]

    def quarantined(self, cid: str) -> frozenset[int]:
        """The 1-based signer indices quarantined for ceremony ``cid``
        (Byzantine partials caught by :meth:`sign`'s RLC blame)."""
        with self._cond:
            return frozenset(self._quarantine.get(cid, ()))

    # -- epoch operations against a held outcome ----------------------------

    def _held_outcome(self, cid: str) -> CeremonyOutcome:
        """The live, share-holding outcome for an epoch op.  KeyError for
        unknown ids, ValueError for non-terminal / failed / share-less
        (journal-recovered or retired) outcomes — callers see exactly
        which precondition failed."""
        out = self._results.get(cid)
        if out is None:
            if cid in self._status:
                raise ValueError(
                    f"ceremony {cid} is still {self._status[cid]}"
                )
            raise KeyError(f"unknown ceremony id {cid!r}")
        if out.status != "done":
            raise ValueError(f"ceremony {cid} is {out.status}, not done")
        if out.final_shares is None:
            raise ValueError(
                f"ceremony {cid} holds no shares (journal-recovered "
                "outcomes and retired epochs serve results only)"
            )
        return out

    def refresh(self, cid: str, seed: int | None = None) -> int:
        """Proactively refresh the held shares of ceremony ``cid`` in
        place: every share changes, the master key (and the outcome's
        public surface) does not.  Returns the new epoch number.

        Runs on the caller's thread — the work is one batched device
        evaluation (``epoch.inprocess``), far below convoy cost, so
        it does not compete through the admission queue.  Concurrent
        epoch ops on the same ceremony are detected by an epoch-counter
        CAS and rejected with ValueError.
        """
        t0 = time.monotonic()
        with self._cond:
            out = self._held_outcome(cid)
            token = out.epoch
            fs = gh.ALL_GROUPS[out.curve].scalar_field
            shares = [int(v) for v in fh.decode(fs, out.final_shares)]
        rng = random.Random(seed) if seed is not None else random.SystemRandom()
        with self._device_turn():
            new = epoch_inprocess.refresh_shares(
                fs, out.n, out.t, shares, rng, device=self.runtime.device
            )
        with self._cond:
            if self._results.get(cid) is not out or out.epoch != token:
                raise ValueError(f"concurrent epoch operation on {cid}")
            out.final_shares = np.asarray(fh.encode(fs, new))
            out.epoch = token + 1
        self.metrics.inc("service_epochs_total", kind="refresh")
        self.metrics.observe(
            "service_epoch_seconds", time.monotonic() - t0, kind="refresh"
        )
        return token + 1

    def reshare(
        self,
        cid: str,
        n_new: int,
        t_new: int,
        seed: int | None = None,
    ) -> str:
        """Reshare ceremony ``cid``'s secret into a fresh (n_new, t_new)
        sharing held under a NEW ceremony id (returned).  The source
        outcome is RETIRED — its shares are dropped (proactive security:
        two live sharings of one secret double the exposure) and further
        epoch ops on it fail; its public result stays served.  The new
        outcome carries the same master key, ``epoch`` advanced by one.
        """
        if not (1 <= t_new < (n_new + 1) / 2):
            raise ValueError(
                f"threshold must satisfy 1 <= t < (n+1)/2, got "
                f"t={t_new} n={n_new}"
            )
        t0 = time.monotonic()
        with self._cond:
            out = self._held_outcome(cid)
            token = out.epoch
            fs = gh.ALL_GROUPS[out.curve].scalar_field
            shares = [int(v) for v in fh.decode(fs, out.final_shares)]
        rng = random.Random(seed) if seed is not None else random.SystemRandom()
        with self._device_turn():
            new = epoch_inprocess.reshare_shares(
                fs, out.n, out.t, shares, n_new, t_new, rng,
                device=self.runtime.device,
            )
        h = hashlib.blake2b(digest_size=6)
        h.update(f"reshare|{cid}|{n_new}|{t_new}|{token + 1}".encode())
        new_cid = h.hexdigest()
        new_out = CeremonyOutcome(
            ceremony_id=new_cid,
            status="done",
            curve=out.curve,
            n=n_new,
            t=t_new,
            master=out.master,
            qualified=(True,) * n_new,
            epoch=token + 1,
            final_shares=np.asarray(fh.encode(fs, new)),
        )
        with self._cond:
            if self._results.get(cid) is not out or out.epoch != token:
                raise ValueError(f"concurrent epoch operation on {cid}")
            out.final_shares = None  # retire the old sharing
            out.epoch = token + 1
            self._record(new_out)
        self.metrics.inc("service_epochs_total", kind="reshare")
        self.metrics.observe(
            "service_epoch_seconds", time.monotonic() - t0, kind="reshare"
        )
        return new_cid

    def sign(
        self,
        cid: str,
        msgs: list[bytes],
        *,
        prove: bool = True,
        seed: int | None = None,
        tamper=None,
    ) -> list[bytes]:
        """Threshold-sign a whole message batch under ceremony ``cid``:
        one canonical signature encoding per message.

        The workload the keys are FOR: all B messages hash to the curve
        in one counter-batched pass (sign.hash2curve), all B x (t+1)
        partials run as one batched ladder (sign.partial), and the
        aggregation is one Pippenger MSM with the message batch as a
        leading axis (sign.aggregate).

        Byzantine tolerance (``prove=True``, the default): the quorum is
        a seed-derived rotation over the ELIGIBLE signers (qualified
        minus this ceremony's quarantine), the whole partial grid is
        checked with ONE RLC-combined pass (sign.verify.rlc_verify), and
        a failing grid is bisected to the exact bad (message, signer)
        cells — the blamed signers join the per-ceremony quarantine and
        the batch transparently re-signs with substitute signers.  By
        Lagrange-at-zero algebra every honest quorum encodes the SAME
        signature bytes, so substitution is invisible to the caller.
        :class:`~.errors.InsufficientSigners` (a
        ValueError) is raised only when eligible signers drop below t+1.

        ``tamper`` is the chaos hook (mirrors ``BatchedCeremony.run``'s):
        called with each attempt's PartialSignatures before
        verification; tests and scripts/service_storm.py use it to play
        the Byzantine signer.

        Since the steady-state lane landed this is submit+wait over the
        sign queue (:meth:`sign_submit` / :meth:`sign_wait`): the
        request may coalesce with other callers' into one warm convoy,
        but the bytes, the rng-derived quorum rotation, the blame /
        quarantine behaviour, and every raised type are identical to
        running alone.  It never mutates the outcome, so concurrent
        epoch ops are safe (and by share-refresh algebra the signatures
        they produce are identical).
        """
        if not msgs:
            return []
        return self.sign_wait(
            self.sign_submit(cid, msgs, prove=prove, seed=seed, tamper=tamper)
        )

    def sign_submit(
        self,
        cid: str,
        msgs: list[bytes],
        *,
        prove: bool = True,
        seed: int | None = None,
        tamper=None,
    ) -> _SignPending:
        """Enqueue a sign request on the lane and return its ticket
        (pass to :meth:`sign_wait`).  Raises here, on the caller's
        thread, for the same preconditions the synchronous path raised
        for: KeyError (unknown ceremony), ValueError (not done /
        share-less), :class:`QueueFullError` (shutting down)."""
        with self._cond:
            out = self._held_outcome(cid)
            curve = out.curve
        p = _SignPending(cid, curve, list(msgs), prove, seed, tamper)
        with self._sign_cond:
            if not self._running or self._draining:
                raise QueueFullError("scheduler is shutting down")
            self._sign_queue.append(p)
            self.metrics.set_gauge(
                "sign_queue_depth",
                sum(len(q.msgs) for q in self._sign_queue),
            )
            self._sign_cond.notify_all()
        return p

    def sign_wait(
        self, ticket: _SignPending, timeout: float | None = None
    ) -> list[bytes]:
        """Block until the lane finishes ``ticket``; returns the
        signature bytes or re-raises the request's typed failure
        (TimeoutError on timeout, with the request still in flight)."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._sign_cond:
            while not ticket.done:
                remain = None
                if deadline is not None:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        raise TimeoutError(
                            f"sign request for {ticket.cid} still in the lane"
                        )
                self._sign_cond.wait(timeout=remain)
        if ticket.error is not None:
            raise ticket.error
        return ticket.sigs

    # -- sign lane (worker side) ---------------------------------------------

    def _pop_sign_convoy(self):
        """Wait for a flush condition and pop one sign convoy: the head
        ticket plus queued mates sharing its (curve, proved) key, capped
        at ``sign_batch_max`` total messages (a lone over-wide ticket
        still pops alone — rung slicing inside the leg bounds the device
        shapes).  Flush fires when the cap is reached (``full``), when
        the head has waited ``sign_flush_ms`` (``deadline``), or
        immediately on drain/shutdown.  Returns (convoy, reason), or
        None when shut down and empty."""
        with self._sign_cond:
            while True:
                if not self._running:
                    if not self._sign_queue:
                        return None
                elif not self._sign_queue:
                    self._sign_cond.wait(timeout=0.2)
                    continue
                head = self._sign_queue[0]
                key = (head.curve, head.prove)
                mates = [
                    p
                    for p in self._sign_queue
                    if (p.curve, p.prove) == key
                ]
                total = sum(len(p.msgs) for p in mates)
                age = time.monotonic() - head.enqueued_at
                if (
                    self._running
                    and not self._draining
                    and total < self.sign_batch_max
                    and age < self.sign_flush_s
                ):
                    # more traffic may coalesce: sleep to the deadline
                    self._sign_cond.wait(timeout=self.sign_flush_s - age)
                    continue
                reason = "full" if total >= self.sign_batch_max else "deadline"
                convoy: list[_SignPending] = []
                taken = 0
                for p in mates:
                    if convoy and taken + len(p.msgs) > self.sign_batch_max:
                        break
                    convoy.append(p)
                    taken += len(p.msgs)
                for p in convoy:
                    self._sign_queue.remove(p)
                self._sign_inflight = list(convoy)
                self.metrics.inc("sign_flush_total", reason=reason)
                self.metrics.set_gauge(
                    "sign_queue_depth",
                    sum(len(q.msgs) for q in self._sign_queue),
                )
                return convoy, reason

    def _sign_worker(self) -> None:
        while True:
            popped = self._pop_sign_convoy()
            if popped is None:
                return
            convoy, reason = popped
            self._run_sign_convoy(convoy, reason)

    def _run_sign_convoy(self, convoy, reason) -> None:
        t0 = time.monotonic()
        ts0 = time.time()
        subs = {
            "hash_s": 0.0, "partial_s": 0.0,
            "verify_s": 0.0, "aggregate_s": 0.0,
        }
        try:
            with self._device_turn():
                self._sign_execute(convoy, subs)
        except Exception as exc:  # noqa: BLE001 — the lane must survive
            with self._device_turn():
                self._isolate_sign(convoy, exc, subs)
        dt = time.monotonic() - t0
        self.metrics.inc("sign_convoys_total")
        if self._log is not None:
            # the lane thread has no ambient obslog context
            # (obslog.current() is a contextvar on the caller's thread)
            # so the convoy span goes to the scheduler's own recorder
            self._log.emit_span(
                "sign_convoy",
                ts0=ts0,
                mono0=t0,
                dur_s=dt,
                subs=subs,
                curve=convoy[0].curve,
                requests=len(convoy),
                messages=sum(len(p.msgs) for p in convoy),
                ceremonies=len({p.cid for p in convoy}),
                proved=convoy[0].prove,
                reason=reason,
                errors=sum(1 for p in convoy if p.error is not None),
            )
        self._deliver_sign(convoy)

    def _deliver_sign(self, convoy) -> None:
        """Per-ticket terminal accounting (success metrics mirror the
        pre-lane synchronous path, ceremony-labelled) and waiter wakeup."""
        now = time.monotonic()
        for p in convoy:
            if p.error is None and p.sigs is None:
                # every path below should have concluded the ticket;
                # a fake/monkeypatched engine that forgot one must not
                # strand its waiter forever
                p.error = errors.TransientEngineError(
                    "SIGN_LANE_LOST: convoy concluded without a result"
                )
            if p.error is None:
                self.metrics.inc("sign_requests_total", ceremony=p.cid)
                self.metrics.inc(
                    "sign_messages_total", len(p.msgs), ceremony=p.cid
                )
                if p.rlc_passes:
                    self.metrics.inc(
                        "sign_rlc_passes_total", p.rlc_passes, ceremony=p.cid
                    )
                self.metrics.observe(
                    "sign_seconds", now - p.enqueued_at, ceremony=p.cid
                )
        with self._sign_cond:
            for p in convoy:
                p.done = True
            self._sign_inflight = []
            self._sign_cond.notify_all()

    def _sign_execute(self, convoy, subs) -> None:
        """Compute every still-live ticket in ``convoy``: the lane's
        engine surface (tests fake it the way engine tests fake
        start/finish_convoy).  Unproved, untampered tickets take the
        folded fast leg together; proved (or tampered) tickets run the
        per-request grid loop — same rng stream as the pre-lane path, so
        bytes/blame/metrics are identical.  Per-ticket failures land on
        the ticket; only convoy-shared failures raise (caller bisects).
        """
        fast, grid = [], []
        for p in convoy:
            if p.error is not None or p.sigs is not None:
                continue
            snap = self._sign_snapshot(p)
            if snap is None:
                continue  # precondition failure already on the ticket
            if p.prove or p.tamper is not None:
                grid.append((p, snap))
            else:
                fast.append((p, snap))
        self._sign_fast_leg(fast, subs)
        # proved steady traffic coalesces into ONE convoy acceptance
        # (one hash screen + one RLC-MSM, sign.verify.rlc_verify_convoy)
        # instead of a per-ticket MSM.  Seeded and tampered tickets keep
        # the per-ticket grid verbatim: a seeded request must produce
        # the same bytes, blame, and pass counts it always did.
        convoyable = [
            (p, snap)
            for p, snap in grid
            if p.prove and p.tamper is None and p.seed is None
        ]
        solo = grid
        if len(convoyable) >= 2:
            self._sign_convoy_rlc(convoyable, subs)
            taken = {id(p) for p, _snap in convoyable}
            solo = [(p, snap) for p, snap in grid if id(p) not in taken]
        for p, snap in solo:
            try:
                p.sigs = self._sign_grid_one(p, snap, subs)
            except errors.ServiceError as exc:
                p.error = exc  # typed (InsufficientSigners...): solo parity
            except Exception as exc:  # noqa: BLE001 — lane must conclude
                self._poison_sign_one(p, exc)

    def _sign_convoy_rlc(self, tickets, subs) -> None:
        """Proved-traffic convoy acceptance: every ticket draws its
        quorum and signs its grid exactly as the per-ticket path would,
        then ONE combined hash screen + RLC-MSM accepts the whole
        convoy.  Tickets the combined check cannot vouch for (a
        screen-failing cell, or an undifferentiated combined failure)
        replay on :meth:`_sign_grid_one` from scratch — the per-ticket
        path owns bisecting blame and quarantine, so fault semantics
        are untouched; only the overwhelmingly common all-honest convoy
        pays the single pass.  The convoy's pass count lands on the
        first accepted ticket (totals across tickets stay equal to
        MSM passes actually performed)."""
        from .. import sign as signing
        from ..sign import verify as sign_verify

        prepared = []  # (p, snap, ps, quorum)
        for p, snap in tickets:
            mat, t, qualified = snap
            try:
                eligible = self._sign_eligible(p, qualified)
                if len(eligible) < t + 1:
                    raise self._sign_starved(p, eligible, t + 1)
                th0 = time.monotonic()
                h_points, _ = signing.hash_to_curve_batch(
                    mat.curve, list(p.msgs), device=self.runtime.device
                )
                subs["hash_s"] += time.monotonic() - th0
                rng = random.SystemRandom()
                quorum = sorted(rng.sample(eligible, t + 1))
                tp0 = time.monotonic()
                ps = signing.partial_sign(
                    mat.curve,
                    [mat.shares[i - 1] for i in quorum],
                    quorum,
                    h_points,
                    rng=rng,
                    prove=True,
                    pks=self.sign_cache.quorum_pks(
                        mat, quorum, device=self.runtime.device
                    ),
                    device=self.runtime.device,
                )
                subs["partial_s"] += time.monotonic() - tp0
                prepared.append((p, snap, ps, quorum))
            except errors.ServiceError as exc:
                p.error = exc
            except Exception as exc:  # noqa: BLE001 — lane must conclude
                self._poison_sign_one(p, exc)
        if not prepared:
            return
        tv0 = time.monotonic()
        report = sign_verify.rlc_verify_convoy(
            [ps for _p, _snap, ps, _q in prepared]
        )
        subs["verify_s"] += time.monotonic() - tv0
        self.metrics.inc(
            "sign_convoy_rlc_total",
            result="ok" if report.ok else "fallback",
        )
        credited = False
        for k, (p, snap, ps, quorum) in enumerate(prepared):
            if not report.grid_ok[k]:
                try:
                    p.sigs = self._sign_grid_one(p, snap, subs)
                except errors.ServiceError as exc:
                    p.error = exc
                except Exception as exc:  # noqa: BLE001 — lane must conclude
                    self._poison_sign_one(p, exc)
                continue
            try:
                ta0 = time.monotonic()
                curve = ps.curve
                lam = self.sign_cache.lagrange_at_zero(curve, tuple(quorum))[1]
                p.sigs = signing.signature_encode(
                    curve, signing.aggregate(ps, lam=lam)
                )
                subs["aggregate_s"] += time.monotonic() - ta0
                p.rlc_passes = 0 if credited else report.passes
                credited = True
                p.signers = len(quorum)
            except Exception as exc:  # noqa: BLE001 — lane must conclude
                self._poison_sign_one(p, exc)

    def _sign_snapshot(self, p):
        """(CeremonyMaterial, t, qualified) for a ticket — the held
        outcome is snapshotted under ``_cond`` but decoded OUTSIDE it,
        behind the per-(ceremony, epoch) cache: a slow sign no longer
        stalls admission or epoch ops.  Records precondition failures
        (unknown / not-done / retired ceremony) on the ticket."""
        try:
            with self._cond:
                out = self._held_outcome(p.cid)
                curve, t, qualified = out.curve, out.t, out.qualified
                epoch, final_shares = out.epoch, out.final_shares
        except (KeyError, ValueError) as exc:
            p.error = exc
            return None
        mat = self.sign_cache.ceremony(p.cid, epoch, curve, final_shares)
        return mat, t, qualified

    def _sign_eligible(self, p, qualified) -> list[int]:
        with self._cond:
            quarantined = set(self._quarantine.get(p.cid, ()))
        return [
            i + 1
            for i, q in enumerate(qualified)
            if q and (i + 1) not in quarantined
        ]

    def _sign_starved(self, p, eligible, need) -> errors.InsufficientSigners:
        self.metrics.inc("sign_starved_total", ceremony=p.cid)
        self._emit(
            "sign_starved", ceremony=p.cid,
            eligible=len(eligible), need=need,
        )
        return errors.InsufficientSigners(
            f"ceremony {p.cid} has {len(eligible)} eligible "
            f"qualified signers, needs t+1={need}"
        )

    def _sign_fast_leg(self, fast, subs) -> None:
        """The steady-state throughput path: every unproved ticket's
        messages, from ANY ceremony, signed by ONE folded ladder per
        ``buckets.SIGN_RUNGS`` slice.  sigma = f(0) per ceremony comes
        from the cache, so per-ticket work is a quorum draw and a row of
        precomputed limbs; hashing of rung k+1 runs under rung k's
        dispatch shadow, and nothing blocks until every rung is in
        flight (``sign.folded_collect``)."""
        from .. import sign as signing

        live = []
        for p, (mat, t, qualified) in fast:
            eligible = self._sign_eligible(p, qualified)
            if len(eligible) < t + 1:
                p.error = self._sign_starved(p, eligible, t + 1)
                continue
            # seed-derived quorum rotation, as in the grid leg — the
            # fold makes the draw byte-irrelevant (sigma == f(0) for
            # every honest quorum) but keeps rotation observability
            rng = (
                random.Random(p.seed)
                if p.seed is not None
                else random.SystemRandom()
            )
            quorum = sorted(rng.sample(eligible, t + 1))
            p.signers = len(quorum)
            live.append((p, self.sign_cache.fold_limbs(mat, quorum)))
        if not live:
            return
        curve = live[0][0].curve
        msgs: list[bytes] = []
        rows = []
        for p, sigma in live:
            msgs.extend(p.msgs)
            rows.extend([sigma] * len(p.msgs))
        rows = np.asarray(rows)  # (B, L)
        # DKG_TPU_SIGN_MESH=1: the rung ladder is mapped over the local
        # devices (parallel.signmesh owns the device tuple; the lane just
        # routes), limb-identical to the one-device rung; each rung is one
        # folded scalar_mul a device, enqueued before the next rung is hashed
        from ..parallel import signmesh

        mesh = signmesh.sign_mesh()
        if mesh is not None:
            self.metrics.set_gauge("sign_mesh_devices", len(mesh))
        pending = []
        t_partial = 0.0
        for a, b in buckets.sign_rung_slices(len(msgs), self.sign_batch_max):
            th0 = time.monotonic()
            _, h_dev = signing.hash_to_curve_batch(
                curve, msgs[a:b], device=self.runtime.device
            )
            tp0 = time.monotonic()
            subs["hash_s"] += tp0 - th0
            if mesh is not None:
                self.metrics.inc("sign_mesh_rungs_total")
                pending.append(signmesh.sign_folded_sharded(curve, rows[a:b], h_dev, mesh))
            else:
                pending.append(signing.sign_folded(curve, rows[a:b], h_dev))
            t_partial += time.monotonic() - tp0
        ta0 = time.monotonic()
        wire = signing.signature_encode(
            curve, signing.folded_collect(curve, pending)
        )
        subs["partial_s"] += t_partial
        subs["aggregate_s"] += time.monotonic() - ta0
        at = 0
        for p, _sigma in live:
            p.sigs = wire[at : at + len(p.msgs)]
            at += len(p.msgs)

    def _sign_grid_one(self, p, snap, subs) -> list[bytes]:
        """The pre-lane per-request loop, verbatim semantics, minus the
        re-derivation: shares/pks come from the (ceremony, epoch) cache,
        Lagrange coefficients from the (curve, quorum) cache.  rng
        consumption order (quorum draw -> DLEQ nonces -> RLC challenges)
        matches the old synchronous path exactly, so a seeded request
        produces the same bytes, blame, and pass counts it always did."""
        from .. import sign as signing
        from ..sign import verify as sign_verify

        mat, t, qualified = snap
        curve = mat.curve
        eligible = self._sign_eligible(p, qualified)
        th0 = time.monotonic()
        h_points, _ = signing.hash_to_curve_batch(
            curve, list(p.msgs), device=self.runtime.device
        )
        subs["hash_s"] += time.monotonic() - th0
        rng = (
            random.Random(p.seed)
            if p.seed is not None
            else random.SystemRandom()
        )
        passes = 0
        while True:
            if len(eligible) < t + 1:
                raise self._sign_starved(p, eligible, t + 1)
            # seed-derived quorum rotation: never always-first-t+1, so
            # load (and exposure) spreads across the qualified set
            quorum = sorted(rng.sample(eligible, t + 1))
            tp0 = time.monotonic()
            ps = signing.partial_sign(
                curve,
                [mat.shares[i - 1] for i in quorum],
                quorum,
                h_points,
                rng=rng,
                prove=p.prove,
                pks=self.sign_cache.quorum_pks(
                    mat, quorum, device=self.runtime.device
                ),
                device=self.runtime.device,
            )
            subs["partial_s"] += time.monotonic() - tp0
            if p.tamper is not None:
                ps = p.tamper(ps) or ps
            if not p.prove:
                break
            tv0 = time.monotonic()
            report = sign_verify.rlc_verify(ps, rng=rng)
            subs["verify_s"] += time.monotonic() - tv0
            passes += report.passes
            if report.ok:
                break
            blamed = sorted({quorum[si] for (_bi, si) in report.bad_cells})
            p.resigns += 1
            with self._cond:
                self._quarantine.setdefault(p.cid, set()).update(blamed)
            self.metrics.inc(
                "sign_quarantined_total", len(blamed), ceremony=p.cid
            )
            self.metrics.inc("sign_resigns_total", ceremony=p.cid)
            self._emit(
                "sign_blame",
                ceremony=p.cid,
                blamed=blamed,
                cells=[list(c) for c in report.bad_cells],
                passes=report.passes,
            )
            eligible = [i for i in eligible if i not in blamed]
        ta0 = time.monotonic()
        lam = self.sign_cache.lagrange_at_zero(curve, tuple(quorum))[1]
        sigs = signing.signature_encode(
            curve, signing.aggregate(ps, lam=lam)
        )
        subs["aggregate_s"] += time.monotonic() - ta0
        p.rlc_passes = passes
        p.signers = len(quorum)
        return sigs

    def _poison_sign_one(self, p, exc) -> None:
        """Width-1 sign failure: the ticket is the culprit.  Typed
        ServiceErrors pass through (callers branch on them); anything
        else surfaces as :class:`PoisonedRequest`."""
        self.metrics.inc("sign_poisoned_total", ceremony=p.cid)
        self._emit(
            "sign_poisoned", ceremony=p.cid, error_kind=type(exc).__name__
        )
        if isinstance(exc, errors.ServiceError):
            p.error = exc
        else:
            p.error = errors.PoisonedRequest(f"{type(exc).__name__}: {exc}")

    def _isolate_sign(self, convoy, exc, subs) -> None:
        """A sign (sub-)convoy raised outside any single ticket's own
        guarded leg: bisect, exactly like ceremony convoys — healthy
        halves re-run and complete bit-identically to signing alone,
        and the ticket still failing by itself is poisoned."""
        live = [p for p in convoy if p.error is None and p.sigs is None]
        if not live:
            return
        if len(live) == 1:
            self._poison_sign_one(live[0], exc)
            return
        self.metrics.inc("sign_bisections_total")
        self._emit(
            "sign_convoy_bisect",
            width=len(live),
            error_kind=type(exc).__name__,
        )
        mid = len(live) // 2
        for half in (live[:mid], live[mid:]):
            try:
                self._sign_execute(half, subs)
            except Exception as e2:  # noqa: BLE001 — isolation must conclude
                self._isolate_sign(half, e2, subs)

    # -- worker side --------------------------------------------------------

    def _pop_convoy(self, block: bool) -> list[_Pending] | None:
        """Head-of-queue convoy: the oldest QUEUED request plus up to
        ``batch_max - 1`` others sharing its convoy key, truncated to
        the largest ladder width that fits (never phantom-padded).
        Returns None when idle (non-blocking) or shut down."""
        with self._cond:
            while True:
                if not self._running or (self._draining and not self._queue):
                    return None
                expired = [
                    p
                    for p in self._queue
                    if p.deadline_at is not None
                    and time.monotonic() > p.deadline_at
                ]
                for p in expired:
                    self._queue.remove(p)
                    self.metrics.inc("service_expired_total", where="queued")
                    self._emit(
                        "service_expired", ceremony=p.cid, where="queued"
                    )
                    self._finish_one(
                        CeremonyOutcome(
                            ceremony_id=p.cid,
                            status="expired",
                            curve=p.req.curve,
                            n=p.req.n,
                            t=p.req.t,
                            error="DEADLINE_EXCEEDED",
                        ),
                        durable=p.req.durable,
                    )
                if self._queue:
                    break
                if not block:
                    return None
                self._cond.wait(timeout=0.2)
            head = self._queue[0]
            key = head.req.convoy_key()
            mates = [p for p in self._queue if p.req.convoy_key() == key]
            cap = min(self.batch_max, buckets.width_cap(head.req.bucket()))
            width = next(
                w for w in buckets.WIDTHS if w <= min(len(mates), cap)
            )
            convoy = mates[:width]
            for p in convoy:
                self._queue.remove(p)
                self._status[p.cid] = "running"
            self.metrics.set_gauge("service_queue_depth", len(self._queue))
            self.metrics.inc("service_convoys_total")
            self._cond.notify_all()
            return convoy

    def _engine_start(self, reqs, cids):
        """Dispatch a convoy, routing through the chaos hook when a
        fault plan is installed (service.faultsvc)."""
        if self._fault_plan is not None:
            self._fault_plan.on_start(reqs)
        return start_convoy(self.runtime, reqs, cids)

    def _engine_finish(self, fl, reqs):
        if self._fault_plan is not None:
            self._fault_plan.on_finish(reqs)
        return finish_convoy(self.runtime, fl)

    def _run_once(self, convoy):
        """Synchronous start+finish of a (sub-)convoy — the bisection /
        retry lane, off the two-deep pipeline."""
        reqs = [p.req for p in convoy]
        fl = self._engine_start(reqs, [p.cid for p in convoy])
        return self._engine_finish(fl, reqs)

    def _hold(self, slot: int, convoy) -> None:
        with self._cond:
            self._held.setdefault(slot, []).append(convoy)

    def _release(self, slot: int, convoy) -> None:
        with self._cond:
            held = self._held.get(slot, [])
            if convoy in held:
                held.remove(convoy)

    def _worker(self, slot: int) -> None:
        inflight = None  # (convoy, InFlight, t_start)
        while True:
            convoy = self._pop_convoy(block=inflight is None)
            if convoy is not None:
                self._hold(slot, convoy)
                t0 = time.monotonic()
                try:
                    fl = self._engine_start(
                        [p.req for p in convoy], [p.cid for p in convoy]
                    )
                except Exception as exc:  # noqa: BLE001 — worker must survive
                    self._isolate(convoy, exc, t0)
                    self._release(slot, convoy)
                    continue
                if inflight is not None:
                    self._finish(*inflight)
                    self._release(slot, inflight[0])
                inflight = (convoy, fl, t0)
                continue
            if inflight is not None:
                self._finish(*inflight)
                self._release(slot, inflight[0])
                inflight = None
                continue
            with self._cond:
                if not self._running or (self._draining and not self._queue):
                    return

    def _watchdog_loop(self) -> None:
        """Detect and respawn dead workers (non-``Exception`` escapes or
        bookkeeping bugs kill a thread silently — without this the pool
        just shrinks until the service deadlocks).  Convoys the dead
        worker held are re-queued once, then failed: the convoy may be
        what killed it (see :data:`_MAX_CRASH_REQUEUES`)."""
        while True:
            with self._cond:
                self._cond.wait(timeout=self._watchdog_interval_s)
                if not self._running:
                    return
                self._watch_pool()
            # outside the _cond block: the sign check takes _sign_cond,
            # and holding _cond across it is legal (_cond -> _sign_cond
            # order) but pointless contention
            self._maybe_respawn_sign_worker()

    def _watch_pool(self) -> None:
        """One watchdog sweep over the ceremony worker pool (caller
        holds ``_cond``)."""
        for i, w in enumerate(self._workers):
            if w.is_alive():
                continue
            orphans = self._held.pop(i, [])
            self._gen += 1
            nw = threading.Thread(
                target=self._worker,
                args=(i,),
                name=f"dkg-svc-{i}r{self._gen}",
                daemon=True,
            )
            self._workers[i] = nw
            nw.start()
            self.metrics.inc("service_worker_restarts_total")
            self._emit("service_worker_restart", slot=i)
            for convoy in orphans:
                for p in convoy:
                    p.crashes += 1
                    if p.crashes > _MAX_CRASH_REQUEUES:
                        self._emit(
                            "service_worker_crash_failed",
                            ceremony=p.cid,
                        )
                        self.metrics.inc(
                            "service_failed_total",
                            kind="WORKER_CRASH",
                        )
                        self._finish_one(
                            CeremonyOutcome(
                                ceremony_id=p.cid,
                                status="failed",
                                curve=p.req.curve,
                                n=p.req.n,
                                t=p.req.t,
                                error=(
                                    "WORKER_CRASH: worker died "
                                    f"{p.crashes}x holding this "
                                    "request"
                                ),
                            ),
                            durable=p.req.durable,
                        )
                    else:
                        self._queue.insert(0, p)
                        self._status[p.cid] = "queued"
                        self.metrics.inc("service_requeued_total")
            self.metrics.set_gauge(
                "service_queue_depth", len(self._queue)
            )
            self._cond.notify_all()

    def _maybe_respawn_sign_worker(self) -> None:
        """Watchdog leg for the sign lane: respawn a dead sign worker.
        Tickets it held in flight fail as TransientEngineError — the
        convoy may be what killed it, so re-running is the caller's
        call, not the lane's."""
        with self._sign_cond:
            if not self._running or self._sign_thread.is_alive():
                return
            orphans = list(self._sign_inflight)
            self._sign_inflight = []
            self._sign_gen += 1
            nt = threading.Thread(
                target=self._sign_worker,
                name=f"dkg-svc-sign-r{self._sign_gen}",
                daemon=True,
            )
            self._sign_thread = nt
            nt.start()
            self.metrics.inc("service_worker_restarts_total")
            self._emit("sign_worker_restart")
            for p in orphans:
                if not p.done:
                    p.error = errors.TransientEngineError(
                        "SIGN_WORKER_CRASH: sign worker died holding "
                        "this request"
                    )
                    p.done = True
            self._sign_cond.notify_all()

    def _finish(self, convoy, fl, t0) -> None:
        try:
            outcomes = self._engine_finish(fl, [p.req for p in convoy])
        except Exception as exc:  # noqa: BLE001 — worker must survive
            self._isolate(convoy, exc, t0)
            return
        self._finish_outcomes(convoy, outcomes, t0)

    def _finish_outcomes(self, convoy, outcomes, t0) -> None:
        dt = time.monotonic() - t0
        # per-ceremony attribution: a width-w convoy's wall clock is
        # shared by w ceremonies (the whole-convoy time goes to the
        # service_convoy_seconds histogram below)
        share = dt / max(1, len(convoy))
        for p, out in zip(convoy, outcomes):
            out.seconds = share
            if (
                p.deadline_at is not None
                and time.monotonic() > p.deadline_at
            ):
                self.metrics.inc("service_expired_total", where="inflight")
                self._emit(
                    "service_expired", ceremony=p.cid, where="inflight"
                )
                out = CeremonyOutcome(
                    ceremony_id=out.ceremony_id,
                    status="expired",
                    curve=out.curve,
                    n=out.n,
                    t=out.t,
                    error="DEADLINE_EXCEEDED",
                    seconds=share,
                )
            with self._cond:
                self._finish_one(out, durable=p.req.durable)
        self.metrics.observe(
            "service_convoy_seconds", dt, width=str(len(convoy))
        )

    # -- blast-radius isolation ---------------------------------------------

    def _isolate(self, convoy, exc, t0) -> None:
        """A (sub-)convoy raised ``exc``: contain the blast radius.

        Typed :class:`~.errors.TransientEngineError`
        retries the WHOLE convoy (bounded, exponential backoff) — the
        work is presumed good, the engine hiccuped.  Everything else is
        presumed poison and bisected down the width ladder: healthy
        halves complete bit-identically to an undisturbed run, and the
        request still failing alone at width 1 is the culprit."""
        if isinstance(exc, errors.TransientEngineError):
            exc = self._retry_transient(convoy, exc, t0)
            if exc is None:
                return  # recovered; outcomes already recorded
            if isinstance(exc, errors.TransientEngineError):
                self._fail_convoy(convoy, exc)  # retries exhausted
                return
            # a retry surfaced a non-transient fault: bisect it
        if len(convoy) == 1:
            self._poison_one(convoy[0], exc)
            return
        self.metrics.inc("service_convoy_bisections_total")
        self._emit(
            "service_convoy_bisect",
            width=len(convoy),
            error_kind=type(exc).__name__,
        )
        mid = len(convoy) // 2
        for half in (convoy[:mid], convoy[mid:]):
            t1 = time.monotonic()
            try:
                outs = self._run_once(half)
            except Exception as e2:  # noqa: BLE001 — isolation must conclude
                self._isolate(half, e2, t1)
            else:
                self._finish_outcomes(half, outs, t1)

    def _retry_transient(self, convoy, exc, t0):
        """Bounded whole-convoy retry for a transient engine fault.
        Returns None when a retry succeeded (outcomes recorded), the
        last TransientEngineError when retries are exhausted, or a
        non-transient exception a retry surfaced (caller bisects)."""
        last = exc
        for attempt in range(1, self.retries + 1):
            self.metrics.inc("service_retries_total")
            self._emit(
                "service_retry", attempt=attempt, width=len(convoy),
                error_kind=type(last).__name__,
            )
            time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
            try:
                outs = self._run_once(convoy)
            except errors.TransientEngineError as e2:
                last = e2
                self._emit(
                    "service_retry_failed", attempt=attempt,
                    error_kind=type(e2).__name__,
                )
                continue
            except Exception as e2:  # noqa: BLE001 — classified by caller
                self._emit(
                    "service_retry_surfaced", attempt=attempt,
                    error_kind=type(e2).__name__,
                )
                return e2
            self._finish_outcomes(convoy, outs, t0)
            return None
        return last

    def _poison_one(self, p, exc) -> None:
        """Width-1 failure: the request is the culprit — typed poisoned
        outcome, convoy-mates (if any) already completed elsewhere."""
        self.metrics.inc("service_poisoned_total")
        self._emit(
            "service_poisoned", ceremony=p.cid, error_kind=type(exc).__name__
        )
        self._finish_one(
            CeremonyOutcome(
                ceremony_id=p.cid,
                status="poisoned",
                curve=p.req.curve,
                n=p.req.n,
                t=p.req.t,
                error=f"PoisonedRequest: {type(exc).__name__}: {exc}",
            ),
            durable=p.req.durable,
        )

    def _fail_convoy(self, convoy, exc) -> None:
        """Terminal whole-convoy failure (transient retries exhausted,
        shutdown races): every member fails with the error KIND
        metric-labelled and obslog'd — no silent outcomes."""
        kind = type(exc).__name__
        self.metrics.inc("service_failed_total", len(convoy), kind=kind)
        self._emit("service_convoy_failed", width=len(convoy), error_kind=kind)
        with self._cond:
            for p in convoy:
                self._finish_one(
                    CeremonyOutcome(
                        ceremony_id=p.cid,
                        status="failed",
                        curve=p.req.curve,
                        n=p.req.n,
                        t=p.req.t,
                        error=f"{type(exc).__name__}: {exc}",
                    ),
                    durable=p.req.durable,
                )

    def _finish_one(
        self,
        out: CeremonyOutcome,
        durable: bool = False,
    ) -> None:
        """Record a terminal outcome.  Journal the public outcome for
        durable ceremonies so recovery re-serves instead of re-running.
        The condition's lock is reentrant, so callers already holding it
        just re-enter."""
        if durable and self._journal is not None:
            self._journal.record_done(out)
        with self._cond:
            self._record(out)

    def _record(self, out: CeremonyOutcome) -> None:
        out.completed_at = time.monotonic()
        self._results[out.ceremony_id] = out
        self._status[out.ceremony_id] = out.status
        self.metrics.inc("service_completed_total", status=out.status)
        if out.seconds:
            # bucket label, not ceremony_id: a server runs unboundedly
            # many ceremonies and histogram series must stay bounded
            # (per-ceremony attribution goes through obslog/tracing)
            self.metrics.observe(
                "service_ceremony_seconds", out.seconds,
                bucket=f"{out.bucket_n}x{out.bucket_t}" if out.bucket_n else "none",
            )
        self._cond.notify_all()
