"""Seeded service-layer fault injection, a copy of
``dkg_tpu/service/faultsvc.py`` less ``FleetFaultPlan`` (no ``fleet.py``
yet).

A :class:`ServiceFaultPlan` is a seeded, declarative schedule; every
injection is observable (``service_faults_injected_total`` and an ambient
flight-recorder event), and ``chip_smoke.py``'s storm stage (the legs of
the JAX package's ``scripts/service_storm.py``) checks that the service
degrades instead of amplifying: healthy requests complete bit-identically
to a fault-free run while the scheduler contains the faults.

Fault kinds:

* *poison*: a convoy start holding a tagged request raises
  :class:`PoisonFault`, a generic exception, so the scheduler must find
  the culprit by bisection;
* *transient*: the next ``times`` starts raise
  :class:`~.errors.TransientEngineError`, the one type the scheduler
  retries;
* *slow*: the next ``times`` starts sleep ``seconds`` first;
* *worker-crash*: the N-th start raises :class:`WorkerCrash`, a
  ``BaseException`` that kills the worker thread, which the scheduler's
  watchdog respawns;
* *journal corruption*: :func:`corrupt_journal` appends garbage to the
  service WAL, a torn tail the next recovery must skip.

The plan plugs into :class:`~.scheduler.CeremonyScheduler` through its
``fault_plan=`` argument: every engine start and finish goes through
:meth:`ServiceFaultPlan.on_start` / :meth:`~ServiceFaultPlan.on_finish`.
"""

from __future__ import annotations

import random
import threading
import time

from ..net.checkpoint import service_wal_path
from ..utils import obslog
from ..utils.metrics import REGISTRY
from . import errors


class WorkerCrash(BaseException):
    """Kills a worker THREAD, not just a convoy: subclasses
    BaseException so the worker loop's ``except Exception`` cannot
    contain it — the thread dies and only the scheduler's watchdog
    brings the capacity back."""


class PoisonFault(RuntimeError):
    """The injected deterministic per-request failure.  Generic on
    purpose (see module docstring): the scheduler's bisection must
    locate the culprit without type hints."""


class ServiceFaultPlan:
    """Declarative, seeded fault schedule for one scheduler.

    Builder methods return ``self`` for chaining::

        plan = (ServiceFaultPlan(seed=7)
                .poison("req-3", "req-19")
                .transient(times=2)
                .slow(0.05, times=1)
                .crash_worker(at_start=5))

    Thread-safe: the scheduler's M workers consume the schedule
    concurrently; counters live under one lock.  ``injected`` and
    :meth:`as_dict` expose the ground truth the storm's blame-accuracy
    check compares the scheduler's verdicts against.
    """

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self._lock = threading.Lock()
        self._poison_tags: set[str] = set()
        self._transient_budget = 0
        self._slow_s = 0.0
        self._slow_budget = 0
        self._crash_at: set[int] = set()
        self._start_calls = 0
        self.injected: dict[str, int] = {}

    # -- builders -----------------------------------------------------------

    def poison(self, *tags: str) -> "ServiceFaultPlan":
        """Every start whose convoy contains a request with one of these
        ``tag`` values raises :class:`PoisonFault` — deterministic, so
        bisection re-runs keep failing until the culprit is alone."""
        self._poison_tags.update(tags)
        return self

    def transient(self, times: int = 1) -> "ServiceFaultPlan":
        """The next ``times`` starts raise TransientEngineError."""
        self._transient_budget += times
        return self

    def slow(self, seconds: float, times: int = 1) -> "ServiceFaultPlan":
        """The next ``times`` starts sleep ``seconds`` before running."""
        self._slow_s = seconds
        self._slow_budget += times
        return self

    def crash_worker(self, at_start: int) -> "ServiceFaultPlan":
        """The ``at_start``-th start call (1-based, across all workers)
        raises :class:`WorkerCrash`."""
        self._crash_at.add(at_start)
        return self

    # -- the scheduler-facing hook ------------------------------------------

    def _note(self, kind: str) -> None:
        """Every injection is observable: per-kind counter + ambient
        flight-recorder event (the net/faults.py contract)."""
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1
        REGISTRY.inc("service_faults_injected_total", kind=kind)
        log = obslog.current()
        if log is not None:
            log.emit("service_fault_injected", fault=kind)

    def on_start(self, reqs) -> None:
        """Called by the scheduler before every convoy start (primary,
        retry, and bisection runs alike).  Raises the scheduled fault."""
        with self._lock:
            self._start_calls += 1
            ncall = self._start_calls
            slow = 0.0
            if self._slow_budget > 0:
                self._slow_budget -= 1
                slow = self._slow_s
            crash = ncall in self._crash_at
            transient = False
            if not crash and not slow and self._transient_budget > 0:
                self._transient_budget -= 1
                transient = True
            poisoned = sum(1 for r in reqs if r.tag in self._poison_tags)
        if slow:
            self._note("slow")
            time.sleep(slow)
        if crash:
            self._note("worker_crash")
            raise WorkerCrash(f"injected worker crash at start #{ncall}")
        if transient:
            self._note("transient")
            raise errors.TransientEngineError("injected transient engine fault")
        if poisoned:
            self._note("poison")
            raise PoisonFault(f"injected poison ({poisoned} tagged member(s))")

    def on_finish(self, reqs) -> None:
        """Finish-side hook (no kinds scheduled here today; the seam
        exists so finish-phase faults need no scheduler change)."""

    # -- reporting ----------------------------------------------------------

    @property
    def poisoned_tags(self) -> frozenset[str]:
        """Ground truth for blame-accuracy checks."""
        return frozenset(self._poison_tags)

    def as_dict(self) -> dict:
        """JSON-able schedule + injection counts (storm artifacts)."""
        with self._lock:
            return {
                "seed": self.seed,
                "poison_tags": sorted(self._poison_tags),
                "crash_at_starts": sorted(self._crash_at),
                "slow_s": self._slow_s,
                "start_calls": self._start_calls,
                "injected": dict(self.injected),
            }


def corrupt_journal(wal_dir, seed: int = 0, nbytes: int = 48) -> str:
    """Append ``nbytes`` of seeded garbage to the service WAL in
    ``wal_dir`` — a torn/corrupted tail the next recovery's checksummed
    replay must skip without losing the intact prefix.  Returns the WAL
    path written."""
    path = service_wal_path(wal_dir)
    rng = random.Random(seed)
    with open(path, "ab") as f:  # deliberate WAL corruption
        f.write(bytes(rng.randrange(256) for _ in range(nbytes)))
    return str(path)
