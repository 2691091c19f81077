"""The service's typed error taxonomy, a copy of
``dkg_tpu/service/errors.py``: the class names are the JAX package's,
because the outcome errors the scheduler journals carry them.

* :class:`TransientEngineError`: the only class the scheduler retries;
  transiency is a claim only the fault's origin can make.
* :class:`PoisonedRequest`: a request that fails on its own at width 1
  (bisection has exonerated its convoy-mates); the terminal ``poisoned``
  status names it.
* :class:`InsufficientSigners`: fewer than t+1 honest qualified signers
  remain (a ValueError too).
* :class:`QueueFullError`: admission backpressure (HTTP 503).
* :class:`FleetSlotQuarantined`: a fleet slot that crash-looped; kept for
  the taxonomy's parity, raised by no ported module yet (no ``fleet.py``).

None of them is raised for a kernel's launch error: a CUDA error is
sticky for the context, and the scheduler treats it as any other
exception (bisection down to ``poisoned``), never as transient.
"""

from __future__ import annotations


class ServiceError(RuntimeError):
    """Base of every typed serving-path error.  Subclasses RuntimeError
    so pre-taxonomy catch sites (``except RuntimeError``) still work."""


class QueueFullError(ServiceError):
    """Admission queue at capacity — the caller should back off and
    retry (HTTP 503).  Raised instead of blocking: a DKG client can
    retry cheaply, while an unbounded queue turns overload into
    unbounded latency for everyone already queued."""


class TransientEngineError(ServiceError):
    """An engine fault the raiser asserts is worth retrying (the whole
    convoy re-runs, bounded by ``DKG_TPU_SERVICE_RETRIES`` with
    exponential backoff).  Nothing else is retried: transiency is a
    claim only the fault's origin can make."""


class PoisonedRequest(ServiceError):
    """A request that fails deterministically on its own — convoy
    bisection has run it at width 1, so healthy convoy-mates are
    exonerated.  Its outcome is terminal status ``poisoned``; retrying
    it anywhere (including journal replay, see
    ``DKG_TPU_SERVICE_MAX_REPLAYS``) is wasted work."""


class FleetSlotQuarantined(ServiceError):
    """A fleet worker slot died too many times within its crash-loop
    window (``DKG_TPU_FLEET_RESPAWN_MAX`` / ``.._WINDOW_S``) and was
    quarantined: no further respawns, and every ceremony placed on it
    gets a typed terminal outcome naming this class.  Retrying the same
    submission elsewhere is the caller's call — the fleet will not
    silently re-run work a crash-looping slot may have half-done."""


class InsufficientSigners(ServiceError, ValueError):
    """Fewer than t+1 honest qualified signers remain for a ceremony —
    either the qualification set was too small to begin with, or signer
    quarantine (Byzantine partials caught by RLC blame) consumed the
    substitution margin.  ValueError subclass for backward
    compatibility with the pre-quarantine precondition error."""
