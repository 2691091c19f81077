"""The multi-tenant ceremony service on the card: many concurrent DKGs,
one warm runtime.  Counterpart of ``dkg_tpu/service/``:

* :mod:`.buckets`: the shape-bucketing policy, limb for limb the JAX
  package's ladder;
* :mod:`.engine`: the warm execution lane, pad-and-mask ceremonies and
  the stacked convoy lane (every kernel launched once a convoy);
* :mod:`.scheduler`: the bounded admission queue, the worker pool with
  its two-deep start/finish pipeline, deadlines, retries, bisection, the
  watchdog, journal recovery, the sign lane and epoch operations;
* :mod:`.durable`: the WAL journal, record for record the JAX package's;
* :mod:`.errors`: the typed failure taxonomy;
* :mod:`.faultsvc`: seeded chaos for all of the above;
* :mod:`.httpobs` and :mod:`.slo`: the localhost scrape surface and the
  rolling SLO evaluator.

Not ported yet: ``aot.py`` (the JAX package's executable store) and
``fleet.py`` with ``FleetFaultPlan`` (ROADMAP).  Entry points:
:class:`CeremonyScheduler`, :class:`CeremonyRequest`; the runtime's
device is the card unless ``WarmRuntime(device="cpu")``.
"""

from .buckets import Bucket, bucket_for, split_widths
from .engine import CeremonyOutcome, CeremonyRequest, WarmRuntime
from .errors import (
    InsufficientSigners,
    PoisonedRequest,
    QueueFullError,
    ServiceError,
    TransientEngineError,
)
from .faultsvc import ServiceFaultPlan, WorkerCrash, corrupt_journal
from .scheduler import CeremonyScheduler

__all__ = [
    "Bucket",
    "bucket_for",
    "split_widths",
    "CeremonyOutcome",
    "CeremonyRequest",
    "WarmRuntime",
    "CeremonyScheduler",
    "ServiceError",
    "QueueFullError",
    "PoisonedRequest",
    "TransientEngineError",
    "InsufficientSigners",
    "ServiceFaultPlan",
    "WorkerCrash",
    "corrupt_journal",
]
