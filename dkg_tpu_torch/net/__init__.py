"""Host-side broadcast channels, the channel-driven party and fault
injection: the counterpart of ``dkg_tpu/net/``.

* ``channel``: the abstract :class:`BroadcastChannel`, the in-process
  :class:`InProcessChannel` and the TCP hub (:class:`TcpHub`,
  :class:`TcpHubChannel`), whose frames are the JAX package's;
* ``party``: :func:`run_party`, the five phases over a channel with the
  deterministic wire encoding of ``utils.serde``, resumable from a WAL;
* ``checkpoint``: the durable per-party log (:class:`PartyWal`) that the
  party, the epoch manager and the ceremony service journal into;
* ``faults``: a seeded fault plan and the chaos harnesses
  (``run_with_faults``, ``run_epochs_with_faults``).
"""

from .channel import (  # noqa: F401
    BroadcastChannel,
    InProcessChannel,
    PayloadTooLarge,
    RetryBudgetExceeded,
    TcpHub,
    TcpHubChannel,
    TransportError,
    TruncatedStream,
)
from .checkpoint import (  # noqa: F401
    PartyWal,
    default_checkpoint_dir,
    service_wal_path,
    wal_path,
)
from .faults import (  # noqa: F401
    CrashFault,
    FaultPlan,
    FaultyChannel,
    RestartFault,
)
from .party import PartyResult, run_party  # noqa: F401
