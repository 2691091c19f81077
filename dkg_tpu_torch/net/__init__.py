"""Host-side broadcast channels and the durable per-party log: the part
of ``dkg_tpu/net/`` the epoch manager runs over (``InProcessChannel``
and ``PartyWal``).  The TCP hub, ``run_party`` and fault injection are
not ported yet."""

from .channel import (  # noqa: F401
    BroadcastChannel,
    InProcessChannel,
    RetryBudgetExceeded,
    TransportError,
    TruncatedStream,
)
from .checkpoint import (  # noqa: F401
    PartyWal,
    default_checkpoint_dir,
    wal_path,
)
