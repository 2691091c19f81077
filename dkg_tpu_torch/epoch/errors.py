"""Typed failures of the epoch subsystem (refresh and resharing): a copy
of ``dkg_tpu/epoch/errors.py``.

Separate from ``dkg.errors.DkgError``: a failed epoch operation leaves
the previous epoch's state intact (the manager changes its state only
after the confirm step), so callers catch EpochError, keep serving the
old shares and retry.
"""

from __future__ import annotations


class EpochError(RuntimeError):
    """One epoch operation (refresh or reshare) failed; the party's
    previous epoch state is untouched.  ``kind`` is a stable string
    (NO_DEALERS, INSUFFICIENT_DEALERS, CHURN_LIMIT, CONFIRM_DIVERGENCE,
    MASTER_DRIFT, NO_GENESIS, BAD_COMMITTEE, NO_PREV_COMMITMENTS,
    MISSING_SHARE)."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"{kind}: {detail}" if detail else kind)
        self.kind = kind
        self.detail = detail
