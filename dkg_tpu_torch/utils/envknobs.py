"""Validated environment-knob parsing: the part of
``dkg_tpu/utils/envknobs.py`` the epoch layer reads, a copy.

``DKG_TPU_EPOCH_DEADLINE_S`` (per-epoch-round fetch timeout) and
``DKG_TPU_EPOCH_MAX_CHURN`` (the leave+join budget a reshare accepts; 0
refuses any membership change) go through :func:`pos_float` and
:func:`nonneg_int` in ``epoch.manager``; ``DKG_TPU_CHECKPOINT_DIR``
through :func:`string` in ``net.checkpoint``.  A typo raises ValueError
rather than selecting a default.  An EMPTY value is treated as unset:
``DKG_TPU_X= cmd`` is the shell idiom for clearing a knob on one
invocation.
"""

from __future__ import annotations

import os


def nonneg_int(name: str, what: str) -> int | None:
    """None when ``name`` is unset, else its value as an int >= 0;
    ``what`` explains the zero semantics in the error message."""
    env = os.environ.get(name)
    if not env:
        return None
    try:
        v = int(env)
    except ValueError:
        v = -1
    if v < 0:
        raise ValueError(f"{name}={env!r}: expected a non-negative integer ({what})")
    return v


def pos_float(name: str, what: str) -> float | None:
    """None when ``name`` is unset, else its value as a finite float > 0."""
    env = os.environ.get(name)
    if not env:
        return None
    try:
        v = float(env)
    except ValueError:
        v = -1.0
    if not v > 0 or v != v or v == float("inf"):
        raise ValueError(f"{name}={env!r}: expected a positive finite number ({what})")
    return v


def string(name: str, what: str) -> str | None:
    """None when ``name`` is unset or empty, else its raw value (``what``
    documents the knob)."""
    del what
    return os.environ.get(name) or None
