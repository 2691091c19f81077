"""Validated environment-knob parsing: the part of
``dkg_tpu/utils/envknobs.py`` the epoch layer and the ceremony service
read, a copy.

``DKG_TPU_EPOCH_DEADLINE_S`` (per-epoch-round fetch timeout) and
``DKG_TPU_EPOCH_MAX_CHURN`` (the leave+join budget a reshare accepts; 0
refuses any membership change) go through :func:`pos_float` and
:func:`nonneg_int` in ``epoch.manager``; ``DKG_TPU_CHECKPOINT_DIR``
through :func:`string` in ``net.checkpoint``; the service's
``DKG_TPU_SERVICE_*``, ``DKG_TPU_SIGN_*`` and ``DKG_TPU_SLO_*`` knobs
through :func:`pos_int`, :func:`nonneg_float` and the rest in
``service.scheduler``, ``service.slo`` and ``service.httpobs``; the
flight recorder's ``DKG_TPU_OBSLOG`` in ``utils.obslog``; the sign
lane's ``DKG_TPU_SIGN_MESH`` through :func:`choice` in
``parallel.signmesh``.  A typo raises ValueError
rather than selecting a default.  An EMPTY value is treated as unset:
``DKG_TPU_X= cmd`` is the shell idiom for clearing a knob on one
invocation.
"""

from __future__ import annotations

import os


def pos_int(name: str, what: str) -> int | None:
    """None when ``name`` is unset, else its value as an int >= 1."""
    env = os.environ.get(name)
    if not env:
        return None
    try:
        v = int(env)
    except ValueError:
        v = 0
    if v < 1:
        raise ValueError(f"{name}={env!r}: expected a positive integer ({what})")
    return v


def choice(name: str, options: tuple, what: str) -> str | None:
    """None when ``name`` is unset (or empty), else its value, which must
    be one of ``options`` (a tuple of accepted strings): an enum knob
    selects a path, and a typo must fail loudly, not run the default."""
    env = os.environ.get(name)
    if not env:
        return None
    if env not in options:
        raise ValueError(f"{name}={env!r}: expected one of {', '.join(repr(o) for o in options)} ({what})")
    return env


def nonneg_float(name: str, what: str) -> float | None:
    """None when ``name`` is unset, else its value as a finite float >= 0."""
    env = os.environ.get(name)
    if not env:
        return None
    try:
        v = float(env)
    except ValueError:
        v = -1.0
    if not v >= 0 or v == float("inf"):
        raise ValueError(f"{name}={env!r}: expected a non-negative finite number ({what})")
    return v


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
