"""Ceremony observability: timings by phase, and counters.

The part of ``dkg_tpu/utils/tracing.py`` the batched wire protocol uses:
:class:`CeremonyTrace`, a copy (structured timings by phase and
sub-phase, protocol counters, one JSON-able dict), and
:func:`phase_span`, which times one phase on the host clock and names it
in a ``torch.profiler`` trace with ``record_function`` (``dkg/<phase>``),
where the JAX package annotates its device profile.  A span ends when
its block does: a caller who wants the card's work inside it
synchronises before the block ends.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import torch


@dataclass
class CeremonyTrace:
    """The mutable trace of one ceremony run."""

    timings_s: dict = field(default_factory=dict)  # phase -> seconds
    counters: dict = field(default_factory=dict)  # name -> int
    meta: dict = field(default_factory=dict)
    # phase -> {sub -> seconds}: finer than timings_s and kept out of it,
    # so rates() and total_s never count a phase twice
    subtimings_s: dict = field(default_factory=dict)

    def bump(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    def record(self, phase: str, seconds: float) -> None:
        self.timings_s[phase] = self.timings_s.get(phase, 0.0) + seconds

    def record_sub(self, phase: str, sub: str, seconds: float) -> None:
        """Add a sub-timing under ``phase``."""
        subs = self.subtimings_s.setdefault(phase, {})
        subs[sub] = subs.get(sub, 0.0) + seconds

    @property
    def total_s(self) -> float:
        return sum(self.timings_s.values())

    def rates(self, units: float) -> dict:
        """units a second for every recorded phase (phases of no duration
        left out)."""
        return {ph: units / s for ph, s in self.timings_s.items() if s > 0}

    def as_dict(self) -> dict:
        out = {
            "timings_s": dict(self.timings_s),
            "subtimings_s": {k: dict(v) for k, v in self.subtimings_s.items()},
            "total_s": self.total_s,
            "counters": dict(self.counters),
            "meta": dict(self.meta),
        }
        units = self.meta.get("units")
        if isinstance(units, (int, float)) and not isinstance(units, bool) and units > 0:
            out["rates_per_s"] = self.rates(units)
        wire = self.wire_summary()
        if wire is not None:
            out["wire"] = wire
        return out

    def wire_summary(self) -> dict | None:
        """Wire totals from the ``net.wire_bytes_out`` / ``_in`` counters,
        or None when the trace saw no transport; ``bytes_per_pair`` over
        the n (n - 1) dealer-recipient pairs (meta ``n``)."""
        out_b = self.counters.get("net.wire_bytes_out")
        in_b = self.counters.get("net.wire_bytes_in")
        if out_b is None and in_b is None:
            return None
        wire: dict = {
            "wire_bytes_out": int(out_b or 0),
            "wire_bytes_in": int(in_b or 0),
            "wire_bytes": int(out_b or 0) + int(in_b or 0),
        }
        n = self.meta.get("n")
        if isinstance(n, int) and n > 1:
            wire["bytes_per_pair"] = (out_b or 0) / (n * (n - 1))
        return wire

    def json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True)


@contextlib.contextmanager
def phase_span(trace: CeremonyTrace | None, phase: str):
    """Time a phase on the host clock into ``trace`` (if given), named
    ``dkg/<phase>`` in a ``torch.profiler`` trace."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"dkg/{phase}"):
        yield
    if trace is not None:
        trace.record(phase, time.perf_counter() - t0)
