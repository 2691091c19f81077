"""Process-wide metrics registry: counters, gauges and fixed-bucket
histograms.

A copy of the registry of ``dkg_tpu/utils/metrics.py``
(:class:`MetricsRegistry` and the process-wide :data:`REGISTRY`).  The
port's epoch manager writes ``epoch_ops_total`` (by kind and status),
``epoch_op_seconds`` and ``epoch_quarantined_total`` into it, and the
ceremony service its ``service_*`` and ``sign_*`` series under the JAX
package's names (the queue depths as gauges).  Exports:
:meth:`MetricsRegistry.snapshot` (one JSON-able dict) and
:meth:`MetricsRegistry.prometheus_text` (the text exposition format).
All operations are thread-safe; labels are plain keyword strings and
series are keyed by the rendered ``name{k="v"}`` form.
"""

from __future__ import annotations

import bisect
import threading

# Latency buckets (seconds): spans ~1 ms RPCs to ~minute-long phases.
# Fixed so concurrent ceremonies and successive processes aggregate —
# a histogram with drifting buckets cannot be merged or compared.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _labelitems(labels: dict) -> tuple:
    return tuple(
        sorted((str(k), str(v)) for k, v in labels.items() if v is not None)
    )


def _escape(value: str) -> str:
    """Prometheus label-value escaping (backslash, double quote, newline)
    — a ceremony_id or error-kind label must never be able to break the
    exposition format, whatever bytes it carries."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _series(name: str, labelitems: tuple) -> str:
    if not labelitems:
        return name
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labelitems)
    return f"{name}{{{inner}}}"


def _fmt(v: float) -> str:
    """Prometheus-style number: integers without a trailing ``.0``."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


class MetricsRegistry:
    """Thread-safe counter/gauge/histogram store with text + JSON export."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (name, labelitems) -> float
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        # (name, labelitems) -> [buckets, per-bucket counts (+overflow), sum, count]
        self._hists: dict[tuple[str, tuple], list] = {}

    # -- writes -------------------------------------------------------------

    def inc(self, name: str, by: float = 1, **labels) -> None:
        key = (name, _labelitems(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _labelitems(labels))
        with self._lock:
            self._gauges[key] = value

    def observe(
        self, name: str, value: float, buckets: tuple = DEFAULT_BUCKETS, **labels
    ) -> None:
        """Record ``value`` into the fixed-bucket histogram ``name``.
        The bucket layout is pinned at a series' first observation."""
        key = (name, _labelitems(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = [tuple(buckets), [0] * (len(buckets) + 1), 0.0, 0]
                self._hists[key] = h
            h[1][bisect.bisect_left(h[0], value)] += 1
            h[2] += value
            h[3] += 1

    def reset(self) -> None:
        """Drop every series (tests and per-run isolation)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- exports ------------------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-able dict of every series.  Histogram buckets are
        cumulative (Prometheus ``le`` semantics) so the snapshot and the
        text exposition describe the identical distribution."""
        with self._lock:
            counters = {_series(n, li): v for (n, li), v in self._counters.items()}
            gauges = {_series(n, li): v for (n, li), v in self._gauges.items()}
            hists = {}
            for (n, li), (buckets, counts, total, count) in self._hists.items():
                cum, acc = {}, 0
                for le, c in zip(buckets, counts):
                    acc += c
                    cum[_fmt(float(le))] = acc
                cum["+Inf"] = acc + counts[-1]
                hists[_series(n, li)] = {
                    "buckets": cum,
                    "sum": total,
                    "count": count,
                }
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def prometheus_text(self) -> str:
        """Prometheus text exposition (``# TYPE`` headers, cumulative
        ``_bucket{le=...}`` series, ``_sum``/``_count``)."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            # deep-copy histogram state INSIDE the lock: the dict values
            # are the live mutable [buckets, counts, sum, count] lists
            # observe() mutates, so reading them field-by-field after
            # release can render a bucket row from one observation and
            # the sum/count from another (the +Inf bucket would disagree
            # with _count in the same exposition)
            hists = [
                ((name, li), (buckets, list(counts), total, count))
                for (name, li), (buckets, counts, total, count)
                in sorted(self._hists.items())
            ]
        lines: list[str] = []
        seen: set[str] = set()
        for (name, li), v in counters:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} counter")
            lines.append(f"{_series(name, li)} {_fmt(float(v))}")
        for (name, li), v in gauges:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{_series(name, li)} {_fmt(float(v))}")
        for (name, li), (buckets, counts, total, count) in hists:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} histogram")
            acc = 0
            for le, c in zip(buckets, counts):
                acc += c
                lines.append(
                    f"{_series(name + '_bucket', li + (('le', _fmt(float(le))),))} {acc}"
                )
            lines.append(
                f"{_series(name + '_bucket', li + (('le', '+Inf'),))} {acc + counts[-1]}"
            )
            lines.append(f"{_series(name + '_sum', li)} {_fmt(total)}")
            lines.append(f"{_series(name + '_count', li)} {count}")
        return "\n".join(lines) + "\n"


#: The process-wide registry every instrumentation site writes to.
REGISTRY = MetricsRegistry()
