"""Rolling SLO evaluation over the process-wide metrics registry, a copy
of ``dkg_tpu/service/slo.py``.

The scheduler's histograms (``service_ceremony_seconds``,
``sign_seconds``) and terminal-status counters
(``service_completed_total{status=...}``) carry everything an SLO needs:

* :func:`evaluate`: from one registry snapshot (or the windowed delta of
  two) to a report of p50/p99 ceremony and sign latency
  (bucket-interpolated quantiles), error-budget burn over the terminal
  statuses, and per-objective ``ok`` verdicts;
* :class:`SloEvaluator`: the rolling form over timestamped snapshots,
  behind the scheduler's ``/slo`` endpoint (:mod:`.httpobs`).

Burn is ``(completed - done) / completed / budget``: 1.0 means the window
spent exactly its budget.  Knobs (constructor arguments win):
``DKG_TPU_SLO_WINDOW_S`` (default 300), ``DKG_TPU_SLO_CEREMONY_P99_S`` /
``DKG_TPU_SLO_SIGN_P99_S`` (unset: reported, not judged),
``DKG_TPU_SLO_ERROR_BUDGET`` (default 0.01).
"""

from __future__ import annotations

import re
import time
from collections import deque
from dataclasses import dataclass

from ..utils import envknobs
from ..utils.metrics import REGISTRY

#: Default rolling window (seconds) and error budget (failure ratio).
DEFAULT_WINDOW_S = 300.0
DEFAULT_ERROR_BUDGET = 0.01

#: How many timestamped snapshots the rolling evaluator retains; at the
#: scheduler's scrape cadence this comfortably covers the window.
_MAX_TICKS = 256

_SERIES_RE = re.compile(r'^(?P<name>[^{]+)(\{(?P<labels>.*)\})?$')
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_series(series: str) -> tuple[str, dict[str, str]]:
    """``'name{k="v"}'`` -> ``("name", {"k": "v"})`` (the rendered-key
    form snapshot() exports)."""
    m = _SERIES_RE.match(series)
    if m is None:
        return series, {}
    labels = {
        k: v.replace('\\"', '"').replace("\\\\", "\\").replace("\\n", "\n")
        for k, v in _LABEL_RE.findall(m.group("labels") or "")
    }
    return m.group("name"), labels


@dataclass
class SloPolicy:
    """The objectives one evaluation judges against.  ``None`` latency
    targets report the quantile without judging it."""

    window_s: float = DEFAULT_WINDOW_S
    ceremony_p99_s: float | None = None
    sign_p99_s: float | None = None
    error_budget: float = DEFAULT_ERROR_BUDGET

    @classmethod
    def from_env(cls) -> "SloPolicy":
        window = envknobs.pos_float(
            "DKG_TPU_SLO_WINDOW_S", "rolling SLO evaluation window"
        )
        budget = envknobs.nonneg_float(
            "DKG_TPU_SLO_ERROR_BUDGET",
            "allowed failure ratio per window (0 = zero tolerance)",
        )
        return cls(
            window_s=DEFAULT_WINDOW_S if window is None else window,
            ceremony_p99_s=envknobs.pos_float(
                "DKG_TPU_SLO_CEREMONY_P99_S", "ceremony p99 latency objective"
            ),
            sign_p99_s=envknobs.pos_float(
                "DKG_TPU_SLO_SIGN_P99_S", "sign p99 latency objective"
            ),
            error_budget=DEFAULT_ERROR_BUDGET if budget is None else budget,
        )


# -- histogram algebra --------------------------------------------------------


def merge_histograms(snapshot: dict, name: str) -> dict | None:
    """Sum every histogram series of base ``name`` (any labels) into one
    ``{"buckets": {le: cum}, "sum": s, "count": c}``; None when absent.
    Buckets are cumulative Prometheus ``le`` counts, merged by key —
    sound because each metric name pins one bucket layout (metrics.py
    fixes layouts at first observation)."""
    merged_buckets: dict[str, int] = {}
    total = 0.0
    count = 0
    found = False
    for series, h in (snapshot.get("histograms") or {}).items():
        base, _labels = parse_series(series)
        if base != name or not isinstance(h, dict):
            continue
        found = True
        for le, c in (h.get("buckets") or {}).items():
            merged_buckets[le] = merged_buckets.get(le, 0) + int(c)
        total += float(h.get("sum", 0.0))
        count += int(h.get("count", 0))
    if not found:
        return None
    return {"buckets": merged_buckets, "sum": total, "count": count}


def quantile(hist: dict, q: float) -> float | None:
    """Bucket-interpolated quantile of a merged cumulative histogram.

    Rank ``q * count`` lands in the first bucket whose cumulative count
    reaches it; the value interpolates linearly between the bucket's
    bounds (lower bound = previous finite ``le``, 0 for the first).  A
    rank landing in the ``+Inf`` bucket returns the largest finite bound
    — the honest answer a fixed-layout histogram can give.  None for an
    empty histogram.
    """
    count = int(hist.get("count", 0))
    if count <= 0:
        return None
    items = sorted(
        ((le, int(c)) for le, c in hist["buckets"].items() if le != "+Inf"),
        key=lambda kv: float(kv[0]),
    )
    target = q * count
    lo = 0.0
    prev_cum = 0
    for le, cum in items:
        hi = float(le)
        if cum >= target and cum > prev_cum:
            frac = (target - prev_cum) / (cum - prev_cum)
            return lo + (hi - lo) * max(0.0, min(1.0, frac))
        lo, prev_cum = hi, cum
    # rank beyond every finite bucket: the +Inf overflow
    return items[-1] and float(items[-1][0]) if items else None


def delta_snapshot(new: dict, old: dict) -> dict:
    """``new - old`` over cumulative series (counters and histogram
    buckets/sums/counts; gauges keep their newest value).  Series absent
    from ``old`` count from zero; negative deltas clamp to zero (a
    registry reset between snapshots must not produce negative rates)."""
    counters = {}
    for series, v in (new.get("counters") or {}).items():
        counters[series] = max(
            0.0, float(v) - float((old.get("counters") or {}).get(series, 0.0))
        )
    hists = {}
    for series, h in (new.get("histograms") or {}).items():
        oh = (old.get("histograms") or {}).get(series) or {}
        old_buckets = oh.get("buckets") or {}
        hists[series] = {
            "buckets": {
                le: max(0, int(c) - int(old_buckets.get(le, 0)))
                for le, c in (h.get("buckets") or {}).items()
            },
            "sum": max(0.0, float(h.get("sum", 0.0)) - float(oh.get("sum", 0.0))),
            "count": max(0, int(h.get("count", 0)) - int(oh.get("count", 0))),
        }
    return {
        "counters": counters,
        "gauges": dict(new.get("gauges") or {}),
        "histograms": hists,
    }


# -- evaluation ---------------------------------------------------------------


def _latency_leg(
    snapshot: dict, name: str, target_p99_s: float | None
) -> dict | None:
    merged = merge_histograms(snapshot, name)
    if merged is None or merged["count"] <= 0:
        return None
    leg = {
        "count": merged["count"],
        "mean_s": round(merged["sum"] / merged["count"], 6),
        "p50_s": round(quantile(merged, 0.50), 6),
        "p99_s": round(quantile(merged, 0.99), 6),
        "target_p99_s": target_p99_s,
    }
    leg["ok"] = target_p99_s is None or leg["p99_s"] <= target_p99_s
    return leg


def evaluate(
    snapshot: dict,
    policy: SloPolicy | None = None,
    window_s: float | None = None,
) -> dict:
    """Judge one snapshot (cumulative or windowed delta) against a
    policy.  Always returns a report; objectives whose series are absent
    are reported ``null`` and do not fail the evaluation (a freshly
    started server has no traffic to violate an SLO with)."""
    pol = policy if policy is not None else SloPolicy()
    report: dict = {
        "window_s": window_s if window_s is not None else pol.window_s,
        "ceremony": _latency_leg(
            snapshot, "service_ceremony_seconds", pol.ceremony_p99_s
        ),
        "sign": _latency_leg(snapshot, "sign_seconds", pol.sign_p99_s),
    }
    completed = 0.0
    failed = 0.0
    by_status: dict[str, float] = {}
    for series, v in (snapshot.get("counters") or {}).items():
        base, labels = parse_series(series)
        if base != "service_completed_total":
            continue
        status = labels.get("status", "unknown")
        by_status[status] = by_status.get(status, 0.0) + float(v)
        completed += float(v)
        if status != "done":
            failed += float(v)
    ratio = failed / completed if completed > 0 else 0.0
    if pol.error_budget > 0:
        burn = ratio / pol.error_budget
    else:
        burn = 0.0 if failed == 0 else float("inf")
    errors = {
        "completed": completed,
        "failed": failed,
        "by_status": by_status,
        "ratio": round(ratio, 6),
        "budget": pol.error_budget,
        "burn": round(burn, 4) if burn != float("inf") else "inf",
        "ok": ratio <= pol.error_budget,
    }
    report["errors"] = errors
    violations = []
    for leg_name in ("ceremony", "sign"):
        leg = report[leg_name]
        if leg is not None and not leg["ok"]:
            violations.append(
                f"{leg_name}_p99 {leg['p99_s']}s > target "
                f"{leg['target_p99_s']}s"
            )
    if not errors["ok"]:
        violations.append(
            f"error ratio {errors['ratio']} > budget {pol.error_budget}"
        )
    report["violations"] = violations
    report["ok"] = not violations
    return report


class SloEvaluator:
    """Rolling windowed evaluation over a live registry.

    :meth:`tick` snapshots the registry with a timestamp; :meth:`report`
    ticks, then evaluates ``newest - oldest_within_window``.  With one
    tick (fresh process) the cumulative snapshot is evaluated over its
    actual age — better a short-window judgment than none.  Thread-safe
    through the GIL-atomic deque append; callers (the scheduler, the
    HTTP thread) may tick/report concurrently.
    """

    def __init__(
        self,
        registry=None,
        policy: SloPolicy | None = None,
        clock=time.monotonic,
    ) -> None:
        self.registry = registry if registry is not None else REGISTRY
        self.policy = policy if policy is not None else SloPolicy.from_env()
        self._clock = clock
        self._ticks: deque[tuple[float, dict]] = deque(maxlen=_MAX_TICKS)

    def tick(self) -> None:
        """Record one timestamped snapshot (call at scrape/phase
        cadence; report() also ticks)."""
        self._ticks.append((self._clock(), self.registry.snapshot()))

    def report(self) -> dict:
        self.tick()
        ticks = list(self._ticks)
        now, head = ticks[-1]
        base_t, base = None, None
        for t, snap in ticks[:-1]:
            if now - t <= self.policy.window_s:
                base_t, base = t, snap
                break
        if base is None:
            # no in-window predecessor: judge the cumulative snapshot
            # over its true age (bounded below to dodge divide-by-zero
            # style degeneracy in consumers computing rates)
            age = now - ticks[0][0] if len(ticks) > 1 else self.policy.window_s
            return evaluate(head, self.policy, window_s=max(age, 1e-9))
        return evaluate(
            delta_snapshot(head, base), self.policy, window_s=now - base_t
        )
