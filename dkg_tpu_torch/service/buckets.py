"""Shape-bucketing policy, a copy of ``dkg_tpu/service/buckets.py``:
requested ``(n, t)`` pad up to a small ladder of canonical shapes.

On the card no program is compiled per shape, but the ladder still fixes
what a ceremony computes: the Fiat-Shamir randomizers bind the padded
tensors, so the port must pad to the JAX package's buckets to derive the
JAX package's rho, and convoys of one bucket stack on one leading axis.

Policy:

* ``n`` rounds up to the next power of two, floored at
  :data:`MIN_BUCKET_N`;
* ``t`` rounds up to the smallest rung of ``n_pad/4``, ``n_pad/3``,
  ``(n_pad-1)/2``, a ``t`` beyond the last escalating to the next ``n``;
* convoy widths come from the ladder :data:`WIDTHS`; a ragged convoy is
  split greedily (k=7 -> 4+2+1), never padded with phantom ceremonies.

Padding is the engine's pad-and-mask contract
(``dkg.ceremony.CeremonyConfig.padded``): phantom dealers are
zero-coefficient polynomials whose shares are zero and whose commitments
are the identity, so a real lane's outputs equal the unpadded run's.
"""

from __future__ import annotations

import dataclasses

#: Smallest n bucket: ceremonies below this pad up to it.  Eight lanes
#: is already enough to keep the batched kernels' vector shapes sane.
MIN_BUCKET_N = 8

#: Largest n bucket the policy will emit.  Requests beyond this are the
#: north-star single-ceremony regime (sharded engine), not service
#: traffic.
MAX_BUCKET_N = 4096

#: Stacked-lane width ladder (descending).  Only these convoy widths
#: ever run; see :func:`split_widths`.
WIDTHS = (8, 4, 2, 1)

#: Stacking crossover: buckets at or above this ``n`` run width-1
#: convoys.  The JAX package's value, calibrated on a single-core CPU
#: (secp256k1, width 8: 1.65x at the (16,5) bucket, 1.27x at (32,8), a
#: 0.95x loss at (64,16)).  On the H100 a stacked convoy launches each
#: kernel once whatever its width; ``chip_smoke.py``'s S2 stage times
#: widths 1-8 at three buckets, and the cap stays the JAX package's
#: until a benchmark can judge a change (PERF.md).
WIDTH_CAP_N = 64


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One canonical padded shape.  Hashable — used as a convoy key
    together with the curve."""

    n: int
    t: int


def _next_pow2(v: int) -> int:
    return 1 << max(v - 1, 1).bit_length()


def t_rungs(n_pad: int) -> tuple[int, ...]:
    """The threshold rungs available at an ``n`` bucket, ascending."""
    return tuple(sorted({n_pad // 4, n_pad // 3, (n_pad - 1) // 2}))


def bucket_for(n: int, t: int) -> Bucket:
    """The canonical bucket dominating ``(n, t)``.

    Raises ValueError for shapes no bucket dominates (n out of range, or
    t >= n which no DKG admits).
    """
    if n < 2 or n > MAX_BUCKET_N:
        raise ValueError(f"bucket_for: n={n} outside [2, {MAX_BUCKET_N}]")
    if t < 1 or t >= n:
        raise ValueError(f"bucket_for: t={t} outside [1, n-1] for n={n}")
    n_pad = max(MIN_BUCKET_N, _next_pow2(n))
    while n_pad <= MAX_BUCKET_N:
        for rung in t_rungs(n_pad):
            if rung >= t:
                return Bucket(n_pad, rung)
        n_pad *= 2
    raise ValueError(f"bucket_for: no bucket dominates (n={n}, t={t})")


def width_cap(b: Bucket) -> int:
    """Largest convoy width worth stacking for ``b`` (a ladder value).

    The scheduler takes ``min(batch_max, width_cap(bucket))`` when it
    pops a convoy, so operators tune ``batch_max`` downward only —
    the cap already excludes the shapes where stacking is a measured
    loss (see :data:`WIDTH_CAP_N`).
    """
    return 1 if b.n >= WIDTH_CAP_N else WIDTHS[0]


#: Message-count rungs for the sign lane (descending): the batch shapes
#: the folded leg's ``scalar_mul`` runs at, the JAX package's ladder.  The
#: small rungs (2, 1) let a convoy of 2 run as [2], not [1, 1], and tail
#: slices of big convoys run at them instead of padding with phantom
#: messages (a phantom message costs a full ladder lane).
SIGN_RUNGS = (256, 64, 16, 4, 2, 1)


def sign_rung_slices(total: int, batch_max: int = SIGN_RUNGS[0]) -> list[tuple[int, int]]:
    """Greedy ``(start, stop)`` decomposition of ``total`` queued sign
    messages into :data:`SIGN_RUNGS` shapes, each at most ``batch_max``
    (total=21 -> [(0, 16), (16, 20), (20, 21)]).  The sign-lane analogue
    of :func:`split_widths`, over the message axis instead of the
    ceremony axis."""
    if total < 0:
        raise ValueError(f"sign_rung_slices: total={total} < 0")
    out: list[tuple[int, int]] = []
    at = 0
    for w in SIGN_RUNGS:
        if w > batch_max:
            continue
        while total - at >= w:
            out.append((at, at + w))
            at += w
    return out


def split_widths(k: int, batch_max: int = WIDTHS[0]) -> list[int]:
    """Greedy decomposition of a convoy of ``k`` ceremonies into ladder
    widths, each at most ``batch_max`` (k=7 -> [4, 2, 1]).  Splitting
    instead of padding: a phantom ceremony costs a full ceremony's
    compute, while one extra narrower convoy costs only its launches."""
    if k < 0:
        raise ValueError(f"split_widths: k={k} < 0")
    out: list[int] = []
    for w in WIDTHS:
        if w > batch_max:
            continue
        while k >= w:
            out.append(w)
            k -= w
    return out
