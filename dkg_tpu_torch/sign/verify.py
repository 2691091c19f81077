"""Random-linear-combination verification of a partial grid, with
bisecting blame.

Counterpart of ``dkg_tpu/sign/verify.py``.  Each DLEQ cell i claims,
with the announcements (A1_i, A2_i) carried from proving time,

    z_i·g − e_i·pk_i − A1_i = 0,    z_i·H_i − e_i·sig_i − A2_i = 0.

With fresh random weights (u_i, v_i) a check, the combined sum

    (Σ u_i·z_i)·g + Σ [−u_i·e_i·pk_i − u_i·A1_i + v_i·z_i·H_i − v_i·e_i·sig_i − v_i·A2_i]

is the identity iff every cell holds, but with probability about k/q
(Schwartz–Zippel; the weights must be unpredictable to the signers), so
a k-cell check is one (5k + 1)-point MSM.

Two stages come before any MSM: a hash screen recomputes each cell's
challenge from its carried announcements (e binds everything but z, so
a forged signature, key or announcement is blamed at hash cost), then
one accept-all check over the survivors.  On failure, a binary search
checks the left half of the failing range, removes the cell found,
and checks the rest again: at most ceil(log2 k) + 1 passes a bad cell.

``dispatch``: ``"device"`` (the default) runs each check's MSM as one
``groups.device.msm`` on the device ``ps.sigs`` lie on; ``"host"`` folds
it with big ints, an oracle a caller asks for (a 27,361-point host MSM
of Python ints takes about a minute).
"""

from __future__ import annotations

import dataclasses
import random

from ..crypto.dleq import _challenge
from ..fields import host as fh
from ..groups import device as gd
from ..groups import host as gh
from .partial import PartialSignatures

DISPATCHES = ("device", "host")


def _rlc_dispatch(dispatch: str) -> str:
    if dispatch not in DISPATCHES:
        raise ValueError(f"rlc dispatch must be host|device, got {dispatch!r}")
    return dispatch


@dataclasses.dataclass(frozen=True)
class RlcReport:
    """One :func:`rlc_verify` outcome.

    ``bad_cells``: the (message, signer) positions that failed, sorted;
    ``passes``: group-level checks made (1 for an honest grid; the hash
    screen costs none); ``grid``: the cells."""

    ok: bool
    bad_cells: tuple[tuple[int, int], ...]
    passes: int
    grid: int

    def pass_bound(self) -> int:
        """1 accept-all pass plus ceil(log2(grid)) + 1 a bad cell."""
        logk = max(1, self.grid - 1).bit_length()
        return 1 + len(self.bad_cells) * (logk + 1)


def _cell_rows(ps: PartialSignatures) -> list[tuple]:
    """Each cell's (e, z, h, pk, sig, a1, a2, g), host tuples, row-major."""
    g = gh.ALL_GROUPS[ps.curve].generator()
    b, m = ps.sigs.shape[:2]
    sigs_host = ps.sigs_host()
    rows = []
    for bi in range(b):
        for si in range(m):
            p = ps.proofs[bi * m + si]
            a1, a2 = ps.announcements[bi * m + si]
            rows.append((p.challenge, p.response, ps.h_points[bi], ps.pks[si], sigs_host[bi][si], a1, a2, g))
    return rows


def _combine(group, rows: list[tuple], rng) -> tuple[list, list]:
    """The combined check's (scalars, points), the g terms in one."""
    q = group.scalar_field.modulus
    g = rows[0][7]
    g_acc = 0
    scalars: list[int] = []
    points: list = []
    for e, z, h, pk, sig, a1, a2, _ in rows:
        u = rng.randrange(1, q)
        v = rng.randrange(1, q)
        g_acc = (g_acc + u * z) % q
        scalars.extend([(q - u * e % q) % q, q - u, v * z % q, (q - v * e % q) % q, q - v])
        points.extend([pk, a1, h, sig, a2])
    scalars.append(g_acc)
    points.append(g)
    return scalars, points


def _rlc_check(group, cs, rows: list[tuple], rng, dispatch: str, device) -> bool:
    """One combined check over ``rows``: True iff the sum is the identity."""
    scalars, points = _combine(group, rows, rng)
    if dispatch == "host":
        return group.is_identity(group.msm(scalars, points))
    pts = gd.from_host(cs, points, device=device)  # (5k + 1, C, L)
    sc = fh.to_tensor(fh.encode(cs.scalar, scalars), device)
    (acc,) = gd.to_host(cs, gd.msm(cs, sc, pts)[None])
    return group.is_identity(acc)


def _screened(group, rows: list[tuple]):
    """The hash screen, lazily: whether each cell's challenge is the one
    its transcript hashes to."""
    return (e == _challenge(group, g, h, pk, sig, a1, a2) for e, _z, h, pk, sig, a1, a2, g in rows)


@dataclasses.dataclass(frozen=True)
class ConvoyReport:
    """One :func:`rlc_verify_convoy` outcome.

    ``grid_ok[i]``: grid i's every cell passed the hash screen and the one
    combined check over all surviving grids held.  A failed combined check
    marks every surviving grid False (an acceptance gate, not blame: the
    caller sends those grids through :func:`rlc_verify`).  ``passes``: 1
    if any grid survived the screen, else 0; ``cells``: all cells."""

    ok: bool
    grid_ok: tuple[bool, ...]
    passes: int
    cells: int


def rlc_verify_convoy(batch: list[PartialSignatures], *, rng=None, dispatch: str = "device") -> ConvoyReport:
    """Accept a convoy of proved grids (one curve, one device) with one
    hash screen and one combined check over every surviving cell.  ``rng``
    draws the weights (default ``random.SystemRandom``)."""
    if not batch:
        return ConvoyReport(ok=True, grid_ok=(), passes=0, cells=0)
    curves = {ps.curve for ps in batch}
    if len(curves) > 1:
        raise ValueError(f"convoy spans curves {sorted(curves)}; expected one")
    for ps in batch:
        if ps.proofs is None or ps.announcements is None:
            raise ValueError("rlc_verify_convoy needs proofs and announcements (partial_sign(..., prove=True))")
    group, cs = gh.ALL_GROUPS[batch[0].curve], gd.ALL_CURVES[batch[0].curve]
    mode = _rlc_dispatch(dispatch)
    rng = random.SystemRandom() if rng is None else rng
    grid_ok = [True] * len(batch)
    survivors: list[tuple] = []
    cells = 0
    for gi, ps in enumerate(batch):
        rows = _cell_rows(ps)
        cells += len(rows)
        if all(_screened(group, rows)):
            survivors.extend(rows)
        else:
            grid_ok[gi] = False
    passes = 0
    if survivors:
        passes = 1
        if not _rlc_check(group, cs, survivors, rng, mode, batch[0].sigs.device):
            grid_ok = [False] * len(batch)
    return ConvoyReport(ok=all(grid_ok), grid_ok=tuple(grid_ok), passes=passes, cells=cells)


def rlc_verify(ps: PartialSignatures, *, rng=None, dispatch: str = "device") -> RlcReport:
    """Accept-all-or-blame verification of a proved partial grid, on the
    device ``ps.sigs`` lie on.  ``rng`` draws the weights (default
    ``random.SystemRandom``; seed it only in tests and benchmarks)."""
    if ps.proofs is None or ps.announcements is None:
        raise ValueError("rlc_verify needs proofs and announcements (partial_sign(..., prove=True))")
    group, cs = gh.ALL_GROUPS[ps.curve], gd.ALL_CURVES[ps.curve]
    mode = _rlc_dispatch(dispatch)
    rng = random.SystemRandom() if rng is None else rng
    b, m = ps.sigs.shape[:2]
    rows = _cell_rows(ps)
    cells = [(bi, si) for bi in range(b) for si in range(m)]
    live: list[int] = []
    bad: list[tuple[int, int]] = []
    for i, clean in enumerate(_screened(group, rows)):
        if clean:
            live.append(i)
        else:
            bad.append(cells[i])
    passes = 0
    while live:
        passes += 1
        if _rlc_check(group, cs, [rows[i] for i in live], rng, mode, ps.sigs.device):
            break
        lo, hi = 0, len(live)  # live[lo:hi] holds a bad cell
        while hi - lo > 1:
            mid = (lo + hi) // 2
            passes += 1
            if _rlc_check(group, cs, [rows[i] for i in live[lo:mid]], rng, mode, ps.sigs.device):
                lo = mid  # the left half is clean: the culprit is on the right
            else:
                hi = mid
        bad.append(cells[live[lo]])
        del live[lo]
    return RlcReport(ok=not bad, bad_cells=tuple(sorted(bad)), passes=passes, grid=b * m)
