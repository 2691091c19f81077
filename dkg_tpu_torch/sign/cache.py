"""Warm-path signing caches: every quorum-stable derivation, done once.

Counterpart of ``dkg_tpu/sign/cache.py``.  None of this depends on the
message signed, only on the ceremony's share epoch and the quorum's
x-coordinates, so a serving lane derives it once:

* **ceremony material**: the decoded share vector, keyed (ceremony id,
  epoch); inserting a new epoch drops the ceremony's stale entries;
* **Lagrange-at-zero coefficients**, keyed (curve, quorum x's): host big
  ints (a t + 1 point interpolation is microseconds on the host), encoded
  to the limbs ``poly.device.lagrange_at_zero_coeffs`` gives;
* **the folded signing scalar** sigma = Σ λ_i(0)·s_i mod q, keyed by the
  ceremony entry: it is f(0) for every honest quorum, so
  ``partial.sign_folded`` signs a message with one ``scalar_mul`` lane
  instead of a (t + 1)-wide grid and an MSM;
* per-quorum public keys (``partial.public_keys``, on the card), inside
  each ceremony entry.

One lock guards the maps; the derivations run outside it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..fields import host as fh
from ..groups import host as gh
from ..poly import host as ph
from .partial import public_keys


def sigma_limb_count(curve: str) -> int:
    """Limbs of one folded-sigma row, the last axis of the (B, L) rows
    :meth:`SignCache.fold_limbs` feeds ``sign_folded``."""
    return gh.ALL_GROUPS[curve].scalar_field.limbs


class CeremonyMaterial:
    """Everything quorum-stable about one (ceremony, epoch): the decoded
    share vector, per-quorum public keys and the folded signing scalar."""

    __slots__ = ("cid", "epoch", "curve", "shares", "_pks", "_fold", "_lock")

    def __init__(self, cid: str, epoch: int, curve: str, shares: tuple[int, ...]):
        self.cid = cid
        self.epoch = epoch
        self.curve = curve
        self.shares = shares  # the n-vector: index i holds the share at x = i + 1
        self._pks: OrderedDict[tuple[int, ...], tuple[torch.Tensor, list]] = OrderedDict()
        self._fold: np.ndarray | None = None  # (L,) canonical sigma limbs
        self._lock = threading.Lock()


class SignCache:
    """LRU caches of a sign lane (module docstring)."""

    def __init__(self, capacity: int = 32, lagrange_capacity: int = 256, pk_capacity: int = 64) -> None:
        self.capacity = capacity
        self.lagrange_capacity = lagrange_capacity
        self.pk_capacity = pk_capacity
        self._lock = threading.Lock()
        self._ceremonies: OrderedDict[tuple[str, int], CeremonyMaterial] = OrderedDict()
        # (curve, xs) -> (lambda ints, (M, L) canonical limbs)
        self._lagrange: OrderedDict[tuple, tuple[tuple[int, ...], np.ndarray]] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def ceremony(self, cid: str, epoch: int, curve: str, final_shares) -> CeremonyMaterial:
        """The decoded material of (cid, epoch); ``final_shares`` are the
        ceremony's (n, L) share limbs (a tensor or a numpy array)."""
        key = (cid, epoch)
        with self._lock:
            mat = self._ceremonies.get(key)
            if mat is not None:
                self._ceremonies.move_to_end(key)
                self.hits += 1
                return mat
            self.misses += 1
        if isinstance(final_shares, torch.Tensor):
            final_shares = fh.from_tensor(final_shares)
        fs = gh.ALL_GROUPS[curve].scalar_field
        mat = CeremonyMaterial(cid, epoch, curve, tuple(int(v) for v in fh.decode(fs, final_shares)))
        with self._lock:
            won = self._ceremonies.setdefault(key, mat)
            if won is mat:
                for k in [k for k in self._ceremonies if k[0] == cid and k != key]:
                    del self._ceremonies[k]  # stale epochs of this ceremony
                while len(self._ceremonies) > self.capacity:
                    self._ceremonies.popitem(last=False)
            return won

    def lagrange_at_zero(self, curve: str, xs: tuple[int, ...]) -> tuple[tuple[int, ...], np.ndarray]:
        """(λ ints, canonical (M, L) uint32 limbs) for interpolation at
        zero over nodes ``xs``, host big ints, cached per (curve, xs)."""
        key = (curve, xs)
        with self._lock:
            hit = self._lagrange.get(key)
            if hit is not None:
                self._lagrange.move_to_end(key)
                self.hits += 1
                return hit
            self.misses += 1
        fs = gh.ALL_GROUPS[curve].scalar_field
        nodes = [x % fs.modulus for x in xs]
        lams = tuple(ph.lagrange_coefficient(fs, 0, i, nodes) for i in range(len(nodes)))
        entry = (lams, fh.encode(fs, list(lams)))
        with self._lock:
            self._lagrange[key] = entry
            while len(self._lagrange) > self.lagrange_capacity:
                self._lagrange.popitem(last=False)
        return entry

    def fold_limbs(self, mat: CeremonyMaterial, quorum: list[int]) -> np.ndarray:
        """Canonical (L,) limbs of sigma = Σ λ_i(0)·s_i over ``quorum``
        (1-based indices into the share vector), once per entry: sigma is
        f(0) for every honest quorum, so the first quorum's serves all."""
        with mat._lock:
            if mat._fold is not None:
                return mat._fold
        fs = gh.ALL_GROUPS[mat.curve].scalar_field
        lams, _ = self.lagrange_at_zero(mat.curve, tuple(quorum))
        sigma = 0
        for lam, x in zip(lams, quorum):
            sigma = (sigma + lam * mat.shares[x - 1]) % fs.modulus
        limbs = fh.encode(fs, [sigma])[0]
        with mat._lock:
            if mat._fold is None:
                mat._fold = limbs
            return mat._fold

    def quorum_pks(self, mat: CeremonyMaterial, quorum: list[int], *, device="cuda") -> tuple[torch.Tensor, list]:
        """(canonical (m, C, L) limbs on ``device``, host tuples) of the
        quorum's public keys, cached per quorum inside the ceremony entry."""
        key = tuple(quorum)
        with mat._lock:
            hit = mat._pks.get(key)
            if hit is not None:
                mat._pks.move_to_end(key)
                return hit
        pks = public_keys(mat.curve, [mat.shares[x - 1] for x in quorum], device=device)
        with mat._lock:
            mat._pks[key] = pks
            while len(mat._pks) > self.pk_capacity:
                mat._pks.popitem(last=False)
        return pks
