"""Fixed-base window tables for the generator g and the Pedersen base h.

Counterpart of ``dkg_tpu/groups/precompute.py`` (``host_table``,
``base_table``, ``generator_table``) and of the function they delegate to,
``dkg_tpu/groups/device.py`` ``_fixed_table_np``: the 8-bit comb
``T[w][d] = d·(2**8)^w·B``, every entry affine (Z = 1; Edwards entries
(x, y, 1, x·y), the Edwards identity (0, 1, 1, 0)) but the Weierstrass
identity, which stays ``(0, 1, 0)``.  Built on the host and
copied to the device, so the limbs equal the JAX package's host table.

Kept for the process (one build per base); the JAX package's
digest-checked disk cache is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import host as fh
from . import device as gd
from . import host as gh


def base_key(cs: gd.CurveSpec, point) -> tuple:
    """Hashable key for a host point: its affine (x, y), or ("identity",)
    for the Weierstrass identity."""
    if cs.kind == "edwards":
        pm = cs.field.modulus
        x, y, z, _ = point
        zi = pow(z, pm - 2, pm)
        return (x * zi % pm, y * zi % pm)
    aff = gh.ALL_GROUPS[cs.name].to_affine(point)
    return aff if aff is not None else ("identity",)


def base_key_to_point(cs: gd.CurveSpec, key: tuple):
    """The host point of a :func:`base_key`."""
    if key == ("identity",):
        return gh.ALL_GROUPS[cs.name].identity()
    x, y = key
    if cs.kind == "edwards":
        return (x, y, 1, x * y % cs.field.modulus)
    return (x, y, 1)


@functools.lru_cache(maxsize=8)
def host_table(cs: gd.CurveSpec, key: tuple, window: int = gd.FIXED_WINDOW) -> np.ndarray:
    """(NW, 2**window, C, L) uint32 table for the base ``key``
    (:func:`base_key`)."""
    group = gh.ALL_GROUPS[cs.name]
    window_base = base_key_to_point(cs, key)
    nw, entries = gd.n_windows(cs, window), 1 << window
    pts = []
    for _ in range(nw):
        acc = group.identity()
        for _ in range(entries):
            pts.append(acc)
            acc = group.add(acc, window_base)
        for _ in range(window):
            window_base = group.add(window_base, window_base)
    proj = fh.encode(cs.field, np.asarray(pts, dtype=object))  # (nw * entries, C, L)
    return gd.affine_canon_host(cs, proj).reshape(nw, entries, cs.ncoords, cs.field.limbs)


def base_table(cs: gd.CurveSpec, base, *, device) -> torch.Tensor:
    """The window table of a fixed host point ``base`` on ``device``."""
    return fh.to_tensor(host_table(cs, base_key(cs, base)), device)


def generator_table(cs: gd.CurveSpec, *, device) -> torch.Tensor:
    """:func:`base_table` for the curve generator g."""
    return base_table(cs, base_key_to_point(cs, cs.gen_affine), device=device)
