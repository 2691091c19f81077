"""The steady sign lane's folded sigma·H(m) ladder mapped over the local
devices.

Counterpart of ``dkg_tpu/parallel/signmesh.py``.  The scheduler's fast leg
signs every unproved ticket's messages with one folded ``scalar_mul`` a
rung (``sign.partial.sign_folded``); the ladder is batch-elementwise, so
a rung splits over devices with no collective: a pure map.  Here the
mesh is a tuple of local devices of one process.  ``DKG_TPU_SIGN_MESH``
(``0`` / ``1``, through ``utils.envknobs.choice``: a typo raises)
engages it; under two CUDA devices it stays off whatever the knob says,
which is always so on a one-GPU machine.  The JAX package's third value,
``force``, engages its CPU meshes, which the port does not have.
Whether the map pays on a multi-GPU machine is not measured yet: the
folded ladder is depth-bound, so it wins only where the devices run
their slices at once.

Bit-exactness: splitting the batch changes only the device a row runs
on, so the mapped rung is limb-identical to the one-device rung.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import host as fh
from ..sign import partial
from ..utils import envknobs


def _devices() -> tuple:
    """The visible CUDA devices, in index order."""
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return tuple(torch.device("cuda", i) for i in range(n_dev))


def sign_mesh() -> tuple | None:
    """The sign lane's devices, or None when the lane stays on one device:
    the knob unset or ``0``, or fewer than two CUDA devices.  Cheap
    enough to resolve per convoy."""
    if envknobs.choice("DKG_TPU_SIGN_MESH", ("0", "1"), "device-mapped folded sign ladder") != "1":
        return None
    devices = _devices()
    return devices if len(devices) >= 2 else None


def sign_folded_sharded(curve: str, sigma_limbs, h_dev: torch.Tensor, mesh: tuple) -> torch.Tensor:
    """``sign.partial.sign_folded`` over the devices of ``mesh``.

    Pads the batch with zero rows up to a multiple of the device count
    (zero scalar bits leave the ladder at the identity; the phantom rows
    are sliced off), runs each device's contiguous slice there and gathers
    the slices back onto ``h_dev``'s device in order.  Returns the raw
    (B, C, L) result exactly like ``sign_folded``."""
    devices = tuple(torch.device(d) for d in mesh)
    kk = (fh.to_tensor(np.asarray(sigma_limbs), h_dev.device) if not isinstance(sigma_limbs, torch.Tensor)
          else sigma_limbs.to(h_dev.device))
    b = h_dev.shape[0]
    if kk.dim() == 1:
        kk = kk.expand(b, kk.shape[-1])
    pad = (-b) % len(devices)
    hh = h_dev
    if pad:
        kk = torch.cat([kk, kk.new_zeros((pad,) + tuple(kk.shape[1:]))])
        hh = torch.cat([hh, hh.new_zeros((pad,) + tuple(hh.shape[1:]))])
    per = (b + pad) // len(devices)
    parts = [partial.sign_folded(curve, kk[i * per : (i + 1) * per].to(d), hh[i * per : (i + 1) * per].to(d))
             for i, d in enumerate(devices)]
    out = torch.cat([p.to(h_dev.device) for p in parts])
    return out[:b] if pad else out
