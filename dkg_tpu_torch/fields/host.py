"""Conversions between Python ints and limb arrays.

The JAX package exchanges ``uint32`` numpy limb arrays; the port keeps
that format at its boundary and converts to ``int32`` tensors inside
(:func:`to_tensor` / :func:`from_tensor`).  ``encode`` and ``decode``
give the JAX package's ``fields/host.py`` results, built through one
bytes buffer instead of a loop over limbs: a (1024, 342) coefficient
matrix encodes in well under a second.
"""

from __future__ import annotations

import numpy as np
import torch

from .spec import FieldSpec


def encode(fs: FieldSpec, values) -> np.ndarray:
    """ints (scalar or nested list) -> uint32 limb array (..., L), each
    value reduced mod p."""
    arr = np.asarray(values, dtype=object)
    m, nbytes = fs.modulus, 2 * fs.limbs
    buf = b"".join((int(v) % m).to_bytes(nbytes, "little") for v in arr.reshape(-1))
    limbs = np.frombuffer(buf, dtype="<u2").astype(np.uint32)
    return limbs.reshape(arr.shape + (fs.limbs,))


def decode(fs: FieldSpec, limbs) -> np.ndarray:
    """Limb array (..., L) with limbs < 2**16 -> object array of Python ints."""
    arr = np.asarray(limbs)
    if arr.size and int(arr.max()) > 0xFFFF:
        raise ValueError("limb values must be < 2**16")
    buf = np.ascontiguousarray(arr, dtype="<u2").tobytes()
    nb = 2 * arr.shape[-1]
    out = np.empty(arr.shape[:-1], dtype=object)
    flat = out.reshape(-1)
    for i in range(flat.size):
        flat[i] = int.from_bytes(buf[i * nb : (i + 1) * nb], "little")
    return out


def to_tensor(limbs, device) -> torch.Tensor:
    """uint32 (or any integer) numpy limbs -> int32 tensor on ``device``.

    Limbs are < 2**16, so the int32 copy holds the same values."""
    arr = np.asarray(limbs)
    if arr.size and (int(arr.max()) > 0xFFFF or int(arr.min()) < 0):
        raise ValueError("limb values must be in [0, 2**16)")
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(device)


def from_tensor(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array (the JAX package's format)."""
    return t.detach().cpu().numpy().astype(np.uint32)
