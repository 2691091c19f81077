"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Every value comes from a seed and is handed to both packages as the
same uint32 limb array: jnp.asarray for ``dkg_tpu``, an int32 tensor on
the CPU for ``dkg_tpu_torch``.  The arithmetic is exact modular, so the
tests compare by exact equality.
"""

import random

import numpy as np
import torch

from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import host as jgh


def field_ints(fs, seed: int, n: int) -> list:
    """n elements of ``fs``: the edge values first, then random ones."""
    rng = random.Random(seed)
    p = fs.modulus
    edges = [0, 1, 2, p - 1, p - 2, (1 << 255) % p, (1 << 16) - 1, p >> 1]
    return (edges + [rng.randrange(p) for _ in range(n)])[:n]


def field_limbs(fs, seed: int, n: int) -> np.ndarray:
    return jfh.encode(fs, field_ints(fs, seed, n))


def point_tuples(curve: str, seed: int, n: int, projective: bool = True) -> list:
    """n host points of ``curve``: multiples of the generator, every 5th
    the identity; projective ones rescaled by a random lambda."""
    g = jgh.ALL_GROUPS[curve]
    p = g.base_field.modulus
    rng = random.Random(seed)
    out = []
    for i in range(n):
        pt = g.identity() if i % 5 == 2 else g.scalar_mul(rng.randrange(1, 1 << 40), g.generator())
        if curve == "ristretto255":
            x, y, z, t = pt
            zi = pow(z, p - 2, p)
            x, y = x * zi % p, y * zi % p
            pt = (x, y, 1, x * y % p)
        else:
            aff = g.to_affine(pt)
            pt = (0, 1, 0) if aff is None else (aff[0], aff[1], 1)
        if projective:
            lam = rng.randrange(1, p)
            pt = tuple(c * lam % p for c in pt)
        out.append(pt)
    return out


def point_limbs(curve: str, seed: int, n: int, projective: bool = True) -> np.ndarray:
    fs = jgh.ALL_GROUPS[curve].base_field
    return jfh.encode(fs, np.asarray(point_tuples(curve, seed, n, projective), dtype=object))


def to_torch(arr) -> torch.Tensor:
    """uint32 numpy limbs (or a jax array) -> int32 CPU tensor."""
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def to_np(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy, the JAX package's format."""
    return t.numpy().astype(np.uint32)
