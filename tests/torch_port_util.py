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


def field_limbs(fs, seed: int, n: int, nbits: int | None = None) -> np.ndarray:
    """``field_ints`` as limbs; with ``nbits`` (a multiple of 16), masked
    to their low nbits bits, as the RLC's weights are."""
    limbs = jfh.encode(fs, field_ints(fs, seed, n))
    if nbits is not None:
        limbs[:, nbits // 16:] = 0
    return limbs


def edge_ints(fs) -> list:
    """The field's edge values: 0, 1, m - 1, and values within 2**32 of
    2**255 and of 2**256 - 1, reduced mod m; for a field wider than 16
    limbs (BLS12-381 p), also m - 2 and values near 2**(16L - 1) and
    2**(16L) - 1."""
    m = fs.modulus
    near = [(1 << 255) + d for d in (-(1 << 32), -1, 0, 1, 1 << 32)]
    near += [(1 << 256) - 1 - d for d in (0, 1, 1 << 32)]
    top = 16 * fs.limbs
    if top > 256:
        near += [m - 2, (1 << (top - 1)) - 1, 1 << (top - 1), (1 << top) - 1, (1 << top) - (1 << 32)]
    return [0, 1, m - 1] + [v % m for v in near]


def edge_operands(fs, seed: int, k: int) -> list:
    """k operand lists over every pair of edge values (the first two
    operands run through all pairs, the others cycle through the edges),
    then seeded random elements: the inputs of a k-ary field kernel."""
    edges = edge_ints(fs)
    e = len(edges)
    rng = random.Random(seed)
    extra = [rng.randrange(fs.modulus) for _ in range(k * 8)]
    ops = []
    for j in range(k):
        if j == 0:
            col = [edges[i // e] for i in range(e * e)]
        elif j == 1:
            col = [edges[i % e] for i in range(e * e)]
        else:
            col = [edges[(i * (j + 2)) % e] for i in range(e * e)]
        ops.append(col + extra[j * 8 : (j + 1) * 8])
    return ops


def point_tuples(curve: str, seed: int, n: int, projective: bool = True, edge_lambdas: bool = False) -> list:
    """n host points of ``curve``: multiples of the generator, every 5th
    the identity; projective ones rescaled by a random lambda (with
    ``edge_lambdas``, the first lanes by the base field's non-zero edge
    values instead)."""
    g = jgh.ALL_GROUPS[curve]
    p = g.base_field.modulus
    rng = random.Random(seed)
    lams = [v for v in edge_ints(g.base_field) if v] if edge_lambdas else []
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
            if i < len(lams):
                lam = lams[i]
            pt = tuple(c * lam % p for c in pt)
        out.append(pt)
    return out


def point_limbs(curve: str, seed: int, n: int, projective: bool = True, edge_lambdas: bool = False) -> np.ndarray:
    fs = jgh.ALL_GROUPS[curve].base_field
    pts = point_tuples(curve, seed, n, projective, edge_lambdas)
    return jfh.encode(fs, np.asarray(pts, dtype=object))


def to_torch(arr) -> torch.Tensor:
    """uint32 numpy limbs (or a jax array) -> int32 CPU tensor."""
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def to_np(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy, the JAX package's format."""
    return t.numpy().astype(np.uint32)


def same(got: torch.Tensor, want) -> bool:
    """An int32 port result equal, limb for limb, to a JAX package one."""
    return got.dtype == torch.int32 and np.array_equal(to_np(got), np.asarray(want))
