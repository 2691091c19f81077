"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Every value comes from a seed and is handed to both packages as the
same uint32 limb array: jnp.asarray for ``dkg_tpu``, an int32 tensor on
the CPU for ``dkg_tpu_torch``; wire objects cross packages through
:func:`to_port` and :func:`to_jax`.  The arithmetic is exact modular, so
the tests compare by exact equality.
"""

import dataclasses
import enum
import importlib
import random

import numpy as np
import pytest
import torch

from dkg_tpu.crypto import dleq as jdleq
from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import host as jgh
from dkg_tpu.sign import partial as jsp
from dkg_tpu_torch.crypto import dleq as tdleq
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.sign import partial as tsp


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


# ---------------------------------------------------------------------------
# signing: the JAX package's test_sign.py shape, and grids carried across
# ---------------------------------------------------------------------------

SIGN_N, SIGN_T = 5, 2
MESSAGES = [b"dkg_tpu sign test message 0", b"dkg_tpu sign test message 1"]
QUORUM, QUORUM2 = [1, 2, 3], [2, 3, 4]


def sharing(curve: str, seed: int = 0x516E) -> tuple[int, list[int]]:
    """The seeded (SIGN_N, SIGN_T) Shamir sharing of the JAX package's
    signing test: (secret, shares at nodes 1..SIGN_N)."""
    fs = jgh.ALL_GROUPS[curve].scalar_field
    rng = random.Random(seed)
    coeffs = [fs.rand_int(rng) for _ in range(SIGN_T + 1)]

    def horner(x: int) -> int:
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % fs.modulus
        return acc

    return coeffs[0], [horner(i) for i in range(1, SIGN_N + 1)]


def _counterpart(cls, src: str, dst: str):
    """The class of package ``dst`` with ``cls``'s name, in the module of
    the same path."""
    mod = cls.__module__
    assert mod.startswith(src + "."), mod
    return getattr(importlib.import_module(dst + mod[len(src):]), cls.__name__)


def _carry(obj, src: str, dst: str, groups: dict):
    """``obj`` rebuilt in package ``dst``'s types, field by field: each
    dataclass as its same-named counterpart, enum members by name, host
    groups by name, containers element by element; ints, bytes and
    strings as they are."""
    if obj is None or isinstance(obj, (int, bytes, str, float)):
        return obj
    if isinstance(obj, enum.Enum):
        return _counterpart(type(obj), src, dst)[obj.name]
    if isinstance(obj, (tuple, list, set, frozenset)):
        return type(obj)(_carry(x, src, dst, groups) for x in obj)
    if isinstance(obj, dict):
        return {_carry(k, src, dst, groups): _carry(v, src, dst, groups) for k, v in obj.items()}
    if type(obj).__module__ == f"{src}.groups.host":
        return groups[obj.name]
    if dataclasses.is_dataclass(obj):
        cls = _counterpart(type(obj), src, dst)
        return cls(**{f.name: _carry(getattr(obj, f.name), src, dst, groups) for f in dataclasses.fields(obj)})
    raise TypeError(f"cannot carry a {type(obj).__name__} across packages")


def to_port(obj):
    """A JAX package object as the port's: a signing grid with its sigs as
    a CPU tensor; wire objects (broadcasts, complaints, proofs, keys,
    environments) rebuilt in the port's same-named types field by field."""
    if isinstance(obj, jsp.PartialSignatures):
        return tsp.PartialSignatures(obj.curve, obj.indices, obj.h_points, to_torch(obj.sigs), obj.pks,
                                     [tdleq.DleqZkp(p.challenge, p.response) for p in obj.proofs], obj.announcements)
    return _carry(obj, "dkg_tpu", "dkg_tpu_torch", tgh.ALL_GROUPS)


def to_jax(obj):
    """A port object as the JAX package's: a signing grid with its sigs as
    uint32 numpy; wire objects rebuilt in the JAX package's types."""
    if isinstance(obj, tsp.PartialSignatures):
        return jsp.PartialSignatures(obj.curve, obj.indices, obj.h_points, to_np(obj.sigs), obj.pks,
                                     [jdleq.DleqZkp(p.challenge, p.response) for p in obj.proofs], obj.announcements)
    return _carry(obj, "dkg_tpu_torch", "dkg_tpu", jgh.ALL_GROUPS)


def z_tampered(ps, bi: int, si: int):
    """Cell (bi, si)'s response z + 1, the forgery that survives the hash
    screen (z is not hashed), on either package's grid."""
    q = jgh.ALL_GROUPS[ps.curve].scalar_field.modulus
    m = len(ps.indices)
    proofs = list(ps.proofs)
    cell = proofs[bi * m + si]
    proofs[bi * m + si] = dataclasses.replace(cell, response=(cell.response + 1) % q)
    return dataclasses.replace(ps, proofs=proofs)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for a module's plain versions: their tensors are
    small, and under the 6-worker suite a multi-threaded op waits on threads
    that other workers have descheduled (a test ran 10-40x its idle time).
    Imported by a test module, it applies to that module only."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
