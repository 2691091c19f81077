"""The ``mod_madd`` kernel: ``(a * b + c) mod p`` in one launch.

Counterpart of ``dkg_tpu/ops/pallas_field.py`` ``mod_madd``.  On a CUDA
tensor :func:`mod_madd` launches ``csrc/field_kernels.cu`` (secp256k1's
base and scalar fields); on a CPU tensor it runs :func:`mod_madd_plain`,
the plain PyTorch version the kernel is held against.  Operands
broadcast over their batch axes.
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields.spec import SECP256K1_N, SECP256K1_P, FieldSpec
from . import build

# field ids of csrc/field.cuh
_FIELD_IDS = {SECP256K1_P.name: 0, SECP256K1_N.name: 1}

MOD_MADD = build.Kernel(
    "mod_madd",
    "field_kernels.cu",
    "dkg_mod_madd",
    [build.PTR, build.PTR, build.PTR, build.PTR, build.I64, build.INT, build.PTR],
)
KERNELS = (MOD_MADD,)


def mod_madd_plain(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return fd.add(fs, fd.mul(fs, a, b), c)


def mod_madd(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(a * b + c) mod p on (..., L) int32 limbs, batch axes broadcast."""
    if a.device.type == "cpu":
        return mod_madd_plain(fs, a, b, c)
    field = _FIELD_IDS.get(fs.name)
    if field is None:
        raise NotImplementedError(f"mod_madd has no CUDA kernel for {fs.name} yet")
    tail = (fs.limbs,)
    (a, b, c), out, n = build.lanes([(a, tail), (b, tail), (c, tail)], tail)
    if n:
        MOD_MADD(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), n, field,
                 build.stream_ptr(out.device))
    return out
