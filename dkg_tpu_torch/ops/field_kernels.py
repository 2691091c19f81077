"""The ``mod_madd`` and ``mod_mul`` kernels: ``(a * b + c) mod p`` and
``(a * b) mod p`` in one launch.

Counterparts of ``dkg_tpu/ops/pallas_field.py`` ``mod_madd`` and
``mod_mul``.  On a CUDA tensor :func:`mod_madd` and :func:`mod_mul` launch
``csrc/field_kernels.cu`` over the field of their operands (secp256k1's
base and scalar fields, ed25519's base field, the ristretto255 scalar
field, BLS12-381's 24-limb base field and its scalar field; any other
field raises); on a CPU tensor they run :func:`mod_madd_plain` and
``fields.device.mul``, the plain PyTorch versions the kernels are held
against.  Operands broadcast over their batch axes.

The three field families count their launches apart: ``MOD_MADD`` and
``MOD_MUL`` for secp256k1's fields, ``MOD_MADD_ED`` and ``MOD_MUL_ED`` for
ed25519's, ``MOD_MADD_BLS`` and ``MOD_MUL_BLS`` for BLS12-381's.
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields.spec import BLS12_381_P, BLS12_381_R, L25519, P25519, SECP256K1_N, SECP256K1_P, FieldSpec
from . import build

_ARGS = [build.PTR, build.PTR, build.PTR, build.PTR, build.I64, build.INT, build.PTR]
MOD_MADD = build.Kernel("mod_madd", "field_kernels.cu", "dkg_mod_madd", _ARGS)
MOD_MADD_ED = build.Kernel("mod_madd[ed25519]", "field_kernels.cu", "dkg_mod_madd", _ARGS)
MOD_MADD_BLS = build.Kernel("mod_madd[bls12_381]", "field_kernels.cu", "dkg_mod_madd", _ARGS)
_MUL_ARGS = [build.PTR, build.PTR, build.PTR, build.I64, build.INT, build.PTR]
MOD_MUL = build.Kernel("mod_mul", "field_kernels.cu", "dkg_mod_mul", _MUL_ARGS)
MOD_MUL_ED = build.Kernel("mod_mul[ed25519]", "field_kernels.cu", "dkg_mod_mul", _MUL_ARGS)
MOD_MUL_BLS = build.Kernel("mod_mul[bls12_381]", "field_kernels.cu", "dkg_mod_mul", _MUL_ARGS)
KERNELS = (MOD_MADD, MOD_MADD_ED, MOD_MADD_BLS, MOD_MUL, MOD_MUL_ED, MOD_MUL_BLS)

# field -> (mod_madd kernel, field id of csrc/field.cuh)
_FIELDS = {
    SECP256K1_P: (MOD_MADD, 0),
    SECP256K1_N: (MOD_MADD, 1),
    P25519: (MOD_MADD_ED, 2),
    L25519: (MOD_MADD_ED, 3),
    BLS12_381_P: (MOD_MADD_BLS, 4),
    BLS12_381_R: (MOD_MADD_BLS, 5),
}
_MUL_KERNELS = {MOD_MADD: MOD_MUL, MOD_MADD_ED: MOD_MUL_ED, MOD_MADD_BLS: MOD_MUL_BLS}


def mul_kernel_for(fs: FieldSpec) -> build.Kernel:
    """The ``mod_mul`` kernel of field ``fs``; raises if there is none."""
    if fs not in _FIELDS:
        raise NotImplementedError(f"mod_mul has no CUDA kernel for {fs.name}")
    return _MUL_KERNELS[_FIELDS[fs][0]]


def mod_madd_plain(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return fd.add(fs, fd.mul(fs, a, b), c)


def mod_madd(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(a * b + c) mod p on (..., L) int32 limbs, batch axes broadcast."""
    if a.device.type == "cpu":
        return mod_madd_plain(fs, a, b, c)
    if fs not in _FIELDS:
        raise NotImplementedError(f"mod_madd has no CUDA kernel for {fs.name}")
    kernel, field = _FIELDS[fs]
    tail = (fs.limbs,)
    (a, b, c), out, n = build.lanes([(a, tail), (b, tail), (c, tail)], tail)
    if n:
        kernel(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), n, field,
               build.stream_ptr(out.device))
    return out


def mod_mul(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p on (..., L) int32 limbs, batch axes broadcast."""
    if a.device.type == "cpu":
        return fd.mul(fs, a, b)
    kernel = mul_kernel_for(fs)
    tail = (fs.limbs,)
    (a, b), out, n = build.lanes([(a, tail), (b, tail)], tail)
    if n:
        kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _FIELDS[fs][1], build.stream_ptr(out.device))
    return out
