"""The ``mxu_mod_mul`` kernel: ``(a * b) mod p`` by the fused
multiply-reduce, in one launch; and :func:`mxu_batch_inv`, a whole
``fields.device.batch_inv`` with that multiply in one launch.

Counterpart of ``dkg_tpu/ops/pallas_mxu.py`` ``mxu_mod_mul``.  On a CUDA
tensor :func:`mxu_mod_mul` launches ``csrc/mxu_kernels.cu`` with the
constants of its operands' field (``FieldSpec.mulred``), built once per
field and device as buffers on the card: ``foldm`` as bytes, transposed
and packed four digits a word, the quotient table, c = b**L mod p and
b**(L+1) - p.  Its fold runs a lane a thread by ``__dp4a``
(``csrc/mxu.cuh``): on the tensor cores it measured slower at every path
shape on the H100 (``PERF.md``).  Fields the kernel does not take raise.
On a CPU tensor it runs ``fields.device._mul_gemm``, the plain PyTorch
version the kernel is held against.  Operands broadcast over their batch
axes.

:func:`mxu_batch_inv` inverts down axis 0 as ``mod_batch_inv`` does, a
thread a column and a warp 32 columns, every multiply of the chain the
warp's tensor-core multiply-reduce; it is built for the three base fields
whose points ``groups.device.affine_canon`` makes affine.  Its plain
version is ``fields.device.batch_inv`` with ``_mul_gemm`` as the multiply
(the JAX package's chain under ``DKG_TPU_MUL=gemm``).

The field families count their launches apart, as ``mod_mul``'s do:
``MXU_MOD_MUL`` and ``MXU_BATCH_INV`` for secp256k1's fields, the
``_ED`` kernels for ed25519's, the ``_BLS`` ones for BLS12-381's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import device as fd
from ..fields.spec import BLS12_381_P, BLS12_381_R, L25519, P25519, SECP256K1_N, SECP256K1_P, FieldSpec
from . import build
from . import field_kernels as fk

# a, b, out, lanes, limbs, foldm, qtable, table length, c, b**(L+1) - p, n_split, shift_e, stream
_ARGS = [build.PTR, build.PTR, build.PTR, build.I64, build.INT, build.PTR, build.PTR, build.INT,
         build.PTR, build.PTR, build.INT, build.INT, build.PTR]
MXU_MOD_MUL = build.Kernel("mxu_mod_mul", "mxu_kernels.cu", "dkg_mxu_mod_mul", _ARGS)
MXU_MOD_MUL_ED = build.Kernel("mxu_mod_mul[ed25519]", "mxu_kernels.cu", "dkg_mxu_mod_mul", _ARGS)
MXU_MOD_MUL_BLS = build.Kernel("mxu_mod_mul[bls12_381]", "mxu_kernels.cu", "dkg_mxu_mod_mul", _ARGS)
# x, out, rows, cols, limbs, the field's four constants as above, n_split, shift_e, chain, its
# length, odd powers, stream
_INV_ARGS = [build.PTR, build.PTR, build.I64, build.I64, build.INT, build.PTR, build.PTR, build.INT,
             build.PTR, build.PTR, build.INT, build.INT, build.PTR, build.INT, build.INT, build.PTR]
MXU_BATCH_INV = build.Kernel("mxu_batch_inv", "mxu_kernels.cu", "dkg_mxu_batch_inv", _INV_ARGS)
MXU_BATCH_INV_ED = build.Kernel("mxu_batch_inv[ed25519]", "mxu_kernels.cu", "dkg_mxu_batch_inv", _INV_ARGS)
MXU_BATCH_INV_BLS = build.Kernel("mxu_batch_inv[bls12_381]", "mxu_kernels.cu", "dkg_mxu_batch_inv", _INV_ARGS)
KERNELS = (MXU_MOD_MUL, MXU_MOD_MUL_ED, MXU_MOD_MUL_BLS, MXU_BATCH_INV, MXU_BATCH_INV_ED, MXU_BATCH_INV_BLS)

WARP = 32  # mxu_batch_inv's columns: a multiple of a warp's lanes

_FIELDS = {
    SECP256K1_P: MXU_MOD_MUL,
    SECP256K1_N: MXU_MOD_MUL,
    P25519: MXU_MOD_MUL_ED,
    L25519: MXU_MOD_MUL_ED,
    BLS12_381_P: MXU_MOD_MUL_BLS,
    BLS12_381_R: MXU_MOD_MUL_BLS,
}
# mxu_batch_inv is built for the base fields whose points affine_canon makes affine
_INV_KERNELS = {SECP256K1_P: MXU_BATCH_INV, P25519: MXU_BATCH_INV_ED, BLS12_381_P: MXU_BATCH_INV_BLS}
_CONSTANTS: dict = {}  # (field name, device) -> the kernel's constant buffers


def kernel_for(fs: FieldSpec) -> build.Kernel:
    """The ``mxu_mod_mul`` kernel of field ``fs``; raises if there is none."""
    if fs not in _FIELDS:
        raise NotImplementedError(f"mxu_mod_mul has no CUDA kernel for {fs.name}")
    return _FIELDS[fs]


def batch_inv_kernel_for(fs: FieldSpec) -> build.Kernel:
    """The ``mxu_batch_inv`` kernel of field ``fs``; raises if there is none."""
    if fs not in _INV_KERNELS:
        raise NotImplementedError(f"mxu_batch_inv has no CUDA kernel for {fs.name}")
    return _INV_KERNELS[fs]


def packed_foldm(fs: FieldSpec) -> np.ndarray:
    """``fs.mulred.foldm`` (3L+1, 2L) as the kernel reads it: (2L, 4·K4)
    bytes, K4 = ceil((3L+1)/4), byte t of row m's word k being
    foldm[4k + t][m] (zero past the last digit)."""
    fm = fs.mulred.foldm
    k4 = -(-fm.shape[0] // 4)
    padded = np.zeros((4 * k4, fm.shape[1]), np.uint8)
    padded[: fm.shape[0]] = fm
    return np.ascontiguousarray(padded.T)


def _constants(fs: FieldSpec, device: torch.device) -> tuple:
    key = (fs.name, device)
    if key not in _CONSTANTS:
        mr = fs.mulred

        def put(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

        _CONSTANTS[key] = (put(packed_foldm(fs)), put(mr.qtable.astype(np.int32)),
                           put(mr.c_limbs.astype(np.int32)), put(mr.np_limbs.astype(np.int32)))
    return _CONSTANTS[key]


def mxu_mod_mul(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p on (..., L) int32 limbs by the fused multiply-reduce,
    batch axes broadcast; equal to ``fields.device.mul``."""
    if a.device.type == "cpu":
        return fd._mul_gemm(fs, a, b)
    kernel = kernel_for(fs)
    tail = (fs.limbs,)
    (a, b), out, n = build.lanes([(a, tail), (b, tail)], tail)
    if n:
        mr = fs.mulred
        foldm, qtable, c, np_limbs = _constants(fs, out.device)
        kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, fs.limbs, foldm.data_ptr(), qtable.data_ptr(),
               qtable.numel(), c.data_ptr(), np_limbs.data_ptr(), mr.n_split, mr.shift_e,
               build.stream_ptr(out.device))
    return out


def mxu_batch_inv_plain(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``batch_inv`` under ``DKG_TPU_MUL=gemm`` down
    axis 0: its chain with ``_mul_gemm`` as every multiply."""
    return fd.batch_inv(fs, x, axis=0, mul=fd._mul_gemm)


def mxu_batch_inv(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """``fields.device.batch_inv(fs, x, axis=0)`` in one launch, every
    multiply the fused multiply-reduce with its fold on the tensor cores:
    x (k, ..., L) -> the same shape, each column x[:, c] inverted by the
    Montgomery trick.  The columns are padded with ones to a multiple of a
    warp's 32 (an inverse of 1 is 1; the padding is dropped).  A column
    holding a zero reads 0 in every row; the others read the canonical
    inverses."""
    if x.device.type == "cpu":
        return mxu_batch_inv_plain(fs, x)
    kernel = batch_inv_kernel_for(fs)
    L = fs.limbs
    if x.dim() < 2:
        raise ValueError(f"mxu_batch_inv takes x (k, ..., L), got {tuple(x.shape)}")
    dev = build.check_operands([(x, (L,))])
    rows = x.shape[0]
    xs = x.reshape(rows, -1, L)
    cols = xs.shape[1]
    pad = (-cols) % WARP
    if pad:
        xs = torch.cat([xs, fd.ones(fs, (rows, pad), device=dev)], dim=1)
    xs = build.aligned(xs.contiguous())
    out = torch.empty_like(xs)
    if rows and cols:
        mr = fs.mulred
        foldm, qtable, c, np_limbs = _constants(fs, dev)
        chain, npow = fk._chain_table(fs, dev), fk.inv_chain(fs)[1]
        kernel(xs.data_ptr(), out.data_ptr(), rows, xs.shape[1], L, foldm.data_ptr(), qtable.data_ptr(),
               qtable.numel(), c.data_ptr(), np_limbs.data_ptr(), mr.n_split, mr.shift_e, chain.data_ptr(),
               len(chain), npow, build.stream_ptr(dev))
    return out[:, :cols].reshape(x.shape)
