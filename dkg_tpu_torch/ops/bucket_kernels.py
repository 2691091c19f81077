"""The ``bucket_accumulate`` kernel: the scatter pass of Pippenger's MSM.

Counterpart of ``dkg_tpu/ops/pallas_mxu.py`` ``bucket_accumulate``.
Points ``(..., m, C, L)`` and window digits ``(..., m, nw)`` give buckets
``(..., nw, 2**window, C, L)``: bucket (w, e) is the sum, in order of the
m points, of those whose window-w digit is e, starting from the
identity.  Digit-0 points land in bucket 0 and stay there (the bucket
close ignores it).

On a CUDA tensor :func:`bucket_accumulate` launches the kernel of the
points' curve (secp256k1's ``bucket_accumulate`` and edwards25519's
``bucket_accumulate[edwards]`` in ``csrc/bucket_kernels.cu``, BLS12-381
G1's ``bucket_accumulate[bls12_381]`` in ``csrc/bls_kernels.cu``; any
other curve raises); on a CPU tensor it runs
:func:`bucket_accumulate_plain`, the plain PyTorch version the kernel is
held against.  Digits of shape ``(m, nw)`` are shared by the whole batch
(the RLC's weights): the kernel reads them with a batch stride of 0.
"""

from __future__ import annotations

import torch

from . import build
from . import point_kernels as pk

# points, digits, out, batch rows, m, nw, window, digit batch stride, stream
_ARGS = [build.PTR, build.PTR, build.PTR, build.I64, build.I64, build.INT, build.INT, build.I64, build.PTR]
BUCKET_ACCUMULATE = build.Kernel("bucket_accumulate", "bucket_kernels.cu", "dkg_bucket_accumulate", _ARGS)
ED_BUCKET_ACCUMULATE = build.Kernel("bucket_accumulate[edwards]", "bucket_kernels.cu",
                                    "dkg_ed_bucket_accumulate", _ARGS)
BLS_BUCKET_ACCUMULATE = build.Kernel("bucket_accumulate[bls12_381]", "bls_kernels.cu",
                                     "dkg_bls_bucket_accumulate", _ARGS)
KERNELS = (BUCKET_ACCUMULATE, ED_BUCKET_ACCUMULATE, BLS_BUCKET_ACCUMULATE)

# (kind, base field, curve constant) -> kernel
_VARIANTS = {pk._WS_KEY: BUCKET_ACCUMULATE, pk._ED_KEY: ED_BUCKET_ACCUMULATE, pk._BLS_KEY: BLS_BUCKET_ACCUMULATE}
WINDOWS = (1, 2, 4, 8)  # the bucket widths the kernel takes


def kernel_for(cs) -> build.Kernel:
    """The kernel that scatters points of curve ``cs``; raises if there is none."""
    kernel = _VARIANTS.get((cs.kind, cs.field.name, cs.const))
    if kernel is None:
        raise NotImplementedError(f"bucket_accumulate has no CUDA kernel for {cs.name}")
    return kernel


def bucket_accumulate_plain(cs, points: torch.Tensor, digits: torch.Tensor, entries: int) -> torch.Tensor:
    """The JAX package's ``_bucket_scan``: one step per point, in order.
    Each step gathers every window's current bucket, adds the point
    (``pt_add_plain(cur, P_j)``, cur first) and writes the sums back by a
    one-hot select.  Digits broadcast to the points' batch."""
    batch, m = points.shape[:-3], points.shape[-3]
    nw = digits.shape[-1]
    tail = points.shape[-2:]
    digits = digits.expand(batch + (m, nw)).long()
    ids = torch.arange(entries, device=points.device)
    buckets = pk.identity_plain(cs, batch + (nw, entries), points.device)
    for j in range(m):
        dig = digits[..., j, :]  # batch + (nw,)
        idx = dig[..., None, None, None].expand(batch + (nw, 1) + tail)
        cur = torch.gather(buckets, -3, idx)[..., 0, :, :]
        new = pk.pt_add_plain(cs, cur, points[..., j, None, :, :])
        onehot = ids == dig[..., None]  # batch + (nw, entries)
        buckets = torch.where(onehot[..., None, None], new[..., None, :, :], buckets)
    return buckets.contiguous()


def bucket_accumulate(cs, points: torch.Tensor, digits: torch.Tensor, window: int, nw: int) -> torch.Tensor:
    """Buckets ``(..., nw, 2**window, C, L)`` of points ``(..., m, C, L)``
    under digits ``(m, nw)`` (shared by the batch) or ``(..., m, nw)``."""
    entries = 1 << window
    if points.device.type == "cpu":
        return bucket_accumulate_plain(cs, points, digits, entries)
    kernel = kernel_for(cs)
    if window not in WINDOWS:
        raise ValueError(f"bucket_accumulate takes a window of {WINDOWS}, got {window}")
    point = (cs.ncoords, cs.field.limbs)
    if points.dim() < 3 or tuple(points.shape[-2:]) != point:
        raise ValueError(f"kernel operand of shape {tuple(points.shape)} does not end in (m,) + {point}")
    batch, m = points.shape[:-3], points.shape[-3]
    if digits.dim() < 2 or tuple(digits.shape[-2:]) != (m, nw):
        raise ValueError(f"kernel operand of shape {tuple(digits.shape)} does not end in {(m, nw)}")
    for t in (points, digits):
        if t.device != points.device or t.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, got {t.device} and {points.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"kernel operands are int32, got {t.dtype}")
    if digits.dim() == 2:
        stride = 0  # one digit block for every batch row
    else:
        digits = digits.expand(batch + (m, nw))
        stride = m * nw
    points, digits = points.contiguous(), digits.contiguous()
    out = torch.empty(batch + (nw, entries) + point, dtype=torch.int32, device=points.device)
    rows = batch.numel()
    if out.numel():
        kernel(points.data_ptr(), digits.data_ptr(), out.data_ptr(), rows, m, nw, window, stride,
               build.stream_ptr(out.device))
    return out
