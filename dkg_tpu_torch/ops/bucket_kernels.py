"""The ``bucket_accumulate`` kernel: the scatter pass of Pippenger's MSM;
and its redesign for digits shared by the batch, ``pt_bucket_sum``, with
the bucket close in one launch, ``pt_bucket_close``.

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

:func:`pt_bucket_sum` takes such shared digits (``(m, nw)``), or a convoy
of digit blocks ``(K..., m, nw)`` each shared by its own ceremony's rows
(the service's stacked verify): a stable counting sort of each window's
digits (:func:`bucket_lists`, index preparation in tensor ops) gives each
bucket its points in order of j,
and ``csrc/pippenger_kernels.cu`` adds exactly those, one thread a bucket
and batch row, reading the points in place through strides.  It forms
buckets 1 .. 2**window - 1 (bucket 0 is not needed), equal limb for limb
to ``bucket_accumulate``'s.  :func:`pt_bucket_close` runs the JAX
package's suffix sum ``run = run + B_e; tot = tot + run`` (e from the
top) over every (row, window) in one launch, from buckets in either
layout.  On a CPU tensor each runs its plain version
(:func:`pt_bucket_sum_plain`: the sorted lists, one ordered add a rank;
:func:`pt_bucket_close_plain`: the suffix sum with the plain add).  A lane
of the close runs on a group of 4 threads on secp256k1 and BLS12-381 and
on one thread on ristretto255, a lane of the sum on one thread: each the
faster setting at its point RLC's shape on the H100 (5.30 against 9.80
device ms one thread on secp256k1's 5472 lanes, 8.76 against 14.22 on
BLS12-381's; ristretto255's 2752 lanes 0.158 on one thread against 0.186
on groups of 8; ``ops/bucket_bench.py``, ``PERF.md``).
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
# points, their row and point strides, order, starts, out, batch rows, m, nw, buckets a window,
# digit blocks, stream
_SUM_ARGS = [build.PTR, build.I64, build.I64, build.PTR, build.PTR, build.PTR, build.I64, build.I64,
             build.INT, build.INT, build.I64, build.PTR]
PT_BUCKET_SUM = build.Kernel("pt_bucket_sum", "pippenger_kernels.cu", "dkg_pt_bucket_sum", _SUM_ARGS)
ED_PT_BUCKET_SUM = build.Kernel("pt_bucket_sum[edwards]", "pippenger_kernels.cu", "dkg_ed_pt_bucket_sum",
                                _SUM_ARGS)
BLS_PT_BUCKET_SUM = build.Kernel("pt_bucket_sum[bls12_381]", "pippenger_kernels.cu", "dkg_bls_pt_bucket_sum",
                                 _SUM_ARGS)
# buckets, their row, window and bucket strides, out, batch rows, nw, buckets a window, stream
_CLOSE_ARGS = [build.PTR, build.I64, build.I64, build.I64, build.PTR, build.I64, build.INT, build.INT, build.PTR]
PT_BUCKET_CLOSE = build.Kernel("pt_bucket_close", "pippenger_kernels.cu", "dkg_pt_bucket_close", _CLOSE_ARGS)
ED_PT_BUCKET_CLOSE = build.Kernel("pt_bucket_close[edwards]", "pippenger_kernels.cu", "dkg_ed_pt_bucket_close",
                                  _CLOSE_ARGS)
BLS_PT_BUCKET_CLOSE = build.Kernel("pt_bucket_close[bls12_381]", "pippenger_kernels.cu",
                                   "dkg_bls_pt_bucket_close", _CLOSE_ARGS)
KERNELS = (BUCKET_ACCUMULATE, ED_BUCKET_ACCUMULATE, BLS_BUCKET_ACCUMULATE, PT_BUCKET_SUM, ED_PT_BUCKET_SUM,
           BLS_PT_BUCKET_SUM, PT_BUCKET_CLOSE, ED_PT_BUCKET_CLOSE, BLS_PT_BUCKET_CLOSE)

# (kind, base field, curve constant) -> kernel
_VARIANTS = {pk._WS_KEY: BUCKET_ACCUMULATE, pk._ED_KEY: ED_BUCKET_ACCUMULATE, pk._BLS_KEY: BLS_BUCKET_ACCUMULATE}
_SUM_VARIANTS = {pk._WS_KEY: PT_BUCKET_SUM, pk._ED_KEY: ED_PT_BUCKET_SUM, pk._BLS_KEY: BLS_PT_BUCKET_SUM}
_CLOSE_VARIANTS = {pk._WS_KEY: PT_BUCKET_CLOSE, pk._ED_KEY: ED_PT_BUCKET_CLOSE, pk._BLS_KEY: BLS_PT_BUCKET_CLOSE}
WINDOWS = (1, 2, 4, 8)  # the bucket widths the kernels take


def kernel_for(cs) -> build.Kernel:
    """The kernel that scatters points of curve ``cs``; raises if there is none."""
    kernel = _VARIANTS.get((cs.kind, cs.field.name, cs.const))
    if kernel is None:
        raise NotImplementedError(f"bucket_accumulate has no CUDA kernel for {cs.name}")
    return kernel


def _variant(table: dict, op: str, cs) -> build.Kernel:
    kernel = table.get((cs.kind, cs.field.name, cs.const))
    if kernel is None:
        raise NotImplementedError(f"{op} has no CUDA kernel for {cs.name}")
    return kernel


def sum_kernel_for(cs) -> build.Kernel:
    """The ``pt_bucket_sum`` kernel of curve ``cs``; raises if there is none."""
    return _variant(_SUM_VARIANTS, "pt_bucket_sum", cs)


def close_kernel_for(cs) -> build.Kernel:
    """The ``pt_bucket_close`` kernel of curve ``cs``; raises if there is none."""
    return _variant(_CLOSE_VARIANTS, "pt_bucket_close", cs)


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


def bucket_lists(digits: torch.Tensor, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The stable counting sort of each window's digits (..., m, nw): order
    (..., nw, m), the points 0..m-1 by digit, each digit's run in
    increasing j; starts (..., nw, 2**window + 1), digit e's run at
    order[..., w, starts[..., w, e] : starts[..., w, e + 1]].  Leading axes
    are digit blocks (a convoy), each sorted on its own.  Both int32, on
    the digits' device."""
    d = digits.transpose(-1, -2).long()
    order = torch.sort(d, dim=-1, stable=True).indices.to(torch.int32)
    counts = torch.zeros(d.shape[:-1] + (1 << window,), dtype=torch.int64, device=d.device)
    counts.scatter_add_(-1, d, torch.ones_like(d))
    starts = torch.nn.functional.pad(counts.cumsum(-1), (1, 0)).to(torch.int32)
    return order.contiguous(), starts.contiguous()


def pt_bucket_sum_plain(cs, points: torch.Tensor, order: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Buckets 1 .. 2**c - 1 from the sorted lists: every bucket of every
    row takes the r-th point of its list at step r, from the identity
    (``pt_add_plain(acc, P_j)``, acc first), as many steps as the longest
    list, a bucket whose list has ended keeping its sum.  order (..., nw,
    m) and starts (..., nw, 2**c + 1) with leading digit-block axes K...;
    points (K..., B..., m, C, L) -> (K..., B..., nw, 2**c - 1, C, L), the
    rows B... of block k read through block k's lists."""
    lead = order.shape[:-2]
    nw, m = order.shape[-2:]
    tail = points.shape[-2:]
    rows = points.shape[len(lead):-3]
    kb, nrows = lead.numel(), rows.numel()
    first = starts[..., 1:-1].long().reshape(kb, nw, -1)  # buckets 1 .. nb
    nb = first.shape[-1]
    count = starts[..., 2:].long().reshape(kb, nw, nb) - first
    flat_order = order.long().reshape(kb, nw, m)
    pts = points.reshape((kb, nrows, m) + tail)
    acc = pk.identity_plain(cs, (kb, nrows, nw * nb), points.device)
    live = count.reshape(kb, 1, nw * nb)
    for r in range(int(count.max()) if count.numel() else 0):
        j = torch.gather(flat_order, 2, (first + r).clamp(max=max(m - 1, 0))).reshape(kb, 1, nw * nb)
        idx = j[..., None, None].expand((kb, nrows, nw * nb) + tail)
        new = pk.pt_add_plain(cs, acc, torch.gather(pts, 2, idx))
        acc = torch.where((r < live)[..., None, None], new, acc)
    return acc.reshape(lead + rows + (nw, nb) + tail).contiguous()


def _strided_points(t: torch.Tensor, lead: int) -> torch.Tensor:
    """``t`` (..., ``lead`` axes, C, L) with its batch axes flattened into
    one, a view where they allow it; copied where a point's limbs are not
    contiguous or not on 16 bytes (the kernels load four limbs at a time)."""
    r = t.reshape((-1,) + t.shape[t.dim() - lead - 2:])
    C, L = r.shape[-2:]
    if r.stride(-1) != 1 or r.stride(-2) != L or r.data_ptr() % 16 or any(s % 4 for s in r.stride()):
        r = build.aligned(r.contiguous())
    return r


def pt_bucket_sum(cs, points: torch.Tensor, digits: torch.Tensor, window: int) -> torch.Tensor:
    """Buckets 1 .. 2**window - 1 of every window: points (..., m, C, L),
    digits (m, nw) shared by every batch row -> (..., nw, 2**window - 1, C,
    L), bucket e of window w the sum from the identity, in order of j, of
    the points whose window-w digit is e (``bucket_accumulate``'s bucket e,
    limb for limb).  Digits (K..., m, nw) are a convoy of digit blocks:
    points (K..., B..., m, C, L), block k's digits shared by the rows B...
    of its ceremony.  One launch either way, the points read where they lie
    (the ceremony's (m, B) layout through strides); the result is a view of
    the kernel's (nw, 2**window - 1, rows, C, L)."""
    if window not in WINDOWS:
        raise ValueError(f"pt_bucket_sum takes a window of {WINDOWS}, got {window}")
    lead = digits.shape[:-2]
    if digits.dim() < 2 or points.dim() < len(lead) + 3 or points.shape[:len(lead)] != lead:
        raise ValueError(f"pt_bucket_sum takes digits (m, nw) shared by the batch, or a convoy of blocks "
                         f"(K..., m, nw) over points (K..., B..., m, C, L), got {tuple(digits.shape)} "
                         f"and points {tuple(points.shape)}")
    if points.device.type == "cpu":
        return pt_bucket_sum_plain(cs, points, *bucket_lists(digits, window))
    kernel = sum_kernel_for(cs)
    point = (cs.ncoords, cs.field.limbs)
    m, nw = points.shape[-3], digits.shape[-1]
    dev = build.check_operands([(points, (m,) + point), (digits, (m, nw))])
    batch, nb = points.shape[:-3], (1 << window) - 1
    pts = _strided_points(points, 1)
    rows = pts.shape[0]
    out = torch.empty((nw, nb, rows) + point, dtype=torch.int32, device=dev)
    if out.numel():
        order, starts = bucket_lists(digits, window)
        kernel(pts.data_ptr(), pts.stride(0), pts.stride(1), order.data_ptr(), starts.data_ptr(), out.data_ptr(),
               rows, m, nw, nb, max(1, lead.numel()), build.stream_ptr(dev),
               route="convoy" if lead.numel() > 1 else None)
    return out.movedim(2, 0).reshape(batch + (nw, nb) + point)


def pt_bucket_close_plain(cs, buckets: torch.Tensor) -> torch.Tensor:
    """The JAX package's bucket close: from the identity, for e = nb .. 1,
    ``run = run + B_e; tot = tot + run`` (the plain add), every (row,
    window) at once.  buckets (..., nw, nb, C, L) -> (..., nw, C, L)."""
    run = tot = pk.identity_plain(cs, buckets.shape[:-3], buckets.device)
    for e in reversed(range(buckets.shape[-3])):
        run = pk.pt_add_plain(cs, run, buckets[..., e, :, :])
        tot = pk.pt_add_plain(cs, tot, run)
    return tot


def pt_bucket_close(cs, buckets: torch.Tensor) -> torch.Tensor:
    """Σ_e e·B_e of every window in one launch: buckets (..., nw, nb, C,
    L), bucket e at index e - 1 and nb = 2**c - 1 (pt_bucket_sum's view,
    or bucket_accumulate's buckets from 1 on), read through strides ->
    (..., nw, C, L), equal to :func:`pt_bucket_close_plain`."""
    if buckets.device.type == "cpu":
        return pt_bucket_close_plain(cs, buckets)
    kernel = close_kernel_for(cs)
    point = (cs.ncoords, cs.field.limbs)
    if buckets.dim() < 4:
        raise ValueError(f"kernel operand of shape {tuple(buckets.shape)} does not end in (nw, nb) + {point}")
    nw, nb = buckets.shape[-4:-2]
    if nb + 1 not in tuple(1 << w for w in WINDOWS):
        raise ValueError(f"pt_bucket_close takes 2**c - 1 buckets a window (c in {WINDOWS}), got {nb}")
    dev = build.check_operands([(buckets, (nw, nb) + point)])
    batch = buckets.shape[:-4]
    src = _strided_points(buckets, 2)
    rows = src.shape[0]
    out = torch.empty((rows, nw) + point, dtype=torch.int32, device=dev)
    if out.numel():
        kernel(src.data_ptr(), src.stride(0), src.stride(1), src.stride(2), out.data_ptr(), rows, nw, nb,
               build.stream_ptr(dev))
    return out.reshape(batch + (nw,) + point)
