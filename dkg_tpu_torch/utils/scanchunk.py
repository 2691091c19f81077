"""Sequential chunked mapping over one axis.

Counterpart of ``dkg_tpu/utils/scanchunk.py``'s ``map_chunked``: the one
implementation of the "full chunks, then one ragged tail call" loop that
every memory-bounded loop of the port runs (the dealing round's two
passes, the point RLC's columns, the transcript digest's dealer rows,
``eval_many``'s Vandermonde points).  The JAX package runs its chunks
through a sequential ``lax.map`` so that the TPU compiler cannot overlap
their temps; here the loop is the host's, so the chunks run one after
another by construction.

What the TPU version concatenates, this one writes into outputs
allocated once, at the first chunk: each chunk's result is copied into
its slice and dropped, so the peak holds one copy of the output and one
chunk's temps, never the parts and their concatenation together.
"""

from __future__ import annotations

import torch


def map_chunked(total: int, chunk: int | None, call, axis: int = 0):
    """Run ``call(offset, width)`` over ``total`` items in ``chunk``-wide
    sequential pieces, the last one ragged.

    ``call`` returns a tensor or a tuple of tensors whose axis ``axis`` is
    ``width`` long; the result has the same structure with that axis
    ``total`` long.  ``chunk`` None, 0 or >= ``total`` is one direct call,
    whose outputs are returned as they are."""
    if chunk is not None and chunk < 0:
        raise ValueError(f"chunk must be >= 0, got {chunk}")
    if not chunk or chunk >= total:
        return call(0, total)
    outs, single = None, False
    for off in range(0, total, chunk):
        width = min(chunk, total - off)
        part = call(off, width)
        single = isinstance(part, torch.Tensor)
        parts = (part,) if single else tuple(part)
        if outs is None:
            outs = tuple(torch.empty(p.shape[:axis % p.dim()] + (total,) + p.shape[axis % p.dim() + 1:],
                                     dtype=p.dtype, device=p.device) for p in parts)
        for o, p in zip(outs, parts):
            if p.shape[axis] != width:
                raise ValueError(f"map_chunked: a chunk of width {width} returned axis {axis} of {p.shape[axis]}")
            o.narrow(axis, off, width).copy_(p)
        del part, parts
    return outs[0] if single else outs
