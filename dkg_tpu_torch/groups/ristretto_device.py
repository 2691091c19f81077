"""Batched ristretto255 encode and decode on limb tensors (RFC 9496
§4.3.1-.2).

Counterpart of ``dkg_tpu/groups/ristretto_device.py``: a whole tensor of
extended Edwards points compresses (or a tensor of candidate encodings
decompresses) without a branch, the inverse square root by the public
power (p - 5)/8, the sign fixes by selects.  Every field product is one
``mod_mul`` launch (``ops/field_kernels.py``; its plain version on CPU
tensors), so an encode is 526 launches whatever the batch: the
exponent's 251 squarings and 250 multiplies and 25 more.  The adds,
subtractions and selects are plain tensor ops, as the JAX package leaves
them to XLA.  The results equal the host's RFC 9496 oracle
(``groups/host.py``) lane for lane.
"""

from __future__ import annotations

import torch

from ..fields import device as fd
from ..fields.spec import P25519
from ..ops import field_kernels as fk
from . import host as gh

F = P25519


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fk.mod_mul(F, a, b)


def _c(v: int, like: torch.Tensor) -> torch.Tensor:
    return fd.constant(F, v, device=like.device)


def _is_odd(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 0] & 1) != 0


def _abs(x: torch.Tensor) -> torch.Tensor:
    """The non-negative (even) representative: negate when odd."""
    return fd.select(_is_odd(x), fd.neg(F, x), x)


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched SQRT_RATIO_M1 (RFC 9496 §4.2): (was_square, root)."""
    v2 = _mul(v, v)
    v3 = _mul(v2, v)
    v7 = _mul(_mul(v3, v3), v)
    uv3 = _mul(u, v3)
    uv7 = _mul(u, v7)
    r = _mul(uv3, fd.pow_const(F, uv7, (gh.P - 5) // 8, mul=fk.mod_mul))
    check = _mul(v, _mul(r, r))
    u_neg = fd.neg(F, u)
    correct = fd.eq(check, u)
    flipped = fd.eq(check, u_neg)
    flipped_i = fd.eq(check, _mul(u_neg, _c(gh.SQRT_M1, u)))
    r = fd.select(flipped | flipped_i, _mul(r, _c(gh.SQRT_M1, u)), r)
    return correct | flipped, _abs(r)


def ristretto_encode_batch(pts: torch.Tensor) -> torch.Tensor:
    """(..., 4, L) extended Edwards points -> (..., L) canonical s limbs
    (all zero for the identity, whichever representative)."""
    x0, y0, z0, t0 = pts.unbind(-2)
    u1 = _mul(fd.add(F, z0, y0), fd.sub(F, z0, y0))
    u2 = _mul(x0, y0)
    one = fd.ones(F, u1.shape[:-1], device=pts.device)
    _, invsqrt = sqrt_ratio_m1(one, _mul(u1, _mul(u2, u2)))
    den1 = _mul(invsqrt, u1)
    den2 = _mul(invsqrt, u2)
    z_inv = _mul(_mul(den1, den2), t0)
    ix0 = _mul(x0, _c(gh.SQRT_M1, pts))
    iy0 = _mul(y0, _c(gh.SQRT_M1, pts))
    enchanted = _mul(den1, _c(gh.INVSQRT_A_MINUS_D, pts))
    rotate = _is_odd(_mul(t0, z_inv))
    x = fd.select(rotate, iy0, x0)
    y = fd.select(rotate, ix0, y0)
    den_inv = fd.select(rotate, enchanted, den2)
    y = fd.select(_is_odd(_mul(x, z_inv)), fd.neg(F, y), y)
    return _abs(_mul(den_inv, fd.sub(F, z0, y)))


def ristretto_decode_batch(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., L) candidate s limbs -> ((..., 4, L) points, (...,) valid).

    An invalid encoding (s >= p, s odd, not a square, t odd or y = 0)
    gives valid = False and a point lane the caller must mask, as in the
    JAX package; a non-canonical lane is decoded from s = 0 so that no
    multiply sees limbs at or above p."""
    p_minus_1 = _c(gh.P - 1, s).expand(s.shape)
    _, borrow = fd.sub_with_borrow(p_minus_1.to(torch.int64), s.to(torch.int64))  # s <= p - 1
    canonical = (borrow == 0) & ~_is_odd(s)
    s = fd.select(canonical, s, torch.zeros_like(s))

    one = fd.ones(F, s.shape[:-1], device=s.device)
    ss = _mul(s, s)
    u1 = fd.sub(F, one, ss)  # 1 - s^2
    u2 = fd.add(F, one, ss)  # 1 + s^2
    u2_sqr = _mul(u2, u2)
    v = fd.sub(F, fd.neg(F, _mul(_c(gh.D, s), _mul(u1, u1))), u2_sqr)  # -(d u1^2) - u2^2
    was_square, invsqrt = sqrt_ratio_m1(one, _mul(v, u2_sqr))
    den_x = _mul(invsqrt, u2)
    den_y = _mul(_mul(invsqrt, den_x), v)
    x = _abs(_mul(fd.add(F, s, s), den_x))
    y = _mul(u1, den_y)
    t = _mul(x, y)
    valid = canonical & was_square & ~_is_odd(t) & ~fd.is_zero(y)
    return torch.stack([x, y, one, t], dim=-2), valid


def limbs_to_bytes_u8(s: torch.Tensor, nbytes: int = 32) -> torch.Tensor:
    """(..., L) 16-bit limbs -> (..., nbytes) uint8, little-endian."""
    inter = torch.stack([s & 0xFF, (s >> 8) & 0xFF], dim=-1).to(torch.uint8)
    return inter.reshape(s.shape[:-1] + (2 * s.shape[-1],))[..., :nbytes]
