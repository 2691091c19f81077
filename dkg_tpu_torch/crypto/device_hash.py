"""The transcript's BLAKE2s Merkle tree where the tensors live.

Counterpart of the device leg of ``dkg_tpu/crypto/device_hash.py``
(``_compress``, ``_h_init``, ``_pad_blocks``, the tree from words,
``row_digests``, ``tree_digest``), as PyTorch tensor ops: on the card the
round-1 tensors are hashed there and only the ``(R, 8)`` row digests
cross to the host.  The construction (leaves, interior nodes, root; its
constants from ``crypto/blake2s.py``) is the one ``crypto/blake2s.py``
documents, and the digests equal its host leg ``row_digests_np`` bit for
bit.

PyTorch has no uint32 type on the card, so words are int32 tensors holding
the uint32 bits: an add wraps modulo 2**32 as uint32 arithmetic does, a
right shift is arithmetic and is masked, and the rotations by 16 and by 8
move whole int16 halves and bytes (one copy each).  A compression runs the
ten rounds over a word-major state, four ``(4, N)`` quarters (rows a, b,
c, d), each half-round one G over four columns at once and the diagonals
as rolls of the quarters, as the JAX package vectorises it.  The JAX
package runs this tree in XLA, not in Pallas: it is plain tensor code here
too.
"""

from __future__ import annotations

import numpy as np
import torch

from .blake2s import IV, MASK32, P3_LEAF, P3_NODE, P_WORD0, SIGMA

# each round's message words in the order the four G steps take them:
# columns' x, columns' y, diagonals' x, diagonals' y
_ORDER = [s[0:8:2] + s[1:8:2] + s[8:16:2] + s[9:16:2] for s in SIGMA]
_INDEX: dict = {}  # device -> (10, 16) int64 message indices


def _index(device: torch.device) -> torch.Tensor:
    if device not in _INDEX:
        _INDEX[device] = torch.tensor(_ORDER, dtype=torch.int64, device=device)
    return _INDEX[device]


def _i32(v: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    v &= MASK32
    return v - (1 << 32) if v >> 31 else v


def _ror(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate int32 words (uint32 bits) right by n: the arithmetic right
    shift masked to its 32 - n low bits."""
    return ((x >> n) & ((1 << (32 - n)) - 1)) | (x << (32 - n))


def _ror16(x: torch.Tensor) -> torch.Tensor:
    """Rotate right by 16: swap each word's int16 halves (little-endian)."""
    return x.view(torch.int16).unflatten(-1, (-1, 2)).flip(-1).flatten(-2).view(torch.int32)


def _ror8(x: torch.Tensor) -> torch.Tensor:
    """Rotate right by 8: each word's bytes one place down (little-endian)."""
    return x.view(torch.uint8).unflatten(-1, (-1, 4)).roll(-1, -1).flatten(-2).view(torch.int32)


def _g(a, b, c, d, x, y):
    """RFC 7693 mixing function G (rotations 16, 12, 8, 7) on four columns
    of int32 words; adds wrap modulo 2**32."""
    a = a + b + x
    d = _ror16(d ^ a)
    c = c + d
    b = _ror(b ^ c, 12)
    a = a + b + y
    d = _ror8(d ^ a)
    c = c + d
    b = _ror(b ^ c, 7)
    return a, b, c, d


def _compress(h: torch.Tensor, m: torch.Tensor, t, f0: int = MASK32) -> torch.Tensor:
    """Batched BLAKE2s compression: h (..., 8), m (..., 16), t an int or a
    tensor of the batch shape -> (..., 8); int32 tensors of uint32 bits."""
    t = torch.as_tensor(t, dtype=torch.int32, device=m.device)
    batch = torch.broadcast_shapes(h.shape[:-1], m.shape[:-1], t.shape)
    n = int(np.prod(batch, dtype=np.int64))
    hw = h.expand(batch + (8,)).reshape(n, 8).T  # word-major (8, n)
    mw = m.expand(batch + (16,)).reshape(n, 16).T.contiguous()
    iv = torch.tensor([_i32(v) for v in IV], dtype=torch.int32, device=m.device)[:, None]
    a, b = hw[0:4], hw[4:8]
    c, d = iv[0:4].expand(4, n), iv[4:8].expand(4, n).clone()
    d[0] ^= t.expand(batch).reshape(n)  # v[12] ^= t (t < 2**31: t_hi is 0)
    d[2] ^= _i32(f0)  # v[14] ^= f0
    idx = _index(m.device)
    for r in range(10):
        ms = mw[idx[r]]  # (16, n)
        a, b, c, d = _g(a, b, c, d, ms[0:4], ms[4:8])
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)  # diagonals
        a, b, c, d = _g(a, b, c, d, ms[8:12], ms[12:16])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    out = hw ^ torch.cat([a, b]) ^ torch.cat([c, d])
    return out.T.reshape(batch + (8,))


def _h_init(p3: int, batch: tuple, device) -> torch.Tensor:
    h = list(IV)
    h[0] ^= P_WORD0
    h[3] ^= p3
    return torch.tensor([_i32(v) for v in h], dtype=torch.int32, device=device).expand(tuple(batch) + (8,))


def _pad_blocks(words: torch.Tensor) -> torch.Tensor:
    """(..., W) words -> (..., NL, 16) blocks, NL a power of two."""
    w = words.shape[-1]
    nl = max(1, -(-w // 16))
    nl_pow2 = 1 << (nl - 1).bit_length()
    words = torch.nn.functional.pad(words, (0, nl_pow2 * 16 - w))
    return words.reshape(words.shape[:-1] + (nl_pow2, 16))


def _tree_from_words(words: torch.Tensor, domain: int) -> torch.Tensor:
    """(R, W) int32 words -> (R, 8) int32 root digests: one compression over
    every leaf of every row, one per level above, one root."""
    r, w = words.shape
    dev = words.device
    blocks = _pad_blocks(words)  # (R, NL, 16)
    nl = blocks.shape[-2]
    t_leaf = torch.arange(nl, dtype=torch.int32, device=dev) * 64
    h = _compress(_h_init(P3_LEAF, (r, nl), dev), blocks, t_leaf[None, :])
    level = 1
    while h.shape[-2] > 1:
        pairs = h.reshape(r, h.shape[-2] // 2, 16)
        h = _compress(_h_init(P3_NODE, pairs.shape[:-1], dev), pairs, level)
        level += 1
    tail = torch.zeros((r, 8), dtype=torch.int32, device=dev)
    tail[:, 0] = _i32(w)
    tail[:, 1] = _i32(domain)
    return _compress(_h_init(P3_NODE, (r,), dev), torch.cat([h[:, 0, :], tail], dim=-1), 0)


def _words(tensor: torch.Tensor) -> torch.Tensor:
    """Any integer tensor of uint32 values as int32 words with the same bits
    (an int32 limb tensor as it is; int64 words >= 2**31 to their two's
    complement)."""
    if tensor.dtype == torch.int32:
        return tensor
    return (tensor.to(torch.int64) & MASK32).sub_(((tensor.to(torch.int64) >> 31) & 1) << 32).to(torch.int32)


def _uint32(digests: torch.Tensor) -> torch.Tensor:
    """int32 digest words as int64 tensors of their uint32 values."""
    return digests.to(torch.int64) & MASK32


def row_digests(tensor: torch.Tensor, domain: int = 0) -> torch.Tensor:
    """Independent Merkle digest per row: (R, ...) -> (R, 8) int64 tensor of
    uint32 values, on the tensor's device."""
    return _uint32(_tree_from_words(_words(tensor).reshape(tensor.shape[0], tensor[0].numel()), domain))


def tree_digest(tensor: torch.Tensor, domain: int = 0) -> torch.Tensor:
    """Merkle digest of all of a tensor's words -> (8,) int64 tensor."""
    return _uint32(_tree_from_words(_words(tensor).reshape(1, tensor.numel()), domain))[0]


def to_numpy(digests: torch.Tensor) -> np.ndarray:
    """Digests as the host leg gives them: uint32 numpy."""
    return digests.cpu().numpy().astype(np.uint32)
