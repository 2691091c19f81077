"""The transcript's BLAKE2s Merkle tree where the tensors live.

Counterpart of the device leg of ``dkg_tpu/crypto/device_hash.py``
(``_compress``, ``_h_init``, ``_pad_blocks``, the tree from words,
``row_digests``, ``tree_digest``), as PyTorch tensor ops: on the card the
round-1 tensors are hashed there and only the ``(R, 8)`` row digests
cross to the host.  The construction (leaves, interior nodes, root; its
constants from ``crypto/blake2s.py``) is the one ``crypto/blake2s.py``
documents, and the digests equal its host leg ``row_digests_np`` bit for
bit.

PyTorch has no uint32 shifts on the card and an int32 ``>>`` is
arithmetic, so words are int64 tensors holding uint32 values, masked to
32 bits after every add and rotate.  A compression runs the ten rounds
over a word-major state, four ``(4, N)`` quarters (rows a, b, c, d), each
half-round one G over four columns at once and the diagonals as rolls of
the quarters, as the JAX package vectorises it.  The JAX package runs
this tree in XLA, not in Pallas: it is plain tensor code here too.
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


def _ror(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) | ((x << (32 - n)) & MASK32)


def _g(a, b, c, d, x, y):
    """RFC 7693 mixing function G (rotations 16, 12, 8, 7) on four columns."""
    a = (a + b + x) & MASK32
    d = _ror(d ^ a, 16)
    c = (c + d) & MASK32
    b = _ror(b ^ c, 12)
    a = (a + b + y) & MASK32
    d = _ror(d ^ a, 8)
    c = (c + d) & MASK32
    b = _ror(b ^ c, 7)
    return a, b, c, d


def _compress(h: torch.Tensor, m: torch.Tensor, t, f0: int = MASK32) -> torch.Tensor:
    """Batched BLAKE2s compression: h (..., 8), m (..., 16), t an int or a
    tensor of the batch shape -> (..., 8); int64 tensors of uint32 values."""
    t = torch.as_tensor(t, dtype=torch.int64, device=m.device)
    batch = torch.broadcast_shapes(h.shape[:-1], m.shape[:-1], t.shape)
    n = int(np.prod(batch, dtype=np.int64))
    hw = h.expand(batch + (8,)).reshape(n, 8).T  # word-major (8, n)
    mw = m.expand(batch + (16,)).reshape(n, 16).T.contiguous()
    iv = torch.tensor(IV, dtype=torch.int64, device=m.device)[:, None]
    a, b = hw[0:4], hw[4:8]
    c, d = iv[0:4].expand(4, n), iv[4:8].expand(4, n).clone()
    d[0] ^= t.expand(batch).reshape(n)  # v[12] ^= t (t < 2**32: t_hi is 0)
    d[2] ^= f0  # v[14] ^= f0
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
    h = np.asarray(IV, np.int64)
    h[0] ^= P_WORD0
    h[3] ^= p3
    return torch.from_numpy(h).to(device).expand(tuple(batch) + (8,))


def _pad_blocks(words: torch.Tensor) -> torch.Tensor:
    """(..., W) words -> (..., NL, 16) blocks, NL a power of two."""
    w = words.shape[-1]
    nl = max(1, -(-w // 16))
    nl_pow2 = 1 << (nl - 1).bit_length()
    words = torch.nn.functional.pad(words, (0, nl_pow2 * 16 - w))
    return words.reshape(words.shape[:-1] + (nl_pow2, 16))


def _tree_from_words(words: torch.Tensor, domain: int) -> torch.Tensor:
    """(R, W) int64 words -> (R, 8) root digests: one compression over
    every leaf of every row, one per level above, one root."""
    r, w = words.shape
    dev = words.device
    blocks = _pad_blocks(words)  # (R, NL, 16)
    nl = blocks.shape[-2]
    t_leaf = torch.arange(nl, dtype=torch.int64, device=dev) * 64
    h = _compress(_h_init(P3_LEAF, (r, nl), dev), blocks, t_leaf[None, :])
    level = 1
    while h.shape[-2] > 1:
        pairs = h.reshape(r, h.shape[-2] // 2, 16)
        h = _compress(_h_init(P3_NODE, pairs.shape[:-1], dev), pairs, level)
        level += 1
    tail = torch.zeros((r, 8), dtype=torch.int64, device=dev)
    tail[:, 0] = w & MASK32
    tail[:, 1] = domain & MASK32
    return _compress(_h_init(P3_NODE, (r,), dev), torch.cat([h[:, 0, :], tail], dim=-1), 0)


def _words(tensor: torch.Tensor) -> torch.Tensor:
    """Any integer tensor as int64 words holding its uint32 values (an
    int32 limb tensor holds them as they are; int32 words >= 2**31 come
    back from their two's complement)."""
    return tensor.to(torch.int64) & MASK32


def row_digests(tensor: torch.Tensor, domain: int = 0) -> torch.Tensor:
    """Independent Merkle digest per row: (R, ...) -> (R, 8) int64 tensor of
    uint32 values, on the tensor's device."""
    return _tree_from_words(_words(tensor).reshape(tensor.shape[0], tensor[0].numel()), domain)


def tree_digest(tensor: torch.Tensor, domain: int = 0) -> torch.Tensor:
    """Merkle digest of all of a tensor's words -> (8,) int64 tensor."""
    return _tree_from_words(_words(tensor).reshape(1, tensor.numel()), domain)[0]


def to_numpy(digests: torch.Tensor) -> np.ndarray:
    """Digests as the host leg gives them: uint32 numpy."""
    return digests.cpu().numpy().astype(np.uint32)
