"""The transcript's BLAKE2s Merkle tree (RFC 7693 compression), numpy u32.

Counterpart of ``dkg_tpu/crypto/blake2s.py`` (``row_digests_np``,
``tree_digest_np``) with its own copy of the tree-mode constants of
``dkg_tpu/crypto/device_hash.py``, whose module docstring specifies the
construction:

* words zero-padded to 16-word blocks, the block count to a power of two;
* leaf i: one compression of block i, h = IV ^ params(node_depth 0),
  t = 64·i, f0 = -1;
* interior: compression of (left || right), h = IV ^ params(node_depth 1),
  t = level, f0 = -1;
* root: one compression of (top || word count, domain, 0...), t = 0.

The digests equal the JAX package's bit for bit.  Inside, the state is
kept word-major, ``(16, N)``, so every step of the mixing function is one
contiguous array op over all N compressions of a tree level.
"""

from __future__ import annotations

import numpy as np

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

# RFC 7693 §2.5 parameter words.  Word 0: digest_length=32 (byte 0),
# key_length=0 (byte 1), fanout=2 (byte 2), depth=255 (byte 3).
# Word 3: node_depth (byte 14 -> bits 16..23) 0 for leaves / 1 for
# interior+root, inner_length=32 (byte 15 -> bits 24..31).
P_WORD0 = 0xFF020020
P3_LEAF = 32 << 24
P3_NODE = (1 << 16) | (32 << 24)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

MASK32 = 0xFFFFFFFF


def _rotr(x: np.ndarray, n: int, tmp: np.ndarray) -> None:
    """x <- x rotated right by n, in place (``tmp`` a scratch array)."""
    np.left_shift(x, np.uint32(32 - n), out=tmp)
    np.right_shift(x, np.uint32(n), out=x)
    np.bitwise_or(x, tmp, out=x)


def _g(v: list, a: int, b: int, c: int, d: int, x: np.ndarray, y: np.ndarray, tmp: np.ndarray) -> None:
    """RFC 7693 §3.1 mixing function G (BLAKE2s rotations 16/12/8/7) on
    the 16 state words, each an (N,) u32 array, in place."""
    va, vb, vc, vd = v[a], v[b], v[c], v[d]
    np.add(va, vb, out=va)
    np.add(va, x, out=va)
    np.bitwise_xor(vd, va, out=vd)
    _rotr(vd, 16, tmp)
    np.add(vc, vd, out=vc)
    np.bitwise_xor(vb, vc, out=vb)
    _rotr(vb, 12, tmp)
    np.add(va, vb, out=va)
    np.add(va, y, out=va)
    np.bitwise_xor(vd, va, out=vd)
    _rotr(vd, 8, tmp)
    np.add(vc, vd, out=vc)
    np.bitwise_xor(vb, vc, out=vb)
    _rotr(vb, 7, tmp)


def _compress(h: np.ndarray, m: np.ndarray, t) -> np.ndarray:
    """BLAKE2s compression F with f0 = -1, word-major: ``h`` (8, N),
    ``m`` (16, N), ``t`` a scalar or (N,) -> (8, N).  All u32; t_hi is 0
    (every chunk is shorter than 2**32 bytes)."""
    n = m.shape[1]
    v = [np.broadcast_to(h[i], (n,)).copy() for i in range(8)]
    v += [np.full(n, IV[i], np.uint32) for i in range(8)]
    tmp = np.empty(n, np.uint32)
    with np.errstate(over="ignore"):
        v[12] ^= np.asarray(t, np.uint32)
        v[14] ^= np.uint32(MASK32)
        for s in SIGMA:
            _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]], tmp)
            _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]], tmp)
            _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]], tmp)
            _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]], tmp)
            _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]], tmp)
            _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]], tmp)
            _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]], tmp)
            _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]], tmp)
    return np.stack([h[i] ^ v[i] ^ v[i + 8] for i in range(8)])


def _h_init(p3: int) -> np.ndarray:
    h = np.asarray(IV, np.uint32).copy()
    h[0] ^= np.uint32(P_WORD0)
    h[3] ^= np.uint32(p3)
    return h[:, None]  # (8, 1): broadcast over the lanes


def row_digests_np(words: np.ndarray, domain: int = 0) -> np.ndarray:
    """Independent Merkle digest per row: (R, W) uint32 -> (R, 8) uint32.
    Every tree level is one compression over all of its nodes in all rows."""
    words = np.ascontiguousarray(words, np.uint32)
    r, w = words.shape
    nl = max(1, -(-w // 16))
    nl_pow2 = 1 << (nl - 1).bit_length()
    padded = np.zeros((r, nl_pow2 * 16), np.uint32)
    padded[:, :w] = words
    blocks = np.ascontiguousarray(padded.reshape(r * nl_pow2, 16).T)  # (16, r * nl_pow2)
    t_leaf = np.tile(np.arange(nl_pow2, dtype=np.uint32) * 64, r)
    h = _compress(_h_init(P3_LEAF), blocks, t_leaf)  # (8, r * nl_pow2), row-major nodes
    level = 1
    while h.shape[1] > r:
        pairs = np.concatenate([h[:, 0::2], h[:, 1::2]])  # (16, nodes / 2)
        h = _compress(_h_init(P3_NODE), pairs, level)
        level += 1
    tail = np.zeros((8, r), np.uint32)
    tail[0] = np.uint32(w & MASK32)
    tail[1] = np.uint32(domain & MASK32)
    root = _compress(_h_init(P3_NODE), np.concatenate([h, tail]), 0)
    return np.ascontiguousarray(root.T)


def tree_digest_np(words, domain: int = 0) -> np.ndarray:
    """Merkle digest of any uint32 array's words -> (8,) uint32."""
    flat = np.asarray(words, np.uint32).reshape(1, -1)
    return row_digests_np(flat, domain)[0]
