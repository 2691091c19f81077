"""Batched BLAKE2b (RFC 7693) over numpy u64 lanes: the hybrid
encryption's KDF.

Counterpart of ``dkg_tpu/crypto/blake2.py``, the same digests.  The KDF
hashes one fixed-length KEM-point encoding per (dealer, recipient) pair;
here the compression function runs over a word-major ``(16, N)``-u64
message batch, one contiguous numpy op per step of the mixing function
for the whole round.
``hashlib.blake2b`` is the oracle the tests hold it to, and
:func:`kdf_batch` is the array twin of
``crypto.elgamal.keystream_from_kem_bytes``.

Scope: unkeyed, unsalted, sequential mode; digest size and
personalisation are the only parameters, and every row of a batch has
one message length.
"""

from __future__ import annotations

import numpy as np

_IV = np.array(
    [
        0x6A09E667F3BCC908,
        0xBB67AE8584CAA73B,
        0x3C6EF372FE94F82B,
        0xA54FF53A5F1D36F1,
        0x510E527FADE682D1,
        0x9B05688C2B3E6C1F,
        0x1F83D9ABFB41BD6B,
        0x5BE0CD19137E2179,
    ],
    dtype=np.uint64,
)

_SIGMA = (
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
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
)


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint64(n)) | (x << np.uint64(64 - n))


def _g(v: np.ndarray, a: int, b: int, c: int, d: int, x: np.ndarray, y: np.ndarray) -> None:
    """RFC 7693 §3.1 mixing function G on the (16, N) u64 work vector."""
    v[a] += v[b] + x
    v[d] = _rotr(v[d] ^ v[a], 32)
    v[c] += v[d]
    v[b] = _rotr(v[b] ^ v[c], 24)
    v[a] += v[b] + y
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] += v[d]
    v[b] = _rotr(v[b] ^ v[c], 63)


def _compress(h: np.ndarray, m: np.ndarray, t: int, last: bool) -> None:
    """RFC 7693 §3.2 compression F, in place on ``h`` ((8, N) u64); ``m``
    is the (16, N) u64 message block batch, ``t`` the byte offset counter
    (shared by all rows: equal-length messages)."""
    v = np.empty((16, h.shape[1]), dtype=np.uint64)
    v[:8] = h
    v[8:] = _IV[:, None]
    v[12] ^= np.uint64(t & 0xFFFFFFFFFFFFFFFF)
    v[13] ^= np.uint64(t >> 64)
    if last:
        v[14] = ~v[14]
    for s in _SIGMA:
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    h ^= v[:8] ^ v[8:]


# Rows hashed a pass: a block's word-major state stays in the CPU's cache
# (one pass over a million rows ran 2-4x slower than passes of 16,384).
ROW_BLOCK = 1 << 14


def blake2b_batch(
    msgs: np.ndarray, digest_size: int = 64, person: bytes = b""
) -> np.ndarray:
    """BLAKE2b over each row of ``msgs`` (``(N, mlen)`` u8): returns
    ``(N, digest_size)`` u8, row i == ``hashlib.blake2b(bytes(msgs[i]),
    digest_size=digest_size, person=person).digest()``.
    """
    if not 1 <= digest_size <= 64:
        raise ValueError("digest_size must be 1..64")
    if len(person) > 16:
        raise ValueError("person must be <= 16 bytes")
    msgs = np.ascontiguousarray(np.atleast_2d(msgs), dtype=np.uint8)
    out = np.empty((msgs.shape[0], digest_size), dtype=np.uint8)
    for i in range(0, msgs.shape[0], ROW_BLOCK):
        out[i : i + ROW_BLOCK] = _blake2b_rows(msgs[i : i + ROW_BLOCK], digest_size, person)
    return out


def _blake2b_rows(msgs: np.ndarray, digest_size: int, person: bytes) -> np.ndarray:
    """:func:`blake2b_batch` over one block of rows."""
    n, mlen = msgs.shape
    h = np.repeat(_IV[:, None], n, axis=1)
    # parameter block (RFC 7693 §2.5): digest_length | key_length<<8 |
    # fanout<<16 | depth<<24 in word 0, personal in words 6-7
    h[0] ^= np.uint64(digest_size | 0x01010000)
    pers = np.frombuffer(person.ljust(16, b"\0"), dtype="<u8")
    h[6] ^= pers[0]
    h[7] ^= pers[1]
    nblocks = max(1, (mlen + 127) // 128)
    padded = np.zeros((n, nblocks * 128), dtype=np.uint8)
    padded[:, :mlen] = msgs
    words = padded.view("<u8").astype(np.uint64).reshape(n, nblocks, 16)
    with np.errstate(over="ignore"):
        for b in range(nblocks):
            last = b == nblocks - 1
            _compress(h, np.ascontiguousarray(words[:, b].T), mlen if last else (b + 1) * 128, last)
    return np.ascontiguousarray(h.T.astype("<u8")).view(np.uint8)[:, :digest_size]


def kdf_batch(kem_enc: np.ndarray, person: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Array twin of ``crypto.elgamal.keystream_from_kem_bytes``:
    ``(N, enc_len)`` u8 KEM-point encodings -> (``(N, 32)`` u8 ChaCha
    keys, ``(N, 12)`` u8 nonces), one lane per (dealer, recipient) pair.
    """
    digest = blake2b_batch(kem_enc, digest_size=64, person=person)
    return digest[:, :32], digest[:, 32:44]
