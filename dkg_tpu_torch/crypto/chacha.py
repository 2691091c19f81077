"""ChaCha20 stream cipher (RFC 8439) in numpy, the DEM of the hybrid
share encryption.

Counterpart of ``dkg_tpu/crypto/chacha.py``, the same bytes out.  A
sealed scalar fits one 64-byte keystream block, so a whole dealing round
is one state batch (:func:`chacha20_block_batch`,
:func:`chacha20_xor_batch`); :func:`chacha20_xor` is the per-message
form.  Both run one quarter-round definition (:func:`_quarter` indexes
the leading axis), so they cannot drift.  The batch is kept word-major,
``(16, N)``, so each step of a quarter round is one contiguous array op
over all N states.  The native single-buffer ChaCha20
(``native.chacha20_xor``, which the recipients' opens run) gives the same
bytes.
"""

from __future__ import annotations

import numpy as np

_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter(state: np.ndarray, a: int, b: int, c: int, d: int) -> None:
    """One quarter round on the words ``state[0..15]``: a (16,) state or a
    word-major (16, N) batch."""
    state[a] += state[b]
    state[d] = _rotl(state[d] ^ state[a], 16)
    state[c] += state[d]
    state[b] = _rotl(state[b] ^ state[c], 12)
    state[a] += state[b]
    state[d] = _rotl(state[d] ^ state[a], 8)
    state[c] += state[d]
    state[b] = _rotl(state[b] ^ state[c], 7)


def _double_rounds(working: np.ndarray) -> None:
    """The 10 ChaCha20 double rounds, in place on ``(16, ...)`` u32."""
    for _ in range(10):
        _quarter(working, 0, 4, 8, 12)
        _quarter(working, 1, 5, 9, 13)
        _quarter(working, 2, 6, 10, 14)
        _quarter(working, 3, 7, 11, 15)
        _quarter(working, 0, 5, 10, 15)
        _quarter(working, 1, 6, 11, 12)
        _quarter(working, 2, 7, 8, 13)
        _quarter(working, 3, 4, 9, 14)


def _block(key_words: np.ndarray, counter: int, nonce_words: np.ndarray) -> bytes:
    state = np.concatenate(
        [
            _CONSTANTS,
            key_words,
            np.array([counter], dtype=np.uint32),
            nonce_words,
        ]
    )
    working = state.copy()
    with np.errstate(over="ignore"):
        _double_rounds(working)
        working += state
    return working.astype("<u4").tobytes()


def chacha20_xor(key: bytes, nonce: bytes, data: bytes, counter: int = 0) -> bytes:
    """XOR ``data`` with the ChaCha20 keystream (encrypt == decrypt)."""
    if len(key) != 32:
        raise ValueError("key must be 32 bytes")
    if len(nonce) != 12:
        raise ValueError("nonce must be 12 bytes (IETF variant)")
    key_words = np.frombuffer(key, dtype="<u4").astype(np.uint32)
    nonce_words = np.frombuffer(nonce, dtype="<u4").astype(np.uint32)
    out = bytearray()
    for i in range(0, len(data), 64):
        ks = _block(key_words, counter + i // 64, nonce_words)
        chunk = data[i : i + 64]
        out.extend(b ^ k for b, k in zip(chunk, ks))
    return bytes(out)


# ---------------------------------------------------------------------------
# batched keystreams — N independent (key, nonce) lanes at once
# ---------------------------------------------------------------------------


def chacha20_block_batch(
    key_words: np.ndarray, counters: np.ndarray, nonce_words: np.ndarray
) -> np.ndarray:
    """One keystream block per lane: ``(N, 8)`` u32 keys, ``(N,)`` u32
    counters, ``(N, 3)`` u32 nonces -> ``(N, 64)`` u8 keystream.

    The whole batch is one word-major ``(16, N)``-u32 state array run
    through the shared :func:`_quarter` schedule: the same bits as N calls
    of :func:`_block`.
    """
    n = key_words.shape[0]
    state = np.empty((16, n), dtype=np.uint32)
    state[0:4] = _CONSTANTS[:, None]
    state[4:12] = key_words.T
    state[12] = counters
    state[13:16] = nonce_words.T
    working = state.copy()
    with np.errstate(over="ignore"):
        _double_rounds(working)
        working += state
    return np.ascontiguousarray(working.T.astype("<u4")).view(np.uint8)


# Lanes a pass: a block's (16, lanes) state stays in the CPU's cache (one
# pass over a million lanes ran 2-4x slower than passes of 16,384).
ROW_BLOCK = 1 << 14


def chacha20_xor_batch(
    keys: np.ndarray, nonces: np.ndarray, data: np.ndarray, counter: int = 0
) -> np.ndarray:
    """Batched :func:`chacha20_xor`: each row of ``data`` (``(N, mlen)``
    u8) is XORed with the keystream of its own ``(key, nonce)`` lane
    (``(N, 32)`` / ``(N, 12)`` u8).  Rows are independent messages; all
    share one length, the array shape.  Returns ``(N, mlen)`` u8.
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    nonces = np.ascontiguousarray(nonces, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if keys.ndim != 2 or keys.shape[1] != 32:
        raise ValueError("keys must be (N, 32) bytes")
    if nonces.shape != (keys.shape[0], 12):
        raise ValueError("nonces must be (N, 12) bytes (IETF variant)")
    n, mlen = data.shape
    if n != keys.shape[0]:
        raise ValueError("data rows must match key lanes")
    if mlen == 0:
        return data.copy()
    out = np.empty_like(data)
    for i in range(0, n, ROW_BLOCK):
        rows = slice(i, i + ROW_BLOCK)
        key_words = keys[rows].view("<u4")
        nonce_words = nonces[rows].view("<u4")
        lanes = key_words.shape[0]
        blocks = [
            chacha20_block_batch(
                key_words, np.full(lanes, counter + b, dtype=np.uint32), nonce_words
            )
            for b in range((mlen + 63) // 64)
        ]
        ks = blocks[0] if len(blocks) == 1 else np.concatenate(blocks, axis=1)
        out[rows] = data[rows] ^ ks[:, :mlen]
    return out
