"""Batched hybrid share encryption of a dealing round: the KEM on the
card, the DEM on the host; and the recipient's batched opening.

Counterpart of ``dkg_tpu/dkg/hybrid_batch.py``, the same wire bytes.  The
KEM scalar multiplications of every (dealer, recipient) pair run as two
batched device passes (:func:`kem_batch`):

    c1[d, i]  = g·r[d, i]          (fixed-base table, one pt_fixed_base
                                    launch)
    kem[d, i] = pk_i·r[d, i]       (groups.device.scalar_mul, one
                                    pt_scalar_mul launch over the
                                    recipients' tables)

and the byte-level DEM tail is array-shaped (:func:`seal_shares_batch`):
one ``groups.device.encode_batch`` of every KEM point (canonical affine
form where the points are, one transfer), one BLAKE2b batch a tag
(``crypto.blake2.kdf_batch``) and one ChaCha20 state batch a tag
(``crypto.chacha.chacha20_xor_batch``, the numpy batch the JAX package
seals with too).  :func:`seal_shares` is the per-pair reference leg;
both legs give the same bytes.  The per-pair leg and the recipient's
:func:`open_share` run the native single-buffer ChaCha20
(``native.chacha20_xor``) and the opens the native constant-structure
ladder (``groups.host``'s ``scalar_mul``), as the JAX package's do.
:func:`seal_shares_mesh` seals a party mesh rank's dealer block.
:func:`seal_shares_pipeline` chunks KEM and DEM over dealers so the host
DEM of chunk k overlaps the device work of chunk k+1, and
:func:`broadcasts_from_batch` packages a dealing round's commitments and
sealed pairs as the wire protocol's round-1 messages.  The JAX package's
``DKG_TPU_DEM`` and ``DKG_TPU_DEM_CHUNK`` are the ``dem=`` and ``chunk=``
arguments here.

Tensors come in as the JAX package's uint32 arrays through
``fields.host.to_tensor``: recipient keys (n_r, C, L), randomness
(n_d, n_r, L), shares and hidings (n_d, n_r, L); the seals also take
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..crypto.blake2 import kdf_batch
from ..crypto.chacha import chacha20_xor_batch
from ..crypto.elgamal import PERSON_RAND, PERSON_SHARE, HybridCiphertext, keystream_from_kem_bytes
from ..fields import host as fh
from ..groups import device as gd
from .broadcast import BroadcastPhase1, EncryptedShares
from .ceremony import resolve_device

DEM_MODES = ("scalar", "batch")


def kem_batch(cfg, pks_dev: torch.Tensor, r_limbs: torch.Tensor, g_table: torch.Tensor):
    """The KEM of every pair: pks_dev (n_r, C, L) recipient keys, r_limbs
    (..., n_r, L) randomness -> (c1, kem), each (..., n_r, C, L)."""
    cs = cfg.cs
    c1 = gd.fixed_base_mul(cs, g_table, r_limbs)
    kem = gd.scalar_mul(cs, r_limbs, pks_dev)
    return c1, kem


def _host(x) -> np.ndarray:
    """A tensor's uint32 limbs on the host (one transfer); arrays as they are."""
    return fh.from_tensor(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _le_bytes(arr: np.ndarray, nbytes: int) -> np.ndarray:
    """16-bit limb rows (N, L) -> little-endian byte rows (N, nbytes), the
    scalar wire encoding."""
    return np.ascontiguousarray(arr.astype("<u2")).view(np.uint8)[:, :nbytes]


def _host_points(cs, pts: np.ndarray) -> list:
    """Point limbs (N, C, L) -> host point tuples, the ints of
    ``groups.device.to_host``."""
    le = np.ascontiguousarray(pts.astype("<u2")).view(np.uint8)
    return [tuple(int.from_bytes(le[i, c].tobytes(), "little") for c in range(cs.ncoords))
            for i in range(pts.shape[0])]


def seal_shares(group, cfg, shares, hidings, c1, kem) -> list[list[tuple[HybridCiphertext, HybridCiphertext]]]:
    """The per-pair DEM: compress each KEM point, derive both keys, and
    encrypt the share and the hiding of each (dealer, recipient) pair;
    shares and hidings (n_d, n_r, L), c1 and kem (n_d, n_r, C, L) from
    :func:`kem_batch`.  One KEM point seals both halves of a pair under
    different KDF tags."""
    cs = cfg.cs
    fs = cs.scalar
    shares, hidings, c1, kem = (_host(x) for x in (shares, hidings, c1, kem))
    n_d, n_r = shares.shape[:2]
    out = []
    for d in range(n_d):
        c1_pts = _host_points(cs, c1[d])
        kem_pts = _host_points(cs, kem[d])
        row = []
        for i in range(n_r):
            kem_bytes = group.encode(kem_pts[i])
            cts = []
            for tag, limbs in ((PERSON_SHARE, shares[d, i]), (PERSON_RAND, hidings[d, i])):
                key, nonce = keystream_from_kem_bytes(kem_bytes, tag)
                msg = int(fh.decode(fs, limbs[None])[0]).to_bytes(fs.nbytes, "little")
                cts.append(HybridCiphertext(c1_pts[i], native.chacha20_xor(key, nonce, msg)))
            row.append((cts[0], cts[1]))
        out.append(row)
    return out


def seal_shares_batch(group, cfg, shares, hidings, c1, kem
                      ) -> list[list[tuple[HybridCiphertext, HybridCiphertext]]]:
    """Array-shaped :func:`seal_shares`, the same pairs and bytes: one
    ``encode_batch`` of every KEM point (its device leg when ``kem`` is on
    the card), one ``kdf_batch`` and one ``chacha20_xor_batch`` a tag.
    Every sealed scalar fits one keystream block.  The e1 tuples are the
    projective c1 points, as the per-pair leg gives them: only the KEM
    points key the KDF, so only they are made canonical."""
    cs = cfg.cs
    fs = cs.scalar
    shares, hidings, c1 = _host(shares), _host(hidings), _host(c1)
    n_d, n_r = shares.shape[:2]
    n_pairs = n_d * n_r
    kem_enc = gd.encode_batch(cs, kem).reshape(n_pairs, -1)
    e1s = _host_points(cs, c1.reshape(n_pairs, cs.ncoords, cs.field.limbs))
    msg_s = _le_bytes(shares.reshape(n_pairs, -1), fs.nbytes)
    msg_h = _le_bytes(hidings.reshape(n_pairs, -1), fs.nbytes)
    k1, nonce1 = kdf_batch(kem_enc, PERSON_SHARE)
    k2, nonce2 = kdf_batch(kem_enc, PERSON_RAND)
    ct_s = chacha20_xor_batch(k1, nonce1, msg_s)
    ct_h = chacha20_xor_batch(k2, nonce2, msg_h)
    return [[(HybridCiphertext(e1s[j], ct_s[j].tobytes()), HybridCiphertext(e1s[j], ct_h[j].tobytes()))
             for j in range(d * n_r, (d + 1) * n_r)] for d in range(n_d)]


def seal_shares_pipeline(group, cfg, shares, hidings, pks_dev: torch.Tensor, r_enc: torch.Tensor,
                         g_table: torch.Tensor, chunk: int | None = None, dem: str = "batch"
                         ) -> list[list[tuple[HybridCiphertext, HybridCiphertext]]]:
    """KEM and DEM for a whole dealing round, chunked over dealers: chunk
    k+1's KEM is launched before chunk k's DEM blocks on its transfer, so
    the card works while the host seals.

    ``chunk`` is dealers a chunk: by default ``max(1, 4096 // n_r)``
    (about 4096 pairs), 0 for one unchunked pass.  ``dem`` is the DEM leg,
    ``"batch"`` (:func:`seal_shares_batch`) or ``"scalar"``
    (:func:`seal_shares`).  The output does not depend on either: chunks
    are independent dealer rows."""
    if dem not in DEM_MODES:
        raise ValueError(f"dem must be one of {DEM_MODES}, got {dem!r}")
    n_d, n_r = r_enc.shape[0], r_enc.shape[1]
    if chunk is None:
        chunk = max(1, 4096 // max(1, n_r))
    if chunk < 0:
        raise ValueError(f"chunk must be >= 0, got {chunk}")
    seal = seal_shares if dem == "scalar" else seal_shares_batch
    shares, hidings = _host(shares), _host(hidings)
    if not chunk or chunk >= n_d:
        return seal(group, cfg, shares, hidings, *kem_batch(cfg, pks_dev, r_enc, g_table))
    spans = [(a, min(a + chunk, n_d)) for a in range(0, n_d, chunk)]
    nxt = kem_batch(cfg, pks_dev, r_enc[spans[0][0] : spans[0][1]], g_table)
    out: list[list[tuple[HybridCiphertext, HybridCiphertext]]] = []
    for k, (a, b) in enumerate(spans):
        cur = nxt
        if k + 1 < len(spans):  # launch chunk k+1 before chunk k's DEM blocks
            nxt = kem_batch(cfg, pks_dev, r_enc[spans[k + 1][0] : spans[k + 1][1]], g_table)
        out.extend(seal(group, cfg, shares[a:b], hidings[a:b], *cur))
    return out


def seal_shares_mesh(group, cfg, mesh, shares, hidings, pks_dev: torch.Tensor, r_enc, g_table: torch.Tensor,
                     chunk: int | None = None) -> list[list[tuple[HybridCiphertext, HybridCiphertext]]]:
    """:func:`seal_shares_pipeline` on a party mesh rank (``parallel.mesh``):
    the rank seals its own dealer block, ``shares`` and ``hidings``
    (block, n, L), with its slice of ``r_enc`` (all n dealers' rows, or
    the block's), the KEM and DEM chunk overlap running within the block.
    Returns the block's sealed rows; dealer rows are independent, so the
    ranks' blocks joined in rank order are byte-identical to one
    :func:`seal_shares_pipeline` over the whole round, and the host holds
    one block's share slab at a time (the JAX package's per-shard walk)."""
    block = mesh.block(cfg.n)
    if shares.shape[0] != block or hidings.shape[0] != block:
        raise ValueError(f"seal_shares_mesh takes the rank's {block} dealer rows, got {shares.shape[0]}")
    if r_enc.shape[0] == cfg.n:
        start, stop = mesh.span(cfg.n)
        r_enc = r_enc[start:stop]
    elif r_enc.shape[0] != block:
        raise ValueError(f"r_enc has {r_enc.shape[0]} dealer rows, expected {block} or {cfg.n}")
    return seal_shares_pipeline(group, cfg, shares, hidings, pks_dev, r_enc, g_table, chunk=chunk)


def open_share(group, sk: int, pair: tuple[HybridCiphertext, HybridCiphertext]) -> tuple[int | None, int | None]:
    """The recipient's decryption of one sealed (share, hiding) pair; a
    payload of the wrong length or not below the group order is None."""
    fs = group.scalar_field
    share_ct, hiding_ct = pair
    kem_bytes = group.encode(group.scalar_mul(sk, share_ct.e1))
    out = []
    for tag, ct in ((PERSON_SHARE, share_ct), (PERSON_RAND, hiding_ct)):
        key, nonce = keystream_from_kem_bytes(kem_bytes, tag)
        pt = native.chacha20_xor(key, nonce, ct.ciphertext)
        v = int.from_bytes(pt, "little") if len(pt) == fs.nbytes else None
        out.append(v if v is None or v < fs.modulus else None)
    return out[0], out[1]


def open_shares_batch(group, cfg, sk: int, pairs: list[tuple[HybridCiphertext, HybridCiphertext]],
                      *, device="cuda") -> list[tuple[int | None, int | None]]:
    """:func:`open_share` for every dealer's pair at once: the KEM points
    sk·e1 as one ``scalar_mul`` on ``device``, their encodings as one
    ``encode_batch``, and the KDF and ChaCha20 as one batch a tag.  The
    same values as :func:`open_share`, element by element (``share_ct.e1``
    keys both tags; a wrong length or a value not below the order is
    None)."""
    cs = cfg.cs
    fs = group.scalar_field
    n = len(pairs)
    if n == 0:
        return []
    device = resolve_device(device)
    sk_limbs = fh.to_tensor(fh.encode(fs, sk), device).expand(n, fs.limbs)
    kem_dev = gd.scalar_mul(cs, sk_limbs, gd.from_host(cs, [p[0].e1 for p in pairs], device=device))
    kem_enc = gd.encode_batch(cs, kem_dev)
    vals: list[list[int | None]] = [[None, None] for _ in range(n)]
    for col, tag in ((0, PERSON_SHARE), (1, PERSON_RAND)):
        cts = [p[col].ciphertext for p in pairs]
        rows = [i for i, ct in enumerate(cts) if len(ct) == fs.nbytes]
        if not rows:
            continue
        data = np.frombuffer(b"".join(cts[i] for i in rows), dtype=np.uint8).reshape(len(rows), fs.nbytes)
        key, nonce = kdf_batch(kem_enc[rows], tag)
        pt = chacha20_xor_batch(key, nonce, data)
        for r, i in enumerate(rows):
            v = int.from_bytes(pt[r].tobytes(), "little")
            vals[i][col] = v if v < fs.modulus else None
    return [(a, b) for a, b in vals]


def broadcasts_from_batch(group, cfg, randomized, sealed: list[list[tuple[HybridCiphertext, HybridCiphertext]]]
                          ) -> list[BroadcastPhase1]:
    """A dealing round as wire messages: one ``BroadcastPhase1`` a dealer,
    its randomized commitments ``randomized`` (n_d, t+1, C, L) as host
    points and its row of sealed pairs, recipient i + 1 the row's i-th."""
    cs = cfg.cs
    comm = _host(randomized)
    out = []
    for d, row in enumerate(sealed):
        enc = tuple(EncryptedShares(i + 1, share_ct, hiding_ct) for i, (share_ct, hiding_ct) in enumerate(row))
        out.append(BroadcastPhase1(tuple(_host_points(cs, comm[d])), enc))
    return out
