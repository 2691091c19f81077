"""Batched partial signatures: every signer x every message at once.

Counterpart of ``dkg_tpu/sign/partial.py``.  A partial signature is
sig_i = s_i·H(m), one scalar multiplication a (message, signer) cell;
the whole (B messages, m signers) grid is one ``groups.device.scalar_mul``
a message chunk: each message's H(m) as a (B', 1) batch of points, so its
window table is built once and read in place by the m lanes that share
it, against the (B', m) scalars, one ``pt_scalar_mul`` launch.  Public
keys pk_i = s_i·g take the generator's fixed-base table (one
``pt_fixed_base`` launch), and every point batch leaves in canonical
affine form (``groups.device.affine_canon``: one ``mod_batch_inv`` and the
coordinates' ``mod_mul`` launches).

Partial verification needs no pairing: each signer proves
log_g(pk_i) = log_{H(m)}(sig_i) by a DLEQ proof, and
:func:`verify_partials` checks the whole grid in one
``crypto.dleq_batch.verify_batch`` (one per-row m = 2 MSM).
:func:`partial_sign_host` is the per-share big-int oracle.

The functions that make tensors from host values take ``device=``
(default ``"cuda"``); those that take a :class:`PartialSignatures` run
where its ``sigs`` lie.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..crypto import dleq_batch
from ..crypto.dleq import DleqZkp
from ..dkg.ceremony import resolve_device
from ..fields import host as fh
from ..groups import device as gd
from ..groups import host as gh
from ..groups import precompute

SIGN_CHUNK = 256  # messages a scalar_mul launch: a (256, t + 1) grid


@dataclasses.dataclass
class PartialSignatures:
    """One batch of partial signatures over a signer subset.

    ``sigs`` holds canonical affine limbs ``(B, m, C, L)`` (int32, on the
    device that signed), so aggregation and encoding never canonicalise
    again; host point tuples for the DLEQ transcripts come from
    :meth:`sigs_host`."""

    curve: str
    indices: tuple[int, ...]  # 1-based signer indices, len m
    h_points: list  # host H(m) tuples, len B
    sigs: torch.Tensor  # (B, m, C, L) canonical affine limbs
    pks: list  # host pk_i tuples, len m
    proofs: list[DleqZkp] | None = None  # row-major over (B, m)
    announcements: list[tuple] | None = None  # (a1, a2) host pairs matching ``proofs``

    def sigs_host(self) -> list[list[tuple]]:
        """Host point tuples, [message][signer], made once an instance
        (``dataclasses.replace``, how a tamper forks a batch, makes a new
        one that derives its own)."""
        memo = getattr(self, "_host_rows", None)
        if memo is not None:
            return memo
        b, m = self.sigs.shape[:2]
        flat = gd.to_host(gd.ALL_CURVES[self.curve], self.sigs.reshape(b * m, *self.sigs.shape[2:]))
        self._host_rows = [flat[i * m : (i + 1) * m] for i in range(b)]
        return self._host_rows


def public_keys(curve: str, shares: list[int], *, device="cuda") -> tuple[torch.Tensor, list]:
    """pk_i = s_i·g for every share, through the generator's fixed-base
    table: (canonical affine limbs (m, C, L) on ``device``, host tuples)."""
    dev = resolve_device(device)
    cs = gd.ALL_CURVES[curve]
    k = fh.to_tensor(fh.encode(cs.scalar, shares), dev)
    canon = gd.affine_canon(cs, gd.fixed_base_mul(cs, precompute.generator_table(cs, device=dev), k))
    return canon, gd.to_host(cs, canon)


def sign_folded(curve: str, sigma_limbs, h_dev: torch.Tensor) -> torch.Tensor:
    """Sign a message batch with the folded quorum scalar in one
    ``scalar_mul``: sigma = Σ λ_i(0)·s_i = f(0) (``sign.cache.SignCache
    .fold_limbs``), so sigma·H(m) is the aggregate signature.

    ``sigma_limbs``: (L,) limbs of one shared sigma, or (B, L) rows, one a
    message; ``h_dev``: (B, C, L) H(m) limbs, whose device the work runs
    on.  Returns the raw projective result; :func:`folded_collect`
    canonicalises a list of them."""
    cs = gd.ALL_CURVES[curve]
    kk = fh.to_tensor(sigma_limbs, h_dev.device) if isinstance(sigma_limbs, np.ndarray) else sigma_limbs
    if kk.dim() == 1:
        kk = kk.expand(h_dev.shape[0], kk.shape[-1])
    return gd.scalar_mul(cs, kk, h_dev)


def folded_collect(curve: str, pending: list) -> torch.Tensor:
    """Canonical affine limbs (Σ B, C, L) of a list of
    :func:`sign_folded` results, ready for ``aggregate.signature_encode``."""
    return gd.affine_canon(gd.ALL_CURVES[curve], torch.cat(pending, dim=0))


def partial_sign_host(group, shares: list[int], h_point) -> list[tuple]:
    """Per-share big-int oracle: [s_i·H(m)] as host point tuples."""
    return [group.scalar_mul_vartime(s, h_point) for s in shares]


def partial_sign(curve: str, shares: list[int], indices: list[int], h_points: list, *, rng=None,
                 prove: bool = False, dispatch: str = "device", chunk: int = SIGN_CHUNK,
                 pks: tuple[torch.Tensor, list] | None = None, device="cuda") -> PartialSignatures:
    """Sign every message with every share: (B, m) partials.

    ``h_points``: host H(m) tuples (``hash2curve``).  ``prove=True``
    attaches a DLEQ proof to every cell (needs ``rng``).  ``dispatch``:
    ``"device"`` runs the grid as one ``scalar_mul`` a chunk of ``chunk``
    messages on ``device``; ``"host"`` is the oracle loop (cross-checks,
    tiny batches), its limbs then copied to ``device``.  ``pks``: the
    (canon, host) pair :func:`public_keys` returns, when the caller holds
    it (``SignCache`` keeps them a quorum); it must match ``shares``."""
    if len(shares) != len(indices):
        raise ValueError("shares and indices must pair up")
    if prove and rng is None:
        raise ValueError("prove=True requires rng")
    if dispatch not in ("device", "host"):
        raise ValueError(f"sign dispatch must be device|host, got {dispatch!r}")
    if chunk < 1:
        raise ValueError(f"sign chunk must be positive, got {chunk}")
    dev = resolve_device(device)
    cs, group = gd.ALL_CURVES[curve], gh.ALL_GROUPS[curve]
    b, m = len(h_points), len(shares)
    if dispatch == "host":
        flat = [p for h in h_points for p in partial_sign_host(group, shares, h)]
        proj = fh.from_tensor(gd.from_host(cs, flat, device="cpu"))
        sigs = fh.to_tensor(gd.affine_canon_host(cs, proj.reshape(b, m, cs.ncoords, cs.field.limbs)), dev)
    else:
        k = fh.to_tensor(fh.encode(cs.scalar, shares), dev)  # (m, L)
        h_dev = gd.from_host(cs, h_points, device=dev)  # (B, C, L)
        parts = []
        for b0 in range(0, b, chunk):
            blk = h_dev[b0 : b0 + chunk, None]  # (B', 1, C, L): one table a message
            parts.append(gd.scalar_mul(cs, k.expand(blk.shape[0], m, k.shape[-1]), blk))
        sigs = gd.affine_canon(cs, torch.cat(parts, dim=0))
    if pks is None:
        pks = public_keys(curve, shares, device=dev)
    ps = PartialSignatures(curve=curve, indices=tuple(int(i) for i in indices), h_points=list(h_points),
                           sigs=sigs, pks=pks[1])
    if prove:
        statements = [st + (shares[i % m],) for i, st in enumerate(verify_statements(ps))]
        ps.proofs, ps.announcements = dleq_batch.generate_batch(group, cs, statements, rng,
                                                                return_announcements=True, device=dev)
    return ps


def verify_partials(ps: PartialSignatures) -> np.ndarray:
    """Check every partial's DLEQ proof in one batched pass -> (B, m) bool,
    on the device ``ps.sigs`` lies on.  A valid proof pins
    log_{H(m)}(sig_i) to log_g(pk_i), s_i by the ceremony's commitments."""
    if ps.proofs is None:
        raise ValueError("PartialSignatures carries no proofs (prove=False)")
    cs, group = gd.ALL_CURVES[ps.curve], gh.ALL_GROUPS[ps.curve]
    ok = dleq_batch.verify_batch(group, cs, ps.proofs, verify_statements(ps), device=ps.sigs.device)
    return ok.reshape(ps.sigs.shape[:2])


def verify_statements(ps: PartialSignatures) -> list[tuple]:
    """Each cell's DLEQ statement (g, H(m), pk_i, sig_i), row-major."""
    g = gh.ALL_GROUPS[ps.curve].generator()
    b, m = ps.sigs.shape[:2]
    sigs_host = ps.sigs_host()
    return [(g, ps.h_points[bi], ps.pks[si], sigs_host[bi][si]) for bi in range(b) for si in range(m)]
