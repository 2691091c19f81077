"""Device legs of epoch operations: thin wrappers over the ceremony's
batched dealing and verification.

Counterpart of ``dkg_tpu/epoch/dealing.py``.  Everything expensive in an
epoch operation goes through the entry points the ceremony uses:

* dealing: :func:`~dkg_tpu_torch.dkg.ceremony.deal_chunked` (the
  commitments, one ``pt_fixed_base`` launch each, and the share row, one
  ``mod_madd_horner``) and
  :func:`~dkg_tpu_torch.dkg.hybrid_batch.seal_shares_pipeline` (the KEM
  for every recipient at once and the DEM), packaged by
  ``broadcasts_from_batch``;
* the recipient's decryption: ``open_shares_batch`` (one KEM recovery
  for every dealer);
* share verification: ``gd.fixed_base_mul`` and ``gd.eval_point_poly``
  over all (dealer, share) rows at once, one ``pt_fixed_base`` and one
  ``pt_ladder_horner`` launch: the bare-commitment twin of the ceremony's
  re-check (epochs carry no Pedersen hiding leg; the dealt constants are
  bound by the previous epoch's commitments).

Each function that makes tensors takes ``device`` (the card unless the
caller asks for the CPU, where the kernels' plain versions run).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dkg.ceremony import CeremonyConfig, deal_chunked, resolve_device
from ..dkg.hybrid_batch import broadcasts_from_batch, open_shares_batch, seal_shares_pipeline
from ..fields import host as fh
from ..groups import device as gd
from ..groups import precompute as gp


def epoch_cfg(group, n: int, t: int) -> CeremonyConfig:
    """The shape of one epoch dealing: the RECIPIENT committee's (n, t)."""
    return CeremonyConfig(group.name, n, t)


def deal_epoch_poly(group, cfg: CeremonyConfig, constant: int, rng, recipient_pks: list, *,
                    device="cuda") -> tuple[tuple, tuple]:
    """Deal one degree-``cfg.t`` polynomial with constant term
    ``constant`` to ``cfg.n`` recipients through the batched ceremony.

    constant = 0 is a refresh deal (master-invariant); constant = the
    dealer's current share is a reshare deal (shares of the share).
    Returns ``(commitments, encrypted_shares)``: the t + 1 BARE
    commitment points and one sealed EncryptedShares a recipient.  The
    coefficients come from ``rng`` in the JAX package's order (t draws
    after the constant, then the n KEM randomizers); the hiding
    polynomial is zero, so the g table stands in for h and epochs need no
    commitment key."""
    dev = resolve_device(device)
    cs, fs = cfg.cs, group.scalar_field
    coeffs = [constant % fs.modulus] + [fs.rand_int(rng) for _ in range(cfg.t)]
    coeffs_a = fh.to_tensor(fh.encode(fs, [coeffs]), dev)
    coeffs_b = torch.zeros_like(coeffs_a)
    g_table = gp.generator_table(cs, device=dev)
    bare, _rand, shares, hidings = deal_chunked(cfg, coeffs_a, coeffs_b, g_table, g_table)
    pks_dev = gd.from_host(cs, [p.point for p in recipient_pks], device=dev)
    r_enc = fh.to_tensor(fh.encode(fs, [[fs.rand_int(rng) for _ in range(cfg.n)]]), dev)
    sealed = seal_shares_pipeline(group, cfg, shares, hidings, pks_dev, r_enc, g_table)
    b = broadcasts_from_batch(group, cfg, bare, sealed)[0]
    return b.committed_coefficients, b.encrypted_shares


def open_my_shares(group, cfg: CeremonyConfig, sk: int, deals: dict, my_index: int, *, device="cuda") -> dict:
    """Decrypt this member's sealed share from every deal in one batched
    KEM recovery: {dealer_index: share_int | None}."""
    order = sorted(deals)
    pairs = []
    for j in order:
        es = deals[j].shares_for(my_index)
        pairs.append((es.share_ct, es.randomness_ct))
    vals = open_shares_batch(group, cfg, sk, pairs, device=device)
    return {j: vals[k][0] for k, j in enumerate(order)}


def check_bare_shares(group, indices: list[int], shares: list[int], coeffs_list: list[tuple], *,
                      device="cuda") -> np.ndarray:
    """g·s == Σ_l idx^l·A_l over k independent (dealer, share) rows: one
    fixed-base batch multiply and one point Horner, the rows' commitments
    made limbs once on ``device`` and read by ``pt_ladder_horner`` a lane
    each."""
    if not indices:
        return np.zeros((0,), dtype=bool)
    dev = resolve_device(device)
    cs = gd.ALL_CURVES[group.name]
    fs = group.scalar_field
    k, tp1 = len(indices), len(coeffs_list[0])
    s_limbs = fh.to_tensor(fh.encode(fs, shares), dev)
    flat = [c for coeffs in coeffs_list for c in coeffs]
    cpts = gd.from_host(cs, flat, device=dev).reshape(k, tp1, cs.ncoords, cs.field.limbs)
    idx = torch.tensor(indices, dtype=torch.int32, device=dev)
    nbits = max(2, int(max(indices)).bit_length())
    lhs = gd.fixed_base_mul(cs, gp.generator_table(cs, device=dev), s_limbs)
    rhs = gd.eval_point_poly(cs, cpts, idx, nbits)
    return gd.eq(cs, lhs, rhs).cpu().numpy()


def check_reshare_constants(group, prev_commitments: tuple, dealer_indices: list[int], claimed_constants: list, *,
                            device="cuda") -> np.ndarray:
    """A_{i,0} == eval(prev_commitments, i) for each reshare dealer: its
    constant must commit to its actual share of the current aggregate,
    which binds the reshared secret to the old one.  The one commitment
    tuple is broadcast to the k lanes, never copied: ``pt_ladder_horner``
    reads it once."""
    if not dealer_indices:
        return np.zeros((0,), dtype=bool)
    dev = resolve_device(device)
    cs = gd.ALL_CURVES[group.name]
    prev = gd.from_host(cs, list(prev_commitments), device=dev)
    idx = torch.tensor(dealer_indices, dtype=torch.int32, device=dev)
    nbits = max(2, int(max(dealer_indices)).bit_length())
    lhs = gd.from_host(cs, list(claimed_constants), device=dev)
    rhs = gd.eval_point_poly(cs, prev[None], idx, nbits)
    return gd.eq(cs, lhs, rhs).cpu().numpy()


def combine_reshare_commitments(group, lam_limbs: torch.Tensor, coeffs_list: list[tuple]) -> tuple:
    """The new aggregate commitments C'_l = Σ_i λ_i·A_{i,l}: one
    ``scalar_mul`` over all M·(t'+1) points (λ (M, L) broadcast along
    each dealer's row), then M - 1 point adds in dealer order, as the JAX
    package folds them; on ``lam_limbs``' device."""
    cs = gd.ALL_CURVES[group.name]
    m, tp1 = len(coeffs_list), len(coeffs_list[0])
    flat = [c for coeffs in coeffs_list for c in coeffs]
    pts = gd.from_host(cs, flat, device=lam_limbs.device).reshape(m, tp1, cs.ncoords, cs.field.limbs)
    lam_b = lam_limbs[:, None, :].expand(m, tp1, lam_limbs.shape[-1])
    scaled = gd.scalar_mul(cs, lam_b, pts)
    acc = scaled[0]
    for i in range(1, m):
        acc = gd.add(cs, acc, scaled[i])
    return tuple(gd.to_host(cs, acc))
