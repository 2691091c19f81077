"""In-process epoch operations over a full share vector.

Counterpart of ``dkg_tpu/epoch/inprocess.py``: a serving lane that holds
ALL final shares of a hosted ceremony in one process refreshes or
reshares them with no channel, no sealing and no complaints, as one
batched computation:

* refresh: every dealer row i deals a zero-constant degree-t polynomial
  u_i and new_share_j = old_share_j + Σ_i u_i(j).  The aggregate's
  constant gains Σ_i u_i(0) = 0, so the master key stays;
* reshare: dealer row i deals a degree-t' polynomial h_i with
  h_i(0) = old_share_i and new_share_j = Σ_i λ_i·h_i(j), λ_i the
  Lagrange-at-zero coefficients of the OLD indices.  The new aggregate's
  constant is Σ_i λ_i·old_share_i = F(0).

Each is one ``poly.device.eval_many`` (one ``mod_madd_horner`` launch
for the whole (dealers, recipients) matrix) and the dealer fold; a
reshare adds λ_i(0) (``poly.device.lagrange_at_zero_coeffs``, ``mod_mul``
launches) and one ``mod_mul`` launch of the weights.  The fold is a tree
of ⌈log2 n⌉ batched field adds where the JAX package adds the n rows in
turn: the sum of canonical residues is the same either way.
"""

from __future__ import annotations

import torch

from ..dkg.ceremony import resolve_device
from ..fields import device as fd
from ..fields import host as fh
from ..fields.spec import FieldSpec
from ..ops import field_kernels as fk
from ..poly import device as poly_device


def _indices(fs: FieldSpec, n: int, device) -> torch.Tensor:
    return fh.to_tensor(fh.encode(fs, list(range(1, n + 1))), device)  # (n, L)


def _coeff_tensor(fs: FieldSpec, constants: list[int], ncoeffs: int, rng, device) -> torch.Tensor:
    """(rows, ncoeffs, L) coefficients: column 0 ``constants``, the rest
    fresh scalars from ``rng`` (host sampling, row by row, as the JAX
    package draws them)."""
    rows = [[c % fs.modulus] + [fs.rand_int(rng) for _ in range(ncoeffs - 1)] for c in constants]
    return fh.to_tensor(fh.encode(fs, rows), device)


def _fold_dealers(fs: FieldSpec, m: torch.Tensor) -> torch.Tensor:
    """Sum an (n_dealers, n_recipients, L) matrix over the dealers: each
    level adds the two halves in one batched ``fd.add``, an odd row
    carried to the next level."""
    while m.shape[0] > 1:
        half = m.shape[0] // 2
        s = fd.add(fs, m[:half], m[half : 2 * half])
        m = torch.cat([s, m[2 * half :]]) if m.shape[0] % 2 else s
    return m[0]


def refresh_shares(fs: FieldSpec, n: int, t: int, shares: list[int], rng, *, device="cuda") -> list[int]:
    """Proactively refresh a full (n, t) share vector; the shared secret
    (and master key) stays.  Returns the new shares."""
    if len(shares) != n:
        raise ValueError(f"expected {n} shares, got {len(shares)}")
    dev = resolve_device(device)
    coeffs = _coeff_tensor(fs, [0] * n, t + 1, rng, dev)  # (n, t+1, L)
    deltas = poly_device.eval_many(fs, coeffs, _indices(fs, n, dev))  # (n, n, L)
    old = fh.to_tensor(fh.encode(fs, shares), dev)
    new = fd.add(fs, old, _fold_dealers(fs, deltas))
    return [int(v) for v in fh.decode(fs, fh.from_tensor(new))]


def reshare_shares(fs: FieldSpec, n: int, t: int, shares: list[int], n_new: int, t_new: int, rng, *,
                   device="cuda") -> list[int]:
    """Reshare an (n, t) share vector into a fresh (n_new, t_new) one of
    the SAME secret.  Returns the new committee's shares (1..n_new)."""
    if len(shares) != n:
        raise ValueError(f"expected {n} shares, got {len(shares)}")
    if n < t + 1:
        raise ValueError(f"need at least t+1={t + 1} dealers, have {n}")
    if n_new < t_new + 1:
        raise ValueError(f"new committee of {n_new} cannot reconstruct at threshold {t_new} (need n' >= t'+1)")
    dev = resolve_device(device)
    coeffs = _coeff_tensor(fs, shares, t_new + 1, rng, dev)  # (n, t_new+1, L)
    m = poly_device.eval_many(fs, coeffs, _indices(fs, n_new, dev))  # (n, n_new, L)
    lam = poly_device.lagrange_at_zero_coeffs(fs, _indices(fs, n, dev))  # (n, L)
    new = _fold_dealers(fs, fk.mod_mul(fs, lam[:, None, :], m))  # (n_new, L)
    return [int(v) for v in fh.decode(fs, fh.from_tensor(new))]
