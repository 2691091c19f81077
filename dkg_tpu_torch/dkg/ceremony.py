"""The batched GJKR ceremony on limb tensors: deal, batch verify, blame,
aggregate, master key.

Counterpart of ``dkg_tpu/dkg/ceremony.py``, held to it limb for limb:
the same coefficients from the same ``rng``, the same complete formulas
in the same order, the same transcript digest and Fiat-Shamir
randomizers.  State is struct-of-arrays over all parties at once:

* ``deal`` — commitments A = g·a and E = A + h·b for every dealer's t+1
  coefficients (``fixed_base_mul`` over the g/h window tables, one
  ``pt_fixed_base`` launch each), and the n×n share/hiding matrices by
  Horner (``eval_many``, one ``mod_madd_horner`` launch);
* ``derive_rho`` — per-dealer BLAKE2s Merkle digests of the canonical
  transcript, folded with BLAKE2b, then n BLAKE2b randomizers; on the
  device leg (the default) the commitments are made canonical affine
  (``affine_canon``: the batch inversion one ``mod_batch_inv`` launch and
  the affine coordinates ``mod_mul``'s, or under ``mul="gemm"`` one
  ``mxu_batch_inv`` launch and ``mxu_mod_mul``'s) and the Merkle rows hashed where
  the tensors are (``crypto/device_hash.py``), only the (n, 8) row
  digests crossing to the host; the host leg does both on the host;
* ``verify_batch`` — with randomizers rho_j each recipient i checks
  g·(Σ_j rho_j s_ji) + h·(Σ_j rho_j s'_ji) == Σ_l i^l · (Σ_j rho_j E_jl):
  scalar RLCs (``_field_dot``, one ``mod_madd_dot`` launch each), the
  point RLC by Straus (``pt_add`` table builds, one ``pt_tree_sum`` and
  one ``pt_window_step`` per 4-bit window), by Pippenger
  (one ``pt_bucket_sum``, one ``pt_bucket_close``, then window steps)
  or bit at a time, the right side by point Horner (``eval_point_poly``,
  one ``pt_ladder_horner`` launch), the left by two ``pt_fixed_base``;
* ``verify_pairwise`` — the direct per-(dealer, recipient) check, run
  only when a batch check fails, to assign blame.

Every function takes tensors on one device.  On the card the point and
field work goes through the CUDA kernels of ``dkg_tpu_torch/csrc``; on
the CPU through their plain versions.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from ..crypto import device_hash as dh
from ..crypto.blake2s import row_digests_np
from ..crypto.commitment import CommitmentKey
from ..fields import device as fd
from ..fields import host as fh
from ..groups import device as gd
from ..groups import host as gh
from ..groups import precompute as gp
from ..ops import field_kernels as fk
from ..ops import point_kernels as pk
from ..poly import device as pdev
from .errors import DkgError, DkgErrorKind


@dataclasses.dataclass(frozen=True)
class CeremonyConfig:
    """Static ceremony shape."""

    curve: str  # name in gd.ALL_CURVES
    n: int  # committee size
    t: int  # threshold (polynomial degree)

    @property
    def cs(self) -> gd.CurveSpec:
        return gd.ALL_CURVES[self.curve]

    @property
    def index_bits(self) -> int:
        """Bit width of party indices 1..n."""
        return max(int(self.n).bit_length(), 1)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it is CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain versions")
    return device


# ---------------------------------------------------------------------------
# round 1: dealing
# ---------------------------------------------------------------------------


def deal(cfg: CeremonyConfig, coeffs_a, coeffs_b, g_table, h_table):
    """All dealers' round-1 outputs: coefficients (n, t+1, L) ->
    A (n, t+1, C, L), E (n, t+1, C, L), s (n, n, L) with s[j, i] = f_j(i+1),
    r (n, n, L) the hiding shares."""
    a_pub, e_comm = deal_commitments(cfg, coeffs_a, coeffs_b, g_table, h_table)
    shares, hidings = deal_shares(cfg, coeffs_a, coeffs_b)
    return a_pub, e_comm, shares, hidings


def deal_chunked(cfg: CeremonyConfig, coeffs_a, coeffs_b, g_table, h_table, chunk: int | None = None):
    """:func:`deal` in chunks of ``chunk`` dealer rows (None or 0: one
    pass), the outputs concatenated on the dealer axis: each dealer's row
    is independent, so the result equals one-shot ``deal`` bit for bit.
    The rows are the ones supplied, which may be fewer than ``cfg.n``
    (a party dealing alone).  The JAX package picks a default chunk for
    the TPU and reads ``DKG_TPU_DEAL_CHUNK``; here the caller picks."""
    if chunk is not None and chunk < 0:
        raise ValueError(f"chunk must be >= 0, got {chunk}")
    n_rows = coeffs_a.shape[0]
    if not chunk or chunk >= n_rows:
        return deal(cfg, coeffs_a, coeffs_b, g_table, h_table)
    outs = [deal(cfg, coeffs_a[c0 : c0 + chunk], coeffs_b[c0 : c0 + chunk], g_table, h_table)
            for c0 in range(0, n_rows, chunk)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def deal_commitments(cfg: CeremonyConfig, coeffs_a, coeffs_b, g_table, h_table):
    cs = cfg.cs
    a_pub = gd.fixed_base_mul(cs, g_table, coeffs_a)
    b_hid = gd.fixed_base_mul(cs, h_table, coeffs_b)
    return a_pub, gd.add(cs, a_pub, b_hid)


def _index_limbs(fs, n: int, device) -> torch.Tensor:
    """Party indices 1..n as (n, L) limbs."""
    xs = fd.zeros(fs, (n,), device=device)
    xs[:, 0] = torch.arange(1, n + 1, dtype=torch.int32, device=device)
    return xs


def deal_shares(cfg: CeremonyConfig, coeffs_a, coeffs_b):
    fs = cfg.cs.scalar
    xs = _index_limbs(fs, cfg.n, coeffs_a.device)
    return pdev.eval_many(fs, coeffs_a, xs), pdev.eval_many(fs, coeffs_b, xs)


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------


def _field_dot(fs, weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Σ_j weights[j]·values[j, ...] mod p: weights (m, L), values
    (m, ..., L) -> (..., L), one ``mod_madd_dot`` launch (the fold
    acc <- w_j·v_j + acc of ``mod_madd``'s step)."""
    return fk.mod_madd_dot(fs, weights, values)


RLC_MODES = ("straus", "bits", "pippenger")


def _point_rlc(cs: gd.CurveSpec, weights: torch.Tensor, points: torch.Tensor, nbits: int,
               mode: str = "straus") -> torch.Tensor:
    """Σ_j weights[j]·P[j, ...] for nbits-wide public weights.

    weights (m, L) with only the low nbits set, points (m, ..., C, L) ->
    (..., C, L).  Three schedules of the JAX package, one sum (equal in
    canonical affine form):

    * ``"straus"``: windowed Straus (w = 4), per-point 16-entry tables,
      then per window from the top, tree-sum each point's entry over j
      (one ``pt_tree_sum`` launch reading the entries in place), and one
      window step;
    * ``"pippenger"``: :func:`groups.device.msm_pippenger` with the m axis
      moved to -3 and the weights shared by every column: the points
      scatter into buckets (one ``pt_bucket_sum`` launch, the points read
      in place), which are closed (one ``pt_bucket_close``) and combined
      per window;
    * ``"bits"``: bit at a time, per bit row from the top one doubling,
      then a select of the points whose bit is set, a tree sum, one add.

    The JAX package chunks the columns to bound its TPU memory; that
    changes no limb and is not done here."""
    if mode not in RLC_MODES:
        raise ValueError(f"rlc must be one of {RLC_MODES}, got {mode!r}")
    if mode == "pippenger":
        return gd.msm_pippenger(cs, weights, points.movedim(0, -3), nbits=nbits)
    m = points.shape[0]
    shape = (m,) + (1,) * (points.dim() - 3)
    acc = gd.identity(cs, points.shape[1:-2], device=points.device)
    if mode == "straus":
        nd = -(-nbits // gd.WINDOW)  # windows that can be non-zero
        table = gd._build_table(cs, points).movedim(0, -4)  # (..., m, 16, C, L), a view
        digits = pk.window_digits(weights, gd.WINDOW)[:, :nd]  # (m, nd)
        for d in reversed(range(nd)):
            total = pk.pt_tree_sum(cs, table, digits[:, d])  # the entries read in place
            acc = gd.window_step(cs, acc, total, gd.WINDOW)
        return acc
    idx = torch.arange(nbits, device=weights.device)
    bits = (weights[:, idx // 16] >> (idx % 16).to(torch.int32)) & 1  # (m, nbits)
    ident = gd.identity(cs, points.shape[:-2], device=points.device)
    for i in reversed(range(nbits)):
        acc = gd.double(cs, acc)
        sel = gd.select((bits[:, i] != 0).reshape(shape).expand(points.shape[:-2]), points, ident)
        acc = gd.add(cs, acc, gd._tree_reduce(cs, sel.movedim(0, -3), m))
    return acc


def verify_batch(cfg: CeremonyConfig, e_comm, shares, hidings, rho, rho_bits: int, g_table, h_table,
                 rlc: str = "pippenger"):
    """RLC batch share verification -> (n,) bool per recipient.

    e_comm (n, t+1, C, L), shares/hidings (n, n, L) with [j, i] as
    recipient i received it from dealer j, rho (n, L) with only the low
    rho_bits bits set.  Sound up to 2^-rho_bits per cheating dealer.
    ``rlc`` is the point RLC's schedule (:data:`RLC_MODES`)."""
    cs = cfg.cs
    fs = cs.scalar
    s_rlc = _field_dot(fs, rho, shares)  # (n, L): Σ_j rho_j s_ji
    r_rlc = _field_dot(fs, rho, hidings)
    d_comm = _point_rlc(cs, rho, e_comm, rho_bits, rlc)  # (t+1, C, L): Σ_j rho_j E_jl
    xs = torch.arange(1, cfg.n + 1, dtype=torch.int32, device=e_comm.device)
    rhs = gd.eval_point_poly(cs, d_comm, xs, cfg.index_bits)  # (n, C, L)
    lhs = gd.add(cs, gd.fixed_base_mul(cs, g_table, s_rlc), gd.fixed_base_mul(cs, h_table, r_rlc))
    return gd.eq(cs, lhs, rhs)


def verify_pairwise(cfg: CeremonyConfig, e_comm, shares, hidings, g_table, h_table):
    """Direct per-(dealer, recipient) checks g·s + h·s' == Σ_l x^l E_l ->
    (n_dealers, n_recipients) bool."""
    cs = cfg.cs
    lhs = gd.add(cs, gd.fixed_base_mul(cs, g_table, shares), gd.fixed_base_mul(cs, h_table, hidings))
    xs = torch.arange(1, shares.shape[1] + 1, dtype=torch.int32, device=shares.device)
    rhs = gd.eval_point_poly(cs, e_comm[:, None], xs.expand(shares.shape[:2]), cfg.index_bits)
    return gd.eq(cs, lhs, rhs)


def aggregate_shares(cfg: CeremonyConfig, shares, qualified):
    """Final share per recipient: Σ over qualified dealers of their shares.
    shares (n_dealers, n_recip, L), qualified (n_dealers,) bool ->
    (n_recip, L), summed by a pairwise tree of field adds."""
    fs = cfg.cs.scalar
    acc = torch.where(qualified[:, None, None], shares, torch.zeros_like(shares))
    while acc.shape[0] > 1:
        if acc.shape[0] % 2:
            acc = torch.cat([acc, torch.zeros_like(acc[:1])])
        acc = fd.add(fs, acc[0::2], acc[1::2])
    return acc[0]


def master_key_from_bare(cfg: CeremonyConfig, a_comm, qualified):
    """Master public key: Σ over qualified dealers of A_{j,0} -> (C, L)."""
    cs = cfg.cs
    a0 = a_comm[:, 0]
    masked = gd.select(qualified, a0, gd.identity(cs, a0.shape[:-2], device=a0.device))
    return gd._tree_reduce(cs, masked, masked.shape[0])


# ---------------------------------------------------------------------------
# transcript digest and Fiat-Shamir randomizers
# ---------------------------------------------------------------------------

DIGESTS = ("device", "host")


def _dealer_rows(cfg: CeremonyConfig, a_comm, e_comm, shares, hidings, *, digest: str = "device",
                 mul: str = "classic"):
    """Per-dealer BLAKE2s Merkle digests of the four round-1 tensors,
    commitments in canonical affine form (rho must not depend on which
    addition schedule produced the projective coordinates): three (k, 8)
    uint32 arrays, the same under either leg.

    ``digest="device"`` canonicalises (``gd.affine_canon`` with ``mul``'s
    multiply) and hashes (``crypto/device_hash.py``) where the tensors are;
    ``"host"`` moves them to the host for big-int canonicalisation
    (``gd.affine_canon_host``) and the numpy tree (``row_digests_np``).
    They stand for the JAX package's ``DKG_TPU_DIGEST=device|host``."""
    k = shares.shape[0]
    if digest == "host":
        a_canon = gd.affine_canon_host(cfg.cs, fh.from_tensor(a_comm))
        e_canon = gd.affine_canon_host(cfg.cs, fh.from_tensor(e_comm))
        sr = np.concatenate(
            [fh.from_tensor(shares).reshape(k, -1), fh.from_tensor(hidings).reshape(k, -1)], axis=-1
        )
        return (
            row_digests_np(a_canon.reshape(k, -1), domain=1),
            row_digests_np(e_canon.reshape(k, -1), domain=2),
            row_digests_np(sr, domain=3),
        )
    if digest != "device":
        raise ValueError(f"digest must be one of {DIGESTS}, got {digest!r}")
    a_canon = gd.affine_canon(cfg.cs, a_comm, mul=mul)
    e_canon = gd.affine_canon(cfg.cs, e_comm, mul=mul)
    sr = torch.cat([shares.reshape(k, -1), hidings.reshape(k, -1)], dim=-1)
    rows = (dh.row_digests(a_canon.reshape(k, -1), domain=1), dh.row_digests(e_canon.reshape(k, -1), domain=2),
            dh.row_digests(sr, domain=3))
    return tuple(dh.to_numpy(r) for r in rows)


def _fold_digest_device(cfg: CeremonyConfig, rows_a, rows_e, rows_sr) -> bytes:
    """Fold the three per-dealer row digest arrays, in dealer order, into
    one BLAKE2b."""
    h = hashlib.blake2b(digest_size=32, person=b"dkgtpu-trd")
    h.update(f"{cfg.curve}|{cfg.n}|{cfg.t}|".encode())
    for rows in (rows_a, rows_e, rows_sr):
        h.update(np.ascontiguousarray(rows, np.uint32))
    return h.digest()


def transcript_digest_device(cfg: CeremonyConfig, a_comm, e_comm, shares, hidings, *, digest: str = "device",
                             mul: str = "classic") -> bytes:
    """The canonical engine transcript digest (the JAX package's device
    family), by either leg of :func:`_dealer_rows`."""
    return _fold_digest_device(cfg, *_dealer_rows(cfg, a_comm, e_comm, shares, hidings, digest=digest, mul=mul))


def _dealer_row_digests(shares_rows: np.ndarray, hidings_rows: np.ndarray) -> np.ndarray:
    """Per-dealer BLAKE2b digests of the delivered share and hiding rows:
    (k, n, L) uint32 x2 -> (k, 32) uint8."""
    out = np.zeros((len(shares_rows), 32), np.uint8)
    for i in range(len(shares_rows)):
        h = hashlib.blake2b(digest_size=32, person=b"dkgtpu-row")
        h.update(np.ascontiguousarray(shares_rows[i]))
        h.update(np.ascontiguousarray(hidings_rows[i]))
        out[i] = np.frombuffer(h.digest(), np.uint8)
    return out


def _fold_digest(cfg: CeremonyConfig, a_np: np.ndarray, e_np: np.ndarray, row_digests: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=32, person=b"dkgtpu-tr")
    h.update(f"{cfg.curve}|{cfg.n}|{cfg.t}|".encode())
    for arr in (a_np, e_np):
        a = np.ascontiguousarray(arr)
        h.update(str(a.shape).encode() + str(a.dtype).encode())
        h.update(a)
    h.update(np.ascontiguousarray(row_digests))
    return h.digest()


def transcript_digest(cfg: CeremonyConfig, a_comm, e_comm, shares, hidings, *, mul: str = "classic") -> bytes:
    """The byte-level audit digest of the complete round-1 transcript (the
    JAX package's ``transcript_digest``): BLAKE2b over the canonical affine
    commitments (``gd.affine_canon``, where the tensors are) and per-dealer
    BLAKE2b digests of the share and hiding rows.  A ceremony uses one
    digest family; the engine's is :func:`transcript_digest_device`."""
    rows = _dealer_row_digests(fh.from_tensor(shares), fh.from_tensor(hidings))
    a_canon = fh.from_tensor(gd.affine_canon(cfg.cs, a_comm, mul=mul))
    e_canon = fh.from_tensor(gd.affine_canon(cfg.cs, e_comm, mul=mul))
    return _fold_digest(cfg, a_canon, e_canon, rows)


def rho_digests(transcript: bytes, n: int, nbytes: int) -> np.ndarray:
    """Row j is BLAKE2b(transcript || j as 4 LE bytes), nbytes long,
    personalised "dkgtpu-rlc": (n, nbytes) uint8."""
    rows = [
        hashlib.blake2b(transcript + j.to_bytes(4, "little"), digest_size=nbytes,
                        person=b"dkgtpu-rlc").digest()
        for j in range(n)
    ]
    return np.frombuffer(b"".join(rows), np.uint8).reshape(n, nbytes)


def fiat_shamir_rho(cfg: CeremonyConfig, transcript: bytes, rho_bits: int) -> np.ndarray:
    """Public batch randomizers from the transcript digest: lane j is
    BLAKE2b(transcript || j as 4 LE bytes), masked to exactly rho_bits.
    Returns (n, L) uint32 limbs."""
    fs = cfg.cs.scalar
    nbytes = (rho_bits + 7) // 8
    # mask to EXACTLY rho_bits: the point RLC reads only the low rho_bits,
    # the field RLC every set bit; both must see the same weights
    mask = (1 << rho_bits) - 1
    dig = rho_digests(transcript, cfg.n, nbytes)
    out = np.zeros((cfg.n, fs.limbs), np.uint32)
    if (1 << rho_bits) > fs.modulus:
        # the masked value may exceed the scalar modulus: reduce per lane
        for j in range(cfg.n):
            out[j] = fh.encode(fs, int.from_bytes(dig[j].tobytes(), "little") & mask)
        return out
    # little-endian bytes -> 16-bit limbs, masked to exactly rho_bits
    nlimb = min((nbytes + 1) // 2, fs.limbs)
    buf = np.zeros((cfg.n, nlimb * 2), np.uint8)
    buf[:, :nbytes] = dig
    limbs16 = np.ascontiguousarray(buf).view("<u2").astype(np.uint32)
    full, rem = divmod(rho_bits, 16)
    if rem and full < nlimb:
        limbs16[:, full] &= (1 << rem) - 1
    if full + (1 if rem else 0) < nlimb:
        limbs16[:, full + (1 if rem else 0) :] = 0
    out[:, :nlimb] = limbs16
    return out


def derive_rho(cfg: CeremonyConfig, a_comm, e_comm, shares, hidings, rho_bits: int, *, device: bool = True,
               digest: str = "device", mul: str = "classic") -> np.ndarray:
    """rho from the real round-1 transcript: binds all four tensors (A as
    well, since it feeds the master key).  ``device=True`` takes the
    Merkle family (:func:`transcript_digest_device`, by the ``digest`` leg),
    ``device=False`` the byte-level audit digest (:func:`transcript_digest`);
    ``mul`` is the canonical affine form's multiply."""
    if device:
        transcript = transcript_digest_device(cfg, a_comm, e_comm, shares, hidings, digest=digest, mul=mul)
    else:
        transcript = transcript_digest(cfg, a_comm, e_comm, shares, hidings, mul=mul)
    return fiat_shamir_rho(cfg, transcript, rho_bits)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class BatchedCeremony:
    """Single-host ceremony over device tensors: deal, batch verify,
    blame, aggregate, master key.

    ``rng`` draws the coefficients as the JAX package's engine does (a, then
    b, dealer by dealer), so ``random.Random(seed)`` gives both packages the
    same ceremony.  :meth:`from_arrays` takes the coefficients instead."""

    def __init__(self, curve: str, n: int, t: int, shared_string: bytes, rng, *, device="cuda"):
        self._setup(curve, n, t, shared_string, device)
        fs = self.cfg.cs.scalar
        for name in ("coeffs_a", "coeffs_b"):
            ints = [[fs.rand_int(rng) for _ in range(t + 1)] for _ in range(n)]
            setattr(self, name, fh.to_tensor(fh.encode(fs, ints), self.device))

    @classmethod
    def from_arrays(cls, curve: str, n: int, t: int, shared_string: bytes, coeffs_a, coeffs_b,
                    *, g_table=None, h_table=None, device="cuda") -> "BatchedCeremony":
        """A ceremony over given coefficients: the JAX package's uint32
        (n, t+1, L) arrays, and its (NW, 256, C, L) g/h tables if given."""
        self = cls.__new__(cls)
        self._setup(curve, n, t, shared_string, device, g_table, h_table)
        shape = (n, t + 1, self.cfg.cs.scalar.limbs)
        for name, arr in (("coeffs_a", coeffs_a), ("coeffs_b", coeffs_b)):
            if tuple(np.shape(arr)) != shape:
                raise ValueError(f"{name} has shape {np.shape(arr)}, expected {shape}")
            setattr(self, name, fh.to_tensor(arr, self.device))
        return self

    def _setup(self, curve, n, t, shared_string, device, g_table=None, h_table=None):
        self.device = resolve_device(device)
        self.cfg = CeremonyConfig(curve, n, t)
        cs = self.cfg.cs
        self.group = gh.ALL_GROUPS[curve]
        self.ck = CommitmentKey.generate(self.group, shared_string)
        t0 = time.perf_counter()
        self.g_table = (gp.generator_table(cs, device=self.device) if g_table is None
                        else fh.to_tensor(g_table, self.device))
        self.h_table = (gp.base_table(cs, self.ck.h, device=self.device) if h_table is None
                        else fh.to_tensor(h_table, self.device))
        self._sync()
        self.table_seconds = time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, rho_bits: int = 128, tamper=None, rlc: str = "pippenger", digest: str = "device",
            mul: str = "classic") -> dict:
        """The whole ceremony, blame path included.

        One RLC batch verification covers all n·(n-1) share relations.  If
        any recipient's check fails, ``verify_pairwise`` finds the failing
        (recipient, dealer) pairs, their dealers are disqualified, and the
        ceremony completes over the qualified set; with more than t
        disqualified it aborts with ``DkgError(MISBEHAVIOUR_HIGHER_THRESHOLD)``
        under ``"error"``.

        ``tamper(a, e, s, r) -> (a, e, s, r)`` runs after dealing, to
        inject faults.  ``rlc`` is the point RLC's schedule (``"pippenger"``,
        the fastest of the three on the H100 at every path's shape since its
        scatter and close are one launch each, ``"straus"``, the JAX
        package's default on its accelerator, or ``"bits"``), ``digest`` the transcript digest's
        leg (``"device"``, the JAX package's own choice on its accelerator,
        or ``"host"``) and ``mul`` the multiply of its canonical affine form
        (``"classic"``, ``mod_mul``, or ``"gemm"``, the fused multiply-reduce
        of ``mxu_batch_inv`` and ``mxu_mod_mul``); every
        output but the timings is the same under each.  Returns tensors (``bare``, ``randomized``,
        ``shares``, ``hidings``, ``rho``, ``ok``, ``qualified``,
        ``final_shares``, ``master``), ``complaints`` as 1-based (recipient,
        dealer) pairs, and ``phase_seconds`` (host clock, each phase ended
        by a device synchronise)."""
        if rlc not in RLC_MODES:
            raise ValueError(f"rlc must be one of {RLC_MODES}, got {rlc!r}")
        if digest not in DIGESTS:
            raise ValueError(f"digest must be one of {DIGESTS}, got {digest!r}")
        gd.field_mul(mul)  # raises for an unknown mul
        cfg = self.cfg
        seconds = {"tables": self.table_seconds}
        clock = time.perf_counter()

        def phase(name):
            nonlocal clock
            self._sync()
            now = time.perf_counter()
            seconds[name] = now - clock
            clock = now

        a, e, s, r = deal(cfg, self.coeffs_a, self.coeffs_b, self.g_table, self.h_table)
        phase("deal")
        if tamper is not None:
            a, e, s, r = tamper(a, e, s, r)
            clock = time.perf_counter()
        rho = fh.to_tensor(derive_rho(cfg, a, e, s, r, rho_bits, digest=digest, mul=mul), self.device)
        phase("fiat_shamir")
        ok = verify_batch(cfg, e, s, r, rho, rho_bits, self.g_table, self.h_table, rlc)
        phase("verify")
        out = {"bare": a, "randomized": e, "shares": s, "hidings": r, "rho": rho, "ok": ok,
               "complaints": [], "phase_seconds": seconds}
        qualified = torch.ones(cfg.n, dtype=torch.bool, device=self.device)
        if not bool(ok.all()):
            pw = verify_pairwise(cfg, e, s, r, self.g_table, self.h_table).cpu().numpy()
            guilty = ~pw.all(axis=1)
            out["complaints"] = [(int(i) + 1, int(j) + 1) for j, i in zip(*np.nonzero(~pw))]
            qualified = torch.as_tensor(~guilty, device=self.device)
            phase("blame")
            if int(guilty.sum()) > cfg.t:
                out["qualified"] = qualified
                out["error"] = DkgError(DkgErrorKind.MISBEHAVIOUR_HIGHER_THRESHOLD)
                return out
        out["qualified"] = qualified
        out["final_shares"] = aggregate_shares(cfg, s, qualified)
        out["master"] = master_key_from_bare(cfg, a, qualified)
        phase("finalise")
        return out
