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

The memory-bounded layer (the JAX package's, for the sizes the system
exists for: BLS12-381 G1 at n = 16384 holds 66.7 GiB of coefficients, E,
s and r on an 80 GB card): dealing in two passes, commitments then
shares, each by dealer chunk (``deal_chunked``); the point RLC by column
chunk (``_point_rlc``); the transcript digest by dealer chunk
(``transcript_rows_chunked``); in ``run()``'s chunked flow A is never
whole, each chunk row-digested and cut to its first column as the
commitments pass makes it (``deal_commitments_a0``).  Every loop is
``utils.scanchunk.map_chunked``, its outputs written in place; the chunk
defaults come from the card's free memory, and on the CPU and at every n
<= 1024 they are one pass.  ``matmul=True`` routes ``eval_many`` and the
scalar RLCs through ``fields.matmul.matmul_mod`` (the JAX package's
DKG_TPU_MXU=1).

Every function takes tensors on one device.  On the card the point and
field work goes through the CUDA kernels of ``dkg_tpu_torch/csrc``; on
the CPU through their plain versions.
"""

from __future__ import annotations

import contextlib
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
from ..fields import matmul as fmm
from ..groups import device as gd
from ..groups import host as gh
from ..groups import precompute as gp
from ..ops import field_kernels as fk
from ..ops import point_kernels as pk
from ..poly import device as pdev
from ..utils.scanchunk import map_chunked
from ..utils.tracing import phase_span
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

    def padded(self, n_pad: int, t_pad: int) -> "CeremonyConfig":
        """The shape-bucketed twin of this config (``service.buckets``):
        same curve, lanes padded to ``(n_pad, t_pad)``.  The caller
        zero-pads the coefficients (phantom dealers are zero polynomials,
        real ones gain zero high-order coefficients), which deal zero
        shares and identity commitments; every round-1 kernel is
        elementwise along the dealer axis, so the real lanes equal the
        unpadded run's.  Phantom dealers are masked out of ``qualified``
        before aggregation."""
        if n_pad < self.n or t_pad < self.t:
            raise ValueError(f"padded({n_pad}, {t_pad}): bucket must dominate the real "
                             f"shape (n={self.n}, t={self.t})")
        return CeremonyConfig(self.curve, n_pad, t_pad)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it is CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain versions")
    return device


# ---------------------------------------------------------------------------
# round 1: dealing
# ---------------------------------------------------------------------------

# The card's budget for one pass's chunk temps: what is free after the
# pass's own outputs, at least DEAL_BUDGET_MIN, at most DEAL_BUDGET_MAX
# (BLS12-381 G1 at n = 16384 leaves about 12 GiB of an H100's 80 GB beside
# its 66.7 GiB of coefficients, E, s and r); the digest, whose torch ops run
# faster on longer tensors, at most DIGEST_BUDGET_MAX.
DEAL_BUDGET_MIN, DEAL_BUDGET_MAX, DIGEST_BUDGET_MAX = 1 << 30, 4 << 30, 8 << 30
# Temps of a dealer row in units of its (t+1) points' bytes: in the
# commitments pass A's and h·b's rows, E's row before its copy into place
# and fixed_base_mul's digits; digesting the row adds affine_canon's
# copies, its int64 words with their padded copy and the BLAKE2s state
# (several hundred bytes a 64-byte block).
COMMIT_TEMPS, DIGEST_TEMPS = 4, 24


def free_device_bytes(device) -> int:
    """Bytes the card can still hand out: what ``cudaMemGetInfo`` reports
    free and what PyTorch's caching allocator holds unused."""
    device = torch.device(device)
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def total_device_bytes(device) -> int:
    """The card's whole memory, as its properties report it: the same on
    every call, whatever else holds memory on the card."""
    return torch.cuda.get_device_properties(torch.device(device)).total_memory


def _budget_chunk(free_bytes: int, io_bytes: int, per_dealer: int, cap: int = DEAL_BUDGET_MAX) -> int:
    """Dealers a chunk: the budget over ``per_dealer`` temp bytes, floored
    to a power of two (every full chunk the same shape, the last ragged)."""
    budget = min(cap, max(DEAL_BUDGET_MIN, free_bytes - io_bytes))
    chunk = max(1, budget // max(1, per_dealer))
    return 1 << (chunk.bit_length() - 1)


def _sizes(cfg: CeremonyConfig) -> tuple[int, int]:
    cs = cfg.cs
    return cs.ncoords * cs.field.limbs * 4, cs.scalar.limbs * 4  # bytes of a point, of a scalar


def _deal_chunk_default(cfg: CeremonyConfig, m: int | None = None, free_bytes: int | None = None, *,
                        a0: bool = False) -> int:
    """Dealer rows a chunk of the commitments pass
    (:func:`deal_commitments_traced_chunked`), from ``free_bytes`` (default:
    what the card has free, :func:`free_device_bytes`) less the pass's
    outputs for ``m`` rows (E, and A or, with ``a0``, its first column),
    over COMMIT_TEMPS of a row (with ``a0`` also DIGEST_TEMPS, under the
    digest's cap: the row is digested in the pass).  The JAX package's formula charges a 15 GiB
    device and the TPU's (8, 128) tile padding instead."""
    m = cfg.n if m is None else m
    pt, _ = _sizes(cfg)
    if free_bytes is None:
        free_bytes = free_device_bytes("cuda")
    row = (cfg.t + 1) * pt
    io_bytes = m * row + m * (pt if a0 else row)
    if a0:  # mostly the digest's temps, under the digest's cap
        return _budget_chunk(free_bytes, io_bytes, row * (COMMIT_TEMPS + DIGEST_TEMPS), DIGEST_BUDGET_MAX)
    return _budget_chunk(free_bytes, io_bytes, row * COMMIT_TEMPS)


def _keeps_a(cfg: CeremonyConfig, total_bytes: int) -> bool:
    """Whether ``run(chunk=None)`` keeps A whole on a card of
    ``total_bytes``: the a0 flow's dealer chunk at the whole card's memory
    covers every dealer.  It depends on n, t and the card alone, never on
    what is free, so the keys of run()'s result do not either."""
    return _deal_chunk_default(cfg, cfg.n, total_bytes, a0=True) >= cfg.n


def _shares_chunk_default(cfg: CeremonyConfig, m: int | None = None, free_bytes: int | None = None) -> int:
    """Dealer rows a chunk of the shares pass
    (:func:`deal_shares_traced_chunked`): the budget after both share
    matrices for ``m`` rows, over a row's two chunk outputs before their
    copy into place (the Horner kernel has no other temps)."""
    m = cfg.n if m is None else m
    _, sc = _sizes(cfg)
    if free_bytes is None:
        free_bytes = free_device_bytes("cuda")
    return _budget_chunk(free_bytes, 2 * m * cfg.n * sc, 2 * cfg.n * sc)


def _digest_chunk_default(cfg: CeremonyConfig, free_bytes: int | None = None) -> int:
    """Dealer rows a chunk of the transcript digest
    (:func:`transcript_rows_chunked`): DIGEST_TEMPS of a dealer's E row
    and of its s‖r row, which the digest holds one after the other."""
    pt, sc = _sizes(cfg)
    if free_bytes is None:
        free_bytes = free_device_bytes("cuda")
    return _budget_chunk(free_bytes, 0, DIGEST_TEMPS * max((cfg.t + 1) * pt, 2 * cfg.n * sc), DIGEST_BUDGET_MAX)


def _resolve_chunk(chunk: int | None, device, default) -> int:
    """``chunk`` as given (0: one pass); None: ``default()`` on the card,
    one pass on the CPU, as the JAX package chunks only on its TPU."""
    if chunk is not None:
        if chunk < 0:
            raise ValueError(f"chunk must be >= 0, got {chunk}")
        return chunk
    return default() if torch.device(device).type == "cuda" else 0


def deal(cfg: CeremonyConfig, coeffs_a, coeffs_b, g_table, h_table):
    """All dealers' round-1 outputs: coefficients (n, t+1, L) ->
    A (n, t+1, C, L), E (n, t+1, C, L), s (n, n, L) with s[j, i] = f_j(i+1),
    r (n, n, L) the hiding shares."""
    a_pub, e_comm = deal_commitments(cfg, coeffs_a, coeffs_b, g_table, h_table)
    shares, hidings = deal_shares(cfg, coeffs_a, coeffs_b)
    return a_pub, e_comm, shares, hidings


def deal_commitments_traced_chunked(cfg: CeremonyConfig, coeffs_a, coeffs_b, g_table, h_table,
                                    chunk: int | None = None):
    """The commitments pass, (A, E), in chunks of ``chunk`` dealer rows
    (None: :func:`_deal_chunk_default` on the card, one pass on the CPU;
    0: one pass), written into E and A allocated once.  The first of the
    dealing round's two passes: its temps are freed before the shares
    pass allocates its own."""
    m = coeffs_a.shape[0]
    chunk = _resolve_chunk(chunk, coeffs_a.device, lambda: _deal_chunk_default(cfg, m))
    return map_chunked(m, chunk, lambda off, w: deal_commitments(
        cfg, coeffs_a[off : off + w], coeffs_b[off : off + w], g_table, h_table))


def deal_shares_traced_chunked(cfg: CeremonyConfig, coeffs_a, coeffs_b, chunk: int | None = None, *,
                               matmul: bool = False):
    """The shares pass, (s, r), in chunks of ``chunk`` dealer rows (None:
    :func:`_shares_chunk_default` on the card, one pass on the CPU; 0: one
    pass), written into s and r allocated once."""
    m = coeffs_a.shape[0]
    chunk = _resolve_chunk(chunk, coeffs_a.device, lambda: _shares_chunk_default(cfg, m))
    return map_chunked(m, chunk, lambda off, w: deal_shares(
        cfg, coeffs_a[off : off + w], coeffs_b[off : off + w], matmul=matmul))


def deal_chunked(cfg: CeremonyConfig, coeffs_a, coeffs_b, g_table, h_table, chunk: int | None = None):
    """:func:`deal` in two passes, the commitments then the shares, each in
    chunks of ``chunk`` dealer rows (None: each pass's default on the card,
    one pass on the CPU; 0: one pass), the outputs written in place: each
    dealer's row is independent, so the result equals one-shot ``deal``
    bit for bit.  The rows are the ones supplied, which may be fewer than
    ``cfg.n`` (a party dealing alone).  An explicit ``chunk`` always wins;
    the port reads no DKG_TPU_DEAL_CHUNK."""
    a_pub, e_comm = deal_commitments_traced_chunked(cfg, coeffs_a, coeffs_b, g_table, h_table, chunk)
    shares, hidings = deal_shares_traced_chunked(cfg, coeffs_a, coeffs_b, chunk)
    return a_pub, e_comm, shares, hidings


def deal_commitments_a0(cfg: CeremonyConfig, coeffs_a, coeffs_b, g_table, h_table, chunk: int, *,
                        digest: str = "device", mul: str = "classic"):
    """The commitments pass with A never whole (the JAX mesh's a0
    discipline): each chunk of A is row-digested (:func:`_point_rows`,
    domain 1) and cut to its first column as the pass makes it.  Returns
    a0 (n, C, L), E (n, t+1, C, L) and A's (n, 8) uint32 row digests."""

    def call(off, w):
        a, e = deal_commitments(cfg, coeffs_a[off : off + w], coeffs_b[off : off + w], g_table, h_table)
        rows = torch.from_numpy(_point_rows(cfg, a, 1, digest=digest, mul=mul).astype(np.int64))
        return a[:, 0].contiguous(), e, rows

    a0, e_comm, rows_a = map_chunked(coeffs_a.shape[0], chunk, call)
    return a0, e_comm, rows_a.numpy().astype(np.uint32)


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


def deal_shares(cfg: CeremonyConfig, coeffs_a, coeffs_b, *, matmul: bool = False):
    fs = cfg.cs.scalar
    xs = _index_limbs(fs, cfg.n, coeffs_a.device)
    return (pdev.eval_many(fs, coeffs_a, xs, matmul=matmul), pdev.eval_many(fs, coeffs_b, xs, matmul=matmul))


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------


def _field_dot(fs, weights: torch.Tensor, values: torch.Tensor, *, matmul: bool = False) -> torch.Tensor:
    """Σ_j weights[j]·values[j, ...] mod p: weights (m, L), values
    (m, ..., L) -> (..., L), one ``mod_madd_dot`` launch (the fold
    acc <- w_j·v_j + acc of ``mod_madd``'s step).  With ``matmul`` (the
    JAX package's DKG_TPU_MXU=1), where values is (m, K, L) and m <=
    ``fields.matmul.MAX_K``, the one-row ``matmul_mod`` instead; the same
    canonical residues."""
    if matmul and values.dim() == 3 and weights.shape[0] <= fmm.MAX_K:
        return fmm.matmul_mod(fs, weights[None], values.transpose(0, 1))[0]
    return fk.mod_madd_dot(fs, weights, values)


RLC_MODES = ("straus", "bits", "pippenger")
# The card's budget for a column chunk's Straus tables or Pippenger
# buckets (the JAX package's is 256 MB): every n <= 1024 path's RLC is
# one chunk; BLS12-381 G1 at n = 16384, t = 5461 takes about 1.18 MB of
# buckets a column, so 1820 columns a chunk.
RLC_BUDGET_BYTES = 2 << 30


def _rlc_col_bytes(cs: gd.CurveSpec, m: int, nbits: int, mode: str) -> int:
    """Temp bytes a column of the point RLC takes under ``mode``: its m
    16-entry Straus tables, or its windows' Pippenger buckets."""
    pt = cs.ncoords * cs.field.limbs * 4
    if mode == "straus":
        return m * 16 * pt
    c = gd.pippenger_window(m, cs.name)
    return -(-nbits // c) * (1 << c) * pt


def _rlc_chunk_default(cs: gd.CurveSpec, shape: tuple, nbits: int, mode: str) -> int:
    """Columns a chunk of the point RLC over points of ``shape`` (m, cols,
    ..., C, L): as many as RLC_BUDGET_BYTES holds, the further batch axes
    multiplying a column's bytes; 0 (one pass) for the bit-at-a-time
    schedule, which is never chunked."""
    if mode == "bits" or len(shape) <= 3:
        return 0
    per_col = _rlc_col_bytes(cs, shape[0], nbits, mode)
    for extra in shape[2:-2]:
        per_col *= extra
    return max(1, RLC_BUDGET_BYTES // per_col)


def _point_rlc(cs: gd.CurveSpec, weights: torch.Tensor, points: torch.Tensor, nbits: int,
               mode: str = "straus", chunk: int | None = None) -> torch.Tensor:
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

    Under Straus and Pippenger the columns (axis 1 of points, the further
    batch axes multiplying a column's bytes) run in sequential chunks of
    ``chunk`` (None: as many as RLC_BUDGET_BYTES holds; 0: one pass), each
    written in place (``utils.scanchunk.map_chunked``), as the JAX package
    bounds its TPU memory; the bit-at-a-time schedule, there as here, runs
    whole.  Chunking changes no limb."""
    if mode not in RLC_MODES:
        raise ValueError(f"rlc must be one of {RLC_MODES}, got {mode!r}")
    if mode != "bits" and points.dim() > 3:
        if chunk is None:
            chunk = _rlc_chunk_default(cs, points.shape, nbits, mode)
        if chunk and points.shape[1] > chunk:
            return map_chunked(points.shape[1], chunk, lambda off, w: _point_rlc(
                cs, weights, points[:, off : off + w], nbits, mode, chunk=0))
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
                 rlc: str = "pippenger", *, rlc_chunk: int | None = None, matmul: bool = False):
    """RLC batch share verification -> (n,) bool per recipient.

    e_comm (n, t+1, C, L), shares/hidings (n, n, L) with [j, i] as
    recipient i received it from dealer j, rho (n, L) with only the low
    rho_bits bits set.  Sound up to 2^-rho_bits per cheating dealer.
    ``rlc`` is the point RLC's schedule (:data:`RLC_MODES`), ``rlc_chunk``
    its column chunk (:func:`_point_rlc`), ``matmul`` the scalar RLCs'
    route (:func:`_field_dot`)."""
    cs = cfg.cs
    fs = cs.scalar
    s_rlc = _field_dot(fs, rho, shares, matmul=matmul)  # (n, L): Σ_j rho_j s_ji
    r_rlc = _field_dot(fs, rho, hidings, matmul=matmul)
    d_comm = _point_rlc(cs, rho, e_comm, rho_bits, rlc, chunk=rlc_chunk)  # (t+1, C, L): Σ_j rho_j E_jl
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
    (n_recip, L): one ``mod_madd_dot`` launch with the 0/1 weights of
    ``qualified`` (its plain version on the CPU), reading the shares where
    they lie, never a masked copy.  The residues are canonical, so they
    equal the JAX package's masked sequential sum."""
    fs = cfg.cs.scalar
    weights = fd.zeros(fs, qualified.shape, device=shares.device)
    weights[:, 0] = qualified.to(torch.int32)
    return fk.mod_madd_dot(fs, weights, shares)


def master_key_from_bare(cfg: CeremonyConfig, a0, qualified):
    """Master public key: Σ over qualified dealers of A_{j,0}, from the
    first commitment column a0 (n, C, L) -> (C, L); the JAX package takes
    the whole A and reads its first column."""
    cs = cfg.cs
    masked = gd.select(qualified, a0, gd.identity(cs, a0.shape[:-2], device=a0.device))
    return gd._tree_reduce(cs, masked, masked.shape[0])


# ---------------------------------------------------------------------------
# transcript digest and Fiat-Shamir randomizers
# ---------------------------------------------------------------------------

DIGESTS = ("device", "host")


def _point_rows(cfg: CeremonyConfig, pts, domain: int, *, digest: str = "device", mul: str = "classic") -> np.ndarray:
    """BLAKE2s Merkle digests of k dealers' commitment rows (k, t+1, C, L)
    in canonical affine form (rho must not depend on which addition
    schedule produced the projective coordinates) -> (k, 8) uint32.

    ``digest="device"`` canonicalises (``gd.affine_canon`` with ``mul``'s
    multiply) and hashes (``crypto/device_hash.py``) where the tensors are;
    ``"host"`` moves them to the host for big-int canonicalisation
    (``gd.affine_canon_host``) and the numpy tree (``row_digests_np``).
    They stand for the JAX package's ``DKG_TPU_DIGEST=device|host``."""
    k = pts.shape[0]
    if digest == "host":
        return row_digests_np(gd.affine_canon_host(cfg.cs, fh.from_tensor(pts)).reshape(k, -1), domain=domain)
    if digest != "device":
        raise ValueError(f"digest must be one of {DIGESTS}, got {digest!r}")
    return dh.to_numpy(dh.row_digests(gd.affine_canon(cfg.cs, pts, mul=mul).reshape(k, -1), domain=domain))


def _share_rows(shares, hidings, *, digest: str = "device") -> np.ndarray:
    """BLAKE2s Merkle digests (domain 3) of k dealers' share and hiding
    rows, each dealer's s‖r row: (k, n, L) x2 -> (k, 8) uint32."""
    k = shares.shape[0]
    if digest == "host":
        sr = np.concatenate([fh.from_tensor(shares).reshape(k, -1), fh.from_tensor(hidings).reshape(k, -1)], axis=-1)
        return row_digests_np(sr, domain=3)
    if digest != "device":
        raise ValueError(f"digest must be one of {DIGESTS}, got {digest!r}")
    return dh.to_numpy(dh.row_digests(torch.cat([shares.reshape(k, -1), hidings.reshape(k, -1)], dim=-1), domain=3))


def _dealer_rows(cfg: CeremonyConfig, a_comm, e_comm, shares, hidings, *, digest: str = "device",
                 mul: str = "classic"):
    """Per-dealer BLAKE2s Merkle digests of the four round-1 tensors (k
    dealers' rows of each): three (k, 8) uint32 arrays, the same under
    either leg (:func:`_point_rows` for A and E, :func:`_share_rows`)."""
    return (_point_rows(cfg, a_comm, 1, digest=digest, mul=mul), _point_rows(cfg, e_comm, 2, digest=digest, mul=mul),
            _share_rows(shares, hidings, digest=digest))


def transcript_rows_chunked(cfg: CeremonyConfig, a_comm, e_comm, shares, hidings, chunk: int | None = None, *,
                            digest: str = "device", mul: str = "classic", rows_a: np.ndarray | None = None):
    """:func:`_dealer_rows` on slices of ``chunk`` dealer rows (None:
    :func:`_digest_chunk_default` on the card, one pass on the CPU; 0: one
    pass), the three (n, 8) arrays in dealer order: the JAX package's
    ``sharded_transcript_digest`` with chunks in place of shards.  Each
    chunk's canonical form, words and s‖r row live only while it is
    hashed.  ``rows_a`` gives A's rows already made (the a0 flow), and
    then ``a_comm`` is not read."""
    chunk = _resolve_chunk(chunk, shares.device, lambda: _digest_chunk_default(cfg))

    def call(off, w):
        sl = slice(off, off + w)
        rows = (_point_rows(cfg, e_comm[sl], 2, digest=digest, mul=mul), _share_rows(shares[sl], hidings[sl], digest=digest))
        if rows_a is None:
            rows = (_point_rows(cfg, a_comm[sl], 1, digest=digest, mul=mul),) + rows
        return tuple(torch.from_numpy(r.astype(np.int64)) for r in rows)

    rows = tuple(r.numpy().astype(np.uint32) for r in map_chunked(shares.shape[0], chunk, call))
    return rows if rows_a is None else (rows_a,) + rows


def _fold_digest_device(cfg: CeremonyConfig, rows_a, rows_e, rows_sr) -> bytes:
    """Fold the three per-dealer row digest arrays, in dealer order, into
    one BLAKE2b."""
    h = hashlib.blake2b(digest_size=32, person=b"dkgtpu-trd")
    h.update(f"{cfg.curve}|{cfg.n}|{cfg.t}|".encode())
    for rows in (rows_a, rows_e, rows_sr):
        h.update(np.ascontiguousarray(rows, np.uint32))
    return h.digest()


def transcript_digest_device(cfg: CeremonyConfig, a_comm, e_comm, shares, hidings, *, digest: str = "device",
                             mul: str = "classic", chunk: int | None = None) -> bytes:
    """The canonical engine transcript digest (the JAX package's device
    family), by either leg of :func:`_dealer_rows`, over dealer chunks of
    ``chunk`` rows (:func:`transcript_rows_chunked`): the same bytes for
    every chunk."""
    return _fold_digest_device(cfg, *transcript_rows_chunked(cfg, a_comm, e_comm, shares, hidings, chunk,
                                                             digest=digest, mul=mul))


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
        (n, t+1, L) arrays, or int32 limb tensors (those already on the
        ceremony's device are taken as they are, not copied: at n = 16384
        the 2 n (t+1) host ints alone take minutes to draw), and its (NW,
        256, C, L) g/h tables if given.  Limbs must be < 2**16 and each
        element below the scalar order."""
        self = cls.__new__(cls)
        self._setup(curve, n, t, shared_string, device, g_table, h_table)
        shape = (n, t + 1, self.cfg.cs.scalar.limbs)
        for name, arr in (("coeffs_a", coeffs_a), ("coeffs_b", coeffs_b)):
            if tuple(np.shape(arr)) != shape:
                raise ValueError(f"{name} has shape {np.shape(arr)}, expected {shape}")
            if isinstance(arr, torch.Tensor):
                if arr.dtype != torch.int32 or bool(((arr < 0) | (arr > 0xFFFF)).any()):
                    raise ValueError(f"{name} must hold int32 limbs in [0, 2**16)")
                setattr(self, name, arr.to(self.device).contiguous())
            else:
                setattr(self, name, fh.to_tensor(arr, self.device))
        return self

    def _setup(self, curve, n, t, shared_string, device, g_table=None, h_table=None):
        self.device = resolve_device(device)
        self.cfg = CeremonyConfig(curve, n, t)
        cs = self.cfg.cs
        self.group = gh.ALL_GROUPS[curve]
        self.ck = CommitmentKey.generate(self.group, shared_string)
        # the g/h tables come through the precompute caches (the process's,
        # then a disk file, else a build); the counters' delta says which
        # route this ceremony's tables took (run(trace=)'s table_cache)
        before = gp.stats()
        t0 = time.perf_counter()
        self.g_table = (gp.generator_table(cs, device=self.device) if g_table is None
                        else fh.to_tensor(g_table, self.device))
        self.h_table = (gp.base_table(cs, self.ck.h, device=self.device) if h_table is None
                        else fh.to_tensor(h_table, self.device))
        self._sync()
        self.table_seconds = time.perf_counter() - t0
        after = gp.stats()
        self.table_stats = {k: after[k] - before[k] for k in after if isinstance(after[k], int)}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, rho_bits: int = 128, tamper=None, rlc: str = "pippenger", digest: str = "device",
            mul: str = "classic", *, trace=None, chunk: int | None = None, rlc_chunk: int | None = None,
            matmul: bool = False) -> dict:
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
        or ``"host"``), ``mul`` the multiply of its canonical affine form
        (``"classic"``, ``mod_mul``, or ``"gemm"``, the fused multiply-reduce
        of ``mxu_batch_inv`` and ``mxu_mod_mul``) and ``matmul`` the route
        of ``eval_many`` and the scalar RLCs (``fields.matmul.matmul_mod``
        in place of ``mod_madd_horner`` / ``mod_madd_dot``: the JAX
        package's DKG_TPU_MXU=1).  ``trace``, a
        ``utils.tracing.CeremonyTrace``, gets the tables' seconds, one span a
        phase, fiat_shamir's sub-timings and meta curve, n, t and
        ``table_cache`` (the precompute counters' delta of this ceremony's
        tables: builds, disk_loads, disk_rejects, proc_hits).

        Memory: ``chunk`` is the dealer chunk of the dealing round's two
        passes and of the transcript digest (None: one pass on the CPU; on
        the card each pass's default from the card's free memory when it
        starts; 0: one pass), ``rlc_chunk`` the point RLC's column chunk
        (None: ``RLC_BUDGET_BYTES``).  A stays whole, and the result
        carries ``bare`` beside ``bare0`` (the (n, C, L) first columns),
        when ``chunk`` is 0 or at least n, and with None on the CPU or
        where :func:`_keeps_a` says so from n, t and the card's whole
        memory (on an 80 GB H100 at every n <= 1024, not at n = 4096).
        Otherwise A is never whole: each chunk is row-digested and cut to
        its first column as the pass makes it, and the result carries
        ``bare0`` and no ``bare``.  So the keys follow the arguments, n, t
        and the card, never the free memory; the chunk sizes, and with
        them the launch counts, may.  The chunked flow takes no ``tamper``
        (passing both raises).  Every output but the timings and ``chunks`` is the same
        under each argument.  Returns tensors (``bare`` where A stayed
        whole, ``bare0``, ``randomized``, ``shares``, ``hidings``, ``rho``,
        ``ok``, ``qualified``, ``final_shares``, ``master``), ``complaints``
        as 1-based (recipient, dealer) pairs, ``transcript`` (the digest
        bytes rho is derived from), ``chunks`` (the resolved dealer chunks
        of the ``deal``, ``shares`` and ``digest`` passes and the ``rlc``'s
        column chunk, 0 for one pass) and ``phase_seconds`` (host clock,
        each phase ended by a device synchronise; under chunking A's digest
        falls in the deal phase)."""
        if rlc not in RLC_MODES:
            raise ValueError(f"rlc must be one of {RLC_MODES}, got {rlc!r}")
        if digest not in DIGESTS:
            raise ValueError(f"digest must be one of {DIGESTS}, got {digest!r}")
        gd.field_mul(mul)  # raises for an unknown mul
        if tamper is not None and chunk:
            raise ValueError("the chunked flow takes no tamper: run tampered ceremonies in one pass (chunk=0)")
        cfg, n = self.cfg, self.cfg.n
        if tamper is not None:
            chunk = 0
        seconds = {"tables": self.table_seconds}
        if trace is not None:
            trace.record("tables", self.table_seconds)
            trace.meta["table_cache"] = dict(self.table_stats)

        @contextlib.contextmanager
        def phase(name):
            t0 = time.perf_counter()
            with phase_span(trace, name):
                yield
                self._sync()
            seconds[name] = time.perf_counter() - t0

        # dealer rows a chunk (0: one pass), each pass's default taken from
        # what the card has free when the pass starts; and the RLC's columns.
        # Whether A stays whole follows the argument, or with None, n, t and
        # the card's whole memory (_keeps_a), never its free bytes
        if chunk is None:
            keep_a = self.device.type != "cuda" or _keeps_a(cfg, total_device_bytes(self.device))
            chunks = {"deal": 0 if keep_a else _deal_chunk_default(cfg, n, a0=True)}
        else:
            chunks = {"deal": _resolve_chunk(chunk, self.device, None)}
            keep_a = not chunk or chunk >= n
        with phase("deal"):
            if keep_a:
                a, e = deal_commitments(cfg, self.coeffs_a, self.coeffs_b, self.g_table, self.h_table)
                a0, rows_a = a[:, 0], None
            else:
                a = None
                a0, e, rows_a = deal_commitments_a0(cfg, self.coeffs_a, self.coeffs_b, self.g_table, self.h_table,
                                                    chunks["deal"], digest=digest, mul=mul)
            chunks["shares"] = _resolve_chunk(chunk, self.device, lambda: _shares_chunk_default(cfg, n))
            s, r = deal_shares_traced_chunked(cfg, self.coeffs_a, self.coeffs_b, chunks["shares"], matmul=matmul)
        if tamper is not None:
            a, e, s, r = tamper(a, e, s, r)
            a0 = a[:, 0]
        with phase("fiat_shamir"):
            t0 = time.perf_counter()
            chunks["digest"] = _resolve_chunk(chunk, self.device, lambda: _digest_chunk_default(cfg))
            rows = transcript_rows_chunked(cfg, a, e, s, r, chunks["digest"], digest=digest, mul=mul, rows_a=rows_a)
            t1 = time.perf_counter()
            transcript = _fold_digest_device(cfg, *rows)
            rho = fh.to_tensor(fiat_shamir_rho(cfg, transcript, rho_bits), self.device)
            if trace is not None:
                trace.record_sub("fiat_shamir", "digest", t1 - t0)
                trace.record_sub("fiat_shamir", "rho", time.perf_counter() - t1)
                trace.meta["digest_dispatch"] = digest
        chunks["rlc"] = (_rlc_chunk_default(cfg.cs, (n, cfg.t + 1, cfg.cs.ncoords, cfg.cs.field.limbs), rho_bits, rlc)
                         if rlc_chunk is None else rlc_chunk)
        with phase("verify"):
            ok = verify_batch(cfg, e, s, r, rho, rho_bits, self.g_table, self.h_table, rlc, rlc_chunk=chunks["rlc"],
                              matmul=matmul)
        out = {"bare0": a0, "randomized": e, "shares": s, "hidings": r, "rho": rho, "ok": ok,
               "complaints": [], "phase_seconds": seconds, "transcript": transcript, "chunks": chunks}
        if a is not None:
            out["bare"] = a
        if trace is not None:
            trace.meta.update({"curve": cfg.curve, "n": cfg.n, "t": cfg.t})
        qualified = torch.ones(n, dtype=torch.bool, device=self.device)
        if not bool(ok.all()):
            with phase("blame"):
                pw = verify_pairwise(cfg, e, s, r, self.g_table, self.h_table).cpu().numpy()
                guilty = ~pw.all(axis=1)
                out["complaints"] = [(int(i) + 1, int(j) + 1) for j, i in zip(*np.nonzero(~pw))]
                qualified = torch.as_tensor(~guilty, device=self.device)
            if int(guilty.sum()) > cfg.t:
                out["qualified"] = qualified
                out["error"] = DkgError(DkgErrorKind.MISBEHAVIOUR_HIGHER_THRESHOLD)
                return out
        out["qualified"] = qualified
        with phase("finalise"):
            out["final_shares"] = aggregate_shares(cfg, s, qualified)
            out["master"] = master_key_from_bare(cfg, a0, qualified)
        return out
