"""Warm execution lane: pad-and-mask ceremonies over shared runtime state.

Counterpart of ``dkg_tpu/service/engine.py``.  One process serves many
ceremonies, so everything curve-dependent is shared and warm:

* :class:`WarmRuntime` holds the commitment key and the g/h window tables
  per ``(curve, shared_string)``, on its device, built once under its
  lock;
* every request's ``(n, t)`` is padded to its ``buckets.bucket_for``
  bucket (``CeremonyConfig.padded``), so same-bucket requests stack;
* same-bucket requests stack on a leading *convoy axis* and run through
  the stacked twins of the round functions (:func:`_deal_stack`,
  :func:`_verify_stack`, :func:`_finalise_stack`), plain functions over
  tensors with that leading axis, where the JAX package ``jax.vmap``\\ s
  its round functions.  Every kernel of a convoy is launched once, never
  in a Python loop over its k ceremonies: the deal folds the convoy into
  the lanes of ``pt_fixed_base`` and ``mod_madd_horner``; the verify's
  weighted sums, whose Fiat-Shamir weights differ from ceremony to
  ceremony, take ``mod_madd_dot`` and ``pt_bucket_sum`` with a convoy
  axis (one weight or digit block a ceremony); the transcript rows of all
  k·n dealers are one ``_dealer_rows`` pass.

Bit-exactness: phantom lanes are zero-coefficient dealers (zero shares,
identity commitments) and every round-1 kernel is elementwise along the
dealer and convoy axes, so a real lane's outputs, wire bytes included,
are the same whether it runs unpadded, padded or stacked.  The
randomizers rho bind the padded tensors, so they differ from the
unpadded run's (and equal the JAX package's at the same padded shape);
that changes which random combination checks the same pair equations,
never the dealt values, the qualified set of an honest run, or the
master key.

:func:`start_convoy` draws, pads and copies the coefficients (pinned,
non-blocking) and enqueues the stacked deal: it waits on nothing on the
card, so a scheduler worker starts convoy k+1 before finishing convoy k.
The first wait is in :func:`finish_convoy`, where the transcript rows
come to the host.  Both take the runtime's ``turn`` lock: a convoy's
time on the card is host time (Python and many small enqueues, flat in
the convoy's width), and threads that interleave such work hand the
interpreter lock back and forth at every op, so four scheduler workers
without the lock served far fewer ceremonies a second than one thread
does (PERF.md §6).  The JAX package's executable store (``aot.py``)
has no counterpart: ``WarmRuntime.warmup`` runs one throwaway convoy per
width, which builds and loads the kernel libraries and warms the caching
allocator.

Every entry point that makes tensors runs on the runtime's device, the
card unless ``WarmRuntime(device="cpu")`` (the tests), where the kernels'
plain versions run.  No kernel error is caught here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import threading

import numpy as np
import torch

from ..crypto.commitment import CommitmentKey
from ..dkg import ceremony as ce
from ..fields import device as fd
from ..fields import host as fh
from ..groups import device as gd
from ..groups import host as gh
from ..groups import precompute as gp
from ..ops import field_kernels as fk
from . import buckets
from .errors import PoisonedRequest

#: Default domain-separation string for service ceremonies (requests may
#: override; the commitment key h derives from it).
DEFAULT_SHARED_STRING = b"dkg-tpu-service"


@dataclasses.dataclass(frozen=True)
class CeremonyRequest:
    """One ceremony-as-a-service request (the JAX package's fields).

    ``seed`` pins the coefficient stream (``random.Random(seed)``, drawn in
    ``BatchedCeremony``'s order), so a journal replay re-deals the same
    polynomials; ``None`` uses ``random.SystemRandom`` (non-durable
    requests only).  ``deadline_s`` is a budget from admission."""

    curve: str
    n: int
    t: int
    shared_string: bytes = DEFAULT_SHARED_STRING
    seed: int | None = None
    rho_bits: int = 128
    deadline_s: float | None = None
    durable: bool = False
    tag: str = ""

    def bucket(self) -> buckets.Bucket:
        return buckets.bucket_for(self.n, self.t)

    def convoy_key(self) -> tuple:
        """Requests sharing this key may stack into one convoy: same
        curve, bucket, randomizer width and commitment key."""
        b = self.bucket()
        return (self.curve, b.n, b.t, self.rho_bits, self.shared_string)


def request_id(req: CeremonyRequest, seq: int = 0) -> str:
    """Deterministic short ceremony id from the request and its admission
    sequence number: the JAX package's blake2b-48 id."""
    h = hashlib.blake2b(digest_size=6)
    h.update(f"{req.curve}|{req.n}|{req.t}|{req.seed}|{req.rho_bits}|{seq}|".encode())
    h.update(req.shared_string)
    return h.hexdigest()


@dataclasses.dataclass
class CeremonyOutcome:
    """Public result of one ceremony.  ``master`` is the canonical encoded
    master public key; ``final_shares`` (secret: uint32 (n, L) limbs)
    stays in process memory, never in the journal."""

    ceremony_id: str
    status: str  # "done" | "failed" | "expired" | "poisoned"
    curve: str = ""
    n: int = 0
    t: int = 0
    bucket_n: int = 0
    bucket_t: int = 0
    master: bytes = b""
    qualified: tuple = ()
    complaints: tuple = ()
    error: str = ""
    #: engine wall clock attributed to this ceremony: its convoy's time
    #: divided by the convoy width
    seconds: float = 0.0
    #: time.monotonic() when the scheduler recorded the outcome
    completed_at: float = 0.0
    #: epoch of the held sharing: +1 per refresh or reshare
    epoch: int = 0
    final_shares: np.ndarray | None = dataclasses.field(default=None, repr=False, compare=False)


class WarmRuntime:
    """Shared warm state for every ceremony of a process, on ``device``:
    the commitment key and g/h window tables per ``(curve,
    shared_string)``.  Thread-safe; every scheduler worker holds it."""

    def __init__(self, device="cuda") -> None:
        self.device = ce.resolve_device(device)
        self._lock = threading.Lock()
        self._ck: dict = {}
        #: held by each convoy start and finish (and the scheduler's sign
        #: lane and epoch calls): one thread drives the device at a time
        self.turn = threading.RLock()

    def commitment(self, curve: str, shared_string: bytes):
        """(CommitmentKey, g_table, h_table) of a ceremony environment,
        built once (under the runtime's lock) and kept."""
        key = (curve, shared_string)
        with self._lock:
            hit = self._ck.get(key)
            if hit is None:
                cs = gd.ALL_CURVES[curve]
                ck = CommitmentKey.generate(gh.ALL_GROUPS[curve], shared_string)
                hit = (ck, gp.generator_table(cs, device=self.device), gp.base_table(cs, ck.h, device=self.device))
                self._ck[key] = hit
            return hit

    def warmup(self, req: CeremonyRequest, widths: tuple = (1,)) -> None:
        """One throwaway convoy a width of ``req``'s bucket: builds and loads
        every kernel library the bucket launches and warms the allocator."""
        for w in widths:
            reqs = [dataclasses.replace(req, seed=(req.seed or 0) + i) for i in range(w)]
            finish_convoy(self, start_convoy(self, reqs))


# ---------------------------------------------------------------------------
# stacked (convoy-axis) twins of the round functions
# ---------------------------------------------------------------------------


def _deal_stack(cfg: ce.CeremonyConfig, coeffs_a, coeffs_b, g_table, h_table):
    """(k, n, t+1, L) coefficient stacks -> stacked round-1 tensors A, E
    (k, n, t+1, C, L) and s, r (k, n, n, L): ``ce.deal`` with the convoy
    folded into its lanes (two ``pt_fixed_base``, one ``pt_add``, two
    ``mod_madd_horner`` launches a convoy)."""
    return ce.deal(cfg, coeffs_a, coeffs_b, g_table, h_table)


def _verify_stack(cfg: ce.CeremonyConfig, e_comm, shares, hidings, rho, rho_bits: int, g_table, h_table):
    """``ce.verify_batch`` over a convoy -> (k, n) bool: e_comm (k, n, t+1,
    C, L), shares and hidings (k, n, n, L), rho (k, n, L), each
    ceremony's own weights.  The scalar RLCs are one ``mod_madd_dot``
    each (a weight block a ceremony), the point RLC one Pippenger MSM
    whose scatter is one ``pt_bucket_sum`` (a digit block a ceremony,
    shared by its t+1 columns; at k = 1 the ceremony's shared block), the
    right side one ``pt_ladder_horner``, the left two ``pt_fixed_base``.
    Every width takes this path, width 1 included."""
    cs = cfg.cs
    fs = cs.scalar
    k, n = shares.shape[:2]
    s_rlc = fk.mod_madd_dot(fs, rho, shares)  # (k, n, L)
    r_rlc = fk.mod_madd_dot(fs, rho, hidings)
    # a lone ceremony's digits are the block shared by its columns
    weights = rho[:, None] if k > 1 else rho[0]
    d_comm = gd.msm_pippenger(cs, weights, e_comm.movedim(1, -3), nbits=rho_bits)  # (k, t+1, C, L)
    xs = torch.arange(1, n + 1, dtype=torch.int32, device=e_comm.device).expand(k, n)
    rhs = gd.eval_point_poly(cs, d_comm[:, None], xs, cfg.index_bits)  # (k, n, C, L)
    lhs = gd.add(cs, gd.fixed_base_mul(cs, g_table, s_rlc), gd.fixed_base_mul(cs, h_table, r_rlc))
    return gd.eq(cs, lhs, rhs)


def _finalise_stack(cfg: ce.CeremonyConfig, a_comm, shares, qualified):
    """``ce.aggregate_shares`` and ``ce.master_key_from_bare`` over a
    convoy: a_comm (k, n, t+1, C, L), shares (k, n, n, L), qualified (k,
    n) -> final shares (k, n, L) (the same pairwise tree of field adds
    over the dealers) and masters (k, C, L) (one ``pt_tree_sum``)."""
    cs = cfg.cs
    acc = torch.where(qualified[:, :, None, None], shares, torch.zeros_like(shares))
    while acc.shape[1] > 1:
        if acc.shape[1] % 2:
            acc = torch.cat([acc, torch.zeros_like(acc[:, :1])], dim=1)
        acc = fd.add(cs.scalar, acc[:, 0::2], acc[:, 1::2])
    a0 = a_comm[:, :, 0]
    masked = gd.select(qualified, a0, gd.identity(cs, a0.shape[:-2], device=a0.device))
    return acc[:, 0], gd._tree_reduce(cs, masked, masked.shape[-3])


# ---------------------------------------------------------------------------
# coefficient drawing and padding
# ---------------------------------------------------------------------------


def draw_coeffs(cfg: ce.CeremonyConfig, rng) -> tuple[np.ndarray, np.ndarray]:
    """The real coefficient arrays (uint32 (n, t+1, L)), drawn in
    ``BatchedCeremony``'s order, so a seeded service ceremony and a fresh
    single ceremony of the same seed deal the same polynomials."""
    fs = cfg.cs.scalar
    n, t = cfg.n, cfg.t
    a = fh.encode(fs, [[fs.rand_int(rng) for _ in range(t + 1)] for _ in range(n)])
    b = fh.encode(fs, [[fs.rand_int(rng) for _ in range(t + 1)] for _ in range(n)])
    return a, b


def pad_coeffs(coeffs: np.ndarray, n_pad: int, t_pad: int) -> np.ndarray:
    """Zero-pad a real (n, t+1, L) coefficient array to the bucket shape
    (n_pad, t_pad+1, L): phantom dealers are zero polynomials, real ones
    gain zero high-order coefficients."""
    n, tc, limbs = coeffs.shape
    out = np.zeros((n_pad, t_pad + 1, limbs), np.uint32)
    out[:n, :tc] = coeffs
    return out


def rng_for(req: CeremonyRequest):
    if req.seed is None:
        return random.SystemRandom()
    return random.Random(req.seed)


def derive_rho_convoy(cfg: ce.CeremonyConfig, a, e, s, r, rho_bits: int) -> np.ndarray:
    """Per-ceremony Fiat-Shamir randomizers of a convoy, uint32 (k, n, L):
    equal to ``ce.derive_rho`` on each ceremony's slice.  The transcript
    row digests are per dealer, so the convoy's (k, n, ...) tensors fold
    into one (k·n, ...) pass of ``ce._dealer_rows`` (one canonical affine
    form, one set of BLAKE2s rows), and only the outer BLAKE2b fold runs a
    ceremony at a time, on the host."""
    k, n = s.shape[0], s.shape[1]
    rows = ce._dealer_rows(cfg, a.reshape((k * n,) + a.shape[2:]), e.reshape((k * n,) + e.shape[2:]),
                           s.reshape((k * n,) + s.shape[2:]), r.reshape((k * n,) + r.shape[2:]))
    rows_a, rows_e, rows_sr = (np.asarray(x).reshape(k, n, -1) for x in rows)
    return np.stack([ce.fiat_shamir_rho(cfg, ce._fold_digest_device(cfg, rows_a[i], rows_e[i], rows_sr[i]),
                                        rho_bits) for i in range(k)])


# ---------------------------------------------------------------------------
# convoy execution: start (enqueue) / finish (host work and the device tail)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class InFlight:
    """An enqueued convoy: its round-1 tensors, not yet read."""

    reqs: list
    ids: list
    cfg_pad: ce.CeremonyConfig
    g_table: torch.Tensor
    h_table: torch.Tensor
    a: torch.Tensor  # (k, n_pad, t_pad+1, C, L)
    e: torch.Tensor
    s: torch.Tensor  # (k, n_pad, n_pad, L)
    r: torch.Tensor


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Limbs to ``device`` without waiting on it: a pinned host copy,
    then a non-blocking transfer ordered on the current stream."""
    host = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def start_convoy(runtime: WarmRuntime, reqs: list, ids: list | None = None) -> InFlight:
    """Draw and pad the coefficients of a same-key convoy and enqueue its
    stacked deal.  Returns with nothing on the card waited for."""
    key = reqs[0].convoy_key()
    if any(r.convoy_key() != key for r in reqs):
        raise ValueError("start_convoy: mixed convoy keys")
    with runtime.turn:
        return _start(runtime, reqs, ids)


def _start(runtime: WarmRuntime, reqs: list, ids: list | None) -> InFlight:
    req0 = reqs[0]
    b = req0.bucket()
    cfg_pad = ce.CeremonyConfig(req0.curve, req0.n, req0.t).padded(b.n, b.t)
    _, g_table, h_table = runtime.commitment(req0.curve, req0.shared_string)
    ca, cb = [], []
    for req in reqs:
        a_real, b_real = draw_coeffs(ce.CeremonyConfig(req.curve, req.n, req.t), rng_for(req))
        ca.append(pad_coeffs(a_real, b.n, b.t))
        cb.append(pad_coeffs(b_real, b.n, b.t))
    dev = runtime.device
    a, e, s, r = _deal_stack(cfg_pad, _to_device(np.stack(ca), dev), _to_device(np.stack(cb), dev),
                             g_table, h_table)
    if ids is None:
        ids = [request_id(req, i) for i, req in enumerate(reqs)]
    return InFlight(list(reqs), list(ids), cfg_pad, g_table, h_table, a, e, s, r)


def finish_convoy(runtime: WarmRuntime, fl: InFlight) -> list[CeremonyOutcome]:
    """Transcript digests, the stacked verify, blame where a check failed,
    and the stacked finalise of an enqueued convoy.  The row digests'
    transfer is the first wait on the deal :func:`start_convoy` enqueued."""
    with runtime.turn:
        return _finish(runtime, fl)


def _finish(runtime: WarmRuntime, fl: InFlight) -> list[CeremonyOutcome]:
    dev = runtime.device
    cfg_pad = fl.cfg_pad
    k, n_pad = len(fl.reqs), cfg_pad.n
    rho_bits = fl.reqs[0].rho_bits
    rho = fh.to_tensor(derive_rho_convoy(cfg_pad, fl.a, fl.e, fl.s, fl.r, rho_bits), dev)
    ok = _verify_stack(cfg_pad, fl.e, fl.s, fl.r, rho, rho_bits, fl.g_table, fl.h_table)
    ok_h = ok.cpu().numpy()

    qualified = np.zeros((k, n_pad), bool)
    complaints: list[list[tuple[int, int]]] = [[] for _ in range(k)]
    errors: list[str] = [""] * k
    for i, req in enumerate(fl.reqs):
        qualified[i, : req.n] = True
        if not ok_h[i, : req.n].all():
            # the rare blame path, a ceremony at a time: the engine holds the
            # plaintext share matrix, so the direct re-check adjudicates
            pw = ce.verify_pairwise(cfg_pad, fl.e[i], fl.s[i], fl.r[i], fl.g_table,
                                    fl.h_table).cpu().numpy()[: req.n, : req.n]
            guilty = ~pw.all(axis=1)
            complaints[i] = [(int(rcp) + 1, int(dlr) + 1) for dlr, rcp in zip(*np.nonzero(~pw))]
            qualified[i, : req.n] = ~guilty
            if int(guilty.sum()) > req.t:
                errors[i] = "MISBEHAVIOUR_HIGHER_THRESHOLD"

    final_shares, master = _finalise_stack(cfg_pad, fl.a, fl.s, torch.as_tensor(qualified, device=dev))
    shares_h = fh.from_tensor(final_shares)
    master_enc = gd.encode_batch(cfg_pad.cs, master)

    out = []
    for i, req in enumerate(fl.reqs):
        failed = bool(errors[i])
        out.append(CeremonyOutcome(
            ceremony_id=fl.ids[i], status="failed" if failed else "done", curve=req.curve, n=req.n, t=req.t,
            bucket_n=cfg_pad.n, bucket_t=cfg_pad.t, master=b"" if failed else master_enc[i].tobytes(),
            qualified=tuple(bool(q) for q in qualified[i, : req.n]), complaints=tuple(complaints[i]),
            error=errors[i], final_shares=None if failed else shares_h[i, : req.n]))
    return out


def run_convoy(runtime: WarmRuntime, reqs: list) -> list[CeremonyOutcome]:
    """start and finish in one call (the unpipelined entry point)."""
    return finish_convoy(runtime, start_convoy(runtime, reqs))


def run_single_reference(req: CeremonyRequest, *, device="cuda") -> bytes:
    """A fresh unpadded single-ceremony run of ``req`` (the oracle the
    service legs are held to): ``BatchedCeremony`` with the same seeded
    rng, its master key canonically encoded."""
    c = ce.BatchedCeremony(req.curve, req.n, req.t, req.shared_string, rng_for(req), device=device)
    out = c.run(rho_bits=req.rho_bits)
    if "master" not in out:
        raise PoisonedRequest(f"reference ceremony failed: {out.get('error')}")
    return gd.encode_batch(c.cfg.cs, out["master"][None])[0].tobytes()


# ---------------------------------------------------------------------------
# wire-format leg (padded KEM and DEM, real-lane slice)
# ---------------------------------------------------------------------------


def wire_broadcasts(runtime: WarmRuntime, req: CeremonyRequest, fl: InFlight, lane: int, pks: list,
                    rng_enc) -> list[bytes]:
    """Wire-format ``BroadcastPhase1`` bytes of one convoy lane, sealed to
    the ``req.n`` recipients' keys ``pks``.

    The KEM runs at the bucket shape: the encryption randomness is drawn
    for the real (n, n) block (the unpadded leg's draw order) and padded
    with ones (a zero KEM scalar has no inverse), the phantom recipients'
    keys with the generator; then the real sub-block of the sealed output
    is packaged.  Byte-identical to the unpadded ``seal_shares_pipeline``
    leg."""
    from ..dkg.hybrid_batch import broadcasts_from_batch, seal_shares_pipeline
    from ..utils import serde

    dev = runtime.device
    cfg_pad = fl.cfg_pad
    cs = cfg_pad.cs
    fs = cs.scalar
    group = gh.ALL_GROUPS[req.curve]
    n, n_pad = req.n, cfg_pad.n
    r_real = fh.encode(fs, [[fs.rand_int(rng_enc) for _ in range(n)] for _ in range(n)])
    r_pad = np.zeros((n_pad, n_pad, fs.limbs), np.uint32)
    r_pad[..., 0] = 1
    r_pad[:n, :n] = r_real
    pks_dev = gd.from_host(cs, list(pks) + [group.generator()] * (n_pad - n), device=dev)
    sealed = seal_shares_pipeline(group, cfg_pad, fl.s[lane], fl.r[lane], pks_dev, fh.to_tensor(r_pad, dev),
                                  fl.g_table)
    real_rows = [row[:n] for row in sealed[:n]]
    # a real dealer's padded high coefficients are commitments to zero that
    # the unpadded wire message does not carry
    bcasts = broadcasts_from_batch(group, cfg_pad, fl.e[lane][:n, : req.t + 1], real_rows)
    return [serde.encode_phase1(group, b) for b in bcasts]
