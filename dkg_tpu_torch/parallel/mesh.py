"""The GJKR ceremony with its parties sharded over ranks of
``torch.distributed``: one process a rank, each holding its own block of
dealers, collectives at the round boundaries.

Counterpart of ``dkg_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a device mesh (``shard_map``); PyTorch's idiom is SPMD:
every rank runs the same functions on its own dealer block, rank r owning
dealers [r·block, (r+1)·block) and, after the share delivery, the same
recipients.  The collectives are the JAX package's:

* the round-1 "broadcast" is not replicated: verification reads the
  rho-combined commitment columns, exchanged as each rank's partial
  point RLC of (t+1, C, L) (one ``all_gather``, then a tree-add), and
  the transcript digest, exchanged as 32-byte dealer row digests
  (``dkg.ceremony.sharded_transcript_digest``);
* the per-recipient share delivery is an ``all_to_all_single`` of the
  share and hiding matrices on the recipient axis, in recipient chunks
  (:func:`_verify_chunk_default`'s 128 MiB rule);
* the master key is each rank's masked tree-add of its bare first
  columns, all-gathered and tree-added;
* blame needs no share movement (a dealer's commitments and its share
  rows lie on one rank): one gather of each rank's (block, n) verdicts.

A :class:`PartyMesh` is a rank's handle on the default process group:
world size, rank, device and backend.  Its collectives
(:meth:`PartyMesh.all_gather`, :meth:`PartyMesh.all_to_all`) are the
only ones the ceremony runs; they count calls, bytes and seconds per op
(in the handle's ``stats`` and ``utils.metrics``'
``mesh_collective_seconds{op}`` and ``mesh_collective_bytes_total{op}``).
They hand the backend the tensors where they lie: ``gloo`` takes CUDA
tensors for both (it copies through the host itself).  The device is the
current CUDA device unless the caller passes another, ``"cpu"``
included; the backend follows the device (``nccl`` on CUDA, ``gloo`` on
the CPU) unless the caller names it; NCCL with two ranks on one device
raises, never switching to gloo by itself.

Every function here runs on every rank at once and takes the rank's
blocks: coefficients (block, t+1, L) (or all n dealers', of which the
rank takes its block), round-1 tensors (block, ...).  Recipient-side
outputs (``ok``, final shares) are the rank's recipients; the master key
and ``qualified`` are the same on every rank.  ``parallel.hostmesh``
starts the ranks of one host; ``parallel.multihost`` joins hosts.
"""

from __future__ import annotations

import dataclasses
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ..dkg import ceremony as ce
from ..groups import device as gd
from ..utils import metrics as _metrics
from ..utils.scanchunk import map_chunked

# recipient chunk budget of the share delivery: the a2a's receive buffer
VERIFY_CHUNK_BYTES = 128 << 20


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclasses.dataclass
class PartyMesh:
    """A rank's handle on the 1-D party mesh of the default process group:
    rank r owns parties [r·per, (r+1)·per).

    ``sharing`` is the number of ranks of this host on this rank's
    device, which split its free memory.  ``backend`` None is a one-rank
    mesh with no process group, whose collectives are local copies.
    ``stats`` counts each op's calls, bytes sent and seconds on this
    rank."""

    world: int
    rank: int
    device: torch.device
    backend: str | None = None
    sharing: int = 1
    stats: dict = dataclasses.field(default_factory=dict)

    def block(self, n: int) -> int:
        if n % self.world:
            raise ValueError(f"committee size {n} must divide evenly over the mesh ({self.world} ranks)")
        return n // self.world

    def span(self, n: int) -> tuple[int, int]:
        """This rank's parties [start, stop) of ``n``."""
        b = self.block(n)
        return self.rank * b, (self.rank + 1) * b

    def free_bytes(self) -> int:
        """This rank's share of what its device has free (the dealing and
        digest chunk budgets): ranks that share a card each budget a part
        of it, never the whole card together."""
        return ce.free_device_bytes(self.device) // max(1, self.sharing)

    # -- collectives ----------------------------------------------------------

    def _run(self, op: str, x: torch.Tensor, fn) -> torch.Tensor:
        t0 = time.perf_counter()
        src = x.contiguous()
        is_bool = src.dtype == torch.bool
        if is_bool:  # bool tensors travel as integers
            src = src.to(torch.uint8)
        out = fn(src)
        if is_bool:
            out = out != 0
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        seconds = time.perf_counter() - t0
        nbytes = src.numel() * src.element_size()
        rec = self.stats.setdefault(op, {"calls": 0, "bytes": 0, "seconds": 0.0})
        rec["calls"] += 1
        rec["bytes"] += nbytes
        rec["seconds"] += seconds
        _metrics.REGISTRY.observe("mesh_collective_seconds", seconds, op=op)
        _metrics.REGISTRY.inc("mesh_collective_bytes_total", nbytes, op=op)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, stacked in rank order: (world, *x.shape)."""

        def fn(src):
            if self.backend is None:
                return src[None].clone()
            parts = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(parts, src)
            return torch.stack(parts)

        return self._run("all_gather", x, fn)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (world, ...): row k goes to rank k; returns (world, ...)
        whose row k came from rank k."""
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all needs a leading axis of {self.world}, got {tuple(x.shape)}")

        def fn(src):
            if self.backend is None:
                return src.clone()
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src)
            return out

        return self._run("all_to_all", x, fn)

    def all_to_all_recipients(self, x: torch.Tensor, off: int, w: int) -> torch.Tensor:
        """The share delivery of one recipient chunk: ``x`` (block_d, n,
        ...) with recipients on axis 1; each rank sends every destination
        the [off, off+w) slice of that destination's recipient block and
        receives its own from every dealer: (n, w, ...) in global dealer
        order (the JAX package's tiled ``all_to_all`` on axis 1)."""
        bd, n = x.shape[0], x.shape[1]
        block = self.block(n)
        v = x.reshape((bd, self.world, block) + tuple(x.shape[2:]))[:, :, off : off + w]
        got = self.all_to_all(v.movedim(1, 0))  # (world src, bd, w, ...)
        return got.reshape((self.world * bd, w) + tuple(x.shape[2:]))


def _device_key(device: torch.device) -> tuple:
    return (socket.gethostname(), device.type, device.index if device.index is not None else 0)


def make_mesh(n_ranks: int | None = None, *, device=None) -> PartyMesh:
    """The party mesh over every rank of the default process group (a
    one-rank mesh with no group when torch.distributed is not
    initialised).

    ``n_ranks`` is the world the caller asks for: a world of another size
    raises rather than truncating or padding (a silently smaller mesh
    would let sharded checks pass without their collectives).  ``device``
    defaults to the current CUDA device and raises when there is none:
    the host runs a rank only when ``device="cpu"`` is passed.  The
    backend is the process group's.  Under NCCL, two ranks of one host on
    one device raise (NCCL refuses them): run such ranks under ``gloo``.
    Collective: every rank calls it."""
    if not dist.is_available() or not dist.is_initialized():
        world, rank, pg_backend = 1, 0, None
    else:
        world, rank, pg_backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    if n_ranks is not None and world != n_ranks:
        raise RuntimeError(f"requested a {n_ranks}-rank party mesh but the process group has {world} ranks "
                           "(start the ranks with parallel.hostmesh.spawn or init_multihost)")
    device = ce.resolve_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    sharing = 1
    if pg_backend is not None:
        # the device check rides a gloo group: NCCL itself would fail on
        # the very ranks it looks for
        side = dist.new_group(backend="gloo") if pg_backend != "gloo" else None
        keys = [None] * world
        dist.all_gather_object(keys, _device_key(device), group=side)
        sharing = keys.count(keys[rank])
        if pg_backend == "nccl" and sharing > 1:
            raise RuntimeError(f"NCCL cannot run {sharing} ranks on one device ({keys[rank]}): give each "
                               "rank its own GPU, or run the ranks under backend='gloo'")
    return PartyMesh(world, rank, device, pg_backend, sharing)


def _verify_chunk_default(cfg: ce.CeremonyConfig, block: int) -> int:
    """Recipients a chunk of the share delivery: the receive buffer
    n·w·L·4 bytes within VERIFY_CHUNK_BYTES, floored to a power of two,
    clamped to [1, block] (the JAX package's rule)."""
    per_recipient = cfg.n * cfg.cs.scalar.limbs * 4
    w = max(1, VERIFY_CHUNK_BYTES // per_recipient)
    w = 1 << (w.bit_length() - 1)
    return min(w, block)


def _local(cfg: ce.CeremonyConfig, mesh: PartyMesh, x: torch.Tensor) -> torch.Tensor:
    """The rank's dealer block of ``x``: as given when it has block rows,
    its slice when it has all n."""
    block = mesh.block(cfg.n)
    if x.shape[0] == block:
        return x
    if x.shape[0] == cfg.n:
        a, b = mesh.span(cfg.n)
        return x[a:b]
    raise ValueError(f"expected {block} or {cfg.n} dealer rows, got {x.shape[0]}")


def _chunk(mesh: PartyMesh, default) -> int:
    """On the card ``default(free_bytes)`` at the rank's share of the free
    memory; one pass on the CPU."""
    return default(mesh.free_bytes()) if mesh.device.type == "cuda" else 0


# ---------------------------------------------------------------------------
# round 1: dealing
# ---------------------------------------------------------------------------


def sharded_deal(cfg, mesh, coeffs_a, coeffs_b, g_table, h_table):
    """Round 1 on the rank's dealers: (a, e, s, r), each (block, ...).
    Nothing is exchanged."""
    a, e = sharded_deal_commitments(cfg, mesh, coeffs_a, coeffs_b, g_table, h_table)
    s, r = sharded_deal_shares(cfg, mesh, coeffs_a, coeffs_b)
    return a, e, s, r


def sharded_deal_commitments(cfg, mesh, coeffs_a, coeffs_b, g_table, h_table):
    """The first of the two dealing passes, (A, E) of the rank's dealers,
    through ``ceremony.deal_commitments_traced_chunked``; the chunk
    default budgets the rank's share of the card's free memory."""
    ca, cb = _local(cfg, mesh, coeffs_a), _local(cfg, mesh, coeffs_b)
    m = ca.shape[0]
    chunk = _chunk(mesh, lambda free: ce._deal_chunk_default(cfg, m, free))
    return ce.deal_commitments_traced_chunked(cfg, ca, cb, g_table, h_table, chunk)


def sharded_deal_shares(cfg, mesh, coeffs_a, coeffs_b):
    """The second dealing pass, (s, r) (block, n, L) of the rank's
    dealers, through ``ceremony.deal_shares_traced_chunked``."""
    ca, cb = _local(cfg, mesh, coeffs_a), _local(cfg, mesh, coeffs_b)
    m = ca.shape[0]
    chunk = _chunk(mesh, lambda free: ce._shares_chunk_default(cfg, m, free))
    return ce.deal_shares_traced_chunked(cfg, ca, cb, chunk)


# ---------------------------------------------------------------------------
# round 2: verification, aggregation, the master key
# ---------------------------------------------------------------------------


def _master_shardlocal(cfg, mesh: PartyMesh, a0: torch.Tensor, qual: torch.Tensor) -> torch.Tensor:
    """The master key from the rank's bare first columns a0 (block, C, L):
    masked by its slice of ``qual``, tree-added, all-gathered and
    tree-added (the dealer set of the aggregated shares)."""
    cs = cfg.cs
    a, b = mesh.span(cfg.n)
    masked = gd.select(qual[a:b].to(a0.device), a0, gd.identity(cs, a0.shape[:-2], device=a0.device))
    part = gd._tree_reduce(cs, masked, masked.shape[0])
    return gd._tree_reduce(cs, mesh.all_gather(part), mesh.world)


def _recipient_loop(cfg, mesh: PartyMesh, chunk: int | None, run):
    """``run(off, w)`` over the rank's recipient block in chunks of
    ``chunk`` (None: :func:`_verify_chunk_default`), outputs written in
    place (``utils.scanchunk.map_chunked``)."""
    block = mesh.block(cfg.n)
    if chunk is None:
        chunk = _verify_chunk_default(cfg, block)
    return map_chunked(block, chunk, run)


def sharded_verify_finalise(cfg, mesh, a0, e, s, r, g_table, h_table, rho, rho_bits: int, *,
                            chunk: int | None = None):
    """Round 2 and the finalise, the commitments never replicated.

    The rank's partial point RLC of its dealers' E with its slice of rho,
    one ``all_gather`` of the world's (t+1, C, L) partials and their
    tree-add; then, a recipient chunk at a time, the share delivery
    (``all_to_all`` of s and r), the scalar RLCs, the right side at the
    rank's global indices (first = rank·block + 1), the two fixed-base
    multiplications, ``eq`` and the aggregate; then the master key.
    The point RLC is Pippenger's (``run()``'s default); ``chunk`` is the
    recipients a chunk (None: :func:`_verify_chunk_default`).  Returns ok
    (block,) and final shares (block, L) of the rank's recipients, and the
    master key (C, L), the same on every rank."""
    cs, fs = cfg.cs, cfg.cs.scalar
    start, _ = mesh.span(cfg.n)
    block = mesh.block(cfg.n)
    rho = rho.to(e.device)
    d_part = ce._point_rlc(cs, rho[start : start + block], e, rho_bits, "pippenger")  # (t+1, C, L)
    d_comm = gd._tree_reduce(cs, mesh.all_gather(d_part).movedim(0, -3), mesh.world)
    qual = torch.ones(cfg.n, dtype=torch.bool, device=e.device)

    def run(off, w):
        s_recv = mesh.all_to_all_recipients(s, off, w)  # (n, w, L)
        r_recv = mesh.all_to_all_recipients(r, off, w)
        s_rlc = ce._field_dot(fs, rho, s_recv)
        r_rlc = ce._field_dot(fs, rho, r_recv)
        xs = torch.arange(start + off + 1, start + off + w + 1, dtype=torch.int32, device=e.device)
        rhs = gd.eval_point_poly(cs, d_comm, xs, cfg.index_bits)
        lhs = gd.add(cs, gd.fixed_base_mul(cs, g_table, s_rlc), gd.fixed_base_mul(cs, h_table, r_rlc))
        return gd.eq(cs, lhs, rhs), ce.aggregate_shares(cfg, s_recv, qual)

    ok, finals = _recipient_loop(cfg, mesh, chunk, run)
    return ok, finals, _master_shardlocal(cfg, mesh, a0, qual)


def sharded_blame(cfg, mesh, e, s, r, g_table, h_table) -> torch.Tensor:
    """Pairwise blame: each rank checks its own dealers against all n
    recipients (``ceremony.verify_pairwise``: dealer-local data, no share
    movement), and one gather assembles the (n, n) verdicts, the same on
    every rank."""
    pw = ce.verify_pairwise(cfg, e, s, r, g_table, h_table)  # (block, n)
    return mesh.all_gather(pw).reshape(cfg.n, cfg.n)


def sharded_finalise(cfg, mesh, a0, s, qualified):
    """Aggregation and the master key over an adjudicated qualified set
    (blame's re-finalise: no verification is repeated).  Returns the
    rank's final shares (block, L) and the master key."""
    qual = qualified.to(s.device)
    finals = _recipient_loop(cfg, mesh, None,
                             lambda off, w: ce.aggregate_shares(cfg, mesh.all_to_all_recipients(s, off, w), qual))
    return finals, _master_shardlocal(cfg, mesh, a0, qual)


def _guilty_error(guilty: np.ndarray):
    from ..dkg.errors import DkgError, DkgErrorKind

    return DkgError(DkgErrorKind.MISBEHAVIOUR_HIGHER_THRESHOLD,
                    detail="guilty dealers (1-based): " + ", ".join(str(j + 1) for j in np.nonzero(guilty)[0]))


def _host_global(mesh: PartyMesh, x: torch.Tensor) -> np.ndarray:
    """The whole of a recipient-sharded tensor on every rank, on the host:
    an all_gather, joined in rank order."""
    g = mesh.all_gather(x)
    return g.reshape((-1,) + tuple(x.shape[1:])).cpu().numpy()


def sharded_ceremony(cfg, mesh, coeffs_a, coeffs_b, g_table, h_table, rho_bits: int = 128, tamper=None):
    """The whole ceremony on the mesh, blame included (the flow of
    :func:`run_sharded_ceremony`): deal, the sharded transcript digest
    and rho, verify and finalise; if any batch check fails anywhere,
    sharded blame and the re-finalise over the qualified set.
    ``tamper(a, e, s, r) -> (a, e, s, r)`` sees the rank's blocks.
    Returns (ok, final_shares, master, qualified): ok (before
    adjudication) and the final shares of the rank's recipients, the rest
    the same on every rank.  More than t guilty dealers raise
    ``DkgError(MISBEHAVIOUR_HIGHER_THRESHOLD)`` on every rank."""
    out = run_sharded_ceremony(cfg, mesh, coeffs_a, coeffs_b, g_table, h_table, rho_bits, tamper)
    return out["ok"], out["final_shares"], out["master"], out["qualified"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sharded_ceremony(cfg, mesh, coeffs_a, coeffs_b, g_table, h_table, rho_bits: int = 128, tamper=None,
                         seal=None, ceremony_id: str = "sharded") -> dict:
    """``BatchedCeremony.run``'s mesh twin: :func:`sharded_ceremony`'s flow
    (the same outputs), every phase timed and its readiness published per
    rank.

    * ``phases_s``: each phase's seconds on this rank (0 deal_commitments,
      1 deal_shares, 2 transcript_digest, 3 verify_finalise, 4 blame on a
      failed batch check; ``seal_transport`` with ``seal``), each ended by
      a device synchronise, also observed as
      ``mesh_collective_seconds{op=<phase>}``; ``mesh_shards_total`` counts
      the ranks;
    * ``events``: ``round_head`` / ``publish`` / ``round_tail`` in obslog's
      schema (party = rank), each rank's publish time gathered to every
      rank, also emitted into the ambient ``utils.obslog`` recorder;
    * ``seal=(group, pks_dev, r_enc)`` seals the rank's dealer block
      (``dkg.hybrid_batch.seal_shares_mesh``) into ``broadcasts``.

    Returns ``ok`` and ``final_shares`` of the rank's recipients,
    ``master``, ``qualified``, ``rho``, ``transcript``, ``broadcasts``
    (None without ``seal``), ``phases_s``, ``events``, ``mesh_shape``,
    ``n_devices`` and ``collectives`` (this rank's counts by op).  More
    than t guilty dealers raise, as :func:`sharded_ceremony` does."""
    from ..utils import obslog

    reg = _metrics.REGISTRY
    mesh.block(cfg.n)  # raises unless n divides over the mesh
    n_dev = mesh.world
    reg.inc("mesh_shards_total", n_dev)
    events: list[dict] = []
    phases: dict[str, float] = {}
    dev = mesh.device

    def head(rd: int) -> float:
        now = time.time()
        events.append({"kind": "round_head", "ceremony_id": ceremony_id, "round": rd, "ts": now})
        obslog.emit_current("round_head", round=rd, ceremony_id=ceremony_id)
        return time.perf_counter()

    def publish(rd: int) -> None:
        _sync(dev)
        ts = mesh.all_gather(torch.tensor([time.time()], dtype=torch.float64, device=dev)).flatten().tolist()
        for party, t in enumerate(ts):
            events.append({"kind": "publish", "ceremony_id": ceremony_id, "round": rd, "party": party, "ts": t})
        obslog.emit_current("publish", round=rd, party=mesh.rank, ceremony_id=ceremony_id)

    def tail(rd: int, op: str, t_open: float) -> None:
        events.append({"kind": "round_tail", "ceremony_id": ceremony_id, "round": rd, "ts": time.time(),
                       "timed_out": False, "present": n_dev, "party": n_dev - 1})
        obslog.emit_current("round_tail", round=rd, ceremony_id=ceremony_id, timed_out=False, present=n_dev)
        seconds = time.perf_counter() - t_open
        phases[op] = phases.get(op, 0.0) + seconds
        reg.observe("mesh_collective_seconds", seconds, op=op)

    t0 = head(0)
    a, e = sharded_deal_commitments(cfg, mesh, coeffs_a, coeffs_b, g_table, h_table)
    publish(0)
    tail(0, "deal_commitments", t0)

    t0 = head(1)
    s, r = sharded_deal_shares(cfg, mesh, coeffs_a, coeffs_b)
    publish(1)
    tail(1, "deal_shares", t0)

    if tamper is not None:
        a, e, s, r = tamper(a, e, s, r)

    broadcasts = None
    if seal is not None:
        from ..dkg import hybrid_batch as hb

        group, pks_dev, r_enc = seal
        t0 = time.perf_counter()
        broadcasts = hb.seal_shares_mesh(group, cfg, mesh, s, r, pks_dev, r_enc, g_table)
        phases["seal_transport"] = time.perf_counter() - t0
        reg.observe("mesh_collective_seconds", phases["seal_transport"], op="seal_transport")

    t0 = head(2)
    transcript = ce.sharded_transcript_digest(cfg, mesh, a, e, s, r)
    rho = torch.from_numpy(ce.fiat_shamir_rho(cfg, transcript, rho_bits).astype(np.int32)).to(dev)
    publish(2)
    tail(2, "transcript_digest", t0)

    # only the bare first columns outlive the digest (the master key's input)
    a0 = a[:, 0].contiguous()
    del a

    t0 = head(3)
    ok, finals, master = sharded_verify_finalise(cfg, mesh, a0, e, s, r, g_table, h_table, rho, rho_bits)
    publish(3)
    tail(3, "verify_finalise", t0)

    qualified = torch.ones(cfg.n, dtype=torch.bool, device=dev)
    if not bool(_host_global(mesh, ok).all()):
        t0 = head(4)
        guilty = ~sharded_blame(cfg, mesh, e, s, r, g_table, h_table).cpu().numpy().all(axis=1)
        if int(guilty.sum()) > cfg.t:
            tail(4, "blame", t0)
            raise _guilty_error(guilty)
        qualified = torch.as_tensor(~guilty, device=dev)
        finals, master = sharded_finalise(cfg, mesh, a0, s, qualified)
        publish(4)
        tail(4, "blame", t0)

    return {"ok": ok, "final_shares": finals, "master": master, "qualified": qualified, "rho": rho,
            "transcript": transcript, "broadcasts": broadcasts, "phases_s": phases, "events": events,
            "mesh_shape": (n_dev,), "n_devices": n_dev,
            "collectives": {k: dict(v) for k, v in mesh.stats.items()}}
