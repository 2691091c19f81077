"""Start the ranks of a party mesh on one host: ``spawn(fn, world_size)``.

The port's counterpart of ``dkg_tpu/parallel/hostmesh.py``, whose
``force_cpu_mesh`` fakes a multi-device CPU backend for the JAX
package's single controller.  Here every rank is a process of its own
(PyTorch's SPMD idiom), started with the ``spawn`` method (a parent that
has initialised CUDA must not fork), joined through a rendezvous on
``127.0.0.1`` at a free port, handed its :class:`mesh.PartyMesh`, and
its return value is sent back to the parent (tensors moved to the host).

Before spawning, the parent builds what the ranks load: the native
runtime, and on a CUDA device every kernel library (``ops.build.build``),
so the ranks only load them.  Ranks inherit the parent's environment, so
``DKG_TPU_TABLE_CACHE`` (the fixed-base tables' disk cache) is one for
all of them.  The ranks run on the card unless the caller passes
``device="cpu"``: ``nccl`` ranks take devices ``rank % count``, ``gloo``
ranks share device 0 when no index is given.  A rank that raises, or dies, fails the whole
spawn: the other ranks are terminated and :class:`RankFailed` carries
the failed ranks' tracebacks.  Every process ``spawn`` starts has ended
when it returns or raises.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import pickle
import socket
import time
import traceback

import torch

from . import mesh as pm


class RankFailed(RuntimeError):
    """A rank of :func:`spawn` raised or died; ``errors`` maps each failed
    rank to its traceback (or exit code)."""

    def __init__(self, errors: dict):
        self.errors = errors
        super().__init__("\n".join(f"rank {r}: {e}" for r, e in sorted(errors.items())))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_device(device: str, backend: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count() if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    return dev


def _rank_main(fn, rank: int, world: int, backend: str, device: str, port: int, args: tuple,
               threads: int | None, timeout: float, conn) -> None:
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(device, backend, rank)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(pm.make_mesh(world, device=dev), *args)
        # plain pickle: tensors travel in the bytes, not as shared-memory
        # handles that die with this process
        conn.send_bytes(pickle.dumps(("ok", _to_host(out))))
    except BaseException:  # noqa: BLE001 — every failure goes to the parent
        conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def spawn(fn, world_size: int, *, backend: str | None = None, device="cuda", args: tuple = (),
          threads: int | None = None, timeout: float = 900.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks, one spawned
    process each; returns their results in rank order.

    ``device`` is the card unless the caller passes ``"cpu"`` (a CUDA
    device with no card raises here, before any process starts);
    ``backend`` defaults to the device's (``mesh.default_backend``);
    ``threads`` sets each rank's intra-op threads; ``timeout`` bounds the
    whole run and each collective.  ``fn`` must be importable by the
    children (a module-level function).  Raises RankFailed if any rank
    raises or dies, RuntimeError on the timeout; either way every rank
    has been stopped."""
    from .. import native
    from ..dkg.ceremony import resolve_device

    device = resolve_device(device)
    backend = backend or pm.default_backend(device)
    native.build()
    if device.type == "cuda":
        from ..ops import build

        build.build()
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs, pending = [], {}
    try:
        for rank in range(world_size):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, daemon=True, name=f"party-mesh-rank-{rank}",
                            args=(fn, rank, world_size, backend, str(device), port, args, threads, timeout, send))
            p.start()
            send.close()
            procs.append(p)
            pending[recv] = rank
        results: list = [None] * world_size
        errors: dict = {}
        deadline = time.monotonic() + timeout
        while pending and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"spawn: ranks {sorted(pending.values())} still running after {timeout} s")
            sentinels = {procs[r].sentinel: c for c, r in pending.items()}
            for ready in multiprocessing.connection.wait([*pending, *sentinels], timeout=left):
                conn = sentinels.get(ready, ready)
                if conn not in pending:
                    continue
                rank = pending[conn]
                if ready is not conn and not conn.poll():
                    procs[rank].join(1)
                    errors[rank] = f"died without a result (exit code {procs[rank].exitcode})"
                else:
                    try:
                        kind, payload = pickle.loads(conn.recv_bytes())
                    except EOFError:
                        kind, payload = "error", f"died without a result (exit code {procs[rank].exitcode})"
                    if kind == "ok":
                        results[rank] = payload
                    else:
                        errors[rank] = payload
                del pending[conn]
                conn.close()
        if errors:
            raise RankFailed(errors)
        for p in procs:
            p.join(timeout=60)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in pending:
            conn.close()
