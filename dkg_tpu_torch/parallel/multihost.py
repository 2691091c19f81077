"""Ceremonies across hosts: one global party mesh, the collectives over
the network.

Counterpart of ``dkg_tpu/parallel/multihost.py``: scaling past one host
is the same SPMD program as ``parallel.mesh``.  ``init_multihost`` joins
the process group (one process a rank, each given the coordinator's
address, the world size and its rank: nothing on a host tells a program
of a cluster), ``global_party_mesh`` lays every rank on the one party
axis, and ``process_party_block`` is this process's contiguous party
block, for host-side per-party work that must track the sharding (DEM
sealing).  Deployment shape (one process a GPU):

    from dkg_tpu_torch.parallel import mesh, multihost
    multihost.init_multihost("host0:29500", num_processes=8, process_id=rank)
    m = multihost.global_party_mesh()
    mesh.run_sharded_ceremony(cfg, m, ...)
"""

from __future__ import annotations

import datetime

import torch.distributed as dist

from ..dkg.ceremony import resolve_device
from .mesh import PartyMesh, default_backend, make_mesh


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, *, backend: str | None = None, device=None,
                   timeout: float = 1800.0) -> None:
    """Join the process group at ``tcp://<coordinator_address>``; a no-op
    for one process, so one launcher serves a laptop and a cluster.
    ``device`` is the card (each process must hold its own GPU under
    ``nccl``) unless the caller passes ``"cpu"``; a CUDA device with no
    card raises.  ``backend`` defaults to ``device``'s (``nccl`` on CUDA,
    ``gloo`` on the CPU)."""
    if not num_processes or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("init_multihost needs the coordinator's address and this process's id")
    device = resolve_device("cuda" if device is None else device)
    dist.init_process_group(backend or default_backend(device), init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))


def global_party_mesh(device=None) -> PartyMesh:
    """The party mesh over every rank of the process group (one rank,
    with no group, before :func:`init_multihost` or at world 1), on the
    current CUDA device unless the caller passes another (``"cpu"``)."""
    return make_mesh(device=device)


def process_party_block(n_parties: int, mesh: PartyMesh | None = None) -> tuple[int, int]:
    """This process's contiguous party block [start, stop) of
    ``n_parties`` under the party-axis sharding (``mesh.span``).  Raises
    ValueError for anything but a 1-D party mesh or a count that does
    not shard evenly."""
    if mesh is None:
        mesh = global_party_mesh()
    if not isinstance(mesh, PartyMesh):
        raise ValueError(f"expected a 1-D party mesh (parallel.mesh.PartyMesh), got {type(mesh).__name__}: "
                         "flat positions would not correspond to party-axis coordinates")
    if n_parties % mesh.world:
        raise ValueError(f"{n_parties} parties do not shard evenly over {mesh.world} ranks")
    return mesh.span(n_parties)
