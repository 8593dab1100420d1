"""Multi-host deployment: one process per card over ``torch.distributed``.

Every host runs the same program; ``initialize`` joins the processes
into one world through a coordinator, and each host's camera streams
become the local shards of one global batch whose "data" axis spans all
ranks. Streams never communicate, so the stream axis shards across hosts
for free; only the row-stripe halos and gathers of
``parallel/spatial.py`` (and flow-net training's gradients) move data,
and they stay inside a host when "model" groups are laid out host-major
(ranks numbered host by host, the default of launchers such as
``torchrun``).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import resolve_device
from ..utils.trees import map_tensors
from .mesh import create_mesh, _data_placements

# Rendezvous and collective timeout: a rank that stalls fails the others
# within it instead of holding them for torch's default of many minutes.
TIMEOUT = datetime.timedelta(minutes=5)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None) -> None:
    """Join the multi-process program (idempotent). ``coordinator_address``
    is "host:port" (TCP rendezvous at rank 0) or an init URL such as
    "file:///path"; without one, the launcher's environment
    (MASTER_ADDR, RANK, WORLD_SIZE) is read. The backend defaults to NCCL
    on CUDA and to gloo when the caller asks for the CPU
    (``device="cpu"``); under NCCL each process takes the card of its
    rank."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw.update(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=TIMEOUT, **kw)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def global_stream_mesh(model_parallel: int = 1, device_type=None):
    """(data, model) mesh over every rank of the world; "model" groups are
    consecutive ranks, so they stay inside a host when ``model_parallel``
    divides the per-host card count."""
    return create_mesh(None, model_parallel, device_type)


def distribute_streams(mesh, local_batch):
    """This rank's camera frames as the local shards of one global batch.

    ``local_batch``: a tree of (n_local, ...) tensors (this host's
    cameras). Returns the same tree of DTensors with leading dimension
    n_local x (world size / model_parallel), sharded over "data" and
    replicated over "model": every rank addresses only its own shard, no
    frame crosses hosts."""
    n_data = mesh.size(mesh.mesh_dim_names.index("data"))
    placements = _data_placements(mesh)

    def one(x):
        x = x.contiguous()
        shape = torch.Size((x.shape[0] * n_data,) + tuple(x.shape[1:]))
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(x, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)

    return map_tensors(local_batch, one)


def host_local_results(global_tree):
    """The inverse view: this rank's shard of every DTensor in the tree as
    numpy (for the host-side export and visualization). With one process
    per card a rank holds one copy of its data index."""
    def one(x):
        return (x.to_local() if isinstance(x, DTensor) else x).cpu().numpy()

    return map_tensors(global_tree, one)
