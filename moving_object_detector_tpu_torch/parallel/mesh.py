"""Device meshes and sharding rules over ``torch.distributed``.

The JAX package's ``parallel/mesh.py`` names a sharding mesh and
lets XLA insert the collectives. Here the program is multi-process SPMD:
one process per device, an initialized default process group of world
size n, and a ``DeviceMesh`` of shape (n // model_parallel,
model_parallel) named ("data", "model").

* ``data``: camera streams / frame batches, the production scaling
  dimension. The detection pipeline's forward path has no cross-stream
  communication.
* ``model``: row stripes of one camera (``parallel/spatial.py``) and the
  flow network's output-channel sharding for training
  (``flow_param_sharding``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..utils.trees import map_tensors


def create_mesh(n_devices: int | None = None, model_parallel: int = 1,
                device_type: str | None = None) -> DeviceMesh:
    """A (data, model) mesh over the ``n_devices`` ranks of the default
    process group (all of them when None). ``device_type`` defaults to
    where the group's collectives move tensors: "cuda" under NCCL, "cpu"
    under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialized process group "
                           "(parallel.multihost.initialize)")
    n = n_devices if n_devices is not None else dist.get_world_size()
    assert n % model_parallel == 0, (n, model_parallel)
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} devices needs a world of {n} "
                         f"processes, not {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))


def make_pipeline_mesh(n_devices: int | None = None,
                       device_type: str | None = None) -> DeviceMesh:
    """Pure data-parallel mesh for the detection pipeline (streams axis)."""
    return create_mesh(n_devices, 1, device_type)


def _data_placements(mesh: DeviceMesh) -> list:
    """A batch sharded over "data", replicated over the other axes."""
    return [Shard(0) if d == "data" else Replicate()
            for d in mesh.mesh_dim_names]


def _data_shard(mesh: DeviceMesh, x: torch.Tensor) -> DTensor:
    """This rank's slice of the global (B, ...) ``x`` along "data", as the
    local shard of a DTensor replicated over "model"."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    assert x.shape[0] % n == 0, (x.shape[0], n)
    chunk = x.shape[0] // n
    i = mesh.get_local_rank("data")
    return DTensor.from_local(x[i * chunk:(i + 1) * chunk], mesh,
                              _data_placements(mesh), run_check=False,
                              shape=x.shape, stride=x.stride())


def shard_batch(mesh: DeviceMesh, batch):
    """Every (B, ...) tensor of ``batch`` (tuples, lists and dicts are
    walked) with the batch dim over "data": each rank keeps its slice, as
    a DTensor whose ``to_local()`` is that slice."""
    return map_tensors(batch, lambda x: _data_shard(mesh, x))


def _conv_kernel_spec(name: str, param: torch.Tensor):
    """Placement over "model" of one flow-net parameter: conv weights
    (O, I, kH, kW) and biases (O,) shard on the output channel when it
    divides cleanly (even and > 2), everything else replicates. The JAX
    rule on HWIO kernels' last axis, on the port's dim 0."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight", "bias") and param.dim() >= 1:
        out_ch = param.shape[0]
        if out_ch % 2 == 0 and out_ch > 2:
            return Shard(0)
    return Replicate()


def flow_param_sharding(mesh: DeviceMesh, params) -> dict:
    """Placements over ``mesh`` for each PWC-Net parameter (a module's
    ``named_parameters()`` or a ``state_dict``): output-channel sharding
    over "model", replicated over "data" and where indivisible."""
    items = params.items() if isinstance(params, dict) else params
    return {name: tuple(_conv_kernel_spec(name, p) if d == "model"
                        else Replicate() for d in mesh.mesh_dim_names)
            for name, p in items}
