"""Multi-card scaling over ``torch.distributed``: meshes, sharding rules,
the multi-stream step and the row-striped perception stages.

The JAX package scales with a sharding mesh and lets XLA insert
the collectives. Here the program is one process per card: camera
streams are data-parallel over the mesh's "data" axis, one camera's rows
split over its "model" axis, with ``ProcessGroup`` collectives
(point-to-point halo exchange, all-gather) where the JAX package has
``shard_map`` with ``ppermute`` / ``all_gather``.
"""

from .mesh import (
    create_mesh,
    flow_param_sharding,
    make_pipeline_mesh,
    shard_batch,
)
from .spatial import compute_disparity_spatial, flow_forward_spatial

__all__ = [
    "create_mesh",
    "flow_param_sharding",
    "make_pipeline_mesh",
    "shard_batch",
    "compute_disparity_spatial",
    "flow_forward_spatial",
]
