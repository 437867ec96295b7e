"""Device meshes for sharded Monte-Carlo: frames data-parallel over the ranks
of a ``torch.distributed`` group (one process per device), and the code axis
of a frame sharded over a second mesh axis."""

from .mesh import (
    CODE_AXIS,
    FRAME_AXIS,
    code_sharded_decode,
    code_sharded_polar_transform,
    default_mesh,
    frame_sharding,
    mesh_2d,
    multihost_mesh,
    pad_to_multiple,
    replicated_sharding,
)

__all__ = [
    "CODE_AXIS",
    "FRAME_AXIS",
    "code_sharded_decode",
    "code_sharded_polar_transform",
    "default_mesh",
    "mesh_2d",
    "multihost_mesh",
    "frame_sharding",
    "replicated_sharding",
    "pad_to_multiple",
]
