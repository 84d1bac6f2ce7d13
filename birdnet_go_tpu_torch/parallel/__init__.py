"""Device meshes, sharding rules and mesh-sharded serving (port of
``birdnet_go_tpu/parallel/``).

One process drives every device of the mesh, as JAX's SPMD serving does:
explicit torch devices, no ``torch.distributed`` and no NCCL. Axes:
- "data": the stream/window batch (data parallel);
- "model": the species axis of the classifier head (tensor parallel).
"""

from birdnet_go_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    param_pspec_tree,
    shard_params,
)
from birdnet_go_tpu_torch.parallel.serving import ShardedClassifier

__all__ = [
    "Mesh",
    "ShardedClassifier",
    "make_mesh",
    "param_pspec_tree",
    "shard_params",
]
