"""Data-parallel training across processes (counterpart of
``nuzero_tpu/parallel``): ``distributed.py`` joins the process group,
``mesh.py`` holds the mesh and its placements."""

from nuzero_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    place_batch_sharded,
    place_replicated,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "place_batch_sharded",
    "place_replicated",
    "replicate",
    "shard_batch",
]
