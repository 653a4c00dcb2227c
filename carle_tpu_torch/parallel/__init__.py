"""Multi-layout stacks and the spatial tier (counterpart of carle_tpu/parallel).

* :mod:`.mesh`: a mesh of slots (``make_mesh``) and row shards
  (``RowShards``, ``shard_rows``, ``gather_rows``): one controller holding a
  tensor per slot, where the JAX package runs one program over a mesh;
* :mod:`.spatial` and :mod:`.cuda_halo`: Life-like generations of a
  row-sharded universe, the halo kernels on CUDA slots;
* :mod:`.packed_env`: the packed stack, on one device or row-sharded
  (``shard_carry_packed``), and :mod:`.spatial_heads`, the nets on its shards
  (``nets.SpaceSharding``);
* :mod:`.band_heads`: band tiling of one huge universe on one device.

Env-batch data parallelism (``env_sharding``, ``shard_carry``,
``replicate``), the uint8 spatial env mode (``spatial_env``) and the 2-D env
x space mesh are not ported yet.
"""

from ..nets import SpaceSharding
from .cuda_halo import (bit_spatial_multi_step_cuda, spatial_ca_step_cuda,
                        spatial_multi_step_cuda)
from .mesh import Mesh, RowShards, gather_rows, make_mesh, shard_rows
from .packed_env import PackedSpatialStack, packed_spatial_sharding, shard_carry_packed
from .spatial import bit_spatial_multi_step, spatial_ca_step, spatial_multi_step

__all__ = [
    "Mesh",
    "PackedSpatialStack",
    "RowShards",
    "SpaceSharding",
    "bit_spatial_multi_step",
    "bit_spatial_multi_step_cuda",
    "gather_rows",
    "make_mesh",
    "packed_spatial_sharding",
    "shard_carry_packed",
    "shard_rows",
    "spatial_ca_step",
    "spatial_ca_step_cuda",
    "spatial_multi_step",
    "spatial_multi_step_cuda",
]
