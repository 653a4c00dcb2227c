"""Multi-layout stacks and the spatial tier (counterpart of carle_tpu/parallel).

* :mod:`.mesh`: a mesh of slots over one axis (``make_mesh``) or two
  (``Mesh([[...], ...], ("env", "space"))``) and row shards (``RowShards``,
  ``shard_rows``, ``gather_rows``): one controller holding a tensor per
  slot, where the JAX package runs one program over a mesh;
* :mod:`.spatial` and :mod:`.cuda_halo`: Life-like generations of a
  row-sharded universe, the halo kernels on CUDA slots;
* :mod:`.spatial_env`: the uint8 spatial env mode, the full env step on a
  row-sharded universe under the unchanged ``Rollout`` and ``WrapperStack``
  (``shard_carry_spatial``), one halo launch a device a step; on the env x
  space mesh (``shard_carry_2d``) the instances shard over ``env`` too, one
  launch a ring a device;
* :mod:`.packed_env`: the packed stack, on one device, row-sharded
  (``shard_carry_packed``) or on the env x space mesh (``env_axis``), and
  :mod:`.spatial_heads`, the nets on its shards (``nets.SpaceSharding``);
* :mod:`.band_heads`: band tiling of one huge universe on one device;
* env-batch data parallelism (:mod:`.mesh`'s ``env_sharding``,
  ``shard_carry``, ``replicate``): the instance batch split over a mesh's
  slots, each slot's instances whole (rings of one slot), everything else
  on the home device, and :mod:`.batch_heads`, the nets a slot at a time
  over the instances (a ``Mesh`` as ``fused_head``).

* :mod:`.distributed`: several processes over one mesh (``initialize``,
  ``process_count``, ``process_index``, ``shutdown``, the launcher
  ``python -m carle_tpu_torch.parallel.distributed``): ``make_mesh()`` under
  an initialised group spans every process's slots, each process holds its
  own slots' shards, ghost rows cross processes point to point
  (:mod:`.ghosts`) and the batch-global terms by ``all_reduce``.
"""

from ..nets import SpaceSharding
from .cuda_halo import (bit_spatial_multi_step_cuda, spatial_ca_step_cuda,
                        spatial_env_step_cuda, spatial_multi_step_cuda)
from .mesh import (Mesh, RowShards, env_sharding, gather_rows, make_mesh, replicate,
                   shard_carry, shard_rows)
from .packed_env import PackedSpatialStack, packed_spatial_sharding, shard_carry_packed
from .spatial import bit_spatial_multi_step, spatial_ca_step, spatial_multi_step
from .spatial_env import shard_carry_2d, shard_carry_spatial, spatial_sharding

# parallel/distributed.py's names, imported on first use, so that
# `python -m carle_tpu_torch.parallel.distributed` runs the one copy of it
_DISTRIBUTED = ("initialize", "process_count", "process_index", "shutdown")


def __getattr__(name):
    if name in _DISTRIBUTED:
        from . import distributed

        return getattr(distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Mesh",
    "PackedSpatialStack",
    "RowShards",
    "SpaceSharding",
    "bit_spatial_multi_step",
    "bit_spatial_multi_step_cuda",
    "env_sharding",
    "gather_rows",
    "initialize",
    "make_mesh",
    "packed_spatial_sharding",
    "process_count",
    "process_index",
    "replicate",
    "shard_carry",
    "shard_carry_2d",
    "shard_carry_packed",
    "shard_carry_spatial",
    "shard_rows",
    "shutdown",
    "spatial_ca_step",
    "spatial_ca_step_cuda",
    "spatial_env_step_cuda",
    "spatial_multi_step",
    "spatial_multi_step_cuda",
    "spatial_sharding",
]
