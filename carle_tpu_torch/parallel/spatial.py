"""One universe across the slots of a mesh: Life-like generations of a
universe whose rows are sharded, with a ghost row from each ring neighbour a
generation (counterpart of carle_tpu/parallel/spatial.py).

The ring wraps, so the torus is global; columns stay inside a slot, so they
wrap as on one device.  Each function takes the universe as
:class:`~.mesh.RowShards` (or as one tensor, which it first shards over
``mesh``) and returns :class:`~.mesh.RowShards` on the same mesh
(:func:`~.mesh.gather_rows` gives the whole tensor).  On a two-axis env x
space mesh each env group's slots are a torus of their own over the group's
instances.  CUDA slots run the halo kernels (parallel/cuda_halo.py), CPU
slots their plain twins.  Rules
ride as data, a scalar or one a universe; ``static_rules`` fixes the packed
rule at compile time.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .cuda_halo import (bit_spatial_multi_step_cuda, spatial_ca_step_cuda,
                        spatial_multi_step_cuda)
from .mesh import Mesh, RowShards, shard_rows

Grid = Union[torch.Tensor, RowShards]


def _shards(grid: Grid, mesh: Optional[Mesh], axis_name: str) -> RowShards:
    if isinstance(grid, RowShards):
        if mesh is not None and grid.mesh is not mesh:
            raise ValueError("the grid's shards lie on another mesh")
        return grid
    if mesh is None:
        raise ValueError("a tensor grid needs the mesh to shard it over")
    return shard_rows(grid, mesh, axis_name)


def spatial_ca_step(grid: Grid, rule_bits, mesh: Optional[Mesh] = None,
                    axis_name: str = "space") -> RowShards:
    """One generation of a row-sharded uint8 universe [inst, H, W]."""
    return spatial_ca_step_cuda(_shards(grid, mesh, axis_name), rule_bits)


def spatial_multi_step(grid: Grid, rule_bits, num_steps: int, mesh: Optional[Mesh] = None,
                       axis_name: str = "space") -> RowShards:
    """``num_steps`` uint8 generations, a ghost-row exchange each."""
    return spatial_multi_step_cuda(_shards(grid, mesh, axis_name), rule_bits, num_steps)


def bit_spatial_multi_step(packed: Grid, rule_bits, num_steps: int,
                           mesh: Optional[Mesh] = None, axis_name: str = "space",
                           static_rules: Optional[Tuple] = None) -> RowShards:
    """``num_steps`` packed generations of a row-sharded universe
    [inst, H, W/32].  ``static_rules=(birth, survive)`` fixes the rule at
    compile time (one kernel library a rule, built on its first use)."""
    if static_rules is not None:
        birth, survive = static_rules
        static_rules = (tuple(int(d) for d in birth), tuple(int(d) for d in survive))
    return bit_spatial_multi_step_cuda(_shards(packed, mesh, axis_name), rule_bits,
                                       num_steps, static_rules)


__all__ = ["bit_spatial_multi_step", "spatial_ca_step", "spatial_multi_step"]
