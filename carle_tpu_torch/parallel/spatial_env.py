"""Spatial env mode: the full environment on a row-sharded uint8 universe
(counterpart of carle_tpu/parallel/spatial_env.py).

The complete ``env_step`` semantics (the action XOR in the centred window,
the batch-global master reset, every wrapper bonus, online learning) run on
a universe whose rows are split over a mesh's ``space`` axis as
:class:`~.mesh.RowShards`, driven by the unchanged
:class:`~carle_tpu_torch.rollout.Rollout` and
:class:`~carle_tpu_torch.mcl.base.WrapperStack`.

The JAX package commits the carry with row shardings and lets GSPMD
partition the jitted step, inserting the halo exchanges.  The port has no
partitioner, so the step is explicit: when ``env.env_step`` meets a
``RowShards`` grid it runs ``cuda_halo.spatial_env_step_cuda``, one launch of
``csrc/halo_words.cu`` a device a step, with the action's toggles and the
reset flag fused in and each slot's ghost rows read from its ring
neighbours' buffers (no clone of a slot, no separate XOR or reset pass);
CPU slots take the plain twin.  When ``WrapperStack.transition`` meets one,
the step context's cell views (``prev_grid``, ``obs``, ``obs_cells``) are
:class:`~carle_tpu_torch.mcl.base.Lazy` views gathered from the shards onto
the mesh's home device (:func:`gathered_views`), as GSPMD gathers a sharded
array for an unsharded consumer: the wrappers, learners included, read the
gathered cells, and the stack's ``gathers`` counts them.  ``reset`` (zeros,
the wrappers' reset hooks, resharded), ``observe`` and ``universe`` work on
shards too.
Everything but the universe (rules, counters, wrapper states) lives on the
home device.  Trajectories equal the ``mesh=None`` stack's bit for bit
(tests/test_torch_spatial_env.py).

The JAX mode refuses a Pallas backend (``_check_xla_backend``) because a
``pallas_call`` is opaque to the GSPMD partitioner.  The port's config has
no backend field and its sharded step is written for shards, so nothing is
checked here.  The 2-D env x space mesh (``shard_carry_2d``, ``env_axis``) is
not ported.

Usage::

    mesh = make_mesh([torch.device("cuda")] * 4, "space")   # or several cards
    ro = Rollout(config, wrappers, agent, device="cuda")    # unchanged
    carry = ro.init(ro.generator(0), rule_bits)
    carry = shard_carry_spatial(carry, mesh, config)
    carry, rewards = ro.run(carry, num_steps)               # runs row-sharded
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..config import EnvConfig
from ..mcl.base import Lazy, WrapperStack
from .mesh import Mesh, RowShards, gather_rows, shard_rows, tree_map_leaves


def spatial_sharding(mesh: Mesh, leaf: Any, config: EnvConfig, axis_name: str = "space",
                     env_axis: Optional[str] = None) -> Optional[str]:
    """Where one state leaf goes in spatial mode: the axis name for the uint8
    universes [instances, H, W] (their rows shard over that axis), None for a
    leaf that stays whole on the mesh's home device (parameters, optimizer
    state, counters, rules, wrapper states; the JAX package shards every
    leaf of the universe's extent, where GSPMD hides it from the
    wrappers)."""
    if env_axis is not None:
        raise NotImplementedError("the 2-D env x space mesh (env_axis) is not ported yet")
    n = mesh.shape[axis_name]
    if (isinstance(leaf, torch.Tensor) and leaf.dtype == torch.uint8
            and tuple(leaf.shape) == config.grid_shape and config.height % n == 0):
        return axis_name
    return None


def shard_carry_spatial(carry: Any, mesh: Mesh, config: EnvConfig,
                        axis_name: str = "space") -> Any:
    """A rollout carry (or any state tree) for spatial execution: the uint8
    universes row-sharded over the mesh, every other tensor on the mesh's
    home device."""

    def place(leaf):
        if isinstance(leaf, RowShards) or not isinstance(leaf, torch.Tensor):
            return leaf
        if spatial_sharding(mesh, leaf, config, axis_name) is not None:
            return shard_rows(leaf, mesh, axis_name)
        return leaf.to(mesh.home)

    return tree_map_leaves(place, carry)


def gathered_views(stack: WrapperStack, prev: RowShards, grid: RowShards
                   ) -> Tuple[Lazy, Lazy, Lazy]:
    """The step context's cell views of a sharded transition, (prev_grid,
    obs_cells, obs): each gathered onto the mesh's home device on its first
    read, obs from the gathered obs_cells; ``stack.gathers`` counts the
    gathers."""
    cells = []   # obs_cells once gathered, shared by obs (no reference to ctx: no cycle)

    def gather(x):
        stack.gathers += 1
        return gather_rows(x)

    def obs_cells():
        if not cells:
            cells.append(gather(grid)[:, None])
        return cells[0]

    return (Lazy(lambda: gather(prev)), Lazy(obs_cells),
            Lazy(lambda: obs_cells().to(torch.float32)))


__all__ = ["gathered_views", "shard_carry_spatial", "spatial_sharding"]
