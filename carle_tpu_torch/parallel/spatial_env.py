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
checked here.

On a two-axis ``Mesh([[...], ...], ("env", "space"))``,
:func:`shard_carry_2d` shards the universes' instances over ``env`` and
their rows over ``space`` at once (parallel/mesh.py): each env group's
slots are a ring of their own, the step launches once a ring a device with
the ring's instances of the action and the rule, and the master reset's
flag is worked out once over every instance.  The gathered views come back
in instance order.  Universes whose instances do not divide over ``env``
shard their rows only (on the first group's ring).  The other
instance-batched leaves (statistics, action streams), which the JAX package
shards over ``env``, stay whole on the home device with everything else.

The env-batch layout of ``mesh.shard_carry`` is this mode on a two-axis
mesh whose rings have one slot each (``mesh.env_layout``): a slot holds its
instances whole, the step launches once a slot, and a ring of one slot
wraps each universe onto itself.  On it the learners with a
``fused_head=Mesh`` read ``ctx.obs_shards``, the instance shards themselves
(nets.py's batch-axis routes); the gathered views are read only by the
wrappers that want the whole batch (Speed's velocity sum and Puffer's count
read ``obs``, Corner and Morpho the cells, Prediction its frame) and, outside
the step, by the agent's observation (``observe``), so a stack of RND2D and
AE2D gathers nothing, and one with Speed and Puffer gathers once a step.

Usage::

    mesh = make_mesh([torch.device("cuda")] * 4, "space")   # or several cards
    ro = Rollout(config, wrappers, agent, device="cuda")    # unchanged
    carry = ro.init(ro.generator(0), rule_bits)
    carry = shard_carry_spatial(carry, mesh, config)
    carry, rewards = ro.run(carry, num_steps)               # runs row-sharded

    mesh = Mesh([[torch.device("cuda")] * 4] * 2, ("env", "space"))
    carry = shard_carry_2d(ro.init(ro.generator(0), rule_bits), mesh, config)
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..config import EnvConfig
from ..mcl.base import Lazy, WrapperStack
from .mesh import Mesh, RowShards, gather_rows, shard_rows, tree_map_leaves


def _placement(mesh: Mesh, leaf: Any, config: EnvConfig, universe: Tuple[int, ...],
               dtype: torch.dtype, axis_name: str, env_axis: Optional[str]) -> Any:
    """The placement of one leaf: None (whole on the home device) unless it
    is a universe of ``dtype`` and shape ``universe`` whose rows divide over
    ``axis_name``; then the axis name, or with ``env_axis`` the spec
    (``env_axis`` or None, ``axis_name``, None) of JAX's PartitionSpec, the
    instances over ``env_axis`` where it is an axis of the mesh that divides
    them."""
    n = mesh.shape[axis_name]
    if not (isinstance(leaf, torch.Tensor) and leaf.dtype == dtype
            and tuple(leaf.shape) == universe and config.height % n == 0):
        return None
    if env_axis is None:
        return axis_name
    env = (env_axis if env_axis in mesh.shape
           and config.instances % mesh.shape[env_axis] == 0 else None)
    return (env, axis_name, None)


def spatial_sharding(mesh: Mesh, leaf: Any, config: EnvConfig, axis_name: str = "space",
                     env_axis: Optional[str] = None) -> Any:
    """Where one state leaf goes in spatial mode: for the uint8 universes
    [instances, H, W] the axis name their rows shard over, or with
    ``env_axis`` (a two-axis mesh) the spec ``(env_axis, axis_name, None)``,
    ``(None, axis_name, None)`` where the instances do not divide over the
    env axis; None for a leaf that stays whole on the mesh's home device
    (parameters, optimizer state, counters, rules, wrapper states; the JAX
    package shards every leaf of the universe's extent, and instance-batched
    leaves over ``env``, where GSPMD hides it from the wrappers)."""
    return _placement(mesh, leaf, config, config.grid_shape, torch.uint8, axis_name,
                      env_axis)


def place_leaf(leaf: Any, where: Any, mesh: Mesh, axis_name: str) -> Any:
    """A leaf where a placement (:func:`spatial_sharding`) puts it: row
    shards (the instances over the spec's env axis, where it has one), or
    whole on the home device; shards and non-tensors as they are."""
    if isinstance(leaf, RowShards) or not isinstance(leaf, torch.Tensor):
        return leaf
    if where is None:
        return leaf.to(mesh.home)
    return shard_rows(leaf, mesh, axis_name, where[0] if isinstance(where, tuple) else None)


def shard_carry_spatial(carry: Any, mesh: Mesh, config: EnvConfig,
                        axis_name: str = "space") -> Any:
    """A rollout carry (or any state tree) for spatial execution: the uint8
    universes row-sharded over the mesh, every other tensor on the mesh's
    home device.  For the env x space layout use :func:`shard_carry_2d`."""
    return tree_map_leaves(lambda leaf: place_leaf(
        leaf, spatial_sharding(mesh, leaf, config, axis_name), mesh, axis_name), carry)


def shard_carry_2d(carry: Any, mesh: Mesh, config: EnvConfig, env_axis: str = "env",
                   space_axis: str = "space") -> Any:
    """A rollout carry on a two-axis env x space mesh: the uint8 universes'
    instances sharded over ``env_axis`` and their rows over ``space_axis``
    at once, every other tensor on the home device.  A universe whose
    instances do not divide over the env axis shards its rows only, as the
    JAX package's leaf that fails a divisibility check shards only on the
    other axis (3 instances on 2 x 4: rows over ``space``)."""
    return tree_map_leaves(lambda leaf: place_leaf(
        leaf, spatial_sharding(mesh, leaf, config, space_axis, env_axis), mesh, space_axis),
        carry)


def gathered_views(stack: WrapperStack, prev: RowShards, grid: RowShards
                   ) -> Tuple[Lazy, Lazy, Lazy]:
    """The step context's cell views of a sharded transition, (prev_grid,
    obs_cells, obs): each gathered onto the mesh's home device on its first
    read, obs from the gathered obs_cells; ``stack.gathers`` counts the
    gathers (module note: which wrappers read them)."""
    def gather(x):
        stack.gathers += 1
        return gather_rows(x)

    return (Lazy(lambda: gather(prev)), Lazy(lambda: gather(grid)[:, None]),
            Lazy(lambda cells: cells.to(torch.float32), "obs_cells"))


__all__ = ["gathered_views", "shard_carry_2d", "shard_carry_spatial", "spatial_sharding"]
