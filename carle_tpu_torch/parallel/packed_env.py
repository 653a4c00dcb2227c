"""The packed stack: full environment semantics on universes stored 32 cells
a word, on one device or with the rows sharded over a mesh (counterpart of
carle_tpu/parallel/packed_env.py).

* the centred action-window XOR toggle, on words (``packed.pack_action``);
* the batch-global master reset when the mean of the action VALUES is 1.0;
* one CA generation: the ``bit_multi_step`` kernel with one step on one
  device, the ``bit_spatial_multi_step`` halo kernel with a mesh;
* every wrapper bonus, online learning included.

Observations unpack lazily: the step context holds the packed words
(``packed``, ``packed_prev``, ``packed_action``), and its cell views
(``obs``, ``obs_cells``, ``prev_grid``, ``action_full``) are
:class:`~carle_tpu_torch.mcl.base.Lazy`, computed on a wrapper's first read
and at most once a step.  When every wrapper is packed-native
(mcl/packed_stats.py) and the nets read the words themselves
(``_online.net_input``), a step unpacks nothing: :attr:`unpacks` counts the
unpacks of the cell views.  The JAX package gets the same from XLA's
dead-code elimination.

With ``mesh`` (parallel/mesh.py) the universe is :class:`~.mesh.RowShards`:
each slot holds H/n rows of every universe as words, and a step XORs the
packed action into the slots whose rows hold the window, runs one halo
generation and applies the master reset on every slot.  ``ctx.packed``,
``packed_prev`` and ``packed_action`` stay sharded (the packed-native
wrappers reduce each shard and add; the nets take
``fused_head=nets.SpaceSharding(mesh)``), while the cell views gather the
shards onto the mesh's home device, as GSPMD gathers a sharded array for an
unsharded consumer: :attr:`gathers` counts them beside :attr:`unpacks`.
On a mesh spanning processes (parallel/distributed.py) each process holds
its slots' words, the action and the views are its instances', the ghost
words cross processes point to point, and the master reset and the
wrappers' batch sums are the whole batch's (``ctx.batch``).
Everything but the universe (rules, counters, wrapper states) lives on the
home device.  Trajectories equal the uint8 stack's bit for bit, toggles,
resets and learning wrappers included (tests/test_torch_packed.py,
tests/test_torch_spatial.py).

With ``env_axis`` on a two-axis ``Mesh([[...], ...], ("env", "space"))``
the universes' instances also shard over ``env`` (parallel/mesh.py): each
env group's slots are a ring of their own, a step XORs each group's
instances of the window into its ring and runs the halo kernel once a ring,
the master reset (worked out once over every instance) clears every ring,
and the gathered views, ``universe`` and ``observe`` come back in instance
order (tests/test_torch_spatial_2d.py).  ``free_steps`` runs each ring where
the JAX stack gathers over ``env`` for the burst; the bits are the same.

Usage::

    stack = PackedSpatialStack(config, wrappers)                 # one device
    stack = PackedSpatialStack(config, wrappers, make_mesh(...))  # row shards
    stack = PackedSpatialStack(config, wrappers, mesh2d, env_axis="env")  # env x space
    ro = Rollout(config, agent=agent, stack=stack, device="cuda")
    carry = ro.init(ro.generator(0), rule_bits)
    carry, rewards = ro.run(carry, num_steps)
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from ..config import EnvConfig
from ..mcl.base import Lazy, StackState, StepCtx, WrapperDef, WrapperStack
from ..ops.bitpack import WORD, pack_grid, unpack_grid
from ..ops.ca import pad_action
from ..ops.cuda_bitpack import bit_multi_step
from ..packed import (PackedEnvState, init_packed_state, pack_action, pack_action_window,
                      packed_transition, xor_words)
from .mesh import (Mesh, RowShards, gather_rows, local_batch, local_map, ringwise, shard_rows,
                   tree_map_leaves)
from .spatial import bit_spatial_multi_step
from .spatial_env import _placement, place_leaf


class PackedSpatialStack(WrapperStack):
    """WrapperStack whose universe is bit-packed, and with ``mesh`` its rows
    sharded over the mesh's ``axis_name`` axis.  Same public contract as
    :class:`~carle_tpu_torch.mcl.base.WrapperStack` (``init``, ``step``,
    ``transition``, ``reset``, ``observe``), so :class:`Rollout` and the
    trainer compose with it unchanged.  Needs ``width % 32 == 0`` and, with a
    mesh, ``height`` divisible by the slots of its ``axis_name``; with
    ``env_axis`` (a two-axis mesh) ``instances`` divisible by its groups.
    ``serialize`` is the base stack's (the same bits)."""

    def __init__(self, config: EnvConfig, wrappers: Sequence[WrapperDef] = (),
                 mesh: Optional[Mesh] = None, axis_name: str = "space",
                 env_axis: Optional[str] = None, serialize: bool = False) -> None:
        if config.width % WORD:
            raise ValueError(f"packed stack needs width % {WORD} == 0, got {config.width}")
        if env_axis is not None and mesh is None:
            raise ValueError("env_axis needs a two-axis mesh")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh)}")
            n = mesh.shape[axis_name]
            if config.height % n:
                raise ValueError(f"height {config.height} not divisible by the space axis "
                                 f"({n})")
            if env_axis is not None:
                if env_axis not in mesh.shape:
                    raise ValueError(f"env axis {env_axis!r} is not an axis of {mesh}")
                if config.instances % mesh.shape[env_axis]:
                    raise ValueError(f"instances {config.instances} not divisible by the "
                                     f"env axis ({mesh.shape[env_axis]})")
        super().__init__(config, wrappers, serialize)
        self.mesh = mesh
        self.axis_name = axis_name
        self.env_axis = env_axis
        self.unpacks = 0  # cell views unpacked by steps (module note)

    # --- state accessors ----------------------------------------------------
    def _shards(self, g) -> RowShards:
        """The universe as shards on the mesh and axes of the stack (a whole
        tensor, or shards laid out otherwise, are sharded anew, as a
        shard_map reshards its input)."""
        if isinstance(g, RowShards):
            if g.mesh is self.mesh and g.env_axis == self.env_axis:
                return g
            g = gather_rows(g)
        return self._shard(g)

    def _shard(self, words: torch.Tensor) -> RowShards:
        return shard_rows(words, self.mesh, self.axis_name, self.env_axis)

    def _shard_batch(self, words: torch.Tensor, like: RowShards) -> RowShards:
        """Words over this process's instances (the step's) as shards laid
        out as ``like`` (within one process: all the instances)."""
        sl = like.local_instances()
        if words.shape[0] != like.shape[0]:   # placed in the whole batch's rows
            full = words.new_zeros((like.shape[0],) + tuple(words.shape[1:]))
            full[sl] = words
            words = full
        return self._shard(words)

    def universe(self, state: StackState, instance: Optional[int] = None) -> torch.Tensor:
        """uint8 [inst, H, W] universe (or one instance's [H, W])."""
        g = state.env.grid
        if isinstance(g, RowShards):
            if instance is not None:
                return unpack_grid(gather_rows(g.take(instance)), self.config.width)[0]
            g = gather_rows(g)
        elif instance is not None:
            g = g[instance]  # decode ONE instance, not the whole batch
        return unpack_grid(g, self.config.width)

    def observe(self, state: StackState) -> torch.Tensor:
        g = state.env.grid
        g = gather_rows(g) if isinstance(g, RowShards) else g
        return unpack_grid(g, self.config.width).to(torch.float32)[:, None]

    def init(self, generator: torch.Generator, rule_bits, device) -> StackState:
        wstates = tuple(w.init(generator, device) for w in self.wrappers)
        env = init_packed_state(self.config, rule_bits, device)
        if self.mesh is not None:
            env = env._replace(grid=self._shard(env.grid))
        return StackState(env=env, wrappers=wstates)

    def _unpack(self, words) -> torch.Tensor:
        if isinstance(words, RowShards):
            self.gathers += 1
            words = gather_rows(words)
        self.unpacks += 1
        return unpack_grid(words, self.config.width)

    # --- the transition -----------------------------------------------------
    def _ca(self, env: PackedEnvState, action: torch.Tensor
            ) -> Tuple[PackedEnvState, torch.Tensor, Any]:
        """(state', binarised patch, packed toggle plane) of one transition:
        on one device ``packed_transition``; with a mesh the sharded
        transition, its toggle plane a Lazy of shards."""
        cfg = self.config
        if self.mesh is None:
            return packed_transition(env, action, cfg)

        def toggled(ring: RowShards, window: torch.Tensor, r0: int, w0: int) -> RowShards:
            """The ring's slots with its instances' packed window XOR-ed in."""
            ah, nw = window.shape[1], window.shape[2]
            offsets = ring.offsets()

            def toggle(i, p):
                a = offsets[i]
                lo, hi = max(a, r0), min(a + ring.rows, r0 + ah)
                if lo < hi:   # this slot's rows hold part of the window
                    p = p.clone()
                    p[:, lo - a:hi - a, w0:w0 + nw] = xor_words(
                        p[:, lo - a:hi - a, w0:w0 + nw], window[:, lo - r0:hi - r0].to(p.device))
                return p

            return RowShards(local_map(ring, toggle), ring.mesh, ring.axis)

        def halo_step(grid, action_bits):
            window, r0, w0 = pack_action_window(action_bits, cfg)
            prev = self._shards(grid)
            prev = ringwise(prev, lambda ring, e: toggled(ring, window[prev.batch_rows(e)],
                                                          r0, w0))
            stepped = bit_spatial_multi_step(prev, env.rule_bits, 1)
            return stepped, Lazy(lambda: self._shard_batch(pack_action(action_bits, cfg),
                                                           prev))

        return packed_transition(env, action, cfg, halo_step)

    def transition(self, state: StackState, action: torch.Tensor, seed: int = 0,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[StackState, StepCtx, torch.Tensor]:
        cfg = self.config
        prev_packed = state.env.grid
        if self.mesh is not None:
            prev_packed = self._shards(prev_packed)
            state = state._replace(env=state.env._replace(grid=prev_packed))
        new_env, action_bits, action_packed = self._ca(state.env, action)
        new_packed = new_env.grid
        ctx = StepCtx(
            prev_grid=Lazy(lambda: self._unpack(prev_packed)),
            obs=Lazy(lambda cells: cells.to(torch.float32), "obs_cells"),
            obs_cells=Lazy(lambda: self._unpack(new_packed)[:, None]),
            action=action_bits,
            action_full=Lazy(lambda: pad_action(action_bits, cfg)),
            action_sum=Lazy(lambda: action.to(torch.float32).sum(dim=(1, 2))[:, None]),
            seed=int(seed),
            generator=generator,
            packed=new_packed,
            packed_prev=prev_packed,
            packed_action=action_packed,
            batch=local_batch(new_packed),
        )
        new_state, reward = self._apply_wrappers(state.wrappers, new_env, ctx,
                                                 new_packed.device)
        return new_state, ctx, reward

    def reset(self, state: StackState, generator: Optional[torch.Generator] = None
              ) -> Tuple[StackState, torch.Tensor]:
        """Zero the universe and run the wrappers' reset hooks, which work on
        cells (MorphoBonus seeds nucleation noise) on one device (the mesh's
        home); resets are rare, so the grid is repacked (and resharded) after
        them."""
        env = state.env
        grid = torch.zeros((self.config.instances, self.config.height, self.config.width),
                           dtype=torch.uint8, device=env.step_num.device)
        new_wstates = []
        for w, ws in zip(self.wrappers, state.wrappers):
            ws, grid = w.on_reset(ws, grid, generator)
            new_wstates.append(ws)
        words = pack_grid(grid.to(torch.uint8))
        if self.mesh is not None:
            words = self._shard(words)
        env = PackedEnvState(grid=words, rule_bits=env.rule_bits,
                             step_num=torch.zeros_like(env.step_num),
                             steps_since_action=torch.zeros_like(env.steps_since_action))
        return (StackState(env=env, wrappers=tuple(new_wstates)),
                grid.to(torch.float32)[:, None])

    def free_steps(self, state: StackState, num_steps: int) -> StackState:
        """``num_steps`` action-free generations on the words (one
        ``bit_multi_step`` launch on one device, the halo kernel with a mesh;
        no unpack, no wrapper work): burn-in and serving rollouts.
        steps_since_action advances too, as ``CARLE.multi_step`` does."""
        env = state.env
        n = int(num_steps)
        if self.mesh is None:
            grid = bit_multi_step(env.grid, env.rule_bits, n)
        else:
            grid = bit_spatial_multi_step(self._shards(env.grid), env.rule_bits, n)
        return state._replace(env=env._replace(
            grid=grid, step_num=env.step_num + n,
            steps_since_action=env.steps_since_action + n))


def packed_spatial_sharding(mesh: Mesh, leaf: Any, config: EnvConfig,
                            axis_name: str = "space", env_axis: Optional[str] = None) -> Any:
    """Where one packed-stack state leaf goes: for the packed universes
    [instances, H, W/32] the axis name their rows shard over, or with
    ``env_axis`` (a two-axis mesh) the spec ``(env_axis, axis_name, None)``
    (``None`` first where the instances do not divide over it); None for a
    leaf that stays whole on the mesh's home device: parameters, optimizer
    state, counters, rules, and the wrappers' own word planes (the packed
    statistics' [H, W/32] masks, the Prediction ring) — the JAX package
    shards those too, where GSPMD hides it from the wrappers."""
    universe = (config.instances, config.height, config.width // WORD)
    return _placement(mesh, leaf, config, universe, torch.uint32, axis_name, env_axis)


def shard_carry_packed(carry: Any, mesh: Mesh, config: EnvConfig,
                       axis_name: str = "space", env_axis: Optional[str] = None) -> Any:
    """A packed-stack carry (or state) with its packed universes sharded over
    the mesh (with ``env_axis`` their instances too: pass the stack the same
    axes) and every other tensor on the mesh's home device."""
    return tree_map_leaves(lambda leaf: place_leaf(
        leaf, packed_spatial_sharding(mesh, leaf, config, axis_name, env_axis), mesh,
        axis_name), carry)


__all__ = ["PackedSpatialStack", "packed_spatial_sharding", "shard_carry_packed"]
