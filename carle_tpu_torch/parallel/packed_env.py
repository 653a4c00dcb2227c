"""The packed stack: full environment semantics on universes stored 32 cells
a word (counterpart of carle_tpu/parallel/packed_env.py, single-device mode).

* the centred action-window XOR toggle, on words (``packed.pack_action``);
* the batch-global master reset when the mean of the action VALUES is 1.0;
* one CA generation: the ``bit_multi_step`` kernel with one step on the card;
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

The JAX stack also shards rows over a device mesh; here ``mesh`` must be None
(the multi-device halo path is ROADMAP Queue 1 item 11).  Trajectories equal
the uint8 stack's bit for bit, toggles, resets and learning wrappers included
(tests/test_torch_packed.py).

Usage::

    stack = PackedSpatialStack(config, wrappers)
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
from ..packed import PackedEnvState, init_packed_state, packed_transition


class PackedSpatialStack(WrapperStack):
    """WrapperStack whose universe is bit-packed.  Same public contract as
    :class:`~carle_tpu_torch.mcl.base.WrapperStack` (``init``, ``step``,
    ``transition``, ``reset``, ``observe``), so :class:`Rollout` and
    the trainer compose with it unchanged.  Needs ``width % 32 == 0``.
    ``axis_name`` and ``env_axis`` name the JAX stack's mesh axes; with no
    mesh they are unused."""

    def __init__(self, config: EnvConfig, wrappers: Sequence[WrapperDef] = (),
                 mesh: Any = None, axis_name: str = "space",
                 env_axis: Optional[str] = None) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "PackedSpatialStack runs on one device (mesh=None); the "
                "row-sharded multi-device stack is ROADMAP Queue 1 item 11")
        if config.width % WORD:
            raise ValueError(f"packed stack needs width % {WORD} == 0, got {config.width}")
        super().__init__(config, wrappers)
        self.unpacks = 0  # cell views unpacked by steps (module note)

    # --- state accessors ----------------------------------------------------
    def universe(self, state: StackState, instance: Optional[int] = None) -> torch.Tensor:
        """uint8 [inst, H, W] universe (or one instance's [H, W])."""
        g = state.env.grid
        if instance is not None:
            g = g[instance]  # decode ONE instance, not the whole batch
        return unpack_grid(g, self.config.width)

    def observe(self, state: StackState) -> torch.Tensor:
        return unpack_grid(state.env.grid, self.config.width).to(torch.float32)[:, None]

    def init(self, generator: torch.Generator, rule_bits, device) -> StackState:
        wstates = tuple(w.init(generator, device) for w in self.wrappers)
        return StackState(env=init_packed_state(self.config, rule_bits, device),
                          wrappers=wstates)

    def _unpack(self, words: torch.Tensor) -> torch.Tensor:
        self.unpacks += 1
        return unpack_grid(words, self.config.width)

    # --- the transition -----------------------------------------------------
    def transition(self, state: StackState, action: torch.Tensor, seed: int = 0,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[StackState, StepCtx, torch.Tensor]:
        cfg = self.config
        prev_packed = state.env.grid
        new_env, action_bits, action_packed = packed_transition(state.env, action, cfg)
        new_packed = new_env.grid
        cells = []   # obs_cells once computed, shared by obs (no reference to ctx: no cycle)

        def obs_cells():
            if not cells:
                cells.append(self._unpack(new_packed)[:, None])
            return cells[0]

        ctx = StepCtx(
            prev_grid=Lazy(lambda: self._unpack(prev_packed)),
            obs=Lazy(lambda: obs_cells().to(torch.float32)),
            obs_cells=Lazy(obs_cells),
            action=action_bits,
            action_full=Lazy(lambda: pad_action(action_bits, cfg)),
            action_sum=Lazy(lambda: action.to(torch.float32).sum(dim=(1, 2))[:, None]),
            seed=int(seed),
            generator=generator,
            packed=new_packed,
            packed_prev=prev_packed,
            packed_action=action_packed,
        )
        new_state, reward = self._apply_wrappers(state.wrappers, new_env, ctx,
                                                 new_packed.device)
        return new_state, ctx, reward

    def reset(self, state: StackState, generator: Optional[torch.Generator] = None
              ) -> Tuple[StackState, torch.Tensor]:
        """Zero the universe and run the wrappers' reset hooks, which work on
        cells (MorphoBonus seeds nucleation noise); resets are rare, so the
        grid is repacked after them."""
        env = state.env
        grid = torch.zeros((self.config.instances, self.config.height, self.config.width),
                           dtype=torch.uint8, device=env.grid.device)
        new_wstates = []
        for w, ws in zip(self.wrappers, state.wrappers):
            ws, grid = w.on_reset(ws, grid, generator)
            new_wstates.append(ws)
        env = PackedEnvState(grid=pack_grid(grid.to(torch.uint8)), rule_bits=env.rule_bits,
                             step_num=torch.zeros_like(env.step_num),
                             steps_since_action=torch.zeros_like(env.steps_since_action))
        return (StackState(env=env, wrappers=tuple(new_wstates)),
                grid.to(torch.float32)[:, None])

    def free_steps(self, state: StackState, num_steps: int) -> StackState:
        """``num_steps`` action-free generations on the words (one
        ``bit_multi_step`` launch; no unpack, no wrapper work): burn-in and
        serving rollouts.  steps_since_action advances too, as
        ``CARLE.multi_step`` does."""
        env = state.env
        n = int(num_steps)
        return state._replace(env=env._replace(
            grid=bit_multi_step(env.grid, env.rule_bits, n), step_num=env.step_num + n,
            steps_since_action=env.steps_since_action + n))


__all__ = ["PackedSpatialStack"]
