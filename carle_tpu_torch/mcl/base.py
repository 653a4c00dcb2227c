"""Wrapper protocol and composition (counterpart of carle_tpu/mcl/base.py:66-220).

A wrapper is data plus plain functions:

* ``init(generator, device) -> state`` builds the wrapper's state;
* ``apply(state, ctx, reward) -> (state', reward')`` consumes a
  :class:`StepCtx` describing one environment transition and transforms the
  reward (usually ``reward + scale * bonus``);
* ``on_reset(state, grid) -> (state', grid')`` hooks resets.

A :class:`WrapperStack` runs the env transition and every wrapper apply in
order; the first wrapper listed is the innermost.  Wrapper state survives
resets.  The ``Motivator`` class shells are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence, Tuple

import torch

from ..config import EnvConfig
from ..env import EnvState, env_step, init_state, reset_state


class StepCtx(NamedTuple):
    """What a wrapper may observe about one env transition."""

    prev_grid: torch.Tensor   # uint8 [inst, H, W] universe BEFORE toggle+update
    obs: torch.Tensor         # float32 [inst, 1, H, W] universe AFTER the update
    obs_cells: torch.Tensor   # uint8 [inst, 1, H, W], the same observation
    action: torch.Tensor      # uint8 [inst, AH, AW] binarised toggle patch


class WrapperDef(NamedTuple):
    """A reward wrapper as plain functions over an explicit state."""

    name: str
    init: Callable[[torch.Generator, torch.device], Any]
    apply: Callable[[Any, StepCtx, torch.Tensor], Tuple[Any, torch.Tensor]]
    on_reset: Callable[[Any, torch.Tensor], Tuple[Any, torch.Tensor]]


def default_on_reset(state: Any, grid: torch.Tensor) -> Tuple[Any, torch.Tensor]:
    """Wrapper states deliberately survive resets (reference mcl.py:66-70)."""
    return state, grid


class StackState(NamedTuple):
    env: EnvState
    wrappers: Tuple[Any, ...]


class WrapperStack:
    """Composes ``env_step`` with an ordered wrapper list.  ``reward`` starts
    at zero and each wrapper transforms it in turn."""

    def __init__(self, config: EnvConfig,
                 wrappers: Sequence[WrapperDef] = ()) -> None:
        self.config = config
        self.wrappers = tuple(wrappers)

    def universe(self, state: StackState) -> torch.Tensor:
        """uint8 [inst, H, W] universe of a stack state."""
        return state.env.grid

    def observe(self, state: StackState) -> torch.Tensor:
        """float32 [inst, 1, H, W] observation (the agent's input)."""
        return state.env.grid.to(torch.float32)[:, None]

    def init(self, generator: torch.Generator, rule_bits,
             device: torch.device) -> StackState:
        wstates = tuple(w.init(generator, device) for w in self.wrappers)
        return StackState(env=init_state(self.config, rule_bits, device),
                          wrappers=wstates)

    def step(self, state: StackState, action: torch.Tensor
             ) -> Tuple[StackState, Tuple[torch.Tensor, torch.Tensor]]:
        """One transition; ``action`` is [inst, AH, AW] of any dtype.
        Returns (state', (obs float32 [inst, 1, H, W], reward [inst, 1]))."""
        prev_grid = state.env.grid
        # the RAW action goes to env_step: it binarises for the toggle, but
        # the master reset reads the mean of the values
        env_state, grid = env_step(state.env, action, self.config)
        ctx = StepCtx(
            prev_grid=prev_grid,
            obs=grid.to(torch.float32)[:, None],
            obs_cells=grid[:, None],
            action=(action != 0).to(torch.uint8),
        )
        reward = torch.zeros((self.config.instances, 1), dtype=torch.float32,
                             device=grid.device)
        new_wstates = []
        for w, ws in zip(self.wrappers, state.wrappers):
            ws, reward = w.apply(ws, ctx, reward)
            new_wstates.append(ws)
        return (StackState(env=env_state, wrappers=tuple(new_wstates)),
                (ctx.obs, reward))

    def reset(self, state: StackState) -> Tuple[StackState, torch.Tensor]:
        """Zero the universe and run the wrappers' reset hooks in order."""
        env_state = reset_state(state.env)
        grid = env_state.grid
        new_wstates = []
        for w, ws in zip(self.wrappers, state.wrappers):
            ws, grid = w.on_reset(ws, grid)
            new_wstates.append(ws)
        env_state = env_state._replace(grid=grid)
        return (StackState(env=env_state, wrappers=tuple(new_wstates)),
                grid.to(torch.float32)[:, None])
