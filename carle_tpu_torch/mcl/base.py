"""Wrapper protocol and composition (counterpart of carle_tpu/mcl/base.py:66-220).

A wrapper is data plus plain functions:

* ``init(generator, device) -> state`` builds the wrapper's state;
* ``apply(state, ctx, reward) -> (state', reward')`` consumes a
  :class:`StepCtx` describing one environment transition and transforms the
  reward (usually ``reward + scale * bonus``);
* ``on_reset(state, grid) -> (state', grid')`` hooks resets.

A :class:`WrapperStack` runs the env transition and every wrapper apply in
order; the first wrapper listed is the innermost.  Wrapper state survives
resets.  :class:`Motivator` is the class shell with the reference's surface
(``env = Wrapper(env)``, ``step``/``reset`` forwarded inward).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EnvConfig
from ..env import CARLE, EnvState, env_step, init_state, reset_state


class StepCtx(NamedTuple):
    """What a wrapper may observe about one env transition."""

    prev_grid: torch.Tensor   # uint8 [inst, H, W] universe BEFORE toggle+update
    obs: torch.Tensor         # float32 [inst, 1, H, W] universe AFTER the update
    obs_cells: torch.Tensor   # uint8 [inst, 1, H, W], the same observation
    action: torch.Tensor      # uint8 [inst, AH, AW] binarised toggle patch
    seed: int = 0             # this step's dropout seed for the net kernels: a
                              # host integer (the counterpart of the JAX key)
    generator: Optional[torch.Generator] = None  # draws plain-PyTorch dropout


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

    def step(self, state: StackState, action: torch.Tensor, seed: int = 0,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[StackState, Tuple[torch.Tensor, torch.Tensor]]:
        """One transition; ``action`` is [inst, AH, AW] of any dtype, ``seed``
        and ``generator`` feed the training wrappers' dropout.  Returns
        (state', (obs float32 [inst, 1, H, W], reward [inst, 1]))."""
        prev_grid = state.env.grid
        # the RAW action goes to env_step: it binarises for the toggle, but
        # the master reset reads the mean of the values
        env_state, grid = env_step(state.env, action, self.config)
        ctx = StepCtx(
            prev_grid=prev_grid,
            obs=grid.to(torch.float32)[:, None],
            obs_cells=grid[:, None],
            action=(action != 0).to(torch.uint8),
            seed=int(seed),
            generator=generator,
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


# ---------------------------------------------------------------------------
# Reference-compatible class shell
# ---------------------------------------------------------------------------


class Motivator:
    """Class shell matching the reference wrapper surface: ``env =
    Wrapper(env)``, ``step``/``reset`` forwarded inward, ``inner_env`` always
    the raw CARLE, rule setters proxied.

    Subclasses define ``_make_def() -> WrapperDef``; reward bubbles outward
    as in the reference (inner wrappers' bonuses are applied first).  The
    shell's own generator (``seed`` keyword) draws the wrapper's initial
    parameters and its plain-PyTorch dropout; the net kernels' dropout seed
    is a host counter that advances every step.
    """

    my_name = "Motivator"

    def __init__(self, env: Any, **kwargs: Any) -> None:
        inner = getattr(env, "inner_env", None)
        self.inner_env: CARLE = env if inner is None else inner
        self.env = env

        self.height = self.inner_env.height
        # reference quirk preserved: width copies height; square universes
        # (the only shipped configs) are unaffected
        self.width = self.inner_env.height
        self.action_height = self.inner_env.action_height
        self.action_width = self.inner_env.action_width
        self.my_device = self.inner_env.my_device
        self._reward_scale_attr = kwargs.get("reward_scale", 1.0)

        self._config: EnvConfig = self.inner_env.config
        seed = int(kwargs.pop("seed", 0))
        self._generator = torch.Generator(device=self.inner_env.device).manual_seed(seed)
        self._drop_seed = (seed & 0x7FFFFFFF) << 24
        self._train = True
        self._wdef: Optional[WrapperDef] = None
        self._wstate: Any = None
        self._build(**kwargs)

    # -- subclass hooks ----------------------------------------------------
    def _make_def(self, **kwargs: Any) -> Optional[WrapperDef]:
        return None

    def _build(self, **kwargs: Any) -> None:
        self._wdef = self._make_def(**kwargs)
        if self._wdef is not None:
            self._wstate = self._wdef.init(self._generator, self.inner_env.device)

    # -- tunables that live inside the wrapper state -----------------------
    # The eval harness mutates reward_scale / batch_size after construction;
    # both are tensors of the wrapper state, so the mutation is a state
    # update and the next step sees it.
    @property
    def reward_scale(self) -> float:
        if self._wstate is not None and hasattr(self._wstate, "reward_scale"):
            return float(self._wstate.reward_scale)
        return self._reward_scale_attr

    @reward_scale.setter
    def reward_scale(self, value: float) -> None:
        if self._wstate is not None and hasattr(self._wstate, "reward_scale"):
            self._wstate = self._wstate._replace(reward_scale=torch.as_tensor(
                value, dtype=torch.float32, device=self.inner_env.device))
        else:
            self._reward_scale_attr = value

    @property
    def batch_size(self) -> int:
        if self._wstate is not None and hasattr(self._wstate, "batch_size"):
            return int(self._wstate.batch_size)
        if hasattr(self, "_batch_size_attr"):
            return self._batch_size_attr
        raise AttributeError(f"{type(self).__name__} has no batch_size")

    @batch_size.setter
    def batch_size(self, value: int) -> None:
        if self._wstate is not None and hasattr(self._wstate, "batch_size"):
            self._wstate = self._wstate._replace(batch_size=torch.as_tensor(
                value, dtype=torch.int32, device=self.inner_env.device))
        else:
            # non-learning wrappers keep the assignment as an inert attribute:
            # the reference eval harness sets batch_size on every wrapper
            self._batch_size_attr = int(value)

    # -- rule proxies --------------------------------------------------------
    @property
    def birth(self) -> List[int]:
        return self.inner_env.birth

    @birth.setter
    def birth(self, digits: List[int]) -> None:
        self.inner_env.birth = digits

    @property
    def survive(self) -> List[int]:
        return self.inner_env.survive

    @survive.setter
    def survive(self, digits: List[int]) -> None:
        self.inner_env.survive = digits

    def rules_from_string(self, my_string: str = "B3/S23") -> None:
        self.inner_env.rules_from_string(my_string)

    def birth_rule_from_string(self, my_string: str = "b3") -> None:
        self.inner_env.birth_rule_from_string(my_string)

    def survive_rule_from_string(self, my_string: str = "s23") -> None:
        self.inner_env.survive_rule_from_string(my_string)

    # -- gym API -------------------------------------------------------------
    def reset(self) -> torch.Tensor:
        obs = self.env.reset()
        if self._wdef is not None:
            grid = self.inner_env.state.grid
            self._wstate, new_grid = self._wdef.on_reset(self._wstate, grid)
            if new_grid is not grid:
                self.inner_env.state = self.inner_env.state._replace(
                    grid=new_grid.to(torch.uint8))
                obs = self.inner_env.universe
        return obs

    def step(self, action: Any):
        prev_grid = self.inner_env.state.grid
        obs, reward, done, info = self.env.step(action)
        if self._wdef is not None:
            patch = self.inner_env._coerce_action(action)
            grid = self.inner_env.state.grid
            self._drop_seed += 1
            ctx = StepCtx(
                prev_grid=prev_grid, obs=obs, obs_cells=grid[:, None],
                action=torch.from_numpy(np.ascontiguousarray(patch != 0)).to(
                    device=grid.device, dtype=torch.uint8),
                seed=self._drop_seed, generator=self._generator)
            self._wstate, reward = self._wdef.apply(self._wstate, ctx, reward)
        return obs, reward, done, info

    # -- torch-compat shims ----------------------------------------------------
    def eval(self) -> "Motivator":
        self._train = False
        self._rebuild_mode()
        return self

    def train(self) -> "Motivator":
        self._train = True
        self._rebuild_mode()
        return self

    def _rebuild_mode(self) -> None:
        """Hook for learning wrappers to swap train/eval apply functions."""

    def to(self, *a: Any, **k: Any) -> "Motivator":
        return self

    def set_grad(self) -> None:
        pass

    def set_no_grad(self) -> None:
        pass
