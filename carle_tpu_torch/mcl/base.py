"""Wrapper protocol and composition (counterpart of carle_tpu/mcl/base.py:66-220).

A wrapper is data plus plain functions:

* ``init(generator, device) -> state`` builds the wrapper's state;
* ``apply(state, ctx, reward) -> (state', reward')`` consumes a
  :class:`StepCtx` describing one environment transition and transforms the
  reward (usually ``reward + scale * bonus``);
* ``on_reset(state, grid, generator) -> (state', grid')`` hooks resets
  (``generator`` draws whatever noise a hook seeds the universe with).

A :class:`WrapperStack` runs the env transition and every wrapper apply in
order; the first wrapper listed is the innermost.  Views of the step that not
every wrapper reads (the float observation, the padded action, the action
sums; on a packed stack every cell view) are :class:`Lazy` in the
:class:`StepCtx`: computed on their first read, at most once a step.  Wrapper
state survives resets.  :class:`Motivator` is the class shell with the reference's surface
(``env = Wrapper(env)``, ``step``/``reset`` forwarded inward).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EnvConfig
from ..env import CARLE, EnvState, env_step, init_state, reset_state
from ..ops.ca import pad_action


class Lazy:
    """A step-context view computed on its first read, at most once a step:
    eager PyTorch cannot drop a view nobody reads, as the JAX package's
    compiler does, so a stack passes the recipe instead of the tensor."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], Any]) -> None:
        self.fn = fn


class StepCtx:
    """What a wrapper may observe about one env transition.  A field given as
    :class:`Lazy` is computed when a wrapper first reads it.

    prev_grid:     uint8 [inst, H, W] universe BEFORE toggle + update
    obs:           float32 [inst, 1, H, W] universe AFTER the update
    obs_cells:     uint8 [inst, 1, H, W], the same observation
    action:        uint8 [inst, AH, AW] binarised toggle patch
    action_full:   uint8 [inst, H, W] that patch padded to the universe
    action_sum:    float32 [inst, 1] sum of the RAW action VALUES (before
                   binarising; in the class shell, before cropping):
                   ParsimonyBonus divides by it
    seed:          this step's dropout seed for the net kernels: a host
                   integer (the counterpart of the JAX key)
    generator:     draws plain-PyTorch dropout
    packed:        uint32 [inst, H, W/32] universe AFTER the update (packed
                   stacks only; None on the uint8 path)
    packed_prev:   uint32 [inst, H, W/32] universe BEFORE toggle + update
    packed_action: uint32 [inst, H, W/32] toggle patch padded to the universe
    """

    __slots__ = ("_values",)

    def __init__(self, prev_grid: Any = None, obs: Any = None, obs_cells: Any = None,
                 action: Any = None, action_full: Any = None, action_sum: Any = None,
                 seed: int = 0, generator: Optional[torch.Generator] = None,
                 packed: Any = None, packed_prev: Any = None,
                 packed_action: Any = None) -> None:
        values = dict(prev_grid=prev_grid, obs=obs, obs_cells=obs_cells, action=action,
                      action_full=action_full, action_sum=action_sum, seed=seed,
                      generator=generator, packed=packed, packed_prev=packed_prev,
                      packed_action=packed_action)
        object.__setattr__(self, "_values", values)

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name not in values:
            raise AttributeError(name)
        value = values[name]
        if isinstance(value, Lazy):
            value = values[name] = value.fn()
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("StepCtx is read-only; use _replace")

    def _replace(self, **changes: Any) -> "StepCtx":
        return StepCtx(**{**self._values, **changes})


class WrapperDef(NamedTuple):
    """A reward wrapper as plain functions over an explicit state."""

    name: str
    init: Callable[[torch.Generator, torch.device], Any]
    apply: Callable[[Any, StepCtx, torch.Tensor], Tuple[Any, torch.Tensor]]
    on_reset: Callable[[Any, torch.Tensor, Optional[torch.Generator]],
                       Tuple[Any, torch.Tensor]]


def default_on_reset(state: Any, grid: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Any, torch.Tensor]:
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

    def transition(self, state: StackState, action: torch.Tensor, seed: int = 0,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[StackState, StepCtx, torch.Tensor]:
        """One transition; ``action`` is [inst, AH, AW] of any dtype, ``seed``
        and ``generator`` feed the training wrappers' dropout.  Returns
        (state', the step context, reward [inst, 1]); the context's float
        observation, padded action and action sums are computed only if a
        wrapper (or the caller) reads them."""
        prev_grid = state.env.grid
        # the RAW action goes to env_step: it binarises for the toggle, but
        # the master reset reads the mean of the values
        env_state, grid = env_step(state.env, action, self.config)
        action_bits = (action != 0).to(torch.uint8)
        ctx = StepCtx(
            prev_grid=prev_grid,
            obs=Lazy(lambda: grid.to(torch.float32)[:, None]),
            obs_cells=grid[:, None],
            action=action_bits,
            action_full=Lazy(lambda: pad_action(action_bits, self.config)),
            action_sum=Lazy(lambda: action.to(torch.float32).sum(dim=(1, 2))[:, None]),
            seed=int(seed),
            generator=generator,
        )
        new_state, reward = self._apply_wrappers(state.wrappers, env_state, ctx, grid.device)
        return new_state, ctx, reward

    def _apply_wrappers(self, wstates: Tuple[Any, ...], env_state: Any, ctx: StepCtx,
                        device) -> Tuple[StackState, torch.Tensor]:
        """Each wrapper's apply in order, the reward starting at zero."""
        reward = torch.zeros((self.config.instances, 1), dtype=torch.float32, device=device)
        new_wstates = []
        for w, ws in zip(self.wrappers, wstates):
            ws, reward = w.apply(ws, ctx, reward)
            new_wstates.append(ws)
        return StackState(env=env_state, wrappers=tuple(new_wstates)), reward

    def step(self, state: StackState, action: torch.Tensor, seed: int = 0,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[StackState, Tuple[torch.Tensor, torch.Tensor]]:
        """:meth:`transition` returning (state', (obs float32 [inst, 1, H, W],
        reward [inst, 1]))."""
        state, ctx, reward = self.transition(state, action, seed, generator)
        return state, (ctx.obs, reward)

    def reset(self, state: StackState, generator: Optional[torch.Generator] = None
              ) -> Tuple[StackState, torch.Tensor]:
        """Zero the universe and run the wrappers' reset hooks in order;
        ``generator`` draws the hooks' noise."""
        env_state = reset_state(state.env)
        grid = env_state.grid
        new_wstates = []
        for w, ws in zip(self.wrappers, state.wrappers):
            ws, grid = w.on_reset(ws, grid, generator)
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
            self._wstate, new_grid = self._wdef.on_reset(self._wstate, grid,
                                                         self._generator)
            if new_grid is not grid:
                self.inner_env.state = self.inner_env.state._replace(
                    grid=new_grid.to(torch.uint8))
                obs = self.inner_env.universe
        return obs

    def _raw_action_sums(self, action: Any) -> torch.Tensor:
        """Per-instance sum of the RAW action VALUES, uncropped: the tensor
        the reference wrapper receives (ParsimonyBonus divides by
        ``action.sum(axis=[1,2,3])``; a [1, 1, H, W] action broadcasts its
        single sum across the batch as torch does)."""
        if torch.is_tensor(action):
            action = action.detach().cpu().numpy()
        arr = np.asarray(action, dtype=np.float32)
        inst = self._config.instances
        if arr.ndim >= 3 and arr.shape[0] == inst:
            sums = arr.reshape(inst, -1).sum(axis=1)
        else:
            sums = np.full((inst,), float(arr.sum()), dtype=np.float32)
        return torch.from_numpy(sums.astype(np.float32)).to(self.inner_env.device)[:, None]

    def step(self, action: Any):
        prev_grid = self.inner_env.state.grid
        obs, reward, done, info = self.env.step(action)
        if self._wdef is not None:
            patch = self.inner_env._coerce_action(action)
            grid = self.inner_env.state.grid
            self._drop_seed += 1
            action_bits = torch.from_numpy(np.ascontiguousarray(patch != 0)).to(
                device=grid.device, dtype=torch.uint8)
            ctx = StepCtx(
                prev_grid=prev_grid, obs=obs, obs_cells=grid[:, None],
                action=action_bits,
                action_full=pad_action(action_bits, self._config),
                action_sum=self._raw_action_sums(action),
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
