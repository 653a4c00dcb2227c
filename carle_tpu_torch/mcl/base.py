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
from ..env import CARLE, EnvState, env_step, init_state
from ..ops.ca import pad_action


class Lazy:
    """A step-context view computed on its first read, at most once a step:
    eager PyTorch cannot drop a view nobody reads, as the JAX package's
    compiler does, so a stack passes the recipe instead of the tensor.
    ``needs`` names other fields of the context that ``fn`` takes, read
    through the context (so a view built on another shares it, and the
    recipe holds no reference to the context)."""

    __slots__ = ("fn", "needs")

    def __init__(self, fn: Callable[..., Any], *needs: str) -> None:
        self.fn = fn
        self.needs = needs


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
    obs_shards:    uint8 [inst, 1, H, W] universe AFTER the update as the row
                   or instance shards it steps on (a sharded uint8 stack:
                   parallel/spatial_env.py; None elsewhere), which the nets'
                   batch-axis route reads without a gather
    batch:         on a mesh spanning processes, which instances of the
                   batch this process holds (``distributed.LocalBatch``:
                   every per-instance field above is over them; batch-global
                   sums add the processes' owned instances); None elsewhere
    """

    __slots__ = ("_values", "_given")

    def __init__(self, prev_grid: Any = None, obs: Any = None, obs_cells: Any = None,
                 action: Any = None, action_full: Any = None, action_sum: Any = None,
                 seed: int = 0, generator: Optional[torch.Generator] = None,
                 packed: Any = None, packed_prev: Any = None,
                 packed_action: Any = None, obs_shards: Any = None, batch: Any = None) -> None:
        values = dict(prev_grid=prev_grid, obs=obs, obs_cells=obs_cells, action=action,
                      action_full=action_full, action_sum=action_sum, seed=seed,
                      generator=generator, packed=packed, packed_prev=packed_prev,
                      packed_action=packed_action, obs_shards=obs_shards, batch=batch)
        object.__setattr__(self, "_values", values)
        object.__setattr__(self, "_given", dict(values))   # the fields as given

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name not in values:
            raise AttributeError(name)
        value = values[name]
        if isinstance(value, Lazy):
            value = values[name] = value.fn(*(getattr(self, n) for n in value.needs))
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("StepCtx is read-only; use _replace")

    def _replace(self, **changes: Any) -> "StepCtx":
        return StepCtx(**{**self._values, **changes})

    def released(self) -> "StepCtx":
        """The context as given, with every :class:`Lazy` view back to its
        recipe: the views that reads computed are no longer held by it."""
        return StepCtx(**self._given)


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

    def __init__(self, config: EnvConfig, wrappers: Sequence[WrapperDef] = (),
                 serialize: bool = False) -> None:
        self.config = config
        self.wrappers = tuple(wrappers)
        # serialize=True: no step-local tensor of a wrapper is still held by
        # the stack when the next wrapper starts (_apply_wrappers)
        self.serialize = serialize
        self.gathers = 0  # cell views gathered from row shards by steps

    def _whole(self, grid) -> torch.Tensor:
        """The universe as one tensor: row shards (the spatial env mode,
        parallel/spatial_env.py) gathered onto the mesh's home device."""
        if isinstance(grid, torch.Tensor):
            return grid
        from ..parallel.mesh import gather_rows

        return gather_rows(grid)

    def universe(self, state: StackState, instance: Optional[int] = None) -> torch.Tensor:
        """uint8 [inst, H, W] universe of a stack state (or one instance's
        [H, W]; of row shards only that instance is gathered)."""
        g = state.env.grid
        if instance is None:
            return self._whole(g)
        if isinstance(g, torch.Tensor):
            return g[instance]
        return self._whole(g.take(instance))[0]

    def observe(self, state: StackState) -> torch.Tensor:
        """float32 [inst, 1, H, W] observation (the agent's input)."""
        return self._whole(state.env.grid).to(torch.float32)[:, None]

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
        wrapper (or the caller) reads them.  A universe of row shards steps
        on its shards (parallel/spatial_env.py)."""
        prev_grid = state.env.grid
        # the RAW action goes to env_step: it binarises for the toggle, but
        # the master reset reads the mean of the values
        env_state, grid = env_step(state.env, action, self.config)
        action_bits = (action != 0).to(torch.uint8)
        shards = batch = None
        if isinstance(grid, torch.Tensor):
            prev, obs_cells = prev_grid, grid[:, None]
            obs = Lazy(lambda: grid.to(torch.float32)[:, None])
        else:   # row shards: the cell views gathered on their first read
            from ..parallel.mesh import local_batch
            from ..parallel.spatial_env import gathered_views

            prev, obs_cells, obs = gathered_views(self, prev_grid, grid)
            shards = Lazy(lambda: grid.map(lambda p: p[:, None]))
            batch = local_batch(grid)
        ctx = StepCtx(
            prev_grid=prev,
            obs=obs,
            obs_cells=obs_cells,
            action=action_bits,
            action_full=Lazy(lambda: pad_action(action_bits, self.config)),
            action_sum=Lazy(lambda: action.to(torch.float32).sum(dim=(1, 2))[:, None]),
            seed=int(seed),
            generator=generator,
            obs_shards=shards,
            batch=batch,
        )
        new_state, reward = self._apply_wrappers(state.wrappers, env_state, ctx, grid.device)
        return new_state, ctx, reward

    def _apply_wrappers(self, wstates: Tuple[Any, ...], env_state: Any, ctx: StepCtx,
                        device) -> Tuple[StackState, torch.Tensor]:
        """Each wrapper's apply in order, the reward starting at zero (over the
        step's instances: this process's on a mesh spanning processes).

        With ``serialize`` each wrapper after the first gets the context as
        given (:meth:`StepCtx.released`), so the views that the previous
        wrapper computed (the float observation, the unpacked or gathered
        cells, the padded action) are no longer held by the stack while it
        runs: it computes again what it reads.  The JAX package puts an
        optimization barrier there for the same end; eager PyTorch runs the
        wrappers in turn already, and a wrapper's own intermediates die when
        its apply returns.  The results are the same bits."""
        reward = torch.zeros((ctx.action.shape[0], 1), dtype=torch.float32, device=device)
        new_wstates = []
        for i, (w, ws) in enumerate(zip(self.wrappers, wstates)):
            if self.serialize and i:
                ctx = ctx.released()
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
        ``generator`` draws the hooks' noise.  Row shards are reset on the
        mesh's home device (resets are rare) and resharded."""
        env = state.env
        grid = torch.zeros(tuple(env.grid.shape), dtype=torch.uint8, device=env.grid.device)
        new_wstates = []
        for w, ws in zip(self.wrappers, state.wrappers):
            ws, grid = w.on_reset(ws, grid, generator)
            new_wstates.append(ws)
        kept = grid
        if not isinstance(env.grid, torch.Tensor):
            from ..parallel.mesh import shard_rows

            kept = shard_rows(grid, env.grid.mesh, env.grid.axis, env.grid.env_axis)
        env_state = EnvState(kept, env.rule_bits, torch.zeros_like(env.step_num),
                             torch.zeros_like(env.steps_since_action))
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
        return self._step(action)

    def _step(self, action: Any):
        """The step on the shell's device, through the inner envs' own
        ``_step`` (a subclass may change what ``step`` returns: the compat
        facade's host tensors)."""
        prev_grid = self.inner_env.state.grid
        obs, reward, done, info = self.env._step(action)
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

    def state_dict(self) -> Any:
        """The reference's ``state_dict`` of this wrapper stack: CPU tensors,
        the reference's key layout and nesting, loadable into the matching
        reference class with ``strict=True`` (mcl/export.py)."""
        from .export import to_state_dict

        return to_state_dict(self)
