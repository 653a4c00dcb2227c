"""PufferDetector — detects unbounded growth absent actions (counterpart of
carle_tpu/mcl/puffer.py).

A window of live-cell counts, appended on action-free steps and cleared by
any toggle; once the window is full, slope = incoming - evicted and the
reward gains 1 when slope > 0.01.  By default the count is the batch-global
universe sum and the +1 goes to every instance (``per_instance=True``: one
window per instance).  The window is a ring buffer in the state: ``buf``
holds the last ``window`` counts, ``head`` the oldest slot, ``count`` the
fill level.  The bonus is added without ``reward_scale``, as in the JAX
package and the reference.  :class:`PufferDetector` is the class shell
(batch-global window).  On a mesh spanning processes (``ctx.batch``) the
batch-global count and ``acted`` add the processes' instances by one
``all_reduce`` each.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..config import EnvConfig
from .base import Motivator, StepCtx, WrapperDef, default_on_reset

GROWTH_THRESHOLD = 512  # window length (reference mcl.py:823)


class PufferState(NamedTuple):
    reward_scale: torch.Tensor  # float32 scalar (kept, unused in the step)
    buf: torch.Tensor           # float32 [lanes, window] ring buffer of counts
    head: torch.Tensor          # int32 [lanes] oldest slot
    count: torch.Tensor         # int32 [lanes] fill level
    window: torch.Tensor        # int32 scalar: the window length

    # lanes are the instances with per_instance (parallel/mesh.py PER_INSTANCE)
    per_instance_fields = ("buf", "head", "count")


def puffer_def(config: EnvConfig, reward_scale: float = 1.0,
               per_instance: bool = False,
               cells_fn: Optional[Callable[[StepCtx], torch.Tensor]] = None,
               growth_threshold: Optional[int] = None) -> WrapperDef:
    """``cells_fn(ctx) -> float32 [instances]`` overrides how the live-cell
    count is taken (default: the sum of the float observation); the
    packed-native variant (mcl/packed_stats.py) passes popcounts, so the
    window, slope and toggle-clear semantics live in one place.
    ``growth_threshold`` is the window length (GROWTH_THRESHOLD by default)."""
    lanes = config.instances if per_instance else 1
    window = GROWTH_THRESHOLD if growth_threshold is None else int(growth_threshold)
    if cells_fn is None:
        cells_fn = lambda ctx: ctx.obs.sum(dim=(1, 2, 3))  # noqa: E731

    def init(generator: Any, device) -> PufferState:
        return PufferState(
            reward_scale=torch.as_tensor(reward_scale, dtype=torch.float32,
                                         device=device),
            buf=torch.zeros((lanes, window), dtype=torch.float32, device=device),
            head=torch.zeros((lanes,), dtype=torch.int32, device=device),
            count=torch.zeros((lanes,), dtype=torch.int32, device=device),
            window=torch.as_tensor(window, dtype=torch.int32, device=device),
        )

    def apply(state: PufferState, ctx: StepCtx,
              reward: torch.Tensor) -> Tuple[PufferState, torch.Tensor]:
        cells_vec = cells_fn(ctx)                                     # [inst]
        if per_instance:
            cells = cells_vec
            acted = ctx.action.sum(dim=(1, 2), dtype=torch.int32) != 0
        elif getattr(ctx, "batch", None) is not None:   # the whole batch's, over processes
            from ..parallel.distributed import batch_sum

            cells = batch_sum(cells_vec, ctx.batch)[None]
            acted = (batch_sum(ctx.action.sum(dim=(1, 2), dtype=torch.int32), ctx.batch)
                     != 0)[None]
        else:
            cells = cells_vec.sum()[None]                             # [1]
            acted = (ctx.action.sum(dtype=torch.int32) != 0)[None]    # [1]

        # list semantics: once the ring is full, slope = incoming - evicted
        full = state.count >= state.window
        head = state.head.to(torch.int64)
        oldest = state.buf.gather(1, head[:, None])[:, 0]
        slope = cells - oldest
        fire = full & (slope > 0.01) & ~acted

        write_idx = torch.where(full, head, state.count.to(torch.int64))
        new_buf = state.buf.scatter(1, write_idx[:, None], cells[:, None])
        new_head = torch.where(full, (state.head + 1) % state.window, state.head)
        new_count = torch.minimum(state.count + 1, state.window)

        # any toggle clears the window (reference mcl.py:846-848)
        new_buf = torch.where(acted[:, None], torch.zeros_like(new_buf), new_buf)
        new_head = torch.where(acted, torch.zeros_like(new_head), new_head)
        new_count = torch.where(acted, torch.zeros_like(new_count), new_count)

        bonus = fire.to(torch.float32)
        bonus = bonus[:, None] if per_instance else bonus[0]
        return (state._replace(buf=new_buf, head=new_head, count=new_count),
                reward + bonus)

    return WrapperDef(name="PufferDetector", init=init, apply=apply,
                      on_reset=default_on_reset)


class PufferDetector(Motivator):
    my_name = "PufferDetector"

    def __init__(self, env: Any, **kwargs: Any) -> None:
        super().__init__(env, **kwargs)
        self.growth_threshold = kwargs.get("growth_threshold", GROWTH_THRESHOLD)
        self.growing_steps = 0  # attribute parity with the reference

    def _make_def(self, **kwargs: Any) -> WrapperDef:
        return puffer_def(self._config, **kwargs)
