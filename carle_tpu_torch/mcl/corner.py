"""CornerBonus — static spatial shaping masks (counterpart of
carle_tpu/mcl/corner.py).

Reward mask: the 16 x 16 top-left square plus a diagonal band of 8 x 8
squares along (ii-4:ii+4, ii-4:ii+4) for ii in 4..95 (the reference loop runs
ii from 0, but Python slice semantics make ii < 4 a no-op: replicated by using
the same slicing).  Punish mask: -1 over the bottom-right and top-right
64 x 64 corners.  Bonus = scale * sum((reward_mask + punish_mask) * obs).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from ..config import EnvConfig
from .base import Motivator, StepCtx, WrapperDef, default_on_reset


def _build_masks(height: int, width: int) -> np.ndarray:
    reward_mask = np.zeros((height, width), dtype=np.float32)
    punish_mask = np.zeros((height, width), dtype=np.float32)

    reward_mask[:16, :16] = 1.0
    for ii in range(96):
        # the reference's slice arithmetic: negative starts for ii < 4 give
        # empty slices
        reward_mask[ii - 4: ii + 4, ii - 4: ii + 4] = 1.0

    punish_mask[-64:, -64:] = -1.0
    punish_mask[:64, -64:] = -1.0
    return reward_mask + punish_mask


class CornerState(NamedTuple):
    reward_scale: torch.Tensor  # float32 scalar
    mask: torch.Tensor          # float32 [H, W]


def corner_def(config: EnvConfig, reward_scale: float = 1.0, **kwargs: Any) -> WrapperDef:
    mask_np = _build_masks(config.height, config.width)

    def init(generator: Any, device) -> CornerState:
        return CornerState(
            reward_scale=torch.as_tensor(reward_scale, dtype=torch.float32, device=device),
            mask=torch.from_numpy(mask_np).to(device))

    def apply(state: CornerState, ctx: StepCtx,
              reward: torch.Tensor) -> Tuple[CornerState, torch.Tensor]:
        bonus = (state.mask[None, None] * ctx.obs).sum(dim=(2, 3))
        return state, reward + state.reward_scale * bonus

    return WrapperDef(name="CornerBonus", init=init, apply=apply,
                      on_reset=default_on_reset)


class CornerBonus(Motivator):
    my_name = "CornerBonus"

    def _make_def(self, **kwargs: Any) -> WrapperDef:
        return corner_def(self._config, **kwargs)
