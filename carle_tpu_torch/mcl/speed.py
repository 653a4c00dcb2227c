"""SpeedDetector — rewards moving patterns via centre-of-mass velocity
(counterpart of carle_tpu/mcl/speed.py:54-95).

As the JAX package: row/column weights exclude the centred action window;
the live-cell denominator is not masked; the first step only records the
centre of mass; afterwards ``speed = sqrt(sum(velocity**2))`` over the
[2, instances] velocity, a batch-global scalar added to every instance
(``per_instance=True``: one speed per instance).  The bonus is added
without ``reward_scale``, as in the JAX package and the reference.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..config import EnvConfig
from .base import StepCtx, WrapperDef, default_on_reset


class SpeedState(NamedTuple):
    reward_scale: torch.Tensor    # float32 scalar (kept, unused in the step)
    center_of_mass: torch.Tensor  # float32 [2, instances]
    has_com: torch.Tensor         # bool scalar
    weight_h: torch.Tensor        # float32 [H, W] masked row-index weights
    weight_w: torch.Tensor        # float32 [H, W] masked column-index weights


def _masked_weights(config: EnvConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    h, w = config.height, config.width
    weight_w = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    weight_h = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    mask = torch.ones((h, w), dtype=torch.float32, device=device)
    r0, c0 = config.action_row_offset, config.action_col_offset
    mask[r0:r0 + config.eff_action_height, c0:c0 + config.eff_action_width] = 0.0
    return weight_h * mask, weight_w * mask


def speed_def(config: EnvConfig, reward_scale: float = 1.0,
              per_instance: bool = False) -> WrapperDef:
    def init(generator: Any, device) -> SpeedState:
        wh, ww = _masked_weights(config, device)
        return SpeedState(
            reward_scale=torch.as_tensor(reward_scale, dtype=torch.float32,
                                         device=device),
            center_of_mass=torch.zeros((2, config.instances),
                                       dtype=torch.float32, device=device),
            has_com=torch.zeros((), dtype=torch.bool, device=device),
            weight_h=wh,
            weight_w=ww,
        )

    def apply(state: SpeedState, ctx: StepCtx,
              reward: torch.Tensor) -> Tuple[SpeedState, torch.Tensor]:
        live = ctx.obs.sum(dim=(1, 2, 3))  # unmasked denominator
        com_h = (ctx.obs * state.weight_h).sum(dim=(1, 2, 3)) / (live + 1e-7)
        com_w = (ctx.obs * state.weight_w).sum(dim=(1, 2, 3)) / (live + 1e-7)
        com = torch.stack([com_h, com_w])  # [2, instances]
        velocity = state.center_of_mass - com
        if per_instance:
            speed = torch.sqrt((velocity ** 2).sum(dim=0))[:, None]
        else:
            speed = torch.sqrt((velocity ** 2).sum())
        new_reward = torch.where(state.has_com, reward + speed, reward)
        return state._replace(center_of_mass=com,
                              has_com=torch.ones_like(state.has_com)), new_reward

    return WrapperDef(name="SpeedDetector", init=init, apply=apply,
                      on_reset=default_on_reset)
