"""SpeedDetector — rewards moving patterns via centre-of-mass velocity
(counterpart of carle_tpu/mcl/speed.py).

As the JAX package: row/column weights exclude the centred action window;
the live-cell denominator is not masked; the first step only records the
centre of mass; afterwards ``speed = sqrt(sum(velocity**2))`` over the
[2, instances] velocity, a batch-global scalar added to every instance
(``per_instance=True``: one speed per instance).  The bonus is added
without ``reward_scale``, as in the JAX package and the reference.
:class:`SpeedDetector` is the class shell (batch-global speed).  On a mesh
spanning processes (``ctx.batch``) each process computes its instances'
centres of mass and one ``all_reduce`` puts the whole batch's on every
process (:func:`speed_bonus`), so the velocity sum runs over every
instance before the square root and the state stays the same everywhere.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..config import EnvConfig
from .base import Motivator, StepCtx, WrapperDef, default_on_reset


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


def speed_bonus(prev_com: torch.Tensor, com: torch.Tensor, ctx: StepCtx,
                per_instance: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(speed, the centre of mass to carry) from the carried [2, instances]
    centre of mass and this step's (over the step's instances): a scalar,
    or [inst, 1] with ``per_instance``; across processes the whole batch's
    centres of mass first (module note)."""
    batch = getattr(ctx, "batch", None)
    if batch is not None:
        from ..parallel.distributed import batch_gather

        com = batch_gather(com, batch, dim=1)
    velocity = prev_com - com
    if per_instance:
        speed = torch.sqrt((velocity ** 2).sum(dim=0))[:, None]
        if batch is not None:
            speed = speed[batch.lo:batch.hi]
    else:
        speed = torch.sqrt((velocity ** 2).sum())
    return speed, com


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
        speed, com = speed_bonus(state.center_of_mass, com, ctx, per_instance)
        new_reward = torch.where(state.has_com, reward + speed, reward)
        return state._replace(center_of_mass=com,
                              has_com=torch.ones_like(state.has_com)), new_reward

    return WrapperDef(name="SpeedDetector", init=init, apply=apply,
                      on_reset=default_on_reset)


class SpeedDetector(Motivator):
    my_name = "SpeedDetector"

    def __init__(self, env: Any, **kwargs: Any) -> None:
        super().__init__(env, **kwargs)
        self.speed_modulator = 32.0  # declared but unused in the reference

    def _make_def(self, **kwargs: Any) -> WrapperDef:
        return speed_def(self._config, **kwargs)
