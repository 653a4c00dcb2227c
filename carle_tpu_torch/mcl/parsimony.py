"""ParsimonyBonus — rescale reward by action frugality (counterpart of
carle_tpu/mcl/parsimony.py).

``reward *= 100 / max(sum(action), 100)`` per instance: a multiplicative
transform of whatever the inner wrappers produced.  The reference's
``parsimony_threshold = 128`` attribute is declared but never used; kept for
attribute parity only.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .base import Motivator, StepCtx, WrapperDef, default_on_reset


class ParsimonyState(NamedTuple):
    pass


def parsimony_def(**kwargs: Any) -> WrapperDef:
    def init(generator: Any, device) -> ParsimonyState:
        return ParsimonyState()

    def apply(state: ParsimonyState, ctx: StepCtx,
              reward: torch.Tensor) -> Tuple[ParsimonyState, torch.Tensor]:
        # the reference divides by the sum of the RAW action VALUES (an agent
        # toggling 200 cells with value 2.0 is scaled by 100/400, not
        # 100/200); ctx.action_sum carries that sum, with the binarised toggle
        # count as the fallback for a ctx made without it
        if ctx.action_sum is not None:
            toggles = ctx.action_sum
        else:
            toggles = ctx.action.to(torch.float32).sum(dim=(1, 2))[:, None]
        return state, 100.0 * reward / toggles.clamp_min(100.0)

    return WrapperDef(name="ParsimonyBonus", init=init, apply=apply,
                      on_reset=default_on_reset)


class ParsimonyBonus(Motivator):
    my_name = "ParsimonyBonus"

    def __init__(self, env: Any, **kwargs: Any) -> None:
        super().__init__(env, **kwargs)
        self.parsimony_threshold = 128  # declared but unused in the reference

    def _make_def(self, **kwargs: Any) -> WrapperDef:
        return parsimony_def(**kwargs)
