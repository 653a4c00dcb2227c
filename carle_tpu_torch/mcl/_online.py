"""Learner state and the inference branch of the online learners
(counterpart of carle_tpu/mcl/_online.py:34-71, 111-181).

:class:`LearnerState` carries every slot of the JAX package's learner,
including Adam's ``mu``/``nu``/``count``, so a shipped ``.npz`` loads whole.
``opt_state`` is ``({"count", "mu", "nu"},)``, whose flattened keys
(``opt_state/0/mu/conv1/w``) are the JAX package's.  Only ``train=False``
(forward pass, no gradient or optimizer work: the reference's
``get_bonus_only``) is ported; the accumulate + Adam branch is not yet.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

# the reference's accumulation window; a state slot, unused at inference
BATCH_SIZE = 64


class LearnerState(NamedTuple):
    """Carried state of one online-learning wrapper."""

    reward_scale: torch.Tensor   # float32 scalar
    batch_size: torch.Tensor     # int32 scalar
    params: Any                  # predictor parameter dict
    target_params: Any           # frozen-net parameters ({} when none)
    opt_state: Any               # ({"count", "mu", "nu"},) Adam slots
    grad_accum: Any              # same structure as params
    buffer_length: torch.Tensor  # int32 scalar
    updates: torch.Tensor        # int32 scalar
    extra: Any                   # wrapper-specific carry


def _zeros_like(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def init_learner(reward_scale: float, params: Any, target_params: Any,
                 device: torch.device) -> LearnerState:
    scalar = torch.zeros((), dtype=torch.int32, device=device)
    return LearnerState(
        reward_scale=torch.as_tensor(reward_scale, dtype=torch.float32,
                                     device=device),
        batch_size=torch.as_tensor(BATCH_SIZE, dtype=torch.int32, device=device),
        params=params,
        target_params=target_params,
        opt_state=({"count": scalar.clone(), "mu": _zeros_like(params),
                    "nu": _zeros_like(params)},),
        grad_accum=_zeros_like(params),
        buffer_length=scalar.clone(),
        updates=scalar.clone(),
        extra=(),
    )


def net_input(ctx: Any) -> torch.Tensor:
    """The observation a wrapper net consumes: the uint8 cells, which the
    kernels read directly (the float32 copy never reaches them)."""
    return ctx.obs_cells


def learner_apply(
    loss_fn: Callable[[Any, LearnerState, Any], Tuple[torch.Tensor, Any]],
    bonus_fn: Callable[[torch.Tensor, Any], torch.Tensor],
):
    """Build a WrapperDef.apply for a frozen learner (``train=False``).
    ``loss_fn(params, state, ctx) -> (per_instance_loss [inst], new_extra)``;
    ``bonus_fn(loss, ctx) -> [inst, 1]``."""

    def apply(state: LearnerState, ctx: Any, reward: torch.Tensor):
        with torch.no_grad():
            per_inst, new_extra = loss_fn(state.params, state, ctx)
        state = state._replace(extra=new_extra)
        return state, reward + state.reward_scale * bonus_fn(per_inst, ctx)

    return apply
