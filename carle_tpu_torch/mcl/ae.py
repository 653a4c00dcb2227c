"""AE2D — autoencoder reconstruction bonus (counterpart of
carle_tpu/mcl/ae.py, its whole-AE branch).

  Conv2d(1,4,3,p1) Drop ReLU Pool Conv2d(4,2,3,p1) Drop ReLU Pool
  ConvT(2,1,4,p1,s2) Drop ReLU ConvT(1,1,4,p1,s2) Drop Sigmoid

The whole autoencoder, its dropout and its squared error run as one
``ae_loss_fwd`` kernel on the card (pools (2, 2)) and all eight parameter
gradients as ``ae_loss_bwd``; the bonus is the per-instance mean over C, H, W.
Same online-learning loop as RND2D (mcl/_online.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import nets
from ..config import EnvConfig
from ._online import (REFERENCE_EFFECTIVE_LR, LearnerState, init_learner,
                      learner_apply, net_input)
from .base import WrapperDef, default_on_reset
from .rnd import RND2D

POOLS = (2, 2)
DROP_P = 0.1


def init_ae_params(generator: torch.Generator, device=None) -> Dict[str, Any]:
    return {
        "conv1": nets.conv_init(4, 1, 3, generator, device),
        "conv2": nets.conv_init(2, 4, 3, generator, device),
        "deconv1": nets.conv_transpose_init(2, 1, 4, generator, device),
        "deconv2": nets.conv_transpose_init(1, 1, 4, generator, device),
    }


def ae2d_def(config: EnvConfig, reward_scale: float = 1.0, batch_size: int = 64,
             lr: Optional[float] = None, train: bool = True,
             dropout: Optional[bool] = None) -> WrapperDef:
    """The AE2D wrapper; ``dropout`` defaults to ``train`` (see rnd2d_def)."""
    use_dropout = train if dropout is None else dropout
    n_elem = config.height * config.width  # C * H * W with C = 1

    def init(generator: torch.Generator, device) -> LearnerState:
        return init_learner(reward_scale, init_ae_params(generator, device),
                            {}, device, batch_size)

    def loss_fn(params, state: LearnerState, ctx):
        obs = net_input(ctx)
        # odd seeds for this net's kernels, even for RND2D's
        err = nets.conv_ae_loss(obs, params["conv1"], params["conv2"],
                                params["deconv1"], params["deconv2"], obs,
                                pools=POOLS, drop_p=DROP_P, train=use_dropout,
                                seed=2 * ctx.seed + 1)
        return err / n_elem, state.extra

    def bonus_fn(per_inst, ctx):
        return per_inst[:, None]

    return WrapperDef(
        name="AE2D", init=init,
        apply=learner_apply(loss_fn, bonus_fn,
                            REFERENCE_EFFECTIVE_LR if lr is None else lr, train),
        on_reset=default_on_reset)


class AE2D(RND2D):
    my_name = "AE2D"
    learning_rate = REFERENCE_EFFECTIVE_LR

    def _def_factory(self):
        return ae2d_def
