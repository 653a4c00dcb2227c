"""AE2D — autoencoder reconstruction bonus at inference (counterpart of
carle_tpu/mcl/ae.py:37-157).

  Conv2d(1,4,3,p1) ReLU Pool Conv2d(4,2,3,p1) ReLU Pool
  ConvT(2,1,4,p1,s2) ReLU ConvT(1,1,4,p1,s2) Sigmoid

The whole autoencoder and its squared error run as one ``ae_loss_fwd``
kernel on the card (pools (2, 2)); the bonus is the per-instance mean over
C, H, W (reference mcl.py:508).  Dropout is off at inference.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .. import nets
from ..config import EnvConfig
from ._online import LearnerState, init_learner, learner_apply, net_input
from .base import WrapperDef, default_on_reset

POOLS = (2, 2)


def init_ae_params(generator: torch.Generator, device=None) -> Dict[str, Any]:
    return {
        "conv1": nets.conv_init(4, 1, 3, generator, device),
        "conv2": nets.conv_init(2, 4, 3, generator, device),
        "deconv1": nets.conv_transpose_init(2, 1, 4, generator, device),
        "deconv2": nets.conv_transpose_init(1, 1, 4, generator, device),
    }


def ae2d_def(config: EnvConfig, reward_scale: float = 1.0) -> WrapperDef:
    """The frozen AE2D wrapper (the JAX package's ``train=False``)."""
    n_elem = config.height * config.width  # C * H * W with C = 1

    def init(generator: torch.Generator, device) -> LearnerState:
        return init_learner(reward_scale, init_ae_params(generator, device),
                            {}, device)

    def loss_fn(params, state: LearnerState, ctx):
        obs = net_input(ctx)
        err = nets.conv_ae_loss(obs, params["conv1"], params["conv2"],
                                params["deconv1"], params["deconv2"], obs,
                                pools=POOLS)
        return err / n_elem, state.extra

    def bonus_fn(per_inst, ctx):
        return per_inst[:, None]

    return WrapperDef(name="AE2D", init=init,
                      apply=learner_apply(loss_fn, bonus_fn),
                      on_reset=default_on_reset)
