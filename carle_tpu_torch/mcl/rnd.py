"""RND2D — random-network-distillation bonus at inference (counterpart of
carle_tpu/mcl/rnd.py:40-163).

A frozen random CNN maps the observation to a 16-dim embedding; a predictor
chases it; the per-instance mean squared embedding error is the bonus.

  predictor:  Conv2d(1,4,3,p1) ReLU Pool Pool Conv2d(4,1,3,p1) ReLU Pool
              Flatten Linear(HW/64,16) Tanh
  random_net: Conv2d(1,2,3,p1) ReLU Pool Pool Conv2d(2,1,3,p1) ReLU Pool
              Flatten Linear(HW/64,16) Tanh

Both conv stages of each net run as one ``encoder_fwd`` kernel on the card
(pools (4, 2)); the dense layer and tanh stay plain PyTorch, as the JAX
package leaves them to XLA.  Dropout is off at inference.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .. import nets
from ..config import EnvConfig
from ._online import LearnerState, init_learner, learner_apply, net_input
from .base import WrapperDef, default_on_reset

RND_DIM = 16
POOLS = (4, 2)


def init_predictor_params(config: EnvConfig, generator: torch.Generator,
                          device=None) -> Dict[str, Any]:
    dense_nodes = (config.width // 8) * (config.height // 8)
    return {
        "conv1": nets.conv_init(4, 1, 3, generator, device),
        "conv2": nets.conv_init(1, 4, 3, generator, device),
        "dense": nets.linear_init(RND_DIM, dense_nodes, generator, device),
    }


def init_random_network_params(config: EnvConfig, generator: torch.Generator,
                               device=None) -> Dict[str, Any]:
    dense_nodes = (config.width // 8) * (config.height // 8)
    return {
        "conv1": nets.conv_init(2, 1, 3, generator, device),
        "conv2": nets.conv_init(1, 2, 3, generator, device),
        "dense": nets.linear_init(RND_DIM, dense_nodes, generator, device),
    }


def embed(params: Dict[str, Any], obs: torch.Tensor) -> torch.Tensor:
    """Either net's forward: the fused encoder, then dense + tanh."""
    x = nets.conv_encoder(obs, params["conv1"], params["conv2"], pools=POOLS)
    return torch.tanh(nets.linear(nets.flatten(x), params["dense"]))


def rnd2d_def(config: EnvConfig, reward_scale: float = 1.0) -> WrapperDef:
    """The frozen RND2D wrapper (the JAX package's ``train=False``)."""

    def init(generator: torch.Generator, device) -> LearnerState:
        return init_learner(
            reward_scale,
            init_predictor_params(config, generator, device),
            init_random_network_params(config, generator, device), device)

    def loss_fn(params, state: LearnerState, ctx):
        obs = net_input(ctx)
        target = embed(state.target_params, obs)
        prediction = embed(params, obs)
        # mean over the embedding dim (reference mcl.py:350)
        return ((target - prediction) ** 2).mean(dim=1), state.extra

    def bonus_fn(per_inst, ctx):
        return per_inst[:, None]

    return WrapperDef(name="RND2D", init=init,
                      apply=learner_apply(loss_fn, bonus_fn),
                      on_reset=default_on_reset)
