"""RND2D — random-network-distillation exploration bonus (counterpart of
carle_tpu/mcl/rnd.py).

A frozen random CNN maps the observation to a 16-dim embedding; a trainable
predictor chases it.  The per-instance mean squared embedding error is the
bonus, and the predictor trains online inside the step: per-step gradient,
64-step accumulation, Adam on the mean gradient (mcl/_online.py).

  predictor:  Conv2d(1,4,3,p1) Drop ReLU Pool Pool Conv2d(4,1,3,p1) Drop ReLU
              Pool Drop Flatten Linear(HW/64,16) Tanh
  random_net: Conv2d(1,2,3,p1) ReLU Pool Pool Conv2d(2,1,3,p1) ReLU Pool
              Flatten Linear(HW/64,16) Tanh

Both conv stages of each net, dropout included, run as one ``encoder_fwd``
kernel on the card (pools (4, 2)) and the predictor's gradient as
``encoder_bwd``; the third dropout, the dense layer, tanh, the error and
their gradients stay plain PyTorch, as the JAX package leaves them to XLA.
The frozen target never builds a graph.  ``fused_head=nets.BandTiling(n)``
runs both encoders as n row bands of each universe (parallel/band_heads.py);
``fused_head=nets.SpaceSharding(mesh)`` runs them slot by slot on a
row-sharded stack (parallel/spatial_heads.py) and gathers the embeddings for
the dense layer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import nets
from ..config import EnvConfig
from ._online import (REFERENCE_EFFECTIVE_LR, LearnerState, init_learner,
                      learner_apply, net_input)
from .base import Motivator, WrapperDef, default_on_reset

RND_DIM = 16
POOLS = (4, 2)
DROP_P = 0.1


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


def predictor_forward(params: Dict[str, Any], obs: torch.Tensor, seed: int,
                      generator: Optional[torch.Generator],
                      train: bool, fused_head: Any = False) -> torch.Tensor:
    """The predictor: the fused encoder (both dropouts in the kernel, from
    ``seed``), the third dropout (from ``generator``), dense + tanh."""
    x = nets.conv_encoder(obs, params["conv1"], params["conv2"], pools=POOLS,
                          drop_p=DROP_P, train=train, seed=seed,
                          mesh=nets.fused_route(fused_head))
    x = nets.dropout(nets.whole(x), DROP_P, train, generator)
    return torch.tanh(nets.linear(nets.flatten(x), params["dense"]))


def random_forward(params: Dict[str, Any], obs: torch.Tensor,
                   fused_head: Any = False) -> torch.Tensor:
    """The frozen target: forward only, no dropout, no graph."""
    with torch.no_grad():
        x = nets.conv_encoder(obs, params["conv1"], params["conv2"], pools=POOLS,
                              mesh=nets.fused_route(fused_head))
        return torch.tanh(nets.linear(nets.flatten(nets.whole(x)), params["dense"]))


def rnd2d_def(config: EnvConfig, reward_scale: float = 1.0, batch_size: int = 64,
              lr: Optional[float] = None, train: bool = True,
              dropout: Optional[bool] = None, fused_head: Any = False) -> WrapperDef:
    """The RND2D wrapper.  ``dropout`` defaults to ``train``; pass
    ``dropout=False`` with ``train=True`` for the reference's "module.eval()
    but updates still firing" configuration (eval() only disables dropout
    there).  ``fused_head`` as :func:`nets.fused_route`."""
    use_dropout = train if dropout is None else dropout
    nets.fused_route(fused_head)  # refuse a tag the port cannot run, at build time

    def init(generator: torch.Generator, device) -> LearnerState:
        return init_learner(
            reward_scale,
            init_predictor_params(config, generator, device),
            init_random_network_params(config, generator, device), device,
            batch_size)

    def loss_fn(params, state: LearnerState, ctx):
        obs = net_input(ctx, fused_head)
        target = random_forward(state.target_params, obs, fused_head)
        # even seeds for this net's kernels, odd for AE2D's
        prediction = predictor_forward(params, obs, 2 * ctx.seed, ctx.generator,
                                       use_dropout, fused_head)
        # mean over the embedding dim; the target carries no gradient
        return ((target - prediction) ** 2).mean(dim=1), state.extra

    def bonus_fn(per_inst, ctx):
        return per_inst[:, None]

    return WrapperDef(
        name="RND2D", init=init,
        apply=learner_apply(loss_fn, bonus_fn,
                            REFERENCE_EFFECTIVE_LR if lr is None else lr, train),
        on_reset=default_on_reset)


class RND2D(Motivator):
    my_name = "RND2D"
    learning_rate = REFERENCE_EFFECTIVE_LR
    rnd_dim = RND_DIM

    def _make_def(self, **kwargs: Any) -> WrapperDef:
        self._def_kwargs = dict(kwargs)
        return self._def_factory()(self._config, train=self._train, **kwargs)

    def _def_factory(self):
        return rnd2d_def

    def _rebuild_mode(self) -> None:
        """Swap the apply between train (accumulate + update, dropout on) and
        eval (forward only), keeping the state."""
        new_def = self._def_factory()(self._config, train=self._train,
                                      **self._def_kwargs)
        self._wdef = self._wdef._replace(apply=new_def.apply)

    @property
    def updates(self) -> int:
        return int(self._wstate.updates)
