"""AE2D — autoencoder reconstruction bonus (counterpart of
carle_tpu/mcl/ae.py, its fused branches).

  Conv2d(1,4,3,p1) Drop ReLU Pool Conv2d(4,2,3,p1) Drop ReLU Pool
  ConvT(2,1,4,p1,s2) Drop ReLU ConvT(1,1,4,p1,s2) Drop Sigmoid

By default the whole autoencoder, its dropout and its squared error run as
one ``ae_loss_fwd`` kernel on the card (pools (2, 2)) and all eight parameter
gradients as ``ae_loss_bwd``.  ``whole_ae=False`` is the two-kernel
composition: ``encoder_fwd`` then ``decoder_loss_fwd``, the embedding and its
cotangent crossing device memory between them.  The bonus is the per-instance
mean over C, H, W.  :func:`ae_forward` gives the reconstruction itself
(encoder and two ``tail_fwd`` stages).  Same online-learning loop as RND2D
(mcl/_online.py).  ``fused_head=nets.BandTiling(n)`` runs the loss as n row
bands of each universe (encoder and decoder loss, parallel/band_heads.py);
``fused_head=nets.SpaceSharding(mesh)`` runs encoder and decoder loss slot by
slot on a row-sharded stack (parallel/spatial_heads.py).
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


def ae_forward(params: Dict[str, Any], obs: torch.Tensor, train: bool = False,
               seed: Optional[int] = None, fused_head: Any = False) -> torch.Tensor:
    """The reconstruction [N, 1, H, W] of the uint8 observation: the fused
    encoder, then the two decoder stages.  Dropout (``train``) from ``seed``:
    the mask the whole-autoencoder kernel draws from the same seed.  A
    BandTiling raises, as the JAX package's conv_tail does: a banded
    reconstruction would be the full-resolution plane band tiling avoids."""
    mesh = nets.fused_route(fused_head)
    x = nets.conv_encoder(obs, params["conv1"], params["conv2"], pools=POOLS,
                          drop_p=DROP_P, train=train, seed=seed, mesh=mesh)
    x = nets.conv_tail(x, params["deconv1"], act="relu", drop_p=DROP_P, train=train,
                       seed=seed, stage=nets.STAGE_DEC1, mesh=mesh)
    return nets.conv_tail(x, params["deconv2"], act="sigmoid", drop_p=DROP_P,
                          train=train, seed=seed, stage=nets.STAGE_DEC2, mesh=mesh)


def ae2d_def(config: EnvConfig, reward_scale: float = 1.0, batch_size: int = 64,
             lr: Optional[float] = None, train: bool = True,
             dropout: Optional[bool] = None, whole_ae: bool = True,
             fused_head: Any = False) -> WrapperDef:
    """The AE2D wrapper; ``dropout`` defaults to ``train`` (see rnd2d_def).
    ``whole_ae=False`` takes the encoder and the decoder loss as two kernels
    instead of one (``nets.conv_ae_loss`` does so itself past the whole-AE
    kernel's shared memory); ``fused_head`` as :func:`nets.fused_route`."""
    use_dropout = train if dropout is None else dropout
    mesh = nets.fused_route(fused_head)
    n_elem = config.height * config.width  # C * H * W with C = 1

    def init(generator: torch.Generator, device) -> LearnerState:
        return init_learner(reward_scale, init_ae_params(generator, device),
                            {}, device, batch_size)

    def loss_fn(params, state: LearnerState, ctx):
        obs = net_input(ctx, fused_head)
        # odd seeds for this net's kernels, even for RND2D's
        kw = dict(drop_p=DROP_P, train=use_dropout, seed=2 * ctx.seed + 1, mesh=mesh)
        if whole_ae:
            err = nets.conv_ae_loss(obs, params["conv1"], params["conv2"],
                                    params["deconv1"], params["deconv2"], obs,
                                    pools=POOLS, **kw)
        else:
            x = nets.conv_encoder(obs, params["conv1"], params["conv2"], pools=POOLS, **kw)
            err = nets.conv_decoder_loss(x, params["deconv1"], params["deconv2"], obs, **kw)
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
