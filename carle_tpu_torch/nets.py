"""Neural-net primitives as plain functions over parameter dicts
(counterpart of carle_tpu/nets.py).

Weights keep torch's layouts, which are also the JAX package's: conv OIHW
``{"w": [O, I, k, k], "b": [O]}``, transpose conv ``[I, O, k, k]``, linear
``[out, in]``.  :func:`conv_encoder` and :func:`conv_ae_loss` are the fused
conv stages of the wrapper nets, differentiable in their parameters: forward
and backward launch the CUDA kernels for CUDA tensors and take the plain
twins for CPU tensors (ops/cuda_head.py).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .ops import cuda_head

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers (torch's defaults in distribution: U(-1/sqrt(fan_in), +))
# ---------------------------------------------------------------------------


def _uniform(shape: Sequence[int], bound: float, generator: torch.Generator,
             device) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return (2.0 * u - 1.0) * bound


def conv_init(out_ch: int, in_ch: int, k: int, generator: torch.Generator,
              device=None) -> Params:
    """Conv2d weight (OIHW) + bias."""
    bound = 1.0 / math.sqrt(in_ch * k * k)
    return {"w": _uniform((out_ch, in_ch, k, k), bound, generator, device),
            "b": _uniform((out_ch,), bound, generator, device)}


def conv_transpose_init(in_ch: int, out_ch: int, k: int,
                        generator: torch.Generator, device=None) -> Params:
    """ConvTranspose2d weight (in_ch, out_ch, k, k) + bias; torch takes
    fan_in from weight.size(1) * k * k."""
    bound = 1.0 / math.sqrt(out_ch * k * k)
    return {"w": _uniform((in_ch, out_ch, k, k), bound, generator, device),
            "b": _uniform((out_ch,), bound, generator, device)}


def linear_init(out_features: int, in_features: int,
                generator: torch.Generator, device=None) -> Params:
    """Linear weight (out, in) + bias."""
    bound = 1.0 / math.sqrt(in_features)
    return {"w": _uniform((out_features, in_features), bound, generator, device),
            "b": _uniform((out_features,), bound, generator, device)}


# ---------------------------------------------------------------------------
# layers (plain PyTorch)
# ---------------------------------------------------------------------------


def conv2d(x: torch.Tensor, p: Params, padding: int = 1) -> torch.Tensor:
    """2-D convolution, NCHW x OIHW, float32."""
    return F.conv2d(x.to(torch.float32), p["w"], p.get("b"), padding=padding)


def conv_transpose2d(x: torch.Tensor, p: Params, stride: int = 2,
                     padding: int = 1) -> torch.Tensor:
    """torch ConvTranspose2d: out = (in - 1) * stride - 2 * padding + k."""
    return F.conv_transpose2d(x, p["w"], p.get("b"), stride=stride,
                              padding=padding)


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.linear(x, p["w"], p.get("b"))


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, no padding."""
    return F.max_pool2d(x, 2)


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout matching ``nn.Dropout``: train scales kept units by
    1/(1-p); eval is the identity.  The mask comes from ``generator`` (on
    x's device), so nothing waits for the device."""
    if not train or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# fused conv stages
# ---------------------------------------------------------------------------


def conv_encoder(x: torch.Tensor, p1: Params, p2: Params, *,
                 pools: Tuple[int, int], drop_p: float = 0.0,
                 train: bool = False, seed: int = 0) -> torch.Tensor:
    """Both encoder stages ``pool(relu(drop(conv3x3)))`` x2: x is the uint8
    observation [N, 1, H, W]; returns float32 [N, C2, H/(p1 p2), W/(p1 p2)].
    Dropout runs only with ``train`` and ``drop_p > 0``, from ``seed`` (a host
    integer: the same seed gives the same mask, forward and backward);
    otherwise no random number is drawn."""
    p = drop_p if train else 0.0
    return cuda_head.encoder(x, p1["w"], p1["b"], p2["w"], p2["b"], pools, p,
                             seed if p > 0.0 else 0)


def conv_ae_loss(src: torch.Tensor, p1: Params, p2: Params, pd1: Params,
                 pd2: Params, obs: torch.Tensor, *, pools: Tuple[int, int],
                 drop_p: float = 0.0, train: bool = False,
                 seed: int = 0) -> torch.Tensor:
    """The whole autoencoder and its per-instance
    ``sum((obs - recon(src))**2)`` over C, H, W ([N] float32; the caller
    divides by C*H*W for the mean), differentiable in the eight parameters.
    Dropout as :func:`conv_encoder`."""
    p = drop_p if train else 0.0
    return cuda_head.ae_loss(src, p1["w"], p1["b"], p2["w"], p2["b"],
                             pd1["w"], pd1["b"], pd2["w"], pd2["b"], obs,
                             pools, p, seed if p > 0.0 else 0)


__all__ = ["Params", "conv_init", "conv_transpose_init", "linear_init",
           "conv2d", "conv_transpose2d", "linear", "max_pool2", "dropout",
           "flatten", "conv_encoder", "conv_ae_loss"]
