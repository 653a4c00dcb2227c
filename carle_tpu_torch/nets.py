"""Neural-net primitives as plain functions over parameter dicts
(counterpart of carle_tpu/nets.py).

Weights keep torch's layouts, which are also the JAX package's: conv OIHW
``{"w": [O, I, k, k], "b": [O]}``, transpose conv ``[I, O, k, k]``, linear
``[out, in]``.  :func:`conv_encoder`, :func:`conv_ae_loss`, :func:`conv_head`,
:func:`conv_tail`, :func:`conv_loss_tail` and :func:`conv_decoder_loss` are the
fused conv stages of the wrapper nets, differentiable in their parameters
(and, past the first layer, in their input): forward and backward launch the
CUDA kernels for CUDA tensors and take the plain twins for CPU tensors
(ops/cuda_head.py, ops/cuda_stages.py).  The device decides the route.

``mesh=`` takes the JAX package's routing tags.  :class:`BandTiling` runs
:func:`conv_encoder`, :func:`conv_decoder_loss` and :func:`conv_ae_loss` as
row bands of one universe, each band an instance of one launch
(parallel/band_heads.py); the single stages refuse it, as the JAX package's
do.  :class:`SpaceSharding` runs :func:`conv_encoder`, :func:`conv_tail`,
:func:`conv_loss_tail`, :func:`conv_decoder_loss` (as tail then loss tail)
and :func:`conv_ae_loss` (as encoder then decoder loss) on row-sharded
inputs and outputs (parallel/mesh.py's RowShards), slot by slot with halo
rows (parallel/spatial_heads.py); :func:`whole` gathers such an output.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .ops import cuda_head, cuda_stages
from .ops.cuda_head import STAGE_DEC1, STAGE_DEC2, STAGE_ENC1, STAGE_ENC2

Params = Dict[str, torch.Tensor]


class BandTiling(NamedTuple):
    """Single-device routing tag for the fused encoder and decoder loss at
    huge universes (counterpart of carle_tpu/nets.py::BandTiling): the
    observation's rows are cut into ``bands`` bands, each an instance of one
    kernel launch with its halo rows sliced from its neighbours and zero rows
    only at the universe's edges (parallel/band_heads.py).  Pass as the
    wrappers' ``fused_head`` or the nets' ``mesh=``.  Band against global is
    exact up to the dropout mask: each band draws its own, as an instance."""

    bands: int


class SpaceSharding(NamedTuple):
    """Routing tag for the fused kernels on a row-sharded observation
    (counterpart of carle_tpu/nets.py::SpaceSharding): the input's rows are
    sharded over ``axis`` of ``mesh`` (a parallel.mesh.Mesh; the packed
    stack with a mesh), and the kernels run slot by slot with halo rows
    (parallel/spatial_heads.py).  Pass as the wrappers' ``fused_head`` or the
    nets' ``mesh=``.  ``env_axis`` (a 2-D env x space mesh) is not ported
    yet."""

    mesh: Any
    axis: str = "space"
    env_axis: Optional[str] = None


def check_mesh(mesh: Any) -> Any:
    """The routing tag a net function runs with: None, a :class:`BandTiling`
    or a :class:`SpaceSharding`; any other value raises ValueError (and a
    SpaceSharding with an env axis NotImplementedError)."""
    if isinstance(mesh, SpaceSharding):
        from .parallel.mesh import Mesh

        if not isinstance(mesh.mesh, Mesh):
            raise ValueError(f"SpaceSharding needs a parallel.mesh.Mesh, got {mesh.mesh!r}")
        if mesh.env_axis is not None:
            raise NotImplementedError("SpaceSharding's env_axis (the 2-D env x space "
                                      "mesh) is not ported yet")
        return mesh
    if mesh is not None and not isinstance(mesh, BandTiling):
        raise ValueError(f"mesh must be None, BandTiling or SpaceSharding, got {mesh!r}")
    return mesh


def fused_route(fused_head: Any) -> Any:
    """The ``mesh=`` of a wrapper's ``fused_head`` argument (the JAX
    package's name and spelling): True, False or None give None, the fused
    kernels on one device (the port has no unfused path to select); a
    :class:`BandTiling` its row bands; a :class:`SpaceSharding` the
    row-sharded route; anything else raises as :func:`check_mesh`."""
    if fused_head is None or isinstance(fused_head, bool):
        return None
    return check_mesh(fused_head)


def whole(x: Any) -> Any:
    """A net output as one tensor: row shards (a SpaceSharding route's
    output) gathered onto their mesh's home device, as GSPMD gathers a
    sharded array for an unsharded consumer; any tensor as it is."""
    from .parallel.mesh import RowShards, gather_rows

    return gather_rows(x) if isinstance(x, RowShards) else x


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


def _drop_args(drop_p: float, train: bool, seed: Optional[int]) -> Tuple[float, int]:
    """(probability, seed) the kernels get: dropout runs only with ``train``
    and ``drop_p > 0``, and then needs a seed (a silent fixed one would repeat
    every step's mask)."""
    p = drop_p if train else 0.0
    if p > 0.0 and seed is None:
        raise ValueError("train=True with drop_p > 0 requires a seed")
    return p, (int(seed) if p > 0.0 else 0)


def conv_encoder(x: torch.Tensor, p1: Params, p2: Params, *,
                 pools: Tuple[int, int], drop_p: float = 0.0,
                 train: bool = False, seed: Optional[int] = 0,
                 mesh: Any = None) -> torch.Tensor:
    """Both encoder stages ``pool(relu(drop(conv3x3)))`` x2: x is the uint8
    observation [N, 1, H, W] (or its packed words); returns float32
    [N, C2, H/(p1 p2), W/(p1 p2)].  Dropout runs only with ``train`` and
    ``drop_p > 0``, from ``seed`` (a host integer: the same seed gives the
    same mask, forward and backward); otherwise no random number is drawn.
    ``mesh=BandTiling(n)`` runs it as n row bands; ``mesh=SpaceSharding``
    takes and gives row shards."""
    if isinstance(check_mesh(mesh), SpaceSharding):
        from .parallel.spatial_heads import encoder_spatial

        return encoder_spatial(x, p1, p2, pools=pools, drop_p=drop_p, train=train, seed=seed,
                               sharding=mesh)
    if mesh is not None:
        from .parallel.band_heads import encoder_banded

        return encoder_banded(x, p1, p2, pools=pools, drop_p=drop_p, train=train,
                              seed=seed, tiling=mesh)
    p, seed = _drop_args(drop_p, train, seed)
    return cuda_head.encoder(x, p1["w"], p1["b"], p2["w"], p2["b"], pools, p, seed)


def whole_ae_route(src: torch.Tensor, p1: Params, p2: Params, pd1: Params,
                   pd2: Params) -> bool:
    """Whether :func:`conv_ae_loss` runs as the one whole-autoencoder kernel
    (else encoder + decoder loss): from the shapes alone, so forward and
    backward, card and CPU take one route."""
    n, _, h, w = cuda_head.cell_shape(src)
    return n <= 65535 and cuda_head.whole_ae_fits(
        h, w, p1["w"].shape[0], p2["w"].shape[0], pd1["w"].shape[1], pd2["w"].shape[1])


def conv_ae_loss(src: torch.Tensor, p1: Params, p2: Params, pd1: Params,
                 pd2: Params, obs: torch.Tensor, *, pools: Tuple[int, int],
                 drop_p: float = 0.0, train: bool = False,
                 seed: Optional[int] = 0, mesh: Any = None) -> torch.Tensor:
    """The whole autoencoder and its per-instance
    ``sum((obs - recon(src))**2)`` over C, H, W ([N] float32; the caller
    divides by C*H*W for the mean), differentiable in the eight parameters.
    Dropout as :func:`conv_encoder`.  One kernel where its shared-memory
    plans fit (:func:`whole_ae_route`); elsewhere :func:`conv_encoder` then
    :func:`conv_decoder_loss` with the same seed (the embedding crosses
    device memory), as carle_tpu/nets.py::conv_ae_loss past its kernel's
    VMEM limit: the same function and dropout mask.  ``mesh=BandTiling(n)``
    runs both as n row bands; ``mesh=SpaceSharding`` runs the encoder and the
    decoder loss on row shards, as carle_tpu/nets.py::conv_ae_loss does."""
    if isinstance(check_mesh(mesh), SpaceSharding):
        kw = dict(drop_p=drop_p, train=train, seed=seed, mesh=mesh)
        x = conv_encoder(src, p1, p2, pools=pools, **kw)
        return conv_decoder_loss(x, pd1, pd2, obs, **kw)
    if mesh is not None:
        from .parallel.band_heads import ae_loss_banded

        return ae_loss_banded(src, p1, p2, pd1, pd2, obs, pools=pools, drop_p=drop_p,
                              train=train, seed=seed, tiling=mesh)
    if tuple(pools) == (2, 2) and not whole_ae_route(src, p1, p2, pd1, pd2):
        kw = dict(drop_p=drop_p, train=train, seed=seed)
        x = conv_encoder(src, p1, p2, pools=pools, **kw)
        return conv_decoder_loss(x, pd1, pd2, obs, **kw)
    p, seed = _drop_args(drop_p, train, seed)
    return cuda_head.ae_loss(src, p1["w"], p1["b"], p2["w"], p2["b"],
                             pd1["w"], pd1["b"], pd2["w"], pd2["b"], obs, pools, p, seed)


def conv_head(x: torch.Tensor, p: Params, *, pool: int, drop_p: float = 0.0,
              train: bool = False, need_dx: bool = False, seed: Optional[int] = None,
              stage: int = STAGE_ENC1, mesh: Any = None) -> torch.Tensor:
    """One conv stage ``pool(relu(drop(conv3x3(x))))``: x [N, C, H, W] float32
    (or the uint8 observation) -> [N, O, H/pool, W/pool].  The backward gives
    the parameter gradients and, with ``need_dx`` (deeper stages), the input
    cotangent; max-pool ties share the gradient equally.  ``stage`` is the
    dropout stage whose Philox bits the kernel draws (0 a net's first
    convolution, 1 its second)."""
    if pool < 2 or pool & (pool - 1):
        raise ValueError(f"pool must be a power of two >= 2, got {pool}")
    if isinstance(check_mesh(mesh), SpaceSharding):
        raise ValueError("SpaceSharding routes the two-stage encoder (conv_encoder); "
                         "a single conv stage has no row-sharded route")
    if mesh is not None:
        raise ValueError(
            "BandTiling applies to the two-stage paths (conv_encoder, "
            "conv_decoder_loss, conv_ae_loss); single-stage heads have no "
            "banded variant"
        )
    prob, seed = _drop_args(drop_p, train, seed)
    return cuda_stages.head(x, p["w"], p["b"], pool, prob, seed, stage, need_dx)


def conv_tail(x: torch.Tensor, p: Params, *, act: str, drop_p: float = 0.0,
              train: bool = False, seed: Optional[int] = None,
              stage: int = STAGE_DEC1, mesh: Any = None) -> torch.Tensor:
    """The decoder stage ``act(drop(conv_transpose2d(x)))`` (stride 2, k 4,
    pad 1), act "relu" or "sigmoid", differentiable in x and its parameters.
    ``stage`` as :func:`conv_head` (2 the decoder's first stage, 3 its
    second).  ``mesh=SpaceSharding`` takes and gives row shards."""
    if isinstance(check_mesh(mesh), SpaceSharding):
        from .parallel.spatial_heads import tail_spatial

        return tail_spatial(x, p, act=act, drop_p=drop_p, train=train, seed=seed, stage=stage,
                            sharding=mesh)
    if mesh is not None:
        raise ValueError(
            "BandTiling serves the training losses (conv_encoder, "
            "conv_decoder_loss, conv_ae_loss) — a banded conv_tail would "
            "materialise the full-resolution activation it exists to avoid"
        )
    prob, seed = _drop_args(drop_p, train, seed)
    return cuda_stages.tail(x, p["w"], p["b"], act, prob, seed, stage)


def conv_loss_tail(x: torch.Tensor, p: Params, obs: torch.Tensor, *, act: str,
                   drop_p: float = 0.0, train: bool = False, seed: Optional[int] = None,
                   stage: int = STAGE_DEC2, mesh: Any = None) -> torch.Tensor:
    """:func:`conv_tail` fused with the error: per-instance
    ``sum((obs - act(drop(conv_transpose2d(x))))**2)`` over C, H, W ([N]
    float32; the caller divides by C*H*W for the mean) without the
    full-resolution reconstruction in device memory.  obs is uint8 or float32
    and gets no gradient.  ``mesh=SpaceSharding`` takes row-sharded x and obs
    and adds the slots' errors."""
    if isinstance(check_mesh(mesh), SpaceSharding):
        from .parallel.spatial_heads import loss_tail_spatial

        return loss_tail_spatial(x, p, obs, act=act, drop_p=drop_p, train=train, seed=seed,
                                 stage=stage, sharding=mesh)
    if mesh is not None:
        raise ValueError(
            "BandTiling routes through conv_decoder_loss / conv_ae_loss "
            "(the banded error reduction needs the two-stage row-weighted "
            "kernel), not the single-stage loss tail"
        )
    prob, seed = _drop_args(drop_p, train, seed)
    return cuda_stages.loss_tail(x, p["w"], p["b"], obs, act, prob, seed, stage)


def conv_decoder_loss(x: torch.Tensor, p1: Params, p2: Params, obs: torch.Tensor, *,
                      drop_p: float = 0.0, train: bool = False,
                      seed: Optional[int] = None, mesh: Any = None) -> torch.Tensor:
    """Both decoder stages (relu, then sigmoid) fused with the error: [N]
    float32 sums over C, H, W; neither the middle activation nor the
    reconstruction reaches device memory.  Differentiable in the embedding x
    and the four parameters.  ``mesh=BandTiling(n)`` runs it as n row bands
    whose row-weighted errors add up to this one; ``mesh=SpaceSharding`` runs
    the two stages as halo'd tails on row shards (the tail, then the loss
    tail's error summed plainly), as carle_tpu/nets.py::conv_decoder_loss
    does."""
    if isinstance(check_mesh(mesh), SpaceSharding):
        kw = dict(drop_p=drop_p, train=train, seed=seed, mesh=mesh)
        a = conv_tail(x, p1, act="relu", stage=STAGE_DEC1, **kw)
        return conv_loss_tail(a, p2, obs, act="sigmoid", stage=STAGE_DEC2, **kw)
    if mesh is not None:
        from .parallel.band_heads import decoder_loss_banded

        return decoder_loss_banded(x, p1, p2, obs, drop_p=drop_p, train=train, seed=seed,
                                   tiling=mesh)
    prob, seed = _drop_args(drop_p, train, seed)
    return cuda_stages.decoder_loss(x, p1["w"], p1["b"], p2["w"], p2["b"], obs, prob, seed)


def ae_loss_by_stages(params: Dict[str, Params], src: torch.Tensor, obs: torch.Tensor, *,
                      drop_p: float = 0.0, train: bool = False,
                      seed: Optional[int] = None) -> torch.Tensor:
    """The autoencoder's error stage by stage, four kernels: head, head with
    the input cotangent, tail, loss tail (pools 2 and 2).  The same function
    as :func:`conv_ae_loss` and, with one seed, the same dropout mask."""
    kw = dict(drop_p=drop_p, train=train, seed=seed)
    x = conv_head(src, params["conv1"], pool=2, stage=STAGE_ENC1, **kw)
    x = conv_head(x, params["conv2"], pool=2, need_dx=True, stage=STAGE_ENC2, **kw)
    x = conv_tail(x, params["deconv1"], act="relu", stage=STAGE_DEC1, **kw)
    return conv_loss_tail(x, params["deconv2"], obs, act="sigmoid", stage=STAGE_DEC2, **kw)


__all__ = ["Params", "BandTiling", "SpaceSharding", "check_mesh", "fused_route", "whole",
           "whole_ae_route",
           "conv_init", "conv_transpose_init", "linear_init",
           "conv2d", "conv_transpose2d", "linear", "max_pool2", "dropout",
           "flatten", "conv_encoder", "conv_ae_loss", "conv_head", "conv_tail",
           "conv_loss_tail", "conv_decoder_loss", "ae_loss_by_stages"]
