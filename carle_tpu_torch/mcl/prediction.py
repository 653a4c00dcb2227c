"""PredictionBonus / SurpriseBonus — forward-model bonuses (counterpart of
carle_tpu/mcl/prediction.py).

PredictionBonus rewards *predictability*: the AE-architecture predictor maps
the frame from ``prediction_steps`` (5) ago to the current frame through a
frame ring; bonus = ``0.1 - prediction_error``, zeroed for dead universes.
SurpriseBonus is the sign flip: bonus = +error, also zeroed for dead
universes.

The reference's Python-list ``grid_buffer`` (append, predict from
``buffer[0]``, pop when len > 5) is a fixed [inst, K, 1, H, W] ring in the
carried state, slot 0 the oldest frame, with the list's source-frame
semantics, the warm-up phase included (the source stays the first frame).
The ring's fill level is a device scalar and the update is index arithmetic
on it, so nothing waits for the device.

Ring storage (``buffer_dtype``): ``"uint8"`` (default; the frames are binary
cell planes, and the kernels read cells), ``"packed"`` ([inst, K, H, W/32]
uint32 words straight off a packed stack's ``ctx.packed``, 32x less carry;
the kernels read the source frame and the target as words, so no cell view
is built, and liveness comes from the words) or ``"float32"`` (the
reference-shaped carry, the same rewards).  The ring's layout is the JAX
package's, so ``FrameBuffer`` checkpoints cross both ways.

The loss is the whole autoencoder as one kernel (``nets.conv_ae_loss``) with
the ring frame as source and the current frame as target, and
``ae_loss_bwd`` for its gradients; ``fused_head=nets.BandTiling(n)`` runs it
as n row bands of each universe, and a ``parallel.mesh.Mesh`` a slot at a time
over the instances (the ring's frames split beside the current frame's
shards).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from .. import nets
from ..config import EnvConfig
from ._online import (REFERENCE_EFFECTIVE_LR, LearnerState, init_learner,
                      learner_apply, net_input)
from .ae import AE2D, DROP_P, POOLS, init_ae_params
from .base import WrapperDef, default_on_reset

# the dropout seed's stream: AE2D and RND2D use the low bit, these the top bits
SEED_STREAM_SHIFT = 58


class FrameBuffer(NamedTuple):
    frames: torch.Tensor  # [inst, K, 1, H, W] uint8 or float32, or [inst, K, H, W/32]
                          # uint32 words ("packed"); slot 0 the oldest
    count: torch.Tensor   # int32 scalar: frames held

    per_instance_fields = ("frames",)   # parallel/mesh.py PER_INSTANCE


def _push(buf: FrameBuffer, obs: torch.Tensor, k: int) -> Tuple[torch.Tensor, FrameBuffer]:
    """The reference's list semantics: the prediction source is ``buffer[0]``
    after appending (== obs while the buffer is empty); once the length
    exceeds K the oldest frame is dropped.  Branch-free on the device count:
    a full ring shifts down by one slot (a gather), and obs lands in slot
    ``min(count, K - 1)``.  Packed words move as int32 views (the same
    bits)."""
    if buf.frames.dtype == torch.uint32:
        src, new = _push(buf._replace(frames=buf.frames.view(torch.int32)),
                         obs.view(torch.int32), k)
        return src.view(torch.uint32), new._replace(frames=new.frames.view(torch.uint32))
    src = torch.where(buf.count == 0, obs, buf.frames[:, 0])
    slots = torch.arange(k, device=obs.device)
    full = (buf.count >= k).to(slots.dtype)
    shifted = buf.frames.index_select(1, (slots + full).clamp_max(k - 1))
    at = (slots == buf.count.clamp_max(k - 1)).view(1, k, *([1] * (buf.frames.ndim - 2)))
    frames = torch.where(at, obs[:, None], shifted)
    return src, FrameBuffer(frames=frames, count=(buf.count + 1).clamp_max(k))


def _alive(ctx) -> torch.Tensor:
    """Per-instance liveness from the packed words on a packed stack, else
    from the uint8 cells: the reference's ``mean(obs) > 0`` for binary
    frames."""
    if ctx.packed is not None:   # row shards gathered: the words are small
        return (nets.whole(ctx.packed).view(torch.int32) != 0).any(dim=2).any(dim=1)
    return (ctx.obs_cells != 0).any(dim=3).any(dim=2).any(dim=1)


def _make_def(config: EnvConfig, name: str, surprise: bool, reward_scale: float = 1.0,
              batch_size: int = 64, lr: Optional[float] = None,
              prediction_steps: int = 5, train: bool = True,
              dropout: Optional[bool] = None, buffer_dtype: str = "uint8",
              fused_head: Any = False) -> WrapperDef:
    use_dropout = train if dropout is None else dropout
    mesh = nets.fused_route(fused_head)
    k = prediction_steps
    if buffer_dtype not in ("uint8", "packed", "float32"):
        raise ValueError(f"buffer_dtype {buffer_dtype!r}: expected 'uint8', "
                         f"'packed' or 'float32'")
    if buffer_dtype == "packed" and config.width % 32:
        raise ValueError("the packed ring needs width % 32 == 0")
    n_elem = config.height * config.width  # C * H * W with C = 1
    stream = (2 if surprise else 1) << SEED_STREAM_SHIFT

    def init(generator: torch.Generator, device) -> LearnerState:
        if buffer_dtype == "packed":
            shape = (config.instances, k, config.height, config.width // 32)
            dtype = torch.uint32
        else:
            shape = (config.instances, k, 1, config.height, config.width)
            dtype = torch.uint8 if buffer_dtype == "uint8" else torch.float32
        buf = FrameBuffer(frames=torch.zeros(shape, dtype=dtype, device=device),
                          count=torch.zeros((), dtype=torch.int32, device=device))
        return init_learner(reward_scale, init_ae_params(generator, device), {},
                            device, batch_size)._replace(extra=buf)

    def store_view(ctx) -> torch.Tensor:
        """The frame as the ring stores it."""
        if buffer_dtype == "float32":
            return ctx.obs
        if buffer_dtype == "uint8":
            return ctx.obs_cells
        if ctx.packed is None:
            raise ValueError("buffer_dtype='packed' needs a packed stack "
                             "(parallel/packed_env.PackedSpatialStack): ctx.packed is "
                             "None on the uint8 path; use the uint8 ring there")
        return nets.whole(ctx.packed)

    def loss_fn(params, state: LearnerState, ctx):
        target = net_input(ctx, fused_head)
        src, new_buf = _push(state.extra, store_view(ctx), k)
        # the kernels read cells or words; a float32 ring holds the same 0/1 values
        src = src[:, None] if buffer_dtype == "packed" else src.to(torch.uint8)
        err = nets.conv_ae_loss(src, params["conv1"], params["conv2"],
                                params["deconv1"], params["deconv2"], target,
                                pools=POOLS, drop_p=DROP_P, train=use_dropout,
                                seed=stream + 2 * ctx.seed + 1, mesh=mesh)
        return err / n_elem, new_buf

    def bonus_fn(per_inst, ctx):
        raw = per_inst if surprise else (0.1 - per_inst)
        return torch.where(_alive(ctx), raw, torch.zeros_like(raw))[:, None]  # dead earn 0

    return WrapperDef(
        name=name, init=init,
        apply=learner_apply(loss_fn, bonus_fn,
                            REFERENCE_EFFECTIVE_LR if lr is None else lr, train),
        on_reset=default_on_reset)


def prediction_def(config: EnvConfig, **kwargs: Any) -> WrapperDef:
    return _make_def(config, "PredictionBonus", surprise=False, **kwargs)


def surprise_def(config: EnvConfig, **kwargs: Any) -> WrapperDef:
    return _make_def(config, "SurpriseBonus", surprise=True, **kwargs)


class PredictionBonus(AE2D):
    my_name = "PredictionBonus"

    def __init__(self, env: Any, **kwargs: Any) -> None:
        super().__init__(env, **kwargs)
        self.prediction_steps = kwargs.get("prediction_steps", 5)

    def _def_factory(self):
        return prediction_def


class SurpriseBonus(AE2D):
    my_name = "SurpriseBonus"

    def __init__(self, env: Any, **kwargs: Any) -> None:
        super().__init__(env, **kwargs)
        self.ca_steps = 3  # declared but unused in the reference

    def _def_factory(self):
        return surprise_def
