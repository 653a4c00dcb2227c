"""The wrapper nets' fused encoder and whole-autoencoder loss: forward and
backward CUDA kernels, in-kernel dropout, and their plain PyTorch twins
(counterpart of carle_tpu/ops/pallas_head.py's ``make_fused_encoder`` and
``make_fused_ae_loss``, without the row mask).

:func:`encoder` and :func:`ae_loss` are the differentiable entry points:
``torch.autograd.Function``s whose forward and backward launch the kernels
(``csrc/encoder_fwd.cu``, ``encoder_bwd.cu``, ``ae_loss_fwd.cu``,
``ae_loss_bwd.cu``) for CUDA tensors and take the plain twins for CPU tensors.
They save only their inputs and the dropout seed: the backward recomputes the
forward, as the JAX ``custom_vjp`` does.  Where no gradient is asked for they
call the forward alone, so inference builds no graph.

Dropout is Philox4x32-10 indexed by the element (``csrc/philox.cuh``);
:func:`philox_keep_mask` is the same generator in int64 tensor arithmetic, so
a twin draws its kernel's mask.  Max-pool ties share the gradient equally, as
the JAX kernels' ``_pool_route``; ``F.max_pool2d``'s own backward sends it to
one element, so the backward twins are written out.

The kernels compute their own convolutions, pools, transpose convolutions,
masks and sums; ``torch.nn.functional`` appears only in the plain twins.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .cuda_build import KERNELS, stream_args

ENCODER = KERNELS["encoder_fwd"]
AE_LOSS = KERNELS["ae_loss_fwd"]
ENCODER_BWD = KERNELS["encoder_bwd"]
AE_LOSS_BWD = KERNELS["ae_loss_bwd"]
MAX_CHANNELS = 8            # the kernels' register-array bound
SMEM_TARGET = 48 * 1024     # forwards: prefer bands within the default shared memory
SMEM_TARGET_BWD = 100 * 1024  # backwards: two blocks a multiprocessor
SMEM_MAX = 227 * 1024
# dropout stages: the counter's stage field (csrc/net_stages.cuh)
STAGE_ENC1, STAGE_ENC2, STAGE_DEC1, STAGE_DEC2 = 0, 1, 2, 3

__all__ = ["ENCODER", "AE_LOSS", "ENCODER_BWD", "AE_LOSS_BWD", "encoder", "ae_loss",
           "encoder_fwd", "encoder_fwd_plain", "encoder_bwd", "encoder_bwd_plain",
           "ae_loss_fwd", "ae_loss_fwd_plain", "ae_loss_bwd", "ae_loss_bwd_plain",
           "philox4x32", "philox_keep_mask", "drop_settings"]


def _check_pools(pools: Tuple[int, int]) -> None:
    for pool in pools:
        if pool < 2 or pool & (pool - 1):
            raise ValueError(f"pools must be powers of two >= 2, got {pools}")


def _check_drop(drop_p: float) -> None:
    if not 0.0 <= drop_p < 1.0:
        raise ValueError(f"drop_p must be in [0, 1), got {drop_p}")


# ---------------------------------------------------------------------------
# dropout: Philox4x32-10 on int64 tensors, the kernels' counter layout
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low words of the 64-bit product of a 32-bit constant and a
    tensor of 32-bit values held in int64 (split so nothing overflows)."""
    xa, xb = x >> 16, x & 0xFFFF
    pa, pb = xa * m, xb * m                 # each below 2**48
    t = pa + (pb >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (pb & 0xFFFF)


def philox4x32(c0, c1, c2, c3, seed: int):
    """Philox4x32-10: four int64 tensors of 32-bit counter words (broadcast
    together) and a 64-bit key -> the four output words, as int64 tensors."""
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _M32, (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def drop_settings(drop_p: float) -> Tuple[int, float]:
    """(keep_below, scale): an element is kept iff its Philox word is below
    ``keep_below = floor((1 - p) 2**32)``; kept values are multiplied by the
    float32 ``1 / (1 - p)``.  The kernels' launchers compute the same."""
    keep_below = min(int(math.floor((1.0 - drop_p) * 4294967296.0)), _M32)
    scale = torch.tensor(1.0 / (1.0 - drop_p), dtype=torch.float32).item()
    return keep_below, scale


def philox_keep_mask(seed: int, stage: int, shape, drop_p: float,
                     device) -> torch.Tensor:
    """The keep mask (bool, ``shape`` = [N, C, H, W]) the kernels draw at
    dropout ``stage``: counter (x, y, instance, 4 * stage + channel // 4),
    output word ``channel % 4``."""
    n, c, h, w = shape
    groups = -(-c // 4)
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=device)
    words = philox4x32(ar(w).view(1, 1, 1, w), ar(h).view(1, 1, h, 1),
                       ar(n).view(n, 1, 1, 1),
                       (4 * stage + ar(groups)).view(1, groups, 1, 1), seed)
    # [N, groups, 4, H, W] -> channel = 4 * group + word
    stacked = torch.stack(words, dim=2).reshape(n, groups * 4, h, w)[:, :c]
    return stacked < drop_settings(drop_p)[0]


def _dropout(z: torch.Tensor, stage: int, drop_p: float, seed: int):
    """(dropped pre-activation, scale) of a layer's pre-activation."""
    if drop_p == 0.0:
        return z, 1.0
    keep = philox_keep_mask(seed, stage, z.shape, drop_p, z.device)
    scale = drop_settings(drop_p)[1]
    return torch.where(keep, z * scale, torch.zeros_like(z)), scale


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _encoder_planes(x, w1, b1, w2, b2, pools, drop_p, seed):
    """The encoder's forward with what its backward needs: the dropped
    pre-activations d1, d2, the pooled stage-1 activation x1, the output and
    the dropout scale."""
    _check_pools(pools)
    _check_drop(drop_p)
    xf = x.to(torch.float32)
    d1, scale = _dropout(F.conv2d(xf, w1, b1, padding=1), STAGE_ENC1, drop_p, seed)
    x1 = F.max_pool2d(F.relu(d1), pools[0])
    d2, _ = _dropout(F.conv2d(x1, w2, b2, padding=1), STAGE_ENC2, drop_p, seed)
    return xf, d1, x1, d2, F.max_pool2d(F.relu(d2), pools[1]), scale


def encoder_fwd_plain(x, w1, b1, w2, b2, pools: Tuple[int, int],
                      drop_p: float = 0.0, seed: int = 0) -> torch.Tensor:
    """``pool(relu(drop(conv3x3(x))))`` twice, zero padding 1; x [N, 1, H, W]
    uint8 or float32 -> float32 [N, C2, H/(p1 p2), W/(p1 p2)]."""
    return _encoder_planes(x, w1, b1, w2, b2, pools, drop_p, seed)[4]


def _pool_route(d: torch.Tensor, g_pooled: torch.Tensor, pool: int,
                scale: float) -> torch.Tensor:
    """The cotangent of a stage's pre-activation from that of its pooled
    output: ``g / count`` to every element equal to its window's maximum,
    then the relu gate ``d > 0`` and the dropout scale (a positive ``d`` was
    kept)."""
    a = F.relu(d)
    up = lambda t: t.repeat_interleave(pool, 2).repeat_interleave(pool, 3)
    eq = (a == up(F.max_pool2d(a, pool))).to(d.dtype)
    count = F.avg_pool2d(eq, pool, divisor_override=1)
    routed = up(g_pooled / count) * eq
    return torch.where(d > 0, routed * scale, torch.zeros_like(d))


def _conv_wgrad(inp: torch.Tensor, gc: torch.Tensor) -> torch.Tensor:
    """dW [O, C, 3, 3] of a zero-padded 3x3 convolution: inp [N, C, H, W],
    gc [N, O, H, W] the cotangent of its output."""
    h, w = inp.shape[2:]
    xp = F.pad(inp, (1, 1, 1, 1))
    taps = [torch.einsum("nchw,nohw->oc", xp[:, :, dy:dy + h, dx:dx + w], gc)
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=2).reshape(gc.shape[1], inp.shape[1], 3, 3)


def _deconv_wgrad(inp: torch.Tensor, gc: torch.Tensor) -> torch.Tensor:
    """dW [C, M, 4, 4] of a transpose convolution (k4, s2, p1): inp
    [N, C, h, w], gc [N, M, 2h, 2w]; output row 2 iy - 1 + ky reads input row
    iy through tap ky."""
    h, w = inp.shape[2:]
    gp = F.pad(gc, (1, 1, 1, 1))
    taps = [torch.einsum("nchw,nmhw->cm", inp,
                         gp[:, :, ky:ky + 2 * h:2, kx:kx + 2 * w:2])
            for ky in range(4) for kx in range(4)]
    return torch.stack(taps, dim=2).reshape(inp.shape[1], gc.shape[1], 4, 4)


def _encoder_bwd_from_planes(xf, d1, x1, d2, w2, g, pools, scale):
    gc2 = _pool_route(d2, g, pools[1], scale)
    gx1 = F.conv_transpose2d(gc2, w2, padding=1)
    gc1 = _pool_route(d1, gx1, pools[0], scale)
    return (_conv_wgrad(xf, gc1), gc1.sum(dim=(0, 2, 3)),
            _conv_wgrad(x1, gc2), gc2.sum(dim=(0, 2, 3)))


def encoder_bwd_plain(x, w1, b1, w2, b2, g, pools: Tuple[int, int],
                      drop_p: float = 0.0, seed: int = 0):
    """(dW1, db1, dW2, db2) of :func:`encoder_fwd_plain` for the output
    cotangent g, with ties in the max pools sharing equally."""
    xf, d1, x1, d2, _, scale = _encoder_planes(x, w1, b1, w2, b2, pools, drop_p, seed)
    return _encoder_bwd_from_planes(xf, d1, x1, d2, w2, g, pools, scale)


def _ae_planes(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, pools, drop_p, seed):
    xf, d1, x1, d2, emb, scale = _encoder_planes(src, w1, b1, w2, b2, pools, drop_p, seed)
    dm, _ = _dropout(F.conv_transpose2d(emb, wt1, bt1, stride=2, padding=1),
                     STAGE_DEC1, drop_p, seed)
    mid = F.relu(dm)
    dy, _ = _dropout(F.conv_transpose2d(mid, wt2, bt2, stride=2, padding=1),
                     STAGE_DEC2, drop_p, seed)
    return xf, d1, x1, d2, emb, mid, dy, torch.sigmoid(dy), scale


def ae_loss_fwd_plain(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs,
                      pools: Tuple[int, int] = (2, 2), drop_p: float = 0.0,
                      seed: int = 0) -> torch.Tensor:
    """Per-instance ``sum((obs - ae(src))**2)`` over C, H, W -> float32 [N];
    the last stage is ``sigmoid(drop(r))``, so a dropped cell gives 0.5."""
    y = _ae_planes(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, pools, drop_p, seed)[7]
    return ((obs.to(torch.float32) - y) ** 2).sum(dim=(1, 2, 3))


def ae_loss_bwd_plain(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, gbar,
                      pools: Tuple[int, int] = (2, 2), drop_p: float = 0.0,
                      seed: int = 0):
    """(dW1, db1, dW2, db2, dWt1, dbt1, dWt2, dbt2) of
    :func:`ae_loss_fwd_plain` for the cotangent gbar [N] of the error."""
    xf, d1, x1, d2, emb, mid, dy, y, scale = _ae_planes(
        src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, pools, drop_p, seed)
    g = gbar.view(-1, 1, 1, 1) * (2.0 * (y - obs.to(torch.float32)))
    gcy = g * y * (1.0 - y)
    if drop_p > 0.0:  # dy == 0 exactly where the cell was dropped or r == 0
        keep = philox_keep_mask(seed, STAGE_DEC2, dy.shape, drop_p, dy.device)
        gcy = torch.where(keep, gcy * scale, torch.zeros_like(gcy))
    dwt2, dbt2 = _deconv_wgrad(mid, gcy), gcy.sum(dim=(0, 2, 3))
    gmid = F.conv2d(gcy, wt2, stride=2, padding=1)
    gcm = torch.where(mid > 0, gmid * scale, torch.zeros_like(gmid))
    dwt1, dbt1 = _deconv_wgrad(emb, gcm), gcm.sum(dim=(0, 2, 3))
    gemb = F.conv2d(gcm, wt1, stride=2, padding=1)
    return _encoder_bwd_from_planes(xf, d1, x1, d2, w2, gemb, pools, scale) + (
        dwt1, dbt1, dwt2, dbt2)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_cuda_inputs(ref: torch.Tensor, cells, weights) -> None:
    for name, t in cells:
        if t.dtype != torch.uint8 or t.device != ref.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous uint8 tensor on "
                             f"{ref.device} (the kernel reads cells)")
    for name, t in weights:
        if t.dtype != torch.float32 or t.device != ref.device:
            raise ValueError(f"{name} must be float32 on {ref.device}")


def _encoder_smem(h: int, w: int, c1: int, c2: int, p1: int, p2: int,
                  r2: int) -> int:
    """Bytes of the encoder kernel's shared-memory layout for a band of r2
    output rows (must match csrc/encoder_fwd.cu)."""
    xr = r2 * p2 + 2
    ir = xr * p1 + 2
    floats = c1 * 9 + c1 + c2 * c1 * 9 + c2 + c1 * xr * (w // p1 + 2)
    return 4 * floats + ir * (w + 2)


RED_FLOATS = 32 * 9     # csrc/encoder_bwd.cuh
RED16_FLOATS = 32 * 16  # csrc/ae_loss_bwd.cu


def _enc_bwd2_smem(w: int, c1: int, c2: int, p1: int, p2: int, r2: int) -> int:
    """csrc/encoder_bwd.cuh::enc_bwd2_smem."""
    w1, xr = w // p1, r2 * p2 + 2
    floats = (c1 * 9 + c1 + c2 * c1 * 9 + c2 + c1 * xr * (w1 + 2)
              + c2 * r2 * p2 * w1 + RED_FLOATS)
    return 4 * floats + (xr * p1 + 2) * (w + 2)


def _enc_bwd1_smem(w: int, c1: int, c2: int, p1: int, rb: int) -> int:
    """csrc/encoder_bwd.cuh::enc_bwd1_smem."""
    floats = (c1 * 9 + c1 + c2 * c1 * 9 + c2 * (rb + 2) * (w // p1 + 2)
              + RED_FLOATS)
    return 4 * floats + (rb * p1 + 2) * (w + 2)


def _pick_band(smem_of, rows: int, choices, target: int = SMEM_TARGET) -> Tuple[int, int]:
    """The largest band in ``choices`` (at most ``rows``) whose shared memory
    fits ``target``, else the smallest that fits SMEM_MAX."""
    fitting = [(b, smem_of(b)) for b in choices if b <= max(rows, choices[-1])]
    for band, smem in fitting:
        if smem <= target:
            return band, smem
    band, smem = fitting[-1]
    if smem > SMEM_MAX:
        raise ValueError("universe too wide for the kernel's shared-memory band")
    return band, smem


def _encoder_shape(x, w1, w2, pools):
    """Checks shared by the encoder's forward and backward launches."""
    _check_pools(pools)
    p1, p2 = pools
    n, cin, h, w = x.shape
    c1, c2 = w1.shape[0], w2.shape[0]
    if cin != 1 or tuple(w1.shape) != (c1, 1, 3, 3) or tuple(w2.shape) != (c2, c1, 3, 3):
        raise ValueError("the encoder kernels take one input channel and 3x3 "
                         f"weights [C1,1,3,3], [C2,C1,3,3]; got x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if max(c1, c2) > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels a stage")
    if h % (p1 * p2) or w % (p1 * p2):
        raise ValueError(f"{h}x{w} is not divisible by the pools {pools}")
    if n > 65535:
        raise ValueError("at most 65535 instances a launch")
    return n, h, w, c1, c2, p1, p2


def _seed_word(seed: int) -> int:
    return int(seed) & 0xFFFFFFFFFFFFFFFF


def _dispatch(name: str, ref: torch.Tensor, plain, kernel, *args):
    """The plain twin for a CPU tensor, the kernel for a CUDA tensor.  Neither
    records a graph: gradients are the autograd Functions' business, whose
    backward is the backward kernel (or its twin), never torch's own rules for
    the twin's operations (``F.max_pool2d`` routes ties otherwise)."""
    if ref.device.type == "cpu":
        with torch.no_grad():
            return plain(*args)
    if ref.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {ref.device}")
    return kernel(*args)


def encoder_fwd(x, w1, b1, w2, b2, pools: Tuple[int, int], drop_p: float = 0.0,
                seed: int = 0) -> torch.Tensor:
    """Both encoder stages as one kernel on CUDA; the plain twin on the CPU.
    The kernel takes uint8 cells [N, 1, H, W] with H and W divisible by
    p1 * p2.  ``drop_p > 0`` applies dropout from ``seed``."""
    return _dispatch("encoder_fwd", x, encoder_fwd_plain, _encoder_fwd_kernel,
                     x, w1, b1, w2, b2, pools, drop_p, seed)


def _encoder_fwd_kernel(x, w1, b1, w2, b2, pools, drop_p, seed):
    _check_drop(drop_p)
    n, h, w, c1, c2, p1, p2 = _encoder_shape(x, w1, w2, pools)
    _check_cuda_inputs(x, [("x", x)], [("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)])
    ho, wo = h // (p1 * p2), w // (p1 * p2)
    r2, smem = _encoder_fwd_band(h, w, c1, c2, p1, p2)
    out = torch.empty((n, c2, ho, wo), dtype=torch.float32, device=x.device)
    ws = [t.contiguous() for t in (w1, b1, w2, b2)]
    device, stream = stream_args(x)
    ENCODER.launch(x.data_ptr(), *(t.data_ptr() for t in ws), out.data_ptr(),
                   n, h, w, c1, c2, p1, p2, r2, smem, float(drop_p),
                   _seed_word(seed), device, stream)
    return out


@functools.lru_cache(maxsize=None)
def _encoder_fwd_band(h, w, c1, c2, p1, p2) -> Tuple[int, int]:
    return _pick_band(lambda r: _encoder_smem(h, w, c1, c2, p1, p2, r),
                      h // (p1 * p2), (8, 4, 2, 1))


@functools.lru_cache(maxsize=None)
def _encoder_bwd_bands(h, w, c1, c2, p1, p2):
    """(R2, shared memory) of the stage-2 backward kernel, (RB, shared
    memory) of the stage-1 backward kernel."""
    h1 = h // p1
    return (_pick_band(lambda r: _enc_bwd2_smem(w, c1, c2, p1, p2, r),
                       h1 // p2, (8, 4, 2, 1), SMEM_TARGET_BWD),
            _pick_band(lambda r: _enc_bwd1_smem(w, c1, c2, p1, r),
                       h1, (8, 4, 2, 1), SMEM_TARGET_BWD))


@functools.lru_cache(maxsize=None)
def _ae_bands(h, w, c1, c2, cmid, cout):
    """(RY, shared memory) of the autoencoder's forward kernel and of its
    decoder backward kernel."""
    return (_pick_band(lambda r: _ae_smem(h, w, c1, c2, cmid, cout, r),
                       h, (32, 16, 8, 4)),
            _pick_band(lambda r: _ae_bwd_smem(w, c1, c2, cmid, cout, r),
                       h, (32, 16, 8, 4), SMEM_TARGET_BWD))


def _encoder_bwd_plan(n, h, w, c1, c2, p1, p2, device):
    """Bands, shared memory and scratch of the encoder's backward kernels."""
    h1, w1 = h // p1, w // p1
    (r2, smem2), (rb, smem1) = _encoder_bwd_bands(h, w, c1, c2, p1, p2)
    bands2, bands1 = -(-(h1 // p2) // r2), -(-h1 // rb)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
    return dict(r2=r2, rb=rb, smem2=smem2, smem1=smem1,
                gc2=empty(n, c2, h1, w1),
                part2=empty(n * bands2, c2 * c1 * 9 + c2),
                part1=empty(n * bands1, c1 * 9 + c1))


def _split(flat: torch.Tensor, shapes):
    out, at = [], 0
    for shape in shapes:
        size = math.prod(shape)
        out.append(flat[at:at + size].view(shape))
        at += size
    return tuple(out)


def encoder_bwd(x, w1, b1, w2, b2, g, pools: Tuple[int, int], drop_p: float = 0.0,
                seed: int = 0):
    """(dW1, db1, dW2, db2) for the cotangent g of :func:`encoder_fwd`'s
    output: the backward kernels on CUDA, the plain twin on the CPU."""
    return _dispatch("encoder_bwd", x, encoder_bwd_plain, _encoder_bwd_kernel,
                     x, w1, b1, w2, b2, g, pools, drop_p, seed)


def _encoder_bwd_kernel(x, w1, b1, w2, b2, g, pools, drop_p, seed):
    _check_drop(drop_p)
    n, h, w, c1, c2, p1, p2 = _encoder_shape(x, w1, w2, pools)
    _check_cuda_inputs(x, [("x", x)], [("w1", w1), ("b1", b1), ("w2", w2),
                                       ("b2", b2), ("g", g)])
    if tuple(g.shape) != (n, c2, h // (p1 * p2), w // (p1 * p2)):
        raise ValueError(f"g shape {tuple(g.shape)} is not the encoder's output's")
    plan = _encoder_bwd_plan(n, h, w, c1, c2, p1, p2, x.device)
    shapes = ((c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,))
    grads = torch.empty(sum(math.prod(s) for s in shapes), dtype=torch.float32,
                        device=x.device)
    ts = [t.contiguous() for t in (w1, b1, w2, b2, g)]
    device, stream = stream_args(x)
    ENCODER_BWD.launch(x.data_ptr(), *(t.data_ptr() for t in ts),
                       plan["gc2"].data_ptr(), plan["part2"].data_ptr(),
                       plan["part1"].data_ptr(), grads.data_ptr(), n, h, w, c1, c2,
                       p1, p2, plan["r2"], plan["rb"], plan["smem2"], plan["smem1"],
                       float(drop_p), _seed_word(seed), device, stream)
    return _split(grads, shapes)


def _ae_smem(h: int, w: int, c1: int, c2: int, cmid: int, cout: int,
             ry: int) -> int:
    """Bytes of the AE kernel's shared-memory layout for a band of ry output
    rows (must match csrc/ae_loss_fwd.cu)."""
    return 4 * (_ae_band_floats(w, c1, c2, cmid, cout, ry) + 32) + (ry + 14) * (w + 2)


def _ae_band_floats(w, c1, c2, cmid, cout, ry) -> int:
    """csrc/ae_bands.cuh::ae_band_floats."""
    xr, er, mr = ry // 2 + 6, ry // 4 + 2, ry // 2 + 2
    return (c1 * 9 + c1 + c2 * c1 * 9 + c2 + c2 * cmid * 16 + cmid
            + cmid * cout * 16 + cout
            + c1 * xr * (w // 2 + 2) + c2 * er * (w // 4) + cmid * mr * (w // 2))


def _ae_bwd_smem(w, c1, c2, cmid, cout, ry) -> int:
    """csrc/ae_loss_bwd.cu::ae_bwd_decoder_smem."""
    floats = (_ae_band_floats(w, c1, c2, cmid, cout, ry) + cout * (ry + 2) * (w + 2)
              + cmid * (ry // 2) * (w // 2) + RED16_FLOATS)
    return 4 * floats + (ry + 14) * (w + 2)


def _ae_shape(src, w1, w2, wt1, wt2, obs, pools):
    """Checks shared by the autoencoder's forward and backward launches."""
    if tuple(pools) != (2, 2):
        raise ValueError(f"the whole-AE kernel needs pools (2, 2), got {pools}")
    n, cin, h, w = src.shape
    c1, c2 = w1.shape[0], w2.shape[0]
    cmid, cout = wt1.shape[1], wt2.shape[1]
    shapes = ((w1, (c1, 1, 3, 3)), (w2, (c2, c1, 3, 3)),
              (wt1, (c2, cmid, 4, 4)), (wt2, (cmid, cout, 4, 4)))
    if cin != 1 or any(tuple(t.shape) != s for t, s in shapes):
        raise ValueError("the whole-AE kernels take one input channel and weights "
                         "[C1,1,3,3], [C2,C1,3,3], [C2,CMID,4,4], [CMID,COUT,4,4]")
    if tuple(obs.shape) != (n, cout, h, w):
        raise ValueError(f"obs shape {tuple(obs.shape)} != {(n, cout, h, w)}")
    if max(c1, c2, cmid, cout) > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels a stage")
    if h % 4 or w % 4:
        raise ValueError(f"{h}x{w} is not divisible by 4")
    if n > 65535:
        raise ValueError("at most 65535 instances a launch")
    return n, h, w, c1, c2, cmid, cout


def ae_loss_fwd(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs,
                pools: Tuple[int, int] = (2, 2), drop_p: float = 0.0,
                seed: int = 0) -> torch.Tensor:
    """The whole autoencoder and its per-instance squared error as one
    kernel on CUDA; the plain twin on the CPU.  The kernel takes uint8 cells
    src [N, 1, H, W] and obs [N, COUT, H, W], pools (2, 2), H and W divisible
    by 4; the caller divides by C*H*W for the mean."""
    return _dispatch("ae_loss_fwd", src, ae_loss_fwd_plain, _ae_loss_fwd_kernel,
                     src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, pools, drop_p, seed)


def _ae_loss_fwd_kernel(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, pools, drop_p,
                        seed):
    _check_drop(drop_p)
    n, h, w, c1, c2, cmid, cout = _ae_shape(src, w1, w2, wt1, wt2, obs, pools)
    _check_cuda_inputs(src, [("src", src), ("obs", obs)],
                       [("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
                        ("wt1", wt1), ("bt1", bt1), ("wt2", wt2), ("bt2", bt2)])
    ry, smem = _ae_bands(h, w, c1, c2, cmid, cout)[0]
    bands = -(-h // ry)
    partials = torch.empty((n, bands), dtype=torch.float32, device=src.device)
    err = torch.empty((n,), dtype=torch.float32, device=src.device)
    ws = [t.contiguous() for t in (w1, b1, w2, b2, wt1, bt1, wt2, bt2)]
    device, stream = stream_args(src)
    AE_LOSS.launch(src.data_ptr(), obs.data_ptr(), *(t.data_ptr() for t in ws),
                   partials.data_ptr(), err.data_ptr(), n, h, w, c1, c2, cmid,
                   cout, ry, smem, float(drop_p), _seed_word(seed), device, stream)
    return err


def ae_loss_bwd(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, gbar,
                pools: Tuple[int, int] = (2, 2), drop_p: float = 0.0, seed: int = 0):
    """The eight parameter gradients for the cotangent gbar [N] of
    :func:`ae_loss_fwd`'s error: the backward kernels on CUDA, the plain twin
    on the CPU."""
    return _dispatch("ae_loss_bwd", src, ae_loss_bwd_plain, _ae_loss_bwd_kernel,
                     src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, gbar, pools, drop_p,
                     seed)


def _ae_loss_bwd_kernel(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, gbar, pools,
                        drop_p, seed):
    _check_drop(drop_p)
    n, h, w, c1, c2, cmid, cout = _ae_shape(src, w1, w2, wt1, wt2, obs, pools)
    _check_cuda_inputs(src, [("src", src), ("obs", obs)],
                       [("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
                        ("wt1", wt1), ("bt1", bt1), ("wt2", wt2), ("bt2", bt2),
                        ("gbar", gbar)])
    if tuple(gbar.shape) != (n,):
        raise ValueError(f"gbar shape {tuple(gbar.shape)} != {(n,)}")
    ry, smem3 = _ae_bands(h, w, c1, c2, cmid, cout)[1]
    plan = _encoder_bwd_plan(n, h, w, c1, c2, 2, 2, src.device)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=src.device)
    gmid, gemb = empty(n, cmid, h // 2, w // 2), empty(n, c2, h // 4, w // 4)
    part3 = empty(n * -(-h // ry), c2 * cmid * 16 + cmid + cmid * cout * 16 + cout)
    shapes = ((c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,),
              (c2, cmid, 4, 4), (cmid,), (cmid, cout, 4, 4), (cout,))
    grads = empty(sum(math.prod(s) for s in shapes))
    ts = [t.contiguous() for t in (w1, b1, w2, b2, wt1, bt1, wt2, bt2, gbar)]
    device, stream = stream_args(src)
    AE_LOSS_BWD.launch(src.data_ptr(), obs.data_ptr(), *(t.data_ptr() for t in ts),
                       gmid.data_ptr(), gemb.data_ptr(), plan["gc2"].data_ptr(),
                       part3.data_ptr(), plan["part2"].data_ptr(),
                       plan["part1"].data_ptr(), grads.data_ptr(), n, h, w, c1, c2,
                       cmid, cout, ry, plan["r2"], plan["rb"], smem3, plan["smem2"],
                       plan["smem1"], float(drop_p), _seed_word(seed), device, stream)
    return _split(grads, shapes)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class EncoderFn(torch.autograd.Function):
    """encoder_fwd with encoder_bwd as its backward; saves only the inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, pools, drop_p, seed):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.settings = (tuple(pools), float(drop_p), int(seed))
        return encoder_fwd(x, w1, b1, w2, b2, *ctx.settings)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        grads = encoder_bwd(*ctx.saved_tensors, g.contiguous(), *ctx.settings)
        return (None, *grads, None, None, None)


class AELossFn(torch.autograd.Function):
    """ae_loss_fwd with ae_loss_bwd as its backward; saves only the inputs."""

    @staticmethod
    def forward(ctx, src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, pools, drop_p, seed):
        ctx.save_for_backward(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs)
        ctx.settings = (tuple(pools), float(drop_p), int(seed))
        return ae_loss_fwd(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, *ctx.settings)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        grads = ae_loss_bwd(*ctx.saved_tensors, gbar.contiguous(), *ctx.settings)
        return (None, *grads, None, None, None, None)


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def encoder(x, w1, b1, w2, b2, pools: Tuple[int, int], drop_p: float = 0.0,
            seed: int = 0) -> torch.Tensor:
    """The fused encoder, differentiable in its four parameters (the cells
    carry no gradient).  Without a parameter that requires grad it is
    :func:`encoder_fwd` alone."""
    if _wants_grad((w1, b1, w2, b2)):
        return EncoderFn.apply(x, w1, b1, w2, b2, pools, drop_p, seed)
    return encoder_fwd(x, w1, b1, w2, b2, pools, drop_p, seed)


def ae_loss(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs,
            pools: Tuple[int, int] = (2, 2), drop_p: float = 0.0,
            seed: int = 0) -> torch.Tensor:
    """The fused autoencoder error, differentiable in its eight parameters."""
    params = (w1, b1, w2, b2, wt1, bt1, wt2, bt2)
    if _wants_grad(params):
        return AELossFn.apply(src, *params, obs, pools, drop_p, seed)
    return ae_loss_fwd(src, *params, obs, pools, drop_p, seed)
