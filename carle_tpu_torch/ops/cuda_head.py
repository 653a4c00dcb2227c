"""The wrapper nets' fused encoder and whole-autoencoder loss: forward and
backward CUDA kernels, in-kernel dropout, and their plain PyTorch twins
(counterpart of carle_tpu/ops/pallas_head.py's ``make_fused_encoder``, with
its per-instance stage-1 row mask, and ``make_fused_ae_loss``).

:func:`encoder` and :func:`ae_loss` are the differentiable entry points:
``torch.autograd.Function``s whose forward and backward launch the kernels
(``csrc/encoder_fwd.cu``, ``encoder_bwd.cu``, ``ae_loss_fwd.cu``,
``ae_loss_bwd.cu``) for CUDA tensors and take the plain twins for CPU tensors.
They save their inputs and the dropout seed, and the backward recomputes the
forward, as the JAX ``custom_vjp`` does; the autoencoder's, on the AE2D route
(below), also keeps what its forward kernel saved.  Where no gradient is asked
for they call the forward alone, so inference builds no graph.

Dropout is Philox4x32-10 indexed by the element (``csrc/philox.cuh``);
:func:`philox_keep_mask` is the same generator in int64 tensor arithmetic, so
a twin draws its kernel's mask.  Max-pool ties share the gradient equally, as
the JAX kernels' ``_pool_route``; ``F.max_pool2d``'s own backward sends it to
one element, so the backward twins are written out.

The kernels compute their own convolutions, pools, transpose convolutions,
masks and sums; ``torch.nn.functional`` appears only in the plain twins.

At AE2D's widths (C1, C2, CMID, COUT) = (4, 2, 1, 1), which every caller in
the package uses, the whole autoencoder runs as kernels specialised for them
(``csrc/ae2d_fwd.cu``, ``ae2d_bwd.cu``): the training forward saves the
embedding and every dropout keep bit, and the backward reads them instead of
recomputing the encoder and drawing again.  The generic kernels take any other
widths; :data:`AE2D_KERNELS` set to False sends AE2D's widths to them too
(tests and chip_smoke.py hold one instantiation against the other).

At the package's three encoder widths (C1, C2, P1, P2) = (4, 1, 4, 2), (2, 1,
4, 2) and (4, 2, 2, 2) (the RND predictor, the frozen RND target and AE2D's
encoder) the encoder runs kernels specialised for them (``csrc/enc3_fwd.cu``,
``enc3_bwd.cu``; :func:`encoder_route`): stage 1 by table, and a training
forward (:class:`EncoderFn`) that saves its dropout keep bits, so the backward
draws none and is one band kernel.  The generic kernels take any other
widths; :data:`ENC3_KERNELS` set to False sends these widths to them too.

The encoder's kernels take any width divisible by the pools: the plans
(:func:`_encoder_fwd_plan`, :func:`_encoder_bwd_bands`, :func:`_enc3_plan`)
choose a block's rows and column tile by the positions it recomputes and the
blocks a multiprocessor holds (:func:`_pick_by_cost`); :data:`TILE_CELLS`
forces tiles of at most that many cells.  The whole autoencoder runs as one
kernel only where its plans fit without column tiles (:func:`whole_ae_fits`);
``nets.conv_ae_loss`` composes the encoder and the decoder loss elsewhere.

Cells (the encoder's x, the autoencoder's src and obs) are uint8 [N, 1, H, W]
or the packed universe itself, uint32 words [N, 1, H, W/32] (ops/bitpack.py's
layout): the kernels expand the words in shared memory as they stage them
(``csrc/common.cuh``), the twins unpack them (:func:`cells`), and either way
the result is the one the same cells give as uint8.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .bitpack import WORD, unpack_grid
from .cuda_build import KERNELS, stream_args

ENCODER = KERNELS["encoder_fwd"]
AE_LOSS = KERNELS["ae_loss_fwd"]
ENCODER_BWD = KERNELS["encoder_bwd"]
AE_LOSS_BWD = KERNELS["ae_loss_bwd"]
AE2D_FWD = KERNELS["ae2d_fwd"]
AE2D_BWD = KERNELS["ae2d_bwd"]
ENC3_FWD = KERNELS["enc3_fwd"]
ENC3_BWD = KERNELS["enc3_bwd"]
MAX_CHANNELS = 8            # the kernels' register-array bound
SMEM_TARGET = 48 * 1024     # forwards: prefer bands within the default shared memory
SMEM_TARGET_BWD = 100 * 1024  # backwards: two blocks a multiprocessor
SMEM_MAX = 227 * 1024
# The card the plans model (H100 SXM): multiprocessors, the shared memory of
# one (each resident block also takes 1 KB), and the resident threads at
# which the model counts a multiprocessor as fully used; and a block's fixed
# cost (its weights, table, staging and barriers) in computed positions.
SM_COUNT = 132
SMEM_SM = 228 * 1024
FULL_THREADS = 1024
BLOCK_COST = 256
# Tiles of at most this many cells of the universe's width in the encoder and
# decoder-loss kernels (None: the plans choose; the decoder loss's cut the
# width only where one band of the whole width does not fit).  Tests and chip_smoke.py set it to hold a
# tiled launch against the untiled one.
TILE_CELLS: Optional[int] = None
# The whole autoencoder at these widths (C1, C2, CMID, COUT) runs the kernels
# specialised for them wherever their plan fits (:func:`ae2d_route`); False
# runs the generic kernels there too, to hold one against the other.
AE2D_WIDTHS = (4, 2, 1, 1)
AE2D_KERNELS = True
AE2D_SMEM_FWD = 76 * 1024   # three blocks a multiprocessor
AE2D_SMEM_BWD = 100 * 1024  # two
# The encoder at these widths (C1, C2, P1, P2) runs the kernels specialised
# for them (:func:`encoder_route`); False runs the generic kernels there too,
# to hold one against the other.
ENC3_WIDTHS = ((4, 1, 4, 2), (2, 1, 4, 2), (4, 2, 2, 2))
ENC3_KERNELS = True
BLOCK_THREADS = 256         # the encoder kernels' threads a block
# dropout stages: the counter's stage field (csrc/net_stages.cuh)
STAGE_ENC1, STAGE_ENC2, STAGE_DEC1, STAGE_DEC2 = 0, 1, 2, 3

__all__ = ["ENCODER", "AE_LOSS", "ENCODER_BWD", "AE_LOSS_BWD", "AE2D_FWD", "AE2D_BWD",
           "AE2D_WIDTHS", "AE2D_KERNELS", "AE2DSaved", "ae2d_route", "saved_keep_masks",
           "ENC3_FWD", "ENC3_BWD", "ENC3_WIDTHS", "ENC3_KERNELS", "Enc3Saved",
           "encoder_route", "enc3_keep_masks",
           "encoder", "ae_loss",
           "encoder_fwd", "encoder_fwd_plain", "encoder_bwd", "encoder_bwd_plain",
           "ae_loss_fwd", "ae_loss_fwd_plain", "ae_loss_bwd", "ae_loss_bwd_plain",
           "philox4x32", "philox_keep_mask", "drop_settings", "cells", "cell_shape",
           "cell_kind", "whole_ae_fits", "TILE_CELLS"]


def _check_pools(pools: Tuple[int, int]) -> None:
    for pool in pools:
        if pool < 2 or pool & (pool - 1):
            raise ValueError(f"pools must be powers of two >= 2, got {pools}")


def _check_drop(drop_p: float) -> None:
    if not 0.0 <= drop_p < 1.0:
        raise ValueError(f"drop_p must be in [0, 1), got {drop_p}")


# ---------------------------------------------------------------------------
# cells: uint8, float32 or packed uint32 words
# ---------------------------------------------------------------------------

# what a launcher's cell argument holds (csrc/common.cuh KIND_*)
_KINDS = {torch.float32: 0, torch.uint8: 1, torch.uint32: 2}


def cells(t: torch.Tensor) -> torch.Tensor:
    """The cells a tensor holds: packed uint32 words [..., W/32] unpacked to
    uint8 [..., W]; any other tensor as it is."""
    return unpack_grid(t, WORD * t.shape[-1]) if t.dtype == torch.uint32 else t


def cell_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The shape of :func:`cells` of ``t``, without unpacking."""
    shape = tuple(t.shape)
    return shape[:-1] + (WORD * shape[-1],) if t.dtype == torch.uint32 else shape


def _packed(*ts: torch.Tensor) -> bool:
    """Whether a launch reads packed words (its count of packed launches)."""
    return any(t.dtype == torch.uint32 for t in ts)


def cell_kind(t: torch.Tensor) -> int:
    """The launchers' kind code of a cell argument: 0 float32, 1 uint8, 2
    packed uint32 words."""
    return _KINDS[t.dtype]


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


def _row_factor(rows: torch.Tensor) -> torch.Tensor:
    """Per-instance row values [N, H] (the encoder's stage-1 mask, the
    decoder loss's error weights) as a factor over [N, C, H, W]."""
    return rows.to(torch.float32)[:, None, :, None]


def _encoder_planes(x, w1, b1, w2, b2, pools, drop_p, seed, mask=None):
    """The encoder's forward with what its backward needs: the dropped
    pre-activations d1, d2, the pooled stage-1 activation x1 (times the row
    mask), the output and the dropout scale."""
    _check_pools(pools)
    _check_drop(drop_p)
    xf = cells(x).to(torch.float32)
    d1, scale = _dropout(F.conv2d(xf, w1, b1, padding=1), STAGE_ENC1, drop_p, seed)
    x1 = F.max_pool2d(F.relu(d1), pools[0])
    if mask is not None:
        x1 = x1 * _row_factor(mask)
    d2, _ = _dropout(F.conv2d(x1, w2, b2, padding=1), STAGE_ENC2, drop_p, seed)
    return xf, d1, x1, d2, F.max_pool2d(F.relu(d2), pools[1]), scale


def encoder_fwd_plain(x, w1, b1, w2, b2, pools: Tuple[int, int],
                      drop_p: float = 0.0, seed: int = 0,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``pool(relu(drop(conv3x3(x))))`` twice, zero padding 1; x [N, 1, H, W]
    uint8 or float32, or packed words [N, 1, H, W/32] -> float32
    [N, C2, H/(p1 p2), W/(p1 p2)].  ``mask`` [N, H/p1] multiplies the pooled
    stage-1 rows that stage 2 reads (the band tiling's out-of-universe
    rows)."""
    return _encoder_planes(x, w1, b1, w2, b2, pools, drop_p, seed, mask)[4]


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


def _encoder_bwd_from_planes(xf, d1, x1, d2, w2, g, pools, scale, mask=None):
    gc2 = _pool_route(d2, g, pools[1], scale)
    gx1 = F.conv_transpose2d(gc2, w2, padding=1)
    if mask is not None:  # no gradient through a zeroed row
        gx1 = gx1 * _row_factor(mask)
    gc1 = _pool_route(d1, gx1, pools[0], scale)
    return (_conv_wgrad(xf, gc1), gc1.sum(dim=(0, 2, 3)),
            _conv_wgrad(x1, gc2), gc2.sum(dim=(0, 2, 3)))


def encoder_bwd_plain(x, w1, b1, w2, b2, g, pools: Tuple[int, int],
                      drop_p: float = 0.0, seed: int = 0,
                      mask: Optional[torch.Tensor] = None):
    """(dW1, db1, dW2, db2) of :func:`encoder_fwd_plain` for the output
    cotangent g, with ties in the max pools sharing equally."""
    xf, d1, x1, d2, _, scale = _encoder_planes(x, w1, b1, w2, b2, pools, drop_p, seed, mask)
    return _encoder_bwd_from_planes(xf, d1, x1, d2, w2, g, pools, scale, mask)


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
    return ((cells(obs).to(torch.float32) - y) ** 2).sum(dim=(1, 2, 3))


def ae_loss_bwd_plain(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, gbar,
                      pools: Tuple[int, int] = (2, 2), drop_p: float = 0.0,
                      seed: int = 0):
    """(dW1, db1, dW2, db2, dWt1, dbt1, dWt2, dbt2) of
    :func:`ae_loss_fwd_plain` for the cotangent gbar [N] of the error."""
    xf, d1, x1, d2, emb, mid, dy, y, scale = _ae_planes(
        src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, pools, drop_p, seed)
    g = gbar.view(-1, 1, 1, 1) * (2.0 * (y - cells(obs).to(torch.float32)))
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


def _check_cuda_inputs(ref: torch.Tensor, cell_args, weights) -> None:
    for name, t in cell_args:
        if (t.dtype not in (torch.uint8, torch.uint32) or t.device != ref.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous uint8 or packed uint32 tensor "
                             f"on {ref.device} (the kernel reads cells)")
    for name, t in weights:
        if t.dtype != torch.float32 or t.device != ref.device:
            raise ValueError(f"{name} must be float32 on {ref.device}")


def _widest_window(n: int, t: int, h: int) -> int:
    """csrc/common.cuh::widest_window: the widest of the windows
    [max(c0 - h, 0), min(c0 + t + h, n)) over the tiles c0 = 0, t, ... of
    [0, n)."""
    return max(min(c0 + t + h, n) - max(c0 - h, 0) for c0 in range(0, n, t))


def _encoder_smem(h: int, w: int, c1: int, c2: int, p1: int, p2: int,
                  r2: int, two: int) -> int:
    """Bytes of the encoder kernel's shared-memory layout for a block of r2
    output rows and two output columns (csrc/encoder_fwd.cu::encoder_fwd_smem)."""
    t = min(two, w // (p1 * p2))
    xr = r2 * p2 + 2
    ir = xr * p1 + 2
    floats = c1 * 9 + c1 + c2 * c1 * 9 + c2 + c1 * xr * (t * p2 + 2)
    return 4 * floats + ir * (_widest_window(w // p1, t * p2, 1) * p1 + 2)


RED_FLOATS = 32 * 9     # csrc/encoder_bwd.cuh
RED16_FLOATS = 32 * 16  # csrc/ae_loss_bwd.cu


def _enc_bwd2_smem(w: int, c1: int, c2: int, p1: int, p2: int, r2: int, t2: int) -> int:
    """csrc/encoder_bwd.cuh::enc_bwd2_smem."""
    t = min(t2, w // (p1 * p2))
    xr = r2 * p2 + 2
    floats = (c1 * 9 + c1 + c2 * c1 * 9 + c2 + c1 * xr * (t * p2 + 2)
              + c2 * r2 * p2 * t * p2 + RED_FLOATS)
    return 4 * floats + (xr * p1 + 2) * (_widest_window(w // p1, t * p2, 1) * p1 + 2)


def _enc_bwd1_smem(w: int, c1: int, c2: int, p1: int, rb: int, t1: int) -> int:
    """csrc/encoder_bwd.cuh::enc_bwd1_smem."""
    t = min(t1, w // p1)
    floats = c1 * 9 + c1 + c2 * c1 * 9 + c2 * (rb + 2) * (t + 2) + RED_FLOATS
    return 4 * floats + (rb * p1 + 2) * (t * p1 + 2)


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


def _pick_tile(smem_of, rows: int, choices, cols: int, unit: int,
               target: int = SMEM_TARGET, cells: Optional[int] = None) -> Tuple[int, int, int]:
    """(band, tile, shared memory) of a kernel whose block owns ``band`` rows
    and ``tile`` of the ``cols`` columns (``smem_of(band, tile)``; a column is
    ``unit`` cells of the universe).  The whole width where one band of it
    fits SMEM_MAX (today's plan, :func:`_pick_band`) unless ``cells`` forces
    tiles of at most that many cells; else the largest band in ``choices``
    with the widest tile (``cols`` or a power of two) that fits ``target``,
    else SMEM_MAX."""
    if cells is None:
        try:
            band, smem = _pick_band(lambda b: smem_of(b, cols), rows, choices, target)
            return band, cols, smem
        except ValueError:
            pass
    limit = cols if cells is None else max(1, min(cols, cells // unit))
    tiles = sorted({limit} | {1 << k for k in range(limit.bit_length())}, reverse=True)
    bands = [b for b in choices if b <= max(rows, choices[-1])]
    for bound in (target, SMEM_MAX):
        for band in bands:
            for tile in tiles:
                smem = smem_of(band, tile)
                if smem <= bound:
                    return band, tile, smem
    raise ValueError("no band and tile of the universe fit the kernel's shared memory")


def _covered(extent: int, block: int, scale: int, halo: int) -> int:
    """Positions a band kernel computes along one axis: blocks of ``block``
    of ``extent`` output positions, each computing ``scale`` positions an
    output and ``halo`` more to either side, cut at the axis's ends."""
    total = 0
    for i0 in range(0, extent, block):
        end = min(i0 + block, extent)
        total += min(scale * end + halo, scale * extent) - max(scale * i0 - halo, 0)
    return total


def _pick_by_cost(smem_of, n: int, rows: int, cols: int, scale: int, halo: int, bands,
                  unit: int, cells: Optional[int] = None,
                  blocks_sm: int = 2048 // BLOCK_THREADS) -> Tuple[int, int, int]:
    """(band, tile, shared memory) of a band kernel over n instances whose
    block owns ``band`` of ``rows`` output rows and ``tile`` of ``cols``
    output columns (a column ``unit`` cells of the universe), computing
    ``scale`` positions an output and ``halo`` to either side (:func:`_covered`),
    in ``smem_of(band, tile)`` bytes: the plan of least modelled time, each
    multiprocessor's blocks in turn times a block's positions and
    BLOCK_COST, over the share of FULL_THREADS its resident blocks keep busy
    (at most ``blocks_sm`` a multiprocessor: the kernel's register cap).
    Tiles are the whole width or a power of two; ``cells`` forces tiles of
    that many cells."""
    if cells is None:
        tiles = sorted({cols} | {1 << k for k in range(cols.bit_length()) if 1 << k < cols},
                       reverse=True)
    else:
        tiles = [max(1, min(cols, cells // unit))]
    best, best_time = None, math.inf
    for band in [b for b in bands if b <= rows] or [min(bands)]:
        for tile in tiles:
            smem = smem_of(band, tile)
            if smem > SMEM_MAX:
                continue
            blocks = n * -(-rows // band) * -(-cols // tile)
            per_sm = -(-blocks // SM_COUNT)
            resident = min(per_sm, blocks_sm, SMEM_SM // (smem + 1024))
            area = n * _covered(rows, band, scale, halo) * _covered(cols, tile, scale, halo)
            t = (per_sm * (area / blocks + BLOCK_COST)
                 / min(1.0, resident * BLOCK_THREADS / FULL_THREADS))
            if t < best_time:
                best, best_time = (band, tile, smem), t
    if best is None:
        raise ValueError("no band and tile of the universe fit the kernel's shared memory")
    return best


def _encoder_shape(x, w1, w2, pools):
    """Checks shared by the encoder's forward and backward launches."""
    _check_pools(pools)
    p1, p2 = pools
    n, cin, h, w = cell_shape(x)
    c1, c2 = w1.shape[0], w2.shape[0]
    if cin != 1 or tuple(w1.shape) != (c1, 1, 3, 3) or tuple(w2.shape) != (c2, c1, 3, 3):
        raise ValueError("the encoder kernels take one input channel and 3x3 "
                         f"weights [C1,1,3,3], [C2,C1,3,3]; got x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if max(c1, c2) > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels a stage")
    if h % (p1 * p2) or w % (p1 * p2):
        raise ValueError(f"{h}x{w} is not divisible by the pools {pools}")
    return n, h, w, c1, c2, p1, p2


def _check_mask(mask, ref: torch.Tensor, n: int, rows: int):
    """The row mask as the kernels read it: float32 [N, rows] on ref's
    device, contiguous; None stays None."""
    if mask is None:
        return None
    if tuple(mask.shape) != (n, rows) or mask.dtype != torch.float32 or mask.device != ref.device:
        raise ValueError(f"mask must be float32 [{n}, {rows}] on {ref.device}, got "
                         f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
    return mask.contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


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
                seed: int = 0, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both encoder stages as one kernel on CUDA; the plain twin on the CPU.
    The kernel takes uint8 cells [N, 1, H, W] or packed words [N, 1, H, W/32]
    with H and W divisible by p1 * p2.  ``drop_p > 0`` applies dropout from
    ``seed``; ``mask`` (float32 [N, H/p1], None for all ones) multiplies the
    pooled stage-1 rows."""
    return _dispatch("encoder_fwd", x, encoder_fwd_plain, _encoder_fwd_kernel,
                     x, w1, b1, w2, b2, pools, drop_p, seed, mask)


def _encoder_fwd_kernel(x, w1, b1, w2, b2, pools, drop_p, seed, mask=None):
    return _encoder_fwd_launch(x, (w1, b1, w2, b2), pools, drop_p, seed, mask, False)[0]


def _encoder_fwd_launch(x, params, pools, drop_p, seed, mask, save):
    """(out, Enc3Saved or None): the forward kernel of the widths' route;
    ``save`` (the specialised route with dropout) also keeps the keep bits
    its backward reads."""
    w1, b1, w2, b2 = params
    _check_drop(drop_p)
    n, h, w, c1, c2, p1, p2 = _encoder_shape(x, w1, w2, pools)
    _check_cuda_inputs(x, [("x", x)], [("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)])
    mask = _check_mask(mask, x, n, h // p1)
    if encoder_route(h, w, (c1, c2), pools):
        return _enc3_fwd_kernel(x, params, pools, drop_p, seed, mask, save)
    ho, wo = h // (p1 * p2), w // (p1 * p2)
    r2, two, smem = _encoder_fwd_plan(h, w, c1, c2, p1, p2, TILE_CELLS, n)
    out = torch.empty((n, c2, ho, wo), dtype=torch.float32, device=x.device)
    ws = [t.contiguous() for t in (w1, b1, w2, b2)]
    device, stream = stream_args(x)
    ENCODER.launch(x.data_ptr(), *(t.data_ptr() for t in ws), _ptr(mask), out.data_ptr(),
                   n, h, w, c1, c2, p1, p2, r2, two, smem, cell_kind(x), float(drop_p),
                   _seed_word(seed), device, stream, packed=_packed(x))
    return out, None


@functools.lru_cache(maxsize=None)
def _encoder_fwd_plan(h, w, c1, c2, p1, p2, cells=None, n=1) -> Tuple[int, int, int]:
    """(R2 output rows, output columns a tile, shared memory) of the generic
    forward kernel on n instances (a block computes R2 p2 + 2 stage-1 rows
    and its tile's p2 columns an output plus one to either side)."""
    return _pick_by_cost(lambda r, t: _encoder_smem(h, w, c1, c2, p1, p2, r, t), n,
                         h // (p1 * p2), w // (p1 * p2), p2, 1, (8, 4, 2, 1), p1 * p2, cells)


@functools.lru_cache(maxsize=None)
def _encoder_bwd_bands(h, w, c1, c2, p1, p2, cells=None, n=1):
    """(R2, T2 output columns, shared memory) of the generic stage-2 backward
    kernel, (RB, T1 stage-1 columns, shared memory) of the generic stage-1
    backward kernel, on n instances."""
    h1 = h // p1
    return (_pick_by_cost(lambda r, t: _enc_bwd2_smem(w, c1, c2, p1, p2, r, t), n, h1 // p2,
                          w // (p1 * p2), p2, 1, (8, 4, 2, 1), p1 * p2, cells),
            _pick_by_cost(lambda r, t: _enc_bwd1_smem(w, c1, c2, p1, r, t), n, h1, w // p1,
                          1, 1, (8, 4, 2, 1), p1, cells))


@functools.lru_cache(maxsize=None)
def _encoder_bwd_whole(h, w, c1, c2):
    """The generic encoder backward's bands without column tiles at pools
    (2, 2), as the whole-AE backward kernel (ae_loss_bwd.cu) runs it: (R2,
    T2, shared memory), (RB, T1, shared memory), each the largest band whose
    shared memory fits SMEM_TARGET_BWD, else the smallest that fits SMEM_MAX
    (:func:`_pick_band`; ValueError where none does)."""
    h1, w1 = h // 2, w // 2
    r2, smem2 = _pick_band(lambda r: _enc_bwd2_smem(w, c1, c2, 2, 2, r, w1 // 2), h1 // 2,
                           (8, 4, 2, 1), SMEM_TARGET_BWD)
    rb, smem1 = _pick_band(lambda r: _enc_bwd1_smem(w, c1, c2, 2, r, w1), h1, (8, 4, 2, 1),
                           SMEM_TARGET_BWD)
    return (r2, w1 // 2, smem2), (rb, w1, smem1)


@functools.lru_cache(maxsize=None)
def _ae_bands(h, w, c1, c2, cmid, cout):
    """(RY, shared memory) of the autoencoder's forward kernel and of its
    decoder backward kernel."""
    return (_pick_band(lambda r: _ae_smem(h, w, c1, c2, cmid, cout, r),
                       h, (32, 16, 8, 4)),
            _pick_band(lambda r: _ae_bwd_smem(w, c1, c2, cmid, cout, r),
                       h, (32, 16, 8, 4), SMEM_TARGET_BWD))


@functools.lru_cache(maxsize=None)
def whole_ae_fits(h: int, w: int, c1: int, c2: int, cmid: int, cout: int) -> bool:
    """Whether the whole autoencoder runs as one kernel at [h, w] (pools
    (2, 2)): its forward and its decoder backward each find a band of the
    whole width within a block's shared memory, and its encoder backward
    needs no column tiles.  Shapes alone decide, on any device, so forward and
    backward take one route; elsewhere ``nets.conv_ae_loss`` composes the
    encoder and the decoder loss, as carle_tpu/nets.py::conv_ae_loss past its
    kernel's VMEM limit."""
    try:
        _ae_bands(h, w, c1, c2, cmid, cout)
        _encoder_bwd_whole(h, w, c1, c2)
    except ValueError:
        return False
    return True


def _encoder_bwd_plan(n, h, w, c1, c2, p1, p2, device, bands):
    """Bands, tiles, shared memory and scratch of the generic encoder
    backward kernels with ``bands`` (:func:`_encoder_bwd_bands` or
    :func:`_encoder_bwd_whole`)."""
    h1, w1 = h // p1, w // p1
    (r2, t2, smem2), (rb, t1, smem1) = bands
    blocks2 = -(-(h1 // p2) // r2) * -(-(w1 // p2) // t2)
    blocks1 = -(-h1 // rb) * -(-w1 // t1)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
    return dict(r2=r2, rb=rb, t2=t2, t1=t1, smem2=smem2, smem1=smem1,
                gc2=empty(n, c2, h1, w1),
                part2=empty(n * blocks2, c2 * c1 * 9 + c2),
                part1=empty(n * blocks1, c1 * 9 + c1))


def _split(flat: torch.Tensor, shapes):
    out, at = [], 0
    for shape in shapes:
        size = math.prod(shape)
        out.append(flat[at:at + size].view(shape))
        at += size
    return tuple(out)


def encoder_bwd(x, w1, b1, w2, b2, g, pools: Tuple[int, int], drop_p: float = 0.0,
                seed: int = 0, mask: Optional[torch.Tensor] = None):
    """(dW1, db1, dW2, db2) for the cotangent g of :func:`encoder_fwd`'s
    output: the backward kernels on CUDA, the plain twin on the CPU."""
    return _dispatch("encoder_bwd", x, encoder_bwd_plain, _encoder_bwd_kernel,
                     x, w1, b1, w2, b2, g, pools, drop_p, seed, mask)


def _encoder_bwd_kernel(x, w1, b1, w2, b2, g, pools, drop_p, seed, mask=None):
    _check_drop(drop_p)
    n, h, w, c1, c2, p1, p2 = _encoder_shape(x, w1, w2, pools)
    _check_cuda_inputs(x, [("x", x)], [("w1", w1), ("b1", b1), ("w2", w2),
                                       ("b2", b2), ("g", g)])
    if tuple(g.shape) != (n, c2, h // (p1 * p2), w // (p1 * p2)):
        raise ValueError(f"g shape {tuple(g.shape)} is not the encoder's output's")
    mask = _check_mask(mask, x, n, h // p1)
    if encoder_route(h, w, (c1, c2), pools):
        # the gradients alone: the saving forward draws the bits the backward reads
        params = (w1, b1, w2, b2)
        saved = (_enc3_fwd_kernel(x, params, pools, drop_p, seed, mask, True)[1]
                 if drop_p > 0.0 else None)
        return _enc3_bwd_kernel(x, params, g, pools, drop_p, mask, saved)
    plan = _encoder_bwd_plan(n, h, w, c1, c2, p1, p2, x.device,
                             _encoder_bwd_bands(h, w, c1, c2, p1, p2, TILE_CELLS, n))
    shapes = ((c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,))
    grads = torch.empty(sum(math.prod(s) for s in shapes), dtype=torch.float32,
                        device=x.device)
    ts = [t.contiguous() for t in (w1, b1, w2, b2)]
    device, stream = stream_args(x)
    ENCODER_BWD.launch(x.data_ptr(), *(t.data_ptr() for t in ts), _ptr(mask),
                       g.contiguous().data_ptr(), plan["gc2"].data_ptr(),
                       plan["part2"].data_ptr(), plan["part1"].data_ptr(), grads.data_ptr(),
                       n, h, w, c1, c2, p1, p2, plan["r2"], plan["rb"], plan["t2"],
                       plan["t1"], plan["smem2"], plan["smem1"], cell_kind(x),
                       float(drop_p), _seed_word(seed), device, stream, packed=_packed(x))
    return _split(grads, shapes)


# -- the encoder at the package's widths (csrc/enc3.cuh) ------------------------


def _enc3_words(p1: int, xw: int) -> int:
    """csrc/enc3.cuh::enc3_words."""
    return (p1 * xw + 2 + 62) // 32 + 1


def _enc3_fwd_smem(c1: int, p1: int, r2: int, tw: int) -> int:
    """csrc/enc3.cuh::enc3_fwd_smem."""
    xr, xw = 2 * r2 + 2, 2 * tw + 2
    return 4 * (512 * c1 + c1 * xr * xw) + 4 * (p1 * xr + 2) * _enc3_words(p1, xw)


def _enc3_bwd_smem(c1: int, c2: int, p1: int, r2: int, tw: int) -> int:
    """csrc/enc3.cuh::enc3_bwd_smem."""
    xr, xw, gr, gw = 2 * r2 + 6, 2 * tw + 6, 2 * r2 + 4, 2 * tw + 4
    return (4 * (512 * c1 + c1 * xr * xw + c2 * gr * gw + 32 * 9) + 512 * (8 if p1 == 4 else 4)
            + 4 * (p1 * xr + 2) * _enc3_words(p1, xw))


@functools.lru_cache(maxsize=None)
def _enc3_plan(n, h, w, c1, c2, p1, backward, cells=None) -> Tuple[int, int, int]:
    """(R2 output rows, TW output columns, shared memory) of the specialised
    forward or backward kernel on n instances of [h, w]: the forward computes
    its stage-1 rows and one to either side, the backward three."""
    smem_of = ((lambda r, t: _enc3_bwd_smem(c1, c2, p1, r, t)) if backward
               else (lambda r, t: _enc3_fwd_smem(c1, p1, r, t)))
    return _pick_by_cost(smem_of, n, h // (2 * p1), w // (2 * p1), 2, 3 if backward else 1,
                         (32, 16, 8, 4, 2, 1), 2 * p1, cells)


def encoder_route(h: int, w: int, widths, pools) -> bool:
    """Whether the encoder at [h, w] with ``widths`` (C1, C2) and ``pools``
    runs the kernels specialised for them (csrc/enc3_fwd.cu, enc3_bwd.cu):
    the widths and pools, and plans that fit, decide, on any device, so the
    forward and the backward take one route."""
    if not ENC3_KERNELS or (*widths, *pools) not in ENC3_WIDTHS:
        return False
    try:
        for backward in (False, True):
            _enc3_plan(1, h, w, *widths, pools[0], backward)
    except ValueError:
        return False
    return True


class Enc3Saved(NamedTuple):
    """The keep bits an encoder training forward on the specialised route
    saves for its backward (csrc/enc3.cuh::Enc3Saved): keep1 [N, H/p1, W/p1]
    (int16, int32 or int64: p1 p1 C1 bits, bit C1 p + c for channel c of
    pixel p = p1 py + px of the pool window), keep2 uint8 [N, H/2p1, W/2p1]
    (bit C2 p + o)."""
    keep1: torch.Tensor
    keep2: torch.Tensor


_KEEP_WORDS = {16: torch.int16, 32: torch.int32, 64: torch.int64}


def enc3_keep_masks(saved: Enc3Saved, c1: int, c2: int, p1: int):
    """The keep masks of the encoder's two dropout stages that a training
    forward saved, in :func:`philox_keep_mask`'s layout: [N, C1, H, W],
    [N, C2, H/p1, W/p1]."""
    return [_unfold_bits(saved.keep1, p1 * p1 * c1, p1, c1),
            _unfold_bits(saved.keep2, 4 * c2, 2, c2)]


def _enc3_fwd_kernel(x, params, pools, drop_p, seed, mask, save):
    """(out, Enc3Saved or None): the specialised forward on checked inputs;
    ``save`` with dropout also writes the keep bits."""
    n, _, h, w = cell_shape(x)
    c1, c2, p1 = params[0].shape[0], params[2].shape[0], pools[0]
    if x.dtype == torch.uint8 and x.data_ptr() % 4:
        raise ValueError("uint8 x must start on a 4-byte boundary (the encoder kernel reads "
                         "its cells four at a time)")
    r2, tw, smem = _enc3_plan(n, h, w, c1, c2, p1, False, TILE_CELLS)
    dev = x.device
    out = torch.empty((n, c2, h // (2 * p1), w // (2 * p1)), dtype=torch.float32, device=dev)
    saved = None
    if save and drop_p > 0.0:
        saved = Enc3Saved(
            torch.empty((n, h // p1, w // p1), dtype=_KEEP_WORDS[p1 * p1 * c1], device=dev),
            torch.empty((n, h // (2 * p1), w // (2 * p1)), dtype=torch.uint8, device=dev))
    ws = [t.contiguous() for t in params]
    device, stream = stream_args(x)
    ENC3_FWD.launch(x.data_ptr(), *(t.data_ptr() for t in ws), _ptr(mask), out.data_ptr(),
                    *(_ptr(t) for t in saved or (None, None)), n, h, w, c1, c2, p1, pools[1],
                    r2, tw, smem, cell_kind(x), float(drop_p), _seed_word(seed), device, stream,
                    packed=_packed(x))
    return out, saved


def _enc3_bwd_kernel(x, params, g, pools, drop_p, mask, saved: Optional[Enc3Saved]):
    """(dW1, db1, dW2, db2) from the specialised backward on checked inputs
    and what the training forward with the same params saved (None without
    dropout)."""
    n, _, h, w = cell_shape(x)
    c1, c2, p1 = params[0].shape[0], params[2].shape[0], pools[0]
    r2, tw, smem = _enc3_plan(n, h, w, c1, c2, p1, True, TILE_CELLS)
    blocks = -(-(h // (2 * p1)) // r2) * -(-(w // (2 * p1)) // tw)
    shapes = ((c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,))
    width = sum(math.prod(s) for s in shapes)
    partials = torch.empty((n * blocks, width), dtype=torch.float32, device=x.device)
    grads = torch.empty((width,), dtype=torch.float32, device=x.device)
    ws = [t.contiguous() for t in (*params, g)]   # alive until the launch is enqueued
    device, stream = stream_args(x)
    ENC3_BWD.launch(x.data_ptr(), *(t.data_ptr() for t in ws[:4]), _ptr(mask),
                    ws[4].data_ptr(), *(_ptr(t) for t in saved or (None, None)),
                    partials.data_ptr(), grads.data_ptr(), n, h, w, c1, c2, p1, pools[1], r2,
                    tw, smem, cell_kind(x), float(drop_p), device, stream, packed=_packed(x))
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
    n, cin, h, w = cell_shape(src)
    c1, c2 = w1.shape[0], w2.shape[0]
    cmid, cout = wt1.shape[1], wt2.shape[1]
    shapes = ((w1, (c1, 1, 3, 3)), (w2, (c2, c1, 3, 3)),
              (wt1, (c2, cmid, 4, 4)), (wt2, (cmid, cout, 4, 4)))
    if cin != 1 or any(tuple(t.shape) != s for t, s in shapes):
        raise ValueError("the whole-AE kernels take one input channel and weights "
                         "[C1,1,3,3], [C2,C1,3,3], [C2,CMID,4,4], [CMID,COUT,4,4]")
    if cell_shape(obs) != (n, cout, h, w):
        raise ValueError(f"obs cells {cell_shape(obs)} != {(n, cout, h, w)}")
    if max(c1, c2, cmid, cout) > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels a stage")
    if h % 4 or w % 4:
        raise ValueError(f"{h}x{w} is not divisible by 4")
    if n > 65535:
        raise ValueError("at most 65535 instances a launch")
    return n, h, w, c1, c2, cmid, cout


def _ae2d_dims(w: int, ry: int):
    """csrc/ae2d.cuh::Ae2dDims: (W/2, W/4, words a bit row, stage-1 rows, their
    width, embedding rows, their width, middle rows) of a band of ry rows."""
    w1, we = w // 2, w // 4
    return w1, we, -(-w // 32) + 2, ry // 2 + 6, w1 + 2, ry // 4 + 2, we + 2, ry // 2 + 2


def _ae2d_fwd_smem(w: int, ry: int, save_keep: bool) -> int:
    """csrc/ae2d.cuh::ae2d_fwd_smem."""
    w1, _, ns, xr, xw, er, ew, mr = _ae2d_dims(w, ry)
    floats = 4 * 512 + 4 * xr * xw + 2 * er * ew + mr * xw + 32
    return 4 * floats + 4 * (ry + 14) * ns + ((ry // 2) * w1 if save_keep else 0)


def _ae2d_bwd_dec_smem(w: int, ry: int) -> int:
    """csrc/ae2d.cuh::ae2d_bwd_dec_smem."""
    w1, _, _, _, xw, er, ew, mr = _ae2d_dims(w, ry)
    return 4 * (2 * er * ew + mr * xw + (ry + 2) * (w + 2) + (ry // 2) * w1 + 32 * 16)


def _ae2d_bwd_enc_smem(w: int, ry: int) -> int:
    """csrc/ae2d.cuh::ae2d_bwd_enc_smem."""
    _, we, ns, xr, xw, er, _, _ = _ae2d_dims(w, ry)
    return (4 * (4 * 512 + 4 * xr * xw + 2 * er * we + 2 * (ry // 2 + 4) * xw + 32 * 9)
            + 4 * (512 + (ry + 14) * ns))


@functools.lru_cache(maxsize=None)
def _ae2d_plan(h: int, w: int):
    """(RY of the forward, RY and shared memory of the backward's decoder and
    encoder band kernels) of the AE2D kernels at [h, w], or None where a band
    of the whole width does not fit a block."""
    try:
        ry, _ = _pick_band(lambda r: _ae2d_fwd_smem(w, r, True), h, (32, 16, 8, 4),
                           AE2D_SMEM_FWD)
        dec = _pick_band(lambda r: _ae2d_bwd_dec_smem(w, r), h, (32, 16, 8, 4), AE2D_SMEM_BWD)
        enc = _pick_band(lambda r: _ae2d_bwd_enc_smem(w, r), h, (32, 16, 8, 4), AE2D_SMEM_BWD)
    except ValueError:
        return None
    return ry, dec, enc


def ae2d_route(h: int, w: int, widths) -> bool:
    """Whether the whole autoencoder at [h, w] with ``widths`` (C1, C2, CMID,
    COUT) runs the AE2D kernels: its widths and a plan that fits decide."""
    return AE2D_KERNELS and tuple(widths) == AE2D_WIDTHS and _ae2d_plan(h, w) is not None


class AE2DSaved(NamedTuple):
    """What the AE2D training forward saves for its backward: the
    embedding [N, 2, H/4, W/4] and, with dropout, the keep bits
    (csrc/ae2d.cuh::Ae2dSaved): keep1 int16 [N, H/2, W/2] (bit 4p + c:
    stage-1 pixel p = 2 py + px of the pool window, channel c), keep2 uint8
    [N, H/4, W/4] (bit 2p + o: stage-2 pixel p, channel o), keepd uint8
    [N, H/2, W/2] (bit 2a + b: output (2i + a, 2j + b); bit 4: middle (i, j))."""
    emb: torch.Tensor
    keep1: Optional[torch.Tensor]
    keep2: Optional[torch.Tensor]
    keepd: Optional[torch.Tensor]


_AE_SHAPES = ((4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,))


def _unfold_bits(words: torch.Tensor, count: int, window: int, channels: int) -> torch.Tensor:
    """Bits [N, h, w] (bit (window py + px) channels + c) as a mask
    [N, channels, h window, w window]."""
    n, h, w = words.shape
    bits = (words.to(torch.int64)[..., None] >> torch.arange(count, device=words.device)) & 1
    bits = bits.view(n, h, w, window, window, channels).permute(0, 5, 1, 3, 2, 4)
    return bits.reshape(n, channels, h * window, w * window).bool()


def saved_keep_masks(saved: AE2DSaved):
    """The keep masks of the four dropout stages that an AE2D training forward
    saved, in :func:`philox_keep_mask`'s layout: [N, 4, H, W], [N, 2, H/2,
    W/2], [N, 1, H/2, W/2], [N, 1, H, W]."""
    keepd = saved.keepd.to(torch.int32)
    return [_unfold_bits(saved.keep1.to(torch.int32) & 0xFFFF, 16, 2, 4),
            _unfold_bits(saved.keep2, 8, 2, 2),
            ((keepd >> 4) & 1).bool()[:, None],
            _unfold_bits(keepd & 0xF, 4, 2, 1)]


def _ae2d_fwd_kernel(src, params, obs, drop_p, seed, save):
    """(err [N], AE2DSaved or None): the AE2D forward kernel on checked
    inputs; ``save`` also writes what its backward reads."""
    n, _, h, w = cell_shape(src)
    if src.dtype == torch.uint8 and src.data_ptr() % 4:
        raise ValueError("uint8 src must start on a 4-byte boundary (the AE2D kernel reads "
                         "its cells four at a time)")
    ry = _ae2d_plan(h, w)[0]
    save_keep = save and drop_p > 0.0
    dev = src.device
    ws = [t.contiguous() for t in params]
    partials = torch.empty((n, -(-h // ry)), dtype=torch.float32, device=dev)
    err = torch.empty((n,), dtype=torch.float32, device=dev)
    saved = None
    if save:
        keeps = ((torch.empty((n, h // 2, w // 2), dtype=torch.int16, device=dev),
                  torch.empty((n, h // 4, w // 4), dtype=torch.uint8, device=dev),
                  torch.empty((n, h // 2, w // 2), dtype=torch.uint8, device=dev))
                 if save_keep else (None, None, None))
        saved = AE2DSaved(torch.empty((n, 2, h // 4, w // 4), dtype=torch.float32, device=dev),
                          *keeps)
    device, stream = stream_args(src)
    AE2D_FWD.launch(src.data_ptr(), obs.data_ptr(), *(t.data_ptr() for t in ws),
                    partials.data_ptr(), err.data_ptr(), *(_ptr(t) for t in saved or (None,) * 4),
                    n, h, w, ry, _ae2d_fwd_smem(w, ry, save_keep), cell_kind(src),
                    cell_kind(obs), float(drop_p), _seed_word(seed), device, stream,
                    packed=_packed(src, obs))
    return err, saved


def _ae2d_bwd_kernel(src, params, obs, gbar, drop_p, saved: AE2DSaved):
    """The eight gradients from the AE2D training forward's ``saved`` (with
    the same params)."""
    n, _, h, w = cell_shape(src)
    _, (ry_dec, smem_dec), (ry_enc, smem_enc) = _ae2d_plan(h, w)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=src.device)
    gcm = empty(n, h // 2, w // 2)
    part_dec, part_enc = empty(n * -(-h // ry_dec), 50), empty(n * -(-h // ry_enc), 114)
    grads = empty(sum(math.prod(s) for s in _AE_SHAPES))
    device, stream = stream_args(src)
    ws = [t.contiguous() for t in (*params, gbar)]   # alive until the launch is enqueued
    AE2D_BWD.launch(src.data_ptr(), obs.data_ptr(), *(t.data_ptr() for t in ws[:8]),
                    *(_ptr(t) for t in saved), ws[8].data_ptr(), gcm.data_ptr(),
                    part_dec.data_ptr(), part_enc.data_ptr(), grads.data_ptr(), n, h, w,
                    ry_dec, ry_enc, smem_dec, smem_enc, cell_kind(src), cell_kind(obs),
                    float(drop_p), device, stream, packed=_packed(src, obs))
    return _split(grads, _AE_SHAPES)


def ae_loss_fwd(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs,
                pools: Tuple[int, int] = (2, 2), drop_p: float = 0.0,
                seed: int = 0) -> torch.Tensor:
    """The whole autoencoder and its per-instance squared error as one
    kernel on CUDA; the plain twin on the CPU.  The kernel takes src
    [N, 1, H, W] and obs [N, COUT, H, W] as uint8 cells or packed words (each
    on its own), pools (2, 2), H and W divisible by 4; the caller divides by
    C*H*W for the mean."""
    return _dispatch("ae_loss_fwd", src, ae_loss_fwd_plain, _ae_loss_fwd_kernel,
                     src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, pools, drop_p, seed)


def _ae_loss_fwd_kernel(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, pools, drop_p,
                        seed):
    return _ae_fwd_launch(src, (w1, b1, w2, b2, wt1, bt1, wt2, bt2), obs, pools, drop_p,
                          seed, False)[0]


def _ae_fwd_launch(src, params, obs, pools, drop_p, seed, save):
    """(err, AE2DSaved or None): the forward kernel of the widths' route;
    ``save`` (the AE2D route only) also keeps what its backward reads."""
    w1, b1, w2, b2, wt1, bt1, wt2, bt2 = params
    _check_drop(drop_p)
    n, h, w, c1, c2, cmid, cout = _ae_shape(src, w1, w2, wt1, wt2, obs, pools)
    _check_cuda_inputs(src, [("src", src), ("obs", obs)],
                       [("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
                        ("wt1", wt1), ("bt1", bt1), ("wt2", wt2), ("bt2", bt2)])
    if ae2d_route(h, w, (c1, c2, cmid, cout)):
        return _ae2d_fwd_kernel(src, params, obs, drop_p, seed, save)
    ry, smem = _ae_bands(h, w, c1, c2, cmid, cout)[0]
    bands = -(-h // ry)
    partials = torch.empty((n, bands), dtype=torch.float32, device=src.device)
    err = torch.empty((n,), dtype=torch.float32, device=src.device)
    ws = [t.contiguous() for t in (w1, b1, w2, b2, wt1, bt1, wt2, bt2)]
    device, stream = stream_args(src)
    AE_LOSS.launch(src.data_ptr(), obs.data_ptr(), *(t.data_ptr() for t in ws),
                   partials.data_ptr(), err.data_ptr(), n, h, w, c1, c2, cmid,
                   cout, ry, smem, cell_kind(src), cell_kind(obs), float(drop_p),
                   _seed_word(seed), device, stream, packed=_packed(src, obs))
    return err, None


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
    if not whole_ae_fits(h, w, c1, c2, cmid, cout):
        raise ValueError(f"{h}x{w} is too wide for the whole-AE backward kernels "
                         "(nets.conv_ae_loss composes encoder and decoder loss there)")
    if ae2d_route(h, w, (c1, c2, cmid, cout)):
        # the gradients alone: the saving forward draws the bits the backward reads
        params = (w1, b1, w2, b2, wt1, bt1, wt2, bt2)
        saved = _ae2d_fwd_kernel(src, params, obs, drop_p, seed, True)[1]
        return _ae2d_bwd_kernel(src, params, obs, gbar, drop_p, saved)
    ry, smem3 = _ae_bands(h, w, c1, c2, cmid, cout)[1]
    plan = _encoder_bwd_plan(n, h, w, c1, c2, 2, 2, src.device,
                             _encoder_bwd_whole(h, w, c1, c2))
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
                       plan["smem1"], cell_kind(src), cell_kind(obs), float(drop_p),
                       _seed_word(seed), device, stream, packed=_packed(src, obs))
    return _split(grads, shapes)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class EncoderFn(torch.autograd.Function):
    """encoder_fwd with encoder_bwd as its backward; saves the inputs and, on
    the specialised route with dropout, the keep bits its forward kernel
    drew, so the backward draws none.  The row mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, pools, drop_p, seed, mask):
        ctx.save_for_backward(x, w1, b1, w2, b2, mask)
        ctx.settings = (tuple(pools), float(drop_p), int(seed))
        if x.device.type == "cuda":
            out, ctx.enc3 = _encoder_fwd_launch(x, (w1, b1, w2, b2), *ctx.settings, mask, True)
            return out
        ctx.enc3 = None
        return encoder_fwd(x, w1, b1, w2, b2, *ctx.settings, mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        *inputs, mask = ctx.saved_tensors
        if ctx.enc3 is not None:
            x, *params = inputs
            pools, drop_p, _ = ctx.settings
            mask = _check_mask(mask, x, x.shape[0], cell_shape(x)[2] // pools[0])
            grads = _enc3_bwd_kernel(x, params, g, pools, drop_p, mask, ctx.enc3)
        else:
            grads = encoder_bwd(*inputs, g.contiguous(), *ctx.settings, mask)
        return (None, *grads, None, None, None, None)


class AELossFn(torch.autograd.Function):
    """ae_loss_fwd with ae_loss_bwd as its backward; saves the inputs and, on
    the AE2D route, what the forward kernel saved (the embedding and the keep
    bits), so the backward draws no dropout bit again."""

    @staticmethod
    def forward(ctx, src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, pools, drop_p, seed):
        ctx.save_for_backward(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs)
        ctx.settings = (tuple(pools), float(drop_p), int(seed))
        params = (w1, b1, w2, b2, wt1, bt1, wt2, bt2)
        if src.device.type == "cuda":
            err, ctx.ae2d = _ae_fwd_launch(src, params, obs, *ctx.settings, True)
            return err
        ctx.ae2d = None
        return ae_loss_fwd(src, *params, obs, *ctx.settings)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        if ctx.ae2d is not None:
            src, *params, obs = ctx.saved_tensors
            grads = _ae2d_bwd_kernel(src, params, obs, gbar, ctx.settings[1], ctx.ae2d)
        else:
            grads = ae_loss_bwd(*ctx.saved_tensors, gbar.contiguous(), *ctx.settings)
        return (None, *grads, None, None, None, None)


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def encoder(x, w1, b1, w2, b2, pools: Tuple[int, int], drop_p: float = 0.0,
            seed: int = 0, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused encoder, differentiable in its four parameters (the cells
    and the row mask carry no gradient).  Without a parameter that requires
    grad it is :func:`encoder_fwd` alone."""
    if _wants_grad((w1, b1, w2, b2)):
        return EncoderFn.apply(x, w1, b1, w2, b2, pools, drop_p, seed, mask)
    return encoder_fwd(x, w1, b1, w2, b2, pools, drop_p, seed, mask)


def ae_loss(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs,
            pools: Tuple[int, int] = (2, 2), drop_p: float = 0.0,
            seed: int = 0) -> torch.Tensor:
    """The fused autoencoder error, differentiable in its eight parameters."""
    params = (w1, b1, w2, b2, wt1, bt1, wt2, bt2)
    if _wants_grad(params):
        return AELossFn.apply(src, *params, obs, pools, drop_p, seed)
    return ae_loss_fwd(src, *params, obs, pools, drop_p, seed)
