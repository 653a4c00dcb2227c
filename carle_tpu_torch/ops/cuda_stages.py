"""The wrapper nets' single stages and the two-stage decoder loss: forward
and backward CUDA kernels and their plain PyTorch twins (counterpart of
carle_tpu/ops/pallas_head.py's ``make_fused_head``, ``make_fused_tail``,
``make_fused_loss_tail`` and ``make_fused_decoder_loss``).

* :func:`head` — ``pool(relu(drop(conv3x3(x))))``, pool a power of two; its
  backward gives dW, db and, with ``need_dx``, the input cotangent; a
  universe too wide for one band of the whole width (8192 cells at 1 -> 4
  channels) runs in column tiles (``_head_bands``).  At the package's three
  stage widths (C, O, pool) = (1, 4, 2), (1, 4, 4) and (4, 2, 2) it runs the
  kernels specialised for them: the forward ``csrc/head2_fwd.cu``
  (:func:`head_fwd_route`: cells by one lookup in copies of a table, four
  pool windows a thread stored 16 bytes a channel), the backward
  ``csrc/head2_bwd.cu`` (:func:`head_route`: one pass a pool window, stage 1
  on cells by table, gx in the same launch from a tile of gc with its halo
  recomputed, the blocks' sums added in a fixed order by the last block);
  other widths take the generic kernels;
* :func:`tail` — ``act(drop(conv_transpose2d(x)))`` (k4, s2, p1), act relu or
  sigmoid; backward dW, db, gx.  At the package's two stage widths (CIN,
  COUT) = (2, 1) and (1, 1) it runs the kernels specialised for them
  (``csrc/tail2_fwd.cu``, ``tail2_bwd.cu``; :func:`tail_route`): parity
  stencils, 16-byte stores, a training forward that saves its keep bits so
  the backward draws none, small blocks (:func:`_tail2_plan`); other widths
  take the generic kernel;
* :func:`loss_tail` — the tail fused with ``sum((obs - y)**2)`` per instance;
  at the tail's two stage widths it runs the kernels specialised for them
  (``csrc/loss_tail2_fwd.cu``, ``loss_tail2_bwd.cu``; :func:`loss_tail_route`):
  the tail's parity stencils, the obs staged beside the input window, the
  error summed in registers and a fixed order; the backward the tail's
  (``tail2_bwd.cuh``) with obs staged where g was; other widths take the
  generic kernels;
* :func:`decoder_loss` — both decoder stages fused with that error; backward
  the four parameter gradients and ``gx``, the embedding's cotangent, which
  flows on into :func:`cuda_head.encoder`'s backward.  Optional per-instance
  error row weights ``em`` [N, H] make it ``make_fused_decoder_loss_banded``;
  its kernels cut a universe too wide for one band of the whole width into
  column tiles (``cuda_head.TILE_CELLS`` forces them).  At the package's one
  decoder width (C2, CMID, COUT) = (2, 1, 1) it runs the kernels specialised
  for it (``csrc/dec2_fwd.cu``, ``dec2_bwd.cu``; :func:`decoder_route`):
  parity stencils, a training forward that saves its keep bits so the
  backward draws none, a backward that forms gx in its own band, rows of
  weight zero skipped; other widths take the generic kernels.

Each is a ``torch.autograd.Function`` that saves its inputs and the seed and
recomputes in the backward, launches its kernels (``csrc/head_fwd.cu``,
``head2_fwd.cu``, ``head_bwd.cu``, ``head2_bwd.cu``, ``tail.cu``, ``tail2_fwd.cu``,
``tail2_bwd.cu``, ``loss_tail2_fwd.cu``, ``loss_tail2_bwd.cu``,
``decoder_loss_fwd.cu``, ``decoder_loss_bwd.cu``)
for CUDA tensors and takes its plain twin (``*_plain``) for CPU tensors.

Dropout draws the Philox bit of the element at a dropout *stage*
(:data:`cuda_head.STAGE_ENC1` .. ``STAGE_DEC2``): the bit the whole-autoencoder
kernel draws for the same element, so with one seed the autoencoder built
from one, two or four kernels applies one mask.  Max-pool ties share the
gradient equally, so the backward twins are written out with
``cuda_head._pool_route`` rather than taken from ``F.max_pool2d``.

A head's x and a loss's obs may be the packed universe, uint32 words
[N, C, H, W/32], wherever they may be uint8 cells (``cuda_head.cells``).
``torch.nn.functional`` appears only in the plain twins.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import cuda_head
from .cuda_build import KERNELS, stream_args
from .cuda_ca import _multiprocessors
from .cuda_head import (MAX_CHANNELS, RED16_FLOATS, RED_FLOATS, SM_COUNT, SMEM_MAX,
                        SMEM_TARGET_BWD,
                        STAGE_DEC1, STAGE_DEC2, STAGE_ENC1, _ae_band_floats,
                        _check_drop, _check_mask, _conv_wgrad, _deconv_wgrad, _dispatch,
                        _dropout, _packed, _pick_band, _pick_by_cost, _pick_tile, _pool_route,
                        _ptr, _row_factor, _seed_word, _split, _unfold_bits, _wants_grad,
                        _widest_window, cell_kind, cell_shape, cells, philox_keep_mask)

HEAD_FWD, HEAD_BWD = KERNELS["head_fwd"], KERNELS["head_bwd"]
TAIL_FWD, TAIL_BWD = KERNELS["tail_fwd"], KERNELS["tail_bwd"]
LOSS_TAIL_FWD, LOSS_TAIL_BWD = KERNELS["loss_tail_fwd"], KERNELS["loss_tail_bwd"]
DECODER_LOSS_FWD, DECODER_LOSS_BWD = KERNELS["decoder_loss_fwd"], KERNELS["decoder_loss_bwd"]
DEC2_FWD, DEC2_BWD = KERNELS["dec2_fwd"], KERNELS["dec2_bwd"]
# The decoder loss at this width (C2, CMID, COUT) runs the kernels specialised
# for it (:func:`decoder_route`); False runs the generic kernels there too,
# to hold one against the other.
DEC2_WIDTHS = (2, 1, 1)
DEC2_KERNELS = True
DEC2_BLOCKS = (4, 3)   # csrc/dec2.cuh: resident blocks a multiprocessor, forward and backward
DEC2_PARTS = 50        # a block's partial gradients: dWt1, dbt1, dWt2, dbt2
TAIL2_FWD, TAIL2_BWD = KERNELS["tail2_fwd"], KERNELS["tail2_bwd"]
# One decoder stage at these widths (CIN, COUT) runs the kernels specialised
# for them (:func:`tail_route`); False runs the generic kernel there too, to
# hold one against the other.
TAIL2_WIDTHS = ((2, 1), (1, 1))
TAIL2_KERNELS = True
TAIL2_THREADS = 256                # csrc/tail2.cuh: threads a block
TAIL2_TILES = (128, 64)            # input columns a block, forward and backward
TAIL2_BANDS = ((16, 8, 4, 2, 1), (32, 16, 8, 4, 2, 1))   # input rows a block
TAIL2_WAVES = (2, 1)               # blocks a multiprocessor the plans' grids reach
LOSS_TAIL2_FWD, LOSS_TAIL2_BWD = KERNELS["loss_tail2_fwd"], KERNELS["loss_tail2_bwd"]
# The loss tail at TAIL2_WIDTHS runs the kernels specialised for them
# (:func:`loss_tail_route`); False runs the generic kernels there too, to hold
# one against the other.
LOSS_TAIL2_KERNELS = True
ACTS = {"relu": 0, "sigmoid": 1}    # csrc/tail.cu, csrc/tail2.cuh
HEAD_POOLS = (2, 4, 8)              # the head kernels' instantiations
HEAD2_FWD, HEAD2_BWD = KERNELS["head2_fwd"], KERNELS["head2_bwd"]
# The head at these widths (C, O, pool) runs the kernels specialised for them
# (:func:`head_fwd_route`, :func:`head_route`); False runs the generic
# kernels there too, to hold one against the other.
HEAD2_WIDTHS = ((1, 4, 2), (1, 4, 4), (4, 2, 2))
HEAD2_KERNELS = True
HEAD2_THREADS = 256     # csrc/head2.cuh: threads a block
HEAD2_BLOCKS = {1: 2, 4: 1}   # csrc/head2_bwd.cu::head2_blocks: blocks a multiprocessor by C
# csrc/head2_fwd.cu's HEAD2_FWD_CELL_BLOCKS, HEAD2_FWD_FLOAT_BLOCKS: blocks a
# multiprocessor on cells (True) and on floats
HEAD2_FWD_BLOCKS = {True: 3, False: 2}
HEAD2_TILE = 128        # pooled columns a tile at most
HEAD2_BANDS = (16, 8, 4, 2, 1)   # pooled rows a tile

__all__ = ["head", "tail", "loss_tail", "decoder_loss",
           "head_fwd", "head_fwd_plain", "head_bwd", "head_bwd_plain",
           "tail_fwd", "tail_fwd_plain", "tail_bwd", "tail_bwd_plain",
           "loss_tail_fwd", "loss_tail_fwd_plain", "loss_tail_bwd", "loss_tail_bwd_plain",
           "decoder_loss_fwd", "decoder_loss_fwd_plain", "decoder_loss_bwd",
           "decoder_loss_bwd_plain", "DEC2_FWD", "DEC2_BWD", "DEC2_WIDTHS", "DEC2_KERNELS",
           "Dec2Saved", "decoder_route", "dec2_keep_masks", "TAIL2_FWD", "TAIL2_BWD",
           "TAIL2_WIDTHS", "TAIL2_KERNELS", "tail_route", "tail2_keep_mask", "LOSS_TAIL2_FWD",
           "LOSS_TAIL2_BWD", "LOSS_TAIL2_KERNELS", "loss_tail_route", "HEAD2_FWD", "HEAD2_BWD",
           "HEAD2_WIDTHS", "HEAD2_KERNELS", "head_fwd_route", "head_route"]


def _check_pool(pool: int) -> None:
    if pool < 2 or pool & (pool - 1):
        raise ValueError(f"pool must be a power of two >= 2, got {pool}")


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"act must be 'relu' or 'sigmoid', got {act!r}")


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _head_planes(x, w, b, pool, drop_p, seed, stage):
    _check_pool(pool)
    _check_drop(drop_p)
    xf = cells(x).to(torch.float32)
    d, scale = _dropout(F.conv2d(xf, w, b, padding=1), stage, drop_p, seed)
    return xf, d, scale


def head_fwd_plain(x, w, b, pool: int, drop_p: float = 0.0, seed: int = 0,
                   stage: int = STAGE_ENC1) -> torch.Tensor:
    """``pool(relu(drop(conv3x3(x) + b)))``, zero padding 1: x [N, C, H, W]
    float32 or uint8 -> float32 [N, O, H/pool, W/pool]."""
    return F.max_pool2d(F.relu(_head_planes(x, w, b, pool, drop_p, seed, stage)[1]), pool)


def head_bwd_plain(x, w, b, g, pool: int, drop_p: float = 0.0, seed: int = 0,
                   stage: int = STAGE_ENC1, need_dx: bool = False):
    """(dW, db, gx) of :func:`head_fwd_plain` for the output cotangent g, pool
    ties sharing equally; gx is None without ``need_dx``."""
    xf, d, scale = _head_planes(x, w, b, pool, drop_p, seed, stage)
    gc = _pool_route(d, g, pool, scale)
    gx = F.conv_transpose2d(gc, w, padding=1) if need_dx else None
    return _conv_wgrad(xf, gc), gc.sum(dim=(0, 2, 3)), gx


def _tail_planes(x, wt, b, act, drop_p, seed, stage):
    """(dropped pre-activation, activation, scale) of a decoder stage."""
    _check_act(act)
    _check_drop(drop_p)
    d, scale = _dropout(F.conv_transpose2d(x, wt, b, stride=2, padding=1), stage,
                        drop_p, seed)
    return d, (F.relu(d) if act == "relu" else torch.sigmoid(d)), scale


def _tail_backward(x, wt, d, y, g, act, drop_p, seed, stage, scale):
    """(dW, db, gx) of a decoder stage from the cotangent g of its activation."""
    if act == "relu":  # a positive pre-activation was kept by the dropout
        gz = torch.where(d > 0, g * scale, torch.zeros_like(g))
    else:
        gz = g * y * (1.0 - y)
        if drop_p > 0.0:
            keep = philox_keep_mask(seed, stage, d.shape, drop_p, d.device)
            gz = torch.where(keep, gz * scale, torch.zeros_like(gz))
    return (_deconv_wgrad(x, gz), gz.sum(dim=(0, 2, 3)),
            F.conv2d(gz, wt, stride=2, padding=1))


def tail_fwd_plain(x, wt, b, act: str, drop_p: float = 0.0, seed: int = 0,
                   stage: int = STAGE_DEC1) -> torch.Tensor:
    """``act(drop(conv_transpose2d(x, wt) + b))`` (k4, s2, p1): x [N, Cin, h, w]
    -> [N, Cout, 2h, 2w]."""
    return _tail_planes(x, wt, b, act, drop_p, seed, stage)[1]


def tail_bwd_plain(x, wt, b, g, act: str, drop_p: float = 0.0, seed: int = 0,
                   stage: int = STAGE_DEC1):
    """(dW, db, gx) of :func:`tail_fwd_plain` for the output cotangent g."""
    d, y, scale = _tail_planes(x, wt, b, act, drop_p, seed, stage)
    return _tail_backward(x, wt, d, y, g, act, drop_p, seed, stage, scale)


def _squared_error(obs, y, em=None):
    sq = (cells(obs).to(torch.float32) - y) ** 2
    return (sq if em is None else _row_factor(em) * sq).sum(dim=(1, 2, 3))


def _error_cotangent(obs, y, gbar, em=None):
    g = gbar.view(-1, 1, 1, 1) * (2.0 * (y - cells(obs).to(torch.float32)))
    return g if em is None else g * _row_factor(em)


def loss_tail_fwd_plain(x, wt, b, obs, act: str = "sigmoid", drop_p: float = 0.0,
                        seed: int = 0, stage: int = STAGE_DEC2) -> torch.Tensor:
    """Per-instance ``sum((obs - tail(x))**2)`` over C, H, W -> float32 [N]."""
    return _squared_error(obs, _tail_planes(x, wt, b, act, drop_p, seed, stage)[1])


def loss_tail_bwd_plain(x, wt, b, obs, gbar, act: str = "sigmoid", drop_p: float = 0.0,
                        seed: int = 0, stage: int = STAGE_DEC2):
    """(dW, db, gx) of :func:`loss_tail_fwd_plain` for the cotangent gbar [N]."""
    d, y, scale = _tail_planes(x, wt, b, act, drop_p, seed, stage)
    return _tail_backward(x, wt, d, y, _error_cotangent(obs, y, gbar), act, drop_p,
                          seed, stage, scale)


def decoder_loss_fwd_plain(x, wt1, b1, wt2, b2, obs, drop_p: float = 0.0,
                           seed: int = 0, em: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-instance ``sum(em * (obs - sigmoid_tail(relu_tail(x)))**2)`` -> [N];
    ``em`` [N, H] weighs each output row (None: all ones)."""
    mid = tail_fwd_plain(x, wt1, b1, "relu", drop_p, seed, STAGE_DEC1)
    y = _tail_planes(mid, wt2, b2, "sigmoid", drop_p, seed, STAGE_DEC2)[1]
    return _squared_error(obs, y, em)


def decoder_loss_bwd_plain(x, wt1, b1, wt2, b2, obs, gbar, drop_p: float = 0.0,
                           seed: int = 0, em: Optional[torch.Tensor] = None):
    """(dWt1, dbt1, dWt2, dbt2, gx) of :func:`decoder_loss_fwd_plain`."""
    mid = tail_fwd_plain(x, wt1, b1, "relu", drop_p, seed, STAGE_DEC1)
    d, y, scale = _tail_planes(mid, wt2, b2, "sigmoid", drop_p, seed, STAGE_DEC2)
    dwt2, dbt2, gmid = _tail_backward(mid, wt2, d, y, _error_cotangent(obs, y, gbar, em),
                                      "sigmoid", drop_p, seed, STAGE_DEC2, scale)
    dwt1, dbt1, gx = tail_bwd_plain(x, wt1, b1, gmid, "relu", drop_p, seed, STAGE_DEC1)
    return dwt1, dbt1, dwt2, dbt2, gx


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_tensors(ref: torch.Tensor, floats, frames=()) -> None:
    """``floats``: (name, tensor) that must be float32 on ref's device;
    ``frames``: the same for tensors the kernels read as uint8 or float32, or
    as packed uint32 words."""
    for name, t in floats:
        if t.dtype != torch.float32 or t.device != ref.device:
            raise ValueError(f"{name} must be float32 on {ref.device}")
    for name, t in frames:
        if t.dtype not in (torch.uint8, torch.float32, torch.uint32) or t.device != ref.device:
            raise ValueError(f"{name} must be uint8, float32 or packed uint32 on "
                             f"{ref.device}")


def _check_instances(n: int) -> None:
    if n > 65535:
        raise ValueError("at most 65535 instances a launch")


def _empty(ref: torch.Tensor, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=ref.device)


# -- head --------------------------------------------------------------------


def _head_fwd_smem(c, o, t, pool, r) -> int:
    """csrc/head_fwd.cu::head_fwd_smem: a band of r output rows and a tile
    of t output columns."""
    return 4 * (o * c * 9 + o + c * (r * pool + 2) * (t * pool + 2))


def _head_bwd_smem(c, o, t, pool, r) -> int:
    """csrc/head_bwd.cu::head_bwd_smem."""
    return _head_fwd_smem(c, o, t, pool, r) + 4 * (o * r * pool * t * pool + RED_FLOATS)


@functools.lru_cache(maxsize=None)
def _head_bands(c, o, h, w, pool, cells=None):
    """(R output rows a band, TC output columns a tile, shared memory) of the
    head's forward and of its backward kernel: the whole width where one band
    of it fits, else column tiles (``cells`` forces tiles of at most that
    many cells)."""
    return (_pick_tile(lambda r, t: _head_fwd_smem(c, o, t, pool, r), h // pool, (8, 4, 2, 1),
                       w // pool, pool, cells=cells),
            _pick_tile(lambda r, t: _head_bwd_smem(c, o, t, pool, r), h // pool, (8, 4, 2, 1),
                       w // pool, pool, SMEM_TARGET_BWD, cells))


def _head_shape(x, w, b, pool):
    _check_pool(pool)
    n, c, h, wd = cell_shape(x)
    o = w.shape[0]
    if pool not in HEAD_POOLS:
        raise ValueError(f"the head kernels take pool in {HEAD_POOLS}, got {pool}")
    if tuple(w.shape) != (o, c, 3, 3) or tuple(b.shape) != (o,):
        raise ValueError(f"head weights must be [O,{c},3,3] and [O]; got "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if max(c, o) > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels a stage")
    if h % pool or wd % pool:
        raise ValueError(f"{h}x{wd} is not divisible by the pool {pool}")
    _check_instances(n)
    return n, c, o, h, wd


def head_fwd(x, w, b, pool: int, drop_p: float = 0.0, seed: int = 0,
             stage: int = STAGE_ENC1) -> torch.Tensor:
    """One conv stage as one kernel on CUDA (x float32 or uint8, pool 2, 4 or
    8); the plain twin on the CPU."""
    return _dispatch("head_fwd", x, head_fwd_plain, _head_fwd_kernel,
                     x, w, b, pool, drop_p, seed, stage)


def _head_fwd_kernel(x, w, b, pool, drop_p, seed, stage):
    _check_drop(drop_p)
    n, c, o, h, wd = _head_shape(x, w, b, pool)
    _check_tensors(x, [("w", w), ("b", b)], [("x", x)])
    if head_fwd_route(c, o, pool, wd, cell_kind(x)):
        return _head2_fwd_kernel(x, w, b, pool, drop_p, seed, stage)
    r, tc, smem = _head_bands(c, o, h, wd, pool, cuda_head.TILE_CELLS)[0]
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    out = _empty(x, n, o, h // pool, wd // pool)
    device, stream = stream_args(x)
    HEAD_FWD.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, c, o, h,
                    wd, pool, r, tc, smem, cell_kind(x), int(stage),
                    float(drop_p), _seed_word(seed), device, stream, packed=_packed(x))
    return out


def head_bwd(x, w, b, g, pool: int, drop_p: float = 0.0, seed: int = 0,
             stage: int = STAGE_ENC1, need_dx: bool = False):
    """(dW, db, gx) for the cotangent g of :func:`head_fwd`'s output; gx is
    None without ``need_dx``."""
    return _dispatch("head_bwd", x, head_bwd_plain, _head_bwd_kernel,
                     x, w, b, g, pool, drop_p, seed, stage, need_dx)


def _head_bwd_kernel(x, w, b, g, pool, drop_p, seed, stage, need_dx):
    _check_drop(drop_p)
    n, c, o, h, wd = _head_shape(x, w, b, pool)
    _check_tensors(x, [("w", w), ("b", b), ("g", g)], [("x", x)])
    if tuple(g.shape) != (n, o, h // pool, wd // pool):
        raise ValueError(f"g shape {tuple(g.shape)} is not the head's output's")
    if head_route(c, o, pool, wd, cell_kind(x), need_dx):
        return _head2_bwd_kernel(x, w, b, g, pool, drop_p, seed, stage, need_dx)
    r, tc, smem = _head_bands(c, o, h, wd, pool, cuda_head.TILE_CELLS)[1]
    bands = -(-(h // pool) // r) * -(-(wd // pool) // tc)   # blocks a universe
    x, w, b, g = x.contiguous(), w.contiguous(), b.contiguous(), g.contiguous()
    shapes = ((o, c, 3, 3), (o,))
    grads = _empty(x, o * c * 9 + o)
    partials = _empty(x, n * bands, o * c * 9 + o)
    gc = _empty(x, n, o, h, wd) if need_dx else None
    gx = _empty(x, n, c, h, wd) if need_dx else None
    device, stream = stream_args(x)
    HEAD_BWD.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
                    gc.data_ptr() if need_dx else None, partials.data_ptr(),
                    grads.data_ptr(), gx.data_ptr() if need_dx else None, n, c, o, h, wd,
                    pool, r, tc, smem, cell_kind(x), int(stage), float(drop_p),
                    _seed_word(seed), device, stream, packed=_packed(x))
    return (*_split(grads, shapes), gx)


# -- the head at the package's three stage widths (csrc/head2_fwd.cu, head2_bwd.cu)


def head_fwd_route(c: int, o: int, pool: int, w: int, kind: int) -> bool:
    """Whether the head's forward with ``c`` -> ``o`` channels at ``pool`` on
    x of cell kind ``kind`` and width ``w`` runs the kernel specialised for
    its widths (csrc/head2_fwd.cu::head2_fwd_takes): the first stage (1, 4)
    on cells (uint8 rows whole 4-byte words) at pool 2 or 4 or on floats at
    pool 2; the second (4, 2) at pool 2 on floats."""
    if not HEAD2_KERNELS or (c, o, pool) not in HEAD2_WIDTHS:
        return False
    if c == 4:
        return kind == 0
    return kind == 2 or (kind == 1 and w % 4 == 0) or (kind == 0 and pool == 2)


def head_route(c: int, o: int, pool: int, w: int, kind: int, need_dx: bool) -> bool:
    """Whether the head's backward with ``c`` -> ``o`` channels at ``pool``
    on x of cell kind ``kind`` (:func:`cuda_head.cell_kind`) and width ``w``
    runs the kernel specialised for its widths (csrc/head2_bwd.cu::
    head2_takes): the first stage (1, 4) on cells (uint8 rows whole 4-byte
    words) at pool 2 or 4 or on floats at pool 2, without an input
    cotangent; the second (4, 2) at pool 2 on floats, with or without."""
    if not HEAD2_KERNELS or (c, o, pool) not in HEAD2_WIDTHS:
        return False
    if c == 4:
        return kind == 0
    return not need_dx and (kind == 2 or (kind == 1 and w % 4 == 0) or (kind == 0 and pool == 2))


def _head2_bwd_smem(c, o, pool, binary, need_dx, rb, tw) -> int:
    """csrc/head2_bwd.cu::head2_bwd_smem."""
    red = 4 * HEAD2_THREADS // 32 * (o * c * 9 + o)
    if binary:
        words = (pool * tw + 2 + 62) // 32 + 1
        return 4 * 512 * o + 512 * (8 if pool == 4 else 4) + 4 * (pool * rb + 2) * words + red
    h = int(need_dx)
    xr, xw = 2 * (rb + 2 * h) + 2, 2 * (tw + 2 * h) + 2
    return 4 * (c * xr * xw + (o * 2 * (rb + 2) * 2 * (tw + 2) if need_dx else 0)) + red


@functools.lru_cache(maxsize=None)
def _head2_plan(n: int, c: int, o: int, pool: int, h: int, w: int, binary: bool,
                need_dx: bool, sms: int = SM_COUNT):
    """(RB pooled rows, TW pooled columns, blocks) of a launch of the
    specialised backward on n instances of [h, w], c -> o channels at ``pool``
    (``binary``: cells, staged as bits): tiles of at most HEAD2_TILE pooled
    columns, then the most rows in HEAD2_BANDS whose shared memory fits and
    whose tiles still number at least the resident blocks (HEAD2_BLOCKS[c] a
    multiprocessor; the fewest rows that fit where none do), and one block a
    resident slot (a block a tile where the tiles are fewer).  Taller tiles
    share their table and their ring of recomputed windows over more windows;
    on an H100 the tallest such tiles timed best at the three widths' main
    shapes (scripts/port_ab.py head-times)."""
    return _head2_tiles(n, h // pool, w // pool, HEAD2_BLOCKS[c] * sms,
                        lambda rb, tw: _head2_bwd_smem(c, o, pool, binary, need_dx, rb, tw))


def _head2_tiles(n, ho, wo, slots, smem_of):
    """(RB, TW, blocks) of :func:`_head2_plan`'s rule for ``slots`` resident
    blocks and a block's shared memory ``smem_of(rb, tw)``."""
    tw = min(wo, HEAD2_TILE)
    fits = [rb for rb in HEAD2_BANDS if smem_of(rb, tw) <= SMEM_MAX]
    rb = next((rb for rb in fits if n * -(-ho // rb) * -(-wo // tw) >= slots), fits[-1])
    return rb, tw, min(n * -(-ho // rb) * -(-wo // tw), slots)


def _head2_fwd_smem(c, o, pool, binary, rb, tw) -> int:
    """csrc/head2_fwd.cu::head2_fwd_smem: on cells 9 tables (8 copies and the
    one they are copied from)."""
    if binary:
        return 4 * 512 * o * 9 + 4 * (pool * rb + 2) * ((pool * tw + 2 + 62) // 32 + 1)
    return 4 * c * (2 * rb + 2) * (2 * tw + 2)


@functools.lru_cache(maxsize=None)
def _head2_fwd_plan(n: int, c: int, o: int, pool: int, h: int, w: int, binary: bool,
                    sms: int = SM_COUNT):
    """(RB pooled rows, TW pooled columns, blocks) of a launch of the
    specialised forward: :func:`_head2_plan`'s rule with the forward's shared
    memory and HEAD2_FWD_BLOCKS[binary] resident blocks a multiprocessor."""
    return _head2_tiles(n, h // pool, w // pool, HEAD2_FWD_BLOCKS[binary] * sms,
                        lambda rb, tw: _head2_fwd_smem(c, o, pool, binary, rb, tw))


def _head2_fwd_kernel(x, w, b, pool, drop_p, seed, stage, plan=None):
    """The specialised forward on checked inputs at a width
    :func:`head_fwd_route` takes; ``plan`` (RB, TW, blocks) overrides
    :func:`_head2_fwd_plan`."""
    (n, c, h, wd), o = cell_shape(x), w.shape[0]
    kind = cell_kind(x)
    rb, tw, grid = plan or _head2_fwd_plan(n, c, o, pool, h, wd, kind != 0,
                                           _multiprocessors(x.device))
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    out = _empty(x, n, o, h // pool, wd // pool)
    device, stream = stream_args(x)
    HEAD2_FWD.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, c, o, h, wd,
                     pool, rb, tw, grid, _head2_fwd_smem(c, o, pool, kind != 0, rb, tw), kind,
                     int(stage), float(drop_p), _seed_word(seed), device, stream,
                     packed=_packed(x))
    return out


def _head2_bwd_kernel(x, w, b, g, pool, drop_p, seed, stage, need_dx, plan=None):
    """(dW, db, gx) from the specialised backward on checked inputs at a width
    :func:`head_route` takes; ``plan`` (RB, TW, blocks) overrides
    :func:`_head2_plan`."""
    (n, c, h, wd), o = cell_shape(x), w.shape[0]
    kind = cell_kind(x)
    rb, tw, grid = plan or _head2_plan(n, c, o, pool, h, wd, kind != 0, need_dx,
                                       _multiprocessors(x.device))
    k = o * c * 9 + o
    x, w, b, g = x.contiguous(), w.contiguous(), b.contiguous(), g.contiguous()
    grads, partials = _empty(x, k), _empty(x, grid, k)
    counter = torch.empty((1,), dtype=torch.int32, device=x.device)
    gx = _empty(x, n, c, h, wd) if need_dx else None
    device, stream = stream_args(x)
    HEAD2_BWD.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), _ptr(gx),
                     partials.data_ptr(), counter.data_ptr(), grads.data_ptr(), n, c, o, h, wd,
                     pool, rb, tw, grid,
                     _head2_bwd_smem(c, o, pool, kind != 0, need_dx, rb, tw), kind,
                     int(stage), float(drop_p), _seed_word(seed), device, stream,
                     packed=_packed(x))
    return (*_split(grads, ((o, c, 3, 3), (o,))), gx)


# -- tail and loss tail --------------------------------------------------------


def _tail_fwd_smem(cin, cout, w, ry) -> int:
    """csrc/tail.cu::tail_fwd_smem."""
    return 4 * (cin * cout * 16 + cout + cin * (ry // 2 + 2) * w + 32)


def _tail_bwd_smem(cin, cout, w, ri) -> int:
    """csrc/tail.cu::tail_bwd_smem."""
    return 4 * (cin * cout * 16 + cout + cin * (ri + 2) * w
                + cout * (2 * ri + 2) * (2 * w + 2) + RED16_FLOATS)


@functools.lru_cache(maxsize=None)
def _tail_bands(cin, cout, h, w):
    """(RY, shared memory) of the tail's forward kernel, (RI, shared memory)
    of its backward kernel; h and w are the input's."""
    return (_pick_band(lambda r: _tail_fwd_smem(cin, cout, w, r), 2 * h, (16, 8, 4, 2)),
            _pick_band(lambda r: _tail_bwd_smem(cin, cout, w, r), h, (8, 4, 2, 1),
                       SMEM_TARGET_BWD))


def _tail_shape(x, wt, b, act):
    _check_act(act)
    n, cin, h, w = x.shape
    cout = wt.shape[1]
    if tuple(wt.shape) != (cin, cout, 4, 4) or tuple(b.shape) != (cout,):
        raise ValueError(f"tail weights must be [{cin},O,4,4] and [O]; got "
                         f"{tuple(wt.shape)}, {tuple(b.shape)}")
    if max(cin, cout) > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels a stage")
    _check_instances(n)
    return n, cin, cout, h, w


def _check_obs(obs, shape) -> None:
    if cell_shape(obs) != tuple(shape):
        raise ValueError(f"obs cells {cell_shape(obs)} != {tuple(shape)}")


def tail_fwd(x, wt, b, act: str, drop_p: float = 0.0, seed: int = 0,
             stage: int = STAGE_DEC1) -> torch.Tensor:
    """One decoder stage as one kernel on CUDA; the plain twin on the CPU."""
    return _dispatch("tail_fwd", x, tail_fwd_plain, _tail_fwd_kernel,
                     x, wt, b, act, drop_p, seed, stage)


def _tail_fwd_kernel(x, wt, b, act, drop_p, seed, stage):
    return _tail_fwd_launch(x, wt, b, act, drop_p, seed, stage, False)[0]


def _tail_fwd_launch(x, wt, b, act, drop_p, seed, stage, save):
    """(y, keep bits or None): the forward kernel of the widths' route;
    ``save`` (the specialised route, with dropout) also keeps the bits its
    backward reads."""
    _check_drop(drop_p)
    n, cin, cout, h, w = _tail_shape(x, wt, b, act)
    _check_tensors(x, [("x", x), ("wt", wt), ("b", b)])
    if tail_route(cin, cout, w):
        return _tail2_fwd_kernel(x, wt, b, act, drop_p, seed, stage, save)
    ry, smem = _tail_bands(cin, cout, h, w)[0]
    x, wt, b = x.contiguous(), wt.contiguous(), b.contiguous()
    out = _empty(x, n, cout, 2 * h, 2 * w)
    device, stream = stream_args(x)
    TAIL_FWD.launch(x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(), n, cin, cout,
                    h, w, ry, smem, ACTS[act], int(stage), float(drop_p), _seed_word(seed),
                    device, stream)
    return out, None


def tail_bwd(x, wt, b, g, act: str, drop_p: float = 0.0, seed: int = 0,
             stage: int = STAGE_DEC1):
    """(dW, db, gx) for the cotangent g of :func:`tail_fwd`'s output."""
    return _dispatch("tail_bwd", x, tail_bwd_plain, _tail_bwd_kernel,
                     x, wt, b, g, act, drop_p, seed, stage)


def _tail_bwd_launch(kernel, x, wt, b, up, gbar, act, drop_p, seed, stage, extra):
    """The tail's or the loss tail's backward launch: ``up`` is g or obs,
    ``extra`` the launcher's integers between act and stage."""
    n, cin, cout, h, w = _tail_shape(x, wt, b, act)
    ri, smem = _tail_bands(cin, cout, h, w)[1]
    bands = -(-h // ri)
    x, wt, b, up = x.contiguous(), wt.contiguous(), b.contiguous(), up.contiguous()
    k = cin * cout * 16 + cout
    grads, partials, gx = _empty(x, k), _empty(x, n * bands, k), _empty(x, n, cin, h, w)
    ups = (up.data_ptr(),) if gbar is None else (up.data_ptr(), gbar.contiguous().data_ptr())
    device, stream = stream_args(x)
    kernel.launch(x.data_ptr(), wt.data_ptr(), b.data_ptr(), *ups, partials.data_ptr(),
                  grads.data_ptr(), gx.data_ptr(), n, cin, cout, h, w, ri, smem, ACTS[act],
                  *extra, int(stage), float(drop_p), _seed_word(seed), device, stream,
                  packed=_packed(up))
    return (*_split(grads, ((cin, cout, 4, 4), (cout,))), gx)


def _tail_bwd_kernel(x, wt, b, g, act, drop_p, seed, stage):
    _check_drop(drop_p)
    n, cin, cout, h, w = _tail_shape(x, wt, b, act)
    _check_tensors(x, [("x", x), ("wt", wt), ("b", b), ("g", g)])
    if tuple(g.shape) != (n, cout, 2 * h, 2 * w):
        raise ValueError(f"g shape {tuple(g.shape)} is not the tail's output's")
    if tail_route(cin, cout, w):
        return _tail2_bwd_kernel(x, wt, b, g, act, drop_p, seed, stage)
    return _tail_bwd_launch(TAIL_BWD, x, wt, b, g, None, act, drop_p, seed, stage, ())


def loss_tail_fwd(x, wt, b, obs, act: str = "sigmoid", drop_p: float = 0.0,
                  seed: int = 0, stage: int = STAGE_DEC2) -> torch.Tensor:
    """A decoder stage and its per-instance squared error against obs (uint8
    or float32 [N, Cout, 2h, 2w]) as one kernel on CUDA; the plain twin on the
    CPU.  The caller divides by C*H*W for the mean."""
    return _dispatch("loss_tail_fwd", x, loss_tail_fwd_plain, _loss_tail_fwd_kernel,
                     x, wt, b, obs, act, drop_p, seed, stage)


def _loss_tail_fwd_kernel(x, wt, b, obs, act, drop_p, seed, stage):
    _check_drop(drop_p)
    n, cin, cout, h, w = _tail_shape(x, wt, b, act)
    _check_tensors(x, [("x", x), ("wt", wt), ("b", b)], [("obs", obs)])
    _check_obs(obs, (n, cout, 2 * h, 2 * w))
    if loss_tail_route(cin, cout, w):
        return _loss_tail2_fwd_kernel(x, wt, b, obs, act, drop_p, seed, stage)
    ry, smem = _tail_bands(cin, cout, h, w)[0]
    x, wt, b, obs = x.contiguous(), wt.contiguous(), b.contiguous(), obs.contiguous()
    partials, err = _empty(x, n, -(-2 * h // ry)), _empty(x, n)
    device, stream = stream_args(x)
    LOSS_TAIL_FWD.launch(x.data_ptr(), wt.data_ptr(), b.data_ptr(), obs.data_ptr(),
                         partials.data_ptr(), err.data_ptr(), n, cin, cout, h, w, ry, smem,
                         ACTS[act], cell_kind(obs), int(stage),
                         float(drop_p), _seed_word(seed), device, stream, packed=_packed(obs))
    return err


def loss_tail_bwd(x, wt, b, obs, gbar, act: str = "sigmoid", drop_p: float = 0.0,
                  seed: int = 0, stage: int = STAGE_DEC2):
    """(dW, db, gx) for the cotangent gbar [N] of :func:`loss_tail_fwd`'s
    error."""
    return _dispatch("loss_tail_bwd", x, loss_tail_bwd_plain, _loss_tail_bwd_kernel,
                     x, wt, b, obs, gbar, act, drop_p, seed, stage)


def _loss_tail_bwd_kernel(x, wt, b, obs, gbar, act, drop_p, seed, stage):
    _check_drop(drop_p)
    n, cin, cout, h, w = _tail_shape(x, wt, b, act)
    _check_tensors(x, [("x", x), ("wt", wt), ("b", b), ("gbar", gbar)], [("obs", obs)])
    _check_obs(obs, (n, cout, 2 * h, 2 * w))
    if tuple(gbar.shape) != (n,):
        raise ValueError(f"gbar shape {tuple(gbar.shape)} != {(n,)}")
    if loss_tail_route(cin, cout, w):
        return _loss_tail2_bwd_kernel(x, wt, b, obs, gbar, act, drop_p, seed, stage)
    return _tail_bwd_launch(LOSS_TAIL_BWD, x, wt, b, obs, gbar, act, drop_p, seed, stage,
                            (cell_kind(obs),))


# -- the tail at the package's two stage widths (csrc/tail2.cuh) ----------------


def _tail2_fwd_smem(cin: int, w: int, ri: int, tj: int) -> int:
    """csrc/tail2.cuh::tail2_fwd_smem."""
    return 4 * cin * (ri + 2) * (min(tj, w) + 2)


def _tail2_bwd_smem(cin: int, w: int, ri: int, tj: int) -> int:
    """csrc/tail2.cuh::tail2_bwd_smem."""
    t = min(tj, w)
    return (4 * ((2 * ri + 4) * (2 * t + 8) + cin * (ri + 4) * (t + 6)
                 + TAIL2_THREADS // 32 * (16 * cin + 1)) + (ri + 2) * (t + 4))


@functools.lru_cache(maxsize=None)
def _tail2_plan(n: int, cin: int, h: int, w: int, backward: bool, sms: int = SM_COUNT):
    """(RI input rows, TJ input columns, shared memory) of a block of the
    specialised forward or backward on n instances of input [h, w] on a card
    of ``sms`` multiprocessors: tiles of TAIL2_TILES columns (the whole width
    where narrower), then the most rows in TAIL2_BANDS whose grid still gives
    every multiprocessor TAIL2_WAVES blocks (the fewest rows where none
    does).  Larger blocks share their halo and their partial sums over more
    outputs; the sizes were chosen by timing plans at the main paths' shapes
    on an H100.  The windows stay small, so shared memory never keeps a
    multiprocessor below the blocks its registers allow."""
    tj = min(w, TAIL2_TILES[int(backward)])
    tiles = -(-w // tj)
    for ri in TAIL2_BANDS[int(backward)]:
        if n * -(-h // ri) * tiles >= TAIL2_WAVES[int(backward)] * sms:
            break
    smem_of = _tail2_bwd_smem if backward else _tail2_fwd_smem
    return ri, tj, smem_of(cin, w, ri, tj)


def tail_route(cin: int, cout: int, w: int) -> bool:
    """Whether the tail with ``cin`` -> ``cout`` channels and input width
    ``w`` runs the kernels specialised for its widths (csrc/tail2_fwd.cu,
    tail2_bwd.cu; their 16-byte stores take an even width): the widths and the
    shape decide, on any device, so the forward and the backward take one
    route."""
    return TAIL2_KERNELS and (cin, cout) in TAIL2_WIDTHS and w % 2 == 0


def loss_tail_route(cin: int, cout: int, w: int) -> bool:
    """Whether the loss tail with ``cin`` -> ``cout`` channels and input width
    ``w`` runs the kernels specialised for its widths (csrc/loss_tail2_fwd.cu,
    loss_tail2_bwd.cu): the tail's widths at an even width, in both
    directions."""
    return LOSS_TAIL2_KERNELS and (cin, cout) in TAIL2_WIDTHS and w % 2 == 0


def tail2_keep_mask(keep: torch.Tensor) -> torch.Tensor:
    """The keep mask a training forward on the specialised route saved (uint8
    [N, h, w], bit 2a + b the output (2i + a, 2j + b)) in
    :func:`philox_keep_mask`'s layout [N, 1, 2h, 2w]."""
    return _unfold_bits(keep.to(torch.int32) & 0xF, 4, 2, 1)


def _tail2_fwd_kernel(x, wt, b, act, drop_p, seed, stage, save=False, plan=None):
    """(y [N, 1, 2h, 2w], keep bits or None): the specialised forward on
    checked inputs; ``save`` with dropout also writes the keep bits (uint8
    [N, h, w]); ``plan`` (RI, TJ) overrides :func:`_tail2_plan`."""
    n, cin, h, w = x.shape
    ri, tj = plan or _tail2_plan(n, cin, h, w, False, _multiprocessors(x.device))[:2]
    keep = (torch.empty((n, h, w), dtype=torch.uint8, device=x.device)
            if save and drop_p > 0.0 else None)
    x, wt, b = x.contiguous(), wt.contiguous(), b.contiguous()
    out = _empty(x, n, 1, 2 * h, 2 * w)
    device, stream = stream_args(x)
    TAIL2_FWD.launch(x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(keep), n,
                     cin, h, w, ri, tj, _tail2_fwd_smem(cin, w, ri, tj), ACTS[act], int(stage),
                     float(drop_p), _seed_word(seed), device, stream)
    return out, keep


def _loss_tail2_smem(kind: int, cin: int, w: int, ri: int, tj: int) -> int:
    """csrc/loss_tail2_fwd.cu::loss_tail2_smem: the input window, then the obs
    tile (2 ri rows of 4-byte units) 16-byte aligned."""
    t = min(tj, w)
    units = {1: t // 2, 0: 2 * t, 2: 2 * t // 32 + 2}[kind]
    return -(-_tail2_fwd_smem(cin, w, ri, tj) // 16) * 16 + 4 * units * 2 * ri


def _loss_tail2_fwd_kernel(x, wt, b, obs, act, drop_p, seed, stage, plan=None):
    """err [N] from the specialised loss-tail forward on checked inputs;
    ``plan`` (RI, TJ) overrides :func:`_tail2_plan` (the forward's)."""
    n, cin, h, w = x.shape
    ri, tj = plan or _tail2_plan(n, cin, h, w, False, _multiprocessors(x.device))[:2]
    blocks = -(-h // ri) * -(-w // min(tj, w))
    x, wt, b, obs = x.contiguous(), wt.contiguous(), b.contiguous(), obs.contiguous()
    if obs.data_ptr() % 16:   # the kernel reads a float32 obs row 16 bytes at a time
        obs = obs.clone()
    partials, err = _empty(x, n, blocks), _empty(x, n)
    device, stream = stream_args(x)
    kind = cell_kind(obs)
    LOSS_TAIL2_FWD.launch(x.data_ptr(), wt.data_ptr(), b.data_ptr(), obs.data_ptr(),
                          partials.data_ptr(), err.data_ptr(), n, cin, h, w, ri, tj,
                          _loss_tail2_smem(kind, cin, w, ri, tj), ACTS[act], kind, int(stage),
                          float(drop_p), _seed_word(seed), device, stream, packed=_packed(obs))
    return err


def _loss_tail2_bwd_smem(kind: int, cin: int, w: int, ri: int, tj: int) -> int:
    """csrc/loss_tail2_bwd.cu::loss_tail2_bwd_smem: the backward's shared
    memory, then the obs tile of uint8 cells (rows of 16-byte pieces) or
    packed words, 16-byte aligned; float32 obs take g's place."""
    t = min(tj, w)
    tile = {0: 0, 1: (2 * ri + 4) * (-(-(2 * t + 20) // 16) * 16),
            2: 4 * (2 * ri + 4) * ((2 * t + 8 + 31) // 32 + 1)}[kind]
    return -(-_tail2_bwd_smem(cin, w, ri, tj) // 16) * 16 + tile


def _loss_tail2_bwd_kernel(x, wt, b, obs, gbar, act, drop_p, seed, stage, plan=None):
    """(dW, db, gx) from the specialised loss-tail backward on checked inputs,
    its keep bits drawn in the kernel; ``plan`` (RI, TJ) overrides
    :func:`_tail2_plan` (the backward's)."""
    n, cin, h, w = x.shape
    ri, tj = plan or _tail2_plan(n, cin, h, w, True, _multiprocessors(x.device))[:2]
    k = 16 * cin + 1
    blocks = -(-h // ri) * -(-w // min(tj, w))
    grads, partials, gx = _empty(x, k), _empty(x, n * blocks, k), _empty(x, n, cin, h, w)
    x, wt, b, obs = x.contiguous(), wt.contiguous(), b.contiguous(), obs.contiguous()
    gbar = gbar.contiguous()
    if obs.data_ptr() % 16:   # the kernel copies obs rows in 16-byte pieces
        obs = obs.clone()
    kind = cell_kind(obs)
    device, stream = stream_args(x)
    LOSS_TAIL2_BWD.launch(x.data_ptr(), wt.data_ptr(), b.data_ptr(), obs.data_ptr(),
                          gbar.data_ptr(), partials.data_ptr(), grads.data_ptr(), gx.data_ptr(),
                          n, cin, h, w, ri, tj, _loss_tail2_bwd_smem(kind, cin, w, ri, tj),
                          ACTS[act], kind, int(stage), float(drop_p), _seed_word(seed), device,
                          stream, packed=_packed(obs))
    return (*_split(grads, ((cin, 1, 4, 4), (1,))), gx)


def _tail2_bwd_kernel(x, wt, b, g, act, drop_p, seed, stage, keep=None, plan=None):
    """(dW, db, gx) from the specialised backward on checked inputs: from
    the keep bits the training forward with the same inputs saved, or (None)
    drawing them; ``plan`` (RI, TJ) overrides :func:`_tail2_plan`."""
    n, cin, h, w = x.shape
    ri, tj = plan or _tail2_plan(n, cin, h, w, True, _multiprocessors(x.device))[:2]
    k = 16 * cin + 1
    blocks = -(-h // ri) * -(-w // min(tj, w))
    grads, partials, gx = _empty(x, k), _empty(x, n * blocks, k), _empty(x, n, cin, h, w)
    x, wt, b, g = x.contiguous(), wt.contiguous(), b.contiguous(), g.contiguous()
    if g.data_ptr() % 16:   # the kernel copies g's rows in 16-byte pieces
        g = g.clone()
    device, stream = stream_args(x)
    TAIL2_BWD.launch(x.data_ptr(), wt.data_ptr(), b.data_ptr(), g.data_ptr(), _ptr(keep),
                     partials.data_ptr(), grads.data_ptr(), gx.data_ptr(), n, cin, h, w, ri, tj,
                     _tail2_bwd_smem(cin, w, ri, tj), ACTS[act], int(stage), float(drop_p),
                     _seed_word(seed), device, stream)
    return (*_split(grads, ((cin, 1, 4, 4), (1,))), gx)


# -- decoder loss --------------------------------------------------------------


def _decoder_floats(w, c2, cmid, cout, ry, tx) -> int:
    """csrc/ae_bands.cuh::decoder_band_floats."""
    if tx >= w:
        return _ae_band_floats(w, 0, c2, cmid, cout, ry)
    er, mr = ry // 4 + 2, ry // 2 + 2
    return (c2 * cmid * 16 + cmid + cmid * cout * 16 + cout
            + c2 * er * _widest_window(w // 4, tx // 4, 1)
            + cmid * mr * _widest_window(w // 2, tx // 2, 1))


def _decoder_fwd_smem(w, c2, cmid, cout, ry, tx) -> int:
    """csrc/decoder_loss_fwd.cu: the band buffers without an encoder, + 32."""
    return 4 * (_decoder_floats(w, c2, cmid, cout, ry, tx) + 32)


def _decoder_bwd_smem(w, c2, cmid, cout, ry, tx) -> int:
    """csrc/decoder_loss_bwd.cu::decoder_loss_bwd_smem."""
    t = min(tx, w)
    return 4 * (_decoder_floats(w, c2, cmid, cout, ry, tx) + cout * (ry + 2) * (t + 2)
                + cmid * (ry // 2) * (t // 2) + RED16_FLOATS)


@functools.lru_cache(maxsize=None)
def _decoder_bands(h, w, c2, cmid, cout, cells=None):
    """(RY, TX output columns a tile, shared memory) of the decoder loss's
    forward and backward kernels; h and w are the output's."""
    return (_pick_tile(lambda r, t: _decoder_fwd_smem(w, c2, cmid, cout, r, 4 * t), h,
                       (16, 8, 4), w // 4, 4, cells=cells),
            _pick_tile(lambda r, t: _decoder_bwd_smem(w, c2, cmid, cout, r, 4 * t), h,
                       (16, 8, 4), w // 4, 4, SMEM_TARGET_BWD, cells))


def _decoder_shape(x, wt1, b1, wt2, b2, obs):
    n, c2, he, we = x.shape
    cmid, cout = wt1.shape[1], wt2.shape[1]
    if (tuple(wt1.shape) != (c2, cmid, 4, 4) or tuple(wt2.shape) != (cmid, cout, 4, 4)
            or tuple(b1.shape) != (cmid,) or tuple(b2.shape) != (cout,)):
        raise ValueError("the decoder-loss kernels take weights [C2,CMID,4,4], [CMID], "
                         "[CMID,COUT,4,4], [COUT]")
    if max(c2, cmid, cout) > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels a stage")
    _check_obs(obs, (n, cout, 4 * he, 4 * we))
    return n, 4 * he, 4 * we, c2, cmid, cout


def decoder_loss_fwd(x, wt1, b1, wt2, b2, obs, drop_p: float = 0.0,
                     seed: int = 0, em: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both decoder stages and the per-instance squared error against obs
    (uint8 or float32 [N, COUT, 4h, 4w]), each output row's error times its
    weight ``em`` [N, 4h] (None: all ones), as one kernel on CUDA; the plain
    twin on the CPU."""
    return _dispatch("decoder_loss_fwd", x, decoder_loss_fwd_plain,
                     _decoder_loss_fwd_kernel, x, wt1, b1, wt2, b2, obs, drop_p, seed, em)


def _decoder_loss_fwd_kernel(x, wt1, b1, wt2, b2, obs, drop_p, seed, em=None):
    return _decoder_fwd_launch(x, (wt1, b1, wt2, b2), obs, drop_p, seed, em, False)[0]


def _decoder_fwd_launch(x, params, obs, drop_p, seed, em, save):
    """(err, Dec2Saved or None): the forward kernel of the widths' route;
    ``save`` (the specialised route, with dropout) also keeps the keep bits
    its backward reads."""
    wt1, b1, wt2, b2 = params
    _check_drop(drop_p)
    n, h, w, c2, cmid, cout = _decoder_shape(x, wt1, b1, wt2, b2, obs)
    _check_tensors(x, [("x", x), ("wt1", wt1), ("b1", b1), ("wt2", wt2), ("b2", b2)],
                   [("obs", obs)])
    em = _check_mask(em, x, n, h)
    if decoder_route(h, w, (c2, cmid, cout)):
        return _dec2_fwd_kernel(x, params, obs, drop_p, seed, em, save)
    # tq: embedding columns a tile, 4 tq output columns
    ry, tq, smem = _decoder_bands(h, w, c2, cmid, cout, cuda_head.TILE_CELLS)[0]
    ts = [t.contiguous() for t in (x, obs, wt1, b1, wt2, b2)]
    blocks = -(-h // ry) * -(-(w // 4) // tq)
    partials, err = _empty(x, n, blocks), _empty(x, n)
    device, stream = stream_args(x)
    DECODER_LOSS_FWD.launch(*(t.data_ptr() for t in ts), _ptr(em), partials.data_ptr(),
                            err.data_ptr(), n, h, w, c2, cmid, cout, ry, 4 * tq, smem,
                            cell_kind(obs), float(drop_p), _seed_word(seed),
                            device, stream, packed=_packed(obs))
    return err, None


def decoder_loss_bwd(x, wt1, b1, wt2, b2, obs, gbar, drop_p: float = 0.0, seed: int = 0,
                     em: Optional[torch.Tensor] = None):
    """(dWt1, dbt1, dWt2, dbt2, gx) for the cotangent gbar [N] of
    :func:`decoder_loss_fwd`'s error."""
    return _dispatch("decoder_loss_bwd", x, decoder_loss_bwd_plain,
                     _decoder_loss_bwd_kernel, x, wt1, b1, wt2, b2, obs, gbar, drop_p, seed,
                     em)


def _decoder_loss_bwd_kernel(x, wt1, b1, wt2, b2, obs, gbar, drop_p, seed, em=None):
    _check_drop(drop_p)
    n, h, w, c2, cmid, cout = _decoder_shape(x, wt1, b1, wt2, b2, obs)
    _check_tensors(x, [("x", x), ("wt1", wt1), ("b1", b1), ("wt2", wt2), ("b2", b2),
                       ("gbar", gbar)], [("obs", obs)])
    if tuple(gbar.shape) != (n,):
        raise ValueError(f"gbar shape {tuple(gbar.shape)} != {(n,)}")
    em = _check_mask(em, x, n, h)
    if decoder_route(h, w, (c2, cmid, cout)):
        # the gradients alone: with dropout the saving forward draws the bits
        # the backward reads
        params = (wt1, b1, wt2, b2)
        saved = _dec2_fwd_kernel(x, params, obs, drop_p, seed, em, True)[1] if drop_p > 0 else None
        return _dec2_bwd_kernel(x, params, obs, gbar, drop_p, em, saved)
    ry, tq, smem = _decoder_bands(h, w, c2, cmid, cout, cuda_head.TILE_CELLS)[1]
    shapes = ((c2, cmid, 4, 4), (cmid,), (cmid, cout, 4, 4), (cout,))
    k = sum(math.prod(s) for s in shapes)
    ts = [t.contiguous() for t in (x, obs, wt1, b1, wt2, b2, gbar)]
    gmid, gx = _empty(x, n, cmid, h // 2, w // 2), _empty(x, n, c2, h // 4, w // 4)
    blocks = -(-h // ry) * -(-(w // 4) // tq)
    partials, grads = _empty(x, n * blocks, k), _empty(x, k)
    device, stream = stream_args(x)
    DECODER_LOSS_BWD.launch(*(t.data_ptr() for t in ts), _ptr(em), gmid.data_ptr(),
                            partials.data_ptr(), grads.data_ptr(), gx.data_ptr(), n, h, w,
                            c2, cmid, cout, ry, 4 * tq, smem, cell_kind(obs),
                            float(drop_p), _seed_word(seed), device, stream,
                            packed=_packed(obs))
    return (*_split(grads, shapes), gx)


# -- the decoder loss at the package's decoder width (csrc/dec2.cuh) ------------


def _dec2_fwd_smem(w: int, ry: int, tx: int, save_keep: bool) -> int:
    """csrc/dec2.cuh::dec2_fwd_smem."""
    t = min(tx, w)
    return (4 * (2 * (ry // 4 + 2) * (t // 4 + 2) + (ry // 2 + 2) * (t // 2 + 2))
            + ((ry // 2) * (t // 2) if save_keep else 0))


def _dec2_bwd_smem(w: int, ry: int, tx: int) -> int:
    """csrc/dec2.cuh::dec2_bwd_smem."""
    t = min(tx, w)
    return 4 * (2 * (ry // 4 + 4) * (t // 4 + 4) + (ry // 2 + 6) * (t // 2 + 6)
                + (ry + 6) * (t + 6) + (ry // 2 + 2) * (t // 2 + 2) + 32 * 16)


@functools.lru_cache(maxsize=None)
def _dec2_plan(n, h, w, backward, cells=None):
    """(RY output rows, TX output columns, shared memory) of the specialised
    forward (the saving instantiation's shared memory, the most it takes) or
    backward on n instances of output [h, w]: the forward computes a middle
    row and column to either side of its outputs', the backward three output
    rows and columns."""
    def smem_of(ry, tx):
        if tx % 4:
            return SMEM_MAX + 1
        return _dec2_bwd_smem(w, ry, tx) if backward else _dec2_fwd_smem(w, ry, tx, True)

    return _pick_by_cost(smem_of, n, h, w, 1, 3 if backward else 1, (64, 32, 16, 8, 4), 1,
                         cells, blocks_sm=DEC2_BLOCKS[int(backward)])


def decoder_route(h: int, w: int, widths) -> bool:
    """Whether the decoder loss with output [h, w] and ``widths`` (C2, CMID,
    COUT) runs the kernels specialised for them (csrc/dec2_fwd.cu,
    dec2_bwd.cu): the widths and plans that fit decide, on any device, so the
    forward and the backward take one route."""
    if not DEC2_KERNELS or tuple(widths) != DEC2_WIDTHS:
        return False
    try:
        for backward in (False, True):
            _dec2_plan(1, h, w, backward)
    except ValueError:
        return False
    return True


class Dec2Saved(NamedTuple):
    """The keep bits a decoder-loss training forward on the specialised route
    saves for its backward (csrc/dec2.cuh): keepd uint8 [N, H/2, W/2], bit
    2a + b the output (2i + a, 2j + b), bit 4 the middle position (i, j).
    Rows of weight zero, and the middle positions only they read, are not
    drawn: their bits are zero."""
    keepd: torch.Tensor


def dec2_keep_masks(saved: Dec2Saved):
    """The keep masks of the decoder's two dropout stages that a training
    forward saved, in :func:`philox_keep_mask`'s layout: [N, 1, H/2, W/2]
    (STAGE_DEC1), [N, 1, H, W] (STAGE_DEC2)."""
    keepd = saved.keepd.to(torch.int32)
    return [((keepd >> 4) & 1).bool()[:, None], _unfold_bits(keepd & 0xF, 4, 2, 1)]


def _dec2_fwd_kernel(x, params, obs, drop_p, seed, em, save):
    """(err [N], Dec2Saved or None): the specialised forward on checked
    inputs; ``save`` with dropout also writes the keep bits."""
    n, _, he, we = x.shape
    h, w = 4 * he, 4 * we
    ry, tx, _ = _dec2_plan(n, h, w, False, cuda_head.TILE_CELLS)
    save_keep = save and drop_p > 0.0
    keepd = (torch.empty((n, h // 2, w // 2), dtype=torch.uint8, device=x.device)
             if save_keep else None)
    ts = [t.contiguous() for t in (x, obs, *params)]
    partials = torch.empty((n, -(-h // ry) * -(-w // min(tx, w))), dtype=torch.float64,
                           device=x.device)
    err = _empty(x, n)
    device, stream = stream_args(x)
    DEC2_FWD.launch(*(t.data_ptr() for t in ts), _ptr(em), partials.data_ptr(),
                    err.data_ptr(), _ptr(keepd), n, h, w, ry, tx,
                    _dec2_fwd_smem(w, ry, tx, save_keep), cell_kind(obs), float(drop_p),
                    _seed_word(seed), device, stream, packed=_packed(obs))
    return err, (Dec2Saved(keepd) if save_keep else None)


def _dec2_bwd_kernel(x, params, obs, gbar, drop_p, em, saved: Optional[Dec2Saved]):
    """(dWt1, dbt1, dWt2, dbt2, gx) from the specialised backward on checked
    inputs and what the training forward with the same params saved (None
    without dropout)."""
    n, _, he, we = x.shape
    h, w = 4 * he, 4 * we
    ry, tx, smem = _dec2_plan(n, h, w, True, cuda_head.TILE_CELLS)
    partials = _empty(x, n * -(-h // ry) * -(-w // min(tx, w)), DEC2_PARTS)
    grads, gx = _empty(x, DEC2_PARTS), _empty(x, n, 2, he, we)
    ts = [t.contiguous() for t in (x, obs, *params, gbar)]   # alive until the launch is enqueued
    device, stream = stream_args(x)
    DEC2_BWD.launch(*(t.data_ptr() for t in ts), _ptr(em),
                    _ptr(saved.keepd if saved is not None else None), partials.data_ptr(),
                    grads.data_ptr(), gx.data_ptr(), n, h, w, ry, tx, smem, cell_kind(obs),
                    float(drop_p), device, stream, packed=_packed(obs))
    return (*_split(grads, ((2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,))), gx)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class HeadFn(torch.autograd.Function):
    """head_fwd with head_bwd as its backward; saves only the inputs."""

    @staticmethod
    def forward(ctx, x, w, b, pool, drop_p, seed, stage, need_dx):
        ctx.save_for_backward(x, w, b)
        ctx.settings = (int(pool), float(drop_p), int(seed), int(stage))
        ctx.need_dx = bool(need_dx)
        return head_fwd(x, w, b, *ctx.settings)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dw, db, gx = head_bwd(*ctx.saved_tensors, g.contiguous(), *ctx.settings,
                              ctx.need_dx)
        return (gx, dw, db, None, None, None, None, None)


class TailFn(torch.autograd.Function):
    """tail_fwd with tail_bwd as its backward; saves the inputs and, on the
    specialised route with dropout, the keep bits its forward kernel drew, so
    the backward draws none."""

    @staticmethod
    def forward(ctx, x, wt, b, act, drop_p, seed, stage):
        ctx.save_for_backward(x, wt, b)
        ctx.settings = (act, float(drop_p), int(seed), int(stage))
        if x.device.type == "cuda":
            y, ctx.keep = _tail_fwd_launch(x, wt, b, *ctx.settings, True)
            return y
        ctx.keep = None
        return tail_fwd(x, wt, b, *ctx.settings)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if ctx.keep is not None:
            dw, db, gx = _tail2_bwd_kernel(*ctx.saved_tensors, g.contiguous(), *ctx.settings,
                                           keep=ctx.keep)
        else:
            dw, db, gx = tail_bwd(*ctx.saved_tensors, g.contiguous(), *ctx.settings)
        return (gx, dw, db, None, None, None, None)


class LossTailFn(torch.autograd.Function):
    """loss_tail_fwd with loss_tail_bwd as its backward; obs gets no gradient."""

    @staticmethod
    def forward(ctx, x, wt, b, obs, act, drop_p, seed, stage):
        ctx.save_for_backward(x, wt, b, obs)
        ctx.settings = (act, float(drop_p), int(seed), int(stage))
        return loss_tail_fwd(x, wt, b, obs, *ctx.settings)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        dw, db, gx = loss_tail_bwd(*ctx.saved_tensors, gbar.contiguous(), *ctx.settings)
        return (gx, dw, db, None, None, None, None, None)


class DecoderLossFn(torch.autograd.Function):
    """decoder_loss_fwd with decoder_loss_bwd as its backward; saves the
    inputs and, on the specialised route with dropout, the keep bits its
    forward kernel drew, so the backward draws none.  obs and the row weights
    get no gradient."""

    @staticmethod
    def forward(ctx, x, wt1, b1, wt2, b2, obs, drop_p, seed, em):
        ctx.save_for_backward(x, wt1, b1, wt2, b2, obs, em)
        ctx.settings = (float(drop_p), int(seed))
        if x.device.type == "cuda":
            err, ctx.dec2 = _decoder_fwd_launch(x, (wt1, b1, wt2, b2), obs, *ctx.settings, em,
                                                True)
            return err
        ctx.dec2 = None
        return decoder_loss_fwd(x, wt1, b1, wt2, b2, obs, *ctx.settings, em)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        *inputs, em = ctx.saved_tensors
        if ctx.dec2 is not None:
            x, *params, obs = inputs
            em = _check_mask(em, x, x.shape[0], 4 * x.shape[2])
            dwt1, dbt1, dwt2, dbt2, gx = _dec2_bwd_kernel(
                x, params, obs, gbar.contiguous(), ctx.settings[0], em, ctx.dec2)
        else:
            dwt1, dbt1, dwt2, dbt2, gx = decoder_loss_bwd(
                *inputs, gbar.contiguous(), *ctx.settings, em)
        return (gx, dwt1, dbt1, dwt2, dbt2, None, None, None, None)


def head(x, w, b, pool: int, drop_p: float = 0.0, seed: int = 0,
         stage: int = STAGE_ENC1, need_dx: bool = False) -> torch.Tensor:
    """The fused conv stage, differentiable in w and b and, with ``need_dx``,
    in x.  Without a gradient request it is :func:`head_fwd` alone."""
    if _wants_grad((w, b) + ((x,) if need_dx else ())):
        return HeadFn.apply(x, w, b, pool, drop_p, seed, stage, need_dx)
    return head_fwd(x, w, b, pool, drop_p, seed, stage)


def tail(x, wt, b, act: str, drop_p: float = 0.0, seed: int = 0,
         stage: int = STAGE_DEC1) -> torch.Tensor:
    """The fused decoder stage, differentiable in x, wt and b."""
    if _wants_grad((x, wt, b)):
        return TailFn.apply(x, wt, b, act, drop_p, seed, stage)
    return tail_fwd(x, wt, b, act, drop_p, seed, stage)


def loss_tail(x, wt, b, obs, act: str = "sigmoid", drop_p: float = 0.0, seed: int = 0,
              stage: int = STAGE_DEC2) -> torch.Tensor:
    """The fused decoder stage and its error, differentiable in x, wt and b."""
    if _wants_grad((x, wt, b)):
        return LossTailFn.apply(x, wt, b, obs, act, drop_p, seed, stage)
    return loss_tail_fwd(x, wt, b, obs, act, drop_p, seed, stage)


def decoder_loss(x, wt1, b1, wt2, b2, obs, drop_p: float = 0.0,
                 seed: int = 0, em: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both decoder stages and the error (rows weighted by ``em``),
    differentiable in x and the four parameters."""
    if _wants_grad((x, wt1, b1, wt2, b2)):
        return DecoderLossFn.apply(x, wt1, b1, wt2, b2, obs, drop_p, seed, em)
    return decoder_loss_fwd(x, wt1, b1, wt2, b2, obs, drop_p, seed, em)
