"""The wrapper nets' single stages and the two-stage decoder loss: forward
and backward CUDA kernels and their plain PyTorch twins (counterpart of
carle_tpu/ops/pallas_head.py's ``make_fused_head``, ``make_fused_tail``,
``make_fused_loss_tail`` and ``make_fused_decoder_loss``).

* :func:`head` — ``pool(relu(drop(conv3x3(x))))``, pool a power of two; its
  backward gives dW, db and, with ``need_dx``, the input cotangent;
* :func:`tail` — ``act(drop(conv_transpose2d(x)))`` (k4, s2, p1), act relu or
  sigmoid; backward dW, db, gx;
* :func:`loss_tail` — the tail fused with ``sum((obs - y)**2)`` per instance;
* :func:`decoder_loss` — both decoder stages fused with that error; backward
  the four parameter gradients and ``gx``, the embedding's cotangent, which
  flows on into :func:`cuda_head.encoder`'s backward.  Optional per-instance
  error row weights ``em`` [N, H] make it ``make_fused_decoder_loss_banded``;
  its kernels cut a universe too wide for one band of the whole width into
  column tiles (``cuda_head.TILE_CELLS`` forces them).

Each is a ``torch.autograd.Function`` that saves its inputs and the seed and
recomputes in the backward, launches its kernels (``csrc/head_fwd.cu``,
``head_bwd.cu``, ``tail.cu``, ``decoder_loss_fwd.cu``, ``decoder_loss_bwd.cu``)
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
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import cuda_head
from .cuda_build import KERNELS, stream_args
from .cuda_head import (MAX_CHANNELS, RED16_FLOATS, RED_FLOATS, SMEM_TARGET_BWD,
                        STAGE_DEC1, STAGE_DEC2, STAGE_ENC1, _ae_band_floats,
                        _check_drop, _check_mask, _conv_wgrad, _deconv_wgrad, _dispatch,
                        _dropout, _packed, _pick_band, _pick_tile, _pool_route, _ptr,
                        _row_factor, _seed_word, _split, _wants_grad, _widest_window,
                        cell_kind, cell_shape, cells, philox_keep_mask)

HEAD_FWD, HEAD_BWD = KERNELS["head_fwd"], KERNELS["head_bwd"]
TAIL_FWD, TAIL_BWD = KERNELS["tail_fwd"], KERNELS["tail_bwd"]
LOSS_TAIL_FWD, LOSS_TAIL_BWD = KERNELS["loss_tail_fwd"], KERNELS["loss_tail_bwd"]
DECODER_LOSS_FWD, DECODER_LOSS_BWD = KERNELS["decoder_loss_fwd"], KERNELS["decoder_loss_bwd"]
ACTS = {"relu": 0, "sigmoid": 1}    # csrc/tail.cu
HEAD_POOLS = (2, 4, 8)              # the head kernels' instantiations

__all__ = ["head", "tail", "loss_tail", "decoder_loss",
           "head_fwd", "head_fwd_plain", "head_bwd", "head_bwd_plain",
           "tail_fwd", "tail_fwd_plain", "tail_bwd", "tail_bwd_plain",
           "loss_tail_fwd", "loss_tail_fwd_plain", "loss_tail_bwd", "loss_tail_bwd_plain",
           "decoder_loss_fwd", "decoder_loss_fwd_plain", "decoder_loss_bwd",
           "decoder_loss_bwd_plain"]


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


def _head_fwd_smem(c, o, w, pool, r) -> int:
    """csrc/head_fwd.cu::head_fwd_smem."""
    return 4 * (o * c * 9 + o + c * (r * pool + 2) * (w + 2))


def _head_bwd_smem(c, o, w, pool, r) -> int:
    """csrc/head_bwd.cu::head_bwd_smem."""
    return _head_fwd_smem(c, o, w, pool, r) + 4 * (o * r * pool * w + RED_FLOATS)


@functools.lru_cache(maxsize=None)
def _head_bands(c, o, h, w, pool):
    """(R, shared memory) of the head's forward and of its backward kernel."""
    return (_pick_band(lambda r: _head_fwd_smem(c, o, w, pool, r), h // pool, (8, 4, 2, 1)),
            _pick_band(lambda r: _head_bwd_smem(c, o, w, pool, r), h // pool, (8, 4, 2, 1),
                       SMEM_TARGET_BWD))


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
    r, smem = _head_bands(c, o, h, wd, pool)[0]
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    out = _empty(x, n, o, h // pool, wd // pool)
    device, stream = stream_args(x)
    HEAD_FWD.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, c, o, h,
                    wd, pool, r, smem, cell_kind(x), int(stage),
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
    r, smem = _head_bands(c, o, h, wd, pool)[1]
    bands = -(-(h // pool) // r)
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
                    pool, r, smem, cell_kind(x), int(stage), float(drop_p),
                    _seed_word(seed), device, stream, packed=_packed(x))
    return (*_split(grads, shapes), gx)


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
    _check_drop(drop_p)
    n, cin, cout, h, w = _tail_shape(x, wt, b, act)
    _check_tensors(x, [("x", x), ("wt", wt), ("b", b)])
    ry, smem = _tail_bands(cin, cout, h, w)[0]
    x, wt, b = x.contiguous(), wt.contiguous(), b.contiguous()
    out = _empty(x, n, cout, 2 * h, 2 * w)
    device, stream = stream_args(x)
    TAIL_FWD.launch(x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(), n, cin, cout,
                    h, w, ry, smem, ACTS[act], int(stage), float(drop_p), _seed_word(seed),
                    device, stream)
    return out


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
    return _tail_bwd_launch(LOSS_TAIL_BWD, x, wt, b, obs, gbar, act, drop_p, seed, stage,
                            (cell_kind(obs),))


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
    _check_drop(drop_p)
    n, h, w, c2, cmid, cout = _decoder_shape(x, wt1, b1, wt2, b2, obs)
    _check_tensors(x, [("x", x), ("wt1", wt1), ("b1", b1), ("wt2", wt2), ("b2", b2)],
                   [("obs", obs)])
    em = _check_mask(em, x, n, h)
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
    return err


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
    """tail_fwd with tail_bwd as its backward; saves only the inputs."""

    @staticmethod
    def forward(ctx, x, wt, b, act, drop_p, seed, stage):
        ctx.save_for_backward(x, wt, b)
        ctx.settings = (act, float(drop_p), int(seed), int(stage))
        return tail_fwd(x, wt, b, *ctx.settings)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
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
    """decoder_loss_fwd with decoder_loss_bwd as its backward; obs and the
    row weights get no gradient."""

    @staticmethod
    def forward(ctx, x, wt1, b1, wt2, b2, obs, drop_p, seed, em):
        ctx.save_for_backward(x, wt1, b1, wt2, b2, obs, em)
        ctx.settings = (float(drop_p), int(seed))
        return decoder_loss_fwd(x, wt1, b1, wt2, b2, obs, *ctx.settings, em)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        *inputs, em = ctx.saved_tensors
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
