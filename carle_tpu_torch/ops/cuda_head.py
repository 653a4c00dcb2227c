"""The wrapper nets' fused forwards: ``encoder_fwd`` and ``ae_loss_fwd`` CUDA
kernels and their plain PyTorch twins (counterpart of
carle_tpu/ops/pallas_head.py's ``make_fused_encoder`` and
``make_fused_ae_loss`` forwards, at inference: no dropout, no row mask).

Each public function takes the plain path for CPU tensors and launches its
kernel (``csrc/encoder_fwd.cu``, ``csrc/ae_loss_fwd.cu``) for CUDA tensors.
The kernels compute their own convolutions, pools, transpose convolutions
and reductions; ``torch.nn.functional`` appears only in the plain twins.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .cuda_build import KERNELS, stream_args

ENCODER = KERNELS["encoder_fwd"]
AE_LOSS = KERNELS["ae_loss_fwd"]
MAX_CHANNELS = 8            # the kernels' register-array bound
SMEM_TARGET = 48 * 1024     # prefer bands that fit the default shared memory
SMEM_MAX = 227 * 1024

__all__ = ["ENCODER", "AE_LOSS", "encoder_fwd", "encoder_fwd_plain",
           "ae_loss_fwd", "ae_loss_fwd_plain"]


def _check_pools(pools: Tuple[int, int]) -> None:
    for pool in pools:
        if pool < 2 or pool & (pool - 1):
            raise ValueError(f"pools must be powers of two >= 2, got {pools}")


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def encoder_fwd_plain(x, w1, b1, w2, b2, pools: Tuple[int, int]) -> torch.Tensor:
    """``pool(relu(conv3x3(x)))`` twice, zero padding 1; x [N, 1, H, W]
    uint8 or float32 -> float32 [N, C2, H/(p1 p2), W/(p1 p2)]."""
    _check_pools(pools)
    z = F.conv2d(x.to(torch.float32), w1, b1, padding=1)
    z = F.max_pool2d(F.relu(z), pools[0])
    z = F.conv2d(z, w2, b2, padding=1)
    return F.max_pool2d(F.relu(z), pools[1])


def ae_loss_fwd_plain(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs,
                      pools: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """Per-instance ``sum((obs - ae(src))**2)`` over C, H, W -> float32 [N]."""
    z = encoder_fwd_plain(src, w1, b1, w2, b2, pools)
    a = F.relu(F.conv_transpose2d(z, wt1, bt1, stride=2, padding=1))
    y = torch.sigmoid(F.conv_transpose2d(a, wt2, bt2, stride=2, padding=1))
    return ((obs.to(torch.float32) - y) ** 2).sum(dim=(1, 2, 3))


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


def _pick_band(smem_of, rows: int, choices) -> Tuple[int, int]:
    """The largest band in ``choices`` (at most ``rows``) whose shared memory
    fits SMEM_TARGET, else the smallest that fits SMEM_MAX."""
    fitting = [(b, smem_of(b)) for b in choices if b <= max(rows, choices[-1])]
    for band, smem in fitting:
        if smem <= SMEM_TARGET:
            return band, smem
    band, smem = fitting[-1]
    if smem > SMEM_MAX:
        raise ValueError("universe too wide for the kernel's shared-memory band")
    return band, smem


def encoder_fwd(x, w1, b1, w2, b2, pools: Tuple[int, int]) -> torch.Tensor:
    """Both encoder stages as one kernel on CUDA; the plain twin on the CPU.
    The kernel takes uint8 cells [N, 1, H, W] with H and W divisible by
    p1 * p2."""
    if x.device.type == "cpu":
        return encoder_fwd_plain(x, w1, b1, w2, b2, pools)
    if x.device.type != "cuda":
        raise ValueError(f"encoder_fwd runs on cpu or cuda, not {x.device}")
    _check_pools(pools)
    p1, p2 = pools
    n, cin, h, w = x.shape
    c1, c2 = w1.shape[0], w2.shape[0]
    if cin != 1 or tuple(w1.shape) != (c1, 1, 3, 3) or tuple(w2.shape) != (c2, c1, 3, 3):
        raise ValueError("encoder_fwd takes one input channel and 3x3 weights "
                         f"[C1,1,3,3], [C2,C1,3,3]; got x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if max(c1, c2) > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels a stage")
    if h % (p1 * p2) or w % (p1 * p2):
        raise ValueError(f"{h}x{w} is not divisible by the pools {pools}")
    if n > 65535:
        raise ValueError("at most 65535 instances a launch")
    _check_cuda_inputs(x, [("x", x)], [("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)])
    ho, wo = h // (p1 * p2), w // (p1 * p2)
    r2, smem = _pick_band(lambda r: _encoder_smem(h, w, c1, c2, p1, p2, r),
                          ho, (8, 4, 2, 1))
    out = torch.empty((n, c2, ho, wo), dtype=torch.float32, device=x.device)
    ws = [t.contiguous() for t in (w1, b1, w2, b2)]
    device, stream = stream_args(x)
    ENCODER.launch(x.data_ptr(), *(t.data_ptr() for t in ws), out.data_ptr(),
                   n, h, w, c1, c2, p1, p2, r2, smem, device, stream)
    return out


def _ae_smem(h: int, w: int, c1: int, c2: int, cmid: int, cout: int,
             ry: int) -> int:
    """Bytes of the AE kernel's shared-memory layout for a band of ry output
    rows (must match csrc/ae_loss_fwd.cu)."""
    xr, er, mr, ir = ry // 2 + 6, ry // 4 + 2, ry // 2 + 2, ry + 14
    floats = (c1 * 9 + c1 + c2 * c1 * 9 + c2 + c2 * cmid * 16 + cmid
              + cmid * cout * 16 + cout
              + c1 * xr * (w // 2 + 2) + c2 * er * (w // 4)
              + cmid * mr * (w // 2) + 32)
    return 4 * floats + ir * (w + 2)


def ae_loss_fwd(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs,
                pools: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """The whole autoencoder and its per-instance squared error as one
    kernel on CUDA; the plain twin on the CPU.  The kernel takes uint8 cells
    src [N, 1, H, W] and obs [N, COUT, H, W], pools (2, 2), H and W divisible
    by 4; the caller divides by C*H*W for the mean."""
    if src.device.type == "cpu":
        return ae_loss_fwd_plain(src, w1, b1, w2, b2, wt1, bt1, wt2, bt2, obs, pools)
    if src.device.type != "cuda":
        raise ValueError(f"ae_loss_fwd runs on cpu or cuda, not {src.device}")
    if tuple(pools) != (2, 2):
        raise ValueError(f"the whole-AE kernel needs pools (2, 2), got {pools}")
    n, cin, h, w = src.shape
    c1, c2 = w1.shape[0], w2.shape[0]
    cmid, cout = wt1.shape[1], wt2.shape[1]
    shapes = ((w1, (c1, 1, 3, 3)), (w2, (c2, c1, 3, 3)),
              (wt1, (c2, cmid, 4, 4)), (wt2, (cmid, cout, 4, 4)))
    if cin != 1 or any(tuple(t.shape) != s for t, s in shapes):
        raise ValueError("ae_loss_fwd takes one input channel and weights "
                         "[C1,1,3,3], [C2,C1,3,3], [C2,CMID,4,4], [CMID,COUT,4,4]")
    if tuple(obs.shape) != (n, cout, h, w):
        raise ValueError(f"obs shape {tuple(obs.shape)} != {(n, cout, h, w)}")
    if max(c1, c2, cmid, cout) > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels a stage")
    if h % 4 or w % 4:
        raise ValueError(f"{h}x{w} is not divisible by 4")
    if n > 65535:
        raise ValueError("at most 65535 instances a launch")
    _check_cuda_inputs(src, [("src", src), ("obs", obs)],
                       [("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
                        ("wt1", wt1), ("bt1", bt1), ("wt2", wt2), ("bt2", bt2)])
    ry, smem = _pick_band(lambda r: _ae_smem(h, w, c1, c2, cmid, cout, r),
                          h, (32, 16, 8, 4))
    bands = -(-h // ry)
    partials = torch.empty((n, bands), dtype=torch.float32, device=src.device)
    err = torch.empty((n,), dtype=torch.float32, device=src.device)
    ws = [t.contiguous() for t in (w1, b1, w2, b2, wt1, bt1, wt2, bt2)]
    device, stream = stream_args(src)
    AE_LOSS.launch(src.data_ptr(), obs.data_ptr(), *(t.data_ptr() for t in ws),
                   partials.data_ptr(), err.data_ptr(), n, h, w, c1, c2, cmid,
                   cout, ry, smem, device, stream)
    return err
