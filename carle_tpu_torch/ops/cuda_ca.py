"""The uint8 CA kernels and their plain PyTorch twins (counterpart of
carle_tpu/ops/pallas_ca.py): :func:`ca_step`, one generation with the action
fused in (``csrc/ca_step.cu``), and :func:`ca_multi_step`, K action-free
generations with each universe resident in shared memory
(``csrc/ca_multi_step.cu``; one launch a generation through device memory
when two copies of a universe exceed 227 KB).

Each takes the plain path for a CPU grid and launches its kernel for a CUDA
grid; anything else raises.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig
from .ca import ca_multi_step as ca_multi_step_plain
from .ca import ca_step_with_action as ca_step_plain
from .cuda_build import KERNELS, stream_args

KERNEL = KERNELS["ca_step"]
KERNEL_MULTI = KERNELS["ca_multi_step"]
# rows a block stages: (BAND_ROWS + 2) x W bytes of shared memory
BAND_ROWS = 32
_SMEM_BYTES = 227 * 1024

__all__ = ["KERNEL", "KERNEL_MULTI", "ca_multi_step", "ca_multi_step_plain", "ca_step",
           "ca_step_plain", "rule_tensor"]


def rule_tensor(rule_bits, grid: torch.Tensor) -> torch.Tensor:
    """The rule mask as an int32 scalar or [instances] tensor on ``grid``'s
    device, checked against the grid's leading dimension."""
    rule = torch.as_tensor(rule_bits, dtype=torch.int32, device=grid.device)
    if rule.ndim > 1 or (rule.ndim == 1 and rule.shape[0] != grid.shape[0]):
        raise ValueError(
            f"rule must be a scalar or a [{grid.shape[0]}] vector, got "
            f"shape {tuple(rule.shape)}")
    return rule.contiguous()


def ca_step(grid: torch.Tensor, action: torch.Tensor, rule_bits,
            config: EnvConfig) -> torch.Tensor:
    """XOR the [inst, AH, AW] action (nonzero toggles) into the centred
    window of the uint8 [inst, H, W] grid and run one generation."""
    if grid.device.type == "cpu":
        return ca_step_plain(grid, action, rule_bits, config)
    if grid.device.type != "cuda":
        raise ValueError(f"ca_step runs on cpu or cuda, not {grid.device}")
    n, h, w = grid.shape
    ah, aw = config.eff_action_height, config.eff_action_width
    if (h, w) != (config.height, config.width):
        raise ValueError(f"grid {h}x{w} does not match the config "
                         f"{config.height}x{config.width}")
    if action.shape != (n, ah, aw):
        raise ValueError(f"action shape {tuple(action.shape)} != {(n, ah, aw)}")
    for name, t in (("grid", grid), ("action", action)):
        if t.dtype != torch.uint8 or t.device != grid.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous uint8 tensor on "
                             f"{grid.device}")
    if n > 65535:
        raise ValueError("ca_step launches one block row per universe: at "
                         "most 65535 universes")
    band = min(BAND_ROWS, h)
    if (band + 2) * w > _SMEM_BYTES:
        band = _SMEM_BYTES // w - 2
        if band < 1:
            raise ValueError(f"width {w} leaves no room for a band in shared "
                             "memory")
    rule = rule_tensor(rule_bits, grid)
    out = torch.empty_like(grid)
    device, stream = stream_args(grid)
    KERNEL.launch(grid.data_ptr(), action.data_ptr(), rule.data_ptr(),
                  int(rule.ndim == 1), out.data_ptr(), n, h, w, ah, aw,
                  config.action_row_offset, config.action_col_offset, band,
                  device, stream)
    return out


def ca_multi_step(grid: torch.Tensor, rule_bits, num_steps: int) -> torch.Tensor:
    """``num_steps`` action-free generations of a uint8 [inst, H, W] grid
    (W % 4 == 0 on the card); the rule is a scalar or an [inst] vector."""
    if grid.device.type == "cpu":
        return ca_multi_step_plain(grid, rule_bits, num_steps)
    if grid.device.type != "cuda":
        raise ValueError(f"ca_multi_step runs on cpu or cuda, not {grid.device}")
    return _ca_multi_step_kernel(grid, rule_bits, num_steps)


def _ca_multi_step_kernel(grid: torch.Tensor, rule_bits, num_steps: int) -> torch.Tensor:
    if grid.dtype != torch.uint8 or grid.ndim != 3 or not grid.is_contiguous():
        raise ValueError("grid must be a contiguous uint8 [inst, H, W] tensor")
    n, h, w = grid.shape
    if w % 4:
        raise ValueError(f"the kernel reads 4 cells a word: width {w} % 4 != 0")
    steps = int(num_steps)
    if steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {steps}")
    keep = 2 * h * w <= _SMEM_BYTES
    if n > 65535 and not keep:
        raise ValueError("the per-generation fallback launches one block row "
                         "per universe: at most 65535 universes")
    rule = rule_tensor(rule_bits, grid)
    out = torch.empty_like(grid)
    scratch = out if keep else torch.empty_like(grid)
    device, stream = stream_args(grid)
    KERNEL_MULTI.launch(grid.data_ptr(), rule.data_ptr(), int(rule.ndim == 1),
                        out.data_ptr(), scratch.data_ptr(), n, h, w, steps, int(keep),
                        device, stream, count=1 if keep else steps)
    return out
