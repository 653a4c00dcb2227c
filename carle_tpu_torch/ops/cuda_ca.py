"""The uint8 CA kernels and their plain PyTorch twins (counterpart of
carle_tpu/ops/pallas_ca.py): :func:`ca_step`, one generation with the action
and the master reset fused in (``csrc/ca_step.cu``: the word kernel
``ca_step_words`` for widths that are a multiple of 16 cells, every width a
main path runs, and the byte kernel ``ca_step`` for the rest;
:func:`ca_step_route` decides by shape), and :func:`ca_multi_step`, K
action-free generations (``csrc/ca_multi_step.cu``): on packed bits held in
registers, the cells packed on the load and unpacked on the store, in one
launch (``ca_multi_step_bits``) where :func:`bits_plan` serves the shape (K >
1, widths of 32, 64, 128 or 256 cells, the rows a block's registers hold);
else the present kernel ``ca_multi_step``, each universe resident in shared
memory (one launch a generation through device memory when two copies of a
universe exceed 227 KB), which ``CA_MULTI_BITS = False`` forces.

Each takes the plain path for a CPU grid and launches its kernel for a CUDA
grid; anything else raises.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import torch

from ..config import EnvConfig
from .ca import ca_multi_step as ca_multi_step_plain
from .ca import ca_step_with_action as ca_step_plain
from .cuda_build import KERNELS, built_plans, stream_args

KERNEL = KERNELS["ca_step"]
KERNEL_WORDS = KERNELS["ca_step_words"]
KERNEL_MULTI = KERNELS["ca_multi_step"]
KERNEL_BITS = KERNELS["ca_multi_step_bits"]
# the byte kernel's rows a block stages: (BAND_ROWS + 2) x W bytes of shared memory
BAND_ROWS = 32
_SMEM_BYTES = 227 * 1024
# False sends every width to the byte kernel (for comparisons on the card)
CA_STEP_WORDS = True
# False sends every ca_multi_step shape to the present kernel (the A/B)
CA_MULTI_BITS = True
# The redesigned kernel's instantiations (V, R) of csrc/ca_multi_step.cu's
# CA_BITS_PLANS: W = 32 V cells a row, R rows a thread; the rows a thread in
# order of preference (the first that divides the rows), as the packed
# engine's with the rule as data
BITS_PLANS = built_plans("ca_multi_step.cu", "CA_BITS_PLANS")
BITS_ROWS = (4, 1)
_BAR_BYTES = 16   # ca_step.cu's mbarrier slot ahead of the staged band
# the word kernel's band: about this many 16-byte columns a thread, halo rows
# included (the probes' best at 1, 64 and 160 universes of 256², PERF.md row 1)
_COLUMNS_A_THREAD = 4

__all__ = ["BITS_PLANS", "CA_MULTI_BITS", "CA_STEP_WORDS", "KERNEL", "KERNEL_BITS", "KERNEL_MULTI",
           "KERNEL_WORDS", "bits_plan", "bits_threads", "ca_multi_step", "ca_multi_step_plain", "ca_step",
           "ca_step_plain", "ca_step_route", "rule_tensor", "words_plan"]


def rule_tensor(rule_bits, grid: torch.Tensor) -> torch.Tensor:
    """The rule mask as an int32 scalar or [instances] tensor on ``grid``'s
    device, checked against the grid's leading dimension."""
    rule = torch.as_tensor(rule_bits, dtype=torch.int32, device=grid.device)
    if rule.ndim > 1 or (rule.ndim == 1 and rule.shape[0] != grid.shape[0]):
        raise ValueError(
            f"rule must be a scalar or a [{grid.shape[0]}] vector, got "
            f"shape {tuple(rule.shape)}")
    return rule.contiguous()


def ca_step_route(h: int, w: int) -> str:
    """Which kernel takes a [*, h, w] grid on the card: ``"words"`` (16-byte
    columns of 4-cell words: w % 16 == 0 and a band of one row with its two
    halo rows fits shared memory) or ``"bytes"``; decided by the shape
    alone, on any device."""
    if CA_STEP_WORDS and w % 16 == 0 and _BAR_BYTES + 3 * w <= _SMEM_BYTES:
        return "words"
    return "bytes"


def words_plan(n: int, h: int, w: int, sms: int) -> Tuple[int, int, int]:
    """(rows a block, rows a thread's strip, threads a block) of the word
    kernel on n universes of h x w on a card of ``sms`` multiprocessors: the
    most threads a block (to 128) that still give every multiprocessor two
    blocks, as many rows as give each thread about _COLUMNS_A_THREAD 16-byte
    columns with the two halo rows, and strips that give each thread one
    strip of a 16-byte column."""
    columns = w // 16
    threads = 128
    band = lambda t: max(1, _COLUMNS_A_THREAD * t // columns - 2)
    while threads > 32 and n * -(-h // band(threads)) < 2 * sms:
        threads //= 2
    rows = max(1, min(band(threads), h, (_SMEM_BYTES - _BAR_BYTES) // w - 2))
    strip = -(-rows // max(1, threads // columns))
    return rows, strip, threads


@lru_cache(maxsize=None)
def _multiprocessors(device: torch.device) -> int:
    """The multiprocessors of the card a grid lies on (one for the emulated
    build's CPU tensors)."""
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def ca_step(grid: torch.Tensor, action: torch.Tensor, rule_bits, config: EnvConfig,
            reset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """XOR the [inst, AH, AW] action (nonzero toggles) into the centred
    window of the uint8 [inst, H, W] grid and run one generation; all zeros
    where the 0-d bool or uint8 ``reset`` (a device flag the host never
    reads) is set."""
    if grid.device.type == "cpu":
        return ca_step_plain(grid, action, rule_bits, config, reset)
    if grid.device.type != "cuda":
        raise ValueError(f"ca_step runs on cpu or cuda, not {grid.device}")
    if ca_step_route(grid.shape[-2], grid.shape[-1]) == "words":
        return _ca_step_words_kernel(grid, action, rule_bits, config, reset)
    return _ca_step_bytes_kernel(grid, action, rule_bits, config, reset)


def _checked(grid, action, config, reset):
    """The launch's common checks; returns (n, h, w, ah, aw, reset pointer)."""
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
    if reset is None:
        return n, h, w, ah, aw, None
    if (reset.dtype not in (torch.bool, torch.uint8) or reset.numel() != 1
            or reset.device != grid.device):
        raise ValueError(f"reset must be a one-element bool or uint8 tensor on {grid.device}")
    return n, h, w, ah, aw, reset.data_ptr()


def _ca_step_words_kernel(grid, action, rule_bits, config, reset=None,
                          plan: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """The word kernel (``plan`` overrides :func:`words_plan`, for the
    tests)."""
    n, h, w, ah, aw, reset_ptr = _checked(grid, action, config, reset)
    if w % 16 or grid.data_ptr() % 16:
        raise ValueError("the word kernel reads 16-byte columns: width % 16 == 0 "
                         "and a 16-byte aligned grid")
    band, strip, threads = plan or words_plan(n, h, w, _multiprocessors(grid.device))
    if _BAR_BYTES + (band + 2) * w > _SMEM_BYTES:
        raise ValueError(f"a band of {band} rows of width {w} exceeds shared memory")
    if n * -(-h // band) >= 2 ** 31:
        raise ValueError("the word kernel folds universes and bands into one grid "
                         "dimension: fewer than 2**31 blocks")
    rule = rule_tensor(rule_bits, grid)
    out = torch.empty_like(grid)
    device, stream = stream_args(grid)
    KERNEL_WORDS.launch(grid.data_ptr(), action.data_ptr(), rule.data_ptr(),
                        int(rule.ndim == 1), reset_ptr, out.data_ptr(), n, h, w, ah, aw,
                        config.action_row_offset, config.action_col_offset, band, strip,
                        threads, device, stream)
    return out


def _ca_step_bytes_kernel(grid, action, rule_bits, config, reset=None) -> torch.Tensor:
    n, h, w, ah, aw, reset_ptr = _checked(grid, action, config, reset)
    if n > 65535:
        raise ValueError("the byte kernel launches one block row per universe: at "
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
                  int(rule.ndim == 1), reset_ptr, out.data_ptr(), n, h, w, ah, aw,
                  config.action_row_offset, config.action_col_offset, band,
                  device, stream)
    return out


def bits_threads(n: int, per: int) -> int:
    """Threads a block of the redesigned kernel for n universes of ``per``
    threads each: whole universes and whole warps (a warp packs and unpacks
    32 cells a row together), at most 256, spare universes past n in the
    last block; 0 where no block of whole warps holds a universe."""
    step = per * 32 // math.gcd(per, 32)
    most = 256 // step * step
    return min(-(-per * n // step) * step, most)


def bits_plan(n: int, h: int, w: int, steps: int):
    """("regs", V, R, threads): the redesigned kernel's plan for K = ``steps``
    generations on n universes of h x w cells (K > 1, w = 32 V, the first of
    BITS_ROWS rows a thread that divides the rows, at most 256 threads a
    universe; :func:`bits_threads` threads); None where the present kernel
    keeps the shape.  Decided by the shape alone, on any device."""
    if steps <= 1 or w % 32:
        return None
    v, r = w // 32, next(r for r in BITS_ROWS if h % r == 0)
    threads = bits_threads(n, h // r) if (v, r) in BITS_PLANS and h // r <= 256 else 0
    return ("regs", v, r, threads) if threads else None


def ca_multi_step(grid: torch.Tensor, rule_bits, num_steps: int) -> torch.Tensor:
    """``num_steps`` action-free generations of a uint8 [inst, H, W] grid of
    0/1 cells (W % 4 == 0 on the card); the rule is a scalar or an [inst]
    vector."""
    if grid.device.type == "cpu":
        return ca_multi_step_plain(grid, rule_bits, num_steps)
    if grid.device.type != "cuda":
        raise ValueError(f"ca_multi_step runs on cpu or cuda, not {grid.device}")
    if CA_MULTI_BITS and grid.ndim == 3:
        plan = bits_plan(*grid.shape, int(num_steps))
        if plan is not None:
            return _ca_multi_bits_kernel(grid, rule_bits, num_steps, plan)
    return _ca_multi_step_kernel(grid, rule_bits, num_steps)


def _ca_multi_bits_kernel(grid: torch.Tensor, rule_bits, num_steps: int,
                          plan: Optional[Tuple[str, int, int, int]] = None) -> torch.Tensor:
    """The redesigned kernel by ``plan`` (default :func:`bits_plan`; raises
    where that leaves the shape to the present kernel).  K = 0 copies
    without a launch."""
    if grid.dtype != torch.uint8 or grid.ndim != 3 or not grid.is_contiguous():
        raise ValueError("grid must be a contiguous uint8 [inst, H, W] tensor")
    n, h, w = grid.shape
    steps = int(num_steps)
    if steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {steps}")
    rule = rule_tensor(rule_bits, grid)
    out = torch.empty_like(grid)
    if steps == 0:
        return out.copy_(grid)
    plan = plan or bits_plan(n, h, w, steps)
    if plan is None:
        raise ValueError(f"no register plan holds {n} universes of {h} x {w} cells")
    _, v, r, threads = plan
    if w != 32 * v or h % r:
        raise ValueError(f"plan {plan} does not cover {h} x {w} cells")
    device, stream = stream_args(grid)
    KERNEL_BITS.launch(grid.data_ptr(), rule.data_ptr(), int(rule.ndim == 1), out.data_ptr(),
                       n, h, w, steps, v, r, threads, device, stream)
    return out


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
