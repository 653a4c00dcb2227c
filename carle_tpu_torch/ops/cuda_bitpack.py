"""The packed CA engines: CUDA kernels for K generations on packed words and
their plain PyTorch twins (counterpart of carle_tpu/ops/pallas_bitpack.py).

* :func:`bit_multi_step` — row-major words [inst, H, W/32], the rule as data
  (``bit_multi_step_pallas``);
* :func:`bit_multi_step_static` — row-major, the rule fixed at compile time
  (``bit_multi_step_pallas_static``): one library per rule mask, built on its
  first use;
* :func:`bit_multi_step_static_cm` and :func:`bit_multi_step_cm` — the
  column-major layout [inst, H/32, W] (``ops/bitpack.pack_grid_cm``), the rule
  fixed or as data (``bit_multi_step_pallas_static_cm``, ``_cm``).

Each takes the plain path for a CPU tensor and launches
``csrc/bit_multi_step.cu`` for a CUDA tensor.  The kernels keep each universe
resident in one block's shared memory for all K generations when two copies
of it fit (:func:`resident`: up to 227 KB, e.g. 512 x 512), and otherwise run
one launch a generation through device memory.  The JAX functions' ``scheme``
argument names TPU schedules; it is accepted and ignored.
"""

from __future__ import annotations

import torch

from ..rules import pack_rule_bits
from . import bitpack
from .bitpack import bit_multi_step as bit_multi_step_plain
from .cuda_build import KERNELS, stream_args
from .cuda_ca import rule_tensor

KERNEL = KERNELS["bit_multi_step"]
KERNEL_CM = KERNELS["bit_multi_step_cm"]
KERNEL_STATIC = KERNELS["bit_multi_step_static"]
KERNEL_STATIC_CM = KERNELS["bit_multi_step_static_cm"]
RESIDENT_MAX_BYTES = 227 * 1024

bit_multi_step_static_plain = bitpack.bit_multi_step_static
bit_multi_step_static_cm_plain = bitpack.bit_multi_step_static_cm
bit_multi_step_cm_plain = bitpack.bit_multi_step_cm

__all__ = ["KERNEL", "KERNEL_CM", "KERNEL_STATIC", "KERNEL_STATIC_CM", "bit_multi_step",
           "bit_multi_step_plain", "bit_multi_step_static", "bit_multi_step_static_plain",
           "bit_multi_step_static_cm", "bit_multi_step_static_cm_plain",
           "bit_multi_step_cm", "bit_multi_step_cm_plain", "resident"]


def resident(height: int, words: int, pad: int = 0) -> bool:
    """True when a [height, words] universe runs resident in shared memory
    (two uint32 copies, ping-pong, rows padded by ``pad`` words), False for
    the per-generation fallback."""
    return 2 * height * (words + pad) * 4 <= RESIDENT_MAX_BYTES


def _checked(packed: torch.Tensor, num_steps: int, name: str, layout: str, cm: bool):
    """(steps, keep resident, out, scratch) of a launch on ``packed``; the
    column-major kernels pad each resident row by a word."""
    if packed.dtype != torch.uint32 or packed.ndim != 3 or not packed.is_contiguous():
        raise ValueError(f"{name}: packed must be a contiguous uint32 {layout} tensor")
    steps = int(num_steps)
    if steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {steps}")
    n, a, b = packed.shape
    keep = resident(a, b, int(cm))
    if n > 65535 and not keep:
        raise ValueError("the per-generation fallback launches one block row "
                         "per universe: at most 65535 universes")
    out = torch.empty_like(packed)
    return steps, keep, out, out if keep else torch.empty_like(packed)


def _device_of(packed: torch.Tensor, name: str) -> str:
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {packed.device}")
    return packed.device.type


def _data_rule(kernel, packed, rule_bits, num_steps, cm, layout):
    steps, keep, out, scratch = _checked(packed, num_steps, kernel.name, layout, cm)
    rule = rule_tensor(rule_bits, packed)
    n, a, b = packed.shape
    device, stream = stream_args(packed)
    kernel.launch(packed.data_ptr(), rule.data_ptr(), int(rule.ndim == 1),
                  out.data_ptr(), scratch.data_ptr(), n, a, b, steps, int(keep),
                  device, stream, count=1 if keep else steps)
    return out


def _static_rule(kernel, packed, birth, survive, num_steps, cm, layout):
    steps, keep, out, scratch = _checked(packed, num_steps, kernel.name, layout, cm)
    n, a, b = packed.shape
    device, stream = stream_args(packed)
    kernel.launch(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, a, b, steps,
                  int(keep), int(cm), device, stream, count=1 if keep else steps,
                  defines=(f"STATIC_RULE={pack_rule_bits(birth, survive):#07x}",))
    return out


def bit_multi_step(packed: torch.Tensor, rule_bits,
                   num_steps: int) -> torch.Tensor:
    """``num_steps`` generations on a uint32 [inst, H, W/32] packed grid; the
    rule is a scalar or an [inst] vector."""
    if _device_of(packed, "bit_multi_step") == "cpu":
        return bit_multi_step_plain(packed, rule_bits, num_steps)
    return _data_rule(KERNEL, packed, rule_bits, num_steps, False, "[inst, H, W/32]")


def bit_multi_step_static(packed: torch.Tensor, birth, survive, num_steps: int,
                          scheme: str = "vc16") -> torch.Tensor:
    """``num_steps`` generations on a uint32 [inst, H, W/32] packed grid with
    the B/S rule (digit lists) fixed at compile time.  ``scheme`` is ignored
    (module note)."""
    if _device_of(packed, "bit_multi_step_static") == "cpu":
        return bit_multi_step_static_plain(packed, birth, survive, num_steps)
    return _static_rule(KERNEL_STATIC, packed, birth, survive, num_steps, False,
                        "[inst, H, W/32]")


def bit_multi_step_static_cm(packed_cm: torch.Tensor, birth, survive,
                             num_steps: int) -> torch.Tensor:
    """``num_steps`` generations on a column-major uint32 [inst, H/32, W]
    grid with the B/S rule fixed at compile time."""
    if _device_of(packed_cm, "bit_multi_step_static_cm") == "cpu":
        return bit_multi_step_static_cm_plain(packed_cm, birth, survive, num_steps)
    return _static_rule(KERNEL_STATIC_CM, packed_cm, birth, survive, num_steps, True,
                        "[inst, H/32, W]")


def bit_multi_step_cm(packed_cm: torch.Tensor, rule_bits,
                      num_steps: int) -> torch.Tensor:
    """``num_steps`` generations on a column-major uint32 [inst, H/32, W]
    grid; the rule is a scalar or an [inst] vector."""
    if _device_of(packed_cm, "bit_multi_step_cm") == "cpu":
        return bit_multi_step_cm_plain(packed_cm, rule_bits, num_steps)
    return _data_rule(KERNEL_CM, packed_cm, rule_bits, num_steps, True, "[inst, H/32, W]")
