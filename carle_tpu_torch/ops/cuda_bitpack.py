"""``bit_multi_step``: the CUDA kernel for K generations on packed words, and
its plain PyTorch twin (counterpart of carle_tpu/ops/pallas_bitpack.py's
``bit_multi_step_pallas``).

:func:`bit_multi_step` takes the plain path for a CPU tensor and launches
``csrc/bit_multi_step.cu`` for a CUDA tensor.  The kernel keeps each
universe resident in one block's shared memory for all K generations when
two copies of it fit (:func:`resident`: up to 227 KB, e.g. 512 x 512), and
otherwise runs one launch a generation through device memory.
"""

from __future__ import annotations

import torch

from .bitpack import bit_multi_step as bit_multi_step_plain
from .cuda_build import KERNELS, stream_args
from .cuda_ca import rule_tensor

KERNEL = KERNELS["bit_multi_step"]
RESIDENT_MAX_BYTES = 227 * 1024

__all__ = ["KERNEL", "bit_multi_step", "bit_multi_step_plain", "resident"]


def resident(height: int, words: int) -> bool:
    """True when a [height, words] universe runs resident in shared memory
    (two uint32 copies, ping-pong), False for the per-generation fallback."""
    return 2 * height * words * 4 <= RESIDENT_MAX_BYTES


def bit_multi_step(packed: torch.Tensor, rule_bits,
                   num_steps: int) -> torch.Tensor:
    """``num_steps`` generations on a uint32 [inst, H, W/32] packed grid; the
    rule is a scalar or an [inst] vector."""
    if packed.device.type == "cpu":
        return bit_multi_step_plain(packed, rule_bits, num_steps)
    if packed.device.type != "cuda":
        raise ValueError(f"bit_multi_step runs on cpu or cuda, not {packed.device}")
    if packed.dtype != torch.uint32 or packed.ndim != 3 or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous uint32 [inst, H, W/32] tensor")
    steps = int(num_steps)
    if steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {steps}")
    n, h, nw = packed.shape
    if n > 65535 and not resident(h, nw):
        raise ValueError("the per-generation fallback launches one block row "
                         "per universe: at most 65535 universes")
    rule = rule_tensor(rule_bits, packed)
    out = torch.empty_like(packed)
    keep = resident(h, nw)
    scratch = out if keep else torch.empty_like(packed)
    device, stream = stream_args(packed)
    KERNEL.launch(packed.data_ptr(), rule.data_ptr(), int(rule.ndim == 1),
                  out.data_ptr(), scratch.data_ptr(), n, h, nw, steps, int(keep),
                  device, stream)
    return out
