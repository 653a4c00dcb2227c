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
``csrc/bit_multi_step.cu`` for a CUDA tensor.

:func:`bit_multi_step` runs the kernels redesigned for the H100
(``bit_words_launch``, counted as ``bit_multi_step_words``) where
:func:`words_plan` serves the shape, in one of three regimes:

* K = 1, any size (the packed carry's step, the bands' universe): the
  streaming kernel, a thread a strip of rows of 4 words (1 where rows are
  not whole 16-byte words), no shared memory; one launch;
* K > 1 on universes of 1, 2, 4 or 8 words a row that a block's registers
  hold: each universe resident in registers for all K generations, a block
  holding whole universes, or, with fewer universes than multiprocessors
  (the server's ``/rollout``), a universe of 8 words a row split over a
  thread-block cluster of 16 blocks that trade two ghost rows a side once
  every two generations; one launch;
* K > 1 on universes too large for shared memory: the streaming kernel once a
  generation (K launches).

:func:`bit_multi_step_static` runs the same kernels with the rule folded at
compile time (``bit_static_words_launch`` in the fixed-rule library, counted
as ``bit_multi_step_static_words``), by the same planner.

The column-major engine with the rule fixed, :func:`bit_multi_step_static_cm`,
runs its redesigned kernel (``bit_static_cm_words_launch`` in the fixed-rule
library, counted as ``bit_multi_step_static_cm_words``) where :func:`cm_plan`
serves the shape: K >= 1 generations with each universe held in registers, a
thread 8 adjacent columns x all H/32 word rows, a universe at most a warp's
lanes (widths of 8 to 256 columns), the columns' neighbours by lane
shuffles; one launch.

Other shapes, and every shape with ``BIT_WORDS = False``, take the present
kernels: each universe resident in one block's shared memory for all K
generations when two copies of it fit (:func:`resident`: up to 227 KB, e.g.
512 x 512; one launch), and otherwise one launch a generation through device
memory.  The column-major engine with the rule as data launches the present
kernels.  The JAX functions' ``scheme`` argument names TPU schedules; it is
accepted and ignored.
"""

from __future__ import annotations

import functools

import torch

from ..rules import pack_rule_bits
from . import bitpack
from .bitpack import bit_multi_step as bit_multi_step_plain
from .cuda_build import KERNELS, built_plans, stream_args
from .cuda_ca import _multiprocessors, rule_tensor

KERNEL = KERNELS["bit_multi_step"]
KERNEL_WORDS = KERNELS["bit_multi_step_words"]
KERNEL_CM = KERNELS["bit_multi_step_cm"]
KERNEL_STATIC = KERNELS["bit_multi_step_static"]
KERNEL_STATIC_WORDS = KERNELS["bit_multi_step_static_words"]
KERNEL_STATIC_CM = KERNELS["bit_multi_step_static_cm"]
KERNEL_STATIC_CM_WORDS = KERNELS["bit_multi_step_static_cm_words"]
RESIDENT_MAX_BYTES = 227 * 1024
# False: the row-major and the fixed-rule column-major engines launch the
# present kernels at every shape (the A/B)
BIT_WORDS = True
# The streaming kernel (K = 1): strips of up to STREAM_MAX_STRIP rows, as
# long as the card keeps STREAM_THREADS_PER_SM threads a multiprocessor, in
# blocks of STREAM_THREADS
STREAM_MAX_STRIP = 8
STREAM_THREADS_PER_SM = 512
STREAM_THREADS = 64


# The register-resident instantiations (V, L, R, CL, G) of
# csrc/bit_regs.cuh's BIT_REGS_PLANS: V words a thread, L lanes a row, R rows
# a thread, clusters of CL blocks, G generations an exchange.  Whole
# universes a block at 1, 2, 4 and 8 words a row, 4 rows a thread or 1; the
# cluster split, and its size-1 instance (the host build's)
REGS_PLANS = built_plans("bit_regs.cuh", "BIT_REGS_PLANS")
# The column-major register-resident instantiations (HW,) of
# csrc/bit_multi_step.cu's BIT_CM_PLANS: HW = H/32 word rows; a thread
# CM_COLUMNS columns (the source's constant of that name)
CM_PLANS = built_plans("bit_multi_step.cu", "BIT_CM_PLANS")
CM_COLUMNS = 8
REGS_MAX_THREADS = 256
# a universe of 8 words a row split over a cluster of 16 blocks, two
# generations an exchange
CLUSTER_PLAN = (2, 4, 1, 16, 2)
# whole universes a block: the rows a thread in order of preference, with
# the rule as data and with it fixed at compile time (the first that divides
# the rows and whose instantiation REGS_PLANS has; one generation an
# exchange).  With Life fixed at bench.py's 4096 x 256², 128 generations, on
# an H100: 8 rows 1.447 ms, 4 rows 1.468, one row 2.179; two generations an
# exchange at 4 and 8 rows 1.956 and 1.728 (scripts/port_ab.py static-plans).
REGS_ROWS = {False: (4, 1), True: (8, 4, 1)}

bit_multi_step_static_plain = bitpack.bit_multi_step_static
bit_multi_step_static_cm_plain = bitpack.bit_multi_step_static_cm
bit_multi_step_cm_plain = bitpack.bit_multi_step_cm

__all__ = ["KERNEL", "KERNEL_CM", "KERNEL_STATIC", "KERNEL_STATIC_CM", "KERNEL_STATIC_CM_WORDS",
           "KERNEL_STATIC_WORDS", "KERNEL_WORDS",
           "bit_multi_step", "bit_multi_step_plain", "bit_multi_step_static",
           "bit_multi_step_static_plain", "bit_multi_step_static_cm",
           "bit_multi_step_static_cm_plain", "bit_multi_step_cm", "bit_multi_step_cm_plain",
           "cm_plan", "resident", "stream_plan", "words_plan"]


def resident(height: int, words: int, pad: int = 0) -> bool:
    """True when a [height, words] universe runs resident in shared memory
    (two uint32 copies, ping-pong, rows padded by ``pad`` words), False for
    the per-generation fallback."""
    return 2 * height * (words + pad) * 4 <= RESIDENT_MAX_BYTES


@functools.lru_cache(maxsize=256)
def stream_plan(n: int, h: int, nw: int, sms: int, aligned: bool = True):
    """("stream", V, S, threads): the streaming kernel's words a thread (a
    16-byte word of 4, or 1 where rows are not whole 16-byte words or
    ``aligned`` is False), rows a strip (doubled while the card keeps
    STREAM_THREADS_PER_SM threads a multiprocessor) and STREAM_THREADS
    threads a block (small blocks spread a small grid evenly over the
    ``sms`` multiprocessors)."""
    v = 4 if nw % 4 == 0 and aligned else 1
    groups = nw // v
    s = 1
    while (s < STREAM_MAX_STRIP and s < h
           and n * groups * -(-h // (2 * s)) >= sms * STREAM_THREADS_PER_SM):
        s *= 2
    return ("stream", v, s, STREAM_THREADS)


def stream_launches(n: int, h: int, nw: int, v: int, s: int) -> int:
    """Launches of one streamed generation: universes in chunks whose items
    (strips x word groups) a 32-bit index covers (bit_words.cuh's
    stream_chunk)."""
    per = -(-h // s) * (nw // v)
    return -(-n // max(1, 2 ** 31 // per))


def _regs_plan(n: int, h: int, nw: int, sms: int, aligned: bool, fixed: bool = False):
    """("regs", V, L, R, CL, G, threads) for K > 1 held in registers, or
    None: a cluster (CLUSTER_PLAN) a universe when there are fewer universes
    than multiprocessors, else whole universes a block, the first of
    REGS_ROWS[fixed] rows a thread that divides the rows."""
    if nw >= 4 and not aligned:
        return None
    v, l, r, cl, g = CLUSTER_PLAN
    per = h // cl // r * l
    if (nw == v * l and n < sms and h % (cl * r) == 0 and per % 32 == 0
            and per <= REGS_MAX_THREADS and h // cl // r >= g):
        return ("regs", v, l, r, cl, g, per)
    r = next(r for r in REGS_ROWS[fixed] if h % r == 0 and (nw, 1, r, 1, 1) in REGS_PLANS
             or r == 1)
    per = h // r
    if per > REGS_MAX_THREADS or (nw, 1, r, 1, 1) not in REGS_PLANS:
        return None
    return ("regs", nw, 1, r, 1, 1, per * min(n, REGS_MAX_THREADS // per))


@functools.lru_cache(maxsize=256)
def words_plan(n: int, h: int, nw: int, steps: int, sms: int, aligned: bool = True,
               fixed: bool = False):
    """The redesigned kernels' plan for K = ``steps`` generations on [n, h,
    nw] words (module note), decided by the shape, the card's ``sms``
    multiprocessors, whether the words are 16-byte aligned and whether the
    rule is ``fixed`` at compile time; None where the present kernel keeps the
    shape (K > 1 on a universe that two copies of fit shared memory but the
    registers do not)."""
    if steps <= 1:
        return stream_plan(n, h, nw, sms, aligned)
    plan = _regs_plan(n, h, nw, sms, aligned, fixed)
    if plan is not None:
        return plan
    return None if resident(h, nw) else stream_plan(n, h, nw, sms, aligned)


@functools.lru_cache(maxsize=256)
def cm_plan(n: int, hw: int, w: int, steps: int, aligned: bool = True):
    """("cm", HW, threads): the redesigned column-major kernel's plan for K =
    ``steps`` >= 1 generations on [n, hw, w] words that are 16-byte aligned:
    CM_COLUMNS columns a thread, the width a power of two of lanes up to a
    warp's, word rows that CM_PLANS has; whole universes a block, the threads
    rounded up to whole warps.  None where the present kernel keeps the
    shape."""
    lanes = w // CM_COLUMNS
    if (steps < 1 or not aligned or w % CM_COLUMNS or not 1 <= lanes <= 32
            or lanes & (lanes - 1) or (hw,) not in CM_PLANS):
        return None
    threads = lanes * min(n, REGS_MAX_THREADS // lanes)
    return ("cm", hw, -(-threads // 32) * 32)


def _static_define(birth, survive) -> tuple:
    """The ``-D`` define of the fixed-rule library for a B/S rule."""
    return (f"STATIC_RULE={pack_rule_bits(birth, survive):#07x}",)


def _words_kernel(packed: torch.Tensor, rule_bits, num_steps: int, plan=None,
                  fixed=None) -> torch.Tensor:
    """bit_words_launch on ``packed`` by ``plan`` (default :func:`words_plan`,
    or where that leaves the shape to the present kernel, the streaming kernel
    a generation a launch); ``fixed`` (birth, survive) launches the fixed-rule
    library's bit_static_words_launch instead (``rule_bits`` unused).  K = 0
    copies without a launch."""
    steps = int(num_steps)
    if steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {steps}")
    if packed.dtype != torch.uint32 or packed.ndim != 3 or not packed.is_contiguous():
        raise ValueError("bit_multi_step: packed must be a contiguous uint32 [inst, H, W/32] "
                         "tensor")
    n, h, nw = packed.shape
    if fixed is None:
        rule = rule_tensor(rule_bits, packed)
        kernel, head, defines = (KERNEL_WORDS,
                                 (packed.data_ptr(), rule.data_ptr(), int(rule.ndim == 1)), ())
    else:
        kernel, head, defines = KERNEL_STATIC_WORDS, (packed.data_ptr(),), _static_define(*fixed)
    out = torch.empty_like(packed)
    if steps == 0:
        return out.copy_(packed)
    if plan is None:
        sms, aligned = _multiprocessors(packed.device), packed.data_ptr() % 16 == 0
        plan = (words_plan(n, h, nw, steps, sms, aligned, fixed is not None)
                or stream_plan(n, h, nw, sms, aligned))
    device, stream = stream_args(packed)
    if plan[0] == "stream":
        _, v, s, threads = plan
        scratch = torch.empty_like(packed) if steps > 1 else out
        kernel.launch(*head, out.data_ptr(), scratch.data_ptr(), n, h, nw, steps, 0, v, 1, 1, 1,
                      1, s, threads, device, stream,
                      count=steps * stream_launches(n, h, nw, v, s), defines=defines)
    else:
        _, v, l, r, cl, g, threads = plan
        kernel.launch(*head, out.data_ptr(), out.data_ptr(), n, h, nw, steps, 1, v, l, r, cl, g,
                      1, threads, device, stream, defines=defines)
    return out


def _cm_words_kernel(packed_cm: torch.Tensor, birth, survive, num_steps: int,
                    plan=None) -> torch.Tensor:
    """bit_static_cm_words_launch on the column-major words by ``plan``
    (default :func:`cm_plan`; raises where it leaves the shape to the present
    kernel).  K = 0 copies without a launch."""
    steps = int(num_steps)
    if steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {steps}")
    if packed_cm.dtype != torch.uint32 or packed_cm.ndim != 3 or not packed_cm.is_contiguous():
        raise ValueError("bit_multi_step_static_cm: packed must be a contiguous uint32 "
                         "[inst, H/32, W] tensor")
    n, hw, w = packed_cm.shape
    out = torch.empty_like(packed_cm)
    if steps == 0:
        return out.copy_(packed_cm)
    plan = plan or cm_plan(n, hw, w, steps, packed_cm.data_ptr() % 16 == 0)
    if plan is None:
        raise ValueError(f"no column-major register plan holds [{n}, {hw}, {w}] words")
    _, plan_hw, threads = plan
    if plan_hw != hw:
        raise ValueError(f"plan {plan} is for {plan_hw} word rows, not {hw}")
    device, stream = stream_args(packed_cm)
    KERNEL_STATIC_CM_WORDS.launch(packed_cm.data_ptr(), out.data_ptr(), n, hw, w, steps,
                                  threads, device, stream,
                                  defines=_static_define(birth, survive))
    return out


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
                  defines=_static_define(birth, survive))
    return out


def bit_multi_step(packed: torch.Tensor, rule_bits,
                   num_steps: int) -> torch.Tensor:
    """``num_steps`` generations on a uint32 [inst, H, W/32] packed grid; the
    rule is a scalar or an [inst] vector."""
    if _device_of(packed, "bit_multi_step") == "cpu":
        return bit_multi_step_plain(packed, rule_bits, num_steps)
    if BIT_WORDS and packed.ndim == 3:
        n, h, nw = packed.shape
        plan = words_plan(n, h, nw, int(num_steps), _multiprocessors(packed.device),
                          packed.data_ptr() % 16 == 0)
        if plan is not None:
            return _words_kernel(packed, rule_bits, num_steps, plan)
    return _data_rule(KERNEL, packed, rule_bits, num_steps, False, "[inst, H, W/32]")


def bit_multi_step_static(packed: torch.Tensor, birth, survive, num_steps: int,
                          scheme: str = "vc16") -> torch.Tensor:
    """``num_steps`` generations on a uint32 [inst, H, W/32] packed grid with
    the B/S rule (digit lists) fixed at compile time.  ``scheme`` is ignored
    (module note)."""
    if _device_of(packed, "bit_multi_step_static") == "cpu":
        return bit_multi_step_static_plain(packed, birth, survive, num_steps)
    if BIT_WORDS and packed.ndim == 3:
        n, h, nw = packed.shape
        plan = words_plan(n, h, nw, int(num_steps), _multiprocessors(packed.device),
                          packed.data_ptr() % 16 == 0, True)
        if plan is not None:
            return _words_kernel(packed, None, num_steps, plan, (birth, survive))
    return _static_rule(KERNEL_STATIC, packed, birth, survive, num_steps, False,
                        "[inst, H, W/32]")


def bit_multi_step_static_cm(packed_cm: torch.Tensor, birth, survive,
                             num_steps: int) -> torch.Tensor:
    """``num_steps`` generations on a column-major uint32 [inst, H/32, W]
    grid with the B/S rule fixed at compile time."""
    if _device_of(packed_cm, "bit_multi_step_static_cm") == "cpu":
        return bit_multi_step_static_cm_plain(packed_cm, birth, survive, num_steps)
    if BIT_WORDS and packed_cm.ndim == 3:
        plan = cm_plan(*packed_cm.shape, int(num_steps), packed_cm.data_ptr() % 16 == 0)
        if plan is not None:
            return _cm_words_kernel(packed_cm, birth, survive, num_steps, plan)
    return _static_rule(KERNEL_STATIC_CM, packed_cm, birth, survive, num_steps, True,
                        "[inst, H/32, W]")


def bit_multi_step_cm(packed_cm: torch.Tensor, rule_bits,
                      num_steps: int) -> torch.Tensor:
    """``num_steps`` generations on a column-major uint32 [inst, H/32, W]
    grid; the rule is a scalar or an [inst] vector."""
    if _device_of(packed_cm, "bit_multi_step_cm") == "cpu":
        return bit_multi_step_cm_plain(packed_cm, rule_bits, num_steps)
    return _data_rule(KERNEL_CM, packed_cm, rule_bits, num_steps, True, "[inst, H/32, W]")
