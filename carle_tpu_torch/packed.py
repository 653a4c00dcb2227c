"""Packed-state environment core: universes stored 32 cells a word
(counterpart of carle_tpu/packed.py).

65k universes of 512 x 512 take 17 GB as uint8 grids but 2.1 GB packed.  This
module keeps the environment state packed from start to finish: toggles XOR
into packed words, the CA update runs on the words, and observations unpack
only when something consumes cells (:func:`observe`).  On the card the one
generation after the XOR is the ``bit_multi_step`` kernel with one step
(ops/cuda_bitpack.py); on the CPU its plain twin.

Trajectories equal the uint8 core's bit for bit (tests/test_torch_packed.py).
Packed words are ``torch.uint32``; the few word operations here (XOR, the
reset select) run on ``int32`` views of them, whose bits are the same.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .config import EnvConfig
from .device import DeviceLike, resolve_device
from .env import EnvState, reset_flags
from .ops.bitpack import WORD, pack_grid, unpack_grid
from .ops.cuda_bitpack import bit_multi_step


class PackedEnvState(NamedTuple):
    """Environment state with the universe packed [inst, H, W//32] uint32."""

    grid: torch.Tensor                # uint32 [instances, H, W//32]
    rule_bits: torch.Tensor           # int32 scalar or [instances]
    step_num: torch.Tensor            # int32 scalar
    steps_since_action: torch.Tensor  # int32 scalar

    per_instance_fields = ("grid", "rule_bits")   # parallel/mesh.py PER_INSTANCE


def _check_width(config: EnvConfig) -> None:
    if config.width % WORD:
        raise ValueError(f"packed core needs width % {WORD} == 0, got {config.width}")


def init_packed_state(config: EnvConfig, rule_bits, device: DeviceLike = None) -> PackedEnvState:
    _check_width(config)
    dev = resolve_device(device)
    return PackedEnvState(
        grid=torch.zeros((config.instances, config.height, config.width // WORD),
                         dtype=torch.uint32, device=dev),
        rule_bits=torch.as_tensor(rule_bits, dtype=torch.int32, device=dev),
        step_num=torch.zeros((), dtype=torch.int32, device=dev),
        steps_since_action=torch.zeros((), dtype=torch.int32, device=dev),
    )


def pack_state(state: EnvState) -> PackedEnvState:
    return PackedEnvState(grid=pack_grid(state.grid), rule_bits=state.rule_bits,
                          step_num=state.step_num,
                          steps_since_action=state.steps_since_action)


def unpack_state(state: PackedEnvState, config: EnvConfig) -> EnvState:
    return EnvState(grid=unpack_grid(state.grid, config.width), rule_bits=state.rule_bits,
                    step_num=state.step_num,
                    steps_since_action=state.steps_since_action)


def observe(state: PackedEnvState, config: EnvConfig) -> torch.Tensor:
    """The observation, unpacked on demand: float32 [inst, 1, H, W]."""
    return unpack_grid(state.grid, config.width).to(torch.float32)[:, None]


def xor_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ^ b of two uint32 word tensors (on int32 views)."""
    return (a.view(torch.int32) ^ b.view(torch.int32)).view(torch.uint32)


def select_words(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where on uint32 words (on int32 views)."""
    return torch.where(cond, a.view(torch.int32), b.view(torch.int32)).view(torch.uint32)


def pack_action_window(action_bits: torch.Tensor, config: EnvConfig
                       ) -> Tuple[torch.Tensor, int, int]:
    """The [inst, AH, AW] toggle patch packed into the words it covers of the
    centred action window: (uint32 [inst, AH, nw], first row, first word).
    A lead pad aligns the window's column offset to a word."""
    inst, ah, aw = action_bits.shape
    if (ah, aw) != (config.eff_action_height, config.eff_action_width):
        raise ValueError(f"action patch is {ah}x{aw}, config window is "
                         f"{config.eff_action_height}x{config.eff_action_width}")
    _check_width(config)
    r0, c0 = config.action_row_offset, config.action_col_offset
    w0 = c0 // WORD
    lead = c0 - w0 * WORD
    nw = -(-(lead + aw) // WORD)
    patch = torch.nn.functional.pad(action_bits.to(torch.uint8),
                                    (lead, nw * WORD - lead - aw))
    return pack_grid(patch), r0, w0


def pack_action(action_bits: torch.Tensor, config: EnvConfig) -> torch.Tensor:
    """[inst, AH, AW] toggle patch -> uint32 [inst, H, W//32] with the patch
    packed into the centred action window.

    Packs only the window's words (:func:`pack_action_window`) and writes them
    into a packed-size zero plane: O(cells/32), where
    ``pack_grid(pad_action(...))`` would build a uint8 universe per step."""
    words, r0, w0 = pack_action_window(action_bits, config)
    inst, ah, nw = words.shape
    out = torch.zeros((inst, config.height, config.width // WORD), dtype=torch.uint32,
                      device=action_bits.device)
    out[:, r0:r0 + ah, w0:w0 + nw] = words
    return out


def packed_transition(state: PackedEnvState, action: torch.Tensor, config: EnvConfig,
                      step_grid: Optional[Callable] = None
                      ) -> Tuple[PackedEnvState, torch.Tensor, Any]:
    """:func:`packed_env_step` returning (state', the binarised uint8 patch,
    the packed toggle plane), which the packed stack's wrappers read.

    ``step_grid(grid, action_bits) -> (stepped grid, toggle plane)`` takes
    the place of the XOR and the generation on one device: the row-sharded
    stack passes its halo step, whose grid is row shards (``.map`` clears
    them shard by shard).  The master reset and the counters are this
    function's either way."""
    action_bits = (action != 0).to(torch.uint8)
    do_reset, any_action = reset_flags(action, state.grid)
    if step_grid is None:
        action_packed = pack_action(action_bits, config)
        stepped = bit_multi_step(xor_words(state.grid, action_packed), state.rule_bits, 1)
    else:
        stepped, action_packed = step_grid(state.grid, action_bits)
    clear = lambda g: select_words(do_reset.to(g.device), torch.zeros_like(g), g)
    new_grid = clear(stepped) if isinstance(stepped, torch.Tensor) else stepped.map(clear)
    zero = torch.zeros_like(state.step_num)
    new_step = torch.where(do_reset, zero, state.step_num + 1)
    new_ssa = torch.where(do_reset, zero,
                          state.steps_since_action + torch.where(any_action, zero, zero + 1))
    return (PackedEnvState(new_grid, state.rule_bits, new_step, new_ssa), action_bits,
            action_packed)


def packed_env_step(state: PackedEnvState, action: torch.Tensor,
                    config: EnvConfig) -> Tuple[PackedEnvState, torch.Tensor]:
    """One transition on packed state, with env.env_step's semantics: XOR
    toggle (any nonzero value), the batch-global master reset iff the float32
    mean of the action VALUES is exactly 1.0, one CA generation.  ``action``
    is [instances, AH, AW]; returns (state', the PACKED grid) — call
    :func:`observe` for cells."""
    new_state = packed_transition(state, action, config)[0]
    return new_state, new_state.grid


def packed_multi_step(state: PackedEnvState, num_steps: int,
                      config: EnvConfig) -> PackedEnvState:
    """``num_steps`` action-free generations, the state packed throughout: one
    ``bit_multi_step`` launch on the card, no pack or unpack."""
    grid = bit_multi_step(state.grid, state.rule_bits, num_steps)
    return state._replace(grid=grid, step_num=state.step_num + int(num_steps))
