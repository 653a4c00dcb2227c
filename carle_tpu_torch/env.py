"""CARLE environment — functional core (counterpart of carle_tpu/env.py:45-151).

Behavioural contract, as the JAX package:

* toggle actions are XOR'd into a centred action window — ANY nonzero value
  toggles;
* the master reset fires iff the float32 mean of the action VALUES over the
  whole batch equals 1.0 exactly: all-ones resets every universe, all-2.0
  only toggles;
* the CA update is a Moore count + B/S rule lookup on a torus, through the
  ``ca_step`` kernel on the card (ops/cuda_ca.py);
* the base env emits zero reward and never sets done.

The ``CARLE`` class shell is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import rules as rules_mod
from .config import EnvConfig
from .device import DeviceLike, resolve_device
from .ops.bitpack import pack_grid, unpack_grid
from .ops.cuda_bitpack import bit_multi_step
from .ops.cuda_ca import ca_step


class EnvState(NamedTuple):
    """Environment state; rules are data (an int32 scalar or [instances])."""

    grid: torch.Tensor                # uint8 [instances, H, W]
    rule_bits: torch.Tensor           # int32 scalar or [instances]
    step_num: torch.Tensor            # int32 scalar
    steps_since_action: torch.Tensor  # int32 scalar


def init_state(config: EnvConfig, rule_bits=rules_mod.LIFE,
               device: DeviceLike = None) -> EnvState:
    dev = resolve_device(device)
    return EnvState(
        grid=torch.zeros(config.grid_shape, dtype=torch.uint8, device=dev),
        rule_bits=torch.as_tensor(rule_bits, dtype=torch.int32, device=dev),
        step_num=torch.zeros((), dtype=torch.int32, device=dev),
        steps_since_action=torch.zeros((), dtype=torch.int32, device=dev),
    )


def reset_state(state: EnvState) -> EnvState:
    """Zero the universe, keep the ruleset."""
    return EnvState(
        grid=torch.zeros_like(state.grid),
        rule_bits=state.rule_bits,
        step_num=torch.zeros_like(state.step_num),
        steps_since_action=torch.zeros_like(state.steps_since_action),
    )


def env_step(state: EnvState, action: torch.Tensor,
             config: EnvConfig) -> Tuple[EnvState, torch.Tensor]:
    """Toggle, (maybe) master-reset, CA update.  ``action`` is
    [instances, AH, AW] of any dtype; returns (new_state, uint8 obs
    [instances, H, W]).  Nothing here waits for the device."""
    toggles = action != 0
    do_reset = action.to(torch.float32).mean() == 1.0
    any_action = toggles.any()

    stepped = ca_step(state.grid, toggles.to(torch.uint8), state.rule_bits, config)
    new_grid = torch.where(do_reset, torch.zeros_like(stepped), stepped)
    zero = torch.zeros_like(state.step_num)
    new_step = torch.where(do_reset, zero, state.step_num + 1)
    new_ssa = torch.where(
        do_reset, zero,
        state.steps_since_action + torch.where(any_action, zero, zero + 1))
    return EnvState(new_grid, state.rule_bits, new_step, new_ssa), new_grid


def multi_step(state: EnvState, num_steps: int,
               config: EnvConfig) -> EnvState:
    """``num_steps`` action-free generations: the packed engine
    (``bit_multi_step`` kernel on the card) for word-aligned widths, else
    ``ca_step`` with an empty action, one generation at a time."""
    grid = state.grid
    if config.width % 32 == 0:
        packed = bit_multi_step(pack_grid(grid), state.rule_bits, num_steps)
        grid = unpack_grid(packed, config.width)
    else:
        blank = torch.zeros(config.action_shape, dtype=torch.uint8,
                            device=grid.device)
        for _ in range(int(num_steps)):
            grid = ca_step(grid, blank, state.rule_bits, config)
    return state._replace(grid=grid, step_num=state.step_num + int(num_steps))
