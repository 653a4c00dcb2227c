"""CARLE environment — functional core (counterpart of carle_tpu/env.py:45-151).

Behavioural contract, as the JAX package:

* toggle actions are XOR'd into a centred action window — ANY nonzero value
  toggles;
* the master reset fires iff the float32 mean of the action VALUES over the
  whole batch equals 1.0 exactly: all-ones resets every universe, all-2.0
  only toggles;
* the CA update is a Moore count + B/S rule lookup on a torus, through the
  ``ca_step`` kernels on the card (ops/cuda_ca.py), which also apply the
  master reset from its device flag;
* the base env emits zero reward and never sets done.

:class:`CARLE` is the stateful shell with the reference's class API over the
functional core; its file I/O (RLE, CSV log, PNG frames, ``render``) is not
ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
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

    # the kernel binarises the bytes itself and writes zeros under the reset
    # flag, so no pass over the grid runs beside it
    patch = action if action.dtype == torch.uint8 else toggles.view(torch.uint8)
    new_grid = ca_step(state.grid, patch.contiguous(), state.rule_bits, config,
                       reset=do_reset)
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


# ---------------------------------------------------------------------------
# Stateful shell — reference-compatible class API
# ---------------------------------------------------------------------------


class CARLE:
    """Gym-like shell over the functional core (reference carle/env.py).

    Accepts the reference's keyword arguments (width, height, action_width,
    action_height, instances; use_cuda, use_grad, alive_rate and logging are
    accepted and unused) plus ``device`` (the card unless ``"cpu"``).
    ``birth`` / ``survive`` are properties that repack the rule mask in the
    state.  Actions are taken as the reference's scripts give them (numpy,
    torch, lists) and coerced on the host, so each ``step`` is a host round
    trip; the rollout loop (rollout.py) is the path that never waits.
    """

    def __init__(self, **kwargs: Any) -> None:
        self.inner_env: Optional["CARLE"] = None  # wrapper protocol
        self.config = EnvConfig(
            width=kwargs.get("width", 256),
            height=kwargs.get("height", 256),
            action_width=kwargs.get("action_width", 64),
            action_height=kwargs.get("action_height", 64),
            instances=kwargs.get("instances", 1),
        ).validate()
        self.device = resolve_device(kwargs.get("device"))
        self.use_cuda = kwargs.get("use_cuda", False)
        self.use_grad = kwargs.get("use_grad", False)
        self.alive_rate = kwargs.get("alive_rate", 0.0)
        self.logging = kwargs.get("logging", False)

        self.allowed_rules = [str(n) for n in range(9)]
        self._birth: List[int] = [3]
        self._survive: List[int] = [2, 3]
        self.state = init_state(self.config, self._packed_bits(), self.device)

        self.instance_id = str(int(time.time()))
        self.step_number = 0
        self.steps_since_action = 0
        self.action: Optional[np.ndarray] = None

    # --- geometry passthroughs (reference attribute names) ----------------
    @property
    def my_device(self) -> str:
        return str(self.device)

    @property
    def width(self) -> int:
        return self.config.width

    @property
    def height(self) -> int:
        return self.config.height

    @property
    def action_width(self) -> int:
        return self.config.eff_action_width

    @property
    def action_height(self) -> int:
        return self.config.eff_action_height

    @property
    def instances(self) -> int:
        return self.config.instances

    # --- rules as mutable attributes ---------------------------------------
    def _packed_bits(self) -> int:
        return rules_mod.pack_rule_bits(self._birth, self._survive)

    def _sync_rule_bits(self) -> None:
        self.state = self.state._replace(rule_bits=torch.as_tensor(
            self._packed_bits(), dtype=torch.int32, device=self.device))

    @property
    def birth(self) -> List[int]:
        return self._birth

    @birth.setter
    def birth(self, digits: List[int]) -> None:
        self._birth = sorted(set(int(d) for d in digits))
        self._sync_rule_bits()

    @property
    def survive(self) -> List[int]:
        return self._survive

    @survive.setter
    def survive(self, digits: List[int]) -> None:
        self._survive = sorted(set(int(d) for d in digits))
        self._sync_rule_bits()

    def birth_rule_from_string(self, my_string: str = "B3") -> None:
        self.birth = rules_mod.parse_digits(my_string)

    def survive_rule_from_string(self, my_string: str = "S23") -> None:
        self.survive = rules_mod.parse_digits(my_string)

    def rules_from_string(self, my_string: str = "B3/S23") -> None:
        b, s = rules_mod.parse_rulestring(my_string)
        self.birth = b
        self.survive = s

    # --- universe access ---------------------------------------------------
    @property
    def universe(self) -> torch.Tensor:
        """float32 [instances, 1, H, W] view, the reference's tensor layout."""
        return self.state.grid.to(torch.float32)[:, None, :, :]

    @universe.setter
    def universe(self, value: Any) -> None:
        arr = torch.as_tensor(value).reshape(self.instances, self.height, self.width)
        self.state = self.state._replace(
            grid=(arr != 0).to(device=self.device, dtype=torch.uint8))

    def get_observation(self) -> torch.Tensor:
        return self.universe

    # --- gym API -------------------------------------------------------------
    def _reset_bookkeeping(self) -> None:
        self.instance_id = str(int(time.time()))
        self.step_number = 0
        self.steps_since_action = 0

    def reset(self) -> torch.Tensor:
        self.state = reset_state(self.state)
        self._reset_bookkeeping()
        return self.universe

    def _coerce_action(self, action: Any) -> np.ndarray:
        """Coerce array-likes to a raw-VALUED [inst, AH, AW] patch on the host
        (input dtype preserved: the toggle and master-reset semantics depend
        on the un-binarised values), centre-cropping oversized actions like
        the reference."""
        if hasattr(action, "detach"):
            action = action.detach().cpu().numpy()
        arr = np.atleast_2d(np.asarray(action))
        if arr.ndim == 2:
            arr = arr[None, None]
        elif arr.ndim == 3:
            # [inst|1, H, W] (the functional core's layout): the channel axis
            # goes at position 1, not the front
            arr = arr[:, None]
        ah, aw = self.action_height, self.action_width
        if arr.shape[2] > ah or arr.shape[3] > aw:
            # centre-crop from the action's own extent: the reference's
            # universe-offset crop for full-size actions, and well defined
            # for any intermediate size
            off_r = max((arr.shape[2] - ah) // 2, 0)
            off_c = max((arr.shape[3] - aw) // 2, 0)
            arr = arr[:, :, off_r:off_r + ah, off_c:off_c + aw]
        if arr.shape[0] == 1 and self.instances > 1:
            arr = np.broadcast_to(arr, (self.instances,) + arr.shape[1:])
        assert arr.shape[2] == ah and arr.shape[3] == aw, (
            f"action window is {arr.shape[2]}x{arr.shape[3]}, expected {ah}x{aw}")
        return arr.reshape(self.instances, ah, aw)

    def step(self, action: Any
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[Dict[str, Any]]]:
        if hasattr(action, "detach"):
            action = action.detach().cpu().numpy()
        raw = np.asarray(action)
        patch = self._coerce_action(raw)  # raw VALUES, centre-cropped
        self.action = (patch != 0).astype(np.uint8)

        # The master reset fires iff the mean of the UNCROPPED action VALUES
        # is exactly 1.0: an all-ones window inside a full-frame action only
        # toggles, and 2.0-valued toggles never reset.  env_step sees the
        # cropped patch, so reconcile: force all ones when the raw action says
        # reset (the reset wipes the universe anyway), and scale by 2 (same
        # nonzero toggles, mean != 1) when only the crop says reset.
        was_reset_pending = float(np.mean(raw.astype(np.float32))) == 1.0
        dev_patch = patch.astype(np.float32)
        crop_mean = float(np.mean(dev_patch))
        if was_reset_pending and crop_mean != 1.0:
            dev_patch = np.ones_like(dev_patch)
        elif crop_mean == 1.0 and not was_reset_pending:
            dev_patch = dev_patch * 2.0

        self.state, _ = env_step(
            self.state, torch.from_numpy(np.ascontiguousarray(dev_patch)).to(self.device),
            self.config)

        if was_reset_pending:
            self._reset_bookkeeping()
        else:
            self.step_number += 1
            if not patch.any():
                self.steps_since_action += 1

        zeros = torch.zeros((self.instances, 1), dtype=torch.float32, device=self.device)
        info: List[Dict[str, Any]] = [{} for _ in range(self.instances)]
        return self.universe, zeros, zeros.clone(), info

    def multi_step(self, num_steps: int) -> torch.Tensor:
        """``num_steps`` action-free generations as one call (the packed
        kernel on the card for word-aligned widths); returns the observation."""
        self.state = multi_step(self.state, num_steps, self.config)
        self.step_number += num_steps
        self.steps_since_action += num_steps
        return self.universe

    # --- torch-compat shims ---------------------------------------------------
    def eval(self) -> "CARLE":
        return self

    def train(self) -> "CARLE":
        return self

    def to(self, *a: Any, **k: Any) -> "CARLE":
        return self
