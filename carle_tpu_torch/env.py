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
functional core, with its pattern and episode I/O: RLE files, the CSV
episode log (``logging=True``), PNG frames and the ASCII ``render``.  A
universe on the card is read to the host with one copy a call.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import rle as rle_codec
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

    per_instance_fields = ("grid", "rule_bits")   # parallel/mesh.py PER_INSTANCE


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


def reset_flags(action: torch.Tensor, grid: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """(master reset, any toggle) of a step, 0-d bool tensors on the action's
    device, over the whole batch.  On one process the reset is the float32
    mean of the action values == 1.0.  On a mesh spanning processes (a
    ``grid`` of row shards, parallel/distributed.py) each process adds its
    instances' value sum and count in float64 (each instance counted by one
    process, ``mesh.local_batch``), one ``all_reduce`` adds the processes',
    and the flag is sum / count == 1.0: the exact mean of 0/1 (or any
    integer-valued) actions either way; it can differ from the float32 mean
    only where that rounds to 1.0 and the exact mean does not (values within
    about 2**-24 of an all-ones batch), or where float32 accumulation over
    more than 2**24 cells rounds.  The flag goes to every ring."""
    from .parallel.mesh import local_batch

    toggles = action != 0
    batch = local_batch(grid)
    if batch is None:
        return action.to(torch.float32).mean() == 1.0, toggles.any()
    from .parallel import distributed

    owned = batch.owned.to(action.device)
    inst = action.shape[0]
    mine = lambda t: torch.where(owned, t, torch.zeros_like(t)).sum()  # noqa: E731
    values = action.to(torch.float64).reshape(inst, -1)
    sums = torch.stack([mine(values.sum(dim=1)),
                        mine(torch.full((inst,), float(values.shape[1]), dtype=torch.float64,
                                        device=action.device)),
                        mine(toggles.reshape(inst, -1).sum(dim=1).to(torch.float64))])
    total, count, toggled = distributed.all_reduce(sums)
    return total / count == 1.0, toggled > 0


def env_step(state: EnvState, action: torch.Tensor,
             config: EnvConfig) -> Tuple[EnvState, torch.Tensor]:
    """Toggle, (maybe) master-reset, CA update.  ``action`` is
    [instances, AH, AW] of any dtype; returns (new_state, uint8 obs
    [instances, H, W]).  A grid of row shards (parallel/mesh.py) steps on
    its shards, one halo launch a device, and the obs is those shards; on a
    mesh spanning processes ``action`` is this process's instances and the
    master reset is the whole batch's (:func:`reset_flags`).  Nothing here
    waits for the device (but the reset's ``all_reduce`` across processes)."""
    toggles = action != 0
    do_reset, any_action = reset_flags(action, state.grid)

    # the kernel binarises the bytes itself and writes zeros under the reset
    # flag, so no pass over the grid runs beside it
    patch = (action if action.dtype == torch.uint8 else toggles.view(torch.uint8)).contiguous()
    if isinstance(state.grid, torch.Tensor):
        new_grid = ca_step(state.grid, patch, state.rule_bits, config, reset=do_reset)
    else:   # row shards: the spatial env mode (parallel/spatial_env.py)
        from .parallel.cuda_halo import spatial_env_step_cuda

        new_grid = spatial_env_step_cuda(state.grid, patch, state.rule_bits, config,
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
    action_height, instances, logging; use_cuda, use_grad and alive_rate are
    accepted and unused) plus ``device`` (the card unless ``"cpu"``).
    With ``logging`` each step appends instance 0's action and universe (the
    universe before the step) to ``log`` as RLE text; ``save_log`` writes it.
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
        self.log: List[List[str]] = []
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
        self.log = []

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

        if self.logging:
            self.log_universe()

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

    # the step on the shell's device, which wrappers call (a subclass may
    # change what ``step`` returns: the compat facade's host tensors)
    _step = step

    def multi_step(self, num_steps: int) -> torch.Tensor:
        """``num_steps`` action-free generations as one call (the packed
        kernel on the card for word-aligned widths); returns the observation."""
        self.state = multi_step(self.state, num_steps, self.config)
        self.step_number += num_steps
        self.steps_since_action += num_steps
        return self.universe

    def render(self) -> None:
        """ASCII render of instance 0 (reference env.py:244-258)."""
        os.system("clear")
        print("\n CA Universe")
        for row in self.state.grid[0].cpu().numpy():
            print("".join("o" if c else " " for c in row))
        time.sleep(0.125)

    # --- pattern / episode I/O (reference env.py:260-513) -------------------
    def get_rle(self, universe: Any, action: bool = False) -> str:
        """A universe or action patch ([H, W] or with leading unit axes;
        numpy or a tensor on any device) as the reference's RLE text."""
        grid = universe.cpu().numpy() if torch.is_tensor(universe) else np.asarray(universe)
        grid = grid.reshape(grid.shape[-2], grid.shape[-1])
        return rle_codec.encode_grid(grid, self._birth, self._survive,
                                     exp_id=self.instance_id, step=self.step_number,
                                     action=action, torus=(self.height, self.width))

    def read_rle(self, filepath: str) -> str:
        """Read an RLE file, adopt its ruleset, return the body text (the
        reference's ``rle_to_grid(env.read_rle(path))`` chain); the decoded
        pattern is kept on ``self._last_pattern``."""
        pattern = rle_codec.read_rle(filepath)
        self.birth = pattern.birth
        self.survive = pattern.survive
        self._last_pattern = pattern
        return pattern.body

    def rle_to_grid(self, rle_text: Any) -> np.ndarray:
        """Decode an RLE body or file text (or an :class:`~carle_tpu_torch.rle.RLEPattern`)
        to a uint8 grid (reference env.py:260-328; MorphoBonus reads patterns
        through it)."""
        if isinstance(rle_text, rle_codec.RLEPattern):
            return rle_text.grid
        return rle_codec.parse_rle_text(rle_text).grid

    def action_padding(self, action: Any) -> np.ndarray:
        """Zero-pad an action patch into the centred window of a full-size
        grid (the reference's nn.ZeroPad2d attribute, env.py:130)."""
        arr = action.cpu().numpy() if torch.is_tensor(action) else np.asarray(action)
        lead = arr.shape[:-2]
        arr2 = arr.reshape((-1,) + arr.shape[-2:])
        padded = np.zeros((arr2.shape[0], self.height, self.width), dtype=arr.dtype)
        r0, c0 = self.config.action_row_offset, self.config.action_col_offset
        padded[:, r0:r0 + arr2.shape[1], c0:c0 + arr2.shape[2]] = arr2
        return padded.reshape(lead + (self.height, self.width))

    def read_csv(self, filepath: str) -> List[List[str]]:
        """An episode log read back as (action_rle, universe_rle) pairs (the
        reference's read_csv is a stub, env.py:384-388)."""
        return [list(p) for p in rle_codec.read_log(filepath)]

    def load_universe(self, filepath: str, universe_index: int = 0) -> None:
        """Load an RLE file of the universe's size into one instance and adopt
        its ruleset."""
        self.read_rle(filepath)
        g = self._last_pattern.grid
        if g.shape != (self.height, self.width):
            raise ValueError(f"tried to load the wrong size universe: {g.shape} vs "
                             f"{(self.height, self.width)}")
        grid = self.state.grid.clone()
        grid[universe_index] = torch.from_numpy(g).to(grid.device)
        self.state = self.state._replace(grid=grid)

    def log_universe(self, universe_index: int = 0) -> None:
        """Append (action, universe) of one instance to ``log`` as RLE text."""
        rle_universe = self.get_rle(self.state.grid[universe_index])
        act = self.action if self.action is not None else np.zeros(
            (self.instances, self.action_height, self.action_width), dtype=np.uint8)
        rle_action = self.get_rle(act[universe_index], action=True)
        self.log.append([rle_action, rle_universe])

    def save_log(self, directory: str = "./logs") -> str:
        """Write ``log`` as the reference's CSV episode log; returns its path."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"carle_log{self.instance_id}.csv")
        rle_codec.write_log(path, self.log)
        return path

    def save_rle(self, rle: str, directory: str = "./logs") -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory,
                            f"universe{self.instance_id}_step{self.step_number}.rle")
        with open(path, "w") as f:
            f.write(rle)
        return path

    def save_frame(self, directory: str = "./frames") -> str:
        """Instance 0 as a grayscale PNG; returns its path."""
        from .utils.png import write_png

        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory,
                            f"frame{self.instance_id}_step{self.step_number}.png")
        write_png(path, 255 * self.state.grid[0].cpu().numpy())
        return path

    # --- torch-compat shims ---------------------------------------------------
    def eval(self) -> "CARLE":
        return self

    def train(self) -> "CARLE":
        return self

    def to(self, *a: Any, **k: Any) -> "CARLE":
        return self


def _main(argv: Optional[List[str]] = None) -> None:
    """Demo and throughput sweep (reference env.py:517-573): a glider,
    the RLE, log and frame files and an RLE round trip, then
    'CA updates per second with {N}x vectorization' for 1, 64 and 1024
    instances (each step a host round trip, as the shell runs).

        python -m carle_tpu_torch.env [--device cpu] [--logs DIR] [--frames DIR]
    """
    import argparse

    parser = argparse.ArgumentParser(description=_main.__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--logs", default="./logs")
    parser.add_argument("--frames", default="./frames")
    parser.add_argument("--instances", type=int, nargs="*", default=[1, 64, 1024])
    args = parser.parse_args(argv)
    env = CARLE(logging=True, device=args.device)
    env.reset()
    action = np.zeros((1, 1, 64, 64), dtype=np.float32)
    action[0, 0, 14, 16] = 1.0
    action[0, 0, 15, 16:18] = 1.0
    action[0, 0, 16, 15:18:2] = 1.0
    env.step(action)
    for _ in range(2):
        env.step(action * 0)

    rle_path = env.save_rle(env.get_rle(env.state.grid[0]), args.logs)
    env.save_frame(args.frames)
    env.save_log(args.logs)

    env2 = CARLE(device=args.device)
    env2.reset()
    env2.load_universe(rle_path)
    if int(env2.state.grid.sum()) != 5:
        raise AssertionError("the glider did not survive the RLE round trip")

    for instances in args.instances:
        env = CARLE(instances=instances, device=args.device)
        env.reset()
        zeros = np.zeros((instances, 1, 64, 64), dtype=np.float32)
        env.step(zeros)  # warm-up: the kernel's first launch builds it
        steps = 256
        if env.device.type == "cuda":
            torch.cuda.synchronize(env.device)
        t0 = time.time()
        for _ in range(steps):
            env.step(zeros)
        if env.device.type == "cuda":
            torch.cuda.synchronize(env.device)
        dt = time.time() - t0
        print("{:.2f} CA updates per second with {}x vectorization".format(
            steps / dt, instances))


if __name__ == "__main__":
    _main()
