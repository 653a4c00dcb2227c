"""Rollout loop — agent + env + wrapper stack (counterpart of
carle_tpu/rollout.py).

The JAX package's ``lax.scan`` becomes a Python loop of eager steps that
never waits for the device: rewards stay on the device and are stacked at
the end.  The carry holds one ``torch.Generator`` on the run's device, which
draws the wrappers' initial parameters, the agent's actions and the training
wrappers' plain-PyTorch dropout, and ``drop_seed``, a host counter that
advances every step: the net kernels' dropout seed (where the JAX carry
splits a key a step).  ``run_logged`` and ``run_gif`` run the same steps in
chunks and write episode artifacts; they keep what they log on the device
and copy it to the host once a chunk.

On a mesh spanning processes (parallel/distributed.py) each process runs
the loop over its own instances: the agent's observation, the action and
the rewards are this process's instances' (an agent that reads no
observation acts on the whole batch and the process keeps its instances'
actions, and the plain dropout draws the whole batch's numbers and keeps
this process's rows, ``StepCtx.batch``: so the run equals one process's), and
:meth:`Rollout.gather_rewards` gives the whole batch's rewards on every
process.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import rle as rle_codec
from . import rules as rules_mod
from .agents import Agent
from .config import EnvConfig
from .device import DeviceLike, resolve_device
from .mcl.base import StackState, WrapperDef, WrapperStack
from .parallel import distributed
from .parallel.mesh import local_batch
from .utils.gif import write_gif
from .utils.png import write_png


class RolloutCarry(NamedTuple):
    stack: StackState
    agent_params: Any
    generator: torch.Generator
    drop_seed: int = 0


class Rollout:
    """Binds (config, wrappers, agent) to one device.  ``stack`` swaps the
    state representation (e.g. the bit-packed
    ``parallel.packed_env.PackedSpatialStack``) while the loop stays the same:
    it touches the stack only through init, transition, reset and observe."""

    def __init__(self, config: EnvConfig, wrappers: Sequence[WrapperDef] = (),
                 agent: Optional[Agent] = None, device: DeviceLike = None,
                 stack: Optional[WrapperStack] = None) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.stack = WrapperStack(config, wrappers) if stack is None else stack
        self.agent = agent

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the rollout's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def init(self, generator: torch.Generator, rule_bits,
             agent_params: Any = None) -> RolloutCarry:
        """Build the carry.  ``agent_params`` overrides the agent's own init."""
        stack = self.stack.init(generator, rule_bits, self.device)
        if agent_params is None and self.agent is not None:
            agent_params = self.agent.init(generator)
        return RolloutCarry(stack=stack, agent_params=agent_params,
                            generator=generator,
                            drop_seed=(generator.initial_seed() & 0x7FFFFFFF) << 24)

    def reset(self, carry: RolloutCarry) -> Tuple[RolloutCarry, torch.Tensor]:
        stack, obs = self.stack.reset(carry.stack, carry.generator)
        return carry._replace(stack=stack), obs

    def with_rules(self, carry: RolloutCarry, rule_bits) -> RolloutCarry:
        """Swap rulesets (a scalar or an [instances] vector): a state update."""
        env = carry.stack.env._replace(rule_bits=torch.as_tensor(
            rule_bits, dtype=torch.int32, device=self.device))
        return carry._replace(stack=carry.stack._replace(env=env))

    def _policy_steps(self, carry: RolloutCarry, num_steps: int,
                      record: Optional[Callable[[int, torch.Tensor, Any], None]] = None
                      ) -> Tuple[RolloutCarry, List[torch.Tensor]]:
        """``num_steps`` policy steps; ``record(t, patch, stack)`` sees each
        step's action patch and the stack after it.  Returns (carry, the
        rewards a step)."""
        if self.agent is None:
            raise ValueError("rollout has no agent; use run_actions")
        cfg = self.config
        stack, rewards, seed = carry.stack, [], carry.drop_seed
        batch = local_batch(stack.env.grid)
        n = cfg.instances if batch is None else batch.hi - batch.lo   # this process's
        # an agent that reads no observation acts on the whole batch; a
        # process keeps its instances' actions, so it draws what one would
        rows = slice(None) if batch is None else slice(batch.lo, batch.hi)
        blank = torch.empty((cfg.instances, 1, 0, 0), device=self.device)
        for t in range(int(num_steps)):
            if self.agent.reads_obs:
                action = self.agent.apply(carry.agent_params, carry.generator,
                                          self.stack.observe(stack))
            else:
                action = self.agent.apply(carry.agent_params, carry.generator, blank)[rows]
            patch = action.reshape(n, cfg.eff_action_height, cfg.eff_action_width)
            seed += 1
            stack, _, reward = self.stack.transition(stack, patch, seed, carry.generator)
            rewards.append(reward)
            if record is not None:
                record(t, patch, stack)
        return carry._replace(stack=stack, drop_seed=seed), rewards

    def run(self, carry: RolloutCarry,
            num_steps: int) -> Tuple[RolloutCarry, torch.Tensor]:
        """``num_steps`` policy steps; returns (carry, rewards [steps, inst, 1])."""
        carry, rewards = self._policy_steps(carry, num_steps)
        return carry, self._stack(rewards)

    # -- logged segments: the episode artifacts of the shell's logging -------
    def run_logged(self, carry: RolloutCarry, num_steps: int, snapshot_every: int = 256,
                   instance: int = 0, directory: str = "./logs", save_png: bool = False
                   ) -> Tuple[RolloutCarry, torch.Tensor, str]:
        """:meth:`run` with periodic episode artifacts (what the shell's
        ``logging=True`` gives, reference env.py:466-513).

        Runs in chunks of ``snapshot_every`` steps; after each chunk the
        logged instance's universe and its last action patch (kept on the
        device) are copied to the host and RLE-encoded as one log entry, the
        rule in the header the instance's own.  Writes the reference's CSV
        episode-log format (plus a PNG frame a chunk with ``save_png``) and
        returns (carry, rewards [steps, inst, 1], log_path): the rewards
        :meth:`run` gives from the same carry."""
        if self.agent is None:
            raise ValueError("rollout has no agent; use run_actions")
        exp_id = str(int(time.time()))
        os.makedirs(directory, exist_ok=True)
        last = {}

        def keep_action(t, patch, stack):
            last["action"] = patch[instance]

        entries: List[List[str]] = []
        rewards: List[torch.Tensor] = []
        done = 0
        while done < num_steps:
            k = int(min(snapshot_every, num_steps - done))
            carry, chunk = self._policy_steps(carry, k, keep_action)
            rewards += chunk
            done += k
            grid = self.stack.universe(carry.stack, instance).cpu().numpy()
            action = (last["action"] != 0).to(torch.uint8).cpu().numpy()
            rb = carry.stack.env.rule_bits.cpu().numpy()
            birth, survive = rules_mod.unpack_rule_bits(
                int(rb[instance] if rb.ndim == 1 else rb))
            entries.append([
                rle_codec.encode_grid(action, birth, survive, exp_id=exp_id, step=done,
                                      action=True, torus=action.shape),
                rle_codec.encode_grid(grid, birth, survive, exp_id=exp_id, step=done,
                                      torus=grid.shape),
            ])
            if save_png:
                write_png(os.path.join(directory, f"frame{exp_id}_step{done}.png"),
                          255 * grid)

        log_path = os.path.join(directory, f"carle_log{exp_id}.csv")
        rle_codec.write_log(log_path, entries)
        return carry, self._stack(rewards), log_path

    # -- animated episodes ---------------------------------------------------
    def run_gif(self, carry: RolloutCarry, num_steps: int,
                path: str = "./logs/episode.gif", every: int = 1, instance: int = 0,
                fps: float = 20.0, scale: int = 1, chunk: int = 256,
                mark_actions: bool = True) -> Tuple[RolloutCarry, torch.Tensor, str]:
        """:meth:`run` that also writes the episode of ``instance`` as an
        animated GIF: a frame a step after the step (``every`` downsamples,
        in phase across chunks), the cells the agent toggled that step in
        the palette's highlight colour (index 2) with ``mark_actions``.  The
        frames of a chunk collect on the device and are copied to the host
        once a chunk.  Returns (carry, rewards [steps, inst, 1], path)."""
        if self.agent is None:
            raise ValueError("rollout has no agent; use run_actions")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cfg = self.config
        top, left = cfg.action_row_offset, cfg.action_col_offset
        ah, aw = cfg.eff_action_height, cfg.eff_action_width
        every = max(1, every)
        frames: List[np.ndarray] = []
        rewards: List[torch.Tensor] = []
        done = 0
        while done < num_steps:
            k = int(min(chunk, num_steps - done))
            grids = torch.empty((k, cfg.height, cfg.width), dtype=torch.uint8,
                                device=self.device)
            acts = torch.empty((k, ah, aw), dtype=torch.uint8, device=self.device)

            def record(t, patch, stack):
                grids[t].copy_(self.stack.universe(stack, instance))
                acts[t].copy_(patch[instance] != 0)

            carry, chunk_rewards = self._policy_steps(carry, k, record)
            rewards += chunk_rewards
            if mark_actions:
                window = grids[:, top:top + ah, left:left + aw]
                window.copy_(torch.where(acts != 0, torch.full_like(window, 2), window))
            start = (-done) % every   # phase-correct downsample across chunks
            frames.append(grids[start::every].cpu().numpy())
            done += k
        write_gif(path, np.concatenate(frames), fps=fps, scale=scale)
        return carry, self._stack(rewards), path

    def run_actions(self, carry: RolloutCarry,
                    actions) -> Tuple[RolloutCarry, torch.Tensor]:
        """Drive a pre-built action stream [steps, inst, AH, AW] (on a mesh
        spanning processes the whole batch's or this process's instances)."""
        actions = torch.as_tensor(actions, device=self.device)
        stack, rewards, seed = carry.stack, [], carry.drop_seed
        batch = local_batch(stack.env.grid)
        if batch is not None and actions.shape[1] == batch.n:
            actions = actions[:, batch.lo:batch.hi]
        for action in actions:
            seed += 1
            stack, _, reward = self.stack.transition(stack, action, seed, carry.generator)
            rewards.append(reward)
        return carry._replace(stack=stack, drop_seed=seed), self._stack(rewards)

    def gather_rewards(self, carry: RolloutCarry, rewards: torch.Tensor) -> torch.Tensor:
        """Rewards [steps, inst, 1] of this process's instances as the whole
        batch's, in instance order, on every process (the rewards as they are
        within one process); every process of the mesh must call it."""
        batch = local_batch(carry.stack.env.grid)
        return rewards if batch is None else distributed.batch_gather(rewards, batch, dim=1)

    def _stack(self, rewards) -> torch.Tensor:
        if not rewards:
            return torch.zeros((0, self.config.instances, 1), device=self.device)
        return torch.stack(rewards)
