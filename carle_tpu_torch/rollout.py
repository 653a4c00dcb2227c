"""Rollout loop — agent + env + wrapper stack (counterpart of
carle_tpu/rollout.py:33-122, 294-304).

The JAX package's ``lax.scan`` becomes a Python loop of eager steps that
never waits for the device: rewards stay on the device and are stacked at
the end.  The carry holds one ``torch.Generator`` on the run's device, which
draws the wrappers' initial parameters, the agent's actions and the training
wrappers' plain-PyTorch dropout, and ``drop_seed``, a host counter that
advances every step: the net kernels' dropout seed (where the JAX carry
splits a key a step).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from .agents import Agent
from .config import EnvConfig
from .device import DeviceLike, resolve_device
from .mcl.base import StackState, WrapperDef, WrapperStack


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

    def run(self, carry: RolloutCarry,
            num_steps: int) -> Tuple[RolloutCarry, torch.Tensor]:
        """``num_steps`` policy steps; returns (carry, rewards [steps, inst, 1])."""
        if self.agent is None:
            raise ValueError("rollout has no agent; use run_actions")
        cfg = self.config
        stack, rewards, seed = carry.stack, [], carry.drop_seed
        blank = torch.empty((cfg.instances, 1, 0, 0), device=self.device)
        for _ in range(int(num_steps)):
            obs = self.stack.observe(stack) if self.agent.reads_obs else blank
            action = self.agent.apply(carry.agent_params, carry.generator, obs)
            patch = action.reshape(cfg.instances, cfg.eff_action_height,
                                   cfg.eff_action_width)
            seed += 1
            stack, _, reward = self.stack.transition(stack, patch, seed, carry.generator)
            rewards.append(reward)
        return carry._replace(stack=stack, drop_seed=seed), self._stack(rewards)

    def run_actions(self, carry: RolloutCarry,
                    actions) -> Tuple[RolloutCarry, torch.Tensor]:
        """Drive a pre-built action stream [steps, inst, AH, AW]."""
        actions = torch.as_tensor(actions, device=self.device)
        stack, rewards, seed = carry.stack, [], carry.drop_seed
        for action in actions:
            seed += 1
            stack, _, reward = self.stack.transition(stack, action, seed, carry.generator)
            rewards.append(reward)
        return carry._replace(stack=stack, drop_seed=seed), self._stack(rewards)

    def _stack(self, rewards) -> torch.Tensor:
        if not rewards:
            return torch.zeros((0, self.config.instances, 1), device=self.device)
        return torch.stack(rewards)
