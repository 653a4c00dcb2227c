"""Baseline agents (counterpart of carle_tpu/agents.py:56-68).

An agent is a pair ``init(generator) -> params`` / ``apply(params,
generator, obs) -> action``: a float observation [inst, 1, H, W] maps to a
float 0/1 action [inst, 1, AH, AW] (rows first).  Randomness comes from the
explicit ``torch.Generator``, which lives on the observation's device.  An
agent that does not read the cells (``reads_obs=False``) is given a
zero-size [inst, 1, 0, 0] observation on the right device, so a rollout
builds no observation for it (on a packed stack, no unpack).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Agent(NamedTuple):
    init: Callable[[torch.Generator], Any]
    apply: Callable[[Any, torch.Generator, torch.Tensor], torch.Tensor]
    reads_obs: bool = True


def make_random_agent(action_width: int = 64, action_height: int = 64,
                      toggle_rate: float = 0.1) -> Agent:
    """Bernoulli(toggle_rate) toggles over the action window."""

    def init(generator: torch.Generator) -> Any:
        return {}

    def apply(params: Any, generator: torch.Generator,
              obs: torch.Tensor) -> torch.Tensor:
        u = torch.rand((obs.shape[0], 1, action_height, action_width),
                       generator=generator, device=obs.device)
        return (u <= toggle_rate).to(torch.float32)

    return Agent(init=init, apply=apply, reads_obs=False)
