"""``carle.agents`` facade: the baseline agents with host torch actions.

The reference's agents are driven as ``action = agent(obs)``; these are the
port's class agents on the facade's device, with ``forward`` returning the
action as a host tensor.
"""

from __future__ import annotations

from typing import Any

from .. import agents as _agents
from .env import to_torch, with_device


class _TorchForward:
    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**with_device(kwargs))

    def forward(self, obs: Any) -> Any:
        return to_torch(super().forward(obs))

    def __call__(self, obs: Any) -> Any:
        return self.forward(obs)


class RandomAgent(_TorchForward, _agents.RandomAgent):
    pass


class RandomNetworkAgent(_TorchForward, _agents.RandomNetworkAgent):
    pass


__all__ = ["RandomAgent", "RandomNetworkAgent"]
