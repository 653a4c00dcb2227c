"""``carle.env`` facade: the CARLE shell with host torch returns.

``reset``/``step`` return torch tensors on the CPU, as the reference env
does by default, so code that reads ``reward.detach().cpu().numpy()`` runs
unchanged.  The shell computes on its device; the copy to the host happens
here, at the facade's boundary, where the shell already makes a host round
trip for the action.  Wrappers underneath call the device step (``_step``),
so a stack copies once, at its outermost layer.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .. import env as _base
from ..device import DeviceLike

# the device the facade's classes and train default to (install(device=))
DEVICE: DeviceLike = None


def to_torch(x: Any) -> Any:
    """A tensor (on any device) or array as a torch tensor on the host."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    return torch.from_numpy(np.array(x))


def with_device(kwargs: dict) -> dict:
    """``kwargs`` with the facade's device where they name none."""
    if kwargs.get("device") is None:
        kwargs = {**kwargs, "device": DEVICE}
    return kwargs


class TorchReturns:
    """Mixin returning the gym API's tensors on the host."""

    def reset(self) -> Any:
        return to_torch(super().reset())

    def step(self, action: Any) -> Tuple[Any, Any, Any, Any]:
        obs, reward, done, info = self._step(action)
        return to_torch(obs), to_torch(reward), to_torch(done), info


class CARLE(TorchReturns, _base.CARLE):
    """Reference-API CARLE with host torch returns (module note)."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**with_device(kwargs))


__all__ = ["CARLE", "DEVICE", "TorchReturns", "to_torch", "with_device"]
