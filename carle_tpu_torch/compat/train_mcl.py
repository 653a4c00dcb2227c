"""``carle.train_mcl`` facade: the wrapper pre-training entry point.

The port's trainer takes the reference's positional contract
``train(agent_fn, instances, steps, rules, mcl)`` and reference-style agent
classes (the facade's included); here it runs on the facade's device unless
the call names one.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .. import train_mcl as _train_mcl
from ..train_mcl import DEFAULT_RULES  # noqa: F401  (re-exported)
from .env import with_device


def train(*args: Any, **kwargs: Any) -> np.ndarray:
    """``carle_tpu_torch.train_mcl.train`` on the facade's device."""
    return _train_mcl.train(*args, **with_device(kwargs))


__all__ = ["DEFAULT_RULES", "train"]
