"""carle_tpu_torch — the PyTorch/CUDA port of carle_tpu for an NVIDIA H100.

A batched Life-like cellular-automaton environment with toggle actions,
reward wrappers whose nets learn inside the step, agents, the rollout loop,
the wrapper trainer, the Carle's Game scoring battery, and pattern I/O,
episode artifacts and analysis, written in PyTorch.  The hot loops are CUDA kernels written by hand
for Hopper (``csrc/``), each beside a plain PyTorch twin of the same
function: a CUDA tensor goes to the kernel, a CPU tensor to the twin.  Entry
points run on the card unless the caller passes ``device="cpu"``.

The package imports neither JAX nor ``carle_tpu``; the JAX package is the
reference it is tested against.
"""

from . import rules
from .config import EnvConfig
from .device import resolve_device
from .env import CARLE, EnvState, env_step, init_state, multi_step, reset_state

__all__ = ["CARLE", "EnvConfig", "EnvState", "env_step", "init_state",
           "multi_step", "reset_state", "resolve_device", "rules"]
