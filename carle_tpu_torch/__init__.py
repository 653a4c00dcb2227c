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

from .config import EnvConfig
from .device import resolve_device
from .env import CARLE, EnvState, env_step, init_state, multi_step, reset_state
from . import rules
from . import rle
from . import agents
from . import checkpoint
from . import mcl
from . import packed
from . import parallel
from . import policy
from .rollout import Rollout, RolloutCarry

__version__ = "0.1.0"

# carle_tpu's names, and resolve_device
__all__ = ["CARLE", "EnvConfig", "EnvState", "Rollout", "RolloutCarry", "agents",
           "checkpoint", "env_step", "init_state", "mcl", "multi_step", "packed", "parallel",
           "policy", "reset_state", "resolve_device", "rle", "rules"]
