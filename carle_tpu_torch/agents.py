"""Baseline agents (counterpart of carle_tpu/agents.py).

An agent is a pair ``init(generator) -> params`` / ``apply(params,
generator, obs) -> action``: a float observation [inst, 1, H, W] maps to a
float 0/1 action [inst, 1, AH, AW] (rows first), on the observation's
device.  Randomness comes from the explicit ``torch.Generator``, which lives
on the observation's device.  An agent that does not read the cells
(``reads_obs=False``) is given a zero-size [inst, 1, 0, 0] observation on
the right device, so a rollout builds no observation for it (on a packed
stack, no unpack).

The class agents (:class:`RandomAgent`, :class:`RandomNetworkAgent`) are the
reference's callable surface, ``agent(obs) -> action``, over a functional
agent (``_agent``) and its parameters (``params``), which the fused scoring
paths run in their rollout.  They take a ``device`` keyword, the card unless
``"cpu"``; their parameters and actions live there.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch

from . import nets
from .device import resolve_device


class Agent(NamedTuple):
    init: Callable[[torch.Generator], Any]
    apply: Callable[[Any, torch.Generator, torch.Tensor], torch.Tensor]
    reads_obs: bool = True


def _resolve_dims(kwargs: Dict[str, Any]) -> Dict[str, int]:
    # The reference's observation_width lookup is dead through a typo
    # ("observatoin_width"); both spellings are honoured here.
    return dict(
        action_width=kwargs.get("action_width", 64),
        action_height=kwargs.get("action_height", 64),
        observation_width=kwargs.get("observation_width",
                                     kwargs.get("observatoin_width", 256)),
        observation_height=kwargs.get("observation_height", 256),
    )


def _as_obs(obs: Any, device: torch.device) -> torch.Tensor:
    """Observations (numpy or torch) as float32 [inst, 1, H, W] on ``device``."""
    arr = obs if torch.is_tensor(obs) else torch.as_tensor(np.asarray(obs))
    arr = arr.detach().to(device=device, dtype=torch.float32)
    return arr[:, None] if arr.ndim == 3 else arr


class _Shell:
    """What the class agents share: the four dims, the device, a callable
    ``forward`` over ``_agent`` and the reference's torch no-ops."""

    def __init__(self, **kwargs: Any) -> None:
        dims = _resolve_dims(kwargs)
        self.action_width = dims["action_width"]
        self.action_height = dims["action_height"]
        self.observation_width = dims["observation_width"]
        self.observation_height = dims["observation_height"]
        self.device = resolve_device(kwargs.get("device"))
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(kwargs.get("seed", 0)))

    def forward(self, obs: Any) -> torch.Tensor:
        return self._agent.apply(self.params, self._generator, _as_obs(obs, self.device))

    def __call__(self, obs: Any) -> torch.Tensor:
        return self.forward(obs)

    def eval(self):
        return self

    def to(self, *a: Any, **k: Any):
        return self


# ---------------------------------------------------------------------------
# RandomAgent: Bernoulli(toggle_rate) toggles
# ---------------------------------------------------------------------------


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


class RandomAgent(_Shell):
    """``agent(obs) -> action``: Bernoulli(toggle_rate) draws from the
    agent's own generator, seeded by ``seed``."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.toggle_rate = kwargs.get("toggle_rate", 0.100)
        self._agent = make_random_agent(self.action_width, self.action_height,
                                        self.toggle_rate)
        self.params = self._agent.init(self._generator)

    def load_state_dict(self, state_dict: Any) -> None:
        pass


# ---------------------------------------------------------------------------
# RandomNetworkAgent: a frozen random CNN policy
# ---------------------------------------------------------------------------


def _rna_forward(params: Dict[str, Any], obs: torch.Tensor, toggle_rate: float,
                 action_width: int, action_height: int) -> torch.Tensor:
    """conv(1->F) relu pool2 conv(F->1) relu pool2 flatten linear sigmoid,
    all bias-free; action = (output <= toggle_rate)."""
    x = nets.max_pool2(torch.relu(nets.conv2d(obs, params["conv1"], padding=1)))
    x = nets.max_pool2(torch.relu(nets.conv2d(x, params["conv2"], padding=1)))
    x = torch.sigmoid(nets.linear(nets.flatten(x), params["dense"]))
    action = (x <= toggle_rate).to(torch.float32)
    return action.reshape(obs.shape[0], 1, action_height, action_width)


def make_random_network_agent(action_width: int = 64, action_height: int = 64,
                              observation_width: int = 256,
                              observation_height: int = 256,
                              toggle_rate: float = 0.1,
                              filter_dim: int = 4) -> Agent:
    dense_nodes = (observation_width // 4) * (observation_height // 4)
    output_nodes = action_width * action_height

    def init(generator: torch.Generator) -> Dict[str, Any]:
        device = generator.device
        return {
            "conv1": nets.conv_init(filter_dim, 1, 3, generator, device, bias=False),
            "conv2": nets.conv_init(1, filter_dim, 3, generator, device, bias=False),
            "dense": nets.linear_init(output_nodes, dense_nodes, generator, device,
                                      bias=False),
        }

    def apply(params: Dict[str, Any], generator: torch.Generator,
              obs: torch.Tensor) -> torch.Tensor:
        # a deterministic policy: the frozen network draws nothing
        return _rna_forward(params, obs, toggle_rate, action_width, action_height)

    return Agent(init=init, apply=apply)


class RandomNetworkAgent(_Shell):
    """``agent(obs) -> action`` over the frozen random CNN policy; its
    weights are drawn from ``seed`` on the agent's device."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.depth = 3
        self.filter_dim = 4
        self.toggle_rate = 0.1
        self._agent = make_random_network_agent(
            self.action_width, self.action_height, self.observation_width,
            self.observation_height, self.toggle_rate, self.filter_dim)
        self.params = self._agent.init(self._generator)

    def load_state_dict(self, state_dict: Any) -> None:
        """The reference's loading surface: a torch state dict, a path to one
        (``.pt``), or a native ``.npz`` params file (``save_pytree`` of either
        package), each put on the agent's device."""
        if isinstance(state_dict, str):
            if state_dict.endswith(".npz"):
                from .checkpoint import load_pytree

                self.params = load_pytree(state_dict, self.params)
                return
            state_dict = torch.load(state_dict, weights_only=True,
                                    map_location=self.device)
        self.load_torch_state_dict(state_dict)

    def load_torch_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """Adopt weights from a reference ``network.state_dict()``: keys
        ``network.{0,3,7}.weight`` (the Sequential's indices) or, from
        ``agent.network.state_dict()``, ``{0,3,7}.weight``."""
        from .mcl.rnd import _torch_getter

        convert = _torch_getter(state_dict, self.device)

        def get(idx: int) -> torch.Tensor:
            for key in (f"network.{idx}.weight", f"{idx}.weight"):
                if key in state_dict:
                    return convert(key)
            raise KeyError(f"no weight entry for Sequential index {idx}")

        self.params = {"conv1": {"w": get(0)}, "conv2": {"w": get(3)},
                       "dense": {"w": get(7)}}


# ---------------------------------------------------------------------------
# Seeder agents: scripted structure deployment (battery calibration)
# ---------------------------------------------------------------------------


def make_seeder_agent(pattern: Any, action_width: int = 64,
                      action_height: int = 64) -> Agent:
    """A scripted agent that writes a known structure through the action
    window whenever the universe is empty, and otherwise lets it run.

    ``pattern`` is a 0/1 cell array ([AH, AW], [1, AH, AW] or [1, 1, AH, AW],
    the mcl.patterns helpers' shape) or a list of such, cycled over the
    instances; each is centred in the window.  Triggering on an empty
    universe keeps the agent stateless: the pattern deploys on the battery's
    reset and again whenever the rule kills it.
    """
    pats = pattern if isinstance(pattern, (list, tuple)) else [pattern]
    canvases = []
    for p in pats:
        arr = np.asarray(p, dtype=np.float32).reshape(np.asarray(p).shape[-2:])
        if arr.shape[0] > action_height or arr.shape[1] > action_width:
            raise ValueError(f"pattern {arr.shape} exceeds the "
                             f"{action_height}x{action_width} action window")
        canvas = np.zeros((action_height, action_width), np.float32)
        r0 = (action_height - arr.shape[0]) // 2
        c0 = (action_width - arr.shape[1]) // 2
        canvas[r0: r0 + arr.shape[0], c0: c0 + arr.shape[1]] = arr
        canvases.append(canvas)
    bank_np = np.stack(canvases)  # [K, AH, AW]
    banks: Dict[torch.device, torch.Tensor] = {}  # the bank on each device it met

    def init(generator: torch.Generator) -> Dict[str, Any]:
        return {}

    def apply(params: Any, generator: torch.Generator,
              obs: torch.Tensor) -> torch.Tensor:
        bank = banks.get(obs.device)
        if bank is None:
            bank = banks[obs.device] = torch.from_numpy(bank_np).to(obs.device)
        idx = torch.arange(obs.shape[0], device=obs.device) % bank.shape[0]
        pat = bank[idx][:, None]  # [inst, 1, AH, AW]
        alive = (obs > 0).flatten(1).any(dim=1)
        return torch.where(alive[:, None, None, None], torch.zeros_like(pat), pat)

    return Agent(init=init, apply=apply)


def tile_pattern(cell_pattern: Any, copies: int, spacing: int = 4,
                 action_height: int = 64, action_width: int = 64) -> np.ndarray:
    """``copies`` of a small pattern tiled into one action canvas (a glider
    fleet, a still-life lattice): row-major with ``spacing`` cells of
    clearance, centred."""
    arr = np.asarray(cell_pattern, dtype=np.float32)
    arr = arr.reshape(arr.shape[-2:])
    ph, pw = arr.shape
    per_row = max(1, (action_width + spacing) // (pw + spacing))
    rows = int(np.ceil(copies / per_row))
    h = rows * (ph + spacing) - spacing
    w = min(copies, per_row) * (pw + spacing) - spacing
    if h > action_height or w > action_width:
        raise ValueError(f"{copies} copies do not fit the window")
    canvas = np.zeros((action_height, action_width), np.float32)
    r0 = (action_height - h) // 2
    c0 = (action_width - w) // 2
    for k in range(copies):
        r = r0 + (k // per_row) * (ph + spacing)
        c = c0 + (k % per_row) * (pw + spacing)
        canvas[r: r + ph, c: c + pw] = arr
    return canvas
