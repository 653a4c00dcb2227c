"""MorphoBonus — rewards matching target morphologies (counterpart of
carle_tpu/mcl/morpho.py).

Each RLE pattern is padded (top 2, left 1) into a small kernel, dead cells set
to -1, live cells normalised to sum to 15, and expanded into 6 symmetry
variants (identity, row flip, column flip, transpose and both transpose
flips); the bonus is max + min of the VALID cross-correlation of the kernel
bank with ``|universe - action|`` over all kernels and positions; a reset
seeds Bernoulli(0.005) nucleation noise.

As the JAX package, this ships the glider assets the reference lacks
(carle_tpu_torch/patterns/), pads every kernel onto a square ``dim x dim``
canvas so all 6 variants stack, and subtracts the *padded* action window so
the correlation is well defined.  The correlation input is the universe BEFORE
the CA update.  It runs through ``F.conv2d``: the JAX package leaves it to XLA,
outside any hand-written kernel.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import rle as rle_codec
from ..config import EnvConfig
from .base import Motivator, StepCtx, WrapperDef
from .patterns import pattern_path


def _kernel_variants(grid: np.ndarray, dim: int = 8) -> np.ndarray:
    """One pattern -> 6 symmetry-variant [dim, dim] kernels, the reference's
    normalisation."""
    canvas = np.zeros((dim, dim), dtype=np.float32)
    h = min(grid.shape[0], dim - 2)
    w = min(grid.shape[1], dim - 1)
    canvas[2: 2 + h, 1: 1 + w] = grid[:h, :w]

    kernel = np.where(canvas > 0, canvas, -1.0).astype(np.float32)
    ones = kernel > 0
    if ones.any():
        kernel[ones] *= 15.0 / kernel[ones].sum()

    return np.stack([
        kernel,
        kernel[::-1, :],          # flip rows
        kernel[:, ::-1],          # flip columns
        kernel.T[::-1, :],        # transpose + flip rows
        kernel.T[:, ::-1],        # transpose + flip columns
        kernel.T,                 # transpose
    ])


def build_kernel_bank(rle_paths: Sequence[str], dim: int = 8) -> np.ndarray:
    """Stack every pattern's 6 variants into a bank [K, 1, dim, dim]."""
    banks: List[np.ndarray] = []
    for path in rle_paths:
        pattern = rle_codec.read_rle(path)
        banks.append(_kernel_variants(np.asarray(pattern.grid, dtype=np.float32), dim))
    return np.concatenate(banks)[:, None]


class MorphoState(NamedTuple):
    reward_scale: torch.Tensor  # float32 scalar
    kernels: torch.Tensor       # float32 [K, 1, dim, dim]


def morpho_def(config: EnvConfig, reward_scale: float = 1.0,
               rle_paths: Sequence[str] = (), dim: int = 8, seed_rate: float = 0.005,
               **kwargs: Any) -> WrapperDef:
    if not rle_paths:
        rle_paths = (pattern_path("glider_1"), pattern_path("glider_2"))
    bank = build_kernel_bank(rle_paths, dim)

    def init(generator: Any, device) -> MorphoState:
        return MorphoState(
            reward_scale=torch.as_tensor(reward_scale, dtype=torch.float32, device=device),
            kernels=torch.from_numpy(bank).to(device))

    def apply(state: MorphoState, ctx: StepCtx,
              reward: torch.Tensor) -> Tuple[MorphoState, torch.Tensor]:
        my_grid = (ctx.prev_grid.to(torch.float32)
                   - ctx.action_full.to(torch.float32)).abs()[:, None]
        response = F.conv2d(my_grid, state.kernels)
        my_max = response.amax(dim=(1, 2, 3))[:, None]
        my_min = response.amin(dim=(1, 2, 3))[:, None]
        return state, reward + state.reward_scale * (my_max + my_min)

    def on_reset(state: MorphoState, grid: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[MorphoState, torch.Tensor]:
        if generator is None:
            raise ValueError("MorphoBonus seeds nucleation noise on reset: pass the "
                             "generator that draws it")
        noise = torch.rand(grid.shape, generator=generator, device=grid.device) < seed_rate
        return state, grid | noise.to(torch.uint8)

    return WrapperDef(name="MorphoBonus", init=init, apply=apply, on_reset=on_reset)


class MorphoBonus(Motivator):
    my_name = "MorphoBonus"

    def __init__(self, env: Any, **kwargs: Any) -> None:
        super().__init__(env, **kwargs)
        # attribute parity: the reference's use_grad kwarg check is dead code
        self.use_grad = kwargs.get("use_grad", False)

    def _make_def(self, **kwargs: Any) -> WrapperDef:
        return morpho_def(self._config, **kwargs)

    def add_rle_pattern(self, rle_path: str, dim: int = 8) -> None:
        """Append a pattern's 6 variants to the kernel bank."""
        extra = torch.from_numpy(build_kernel_bank([rle_path], dim)).to(
            self._wstate.kernels.device)
        self._wstate = self._wstate._replace(
            kernels=torch.cat([self._wstate.kernels, extra]))
