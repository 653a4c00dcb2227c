"""Life-like CA update — plain PyTorch (counterpart of carle_tpu/ops/ca.py).

Integer arithmetic on uint8 grids: the Moore sum is separable (3 row-rolled
adds, then 3 column-rolled adds minus the centre), circular rolls give the
torus, and the birth/survive decision is one shift of the 18-bit rule mask,
``(rule_bits >> (count + 9*alive)) & 1`` (rules.py), so rules are data.

These are the plain versions of the ``ca_step`` and ``ca_multi_step``
kernels (ops/cuda_ca.py), which the CPU runs and the card's kernels are held
against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import EnvConfig


def neighbor_counts(grid: torch.Tensor) -> torch.Tensor:
    """Live Moore neighbours of each cell of a uint8 (0/1) [..., H, W] grid
    on a torus; uint8 counts 0-8."""
    rows = grid + torch.roll(grid, 1, dims=-2) + torch.roll(grid, -1, dims=-2)
    return rows + torch.roll(rows, 1, dims=-1) + torch.roll(rows, -1, dims=-1) - grid


def apply_rule(grid: torch.Tensor, counts: torch.Tensor,
               rule_bits) -> torch.Tensor:
    """Next cell state from the 18-bit rule mask: a scalar (one rule for the
    batch) or an [instances] vector applied along dimension 0."""
    idx = counts.to(torch.int32) + 9 * grid.to(torch.int32)
    bits = torch.as_tensor(rule_bits, dtype=torch.int32, device=grid.device)
    if bits.ndim == 1:
        if bits.shape[0] != grid.shape[0]:
            raise ValueError(
                f"per-instance rule vector of length {bits.shape[0]} must "
                f"match grid dimension 0 ({grid.shape[0]}) — the vector "
                "applies along dim 0")
        bits = bits.reshape(bits.shape[0], *([1] * (grid.ndim - 1)))
    return ((bits >> idx) & 1).to(torch.uint8)


def ca_step_grid(grid: torch.Tensor, rule_bits) -> torch.Tensor:
    """One CA generation: neighbour count + rule table, torus boundary."""
    return apply_rule(grid, neighbor_counts(grid), rule_bits)


def ca_multi_step(grid: torch.Tensor, rule_bits, num_steps: int) -> torch.Tensor:
    """``num_steps`` action-free generations of a uint8 [inst, H, W] grid."""
    for _ in range(int(num_steps)):
        grid = ca_step_grid(grid, rule_bits)
    return grid


def pad_action(action: torch.Tensor, config: EnvConfig) -> torch.Tensor:
    """Zero-pad an [inst, AH, AW] patch into the centred action window of a
    full [inst, H, W] grid (floor-centred, the extra row/column below/right)."""
    r0, c0 = config.action_row_offset, config.action_col_offset
    ah, aw = config.eff_action_height, config.eff_action_width
    return F.pad(action, (c0, config.width - c0 - aw,
                          r0, config.height - r0 - ah))


def ca_step_with_action(grid: torch.Tensor, action: torch.Tensor, rule_bits,
                        config: EnvConfig, reset=None) -> torch.Tensor:
    """Toggle the centred action window (any nonzero action value toggles)
    and run one CA generation; zeros wherever the 0-d ``reset`` flag (env
    step's master reset, a tensor the host never reads) is set."""
    toggles = (pad_action(action, config) != 0).to(torch.uint8)
    stepped = ca_step_grid(grid ^ toggles, rule_bits)
    if reset is None:
        return stepped
    return torch.where(torch.as_tensor(reset, device=grid.device) != 0,
                       torch.zeros_like(stepped), stepped)
