"""Canned action patterns and the shipped ``.rle`` assets (counterpart of
carle_tpu/mcl/patterns.py).

The helpers return float 0/1 arrays shaped [1, 1, 64, 64] ready to feed
``env.step``.  ``get_symmetric_action`` does what the reference meant (its
zero-size allocation makes it a silent no-op); ``reference_compat=True``
reproduces the no-op.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

PATTERN_DIR = os.path.join(os.path.dirname(__file__), "..", "patterns")


def pattern_path(name: str) -> str:
    """Absolute path of a shipped .rle asset (glider_1, glider_2, lwss,
    gosper_gun, spaceship_duck, spaceship_step)."""
    return os.path.abspath(os.path.join(PATTERN_DIR, name + ".rle"))


def get_glider() -> np.ndarray:
    """Glider at the window centre."""
    action = np.zeros((1, 1, 64, 64), dtype=np.float32)
    action[:, :, 32, 32] = 1.0
    action[:, :, 33, 32:34] = 1.0
    action[:, :, 34, 31] = 1.0
    action[:, :, 34, 33] = 1.0
    return action


def get_morley_puffer() -> np.ndarray:
    """Morley/Move-rule puffer seed."""
    action = np.zeros((1, 1, 64, 64), dtype=np.float32)
    action[:, :, 31:33, 32] = 1.0
    action[:, :, 30, 33] = 1.0
    action[:, :, 33, 33] = 1.0
    action[:, :, 29:35, 34] = 1.0
    action[:, :, 30, 35:37] = 1.0
    action[:, :, 33, 35:37] = 1.0
    action[:, :, 31:33, 37] = 1.0
    return action


def get_symmetric_action(probability: float = 0.125, vertical_symmetry: bool = False,
                         seed: Optional[int] = None,
                         reference_compat: bool = False) -> np.ndarray:
    """Random toggles mirrored about the vertical midline: for each row, each
    column offset j in [2, 32) toggles both (mid + j) and (mid - j) with the
    given probability."""
    if reference_compat:
        return np.zeros((0, 0, 64, 64), dtype=np.float32)
    rng = np.random.RandomState(seed)
    action = np.zeros((1, 1, 64, 64), dtype=np.float32)
    mid = 32
    for ii in range(64):
        for jj in range(1, mid):
            if rng.rand() <= probability and jj > 1:
                action[:, :, ii, mid + jj] = 1.0
                action[:, :, ii, mid - jj] = 1.0
    return action
