"""Environment configuration (counterpart of carle_tpu/config.py).

An immutable dataclass: every derived quantity (action-window offsets,
effective action size) is computed once, and the config is hashable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static configuration of a batch of CA universes.

    Mirrors the reference defaults (env.py:21-48): 256x256 universes with a
    centered 64x64 toggle-action window, one instance unless asked otherwise.
    """

    height: int = 256
    width: int = 256
    action_height: int = 64
    action_width: int = 64
    instances: int = 1

    # --- derived geometry -------------------------------------------------
    # The reference shrinks the action window by (dim % 2) before centering
    # (env.py:124-125).  Replicated so odd-sized universes behave identically.
    @property
    def eff_action_height(self) -> int:
        return self.action_height - (self.height % 2)

    @property
    def eff_action_width(self) -> int:
        return self.action_width - (self.width % 2)

    @property
    def action_row_offset(self) -> int:
        """First universe row covered by the action window (floor-centered,
        extra padding goes below — matches env.py:119-132)."""
        return (self.height - self.eff_action_height) // 2

    @property
    def action_col_offset(self) -> int:
        return (self.width - self.eff_action_width) // 2

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (self.instances, self.height, self.width)

    @property
    def action_shape(self) -> Tuple[int, int, int]:
        return (self.instances, self.eff_action_height, self.eff_action_width)

    def validate(self) -> "EnvConfig":
        if self.height < 1 or self.width < 1:
            raise ValueError(
                f"universe must be at least 1x1, got "
                f"{self.height}x{self.width}"
            )
        if self.eff_action_height < 1 or self.eff_action_width < 1:
            # a zero/negative window yields a silently inert env (empty
            # toggle patches) or opaque negative-dimension shape errors far
            # from the misconfiguration — fail here instead
            raise ValueError(
                f"action window {self.action_height}x{self.action_width} is "
                "degenerate (effective size "
                f"{self.eff_action_height}x{self.eff_action_width}); both "
                "dimensions must be >= 1"
            )
        if self.eff_action_height > self.height or self.eff_action_width > self.width:
            raise ValueError(
                f"action window {self.action_height}x{self.action_width} does not "
                f"fit in universe {self.height}x{self.width}"
            )
        if self.instances < 1:
            raise ValueError("instances must be >= 1")
        return self
