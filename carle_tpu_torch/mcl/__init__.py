"""Reward wrappers (counterpart of carle_tpu/mcl): the four of the scoring
battery, as functional :class:`WrapperDef`s."""

from .ae import ae2d_def
from .base import StackState, StepCtx, WrapperDef, WrapperStack
from .puffer import puffer_def
from .rnd import rnd2d_def
from .speed import speed_def

__all__ = ["StackState", "StepCtx", "WrapperDef", "WrapperStack",
           "ae2d_def", "puffer_def", "rnd2d_def", "speed_def"]
