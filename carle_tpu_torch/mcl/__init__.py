"""Reward wrappers (counterpart of carle_tpu/mcl): the four of the scoring
battery as functional :class:`WrapperDef`s, and the class shells of the two
that learn."""

from .ae import AE2D, ae2d_def
from .base import Motivator, StackState, StepCtx, WrapperDef, WrapperStack
from .puffer import puffer_def
from .rnd import RND2D, rnd2d_def
from .speed import speed_def

__all__ = ["AE2D", "Motivator", "RND2D", "StackState", "StepCtx", "WrapperDef",
           "WrapperStack", "ae2d_def", "puffer_def", "rnd2d_def", "speed_def"]
