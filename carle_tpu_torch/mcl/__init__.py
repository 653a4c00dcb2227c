"""Reward wrappers (counterpart of carle_tpu/mcl): the nine of the package as
functional :class:`WrapperDef`s and their class shells with the reference's
surface (``env = Wrapper(env)``)."""

from .ae import AE2D, ae2d_def, ae_forward
from .base import Motivator, StackState, StepCtx, WrapperDef, WrapperStack
from .corner import CornerBonus, corner_def
from .morpho import MorphoBonus, morpho_def
from .parsimony import ParsimonyBonus, parsimony_def
from .prediction import (FrameBuffer, PredictionBonus, SurpriseBonus, prediction_def,
                         surprise_def)
from .puffer import puffer_def
from .rnd import RND2D, rnd2d_def
from .speed import speed_def

__all__ = ["AE2D", "CornerBonus", "FrameBuffer", "MorphoBonus", "Motivator",
           "ParsimonyBonus", "PredictionBonus", "RND2D", "StackState", "StepCtx",
           "SurpriseBonus", "WrapperDef", "WrapperStack", "ae2d_def", "ae_forward",
           "corner_def", "morpho_def", "parsimony_def", "prediction_def", "puffer_def",
           "rnd2d_def", "speed_def", "surprise_def"]
