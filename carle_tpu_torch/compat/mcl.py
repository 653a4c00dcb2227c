"""``carle.mcl`` facade: the wrapper classes with host torch returns and the
pattern helpers.

Each class is the port's shell (the reference's semantics) with ``reset`` /
``step`` returning host tensors at the facade's boundary; wrappers compose
as in the reference (``env = Wrapper(env)``) and compute on the inner
CARLE's device.  The pattern helpers return torch tensors.
"""

from __future__ import annotations

from typing import Any

from .. import mcl as _mcl
from ..mcl import patterns as _patterns
from .env import CARLE, TorchReturns, to_torch  # noqa: F401  (re-exported)


class Motivator(TorchReturns, _mcl.Motivator):
    pass


class RND2D(TorchReturns, _mcl.RND2D):
    pass


class AE2D(TorchReturns, _mcl.AE2D):
    pass


class PredictionBonus(TorchReturns, _mcl.PredictionBonus):
    pass


class SurpriseBonus(TorchReturns, _mcl.SurpriseBonus):
    pass


class MorphoBonus(TorchReturns, _mcl.MorphoBonus):
    pass


class CornerBonus(TorchReturns, _mcl.CornerBonus):
    pass


class SpeedDetector(TorchReturns, _mcl.SpeedDetector):
    pass


class PufferDetector(TorchReturns, _mcl.PufferDetector):
    pass


class ParsimonyBonus(TorchReturns, _mcl.ParsimonyBonus):
    pass


def get_glider() -> Any:
    return to_torch(_patterns.get_glider())


def get_morley_puffer() -> Any:
    return to_torch(_patterns.get_morley_puffer())


def get_symmetric_action(*args: Any, **kwargs: Any) -> Any:
    return to_torch(_patterns.get_symmetric_action(*args, **kwargs))


__all__ = ["AE2D", "CARLE", "CornerBonus", "MorphoBonus", "Motivator", "ParsimonyBonus",
           "PredictionBonus", "PufferDetector", "RND2D", "SpeedDetector", "SurpriseBonus",
           "get_glider", "get_morley_puffer", "get_symmetric_action"]
