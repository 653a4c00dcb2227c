"""Drop-in facade for the reference ``carle`` package (counterpart of
carle_tpu/compat/).

Code written against riveSunder/carle runs on the port unchanged: the
facade's classes return **torch tensors on the host** from ``reset`` /
``step`` / ``forward``, as the reference does by default, while the
computation runs on the device underneath.

Usage::

    import carle_tpu_torch.compat as compat
    compat.install()                   # "carle" now serves carle_tpu_torch
    # compat.install(device="cpu")     # the facade's classes and train on the CPU

    from carle.env import CARLE
    from carle.mcl import AE2D, RND2D, SpeedDetector, get_glider

``install(device=None)`` registers the ``carle``, ``carle.env``,
``carle.mcl``, ``carle.agents`` and ``carle.train_mcl`` aliases (they win
over a real ``carle`` on sys.path) and sets the device that the facade's
classes and ``train`` default to: ``None`` is the card, and asking for it
where there is none raises, as every entry point of the port does.
``uninstall()`` removes the aliases and gives back any module they
displaced, the same objects.
"""

from __future__ import annotations

import sys
from typing import Any

from . import agents, env, mcl, train_mcl  # noqa: F401  (carle.* submodules)
from ..device import DeviceLike


def _aliases() -> dict:
    return {
        "carle": sys.modules[__name__],
        "carle.env": env,
        "carle.mcl": mcl,
        "carle.agents": agents,
        "carle.train_mcl": train_mcl,
    }


# modules displaced by install(), given back by uninstall(): a process that
# imported the real reference (or another facade) first gets ITS module
# objects back, not re-executed copies with new class identities
_DISPLACED: dict = {}


def install(device: DeviceLike = None) -> Any:
    """Register this package as the ``carle`` module (and submodules), with
    ``device`` the facade's default, keeping any ``carle*`` modules already
    imported so :func:`uninstall` can give them back."""
    env.DEVICE = device
    for name, mod in _aliases().items():
        existing = sys.modules.get(name)
        if existing is not None and existing is not mod and name not in _DISPLACED:
            _DISPLACED[name] = existing
        sys.modules[name] = mod
    return sys.modules[__name__]


def uninstall() -> None:
    """Undo :func:`install`: give back any displaced modules, else drop the
    alias (only entries still pointing at this facade are touched)."""
    for name, mod in _aliases().items():
        if sys.modules.get(name) is mod:
            displaced = _DISPLACED.pop(name, None)
            if displaced is not None:
                sys.modules[name] = displaced
            else:
                sys.modules.pop(name, None)
        else:
            _DISPLACED.pop(name, None)
    env.DEVICE = None


__all__ = ["agents", "env", "install", "mcl", "train_mcl", "uninstall"]
