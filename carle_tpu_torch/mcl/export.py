"""Export wrapper parameters as the reference's torch checkpoints
(counterpart of carle_tpu/mcl/export.py).

The reverse direction (a reference ``.pt`` into the port's parameters) is
``mcl/rnd.py``'s and ``mcl/ae.py``'s ``*_params_from_torch``.  The key layout
is the shipped reference artifacts': every Motivator level registers both
``inner_env`` (the raw CARLE) and ``env`` (the wrapped env) as submodules, so
a bare RND2D stack carries two copies of the constant Moore kernel and an
AE2D-over-RND2D stack nests the whole inner RND2D under ``env.*``.  The
Sequential indices of each net:

  RND2D predictor       conv1->0  conv2->5   dense->11
  RND2D random_network  conv1->0  conv2->4   dense->8
  AE2D  predictor       conv1->0  conv2->4  deconv1->8  deconv2->11

PredictionBonus and SurpriseBonus share AE2D's predictor layout.  The
parameters already have torch's layouts, so export renames keys and brings
the tensors to the CPU as float32, ready for ``torch.save``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

# The constant Moore kernel the reference registers as a conv weight;
# checkpoints hold it though it never trains.
MOORE_KERNEL = np.array(
    [[[[1.0, 1.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 1.0]]]], dtype=np.float32)

_RND_PREDICTOR_IDX = (("conv1", 0), ("conv2", 5), ("dense", 11))
_RND_RANDOM_IDX = (("conv1", 0), ("conv2", 4), ("dense", 8))
_AE_PREDICTOR_IDX = (("conv1", 0), ("conv2", 4), ("deconv1", 8), ("deconv2", 11))


def _cpu(x: Any) -> torch.Tensor:
    x = x.detach() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return x.to(device="cpu", dtype=torch.float32).clone()


def _sequential_entries(prefix: str, params: Dict[str, Any],
                        index_map) -> "OrderedDict[str, torch.Tensor]":
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for ours, idx in index_map:
        out[f"{prefix}.{idx}.weight"] = _cpu(params[ours]["w"])
        out[f"{prefix}.{idx}.bias"] = _cpu(params[ours]["b"])
    return out


def rnd2d_entries(params: Dict[str, Any],
                  target_params: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """``predictor.*`` + ``random_network.*`` entries of an RND2D level."""
    out = _sequential_entries("predictor", params, _RND_PREDICTOR_IDX)
    out.update(_sequential_entries("random_network", target_params, _RND_RANDOM_IDX))
    return out


def ae2d_entries(params: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """``predictor.*`` entries of an AE2D, Prediction or Surprise level."""
    return _sequential_entries("predictor", params, _AE_PREDICTOR_IDX)


_OWN_ENTRY_BUILDERS = {
    "RND2D": lambda ws: rnd2d_entries(ws.params, ws.target_params),
    "AE2D": lambda ws: ae2d_entries(ws.params),
    "PredictionBonus": lambda ws: ae2d_entries(ws.params),
    "SurpriseBonus": lambda ws: ae2d_entries(ws.params),
}


def _module_entries(obj: Any) -> "OrderedDict[str, torch.Tensor]":
    """The reference-shaped state dict of a shell stack, level by level."""
    if getattr(obj, "inner_env", None) is None:  # the raw CARLE
        return OrderedDict([("neighborhood.weight", torch.from_numpy(MOORE_KERNEL.copy()))])
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, v in _module_entries(obj.inner_env).items():
        out[f"inner_env.{k}"] = v
    for k, v in _module_entries(obj.env).items():
        out[f"env.{k}"] = v
    builder = _OWN_ENTRY_BUILDERS.get(getattr(obj, "my_name", None))
    if builder is not None and getattr(obj, "_wstate", None) is not None:
        out.update(builder(obj._wstate))
    return out


def _as_requested(sd: "OrderedDict[str, torch.Tensor]", torch_tensors: bool):
    if torch_tensors:
        return sd
    return OrderedDict((k, v.numpy()) for k, v in sd.items())


def to_state_dict(wrapper: Any, torch_tensors: bool = True) -> "OrderedDict[str, Any]":
    """The reference's ``state_dict`` of a shell wrapper (stack): ``wrapper``
    is any Motivator shell (``RND2D``, ``AE2D``, ... over a ``CARLE``); the
    nesting follows the reference's module registration, so the result loads
    into the matching reference class with ``load_state_dict(...,
    strict=True)``.  Values are CPU float32 tensors (``torch_tensors=False``:
    numpy arrays)."""
    return _as_requested(_module_entries(wrapper), torch_tensors)


def save_torch_checkpoint(path: str, wrapper: Any) -> None:
    """``torch.save`` a reference-loadable checkpoint of a shell stack."""
    torch.save(to_state_dict(wrapper), path)


def learner_state_to_state_dict(kind: str, params: Dict[str, Any],
                                target_params: Optional[Dict[str, Any]] = None,
                                torch_tensors: bool = True) -> "OrderedDict[str, Any]":
    """Bare fused-path parameters (a ``LearnerState``'s ``params`` /
    ``target_params``) as a one-wrapper-over-CARLE checkpoint.  ``kind`` is
    "RND2D", "AE2D", "PredictionBonus" or "SurpriseBonus"."""
    moore = torch.from_numpy(MOORE_KERNEL)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["inner_env.neighborhood.weight"] = moore.clone()
    sd["env.neighborhood.weight"] = moore.clone()
    if kind == "RND2D":
        if target_params is None:
            raise ValueError("RND2D export needs target_params (random_network)")
        sd.update(rnd2d_entries(params, target_params))
    elif kind in ("AE2D", "PredictionBonus", "SurpriseBonus"):
        sd.update(ae2d_entries(params))
    else:
        raise ValueError(f"no torch checkpoint layout for wrapper kind {kind!r}")
    return _as_requested(sd, torch_tensors)
