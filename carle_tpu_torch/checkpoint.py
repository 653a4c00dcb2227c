"""Checkpoints: the JAX package's flat ``.npz`` learner states (counterpart
of carle_tpu/checkpoint.py:76-125).

A JAX checkpoint is a flat ``.npz`` keyed by tree path, e.g.
``params/conv1/w`` or ``opt_state/0/mu/dense/b``.  The port's states are
nested dicts, tuples and NamedTuples with the same paths, so
:func:`flatten` gives the same keys as ``jax.tree_util`` flattening,
:func:`save_pytree` writes the file the JAX package writes (same keys, same
metadata entry: either package reads the other's; :func:`checkpoint_meta`
reads that entry), and
:func:`load_pytree` reads a file into the structure of a template state.
:func:`learner_state_from_numpy` builds a :class:`LearnerState` straight
from such a flat dict (a Prediction/Surprise state's frame ring included) and
:func:`state_from_numpy` any other wrapper state, which is how parameters
cross from one package to the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .mcl._online import LearnerState
from .mcl.prediction import FrameBuffer

FORMAT_VERSION = 1
_META_KEY = "__checkpoint_meta__"


def flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Leaves of a nested dict / tuple / NamedTuple state keyed by path."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    for key, value in items:
        out.update(flatten(value, f"{prefix}/{key}" if prefix else key))
    return out


def _rebuild(template: Any, leaves: Mapping[str, Any], prefix: str = "") -> Any:
    def sub(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, sub(k)) for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, leaves, sub(f))
                                for f, v in zip(template._fields, template)))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves, sub(i))
                              for i, v in enumerate(template))
    return leaves[prefix]


def save_pytree(path: str, tree: Any, compress: bool = False) -> str:
    """Serialize a state (nested dicts / tuples / NamedTuples of tensors) to
    ``path``: a flat ``.npz`` keyed by tree path, stamped with the
    format-version metadata entry.  Saving a whole :class:`LearnerState` keeps
    Adam's moments, the accumulator and the counters, so training resumes
    exactly."""
    arrays: Dict[str, np.ndarray] = {
        key: leaf.detach().cpu().numpy() for key, leaf in flatten(tree).items()}
    arrays[_META_KEY] = np.frombuffer(
        json.dumps({"format_version": FORMAT_VERSION}).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    (np.savez_compressed if compress else np.savez)(path, **arrays)
    return path


def checkpoint_meta(path: str) -> Dict[str, Any]:
    """A checkpoint's metadata entry; files without one report
    ``{"format_version": 0}``."""
    with np.load(path) as data:
        if _META_KEY not in data.files:
            return {"format_version": 0}
        return json.loads(bytes(data[_META_KEY]).decode())


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """The arrays of a checkpoint file, without its metadata entry; rejects a
    wire format newer than this code understands."""
    with np.load(path) as data:
        if _META_KEY in data.files:
            meta = json.loads(bytes(data[_META_KEY]).decode())
            if meta.get("format_version", 0) > FORMAT_VERSION:
                raise ValueError(
                    f"checkpoint {path} uses wire format "
                    f"{meta['format_version']}, newer than supported "
                    f"{FORMAT_VERSION}")
        return {k: data[k] for k in data.files if k != _META_KEY}


def load_pytree(path: str, like: Any) -> Any:
    """Load a checkpoint into the structure, dtypes and devices of ``like``.
    Raises on a missing leaf or a shape mismatch; extra keys are ignored."""
    stored = read_npz(path)
    leaves = {}
    for key, leaf in flatten(like).items():
        if key not in stored:
            raise KeyError(f"checkpoint {path} is missing leaf {key!r}")
        arr = stored[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                             f"expected {tuple(leaf.shape)}")
        leaves[key] = torch.tensor(arr, dtype=leaf.dtype, device=leaf.device)
    return _rebuild(like, leaves)


def _nest(flat: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """Nested dict of the entries under ``prefix/``."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *parents, leaf = key[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def _tensor(a, device) -> torch.Tensor:
    """Float leaves become float32 tensors, uint8 (cells, frames), uint32
    (packed frames) and bool leaves keep their type, other integer leaves
    become int32."""
    a = np.asarray(a)
    kept = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint32): torch.uint32,
            np.dtype(np.bool_): torch.bool}
    if a.dtype in kept:
        dtype = kept[a.dtype]
    else:
        dtype = torch.int32 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.tensor(a, dtype=dtype, device=device)


def state_from_numpy(flat: Mapping[str, np.ndarray], like: Any, device) -> Any:
    """A flat dict of numpy arrays keyed by tree path into the structure of
    the template state ``like`` (a CornerState, a MorphoState, ...), on
    ``device``; shapes follow the arrays, not the template."""
    leaves = {k: _tensor(v, device) for k, v in flat.items() if k != _META_KEY}
    return _rebuild(like, leaves)


def learner_state_from_numpy(flat: Mapping[str, np.ndarray],
                             device) -> LearnerState:
    """The JAX package's learner state, as a flat dict of numpy arrays (what
    ``np.load`` of its ``.npz`` or ``jax.tree_util`` flattening gives), as
    the port's :class:`LearnerState` on ``device``.  A Prediction/Surprise
    state's frame ring (``extra/frames``, ``extra/count``) becomes a
    :class:`FrameBuffer`."""
    t = {k: _tensor(v, device) for k, v in flat.items() if k != _META_KEY}
    adam = _nest(t, "opt_state")["0"]
    return LearnerState(
        reward_scale=t["reward_scale"],
        batch_size=t["batch_size"],
        params=_nest(t, "params"),
        target_params=_nest(t, "target_params"),
        opt_state=({"count": adam["count"], "mu": adam["mu"],
                    "nu": adam["nu"]},),
        grad_accum=_nest(t, "grad_accum"),
        buffer_length=t["buffer_length"],
        updates=t["updates"],
        extra=(FrameBuffer(frames=t["extra/frames"], count=t["extra/count"])
               if "extra/frames" in t else ()),
    )
