"""Device meshes and row shards (counterpart of carle_tpu/parallel/mesh.py's
``make_mesh`` and of a JAX array row-sharded over a mesh).

The JAX package's spatial tier is one program over a mesh (``shard_map``):
each device holds a block of rows and trades ghost rows with its ring
neighbours.  Here one controller holds a list of per-slot shards:

* :class:`Mesh` is a list of slots, each a ``torch.device``.  Slots may
  repeat one device (several shards on one card, the single-card case) or
  name several CUDA devices, which must reach each other's memory by peer
  access (NVLink); a mesh whose cards cannot raises.  A CPU mesh exists only
  when the caller lists ``cpu`` slots (the tests use 8, as the JAX tests use
  8 CPU devices).
* :class:`RowShards` is a tensor whose rows (dimension -2) are split evenly
  over the slots: one tensor per slot, each its own allocation on its slot's
  device.  :func:`shard_rows` and :func:`gather_rows` move between the two.
  They stand in for GSPMD's placement: nothing reads a neighbour's rows by
  indexing one big tensor.

Multi-process meshes (``torch.distributed``) and env-batch data parallelism
(``env_sharding``, ``shard_carry``, ``replicate``) are not here yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


def _slot(device: Any) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A one-axis mesh of slots (counterpart of the ``jax.sharding.Mesh``
    that ``make_mesh`` builds): ``devices`` in ring order, ``axis_names``
    one name, ``shape[axis]`` the slot count.  The first slot is the home
    device, where gathered views and replicated state live."""

    def __init__(self, devices: Sequence[Any], axis_names: Tuple[str, ...] = ("env",)) -> None:
        devices = tuple(_slot(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one slot")
        if len(axis_names) != 1:
            raise ValueError(f"a mesh has one axis here, got {axis_names}")
        kinds = {d.type for d in devices}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"mesh slots must be all cpu or all cuda, got {devices}")
        cards = sorted({d.index for d in devices if d.type == "cuda"})
        for a in cards:
            for b in cards:
                if a != b and not torch.cuda.can_device_access_peer(a, b):
                    raise ValueError(f"mesh slots cuda:{a} and cuda:{b} cannot reach "
                                     "each other's memory (no peer access)")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def make_mesh(devices: Optional[Sequence[Any]] = None, axis_name: str = "env") -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device; without
    one this raises: a CPU mesh is built only from ``cpu`` slots the caller
    lists)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes every visible CUDA device and "
                               "found none; list cpu slots to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis_name,))


class RowShards:
    """A tensor [..., H, W*] whose H rows are split evenly over a mesh's
    slots: ``parts[s]`` holds rows [s H/n, (s + 1) H/n) on slot s's device.
    ``axis`` names the mesh axis the rows shard over."""

    __slots__ = ("parts", "mesh", "axis")

    def __init__(self, parts: Sequence[torch.Tensor], mesh: Mesh, axis: str = "space") -> None:
        parts = list(parts)
        if len(parts) != mesh.size:
            raise ValueError(f"{len(parts)} shards for a mesh of {mesh.size} slots")
        self.parts = parts
        self.mesh = mesh
        self.axis = axis

    @property
    def rows(self) -> int:
        """Rows a slot holds."""
        return self.parts[0].shape[-2]

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[-2] *= len(self.parts)
        return torch.Size(s)

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    def offsets(self) -> List[int]:
        """The global row of each slot's first row."""
        return [s * self.rows for s in range(len(self.parts))]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RowShards":
        """``fn`` of every shard, in place of it (row counts kept equal)."""
        return RowShards([fn(p) for p in self.parts], self.mesh, self.axis)

    def __repr__(self) -> str:
        return f"RowShards({tuple(self.shape)}, {self.parts[0].dtype}, {self.mesh})"


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "space") -> RowShards:
    """Split ``x``'s rows (dimension -2) evenly over the mesh's slots, each
    shard a new allocation on its slot's device."""
    n = mesh.size
    h = x.shape[-2]
    if h % n:
        raise ValueError(f"height {h} not divisible by the {axis} axis ({n})")
    hl = h // n
    parts = []
    for s, dev in enumerate(mesh.devices):
        part = torch.empty(x.shape[:-2] + (hl, x.shape[-1]), dtype=x.dtype, device=dev)
        part.copy_(x[..., s * hl:(s + 1) * hl, :])
        parts.append(part)
    return RowShards(parts, mesh, axis)


def gather_rows(x: RowShards, device: Any = None) -> torch.Tensor:
    """The whole tensor on ``device`` (default: the mesh's home device);
    differentiable."""
    dev = x.mesh.home if device is None else torch.device(device)
    return torch.cat([p.to(dev) for p in x.parts], dim=-2)


def tree_map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` of every leaf of a tree of named tuples, tuples, lists and
    dicts (a rollout carry); other nodes are leaves."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_leaves(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


__all__ = ["Mesh", "RowShards", "gather_rows", "make_mesh", "shard_rows", "tree_map_leaves"]
