"""Device meshes and row shards (counterpart of carle_tpu/parallel/mesh.py's
``make_mesh`` and of a JAX array row-sharded over a mesh).

The JAX package's spatial tier is one program over a mesh (``shard_map``):
each device holds a block of rows and trades ghost rows with its ring
neighbours.  Here one controller holds a list of per-slot shards:

* :class:`Mesh` is a list of slots, each a ``torch.device``, over one axis
  or over two (``Mesh([[d00, d01, ...], [d10, ...]], ("env", "space"))``,
  the counterpart of ``Mesh(devs.reshape(n_env, n_space), ("env",
  "space"))``: slots in row-major order).  Slots may repeat one device
  (several shards on one card, the single-card case) or name several CUDA
  devices, which must reach each other's memory by peer access (NVLink); a
  mesh whose cards cannot raises.  A CPU mesh exists only when the caller
  lists ``cpu`` slots (the tests use 8, as the JAX tests use 8 CPU
  devices).
* :class:`RowShards` is a tensor whose rows (dimension -2) are split evenly
  over the slots of the row axis: one tensor per slot, each its own
  allocation on its slot's device.  On a two-axis mesh the rows split over
  the second axis (``space``) and, with ``env_axis``, the instances
  (dimension 0) over the first: slot (e, s) holds instances
  [e I/n_env, (e + 1) I/n_env) and rows [s H/n_space, (s + 1) H/n_space).
  Each env group's slots form a ring of their own (:meth:`RowShards.rings`,
  on :meth:`Mesh.ring`), and every halo kernel is handed one ring at a time
  (:func:`ringwise`), so a slot never reads another group's rows.  Without
  ``env_axis`` a two-axis mesh's shards hold every instance on the first
  group's ring: where the JAX package replicates such a leaf over ``env``,
  one controller keeps one copy.  :func:`shard_rows` and
  :func:`gather_rows` move between the two (the gather in instance order).
  They stand in for GSPMD's placement: nothing reads a neighbour's rows by
  indexing one big tensor.

Env-batch data parallelism (counterpart of carle_tpu/parallel/mesh.py's
``env_sharding``, ``shard_carry`` and ``replicate``) splits the instance
batch over the slots of the mesh's first axis and keeps everything else
whole:

* :func:`env_sharding` is JAX's placement rule exactly: a leaf shards over
  the env axis only where dimension 0 equals ``instances`` and ``instances``
  divides by that axis's extent (not the slot count; they differ on a
  two-axis mesh).  It returns the spec tuple (``("env", None, None)``), or
  None where JAX's is ``P()``, as ``spatial_env.spatial_sharding`` returns a
  placement: there is no ``NamedSharding`` to return.
* :func:`shard_carry` lays the universes out on :func:`env_layout`, the
  two-axis ``Mesh([[d] for d in env_slots(mesh)], ("env", "space"))`` with a
  space extent of 1 (the env x space layout; cached on the mesh): a uint8
  universe [inst, H, W], or packed words [inst, H, W/32], becomes
  ``RowShards(env_axis="env")``, one slot's instances whole a shard and each
  slot a ring of one, so the env step, the stacks, resets, ``universe`` and
  the gathered views of the spatial env mode run on it unchanged (a halo
  launch a ring: n launches a step where the unsharded step launches
  once).  Every other leaf stays whole on the home device: parameters, Adam
  moments, rule bits, counters, the agent's state, and the per-instance
  statistics, frame rings and action streams that the JAX package shards
  over ``env`` (GSPMD hides that from the wrappers; here the wrappers read
  gathered views, and the nets the shards themselves: nets.py's batch-axis
  routes).
* :func:`replicate` puts a tree on the home device; each launch of a
  batch-axis route copies the weights it needs onto its slot's device
  (a no-op on one card), as ``parallel/spatial_heads.py`` does.

On a two-axis mesh the instances shard over the first axis, on each env
group's first slot (:func:`env_slots`): the JAX package replicates an
instance shard over the second axis, one controller keeps one copy.

**Several processes** (parallel/distributed.py): a mesh may span the slots
of several processes.  Each slot has an owner (:attr:`Mesh.owners`, ranks);
``make_mesh()`` under an initialised group lists every process's slots in
process order (``distributed.global_slots``), as ``jax.devices()`` spans
hosts, every process with as many slots.  A process holds only its own
slots' parts: a :class:`RowShards`' part of another process's slot is a
``meta`` tensor of the shard's shape and dtype (:meth:`RowShards.is_local`),
so shapes are known everywhere and any use of the data fails loudly.  Every
per-slot loop runs over the local slots; a ring whose slots all belong to
other processes is skipped (:func:`ringwise`), and a ring that spans
processes trades its ghost rows point to point (parallel/ghosts.py).  The
home device is this process's first slot.  :func:`gather_rows` gives this
process's instances, joining a ring that spans processes by a sum of its
parts over the processes (every process joins, counted in
``distributed.STATS``).  :func:`shard_carry` and its kin keep each
process's parts of a tree that every process built the same from the same
seed (what each JAX worker does with ``ro.init(PRNGKey(0))``), and on an
instance split also this process's rows of the leaves a state declares
per-instance (:data:`PER_INSTANCE`); what stays whole is a copy a process
on its home device (:func:`replicate`).
:func:`local_batch` says which instances a process holds.  A mesh within
one process (no group, or slots listed by hand) is as before.
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
    """A mesh of slots (counterpart of the ``jax.sharding.Mesh`` that
    ``make_mesh`` builds, or of a two-axis one): ``devices`` the slots in
    row-major order, ``axis_names`` one or two names, ``shape`` each axis's
    extent.  A two-axis mesh takes its slots as a sequence of equal rows,
    one a group of the first axis.  ``owners`` gives each slot's process
    (default: all this process's).  This process's first slot is the home
    device, where gathered views and replicated state live."""

    def __init__(self, devices: Sequence[Any], axis_names: Tuple[str, ...] = ("env",),
                 owners: Optional[Sequence[int]] = None) -> None:
        axis_names = tuple(axis_names)
        if len(axis_names) == 2:
            groups = [list(g) for g in devices]
            if not groups or any(len(g) != len(groups[0]) for g in groups):
                raise ValueError("a two-axis mesh takes its slots as rows of equal length")
            extents = (len(groups), len(groups[0]))
            devices = [d for g in groups for d in g]
        elif len(axis_names) == 1:
            devices = list(devices)
            extents = (len(devices),)
        else:
            raise ValueError(f"a mesh has one or two axes here, got {axis_names}")
        devices = tuple(_slot(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one slot")
        kinds = {d.type for d in devices}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"mesh slots must be all cpu or all cuda, got {devices}")
        from . import distributed   # imported on use: `python -m ...distributed` runs it

        rank = distributed.process_index()
        owners = (rank,) * len(devices) if owners is None else tuple(int(o) for o in owners)
        if len(owners) != len(devices):
            raise ValueError(f"{len(owners)} owners for {len(devices)} slots")
        self.owners = owners
        self.rank = rank
        # the peer check covers this process's cards only
        cards = sorted({d.index for d, o in zip(devices, owners) if d.type == "cuda" and o == rank})
        for a in cards:
            for b in cards:
                if a != b and not torch.cuda.can_device_access_peer(a, b):
                    raise ValueError(f"mesh slots cuda:{a} and cuda:{b} cannot reach "
                                     "each other's memory (no peer access)")
        self.devices = devices
        self.axis_names = axis_names
        self._extents = extents
        self._rings: Dict[int, "Mesh"] = {}
        self._env_layout: Optional["Mesh"] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._extents))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """This process's first slot (a ring of other processes' slots, seen
        from here: its first)."""
        return self.devices[self.owners.index(self.rank) if self.rank in self.owners else 0]

    def is_local(self, s: int) -> bool:
        """Whether slot s belongs to this process."""
        return self.owners[s] == self.rank

    @property
    def local_slots(self) -> List[int]:
        return [s for s, o in enumerate(self.owners) if o == self.rank]

    @property
    def multi(self) -> bool:
        """Whether the slots belong to more than one process."""
        return len(set(self.owners)) > 1

    def ring(self, group: int = 0) -> "Mesh":
        """The one-axis mesh of env group ``group``'s slots, over the second
        axis (a one-axis mesh is its own only ring); the same object on
        every call."""
        if len(self.axis_names) == 1:
            if group != 0:
                raise ValueError(f"a one-axis mesh has one ring, not {group + 1}")
            return self
        if group not in self._rings:
            n = self._extents[1]
            self._rings[group] = Mesh(self.devices[group * n:(group + 1) * n],
                                      self.axis_names[1:], self.owners[group * n:(group + 1) * n])
        return self._rings[group]

    def __repr__(self) -> str:
        owners = f", owners={self.owners}" if self.multi else ""
        if len(self.axis_names) == 1:
            return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names}{owners})"
        return (f"Mesh({[str(d) for d in self.devices]}, {self.axis_names}, "
                f"shape={self._extents}{owners})")


def make_mesh(devices: Optional[Sequence[Any]] = None, axis_name: str = "env") -> Mesh:
    """A one-axis mesh over ``devices`` (default: under an initialised
    process group every process's slots, ``distributed.global_slots``, each
    process with as many; else every visible CUDA device, and without one
    this raises: a CPU mesh is built only from ``cpu`` slots the caller
    lists)."""
    from . import distributed

    if devices is None and distributed.is_initialized():
        slots = distributed.global_slots()
        counts = {r: sum(1 for o, _ in slots if o == r) for r, _ in slots}
        if len(set(counts.values())) != 1:
            raise ValueError(f"every process must bring as many slots: {counts}")
        return Mesh([d for _, d in slots], (axis_name,), [r for r, _ in slots])
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes every visible CUDA device and "
                               "found none; list cpu slots to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis_name,))


def _layout(mesh: Mesh, axis: str, env_axis: Optional[str]) -> Tuple[int, int]:
    """(env groups, slots a ring) of shards over ``axis`` (and ``env_axis``)
    of ``mesh``, after checking the axes."""
    if len(mesh.axis_names) == 1:
        if env_axis is not None:
            raise ValueError(f"env axis {env_axis!r} on the one-axis mesh {mesh.axis_names}")
        return 1, mesh.size
    env_name, space_name = mesh.axis_names
    if axis != space_name:
        raise ValueError(f"rows shard over a two-axis mesh's second axis {space_name!r}, "
                         f"not {axis!r}")
    if env_axis not in (None, env_name):
        raise ValueError(f"instances shard over a two-axis mesh's first axis "
                         f"{env_name!r}, not {env_axis!r}")
    n_env, n_space = mesh.shape[env_name], mesh.shape[space_name]
    return (n_env if env_axis else 1), n_space


class RowShards:
    """A tensor [N, ..., H, W*] whose H rows are split evenly over the slots
    of a mesh's row axis ``axis``: ``parts[s]`` holds rows [s H/n, (s + 1)
    H/n) on slot s's device.  On a two-axis mesh with ``env_axis`` the
    instances split too: ``parts[e n_space + s]`` holds env group e's
    instances (module note); without it the shards lie on the first group's
    ring."""

    __slots__ = ("parts", "mesh", "axis", "env_axis")

    def __init__(self, parts: Sequence[torch.Tensor], mesh: Mesh, axis: str = "space",
                 env_axis: Optional[str] = None) -> None:
        parts = list(parts)
        groups, n = _layout(mesh, axis, env_axis)
        if len(parts) != groups * n:
            raise ValueError(f"{len(parts)} shards for {groups} ring(s) of {n} slots")
        self.parts = parts
        self.mesh = mesh
        self.axis = axis
        self.env_axis = env_axis

    @property
    def groups(self) -> int:
        """Env groups (rings) the shards split the instances over."""
        return self.mesh.shape[self.env_axis] if self.env_axis else 1

    @property
    def slots(self) -> int:
        """Slots a ring."""
        return len(self.parts) // self.groups

    @property
    def rows(self) -> int:
        """Rows a slot holds."""
        return self.parts[0].shape[-2]

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[0] *= self.groups
        s[-2] *= self.slots
        return torch.Size(s)

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    def offsets(self) -> List[int]:
        """The global row of each slot's first row."""
        return [(i % self.slots) * self.rows for i in range(len(self.parts))]

    def is_local(self, i: int) -> bool:
        """Whether part i (on slot i: without ``env_axis`` the parts lie on the
        first ring) is this process's (else a ``meta`` tensor)."""
        return self.mesh.is_local(i)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RowShards":
        """``fn`` of every shard, in place of it (row counts kept equal);
        another process's parts stay ``meta`` tensors of the result's shape."""
        return RowShards(local_map(self, lambda i, p: fn(p)), self.mesh, self.axis,
                         self.env_axis)

    def local_instances(self) -> slice:
        """The instances this process holds: those of the rings with a slot of
        its own (all of them within one process)."""
        if self.groups == 1:
            return slice(0, self.shape[0])
        k, n = self.parts[0].shape[0], self.slots
        mine = [e for e in range(self.groups)
                if any(self.mesh.is_local(e * n + s) for s in range(n))]
        return slice(mine[0] * k, (mine[-1] + 1) * k)

    def batch_rows(self, e: int) -> slice:
        """Ring e's instances within this process's per-instance tensors
        (:meth:`local_instances`)."""
        sl, lo = self.instances()[e], self.local_instances().start
        if sl.start is None:
            return sl
        return slice(sl.start - lo, sl.stop - lo)

    def instances(self) -> List[slice]:
        """The slice of the batch each ring holds, in ring order."""
        if self.groups == 1:
            return [slice(None)]
        k = self.parts[0].shape[0]
        return [slice(e * k, (e + 1) * k) for e in range(self.groups)]

    def rings(self) -> List["RowShards"]:
        """Each env group's shards as one-axis shards on its ring
        (:meth:`Mesh.ring`), in instance order."""
        n = self.slots
        return [RowShards(self.parts[e * n:(e + 1) * n], self.mesh.ring(e), self.axis)
                for e in range(self.groups)]

    def take(self, instance: int) -> "RowShards":
        """One instance's shards ([1, ...]) on the ring that holds it (the
        instance counted within this process's, :meth:`local_instances`)."""
        instance += self.local_instances().start
        k = self.parts[0].shape[0]
        ring = self.rings()[instance // k if self.groups > 1 else 0]
        i = instance % k if self.groups > 1 else instance
        return ring.map(lambda p: p[i:i + 1])

    def __repr__(self) -> str:
        env = f", env_axis={self.env_axis!r}" if self.env_axis else ""
        return f"RowShards({tuple(self.shape)}, {self.parts[0].dtype}, {self.mesh}{env})"


def fill_meta(outs: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """Per-slot results with None for another process's slot: each None a
    ``meta`` tensor shaped as the first result (every slot's are alike)."""
    like = next(o for o in outs if o is not None)
    return [torch.empty(like.shape, dtype=like.dtype, device="meta") if o is None else o
            for o in outs]


def local_map(x: RowShards, fn: Callable[[int, torch.Tensor], torch.Tensor]
              ) -> List[torch.Tensor]:
    """``fn(i, part)`` of this process's parts; the others ``meta`` tensors
    shaped as the results."""
    return fill_meta([fn(i, p) if x.is_local(i) else None for i, p in enumerate(x.parts)])


def ringwise(x: RowShards, fn: Callable[[RowShards, int], RowShards]) -> RowShards:
    """``fn(ring, e)`` of each env group e's ring (``x.instances()[e]`` the
    slice of the batch it holds, ``x.batch_rows(e)`` the same within this
    process's per-instance tensors), the rings' results together again on x's
    mesh: how a one-axis operation runs on a two-axis mesh, each ring
    independent of the others.  A ring of other processes' slots only is
    skipped: its parts stay ``meta``, shaped as a local ring's results."""
    rings = x.rings()
    outs = [fn(r, e) if any(r.is_local(i) for i in range(len(r.parts))) else None
            for e, r in enumerate(rings)]
    n = len(rings[0].parts)
    parts = fill_meta([p for o in outs for p in (o.parts if o is not None else [None] * n)])
    return RowShards(parts, x.mesh, x.axis, x.env_axis)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "space",
               env_axis: Optional[str] = None) -> RowShards:
    """Split ``x``'s rows (dimension -2) evenly over the slots of the mesh's
    row axis, and with ``env_axis`` its instances (dimension 0) over the env
    groups; each shard a new allocation on its slot's device."""
    groups, n = _layout(mesh, axis, env_axis)
    h = x.shape[-2]
    if h % n:
        raise ValueError(f"height {h} not divisible by the {axis} axis ({n})")
    if groups > 1 and x.shape[0] % groups:
        raise ValueError(f"instances {x.shape[0]} not divisible by the {env_axis} axis "
                         f"({groups})")
    hl, k = h // n, x.shape[0] // groups
    parts = []
    for i, dev in enumerate(mesh.devices[:groups * n]):
        e, s = divmod(i, n)
        block = (x if groups == 1 else x[e * k:(e + 1) * k])[..., s * hl:(s + 1) * hl, :]
        part = torch.empty(block.shape, dtype=x.dtype,
                           device=dev if mesh.is_local(i) else "meta")
        if mesh.is_local(i):
            part.copy_(block)
        parts.append(part)
    return RowShards(parts, mesh, axis, env_axis)


def _spans(ring: RowShards) -> bool:
    """Whether a ring's slots belong to more than one process."""
    return len(set(ring.mesh.owners)) > 1


def combine_rings(x: RowShards, totals: Dict[int, torch.Tensor], dim: int = 0
                  ) -> torch.Tensor:
    """Per-ring tensors over each ring's instances (``dim``), ``totals[e]``
    this process's part of ring e (its own slots' sum), as one tensor over
    this process's instances: a ring that spans processes summed over them
    (every process joins, with zeros where it holds none of the ring's
    slots; ``distributed.world_sum``, differentiable), the rings in instance
    order.  Within one process: the rings' totals concatenated."""
    from . import distributed

    like = next(iter(totals.values()))
    out = []
    for e, ring in enumerate(x.rings()):
        if _spans(ring) and x.mesh.multi:
            t = distributed.world_sum(totals[e] if e in totals else torch.zeros_like(like))
        else:
            t = totals.get(e)
        if any(ring.is_local(i) for i in range(len(ring.parts))):
            out.append(t)
    return out[0] if len(out) == 1 else torch.cat(out, dim=dim)


def gather_rows(x: RowShards, device: Any = None) -> torch.Tensor:
    """The whole tensor on ``device`` (default: the mesh's home device), the
    instances in order; differentiable.  On a mesh spanning processes: this
    process's instances (:meth:`RowShards.local_instances`), a ring that
    spans processes gathered by :func:`combine_rings` (each process's rows
    placed in zeros and summed; every process joins)."""
    dev = x.mesh.home if device is None else torch.device(device)
    if not x.mesh.multi:
        rings = [torch.cat([p.to(dev) for p in r.parts], dim=-2) for r in x.rings()]
        return rings[0] if len(rings) == 1 else torch.cat(rings, dim=0)
    totals = {}
    for e, ring in enumerate(x.rings()):
        if not any(ring.is_local(i) for i in range(len(ring.parts))):
            continue
        rows = [p.to(dev) if ring.is_local(i) else torch.zeros(p.shape, dtype=p.dtype,
                                                                device=dev)
                for i, p in enumerate(ring.parts)]
        totals[e] = torch.cat(rows, dim=-2)
    words = next(iter(totals.values())).dtype
    wire = {torch.uint32: torch.int32, torch.bool: torch.uint8}.get(words)
    if wire is not None:   # summed as their bits
        totals = {e: t.view(wire) if words == torch.uint32 else t.to(wire)
                  for e, t in totals.items()}
    out = combine_rings(x, totals)
    return out if wire is None else (out.view(words) if words == torch.uint32
                                     else out.to(words))


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


def env_slots(mesh: Mesh) -> Tuple[torch.device, ...]:
    """The slot of each index of the mesh's first axis, the instance axis:
    a one-axis mesh's slots; a two-axis mesh's first slot of each env
    group."""
    if len(mesh.axis_names) == 1:
        return mesh.devices
    return mesh.devices[::mesh.shape[mesh.axis_names[1]]]


def env_layout(mesh: Mesh, axis_name: str = "env") -> Mesh:
    """The two-axis mesh the instance shards of ``mesh`` lie on (module
    note): ``Mesh([[d] for d in env_slots(mesh)], (axis_name, "space"))``, the
    same object on every call; a two-axis mesh whose second axis has one slot
    is its own.  ``axis_name`` must be the mesh's first axis."""
    if axis_name != mesh.axis_names[0]:
        raise ValueError(f"instances shard over the mesh's first axis "
                         f"{mesh.axis_names[0]!r}, not {axis_name!r}")
    if len(mesh.axis_names) == 2 and mesh.shape[mesh.axis_names[1]] == 1:
        return mesh
    if mesh._env_layout is None:
        rows = "space" if axis_name != "space" else "rows"
        step = 1 if len(mesh.axis_names) == 1 else mesh.shape[mesh.axis_names[1]]
        mesh._env_layout = Mesh([[d] for d in env_slots(mesh)], (axis_name, rows),
                                mesh.owners[::step])
    return mesh._env_layout


def env_sharding(mesh: Mesh, leaf: Any, instances: int, axis_name: str = "env") -> Any:
    """Where one state leaf goes (carle_tpu/parallel/mesh.py::env_sharding):
    the spec ``(axis_name, None, ...)``, one entry a dimension, where
    dimension 0 equals ``instances`` and ``instances`` divides by the extent
    of ``axis_name``; else None (JAX's ``P()``: whole).  Only dimension 0 is
    considered, so a leaf whose inner dimension equals ``instances`` stays
    whole."""
    shape = tuple(getattr(leaf, "shape", ()))
    if shape and shape[0] == instances and instances % mesh.shape[axis_name] == 0:
        return (axis_name,) + (None,) * (len(shape) - 1)
    return None


def shard_carry(carry: Any, mesh: Mesh, config: Any, axis_name: str = "env") -> Any:
    """A rollout carry (or any state tree) with its universes (uint8 [inst,
    H, W], packed words [inst, H, W/32]) sharded over the instance axis where
    :func:`env_sharding` shards them, as instance shards on
    :func:`env_layout`, and every other tensor on the home device (module
    note; across processes also this process's rows of the leaves a state
    declares per-instance, :data:`PER_INSTANCE`, where :func:`env_sharding`
    shards them); row shards and non-tensors as they are."""
    layout = env_layout(mesh, axis_name)
    n, h, w = config.instances, config.height, config.width
    universes = {((n, h, w), torch.uint8), ((n, h, w // 32), torch.uint32)}

    def place(leaf, per_instance):
        if isinstance(leaf, RowShards) or not isinstance(leaf, torch.Tensor):
            return leaf
        split = env_sharding(mesh, leaf, n, axis_name) is not None
        if (tuple(leaf.shape), leaf.dtype) in universes and split:
            return shard_rows(leaf, layout, layout.axis_names[1], axis_name)
        if split and per_instance and layout.multi:   # this process's instances
            leaf = _local_rows(mesh, leaf, n, axis_name)
        return leaf.to(layout.home)

    def walk(node, per_instance=False):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            declared = getattr(type(node), PER_INSTANCE, ())
            return type(node)(*(walk(v, f in declared) for f, v in zip(node._fields, node)))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return place(node, per_instance)

    return walk(carry)


# the class attribute by which a state (a NamedTuple) names its fields whose
# dimension 0 is the instance batch: shard_carry splits those, and only
# those, over a mesh's processes (a dimension that equals the instances by
# chance, a parameter's or Speed's [2, instances], stays whole)
PER_INSTANCE = "per_instance_fields"


def local_batch(x: Any) -> Optional[distributed.LocalBatch]:
    """Which instances this process holds of a universe ``x`` laid out on a
    mesh spanning processes (``distributed.LocalBatch``: its window, the
    instances it reports in batch-global sums and their weights in a batch
    mean); None for a tensor or a mesh within one process."""
    from . import distributed

    if not isinstance(x, RowShards) or not x.mesh.multi:
        return None
    sl, n = x.local_instances(), x.shape[0]
    k, slots = (x.parts[0].shape[0], x.slots) if x.groups > 1 else (n, x.slots)
    owned = []
    for e in range(sl.start // k, sl.stop // k):
        owners = x.mesh.owners[e * slots:(e + 1) * slots] if x.groups > 1 else \
            x.mesh.owners[:slots]
        owned += [min(owners) == x.mesh.rank] * k
    owned_t = torch.tensor(owned, dtype=torch.bool, device=x.mesh.home)
    return distributed.LocalBatch(sl.start, sl.stop, n, owned_t,
                                  owned_t.to(torch.float32) / n)


def _local_rows(mesh: Mesh, leaf: torch.Tensor, n: int, axis_name: str) -> torch.Tensor:
    """This process's rows (its env slots' instances) of a per-instance leaf
    on a mesh spanning processes."""
    slots = env_slots(mesh)
    k = n // len(slots)
    first = env_layout(mesh, axis_name)
    mine = [e for e in range(len(slots)) if first.is_local(e)]
    return leaf[mine[0] * k:(mine[-1] + 1) * k]


def replicate(tree: Any, mesh: Mesh) -> Any:
    """A tree whole on the mesh's home device (row shards gathered), where
    the JAX package replicates it over every device: on a mesh spanning
    processes, each process's own copy on its home device."""
    def place(leaf):
        if isinstance(leaf, RowShards):
            return gather_rows(leaf, mesh.home)
        return leaf.to(mesh.home) if isinstance(leaf, torch.Tensor) else leaf

    return tree_map_leaves(place, tree)


__all__ = ["Mesh", "PER_INSTANCE", "RowShards", "combine_rings", "env_layout", "env_sharding",
           "env_slots", "fill_meta", "gather_rows", "local_batch", "local_map", "make_mesh",
           "replicate", "ringwise", "shard_carry", "shard_rows", "tree_map_leaves"]
