"""The fused wrapper-net kernels over the instance batch of a mesh
(counterpart of carle_tpu/nets.py's ``_shard_fused``, ``_shard_fused_loss``,
``_shard_fused_encoder``, ``_shard_fused_decoder_loss`` and
``_shard_fused_ae``).

With ``mesh=`` (or a wrapper's ``fused_head=``) a :class:`~.mesh.Mesh`, the
six fused net functions of nets.py split the instance batch evenly over the
slots of the mesh's first axis (:func:`~.mesh.env_slots`) and run each slot's
instances as an ordinary batch: the same net function with no mesh, so the
same kernel, launched once a slot on the slot's device.

* inputs: instance shards (``RowShards`` on :func:`~.mesh.env_layout`, as
  :func:`~.mesh.shard_carry` lays the universes out) are used shard by
  shard, with no gather; a tensor is cut into equal blocks of its first
  dimension, each moved to its slot (``.to``; a no-op on one card).  A batch
  that does not divide over the slots raises ValueError: the route is
  decided by the tag, not by the shape.
* outputs: instance shards for instance-shard inputs, else concatenated in
  instance order on the home device; the per-instance errors of the loss
  routes always on the home device.
* parameters: moved to each slot (``.to``), so autograd adds the slots'
  parameter gradients on the home device, what the JAX shard_map's
  transpose does with its psum.  The input's gradient flows back through the
  blocks.
* dropout: slot s draws with ``seed + s * 0x3779B1`` modulo 2**64
  (``spatial_heads._shard_seed``: JAX's per-shard offset on the 64-bit
  seed); the JAX encoder's replicated row mask is all ones on this route,
  which the kernels' ``None`` mask is.
* on a mesh spanning processes (parallel/distributed.py) a process runs its
  own slots only, over its own instances (a tensor input is this process's
  instances; instance shards have its parts), each slot seeded by its
  global index, so it draws what it draws on one controller; the outputs
  are this process's instances.  The learners add the processes' gradients
  (mcl/_online.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from .mesh import Mesh, RowShards, env_layout, env_slots, fill_meta
from .spatial_heads import _shard_seed


def _local_env_slots(mesh: Mesh) -> List[int]:
    """This process's indices of the mesh's first axis."""
    layout = env_layout(mesh, mesh.axis_names[0])
    return [s for s in range(len(env_slots(mesh))) if layout.is_local(s)]


def instance_parts(x: Any, mesh: Mesh) -> Dict[int, torch.Tensor]:
    """Each of this process's slots' instances of ``x`` on its device, by
    the slot's index of the first axis (module note)."""
    slots, mine = env_slots(mesh), _local_env_slots(mesh)
    if isinstance(x, RowShards):
        if (x.slots != 1 or len(x.parts) != len(slots)
                or any(x.parts[s].device != slots[s] for s in mine)):
            raise ValueError(f"{x!r} is not instance shards on the slots of {mesh}")
        return {s: x.parts[s] for s in mine}
    n = len(mine)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} instances does not divide over the "
                         f"{n} slots of {mesh}")
    k = x.shape[0] // n
    return {s: x[i * k:(i + 1) * k].to(slots[s]) for i, s in enumerate(mine)}


def _params_on(p: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in p.items()}


def per_slot(mesh: Mesh, inputs: Sequence[Any], params: Sequence[Dict[str, torch.Tensor]],
             seed: int, call: Callable[..., torch.Tensor], loss: bool = False) -> Any:
    """``call(slot seed, *slot inputs, *slot params)`` for each slot of the
    mesh's first axis, the results joined as the module note says
    (``loss``: per-instance errors, on the home device)."""
    parts = [instance_parts(x, mesh) for x in inputs]
    slots = env_slots(mesh)
    outs = {s: call(_shard_seed(seed, s), *(p[s] for p in parts),
                    *(_params_on(q, slots[s]) for q in params))
            for s in _local_env_slots(mesh)}
    like = inputs[0]
    if isinstance(like, RowShards) and not loss:
        return RowShards(fill_meta([outs.get(s) for s in range(len(slots))]),
                         like.mesh, like.axis, like.env_axis)
    return torch.cat([o.to(mesh.home) for o in outs.values()])


__all__ = ["instance_parts", "per_slot"]
