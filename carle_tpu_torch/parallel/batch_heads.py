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
* dropout: slot s draws with ``seed + s * 0x3779B1`` in int32 arithmetic
  (``spatial_heads._shard_seed``), JAX's per-shard seed; the JAX encoder's
  replicated row mask is all ones on this route, which the kernels' ``None``
  mask is.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from .mesh import Mesh, RowShards, env_slots
from .spatial_heads import _shard_seed


def instance_parts(x: Any, mesh: Mesh) -> List[torch.Tensor]:
    """Each slot's instances of ``x`` on its device (module note)."""
    slots = env_slots(mesh)
    if isinstance(x, RowShards):
        if x.slots != 1 or [p.device for p in x.parts] != list(slots):
            raise ValueError(f"{x!r} is not instance shards on the slots of {mesh}")
        return list(x.parts)
    n = len(slots)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} instances does not divide over the "
                         f"{n} slots of {mesh}")
    k = x.shape[0] // n
    return [x[s * k:(s + 1) * k].to(d) for s, d in enumerate(slots)]


def _params_on(p: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in p.items()}


def per_slot(mesh: Mesh, inputs: Sequence[Any], params: Sequence[Dict[str, torch.Tensor]],
             seed: int, call: Callable[..., torch.Tensor], loss: bool = False) -> Any:
    """``call(slot seed, *slot inputs, *slot params)`` for each slot of the
    mesh's first axis, the results joined as the module note says
    (``loss``: per-instance errors, on the home device)."""
    parts = [instance_parts(x, mesh) for x in inputs]
    outs = [call(_shard_seed(seed, s), *(p[s] for p in parts),
                 *(_params_on(q, dev) for q in params))
            for s, dev in enumerate(env_slots(mesh))]
    like = inputs[0]
    if isinstance(like, RowShards) and not loss:
        return RowShards(outs, like.mesh, like.axis, like.env_axis)
    return torch.cat([o.to(mesh.home) for o in outs])


__all__ = ["instance_parts", "per_slot"]
