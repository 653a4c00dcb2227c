"""Online-learning machinery of the bonus wrappers (counterpart of
carle_tpu/mcl/_online.py).

The reference trains its predictor nets inside ``env.step``: it accumulates a
mean loss for ``batch_size`` (64) steps, then takes one Adam step.  Parameters
do not change between optimizer steps, so accumulating per-step gradients and
stepping Adam on their mean is the same thing; the accumulator and its
counter ride in :class:`LearnerState`.

:class:`LearnerState` carries every slot of the JAX package's learner,
including Adam's ``mu``/``nu``/``count``; ``opt_state`` is
``({"count", "mu", "nu"},)``, whose flattened keys (``opt_state/0/mu/conv1/w``)
are the JAX package's, so checkpoints cross both ways.

Nothing here waits for the device.  Whether a step is the one that updates is
a device predicate (``buffer_length + 1 >= batch_size``, both tensors), so the
update is branch-free: every step computes the Adam candidate on the ~17k
parameters and ``torch.where`` selects it or the carried values.  Changing
``batch_size`` or loading a checkpoint is therefore just a state update.

Every learned wrapper of the reference declares its own learning rate but
builds its optimizer before the subclass assignment runs, so the effective
rate is 6e-2 for all; ``lr=None`` means that.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch

REFERENCE_EFFECTIVE_LR = 6e-2   # what the reference actually uses everywhere
BATCH_SIZE = 64                 # the reference's accumulation window
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # torch.optim.Adam defaults


class LearnerState(NamedTuple):
    """Carried state of one online-learning wrapper."""

    reward_scale: torch.Tensor   # float32 scalar
    batch_size: torch.Tensor     # int32 scalar
    params: Any                  # predictor parameter dict
    target_params: Any           # frozen-net parameters ({} when none)
    opt_state: Any               # ({"count", "mu", "nu"},) Adam slots
    grad_accum: Any              # same structure as params
    buffer_length: torch.Tensor  # int32 scalar
    updates: torch.Tensor        # int32 scalar
    extra: Any                   # wrapper-specific carry


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a nested parameter dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """The structure of ``like`` filled from ``leaves`` (an iterator or a
    list in :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def init_learner(reward_scale: float, params: Any, target_params: Any,
                 device: torch.device, batch_size: int = BATCH_SIZE) -> LearnerState:
    scalar = torch.zeros((), dtype=torch.int32, device=device)
    return LearnerState(
        reward_scale=torch.as_tensor(reward_scale, dtype=torch.float32,
                                     device=device),
        batch_size=torch.as_tensor(batch_size, dtype=torch.int32, device=device),
        params=params,
        target_params=target_params,
        opt_state=({"count": scalar.clone(), "mu": tree_map(torch.zeros_like, params),
                    "nu": tree_map(torch.zeros_like, params)},),
        grad_accum=tree_map(torch.zeros_like, params),
        buffer_length=scalar.clone(),
        updates=scalar.clone(),
        extra=(),
    )


def adam_step(params: torch.Tensor, grads: torch.Tensor, mu: torch.Tensor,
              nu: torch.Tensor, count: torch.Tensor, lr: float):
    """One Adam step as ``optax.adam(lr, 0.9, 0.999, 1e-8)`` takes it:
    returns (params', mu', nu', count').  ``count`` is the int32 step counter;
    the bias corrections are float32 ``1 - beta ** count'``, and eps is added
    outside the square root of the corrected second moment."""
    count = count + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(ADAM_B1, t)   # scalar base: no host-to-device copy
    bc2 = 1.0 - torch.pow(ADAM_B2, t)
    mu = (mu * ADAM_B1).add_(grads, alpha=1.0 - ADAM_B1)
    nu = (nu * ADAM_B2).addcmul_(grads, grads, value=1.0 - ADAM_B2)
    denom = (nu / bc2).sqrt_().add_(ADAM_EPS)
    step = (mu / bc1).div_(denom).mul_(-lr)
    return params + step, mu, nu, count


def _flat(tree: Any) -> torch.Tensor:
    """Every leaf of a parameter tree as one vector, in tree_leaves order."""
    return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(tree)])


def _unflat(flat: torch.Tensor, like: Any) -> Any:
    """Views of ``flat`` in the structure and shapes of ``like``."""
    leaves = tree_leaves(like)
    parts = flat.split([leaf.numel() for leaf in leaves])
    return tree_unflatten(like, [p.view(leaf.shape) for p, leaf in zip(parts, leaves)])


def accumulate_and_maybe_update(state: LearnerState, grads: Any,
                                lr: float) -> LearnerState:
    """Reference ``get_bonus_accumulate`` semantics: add this step's
    gradients, bump the counter, and when it reaches ``batch_size`` apply Adam
    on the batch-mean gradient, clear the accumulator, reset the counter and
    count the update.  Branch-free on the device predicate (module note); the
    arithmetic runs on one flat vector a slot, so its launches do not grow with
    the number of leaves, and the new leaves are views of those vectors."""
    adam = state.opt_state[0]
    params, mu, nu = _flat(state.params), _flat(adam["mu"]), _flat(adam["nu"])
    accum = _flat(state.grad_accum) + _flat(grads)
    count = state.buffer_length + 1
    do_update = count >= state.batch_size
    new_params, new_mu, new_nu, new_count = adam_step(
        params, accum / state.batch_size.to(torch.float32), mu, nu, adam["count"], lr)

    def select(updated, carried):
        return _unflat(torch.where(do_update, updated, carried), state.params)

    opt_state = ({"count": torch.where(do_update, new_count, adam["count"]),
                  "mu": select(new_mu, mu), "nu": select(new_nu, nu)},)
    return state._replace(
        params=select(new_params, params),
        opt_state=opt_state,
        grad_accum=select(torch.zeros_like(accum), accum),
        buffer_length=torch.where(do_update, torch.zeros_like(count), count),
        updates=state.updates + do_update.to(torch.int32),
    )


def net_input(ctx: Any, fused_head: Any = None) -> Any:
    """The observation a wrapper net consumes: the packed universe itself,
    uint32 words [inst, 1, H, W/32], when the stack carries one (the kernels
    expand the words in shared memory, so no cell view is built), else the
    uint8 cells.  The float32 copy never reaches the kernels.  On a
    row-sharded stack the words stay sharded for a ``fused_head`` of
    ``nets.SpaceSharding`` and are gathered for any other route."""
    from ..nets import SpaceSharding
    from ..parallel.mesh import RowShards, gather_rows

    packed = getattr(ctx, "packed", None)
    if isinstance(packed, RowShards):
        if isinstance(fused_head, SpaceSharding):
            return packed.map(lambda p: p[:, None])
        return gather_rows(packed)[:, None]
    if packed is not None:
        return packed[:, None]
    return ctx.obs_cells


def learner_apply(
    loss_fn: Callable[[Any, LearnerState, Any], Tuple[torch.Tensor, Any]],
    bonus_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    lr: float = REFERENCE_EFFECTIVE_LR,
    train: bool = True,
):
    """Build a WrapperDef.apply for an online learner.
    ``loss_fn(params, state, ctx) -> (per_instance_loss [inst], new_extra)``
    defines the objective over the step context (dropout seed in
    ``ctx.seed``); ``bonus_fn(loss, ctx) -> [inst, 1]`` maps it to the bonus.

    With ``train`` the gradient of the mean loss is taken on detached leaf
    copies of the parameters (so the state's tensors stay plain and callers
    under ``no_grad`` still work), accumulated, and applied as
    :func:`accumulate_and_maybe_update` says.  With ``train=False`` this is
    the reference's ``get_bonus_only``: forward pass only, no graph, no
    gradient or optimizer work."""

    def apply(state: LearnerState, ctx: Any, reward: torch.Tensor):
        if train:
            leaves = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
            with torch.enable_grad():
                per_inst, new_extra = loss_fn(leaves, state, ctx)
                grads = torch.autograd.grad(per_inst.mean(), tree_leaves(leaves))
            per_inst = per_inst.detach()
            with torch.no_grad():
                state = accumulate_and_maybe_update(
                    state._replace(extra=new_extra),
                    tree_unflatten(state.params, grads), lr)
        else:
            with torch.no_grad():
                per_inst, new_extra = loss_fn(state.params, state, ctx)
            state = state._replace(extra=new_extra)
        return state, reward + state.reward_scale * bonus_fn(per_inst, ctx)

    return apply
