"""Device-memory preflight: price a training step before the first segment
(counterpart of carle_tpu/utils/preflight.py).

The JAX package prices its compiled step with XLA's ``memory_analysis``;
PyTorch compiles nothing ahead, so the price here is the card's own:

* **arguments** (``argument_size_in_bytes``): the bytes of every tensor in
  the state the step carries (universes, stack state, parameters, Adam
  moments), each storage counted once;
* **transient** (``temp_size_in_bytes``): what one step allocates beyond
  its arguments at its peak.  On the card the step runs once on a copy of
  the state cut to a slice of the instances, and the slice's peak is the
  rise of ``torch.cuda.max_memory_allocated`` over the allocation before it
  (after ``reset_peak_memory_stats``).  Two slices, one twice the other,
  give the cost of an instance and the part that no instance pays (the
  nets' gradients), and the line through them is read at the whole batch.
  The copies are dropped after, and the run's state and generators are not
  touched.  A first run of the smallest slice goes before them: what it
  leaves allocated (the libraries' workspaces and caches, where this process
  has not made them yet) is ``workspace_size_in_bytes``.  The CPU has no
  allocator statistic: there the transient counts as 0 and the dict says so
  (``temp_measured``).

``peak_estimate_gib`` is arguments plus transient plus workspace.  ``budget_gib=None``
checks only on the card, against its total memory
(``torch.cuda.mem_get_info``) less :data:`MARGIN_FRACTION` of it and never
less than :data:`MARGIN_MIN_GIB`: the CUDA context, the kernels' libraries
and the caching allocator's rounding live outside what the allocator counts.
An explicit budget engages the check on any device; ``force=True`` warns and
goes on.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..parallel.mesh import tree_map_leaves

# the part of the card's memory kept out of the default budget, and its floor
MARGIN_FRACTION = 0.05
MARGIN_MIN_GIB = 1.0
GIB = 2 ** 30


class HBMBudgetError(RuntimeError):
    """A priced step exceeds the device-memory budget; ``analysis`` is the
    price (:func:`price_program`)."""

    def __init__(self, message: str, analysis: Dict[str, Any]):
        super().__init__(message)
        self.analysis = analysis


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree (row shards by their parts), off the meta device."""
    found: List[torch.Tensor] = []

    def visit(leaf: Any) -> None:
        for t in getattr(leaf, "parts", None) or (leaf,):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                found.append(t)

    tree_map_leaves(visit, tree)
    return found


def tensor_bytes(tree: Any) -> int:
    """Bytes of the tensors in ``tree``, each storage once."""
    storages = {(t.device, t.untyped_storage().data_ptr()): t.untyped_storage().nbytes()
                for t in _tensors(tree)}
    return sum(storages.values())


def device_of(tree: Any) -> Optional[torch.device]:
    """The device of the first tensor in ``tree`` (None without one)."""
    tensors = _tensors(tree)
    return tensors[0].device if tensors else None


def copy_tree(tree: Any) -> Any:
    """A copy of ``tree`` that shares no tensor and no generator state."""
    def copy(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.clone()
        if isinstance(leaf, torch.Generator):
            gen = torch.Generator(device=leaf.device)
            gen.set_state(leaf.get_state())
            return gen
        return leaf
    return tree_map_leaves(copy, tree)


def _transient(fn: Callable[..., Any], args: Tuple[Any, ...], kwargs: Dict[str, Any],
               device: torch.device) -> Tuple[int, int]:
    """(peak bytes that ``fn(*copies of args)`` allocates on ``device`` above
    what was allocated before it, bytes it leaves allocated once its copies
    and outputs are dropped)."""
    torch.cuda.synchronize(device)
    start = torch.cuda.memory_allocated(device)
    copies = copy_tree(args)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*copies, **kwargs)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del out, copies
    return max(int(peak), 0), max(int(torch.cuda.memory_allocated(device) - start), 0)


def price_program(fn: Callable[..., Any], *args: Any,
                  cut: Optional[Callable[[Tuple[Any, ...], int], Tuple[Any, ...]]] = None,
                  instances: Optional[int] = None, **kwargs: Any) -> Dict[str, Any]:
    """The device-memory price of ``fn(*args, **kwargs)`` (module note) as
    a plain dict: ``argument_size_in_bytes``, ``temp_size_in_bytes``,
    ``peak_estimate_gib``, ``temp_measured``, ``device``, and on the card
    ``workspace_size_in_bytes`` and ``slices`` ({instances: measured
    transient bytes}).

    ``cut(args, n)`` gives the arguments cut to ``n`` of the ``instances``
    (the per-instance leaves' first ``n`` rows); without it the transient is
    measured on a copy of the whole arguments.  ``fn`` must take the
    arguments as its own (it runs on copies) and have no other effect."""
    device = device_of(args)
    mem: Dict[str, Any] = {"argument_size_in_bytes": tensor_bytes(args),
                           "device": str(device)}
    if device is None or device.type != "cuda":
        mem.update(temp_size_in_bytes=0, temp_measured=False,
                   temp_note="no allocator statistic on this device: transient counted as 0")
    else:
        if cut is None or instances is None or instances < 4:
            sizes = {instances or 1: args}
        else:
            small = max(1, min(instances // 4, 32))
            sizes = {n: cut(args, n) for n in (small, 2 * small)}
        # a first run leaves the libraries' workspaces and caches allocated
        # (cuBLAS's among them): counted once, apart from the slices
        _, workspace = _transient(fn, sizes[min(sizes)], kwargs, device)
        slices = {n: _transient(fn, a, kwargs, device)[0] for n, a in sizes.items()}
        if len(slices) == 1:
            temp = next(iter(slices.values()))
        else:
            (n0, t0), (n1, t1) = sorted(slices.items())
            per = max(t1 - t0, 0) / (n1 - n0)
            temp = int(math.ceil(max(t0 - per * n0, 0) + per * instances))
        mem.update(temp_size_in_bytes=temp, workspace_size_in_bytes=workspace,
                   temp_measured=True, slices=slices)
    mem["peak_estimate_gib"] = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                                + mem.get("workspace_size_in_bytes", 0)) / GIB
    return mem


def default_budget_gib(device: torch.device) -> float:
    """The card's total memory less the margin (module note), in GiB."""
    total = torch.cuda.mem_get_info(device)[1] / GIB
    return total - max(MARGIN_FRACTION * total, MARGIN_MIN_GIB)


def check_hbm_budget(fn: Callable[..., Any], *args: Any, budget_gib: Optional[float] = None,
                     force: bool = False, label: str = "program",
                     **kwargs: Any) -> Optional[Dict[str, Any]]:
    """Price ``fn(*args, **kwargs)`` (:func:`price_program`, which also takes
    ``cut`` and ``instances``) and raise :class:`HBMBudgetError` where it
    exceeds the budget.  ``budget_gib=None`` checks only where the
    arguments lie on the card (:func:`default_budget_gib`) and returns None
    elsewhere; ``force=True`` prices and warns but never raises.  Returns
    the price."""
    device = device_of(args)
    if budget_gib is None:
        if device is None or device.type != "cuda":
            return None
        budget_gib = default_budget_gib(device)
    mem = price_program(fn, *args, **kwargs)
    mem["budget_gib"] = budget_gib
    peak = mem["peak_estimate_gib"]
    if peak > budget_gib:
        msg = (f"device-memory preflight: {label} prices at {peak:.6g} GiB "
               f"(arguments {mem['argument_size_in_bytes'] / GIB:.6g}, transient "
               f"{mem['temp_size_in_bytes'] / GIB:.6g}), over the {budget_gib:.6g} GiB "
               f"budget.  Shrink the run (fewer instances, smaller universes, "
               f"--packed-state) or force past the check (force_hbm=True / --force).")
        if not force:
            raise HBMBudgetError(msg, mem)
        print(f"WARNING: {msg}  Proceeding (forced).", flush=True)
    return mem


__all__ = ["HBMBudgetError", "MARGIN_FRACTION", "MARGIN_MIN_GIB", "check_hbm_budget",
           "copy_tree", "default_budget_gib", "price_program", "tensor_bytes"]
