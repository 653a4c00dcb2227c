"""Wrapper pre-training entry point (counterpart of carle_tpu/train_mcl.py).

Same protocol as the reference: stack CARLE -> RND2D -> AE2D, drive with a
random agent, cycle epochs x rulesets, run ``steps_per_rule`` steps per
segment; both nets train inside the step.  After each segment the wrapper
states are checkpointed and the reward history is dumped.

* rule changes are state updates: one rollout serves the whole run;
* checkpoints are ``.npz`` files of the full learner state (parameters, Adam
  moments, accumulation counters) in the JAX package's format, so training
  resumes exactly and either package reads the other's files;
* metrics are the ``.npy`` reward histories the reference writes;
* ``packed_state=True`` (``--packed-state``) carries the universes
  bit-packed, 32 cells a word (parallel/packed_env.py): 65k universes of
  512 x 512 hold 2.1 GB packed against 17 GB as uint8, and the nets' kernels
  read the words themselves.  Rewards equal the uint8 carry's.

``agent_fn`` takes any agent the scoring battery's fused paths take
(evaluation/eval.py ``_resolve_fused_agent``): a class agent, an instance, a
functional agent or an ``(Agent, params)`` pair.

* ``mesh`` (``--mesh {auto,on,off}``) splits the instance batch over the
  slots of a mesh (parallel/mesh.py ``shard_carry``, the nets a slot at a
  time over the instances), one process's or, under an initialised process
  group, every process's (parallel/distributed.py): each process steps its
  own instances, the learners add the processes' gradients by
  ``all_reduce``, every process reads ``resume_from``, and process 0 alone
  writes checkpoints, metrics, progress and logs.
* before the first segment a device-memory preflight prices the run's
  first steps (utils/preflight.py, ``hbm_budget_gib`` / ``--hbm-budget-gib``,
  ``force_hbm`` / ``--force``); ``serialize`` (``--serialize``) runs the
  wrappers holding nothing of one another's views.

``train``'s arguments 1-20 are carle_tpu's, in its order.

Run:  python -m carle_tpu_torch.train_mcl [--device cpu] [--packed-state]
          [--mesh auto|on|off] [--hbm-budget-gib G] [--force] [--serialize]
      torchrun --nproc-per-node 2 -m carle_tpu_torch.train_mcl --mesh on ...
      python -m carle_tpu_torch.parallel.distributed --nprocs 2 \
          carle_tpu_torch.train_mcl:main --mesh on ...
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import rules as rules_mod
from .agents import make_random_agent
from .checkpoint import load_pytree, save_pytree
from .config import EnvConfig
from .device import DeviceLike, resolve_device
from .evaluation.eval import _resolve_fused_agent
from .mcl.ae import ae2d_def
from .mcl.base import WrapperStack
from .mcl.rnd import rnd2d_def
from .parallel import distributed
from .parallel.mesh import PER_INSTANCE, Mesh, env_layout, make_mesh, shard_carry
from .parallel.packed_env import PackedSpatialStack
from .rollout import Rollout, RolloutCarry
from .utils.preflight import check_hbm_budget

# Life, Move/Morley, Day & Night, B3/S023 (the reference's training rules)
DEFAULT_RULES: List[List[List[int]]] = [
    [[3], [2, 3]],
    [[3, 6, 8], [2, 4, 5]],
    [[3, 6, 7, 8], [3, 4, 6, 7, 8]],
    [[3], [0, 2, 3]],
]
WRAPPER_NAMES = ("RND2D", "AE2D")
# steps the preflight runs on each slice: a segment holds the carry it was
# given beside the one it steps, and the allocator's blocks settle over its
# first steps
PREFLIGHT_STEPS = 8


def _find_checkpoint(directory: str, name: str) -> str:
    """Resolve a wrapper checkpoint in ``directory``: the canonical
    ``{name}.npz`` if present, else the newest ``{name}_*.npz`` the trainer
    itself writes, so ``--resume-from`` can point straight at a previous
    run's ``models/`` directory."""
    canonical = os.path.join(directory, f"{name}.npz")
    if os.path.exists(canonical):
        return canonical
    if not os.path.isdir(directory):
        raise FileNotFoundError(
            f"--resume-from directory {directory!r} does not exist "
            f"(expected {name}.npz or {name}_*.npz checkpoints in it)")
    candidates = [os.path.join(directory, f) for f in os.listdir(directory)
                  if f.startswith(name + "_") and f.endswith(".npz")]
    if not candidates:
        return canonical  # let load_pytree raise its clear error
    return max(candidates, key=os.path.getmtime)


def resolve_mesh(mesh: Any, instances: int, device: DeviceLike = None) -> Optional[Mesh]:
    """The mesh ``train`` runs on (carle_tpu/train_mcl.py's resolution):
    ``"auto"`` a mesh over every slot where there is more than one and
    ``instances`` divides by their number, else none (one card: today's
    single-device run): under an initialised process group every process's
    slots, else every visible CUDA device where the run is on the card;
    ``True`` ``make_mesh()``; ``False`` or ``None`` none; a ``Mesh`` as
    given."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is True:
        return make_mesh()
    if mesh is None or mesh is False:
        return None
    if mesh != "auto":
        raise ValueError(f"mesh must be 'auto', True, False, None or a Mesh, got {mesh!r}")
    if distributed.is_initialized():
        count = len(distributed.global_slots())
    else:
        count = torch.cuda.device_count() if resolve_device(device).type == "cuda" else 0
    return make_mesh() if count > 1 and instances % count == 0 else None


def cut_instances(tree: Any, instances: int, n: int) -> Any:
    """``tree`` (states of a rollout carry) with the fields its states
    declare per-instance (``parallel.mesh.PER_INSTANCE``) cut to their first
    ``n`` of ``instances`` rows; the rest as it is (views, not copies)."""
    def walk(node: Any, per_instance: bool = False) -> Any:
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            declared = getattr(type(node), PER_INSTANCE, ())
            return type(node)(*(walk(v, f in declared) for f, v in zip(node._fields, node)))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if (per_instance and isinstance(node, torch.Tensor) and node.dim()
                and node.shape[0] == instances):
            return node[:n]
        return node

    return walk(tree)


def _write_progress(path: str, payload: Dict[str, Any]) -> None:
    """Atomic progress write (tmp + rename): a crash mid-write never leaves a
    torn JSON for a supervisor to trip over."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def train(
    agent_fn: Optional[Callable[..., Any]] = None,
    instances: int = 16,
    steps: Sequence[int] = (64, 2048),
    rules: Optional[Sequence[Sequence[Sequence[int]]]] = None,
    mcl: Optional[Sequence[Callable[..., Any]]] = None,
    height: int = 256,
    width: int = 256,
    batch_size: int = 64,
    seed: int = 0,
    log_dir: str = "./logs/mcl",
    resume_from: Optional[str] = None,
    segment_callback: Optional[Callable[[Dict[str, Any]], None]] = None,
    mesh: Any = "auto",
    mixed_rules: bool = False,
    skip_segments: int = 0,
    progress_file: Optional[str] = None,
    fused_head: bool = False,
    packed_state: bool = False,
    hbm_budget_gib: Optional[float] = None,
    force_hbm: bool = False,
    *,
    serialize: bool = False,
    device: DeviceLike = None,
) -> np.ndarray:
    """Pre-train the RND2D + AE2D wrapper stack.  ``steps`` is (epochs,
    steps per ruleset segment).  Arguments 1-20 are carle_tpu's, in its
    order (the reference's ``train(agent_fn, instances, steps, rules,
    mcl)`` first); ``serialize`` and ``device`` are keywords only.

    ``mcl`` is accepted and unused: the stack is RND2D + AE2D, as in the
    reference and carle_tpu.  ``fused_head`` is accepted and selects
    nothing: every learned layer of the port runs as its hand-written
    kernel on the card already (with a mesh of several slots the nets take
    the mesh, as below).

    ``mixed_rules=True`` trains on all rulesets at once instead of cycling
    them: the rulesets are dealt round-robin across the instance batch as a
    per-instance rule vector, so each epoch is one segment whose updates see
    every rule's dynamics together.

    ``progress_file`` atomically records how many segments completed after
    each one, and ``skip_segments`` fast-forwards the schedule past segments
    a previous process already finished; with ``resume_from`` (a directory of
    ``RND2D*.npz`` / ``AE2D*.npz``) this continues from the last completed
    segment.  Continuation is semantic, not bit-exact: the generator restarts
    from ``seed``, so the action stream differs from the uncrashed run; the
    learned state (parameters, Adam moments, accumulation counters) is exact.

    ``packed_state=True`` carries the universes bit-packed (32 cells a word,
    the packed stack); the reward history is the same.

    ``mesh`` (:func:`resolve_mesh`: ``"auto"``, ``True``, ``False``/``None``
    or a ``parallel.mesh.Mesh``) splits the instance batch over the mesh's
    slots: the universes become instance shards after ``resume_from``
    (``shard_carry``; packed, the packed stack on the instance layout), the
    parameters, optimizer state and counters stay on the mesh's home device,
    which is the run's device, and where the mesh has more than one slot
    both nets take it as ``fused_head`` and launch their kernels a slot at a
    time.  The reward history equals the single-device run's up to the
    gradients' summation order.  Under a process group with a mesh over
    every process's slots each process runs its instances, the history is
    the whole batch's on every process, and process 0 alone writes files
    and prints.

    Device-memory preflight (utils/preflight.py): before the first segment
    the carry's bytes and the transient of ``PREFLIGHT_STEPS`` steps on
    carries of two slices of the instances (the run's wrapper states on new
    universes) are priced, and a run priced over the budget raises
    :class:`~.utils.preflight.HBMBudgetError` before it writes anything.
    ``hbm_budget_gib=None`` is the card's memory less a margin, checked only
    on the card; an explicit budget checks on any device; ``force_hbm=True``
    warns and goes on.  Pricing leaves the carry and its generator
    untouched.  With a mesh the slices step off the mesh, on the home
    device, and the whole batch is priced there: an upper bound where the
    slots share one card.

    ``serialize=True`` (the stacks' ``serialize``): no view a wrapper
    computed of the step is still held when the next wrapper starts; the
    history is the same bits.

    ``agent_fn`` drives the universes: ``None`` is the Bernoulli(0.1) random
    agent; an agent class is built with ``seed``, the four dims and the
    device, and keeps its own parameters (a seeded RandomNetworkAgent's
    identity is its frozen weights).

    ``segment_callback`` gets a dict a segment: ``epoch``, ``ruleset``,
    ``steps_per_second``, ``mean_reward``, ``carry`` (the rollout carry
    after it; across processes, this process's parts) and ``preflight``
    (the price, or None where the preflight did not engage).

    Runs on the card unless ``device="cpu"``.  Returns the per-step summed
    reward history (skipped segments excluded), and writes
      {log_dir}/models/RND2D_{exp}.npz, AE2D_{exp}.npz  (full learner states)
      {log_dir}/metrics/mcl_rewards_{exp}.npy
    """
    del mcl, fused_head   # accepted for carle_tpu's signature (docstring)
    rules = DEFAULT_RULES if rules is None else rules
    config = EnvConfig(height=height, width=width, action_height=64,
                       action_width=64, instances=instances).validate()
    # resolved before the defs: on a mesh of several slots the nets take it
    mesh_obj = resolve_mesh(mesh, instances, device)
    device = resolve_device(device) if mesh_obj is None else mesh_obj.home
    if agent_fn is None:
        agent, agent_params = make_random_agent(config.eff_action_width,
                                                config.eff_action_height), None
    else:
        agent, agent_params = _resolve_fused_agent(agent_fn, None, None, config, 0.1,
                                                   seed, device)

    def rollout(cfg: EnvConfig, on: Optional[Mesh]) -> Rollout:
        """The run's rollout over ``cfg``'s instances, on mesh ``on``."""
        fused = on if on is not None and on.size > 1 else False
        defs = [rnd2d_def(cfg, batch_size=batch_size, fused_head=fused),
                ae2d_def(cfg, batch_size=batch_size, fused_head=fused)]
        if not packed_state:
            stack = WrapperStack(cfg, defs, serialize)
        elif on is None:
            stack = PackedSpatialStack(cfg, defs, serialize=serialize)
        else:   # the packed universes as instance shards (shard_carry's layout)
            layout = env_layout(on, on.axis_names[0])
            env_axis, space_axis = layout.axis_names
            stack = PackedSpatialStack(cfg, defs, layout, space_axis, env_axis,
                                       serialize=serialize)
        return Rollout(cfg, defs, agent, device=device, stack=stack)

    ro = rollout(config, mesh_obj)
    carry = ro.init(ro.generator(seed), rules_mod.LIFE, agent_params=agent_params)

    if resume_from:
        wstates = tuple(load_pytree(_find_checkpoint(resume_from, name), ws)
                        for name, ws in zip(WRAPPER_NAMES, carry.stack.wrappers))
        carry = carry._replace(stack=carry.stack._replace(wrappers=wstates))

    def probe(cut_carry: RolloutCarry) -> Any:
        """The run's first steps on a carry of fewer instances, off the mesh."""
        n = int(cut_carry.stack.env.grid.shape[0])
        return rollout(dataclasses.replace(config, instances=n), None).run(
            cut_carry, PREFLIGHT_STEPS)

    def cut(args: Any, n: int) -> Any:
        """A carry of ``n`` instances off the mesh: the run's wrapper states
        (their per-instance fields cut) on a new universe of its own."""
        small = rollout(dataclasses.replace(config, instances=n), None)
        fresh = small.init(small.generator(seed), rules_mod.LIFE,
                           agent_params=args[0].agent_params)
        wrappers = cut_instances(args[0].stack.wrappers, instances, n)
        return (fresh._replace(stack=fresh.stack._replace(wrappers=wrappers)),)

    mem = check_hbm_budget(probe, carry, budget_gib=hbm_budget_gib, force=force_hbm,
                           label=f"train step (inst={instances}, {height}x{width})",
                           cut=cut, instances=instances)
    if mem is not None and distributed.process_index() == 0:
        print(f"device-memory preflight: {mem['peak_estimate_gib']:.6g} GiB priced "
              f"(transient {mem['temp_size_in_bytes'] / 2**30:.6g} GiB"
              f"{'' if mem['temp_measured'] else ', not measured here'})", flush=True)
    if mesh_obj is not None:
        carry = shard_carry(carry, mesh_obj, config, mesh_obj.axis_names[0])

    writer = distributed.process_index() == 0   # the one process that writes files and logs
    exp_id = "mcl" + str(int(time.time()))
    model_dir = os.path.join(log_dir, "models")
    metric_dir = os.path.join(log_dir, "metrics")
    if writer:
        os.makedirs(model_dir, exist_ok=True)
        os.makedirs(metric_dir, exist_ok=True)

    epochs, steps_per_rule = int(steps[0]), int(steps[1])
    if mixed_rules:
        packed = [rules_mod.pack_rule_bits(r[0], r[1]) for r in rules]
        rule_vec = np.asarray([packed[i % len(packed)] for i in range(instances)],
                              dtype=np.int32)
        segments = [("mixed", rule_vec)]
    else:
        segments = [(ruleset, rules_mod.pack_rule_bits(ruleset[0], ruleset[1]))
                    for ruleset in rules]
    total_segments = epochs * len(segments)

    rewards_hist: List[np.ndarray] = []
    seg_index = 0
    for epoch in range(epochs):
        for ruleset, bits in segments:
            seg_index += 1
            if seg_index <= skip_segments:
                continue
            carry = ro.with_rules(carry, bits)
            carry = ro.reset(carry)[0]   # the float observation dropped: [inst, 1, H, W]

            t1 = time.time()
            carry, seg_rewards = ro.run(carry, steps_per_rule)
            seg_rewards = ro.gather_rewards(carry, seg_rewards)   # the whole batch's
            seg_sum = seg_rewards.sum(dim=(1, 2)).cpu().numpy()  # [steps]; waits
            t2 = time.time()

            rewards_hist.append(seg_sum)
            steps_per_second = steps_per_rule * instances / (t2 - t1)
            mean_reward = float(seg_sum.sum()) / (steps_per_rule * instances)
            if writer:
                print(f"steps / second = {steps_per_second:.3f}")
                print(f"round {epoch}, ruleset {ruleset}, "
                      f"mean reward = {mean_reward:.3e}")
                for name, ws in zip(WRAPPER_NAMES, carry.stack.wrappers):
                    save_pytree(os.path.join(model_dir, f"{name}_{exp_id}.npz"), ws)
                if progress_file:
                    _write_progress(progress_file, {
                        "completed_segments": seg_index,
                        "total_segments": total_segments,
                        "exp_id": exp_id,
                        "model_dir": model_dir,
                    })
            if segment_callback:
                segment_callback(dict(epoch=epoch, ruleset=ruleset,
                                      steps_per_second=steps_per_second,
                                      mean_reward=mean_reward, carry=carry, preflight=mem))

        if rewards_hist and writer:
            np.save(os.path.join(metric_dir, f"mcl_rewards_{exp_id}.npy"),
                    np.concatenate(rewards_hist))

    return (np.concatenate(rewards_hist) if rewards_hist
            else np.zeros(0, dtype=np.float32))


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Pre-train the RND2D+AE2D wrapper stack")
    parser.add_argument("--instances", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--steps-per-rule", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--size", type=int, default=256,
                        help="universe height = width")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-dir", default="./logs/mcl")
    parser.add_argument("--resume-from", default=None,
                        help="directory holding RND2D.npz / AE2D.npz (or a "
                             "previous run's models/ dir: the newest "
                             "RND2D_*/AE2D_* checkpoints are picked up)")
    parser.add_argument("--skip-segments", type=int, default=0,
                        help="fast-forward past the first N schedule segments "
                             "(restart: pair with --resume-from)")
    parser.add_argument("--progress-file", default=None,
                        help="atomically record the completed-segment count "
                             "here after each segment")
    parser.add_argument("--mixed-rules", action="store_true",
                        help="train on all rulesets at once through a "
                             "per-instance rule vector (one segment per "
                             "epoch) instead of cycling them")
    parser.add_argument("--packed-state", action="store_true",
                        help="carry the universes bit-packed (32 cells a word)")
    parser.add_argument("--mesh", choices=("auto", "on", "off"), default="auto",
                        help="split the instance batch over every visible CUDA device, "
                             "or every process's slots under torchrun or the launcher "
                             "(auto: when there is more than one and the instances "
                             "divide by their number)")
    parser.add_argument("--fused-head", action="store_true",
                        help="accepted for carle_tpu's command line: every learned layer "
                             "runs as its hand-written kernel already")
    parser.add_argument("--hbm-budget-gib", type=float, default=None,
                        help="device-memory budget of the preflight (default: the card's "
                             "memory less a margin, no check off the card); a run priced "
                             "over it refuses to start")
    parser.add_argument("--force", action="store_true",
                        help="start even if the preflight prices the run over the budget "
                             "(warns instead of raising)")
    parser.add_argument("--serialize", action="store_true",
                        help="hold no view of the step that one wrapper computed while "
                             "the next runs (the same rewards)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    # under torchrun: join the group from its variables (the launcher has joined)
    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not distributed.is_initialized()
    if joined:
        distributed.initialize()

    history = train(
        instances=args.instances,
        steps=[args.epochs, args.steps_per_rule],
        rules=DEFAULT_RULES,
        height=args.size,
        width=args.size,
        batch_size=args.batch_size,
        seed=args.seed,
        log_dir=args.log_dir,
        resume_from=args.resume_from,
        mesh={"auto": "auto", "on": True, "off": False}[args.mesh],
        mixed_rules=args.mixed_rules,
        skip_segments=args.skip_segments,
        progress_file=args.progress_file,
        fused_head=args.fused_head,
        packed_state=args.packed_state,
        hbm_budget_gib=args.hbm_budget_gib,
        force_hbm=args.force,
        serialize=args.serialize,
        device=args.device,
    )
    if distributed.process_index() == 0:
        print(json.dumps({"total_reward": float(history.sum()),
                          "segments": len(history) // args.steps_per_rule}))
    if joined:
        distributed.shutdown()


if __name__ == "__main__":
    main()
