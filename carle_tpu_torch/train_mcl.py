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

Not ported yet: multi-card sharding (``mesh``) and class agents (``agent_fn``
other than None).

Run:  python -m carle_tpu_torch.train_mcl [--device cpu] [--packed-state]
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from . import rules as rules_mod
from .agents import make_random_agent
from .checkpoint import load_pytree, save_pytree
from .config import EnvConfig
from .device import DeviceLike
from .mcl.ae import ae2d_def
from .mcl.rnd import rnd2d_def
from .parallel.packed_env import PackedSpatialStack
from .rollout import Rollout

# Life, Move/Morley, Day & Night, B3/S023 (the reference's training rules)
DEFAULT_RULES: List[List[List[int]]] = [
    [[3], [2, 3]],
    [[3, 6, 8], [2, 4, 5]],
    [[3, 6, 7, 8], [3, 4, 6, 7, 8]],
    [[3], [0, 2, 3]],
]
WRAPPER_NAMES = ("RND2D", "AE2D")


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
    height: int = 256,
    width: int = 256,
    batch_size: int = 64,
    seed: int = 0,
    log_dir: str = "./logs/mcl",
    resume_from: Optional[str] = None,
    segment_callback: Optional[Callable[[Dict[str, Any]], None]] = None,
    mixed_rules: bool = False,
    skip_segments: int = 0,
    progress_file: Optional[str] = None,
    device: DeviceLike = None,
    packed_state: bool = False,
) -> np.ndarray:
    """Pre-train the RND2D + AE2D wrapper stack.  ``steps`` is (epochs,
    steps per ruleset segment).

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
    the packed stack with no mesh); the reward history is the same.

    Runs on the card unless ``device="cpu"``.  Returns the per-step summed
    reward history (skipped segments excluded), and writes
      {log_dir}/models/RND2D_{exp}.npz, AE2D_{exp}.npz  (full learner states)
      {log_dir}/metrics/mcl_rewards_{exp}.npy
    """
    if agent_fn is not None:
        raise NotImplementedError(
            "only the random agent (agent_fn=None) trains the wrappers so far")
    rules = DEFAULT_RULES if rules is None else rules
    config = EnvConfig(height=height, width=width, action_height=64,
                       action_width=64, instances=instances).validate()
    wrapper_defs = [rnd2d_def(config, batch_size=batch_size),
                    ae2d_def(config, batch_size=batch_size)]
    agent = make_random_agent(config.eff_action_width, config.eff_action_height)
    stack = PackedSpatialStack(config, wrapper_defs) if packed_state else None
    ro = Rollout(config, wrapper_defs, agent, device=device, stack=stack)
    carry = ro.init(ro.generator(seed), rules_mod.LIFE)

    if resume_from:
        wstates = tuple(load_pytree(_find_checkpoint(resume_from, name), ws)
                        for name, ws in zip(WRAPPER_NAMES, carry.stack.wrappers))
        carry = carry._replace(stack=carry.stack._replace(wrappers=wstates))

    exp_id = "mcl" + str(int(time.time()))
    model_dir = os.path.join(log_dir, "models")
    metric_dir = os.path.join(log_dir, "metrics")
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
            carry, _ = ro.reset(carry)

            t1 = time.time()
            carry, seg_rewards = ro.run(carry, steps_per_rule)
            seg_sum = seg_rewards.sum(dim=(1, 2)).cpu().numpy()  # [steps]; waits
            t2 = time.time()

            rewards_hist.append(seg_sum)
            steps_per_second = steps_per_rule * instances / (t2 - t1)
            mean_reward = float(seg_sum.sum()) / (steps_per_rule * instances)
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
                                      mean_reward=mean_reward))

        if rewards_hist:
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
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

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
        mixed_rules=args.mixed_rules,
        skip_segments=args.skip_segments,
        progress_file=args.progress_file,
        device=args.device,
        packed_state=args.packed_state,
    )
    print(json.dumps({"total_reward": float(history.sum()),
                      "segments": len(history) // args.steps_per_rule}))


if __name__ == "__main__":
    main()
