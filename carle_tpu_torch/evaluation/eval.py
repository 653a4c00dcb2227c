"""Challenge scoring battery (counterpart of carle_tpu/evaluation/eval.py:53-75,
176-254, 374-580).

Protocol: build the wrapper stack from ``[name, reward_scale, checkpoint]``
triples with every learner frozen (``train=False``: no updates, dropout
off), run the agent ``steps`` steps per ruleset, score = mean reward per
step.  The reference sets BOTH birth and survive from the birth list
(``survive = ruleset[0]``, reference eval.py:58-59); that bug shaped the
published baseline scores, so it is the default (``reference_compat=True``).

Checkpoints are the JAX package's ``.npz`` learner states, shipped in this
package's own ``evaluation/`` folder.  The agent is the Bernoulli random
baseline (``Agent=None``) or a functional
:class:`carle_tpu_torch.agents.Agent` with ``agent_params``; the class
agents, the ``(Agent, params)`` pairs and the torch ``.pt`` converters are
not ported yet.

Run:  python -m carle_tpu_torch.evaluation.eval [--batched] [--device cpu]
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import rules as rules_mod
from ..agents import Agent as FnAgent, make_random_agent
from ..checkpoint import load_pytree
from ..config import EnvConfig
from ..device import DeviceLike, resolve_device
from ..mcl import (ae2d_def, corner_def, morpho_def, parsimony_def, prediction_def,
                   puffer_def, rnd2d_def, speed_def, surprise_def)
from ..rollout import Rollout

_HERE = os.path.dirname(os.path.abspath(__file__))

DEFAULT_WRAPPERS = [
    ["RND2D", 1.0, _HERE + "/RND2D_mcl.npz"],
    ["AE2D", 1.0, _HERE + "/AE2D_mcl.npz"],
    ["SpeedDetector", 1e-2, None],
    ["PufferDetector", 1e-3, None],
]

# reference eval.py:89-94 — the last ruleset [[2],[0]] is the held-out outgroup
DEFAULT_RULES = [
    [[3, 6, 8], [2, 4, 5]],
    [[3], [2, 3]],
    [[3, 6, 7, 8], [3, 4, 6, 7, 8]],
    [[3], [0, 2, 3]],
    [[2], [0]],
]


def wrapper_defs(config: EnvConfig, wrappers, per_instance: bool):
    """The frozen WrapperDef of each ``[name, scale, ckpt]`` spec."""
    factory = {
        "RND2D": lambda s: rnd2d_def(config, reward_scale=s, train=False),
        "AE2D": lambda s: ae2d_def(config, reward_scale=s, train=False),
        "PredictionBonus": lambda s: prediction_def(config, reward_scale=s, train=False),
        "SurpriseBonus": lambda s: surprise_def(config, reward_scale=s, train=False),
        "MorphoBonus": lambda s: morpho_def(config, reward_scale=s),
        "CornerBonus": lambda s: corner_def(config, reward_scale=s),
        "ParsimonyBonus": lambda s: parsimony_def(reward_scale=s),
        "SpeedDetector": lambda s: speed_def(config, reward_scale=s,
                                             per_instance=per_instance),
        "PufferDetector": lambda s: puffer_def(config, reward_scale=s,
                                               per_instance=per_instance),
    }
    defs = []
    for name, scale, _ in wrappers:
        if name not in factory:
            raise ValueError(f"unknown wrapper {name!r}; one of {sorted(factory)}")
        defs.append(factory[name](scale))
    return defs


def inject_wrapper_checkpoints(wstates: Sequence[Any],
                               wrappers: Sequence[Sequence[Any]]) -> Tuple[Any, ...]:
    """Load each spec's ``.npz`` checkpoint into the matching wrapper state
    (shapes checked against it); the spec's reward_scale wins over the
    checkpointed value."""
    new = list(wstates)
    for i, (name, _, ckpt) in enumerate(wrappers):
        if ckpt is None:
            continue
        if not hasattr(new[i], "reward_scale") or not hasattr(new[i], "params"):
            raise ValueError(f"{name} has no checkpointable state; drop the "
                             f"checkpoint path {ckpt!r} from its spec")
        if not ckpt.endswith(".npz"):
            raise ValueError(f"{ckpt!r}: only .npz learner states load here "
                             "(the torch .pt converters are not ported)")
        new[i] = load_pytree(ckpt, new[i])._replace(reward_scale=new[i].reward_scale)
    return tuple(new)


def _resolve_agent(Agent: Any, agent_params: Any, config: EnvConfig,
                   toggle_rate: float):
    if Agent is None:
        if agent_params is not None:
            raise ValueError("agent_params were given but Agent=None scores "
                             "the Bernoulli random baseline, which has none")
        return make_random_agent(config.eff_action_width,
                                 config.eff_action_height, toggle_rate), None
    if isinstance(Agent, FnAgent):
        return Agent, agent_params
    raise TypeError("Agent must be None or a carle_tpu_torch.agents.Agent")


def battery_rule_bits(ruleset, reference_compat: bool) -> int:
    birth = list(ruleset[0])
    survive = list(ruleset[0] if reference_compat else ruleset[1])
    return rules_mod.pack_rule_bits(birth, survive)


def evaluate_fused(Agent: Any = None, rules=None, wrappers=None,
                   steps: int = 1024, reference_compat: bool = True,
                   seed: int = 0, toggle_rate: float = 0.1,
                   verbose: bool = True, config: Optional[EnvConfig] = None,
                   agent_params: Any = None,
                   device: DeviceLike = None) -> Tuple[float, np.ndarray]:
    """The published protocol: rulesets run one after another on one stack
    whose wrapper statistics carry across segments.  Returns (mean score,
    per-step summed-reward trace [len(rules) * steps])."""
    rules = DEFAULT_RULES if rules is None else rules
    wrappers = DEFAULT_WRAPPERS if wrappers is None else wrappers
    config = EnvConfig() if config is None else config
    agent, params = _resolve_agent(Agent, agent_params, config, toggle_rate)
    ro = Rollout(config, wrapper_defs(config, wrappers, per_instance=False),
                 agent, device=device)
    carry = ro.init(ro.generator(seed), rules_mod.LIFE, agent_params=params)
    carry = carry._replace(stack=carry.stack._replace(
        wrappers=inject_wrapper_checkpoints(carry.stack.wrappers, wrappers)))

    score, total, traces = 0.0, 0, []
    for ruleset in rules:
        carry = ro.with_rules(carry, battery_rule_bits(ruleset, reference_compat))
        carry, _ = ro.reset(carry)
        carry, rewards = ro.run(carry, steps)
        seg = rewards.sum(dim=(1, 2)).double().cpu().numpy()  # [steps]
        traces.append(seg)
        score += float(seg.sum())
        total += steps
        if verbose:
            print("cumulative score = {:.3e} at total steps = {}, rulset = {}"
                  .format(score, total, ruleset))
    return score / total, np.concatenate(traces)


def evaluate_fused_batched(Agent: Any = None, rules=None, wrappers=None,
                           steps: int = 1024, reference_compat: bool = True,
                           seed: int = 0, toggle_rate: float = 0.1,
                           verbose: bool = True, agent_params: Any = None,
                           replicas: int = 1,
                           device: DeviceLike = None) -> Tuple[float, np.ndarray]:
    """The whole battery as one batch: each ruleset is an instance with its
    own rule mask (rules are data), ``replicas`` independent copies of the
    battery ride as further instances, and Speed/Puffer run per instance.
    Each ruleset starts from fresh statistics, where the published protocol
    carries them across segments (see the JAX package's note).  Returns
    (mean score, per-ruleset mean reward per step [len(rules)])."""
    rules = DEFAULT_RULES if rules is None else rules
    wrappers = DEFAULT_WRAPPERS if wrappers is None else wrappers
    replicas = max(1, int(replicas))
    config = EnvConfig(instances=len(rules) * replicas)
    agent, params = _resolve_agent(Agent, agent_params, config, toggle_rate)
    ro = Rollout(config, wrapper_defs(config, wrappers, per_instance=True),
                 agent, device=device)
    carry = ro.init(ro.generator(seed), rules_mod.LIFE, agent_params=params)
    carry = carry._replace(stack=carry.stack._replace(
        wrappers=inject_wrapper_checkpoints(carry.stack.wrappers, wrappers)))
    bits = [battery_rule_bits(rs, reference_compat) for rs in rules] * replicas
    carry = ro.with_rules(carry, torch.tensor(bits, dtype=torch.int32))
    carry, _ = ro.reset(carry)
    carry, rewards = ro.run(carry, steps)

    per_inst = rewards.sum(dim=(0, 2)).double().cpu().numpy() / steps
    per_rule = per_inst.reshape(replicas, len(rules)).mean(axis=0)
    score = float(per_rule.mean())
    if verbose:
        for rs, v in zip(rules, per_rule):
            print(f"ruleset {rs}: mean reward/step = {v:.3e}")
    return score, per_rule


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Challenge scoring battery (5 rulesets x N steps), "
                    "random baseline agent")
    parser.add_argument("--batched", action="store_true",
                        help="all rulesets as one batch of per-instance rules")
    parser.add_argument("--steps", type=int, default=1024)
    parser.add_argument("--replicas", type=int, default=1,
                        help="battery copies in the batch (--batched only)")
    parser.add_argument("--fix-survive-bug", action="store_true",
                        help="use the declared survive rules instead of the "
                             "reference's survive<-birth bug")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    compat = not args.fix_survive_bug
    if args.batched:
        score, _ = evaluate_fused_batched(
            steps=args.steps, reference_compat=compat, seed=args.seed,
            replicas=args.replicas, device=device)
    else:
        score, _ = evaluate_fused(steps=args.steps, reference_compat=compat,
                                  seed=args.seed, device=device)
    print("mean evaluation score is {:.3e}".format(score))


if __name__ == "__main__":
    main()
