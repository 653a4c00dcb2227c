"""Challenge scoring battery (counterpart of carle_tpu/evaluation/eval.py).

Protocol: build the wrapper stack from ``[cls, reward_scale, checkpoint]``
triples with every learner frozen, run the agent ``steps`` steps per
ruleset, score = mean reward per step.  The reference sets BOTH birth and
survive from the birth list (``survive = ruleset[0]``); that bug shaped the
published baseline scores, so it is the default (``reference_compat=True``).

Three entry points:

* :func:`evaluate`, the reference's per-step loop: the agent class is called
  on each observation and the ``CARLE`` shell, wrapped in the wrappers' class
  shells, steps once a call.  Each step copies the action and the reward to
  the host, as the protocol does;
* :func:`evaluate_fused`, the same protocol as one :class:`Rollout` over the
  functional wrapper defs (rulesets one after another, statistics carried
  across segments);
* :func:`evaluate_fused_batched`, the whole battery as one batch.

A spec's class is one of the port's wrapper classes (``RND2D``, ...); the
fused paths also take its name, and resolve a subclass to its base's def by
``my_name``.  Checkpoints are
the JAX package's ``.npz`` learner states (shipped in this package's own
``evaluation/`` folder) or reference torch ``.pt`` state dicts (converted by
mcl/rnd.py's and mcl/ae.py's ``*_params_from_torch``).  The fused paths score
any agent :func:`_resolve_fused_agent` takes; :func:`load_shipped_policy` gives
the shipped trained PPO policy (``policy_ppo.npz``) as such an agent.

Run:  python -m carle_tpu_torch.evaluation.eval [--per-step | --batched]
          [--agent random|network|policy] [--agent-params PATH] [--device cpu]
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import rules as rules_mod
from ..agents import Agent as FnAgent, make_random_agent
from ..checkpoint import load_pytree
from ..config import EnvConfig
from ..device import DeviceLike, resolve_device
from ..env import CARLE
from ..mcl import (AE2D, RND2D, PufferDetector, SpeedDetector, ae2d_def, ae_params_from_torch,
                   corner_def, morpho_def, parsimony_def, predictor_params_from_torch,
                   prediction_def, puffer_def, random_network_params_from_torch,
                   rnd2d_def, speed_def, surprise_def)
from ..parallel.mesh import Mesh, shard_carry
from ..rollout import Rollout
from .submission import SubmissionAgent

_HERE = os.path.dirname(os.path.abspath(__file__))
SHIPPED_POLICY = _HERE + "/policy_ppo.npz"

DEFAULT_WRAPPERS = [
    [RND2D, 1.0, _HERE + "/RND2D_mcl.npz"],
    [AE2D, 1.0, _HERE + "/AE2D_mcl.npz"],
    [SpeedDetector, 1e-2, None],
    [PufferDetector, 1e-3, None],
]

# reference eval.py:89-94 — the last ruleset [[2],[0]] is the held-out outgroup
DEFAULT_RULES = [
    [[3, 6, 8], [2, 4, 5]],
    [[3], [2, 3]],
    [[3, 6, 7, 8], [3, 4, 6, 7, 8]],
    [[3], [0, 2, 3]],
    [[2], [0]],
]


def _spec_name(cls: Any) -> Any:
    """A spec's wrapper name: the string itself, or the class's ``my_name``."""
    return cls if isinstance(cls, str) else getattr(cls, "my_name", cls)


def _label(cls: Any) -> str:
    return cls if isinstance(cls, str) else getattr(cls, "__name__", repr(cls))


def wrapper_defs(config: EnvConfig, wrappers, per_instance: bool, fused_head: Any = False):
    """The frozen WrapperDef of each ``[cls or name, scale, ckpt]`` spec; the
    nets of the learned ones take ``fused_head`` (a mesh: a slot at a time
    over the instances)."""
    nets = dict(train=False, fused_head=fused_head)
    factory = {
        "RND2D": lambda s: rnd2d_def(config, reward_scale=s, **nets),
        "AE2D": lambda s: ae2d_def(config, reward_scale=s, **nets),
        "PredictionBonus": lambda s: prediction_def(config, reward_scale=s, **nets),
        "SurpriseBonus": lambda s: surprise_def(config, reward_scale=s, **nets),
        "MorphoBonus": lambda s: morpho_def(config, reward_scale=s),
        "CornerBonus": lambda s: corner_def(config, reward_scale=s),
        "ParsimonyBonus": lambda s: parsimony_def(reward_scale=s),
        "SpeedDetector": lambda s: speed_def(config, reward_scale=s,
                                             per_instance=per_instance),
        "PufferDetector": lambda s: puffer_def(config, reward_scale=s,
                                               per_instance=per_instance),
    }
    defs = []
    for cls, scale, _ in wrappers:
        name = _spec_name(cls)
        if not isinstance(name, str) or name not in factory:
            raise ValueError(f"unknown wrapper {_label(cls)!r}; one of {sorted(factory)}")
        defs.append(factory[name](scale))
    return defs


def _torch_checkpoint(path: str, device) -> Any:
    return torch.load(path, weights_only=True, map_location=device)


def inject_wrapper_checkpoints(wstates: Sequence[Any],
                               wrappers: Sequence[Sequence[Any]]) -> Tuple[Any, ...]:
    """Load each spec's checkpoint into the matching wrapper state: a native
    ``.npz`` learner state (shapes checked against it), or a reference torch
    ``.pt`` (RND2D's into both nets; AE2D's, Prediction's and Surprise's
    into the autoencoder).  The spec's reward_scale wins over the
    checkpointed value."""
    new = list(wstates)
    for i, (cls, _, ckpt) in enumerate(wrappers):
        if ckpt is None:
            continue
        if not hasattr(new[i], "reward_scale") or not hasattr(new[i], "params"):
            raise ValueError(f"{_label(cls)} has no checkpointable state; drop the "
                             f"checkpoint path {ckpt!r} from its spec")
        if ckpt.endswith(".npz"):
            new[i] = load_pytree(ckpt, new[i])._replace(reward_scale=new[i].reward_scale)
            continue
        device = new[i].reward_scale.device
        sd = _torch_checkpoint(ckpt, device)
        name = _spec_name(cls)
        if name == "RND2D":
            new[i] = new[i]._replace(
                params=predictor_params_from_torch(sd, device),
                target_params=random_network_params_from_torch(sd, device))
        elif name in ("AE2D", "PredictionBonus", "SurpriseBonus"):
            new[i] = new[i]._replace(params=ae_params_from_torch(sd, device))
        else:
            raise ValueError(f"no torch converter for {_label(cls)}")
    return tuple(new)


def load_shipped_policy(path: Optional[str] = None,
                        device: DeviceLike = None) -> Tuple[FnAgent, Any]:
    """(Agent, params) pair of the shipped trained PPO policy
    (``policy_ppo.npz`` beside this module, float16 on disk, float32 on
    ``device``, the card unless ``"cpu"``); ``path`` overrides with another native ``.npz`` params
    file of the same architecture.  The agent samples its toggles and runs the
    plain conv path, as the JAX package's does.  Pass the pair to
    :func:`evaluate_fused` / :func:`evaluate_fused_batched`."""
    from ..policy import _policy_agent, init_policy_params

    path = path or SHIPPED_POLICY
    if not path.endswith(".npz"):
        raise ValueError("policy params must be a native .npz pytree (torch .pt state "
                         "dicts apply to the class agents, not the shipped policy)")
    cfg = EnvConfig()
    template = init_policy_params(torch.Generator(device=resolve_device(device)).manual_seed(0),
                                  cfg)
    return _policy_agent(cfg), load_pytree(path, template)


def _load_wrapper_checkpoint(wrapper: Any, path: str) -> None:
    """A shell's checkpoint: ``.npz`` into its whole state (the spec's
    reward_scale kept), else a torch ``.pt`` through its ``load_state_dict``,
    on the shell's device."""
    if path.endswith(".npz"):
        scale = wrapper.reward_scale
        wrapper._wstate = load_pytree(path, wrapper._wstate)
        wrapper.reward_scale = scale
    else:
        wrapper.load_state_dict(_torch_checkpoint(path, wrapper.inner_env.device))


def battery_rule_bits(ruleset, reference_compat: bool) -> int:
    birth = list(ruleset[0])
    survive = list(ruleset[0] if reference_compat else ruleset[1])
    return rules_mod.pack_rule_bits(birth, survive)


def evaluate(Agent: Any, rules: Sequence[Sequence[Sequence[int]]],
             wrappers: Sequence[Sequence[Any]], params_path: Optional[str] = None,
             steps: int = 1024, reference_compat: bool = True, seed: int = 0,
             verbose: bool = True, device: DeviceLike = None) -> Tuple[float, List[float]]:
    """Score an agent class over the wrapper stack and the ruleset battery,
    one step a call, as the reference does: ``Agent(seed=seed,
    device=device)`` acts on each observation of ``CARLE(device=device)``
    wrapped in each spec's class shell (``seed`` its seed; ``batch_size`` set
    to ``steps * len(rules)`` so no update fires; the checkpoint loaded; eval
    mode).  Runs on the card unless ``device="cpu"``.  Returns (mean reward
    per step, per-step summed-reward trace)."""
    device = resolve_device(device)
    agent = Agent(seed=seed, device=device)
    if params_path is not None:
        agent.load_state_dict(params_path)

    env: Any = CARLE(device=device)
    for spec in wrappers:
        cls, scale, ckpt = spec[0], spec[1], spec[2]
        env = cls(env, seed=seed)
        env.reward_scale = scale
        try:
            env.batch_size = steps * len(rules)  # freeze the updates
        except AttributeError:
            pass  # statistic wrappers have no update cycle
        if ckpt is not None:
            _load_wrapper_checkpoint(env, ckpt)
        env.eval()

    score = 0.0
    total_steps = 0
    score_trace: List[float] = []
    for ruleset in rules:
        env.inner_env.birth = list(ruleset[0])
        if reference_compat:
            env.inner_env.survive = list(ruleset[0])  # the reference's bug
        else:
            env.inner_env.survive = list(ruleset[1])

        obs = env.reset()
        for _ in range(steps):
            action = agent(obs)
            obs, reward, done, info = env.step(action)
            step_sum = float(reward.sum())
            score += step_sum
            score_trace.append(step_sum)
            total_steps += 1

        if verbose:
            print("cumulative score = {:.3e} at total steps = {}, rulset = {}".format(
                score, total_steps, ruleset))

    score /= total_steps
    return score, score_trace


def _resolve_fused_agent(Agent: Any, params_path: Optional[str], agent_params: Any,
                         config: EnvConfig, toggle_rate: float, seed: int,
                         device: torch.device) -> Tuple[FnAgent, Any]:
    """Any supported agent spec as (functional Agent, params).

    Takes ``None`` (the Bernoulli baseline), a functional
    :class:`carle_tpu_torch.agents.Agent`, an ``(Agent, params)`` pair, an
    agent class (built with ``seed``, the config's four dims and ``device``)
    or an agent instance: a class or an instance gives its ``_agent`` and
    its ``params``.  ``params_path`` loads into a class or an instance
    through its ``load_state_dict`` (torch ``.pt`` or native ``.npz``).
    Params of ``None`` mean the agent's own init."""
    if Agent is None:
        if params_path is not None or agent_params is not None:
            raise ValueError(
                "params_path/agent_params were given but Agent=None scores the "
                "Bernoulli random baseline, which has no parameters; pass the "
                "agent the parameters belong to")
        return make_random_agent(config.eff_action_width, config.eff_action_height,
                                 toggle_rate), None
    if isinstance(Agent, FnAgent):
        if params_path is not None:
            raise ValueError(
                "params_path cannot be loaded into a bare functional Agent (its "
                "parameter structure is the caller's); load the checkpoint and "
                "pass agent_params, or pass an agent class or instance with a "
                "load_state_dict")
        return Agent, agent_params
    if isinstance(Agent, tuple):
        if params_path is not None or agent_params is not None:
            raise ValueError(
                "an (Agent, params) pair already carries its parameters; "
                "params_path/agent_params would be ignored; pass one source of "
                "parameters only")
        fn, p = Agent
        return fn, p

    inst = (Agent(seed=seed, action_width=config.eff_action_width,
                  action_height=config.eff_action_height,
                  observation_width=config.width, observation_height=config.height,
                  device=device)
            if isinstance(Agent, type) else Agent)
    if params_path is not None:
        inst.load_state_dict(params_path)
    fn = getattr(inst, "_agent", None)
    if fn is None:
        raise TypeError(
            f"{type(inst).__name__} does not expose a functional policy (expected "
            "an `_agent` attribute); pass a carle_tpu_torch.agents.Agent or an "
            "(Agent, params) pair instead")
    return fn, getattr(inst, "params", None)


def _frozen_rollout(config: EnvConfig, wrappers, per_instance: bool, agent: FnAgent,
                    params: Any, seed: int, device: torch.device, fused_head: Any = False):
    """(rollout, carry) of the frozen stack with the specs' checkpoints."""
    ro = Rollout(config, wrapper_defs(config, wrappers, per_instance, fused_head), agent,
                 device=device)
    carry = ro.init(ro.generator(seed), rules_mod.LIFE, agent_params=params)
    return ro, carry._replace(stack=carry.stack._replace(
        wrappers=inject_wrapper_checkpoints(carry.stack.wrappers, wrappers)))


def evaluate_fused(Agent: Any = None, rules=None, wrappers=None,
                   params_path: Optional[str] = None,
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
    device = resolve_device(device)
    agent, params = _resolve_fused_agent(Agent, params_path, agent_params, config,
                                         toggle_rate, seed, device)
    ro, carry = _frozen_rollout(config, wrappers, False, agent, params, seed, device)

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
                           params_path: Optional[str] = None,
                           steps: int = 1024, reference_compat: bool = True,
                           seed: int = 0, toggle_rate: float = 0.1,
                           verbose: bool = True, agent_params: Any = None,
                           replicas: int = 1, device: DeviceLike = None,
                           mesh: Optional[Mesh] = None) -> Tuple[float, np.ndarray]:
    """The whole battery as one batch: each ruleset is an instance with its
    own rule mask (rules are data), ``replicas`` independent copies of the
    battery ride as further instances, and Speed/Puffer run per instance.
    Each ruleset starts from fresh statistics, where the published protocol
    carries them across segments (see the JAX package's note).  ``mesh`` (a
    ``parallel.mesh.Mesh``) splits the instances over its slots
    (``shard_carry``; the frozen nets a slot at a time over them), the run on
    its home device; rulesets x replicas must divide by the slots of its
    first axis (ValueError otherwise).  Returns (mean score, per-ruleset mean
    reward per step [len(rules)])."""
    rules = DEFAULT_RULES if rules is None else rules
    wrappers = DEFAULT_WRAPPERS if wrappers is None else wrappers
    replicas = max(1, int(replicas))
    config = EnvConfig(instances=len(rules) * replicas)
    fused = False
    if mesh is not None:
        slots = mesh.shape[mesh.axis_names[0]]
        if config.instances % slots:
            raise ValueError(f"rulesets x replicas = {len(rules)} x {replicas} = "
                             f"{config.instances} instances do not divide over the {slots} "
                             f"slots of {mesh}")
        device, fused = mesh.home, (mesh if mesh.size > 1 else False)
    device = resolve_device(device)
    agent, params = _resolve_fused_agent(Agent, params_path, agent_params, config,
                                         toggle_rate, seed, device)
    ro, carry = _frozen_rollout(config, wrappers, True, agent, params, seed, device, fused)
    bits = [battery_rule_bits(rs, reference_compat) for rs in rules] * replicas
    carry = ro.with_rules(carry, torch.tensor(bits, dtype=torch.int32))
    if mesh is not None:
        carry = shard_carry(carry, mesh, config, mesh.axis_names[0])
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

    from ..agents import RandomNetworkAgent

    parser = argparse.ArgumentParser(
        description="Challenge scoring battery (5 rulesets x N steps)")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--per-step", action="store_true",
                      help="the reference's per-step loop (evaluate) over the "
                           "class shells")
    mode.add_argument("--batched", action="store_true",
                      help="all rulesets as one batch of per-instance rules")
    parser.add_argument("--steps", type=int, default=1024)
    parser.add_argument("--replicas", type=int, default=1,
                        help="battery copies in the batch (--batched only)")
    parser.add_argument("--fix-survive-bug", action="store_true",
                        help="use the declared survive rules instead of the "
                             "reference's survive<-birth bug")
    parser.add_argument("--agent", choices=("random", "network", "policy"),
                        default="random",
                        help="random = Bernoulli baseline (SubmissionAgent), "
                             "network = frozen random-CNN RandomNetworkAgent, "
                             "policy = the shipped trained PPO policy "
                             "(policy_ppo.npz; override with --agent-params)")
    parser.add_argument("--agent-params", default=None,
                        help="agent checkpoint loaded via load_state_dict (.pt "
                             "torch state dict or .npz params); for --agent "
                             "policy a native .npz params file")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.agent == "policy" and args.per_step:
        parser.error("--agent policy is a functional policy with no per-step "
                     "shell; drop --per-step")
    if args.agent == "random" and args.agent_params:
        # SubmissionAgent's load_state_dict is a no-op (the challenge
        # template's contract): the params would load into nothing
        parser.error("--agent random has no parameters to load; use --agent "
                     "network or --agent policy with --agent-params")
    device = resolve_device(args.device)
    compat = not args.fix_survive_bug
    kwargs = dict(steps=args.steps, reference_compat=compat, seed=args.seed, device=device)
    if args.agent == "policy":
        kwargs["Agent"] = load_shipped_policy(args.agent_params, device)
    elif args.agent == "network":
        kwargs.update(Agent=RandomNetworkAgent, params_path=args.agent_params)
    if args.per_step:
        agent = kwargs.pop("Agent", SubmissionAgent)
        score, _ = evaluate(agent, DEFAULT_RULES, DEFAULT_WRAPPERS, **kwargs)
    elif args.batched:
        score, _ = evaluate_fused_batched(replicas=args.replicas, **kwargs)
    else:
        score, _ = evaluate_fused(**kwargs)
    print("mean evaluation score is {:.3e}".format(score))


if __name__ == "__main__":
    main()
