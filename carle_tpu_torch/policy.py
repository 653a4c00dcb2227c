"""Policy-gradient agent training (counterpart of carle_tpu/policy.py).

A learnable toggle policy trained against the endogenous-reward wrapper
stack.  Policy: a small CNN maps the observation to per-cell Bernoulli logits
over the action window (conv 1->8, relu, pool 2; conv 8->1, relu, pool 2; a
dense layer; minus 3.0, so sigmoid(-3) ~ 0.047 toggles at init).  Two
trainers:

* :class:`PolicyTrainer`: per-step REINFORCE with a batch-mean advantage
  blended with an EMA baseline, global-norm clipping and an entropy bonus,
  ``loss = -(R - b) * sum(log pi(a|s)) - beta * H[pi]``;
* :class:`PPOTrainer`: a collect phase storing uint8 grids, action bits,
  rewards and behaviour log-probs, then clipped-surrogate minibatch epochs
  that recompute the policy forward from the stored grids.

The JAX package's ``lax.scan`` becomes eager Python loops that never wait
for the device.  Each trainer state carries one ``torch.Generator`` on the
trainers' device, which draws the initial parameters, the actions'
uniforms, the epochs' permutations and the wrappers' plain-PyTorch dropout,
and ``drop_seed``, a host counter that advances every step: the net kernels'
dropout seed (where the JAX state splits a key a step).  The uniforms and
the permutations are drawn by :meth:`PolicyTrainer._uniform` and
:meth:`PPOTrainer._permutation`, so a caller can replay another stream.

``fused_head=True`` runs both conv stages as the fused encoder
(``nets.conv_encoder``: the kernels specialised at the policy's widths
(C1, C2, P1, P2) = (8, 1, 2, 2), ``csrc/enc3_fwd.cu``, ``enc3_bwd.cu``),
differentiable in the four conv parameters; it reads the universe's uint8
cells, never a float copy.  ``False`` runs ``nets.conv2d`` and
``nets.max_pool2`` under autograd.  The dense layer is one large product,
``F.linear``, on either route (the JAX package computes it outside Pallas).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import nets
from .agents import Agent
from .config import EnvConfig
from .device import DeviceLike, resolve_device
from .mcl._online import _flat, _unflat, adam_step, tree_leaves, tree_map, tree_unflatten
from .mcl.base import WrapperDef, WrapperStack


def init_policy_params(generator: torch.Generator, config: EnvConfig,
                       filters: int = 8) -> Dict[str, Any]:
    """Conv OIHW ``{"w", "b"}`` pairs and the dense layer (out, in), drawn
    from ``generator`` on its device."""
    device = generator.device
    dense_in = (config.height // 4) * (config.width // 4)
    n_out = config.eff_action_height * config.eff_action_width
    return {
        "conv1": nets.conv_init(filters, 1, 3, generator, device),
        "conv2": nets.conv_init(1, filters, 3, generator, device),
        "dense": nets.linear_init(n_out, dense_in, generator, device),
    }


def policy_logits(params: Dict[str, Any], obs: torch.Tensor,
                  fused_head: Any = False) -> torch.Tensor:
    """obs [inst, 1, H, W] (uint8 cells or 0/1 floats) -> toggle logits
    [inst, AH*AW].  ``fused_head`` runs the conv front-end as the fused
    encoder on uint8 cells (a float observation is cast to them); a
    ``parallel.mesh.Mesh`` runs it a slot at a time over the instances
    (nets.py's batch-axis route, the JAX package's ``nets._shard_fused``)."""
    if fused_head:
        cells = obs if obs.dtype in (torch.uint8, torch.uint32) else obs.to(torch.uint8)
        x = nets.conv_encoder(cells, params["conv1"], params["conv2"], pools=(2, 2),
                              drop_p=0.0, mesh=nets.fused_route(fused_head))
    else:
        x = nets.max_pool2(torch.relu(nets.conv2d(obs, params["conv1"], padding=1)))
        x = nets.max_pool2(torch.relu(nets.conv2d(x, params["conv2"], padding=1)))
    return nets.linear(nets.flatten(x), params["dense"]) - 3.0


def log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Per-cell Bernoulli log-probability of a 0/1 action, optax's
    ``-sigmoid_binary_cross_entropy(logits, action)``."""
    return action * F.logsigmoid(logits) + (1.0 - action) * F.logsigmoid(-logits)


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Mean Bernoulli entropy in the stable logits form: -log p =
    softplus(-x), -log(1-p) = softplus(x)."""
    p = torch.sigmoid(logits)
    return torch.mean(p * F.softplus(-logits) + (1.0 - p) * F.softplus(logits))


class ClippedAdam:
    """``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))``
    on a parameter tree.  The state is ``{"count", "mu", "nu"}`` (Adam's
    slots, :func:`mcl._online.adam_step`); the clip keeps the gradient where
    its global norm (over every leaf) is below ``max_norm``, else scales it
    to ``g / norm * max_norm``.  The arithmetic runs on one flat vector."""

    def __init__(self, lr: float, max_norm: float = 1.0) -> None:
        self.lr = lr
        self.max_norm = max_norm

    def init(self, params: Any) -> Dict[str, Any]:
        device = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads: Any, state: Dict[str, Any], params: Any
               ) -> Tuple[Any, Dict[str, Any]]:
        g = _flat(grads)
        norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(norm < self.max_norm, g, g / norm * self.max_norm)
        new, mu, nu, count = adam_step(_flat(params), g, _flat(state["mu"]),
                                       _flat(state["nu"]), state["count"], self.lr)
        return _unflat(new, params), {"count": count, "mu": _unflat(mu, params),
                                      "nu": _unflat(nu, params)}


class PolicyTrainState(NamedTuple):
    stack: Any                # StackState
    params: Any
    opt_state: Any
    baseline: torch.Tensor    # EMA of the batch-mean reward
    generator: torch.Generator
    drop_seed: int = 0


def _leaves(params: Any) -> Any:
    """Detached copies of the parameters that record a graph."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


class _Trainer:
    """What both trainers share: the stack, the optimiser, the state's
    initialisation, the action draw and the agent."""

    def __init__(self, config: EnvConfig, wrappers: Sequence[WrapperDef], lr: float,
                 entropy_beta: float, baseline_decay: float, fused_head: Any,
                 device: DeviceLike) -> None:
        self.config = config
        self.fused_head = fused_head
        self.device = resolve_device(device)
        self.stack = WrapperStack(config, wrappers)
        # global-norm clipping: the surrogate's gradient scales with the
        # summed log-prob over the whole action window, and occasional large
        # advantage x logp spikes otherwise diverge the logits to overflow
        self.opt = ClippedAdam(lr)
        self.entropy_beta = entropy_beta
        self.baseline_decay = baseline_decay

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the trainer's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def init(self, generator: torch.Generator, rule_bits):
        """The stack, fresh parameters and Adam slots; ``generator`` (on the
        trainer's device) draws them and is carried for the run."""
        stack = self.stack.init(generator, rule_bits, self.device)
        params = init_policy_params(generator, self.config)
        return PolicyTrainState(
            stack=stack, params=params, opt_state=self.opt.init(params),
            baseline=torch.zeros((), dtype=torch.float32, device=self.device),
            generator=generator,
            drop_seed=(generator.initial_seed() & 0x7FFFFFFF) << 24)

    def _uniform(self, generator: torch.Generator, shape) -> torch.Tensor:
        """The uniforms an action is sampled from (``u < sigmoid(logits)``)."""
        return torch.rand(tuple(shape), generator=generator, device=self.device)

    def _sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        u = self._uniform(generator, logits.shape)
        return (u < torch.sigmoid(logits)).to(torch.float32)

    def _patch(self, action: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return action.reshape(cfg.instances, cfg.eff_action_height, cfg.eff_action_width)

    def as_agent(self, deterministic_rate: Optional[float] = None) -> Agent:
        """The trained policy on the Agent protocol, with this trainer's
        ``fused_head``, so the evaluated forward is the trained one."""
        return _policy_agent(self.config, deterministic_rate, fused_head=self.fused_head)


class PolicyTrainer(_Trainer):
    """Per-step REINFORCE over a wrapper stack on one device."""

    def __init__(self, config: EnvConfig, wrappers: Sequence[WrapperDef] = (),
                 lr: float = 1e-3, entropy_beta: float = 1e-3,
                 baseline_decay: float = 0.99, fused_head: Any = False,
                 device: DeviceLike = None) -> None:
        super().__init__(config, wrappers, lr, entropy_beta, baseline_decay, fused_head,
                         device)

    def step(self, state: PolicyTrainState) -> Tuple[PolicyTrainState, torch.Tensor]:
        """One REINFORCE step: sample, transition, update.  The sampling
        forward's logits are the loss's (the same function of the same
        parameters), so the policy runs forward once a step.  Returns (state',
        the batch-mean reward)."""
        cells = self.stack.universe(state.stack)[:, None]
        leaves = _leaves(state.params)
        with torch.enable_grad():
            lg = policy_logits(leaves, cells, self.fused_head)
        with torch.no_grad():
            action = self._sample(lg.detach(), state.generator)
            seed = state.drop_seed + 1
            stack, (_, reward) = self.stack.step(state.stack, self._patch(action), seed,
                                                 state.generator)
            r = reward[:, 0]
            # batch-mean baseline (no lag) blended with the EMA (keeps a
            # signal when instances == 1)
            baseline = (self.baseline_decay * state.baseline
                        + (1 - self.baseline_decay) * r.mean())
            advantage = r - r.mean() + 0.1 * (r - baseline)
        with torch.enable_grad():
            logp_sum = log_prob(lg, action).sum(dim=1)
            loss = -(advantage * logp_sum).mean() - self.entropy_beta * entropy(lg)
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        with torch.no_grad():
            params, opt_state = self.opt.update(tree_unflatten(state.params, grads),
                                                state.opt_state, state.params)
        new_state = state._replace(stack=stack, params=params, opt_state=opt_state,
                                   baseline=baseline, drop_seed=seed)
        return new_state, r.mean()

    def run(self, state: PolicyTrainState, num_steps: int
            ) -> Tuple[PolicyTrainState, torch.Tensor]:
        """Train for ``num_steps`` steps; returns (state, mean-reward trace
        [num_steps] on the device)."""
        trace = []
        for _ in range(int(num_steps)):
            state, r = self.step(state)
            trace.append(r)
        return state, (torch.stack(trace) if trace
                       else torch.zeros((0,), device=self.device))


def _policy_agent(cfg: EnvConfig, deterministic_rate: Optional[float] = None,
                  fused_head: Any = False) -> Agent:
    """The policy as an Agent: toggles where ``u < sigmoid(logits)`` (``u``
    from the caller's generator), or where ``sigmoid(logits) >
    deterministic_rate``."""

    def init(generator: torch.Generator) -> Any:
        raise RuntimeError("use trained params from a trainer state")

    def apply(params: Any, generator: torch.Generator, obs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            logits = policy_logits(params, obs, fused_head)
            if deterministic_rate is not None:
                action = torch.sigmoid(logits) > deterministic_rate
            else:
                u = torch.rand(logits.shape, generator=generator, device=logits.device)
                action = u < torch.sigmoid(logits)
        return action.to(torch.float32).reshape(
            obs.shape[0], 1, cfg.eff_action_height, cfg.eff_action_width)

    return Agent(init=init, apply=apply)


# ---------------------------------------------------------------------------
# PPO: clipped-surrogate training over recomputed rollout segments
# ---------------------------------------------------------------------------


PPOTrainState = PolicyTrainState   # the JAX package's name for the same carry


class PPOBatch(NamedTuple):
    """What a collect phase stores, [horizon, inst, ...]."""
    grids: torch.Tensor       # uint8 [T, inst, H, W]: the universes the policy saw
    actions: torch.Tensor     # bool [T, inst, AH*AW]
    rewards: torch.Tensor     # float32 [T, inst]
    logp_old: torch.Tensor    # float32 [T, inst]: the behaviour log-probs


class PPOTrainer(_Trainer):
    """Proximal Policy Optimization.  Each :meth:`run` is two phases
    (:meth:`collect`, :meth:`update`):

    1. **Collect**: ``horizon`` policy steps through the wrapped env, storing
       the uint8 grids the policy saw, the sampled action bits, per-instance
       rewards and behaviour log-probs.
    2. **Update**: ``epochs`` passes of minibatched clipped-surrogate ascent;
       the policy forward is recomputed from the stored uint8 grids, which
       reach the encoder as they are (no float copy).  The advantage is the
       credit (the immediate reward, or with ``gamma > 0`` the discounted
       return-to-go centred per timestep) less its batch mean.
    """

    def __init__(self, config: EnvConfig, wrappers: Sequence[WrapperDef] = (),
                 lr: float = 3e-4, clip_eps: float = 0.2, entropy_beta: float = 1e-3,
                 epochs: int = 4, minibatches: int = 4, baseline_decay: float = 0.99,
                 gamma: float = 0.0, norm_advantage: bool = False,
                 fused_head: Any = False, device: DeviceLike = None) -> None:
        super().__init__(config, wrappers, lr, entropy_beta, baseline_decay, fused_head,
                         device)
        self.clip_eps = clip_eps
        self.epochs = epochs
        self.minibatches = minibatches
        # gamma > 0 credits actions for future bonuses flowing through the
        # universe state (a toggled glider pays SpeedDetector for many
        # steps); gamma == 0 reduces to the immediate-bonus objective.
        self.gamma = gamma
        # std-normalizing near-constant endogenous rewards amplifies batch
        # noise to +/-1 and the repeated clipped updates then drive the
        # policy to a degenerate attractor: default off, raw advantages
        self.norm_advantage = norm_advantage

    def _permutation(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """An epoch's order of the n collected samples."""
        return torch.randperm(n, generator=generator, device=self.device)

    def _minibatch_size(self, n: int) -> int:
        mb = n // self.minibatches
        if mb == 0:
            # a mean over an empty minibatch is NaN: fail before any step
            raise ValueError(
                f"horizon*instances = {n} must be >= minibatches "
                f"({self.minibatches}); raise the horizon or lower minibatches")
        return mb

    # -- phase 1: collect -----------------------------------------------------
    def collect(self, state: PPOTrainState, horizon: int) -> Tuple[PPOTrainState, PPOBatch]:
        """``horizon`` policy steps through the stack; returns (state with the
        new stack, what the update reads)."""
        cfg = self.config
        n_act = cfg.eff_action_height * cfg.eff_action_width
        dev = self.device
        batch = PPOBatch(
            grids=torch.empty((horizon, cfg.instances, cfg.height, cfg.width),
                              dtype=torch.uint8, device=dev),
            actions=torch.empty((horizon, cfg.instances, n_act), dtype=torch.bool, device=dev),
            rewards=torch.empty((horizon, cfg.instances), dtype=torch.float32, device=dev),
            logp_old=torch.empty((horizon, cfg.instances), dtype=torch.float32, device=dev))
        stack, seed = state.stack, state.drop_seed
        with torch.no_grad():
            for t in range(horizon):
                batch.grids[t].copy_(self.stack.universe(stack))   # the state BEFORE acting
                logits = policy_logits(state.params, batch.grids[t][:, None], self.fused_head)
                action = self._sample(logits, state.generator)
                batch.logp_old[t] = log_prob(logits, action).sum(dim=1)
                batch.actions[t] = action.to(torch.bool)
                seed += 1
                stack, (_, reward) = self.stack.step(stack, self._patch(action), seed,
                                                     state.generator)
                batch.rewards[t] = reward[:, 0]
        return state._replace(stack=stack, drop_seed=seed), batch

    def _credit(self, rewards: torch.Tensor) -> torch.Tensor:
        """[horizon, inst] credit: the rewards, or with ``gamma > 0`` the
        discounted return-to-go along the horizon, centred per timestep across
        instances when there are several (truncated returns shrink toward the
        horizon's end, so one global baseline would push late actions negative
        by position)."""
        if self.gamma <= 0.0:
            return rewards
        returns = torch.empty_like(rewards)
        carry = torch.zeros_like(rewards[0])
        for t in range(rewards.shape[0] - 1, -1, -1):
            carry = rewards[t] + self.gamma * carry
            returns[t] = carry
        if self.config.instances > 1:
            returns = returns - returns.mean(dim=1, keepdim=True)
        return returns

    # -- phase 2: clipped-surrogate updates -----------------------------------
    def _minibatch_update(self, params: Any, opt_state: Any, idx: torch.Tensor,
                          grids: torch.Tensor, actions: torch.Tensor,
                          advantages: torch.Tensor, logp_old: torch.Tensor,
                          entropy_beta: float) -> Tuple[Any, Any]:
        """One clipped-surrogate step on the samples ``idx`` of the flat
        batch (grids uint8 [n, H, W], actions bool [n, AH*AW])."""
        leaves = _leaves(params)
        with torch.enable_grad():
            lg = policy_logits(leaves, grids[idx][:, None], self.fused_head)
            logp = log_prob(lg, actions[idx].to(torch.float32)).sum(dim=1)
            ratio = torch.exp(logp - logp_old[idx])
            adv = advantages[idx]
            clipped = torch.clamp(ratio, 1.0 - self.clip_eps, 1.0 + self.clip_eps) * adv
            pg_loss = -torch.mean(torch.minimum(ratio * adv, clipped))
            loss = pg_loss - entropy_beta * entropy(lg)
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        with torch.no_grad():
            return self.opt.update(tree_unflatten(params, grads), opt_state, params)

    def update(self, state: PPOTrainState, batch: PPOBatch,
               entropy_beta: Optional[float] = None) -> PPOTrainState:
        """``epochs`` passes of minibatched clipped-surrogate updates over a
        collected batch; ``entropy_beta`` overrides the constructor's value."""
        beta = self.entropy_beta if entropy_beta is None else float(entropy_beta)
        cfg = self.config
        n = batch.rewards.numel()
        mb = self._minibatch_size(n)
        with torch.no_grad():
            flat_grids = batch.grids.reshape(n, cfg.height, cfg.width)
            flat_actions = batch.actions.reshape(n, -1)
            flat_rewards = self._credit(batch.rewards).reshape(n)
            flat_logp = batch.logp_old.reshape(n)
            baseline = (self.baseline_decay * state.baseline
                        + (1 - self.baseline_decay) * flat_rewards.mean())
            # strictly zero-mean advantage (no EMA blend): any uniform offset
            # acts as behaviour cloning of the sampled, mostly-zero patches;
            # the EMA is kept only as a reward-trace diagnostic
            advantages = flat_rewards - flat_rewards.mean()
            if self.norm_advantage:
                advantages = advantages / (advantages.std(unbiased=False) + 1e-6)
        params, opt_state = state.params, state.opt_state
        for _ in range(self.epochs):
            perm = self._permutation(state.generator, n)
            for idx in perm[: mb * self.minibatches].reshape(self.minibatches, mb):
                params, opt_state = self._minibatch_update(
                    params, opt_state, idx, flat_grids, flat_actions, advantages, flat_logp,
                    beta)
        return state._replace(params=params, opt_state=opt_state, baseline=baseline)

    def run(self, state: PPOTrainState, horizon: int,
            entropy_beta: Optional[float] = None) -> Tuple[PPOTrainState, torch.Tensor]:
        """One PPO iteration, :meth:`collect` then :meth:`update`; returns
        (state, per-step batch-mean reward trace [horizon])."""
        self._minibatch_size(horizon * self.config.instances)
        state, batch = self.collect(state, horizon)
        return self.update(state, batch, entropy_beta), batch.rewards.mean(dim=1)


__all__ = ["init_policy_params", "policy_logits", "log_prob", "entropy", "ClippedAdam",
           "PolicyTrainState", "PolicyTrainer", "PPOTrainState", "PPOBatch", "PPOTrainer"]
