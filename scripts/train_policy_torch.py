"""Train a toggle policy against the frozen eval wrapper stack with
carle_tpu_torch, then score it on the challenge battery against the random
baseline.

REINFORCE or PPO (carle_tpu_torch/policy.py) on the eval geometry with the
DEFAULT_WRAPPERS stack: RND2D + AE2D loading the shipped checkpoints, frozen
as during evaluation, plus Speed and Puffer, so the policy optimises the
reward it is scored on.  Training cycles the four public rulesets (survive
set from birth, as the published battery runs them); scoring runs the full
5-ruleset battery through evaluate_fused.  Writes policy_params.npz,
policy_reward_trace.npy and battery_scores.json to --out-dir.

Run (one NVIDIA card):
  python scripts/train_policy_torch.py --instances 16 --epochs 2 --steps 1024 \\
      --out-dir logs/policy_torch
  (--device cpu runs the plain PyTorch path on the CPU.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--instances", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--steps", type=int, default=1024,
                        help="training steps per ruleset segment")
    parser.add_argument("--algo", choices=("reinforce", "ppo"), default="reinforce")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--entropy-beta", type=float, default=1e-3)
    parser.add_argument("--entropy-beta-final", type=float, default=None,
                        help="PPO only: decay the entropy bonus linearly from "
                             "--entropy-beta to this value across all iterations")
    parser.add_argument("--ppo-horizon", type=int, default=128,
                        help="steps collected per PPO iteration")
    parser.add_argument("--gamma", type=float, default=0.0,
                        help="PPO discount for return-to-go credit (0 = immediate bonus)")
    parser.add_argument("--eval-steps", type=int, default=1024)
    parser.add_argument("--resume-params", default=None,
                        help="policy params .npz to continue training from "
                             "(fresh optimiser state)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out-dir", default="logs/policy_torch")
    parser.add_argument("--skip-eval", action="store_true")
    parser.add_argument("--fused-head", action="store_true",
                        help="run the policy's conv front-end as the fused encoder "
                             "kernels (csrc/enc3_fwd.cu, enc3_bwd.cu)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from carle_tpu_torch import EnvConfig, rules as rules_mod
    from carle_tpu_torch.checkpoint import load_pytree, save_pytree
    from carle_tpu_torch.device import resolve_device
    from carle_tpu_torch.evaluation.eval import (DEFAULT_WRAPPERS, evaluate_fused,
                                                 inject_wrapper_checkpoints, wrapper_defs)
    from carle_tpu_torch.policy import PolicyTrainer, PPOTrainer, init_policy_params
    from carle_tpu_torch.train_mcl import DEFAULT_RULES as TRAIN_RULES

    device = resolve_device(args.device)
    config = EnvConfig(instances=args.instances)  # the eval geometry, batched
    defs = wrapper_defs(config, DEFAULT_WRAPPERS, per_instance=False)
    kw = dict(lr=args.lr, entropy_beta=args.entropy_beta, fused_head=args.fused_head,
              device=device)
    trainer = (PPOTrainer(config, defs, gamma=args.gamma, **kw) if args.algo == "ppo"
               else PolicyTrainer(config, defs, **kw))
    state = trainer.init(trainer.generator(args.seed), rules_mod.LIFE)
    state = state._replace(stack=state.stack._replace(
        wrappers=inject_wrapper_checkpoints(state.stack.wrappers, DEFAULT_WRAPPERS)))
    if args.resume_params:
        template = init_policy_params(trainer.generator(0), config)
        loaded = load_pytree(args.resume_params, template)
        state = state._replace(params=loaded, opt_state=trainer.opt.init(loaded))

    os.makedirs(args.out_dir, exist_ok=True)
    history = []
    iters_per_segment = max(1, args.steps // args.ppo_horizon)
    total_iters = args.epochs * len(TRAIN_RULES) * iters_per_segment
    iter_idx = 0
    for epoch in range(args.epochs):
        for ruleset in TRAIN_RULES:
            # survive <- birth: the rules the published battery runs
            bits = rules_mod.pack_rule_bits(ruleset[0], ruleset[0])
            env = state.stack.env._replace(
                rule_bits=torch.as_tensor(bits, dtype=torch.int32, device=device))
            state = state._replace(stack=state.stack._replace(env=env))
            t0 = time.time()
            if args.algo == "ppo":
                traces = []
                for _ in range(iters_per_segment):
                    beta = None
                    if args.entropy_beta_final is not None:
                        frac = iter_idx / max(1, total_iters - 1)
                        beta = (args.entropy_beta
                                + frac * (args.entropy_beta_final - args.entropy_beta))
                    state, t = trainer.run(state, args.ppo_horizon, entropy_beta=beta)
                    iter_idx += 1
                    traces.append(t.cpu().numpy())
                trace = np.concatenate(traces)
            else:
                state, trace = trainer.run(state, args.steps)
                trace = trace.cpu().numpy()
            history.append(trace)
            # len(trace): the steps actually run (PPO rounds to whole horizons)
            print(json.dumps({
                "epoch": epoch, "ruleset": ruleset,
                "mean_reward_first100": float(trace[:100].mean()),
                "mean_reward_last100": float(trace[-100:].mean()),
                "segment_steps": int(len(trace)),
                "steps_per_s": len(trace) / (time.time() - t0),
            }), flush=True)

    params_path = save_pytree(os.path.join(args.out_dir, "policy_params.npz"), state.params)
    np.save(os.path.join(args.out_dir, "policy_reward_trace.npy"), np.concatenate(history))
    print(json.dumps({"saved": params_path}), flush=True)
    if args.skip_eval:
        return 0

    # battery score: the trained policy (stochastic, as trained) against the
    # random agent, one universe (the published protocol)
    agent = PolicyTrainer(EnvConfig(), [], device=device).as_agent()
    score_policy, _ = evaluate_fused(Agent=(agent, state.params), steps=args.eval_steps,
                                     seed=args.seed, verbose=False, device=device)
    score_random, _ = evaluate_fused(steps=args.eval_steps, seed=args.seed, verbose=False,
                                     device=device)
    out = {
        "policy_score": float(score_policy),
        "random_score": float(score_random),
        "eval_steps": args.eval_steps,
        "train": {"instances": args.instances, "epochs": args.epochs,
                  "steps_per_segment": args.steps, "lr": args.lr, "algo": args.algo},
    }
    print(json.dumps(out), flush=True)
    with open(os.path.join(args.out_dir, "battery_scores.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
