"""Demo drivers mirroring the reference's __main__ blocks (counterpart of
carle_tpu/demos.py).

* :func:`prediction_demo` — reference mcl.py:895-959: CARLE -> PredictionBonus
  -> ParsimonyBonus, seed a glider, predictable steps then random steps; the
  predictability reward rises then plummets.  Saves the reward curve and the
  final frame.
* :func:`wrapper_agent_demo` — reference agents.py:105-208: a wrapper env
  (AE2D/RND2D) driven by the pentadecathlon seed and by a RandomAgent across
  rulesets, dumping reward curves and frames.
* :func:`morpho_spaceship_demo` — MorphoBonus tracking the shipped duck
  spaceship.
* :func:`episode_gif_demo` — a random agent's episode as an animated GIF
  from ``Rollout.run_gif``.

Each runs on the card unless ``device="cpu"``; a step's reward stays on the
device and the curve is copied to the host once.  matplotlib is optional:
without it the curves are saved as .npy only.

Run:  python -m carle_tpu_torch.demos [outdir] [--device cpu]
"""

from __future__ import annotations

import os
import sys
from typing import List

import numpy as np
import torch

from .agents import RandomAgent
from .device import DeviceLike
from .env import CARLE
from .mcl import AE2D, ParsimonyBonus, PredictionBonus, RND2D
from .mcl.patterns import get_glider
from .utils.png import write_png


def _save_curve(path_base: str, rewards: List[torch.Tensor], title: str) -> None:
    """Save a step's rewards (device scalars) as .npy, and as a plot when
    matplotlib is installed."""
    curve = torch.stack(rewards).cpu().numpy() if rewards else np.zeros(0, np.float32)
    np.save(path_base + ".npy", curve)
    try:
        import matplotlib
    except ImportError:
        return  # the .npy holds the data
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.plot(curve, lw=2, label="rewards")
    plt.legend()
    plt.title(title)
    plt.xlabel("steps")
    plt.savefig(path_base + ".png")
    plt.close()


def _save_frame(path: str, obs: torch.Tensor) -> None:
    frame = obs.reshape(obs.shape[-2], obs.shape[-1]).cpu().numpy()
    write_png(path, (255 * frame).astype(np.uint8))


def prediction_demo(outdir: str = "./frames", predictable_steps: int = 1024,
                    random_steps: int = 512, seed: int = 0,
                    device: DeviceLike = None) -> float:
    os.makedirs(outdir, exist_ok=True)
    env: object = CARLE(device=device)
    env = PredictionBonus(env, seed=seed)
    env = ParsimonyBonus(env)
    env.inner_env.birth = [3]
    env.inner_env.survive = [2, 3]

    obs = env.reset()
    rng = np.random.RandomState(seed)
    action = get_glider()
    rewards: List[torch.Tensor] = []
    for _ in range(predictable_steps):
        obs, reward, done, info = env.step(action)
        rewards.append(reward.sum())
        action = action * 0.0
    for _ in range(random_steps):
        action = (rng.rand(*np.shape(get_glider())) > 0.95).astype(np.float32)
        obs, reward, done, info = env.step(action)
        rewards.append(reward.sum())

    sum_reward = float(torch.stack(rewards).sum()) if rewards else 0.0
    print("reward sum ", sum_reward)
    _save_curve(os.path.join(outdir, "prediction_demo_rewards"), rewards,
                "PredictionBonus: glider then noise")
    _save_frame(os.path.join(outdir, "prediction_demo_final.png"), obs)
    return sum_reward


def _pentadecathlon_action() -> np.ndarray:
    """The reference demo's seed action (agents.py:129-133): three 8-row
    columns with holes at rows 9 and 14 — pentadecathlon-style oscillators
    placed across the action window."""
    action = np.zeros((1, 1, 64, 64), dtype=np.float32)
    for ii in range(1, 30, 14):
        action[0, 0, 8:16, ii:ii + 3] = 1.0
        action[0, 0, 9, ii + 1] = 0.0
        action[0, 0, 14, ii + 1] = 0.0
    return action


def wrapper_agent_demo(outdir: str = "./frames", steps: int = 128, seed: int = 0,
                       device: DeviceLike = None) -> None:
    os.makedirs(outdir, exist_ok=True)
    rulesets = {"life": ([3], [2, 3]), "mouse_maze": ([3, 7], [1, 2, 3, 4, 5])}
    for wrapper_cls, wrapper_name in ((AE2D, "AE2D"), (RND2D, "RND2D")):
        for name, (birth, survive) in rulesets.items():
            # leg 1 — the reference __main__'s pentadecathlon seed, then
            # free-running dynamics (agents.py:125-141)
            env = wrapper_cls(CARLE(device=device), batch_size=32, seed=seed)
            env.inner_env.birth = birth
            env.inner_env.survive = survive
            obs = env.reset()
            action = _pentadecathlon_action()
            rewards: List[torch.Tensor] = []
            for _ in range(steps):
                obs, reward, done, info = env.step(action)
                action = np.zeros_like(action)  # seed once, then hands off
                rewards.append(reward.sum())
            base = os.path.join(outdir, f"pentadecathlon_{wrapper_name}_{name}")
            _save_curve(base, rewards, f"{name} seeded, {wrapper_name} reward")
            _save_frame(base + "_final.png", obs)

            # leg 2 — RandomAgent across the same rulesets (agents.py:147+)
            env = wrapper_cls(CARLE(device=device), batch_size=32, seed=seed)
            env.inner_env.birth = birth
            env.inner_env.survive = survive
            agent = RandomAgent(seed=seed, device=env.inner_env.device)
            obs = env.reset()
            rewards = []
            for _ in range(steps):
                obs, reward, done, info = env.step(agent(obs))
                rewards.append(reward.sum())
            base = os.path.join(outdir, f"random_{wrapper_name}_{name}")
            _save_curve(base, rewards, f"{name} CA with {wrapper_name} reward")
            _save_frame(base + "_final.png", obs)


def morpho_spaceship_demo(outdir: str = "./frames", steps: int = 64, seed: int = 0,
                          device: DeviceLike = None) -> None:
    """MorphoBonus rewarding the reference's own shipped spaceship pattern
    (spaceship_duck.rle — the morphology the reference meant to target
    before its glider-file paths broke, mcl.py:140-141): seed the duck in a
    Life universe and watch the morphology reward stay positive while it
    cruises."""
    from .mcl import MorphoBonus
    from .mcl.patterns import pattern_path

    os.makedirs(outdir, exist_ok=True)
    env = MorphoBonus(CARLE(device=device), seed=seed,
                      rle_paths=(pattern_path("spaceship_duck"),
                                 pattern_path("spaceship_step")))
    obs = env.reset()

    # drop the duck near the window centre through the action interface
    with open(pattern_path("spaceship_duck")) as f:
        duck = env.inner_env.rle_to_grid(f.read())
    action = np.zeros((1, 1, 64, 64), dtype=np.float32)
    action[0, 0, 20:20 + duck.shape[0], 20:20 + duck.shape[1]] = duck
    obs, reward, *_ = env.step(action)

    rewards: List[torch.Tensor] = []
    zeros = np.zeros_like(action)
    for _ in range(steps):
        obs, reward, done, info = env.step(zeros)
        rewards.append(reward.sum())
    base = os.path.join(outdir, "morpho_spaceship")
    _save_curve(base, rewards, "MorphoBonus tracking the duck spaceship")
    _save_frame(base + "_final.png", obs)


def episode_gif_demo(outdir: str = "./frames", steps: int = 256, seed: int = 0,
                     device: DeviceLike = None) -> str:
    """A random agent in a Life universe (4 instances) rendered to an
    animated GIF, its toggles highlighted, by ``Rollout.run_gif``; returns
    the GIF's path."""
    from . import rules
    from .agents import make_random_agent
    from .config import EnvConfig
    from .rollout import Rollout

    os.makedirs(outdir, exist_ok=True)
    ro = Rollout(EnvConfig(instances=4), wrappers=[], agent=make_random_agent(),
                 device=device)
    carry = ro.init(ro.generator(seed), rules.LIFE)
    carry, _ = ro.reset(carry)
    _, _, path = ro.run_gif(carry, num_steps=steps, chunk=min(steps, 128), every=2,
                            path=os.path.join(outdir, "episode_random_life.gif"))
    print(f"episode gif: {path}")
    return path


def main(argv: List[str]) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("outdir", nargs="?", default="./frames")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    prediction_demo(args.outdir, predictable_steps=256, random_steps=128,
                    device=args.device)
    wrapper_agent_demo(args.outdir, steps=64, device=args.device)
    morpho_spaceship_demo(args.outdir, steps=64, device=args.device)
    episode_gif_demo(args.outdir, steps=256, device=args.device)
    print(f"demo artifacts in {args.outdir}")


if __name__ == "__main__":
    main(sys.argv[1:])
