"""How well the device-memory preflight prices ``train`` on the card.

For each batch of 256² universes, ``train`` (one ruleset, one segment of 64
steps, RND2D + AE2D, dropout on) runs with the preflight's probe at 1 step
and at ``train_mcl.PREFLIGHT_STEPS``, and the price (arguments, transient,
workspace) is set beside the peak that ``torch.cuda.max_memory_allocated``
reaches over the first segment, above what was allocated before the call.
Also printed: the bytes of the float observation ``Rollout.reset`` returns
(which ``train`` drops), and the tensors a training step leaves in reference
cycles (``gc`` with ``DEBUG_SAVEALL`` over 4 steps: 0 when every step-local
tensor dies with its last reference).

    python scripts/preflight_probe_torch.py [--sizes 64 1024]

One JSON line a measurement; the card's name and power limit first.  Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from carle_tpu_torch import EnvConfig, rules, train_mcl  # noqa: E402
from carle_tpu_torch.agents import make_random_agent  # noqa: E402
from carle_tpu_torch.mcl import ae2d_def, rnd2d_def  # noqa: E402
from carle_tpu_torch.rollout import Rollout  # noqa: E402

GIB = 2 ** 30


def priced(n: int, probe_steps: int, log_dir: str) -> dict:
    """The price of ``train`` at ``n`` universes with a probe of
    ``probe_steps`` steps, and the first segment's measured peak."""
    train_mcl.PREFLIGHT_STEPS = probe_steps
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    seen = []

    def after(info):
        torch.cuda.synchronize()
        seen.append((info["preflight"], torch.cuda.max_memory_allocated() - before))

    train_mcl.train(instances=n, steps=(1, 64), rules=[[[3], [2, 3]]], log_dir=log_dir,
                    mesh=False, segment_callback=after, device="cuda")
    price, peak = seen[0]
    return {"universes": n, "probe_steps": probe_steps,
            "peak_estimate_gib": price["peak_estimate_gib"],
            "argument_gib": price["argument_size_in_bytes"] / GIB,
            "temp_gib": price["temp_size_in_bytes"] / GIB,
            "workspace_gib": price["workspace_size_in_bytes"] / GIB,
            "measured_peak_gib": peak / GIB,
            "error": price["peak_estimate_gib"] / (peak / GIB) - 1}


def cycles(n: int) -> dict:
    """Tensors a training step leaves in reference cycles, and the bytes of
    the observation ``Rollout.reset`` returns."""
    cfg = EnvConfig(instances=n)
    defs = [rnd2d_def(cfg), ae2d_def(cfg)]
    ro = Rollout(cfg, defs, make_random_agent(64, 64, 0.1), device="cuda")
    carry = ro.init(ro.generator(0), rules.LIFE)
    carry, obs = ro.reset(carry)
    reset_bytes = obs.numel() * obs.element_size()
    del obs
    carry, _ = ro.run(carry, 2)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        carry, _ = ro.run(carry, 4)
        torch.cuda.synchronize()
        gc.collect()
        tensors = [o for o in gc.garbage if torch.is_tensor(o)]
        found = {"cycle_tensors_per_step": len(tensors) / 4,
                 "cycle_bytes_per_step": sum(t.numel() * t.element_size() for t in tensors) / 4}
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    return {"universes": n, "reset_observation_gib": reset_bytes / GIB, **found}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=[64, 1024])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    default = train_mcl.PREFLIGHT_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        for n in args.sizes:
            for steps in (default, 1, default):   # the first call in the process pays the workspace
                print(json.dumps(priced(n, steps, os.path.join(tmp, f"{n}-{steps}"))), flush=True)
    train_mcl.PREFLIGHT_STEPS = default
    for n in args.sizes:
        print(json.dumps(cycles(n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
