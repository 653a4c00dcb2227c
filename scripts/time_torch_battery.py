"""Wall time of carle_tpu_torch's scoring battery on the card, several times.

    python scripts/time_torch_battery.py [--batched 4] [--sequential 2]

Run from the repository root.  Prints one JSON line: the seconds of each
``evaluate_fused_batched`` run (160 universes x 1024 steps) and each
``evaluate_fused`` run (5 x 1024 steps on one universe), after one short
batched run that builds the kernels and warms the card.  The host's time a
step varies with the machine's load, so to compare two commits run this from
a checkout of each in turns (parent, change, parent, change, ...) inside one
session on one card, and compare medians against the spread of either side's
own runs.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch

from carle_tpu_torch.evaluation import eval as ev


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batched", type=int, default=4, help="batched runs")
    parser.add_argument("--sequential", type=int, default=2, help="sequential runs")
    args = parser.parse_args()
    ev.evaluate_fused_batched(steps=64, replicas=32, seed=0, verbose=False, device="cuda")
    torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0), "batched_s": [], "sequential_s": []}
    for _ in range(args.batched):
        t0 = time.perf_counter()
        ev.evaluate_fused_batched(steps=1024, replicas=32, seed=0, verbose=False,
                                  device="cuda")
        torch.cuda.synchronize()
        out["batched_s"].append(round(time.perf_counter() - t0, 4))
    for _ in range(args.sequential):
        t0 = time.perf_counter()
        ev.evaluate_fused(steps=1024, seed=0, verbose=False, device="cuda")
        torch.cuda.synchronize()
        out["sequential_s"].append(round(time.perf_counter() - t0, 4))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
