"""Soup search with carle_tpu_torch: evolve random soups on the packed engine,
census the ash (counterpart of scripts/soup_search.py).

Start from random noise, let the rule run, and catalogue what survives: the
packed engine (``bit_multi_step``, one launch for the whole batch on the
card) evolves the soups, then ``analysis.census`` classifies every object of
each final universe (the ``ca_step`` kernel on the card) — object counts by
kind, ash density and the "notable" objects (spaceships, or oscillators of
period > 2).  The soups are drawn from a torch generator seeded by --seed.

    python scripts/soup_search_torch.py --soups 64 --size 256 --steps 1024
    python scripts/soup_search_torch.py --rule B36/S245 --density 0.1
    python scripts/soup_search_torch.py --quick --device cpu   # smoke

One JSON line per soup (counts + notables) and a final aggregate line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--soups", type=int, default=64)
    parser.add_argument("--size", type=int, default=256,
                        help="universe side, a multiple of 32 (the packed engine's words)")
    parser.add_argument("--steps", type=int, default=1024)
    parser.add_argument("--rule", default="B3/S23")
    parser.add_argument("--density", type=float, default=0.3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-period", type=int, default=16,
                        help="census search horizon per object")
    parser.add_argument("--quick", action="store_true",
                        help="tiny smoke config (8 soups, 64^2, 64 steps)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.quick:
        args.soups, args.size, args.steps = 8, 64, 64
    if args.size % 32:
        parser.error(f"--size {args.size} is not a multiple of 32")

    import torch

    from carle_tpu_torch import rules as rules_mod
    from carle_tpu_torch.analysis import census
    from carle_tpu_torch.device import resolve_device
    from carle_tpu_torch.ops.bitpack import pack_grid, unpack_grid
    from carle_tpu_torch.ops.cuda_bitpack import bit_multi_step

    device = resolve_device(args.device)
    birth, survive = rules_mod.parse_rulestring(args.rule)
    bits = rules_mod.pack_rule_bits(birth, survive)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    grids = (torch.rand((args.soups, args.size, args.size), generator=gen, device=device)
             < args.density).to(torch.uint8)
    out = bit_multi_step(pack_grid(grids), bits, args.steps)
    finals = unpack_grid(out, args.size).cpu().numpy()

    area = args.size * args.size
    totals: dict = {}
    notable_total = 0
    for i, final in enumerate(finals):
        rep = census(final, bits, max_period=args.max_period, device=device)
        notables = [o for o in rep["objects"]
                    if o["kind"] == "spaceship"
                    or (o["kind"] == "oscillator" and o["period"] > 2)]
        notable_total += len(notables)
        for k, n in rep["counts"].items():
            totals[k] = totals.get(k, 0) + n
        print(json.dumps({
            "soup": i,
            "ash_density": round(float(final.sum()) / area, 5),
            "counts": rep["counts"],
            "notable": notables[:8],
        }), flush=True)

    print(json.dumps({
        "soup_search": {
            "rule": rules_mod.rulestring(birth, survive),
            "soups": args.soups, "size": args.size, "steps": args.steps,
            "object_counts": totals,
            "notable_objects": notable_total,
        }
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
