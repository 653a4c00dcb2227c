"""Pattern analytics: period/displacement classification, population curves,
episode reports and object censuses (counterpart of carle_tpu/analysis.py).

* :func:`classify_pattern` — the exact (period, displacement) of a pattern
  evolving in an empty universe: ``still-life`` (p=1, d=0), ``oscillator``
  (p>1, d=0), ``spaceship`` (d != 0), ``died``, or ``aperiodic`` within the
  search horizon.  A glider is a period-4 (1,1)-spaceship; a blinker a
  period-2 oscillator.
* :func:`population_curve` — per-generation live-cell counts, the raw
  series behind puffer/growth detection.
* :func:`episode_report`, :func:`extract_objects`, :func:`census` — what an
  agent built, from a logged episode or a universe.

The generations run through ``cuda_ca.ca_step`` with an empty 1x1 action
window (the ``ca_step_words`` kernel on the card for widths that are a
multiple of 16, every census box; the plain twin on the CPU).  Entry points
run on the card unless the caller passes ``device="cpu"`` (or a grid that
lies on the CPU).  Displacement search stays numpy on the host: FFT
cross-correlation proposes an offset and an exact comparison accepts it, so
a match is never heuristic.  The frames a classification reads are copied
from the device in chunks of 1, 2, 4, ... generations, and a census
classifies all objects of one box size in one batch: a chunk is one launch
a generation and one copy for all of them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .config import EnvConfig
from .device import DeviceLike, resolve_device
from .ops.cuda_ca import ca_step

# most bytes of frames a classification chunk holds on the device
_CHUNK_BYTES = 64 * 2**20


class Classification(NamedTuple):
    kind: str                 # still-life | oscillator | spaceship | died | aperiodic
    period: int               # 0 for died/aperiodic
    displacement: tuple       # (dy, dx) torus shift per period, (0, 0) unless spaceship
    population: int           # live cells at detection (0 when died)

    @property
    def speed(self) -> float:
        """Chebyshev speed in cells/generation (gliders: 0.25 = c/4)."""
        if self.period == 0:
            return 0.0
        return max(abs(self.displacement[0]), abs(self.displacement[1])) / self.period


def _device_of(grid: Any, device: DeviceLike) -> torch.device:
    """``device`` if given, else the grid's own if it is a tensor, else the card."""
    if device is None and torch.is_tensor(grid):
        return grid.device
    return resolve_device(device)


def _host(grid: Any) -> np.ndarray:
    return grid.cpu().numpy() if torch.is_tensor(grid) else np.asarray(grid)


def _stepper(n: int, h: int, w: int, rule_bits: Any,
             device: torch.device) -> Callable[[torch.Tensor], torch.Tensor]:
    """One generation of n bare [h, w] universes: ``ca_step`` with an empty
    1x1 action window (XOR with zero), the rule a device tensor made once."""
    cfg = EnvConfig(height=h, width=w, action_height=1 + h % 2, action_width=1 + w % 2,
                    instances=n).validate()
    blank = torch.zeros(cfg.action_shape, dtype=torch.uint8, device=device)
    rule = torch.as_tensor(rule_bits, dtype=torch.int32, device=device)
    return lambda g: ca_step(g, blank, rule, cfg)


def _find_shift(a: np.ndarray, b: np.ndarray,
                fa: Optional[np.ndarray] = None) -> Optional[tuple]:
    """The torus shift (dy, dx) with roll(a, (dy, dx)) == b, or None.

    FFT cross-correlation proposes the best-aligned offsets; an exact
    comparison accepts or rejects each (correlation alone can tie for
    symmetric patterns).  ``fa`` is ``rfft2(a)``, computed once across
    repeated probes."""
    if fa is None:
        fa = np.fft.rfft2(a.astype(np.float32))
    fb = np.fft.rfft2(b.astype(np.float32))
    corr = np.fft.irfft2(np.conj(fa) * fb, s=a.shape)
    peak = corr.max()  # all offsets sharing the peak (floating-point ties within 1e-3)
    for dy, dx in zip(*np.nonzero(corr >= peak - 1e-3)):
        if np.array_equal(np.roll(a, (dy, dx), axis=(0, 1)), b):
            return int(dy), int(dx)
    return None


def _signed(d: int, n: int) -> int:
    """A torus offset as the signed shift of smallest magnitude."""
    return d - n if d > n // 2 else d


def _classify_batch(g0: np.ndarray, rule_bits: Any, max_period: int,
                    device: torch.device) -> List[Classification]:
    """Classify each of n same-shaped universes g0 [n, H, W] (0/1) in
    isolation: the first generation 1..max_period at which it recurs up to
    translation.  Every universe evolves on its own torus, so a batch gives
    each the result it would get alone."""
    n, h, w = g0.shape
    pop0 = g0.reshape(n, -1).sum(axis=1).astype(np.int64)
    results: List[Optional[Classification]] = [
        Classification("died", 0, (0, 0), 0) if pop0[i] == 0 else None for i in range(n)]
    todo = [i for i in range(n) if results[i] is None]
    if not todo:
        return results
    ffts: Dict[int, np.ndarray] = {}
    last_pops = pop0.copy()   # generation 0's, if max_period is 0
    step = _stepper(n, h, w, rule_bits, device)
    g = torch.from_numpy(np.ascontiguousarray(g0)).to(device)
    most = max(1, _CHUNK_BYTES // (n * h * w))
    p, chunk = 0, 1
    while todo and p < max_period:
        c = min(chunk, max_period - p, most)
        frames = torch.empty((c, n, h, w), dtype=torch.uint8, device=device)
        for j in range(c):
            g = step(g)
            frames[j].copy_(g)
        host = frames.cpu().numpy()
        pops = host.reshape(c, n, -1).sum(axis=2)
        for j in range(c):
            gen = p + j + 1
            still = []
            for i in todo:
                if pops[j, i] == 0:
                    results[i] = Classification("died", 0, (0, 0), 0)
                    continue
                if pops[j, i] == pop0[i]:   # else it cannot be a translation of g0
                    if i not in ffts:
                        ffts[i] = np.fft.rfft2(g0[i].astype(np.float32))
                    shift = _find_shift(g0[i], host[j, i], fa=ffts[i])
                    if shift is not None:
                        dy, dx = _signed(shift[0], h), _signed(shift[1], w)
                        kind = (("still-life" if gen == 1 else "oscillator")
                                if (dy, dx) == (0, 0) else "spaceship")
                        results[i] = Classification(kind, gen, (dy, dx), int(pop0[i]))
                        continue
                still.append(i)
            todo = still
        last_pops = pops[-1]
        p += c
        chunk *= 2
    for i in todo:
        results[i] = Classification("aperiodic", 0, (0, 0), int(last_pops[i]))
    return results


def classify_pattern(grid: Any, rule_bits: Any, max_period: int = 64,
                     device: DeviceLike = None) -> Classification:
    """Classify a pattern's long-run behaviour in an empty universe.

    ``grid`` is a single [H, W] 0/1 array or tensor (place the pattern well
    clear of the torus seam if displacement signs matter); ``rule_bits`` an
    18-bit rule mask (``rules.pack_rule_bits``).  Searches generations
    1..``max_period`` for the first exact recurrence of the initial pattern
    up to translation."""
    g0 = _host(grid).astype(np.uint8)
    if g0.ndim != 2:
        raise ValueError(f"classify_pattern wants one [H, W] grid, got {g0.shape}")
    return _classify_batch(g0[None], rule_bits, max_period, _device_of(grid, device))[0]


def population_curve(grid: Any, rule_bits: Any, num_steps: int,
                     device: DeviceLike = None) -> np.ndarray:
    """Per-generation live-cell counts (generation 1..N): [num_steps] for a
    single [H, W] grid, [num_steps, inst] for a batch [inst, H, W].  The
    counts stay on the device and are copied once, at the end."""
    dev = _device_of(grid, device)
    g = grid if torch.is_tensor(grid) else torch.from_numpy(np.asarray(grid))
    g = g.to(device=dev, dtype=torch.uint8)
    single = g.ndim == 2
    if single:
        g = g[None]
    n, h, w = g.shape
    step = _stepper(n, h, w, rule_bits, dev)
    pops = torch.empty((int(num_steps), n), dtype=torch.int32, device=dev)
    g = g.contiguous()
    for t in range(int(num_steps)):
        g = step(g)
        torch.sum(g, dim=(1, 2), dtype=torch.int32, out=pops[t])
    out = pops.cpu().numpy()
    return out[:, 0] if single else out


def episode_report(log_path: str, rule_bits: Any = None, max_period: int = 32,
                   device: DeviceLike = None) -> dict:
    """Creativity report for a logged episode (the reference CSV format of
    (action_rle, universe_rle) pairs: ``CARLE.save_log``,
    ``Rollout.run_logged``).

    Step count, action budget (total/mean toggles: what ParsimonyBonus
    taxes), the population curve with a least-squares growth slope (what
    PufferDetector thresholds) and, with ``rule_bits``, the exact
    classification of the final universe's evolution."""
    from .rle import parse_rle_text, read_log

    pairs = read_log(log_path)
    if not pairs:
        return {"steps": 0}
    toggles, pops = [], []
    final = None
    for action_rle, universe_rle in pairs:
        toggles.append(int(parse_rle_text(action_rle).grid.sum()))
        final = parse_rle_text(universe_rle).grid
        pops.append(int(final.sum()))
    steps = len(pairs)
    slope = (float(np.polyfit(np.arange(steps), np.asarray(pops, np.float64), 1)[0])
             if steps >= 2 else 0.0)
    report = {
        "steps": steps,
        "total_toggles": int(np.sum(toggles)),
        "mean_toggles_per_step": float(np.mean(toggles)),
        "population": {
            "first": pops[0], "last": pops[-1],
            "mean": float(np.mean(pops)), "max": int(np.max(pops)),
            "growth_slope": slope,  # cells/step; PufferDetector fires > 0.01
        },
    }
    if rule_bits is not None and final is not None:
        c = classify_pattern(final, rule_bits, max_period=max_period, device=device)
        report["final_pattern"] = {
            "kind": c.kind, "period": c.period,
            "displacement": list(c.displacement), "speed": c.speed,
        }
    return report


def extract_objects(grid: Any) -> list:
    """8-connected components of a 0/1 grid, torus-aware (an object crossing
    the wraparound seam is ONE object).  Returns a list of [n_cells, 2]
    arrays of (row, col) coordinates UNWRAPPED relative to each object's
    bounding box (origin at its top-left), so seam-crossing objects come out
    contiguous."""
    g = _host(grid) != 0
    if g.ndim != 2:
        raise ValueError(f"extract_objects wants one [H, W] grid, got {g.shape}")
    h, w = g.shape
    seen = np.zeros_like(g, dtype=bool)
    objects = []
    for r, c in zip(*np.nonzero(g)):
        if seen[r, c]:
            continue
        seen[r, c] = True
        stack = [(r, c, 0, 0)]  # (torus row/col, unwrapped row/col)
        cells = []
        while stack:
            y, x, uy, ux = stack.pop()
            cells.append((uy, ux))
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy == 0 and dx == 0:
                        continue
                    ny, nx = (y + dy) % h, (x + dx) % w
                    if g[ny, nx] and not seen[ny, nx]:
                        seen[ny, nx] = True
                        stack.append((ny, nx, uy + dy, ux + dx))
        arr = np.asarray(cells, dtype=np.int64)
        arr -= arr.min(axis=0)  # origin at the bounding-box corner
        objects.append(arr)
    return objects


def _canonical_box(n: int) -> int:
    """A box extent rounded up to a power of two (>= 16).  The sizes are
    part of the result: a box's torus decides what a spaceship meets within
    the search horizon, so they match the JAX package's."""
    size = 16
    while size < n:
        size *= 2
    return size


def census(grid: Any, rule_bits: Any, max_period: int = 32, pad: int = 8,
           device: DeviceLike = None) -> dict:
    """Object census of a universe: every 8-connected object classified IN
    ISOLATION (standard soup-census methodology: nearby objects that would
    interact are still reported individually), the objects of one box size
    in one batch.

    Returns {"objects": [{kind, period, displacement, speed, population}],
    "counts": {kind: n}} sorted largest-object first."""
    dev = _device_of(grid, device)
    objs = extract_objects(grid)
    boxes: Dict[tuple, List[int]] = {}
    for i, cells in enumerate(objs):
        hh, ww = cells.max(axis=0) + 1
        shape = (_canonical_box(int(hh) + 2 * pad), _canonical_box(int(ww) + 2 * pad))
        boxes.setdefault(shape, []).append(i)
    found: Dict[int, Classification] = {}
    for (bh, bw), members in boxes.items():
        batch = np.zeros((len(members), bh, bw), dtype=np.uint8)
        for b, i in enumerate(members):
            batch[b, objs[i][:, 0] + pad, objs[i][:, 1] + pad] = 1
        for i, c in zip(members, _classify_batch(batch, rule_bits, max_period, dev)):
            found[i] = c
    results = [{
        "kind": found[i].kind, "period": found[i].period,
        "displacement": list(found[i].displacement), "speed": found[i].speed,
        "population": int(len(cells)),
    } for i, cells in enumerate(objs)]
    results.sort(key=lambda o: -o["population"])
    counts: dict = {}
    for o in results:
        counts[o["kind"]] = counts.get(o["kind"], 0) + 1
    return {"objects": results, "counts": counts}


def _main(argv: Optional[List[str]] = None) -> int:
    """CLI: classify a pattern file, census a universe, or report an episode.

        python -m carle_tpu_torch.analysis pattern.rle [--rule B3/S23] [--device cpu]
        python -m carle_tpu_torch.analysis universe.rle --census
        python -m carle_tpu_torch.analysis episode_log.csv --report
    """
    import argparse
    import json

    from . import rules as rules_mod
    from .rle import read_rle

    parser = argparse.ArgumentParser(description=_main.__doc__)
    parser.add_argument("path", help=".rle pattern/universe or episode CSV")
    parser.add_argument("--rule", default=None,
                        help="B/S rulestring (default: the file's header rule, or B3/S23)")
    parser.add_argument("--census", action="store_true",
                        help="per-object census instead of whole-pattern classification")
    parser.add_argument("--report", action="store_true",
                        help="treat path as an episode-log CSV")
    parser.add_argument("--max-period", type=int, default=64)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.report:
        bits = (rules_mod.pack_rule_bits(*rules_mod.parse_rulestring(args.rule))
                if args.rule else rules_mod.LIFE)
        print(json.dumps(episode_report(args.path, bits, max_period=args.max_period,
                                        device=device)))
        return 0

    pat = read_rle(args.path)
    birth, survive = ((pat.birth, pat.survive) if args.rule is None
                      else rules_mod.parse_rulestring(args.rule))
    bits = rules_mod.pack_rule_bits(birth, survive)
    if args.census:
        print(json.dumps({"rule": rules_mod.rulestring(birth, survive),
                          **census(pat.grid, bits, max_period=args.max_period,
                                   device=device)}))
        return 0
    pad = 8
    box = np.zeros((_canonical_box(pat.grid.shape[0] + 2 * pad),
                    _canonical_box(pat.grid.shape[1] + 2 * pad)), np.uint8)
    box[pad:pad + pat.grid.shape[0], pad:pad + pat.grid.shape[1]] = pat.grid
    c = classify_pattern(box, bits, max_period=args.max_period, device=device)
    print(json.dumps({
        "rule": rules_mod.rulestring(birth, survive),
        "kind": c.kind, "period": c.period,
        "displacement": list(c.displacement), "speed": c.speed,
        "population": c.population,
    }))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
