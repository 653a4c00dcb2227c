"""Packed-native statistic wrappers: popcounts instead of cell unpacking
(counterpart of carle_tpu/mcl/packed_stats.py).

Speed, Puffer and Corner consume only reductions of the universe (live
counts, index-weighted sums, masked sums).  On the packed stack
(parallel/packed_env.py) those come straight from the uint32 words with a
SWAR popcount (``ops.bitpack.popcount``), and the float32 cell observation is
never built:

* live count          = popcount(g)
* masked count        = popcount(g & mask_words)
* row-weighted sum    = sum_r r * rowcount_r
* column-weighted sum = 32 * sum_w w * popcount(word_w)
                        + sum_k 2^k * popcount(g & M_k)
  where M_k has bit b set iff bit k of b is set (M_0 = 0xAAAAAAAA, ...,
  M_4 = 0xFFFF0000): the bit index's binary expansion.

The popcounts are integer-exact; the float32 weighted sums are exact while
count x index < 2^24 (through ~4096² universes) and correctly rounded above,
never worse than the dense float32 path, which sums the same magnitudes cell
by cell.  Morpho's pattern correlation is exact integer arithmetic on bit
planes (ops/bitsliced.py); Prediction and Surprise keep a ring of packed
frames and their nets read the words (``_online.net_input``).  When every
wrapper of a packed stack is packed-native, a step unpacks nothing (the
stack's ``unpacks`` counter stays 0).

On a row-sharded packed stack (a mesh) each statistic reduces every shard,
the row-weighted sums from the shard's first global row, and adds the
shards' exact integer sums over a ring, so the bonus does not depend on the
sharding; on a two-axis env x space mesh the env groups' sums are
concatenated in instance order.  Morpho's windows cross the shards' edges:
each slot pads its rows of ``prev ^ action`` with the first ``dim - 1``
rows of the next slot of its ring, takes the per-instance integer extremes
over its own VALID anchors, and the slots' extremes combine by max and min
before the one float division, so the bonus equals the unsharded one bit
for bit.  These defs need a packed stack: on the uint8 path ``ctx.packed``
is None and they raise.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from ..config import EnvConfig
from ..ops import bitsliced as bs
from ..ops.bitpack import WORD, pack_grid, popcount
from ..parallel.mesh import RowShards, combine_rings
from .base import StepCtx, WrapperDef, default_on_reset
from .corner import _build_masks
from .speed import speed_bonus

_BIT_MASKS = tuple(
    int(sum(1 << b for b in range(WORD) if (b >> k) & 1))
    for k in range(5)  # 0xAAAAAAAA, 0xCCCCCCCC, 0xF0F0F0F0, 0xFF00FF00, 0xFFFF0000
)


def _pack_mask(mask: np.ndarray, device) -> torch.Tensor:
    """bool/0-1 [H, W] -> uint32 [H, W/32] (pack_grid's layout)."""
    return pack_grid(torch.from_numpy(np.asarray(mask) != 0)[None].to(torch.uint8))[0].to(device)


def _require_packed(ctx: StepCtx) -> Any:
    if ctx.packed is None:
        raise ValueError(
            "packed-native stat wrappers need a packed stack "
            "(parallel/packed_env.PackedSpatialStack): ctx.packed is None "
            "on the uint8 path; use the dense defs there")
    if isinstance(ctx.packed, RowShards):
        return ctx.packed.map(bs.as_plane)
    return bs.as_plane(ctx.packed)


def _per_shard(g: Any, fn, *planes: torch.Tensor) -> torch.Tensor:
    """``fn(words, *plane rows, first row)`` of the universe ([..., inst]):
    of each shard of row-sharded words with its rows of each [H, W/32]
    plane, added over each ring's slots on the mesh's home device, the env
    groups' sums concatenated over the instances in order; or of whole
    words.  fn returns exact integers, so the sum does not depend on the
    sharding.  On a mesh spanning processes: this process's instances, a
    ring's sums added over the processes holding it (``combine_rings``)."""
    if not isinstance(g, RowShards):
        return fn(g, *planes, 0)
    totals = {}
    for e, ring in enumerate(g.rings()):
        for i, (p, a) in enumerate(zip(ring.parts, ring.offsets())):
            if not ring.is_local(i):
                continue
            part = fn(p, *(m[a:a + ring.rows].to(p.device) for m in planes), a).to(g.device)
            totals[e] = part if e not in totals else totals[e] + part
    return combine_rings(g, totals, dim=-1)


def _live_count_i(g: torch.Tensor, r0: int = 0) -> torch.Tensor:
    """Live cells per instance: [inst, H, W/32] -> int64 [inst]."""
    return popcount(g).sum(dim=(1, 2))


def _row_weighted_i(g: torch.Tensor, r0: int = 0) -> torch.Tensor:
    """sum over live cells of the row index (the first row is ``r0``), per
    instance, exact (int64 [inst])."""
    rows = popcount(g).sum(dim=2)                               # [inst, H]
    r = torch.arange(r0, r0 + g.shape[1], dtype=torch.int64, device=g.device)
    return (rows * r[None, :]).sum(dim=1)


def _col_weighted_i(g: torch.Tensor, r0: int = 0) -> torch.Tensor:
    """sum over live cells of the column index, per instance, exact (int64
    [inst])."""
    words = popcount(g).sum(dim=1)                              # [inst, W/32]
    w = WORD * torch.arange(g.shape[2], dtype=torch.int64, device=g.device)
    total = (words * w[None, :]).sum(dim=1)
    for k, m in enumerate(_BIT_MASKS):
        total = total + (1 << k) * popcount(g & m).sum(dim=(1, 2))
    return total


def _live_count(g: Any) -> torch.Tensor:
    """Live cells per instance, integer-exact, as float32 [inst] (whole or
    row-sharded words)."""
    return _per_shard(g, _live_count_i).to(torch.float32)


def _masked_count(g: Any, mask: torch.Tensor) -> torch.Tensor:
    """Live cells inside the [H, W/32] mask words per instance (float32)."""
    return _per_shard(g, lambda p, m, r0: _live_count_i(p & m[None]), mask).to(torch.float32)


class PackedSpeedState(NamedTuple):
    reward_scale: torch.Tensor    # float32 scalar
    center_of_mass: torch.Tensor  # float32 [2, instances]
    has_com: torch.Tensor         # bool scalar
    excl_words: torch.Tensor      # uint32 [H, W/32]: the action window's complement


def speed_def_packed(config: EnvConfig, reward_scale: float = 1.0,
                     per_instance: bool = False, **kwargs: Any) -> WrapperDef:
    """SpeedDetector on packed words (the semantics of mcl/speed.py: centre
    of mass numerators masked to outside the action window, unmasked
    denominator, the first step only records)."""
    excl = np.ones((config.height, config.width), dtype=np.uint8)
    r0, c0 = config.action_row_offset, config.action_col_offset
    excl[r0:r0 + config.eff_action_height, c0:c0 + config.eff_action_width] = 0

    def init(generator: Any, device) -> PackedSpeedState:
        return PackedSpeedState(
            reward_scale=torch.as_tensor(reward_scale, dtype=torch.float32, device=device),
            center_of_mass=torch.zeros((2, config.instances), dtype=torch.float32,
                                       device=device),
            has_com=torch.zeros((), dtype=torch.bool, device=device),
            excl_words=_pack_mask(excl, device))

    def apply(state: PackedSpeedState, ctx: StepCtx,
              reward: torch.Tensor) -> Tuple[PackedSpeedState, torch.Tensor]:
        g = _require_packed(ctx)

        def sums(p, excl, r0):   # unmasked denominator, masked numerators
            mp = p & excl[None]
            return torch.stack([_live_count_i(p), _row_weighted_i(mp, r0), _col_weighted_i(mp)])

        live, rows, cols = _per_shard(g, sums, bs.as_plane(state.excl_words)).to(torch.float32)
        com = torch.stack([rows / (live + 1e-7), cols / (live + 1e-7)])
        speed, com = speed_bonus(state.center_of_mass, com, ctx, per_instance)
        new_reward = torch.where(state.has_com, reward + speed, reward)
        return state._replace(center_of_mass=com,
                              has_com=torch.ones_like(state.has_com)), new_reward

    return WrapperDef(name="SpeedDetector(packed)", init=init, apply=apply,
                      on_reset=default_on_reset)


def puffer_def_packed(config: EnvConfig, reward_scale: float = 1.0,
                      growth_threshold: int = 512, per_instance: bool = False,
                      **kwargs: Any) -> WrapperDef:
    """PufferDetector on packed words: the live count feeding the window comes
    from popcounts; the window, slope and toggle-clear semantics are
    mcl/puffer.py's (its ``cells_fn`` hook)."""
    from .puffer import puffer_def

    dense = puffer_def(config, reward_scale, per_instance,
                       cells_fn=lambda ctx: _live_count(_require_packed(ctx)),
                       growth_threshold=growth_threshold)
    return dense._replace(name="PufferDetector(packed)")


def parsimony_def_packed(**kwargs: Any) -> WrapperDef:
    """ParsimonyBonus is packed-native already: it reads only
    ``ctx.action_sum``, never a cell view.  Here under the packed name for
    code that builds stacks."""
    from .parsimony import parsimony_def

    return parsimony_def(**kwargs)._replace(name="ParsimonyBonus(packed)")


class PackedMorphoState(NamedTuple):
    reward_scale: torch.Tensor  # float32 scalar
    valid_words: torch.Tensor   # uint32 [H, W/32]: the VALID correlation anchors


def morpho_def_packed(config: EnvConfig, reward_scale: float = 1.0, rle_paths: Any = (),
                      dim: int = 8, seed_rate: float = 0.005, **kwargs: Any) -> WrapperDef:
    """MorphoBonus on packed words: the pattern correlation as bit-sliced
    window counts (ops/bitsliced.py), no cell unpack.

    Each kernel has n live cells of weight ``15/n`` and -1 elsewhere on its
    ``dim x dim`` canvas; the bonus is max + min over kernels and VALID
    positions of its correlation with ``|universe - action|``, which for
    binary cells is ``universe XOR action``.  The response is
    ``(w + 1) N_live - N_all`` (N_all the window's live count, N_live the
    count at the kernel's live offsets); times n it is the integer
    ``g = (15 + n) N_live - n N_all``, computed bit-sliced with an offset
    that keeps it non-negative, its per-instance max and min found MSB first,
    and divided by n once per kernel.  Exact where the dense def's float32
    correlation rounds.  On a row-sharded stack each slot works on its own
    rows with the next slot's first ``dim - 1`` below (the module note), so
    a slot must hold at least ``dim - 1`` rows.  A reset seeds the dense
    def's nucleation noise."""
    from .morpho import build_kernel_bank, morpho_def
    from .patterns import pattern_path

    if not rle_paths:
        rle_paths = (pattern_path("glider_1"), pattern_path("glider_2"))
    bank = build_kernel_bank(rle_paths, dim)[:, 0]  # [K, dim, dim]
    kernels = [tuple((int(r), int(c)) for r, c in np.argwhere(k > 0)) for k in bank]
    win = dim * dim
    valid = np.zeros((config.height, config.width), dtype=np.uint8)
    valid[: config.height - dim + 1, : config.width - dim + 1] = 1

    def init(generator: Any, device) -> PackedMorphoState:
        return PackedMorphoState(
            reward_scale=torch.as_tensor(reward_scale, dtype=torch.float32, device=device),
            valid_words=_pack_mask(valid, device))

    def extremes(x: torch.Tensor, valid_words: torch.Tensor, rows: int):
        """Per kernel, the per-instance (max, min) integers over the VALID
        anchors among x's first ``rows`` rows (x may hold ``dim - 1`` rows
        more, which the anchors' windows read): of g, or of N_all for an
        all-dead kernel."""
        crop = lambda num: tuple(q[:, :rows] for q in num)
        n_all = bs.window_sum(x, dim, dim)       # shared by every kernel
        n_all_rows = crop(n_all)
        out = []
        for offsets in kernels:
            n = len(offsets)
            if n == 0:  # an all-dead kernel: the response is -N_all exactly
                num = n_all_rows
            else:
                width = int((15 + n) * n + n * win).bit_length()
                num = bs.sub_offset(bs.mul_const(crop(bs.tap_sum(x, offsets)), 15 + n, width),
                                    bs.mul_const(n_all_rows, n, width), n * win, width)
            out.append((bs.max_over_cells(num, valid_words),
                        bs.min_over_cells(num, valid_words)))
        return out

    def sharded_extremes(prev: RowShards, action: RowShards, valid_words: torch.Tensor):
        """:func:`extremes` of row-sharded ``prev ^ action``: each slot's rows
        padded below with the next slot's first ``dim - 1`` rows of its ring
        (below the universe's last row the ring's wrap, read by no VALID
        anchor), a slot without a VALID anchor skipped; the padded slots of
        a device (of every ring) stacked as one batch, so that a card runs
        the bit-sliced operations once; the slots' extremes combined by max
        and min over each ring and the env groups' concatenated in instance
        order."""
        if prev.rows < dim - 1:
            raise ValueError(f"morpho_def_packed on shards of {prev.rows} rows a slot: a "
                             f"window of {dim} rows needs at least dim - 1 = {dim - 1}")
        if prev.mesh.multi:
            raise NotImplementedError("morpho_def_packed on a mesh spanning processes is not "
                                      "ported (its window rows and max/min across processes)")
        home, rows, k = prev.device, prev.rows, prev.parts[0].shape[0]
        batches = {}   # device -> [(ring, padded slot, its VALID anchors)]
        for e, (ring, act) in enumerate(zip(prev.rings(), action.rings())):
            xs = [bs.as_plane(p) ^ bs.as_plane(q) for p, q in zip(ring.parts, act.parts)]
            for s, (x, a) in enumerate(zip(xs, ring.offsets())):
                if valid[a:a + rows].any():
                    below = xs[(s + 1) % len(xs)][:, :dim - 1].to(x.device)
                    batches.setdefault(x.device, []).append(
                        (e, torch.cat([x, below], dim=1),
                         valid_words[a:a + rows].to(x.device).expand(k, -1, -1)))
        acc = [None] * prev.groups   # per ring, per kernel (max, min) [k]
        for items in batches.values():
            ext = extremes(torch.cat([x for _, x, _ in items]),
                           torch.cat([v for _, _, v in items]), rows)
            for e in sorted({e for e, _, _ in items}):
                idx = torch.tensor([j for j, it in enumerate(items) if it[0] == e])
                got = [(hi.view(-1, k)[idx.to(hi.device)].amax(0).to(home),
                        lo.view(-1, k)[idx.to(lo.device)].amin(0).to(home)) for hi, lo in ext]
                acc[e] = got if acc[e] is None else [
                    (torch.maximum(h0, h1), torch.minimum(l0, l1))
                    for (h0, l0), (h1, l1) in zip(acc[e], got)]
        return [tuple(torch.cat(v) for v in zip(*per_kernel)) for per_kernel in zip(*acc)]

    def apply(state: PackedMorphoState, ctx: StepCtx,
              reward: torch.Tensor) -> Tuple[PackedMorphoState, torch.Tensor]:
        if ctx.packed_prev is None or ctx.packed_action is None:
            raise ValueError("morpho_def_packed needs a packed stack filling "
                             "ctx.packed_prev and ctx.packed_action; use "
                             "mcl.morpho.morpho_def on the uint8 path")
        valid_words = bs.as_plane(state.valid_words)
        if isinstance(ctx.packed_prev, RowShards):
            ext = sharded_extremes(ctx.packed_prev, ctx.packed_action, valid_words)
        else:
            x = bs.as_plane(ctx.packed_prev) ^ bs.as_plane(ctx.packed_action)
            ext = extremes(x, valid_words, x.shape[1])
        best_max = best_min = None
        for offsets, (hi, lo) in zip(kernels, ext):
            n = len(offsets)
            if n == 0:
                fmax, fmin = -lo.to(torch.float32), -hi.to(torch.float32)
            else:
                fmax = (hi - n * win).to(torch.float32) / n
                fmin = (lo - n * win).to(torch.float32) / n
            best_max = fmax if best_max is None else torch.maximum(best_max, fmax)
            best_min = fmin if best_min is None else torch.minimum(best_min, fmin)
        bonus = (best_max + best_min)[:, None]
        return state, reward + state.reward_scale * bonus

    dense = morpho_def(config, reward_scale, rle_paths, dim, seed_rate)
    return WrapperDef(name="MorphoBonus(packed)", init=init, apply=apply,
                      on_reset=dense.on_reset)


def prediction_def_packed(config: EnvConfig, **kwargs: Any) -> WrapperDef:
    """PredictionBonus with a packed frame ring ([inst, K, H, W/32] uint32):
    the ring stores ``ctx.packed`` as it is, and the autoencoder kernels read
    both the source frame and the target as words."""
    from .prediction import prediction_def

    return prediction_def(config, buffer_dtype="packed", **kwargs)._replace(
        name="PredictionBonus(packed)")


def surprise_def_packed(config: EnvConfig, **kwargs: Any) -> WrapperDef:
    """SurpriseBonus on the packed frame ring (see :func:`prediction_def_packed`)."""
    from .prediction import surprise_def

    return surprise_def(config, buffer_dtype="packed", **kwargs)._replace(
        name="SurpriseBonus(packed)")


class PackedCornerState(NamedTuple):
    reward_scale: torch.Tensor  # float32 scalar
    plus_words: torch.Tensor    # uint32 [H, W/32]
    minus_words: torch.Tensor   # uint32 [H, W/32]


def corner_def_packed(config: EnvConfig, reward_scale: float = 1.0,
                      **kwargs: Any) -> WrapperDef:
    """CornerBonus on packed words: popcount(g & plus) - popcount(g & minus),
    integer-exact (the mask's values are +1, 0, -1)."""
    mask = _build_masks(config.height, config.width)

    def init(generator: Any, device) -> PackedCornerState:
        return PackedCornerState(
            reward_scale=torch.as_tensor(reward_scale, dtype=torch.float32, device=device),
            plus_words=_pack_mask(mask > 0, device), minus_words=_pack_mask(mask < 0, device))

    def apply(state: PackedCornerState, ctx: StepCtx,
              reward: torch.Tensor) -> Tuple[PackedCornerState, torch.Tensor]:
        g = _require_packed(ctx)
        bonus = (_masked_count(g, bs.as_plane(state.plus_words))
                 - _masked_count(g, bs.as_plane(state.minus_words)))[:, None]
        return state, reward + state.reward_scale * bonus

    return WrapperDef(name="CornerBonus(packed)", init=init, apply=apply,
                      on_reset=default_on_reset)


__all__ = ["corner_def_packed", "morpho_def_packed", "parsimony_def_packed",
           "prediction_def_packed", "puffer_def_packed", "speed_def_packed",
           "surprise_def_packed"]
