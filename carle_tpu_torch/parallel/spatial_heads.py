"""The fused wrapper-net kernels on row-sharded observations (counterpart of
carle_tpu/parallel/spatial_heads.py).

With ``fused_head=nets.SpaceSharding(mesh)`` a learned wrapper on a
row-sharded packed stack runs its kernels slot by slot, each on its slot's
device, with halo rows sized to the kernel's receptive field:

* halo rows come over an OPEN ring (no wraparound): the first and last slots
  get zero rows past the universe's edges, which is the zero-padded
  convolution's edge.  (The CA's ring wraps: parallel/cuda_halo.py; the two
  share no helper.)
* the two-stage encoder (rows 3c/3d of PERF.md's kernel table, the
  row-masked encoder kernels) takes ``p1 p2`` input rows of halo a side
  (stage 2's one pooled row = p1 input rows, plus stage 1's one row, rounded
  to the pooling grid so the padded block's windows stay on the global grid)
  and crops one output row a side; a stage-1 row mask zeroes the pooled rows
  outside the universe, where the global function pads stage 2 with zeros
  and a zero halo would give relu(b1);
* the decoder stage (``tail.cu``) takes one input row of halo a side and
  crops two output rows a side; the reconstruction error sums each slot's
  rows and adds the slots' sums.
* halo slices and outputs move between slots with ``.to(device)`` (on one
  card, a no-op), the parameters are moved to each slot likewise, and
  autograd sums the parameter gradients over the slots, as the JAX
  shard_map's transpose does; cropped halo outputs get zero cotangents.
* dropout: each slot draws with its own seed (``_shard_seed``, the JAX
  formula), and its Philox counter runs over its padded block's rows, so a
  row recomputed as a neighbour's halo draws another mask than in its own
  slot, as in the JAX package; forward and backward of a slot agree.

Inputs and outputs are :class:`~.mesh.RowShards` on the stack's mesh.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import nets
from ..nets import SpaceSharding
from ..ops import cuda_head, cuda_stages
from .mesh import RowShards

SEED_STRIDE = 0x3779B1   # carle_tpu/parallel/spatial_heads.py::_shard_seed


def _words_as_int32(t: torch.Tensor) -> torch.Tensor:
    """Packed words as int32 (the same bits: PyTorch copies few uint32 ops)."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _halo_rows(x: RowShards, halo: int) -> List[torch.Tensor]:
    """Each slot's [N, C, HL, W*] block padded with ``halo`` rows of each
    neighbour over the OPEN ring: zero rows past the universe's edges."""
    parts, n = x.parts, len(x.parts)
    if halo > x.rows:
        raise ValueError(f"a halo of {halo} rows exceeds the {x.rows} rows a slot holds")
    out = []
    for s, p in enumerate(parts):
        q = _words_as_int32(p)
        zeros = q.new_zeros(q.shape[:2] + (halo,) + q.shape[3:])
        top = _words_as_int32(parts[s - 1])[:, :, -halo:].to(p.device) if s > 0 else zeros
        bot = _words_as_int32(parts[s + 1])[:, :, :halo].to(p.device) if s < n - 1 else zeros
        padded = torch.cat([top, q, bot], dim=2)
        out.append(padded.view(torch.uint32) if p.dtype == torch.uint32 else padded)
    return out


def _shard_seed(seed: int, s: int) -> int:
    """Slot s's dropout seed: carle_tpu/parallel/spatial_heads.py::_shard_seed
    on the space axis (the env axis waits with the 2-D mesh)."""
    return int(seed) + s * SEED_STRIDE


def _on(p: nets.Params, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return p["w"].to(device), p["b"].to(device)


def _check(sharding: SpaceSharding, x: RowShards) -> None:
    if not isinstance(x, RowShards):
        raise TypeError("SpaceSharding takes row-sharded inputs (parallel.mesh.RowShards), "
                        f"got {type(x)}")
    if x.mesh is not sharding.mesh or x.axis != sharding.axis:
        raise ValueError("the input's shards are not on the SpaceSharding's mesh and axis")


def encoder_spatial(x: RowShards, p1: nets.Params, p2: nets.Params, *,
                    pools: Tuple[int, int], drop_p: float, train: bool,
                    seed: Optional[int], sharding: SpaceSharding) -> RowShards:
    """:func:`nets.conv_encoder` on a row-sharded observation [N, 1, H, W*]
    (uint8 cells or packed words): row-sharded [N, C2, H/(p1 p2), W/(p1 p2)]."""
    _check(sharding, x)
    prob, seed = nets._drop_args(drop_p, train, seed)
    out = []
    for s, (xp, mask) in enumerate(_encoder_blocks(x, pools)):
        dev = xp.device
        y = cuda_head.encoder(xp, *_on(p1, dev), *_on(p2, dev), pools, prob,
                              _shard_seed(seed, s), mask=mask)
        out.append(y[:, :, 1:-1])   # the halo's one output row a side
    return RowShards(out, x.mesh, x.axis)


def _encoder_blocks(x: RowShards, pools: Tuple[int, int]
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each slot's encoder input: its block with ``p1 p2`` halo rows a side,
    and the stage-1 row mask [N, rows / p1] that zeroes the pooled rows
    outside the universe."""
    pool1, pool2 = pools
    halo = pool1 * pool2
    if x.rows % halo:
        raise ValueError(f"a slot's {x.rows} rows are not a multiple of the pools {pools}")
    n_inst, h1_loc = x.parts[0].shape[0], x.rows // pool1
    h1 = h1_loc * len(x.parts)
    out = []
    for s, xp in enumerate(_halo_rows(x, halo)):
        rows = torch.arange(xp.shape[2] // pool1, device=xp.device) + s * h1_loc - halo // pool1
        mask = ((rows >= 0) & (rows < h1)).to(torch.float32)[None].expand(n_inst, -1)
        out.append((xp, mask.contiguous()))
    return out


def tail_spatial(x: RowShards, p: nets.Params, *, act: str, drop_p: float, train: bool,
                 seed: Optional[int], stage: int, sharding: SpaceSharding) -> RowShards:
    """:func:`nets.conv_tail` (deconv s2 k4 p1, dropout, act) on a
    row-sharded input: one input row of halo a side, two output rows cropped."""
    _check(sharding, x)
    prob, seed = nets._drop_args(drop_p, train, seed)
    out = []
    for s, xp in enumerate(_halo_rows(x, 1)):
        y = cuda_stages.tail(xp, *_on(p, xp.device), act, prob, _shard_seed(seed, s), stage)
        out.append(y[:, :, 2:-2])
    return RowShards(out, x.mesh, x.axis)


def loss_tail_spatial(x: RowShards, p: nets.Params, obs: RowShards, *, act: str,
                      drop_p: float, train: bool, seed: Optional[int], stage: int,
                      sharding: SpaceSharding) -> torch.Tensor:
    """The row-sharded reconstruction error: :func:`tail_spatial`, then each
    slot's ``sum((obs - y)**2)`` over C, H, W, added on the mesh's home
    device ([N] float32).  obs: row-sharded uint8 cells or packed words."""
    _check(sharding, obs)
    y = tail_spatial(x, p, act=act, drop_p=drop_p, train=train, seed=seed, stage=stage,
                     sharding=sharding)
    total = None
    for ys, os_ in zip(y.parts, obs.parts):
        err = ((cuda_head.cells(os_).to(torch.float32) - ys) ** 2).sum(dim=(1, 2, 3))
        err = err.to(x.mesh.home)
        total = err if total is None else total + err
    return total


__all__ = ["encoder_spatial", "loss_tail_spatial", "tail_spatial"]
