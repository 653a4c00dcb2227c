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
  formula's offset on the 64-bit seed), and its Philox counter runs over its
  padded block's rows, so a
  row recomputed as a neighbour's halo draws another mask than in its own
  slot, as in the JAX package; forward and backward of a slot agree.
* on a two-axis env x space mesh (``SpaceSharding(mesh, "space", "env")``)
  each env group's slots run as a ring of their own over the group's
  instances (parallel/mesh.py's ``ringwise``): halo rows never cross into
  another group, the row mask is built for the group's instances, the seed
  takes the env index as JAX's does, and the reconstruction error adds over
  ``space`` within a group and concatenates the groups in instance order.

* on a mesh spanning processes each process runs its own slots: a
  neighbour's halo rows of another process come by ``isend``/``irecv``
  (parallel/ghosts.py; differentiable, so a hidden layer's halo sends its
  cotangent back), and a ring's error sums are added over the processes
  holding it (``mesh.combine_rings``).

Inputs and outputs are :class:`~.mesh.RowShards` on the stack's mesh.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import nets
from ..nets import SpaceSharding
from ..ops import cuda_head, cuda_stages
from .mesh import RowShards, combine_rings, fill_meta, ringwise

SEED_STRIDE = 0x3779B1   # carle_tpu/parallel/spatial_heads.py::_shard_seed
ENV_STRIDE = 1013904223  # the same, the space index's factor with an env axis


def _words_as_int32(t: torch.Tensor) -> torch.Tensor:
    """Packed words as int32 (the same bits: PyTorch copies few uint32 ops)."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _halo_rows(x: RowShards, halo: int) -> List[Optional[torch.Tensor]]:
    """Each slot's [N, C, HL, W*] block padded with ``halo`` rows of each
    neighbour over the OPEN ring (one ring: a one-axis mesh's, or one env
    group's): zero rows past the universe's edges; another process's rows
    by parallel/ghosts.py, None for another process's slot."""
    parts, n = x.parts, len(x.parts)
    if halo > x.rows:
        raise ValueError(f"a halo of {halo} rows exceeds the {x.rows} rows a slot holds")
    from .ghosts import edge_rows_differentiable

    ghosts = edge_rows_differentiable(x, halo, wrap=False)

    def rows(j, edge, p):
        if x.is_local(j):
            q = _words_as_int32(parts[j])
            return (q[:, :, :halo] if edge == 0 else q[:, :, -halo:]).to(p.device)
        return _words_as_int32(ghosts[j, edge])

    out = []
    for s, p in enumerate(parts):
        if not x.is_local(s):
            out.append(None)
            continue
        q = _words_as_int32(p)
        zeros = q.new_zeros(q.shape[:2] + (halo,) + q.shape[3:])
        top = rows(s - 1, 1, p) if s > 0 else zeros
        bot = rows(s + 1, 0, p) if s < n - 1 else zeros
        padded = torch.cat([top, q, bot], dim=2)
        out.append(padded.view(torch.uint32) if p.dtype == torch.uint32 else padded)
    return out


def _int32(v: int) -> int:
    """``v`` wrapped to a signed 32-bit integer (int32 arithmetic)."""
    return (int(v) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _shard_seed(seed: int, s: int, e: Optional[int] = None) -> int:
    """Slot s's dropout seed in env group e (None: a one-axis mesh): the
    64-bit ``seed`` plus the slot's offset times SEED_STRIDE, modulo 2**64.
    The offset is carle_tpu/parallel/spatial_heads.py::_shard_seed's: the
    space index, on a two-axis mesh times ENV_STRIDE plus the env index (in
    int32 arithmetic, as there).  The seed keeps its 64 bits, where the JAX
    formula (and this one before) wraps the sum to int32: the kernels key
    Philox with both 32-bit words of the seed, so a wrap dropped the high
    word, and with it Prediction's and Surprise's stream bit (their masks
    became AE2D's) and all but the low bits of the run's seed (runs 128
    seeds apart drew the same masks), on a mesh only.  Slot 0 now draws what
    ``mesh=None`` draws.  JAX draws from another generator, so no mask is
    compared with its bit for bit."""
    off = s if e is None else _int32(s * ENV_STRIDE + e)
    return (int(seed) + off * SEED_STRIDE) % 2 ** 64


def _on(p: nets.Params, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return p["w"].to(device), p["b"].to(device)


def _check(sharding: SpaceSharding, x: RowShards) -> None:
    if not isinstance(x, RowShards):
        raise TypeError("SpaceSharding takes row-sharded inputs (parallel.mesh.RowShards), "
                        f"got {type(x)}")
    if (x.mesh is not sharding.mesh or x.axis != sharding.axis
            or x.env_axis != sharding.env_axis):
        raise ValueError("the input's shards are not on the SpaceSharding's mesh and axes")


def _by_ring(x: RowShards, sharding: SpaceSharding, fn) -> RowShards:
    """``fn(ring, env index or None)`` of each env group's ring."""
    env = sharding.env_axis is not None
    return ringwise(x, lambda ring, e: fn(ring, e if env else None))


def encoder_spatial(x: RowShards, p1: nets.Params, p2: nets.Params, *,
                    pools: Tuple[int, int], drop_p: float, train: bool,
                    seed: Optional[int], sharding: SpaceSharding) -> RowShards:
    """:func:`nets.conv_encoder` on a row-sharded observation [N, 1, H, W*]
    (uint8 cells or packed words): row-sharded [N, C2, H/(p1 p2), W/(p1 p2)]."""
    _check(sharding, x)
    prob, seed = nets._drop_args(drop_p, train, seed)

    def ring(r, e):
        out = []
        for s, block in enumerate(_encoder_blocks(r, pools)):
            if block is None:   # another process's slot
                out.append(None)
                continue
            xp, mask = block
            dev = xp.device
            y = cuda_head.encoder(xp, *_on(p1, dev), *_on(p2, dev), pools, prob,
                                  _shard_seed(seed, s, e), mask=mask)
            out.append(y[:, :, 1:-1])   # the halo's one output row a side
        return RowShards(fill_meta(out), r.mesh, r.axis)

    return _by_ring(x, sharding, ring)


def _encoder_blocks(x: RowShards, pools: Tuple[int, int]
                    ) -> List[Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Each slot's encoder input (of one ring): its block with ``p1 p2`` halo
    rows a side, and the stage-1 row mask [N, rows / p1] (N the ring's
    instances) that zeroes the pooled rows outside the universe; None for
    another process's slot."""
    pool1, pool2 = pools
    halo = pool1 * pool2
    if x.rows % halo:
        raise ValueError(f"a slot's {x.rows} rows are not a multiple of the pools {pools}")
    n_inst, h1_loc = x.parts[0].shape[0], x.rows // pool1
    h1 = h1_loc * len(x.parts)
    out = []
    for s, xp in enumerate(_halo_rows(x, halo)):
        if xp is None:
            out.append(None)
            continue
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

    def ring(r, e):
        out = []
        for s, xp in enumerate(_halo_rows(r, 1)):
            if xp is None:
                out.append(None)
                continue
            y = cuda_stages.tail(xp, *_on(p, xp.device), act, prob, _shard_seed(seed, s, e),
                                 stage)
            out.append(y[:, :, 2:-2])
        return RowShards(fill_meta(out), r.mesh, r.axis)

    return _by_ring(x, sharding, ring)


def loss_tail_spatial(x: RowShards, p: nets.Params, obs: RowShards, *, act: str,
                      drop_p: float, train: bool, seed: Optional[int], stage: int,
                      sharding: SpaceSharding) -> torch.Tensor:
    """The row-sharded reconstruction error: :func:`tail_spatial`, then each
    slot's ``sum((obs - y)**2)`` over C, H, W, added over a ring's slots on
    the mesh's home device, the env groups' sums concatenated in instance
    order ([N] float32).  obs: row-sharded uint8 cells or packed words."""
    _check(sharding, obs)
    y = tail_spatial(x, p, act=act, drop_p=drop_p, train=train, seed=seed, stage=stage,
                     sharding=sharding)
    totals = {}
    for e, (yr, obr) in enumerate(zip(y.rings(), obs.rings())):
        for i, (ys, os_) in enumerate(zip(yr.parts, obr.parts)):
            if not yr.is_local(i):
                continue
            err = ((cuda_head.cells(os_).to(torch.float32) - ys) ** 2).sum(dim=(1, 2, 3))
            err = err.to(x.mesh.home)
            totals[e] = err if e not in totals else totals[e] + err
    return combine_rings(y, totals)


__all__ = ["encoder_spatial", "loss_tail_spatial", "tail_spatial"]
