"""Ghost rows across processes: the edge rows of a ring's slots that live in
another process, traded point to point (parallel/distributed.py's
``exchange``).

A slot reads ``k`` rows of each ring neighbour: the last rows of the slot
above, the first rows of the slot below (``wrap``: the ring wraps, the
CA's torus; without it the first and last slots have no neighbour past the
universe's edge, the nets' open ring).  Where the neighbour is another
process's, its owner sends them: slot j's first rows go to the owner of
slot j - 1 and its last rows to the owner of slot j + 1, a message each,
tagged ``2 j + edge`` (0 first rows, 1 last).  Both sides list the
messages in the order of (j, edge), receives posted before sends.

:func:`edge_rows` gives the received rows, keyed (slot, edge);
:func:`edge_rows_differentiable` the same as an autograd function, whose
backward sends each received block's cotangent back to the slot it came
from and adds it into that slot's rows (the nets' halo on a hidden layer).
That backward communicates inside autograd's backward, which runs one
thread a card: under a group a process's slots lie on one card
(``distributed.initialize`` refuses more), so every process issues these
messages in the same order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import RowShards

Key = Tuple[int, int]   # (slot, edge): edge 0 the slot's first rows, 1 its last


def _neighbours(n: int, s: int, wrap: bool) -> Tuple[Optional[int], Optional[int]]:
    north = (s - 1) % n if wrap or s > 0 else None
    south = (s + 1) % n if wrap or s < n - 1 else None
    return north, south


def plan(x: RowShards, wrap: bool) -> Tuple[List[Tuple[Key, int]], List[Tuple[Key, int, int]]]:
    """(sends, receives) of one ring: sends ((slot, edge), peer rank) of this
    process's slots; receives ((slot, edge), peer rank, the local slot that
    reads them)."""
    owners, me, n = x.mesh.owners, x.mesh.rank, len(x.parts)
    sends, recvs = [], []
    for j in range(n):
        north, south = _neighbours(n, j, wrap)
        for edge, reader in ((0, north), (1, south)):
            if reader is None or owners[reader] == owners[j]:
                continue
            if owners[j] == me:
                sends.append(((j, edge), owners[reader]))
            elif owners[reader] == me:
                recvs.append(((j, edge), owners[j], reader))
    return sends, recvs


def _edge(p: torch.Tensor, edge: int, k: int) -> torch.Tensor:
    return p.narrow(-2, 0 if edge == 0 else p.shape[-2] - k, k)


def _recv_spec(x: RowShards, key: Key, peer: int, reader: int, k: int,
               parts: Sequence[torch.Tensor]):
    from . import distributed   # imported on use: `python -m ...distributed` runs it

    like = parts[key[0]]
    shape = tuple(like.shape[:-2]) + (k, like.shape[-1])
    return distributed.Recv(peer, shape, like.dtype, x.mesh.devices[reader],
                            2 * key[0] + key[1])


def edge_rows(x: RowShards, k: int, wrap: bool = True,
              parts: Optional[Sequence[torch.Tensor]] = None) -> Dict[Key, torch.Tensor]:
    """The ``k`` edge rows this process's slots of the ring ``x`` need from
    other processes' slots, keyed (slot, edge), each on the device of the
    slot that reads it; ``parts`` overrides x's parts (a step's buffers).
    Empty where the ring is one process's."""
    if not x.mesh.multi:
        return {}
    from . import distributed

    parts = list(x.parts if parts is None else parts)
    sends, recvs = plan(x, wrap)
    got = distributed.exchange(
        [(peer, _edge(parts[j], edge, k), 2 * j + edge) for (j, edge), peer in sends],
        [_recv_spec(x, key, peer, reader, k, parts) for key, peer, reader in recvs])
    return {key: t for (key, _, _), t in zip(recvs, got)}


class _EdgeRows(torch.autograd.Function):
    """:func:`edge_rows` as an autograd function over this process's parts."""

    @staticmethod
    def forward(ctx, x: RowShards, k: int, wrap: bool, local: List[int], *tensors):
        parts = list(x.parts)
        for i, t in zip(local, tensors):
            parts[i] = t
        got = edge_rows(x, k, wrap, parts)
        ctx.x, ctx.k, ctx.wrap, ctx.local = x, k, wrap, local
        ctx.parts = {i: (t.shape, t.dtype, t.device) for i, t in zip(local, tensors)}
        ctx.got = [(t.shape, t.dtype, t.device) for t in got.values()]
        return tuple(got.values())

    @staticmethod
    def backward(ctx, *grads):
        from . import distributed

        k = ctx.k
        sends, recvs = plan(ctx.x, ctx.wrap)
        back = [(peer, g if g is not None else torch.zeros(shape, dtype=dtype, device=dev),
                 2 * j + edge)
                for ((j, edge), peer, _), g, (shape, dtype, dev) in zip(recvs, grads, ctx.got)]
        specs = []
        for (j, edge), peer in sends:
            shape, dtype, dev = ctx.parts[j]
            specs.append(distributed.Recv(peer, tuple(shape[:-2]) + (k, shape[-1]), dtype, dev,
                                          2 * j + edge))
        got = distributed.exchange(back, specs)
        out = {i: torch.zeros(shape, dtype=dtype, device=dev)
               for i, (shape, dtype, dev) in ctx.parts.items()}
        for ((j, edge), _), g in zip(sends, got):
            _edge(out[j], edge, k).add_(g)
        return (None, None, None, None) + tuple(out[i] for i in ctx.local)


def edge_rows_differentiable(x: RowShards, k: int, wrap: bool = False
                             ) -> Dict[Key, torch.Tensor]:
    """:func:`edge_rows`, differentiable with respect to this process's
    parts (module note)."""
    local = [i for i in range(len(x.parts)) if x.is_local(i)]
    if not (x.mesh.multi and torch.is_grad_enabled()
            and any(x.parts[i].requires_grad for i in local)):
        return edge_rows(x, k, wrap)
    recvs = plan(x, wrap)[1]
    out = _EdgeRows.apply(x, k, wrap, local, *(x.parts[i] for i in local))
    return {key: t for (key, _, _), t in zip(recvs, out)}


__all__ = ["edge_rows", "edge_rows_differentiable", "plan"]
