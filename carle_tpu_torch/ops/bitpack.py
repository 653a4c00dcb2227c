"""Bit-packed CA engine, 32 cells a word — plain PyTorch (counterpart of
carle_tpu/ops/bitpack.py).

Layout as the JAX package: bit ``j`` of word ``[..., k]`` is the cell in
column ``32k + j``; packed universes are ``torch.uint32`` [..., H, W/32] and
equal to ``carle_tpu.ops.bitpack.pack_grid``'s words, word for word.

A generation: a carry-save adder tree builds the Moore count bit-sliced
(planes n0..n3) and a 5-level multiplexer tree over (n0..n3, alive) whose
leaves are the 18 rule bits applies the rule as data.  PyTorch has few
operations on ``uint32`` on the CPU, so the words are computed on ``int64``
holding the 32-bit values, with every left shift and complement masked back
to 32 bits.

This is the plain version of the ``bit_multi_step`` kernel
(ops/cuda_bitpack.py).
"""

from __future__ import annotations

import torch

WORD = 32
_MASK = 0xFFFFFFFF


def pack_grid(grid: torch.Tensor) -> torch.Tensor:
    """uint8/bool [..., H, W] -> uint32 [..., H, W//32] (W % 32 == 0)."""
    *lead, h, w = grid.shape
    if w % WORD:
        raise ValueError(f"width {w} not a multiple of {WORD}")
    bits = grid.to(torch.int64).reshape(*lead, h, w // WORD, WORD)
    weights = torch.ones((), dtype=torch.int64, device=grid.device) << torch.arange(
        WORD, dtype=torch.int64, device=grid.device)
    return (bits * weights).sum(dim=-1).to(torch.uint32)


def unpack_grid(packed: torch.Tensor, width: int) -> torch.Tensor:
    """uint32 [..., H, W//32] -> uint8 [..., H, W]."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[..., None] >> shifts) & 1
    *lead, h, words, _ = bits.shape
    return bits.reshape(*lead, h, words * WORD).to(torch.uint8)[..., :width]


def _csa(a, b, c):
    """Carry-save adder: three weight-k bit-planes -> (sum@k, carry@2k)."""
    ab = a ^ b
    return ab ^ c, (a & b) | (ab & c)


def _not(x):
    return x ^ _MASK


def _horizontal_planes(g):
    """Weight-1/weight-2 planes of each cell's west+east neighbour pair, with
    cross-word carries (torus over the word axis)."""
    left = ((g << 1) & _MASK) | (torch.roll(g, 1, dims=-1) >> 31)
    right = (g >> 1) | ((torch.roll(g, -1, dims=-1) << 31) & _MASK)
    return left ^ right, left & right


def _neighbor_bitplanes(g):
    """Bit-sliced Moore count (n0, n1, n2, n3) of int64-held words."""
    a, b = _horizontal_planes(g)

    def up(x):
        return torch.roll(x, 1, dims=-2)

    def down(x):
        return torch.roll(x, -1, dims=-2)

    s1, c1 = _csa(up(a), a, down(a))       # weight-1 triples
    s2, c2 = _csa(up(g), down(g), s1)      # + the two vertical cells
    s3, c3 = _csa(up(b), b, down(b))       # weight-2 triples
    s4, c4 = _csa(s3, c1, c2)
    return s2, s4, c3 ^ c4, c3 & c4


def _rule_leaf(bits: torch.Tensor, k: int, like: torch.Tensor) -> torch.Tensor:
    """All-ones word where bit k of the rule mask is set, else zero; the rule
    is a scalar or an [instances] vector along dimension 0."""
    leaf = ((bits >> k) & 1) * _MASK
    if leaf.ndim == 1:
        leaf = leaf.reshape(leaf.shape[0], *([1] * (like.ndim - 1)))
    return leaf


def _rule_mux(g, counts, bits: torch.Tensor):
    """Select bit (count + 9*alive) of the rule mask by a mux tree."""
    sels = counts

    def fold(leaves):
        planes = leaves
        for sel in sels:
            nsel = _not(sel)
            nxt = [(planes[i] & nsel) | (planes[i + 1] & sel)
                   for i in range(0, len(planes) - 1, 2)]
            if len(planes) % 2:
                nxt.append(planes[-1] & nsel)  # odd tail: only reachable sel=0
            planes = nxt
        return planes[0]

    dead = fold([_rule_leaf(bits, v, g) for v in range(9)])
    alive = fold([_rule_leaf(bits, 9 + v, g) for v in range(9)])
    return (dead & _not(g)) | (alive & g)


def _rule_tensor(rule_bits, like: torch.Tensor) -> torch.Tensor:
    bits = torch.as_tensor(rule_bits, device=like.device).to(torch.int64)
    if bits.ndim == 1 and bits.shape[0] != like.shape[0]:
        raise ValueError(
            f"per-instance rule vector of length {bits.shape[0]} must "
            f"match grid dimension 0 ({like.shape[0]}) — the vector "
            "applies along dim 0")
    return bits


def bit_ca_step(packed: torch.Tensor, rule_bits) -> torch.Tensor:
    """One generation on a packed grid; rules are data."""
    g = packed.to(torch.int64)
    bits = _rule_tensor(rule_bits, g)
    return _rule_mux(g, _neighbor_bitplanes(g), bits).to(torch.uint32)


def bit_multi_step(packed: torch.Tensor, rule_bits,
                   num_steps: int) -> torch.Tensor:
    """``num_steps`` generations on a packed [inst, H, W/32] grid."""
    g = packed.to(torch.int64)
    bits = _rule_tensor(rule_bits, g)
    for _ in range(int(num_steps)):
        g = _rule_mux(g, _neighbor_bitplanes(g), bits)
    return g.to(torch.uint32)
