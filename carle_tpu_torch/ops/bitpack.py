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

Also here: the same engine with the rule fixed ahead of time (the mux tree
folds to a few operations), the column-major layout with bits along H
(:func:`pack_grid_cm`), and a SWAR :func:`popcount`.  These are the plain
versions of the ``bit_multi_step*`` kernels (ops/cuda_bitpack.py).
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


def _mux_fold(leaves, sels):
    """Select leaf ``sum_k 2^k sel_k`` bitwise by a mux tree over the
    selector planes (LSB first)."""
    planes = leaves
    for sel in sels:
        nsel = _not(sel)
        nxt = [(planes[i] & nsel) | (planes[i + 1] & sel)
               for i in range(0, len(planes) - 1, 2)]
        if len(planes) % 2:
            nxt.append(planes[-1] & nsel)  # odd tail: only reachable sel=0
        planes = nxt
    return planes[0]


def _rule_mux(g, counts, bits: torch.Tensor):
    """Select bit (count + 9*alive) of the rule mask by a mux tree."""
    dead = _mux_fold([_rule_leaf(bits, v, g) for v in range(9)], counts)
    alive = _mux_fold([_rule_leaf(bits, 9 + v, g) for v in range(9)], counts)
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


# ---------------------------------------------------------------------------
# popcount
# ---------------------------------------------------------------------------


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (uint32, or int64 holding 32-bit values)
    as int64: a SWAR count, since PyTorch has no popcount operation."""
    x = words.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK) >> 24


# ---------------------------------------------------------------------------
# column-major packing: bits along H
# ---------------------------------------------------------------------------


def pack_grid_cm(grid: torch.Tensor) -> torch.Tensor:
    """uint8/bool [..., H, W] -> uint32 [..., H//32, W]: bit j of word
    [..., k, c] is the cell in row 32k + j of column c (H % 32 == 0)."""
    *lead, h, w = grid.shape
    if h % WORD:
        raise ValueError(f"height {h} not a multiple of {WORD}")
    bits = grid.to(torch.int64).reshape(*lead, h // WORD, WORD, w)
    weights = torch.ones((), dtype=torch.int64, device=grid.device) << torch.arange(
        WORD, dtype=torch.int64, device=grid.device)
    return (bits * weights[:, None]).sum(dim=-2).to(torch.uint32)


def unpack_grid_cm(packed: torch.Tensor, height: int) -> torch.Tensor:
    """uint32 [..., H//32, W] -> uint8 [..., H, W]."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[..., None, :] >> shifts[:, None]) & 1
    *lead, words, _, w = bits.shape
    return bits.reshape(*lead, words * WORD, w).to(torch.uint8)[..., :height, :]


# ---------------------------------------------------------------------------
# the rule fixed ahead of time: constant-fold the mux tree
# ---------------------------------------------------------------------------


def _fold_mux(a, b, sel):
    """Mux with constant folding: planes are the strings "0"/"1" or words;
    returns the same representation."""
    if isinstance(a, str) and isinstance(b, str):
        if a == b:
            return a
        return sel if a == "0" else _not(sel)
    if isinstance(a, str):
        return (b & sel) if a == "0" else (_not(sel) | (b & sel))
    if isinstance(b, str):
        return (a & _not(sel)) if b == "0" else (sel | (a & _not(sel)))
    return (a & _not(sel)) | (b & sel)


def _fold_tail(a, sel):
    """Odd-tail node (only reachable when sel == 0)."""
    if isinstance(a, str):
        return a if a == "0" else _not(sel)
    return a & _not(sel)


def _fold_tree(leaves, selectors):
    planes = list(leaves)
    for sel in selectors:
        nxt = [_fold_mux(planes[i], planes[i + 1], sel)
               for i in range(0, len(planes) - 1, 2)]
        if len(planes) % 2:
            nxt.append(_fold_tail(planes[-1], sel))
        planes = nxt
    return planes[0]


def _static_rule_fold(g, counts, birth, survive, count9: bool = False):
    """Apply a B/S rule known ahead of time to bit-sliced counts.  With
    ``count9`` the counts include the centre cell: the dead branch reads
    birth[count9] and the alive branch survive[count9 - 1]."""
    birth_set = {int(d) for d in birth}
    survive_set = {int(d) for d in survive}

    def fold(leaves):
        out = _fold_tree(leaves, list(counts))
        if isinstance(out, str):
            zero = torch.zeros_like(g)
            return zero if out == "0" else _not(zero)
        return out

    if count9:
        dead = fold(["1" if v in birth_set else "0" for v in range(9)] + ["0"])
        alive = fold(["0"] + ["1" if v - 1 in survive_set else "0" for v in range(1, 10)])
    else:
        dead = fold(["1" if v in birth_set else "0" for v in range(9)])
        alive = fold(["1" if v in survive_set else "0" for v in range(9)])
    return (dead & _not(g)) | (alive & g)


def _rule_mux_static(g, counts, birth, survive):
    """The rule fixed ahead of time, over neighbour-count planes."""
    return _static_rule_fold(g, counts, birth, survive)


def bit_ca_step_static(packed: torch.Tensor, birth, survive) -> torch.Tensor:
    """One generation with the B/S rule fixed ahead of time: the mux tree's
    leaves are constants and fold away (for Life the decision is
    ``~n3 & ~n2 & n1 & (n0 | g)``)."""
    g = packed.to(torch.int64)
    return _rule_mux_static(g, _neighbor_bitplanes(g), birth, survive).to(torch.uint32)


def bit_multi_step_static(packed: torch.Tensor, birth, survive,
                          num_steps: int) -> torch.Tensor:
    """``num_steps`` generations of :func:`bit_ca_step_static`; the plain
    version of the ``bit_multi_step_static`` kernel."""
    g = packed.to(torch.int64)
    for _ in range(int(num_steps)):
        g = _rule_mux_static(g, _neighbor_bitplanes(g), birth, survive)
    return g.to(torch.uint32)


# ---------------------------------------------------------------------------
# column-major steps (counterpart of carle_tpu/ops/pallas_bitpack.py:453-509)
# ---------------------------------------------------------------------------


def _count9_planes_cm(g):
    """Bit planes of the count INCLUDING the centre on column-major words
    [..., H/32, W]: the vertical neighbours are in-word shifts with a carry
    from the word above or below, the horizontal ones whole words."""
    pw = torch.roll(g, 1, dims=-2)     # word k-1 at k: rows above
    nw = torch.roll(g, -1, dims=-2)    # word k+1 at k: rows below
    u = ((g << 1) & _MASK) | (pw >> 31)   # the cell of row r-1 at r
    d = (g >> 1) | ((nw << 31) & _MASK)   # the cell of row r+1 at r
    ab = u ^ g
    p0 = ab ^ d                        # the vertical triple's weight-1 plane
    p1 = (u & g) | (ab & d)            # and its weight-2 plane
    s1, c1 = _csa(torch.roll(p0, 1, dims=-1), p0, torch.roll(p0, -1, dims=-1))
    s2, c2 = _csa(torch.roll(p1, 1, dims=-1), p1, torch.roll(p1, -1, dims=-1))
    cc = c1 & s2
    return s1, c1 ^ s2, c2 ^ cc, c2 & cc


def bit_multi_step_static_cm(packed_cm: torch.Tensor, birth, survive,
                             num_steps: int) -> torch.Tensor:
    """``num_steps`` generations on a column-major packed [inst, H/32, W]
    grid (:func:`pack_grid_cm`) with the rule fixed ahead of time; the plain
    version of the ``bit_multi_step_static_cm`` kernel."""
    g = packed_cm.to(torch.int64)
    for _ in range(int(num_steps)):
        g = _static_rule_fold(g, _count9_planes_cm(g), birth, survive, count9=True)
    return g.to(torch.uint32)


def bit_multi_step_cm(packed_cm: torch.Tensor, rule_bits,
                      num_steps: int) -> torch.Tensor:
    """``num_steps`` generations on a column-major packed grid, the rule as
    data (a scalar or an [inst] vector); the plain version of the
    ``bit_multi_step_cm`` kernel."""
    g = packed_cm.to(torch.int64)
    bits = _rule_tensor(rule_bits, g)
    zero = torch.zeros((), dtype=torch.int64, device=g.device)
    dead_leaves = [_rule_leaf(bits, v, g) for v in range(9)] + [zero]
    alive_leaves = [zero] + [_rule_leaf(bits, 9 + v, g) for v in range(9)]
    for _ in range(int(num_steps)):
        counts = _count9_planes_cm(g)
        g = (_mux_fold(dead_leaves, counts) & _not(g)) | (_mux_fold(alive_leaves, counts) & g)
    return g.to(torch.uint32)
