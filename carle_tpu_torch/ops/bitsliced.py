"""Bit-sliced small-integer arithmetic on packed cell planes (counterpart of
carle_tpu/ops/bitsliced.py), as plain PyTorch.

An integer per CELL is a tuple of packed bit-planes (LSB first), each shaped
like a packed grid ``[..., H, W/32]``, so one word operation processes 32
cells' worth of one bit position: column and row tap shifts, ripple adders,
constant multiplies and per-instance max/min over cell positions.  Wrappers
whose math is "small integers per cell, then a reduction" (MorphoBonus's
pattern correlations, mcl/packed_stats.py) run on packed words this way
without unpacking a cell.

Planes are int64 tensors holding 32-bit words (PyTorch has few ``uint32``
operations on the CPU; ops/bitpack.py does the same): every left shift and
complement is masked back to 32 bits.  Bit j of word ``[..., k]`` is the cell
in column ``32 k + j``.  Every number here is non-negative; subtraction adds
an offset first (:func:`sub_offset`).  The JAX package computes this in XLA
outside any kernel; so does the port, in eager PyTorch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .bitpack import WORD, popcount

Plane = torch.Tensor             # int64 [..., H, W/32] holding 32-bit words
Num = Tuple[torch.Tensor, ...]   # LSB-first bit-planes
_MASK = 0xFFFFFFFF


def as_plane(words: torch.Tensor) -> Plane:
    """Packed uint32 words as a plane (int64 holding the same values)."""
    return words.to(torch.int64)


# ---------------------------------------------------------------------------
# tap shifts (zero fill: callers mask to the valid region)
# ---------------------------------------------------------------------------


def _word_shift(a: Plane, n: int) -> Plane:
    """Whole words toward lower columns, zero-filled."""
    if n == 0:
        return a
    out = torch.zeros_like(a)
    if n < a.shape[-1]:
        out[..., : a.shape[-1] - n] = a[..., n:]
    return out


def shift_col(x: Plane, d: int) -> Plane:
    """y(i, j) = x(i, j + d) for d >= 0, zero-filled past the last column."""
    if d == 0:
        return x
    q, r = divmod(d, WORD)
    x = _word_shift(x, q)
    if r == 0:
        return x
    return (x >> r) | ((_word_shift(x, 1) << (WORD - r)) & _MASK)


def shift_row(x: Plane, d: int) -> Plane:
    """y(i, j) = x(i + d, j) for d >= 0, zero-filled past the last row."""
    if d == 0:
        return x
    out = torch.zeros_like(x)
    if d < x.shape[-2]:
        out[..., : x.shape[-2] - d, :] = x[..., d:, :]
    return out


# ---------------------------------------------------------------------------
# adders
# ---------------------------------------------------------------------------


def add_plane(num: Sequence[Plane], p: Plane, width: int) -> Num:
    """num + binary plane ``p`` (half-adder carry chain), clipped to width."""
    out = []
    carry = p
    for a in num:
        out.append(a ^ carry)
        carry = a & carry
        if len(out) == width:
            return tuple(out)
    if len(out) < width:
        out.append(carry)
    return tuple(out[:width])


def add(a: Sequence[Plane], b: Sequence[Plane], width: int) -> Num:
    """Ripple-carry addition of two numbers, clipped to ``width`` planes."""
    out = []
    carry = None
    for k in range(width):
        terms = [t for t in (a[k] if k < len(a) else None,
                             b[k] if k < len(b) else None, carry) if t is not None]
        if not terms:
            break
        if len(terms) == 1:
            out.append(terms[0])
            carry = None
        elif len(terms) == 2:
            out.append(terms[0] ^ terms[1])
            carry = terms[0] & terms[1]
        else:
            s = terms[0] ^ terms[1]
            out.append(s ^ terms[2])
            carry = (terms[0] & terms[1]) | (s & terms[2])
    if carry is not None and len(out) < width:
        out.append(carry)
    return tuple(out)


def shift_planes(num: Sequence[Plane], k: int) -> Num:
    """Multiply by 2^k: prepend k zero planes."""
    if not num:
        return tuple(num)
    return (torch.zeros_like(num[0]),) * k + tuple(num)


def mul_const(num: Sequence[Plane], c: int, width: int) -> Num:
    """Multiply a number by a non-negative Python int (shift and add)."""
    if c == 0 or not num:
        return ()
    acc: Num = ()
    k = 0
    while c:
        if c & 1:
            acc = add(acc, shift_planes(num, k), width)
        c >>= 1
        k += 1
    return acc


def sub_offset(a: Sequence[Plane], b: Sequence[Plane], offset: int, width: int) -> Num:
    """``a - b + offset`` as a non-negative number of ``width`` planes.

    The caller guarantees ``0 <= a - b + offset < 2**width``; computed as
    ``a + offset + (2**width - b)`` mod 2^width (two's complement)."""
    if not a and not b:
        raise ValueError("empty operands")
    ref = (a or b)[0]
    ones = torch.full_like(ref, _MASK)
    zero = torch.zeros_like(ref)
    notb = tuple((b[k] ^ _MASK) if k < len(b) else ones for k in range(width))
    const = (offset + 1) % (1 << width)
    cplanes = tuple(ones if (const >> k) & 1 else zero for k in range(width))
    return add(add(tuple(a), notb, width), cplanes, width)


# ---------------------------------------------------------------------------
# windowed tap sums
# ---------------------------------------------------------------------------


def _width_for(n: int) -> int:
    return max(int(n).bit_length(), 1)


def tap_sum(x: Plane, offsets: Sequence[Tuple[int, int]]) -> Num:
    """Per-cell count of set bits of ``x`` at non-negative ``(dy, dx)`` tap
    offsets: ``N(i, j) = sum_t x(i + dy_t, j + dx_t)``; each row shift once."""
    width = _width_for(len(offsets))
    by_row = {}
    for dy, dx in offsets:
        by_row.setdefault(dy, []).append(dx)
    acc: Num = ()
    for dy in sorted(by_row):
        row = shift_row(x, dy) if dy else x
        for dx in sorted(by_row[dy]):
            acc = add_plane(acc, shift_col(row, dx), width)
    return acc


def window_sum(x: Plane, hh: int, ww: int) -> Num:
    """Per-cell count of set bits in the ``hh x ww`` window anchored at the
    cell: separable (rows of column sums)."""
    row: Num = ()
    for dx in range(ww):
        row = add_plane(row, shift_col(x, dx), _width_for(ww))
    width = _width_for(hh * ww)
    acc: Num = tuple(row)
    for dy in range(1, hh):
        acc = add(acc, tuple(shift_row(p, dy) for p in row), width)
    return acc


# ---------------------------------------------------------------------------
# per-instance max/min over cell positions (MSB first)
# ---------------------------------------------------------------------------


def _any_bits(x: Plane, batch_dims: int) -> torch.Tensor:
    return popcount(x).sum(dim=tuple(range(batch_dims, x.ndim))) > 0


def max_over_cells(num: Sequence[Plane], valid: Plane, batch_dims: int = 1) -> torch.Tensor:
    """Largest encoded value over the VALID cell positions, per batch entry
    (int64 ``[batch...]``): keep the candidates whose current bit is set
    whenever one is.  ``valid`` must be non-empty per batch entry."""
    cand = torch.broadcast_to(valid, num[0].shape)
    val = torch.zeros(num[0].shape[:batch_dims], dtype=torch.int64, device=num[0].device)
    bshape = val.shape + (1,) * (num[0].ndim - batch_dims)
    for k in reversed(range(len(num))):
        t = cand & num[k]
        has = _any_bits(t, batch_dims)
        val = val + has.to(torch.int64) * (1 << k)
        cand = torch.where(has.reshape(bshape), t, cand)
    return val


def min_over_cells(num: Sequence[Plane], valid: Plane, batch_dims: int = 1) -> torch.Tensor:
    """Smallest encoded value over the VALID cell positions (int64)."""
    cand = torch.broadcast_to(valid, num[0].shape)
    val = torch.zeros(num[0].shape[:batch_dims], dtype=torch.int64, device=num[0].device)
    bshape = val.shape + (1,) * (num[0].ndim - batch_dims)
    for k in reversed(range(len(num))):
        t = cand & (num[k] ^ _MASK)
        has_zero = _any_bits(t, batch_dims)
        # no candidate with bit k clear: every candidate has it set
        val = val + (~has_zero).to(torch.int64) * (1 << k)
        cand = torch.where(has_zero.reshape(bshape), t, cand)
    return val
