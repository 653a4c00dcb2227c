"""The fused encoder and decoder loss as row bands of one universe (counterpart
of carle_tpu/parallel/band_heads.py).

A universe too large to be one instance of the net kernels cheaply (8192²:
the pod_smoke single-device leg, the Prediction ring probe) is cut into
``bands`` row bands.  Each band, with halo rows sliced exactly from its
neighbours and zero rows only past the universe's edges, becomes one instance
of ONE launch; the kernels' launch grids then cover bands x column tiles x
instances.  Banding is slicing, so each kernel's parameter gradients, summed
over the band instances, are the global ones, and autograd carries the
embedding's cotangent back through the slices.

* encoder: ``p1 p2`` input halo rows a side, cropped to one pooled output row
  a side (:data:`ENC_CROP`).  A zero cell row past the universe's edge would
  give stage 1 relu(b1) where the global function pads stage 2 with zeros, so
  each band carries a stage-1 row-validity mask (``cuda_head.encoder``'s
  ``mask``) that zeroes those rows;
* decoder loss: each band reads a window of embedding rows, its core plus
  :data:`DEC_HALO` rows a side, shifted inward at the universe's edges so the
  window never leaves it (zero rows would give relu(bt1) at the middle
  stage), and per-band error row weights ``em`` keep exactly the band's core
  output rows, so the bands' errors add up to the global error and no
  full-resolution reconstruction reaches device memory.

Unlike the JAX package, which runs the global function where no TPU is
present, the port runs the banded composition on both devices: on the CPU
through the twins, so the CPU tests exercise the slicing.  Dropout: each band
draws its own mask, as an instance of the launch (Philox counter (x, y,
instance, stage) with y the band-local row).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import nets
from ..nets import BandTiling
from ..ops import cuda_head, cuda_stages

ENC_CROP = 1   # pooled output rows cropped a side (halo = p1 p2 input rows)
DEC_HALO = 2   # embedding window margin rows a side (decoder + loss)


def _rows(x: torch.Tensor, starts, rows: int) -> torch.Tensor:
    """[inst, C, H, W*] -> [inst * len(starts), C, rows, W*]: rows
    [s, s + rows) of each instance for each start s (negative or past H: zero
    rows), instance i's window b at i * len(starts) + b.  Works for uint8
    cells, packed words and float planes (rows are rows); differentiable for
    float x."""
    n, c, h, w = x.shape
    lo = max(0, -min(starts))
    hi = max(0, max(starts) + rows - h)
    if x.dtype == torch.uint32:   # word copies as int32: the same bits
        return _rows(x.view(torch.int32), starts, rows).view(torch.uint32)
    if lo or hi:
        x = torch.cat([x.new_zeros((n, c, lo, w)), x, x.new_zeros((n, c, hi, w))], dim=2)
    picked = x.index_select(2, _row_index(tuple(starts), rows, lo, x.device))
    return picked.reshape(n, c, len(starts), rows, w).transpose(1, 2).reshape(
        n * len(starts), c, rows, w)


# The index and weight tensors of a geometry are built once a device (a
# rollout asks for them every step, and building one is host work and a copy
# to the device); callers never write into them.
@functools.lru_cache(maxsize=64)
def _row_index(starts: tuple, rows: int, lo: int, device) -> torch.Tensor:
    return (torch.tensor(starts)[:, None] + lo + torch.arange(rows)[None, :]).reshape(-1).to(
        device)


def _band_input(x: torch.Tensor, nb: int, halo: int) -> torch.Tensor:
    """[inst, C, H, W*] -> [inst nb, C, H/nb + 2 halo, W*]: band ``b`` of
    instance ``i`` at index ``i nb + b``; halo rows are exact slices of the
    neighbouring bands, zero past the universe's edges."""
    hb = x.shape[2] // nb
    return _rows(x, [b * hb - halo for b in range(nb)], hb + 2 * halo)


def _unband(y: torch.Tensor, n: int, nb: int) -> torch.Tensor:
    """[inst nb, C, hb', W'] -> [inst, C, nb hb', W'] (bands are contiguous
    row blocks)."""
    _, c, hbp, w = y.shape
    return y.reshape(n, nb, c, hbp, w).transpose(1, 2).reshape(n, c, nb * hbp, w)


def _check(h: int, nb: int, unit: int, what: str) -> int:
    if h % nb:
        raise ValueError(f"band tiling: {what} height {h} not divisible by "
                         f"bands={nb}")
    hb = h // nb
    if hb % unit:
        raise ValueError(f"band tiling: band height {hb} must be a "
                         f"multiple of {unit} ({what})")
    return hb


@functools.lru_cache(maxsize=64)
def encoder_mask(h: int, nb: int, pools: Tuple[int, int], n: int,
                 device=None) -> torch.Tensor:
    """The stage-1 row validity of every band of ``n`` universes of height
    ``h`` in ``nb`` bands: [n nb, (h/nb + 2 p1 p2) / p1] float32, band-local
    pooled row r of band b being global pooled row b h/(nb p1) + r - p2; ones
    except past the universe's edges."""
    pool1, pool2 = pools
    hb = h // nb
    r = torch.arange((hb + 2 * pool1 * pool2) // pool1)
    rows = r[None, :] + (torch.arange(nb) * (hb // pool1))[:, None] - pool2
    return ((rows >= 0) & (rows < h // pool1)).to(torch.float32).repeat(n, 1).to(device)


def encoder_banded(x: torch.Tensor, p1: nets.Params, p2: nets.Params, *,
                   pools: Tuple[int, int], drop_p: float, train: bool,
                   seed: Optional[int], tiling: BandTiling) -> torch.Tensor:
    """:func:`nets.conv_encoder` as ``tiling.bands`` row bands: one launch
    over every band of every instance."""
    halo = pools[0] * pools[1]
    n, _, h, _ = x.shape
    nb = tiling.bands
    _check(h, nb, halo, "observation")
    p, seed = nets._drop_args(drop_p, train, seed)
    out = cuda_head.encoder(_band_input(x, nb, halo), p1["w"], p1["b"], p2["w"], p2["b"],
                            pools, p, seed, mask=encoder_mask(h, nb, tuple(pools), n, x.device))
    return _unband(out[:, :, ENC_CROP:-ENC_CROP], n, nb)


def decoder_windows(he: int, nb: int) -> Tuple[list, int]:
    """(first rows, height) of each band's embedding window: its core plus
    DEC_HALO rows a side, shifted inward at the universe's edges (an edge
    band's window ends at the universe's edge, whose zero padding the
    kernel's own is)."""
    heb = _check(he, nb, 1, "embedding")
    win = heb + 2 * DEC_HALO if nb > 1 else heb
    if win > he:
        raise ValueError(
            f"band tiling: embedding window {win} exceeds height {he} — "
            f"use fewer bands")
    return [min(max(b * heb - DEC_HALO, 0), he - win) for b in range(nb)], win


@functools.lru_cache(maxsize=64)
def decoder_row_weights(he: int, nb: int, n: int, device=None) -> torch.Tensor:
    """The error row weights of every band of ``n`` embeddings of height
    ``he``: [n nb, 4 win] float32, one on the band's core output rows (at
    offset 4 (b he/nb - start) of its window), zero elsewhere."""
    starts, win = decoder_windows(he, nb)
    heb = he // nb
    em = torch.zeros((nb, 4 * win), dtype=torch.float32)
    for b, s in enumerate(starts):
        o = 4 * (b * heb - s)
        em[b, o:o + 4 * heb] = 1.0
    return em.repeat(n, 1).to(device)


def decoder_loss_banded(x: torch.Tensor, pd1: nets.Params, pd2: nets.Params,
                        obs: torch.Tensor, *, drop_p: float, train: bool,
                        seed: Optional[int], tiling: BandTiling) -> torch.Tensor:
    """:func:`nets.conv_decoder_loss` as ``tiling.bands`` row bands: the
    bands' row-weighted errors add up to the global error."""
    n, _, he, _ = x.shape
    nb = tiling.bands
    starts, win = decoder_windows(he, nb)
    p, seed = nets._drop_args(drop_p, train, seed)
    err = cuda_stages.decoder_loss(_rows(x, starts, win), pd1["w"], pd1["b"], pd2["w"],
                                   pd2["b"], _rows(obs, [4 * s for s in starts], 4 * win),
                                   p, seed, em=decoder_row_weights(he, nb, n, x.device))
    return err.reshape(n, nb).sum(dim=1)


def ae_loss_banded(src: torch.Tensor, p1: nets.Params, p2: nets.Params,
                   pd1: nets.Params, pd2: nets.Params, obs: torch.Tensor, *,
                   pools: Tuple[int, int], drop_p: float, train: bool,
                   seed: Optional[int], tiling: BandTiling) -> torch.Tensor:
    """The autoencoder's error under band tiling: the banded encoder (the
    whole embedding lands in device memory, 2 x 2048² float32 at 8192²) then
    the banded decoder loss, with one seed.  The whole-autoencoder kernel
    cannot span bands: the decoder needs its neighbours' embedding rows."""
    kw = dict(drop_p=drop_p, train=train, seed=seed, tiling=tiling)
    x = encoder_banded(src, p1, p2, pools=pools, **kw)
    return decoder_loss_banded(x, pd1, pd2, obs, **kw)


__all__ = ["DEC_HALO", "ENC_CROP", "ae_loss_banded", "decoder_loss_banded",
           "decoder_row_weights", "decoder_windows", "encoder_banded", "encoder_mask"]
