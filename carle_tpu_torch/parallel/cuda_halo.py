"""The halo kernels: Life-like generations of row-sharded universes on CUDA,
and their plain PyTorch twins (counterpart of
carle_tpu/parallel/pallas_halo.py).

* :func:`spatial_ca_step_cuda` — one uint8 generation
  (``spatial_ca_step_pallas``);
* :func:`spatial_multi_step_cuda` — K uint8 generations
  (``spatial_multi_step_pallas``);
* :func:`bit_spatial_multi_step_cuda` — K packed generations
  (``bit_spatial_multi_step_pallas``), the rule as data or, with
  ``static_rules``, fixed at compile time (one library a rule mask).

Each takes :class:`~.mesh.RowShards` of [N, H/n, W] uint8 cells or
[N, H/n, W/32] uint32 words and returns new shards.  All three launch
``csrc/halo_step.cu`` for CUDA slots, every slot on a device in one launch,
each slot reading its ring neighbours' edge rows in place (the ring wraps:
the torus).  The packed one (``bit_halo_words_launch``, counted as
``bit_spatial_words``) runs one generation by the streaming kernel, and K
generations in chunks of T (:func:`halo_plan`: T <= the slot's rows): one
launch per device per chunk, each a temporal-blocking kernel on bands staged
with T ghost rows a side; with ``BIT_HALO_BLOCKS = False`` it takes the
present kernel, once per device per generation.  The uint8 burst
(``u8_halo_bits_launch``, counted as ``spatial_multi_step_bits``) runs the
same temporal-blocking kernel on the cells packed as they are staged and
unpacked as they are stored, where :func:`u8_halo_plan` holds the shape
(K > 1, W % 32 == 0, a band's packed copies fit shared memory); other
shapes, one generation (:func:`spatial_ca_step_cuda`) and
``HALO_U8_BITS = False`` take the present uint8 kernel, once per device per
generation.  Slots on several cards run each generation (packed:
each chunk) on every card's stream, each waiting on an event its
neighbours' cards recorded after the previous one; that path needs peer
access and has not run on a machine of several cards.  For CPU slots each
takes its twin (``*_plain``): ghost rows copied from the ring neighbours,
the engines' update on the padded rows, columns rolled.  The step count is
data (a host integer): no rebuild for another count.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import bitpack
from ..ops.ca import apply_rule
from ..ops.cuda_bitpack import stream_launches, stream_plan
from ..ops.cuda_build import KERNELS, library, stream_args
from ..ops.cuda_ca import _multiprocessors
from ..rules import pack_rule_bits
from .mesh import RowShards

KERNEL_STEP = KERNELS["spatial_ca_step"]
KERNEL_MULTI = KERNELS["spatial_multi_step"]
KERNEL_BIT = KERNELS["bit_spatial_multi_step"]
KERNEL_BIT_WORDS = KERNELS["bit_spatial_words"]
KERNEL_U8_BITS = KERNELS["spatial_multi_step_bits"]
KIND_U8, KIND_U32 = 1, 2     # csrc/common.cuh
MAX_SLOTS = 64               # csrc/halo_step.cu: slots of one device a launch covers
# False: bit_spatial_multi_step_cuda launches the present kernel, once a
# generation (the A/B)
BIT_HALO_BLOCKS = True
# bit_halo_words_launch's temporal blocking: shared memory a block may take,
# generations a launch, the most rows a band, threads a block, the most rows
# a compute strip
HALO_SMEM_BYTES = 227 * 1024
HALO_T = 8
HALO_ROWS = 64
HALO_THREADS = 512
HALO_MAX_STRIP = 32
# False: spatial_multi_step_cuda launches the present uint8 kernel, once a
# generation (the A/B)
HALO_U8_BITS = True

__all__ = ["KERNEL_BIT", "KERNEL_BIT_WORDS", "KERNEL_MULTI", "KERNEL_STEP", "KERNEL_U8_BITS",
           "bit_spatial_multi_step_cuda", "halo_plan", "u8_halo_plan",
           "bit_spatial_multi_step_plain", "spatial_ca_step_cuda", "spatial_ca_step_plain",
           "spatial_multi_step_cuda", "spatial_multi_step_plain"]


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _padded(parts: Sequence[torch.Tensor], s: int) -> torch.Tensor:
    """Slot s's rows with a ghost row copied from each ring neighbour: the
    last row of slot s-1 above, the first of slot s+1 below (torus)."""
    n, p = len(parts), parts[s]
    north = parts[(s - 1) % n][:, -1:].to(p.device)
    south = parts[(s + 1) % n][:, :1].to(p.device)
    return torch.cat([north, p, south], dim=1)


def _step_u8(parts: List[torch.Tensor], rule_bits) -> List[torch.Tensor]:
    out = []
    for s, p in enumerate(parts):
        g = _padded(parts, s).to(torch.int32)
        rows = g[:, :-2] + g[:, 1:-1] + g[:, 2:]
        counts = rows + torch.roll(rows, 1, dims=-1) + torch.roll(rows, -1, dims=-1) - g[:, 1:-1]
        out.append(apply_rule(p, counts, torch.as_tensor(rule_bits).to(p.device)))
    return out


def _step_u32(parts: List[torch.Tensor], rule_bits, static_rules) -> List[torch.Tensor]:
    """One packed generation: bitpack's carry-save count with the vertical
    neighbours from the ghost rows, its rule mux (data or fixed)."""
    out = []
    for s, p in enumerate(parts):
        g = _padded(parts, s).to(torch.int64)
        a, b = bitpack._horizontal_planes(g)
        s1, c1 = bitpack._csa(a[:, :-2], a[:, 1:-1], a[:, 2:])
        s2, c2 = bitpack._csa(g[:, :-2], g[:, 2:], s1)
        s3, c3 = bitpack._csa(b[:, :-2], b[:, 1:-1], b[:, 2:])
        s4, c4 = bitpack._csa(s3, c1, c2)
        counts = (s2, s4, c3 ^ c4, c3 & c4)
        mid = g[:, 1:-1]
        if static_rules is None:
            new = bitpack._rule_mux(mid, counts, bitpack._rule_tensor(
                torch.as_tensor(rule_bits).to(p.device), mid))
        else:
            new = bitpack._rule_mux_static(mid, counts, *static_rules)
        out.append(new.to(torch.uint32))
    return out


def _multi_plain(x: RowShards, steps: int, step) -> RowShards:
    parts = list(x.parts)
    for _ in range(int(steps)):
        parts = step(parts)
    return RowShards([p.clone() for p in parts] if steps == 0 else parts, x.mesh, x.axis)


def spatial_ca_step_plain(x: RowShards, rule_bits) -> RowShards:
    """One uint8 generation of row-sharded universes, ghost rows by copy."""
    return _multi_plain(x, 1, lambda parts: _step_u8(parts, rule_bits))


def spatial_multi_step_plain(x: RowShards, rule_bits, num_steps: int) -> RowShards:
    """``num_steps`` uint8 generations (:func:`spatial_ca_step_plain` each)."""
    return _multi_plain(x, num_steps, lambda parts: _step_u8(parts, rule_bits))


def bit_spatial_multi_step_plain(x: RowShards, rule_bits, num_steps: int,
                                 static_rules: Optional[Tuple] = None) -> RowShards:
    """``num_steps`` packed generations of row-sharded words."""
    return _multi_plain(x, num_steps, lambda parts: _step_u32(parts, rule_bits, static_rules))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check(x: RowShards, dtype: torch.dtype, name: str, rule_bits) -> str:
    """'cpu' or 'cuda': where the slots are, after checking the shards and
    the rule."""
    if not isinstance(x, RowShards):
        raise TypeError(f"{name} takes RowShards (parallel.mesh.shard_rows), got {type(x)}")
    for p, dev in zip(x.parts, x.mesh.devices):
        if p.dtype != dtype or p.ndim != 3 or p.device != dev or not p.is_contiguous():
            raise ValueError(f"{name}: every shard must be a contiguous {dtype} [N, H/n, W] "
                             f"tensor on its slot's device")
        if p.shape != x.parts[0].shape:
            raise ValueError(f"{name}: shards of unequal shapes")
    if dtype == torch.uint8 and x.parts[0].shape[-1] % 4:
        raise ValueError(f"{name}: the uint8 kernel reads 4 cells a word; width "
                         f"{x.parts[0].shape[-1]} % 4 != 0")
    _rule(rule_bits, x)
    return x.mesh.home.type


def _rule(rule_bits, x: RowShards) -> torch.Tensor:
    rule = torch.as_tensor(rule_bits, dtype=torch.int32)
    n = x.parts[0].shape[0]
    if rule.ndim > 1 or (rule.ndim == 1 and rule.shape[0] != n):
        raise ValueError(f"rule must be a scalar or a [{n}] vector, got shape "
                         f"{tuple(rule.shape)}")
    return rule


def _rules_by_device(rule_bits, x: RowShards) -> Dict[torch.device, torch.Tensor]:
    rule = _rule(rule_bits, x)
    return {d: rule.to(d).contiguous() for d in set(x.mesh.devices)}


_PEERS_ENABLED = set()


def _enable_peers(devices: Sequence[torch.device]) -> None:
    lib = library("halo_step")
    for a in devices:
        for b in devices:
            if a != b and (a.index, b.index) not in _PEERS_ENABLED:
                rc = lib.halo_enable_peer(a.index, b.index)
                if rc != 0:
                    raise RuntimeError(f"peer access cuda:{a.index} -> cuda:{b.index} failed: "
                                       f"{lib.cuda_error_string(rc).decode()}")
                _PEERS_ENABLED.add((a.index, b.index))


def _slot_groups(x: RowShards) -> Dict[torch.device, List[int]]:
    """The slots of each device, in ring order."""
    groups: Dict[torch.device, List[int]] = {}
    for s, dev in enumerate(x.mesh.devices):
        groups.setdefault(dev, []).append(s)
    for dev, slots in groups.items():
        if len(slots) > MAX_SLOTS:
            raise ValueError(f"at most {MAX_SLOTS} slots a device, {dev} has {len(slots)}")
    return groups


def _chunks(x: RowShards, groups, chunks: int, launch) -> None:
    """Run ``launch(dev, c0, c1)`` (chunks [c0, c1) on the slots of ``dev``)
    over ``chunks`` chunks: in one call on one card; on several cards chunk
    by chunk, chunk c on a card waiting for chunk c - 1 on the cards holding
    its slots' ring neighbours (their rows are its ghost rows, and it
    overwrites the buffer they read)."""
    mesh, n = x.mesh, len(x.parts)
    if len(groups) == 1:
        launch(mesh.home, 0, chunks)
        return
    devs = list(groups)
    _enable_peers(devs)
    neighbours = {d: {mesh.devices[(s + k) % n] for s in groups[d] for k in (-1, 1)} - {d}
                  for d in devs}

    def record():
        events = {}
        for d in devs:
            events[d] = torch.cuda.Event()
            events[d].record(torch.cuda.current_stream(d))
        return events

    events = record()   # the inputs' producers
    for c in range(chunks):
        for d in devs:
            for nb in neighbours[d]:
                torch.cuda.current_stream(d).wait_event(events[nb])
            launch(d, c, c + 1)
        events = record()
    for d in devs:   # each card's outputs are read by its neighbours' next users
        for nb in neighbours[d]:
            torch.cuda.current_stream(d).wait_event(events[nb])


def _buffers(x: RowShards, steps: int):
    """(out, scratch, ctypes arrays of the in, scratch and out pointers)."""
    parts, n = x.parts, len(x.parts)
    out = [torch.empty_like(p) for p in parts]
    scratch = [torch.empty_like(p) for p in parts] if steps > 1 else out
    ptrs = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    return out, scratch, [ptrs(parts), ptrs(scratch), ptrs(out)]


def _launch(kernel, x: RowShards, rule_bits, steps: int, kind: int,
            defines: Tuple[str, ...] = ()) -> RowShards:
    parts = x.parts
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {steps}")
    if steps == 0:
        return x.map(torch.clone)
    n_inst, hl, w = parts[0].shape
    if n_inst > 65535:
        raise ValueError("a launch covers at most 65535 universes")
    n = len(parts)
    rules = _rules_by_device(rule_bits, x)
    groups = _slot_groups(x)
    out, scratch, arrays = _buffers(x, steps)
    slot_arrays = {dev: (ctypes.c_int * len(s))(*s) for dev, s in groups.items()}
    packed = kind == KIND_U32

    def launch(dev, t0, t1):
        rule = rules[dev]
        kernel.launch(kind, *(ctypes.cast(a, ctypes.c_void_p) for a in arrays),
                      ctypes.cast(slot_arrays[dev], ctypes.c_void_p), len(groups[dev]), n,
                      rule.data_ptr(), int(rule.ndim == 1), n_inst, hl, w, steps, t0, t1,
                      *stream_args(parts[groups[dev][0]]), defines=defines, packed=packed,
                      count=t1 - t0)   # the launcher launches once a generation

    _chunks(x, groups, steps, launch)
    return RowShards(out, x.mesh, x.axis)


def _band_rows(hl: int, nw: int, t: int) -> int:
    """The most rows, up to HALO_ROWS, of a band whose two copies with ``t``
    ghost rows a side fit shared memory as [rows + 2t, nw] words (<= 0:
    none fit)."""
    rows = min(HALO_ROWS, hl)
    while rows > 0 and 2 * (rows + 2 * t) * nw * 4 > HALO_SMEM_BYTES:
        rows -= 8
    return rows


def _strip(rows: int, t: int, groups: int) -> int:
    """Rows a compute strip, so that a generation's items about fill a block
    of HALO_THREADS."""
    return max(1, min(HALO_MAX_STRIP, (rows + 2 * t) * groups // HALO_THREADS))


def halo_plan(n_inst: int, hl: int, nw: int, steps: int, slots: int, sms: int,
              aligned: bool = True):
    """(T, V, rows, strip, threads) of bit_halo_words_launch for ``steps``
    generations of [n_inst, hl, nw] words on each of ``slots`` slots of a
    card with ``sms`` multiprocessors.  T = 1 (one generation, or one-row
    slots): the streaming kernel, (V, strip, threads) as
    ops.cuda_bitpack.stream_plan over the slots' universes, rows 0.  T > 1:
    T = min(HALO_T, hl, steps) generations a launch on bands of the most
    rows, up to HALO_ROWS, whose two copies with T ghost rows a side fit
    shared memory (the best plan measured at 8192² over 4 slots: T = 8,
    64 rows); compute strips of ``strip`` rows so that a generation's items
    about fill the block."""
    t = min(HALO_T, hl, steps)
    rows = _band_rows(hl, nw, t)
    if t <= 1 or rows <= 0:   # one generation a launch
        _, v, s, threads = stream_plan(n_inst * slots, hl, nw, sms, aligned)
        return (1, v, 0, s, threads)
    v = 4 if nw % 4 == 0 and aligned else 1
    return (t, v, rows, _strip(rows, t, nw // v), HALO_THREADS)


def u8_halo_plan(hl: int, w: int, steps: int, aligned: bool = True):
    """(T, V, rows, strip, threads) of u8_halo_bits_launch for ``steps``
    generations of uint8 slots of [hl, w] cells, or None where the route does
    not hold: one generation, a width not a multiple of 32, a buffer not
    16-byte aligned (a thread loads and stores 16 cells at once), or no band
    whose packed copies fit shared memory.  halo_plan's bands at T =
    min(HALO_T, hl, steps) >= 1 (8192² over 4 slots: T = 8, 64 rows, 512
    threads, one block a multiprocessor), the threads cut to whole warps
    that the first generation's items fill."""
    if steps <= 1 or w % 32 or not aligned:
        return None
    nw = w // 32
    t = min(HALO_T, hl, steps)
    rows = _band_rows(hl, nw, t)
    if rows <= 0:
        return None
    v = 4 if nw % 4 == 0 else 1
    strip = _strip(rows, t, nw // v)
    items = -(-(rows + 2 * t - 2) // strip) * (nw // v)
    return (t, v, rows, strip, min(HALO_THREADS, 32 * -(-items // 32)))


def _launch_chunks(kernel, x: RowShards, rule_bits, steps: int, plan, out, arrays, groups,
                   defines: Tuple[str, ...] = (), per_chunk: int = 1,
                   packed: bool = True) -> RowShards:
    """``steps`` generations in chunks of the plan's T by one of the
    chunked launchers (bit_halo_words_launch, u8_halo_bits_launch), one
    launch a chunk a device (``per_chunk`` a chunk where T = 1 streams)."""
    parts = x.parts
    n_inst, hl, w = parts[0].shape
    rules = _rules_by_device(rule_bits, x)
    t, v, rows, strip, threads = plan
    slot_arrays = {dev: (ctypes.c_int * len(s))(*s) for dev, s in groups.items()}

    def launch(dev, c0, c1):
        rule = rules[dev]
        kernel.launch(*(ctypes.cast(a, ctypes.c_void_p) for a in arrays),
                      ctypes.cast(slot_arrays[dev], ctypes.c_void_p), len(groups[dev]),
                      len(parts), rule.data_ptr(), int(rule.ndim == 1), n_inst, hl, w, steps, t,
                      c0, c1, v, max(rows, 1), strip, threads,
                      *stream_args(parts[groups[dev][0]]), defines=defines, packed=packed,
                      count=(c1 - c0) * per_chunk)

    _chunks(x, groups, -(-steps // t), launch)
    return RowShards(out, x.mesh, x.axis)


def _launch_words(x: RowShards, rule_bits, steps: int, defines: Tuple[str, ...] = (),
                  plan=None) -> RowShards:
    """bit_halo_words_launch: ``steps`` packed generations in chunks of the
    plan's T (default :func:`halo_plan`), one launch a chunk a device."""
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {steps}")
    if steps == 0:
        return x.map(torch.clone)
    n_inst, hl, nw = x.parts[0].shape
    groups = _slot_groups(x)
    out, scratch, arrays = _buffers(x, steps)
    if plan is None:
        aligned = all(t.data_ptr() % 16 == 0 for ts in (x.parts, scratch, out) for t in ts)
        plan = halo_plan(n_inst, hl, nw, steps, max(len(s) for s in groups.values()),
                         _multiprocessors(x.mesh.home), aligned)
    per_chunk = stream_launches(n_inst, hl, nw, plan[1], plan[3]) if plan[0] == 1 else 1
    return _launch_chunks(KERNEL_BIT_WORDS, x, rule_bits, steps, plan, out, arrays, groups,
                          defines, per_chunk)


def _launch_u8_bits(x: RowShards, rule_bits, steps: int, plan,
                    defines: Tuple[str, ...] = ()) -> RowShards:
    """u8_halo_bits_launch: ``steps`` >= 1 uint8 generations by ``plan``
    (:func:`u8_halo_plan`), one launch a chunk a device."""
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {steps}")
    groups = _slot_groups(x)
    out, _, arrays = _buffers(x, steps)
    return _launch_chunks(KERNEL_U8_BITS, x, rule_bits, steps, plan, out, arrays, groups,
                          defines, packed=False)


def _u8_multi(x: RowShards, rule_bits, steps: int) -> RowShards:
    """The uint8 burst on checked shards: the packed temporal-blocking kernel
    where :func:`u8_halo_plan` holds the shape and HALO_U8_BITS is on, else
    the present kernel."""
    _, hl, w = x.parts[0].shape
    plan = HALO_U8_BITS and u8_halo_plan(hl, w, int(steps),
                                         all(p.data_ptr() % 16 == 0 for p in x.parts))
    if plan:
        return _launch_u8_bits(x, rule_bits, steps, plan)
    return _launch(KERNEL_MULTI, x, rule_bits, steps, KIND_U8)


def spatial_ca_step_cuda(x: RowShards, rule_bits) -> RowShards:
    """One uint8 generation of row-sharded universes [N, H, W]; the rule a
    scalar or an [N] vector."""
    if _check(x, torch.uint8, "spatial_ca_step", rule_bits) == "cpu":
        return spatial_ca_step_plain(x, rule_bits)
    return _launch(KERNEL_STEP, x, rule_bits, 1, KIND_U8)


def spatial_multi_step_cuda(x: RowShards, rule_bits, num_steps: int) -> RowShards:
    """``num_steps`` uint8 generations of row-sharded universes."""
    if _check(x, torch.uint8, "spatial_multi_step", rule_bits) == "cpu":
        return spatial_multi_step_plain(x, rule_bits, num_steps)
    return _u8_multi(x, rule_bits, num_steps)


def bit_spatial_multi_step_cuda(x: RowShards, rule_bits, num_steps: int,
                                static_rules: Optional[Tuple] = None) -> RowShards:
    """``num_steps`` packed generations of row-sharded words [N, H, W/32];
    ``static_rules=(birth, survive)`` fixes the rule at compile time (the
    rule argument is then not read)."""
    if _check(x, torch.uint32, "bit_spatial_multi_step", rule_bits) == "cpu":
        return bit_spatial_multi_step_plain(x, rule_bits, num_steps, static_rules)
    defines, rule = (), rule_bits
    if static_rules is not None:
        rule = pack_rule_bits(*static_rules)
        defines = (f"STATIC_RULE={rule:#07x}",)
    if BIT_HALO_BLOCKS:
        return _launch_words(x, rule, num_steps, defines)
    return _launch(KERNEL_BIT, x, rule, num_steps, KIND_U32, defines)
