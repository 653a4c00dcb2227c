"""The halo kernels: Life-like generations of row-sharded universes on CUDA,
and their plain PyTorch twins (counterpart of
carle_tpu/parallel/pallas_halo.py).

* :func:`spatial_ca_step_cuda` — one uint8 generation
  (``spatial_ca_step_pallas``);
* :func:`spatial_env_step_cuda` — one uint8 generation with the env step's
  action window and master reset fused in: the step of the uint8 spatial env
  mode (parallel/spatial_env.py);
* :func:`spatial_multi_step_cuda` — K uint8 generations
  (``spatial_multi_step_pallas``);
* :func:`bit_spatial_multi_step_cuda` — K packed generations
  (``bit_spatial_multi_step_pallas``), the rule as data or, with
  ``static_rules``, fixed at compile time (one library a rule mask).

Each takes :class:`~.mesh.RowShards` of [N, H/n, W] uint8 cells or
[N, H/n, W/32] uint32 words and returns new shards, every slot on a device
in one launch, each slot reading its ring neighbours' edge rows in place
(the ring wraps: the torus).  On a two-axis env x space mesh each env
group's slots are a ring of their own: every launcher is handed one ring
at a time with its instances' rule entries and action (:func:`_by_ring`),
so a step launches once a ring a device, and the master reset's flag,
worked out once over the whole batch, goes to every ring.

One uint8 generation (the first two, and the third at K = 1) runs
``csrc/halo_words.cu`` (``halo_words_launch``, counted as
``spatial_ca_step_words``) where :func:`halo_words_route` holds the shape
(W % 16 == 0): row 1's design on row shards, a band of rows with a ghost
row a side staged by bulk copies, the action's toggles XOR-ed into the
staged rows the window covers, a thread a strip of a 16-byte column
(:func:`halo_words_plan`); the flag set, it writes zeros.  Other widths and
``HALO_U8_WORDS = False`` take the present ``halo_u8_kernel``
(``csrc/halo_step.cu``), the env step's window then XOR-ed into clones of
the slots it covers and the flag applied after.  The packed one
(``bit_halo_words_launch``, counted as ``bit_spatial_words``) runs one
generation by the streaming kernel, and K generations in chunks of T
(:func:`halo_plan`: T <= the slot's rows): one launch per device per chunk,
each a temporal-blocking kernel on bands staged with T ghost rows a side;
with ``BIT_HALO_BLOCKS = False`` it takes the present kernel, once per
device per generation.  The uint8 burst (``u8_halo_bits_launch``, counted as
``spatial_multi_step_bits``) runs the same temporal-blocking kernel on the
cells packed as they are staged and unpacked as they are stored, where
:func:`u8_halo_plan` holds the shape (K > 1, W % 32 == 0, a band's packed
copies fit shared memory); other shapes and ``HALO_U8_BITS = False`` take
the present uint8 kernel, once per device per generation.  Slots on several
cards run each launch (packed: each chunk) on every card's stream, each
waiting on an event its neighbours' cards recorded after the previous one;
that path needs peer access and has not run on a machine of several cards.
For CPU slots each takes its twin (``*_plain``): ghost rows copied from the
ring neighbours, the engines' update on the padded rows, columns rolled.
The step count is data (a host integer): no rebuild for another count.

**A ring that spans processes** (parallel/distributed.py): each process
launches for its own slots only.  The kernels index a neighbour's rows
through the slot pointer table, so a neighbour of another process gets a
*phantom*: a buffer of the slot's shape on the reading slot's device, whose
edge rows alone are filled, at the rows the kernel reads (the alternative,
ghost pointers handed to the launchers, would change every launcher's
signature and table for the same bytes; a phantom keeps the kernels and
their tables as they are).  Before each chunk (:func:`_chunks`) the ring's
processes trade the chunk's edge rows (parallel/ghosts.py, ``isend`` /
``irecv``): T rows a side once a chunk of T generations on the
temporal-blocking kernels, one row a side once a generation on the others,
words as words.  A process sends its slots' rows of the buffer the chunk
reads, after the kernel that wrote it (under gloo the copy to the host
waits for it; under NCCL the send is queued on the stream) and copies the
received rows into the phantoms on the reading slot's stream before the
launch.  The kernels never write a phantom (they write only the slots
they are given).  The twins trade one row a side a generation the same way.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..config import EnvConfig
from ..ops import bitpack
from ..ops.ca import apply_rule
from ..ops.cuda_bitpack import stream_launches, stream_plan
from ..ops.cuda_build import KERNELS, library, stream_args
from ..ops.cuda_ca import _multiprocessors
from ..rules import pack_rule_bits
from .ghosts import edge_rows, plan
from .mesh import RowShards, fill_meta, local_map, ringwise

KERNEL_STEP = KERNELS["spatial_ca_step"]
KERNEL_MULTI = KERNELS["spatial_multi_step"]
KERNEL_BIT = KERNELS["bit_spatial_multi_step"]
KERNEL_BIT_WORDS = KERNELS["bit_spatial_words"]
KERNEL_U8_BITS = KERNELS["spatial_multi_step_bits"]
KERNEL_WORDS = KERNELS["spatial_ca_step_words"]
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
# False: one uint8 generation (spatial_ca_step_cuda, spatial_env_step_cuda,
# spatial_multi_step_cuda at K = 1) launches the present uint8 kernel (the A/B)
HALO_U8_WORDS = True
# halo_words_launch's bands: blocks a multiprocessor whose staged bands fit
# shared memory together, threads a block
HALO_WORDS_BLOCKS = 3
HALO_WORDS_THREADS = 256
_BAR_BYTES = 16        # halo_words.cu's mbarrier slot ahead of the staged band
_BLOCK_RESERVED = 1024  # shared memory the runtime keeps for each block

__all__ = ["HALO_U8_WORDS", "KERNEL_BIT", "KERNEL_BIT_WORDS", "KERNEL_MULTI", "KERNEL_STEP",
           "KERNEL_U8_BITS", "KERNEL_WORDS", "bit_spatial_multi_step_cuda", "halo_plan",
           "halo_words_plan", "halo_words_route", "u8_halo_plan",
           "bit_spatial_multi_step_plain", "spatial_ca_step_cuda", "spatial_ca_step_plain",
           "spatial_env_step_cuda", "spatial_env_step_plain", "spatial_multi_step_cuda",
           "spatial_multi_step_plain"]


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _padded(x: RowShards, s: int, ghosts) -> torch.Tensor:
    """Slot s's rows with a ghost row from each ring neighbour: the last row
    of slot s-1 above, the first of slot s+1 below (torus); another
    process's from ``ghosts`` (parallel/ghosts.py's ``edge_rows``)."""
    parts, n = x.parts, len(x.parts)
    p, north, south = parts[s], (s - 1) % n, (s + 1) % n
    above = parts[north][:, -1:].to(p.device) if x.is_local(north) else ghosts[north, 1]
    below = parts[south][:, :1].to(p.device) if x.is_local(south) else ghosts[south, 0]
    return torch.cat([above, p, below], dim=1)


def _step_u8(x: RowShards, rule_bits) -> List[torch.Tensor]:
    ghosts = edge_rows(x, 1)

    def step(s, p):
        g = _padded(x, s, ghosts).to(torch.int32)
        rows = g[:, :-2] + g[:, 1:-1] + g[:, 2:]
        counts = rows + torch.roll(rows, 1, dims=-1) + torch.roll(rows, -1, dims=-1) - g[:, 1:-1]
        return apply_rule(p, counts, torch.as_tensor(rule_bits).to(p.device))

    return local_map(x, step)


def _step_u32(x: RowShards, rule_bits, static_rules) -> List[torch.Tensor]:
    """One packed generation: bitpack's carry-save count with the vertical
    neighbours from the ghost rows, its rule mux (data or fixed)."""
    ghosts = edge_rows(x, 1)

    def step(s, p):
        g = _padded(x, s, ghosts).to(torch.int64)
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
        return new.to(torch.uint32)

    return local_map(x, step)


def _multi_plain(x: RowShards, steps: int, step) -> RowShards:
    """``steps`` generations of ``step(shards) -> parts``."""
    if int(steps) == 0:
        return x.map(torch.clone)
    for _ in range(int(steps)):
        x = RowShards(step(x), x.mesh, x.axis)
    return x


def _by_ring(x: RowShards, rule_bits, fn) -> RowShards:
    """``fn(ring, its rule, its instances)`` of each env group's ring
    (parallel.mesh.ringwise; one ring on a one-axis mesh): a rule vector [N]
    gives each ring its instances' entries.  Ghost rows then come only from
    the slot's own ring."""
    if not isinstance(x, RowShards):
        raise TypeError(f"the halo steps take RowShards (parallel.mesh.shard_rows), "
                        f"got {type(x)}")
    rule = _rule(rule_bits, x)
    return ringwise(x, lambda ring, e: fn(ring, _by_instance(rule, x, e) if rule.ndim == 1
                                          else rule, x.batch_rows(e)))


def _by_instance(t: torch.Tensor, x: RowShards, e: int) -> torch.Tensor:
    """Ring e's instances of a per-instance tensor: of the whole batch's
    ([N, ...]) or of this process's (``x.local_instances()``)."""
    if t.shape[0] == x.shape[0]:
        return t[x.instances()[e]]
    return t[x.batch_rows(e)]


def spatial_ca_step_plain(x: RowShards, rule_bits) -> RowShards:
    """One uint8 generation of row-sharded universes, ghost rows by copy."""
    return _by_ring(x, rule_bits, lambda r, rule, _: _multi_plain(
        r, 1, lambda y: _step_u8(y, rule)))


def _toggled(x: RowShards, action: torch.Tensor, config: EnvConfig) -> List[torch.Tensor]:
    """The slots of one ring with the [N, AH, AW] action's toggles (nonzero
    bytes; N the ring's instances) XOR-ed into the config's centred window:
    a clone of each slot whose rows the window covers, the others as they
    are."""
    r0, c0 = config.action_row_offset, config.action_col_offset
    ah, aw = action.shape[-2:]
    offsets = x.offsets()

    def toggle(i, p):
        a = offsets[i]
        lo, hi = max(a, r0), min(a + x.rows, r0 + ah)
        if lo < hi:
            p = p.clone()
            p[:, lo - a:hi - a, c0:c0 + aw] ^= (action[:, lo - r0:hi - r0] != 0).to(
                device=p.device, dtype=torch.uint8)
        return p

    return local_map(x, toggle)


def _zeroed(x: RowShards, reset: Optional[torch.Tensor]) -> RowShards:
    """Every slot all zeros where the 0-d ``reset`` flag is set (the flag of
    the whole batch, on a two-axis mesh the same for every ring)."""
    if reset is None:
        return x
    return x.map(lambda p: torch.where(reset.to(p.device) != 0, torch.zeros_like(p), p))


def spatial_env_step_plain(x: RowShards, action: torch.Tensor, rule_bits, config: EnvConfig,
                           reset: Optional[torch.Tensor] = None) -> RowShards:
    """One env-mode generation of row-sharded uint8 universes: the action's
    toggles XOR-ed into the centred window, one generation, zeros under the
    reset flag."""
    def ring(r, rule, sl):
        toggled = RowShards(_toggled(r, action[sl], config), r.mesh, r.axis)
        return _multi_plain(toggled, 1, lambda y: _step_u8(y, rule))

    return _zeroed(_by_ring(x, rule_bits, ring), reset)


def spatial_multi_step_plain(x: RowShards, rule_bits, num_steps: int) -> RowShards:
    """``num_steps`` uint8 generations (:func:`spatial_ca_step_plain` each)."""
    return _by_ring(x, rule_bits, lambda r, rule, _: _multi_plain(
        r, num_steps, lambda y: _step_u8(y, rule)))


def bit_spatial_multi_step_plain(x: RowShards, rule_bits, num_steps: int,
                                 static_rules: Optional[Tuple] = None) -> RowShards:
    """``num_steps`` packed generations of row-sharded words."""
    return _by_ring(x, rule_bits, lambda r, rule, _: _multi_plain(
        r, num_steps, lambda y: _step_u32(y, rule, static_rules)))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check(x: RowShards, dtype: torch.dtype, name: str, rule_bits) -> str:
    """'cpu' or 'cuda': where the slots are, after checking the shards and
    the rule."""
    if not isinstance(x, RowShards):
        raise TypeError(f"{name} takes RowShards (parallel.mesh.shard_rows), got {type(x)}")
    for s in x.mesh.local_slots:
        p, dev = x.parts[s], x.mesh.devices[s]
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
    """The rule, a scalar or a vector over the whole batch or over this
    process's instances (:func:`_by_instance`)."""
    rule = torch.as_tensor(rule_bits, dtype=torch.int32)
    n, sl = x.shape[0], x.local_instances()
    if rule.ndim > 1 or (rule.ndim == 1 and rule.shape[0] not in (n, sl.stop - sl.start)):
        raise ValueError(f"rule must be a scalar or a [{n}] vector, got shape "
                         f"{tuple(rule.shape)}")
    return rule


def _rules_by_device(rule_bits, x: RowShards) -> Dict[torch.device, torch.Tensor]:
    rule = _rule(rule_bits, x)
    return {x.mesh.devices[s]: rule.to(x.mesh.devices[s]).contiguous()
            for s in x.mesh.local_slots}


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
    """This process's slots of each device, in ring order."""
    groups: Dict[torch.device, List[int]] = {}
    for s in x.mesh.local_slots:
        groups.setdefault(x.mesh.devices[s], []).append(s)
    for dev, slots in groups.items():
        if len(slots) > MAX_SLOTS:
            raise ValueError(f"at most {MAX_SLOTS} slots a device, {dev} has {len(slots)}")
    return groups


def _chunks(x: RowShards, groups, chunks: int, launch, trade=None) -> None:
    """Run ``launch(dev, c0, c1)`` (chunks [c0, c1) on the slots of ``dev``)
    over ``chunks`` chunks: in one call on one card; on several cards, or
    with ``trade(c)`` (the ghost rows of chunk c from other processes,
    :class:`_Phantoms`), chunk by chunk, chunk c on a card waiting for chunk
    c - 1 on the cards holding its slots' ring neighbours (their rows are
    its ghost rows, and it overwrites the buffer they read)."""
    mesh, n = x.mesh, len(x.parts)
    if len(groups) == 1 and trade is None:
        launch(mesh.home, 0, chunks)
        return
    if len(groups) == 1:
        for c in range(chunks):
            trade(c)
            launch(mesh.home, c, c + 1)
        return
    devs = list(groups)
    _enable_peers(devs)
    neighbours = {d: {mesh.devices[(s + k) % n] for s in groups[d] for k in (-1, 1)
                      if mesh.is_local((s + k) % n)} - {d}
                  for d in devs}

    def record():
        events = {}
        for d in devs:
            events[d] = torch.cuda.Event()
            events[d].record(torch.cuda.current_stream(d))
        return events

    events = record()   # the inputs' producers
    for c in range(chunks):
        if trade is not None:
            trade(c)
        for d in devs:
            for nb in neighbours[d]:
                torch.cuda.current_stream(d).wait_event(events[nb])
            launch(d, c, c + 1)
        events = record()
    for d in devs:   # each card's outputs are read by its neighbours' next users
        for nb in neighbours[d]:
            torch.cuda.current_stream(d).wait_event(events[nb])


# phantom buffers by (slot, shape, dtype, device), kept from call to call:
# each call fills the edge rows it reads on the reading slot's stream before
# its launch, so a call reuses a buffer only after the last one's kernels
_PHANTOM_CACHE: Dict[Tuple[int, Tuple[int, ...], torch.dtype, torch.device], torch.Tensor] = {}


class _Phantoms:
    """A ring's neighbours of other processes as buffers of the slot's shape
    on the reading slot's device (allocated once a slot, shape and device:
    :data:`_PHANTOM_CACHE`), their edge rows filled before each chunk by
    ``trade(c)`` (module note); none where the ring is one process's."""

    def __init__(self, x: RowShards, rows: int) -> None:
        self.x, self.rows = x, rows
        self.buffers: Dict[int, torch.Tensor] = {}
        if x.mesh.multi:
            for (j, _), _, reader in plan(x, True)[1]:
                if j in self.buffers:
                    continue
                p, dev = x.parts[j], x.mesh.devices[reader]
                key = (j, tuple(p.shape), p.dtype, dev)
                if key not in _PHANTOM_CACHE:
                    _PHANTOM_CACHE[key] = torch.empty(p.shape, dtype=p.dtype, device=dev)
                self.buffers[j] = _PHANTOM_CACHE[key]

    def ptr(self, s: int, t: torch.Tensor) -> int:
        if self.x.is_local(s):
            return t.data_ptr()
        return self.buffers[s].data_ptr() if s in self.buffers else 0

    def trader(self, source):
        """``trade(c)``: chunk c's edge rows of ``source(c)`` (this process's
        parts the chunk reads) into the phantoms; None where there are
        none."""
        if not self.buffers:
            return None
        k, x = self.rows, self.x

        def trade(c):
            for (j, edge), rows in edge_rows(x, k, True, source(c)).items():
                buf = self.buffers[j]
                buf.narrow(-2, 0 if edge == 0 else buf.shape[-2] - k, k).copy_(rows)

        return trade

    def shards(self, parts: List[torch.Tensor]) -> RowShards:
        """Results of this process's slots as shards (the others ``meta``)."""
        return RowShards(fill_meta([p if self.x.is_local(i) else None
                                    for i, p in enumerate(parts)]), self.x.mesh, self.x.axis)


def _buffers(x: RowShards, steps: int, phantoms: "_Phantoms"):
    """(out, scratch, ctypes arrays of the in, scratch and out pointers); a
    slot of another process reads as its phantom (or nothing)."""
    parts, n = x.parts, len(x.parts)
    alloc = lambda: [torch.empty_like(p) if x.is_local(i) else p  # noqa: E731
                     for i, p in enumerate(parts)]
    out = alloc()
    scratch = alloc() if steps > 1 else out
    ptrs = lambda ts: (ctypes.c_void_p * n)(*(phantoms.ptr(i, t) for i, t in enumerate(ts)))
    return out, scratch, [ptrs(parts), ptrs(scratch), ptrs(out)]


def _source(x: RowShards, out, scratch, chunks: int):
    """``source(c)``: the parts chunk c reads (halo_step.cu's run_chunks: the
    input first, then what chunk c - 1 wrote)."""
    return lambda c: x.parts if c == 0 else (out if (chunks - (c - 1)) % 2 else scratch)


def _local(x: RowShards, ts) -> List[torch.Tensor]:
    return [t for i, t in enumerate(ts) if x.is_local(i)]


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
    phantoms = _Phantoms(x, 1)
    out, scratch, arrays = _buffers(x, steps, phantoms)
    slot_arrays = {dev: (ctypes.c_int * len(s))(*s) for dev, s in groups.items()}
    packed = kind == KIND_U32

    def launch(dev, t0, t1):
        rule = rules[dev]
        kernel.launch(kind, *(ctypes.cast(a, ctypes.c_void_p) for a in arrays),
                      ctypes.cast(slot_arrays[dev], ctypes.c_void_p), len(groups[dev]), n,
                      rule.data_ptr(), int(rule.ndim == 1), n_inst, hl, w, steps, t0, t1,
                      *stream_args(parts[groups[dev][0]]), defines=defines, packed=packed,
                      count=t1 - t0)   # the launcher launches once a generation

    _chunks(x, groups, steps, launch, phantoms.trader(_source(x, out, scratch, steps)))
    return phantoms.shards(out)


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


def _launch_chunks(kernel, x: RowShards, rule_bits, steps: int, plan, bufs, groups,
                   phantoms: "_Phantoms", defines: Tuple[str, ...] = (), per_chunk: int = 1,
                   packed: bool = True) -> RowShards:
    """``steps`` generations in chunks of the plan's T by one of the
    chunked launchers (bit_halo_words_launch, u8_halo_bits_launch), one
    launch a chunk a device (``per_chunk`` a chunk where T = 1 streams);
    ``bufs`` is :func:`_buffers`' (out, scratch, arrays), ``phantoms`` with
    T rows a side."""
    out, scratch, arrays = bufs
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

    chunks = -(-steps // t)
    _chunks(x, groups, chunks, launch, phantoms.trader(_source(x, out, scratch, chunks)))
    return phantoms.shards(out)


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
    phantoms = _Phantoms(x, 0)
    bufs = _buffers(x, steps, phantoms)
    if plan is None:
        aligned = all(t.data_ptr() % 16 == 0 for ts in (x.parts, bufs[1], bufs[0])
                      for t in _local(x, ts))
        plan = halo_plan(n_inst, hl, nw, steps, max(len(s) for s in groups.values()),
                         _multiprocessors(x.mesh.home), aligned)
    phantoms.rows = plan[0]
    per_chunk = stream_launches(n_inst, hl, nw, plan[1], plan[3]) if plan[0] == 1 else 1
    return _launch_chunks(KERNEL_BIT_WORDS, x, rule_bits, steps, plan, bufs, groups, phantoms,
                          defines, per_chunk)


def _launch_u8_bits(x: RowShards, rule_bits, steps: int, plan,
                    defines: Tuple[str, ...] = ()) -> RowShards:
    """u8_halo_bits_launch: ``steps`` >= 1 uint8 generations by ``plan``
    (:func:`u8_halo_plan`), one launch a chunk a device."""
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {steps}")
    groups = _slot_groups(x)
    phantoms = _Phantoms(x, plan[0])
    return _launch_chunks(KERNEL_U8_BITS, x, rule_bits, steps, plan,
                          _buffers(x, steps, phantoms), groups, phantoms, defines, packed=False)


def halo_words_route(hl: int, w: int) -> str:
    """Which kernel takes one uint8 generation of slots of [hl, w] cells on
    the card: ``"words"`` (halo_words.cu: w % 16 == 0 and a band of one row
    with its two ghost rows fits shared memory) or ``"present"``
    (``halo_u8_kernel``, and every shape while HALO_U8_WORDS is off);
    decided by the shape alone, on any device."""
    if HALO_U8_WORDS and w % 16 == 0 and _BAR_BYTES + 3 * w <= HALO_SMEM_BYTES:
        return "words"
    return "present"


def halo_words_plan(n_inst: int, hl: int, w: int, slots: int, sms: int) -> Tuple[int, int, int]:
    """(band rows, strip rows, threads) of halo_words_launch for one
    generation of n_inst universes of [hl, w] cells on each of ``slots``
    slots of a card with ``sms`` multiprocessors: bands of the most rows, to
    a slot's, whose staged copy with its two ghost rows lets
    HALO_WORDS_BLOCKS blocks share a multiprocessor (halved while that
    leaves fewer than two blocks a multiprocessor: 8192² over 4 slots, 7
    rows, 3 blocks of 72 KB); a thread a strip of a 16-byte column, strips
    that give each of HALO_WORDS_THREADS threads at least one, the threads
    cut to whole warps the items fill."""
    budget = HALO_SMEM_BYTES // HALO_WORDS_BLOCKS - _BLOCK_RESERVED - _BAR_BYTES
    rows = max(1, min(hl, budget // w - 2))
    while rows > 1 and n_inst * slots * -(-hl // rows) < 2 * sms:
        rows = -(-rows // 2)
    columns = w // 16
    strip = -(-rows // max(1, HALO_WORDS_THREADS // columns))
    items = columns * -(-rows // strip)
    return rows, strip, min(HALO_WORDS_THREADS, 32 * -(-items // 32))


def _check_env(x: RowShards, action: torch.Tensor, config: EnvConfig, reset) -> None:
    """The env step's checks: the shards the config's universe, the action
    its [N, AH, AW] uint8 window on the home device, the flag one byte."""
    n = x.shape[0]
    ah, aw = config.eff_action_height, config.eff_action_width
    if tuple(x.shape) != (n, config.height, config.width):
        raise ValueError(f"universe {tuple(x.shape)[1:]} does not match the config "
                         f"{config.height}x{config.width}")
    sl = x.local_instances()
    n = sl.stop - sl.start   # this process's instances (all within one process)
    if (action.shape != (n, ah, aw) or action.dtype != torch.uint8
            or action.device != x.mesh.home or not action.is_contiguous()):
        raise ValueError(f"action must be a contiguous uint8 [{n}, {ah}, {aw}] tensor on "
                         f"{x.mesh.home}")
    if reset is not None and (reset.dtype not in (torch.bool, torch.uint8)
                              or reset.numel() != 1 or reset.device != x.mesh.home):
        raise ValueError(f"reset must be a one-element bool or uint8 tensor on {x.mesh.home}")


def _launch_halo_words(x: RowShards, rule_bits, action: Optional[torch.Tensor] = None,
                       config: Optional[EnvConfig] = None,
                       reset: Optional[torch.Tensor] = None,
                       plan: Optional[Tuple[int, int, int]] = None) -> RowShards:
    """halo_words_launch: one generation of checked uint8 shards, the action
    (with the config's window) and the reset flag fused in where given; one
    launch a device (``plan`` overrides :func:`halo_words_plan`)."""
    parts = x.parts
    n_inst, hl, w = parts[0].shape
    groups = _slot_groups(x)
    phantoms = _Phantoms(x, 1)
    out, _, (in_ptrs, _, out_ptrs) = _buffers(x, 1, phantoms)
    if w % 16 or any(t.data_ptr() % 16 for ts in (parts, out) for t in _local(x, ts)):
        raise ValueError("halo_words reads 16-byte columns: width % 16 == 0 and "
                         "16-byte aligned shards")
    rows, strip, threads = plan or halo_words_plan(
        n_inst, hl, w, max(len(s) for s in groups.values()), _multiprocessors(x.mesh.home))
    if _BAR_BYTES + (rows + 2) * w > HALO_SMEM_BYTES:
        raise ValueError(f"a band of {rows} rows of width {w} exceeds shared memory")
    rules = _rules_by_device(rule_bits, x)
    on = lambda t: {d: t.to(d).contiguous() for d in groups} if t is not None else {}
    actions, resets = on(action), on(reset)
    ah, aw, r0, c0 = ((action.shape[1], action.shape[2], config.action_row_offset,
                       config.action_col_offset) if action is not None else (0, 0, 0, 0))
    slot_arrays = {dev: (ctypes.c_int * len(s))(*s) for dev, s in groups.items()}

    def launch(dev, *_):   # one generation: _chunks' one chunk
        rule = rules[dev]
        KERNEL_WORDS.launch(*(ctypes.cast(a, ctypes.c_void_p) for a in (in_ptrs, out_ptrs)),
                            ctypes.cast(slot_arrays[dev], ctypes.c_void_p), len(groups[dev]),
                            len(parts), actions[dev].data_ptr() if actions else None, ah, aw,
                            r0, c0,
                            rule.data_ptr(), int(rule.ndim == 1),
                            resets[dev].data_ptr() if resets else None, n_inst, hl, w, rows,
                            strip, threads, *stream_args(parts[groups[dev][0]]))

    _chunks(x, groups, 1, launch, phantoms.trader(lambda c: parts))
    return phantoms.shards(out)


def _u8_step(x: RowShards, rule_bits) -> RowShards:
    """One uint8 generation of checked shards: halo_words where
    :func:`halo_words_route` holds the shape, else the present kernel."""
    _, hl, w = x.parts[0].shape
    if halo_words_route(hl, w) == "words":
        return _launch_halo_words(x, rule_bits)
    return _launch(KERNEL_STEP, x, rule_bits, 1, KIND_U8)


def _u8_multi(x: RowShards, rule_bits, steps: int) -> RowShards:
    """The uint8 burst on checked shards: one generation by :func:`_u8_step`;
    more by the packed temporal-blocking kernel where :func:`u8_halo_plan`
    holds the shape and HALO_U8_BITS is on, else the present kernel."""
    if int(steps) == 1:
        return _u8_step(x, rule_bits)
    _, hl, w = x.parts[0].shape
    plan = HALO_U8_BITS and u8_halo_plan(hl, w, int(steps),
                                         all(p.data_ptr() % 16 == 0 for p in _local(x, x.parts)))
    if plan:
        return _launch_u8_bits(x, rule_bits, steps, plan)
    return _launch(KERNEL_MULTI, x, rule_bits, steps, KIND_U8)


def spatial_ca_step_cuda(x: RowShards, rule_bits) -> RowShards:
    """One uint8 generation of row-sharded universes [N, H, W]; the rule a
    scalar or an [N] vector."""
    def ring(r, rule, _):
        if _check(r, torch.uint8, "spatial_ca_step", rule) == "cpu":
            return spatial_ca_step_plain(r, rule)
        return _u8_step(r, rule)

    return _by_ring(x, rule_bits, ring)


def spatial_env_step_cuda(x: RowShards, action: torch.Tensor, rule_bits, config: EnvConfig,
                          reset: Optional[torch.Tensor] = None) -> RowShards:
    """One env-mode generation of row-sharded uint8 universes [N, H, W]: the
    nonzero bytes of the uint8 [N, AH, AW] action toggle the config's centred
    window, then one generation; all zeros where the 0-d bool or uint8
    ``reset`` (a flag on the mesh's home device that the host never reads) is
    set.  On the card one halo_words launch a device; where the route leaves
    the shape, the window XOR-ed into clones of the slots it covers, the
    present kernel, then the flag."""
    if not isinstance(x, RowShards):
        raise TypeError(f"spatial_env_step takes RowShards, got {type(x)}")
    _check_env(x, action, config, reset)

    def ring(r, rule, sl):   # the flag is the whole batch's: every ring gets it
        act = action[sl]   # action: this process's instances
        if _check(r, torch.uint8, "spatial_env_step", rule) == "cpu":
            return spatial_env_step_plain(r, act, rule, config, reset)
        _, hl, w = r.parts[0].shape
        if halo_words_route(hl, w) == "words":
            return _launch_halo_words(r, rule, act, config, reset)
        toggled = RowShards(_toggled(r, act, config), r.mesh, r.axis)
        return _zeroed(_launch(KERNEL_STEP, toggled, rule, 1, KIND_U8), reset)

    return _by_ring(x, rule_bits, ring)


def spatial_multi_step_cuda(x: RowShards, rule_bits, num_steps: int) -> RowShards:
    """``num_steps`` uint8 generations of row-sharded universes."""
    def ring(r, rule, _):
        if _check(r, torch.uint8, "spatial_multi_step", rule) == "cpu":
            return spatial_multi_step_plain(r, rule, num_steps)
        return _u8_multi(r, rule, num_steps)

    return _by_ring(x, rule_bits, ring)


def bit_spatial_multi_step_cuda(x: RowShards, rule_bits, num_steps: int,
                                static_rules: Optional[Tuple] = None) -> RowShards:
    """``num_steps`` packed generations of row-sharded words [N, H, W/32];
    ``static_rules=(birth, survive)`` fixes the rule at compile time (the
    rule argument is then not read)."""
    def ring(r, rule, _):
        if _check(r, torch.uint32, "bit_spatial_multi_step", rule) == "cpu":
            return bit_spatial_multi_step_plain(r, rule, num_steps, static_rules)
        defines = ()
        if static_rules is not None:
            rule = pack_rule_bits(*static_rules)
            defines = (f"STATIC_RULE={rule:#07x}",)
        if BIT_HALO_BLOCKS:
            return _launch_words(r, rule, num_steps, defines)
        return _launch(KERNEL_BIT, r, rule, num_steps, KIND_U32, defines)

    return _by_ring(x, rule_bits, ring)
