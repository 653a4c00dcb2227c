"""Several processes over one mesh (counterpart of ``jax.distributed``:
``initialize``, ``process_count``, ``process_index`` and ``jax.devices()``
spanning processes).

Each process contributes its slots (``local_devices``: one card, several
slots of one card, or ``cpu`` slots) and :func:`global_slots` lists every
process's slots in process order, as ``jax.devices()`` lists every host's
devices.  ``parallel.mesh.make_mesh()`` under an initialised group spans
them: each slot has an owner process, a process holds only its own slots'
shards, and what crosses processes goes through this module:

* ghost rows by :func:`exchange` (``irecv`` posted before ``isend``, both
  waited on): the halo steps' rows a chunk, the nets' halo rows
  (parallel/ghosts.py);
* batch-global terms by :func:`all_reduce` / :func:`world_sum` (sums in
  place, the second differentiable: its backward is the same sum of the
  cotangents): the master-reset flag, the learners' gradient sums, Speed's
  and Puffer's batch sums, the error sums and gathers of a universe whose
  rows span processes.

**The backend rule** (:func:`choose_backend`): NCCL where every slot of the
process is a CUDA device and the host has a card for each of its processes
(``LOCAL_WORLD_SIZE``, else the group's size), so every process has cards of
its own; gloo on the CPU and where processes share a card (NCCL cannot put
two ranks on one card).  ``backend=`` overrides the rule; an NCCL group
that cannot form raises with NCCL's own message at the first collective,
which :func:`initialize` runs.  gloo moves no CUDA tensor point to point, so
under gloo a CUDA tensor is staged through host memory (pinned where it is
received): the copy to the host waits for the kernel that wrote it, the
copy back is queued on the slot's stream before the kernel that reads it.
Under NCCL the rows go from the device.  :data:`STATS` counts the
collectives by kind, the exchanges, the bytes sent and the host-staging
seconds.

A run over several processes equals one process's run on the same mesh:
the universes bit for bit, the rewards up to the gradients' summation
order.  One exception: a net launched once over a process's instances (a
wrapper's ``fused_head`` without a mesh) numbers them from 0 in its kernels'
dropout draw, so on an instance split its masks are not one process's; a
``Mesh`` as ``fused_head`` (what ``train`` passes) seeds each slot by its
global index and draws the same.

**The launcher**::

    python -m carle_tpu_torch.parallel.distributed --nprocs N \\
        [--slots-per-process K] [--device cpu|cuda] [--timeout S] \\
        module:function [args ...]

spawns N processes (``subprocess``); each initialises the group (rendezvous
by ``file://`` in a temporary directory: a free TCP port races under
parallel test runs) with K slots of its device (``cuda``: card ``LOCAL_RANK``
modulo the cards) and calls ``function(args)`` (a list of strings;
``module`` may be a ``path/to/file.py``).  The parent waits up to the
timeout (:data:`LAUNCH_TIMEOUT_S` unless given), kills every child when one
fails or the time runs out, and exits non-zero with the failing child's
last lines.  :func:`launch` is the same from Python, with the same
defaults (``cuda`` slots: ask for ``cpu``).  ``torchrun`` works too:
:func:`initialize` with no arguments reads ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_LOCAL: Dict[str, Any] = {"devices": None}
# how long the launcher waits for its children, from Python and the command line
LAUNCH_TIMEOUT_S = 3600.0
# what crossed processes since reset_stats(): collectives by kind, ghost-row
# exchanges, messages and bytes sent, seconds spent staging through the host
STATS: Dict[str, float] = {}


def reset_stats() -> None:
    STATS.update(all_reduce=0, exchanges=0, messages=0, bytes_sent=0, staging_s=0.0)


reset_stats()


def _count(key: str, value: float = 1) -> None:
    STATS[key] = STATS.get(key, 0) + value


# ---------------------------------------------------------------------------
# the group
# ---------------------------------------------------------------------------


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"initialize() needs {name} (or its argument): the variables "
                         "torchrun sets")
    return int(os.environ[name])


def _init_url(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError("initialize() needs coordinator_address or MASTER_ADDR and "
                             "MASTER_PORT")
        return f"tcp://{addr}:{port}"
    return coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"


def choose_backend(local_devices: Sequence[Any], local_processes: int) -> str:
    """The backend rule (module note): ``"nccl"`` where every slot is a CUDA
    device and the host has at least a card a process, else ``"gloo"``."""
    cuda = all(torch.device(d).type == "cuda" for d in local_devices)
    if cuda and torch.cuda.is_available() and torch.cuda.device_count() >= local_processes:
        return "nccl"
    return "gloo"


def _device(d: Any) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               local_devices: Optional[Sequence[Any]] = None) -> None:
    """Join the group (``jax.distributed.initialize``).  Without arguments
    the torchrun variables say where and who: ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the card.
    ``coordinator_address`` is ``host:port`` or an init URL (``file://...``).
    ``local_devices`` are this process's mesh slots (default: card
    ``LOCAL_RANK`` modulo the cards, or ``cpu`` without one).  The backend
    as :func:`choose_backend` unless given.  A failed rendezvous or an NCCL
    group that cannot form raises.

    Under a group of several processes a process's slots lie on one card
    (or the CPU): the halo rows' backward and the learners' sums run
    collectives inside autograd's backward, which runs on one thread a
    card, so with several cards a process the processes could issue them
    in different orders (ROADMAP: several cards and NCCL, not run)."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    n = _env_int("WORLD_SIZE", num_processes)
    rank = _env_int("RANK", process_id)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if local_devices is None:
        if torch.cuda.is_available():
            local_devices = [torch.device("cuda", local_rank % torch.cuda.device_count())]
        else:
            local_devices = [torch.device("cpu")]
    devices = [_device(d) for d in local_devices]
    if not devices:
        raise ValueError("a process needs at least one slot")
    cards = {d.index for d in devices if d.type == "cuda"}
    if n > 1 and len(cards) > 1:
        raise ValueError(f"a process of a group brings slots of one card, got cards "
                         f"{sorted(cards)}: collectives in autograd's backward run on one "
                         "thread a card and could pair across processes out of order")
    backend = backend or choose_backend(devices, local_world)
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, init_method=_init_url(coordinator_address),
                            world_size=n, rank=rank)
    _LOCAL["devices"] = devices
    if backend == "nccl":   # forms the communicator: NCCL's own error raises here
        cards = [None] * n
        dist.all_gather_object(cards, (socket.gethostname(), sorted({d.index for d in devices})))
        seen: Dict[Tuple[str, int], int] = {}
        for r, (host, idx) in enumerate(cards):
            for i in idx:
                if (host, i) in seen:
                    raise RuntimeError(f"NCCL cannot put ranks {seen[host, i]} and {r} on one "
                                       f"card (cuda:{i} of {host}); use backend='gloo'")
                seen[host, i] = r


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if is_initialized() else 0


def backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def local_devices() -> List[torch.device]:
    """This process's slots (as :func:`initialize` took them; without a group
    every visible card, or none)."""
    if _LOCAL["devices"] is not None:
        return list(_LOCAL["devices"])
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return []


def global_slots() -> List[Tuple[int, torch.device]]:
    """Every process's slots in process order, as (owner rank, device): each
    process's :func:`local_devices`, gathered (``all_gather_object``)."""
    mine = [str(d) for d in local_devices()]
    if not is_initialized():
        return [(0, torch.device(d)) for d in mine]
    every: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return [(r, torch.device(d)) for r, ds in enumerate(every) for d in ds]


def shutdown() -> None:
    """Leave the group (no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()
    _LOCAL["devices"] = None


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor) -> bool:
    """Whether a tensor goes through host memory (a CUDA tensor under gloo)."""
    return t.is_cuda and backend() == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as the backends take it: uint32 words as int32, bool as
    uint8 (the same bits)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    return t


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the processes in place (a CUDA tensor under gloo
    through the host) and return it; every process gets the same bits."""
    _count("all_reduce")
    w = _wire(t)
    if _staged(w):
        t0 = time.perf_counter()
        host = w.to("cpu")
        _count("staging_s", time.perf_counter() - t0)
        dist.all_reduce(host)
        t0 = time.perf_counter()
        w.copy_(host)
        _count("staging_s", time.perf_counter() - t0)
    else:
        dist.all_reduce(w)
    return t


class _WorldSum(torch.autograd.Function):
    """The sum over the processes; its cotangent is the sum of theirs (every
    process's loss adds up to the global one)."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone())


def world_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes, a new tensor, differentiable."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _WorldSum.apply(t)
    return all_reduce(t.detach().clone())


class Recv(NamedTuple):
    """A message to receive: from ``peer`` with ``tag``, a tensor of ``shape``
    and ``dtype`` that lands on ``device``."""

    peer: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    tag: int


def exchange(sends: Sequence[Tuple[int, torch.Tensor, int]], recvs: Sequence[Recv]
             ) -> List[torch.Tensor]:
    """Point-to-point messages: every ``irecv`` posted first, then every
    ``isend`` (``(peer, tensor, tag)``), all waited on; returns the received
    tensors in the order of ``recvs``.  Both sides must list a pair's
    messages in the same order (NCCL matches them by order, gloo by tag).
    Under gloo CUDA tensors go through host memory (module note)."""
    if not sends and not recvs:
        return []
    nccl = backend() == "nccl"
    t0 = time.perf_counter()
    landing = []
    for r in recvs:
        staged = r.device.type == "cuda" and not nccl
        buf = torch.empty(r.shape, dtype=r.dtype,
                          device="cpu" if staged else r.device,
                          pin_memory=staged)
        landing.append(buf)
    outgoing = []
    for peer, t, tag in sends:
        t = t.contiguous()
        outgoing.append((peer, t.to("cpu") if _staged(t) else t, tag))
    staging = time.perf_counter() - t0
    if nccl:
        ops = ([dist.P2POp(dist.irecv, _wire(b), r.peer, tag=r.tag)
                for r, b in zip(recvs, landing)]
               + [dist.P2POp(dist.isend, _wire(t), peer, tag=tag) for peer, t, tag in outgoing])
        works = dist.batch_isend_irecv(ops)
    else:
        works = ([dist.irecv(_wire(b), src=r.peer, tag=r.tag) for r, b in zip(recvs, landing)]
                 + [dist.isend(_wire(t), dst=peer, tag=tag) for peer, t, tag in outgoing])
    for w in works:
        w.wait()
    t0 = time.perf_counter()
    out = [b.to(r.device, non_blocking=True) if b.device != r.device else b
           for r, b in zip(recvs, landing)]
    _count("staging_s", staging + time.perf_counter() - t0)
    _count("exchanges")
    _count("messages", len(outgoing))
    _count("bytes_sent", sum(t.numel() * t.element_size() for _, t, _ in outgoing))
    return out


# ---------------------------------------------------------------------------
# this process's window of the instance batch
# ---------------------------------------------------------------------------


class LocalBatch(NamedTuple):
    """The instances [lo, hi) of a batch of ``n`` that this process holds on
    a mesh spanning processes: ``owned`` (bool [hi - lo]) marks those this
    process reports in batch-global sums (the lowest rank among the
    processes holding an instance, so a sum counts each instance once),
    ``weights`` (float32 [hi - lo]) is ``owned / n``: each instance's share
    of a batch mean."""

    lo: int
    hi: int
    n: int
    owned: torch.Tensor
    weights: torch.Tensor


def batch_rand(shape: Sequence[int], generator: Optional[torch.Generator], device: Any,
               batch: Optional[LocalBatch] = None) -> torch.Tensor:
    """``torch.rand(shape)``; with ``batch`` (``shape[0]`` its instances) the
    whole batch's numbers drawn and this process's rows kept, so every
    process draws what one process would (as a replicated JAX key does)."""
    shape = tuple(shape)
    if batch is None:
        return torch.rand(shape, generator=generator, device=device)
    if shape[0] != batch.hi - batch.lo:
        raise ValueError(f"batch_rand over instances [{batch.lo}, {batch.hi}) got "
                         f"{shape[0]} rows")
    return torch.rand((batch.n,) + shape[1:], generator=generator,
                      device=device)[batch.lo:batch.hi]


def batch_gather(t: torch.Tensor, batch: Optional[LocalBatch], dim: int = 0) -> torch.Tensor:
    """A tensor over this process's instances (``dim``) as the whole batch's
    on every process: each instance from the process that owns it, summed
    into zeros (:func:`world_sum`; exact, differentiable); ``t`` itself
    where ``batch`` is None (one process)."""
    if batch is None:
        return t
    dim = dim % t.ndim
    mask = batch.owned.view([-1 if i == dim else 1 for i in range(t.ndim)]).to(t.device)
    kept = torch.where(mask, t, torch.zeros_like(t))
    pad = lambda k: t.new_zeros(t.shape[:dim] + (k,) + t.shape[dim + 1:])  # noqa: E731
    return world_sum(torch.cat([pad(batch.lo), kept, pad(batch.n - batch.hi)], dim=dim))


def batch_sum(t: torch.Tensor, batch: Optional[LocalBatch]) -> torch.Tensor:
    """The sum over the whole batch of a tensor over this process's
    instances (dimension 0), every other dimension kept."""
    if batch is None:
        return t.sum(dim=0)
    mask = batch.owned.view([-1] + [1] * (t.ndim - 1)).to(t.device)
    return world_sum(torch.where(mask, t, torch.zeros_like(t)).sum(dim=0))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


class LaunchError(RuntimeError):
    """A child failed or the time ran out: ``rank``, ``returncode`` (None on
    a timeout) and ``output``, its last lines."""

    def __init__(self, rank: int, returncode: Optional[int], output: str) -> None:
        what = "timed out" if returncode is None else f"exited with {returncode}"
        super().__init__(f"process {rank} {what}:\n{output}")
        self.rank, self.returncode, self.output = rank, returncode, output


def _resolve(target: str):
    module, _, name = target.partition(":")
    if not name:
        raise ValueError(f"the target is module:function, got {target!r}")
    if module.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(module))[0], module)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(module)
    return getattr(mod, name)


def _tail(text: str, lines: int = 40) -> str:
    return "\n".join(text.splitlines()[-lines:])


def launch(target: str, nprocs: int, args: Sequence[str] = (), slots_per_process: int = 1,
           device: str = "cuda", timeout: float = LAUNCH_TIMEOUT_S,
           backend: Optional[str] = None,
           env: Optional[Dict[str, str]] = None, workdir: Optional[str] = None) -> List[str]:
    """Run ``target(list(args))`` in ``nprocs`` new processes over one group
    (module note); returns each child's output in rank order, or raises
    :class:`LaunchError` (every child killed) when one fails or ``timeout``
    seconds pass.  ``workdir`` holds the rendezvous file (default: a new
    temporary directory, removed after)."""
    tmp = tempfile.mkdtemp(prefix="carle_dist_", dir=workdir)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(p for p in (root, base.get("PYTHONPATH")) if p)
    procs = []
    try:
        for r in range(nprocs):
            child = dict(base, WORLD_SIZE=str(nprocs), RANK=str(r), LOCAL_RANK=str(r),
                         LOCAL_WORLD_SIZE=str(nprocs),
                         CARLE_DIST_INIT="file://" + os.path.join(tmp, "rendezvous"),
                         CARLE_DIST_SLOTS=str(int(slots_per_process)),
                         CARLE_DIST_DEVICE=device, CARLE_DIST_BACKEND=backend or "")
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            p = subprocess.Popen([sys.executable, "-m", "carle_tpu_torch.parallel.distributed",
                                  "--child", target, *args], stdout=log,
                                 stderr=subprocess.STDOUT, env=child)
            procs.append((p, log))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (bad[0], codes[bad[0]])
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failed = (next(r for r, c in enumerate(codes) if c is None), None)
            else:
                time.sleep(0.02)
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outputs = []
        for _, log in procs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
        if failed is not None:
            raise LaunchError(failed[0], failed[1], _tail(outputs[failed[0]]))
        return outputs
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _child(target: str, args: List[str]) -> int:
    slots = int(os.environ.get("CARLE_DIST_SLOTS", "1"))
    kind = os.environ.get("CARLE_DIST_DEVICE", "cpu")
    if kind == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    else:
        dev = torch.device(kind)
    initialize(coordinator_address=os.environ["CARLE_DIST_INIT"],
               backend=os.environ.get("CARLE_DIST_BACKEND") or None,
               local_devices=[dev] * slots)
    try:
        _resolve(target)(list(args))
    finally:
        shutdown()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        try:
            return _child(argv[1], argv[2:])
        except Exception:   # the child's boundary: its traceback is the parent's report
            traceback.print_exc()
            sys.stdout.flush()
            return 1
    parser = argparse.ArgumentParser(
        prog="python -m carle_tpu_torch.parallel.distributed",
        description="Run module:function(args) in N processes over one mesh")
    parser.add_argument("--nprocs", type=int, required=True)
    parser.add_argument("--slots-per-process", type=int, default=1)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    parser.add_argument("--timeout", type=float, default=LAUNCH_TIMEOUT_S)
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    parser.add_argument("target")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    a = parser.parse_args(argv)
    try:
        outputs = launch(a.target, a.nprocs, a.args, a.slots_per_process, a.device, a.timeout,
                         a.backend)
    except LaunchError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    for r, out in enumerate(outputs):
        for line in out.splitlines():
            print(f"[{r}] {line}")
    return 0


__all__ = ["LAUNCH_TIMEOUT_S", "LaunchError", "LocalBatch", "Recv", "STATS", "all_reduce",
           "batch_gather", "batch_rand", "batch_sum", "choose_backend", "exchange",
           "global_slots", "initialize", "is_initialized", "launch", "local_devices",
           "process_count", "process_index", "reset_stats", "shutdown", "world_sum"]


if __name__ == "__main__":   # the package's module, not a second copy of its state
    from carle_tpu_torch.parallel.distributed import main as _main

    sys.exit(_main())
