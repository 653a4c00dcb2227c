"""Worker of tests/test_torch_multiprocess.py: run by the launcher
(``python -m carle_tpu_torch.parallel.distributed --nprocs 2
--slots-per-process 4 --device cpu tests/_torch_multiprocess_worker.py:main
OUT``) in each of two processes of 4 ``cpu`` slots, one 8-slot mesh.

It runs the three legs of tests/_multiprocess_worker.py at its sizes, Speed
and Puffer at 2 instances, the master reset's three cases, and
``train(mesh=True)``, and writes its results
to ``OUT/rank<r>.npz`` (arrays) and ``OUT/rank<r>.json`` (scalars) for the
test to hold against the one-controller 8-slot mesh (and ``carle_tpu``).
Imports no JAX.
"""

import functools
import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from carle_tpu_torch import EnvConfig, rules, train_mcl
from carle_tpu_torch.agents import make_random_agent
from carle_tpu_torch.checkpoint import learner_state_from_numpy
from carle_tpu_torch.env import env_step, init_state, reset_flags
from carle_tpu_torch.mcl import ae2d_def, rnd2d_def
from carle_tpu_torch.parallel import (PackedSpatialStack, distributed, gather_rows,
                                      make_mesh, shard_carry, shard_carry_packed, shard_rows,
                                      spatial_multi_step_cuda)
from carle_tpu_torch.parallel.mesh import local_batch
from carle_tpu_torch.rollout import Rollout

CFG = EnvConfig(height=32, width=32, action_height=8, action_width=8, instances=8)
PCFG = EnvConfig(height=32, width=64, action_height=8, action_width=8, instances=2)


def leg1_random(mesh):
    """RND2D (batch 2, dropout on) with the random agent, 4 steps, the
    universes sharded over every process's slots."""
    ro = Rollout(CFG, [rnd2d_def(CFG, batch_size=2, fused_head=mesh)],
                 make_random_agent(8, 8), device="cpu")
    carry = shard_carry(ro.init(ro.generator(0), rules.LIFE), mesh, CFG)
    carry, rewards = ro.run(carry, 4)
    batch = local_batch(carry.stack.env.grid)
    grid = distributed.batch_gather(ro.stack.universe(carry.stack), batch)
    return ro.gather_rewards(carry, rewards), grid, carry.stack.wrappers[0]


def leg1_actions(mesh, learner, actions):
    """The same stack with dropout off, the learner state and the action
    stream the test gives (held against carle_tpu)."""
    ro = Rollout(CFG, [rnd2d_def(CFG, batch_size=2, dropout=False, fused_head=mesh)],
                 device="cpu")
    carry = ro.init(ro.generator(0), rules.LIFE)
    carry = carry._replace(stack=carry.stack._replace(wrappers=(learner,)))
    carry = shard_carry(carry, mesh, CFG)
    carry, rewards = ro.run_actions(carry, actions)
    return ro.gather_rewards(carry, rewards)


def leg2(smesh, grid):
    """5 generations of one 32 x 64 universe, 4 rows a slot: the ghost rows
    cross the process boundary."""
    return gather_rows(spatial_multi_step_cuda(shard_rows(grid, smesh), rules.LIFE, 5))


def leg3(smesh):
    """The packed stack with RND2D (batch 2) on the space mesh, 6 steps."""
    defs = [rnd2d_def(PCFG, batch_size=2)]
    ro = Rollout(PCFG, defs, make_random_agent(8, 8), device="cpu",
                 stack=PackedSpatialStack(PCFG, defs, smesh))
    carry = shard_carry_packed(ro.init(ro.generator(42), rules.LIFE), smesh, PCFG)
    carry, rewards = ro.run(carry, 6)
    return ro.stack.universe(carry.stack), ro.gather_rewards(carry, rewards)


def leg4(smesh):
    """The packed stack with RND2D and AE2D on the row shards themselves
    (``fused_head=SpaceSharding``, dropout on), 128 x 64, 16 rows a slot,
    4 steps: the nets' halo rows cross processes forward and backward."""
    from carle_tpu_torch.nets import SpaceSharding

    cfg = EnvConfig(height=128, width=64, action_height=8, action_width=8, instances=2)
    tag = SpaceSharding(smesh)
    defs = [rnd2d_def(cfg, batch_size=2, fused_head=tag), ae2d_def(cfg, batch_size=2,
                                                                    fused_head=tag)]
    ro = Rollout(cfg, defs, make_random_agent(8, 8), device="cpu",
                 stack=PackedSpatialStack(cfg, defs, smesh))
    carry = shard_carry_packed(ro.init(ro.generator(4), rules.LIFE), smesh, cfg)
    carry, rewards = ro.run(carry, 4)
    return ro.stack.universe(carry.stack), ro.gather_rewards(carry, rewards)


def mesh_2d(spanning):
    """The 8 slots as a 2 x 4 env x space mesh: each ring over both
    processes (``spanning``), or each process's 4 slots a ring."""
    from carle_tpu_torch.parallel import Mesh

    slots = distributed.global_slots()
    order = [0, 1, 4, 5, 2, 3, 6, 7] if spanning else list(range(8))
    return Mesh([[slots[i][1] for i in order[:4]], [slots[i][1] for i in order[4:]]],
                ("env", "space"), [slots[i][0] for i in order])


def leg5(mesh):
    """The uint8 spatial env mode on an env x space mesh (4 universes of 64²,
    2 a ring, 16 rows a slot): Speed and Puffer (batch-global) and RND2D
    (batch 2, dropout off: launched once over a process's instances, its
    kernels number them from 0 in the draw), the random agent, 6 steps."""
    from carle_tpu_torch.mcl import puffer_def, speed_def
    from carle_tpu_torch.parallel import shard_carry_2d

    cfg = EnvConfig(height=64, width=64, action_height=8, action_width=8, instances=4)
    ro = Rollout(cfg, [speed_def(cfg), puffer_def(cfg, growth_threshold=2),
                       rnd2d_def(cfg, batch_size=2, dropout=False)], make_random_agent(8, 8),
                 device="cpu")
    carry = shard_carry_2d(ro.init(ro.generator(5), rules.LIFE), mesh, cfg)
    carry, rewards = ro.run(carry, 6)
    batch = local_batch(carry.stack.env.grid)
    return (distributed.batch_gather(ro.stack.universe(carry.stack), batch),
            ro.gather_rewards(carry, rewards))


def mesh_pair():
    """A 2-slot env mesh, one slot a process."""
    from carle_tpu_torch.parallel import Mesh

    slots = distributed.global_slots()
    return Mesh([slots[0][1], slots[4][1]], ("env",), [slots[0][0], slots[4][0]])


def leg7(mesh):
    """Speed (batch-global and per instance) and Puffer (per instance) on 2
    universes of 32², one a slot, the random agent: 12 steps unsharded (the
    whole batch in every process, till cells outside the action window give
    Speed a centre of mass), then the carry sharded and 4 steps more.  Speed's [2, instances] centre of mass
    stays whole on every process, Puffer's per-instance window is split."""
    from carle_tpu_torch.mcl import puffer_def, speed_def

    cfg = EnvConfig(height=32, width=32, action_height=8, action_width=8, instances=2)
    ro = Rollout(cfg, [speed_def(cfg), speed_def(cfg, per_instance=True),
                       puffer_def(cfg, per_instance=True, growth_threshold=2)],
                 make_random_agent(8, 8), device="cpu")
    carry, _ = ro.run(ro.init(ro.generator(11), rules.LIFE), 12)
    carry, rewards = ro.run(shard_carry(carry, mesh, cfg), 4)
    batch = local_batch(carry.stack.env.grid)
    return (distributed.batch_gather(ro.stack.universe(carry.stack), batch),
            ro.gather_rewards(carry, rewards))


def reset_cases(mesh):
    """The master reset on the 8-slot env mesh: all ones on every process,
    all ones on process 0 only, all 2.0.  (flag, universe all zeros after
    the step) of each."""
    grid = (torch.rand((8, 32, 32), generator=torch.Generator().manual_seed(3)) < 0.4)
    state = init_state(CFG, rules.LIFE, "cpu")._replace(grid=grid.to(torch.uint8))
    state = shard_carry(state, mesh, CFG)
    batch = local_batch(state.grid)
    n, rank = batch.hi - batch.lo, distributed.process_index()
    out = []
    for value in (lambda: 1.0, lambda: 1.0 if rank == 0 else 0.0, lambda: 2.0):
        action = torch.full((n, 8, 8), value(), dtype=torch.float32)
        flag = bool(reset_flags(action, state.grid)[0])
        new, _ = env_step(state, action, CFG)
        whole = distributed.batch_gather(gather_rows(new.grid), batch)
        out.append((flag, bool((whole == 0).all())))
    return out


def _checksum(tree) -> str:
    leaves = [t for v in tree.values() for t in v.values()]
    return hashlib.sha256(b"".join(t.detach().numpy().tobytes() for t in leaves)).hexdigest()


def trained(log_dir, packed):
    """train(mesh=True): 16 universes of 64 x 64 (RND2D's dense weight is
    [16, 64]: a parameter whose first dimension equals the instances stays
    whole), Life, 1 x 4 steps, batch 2, the learners' dropout off (the defs
    train builds, patched here)."""
    rnd, ae = train_mcl.rnd2d_def, train_mcl.ae2d_def
    train_mcl.rnd2d_def = functools.partial(rnd, dropout=False)
    train_mcl.ae2d_def = functools.partial(ae, dropout=False)
    try:
        return train_mcl.train(instances=16, steps=(1, 4), rules=[[[3], [2, 3]]], height=64,
                               width=64, batch_size=2, seed=0, log_dir=log_dir, device="cpu",
                               mesh=True, packed_state=packed)
    finally:
        train_mcl.rnd2d_def, train_mcl.ae2d_def = rnd, ae


def main(argv):
    out = argv[0]
    rank = distributed.process_index()
    mesh, smesh = make_mesh(axis_name="env"), make_mesh(axis_name="space")
    given = np.load(os.path.join(out, "inputs.npz"))
    r1, g1, learner = leg1_random(mesh)
    every = [None] * distributed.process_count()
    dist.all_gather_object(every, _checksum(learner.params))
    flat = {k[len("learner/"):]: given[k] for k in given.files if k.startswith("learner/")}
    r1b = leg1_actions(mesh, learner_state_from_numpy(flat, "cpu"),
                       torch.from_numpy(given["actions"]))
    g2 = leg2(smesh, torch.from_numpy(given["grid2"]))
    g3, r3 = leg3(smesh)
    g4, r4 = leg4(smesh)
    g5, r5 = leg5(mesh_2d(True))
    g6, r6 = leg5(mesh_2d(False))
    g7, r7 = leg7(mesh_pair())
    resets = reset_cases(mesh)
    distributed.reset_stats()
    hist = trained(os.path.join(out, f"train{rank}"), False)
    stats = dict(distributed.STATS)
    hist_packed = trained(os.path.join(out, f"packed{rank}"), True)
    np.savez(os.path.join(out, f"rank{rank}.npz"), r1=r1.numpy(), g1=g1.numpy(),
             r1b=r1b.numpy(), g2=g2.numpy(), g3=g3.numpy(), r3=r3.numpy(), g4=g4.numpy(),
             r4=r4.numpy(), g5=g5.numpy(), r5=r5.numpy(), g6=g6.numpy(), r6=r6.numpy(),
             g7=g7.numpy(), r7=r7.numpy(), hist=hist,
             hist_packed=hist_packed)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"mesh": repr(mesh), "checksums": every, "updates": int(learner.updates),
                   "resets": resets, "train_stats": stats}, f)
    print(f"process {rank}: ok")


def fail(argv):
    """Process 1 raises (the launcher's failure case); process 0 works on
    until the launcher kills it."""
    import time

    if distributed.process_index() == 1:
        raise RuntimeError("process 1 fails on purpose")
    time.sleep(120)


if __name__ == "__main__":
    sys.exit("run me through python -m carle_tpu_torch.parallel.distributed")
