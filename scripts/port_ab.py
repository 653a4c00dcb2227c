"""Measurements that compare two checkouts of carle_tpu_torch on one CUDA card,
each taken in a fresh process.

    python scripts/port_ab.py digest --root DIR
        sha256 digests of kernel outputs on seeded inputs: the whole
        autoencoder's error and eight gradients (uint8 and packed src,
        dropout 0 and 0.1) with the training forward's saved embedding and
        keep bits, the encoder's forward at the package's three widths
        (dropout 0 and 0.1, 256² and RND's bands of 8192²), and the decoder
        loss's error and five gradients on the route the checkout takes and
        on the generic kernels (uint8 and packed obs, dropout 0 and 0.1, row
        weights none and with zero rows), the tail's two stages (the output
        and gx, dropout 0 and 0.1), and env_step over a battery leg
        (160 universes, 256 steps with resets, all-2.0 and empty actions:
        every grid, step_num and steps_since_action), and the packed engine
        with the rule as data at the main paths' shapes and the packed halo
        kernel at 8192² over 4 slots (1 and 64 generations).  Equal digests
        from two checkouts mean bit-for-bit equal outputs.
    python scripts/port_ab.py env-step --root DIR
        one env_step on 160 universes of 256²: its device launches and
        device µs by kernel (torch.profiler) and its device ms after an L2
        flush and L2-warm (calls in a row).
    python scripts/port_ab.py profile-packed --root DIR
        chip_smoke.py's packed training profile (64 universes, 64 steps on
        the packed carry, under torch.profiler) as one JSON line.
    python scripts/port_ab.py profile-wrappers --root DIR
        the same profile of the wrappers path's learning stack: PredictionBonus
        over AE2D by two kernels (encoder, decoder loss) over RND2D on 64
        universes of 256², dropout on, 64 steps.
    python scripts/port_ab.py profile-spatial --root DIR
        the same profile of AE2D with SpaceSharding (the encoder, then the
        decoder's two tails on each slot's rows, forward and backward, dropout
        on, an update every 4 steps) on one universe of 8192² over 4 mesh
        slots of the card, 16 steps.
    python scripts/port_ab.py encoder-times --root DIR [--generic]
        device ms (chip_smoke.py's Timer) of the encoder at rows 3a-3d's
        shapes: the forward on 160 x 256², the gradients alone and from the
        saved bits on 64 x 256² with dropout 0.1, and the RND predictor's
        and target's masked bands of 8192²; --generic adds the generic
        kernels beside each.  Run it in a copy whose sources were edited to
        time a variant against the tree.
    python scripts/port_ab.py decoder-gx --root DIR
        device ms of the decoder loss's backward from the saved bits on
        Prediction's 128 bands of 80 x 8192 and on 64 x 256², dropout 0 and
        0.1, as the tree's one band kernel (csrc/dec2_bwd.cu, which
        recomputes the output cotangent on three rows to either side for gx)
        and as two launches (scripts/dec2_gx_probe.cu: the middle cotangent
        through device memory, then a launch for gx), in turns, and whether
        the two give the same gx.
    python scripts/port_ab.py packed-times --root DIR
        device ms (chip_smoke.py's Timer) of the packed engine with the rule
        as data (PERF.md row 2) at the server's /rollout shape (1 x 256²,
        256 generations) and the engines' (4096 x 256², 128), and of the
        packed halo kernel (row 15) at 8192² over 4 mesh slots, 64
        generations, each call's rule on the card.
    python scripts/port_ab.py row-14 --root DIR
        PERF.md row 14 at 8192² over 4 mesh slots of the card, one uint8
        generation: spatial_ca_step_cuda on the checkout's route and, where
        the checkout has HALO_U8_WORDS, the present kernel forced and the
        uint8 env mode's step (64 x 64 actions at p = 0.2, the reset flag
        unset and set): a digest, device ms in turns (chip_smoke.py's Timer)
        and CUPTI µs cold, the plan and its registers and blocks a
        multiprocessor.
    python scripts/port_ab.py plans-14 --root DIR
        the same generation by halo_words under each plan (band rows, strip
        rows, threads) of ROW_14_PLANS, bit for bit the route's, in turns,
        with CUPTI µs cold and each plan's registers and blocks a
        multiprocessor.
    python scripts/port_ab.py static-plans --root DIR
        the fixed-rule packed engine (PERF.md row 10) at the engines' shape
        (4096 x 256², 128 generations, Life fixed): each register-resident
        plan of csrc/bit_multi_step.cu's list for 8 words a row, held bit for
        bit against the present kernel and timed in turns with it (device ms,
        chip_smoke.py's Timer), with each plan's registers, spills and blocks
        a multiprocessor.  Run it in a copy whose sources were edited (the
        register cap) to time a variant against the tree.
    python scripts/port_ab.py engine-plans --root DIR
        rows 12 and 11a at the engines' shape (4096 x 256², 128 generations,
        Life: the uint8 engine with the rule as data on the card, the
        column-major engine with it fixed): each plan of the redesigned
        kernels (csrc/ca_multi_step.cu's ca_bits_kernel at 4 and 1 rows a
        thread; csrc/bit_multi_step.cu's bit_cm_regs_kernel in blocks of one
        warp and of 256 threads) held bit for bit against the present kernel
        and timed in turns with it (device ms, chip_smoke.py's Timer), with
        each plan's registers, spills and blocks a multiprocessor.
    python scripts/port_ab.py rows-13-8a --root DIR
        the uint8 halo burst (PERF.md row 13: 8 generations of one universe
        of 8192² over 4 mesh slots, Life on the card), the packed halo
        kernel (row 15: the same universe packed, 64 generations) and the
        loss tail's forward (row 8a: x [160,1,128,128] float32 after a relu,
        obs [160,1,256,256] uint8 and packed, sigmoid) on the checkout's
        routes, timed in turns (device ms, chip_smoke.py's Timer) with each
        row's CUPTI µs cold, and digests of their outputs (equal digests from
        two checkouts: the same bits).  Where the checkout has them, also
        the present uint8 kernel and the generic loss tail forced, each held
        against the route's output, and the new kernels' plans, registers and
        blocks a multiprocessor.
    python scripts/port_ab.py plans-13-8a
        forced plans of rows 13 and 8a's redesigned kernels, each held
        against the route's output and timed in turns (device ms, chip_smoke.py's
        Timer) with its CUPTI µs cold: the uint8 halo burst (PERF.md row 13,
        8 generations of 8192² over 4 slots; bands and threads a block, with
        their registers and blocks a multiprocessor) and the loss tail's
        forward (row 8a, x [160 or 64,1,128,128] float32 after a relu, obs
        uint8, sigmoid; an item's rows), beside the plain tail's forward
        (row 7a, tail2_fwd.cu) at the same shape.
    python scripts/port_ab.py head-times --root DIR
        the head's backward (PERF.md row 9b) at its three cases (AE conv1 on
        64 x 256² uint8 cells, RND conv1 at pool 4, AE conv2 on float32 with
        its input cotangent; dropout 0.1): the specialised kernel
        (csrc/head2_bwd.cu) by the planner's plan and by each plan of a few
        tile heights, and the generic kernel forced, held against each other
        (1e-5 of each leaf's largest entry, gx bit for bit) and timed in turns
        (device ms, chip_smoke.py's Timer), with the instantiations' registers,
        spills and blocks a multiprocessor.
    python scripts/port_ab.py rows-9a-8b --root DIR
        the head's forward (PERF.md row 9a: u8 and packed [160,1,256,256]
        at pool 2, RND's pool 4, AE conv2 on f32 [64,4,128,128], dropout
        0.1 on u8 [64]), the loss tail's backward (row 8b: x [64,1,128,128]
        float32 after a relu, obs [64,1,256,256] uint8 and packed, sigmoid,
        dropout 0.1 and none) and the rows whose sources they share (9b,
        the head's backward on u8 [64] at dropout 0.1; 7b, the tail's
        backward on [64,1,128,128] at dropout 0.1) on the checkout's routes,
        timed in turns (device ms, chip_smoke.py's Timer) with each call's
        CUPTI µs cold, and digests of their outputs (equal digests from two
        checkouts: the same bits).  Where the checkout has them, also the
        generic kernels forced at rows 9a and 8b, held against the route.
    python scripts/port_ab.py plans-9a
        the head's forward (row 9a) at u8 [160,1,256,256], pools 2 and 4,
        under forced plans (tile heights and blocks a multiprocessor),
        copies of its table and register caps (copies of csrc/head2_fwd.cu
        with HEAD2_FWD_COPIES and HEAD2_FWD_CELL_BLOCKS replaced, built
        beside the package's kernels), each held bit for bit against the
        route and timed in turns with its CUPTI µs cold, registers, spills
        and blocks a multiprocessor.
    python scripts/port_ab.py ties-65600
        chip_smoke.py's kernels phase with one draw of an obs [64,1,128,128]
        more from its generator before the band kernels (the draw a first
        version of row 8b's check made, on which the encoder's backward on
        65,600 instances failed 1e-4 over all outputs): every check that
        fails, recorded rather than raised, and the 65,600-instance check's
        errors and pool-tie analysis, over every instance and over those past
        65,535 alone.
    python scripts/port_ab.py host-encoder --root DIR
        the host's µs to enqueue a training step's encoder work (the RND
        predictor forward with dropout through autograd, the target's
        forward, the backward) on 64 packed 256² universes, three times.
    python scripts/port_ab.py python-cost --root DIR
        on the CPU, with the launches stubbed: the Python µs of the encoder's
        launch paths (the specialised forward, saving forward and backward
        from the saved bits, and the generic ones).

DIR is the checkout whose package, chip_smoke.py and kernel build directory
the process uses (default: this script's own).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from pathlib import Path


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digests(torch) -> dict:
    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.mcl.rnd import init_predictor_params, init_random_network_params
    from carle_tpu_torch.ops import bitpack, cuda_head as ch, cuda_stages as cs
    from carle_tpu_torch.parallel import band_heads as bh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    x = (torch.rand((64, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    x[:16, :, :128] = 0
    obs = (torch.rand((64, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    ae = init_ae_params(gen, dev)
    ps = [ae[k][t] for k in ("conv1", "conv2", "deconv1", "deconv2") for t in ("w", "b")]
    gbar = torch.randn((64,), generator=gen, device=dev)
    out = {}
    for kind, src in (("u8", x), ("u32", bitpack.pack_grid(x))):
        for p in (0.0, 0.1):
            err, saved = ch._ae_fwd_launch(src, ps, obs, (2, 2), p, 99, True)
            out[f"ae2d fwd {kind} drop {p}"] = _digest([err, *saved])
            out[f"ae2d bwd {kind} drop {p}"] = _digest(
                ch.ae_loss_bwd(src, *ps, obs, gbar, (2, 2), p, 99))
    conv = lambda q: (q["conv1"]["w"], q["conv1"]["b"], q["conv2"]["w"], q["conv2"]["b"])
    nets = {"rnd": (conv(init_predictor_params(EnvConfig(), gen, dev)), (4, 2)),
            "target": (conv(init_random_network_params(EnvConfig(), gen, dev)), (4, 2)),
            "ae": (conv(ae), (2, 2))}
    universe = (torch.rand((1, 1, 8192, 8192), generator=gen, device=dev) < 0.2).to(torch.uint8)
    bands = bh._band_input(bitpack.pack_grid(universe), 512, 8)
    mask = bh.encoder_mask(8192, 512, (4, 2), 1, dev)
    for name, (w4, pools) in nets.items():
        for p in (0.0, 0.1):
            out[f"encoder fwd {name} 256 drop {p}"] = _digest(
                [ch.encoder_fwd(x, *w4, pools, p, 7)])
            if pools == (4, 2):
                out[f"encoder fwd {name} bands drop {p}"] = _digest(
                    [ch.encoder_fwd(bands, *w4, pools, p, 7, mask)])
    # the decoder loss on the route the checkout takes at the decoder's width
    # and on the generic kernels (a checkout without the DEC2_KERNELS switch
    # ignores it): uint8 and packed obs, row weights none and with zero rows;
    # a random embedding and a positive middle bias, so every stage is live
    # (AE2D's initial weights zero the middle activations)
    dgen = torch.Generator(device=dev).manual_seed(4321)
    emb = torch.relu(torch.randn((64, 2, 64, 64), generator=dgen, device=dev))
    dec = [0.3 * torch.randn(s, generator=dgen, device=dev)
           for s in ((2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,))]
    dec[1] = dec[1].abs()
    em = torch.ones((64, 256), device=dev)
    em[:, :16] = 0.0
    for route in ("route", "generic"):
        cs.DEC2_KERNELS = route == "route"
        for kind, o in (("u8", obs), ("u32", bitpack.pack_grid(obs))):
            for p in (0.0, 0.1):
                for label, e in (("", None), (" em", em)):
                    key = f"decoder loss {route} {kind} drop {p}{label}"
                    out[f"{key} fwd"] = _digest([cs.decoder_loss_fwd(emb, *dec, o, p, 99, e)])
                    out[f"{key} bwd"] = _digest(cs.decoder_loss_bwd(emb, *dec, o, gbar, p, 99, e))
    cs.DEC2_KERNELS = True
    # the decoder's two stages alone (the tail) on the route the checkout
    # takes: the output and gx, dropout 0 and 0.1 (dW and db are left out:
    # the specialised kernels sum them in another order)
    mid = torch.relu(torch.randn((64, 1, 128, 128), generator=dgen, device=dev))
    stages = (("deconv1", emb, dec[0], dec[1], "relu", 2), ("deconv2", mid, dec[2], dec[3],
                                                            "sigmoid", 3))
    for name, xin, wt, b, act, stage in stages:
        g = torch.randn((64, 1, 2 * xin.shape[2], 2 * xin.shape[3]), generator=dgen, device=dev)
        for p in (0.0, 0.1):
            out[f"tail {name} drop {p} fwd"] = _digest([cs.tail_fwd(xin, wt, b, act, p, 99, stage)])
            out[f"tail {name} drop {p} gx"] = _digest(
                [cs.tail_bwd(xin, wt, b, g, act, p, 99, stage)[2]])
    out["env_step battery leg"] = env_leg_digest(torch)
    out.update(packed_engine_digests(torch))
    return out


def packed_engine_digests(torch) -> dict:
    """Digests of the packed engine with the rule as data (PERF.md row 2) at
    the main paths' shapes and of the packed halo kernel (row 15) at 8192²
    over 4 mesh slots, on the route the checkout takes."""
    import chip_smoke
    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import bitpack, cuda_bitpack
    from carle_tpu_torch.parallel import spatial
    from carle_tpu_torch.parallel.mesh import gather_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    soup = lambda n, h, w, p: bitpack.pack_grid(
        (torch.rand((n, h, w), generator=gen, device=dev) < p).to(torch.uint8))
    big = soup(4096, 256, 256, 0.5)
    band = soup(1, 8192, 8192, 0.2)
    vec = torch.randint(0, 1 << 18, (160,), generator=gen, device=dev, dtype=torch.int32)
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=dev)
    out = {}
    for label, (words, rule, steps) in {
            "[64,256,8] x 1": (big[:64].contiguous(), vec[:64].contiguous(), 1),
            "[160,256,8] x 1": (big[:160].contiguous(), vec, 1),
            "[1,8192,256] x 1": (band, life, 1),
            "[1,8192,256] x 3": (band, life, 3),
            "[1,256,8] x 256": (big[:1].contiguous(), life, 256),
            "[4096,256,8] x 128": (big, life, 128)}.items():
        out[f"bit_multi_step {label}"] = _digest([cuda_bitpack.bit_multi_step(words, rule, steps)])
    mesh = chip_smoke._spatial_mesh(torch)
    for steps in (1, 64):
        out[f"bit_spatial_multi_step 8192 x 4 slots x {steps}"] = _digest([gather_rows(
            spatial.bit_spatial_multi_step(band, life, steps, mesh))])
    return out


def packed_times(torch) -> dict:
    import chip_smoke
    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import bitpack, cuda_bitpack
    from carle_tpu_torch.parallel import cuda_halo
    from carle_tpu_torch.parallel.mesh import shard_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    timer = chip_smoke.Timer(torch)
    soup = lambda n, h, w, p: bitpack.pack_grid(
        (torch.rand((n, h, w), generator=gen, device=dev) < p).to(torch.uint8))
    big = soup(4096, 256, 256, 0.5)
    band = soup(1, 8192, 8192, 0.2)
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=dev)
    one = big[:1].contiguous()
    slots = shard_rows(band, chip_smoke._spatial_mesh(torch))
    return {"row 2 [1,256,8] x 256": timer.ms(
                lambda: cuda_bitpack.bit_multi_step(one, life, 256), 30),
            "row 2 [4096,256,8] x 128": timer.ms(
                lambda: cuda_bitpack.bit_multi_step(big, life, 128), 5),
            "row 15 8192 x 4 slots x 64": timer.ms(
                lambda: cuda_halo.bit_spatial_multi_step_cuda(slots, life, 64), 5)}


def static_plans(torch) -> dict:
    import ctypes

    import chip_smoke
    from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    big = bitpack.pack_grid((torch.rand((4096, 256, 256), generator=gen, device=dev)
                             < 0.5).to(torch.uint8))
    timer = chip_smoke.Timer(torch)
    life = ([3], [2, 3])
    defines = cuda_bitpack._static_define(*life)
    present = lambda: cuda_bitpack._static_rule(cuda_bitpack.KERNEL_STATIC, big, *life, 128,
                                                False, "")
    want = present()
    lib = cuda_build.library("bit_multi_step", defines)
    occ = lib.bit_static_words_occupancy
    occ.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    plans = {}
    for v, l, r, cl, g in cuda_bitpack.REGS_PLANS:
        if v != 8 or l != 1 or cl != 1:
            continue
        plan = ("regs", v, l, r, cl, g, 256)
        fn = lambda plan=plan: cuda_bitpack._words_kernel(big, None, 128, plan, life)
        if not torch.equal(fn(), want):
            raise AssertionError(f"plan {plan} differs from the present kernel")
        out = (ctypes.c_int * 4)()
        rc = occ(1, v, l, r, cl, g, 256, 0, ctypes.cast(out, ctypes.c_void_p))
        plans[str(plan)] = {"fn": fn, "registers": out[0], "spilled_bytes": out[2],
                            "blocks_per_sm": out[3], "rc": rc}
    times = {name: [] for name in ["present", *plans]}
    order = ["present", *plans]
    for name in order + order[::-1]:
        fn = present if name == "present" else plans[name]["fn"]
        times[name].append(timer.ms(fn, 5))
    return {name: {"ms": times[name],
                   **{k: v for k, v in plans.get(name, {}).items() if k != "fn"}}
            for name in order}


def engine_plans(torch) -> dict:
    import chip_smoke
    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_build, cuda_ca

    grid = chip_smoke._bench_grid(torch)
    cm = bitpack.pack_grid_cm(grid)
    n, steps = grid.shape[0], chip_smoke.BENCH_STEPS
    timer = chip_smoke.Timer(torch)
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=grid.device)
    fixed = ([3], [2, 3])
    u8 = lambda: cuda_ca.ca_multi_step(grid, life, steps)
    words = lambda: cuda_bitpack.bit_multi_step_static_cm(cm, *fixed, steps)
    rows = {"row 12": {"present": {"fn": lambda: chip_smoke._present_u8(u8)}},
            "row 11a": {"present": {"fn": lambda: chip_smoke._present_packed(words)}}}
    for v, r in cuda_ca.BITS_PLANS:
        if v == 8:
            plan = ("regs", v, r, cuda_ca.bits_threads(n, 256 // r))
            rows["row 12"][str(plan)] = {
                "fn": lambda plan=plan: cuda_ca._ca_multi_bits_kernel(grid, life, steps, plan),
                **chip_smoke._occupancy(cuda_build, "ca_multi_step", "ca_bits_occupancy",
                                        *plan[1:])[0]}
    for threads in (32, 256):
        plan = ("cm", cm.shape[1], threads)
        rows["row 11a"][str(plan)] = {
            "fn": lambda plan=plan: cuda_bitpack._cm_words_kernel(cm, *fixed, steps, plan),
            **chip_smoke._occupancy(cuda_build, "bit_multi_step",
                                    "bit_static_cm_words_occupancy", *plan[1:],
                                    defines=cuda_bitpack._static_define(*fixed))[0]}
    out = {}
    for row, plans in rows.items():
        want = plans["present"]["fn"]()
        for name, entry in plans.items():
            if not torch.equal(entry["fn"](), want):
                raise AssertionError(f"{row} plan {name} differs from the present kernel")
        times = chip_smoke._in_turns(timer, {name: e["fn"] for name, e in plans.items()})
        out[row] = {name: {"ms": times[name], **{k: v for k, v in e.items() if k != "fn"}}
                    for name, e in plans.items()}
    return out


def _rows_13_8a_inputs(torch, gen, n: int = 160):
    """Row 13's universe (u8 [1,8192,8192], ~30% alive) and row 8a's inputs
    (x [n,1,128,128] float32 after a relu, wt, b, obs [n,1,256,256] uint8)
    on the card, from ``gen``."""
    dev = gen.device
    grid = (torch.rand((1, 8192, 8192), generator=gen, device=dev) < 0.3).to(torch.uint8)
    x = torch.relu(torch.randn((n, 1, 128, 128), generator=gen, device=dev))
    wt = torch.randn((1, 1, 4, 4), generator=gen, device=dev) * 0.3
    b = torch.randn((1,), generator=gen, device=dev) * 0.3
    obs = (torch.rand((n, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    return grid, (x, wt, b, obs)


def rows_13_8a(torch) -> dict:
    import chip_smoke
    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import bitpack, cuda_build, cuda_stages
    from carle_tpu_torch.parallel import cuda_halo
    from carle_tpu_torch.parallel.mesh import gather_rows, shard_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    timer = chip_smoke.Timer(torch)
    size, slots = 8192, 4
    grid, (x, wt, b, obs) = _rows_13_8a_inputs(torch, gen)
    mesh = chip_smoke._spatial_mesh(torch)
    g8, g32 = shard_rows(grid, mesh), shard_rows(bitpack.pack_grid(grid), mesh)
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=dev)
    o32 = bitpack.pack_grid(obs)
    rows = {"row 13": {"route": lambda: cuda_halo.spatial_multi_step_cuda(g8, life, 8)},
            "row 15": {"route": lambda: cuda_halo.bit_spatial_multi_step_cuda(g32, life, 64)},
            "row 8a": {"route": lambda: cuda_stages.loss_tail_fwd(x, wt, b, obs, "sigmoid"),
                       "route u32 obs": lambda: cuda_stages.loss_tail_fwd(x, wt, b, o32,
                                                                          "sigmoid")}}
    cupti = {"row 13": ("halo_u8_kernel", "bit_blocks_kernel"),
             "row 15": ("bit_blocks_kernel", "bit_stream_kernel", "bit_halo_kernel"),
             "row 8a": ("tail_fwd_kernel", "tail2_fwd_kernel", "row_sums_kernel")}
    out = {}
    if hasattr(cuda_halo, "HALO_U8_BITS"):
        hl = size // slots
        plan = cuda_halo.u8_halo_plan(hl, size, 8)
        rows["row 13"]["present"] = lambda: chip_smoke._flag_off(
            cuda_halo, "HALO_U8_BITS", rows["row 13"]["route"])
        out["row 13 plan"] = plan
        out["row 13 occupancy"] = chip_smoke._occupancy(
            cuda_build, "halo_step", "u8_halo_bits_occupancy", plan[1], plan[2], plan[0],
            size // 32, plan[4])[0]
    if hasattr(cuda_stages, "LOSS_TAIL2_KERNELS"):
        rows["row 8a"]["generic"] = lambda: chip_smoke._flag_off(
            cuda_stages, "LOSS_TAIL2_KERNELS", rows["row 8a"]["route"])
        ri, tj, _ = cuda_stages._tail2_plan(160, 1, 128, 128, False,
                                            cuda_stages._multiprocessors(dev))
        out["row 8a plan"] = (ri, tj)
        out["row 8a occupancy"] = {
            kind: chip_smoke._occupancy(
                cuda_build, "loss_tail2_fwd", "loss_tail2_fwd_occupancy", 1, 1, 0, code,
                chip_smoke.Big(cuda_stages._loss_tail2_smem(code, 1, 128, ri, tj)))[0]
            for kind, code in (("u8", 1), ("u32", 2), ("f32", 0))}
    for row, fns in rows.items():
        outs = {name: fn() for name, fn in fns.items()}
        first = outs["route"]
        if row == "row 8a":
            for name, got in outs.items():
                rel = float(((got - first).abs() / first.abs()).max())
                if rel > 1e-5:
                    raise AssertionError(f"{row} {name} differs from the route by {rel}")
            out[f"{row} digest"] = _digest([first])
        else:
            for name, got in outs.items():
                if not all(torch.equal(a, c) for a, c in zip(got.parts, first.parts)):
                    raise AssertionError(f"{row} {name} differs from the route")
            out[f"{row} digest"] = _digest([gather_rows(first)])
        del outs, first
        out[f"{row} ms"] = chip_smoke._in_turns(timer, fns, rounds=2, reps=5)
        out[f"{row} cupti cold us"] = {
            name: chip_smoke._cupti_us(torch, timer, fn, cupti[row], f"{row} {name}")
            for name, fn in fns.items()}
    return out


def row_14(torch) -> dict:
    import chip_smoke
    import numpy as np

    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.ops import cuda_build
    from carle_tpu_torch.parallel import cuda_halo
    from carle_tpu_torch.parallel.mesh import gather_rows, shard_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    timer = chip_smoke.Timer(torch)
    size, slots = 8192, 4
    grid = (torch.rand((1, size, size), generator=gen, device=dev) < 0.3).to(torch.uint8)
    g8 = shard_rows(grid, chip_smoke._spatial_mesh(torch))
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=dev)
    fns = {"route": lambda: cuda_halo.spatial_ca_step_cuda(g8, life)}
    out = {}
    if hasattr(cuda_halo, "HALO_U8_WORDS"):
        fns["present"] = lambda: chip_smoke._flag_off(cuda_halo, "HALO_U8_WORDS", fns["route"])
        hl = size // slots
        rows, strip, threads = plan = cuda_halo.halo_words_plan(
            1, hl, size, slots, torch.cuda.get_device_properties(dev).multi_processor_count)
        out["plan"] = plan
        out["occupancy"] = chip_smoke._occupancy(cuda_build, "halo_words",
                                                 "halo_words_occupancy", rows, size,
                                                 threads)[0]
        cfg = EnvConfig(size, size, 64, 64, 1)
        action = torch.from_numpy((np.random.RandomState(14).rand(*cfg.action_shape) < 0.2)
                                  .astype(np.uint8)).to(dev)
        for flag in (False, True):
            reset = torch.tensor(flag, device=dev)
            fns[f"env step, reset {flag}"] = (
                lambda reset=reset: cuda_halo.spatial_env_step_cuda(g8, action, life, cfg, reset))
    first = fns["route"]()
    for name in ("route", "present"):
        if name in fns and not all(torch.equal(a, b) for a, b in zip(fns[name]().parts,
                                                                      first.parts)):
            raise AssertionError(f"row 14 {name} differs from the route")
    out["digest"] = _digest([gather_rows(first)])
    del first
    out["ms"] = chip_smoke._in_turns(timer, fns, rounds=2, reps=10)
    out["cupti cold us"] = {
        name: chip_smoke._cupti_us(torch, timer, fn, ("halo_u8_kernel", "halo_words_kernel"),
                                   f"row 14 {name}")
        for name, fn in fns.items()}
    return out


ROW_14_PLANS = ((7, 7, 256), (7, 7, 128), (6, 6, 256), (3, 3, 256), (11, 11, 256),
                (25, 25, 256), (7, 2, 256), (1, 1, 256))


def plans_14(torch) -> dict:
    import chip_smoke

    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import cuda_build
    from carle_tpu_torch.parallel import cuda_halo
    from carle_tpu_torch.parallel.mesh import shard_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    timer = chip_smoke.Timer(torch)
    grid = (torch.rand((1, 8192, 8192), generator=gen, device=dev) < 0.3).to(torch.uint8)
    g8 = shard_rows(grid, chip_smoke._spatial_mesh(torch))
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=dev)
    fns = {str(plan): (lambda plan=plan: cuda_halo._launch_halo_words(g8, life, plan=plan))
           for plan in ROW_14_PLANS}
    first = cuda_halo.spatial_ca_step_cuda(g8, life)
    for name, fn in fns.items():
        if not all(torch.equal(a, b) for a, b in zip(fn().parts, first.parts)):
            raise AssertionError(f"row 14 plan {name} differs from the route")
    out = {"route plan": cuda_halo.halo_words_plan(1, 2048, 8192, 4,
                                                   torch.cuda.get_device_properties(dev)
                                                   .multi_processor_count),
           "ms": chip_smoke._in_turns(timer, fns, rounds=2, reps=10),
           "cupti cold us": {name: chip_smoke._cupti_us(torch, timer, fn, ("halo_words_kernel",),
                                                        f"row 14 plan {name}")
                             for name, fn in fns.items()},
           "occupancy": {str(p): chip_smoke._occupancy(cuda_build, "halo_words",
                                                       "halo_words_occupancy", p[0], 8192,
                                                       p[2])[0] for p in ROW_14_PLANS}}
    return out


def plans_13_8a(torch) -> dict:
    import chip_smoke
    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import cuda_build, cuda_stages
    from carle_tpu_torch.parallel import cuda_halo
    from carle_tpu_torch.parallel.mesh import shard_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    timer = chip_smoke.Timer(torch)
    out = {}
    size = 8192
    grid, _ = _rows_13_8a_inputs(torch, gen)
    g8 = shard_rows(grid, chip_smoke._spatial_mesh(torch))
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=dev)
    route = cuda_halo.spatial_multi_step_cuda(g8, life, 8)
    hl, nw = size // len(g8.parts), size // 32
    fns, occupancy = {}, {}
    for rows, threads in ((64, 512), (32, 256), (40, 256), (32, 512), (64, 256)):
        plan = (8, 4, rows, cuda_halo._strip(rows, 8, nw // 4), threads)
        fn = (lambda plan=plan: cuda_halo._launch_u8_bits(g8, life, 8, plan))
        if not all(torch.equal(a, c) for a, c in zip(fn().parts, route.parts)):
            raise AssertionError(f"row 13 at plan {plan} differs from the route")
        fns[f"plan {plan}"] = fn
        occupancy[f"plan {plan}"] = chip_smoke._occupancy(
            cuda_build, "halo_step", "u8_halo_bits_occupancy", 4, rows, 8, nw, threads)[0]
    out["row 13"] = {"route plan": cuda_halo.u8_halo_plan(hl, size, 8), "occupancy": occupancy,
                     "ms": chip_smoke._in_turns(timer, fns, rounds=2, reps=5),
                     "cupti cold us": {name: chip_smoke._cupti_us(
                         torch, timer, fn, ("bit_blocks_kernel",), name)
                         for name, fn in fns.items()}}
    del grid, g8, route, fns
    for n in (160, 64):
        _, (x, wt, b, obs) = _rows_13_8a_inputs(torch, gen, n)
        args = (x, wt, b, obs, "sigmoid", 0.0, 0, cuda_stages.STAGE_DEC2)
        want = cuda_stages.loss_tail_fwd(*args[:5])
        fns = {}
        for plan in ((16, 128), (8, 128), (4, 128), (2, 128), (32, 128)):
            fn = (lambda plan=plan: cuda_stages._loss_tail2_fwd_kernel(*args, plan=plan))
            rel = float(((fn() - want).abs() / want.abs()).max())
            if rel > 1e-5:
                raise AssertionError(f"row 8a at plan {plan} differs from the route by {rel}")
            fns[f"plan {plan}"] = fn
        fns["tail2_fwd"] = lambda: cuda_stages.tail(x, wt, b, "sigmoid")
        out[f"row 8a at {n}"] = {
            "route plan": cuda_stages._tail2_plan(n, 1, 128, 128, False,
                                                  cuda_stages._multiprocessors(dev))[:2],
            "ms": chip_smoke._in_turns(timer, fns, rounds=2, reps=5),
            "cupti cold us": {name: chip_smoke._cupti_us(
                torch, timer, fn, ("loss_tail2_fwd_kernel", "row_sums_kernel",
                                   "tail2_fwd_kernel"), name) for name, fn in fns.items()}}
    return out


def head_times(torch) -> dict:
    import ctypes

    import chip_smoke
    from carle_tpu_torch.ops import cuda_build, cuda_head, cuda_stages

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    timer = chip_smoke.Timer(torch)
    cells = (torch.rand((64, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    cells[:16, :, :128] = 0
    x1 = torch.relu(torch.randn((64, 4, 128, 128), generator=gen, device=dev))
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    cases = {  # label: (x, w, b, g, pool, stage, need_dx)
        "AE conv1 u8 [64,1,256,256] pool 2": (cells, rand(4, 1, 3, 3) * 0.3, rand(4).abs() * 0.3,
                                              rand(64, 4, 128, 128), 2, 0, False),
        "RND conv1 u8 [64,1,256,256] pool 4": (cells, rand(4, 1, 3, 3) * 0.3,
                                               rand(4).abs() * 0.3, rand(64, 4, 64, 64), 4, 0,
                                               False),
        "AE conv2 f32 [64,4,128,128] pool 2, gx": (x1, rand(2, 4, 3, 3) * 0.3,
                                                   rand(2).abs() * 0.3, rand(64, 2, 64, 64), 2,
                                                   1, True),
    }
    lib = cuda_build.library("head2_bwd")
    occ = lib.head2_bwd_occupancy
    occ.argtypes = [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for label, (x, w, b, g, pool, stage, dx) in cases.items():
        args = (x, w, b, g, pool, 0.1, 99, stage, dx)
        n, c, h, wd = cuda_head.cell_shape(x)
        route = lambda: cuda_stages.head_bwd(*args)
        generic = lambda: chip_smoke._generic_head(route)
        want, got = generic(), route()
        entry = {"plan": cuda_stages._head2_plan(n, c, w.shape[0], pool, h, wd,
                                                 cuda_head.cell_kind(x) != 0, dx, sms),
                 "max_leaf_rel_err": max(chip_smoke._leaf_errors(
                     [t for t in got if t is not None], [t for t in want if t is not None]))}
        if dx:
            entry["gx_equal"] = bool(torch.equal(got[2], want[2]))
        fns = {"route": route, "generic": generic}
        ho, wo = h // pool, wd // pool
        for rb in (1, 2, 4, 8, 16):
            for per_sm in (1, 2, 3):
                tiles = n * -(-ho // rb)
                plan = (rb, min(wo, 128), min(tiles, per_sm * sms))
                fns[f"plan {plan}"] = lambda plan=plan: cuda_stages._head2_bwd_kernel(
                    *args, plan=plan)
        for name, fn in fns.items():
            errs = chip_smoke._leaf_errors([t for t in fn() if t is not None],
                                           [t for t in want if t is not None])
            entry.setdefault("errors", {})[name] = max(errs)
        order = list(fns)
        for name in order + order[::-1]:
            entry.setdefault("ms", {}).setdefault(name, []).append(timer.ms(fns[name], 10))
        kind = cuda_head.cell_kind(x)
        rb, tw, _ = entry["plan"]
        res = (ctypes.c_int * 4)()
        smem = cuda_stages._head2_bwd_smem(c, w.shape[0], pool, kind != 0, dx, rb, tw)
        rc = occ(c, w.shape[0], pool, kind, 1, int(dx), smem, 0,
                 ctypes.cast(res, ctypes.c_void_p))
        entry["occupancy"] = {"rc": rc, "registers": res[0], "spilled_bytes": res[2],
                              "blocks_per_sm": res[3], "smem": smem}
        out[label] = entry
    return out


def _battery_leg_actions(torch, steps, shape, dev):
    """A battery leg's actions: toggles at p = 0.1 from a seed, all ones (the
    master reset) a fifth of the way in and after three fifths, all 2.0
    (toggles, no reset) at half way, nothing on every seventh step."""
    gen = torch.Generator(device=dev).manual_seed(77)
    for t in range(steps):
        a = (torch.rand(shape, generator=gen, device=dev) < 0.1).to(torch.float32)
        if t in (steps // 5, 3 * steps // 5):
            a.fill_(1.0)
        elif t == steps // 2:
            a.fill_(2.0)
        elif t % 7 == 6:
            a.zero_()
        yield a


def env_leg_digest(torch) -> str:
    """env_step over a battery leg (5 rulesets x 32 universes of 256², 256
    steps, _battery_leg_actions): every step's grid, step_num and
    steps_since_action in one digest."""
    import chip_smoke
    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.env import env_step, init_state

    dev = torch.device("cuda")
    cfg = EnvConfig(instances=160)
    bits = [rules.pack_rule_bits(*chip_smoke.BATTERY_RULESETS[i % 5]) for i in range(160)]
    state = init_state(cfg, torch.tensor(bits, dtype=torch.int32), dev)
    gen = torch.Generator(device=dev).manual_seed(78)
    state = state._replace(grid=(torch.rand(cfg.grid_shape, generator=gen, device=dev)
                                 < 0.35).to(torch.uint8))
    h = hashlib.sha256()
    for a in _battery_leg_actions(torch, 256, cfg.action_shape, dev):
        state, obs = env_step(state, a, cfg)
        for t in (obs, state.step_num, state.steps_since_action):
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def env_step_cost(torch) -> dict:
    """One env_step on 160 universes of 256² (a p = 0.1 float action, the
    rules of the battery): its device launches and device µs (torch.profiler,
    chip_smoke._device_split) and its device ms after an L2 flush
    (chip_smoke.Timer) and L2-warm."""
    import chip_smoke
    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.env import env_step, init_state

    dev = torch.device("cuda")
    cfg = EnvConfig(instances=160)
    bits = [rules.pack_rule_bits(*chip_smoke.BATTERY_RULESETS[i % 5]) for i in range(160)]
    state = init_state(cfg, torch.tensor(bits, dtype=torch.int32), dev)
    gen = torch.Generator(device=dev).manual_seed(79)
    state = state._replace(grid=(torch.rand(cfg.grid_shape, generator=gen, device=dev)
                                 < 0.35).to(torch.uint8))
    action = (torch.rand(cfg.action_shape, generator=gen, device=dev) < 0.1).to(torch.float32)
    step = lambda: env_step(state, action, cfg)
    timer = chip_smoke.Timer(torch)
    split = chip_smoke._device_split(torch, step, 20)
    return {"launches_per_call": split["launches_per_call"],
            "device_us_per_call": split["device_us_per_call"], "by_kernel": split["by_kernel"],
            "flushed_ms": [timer.ms(step, 50) for _ in range(2)],
            "l2_warm_ms": [_warm_ms(torch, step, 20) for _ in range(2)]}


def _warm_ms(torch, fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls in a row, its inputs left
    in L2 by a warm-up; the stream sleeps first so the host has queued the
    calls before the start event fires."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)   # ~10 ms: longer than the host takes to queue them
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _encoder_nets(torch, gen, dev):
    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.mcl.rnd import init_predictor_params, init_random_network_params

    conv = lambda q: (q["conv1"]["w"], q["conv1"]["b"], q["conv2"]["w"], q["conv2"]["b"])
    rnd = init_predictor_params(EnvConfig(), gen, dev)
    target = init_random_network_params(EnvConfig(), gen, dev)
    return {"rnd": (conv(rnd), (4, 2)), "target": (conv(target), (4, 2)),
            "ae": (conv(init_ae_params(gen, dev)), (2, 2))}


def encoder_times(torch, generic: bool) -> dict:
    import chip_smoke
    from carle_tpu_torch.ops import bitpack, cuda_head as ch
    from carle_tpu_torch.parallel import band_heads as bh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = chip_smoke.Timer(torch)
    nets = _encoder_nets(torch, gen, dev)

    def times(fn, reps, both=True):
        out = [timer.ms(fn, reps)]
        if generic and both:
            out.append(timer.ms(lambda: chip_smoke._generic_encoder(fn), reps))
        return out

    out = {}
    x160 = (torch.rand((160, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    x64 = x160[:64].contiguous()
    for name, (w4, pools) in nets.items():
        out[f"3a fwd160 {name}"] = times(lambda: ch.encoder_fwd(x160, *w4, pools), 20)
        g = torch.randn(ch.encoder_fwd(x64, *w4, pools).shape, generator=gen, device=dev)
        out[f"3b bwd64 drop {name}"] = times(
            lambda: ch.encoder_bwd(x64, *w4, g, pools, 0.1, 7), 10)
        saved = ch._encoder_fwd_launch(x64, w4, pools, 0.1, 7, None, True)[1]
        out[f"3b from saved {name}"] = times(
            lambda: ch._enc3_bwd_kernel(x64, w4, g, pools, 0.1, None, saved), 10, False)
        out[f"train fwd64 save {name}"] = times(
            lambda: ch._encoder_fwd_launch(x64, w4, pools, 0.1, 7, None, True), 10, False)
    universe = (torch.rand((1, 1, 8192, 8192), generator=gen, device=dev) < 0.2).to(torch.uint8)
    xw = bh._band_input(bitpack.pack_grid(universe), 512, 8)
    mask = bh.encoder_mask(8192, 512, (4, 2), 1, dev)
    for name in ("rnd", "target"):
        w4, pools = nets[name]
        for p in (0.0, 0.1):
            out[f"3c bands fwd {name} drop {p}"] = times(
                lambda: ch.encoder_fwd(xw, *w4, pools, p, 31, mask), 10)
        g = torch.randn((512, 1, 4, 1024), generator=gen, device=dev)
        out[f"3d bands bwd {name}"] = times(
            lambda: ch.encoder_bwd(xw, *w4, g, pools, 0.1, 31, mask), 5)
        saved = ch._encoder_fwd_launch(xw, w4, pools, 0.1, 31, mask, True)[1]
        out[f"3d from saved {name}"] = times(
            lambda: ch._enc3_bwd_kernel(xw, w4, g, pools, 0.1, mask, saved), 5, False)
    return out


def profile_wrappers(torch) -> dict:
    import chip_smoke
    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.mcl import ae2d_def, prediction_def, rnd2d_def
    from carle_tpu_torch.rollout import Rollout

    cfg = EnvConfig(instances=64)
    defs = [rnd2d_def(cfg, reward_scale=0.0), ae2d_def(cfg, reward_scale=0.0, whole_ae=False),
            prediction_def(cfg)]
    ro = Rollout(cfg, defs, make_random_agent(64, 64, 0.1), device="cuda")
    return chip_smoke._profile_steps(torch, ro, ro.init(ro.generator(0), rules.LIFE), 64, 64)


def profile_spatial(torch) -> dict:
    import chip_smoke
    from carle_tpu_torch import EnvConfig, nets, rules
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.mcl import ae2d_def
    from carle_tpu_torch.parallel.packed_env import PackedSpatialStack
    from carle_tpu_torch.rollout import Rollout

    size = chip_smoke.SPATIAL_SIZE
    cfg = EnvConfig(height=size, width=size, action_height=64, action_width=64, instances=1)
    mesh = chip_smoke._spatial_mesh(torch)
    defs = [ae2d_def(cfg, batch_size=4, fused_head=nets.SpaceSharding(mesh))]
    ro = Rollout(cfg, defs, make_random_agent(64, 64, 0.2), device="cuda",
                 stack=PackedSpatialStack(cfg, defs, mesh))
    return chip_smoke._profile_steps(torch, ro, ro.init(ro.generator(0), rules.LIFE), 16, 1)


def decoder_gx(torch) -> dict:
    import ctypes
    import subprocess

    import chip_smoke
    from carle_tpu_torch.ops import bitpack, cuda_build, cuda_stages as cs
    from carle_tpu_torch.parallel import band_heads as bh

    probe = Path(__file__).resolve().with_name("dec2_gx_probe.cu")
    lib_path = cuda_build.build_dir() / "dec2_gx_probe.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
                    str(lib_path), str(probe)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.opt2_launch.argtypes = [P] * 13 + [I] * 6 + [ctypes.c_double, P]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = chip_smoke.Timer(torch)
    ps = [torch.randn(s, generator=gen, device=dev) * 0.3
          for s in ((2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,))]
    ps[1] = ps[1].abs()
    x = torch.relu(torch.randn((128, 2, 20, 2048), generator=gen, device=dev))
    cells = (torch.rand((128, 1, 80, 8192), generator=gen, device=dev) < 0.3).to(torch.uint8)
    x2 = torch.relu(torch.randn((64, 2, 64, 64), generator=gen, device=dev))
    o2 = (torch.rand((64, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    cases = {"bands 128x80x8192": (x, bitpack.pack_grid(cells),
                                   torch.randn((128,), generator=gen, device=dev),
                                   bh.decoder_row_weights(2048, 128, 1, dev)),
             "64x256": (x2, o2, torch.randn((64,), generator=gen, device=dev), None)}
    out = {}
    for name, (xx, obs, gbar, em) in cases.items():
        n, _, he, we = xx.shape
        h, w = 4 * he, 4 * we
        ry, tx, _ = cs._dec2_plan(n, h, w, True)
        blocks = -(-h // ry) * -(-w // min(tx, w))
        for p in (0.0, 0.1):
            saved = cs._decoder_fwd_launch(xx, ps, obs, p, 7, em, True)[1]
            keepd = None if saved is None else saved.keepd
            partials = torch.empty((n * blocks, 50), device=dev)
            grads = torch.empty((50,), device=dev)
            gx = torch.empty((n, 2, he, we), device=dev)
            gmid = torch.empty((n, h // 2, w // 2), device=dev)
            ts = [t.contiguous() for t in (xx, obs, *ps, gbar)]

            def two_launches():
                rc = lib.opt2_launch(*(t.data_ptr() for t in ts),
                                     None if em is None else em.data_ptr(),
                                     None if keepd is None else keepd.data_ptr(),
                                     partials.data_ptr(), grads.data_ptr(), gx.data_ptr(),
                                     gmid.data_ptr(), n, h, w, ry, tx, cs.cell_kind(obs), p,
                                     torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"dec2_gx_probe: CUDA error {rc}")

            one = lambda: cs._dec2_bwd_kernel(xx, ps, obs, gbar, p, em, saved)
            want = one()
            two_launches()
            torch.cuda.synchronize()
            r = {"plan": [ry, tx], "gx_equal": bool(torch.equal(gx, want[4])),
                 "one band kernel": [], "two launches": []}
            for _ in range(2):
                r["one band kernel"].append(timer.ms(one, 10))
                r["two launches"].append(timer.ms(two_launches, 10))
            out[f"{name} drop {p}"] = r
    return out


def _loop_us(fn, reps: int, sync=None) -> float:
    for _ in range(20):
        fn()
    if sync:
        sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    if sync:
        sync()
    return t


def host_encoder(torch) -> list:
    from carle_tpu_torch.ops import bitpack, cuda_head as ch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = bitpack.pack_grid((torch.rand((64, 1, 256, 256), generator=gen, device=dev) < 0.3)
                          .to(torch.uint8))
    nets = _encoder_nets(torch, gen, dev)
    leaves = [t.detach().clone().requires_grad_(True) for t in nets["rnd"][0]]
    target = nets["target"][0]

    def step():
        out = ch.encoder(x, *leaves, (4, 2), 0.1, 7)
        ch.encoder(x, *target, (4, 2))
        torch.autograd.grad(out.sum(), leaves)

    return [_loop_us(step, 300, torch.cuda.synchronize) for _ in range(3)]


def python_cost(torch) -> dict:
    from carle_tpu_torch.ops import cuda_head as ch

    ch.stream_args = lambda t: (0, None)
    for k in (ch.ENC3_FWD, ch.ENC3_BWD, ch.ENCODER, ch.ENCODER_BWD):
        k.launch = lambda *a, **kw: None
    x = torch.zeros((64, 1, 256, 256), dtype=torch.uint8)
    ps = [torch.randn(4, 1, 3, 3), torch.randn(4), torch.randn(1, 4, 3, 3), torch.randn(1)]
    g = torch.randn(64, 1, 32, 32)
    saved = ch._encoder_fwd_launch(x, ps, (4, 2), 0.1, 7, None, True)[1]
    out = {"enc3 saving fwd": _loop_us(lambda: ch._encoder_fwd_launch(x, ps, (4, 2), 0.1, 7,
                                                                      None, True), 2000),
           "enc3 fwd": _loop_us(lambda: ch._encoder_fwd_launch(x, ps, (4, 2), 0.0, 7, None,
                                                               False), 2000),
           "enc3 bwd from saved": _loop_us(lambda: ch._enc3_bwd_kernel(x, ps, g, (4, 2), 0.1,
                                                                       None, saved), 2000)}
    ch.ENC3_KERNELS = False
    out["generic fwd"] = _loop_us(lambda: ch._encoder_fwd_launch(x, ps, (4, 2), 0.1, 7, None,
                                                                 True), 2000)
    out["generic bwd"] = _loop_us(lambda: ch._encoder_bwd_kernel(x, *ps, g, (4, 2), 0.1, 7),
                                  2000)
    return out


def _rows_9a_8b_inputs(torch, gen):
    """The inputs of rows 9a, 8b, 9b and 7b on the card, from ``gen``."""
    dev = gen.device
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    cells = (torch.rand((160, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    cells[:40, :, :128] = 0   # blank regions: whole pool windows tie
    obs = (torch.rand((64, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    return dict(cells=cells, w1=rand(4, 1, 3, 3) * 0.3, b1=rand(4).abs() * 0.3,
                w2=rand(2, 4, 3, 3) * 0.3, b2=rand(2).abs() * 0.3,
                x1=torch.relu(rand(64, 4, 128, 128)), mid=torch.relu(rand(64, 1, 128, 128)),
                wt=rand(1, 1, 4, 4) * 0.3, bt=rand(1) * 0.3, obs=obs,
                gbar=rand(64) / (64 * 65536), g9=rand(64, 4, 128, 128),
                g7=rand(64, 1, 256, 256))


def rows_9a_8b(torch) -> dict:
    import chip_smoke
    from carle_tpu_torch.ops import bitpack, cuda_stages as cs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    timer = chip_smoke.Timer(torch)
    t = _rows_9a_8b_inputs(torch, gen)
    cells, obs = t["cells"], t["obs"]
    words, o32 = bitpack.pack_grid(cells[:, 0])[:, None], bitpack.pack_grid(obs)
    lt = (t["mid"], t["wt"], t["bt"])
    fns = {
        "row 9a u8": lambda: cs.head_fwd(cells, t["w1"], t["b1"], 2),
        "row 9a u32": lambda: cs.head_fwd(words, t["w1"], t["b1"], 2),
        "row 9a pool 4": lambda: cs.head_fwd(cells, t["w1"], t["b1"], 4),
        "row 9a conv2": lambda: cs.head_fwd(t["x1"], t["w2"], t["b2"], 2, stage=1),
        "row 9a drop": lambda: cs.head_fwd(cells[:64], t["w1"], t["b1"], 2, 0.1, 5),
        "row 8b": lambda: cs.loss_tail_bwd(*lt, obs, t["gbar"], "sigmoid", 0.1, 5),
        "row 8b u32": lambda: cs.loss_tail_bwd(*lt, o32, t["gbar"], "sigmoid", 0.1, 5),
        "row 8b no drop": lambda: cs.loss_tail_bwd(*lt, obs, t["gbar"], "sigmoid"),
        "row 9b": lambda: cs.head_bwd(cells[:64], t["w1"], t["b1"], t["g9"], 2, 0.1, 5),
        "row 7b": lambda: cs.tail_bwd(*lt, t["g7"], "sigmoid", 0.1, 5, 3),
    }
    cupti = {"row 9a": ("head_fwd_kernel", "head2_fwd_"),
             "row 8b": ("tail_bwd_kernel", "tail2_bwd_kernel", "column_sums_kernel"),
             "row 9b": ("head2_cells", "head2_floats"),
             "row 7b": ("tail2_bwd_kernel", "column_sums_kernel")}
    out = {}
    if hasattr(cs, "HEAD2_FWD"):
        fns["row 9a u8 generic"] = lambda: chip_smoke._generic_head(fns["row 9a u8"])
        fns["row 8b generic"] = lambda: chip_smoke._flag_off(cs, "LOSS_TAIL2_KERNELS",
                                                               fns["row 8b"])
        if not torch.equal(fns["row 9a u8"](), fns["row 9a u8 generic"]()):
            raise AssertionError("row 9a differs from the generic kernel")
        if not torch.equal(fns["row 8b"]()[2], fns["row 8b generic"]()[2]):
            raise AssertionError("row 8b's gx differs from the generic kernel's")
    for name, fn in fns.items():
        got = fn()
        out[f"{name} digest"] = _digest(got if isinstance(got, tuple) else [got])
    out["ms"] = chip_smoke._in_turns(timer, fns, rounds=2, reps=10)
    out["cupti cold us"] = {name: chip_smoke._cupti_us(torch, timer, fn, cupti[name[:6]], name)
                            for name, fn in fns.items()}
    return out


def _head2_fwd_variants(cuda_build, cs, variants):
    """{(copies, blocks): (a CudaKernel launching it, its library)}: a copy
    of csrc/head2_fwd.cu for each (copies of its table, register cap in
    blocks a multiprocessor on cells), its two constants replaced, built
    under the package's build directory with the package's nvcc flags, all
    at once."""
    import ctypes
    import re
    import subprocess

    text = (cuda_build.CSRC / "head2_fwd.cu").read_text()
    out = cuda_build.build_dir() / "head2_fwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for copies, blocks in variants:
        src = text
        for name, value in (("HEAD2_FWD_COPIES", copies), ("HEAD2_FWD_CELL_BLOCKS", blocks)):
            src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                             src)
            if n != 1:
                raise RuntimeError(f"csrc/head2_fwd.cu holds no single {name} to replace")
        cu = out / f"head2_fwd_copies{copies}_blocks{blocks}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        jobs[copies, blocks] = so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"head2_fwd variant {key} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        kernel = cuda_build.CudaKernel("head2_fwd", "head2_fwd_launch", cs.HEAD2_FWD.argtypes)
        kernel._lib, kernel._fn = lib, getattr(lib, "head2_fwd_launch")
        kernel._fn.argtypes, kernel._fn.restype = kernel.argtypes, ctypes.c_int
        built[key] = kernel, lib
    return built


def plans_9a(torch) -> dict:
    import ctypes

    import chip_smoke
    from carle_tpu_torch.ops import cuda_build, cuda_stages as cs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    timer = chip_smoke.Timer(torch)
    t = _rows_9a_8b_inputs(torch, gen)
    sms = cs._multiprocessors(dev)
    variants = _head2_fwd_variants(cuda_build, cs,
                                   ((1, 4), (2, 4), (4, 4), (8, 3), (8, 2), (4, 3)))
    kernel, smem_of = cs.HEAD2_FWD, cs._head2_fwd_smem

    def smem(k):   # _head2_fwd_smem with k copies (and the table they come from)
        return lambda c, o, pool, binary, rb, tw: (
            smem_of(c, o, pool, binary, rb, tw) - binary * 4 * 512 * o * (9 - k - (k > 1)))

    def on(k, variant, fn):
        cs.HEAD2_FWD, cs._head2_fwd_smem = variant, smem(k)
        try:
            return fn()
        finally:
            cs.HEAD2_FWD, cs._head2_fwd_smem = kernel, smem_of

    out = {"route plan": cs._head2_fwd_plan(160, 1, 4, 2, 256, 256, True, sms)}
    for pool in (2, 4):
        args = (t["cells"], t["w1"], t["b1"], pool, 0.0, 0, 0)
        want = cs.head_fwd(*args[:4])
        fns, occupancy = {}, {}
        for (k, cap), (variant, lib) in variants.items():
            report = (ctypes.c_int * 4)()
            fn = lib.head2_fwd_occupancy
            fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            if fn(1, 4, pool, 1, 0, smem(k)(1, 4, pool, True, 16, 256 // pool), 0,
                  ctypes.cast(report, ctypes.c_void_p)):
                raise RuntimeError(f"head2_fwd_occupancy failed (copies {k}, cap {cap})")
            occupancy[f"copies {k} cap {cap}"] = dict(zip(
                ("registers", "static_smem", "spilled_bytes", "blocks_per_sm"), report))
            for rb, per_sm in ((16, cap), (16, 2 * cap), (8, cap), (8, 2 * cap)):
                plan = (rb, 256 // pool, min(160 * (256 // pool) // rb, per_sm * sms))
                fn = (lambda plan=plan, k=k, v=variant:
                      on(k, v, lambda: cs._head2_fwd_kernel(*args, plan=plan)))
                if not torch.equal(fn(), want):
                    raise AssertionError(f"row 9a at {plan}, copies {k}, cap {cap} differs "
                                         "from the route")
                fns[f"copies {k} cap {cap} plan {plan}"] = fn
        out[f"pool {pool}"] = {
            "occupancy": occupancy, "ms": chip_smoke._in_turns(timer, fns, rounds=2, reps=5),
            "cupti cold us": {name: chip_smoke._cupti_us(torch, timer, fn, ("head2_fwd_",), name)
                              for name, fn in fns.items()}}
    return out


def ties_65600(torch) -> dict:
    import chip_smoke
    from carle_tpu_torch.ops import cuda_build

    failed, band_kernels, check = [], chip_smoke.phase_band_kernels, chip_smoke.check

    def shifted(torch, timer, gen, philox):
        # the draw of an obs [64,1,128,128] more from the phase's generator:
        # the generator's offset as where that draw comes before this phase
        torch.rand((64, 1, 128, 128), generator=gen, device=gen.device)
        out = band_kernels(torch, timer, gen, philox)
        shifted.report = out["bands_kernels"]
        return out

    def record(cond, what):
        if not cond:
            failed.append(what)

    torch.backends.cudnn.allow_tf32 = False       # as chip_smoke.py's main: the
    torch.backends.cuda.matmul.allow_tf32 = False  # plain twins in full float32
    chip_smoke.phase_band_kernels, chip_smoke.check = shifted, record
    try:
        chip_smoke.phase_kernels(torch, chip_smoke.Timer(torch), chip_smoke.shipped_states(torch),
                                 chip_smoke.philox_draw_ops(cuda_build))
    finally:
        chip_smoke.phase_band_kernels, chip_smoke.check = band_kernels, check
    report = shifted.report
    return {"checks failed": failed,
            "encoder_bwd": report["instances_65600_encoder_bwd"],
            "max_leaf_rel_err": report["instances_65600_max_leaf_rel_err"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("digest", "env-step", "profile-packed",
                                         "profile-wrappers", "profile-spatial",
                                         "encoder-times", "decoder-gx", "host-encoder",
                                         "packed-times", "static-plans", "engine-plans",
                                         "head-times", "rows-13-8a", "plans-13-8a", "row-14",
                                         "plans-14",
                                         "rows-9a-8b", "plans-9a", "ties-65600",
                                         "python-cost"))
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--generic", action="store_true",
                        help="encoder-times: also time the generic kernels")
    args = parser.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if args.what == "python-cost":   # the CPU: no device metric
        print(json.dumps({"root": root, "device": "cpu", args.what: python_cost(torch)}))
        return 0
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    if args.what == "digest":
        result = digests(torch)
    elif args.what == "env-step":
        result = env_step_cost(torch)
    elif args.what == "encoder-times":
        result = encoder_times(torch, args.generic)
    elif args.what == "decoder-gx":
        result = decoder_gx(torch)
    elif args.what == "profile-wrappers":
        result = profile_wrappers(torch)
    elif args.what == "profile-spatial":
        result = profile_spatial(torch)
    elif args.what == "host-encoder":
        result = host_encoder(torch)
    elif args.what == "packed-times":
        result = packed_times(torch)
    elif args.what == "static-plans":
        result = static_plans(torch)
    elif args.what == "engine-plans":
        result = engine_plans(torch)
    elif args.what == "head-times":
        result = head_times(torch)
    elif args.what == "rows-13-8a":
        result = rows_13_8a(torch)
    elif args.what == "plans-13-8a":
        result = plans_13_8a(torch)
    elif args.what == "row-14":
        result = row_14(torch)
    elif args.what == "plans-14":
        result = plans_14(torch)
    elif args.what == "rows-9a-8b":
        result = rows_9a_8b(torch)
    elif args.what == "plans-9a":
        result = plans_9a(torch)
    elif args.what == "ties-65600":
        result = ties_65600(torch)
    else:
        import chip_smoke

        result = chip_smoke.phase_profile_train(torch, 64, True)
    print(json.dumps({"root": root, "card": torch.cuda.get_device_name(0), args.what: result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
