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
        every grid, step_num and steps_since_action).  Equal digests from
        two checkouts mean bit-for-bit equal outputs.
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
    lib_path = cuda_build.BUILD_DIR / "dec2_gx_probe.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("digest", "env-step", "profile-packed",
                                         "profile-wrappers", "profile-spatial",
                                         "encoder-times", "decoder-gx", "host-encoder",
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
    else:
        import chip_smoke

        result = chip_smoke.phase_profile_train(torch, 64, True)
    print(json.dumps({"root": root, "card": torch.cuda.get_device_name(0), args.what: result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
