"""Chip smoke test of carle_tpu_torch on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero without the final line:

1. build   the six CUDA kernels from carle_tpu_torch/csrc (one nvcc each,
           all at once) and print the card as nvidia-smi names it;
2. kernels each kernel against its plain PyTorch twin on the card at the
           slices' shapes (integer kernels exact, float kernels within the
           stated tolerance), with their times (CUDA events, L2 flushed
           before every launch) and the least time the card could take; the
           net kernels also with dropout 0.1 (kernel and twin draw the same
           Philox mask), the drop rate the card draws, and the backward
           kernels twice for the same bits;
3. battery the scoring battery's entry points with the shipped checkpoints:
           evaluate_fused_batched (5 rulesets x 32 replicas = 160 universes
           of 256 x 256, 1024 steps) and evaluate_fused (5 x 1024 steps x 1
           universe); then one 64-step run_actions stream through the kernel
           path on the card and the plain path on the CPU;
4. server  the port's HTTP server on 127.0.0.1 in a thread: /health, /score
           (64 steps) and /rollout (256 x 256, 256 generations);
5. train   train_mcl.train at full width: 64 universes of 256 x 256, the 4
           training rulesets x 128 steps with both nets learning inside the
           step (dropout on, 8 Adam updates a learner), the checkpoints read
           back, a resumed last segment and one mixed-rules segment; then one
           16-step action stream through the training stack (dropout off,
           batch_size 4), kernel path on the card vs plain path on the CPU;
6. profile 64 steps of the batched battery and 64 training steps under
           torch.profiler: device time a step by kernel and the device's
           busy share;
7. report  a {"kernels": [...]} line with each kernel's launches on the main
           paths (battery, server and train, each counted from zero just
           before it), then the card's name and power limit, then the ok
           line.

Tolerances: float kernels vs plain twins rtol 1e-4 / atol 1e-4 (the twins
run cuDNN in full float32, TF32 off; cuDNN's own algorithms sum in other
orders); the AE error sums 65,536 squares per universe, so rtol 1e-4.
Battery rewards, kernel path on the card vs plain path on the CPU: rtol 1e-4,
atol 1e-5.  Gradients, kernel vs twin: 1e-4 of each leaf's largest entry (sums
over 4 million positions in other orders; a pool window whose maxima tie in
one and differ in the last bit in the other moves one window's share).
Training rewards through 4 Adam updates, card vs CPU: rtol 2e-3 (Adam divides
by the gradient's own scale).
"""

from __future__ import annotations

import argparse
import http.client
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback

# Peaks of one H100 SXM at its 700 W limit.  HBM and float32 from NVIDIA's
# data sheet; INT32 = 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost (the
# Hopper architecture white paper), the rate of the bitwise ALU work.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT32_OPS = 64 * 132 * 1.98e9
# Integer operations a packed word needs a generation, counted as the card
# executes them: LOP3 computes any 3-input boolean function and SHF a funnel
# shift in one operation.  Horizontal pairs 3 x (2 SHF + 2 LOP3) = 12, the
# carry-save tree 4 CSAs x 2 LOP3 + n2, n3 = 10, the two 9-leaf mux folds
# 2 x 11 LOP3 + the alive/dead select = 23: 45.  (carle_tpu/ops/bitpack.py:11
# counts ~110 two-input operations: the TPU has no 3-input logic op.)
OPS_PER_WORD = 45

SOURCES = {
    "ca_step": ("carle_tpu_torch/csrc/ca_step.cu", "carle_tpu/ops/pallas_ca.py:100"),
    "bit_multi_step": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                       "carle_tpu/ops/pallas_bitpack.py:565"),
    "encoder_fwd": ("carle_tpu_torch/csrc/encoder_fwd.cu",
                    "carle_tpu/ops/pallas_head.py:1081"),
    "ae_loss_fwd": ("carle_tpu_torch/csrc/ae_loss_fwd.cu",
                    "carle_tpu/ops/pallas_head.py:1841"),
    "encoder_bwd": ("carle_tpu_torch/csrc/encoder_bwd.cu",
                    "carle_tpu/ops/pallas_head.py:1114"),
    "ae_loss_bwd": ("carle_tpu_torch/csrc/ae_loss_bwd.cu",
                    "carle_tpu/ops/pallas_head.py:1875"),
}
# the kernels each main path must launch
PATH_KERNELS = {
    "battery": ("ca_step", "encoder_fwd", "ae_loss_fwd"),
    "server": ("ca_step", "bit_multi_step", "encoder_fwd", "ae_loss_fwd"),
    "train": ("ca_step", "encoder_fwd", "ae_loss_fwd", "encoder_bwd", "ae_loss_bwd"),
}
DROP_P = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Mean device time of a callable, each launch after an L2 flush.

    Before each timed launch the stream sleeps ~0.5 ms on the device, so the
    host has queued the launch by the time the start event fires: the time
    is the device's, not the Python wrapper's.  A callable that launches many
    kernels (the plain twins) can outrun the sleep; its time then includes
    the host's gaps between them, which is its real cost."""

    SLEEP_CYCLES = 1_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int, warmup: int = 1) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def bound_ms(nbytes: float, ops: float, rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_build(cuda_build):
    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    seconds = time.perf_counter() - t0
    for name, path in paths.items():
        log_path = path.with_suffix(".log")
        used = [l.strip() for l in log_path.read_text().splitlines()
                if "Used" in l or "spill" in l] if log_path.exists() else []
        log(f"built {name}: {path.name} | " + " | ".join(used))
    return seconds


def phase_kernels(torch, timer, shipped):
    """Each kernel vs its plain twin at the slice's shapes."""
    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_ca, cuda_head

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # ca_step: 160 universes of 256x256, valued actions, scalar and vector rules
    cfg = EnvConfig(instances=160)
    grid = (torch.rand(cfg.grid_shape, generator=gen, device=dev) < 0.35).to(torch.uint8)
    action = (torch.rand(cfg.action_shape, generator=gen, device=dev) * 8).to(torch.uint8)
    action[action > 3] = 0
    rule_vec = torch.randint(0, 1 << 18, (160,), generator=gen, device=dev,
                             dtype=torch.int32)
    err = 0
    for rule in (torch.tensor(rules.MORLEY, dtype=torch.int32, device=dev), rule_vec):
        got = cuda_ca.ca_step(grid, action, rule, cfg)
        want = cuda_ca.ca_step_plain(grid, action, rule, cfg)
        err = max(err, int((got.int() - want.int()).abs().max()))
    check(err == 0, f"ca_step differs from its plain twin: max {err}")
    n, h, w = cfg.grid_shape
    nbytes = 2 * n * h * w + n * cfg.eff_action_height * cfg.eff_action_width + 4 * n
    ops = n * h * w * OPS_PER_WORD / 32  # the packed engine's count: least ops
    b, by = bound_ms(nbytes, ops, INT32_OPS)
    results["ca_step"] = dict(
        max_abs_err=float(err),
        ms=timer.ms(lambda: cuda_ca.ca_step(grid, action, rule_vec, cfg), 20),
        plain_ms=timer.ms(lambda: cuda_ca.ca_step_plain(grid, action, rule_vec, cfg), 5),
        bound_ms=b, bound_by=by, library_ms=None,
        shape="u8 [160,256,256], action [160,64,64], rule [160]")
    log(f"ca_step ok: {results['ca_step']}")

    # bit_multi_step: 4096 x 256x256 x 128 generations (scalar rule) and
    # 160 universes with a rule vector
    steps = 128
    big = bitpack.pack_grid(
        (torch.rand((4096, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8))
    small = big[:160].contiguous()
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=dev)
    mism = 0
    for packed, rule in ((big, life), (small, rule_vec)):
        got = cuda_bitpack.bit_multi_step(packed, rule, steps).to(torch.int64)
        t0 = time.perf_counter()
        want = cuda_bitpack.bit_multi_step_plain(packed, rule, steps).to(torch.int64)
        torch.cuda.synchronize()
        if packed is big:
            plain_big_ms = (time.perf_counter() - t0) * 1e3
        mism = max(mism, int((got - want).abs().max()))
    check(mism == 0, f"bit_multi_step differs from its plain twin: max {mism}")
    words = big.numel()
    b, by = bound_ms(2 * 4 * words + 4, OPS_PER_WORD * words * steps, INT32_OPS)
    results["bit_multi_step"] = dict(
        max_abs_err=float(mism),
        ms=timer.ms(lambda: cuda_bitpack.bit_multi_step(big, life, steps), 3),
        plain_ms=plain_big_ms, bound_ms=b, bound_by=by, library_ms=None,
        shape="u32 [4096,256,8] x 128 generations, scalar rule")
    log(f"bit_multi_step ok: {results['bit_multi_step']}")

    # encoder_fwd and ae_loss_fwd on the battery's observations, shipped weights
    x = (torch.rand((160, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    rnd, ae = shipped["RND2D"], shipped["AE2D"]
    enc_err = 0.0
    cases = [(rnd.params, (4, 2)), (rnd.target_params, (4, 2)), (ae.params, (2, 2))]
    for p, pools in cases:
        args = (x, p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"])
        got = cuda_head.encoder_fwd(*args, pools)
        want = cuda_head.encoder_fwd_plain(*args, pools)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        enc_err = max(enc_err, float((got - want).abs().max()))
    p = rnd.params
    args = (x, p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"])
    c1, c2 = 4, 1
    flops = 2 * 160 * (256 * 256 * c1 * 9 + 64 * 64 * c2 * c1 * 9)
    b, by = bound_ms(160 * 256 * 256 + 160 * c2 * 32 * 32 * 4, flops, FP32_FLOPS)
    results["encoder_fwd"] = dict(
        max_abs_err=enc_err,
        ms=timer.ms(lambda: cuda_head.encoder_fwd(*args, (4, 2)), 20),
        plain_ms=timer.ms(lambda: cuda_head.encoder_fwd_plain(*args, (4, 2)), 5),
        bound_ms=b, bound_by=by, library_ms=None,
        shape="u8 [160,1,256,256], RND predictor (pools 4,2; C1=4, C2=1)")
    log(f"encoder_fwd ok: {results['encoder_fwd']}")

    q = ae.params
    ae_args = (x, q["conv1"]["w"], q["conv1"]["b"], q["conv2"]["w"], q["conv2"]["b"],
               q["deconv1"]["w"], q["deconv1"]["b"], q["deconv2"]["w"], q["deconv2"]["b"], x)
    got = cuda_head.ae_loss_fwd(*ae_args)
    again = cuda_head.ae_loss_fwd(*ae_args)
    want = cuda_head.ae_loss_fwd_plain(*ae_args)
    check(torch.equal(got, again), "ae_loss_fwd is not deterministic")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    hw = 256 * 256
    flops = 2 * 160 * (hw * 4 * 9 + hw // 4 * 2 * 4 * 9 + hw // 4 * 1 * 2 * 4
                       + hw * 1 * 1 * 4) + 160 * hw * 3
    b, by = bound_ms(2 * 160 * hw + 160 * 4, flops, FP32_FLOPS)
    results["ae_loss_fwd"] = dict(
        max_abs_err=float((got - want).abs().max()),
        max_rel_err=float(((got - want).abs() / want.abs()).max()),
        ms=timer.ms(lambda: cuda_head.ae_loss_fwd(*ae_args), 20),
        plain_ms=timer.ms(lambda: cuda_head.ae_loss_fwd_plain(*ae_args), 5),
        bound_ms=b, bound_by=by, library_ms=None,
        shape="u8 src=obs [160,1,256,256], AE2D (C1=4, C2=2, 1, 1)")
    log(f"ae_loss_fwd ok: {results['ae_loss_fwd']}")
    results.update(phase_train_kernels(torch, timer, gen))
    return results


def _leaf_errors(got, want):
    """Largest |difference| of each leaf over that leaf's largest entry."""
    return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(got, want)]


def phase_train_kernels(torch, timer, gen):
    """The backward kernels and the dropout forwards vs their twins at the
    training path's shapes: 64 universes of 256 x 256, fresh parameters."""
    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.mcl.rnd import init_predictor_params
    from carle_tpu_torch.ops import cuda_head

    dev = torch.device("cuda")
    n, h, w, seed = 64, 256, 256, 20240229
    hw = h * w
    x = (torch.rand((n, 1, h, w), generator=gen, device=dev) < 0.3).to(torch.uint8)
    x[: n // 4, :, : h // 2] = 0   # blank regions: whole pool windows tie
    rnd = init_predictor_params(EnvConfig(), gen, dev)
    ae = init_ae_params(gen, dev)
    enc_args = (x, rnd["conv1"]["w"], rnd["conv1"]["b"], rnd["conv2"]["w"],
                rnd["conv2"]["b"])
    ae_args = (x, *(ae[k][t] for k in ("conv1", "conv2", "deconv1", "deconv2")
                    for t in ("w", "b")), x)
    g = torch.randn((n, 1, h // 8, w // 8), generator=gen, device=dev)
    gbar = torch.randn((n,), generator=gen, device=dev) / (n * hw)
    results, tol = {}, 1e-4

    # forwards with dropout: agreement needs the same mask in kernel and twin
    drop = {}
    got = cuda_head.encoder_fwd(*enc_args, (4, 2), DROP_P, seed)
    want = cuda_head.encoder_fwd_plain(*enc_args, (4, 2), DROP_P, seed)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    check(not torch.equal(got, cuda_head.encoder_fwd(*enc_args, (4, 2))),
          "dropout changed nothing in encoder_fwd")
    drop["encoder_fwd_max_abs_err"] = float((got - want).abs().max())
    drop["encoder_fwd_ms"] = timer.ms(
        lambda: cuda_head.encoder_fwd(*enc_args, (4, 2), DROP_P, seed), 20)
    drop["encoder_fwd_plain_ms"] = timer.ms(
        lambda: cuda_head.encoder_fwd_plain(*enc_args, (4, 2), DROP_P, seed), 3)
    got = cuda_head.ae_loss_fwd(*ae_args, (2, 2), DROP_P, seed)
    want = cuda_head.ae_loss_fwd_plain(*ae_args, (2, 2), DROP_P, seed)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    drop["ae_loss_fwd_max_rel_err"] = float(((got - want).abs() / want.abs()).max())
    drop["ae_loss_fwd_ms"] = timer.ms(
        lambda: cuda_head.ae_loss_fwd(*ae_args, (2, 2), DROP_P, seed), 20)
    drop["ae_loss_fwd_plain_ms"] = timer.ms(
        lambda: cuda_head.ae_loss_fwd_plain(*ae_args, (2, 2), DROP_P, seed), 3)
    # the mask the card draws, read off the error: with zero weights and a
    # last bias of 40 a kept cell reconstructs 1.0 and a dropped cell 0.5, so
    # against blank cells the error counts the dropped cells exactly
    zeros = [torch.zeros_like(t) for t in ae_args[1:9]]
    zeros[7] = zeros[7] + 40.0
    blank = torch.zeros_like(x)
    err = cuda_head.ae_loss_fwd(blank, *zeros, blank, (2, 2), DROP_P, seed)
    dropped = (hw - err.double()) / 0.75
    keep = cuda_head.philox_keep_mask(seed, cuda_head.STAGE_DEC2, (n, 1, h, w), DROP_P, dev)
    twin_dropped = (~keep).sum(dim=(1, 2, 3)).double()
    check(torch.equal(dropped, twin_dropped),
          f"the card's mask is not the twin's: dropped cells an instance "
          f"{dropped[:4].tolist()} vs {twin_dropped[:4].tolist()}")
    rate = float(dropped.sum()) / (n * hw)
    sigma = math.sqrt(DROP_P * (1 - DROP_P) / (n * hw))
    check(abs(rate - DROP_P) < 3 * sigma, f"drop rate {rate} is not within 3 sigma "
          f"({3 * sigma:.2e}) of {DROP_P}")
    drop["drop_rate"], drop["three_sigma"] = rate, 3 * sigma
    log(f"dropout ok: {drop}")
    results["dropout"] = drop

    # encoder_bwd: RND predictor (pools 4,2; C1=4, C2=1)
    errs = {}
    for p in (0.0, DROP_P):
        got = cuda_head.encoder_bwd(*enc_args, g, (4, 2), p, seed)
        again = cuda_head.encoder_bwd(*enc_args, g, (4, 2), p, seed)
        want = cuda_head.encoder_bwd_plain(*enc_args, g, (4, 2), p, seed)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "encoder_bwd is not the same bit for bit from run to run")
        errs[p] = _leaf_errors(got, want)
        check(max(errs[p]) < tol, f"encoder_bwd (drop {p}) leaves differ: {errs[p]}")
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    c1, c2 = 4, 1
    s1, s2 = n * hw * c1 * 9, n * (hw // 16) * c2 * c1 * 9   # multiply-adds a stage
    flops = 2 * ((s1 + s2) + s1 + 2 * s2)   # recompute + dW1 + dW2 and the stage-1 cotangent
    b, by = bound_ms(n * hw + g.numel() * 4 + 77 * 4, flops, FP32_FLOPS)
    results["encoder_bwd"] = dict(
        max_abs_err=abs_err, max_leaf_rel_err=max(errs[DROP_P]),
        max_leaf_rel_err_no_drop=max(errs[0.0]),
        ms=timer.ms(lambda: cuda_head.encoder_bwd(*enc_args, g, (4, 2), DROP_P, seed), 10),
        ms_no_drop=timer.ms(lambda: cuda_head.encoder_bwd(*enc_args, g, (4, 2)), 10),
        plain_ms=timer.ms(
            lambda: cuda_head.encoder_bwd_plain(*enc_args, g, (4, 2), DROP_P, seed), 2),
        bound_ms=b, bound_by=by, library_ms=None,
        shape="u8 [64,1,256,256], g [64,1,32,32], RND predictor, drop 0.1")
    log(f"encoder_bwd ok: {results['encoder_bwd']}")

    # ae_loss_bwd: AE2D (C1=4, C2=2, CMID=1, COUT=1)
    for p in (0.0, DROP_P):
        got = cuda_head.ae_loss_bwd(*ae_args, gbar, (2, 2), p, seed)
        again = cuda_head.ae_loss_bwd(*ae_args, gbar, (2, 2), p, seed)
        want = cuda_head.ae_loss_bwd_plain(*ae_args, gbar, (2, 2), p, seed)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "ae_loss_bwd is not the same bit for bit from run to run")
        errs[p] = _leaf_errors(got, want)
        check(max(errs[p]) < tol, f"ae_loss_bwd (drop {p}) leaves differ: {errs[p]}")
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    c1, c2, cm, co = 4, 2, 1, 1
    s1, s2 = n * hw * c1 * 9, n * (hw // 4) * c2 * c1 * 9
    d1, d2 = n * (hw // 4) * cm * c2 * 4, n * hw * co * cm * 4
    # forward recompute, then dW of all four layers and the cotangents of
    # three (the cells take none)
    flops = 2 * ((s1 + s2 + d1 + d2) + (s1 + s2 + d1 + d2) + (s2 + d1 + d2)) + n * hw * 8
    b, by = bound_ms(2 * n * hw + n * 4 + 164 * 4, flops, FP32_FLOPS)
    results["ae_loss_bwd"] = dict(
        max_abs_err=abs_err, max_leaf_rel_err=max(errs[DROP_P]),
        max_leaf_rel_err_no_drop=max(errs[0.0]),
        ms=timer.ms(lambda: cuda_head.ae_loss_bwd(*ae_args, gbar, (2, 2), DROP_P, seed), 10),
        ms_no_drop=timer.ms(lambda: cuda_head.ae_loss_bwd(*ae_args, gbar, (2, 2)), 10),
        plain_ms=timer.ms(
            lambda: cuda_head.ae_loss_bwd_plain(*ae_args, gbar, (2, 2), DROP_P, seed), 2),
        bound_ms=b, bound_by=by, library_ms=None,
        shape="u8 src=obs [64,1,256,256], gbar [64], AE2D, drop 0.1")
    log(f"ae_loss_bwd ok: {results['ae_loss_bwd']}")
    return results


def shipped_states(torch):
    """The shipped learner states on the card, keyed by wrapper name."""
    from carle_tpu_torch.checkpoint import learner_state_from_numpy, read_npz
    from carle_tpu_torch.evaluation.eval import DEFAULT_WRAPPERS

    return {name: learner_state_from_numpy(read_npz(ckpt), "cuda")
            for name, _, ckpt in DEFAULT_WRAPPERS if ckpt}


def phase_battery(torch, cuda_build):
    from carle_tpu_torch.evaluation import eval as ev

    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    score_b, per_rule = ev.evaluate_fused_batched(steps=1024, replicas=32, seed=0,
                                                  verbose=False, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    score_s, trace = ev.evaluate_fused(steps=1024, seed=0, verbose=False, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = cuda_build.launch_counts()
    for name, score in (("batched", score_b), ("sequential", score_s)):
        check(math.isfinite(score) and 0.0 <= score <= 10.0,
              f"{name} battery score {score} is not in [0, 10]")
    check(trace.shape == (5 * 1024,) and per_rule.shape == (5,), "battery shapes")
    e2e = {
        "batched_score": score_b, "batched_per_ruleset": [float(v) for v in per_rule],
        "batched_s": t1 - t0, "batched_universe_steps_per_s": 160 * 1024 / (t1 - t0),
        "sequential_score": score_s, "sequential_s": t2 - t1,
        "sequential_steps_per_s": 5 * 1024 / (t2 - t1),
    }
    log(f"battery ok: {json.dumps(e2e)}")
    log(f"battery launches: {json.dumps(counts)}")
    return counts, e2e


def phase_parity(torch):
    """64 steps of one numpy action stream through the kernel path on the
    card and the plain path on the CPU (the wrappers take their plain twins
    only for CPU tensors)."""
    import numpy as np

    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.evaluation import eval as ev
    from carle_tpu_torch.rollout import Rollout

    cfg = EnvConfig(instances=10)
    rng = np.random.RandomState(0)
    acts = (rng.rand(64, *cfg.action_shape) < 0.1).astype(np.float32)
    acts[40] = 1.0  # the master reset
    bits = [ev.battery_rule_bits(rs, True) for rs in ev.DEFAULT_RULES] * 2
    rewards = {}
    for device in ("cuda", "cpu"):
        ro = Rollout(cfg, ev.wrapper_defs(cfg, ev.DEFAULT_WRAPPERS, True),
                     device=device)
        carry = ro.init(ro.generator(0), bits[0])
        carry = carry._replace(stack=carry.stack._replace(
            wrappers=ev.inject_wrapper_checkpoints(carry.stack.wrappers,
                                                   ev.DEFAULT_WRAPPERS)))
        carry = ro.with_rules(carry, torch.tensor(bits, dtype=torch.int32))
        _, r = ro.run_actions(carry, torch.from_numpy(acts))
        rewards[device] = r.cpu()
    torch.testing.assert_close(rewards["cuda"], rewards["cpu"], rtol=1e-4, atol=1e-5)
    diff = float((rewards["cuda"] - rewards["cpu"]).abs().max())
    log(f"run_actions kernel path (cuda) vs plain path (cpu): max abs diff {diff}")
    return diff


def _request(conn, method, path, body=None):
    conn.request(method, path, None if body is None else json.dumps(body))
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    check(resp.status == 200, f"{path}: HTTP {resp.status} {payload}")
    return payload


def phase_server(torch, cuda_build):
    import numpy as np

    from carle_tpu_torch import serve
    from carle_tpu_torch.ops import bitpack
    from carle_tpu_torch.rle import parse_rle_text

    cuda_build.reset_launch_counts()
    srv = serve.make_server("127.0.0.1", 0, device="cuda")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=600)
        health = _request(conn, "GET", "/health")
        check(health["ok"] and health["device"].startswith("cuda"), f"/health {health}")
        score = _request(conn, "POST", "/score", {"steps": 64})
        check(math.isfinite(score["score"]) and 0.0 <= score["score"] <= 10.0
              and len(score["per_ruleset"]) == 5, f"/score {score}")
        body = {"rule": "B3/S23", "size": 256, "steps": 256, "seed": 1}
        roll = _request(conn, "POST", "/rollout", body)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread did not stop")
    counts = cuda_build.launch_counts()
    # /rollout against the plain packed engine on the CPU, same soup
    grid, bits, birth, survive = serve._initial_grid(body, torch.device("cuda"))
    want = bitpack.bit_multi_step(bitpack.pack_grid(grid.cpu()), bits, 256)
    want_pop = int(bitpack.unpack_grid(want, 256).sum())
    decoded = parse_rle_text(roll["rle"]).grid
    check(roll["generations"] == 256 and roll["population"] == want_pop
          and int(np.asarray(decoded).sum()) == want_pop,
          f"/rollout population {roll['population']} != plain {want_pop}")
    log(f"server ok: health, score {score['score']:.4f} in {score['latency_s']} s, "
        f"rollout population {roll['population']} in {roll['latency_s']} s")
    log(f"server launches: {json.dumps(counts)}")
    return counts, {"score_latency_s": score["latency_s"],
                    "rollout_latency_s": roll["latency_s"]}


def phase_train(torch, cuda_build):
    """train_mcl.train at full width through its public entry point."""
    import glob

    import numpy as np

    from carle_tpu_torch import EnvConfig, train_mcl
    from carle_tpu_torch.checkpoint import flatten, load_pytree, read_npz
    from carle_tpu_torch.mcl import ae2d_def, rnd2d_def

    n, steps_per_rule = 64, 128
    cfg = EnvConfig(instances=n)
    segments = []
    cuda_build.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        hist = train_mcl.train(instances=n, height=256, width=256,
                               steps=(1, steps_per_rule), batch_size=64, seed=0,
                               log_dir=os.path.join(tmp, "run"),
                               segment_callback=segments.append, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = cuda_build.launch_counts()
        steps = 4 * steps_per_rule
        check(hist.shape == (steps,) and np.isfinite(hist).all(), "training rewards")
        models = os.path.join(tmp, "run", "models")
        gen = torch.Generator(device="cuda").manual_seed(0)
        states = {}
        for name, make in (("RND2D", rnd2d_def), ("AE2D", ae2d_def)):
            path = train_mcl._find_checkpoint(models, name)
            like = make(cfg).init(gen, torch.device("cuda"))
            states[name] = load_pytree(path, like)
            check(int(states[name].updates) == steps // 64,
                  f"{name} reports {int(states[name].updates)} updates, not {steps // 64}")
            check(int(states[name].buffer_length) == 0, f"{name} accumulator not cleared")
            stored = read_npz(path)
            check(all(np.array_equal(t.cpu().numpy(), stored[k])
                      for k, t in flatten(states[name]).items()),
                  f"{name} checkpoint does not load back equal")
            check(all(bool(torch.isfinite(t).all())
                      for t in flatten(states[name].params).values()),
                  f"{name} parameters are not finite")
        first, last = segments[0]["mean_reward"], segments[-1]["mean_reward"]
        check(last < first, f"the bonus did not fall as the nets learned: mean reward "
              f"{first:.4e} in the first segment, {last:.4e} in the last")
        # resume: the last segment only, from the written learner states
        again = []
        resumed = train_mcl.train(instances=n, steps=(1, steps_per_rule), batch_size=64,
                                  seed=1, log_dir=os.path.join(tmp, "again"),
                                  resume_from=models, skip_segments=3,
                                  segment_callback=again.append, device="cuda")
        check(resumed.shape == (steps_per_rule,) and len(again) == 1
              and np.isfinite(resumed).all(), "resumed segment")
        rnd2 = load_pytree(train_mcl._find_checkpoint(
            os.path.join(tmp, "again", "models"), "RND2D"), states["RND2D"])
        check(int(rnd2.updates) == steps // 64 + steps_per_rule // 64, "resumed updates")
        t1 = time.perf_counter()
        mixed = train_mcl.train(instances=n, steps=(1, 64), batch_size=64, seed=2,
                                mixed_rules=True, log_dir=os.path.join(tmp, "mixed"),
                                device="cuda")
        mixed_wall = time.perf_counter() - t1
        check(mixed.shape == (64,) and np.isfinite(mixed).all(), "mixed-rules segment")
        check(len(glob.glob(os.path.join(tmp, "*", "metrics", "mcl_rewards_*.npy"))) == 3,
              "reward histories were not written")
    e2e = {
        "universes": n, "steps": steps, "wall_s": wall,
        "steps_per_s": steps / wall, "universe_steps_per_s": n * steps / wall,
        "segment_universe_steps_per_s": [s["steps_per_second"] for s in segments],
        "segment_mean_reward": [s["mean_reward"] for s in segments],
        "updates": {k: int(v.updates) for k, v in states.items()},
        "resumed_mean_reward": again[0]["mean_reward"],
        "mixed_rules_64_steps_s": mixed_wall,
    }
    log(f"train ok: {json.dumps(e2e)}")
    log(f"train launches: {json.dumps(counts)}")
    return counts, e2e


def phase_train_parity(torch):
    """16 steps of one numpy action stream through the training stack
    (dropout off, batch_size 4: four Adam updates a learner), kernel path on
    the card vs plain path on the CPU, from the same initial parameters."""
    import numpy as np

    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.mcl import ae2d_def, rnd2d_def
    from carle_tpu_torch.rollout import Rollout

    cfg = EnvConfig(instances=8)
    acts = (np.random.RandomState(0).rand(16, *cfg.action_shape) < 0.1).astype(np.float32)
    kw = dict(train=True, dropout=False, batch_size=4)
    rewards, wstates = {}, None
    for device in ("cpu", "cuda"):
        ro = Rollout(cfg, [rnd2d_def(cfg, **kw), ae2d_def(cfg, **kw)], device=device)
        carry = ro.init(ro.generator(0), rules.LIFE)
        if wstates is None:   # the CPU's draw, carried to the card
            wstates = carry.stack.wrappers
        else:
            to_card = lambda t: t.to("cuda") if torch.is_tensor(t) else t
            moved = tuple(_map_state(ws, to_card) for ws in wstates)
            carry = carry._replace(stack=carry.stack._replace(wrappers=moved))
        carry, r = ro.run_actions(carry, torch.from_numpy(acts))
        check(all(int(ws.updates) == 4 for ws in carry.stack.wrappers), "parity updates")
        rewards[device] = r.cpu()
    torch.testing.assert_close(rewards["cuda"], rewards["cpu"], rtol=2e-3, atol=0)
    diff = float(((rewards["cuda"] - rewards["cpu"]).abs() / rewards["cpu"].abs()).max())
    log(f"training stack kernel path (cuda) vs plain path (cpu), 16 steps through 4 "
        f"updates: max rel diff {diff}")
    return diff


def _map_state(state, fn):
    """``fn`` over every leaf of a learner state (NamedTuple of dicts/tuples)."""
    if isinstance(state, dict):
        return {k: _map_state(v, fn) for k, v in state.items()}
    if hasattr(state, "_fields"):
        return type(state)(*(_map_state(v, fn) for v in state))
    if isinstance(state, (tuple, list)):
        return type(state)(_map_state(v, fn) for v in state)
    return fn(state)


def _profile_steps(torch, ro, carry, steps, universes):
    """``steps`` steps unprofiled (wall, and the host's time to queue them)
    and again under torch.profiler: device time a step by kernel and the
    device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    carry, _ = ro.run(carry, 16)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = ro.run(carry, steps)
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        carry, _ = ro.run(carry, steps)
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # kernels only: an aten op's entry repeats the device time of its kernels
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=device_us, reverse=True)[:14]
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {
        "steps": steps, "universes": universes, "wall_ms_per_step": wall_ms,
        "host_queue_ms_per_step": host_ms, "device_ms_per_step": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "device_launches_per_step": sum(e.count for e in events) / steps,
        "top_device_us_per_step": [
            {"name": e.key[:60], "us": device_us(e) / steps,
             "calls_per_step": e.count / steps} for e in top],
        # the host's own time in each operation, under the profiler
        "top_host_us_per_step": [
            {"name": e.key[:40], "us": e.self_cpu_time_total / steps,
             "calls_per_step": e.count / steps} for e in host],
    }


def phase_profile_train(torch, steps: int = 64):
    """Where a training step's time goes: 64 universes, both nets learning,
    dropout on, Life."""
    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.mcl import ae2d_def, rnd2d_def
    from carle_tpu_torch.rollout import Rollout

    cfg = EnvConfig(instances=64)
    ro = Rollout(cfg, [rnd2d_def(cfg), ae2d_def(cfg)], make_random_agent(64, 64, 0.1),
                 device="cuda")
    carry = ro.init(ro.generator(0), rules.LIFE)
    return _profile_steps(torch, ro, carry, steps, 64)


def phase_profile(torch, steps: int = 64):
    """Where a battery step's time goes: ``steps`` steps of the batched
    battery (160 universes) under torch.profiler, beside the same steps
    unprofiled.  Returns device time a step by kernel and the device's busy
    share of the unprofiled wall time."""
    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.evaluation import eval as ev
    from carle_tpu_torch.rollout import Rollout

    cfg = EnvConfig(instances=160)
    ro = Rollout(cfg, ev.wrapper_defs(cfg, ev.DEFAULT_WRAPPERS, True),
                 make_random_agent(64, 64, 0.1), device="cuda")
    carry = ro.init(ro.generator(0), 0)
    carry = carry._replace(stack=carry.stack._replace(
        wrappers=ev.inject_wrapper_checkpoints(carry.stack.wrappers,
                                               ev.DEFAULT_WRAPPERS)))
    bits = [ev.battery_rule_bits(rs, True) for rs in ev.DEFAULT_RULES] * 32
    carry = ro.with_rules(carry, torch.tensor(bits, dtype=torch.int32))
    carry, _ = ro.reset(carry)
    return _profile_steps(torch, ro, carry, steps, 160)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", default=None,
                        help="also write the full report as JSON to this path")
    args = parser.parse_args()
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        log("FAIL: PyTorch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 1
    try:
        from carle_tpu_torch.ops import cuda_build
    except ImportError as exc:
        log(f"FAIL: carle_tpu_torch is not importable ({exc}); run from the "
            "repository root")
        return 1
    torch.backends.cudnn.allow_tf32 = False       # the plain twins are the
    torch.backends.cuda.matmul.allow_tf32 = False  # reference: full float32
    try:
        card = card_line()
        log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        build_s = phase_build(cuda_build)
        log(f"build: {build_s:.1f} s")
        shipped = shipped_states(torch)
        timer = Timer(torch)
        results = phase_kernels(torch, timer, shipped)
        del timer
        torch.cuda.empty_cache()
        battery_counts, e2e = phase_battery(torch, cuda_build)
        parity_diff = phase_parity(torch)
        server_counts, server = phase_server(torch, cuda_build)
        train_counts, train = phase_train(torch, cuda_build)
        train_parity_diff = phase_train_parity(torch)
        profile = phase_profile(torch)
        log(f"profile: {json.dumps(profile)}")
        profile_train = phase_profile_train(torch)
        log(f"profile (training): {json.dumps(profile_train)}")
    except Exception:  # report the failing phase and exit non-zero
        traceback.print_exc()
        log("FAIL: see the traceback above")
        return 1

    path_counts = {"battery": battery_counts, "server": server_counts,
                   "train": train_counts}
    missing = [f"{path}:{k}" for path, needed in PATH_KERNELS.items()
               for k in needed if path_counts[path][k] == 0]
    if missing:
        log(f"FAIL: kernels not launched on the main path: {missing}")
        return 1
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c[name] for c in path_counts.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    report = {
        "card": card, "build_s": build_s, "kernels": kernels,
        "kernel_shapes": {k: results[k]["shape"] for k in SOURCES},
        "kernel_details": {k: results[k] for k in SOURCES},
        "launches": path_counts,
        "e2e": e2e, "server": server, "run_actions_max_abs_diff": parity_diff,
        "train": train, "train_parity_max_rel_diff": train_parity_diff,
        "dropout": results["dropout"],
        "profile": profile, "profile_train": profile_train,
        "total_s": time.perf_counter() - t_start,
    }
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    log(json.dumps({k: report[k] for k in ("launches", "e2e", "server", "train",
                                           "total_s")}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
