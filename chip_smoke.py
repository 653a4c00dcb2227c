"""Chip smoke test of carle_tpu_torch on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero without the final line:

1. build   the CUDA kernels from carle_tpu_torch/csrc (one nvcc a source,
           all at once) and print the card as nvidia-smi names it;
2. kernels each kernel against its plain PyTorch twin on the card at the
           slices' shapes (integer kernels exact, float kernels within the
           stated tolerance), with their times (CUDA events, L2 flushed
           before every launch) and the least time the card could take; the
           net kernels also with dropout 0.1 (kernel and twin draw the same
           Philox mask), the drop rate the card draws, and the backward
           kernels twice for the same bits; the single-stage kernels (head,
           tail, loss tail) and the decoder loss at the autoencoder's shapes
           (forwards on 160 universes, backwards on 64, with and without
           dropout), the head also at RND's pool 4 and with its input
           cotangent, and the whole-autoencoder kernels with a source frame
           that is not the target; the fixed-rule, column-major and uint8
           engines at bench.py's geometry (4096 x 256 x 256, 128 generations,
           Life, p = 0.5; the data-rule engines also with the battery's 5
           rulesets dealt over the universes), bit for bit; every kernel that
           reads cells fed the packed words against it fed the same cells as
           uint8, bit for bit, forward and backward, dropout off and on; the
           band tiling's kernel features at the 8192² slice's band shapes:
           the RND encoder with per-band row masks on 512 bands of 32 x 8192
           and the decoder loss with per-band row weights on Prediction's 128
           windows of 80 x 8192, dropout off and on, uint8 and packed, a mask
           or weights of ones bit for bit the plain kernel; the global
           encoders (RND predictor and target, AE) and decoder loss at 8192²
           (column tiles); conv_ae_loss on 4 x 2048² (past the whole-AE
           kernel) against encoder + decoder loss, bit for bit; tiles forced
           at 256² (48 cells, edges inside words) against one tile; 65,600
           instances a launch;
   engines each of the five packed and uint8 engines once at bench.py's
           geometry through its public function: all leave bench.py's
           checksum, the live-cell sum of the plain twin;
3. battery the scoring battery's entry points with the shipped checkpoints:
           evaluate_fused_batched (5 rulesets x 32 replicas = 160 universes
           of 256 x 256, 1024 steps) and evaluate_fused (5 x 256 steps x 1
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
   packed  the packed path: train_mcl.train(packed_state=True) at train-64's
           geometry, whose reward history must equal the uint8 run's; the
           packed stack on 160 universes x 256 steps with the seven
           packed-native wrappers (Prediction and Surprise learning) and
           RND2D + AE2D (two kernels), each wrapper's reward against its
           dense def on the uint8 stack, no cell view unpacked, the nets
           reading the words; 16 steps of it on 8 universes, card against CPU;
6. routes  the autoencoder's error and its 8 gradient leaves on 64 universes
           (a frame of a real rollout) by one kernel, by two (encoder, decoder
           loss) and by four (head, head, tail, loss tail), dropout off and on
           with one seed: all three agree, and their times;
7. wrappers all nine reward wrappers: evaluate_fused_batched with a list of
           all nine on 160 universes x 256 steps; PredictionBonus over AE2D
           (two-kernel route) over RND2D learning online on 64 universes for
           256 steps with dropout on (4 updates a learner, the prediction
           error falls); ae_forward on the shipped AE2D checkpoint against
           ae_loss_fwd; then the nine-wrapper stack (32 steps) and the
           learning stack (16 steps, dropout off, batch_size 4) through the
           kernel path on the card and the plain path on the CPU;
8. bands   band tiling on one packed universe of 8192²: RND2D with
           BandTiling(512) and the packed-ring PredictionBonus with
           BandTiling(128) learning through run_actions (64 x 64 actions at
           p = 0.2, dropout on, 128 steps, 2 Adam updates each; cells/s and
           peak memory); each banded stack against the unbanded one at 8192²
           (dropout off, batch_size 4, 16 steps); the banded stack on 8
           universes of 256² with BandTiling(4), card against CPU; each leg
           profiled as in the profile phase;
9. profile 64 steps of the batched battery and 64 training steps, uint8 and
           packed carry, under torch.profiler: device time a step by kernel,
           the device's busy share and the peak device memory;
10. report a {"kernels": [...]} line with each kernel's launches on the main
           paths (battery, server, train, routes, wrappers, packed, bands and
           engines, each counted from zero just before it; the rows of the
           mask and the row weights count their kernel's launches on the
           bands path), then the card's name and power limit, then the ok
           line.

Tolerances: float kernels vs plain twins rtol 1e-4 / atol 1e-4 (the twins
run cuDNN in full float32, TF32 off; cuDNN's own algorithms sum in other
orders); the AE error sums 65,536 squares per universe, so rtol 1e-4.
Integer engines and the packed-word inputs: bit for bit.  The packed path's
wrappers against their dense defs: rtol 1e-4 (Speed's float32 weighted sums
in another order; Morpho's exact integer sums against a float32 conv, atol
1e-4 of its largest reward).
Battery rewards, kernel path on the card vs plain path on the CPU: rtol 1e-4,
atol 1e-5.  Gradients, kernel vs twin: 1e-4 of each leaf's largest entry (sums
over 4 million positions in other orders; a pool window whose maxima tie in
one and differ in the last bit in the other moves one window's share).
Training rewards through 4 Adam updates, card vs CPU: rtol 2e-3 (Adam divides
by the gradient's own scale).  The autoencoder's three routes against each
other: error rtol 1e-4, gradients as above (one mask, other summation
orders); ae_forward's reconstruction error against ae_loss_fwd's: rtol 1e-4.
The encoder's gradients at 8192² (band shapes and global): 2e-3 of each
leaf's largest entry (134 million stage-1 positions: the pool-tie shares that
move between summation orders add up; see phase_band_kernels).  Column tiles
against one tile: encoder outputs bit for bit, sums and gradients 1e-5 of each
leaf's largest entry.  Banded stack against unbanded at 8192²: rtol 1e-4.
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
# The same count for the other engines (a word of cells a generation):
# the row-major engine with Life fixed at compile time: pairs 12, carry-save
# tree 10, Life's decision n1 & ~n2 & ~n3 & (n0 | g) 2 LOP3 = 24; column-major
# (each thread carries its neighbours' vertical triples): the east column's
# triple 2 SHF + 2 LOP3, count9 from the triples 2 CSAs x 2 LOP3 + 4 = 12,
# then Life's decision 2 LOP3 = 16 fixed, the two 10-leaf mux folds 2 x 11
# LOP3 + the select = 23 as data: 35; the uint8 engine (4 cells a word):
# column sums 3 IADD3, 2 SHF, count9 1 IADD3, index 1 LEA, a byte's lookup
# BFE + SHF + BFI x 4 = 19.
OPS_PER_WORD_STATIC, OPS_PER_WORD_STATIC_CM, OPS_PER_WORD_CM = 24, 16, 35
OPS_PER_U8_WORD = 19
BENCH_UNIVERSES, BENCH_SIZE, BENCH_STEPS = 4096, 256, 128   # bench.py's geometry
BATTERY_RULESETS = (([3], [2, 3]), ([3, 6, 8], [2, 4, 5]), ([3, 6, 7, 8], [3, 4, 6, 7, 8]),
                    ([3], [0, 2, 3]), ([1, 3, 5, 7], [1, 3, 5, 7]))

SOURCES = {
    "ca_step": ("carle_tpu_torch/csrc/ca_step.cu", "carle_tpu/ops/pallas_ca.py:100"),
    "bit_multi_step": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                       "carle_tpu/ops/pallas_bitpack.py:565"),
    "bit_multi_step_static": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                              "carle_tpu/ops/pallas_bitpack.py:647"),
    "bit_multi_step_static_cm": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                                 "carle_tpu/ops/pallas_bitpack.py:736"),
    "bit_multi_step_cm": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                          "carle_tpu/ops/pallas_bitpack.py:770"),
    "ca_multi_step": ("carle_tpu_torch/csrc/ca_multi_step.cu",
                      "carle_tpu/ops/pallas_ca.py:153"),
    "encoder_fwd": ("carle_tpu_torch/csrc/encoder_fwd.cu",
                    "carle_tpu/ops/pallas_head.py:1081"),
    "ae_loss_fwd": ("carle_tpu_torch/csrc/ae_loss_fwd.cu",
                    "carle_tpu/ops/pallas_head.py:1841"),
    "encoder_bwd": ("carle_tpu_torch/csrc/encoder_bwd.cu",
                    "carle_tpu/ops/pallas_head.py:1114"),
    "ae_loss_bwd": ("carle_tpu_torch/csrc/ae_loss_bwd.cu",
                    "carle_tpu/ops/pallas_head.py:1875"),
    "head_fwd": ("carle_tpu_torch/csrc/head_fwd.cu", "carle_tpu/ops/pallas_head.py:281"),
    "head_bwd": ("carle_tpu_torch/csrc/head_bwd.cu", "carle_tpu/ops/pallas_head.py:297"),
    "tail_fwd": ("carle_tpu_torch/csrc/tail.cu", "carle_tpu/ops/pallas_head.py:628"),
    "tail_bwd": ("carle_tpu_torch/csrc/tail.cu", "carle_tpu/ops/pallas_head.py:645"),
    "loss_tail_fwd": ("carle_tpu_torch/csrc/tail.cu", "carle_tpu/ops/pallas_head.py:794"),
    "loss_tail_bwd": ("carle_tpu_torch/csrc/tail.cu", "carle_tpu/ops/pallas_head.py:822"),
    "decoder_loss_fwd": ("carle_tpu_torch/csrc/decoder_loss_fwd.cu",
                         "carle_tpu/ops/pallas_head.py:1481"),
    "decoder_loss_bwd": ("carle_tpu_torch/csrc/decoder_loss_bwd.cu",
                         "carle_tpu/ops/pallas_head.py:1506"),
}
# Rows whose kernel is another row's with band tiling's feature added: the
# launches they report are their kernel's on the bands path, where every
# encoder launch carries the per-band row mask and every decoder-loss launch
# the per-band row weights.
FEATURE_ROWS = {
    "encoder_fwd_mask": ("encoder_fwd", "carle_tpu_torch/csrc/encoder_fwd.cu",
                         "carle_tpu/ops/pallas_head.py:1375"),
    "encoder_bwd_mask": ("encoder_bwd", "carle_tpu_torch/csrc/encoder_bwd.cu",
                         "carle_tpu/ops/pallas_head.py:1375"),
    "decoder_loss_fwd_em": ("decoder_loss_fwd", "carle_tpu_torch/csrc/decoder_loss_fwd.cu",
                            "carle_tpu/ops/pallas_head.py:1776"),
    "decoder_loss_bwd_em": ("decoder_loss_bwd", "carle_tpu_torch/csrc/decoder_loss_bwd.cu",
                            "carle_tpu/ops/pallas_head.py:1776"),
}
BAND_SIZE = 8192                     # pod_smoke.py's spatial8k universe, one of it
RND_BANDS, PRED_BANDS = 512, 128     # BandTiling(size // 16), BandTiling(size // 64)
# the kernels each main path must launch
PATH_KERNELS = {
    "battery": ("ca_step", "encoder_fwd", "ae_loss_fwd"),
    "server": ("ca_step", "bit_multi_step", "encoder_fwd", "ae_loss_fwd"),
    "train": ("ca_step", "encoder_fwd", "ae_loss_fwd", "encoder_bwd", "ae_loss_bwd"),
    "routes": ("encoder_fwd", "encoder_bwd", "ae_loss_fwd", "ae_loss_bwd", "head_fwd",
               "head_bwd", "tail_fwd", "tail_bwd", "loss_tail_fwd", "loss_tail_bwd",
               "decoder_loss_fwd", "decoder_loss_bwd"),
    "wrappers": ("ca_step", "encoder_fwd", "encoder_bwd", "ae_loss_fwd", "ae_loss_bwd",
                 "decoder_loss_fwd", "decoder_loss_bwd", "tail_fwd"),
    "packed": ("bit_multi_step", "encoder_fwd", "encoder_bwd", "ae_loss_fwd", "ae_loss_bwd",
               "decoder_loss_fwd", "decoder_loss_bwd"),
    "bands": ("bit_multi_step", "encoder_fwd", "encoder_bwd", "decoder_loss_fwd",
              "decoder_loss_bwd"),
    "engines": ("bit_multi_step_static", "bit_multi_step_static_cm", "bit_multi_step_cm",
                "ca_multi_step"),
}
# the kernels the packed path must launch on packed words
PACKED_INPUT_KERNELS = ("encoder_fwd", "encoder_bwd", "ae_loss_fwd", "ae_loss_bwd",
                        "decoder_loss_fwd", "decoder_loss_bwd")
NINE = ("RND2D", "AE2D", "PredictionBonus", "SurpriseBonus", "MorphoBonus", "CornerBonus",
        "ParsimonyBonus", "SpeedDetector", "PufferDetector")
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
    results.update(phase_stage_kernels(torch, timer, gen))
    results.update(phase_engine_kernels(torch, timer))
    phase_packed_input_kernels(torch, timer, gen, results)
    results.update(phase_band_kernels(torch, timer, gen))
    torch.cuda.empty_cache()
    return results


def _plain_ms(torch, fn):
    """(fn(), its wall ms after a synchronize): one run of a plain twin."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _bench_grid(torch):
    """bench.py's grid: 4096 universes of 256 x 256, cells alive with p = 0.5,
    a fixed seed."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (BENCH_UNIVERSES, BENCH_SIZE, BENCH_SIZE)
    return (torch.rand(shape, generator=gen, device="cuda") < 0.5).to(torch.uint8)


def phase_engine_kernels(torch, timer):
    """Rows 10, 11a, 11b and 12 against their twins at bench.py's geometry
    (4096 x 256 x 256, 128 generations, Life; rows 11b and 12 also with the
    battery's 5 rulesets dealt over the universes), bit for bit."""
    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_ca

    grid = _bench_grid(torch)
    n, size, steps = BENCH_UNIVERSES, BENCH_SIZE, BENCH_STEPS
    rm, cm = bitpack.pack_grid(grid), bitpack.pack_grid_cm(grid)
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device="cuda")
    vec = torch.tensor([rules.pack_rule_bits(*BATTERY_RULESETS[i % 5]) for i in range(n)],
                       dtype=torch.int32, device="cuda")
    words, cells = rm.numel(), grid.numel()
    results = {}

    def held(name, kernel_fn, plain_fn):
        got = kernel_fn()
        want, plain = _plain_ms(torch, plain_fn)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0, f"{name} differs from its plain twin: max {err}")
        return plain

    specs = {
        "bit_multi_step_static": (
            lambda: cuda_bitpack.bit_multi_step_static(rm, [3], [2, 3], steps),
            lambda: cuda_bitpack.bit_multi_step_static_plain(rm, [3], [2, 3], steps),
            None, OPS_PER_WORD_STATIC, "u32 [4096,256,8] x 128, Life fixed"),
        "bit_multi_step_static_cm": (
            lambda: cuda_bitpack.bit_multi_step_static_cm(cm, [3], [2, 3], steps),
            lambda: cuda_bitpack.bit_multi_step_static_cm_plain(cm, [3], [2, 3], steps),
            None, OPS_PER_WORD_STATIC_CM, "u32 column-major [4096,8,256] x 128, Life fixed"),
        "bit_multi_step_cm": (
            lambda: cuda_bitpack.bit_multi_step_cm(cm, life, steps),
            lambda: cuda_bitpack.bit_multi_step_cm_plain(cm, life, steps),
            (lambda: cuda_bitpack.bit_multi_step_cm(cm, vec, steps),
             lambda: cuda_bitpack.bit_multi_step_cm_plain(cm, vec, steps)),
            OPS_PER_WORD_CM, "u32 column-major [4096,8,256] x 128, Life as data"),
    }
    for name, (kfn, pfn, vector, ops, shape) in specs.items():
        plain = held(name, kfn, pfn)
        if vector:
            held(name + " (rule vector)", *vector)
        b, by = bound_ms(2 * 4 * words + 4, ops * words * steps, INT32_OPS)
        results[name] = dict(max_abs_err=0.0, ms=timer.ms(kfn, 3), plain_ms=plain,
                             bound_ms=b, bound_by=by, library_ms=None, shape=shape)
        if vector:
            results[name]["ms_rule_vector"] = timer.ms(vector[0], 3)
        log(f"{name} ok: {results[name]}")
    plain = held("ca_multi_step", lambda: cuda_ca.ca_multi_step(grid, life, steps),
                 lambda: cuda_ca.ca_multi_step_plain(grid, life, steps))
    held("ca_multi_step (rule vector)", lambda: cuda_ca.ca_multi_step(grid, vec, steps),
         lambda: cuda_ca.ca_multi_step_plain(grid, vec, steps))
    b, by = bound_ms(2 * cells + 4, OPS_PER_U8_WORD * cells // 4 * steps, INT32_OPS)
    results["ca_multi_step"] = dict(
        max_abs_err=0.0, ms=timer.ms(lambda: cuda_ca.ca_multi_step(grid, life, steps), 2),
        ms_rule_vector=timer.ms(lambda: cuda_ca.ca_multi_step(grid, vec, steps), 2),
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        shape="u8 [4096,256,256] x 128, Life")
    log(f"ca_multi_step ok: {results['ca_multi_step']}")
    return results


def _same_bits(a, b) -> bool:
    """Tensors (or tuples of them, None skipped) equal bit for bit."""
    if isinstance(a, (tuple, list)):
        return all(_same_bits(x, y) for x, y in zip(a, b) if x is not None)
    return a.equal(b)


def phase_packed_input_kernels(torch, timer, gen, results):
    """Each kernel that reads cells, fed the packed universe (uint32 words
    [N, 1, H, W/32]), against the same kernel fed the same cells as uint8:
    the same bits, forward and backward, dropout off and 0.1; and its time on
    the words at the shapes of its uint8 row (added to ``results``)."""
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.mcl.rnd import init_predictor_params
    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.ops import bitpack, cuda_head as ch, cuda_stages as cs

    dev = torch.device("cuda")
    seed = 4242
    x8 = {n: (torch.rand((n, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
          for n in (64, 160)}
    o8 = {n: (torch.rand((n, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
          for n in (64, 160)}
    x32 = {n: bitpack.pack_grid(t) for n, t in x8.items()}
    o32 = {n: bitpack.pack_grid(t) for n, t in o8.items()}
    rnd = init_predictor_params(EnvConfig(), gen, dev)
    enc = (rnd["conv1"]["w"], rnd["conv1"]["b"], rnd["conv2"]["w"], rnd["conv2"]["b"])
    ae = init_ae_params(gen, dev)
    ps = [ae[k][t] for k in ("conv1", "conv2", "deconv1", "deconv2") for t in ("w", "b")]
    gbar = torch.randn((64,), generator=gen, device=dev)
    g_enc = torch.randn((64, 1, 32, 32), generator=gen, device=dev)
    g_head = torch.randn((64, 4, 128, 128), generator=gen, device=dev)
    emb = {n: ch.encoder_fwd(x8[n], *ps[:4], (2, 2)) for n in (64, 160)}
    mid = {n: torch.relu(torch.randn((n, 1, 128, 128), generator=gen, device=dev))
           for n in (64, 160)}
    cases = {  # name: (call on words, call on cells) at 64 universes, f(drop_p)
        "encoder_fwd": lambda src, obs, p: ch.encoder_fwd(src, *enc, (4, 2), p, seed),
        "encoder_bwd": lambda src, obs, p: ch.encoder_bwd(src, *enc, g_enc, (4, 2), p, seed),
        "ae_loss_fwd": lambda src, obs, p: ch.ae_loss_fwd(src, *ps, obs, (2, 2), p, seed),
        "ae_loss_bwd": lambda src, obs, p: ch.ae_loss_bwd(src, *ps, obs, gbar, (2, 2), p, seed),
        "decoder_loss_fwd": lambda src, obs, p: cs.decoder_loss_fwd(emb[64], *ps[4:], obs, p,
                                                                   seed),
        "decoder_loss_bwd": lambda src, obs, p: cs.decoder_loss_bwd(emb[64], *ps[4:], obs, gbar,
                                                                   p, seed),
        "head_fwd": lambda src, obs, p: cs.head_fwd(src, ps[0], ps[1], 2, p, seed),
        "head_bwd": lambda src, obs, p: cs.head_bwd(src, ps[0], ps[1], g_head, 2, p, seed),
        "loss_tail_fwd": lambda src, obs, p: cs.loss_tail_fwd(mid[64], ps[6], ps[7], obs,
                                                             "sigmoid", p, seed),
        "loss_tail_bwd": lambda src, obs, p: cs.loss_tail_bwd(mid[64], ps[6], ps[7], obs, gbar,
                                                             "sigmoid", p, seed),
    }
    checked = []
    for name, fn in cases.items():
        for p in (0.0, DROP_P):
            want = fn(x8[64], o8[64], p)
            pairs = [(x32[64], o32[64])]
            if name.startswith("ae_loss"):   # src and obs each on its own
                pairs += [(x32[64], o8[64]), (x8[64], o32[64])]
            for src, obs in pairs:
                check(_same_bits(fn(src, obs, p), want),
                      f"{name} (drop {p}) on packed words differs from it on uint8 cells")
            checked.append(f"{name} drop {p}")
    # times on the words, at each uint8 row's shapes
    timed = {
        "encoder_fwd": lambda: ch.encoder_fwd(x32[160], *enc, (4, 2)),
        "ae_loss_fwd": lambda: ch.ae_loss_fwd(x32[160], *ps, x32[160]),
        "encoder_bwd": lambda: ch.encoder_bwd(x32[64], *enc, g_enc, (4, 2), DROP_P, seed),
        "ae_loss_bwd": lambda: ch.ae_loss_bwd(x32[64], *ps, x32[64], gbar, (2, 2), DROP_P, seed),
        "decoder_loss_fwd": lambda: cs.decoder_loss_fwd(emb[160], *ps[4:], o32[160]),
        "decoder_loss_bwd": lambda: cs.decoder_loss_bwd(emb[64], *ps[4:], o32[64], gbar,
                                                        DROP_P, seed),
        "head_fwd": lambda: cs.head_fwd(x32[160], ps[0], ps[1], 2),
        "loss_tail_fwd": lambda: cs.loss_tail_fwd(mid[160], ps[6], ps[7], o32[160], "sigmoid"),
    }
    for name, fn in timed.items():
        results[name]["ms_u32"] = timer.ms(fn, 10)
    log(f"packed-word inputs ok, bit-equal to uint8 cells: {checked}; times (ms) "
        f"{json.dumps({k: results[k]['ms_u32'] for k in timed})}")


def phase_engines(torch, cuda_build):
    """The engines' path: each of the five packed and uint8 engines once at
    bench.py's geometry through its public function, as bench.py's backends
    run it, and the live-cell sum each leaves: bench.py's checksum, which
    every engine and the plain twin must share."""
    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_ca

    grid = _bench_grid(torch)
    rm, cm = bitpack.pack_grid(grid), bitpack.pack_grid_cm(grid)
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device="cuda")
    steps = BENCH_STEPS
    twin = int(bitpack.popcount(cuda_bitpack.bit_multi_step_plain(rm, life, steps)).sum())
    cuda_build.reset_launch_counts()
    runs = {
        "bit_multi_step": lambda: bitpack.popcount(
            cuda_bitpack.bit_multi_step(rm, life, steps)).sum(),
        "bit_multi_step_static": lambda: bitpack.popcount(
            cuda_bitpack.bit_multi_step_static(rm, [3], [2, 3], steps)).sum(),
        "bit_multi_step_static_cm": lambda: bitpack.popcount(
            cuda_bitpack.bit_multi_step_static_cm(cm, [3], [2, 3], steps)).sum(),
        "bit_multi_step_cm": lambda: bitpack.popcount(
            cuda_bitpack.bit_multi_step_cm(cm, life, steps)).sum(),
        "ca_multi_step": lambda: cuda_ca.ca_multi_step(grid, life, steps).sum(dtype=torch.int64),
    }
    sums, wall = {}, {}
    for name, fn in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums[name] = int(fn())
        wall[name] = time.perf_counter() - t0
    counts = cuda_build.launch_counts()
    check(set(sums.values()) == {twin},
          f"the engines disagree on the checksum: {sums}, plain twin {twin}")
    updates = BENCH_UNIVERSES * BENCH_SIZE * BENCH_SIZE * steps
    out = {"checksum": twin, "universes": BENCH_UNIVERSES, "size": BENCH_SIZE,
           "generations": steps, "wall_s": wall,
           "cell_updates_per_s": {k: updates / v for k, v in wall.items()}}
    log(f"engines checksum {twin}: all five engines and the plain twin agree")
    log(f"engines ok: {json.dumps(out)}")
    log(f"engines launches: {json.dumps(counts)}")
    return counts, out


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


def _bits_twice(fn, what):
    """fn() twice: the same bits, returned once."""
    first, again = fn(), fn()
    check(all(bool((a == b).all()) for a, b in zip(first, again) if a is not None),
          f"{what} is not the same bit for bit from run to run")
    return first


def phase_stage_kernels(torch, timer, gen):
    """The single-stage kernels and the decoder loss vs their twins at the
    autoencoder's shapes (256 x 256 universes, channels 1 -> 4 -> 2 -> 1 -> 1):
    forwards on 160 universes, backwards on 64, without and with dropout 0.1;
    the head also at RND's pool 4; ae_loss with a source that is not the
    target."""
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.ops import cuda_head, cuda_stages

    dev = torch.device("cuda")
    nf, nb, h, w, seed = 160, 64, 256, 256, 20240301
    hw = h * w
    ae = init_ae_params(gen, dev)
    (w1, b1), (w2, b2), (wt1, bt1), (wt2, bt2) = (
        (ae[k]["w"], ae[k]["b"]) for k in ("conv1", "conv2", "deconv1", "deconv2"))
    cells = (torch.rand((nf, 1, h, w), generator=gen, device=dev) < 0.3).to(torch.uint8)
    cells[: nf // 4, :, : h // 2] = 0   # blank regions: whole pool windows tie
    obs = (torch.rand((nf, 1, h, w), generator=gen, device=dev) < 0.3).to(torch.uint8)
    # the activations the stages see, from the kernels themselves
    x1 = cuda_stages.head_fwd(cells, w1, b1, 2)                  # [N, 4, 128, 128]
    emb = cuda_stages.head_fwd(x1, w2, b2, 2, stage=1)          # [N, 2, 64, 64]
    mid = cuda_stages.tail_fwd(emb, wt1, bt1, "relu", stage=2)  # [N, 1, 128, 128]
    gbar = torch.randn((nb,), generator=gen, device=dev) / (nb * hw)
    results, tol = {}, 1e-4
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)

    def close(got, want, what, rtol=1e-4, atol=1e-4):
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
        return float((got - want).abs().max())

    def backward_case(name, fn, plain, label):
        """Kernel vs twin without and with dropout, each twice for the bits;
        returns (worst leaf error with dropout, without, largest abs error)."""
        worst = {}
        for p in (0.0, DROP_P):
            got = [t for t in _bits_twice(lambda: fn(p), f"{name} ({label})") if t is not None]
            want = [t for t in plain(p) if t is not None]
            worst[p] = max(_leaf_errors(got, want))
            check(worst[p] < tol, f"{name} ({label}, drop {p}) leaves differ: {worst[p]}")
            abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        return worst[DROP_P], worst[0.0], abs_err

    # -- head_fwd: AE conv1 on cells, AE conv2 on floats, RND's pool 4 ---------
    head_cases = {  # label: (x, w, b, pool, stage)
        "AE conv1, u8 [160,1,256,256] -> [160,4,128,128], pool 2": (cells, w1, b1, 2, 0),
        "AE conv2, f32 [160,4,128,128] -> [160,2,64,64], pool 2": (x1, w2, b2, 2, 1),
        "RND conv1, u8 [160,1,256,256] -> [160,4,64,64], pool 4": (cells, w1, b1, 4, 0),
    }
    detail, err = {}, 0.0
    for label, (x, wt, b, pool, stage) in head_cases.items():
        err = max(err, close(cuda_stages.head_fwd(x, wt, b, pool, 0.0, 0, stage),
                             cuda_stages.head_fwd_plain(x, wt, b, pool, 0.0, 0, stage), label))
        xb = x[:nb].contiguous()
        close(cuda_stages.head_fwd(xb, wt, b, pool, DROP_P, seed, stage),
              cuda_stages.head_fwd_plain(xb, wt, b, pool, DROP_P, seed, stage),
              label + ", dropout")
        detail[label] = {"ms": timer.ms(
            lambda: cuda_stages.head_fwd(x, wt, b, pool, 0.0, 0, stage), 20)}
    label = next(iter(head_cases))
    flops = 2 * 9 * 1 * 4 * nf * hw
    bound, by = bound_ms(nf * hw + nf * 4 * hw // 4 * 4 + 40 * 4, flops, FP32_FLOPS)
    results["head_fwd"] = dict(
        max_abs_err=err, ms=detail[label]["ms"],
        plain_ms=timer.ms(lambda: cuda_stages.head_fwd_plain(cells, w1, b1, 2), 5),
        bound_ms=bound, bound_by=by, library_ms=None, shape=label, cases=detail)
    log(f"head_fwd ok: {results['head_fwd']}")

    # -- head_bwd: the same three, the second with its input cotangent ---------
    detail = {}
    for label, (x, wt, b, pool, stage) in head_cases.items():
        xb = x[:nb].contiguous()
        need_dx = xb.dtype == torch.float32
        g = rand(nb, wt.shape[0], x.shape[2] // pool, x.shape[3] // pool)
        args = (xb, wt, b, g, pool)
        e_drop, e_plain, abs_err = backward_case(
            "head_bwd", lambda p: cuda_stages.head_bwd(*args, p, seed, stage, need_dx),
            lambda p: cuda_stages.head_bwd_plain(*args, p, seed, stage, need_dx), label)
        detail[label] = {
            "need_dx": need_dx, "max_leaf_rel_err": e_drop, "max_leaf_rel_err_no_drop": e_plain,
            "max_abs_err": abs_err,
            "ms": timer.ms(lambda: cuda_stages.head_bwd(*args, DROP_P, seed, stage, need_dx), 10),
            "ms_no_drop": timer.ms(lambda: cuda_stages.head_bwd(*args, 0.0, 0, stage, need_dx), 10)}
        if label.startswith("AE conv1"):
            plain_ms = timer.ms(lambda: cuda_stages.head_bwd_plain(*args, DROP_P, seed, stage,
                                                                   need_dx), 2)
    label = next(iter(head_cases))
    first = detail[label]
    flops = 2 * (2 * 9 * 1 * 4 * nb * hw)   # one recompute and dW; the cells take no cotangent
    bound, by = bound_ms(nb * hw + nb * 4 * hw // 4 * 4 + 80 * 4, flops, FP32_FLOPS)
    results["head_bwd"] = dict(
        max_abs_err=first["max_abs_err"], max_leaf_rel_err=first["max_leaf_rel_err"],
        ms=first["ms"], ms_no_drop=first["ms_no_drop"], plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None,
        shape=label.replace("160", "64") + ", g [64,4,128,128], drop 0.1", cases=detail)
    log(f"head_bwd ok: {results['head_bwd']}")

    # -- tail and loss tail ------------------------------------------------------
    tail_cases = {  # label: (x, wt, b, act, stage)
        "AE deconv2, f32 [160,1,128,128] -> [160,1,256,256], sigmoid": (mid, wt2, bt2, "sigmoid", 3),
        "AE deconv1, f32 [160,2,64,64] -> [160,1,128,128], relu": (emb, wt1, bt1, "relu", 2),
    }
    fwd_detail, bwd_detail, err = {}, {}, 0.0
    for label, (x, wt, b, act, stage) in tail_cases.items():
        err = max(err, close(cuda_stages.tail_fwd(x, wt, b, act, 0.0, 0, stage),
                             cuda_stages.tail_fwd_plain(x, wt, b, act, 0.0, 0, stage), label))
        xb = x[:nb].contiguous()
        close(cuda_stages.tail_fwd(xb, wt, b, act, DROP_P, seed, stage),
              cuda_stages.tail_fwd_plain(xb, wt, b, act, DROP_P, seed, stage), label + ", dropout")
        fwd_detail[label] = {"ms": timer.ms(
            lambda: cuda_stages.tail_fwd(x, wt, b, act, 0.0, 0, stage), 20)}
        g = rand(nb, wt.shape[1], 2 * x.shape[2], 2 * x.shape[3])
        args = (xb, wt, b, g, act)
        e_drop, e_plain, abs_err = backward_case(
            "tail_bwd", lambda p: cuda_stages.tail_bwd(*args, p, seed, stage),
            lambda p: cuda_stages.tail_bwd_plain(*args, p, seed, stage), label)
        bwd_detail[label] = {
            "max_leaf_rel_err": e_drop, "max_leaf_rel_err_no_drop": e_plain,
            "max_abs_err": abs_err,
            "ms": timer.ms(lambda: cuda_stages.tail_bwd(*args, DROP_P, seed, stage), 10),
            "ms_no_drop": timer.ms(lambda: cuda_stages.tail_bwd(*args, 0.0, 0, stage), 10)}
        if act == "sigmoid":
            plain_fwd = timer.ms(lambda: cuda_stages.tail_fwd_plain(x, wt, b, act, 0.0, 0, stage), 5)
            plain_bwd = timer.ms(lambda: cuda_stages.tail_bwd_plain(*args, DROP_P, seed, stage), 2)
    label = next(iter(tail_cases))
    taps = 2 * 4 * 1 * 1   # flops an output position: 2 x 2 inputs a channel pair
    bound, by = bound_ms(nf * (hw // 4 + hw) * 4 + 17 * 4, taps * nf * hw, FP32_FLOPS)
    results["tail_fwd"] = dict(max_abs_err=err, ms=fwd_detail[label]["ms"], plain_ms=plain_fwd,
                               bound_ms=bound, bound_by=by, library_ms=None, shape=label,
                               cases=fwd_detail)
    log(f"tail_fwd ok: {results['tail_fwd']}")
    first = bwd_detail[label]
    bound, by = bound_ms(nb * (hw // 4 + hw + hw // 4) * 4 + 34 * 4, 3 * taps * nb * hw + 4 * nb * hw,
                         FP32_FLOPS)
    results["tail_bwd"] = dict(
        max_abs_err=first["max_abs_err"], max_leaf_rel_err=first["max_leaf_rel_err"],
        ms=first["ms"], ms_no_drop=first["ms_no_drop"], plain_ms=plain_bwd, bound_ms=bound,
        bound_by=by, library_ms=None,
        shape="f32 x [64,1,128,128], g [64,1,256,256], sigmoid, drop 0.1", cases=bwd_detail)
    log(f"tail_bwd ok: {results['tail_bwd']}")

    obs_f = obs.to(torch.float32)
    lt_args = (mid, wt2, bt2)
    got = cuda_stages.loss_tail_fwd(*lt_args, obs)
    check(torch.equal(got, cuda_stages.loss_tail_fwd(*lt_args, obs)),
          "loss_tail_fwd is not deterministic")
    want = cuda_stages.loss_tail_fwd_plain(*lt_args, obs)
    close(got, want, "loss_tail_fwd", atol=1e-3)
    close(cuda_stages.loss_tail_fwd(*lt_args, obs_f), want, "loss_tail_fwd, f32 obs", atol=1e-3)
    mb, ob = mid[:nb].contiguous(), obs[:nb].contiguous()
    close(cuda_stages.loss_tail_fwd(mb, wt2, bt2, ob, "sigmoid", DROP_P, seed),
          cuda_stages.loss_tail_fwd_plain(mb, wt2, bt2, ob, "sigmoid", DROP_P, seed),
          "loss_tail_fwd, dropout", atol=1e-3)
    bound, by = bound_ms(nf * (hw // 4 * 4 + hw) + nf * 4, (taps + 3) * nf * hw, FP32_FLOPS)
    results["loss_tail_fwd"] = dict(
        max_abs_err=float((got - want).abs().max()),
        max_rel_err=float(((got - want).abs() / want.abs()).max()),
        ms=timer.ms(lambda: cuda_stages.loss_tail_fwd(*lt_args, obs), 20),
        ms_f32_obs=timer.ms(lambda: cuda_stages.loss_tail_fwd(*lt_args, obs_f), 20),
        plain_ms=timer.ms(lambda: cuda_stages.loss_tail_fwd_plain(*lt_args, obs), 5),
        bound_ms=bound, bound_by=by, library_ms=None,
        shape="f32 x [160,1,128,128], u8 obs [160,1,256,256], sigmoid")
    log(f"loss_tail_fwd ok: {results['loss_tail_fwd']}")
    e_drop, e_plain, abs_err = backward_case(
        "loss_tail_bwd",
        lambda p: cuda_stages.loss_tail_bwd(mb, wt2, bt2, ob, gbar, "sigmoid", p, seed),
        lambda p: cuda_stages.loss_tail_bwd_plain(mb, wt2, bt2, ob, gbar, "sigmoid", p, seed),
        "AE deconv2")
    backward_case(
        "loss_tail_bwd",
        lambda p: cuda_stages.loss_tail_bwd(mb, wt2, bt2, ob.float(), gbar, "sigmoid", p, seed),
        lambda p: cuda_stages.loss_tail_bwd_plain(mb, wt2, bt2, ob, gbar, "sigmoid", p, seed),
        "AE deconv2, f32 obs")
    bound, by = bound_ms(nb * (hw // 4 * 4 + hw + hw // 4 * 4) + nb * 4 + 34 * 4,
                         3 * taps * nb * hw + 8 * nb * hw, FP32_FLOPS)
    results["loss_tail_bwd"] = dict(
        max_abs_err=abs_err, max_leaf_rel_err=e_drop, max_leaf_rel_err_no_drop=e_plain,
        ms=timer.ms(lambda: cuda_stages.loss_tail_bwd(mb, wt2, bt2, ob, gbar, "sigmoid",
                                                      DROP_P, seed), 10),
        ms_no_drop=timer.ms(lambda: cuda_stages.loss_tail_bwd(mb, wt2, bt2, ob, gbar), 10),
        plain_ms=timer.ms(lambda: cuda_stages.loss_tail_bwd_plain(
            mb, wt2, bt2, ob, gbar, "sigmoid", DROP_P, seed), 2),
        bound_ms=bound, bound_by=by, library_ms=None,
        shape="f32 x [64,1,128,128], u8 obs [64,1,256,256], gbar [64], sigmoid, drop 0.1")
    log(f"loss_tail_bwd ok: {results['loss_tail_bwd']}")

    # -- decoder loss ------------------------------------------------------------
    dl_args = (emb, wt1, bt1, wt2, bt2)
    got = cuda_stages.decoder_loss_fwd(*dl_args, obs)
    check(torch.equal(got, cuda_stages.decoder_loss_fwd(*dl_args, obs)),
          "decoder_loss_fwd is not deterministic")
    want = cuda_stages.decoder_loss_fwd_plain(*dl_args, obs)
    close(got, want, "decoder_loss_fwd", atol=1e-3)
    close(cuda_stages.decoder_loss_fwd(*dl_args, obs_f), want, "decoder_loss_fwd, f32 obs",
          atol=1e-3)
    eb = emb[:nb].contiguous()
    db_args = (eb, wt1, bt1, wt2, bt2, ob)
    close(cuda_stages.decoder_loss_fwd(*db_args, DROP_P, seed),
          cuda_stages.decoder_loss_fwd_plain(*db_args, DROP_P, seed),
          "decoder_loss_fwd, dropout", atol=1e-3)
    d1, d2 = 4 * 2 * 1 * (hw // 4), 4 * 1 * 1 * hw   # multiply-adds a universe, each stage
    bound, by = bound_ms(nf * (2 * hw // 16 * 4 + hw) + nf * 4,
                         2 * nf * (d1 + d2) + 3 * nf * hw, FP32_FLOPS)
    results["decoder_loss_fwd"] = dict(
        max_abs_err=float((got - want).abs().max()),
        max_rel_err=float(((got - want).abs() / want.abs()).max()),
        ms=timer.ms(lambda: cuda_stages.decoder_loss_fwd(*dl_args, obs), 20),
        plain_ms=timer.ms(lambda: cuda_stages.decoder_loss_fwd_plain(*dl_args, obs), 5),
        bound_ms=bound, bound_by=by, library_ms=None,
        shape="f32 x [160,2,64,64], u8 obs [160,1,256,256], AE2D decoder (2, 1, 1)")
    log(f"decoder_loss_fwd ok: {results['decoder_loss_fwd']}")
    e_drop, e_plain, abs_err = backward_case(
        "decoder_loss_bwd", lambda p: cuda_stages.decoder_loss_bwd(*db_args, gbar, p, seed),
        lambda p: cuda_stages.decoder_loss_bwd_plain(*db_args, gbar, p, seed), "AE2D decoder")
    bound, by = bound_ms(nb * (2 * hw // 16 * 4 * 2 + hw) + nb * 4 + 52 * 4,
                         2 * nb * 3 * (d1 + d2) + 8 * nb * hw, FP32_FLOPS)
    results["decoder_loss_bwd"] = dict(
        max_abs_err=abs_err, max_leaf_rel_err=e_drop, max_leaf_rel_err_no_drop=e_plain,
        ms=timer.ms(lambda: cuda_stages.decoder_loss_bwd(*db_args, gbar, DROP_P, seed), 10),
        ms_no_drop=timer.ms(lambda: cuda_stages.decoder_loss_bwd(*db_args, gbar), 10),
        plain_ms=timer.ms(lambda: cuda_stages.decoder_loss_bwd_plain(*db_args, gbar, DROP_P,
                                                                      seed), 2),
        bound_ms=bound, bound_by=by, library_ms=None,
        shape="f32 x [64,2,64,64], u8 obs [64,1,256,256], gbar [64], drop 0.1")
    log(f"decoder_loss_bwd ok: {results['decoder_loss_bwd']}")

    # -- the whole-autoencoder kernels with a source that is not the target ------
    flat = (w1, b1, w2, b2, wt1, bt1, wt2, bt2)
    sb = cells[:nb].contiguous()
    got = cuda_head.ae_loss_fwd(cells, *flat, obs)
    want = cuda_head.ae_loss_fwd_plain(cells, *flat, obs)
    close(got, want, "ae_loss_fwd, src != obs", atol=1e-3)
    check(not torch.equal(got, cuda_head.ae_loss_fwd(cells, *flat, cells)),
          "ae_loss_fwd ignores its target")
    e_drop, e_plain, _ = backward_case(
        "ae_loss_bwd", lambda p: cuda_head.ae_loss_bwd(sb, *flat, ob, gbar, (2, 2), p, seed),
        lambda p: cuda_head.ae_loss_bwd_plain(sb, *flat, ob, gbar, (2, 2), p, seed),
        "src != obs")
    results["ae_loss_src_not_obs"] = dict(
        fwd_max_rel_err=float(((got - want).abs() / want.abs()).max()),
        bwd_max_leaf_rel_err=e_drop, bwd_max_leaf_rel_err_no_drop=e_plain,
        fwd_ms=timer.ms(lambda: cuda_head.ae_loss_fwd(cells, *flat, obs), 20),
        bwd_ms=timer.ms(lambda: cuda_head.ae_loss_bwd(sb, *flat, ob, gbar, (2, 2), DROP_P,
                                                      seed), 10),
        shape="fwd u8 src, obs [160,1,256,256]; bwd [64,...], gbar [64], drop 0.1")
    log(f"ae_loss with src != obs ok: {results['ae_loss_src_not_obs']}")
    return results


def _tile_plans(h, w):
    """The (band, tile, shared memory) plans the encoder and decoder-loss
    kernels take at [h, w] (RND predictor, AE encoder, AE2D decoder)."""
    from carle_tpu_torch.ops import cuda_head, cuda_stages

    return {"rnd_encoder_fwd": cuda_head._encoder_fwd_plan(h, w, 4, 1, 4, 2),
            "rnd_encoder_bwd": cuda_head._encoder_bwd_bands(h, w, 4, 1, 4, 2),
            "ae_encoder_fwd": cuda_head._encoder_fwd_plan(h, w, 4, 2, 2, 2),
            "ae_encoder_bwd": cuda_head._encoder_bwd_bands(h, w, 4, 2, 2, 2),
            "decoder_fwd_bwd": cuda_stages._decoder_bands(h, w, 2, 1, 1)}


def _encoder_bound(n, h, w, c1, c2, p1, p2, cell_bytes, backward):
    """(bound ms, what bounds it) of an encoder launch: cells read once, the
    output (or its cotangent and the gradients) once, 2 flops a
    multiply-add (the backward: recompute, dW1, dW2 and the stage-1
    cotangent)."""
    s1 = n * h * w * c1 * 9
    s2 = n * (h // p1) * (w // p1) * c2 * c1 * 9
    out = n * c2 * (h // (p1 * p2)) * (w // (p1 * p2)) * 4
    mask = n * (h // p1) * 4
    flops = 2 * ((s1 + s2) + s1 + 2 * s2) if backward else 2 * (s1 + s2)
    return bound_ms(n * h * w * cell_bytes + out + mask, flops, FP32_FLOPS)


def _decoder_bound(n, h, w, obs_bytes, backward):
    """The same for an AE2D decoder-loss launch ([n, 2, h/4, w/4] -> [n, 1,
    h, w]) with row weights."""
    hw = h * w
    d1, d2 = 4 * 2 * 1 * (hw // 4), 4 * 1 * 1 * hw
    emb = 2 * hw // 16 * 4
    if backward:
        return bound_ms(n * (2 * emb + hw * obs_bytes + h * 4) + n * 4 + 52 * 4,
                        2 * n * 3 * (d1 + d2) + 8 * n * hw, FP32_FLOPS)
    return bound_ms(n * (emb + hw * obs_bytes + h * 4) + n * 4,
                    2 * n * (d1 + d2) + 3 * n * hw, FP32_FLOPS)


def phase_band_kernels(torch, timer, gen):
    """Row 3's mask and row 6's row weights at the band shapes of the 8192²
    slice, against their twins; the width repair (the global encoders and
    decoder loss at 8192²); the size repair (conv_ae_loss on 4 x 2048² equals
    encoder + decoder loss bit for bit); column tiles forced at 256² against
    one tile; more than 65,535 instances a launch."""
    from carle_tpu_torch import EnvConfig, nets
    from carle_tpu_torch.mcl._online import tree_leaves, tree_unflatten
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.mcl.rnd import init_predictor_params, init_random_network_params
    from carle_tpu_torch.ops import bitpack, cuda_head, cuda_stages
    from carle_tpu_torch.parallel import band_heads as bh

    dev = torch.device("cuda")
    size, seed, tol = BAND_SIZE, 31415, 1e-4
    # the encoder's gradients at 8192² sum over 134 million stage-1 positions
    # (33 times the 256² checks'): a pool window whose maxima tie in the
    # kernel's summation order and differ in the last bit in cuDNN's sends its
    # share elsewhere, and the moved shares reach ~1e-3 of a leaf (9.4e-4 on
    # this phase's draw)
    tol_ties = 2e-3
    results, report = {}, {}
    universe = (torch.rand((1, 1, size, size), generator=gen, device=dev) < 0.2).to(torch.uint8)
    words = bitpack.pack_grid(universe)
    rnd = init_predictor_params(EnvConfig(), gen, dev)
    target = init_random_network_params(EnvConfig(), gen, dev)
    ae = init_ae_params(gen, dev)
    conv = lambda p: (p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"])
    dec = (ae["deconv1"]["w"], ae["deconv1"]["b"], ae["deconv2"]["w"], ae["deconv2"]["b"])
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))

    # -- row 3's mask: the RND predictor on 512 bands of 32 x 8192 -------------
    xb = bh._band_input(universe, RND_BANDS, 8)
    xw = bh._band_input(words, RND_BANDS, 8)
    mask = bh.encoder_mask(size, RND_BANDS, (4, 2), 1, dev)
    ones = torch.ones_like(mask)
    g = torch.randn((RND_BANDS, 1, 4, size // 8), generator=gen, device=dev)
    w4 = conv(rnd)
    fwd_err, leaf_err = 0.0, 0.0
    for p in (0.0, DROP_P):
        got = cuda_head.encoder_fwd(xb, *w4, (4, 2), p, seed, mask)
        want = cuda_head.encoder_fwd_plain(xb, *w4, (4, 2), p, seed, mask)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        fwd_err = max(fwd_err, float((got - want).abs().max()))
        check(torch.equal(cuda_head.encoder_fwd(xw, *w4, (4, 2), p, seed, mask), got),
              "masked encoder_fwd on packed words differs from uint8 cells")
        check(torch.equal(cuda_head.encoder_fwd(xb, *w4, (4, 2), p, seed, ones),
                          cuda_head.encoder_fwd(xb, *w4, (4, 2), p, seed)),
              "encoder_fwd with a mask of ones is not the unmasked kernel")
        grads = _bits_twice(lambda: cuda_head.encoder_bwd(xb, *w4, g, (4, 2), p, seed, mask),
                            "masked encoder_bwd")
        errs = _leaf_errors(grads, cuda_head.encoder_bwd_plain(xb, *w4, g, (4, 2), p, seed,
                                                               mask))
        check(max(errs) < tol_ties, f"masked encoder_bwd (drop {p}) leaves differ: {errs}")
        leaf_err = max(leaf_err, max(errs))
        check(same(cuda_head.encoder_bwd(xw, *w4, g, (4, 2), p, seed, mask), grads),
              "masked encoder_bwd on packed words differs from uint8 cells")
        check(same(cuda_head.encoder_bwd(xb, *w4, g, (4, 2), p, seed, ones),
                   cuda_head.encoder_bwd(xb, *w4, g, (4, 2), p, seed)),
              "encoder_bwd with a mask of ones is not the unmasked kernel")
    n, h, w = RND_BANDS, 32, size
    b, by = _encoder_bound(n, h, w, 4, 1, 4, 2, 1 / 8, False)
    results["encoder_fwd_mask"] = dict(
        max_abs_err=fwd_err,
        ms=timer.ms(lambda: cuda_head.encoder_fwd(xw, *w4, (4, 2), DROP_P, seed, mask), 10),
        ms_u8=timer.ms(lambda: cuda_head.encoder_fwd(xb, *w4, (4, 2), DROP_P, seed, mask), 10),
        plain_ms=timer.ms(lambda: cuda_head.encoder_fwd_plain(xw, *w4, (4, 2), DROP_P, seed,
                                                              mask), 2),
        bound_ms=b, bound_by=by, library_ms=None,
        plan=cuda_head._encoder_fwd_plan(h, w, 4, 1, 4, 2),
        shape=f"u32 [{n},1,32,{size // 32}] (RND bands of {size}²), mask [{n},8], drop 0.1")
    log(f"encoder_fwd_mask ok: {results['encoder_fwd_mask']}")
    b, by = _encoder_bound(n, h, w, 4, 1, 4, 2, 1 / 8, True)
    results["encoder_bwd_mask"] = dict(
        max_abs_err=leaf_err, max_leaf_rel_err=leaf_err,
        ms=timer.ms(lambda: cuda_head.encoder_bwd(xw, *w4, g, (4, 2), DROP_P, seed, mask), 5),
        plain_ms=timer.ms(lambda: cuda_head.encoder_bwd_plain(xw, *w4, g, (4, 2), DROP_P, seed,
                                                              mask), 1),
        bound_ms=b, bound_by=by, library_ms=None,
        plan=cuda_head._encoder_bwd_bands(h, w, 4, 1, 4, 2),
        shape=f"u32 [{n},1,32,{size // 32}], g [{n},1,4,{size // 8}], mask, drop 0.1")
    log(f"encoder_bwd_mask ok: {results['encoder_bwd_mask']}")
    del xb, xw, g

    # -- row 6: the AE2D decoder loss on 128 bands (Prediction's geometry) ------
    emb = cuda_head.encoder_fwd(universe, *conv(ae), (2, 2))          # [1, 2, 2048, 2048]
    starts, win = bh.decoder_windows(size // 4, PRED_BANDS)
    eb = bh._rows(emb, starts, win)                                      # [128, 2, 20, 2048]
    ob8 = bh._rows(universe, [4 * s for s in starts], 4 * win)           # [128, 1, 80, 8192]
    ob32 = bh._rows(words, [4 * s for s in starts], 4 * win)
    em = bh.decoder_row_weights(size // 4, PRED_BANDS, 1, dev)
    em_ones = torch.ones_like(em)
    gbar = torch.randn((PRED_BANDS,), generator=gen, device=dev) / (size * size)
    fwd_err, leaf_err = 0.0, 0.0
    for p in (0.0, DROP_P):
        got = cuda_stages.decoder_loss_fwd(eb, *dec, ob8, p, seed, em)
        want = cuda_stages.decoder_loss_fwd_plain(eb, *dec, ob8, p, seed, em)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        fwd_err = max(fwd_err, float(((got - want).abs() / want.abs()).max()))
        check(torch.equal(cuda_stages.decoder_loss_fwd(eb, *dec, ob32, p, seed, em), got),
              "row-weighted decoder_loss_fwd on packed obs differs from uint8")
        check(torch.equal(cuda_stages.decoder_loss_fwd(eb, *dec, ob8, p, seed, em_ones),
                          cuda_stages.decoder_loss_fwd(eb, *dec, ob8, p, seed)),
              "decoder_loss_fwd with em of ones is not the unweighted kernel")
        grads = _bits_twice(
            lambda: cuda_stages.decoder_loss_bwd(eb, *dec, ob8, gbar, p, seed, em),
            "row-weighted decoder_loss_bwd")
        errs = _leaf_errors(grads, cuda_stages.decoder_loss_bwd_plain(eb, *dec, ob8, gbar, p,
                                                                      seed, em))
        check(max(errs) < tol, f"row-weighted decoder_loss_bwd (drop {p}) leaves differ: {errs}")
        leaf_err = max(leaf_err, max(errs))
        check(same(cuda_stages.decoder_loss_bwd(eb, *dec, ob32, gbar, p, seed, em), grads),
              "row-weighted decoder_loss_bwd on packed obs differs from uint8")
        check(same(cuda_stages.decoder_loss_bwd(eb, *dec, ob8, gbar, p, seed, em_ones),
                   cuda_stages.decoder_loss_bwd(eb, *dec, ob8, gbar, p, seed)),
              "decoder_loss_bwd with em of ones is not the unweighted kernel")
    n, h, w = PRED_BANDS, 4 * win, size
    b, by = _decoder_bound(n, h, w, 1 / 8, False)
    results["decoder_loss_fwd_em"] = dict(
        max_abs_err=fwd_err, max_rel_err=fwd_err,
        ms=timer.ms(lambda: cuda_stages.decoder_loss_fwd(eb, *dec, ob32, DROP_P, seed, em), 10),
        plain_ms=timer.ms(lambda: cuda_stages.decoder_loss_fwd_plain(eb, *dec, ob32, DROP_P,
                                                                     seed, em), 2),
        bound_ms=b, bound_by=by, library_ms=None,
        plan=cuda_stages._decoder_bands(h, w, 2, 1, 1)[0],
        shape=f"f32 x [{n},2,{win},{size // 4}], u32 obs [{n},1,{4 * win},{size // 32}], "
              f"em [{n},{4 * win}], drop 0.1")
    log(f"decoder_loss_fwd_em ok: {results['decoder_loss_fwd_em']}")
    b, by = _decoder_bound(n, h, w, 1 / 8, True)
    results["decoder_loss_bwd_em"] = dict(
        max_abs_err=leaf_err, max_leaf_rel_err=leaf_err,
        ms=timer.ms(lambda: cuda_stages.decoder_loss_bwd(eb, *dec, ob32, gbar, DROP_P, seed,
                                                         em), 5),
        plain_ms=timer.ms(lambda: cuda_stages.decoder_loss_bwd_plain(eb, *dec, ob32, gbar,
                                                                     DROP_P, seed, em), 1),
        bound_ms=b, bound_by=by, library_ms=None,
        plan=cuda_stages._decoder_bands(h, w, 2, 1, 1)[1],
        shape=f"f32 x [{n},2,{win},{size // 4}], u32 obs, gbar [{n}], em, drop 0.1")
    log(f"decoder_loss_bwd_em ok: {results['decoder_loss_bwd_em']}")
    del eb, ob8, ob32

    # -- the width repair: the global kernels on one universe of 8192² ---------
    width = {"plans": _tile_plans(size, size)}
    for name, params, pools in (("rnd_predictor", rnd, (4, 2)), ("rnd_target", target, (4, 2)),
                                ("ae_encoder", ae, (2, 2))):
        w4 = conv(params)
        got = cuda_head.encoder_fwd(universe, *w4, pools, DROP_P, seed)
        torch.testing.assert_close(got, cuda_head.encoder_fwd_plain(universe, *w4, pools,
                                                                    DROP_P, seed),
                                   rtol=1e-4, atol=1e-4)
        check(torch.equal(cuda_head.encoder_fwd(words, *w4, pools, DROP_P, seed), got),
              f"{name} at {size}² on packed words differs from uint8 cells")
        gg = torch.randn(got.shape, generator=gen, device=dev)
        errs = _leaf_errors(cuda_head.encoder_bwd(universe, *w4, gg, pools, DROP_P, seed),
                            cuda_head.encoder_bwd_plain(universe, *w4, gg, pools, DROP_P, seed))
        check(max(errs) < tol_ties, f"{name} encoder_bwd at {size}² leaves differ: {errs}")
        width[name] = dict(
            fwd_ms=timer.ms(lambda: cuda_head.encoder_fwd(words, *w4, pools, DROP_P, seed), 10),
            bwd_ms=timer.ms(lambda: cuda_head.encoder_bwd(words, *w4, gg, pools, DROP_P, seed),
                            5),
            bwd_max_leaf_rel_err=max(errs))
    gb1 = gbar[:1].contiguous()
    got = cuda_stages.decoder_loss_fwd(emb, *dec, universe, DROP_P, seed)
    torch.testing.assert_close(got, cuda_stages.decoder_loss_fwd_plain(emb, *dec, universe,
                                                                       DROP_P, seed),
                               rtol=1e-4, atol=0)
    errs = _leaf_errors(cuda_stages.decoder_loss_bwd(emb, *dec, universe, gb1, DROP_P, seed),
                        cuda_stages.decoder_loss_bwd_plain(emb, *dec, universe, gb1, DROP_P,
                                                           seed))
    check(max(errs) < tol, f"decoder_loss_bwd at {size}² leaves differ: {errs}")
    width["ae_decoder_loss"] = dict(
        fwd_ms=timer.ms(lambda: cuda_stages.decoder_loss_fwd(emb, *dec, words, DROP_P, seed),
                        10),
        bwd_ms=timer.ms(lambda: cuda_stages.decoder_loss_bwd(emb, *dec, words, gb1, DROP_P,
                                                             seed), 5),
        bwd_max_leaf_rel_err=max(errs))
    report["width_8192"] = width
    log(f"width repair at {size}² ok: {json.dumps(width)}")
    del emb, universe, words
    torch.cuda.empty_cache()

    # -- the size repair: conv_ae_loss past the whole-AE kernel's plans --------
    side = 2048
    src = (torch.rand((4, 1, side, side), generator=gen, device=dev) < 0.2).to(torch.uint8)
    check(not cuda_head.whole_ae_fits(side, side, 4, 2, 1, 1),
          f"{side}² fits the whole-AE kernel: no fallback to hold")

    def ae_route(one_call):
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(ae)]
        p = tree_unflatten(ae, leaves)
        kw = dict(drop_p=DROP_P, train=True, seed=seed)
        if one_call:
            err = nets.conv_ae_loss(src, p["conv1"], p["conv2"], p["deconv1"], p["deconv2"],
                                    src, pools=(2, 2), **kw)
        else:   # ae2d_def(whole_ae=False)'s computation
            x = nets.conv_encoder(src, p["conv1"], p["conv2"], pools=(2, 2), **kw)
            err = nets.conv_decoder_loss(x, p["deconv1"], p["deconv2"], src, **kw)
        return (err.detach(), *torch.autograd.grad(err.sum(), leaves))

    fallback, two = ae_route(True), ae_route(False)
    check(same(fallback, two), f"conv_ae_loss at {side}² is not the two-kernel route bit "
          "for bit (value and 8 gradients)")
    report["size_2048_conv_ae_loss_equals_two_kernels"] = True
    log(f"size repair at 4 x {side}² ok: conv_ae_loss = encoder + decoder loss, bit for bit")
    del src

    # -- column tiles forced at 256² against the one-tile launch ----------------
    n = 64
    x8 = (torch.rand((n, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    x8[: n // 4, :, :, :100] = 0   # blank stretches across tile edges: pool windows tie
    x32 = bitpack.pack_grid(x8)
    w4 = conv(rnd)
    g = torch.randn((n, 1, 32, 32), generator=gen, device=dev)
    e64 = cuda_head.encoder_fwd(x8, *conv(ae), (2, 2))
    gb = torch.randn((n,), generator=gen, device=dev) / (256 * 256)
    calls = {
        "encoder_fwd": lambda x: (cuda_head.encoder_fwd(x, *w4, (4, 2), DROP_P, seed),),
        "encoder_bwd": lambda x: cuda_head.encoder_bwd(x, *w4, g, (4, 2), DROP_P, seed),
        "decoder_loss_fwd": lambda x: (cuda_stages.decoder_loss_fwd(e64, *dec, x, DROP_P,
                                                                    seed),),
        "decoder_loss_bwd": lambda x: cuda_stages.decoder_loss_bwd(e64, *dec, x, gb, DROP_P,
                                                                   seed),
    }
    tiles = {}
    one = {k: fn(x8) for k, fn in calls.items()}
    one_ms = {k: timer.ms(lambda: fn(x32), 10) for k, fn in calls.items()}
    try:
        cuda_head.TILE_CELLS = 48      # six tiles, each edge inside a packed word
        for k, fn in calls.items():
            for x in (x8, x32):
                got = _bits_twice(lambda: fn(x), f"{k} in column tiles")
                worst = max(_leaf_errors(got, one[k]))
                if k == "encoder_fwd":
                    check(same(got, one[k]), "encoder_fwd in column tiles differs from one tile")
                check(worst < 1e-5, f"{k} in column tiles differs from one tile: {worst}")
            tiles[k] = dict(max_leaf_rel_err=worst, ms=timer.ms(lambda: fn(x32), 10),
                            one_tile_ms=one_ms[k])
    finally:
        cuda_head.TILE_CELLS = None
    report["forced_tiles_256"] = tiles
    log(f"column tiles forced at 256² (48 cells a tile) ok: {json.dumps(tiles)}")

    # -- more than 65,535 instances a launch -----------------------------------
    n = 65_600
    xs = (torch.rand((n, 1, 16, 32), generator=gen, device=dev) < 0.3).to(torch.uint8)
    ms = (torch.rand((n, 4), generator=gen, device=dev) < 0.8).to(torch.float32)
    gs = torch.randn((n, 1, 2, 4), generator=gen, device=dev)
    torch.testing.assert_close(cuda_head.encoder_fwd(xs, *w4, (4, 2), DROP_P, seed, ms),
                               cuda_head.encoder_fwd_plain(xs, *w4, (4, 2), DROP_P, seed, ms),
                               rtol=1e-4, atol=1e-4)
    errs = _leaf_errors(cuda_head.encoder_bwd(xs, *w4, gs, (4, 2), DROP_P, seed, ms),
                        cuda_head.encoder_bwd_plain(xs, *w4, gs, (4, 2), DROP_P, seed, ms))
    check(max(errs) < tol, f"encoder_bwd on {n} instances: {errs}")
    es = torch.rand((n, 2, 4, 8), generator=gen, device=dev)
    os_ = xs.expand(n, 1, 16, 32).contiguous()
    ws = torch.rand((n, 16), generator=gen, device=dev)
    gbs = torch.randn((n,), generator=gen, device=dev)
    torch.testing.assert_close(cuda_stages.decoder_loss_fwd(es, *dec, os_, DROP_P, seed, ws),
                               cuda_stages.decoder_loss_fwd_plain(es, *dec, os_, DROP_P, seed,
                                                                  ws), rtol=1e-4, atol=1e-4)
    errs += _leaf_errors(cuda_stages.decoder_loss_bwd(es, *dec, os_, gbs, DROP_P, seed, ws),
                         cuda_stages.decoder_loss_bwd_plain(es, *dec, os_, gbs, DROP_P, seed,
                                                            ws))
    check(max(errs) < tol, f"decoder_loss_bwd on {n} instances: {errs}")
    report["instances_65600_max_leaf_rel_err"] = max(errs)
    log(f"{n} instances a launch ok (encoder and decoder loss, forward and backward)")
    results["bands_kernels"] = report
    return results


def phase_bands(torch, cuda_build):
    """Band tiling's path at full size: RND2D with BandTiling(512) and the
    packed-ring PredictionBonus with BandTiling(128) learning on one packed
    universe of 8192² (run_actions, 64 x 64 actions at p = 0.2, dropout on,
    128 steps: 2 Adam updates each); then each banded stack against the
    unbanded one at 8192² (dropout off, batch_size 4, 16 steps), the banded
    stack on 8 universes of 256² card against CPU, and both legs profiled."""
    import numpy as np

    from carle_tpu_torch import EnvConfig, nets, rules
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.mcl import prediction_def_packed, rnd2d_def
    from carle_tpu_torch.ops import cuda_head
    from carle_tpu_torch.parallel.packed_env import PackedSpatialStack
    from carle_tpu_torch.rollout import Rollout

    size, steps = BAND_SIZE, 128
    cfg = EnvConfig(height=size, width=size, action_height=64, action_width=64, instances=1)
    acts = (np.random.RandomState(1).rand(steps, *cfg.action_shape) < 0.2).astype(np.float32)
    legs = {"rnd2d": lambda c, **kw: rnd2d_def(c, **kw),
            "prediction_packed": lambda c, **kw: prediction_def_packed(c, **kw)}
    tilings = {"rnd2d": nets.BandTiling(RND_BANDS),
               "prediction_packed": nets.BandTiling(PRED_BANDS)}

    def rollout(c, name, fused_head, agent=None, **kw):
        defs = [legs[name](c, fused_head=fused_head, **kw)]
        ro = Rollout(c, defs, agent, device="cuda", stack=PackedSpatialStack(c, defs))
        return ro, ro.init(ro.generator(0), rules.LIFE)

    out = {}
    cuda_build.reset_launch_counts()
    for name in legs:
        ro, carry = rollout(cfg, name, tilings[name], batch_size=64)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        carry, r0 = ro.run_actions(carry, torch.from_numpy(acts[:4]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, r = ro.run_actions(carry, torch.from_numpy(acts[4:]))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (steps - 4)
        state = carry.stack.wrappers[0]
        rewards = torch.cat([r0, r])
        check(bool(torch.isfinite(rewards).all()), f"{name} banded rewards are not finite")
        check(int(state.updates) == 2, f"{name} banded: {int(state.updates)} updates, not 2")
        out[name] = {"bands": tilings[name].bands, "steps": steps, "updates": 2,
                     "step_ms": step_s * 1e3, "cells_per_s": size * size / step_s,
                     "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                     "reward_first": float(rewards[0, 0, 0]),
                     "reward_last": float(rewards[-1, 0, 0])}
        del ro, carry
    counts = cuda_build.launch_counts()
    out["packed_launches"] = cuda_build.packed_launch_counts()
    log(f"bands slice ok: {json.dumps(out)}")
    log(f"bands launches: {json.dumps(counts)}")

    # banded against unbanded at 8192², dropout off, 4 updates
    kw = dict(train=True, dropout=False, batch_size=4)
    a16 = torch.from_numpy(acts[:16])
    for name in legs:
        rewards = []
        for fused_head in (tilings[name], False):
            ro, carry = rollout(cfg, name, fused_head, **kw)
            carry, r = ro.run_actions(carry, a16)
            check(int(carry.stack.wrappers[0].updates) == 4, f"{name} parity updates")
            rewards.append(r.cpu())
            del ro, carry
        torch.testing.assert_close(rewards[0], rewards[1], rtol=1e-4, atol=0)
        out[f"{name}_banded_vs_unbanded_max_rel_diff"] = float(
            ((rewards[0] - rewards[1]).abs() / rewards[1].abs()).max())
    torch.cuda.empty_cache()

    # the banded stack on 8 universes of 256², card against CPU
    small = EnvConfig(instances=8)
    sa = (np.random.RandomState(0).rand(16, *small.action_shape) < 0.1).astype(np.float32)
    rewards, carries = _card_vs_cpu(
        torch, small, lambda: [rnd2d_def(small, fused_head=nets.BandTiling(4), **kw),
                               prediction_def_packed(small, fused_head=nets.BandTiling(4),
                                                     **kw)],
        sa, rules.LIFE, packed=True)
    for carry in carries.values():
        check(all(int(ws.updates) == 4 for ws in carry.stack.wrappers), "bands parity updates")
    torch.testing.assert_close(rewards["cuda"], rewards["cpu"], rtol=2e-3, atol=0)
    out["card_vs_cpu_256_max_rel_diff"] = float(
        ((rewards["cuda"] - rewards["cpu"]).abs() / rewards["cpu"].abs()).max())

    # where a step's time goes: each leg under torch.profiler (random agent)
    for name in legs:
        ro, carry = rollout(cfg, name, tilings[name], make_random_agent(64, 64, 0.2),
                            batch_size=64)
        out[f"profile_{name}"] = _profile_steps(torch, ro, carry, 32, 1)
        del ro, carry
    check(cuda_head.TILE_CELLS is None, "a forced tile width leaked into the slice")
    log(f"bands ok: {json.dumps({k: v for k, v in out.items() if not k.startswith('profile')})}")
    return counts, out


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
    score_s, trace = ev.evaluate_fused(steps=256, seed=0, verbose=False, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = cuda_build.launch_counts()
    for name, score in (("batched", score_b), ("sequential", score_s)):
        check(math.isfinite(score) and 0.0 <= score <= 10.0,
              f"{name} battery score {score} is not in [0, 10]")
    check(trace.shape == (5 * 256,) and per_rule.shape == (5,), "battery shapes")
    e2e = {
        "batched_score": score_b, "batched_per_ruleset": [float(v) for v in per_rule],
        "batched_s": t1 - t0, "batched_universe_steps_per_s": 160 * 1024 / (t1 - t0),
        "sequential_score": score_s, "sequential_s": t2 - t1,
        "sequential_steps": 5 * 256, "sequential_steps_per_s": 5 * 256 / (t2 - t1),
    }
    log(f"battery ok: {json.dumps(e2e)}")
    log(f"battery launches: {json.dumps(counts)}")
    return counts, e2e


def _card_vs_cpu(torch, cfg, make_defs, acts, rule_bits, prepare=None, packed=False):
    """One numpy action stream through ``Rollout.run_actions`` on the CPU
    (plain path) and on the card (kernel path) from the same initial wrapper
    states: the CPU's draw, after ``prepare(wrapper states)``, carried to the
    card; ``packed`` runs the packed stack.  Returns ({device: rewards on the
    host}, {device: final carry})."""
    from carle_tpu_torch.parallel.packed_env import PackedSpatialStack
    from carle_tpu_torch.rollout import Rollout

    rewards, carries, wstates = {}, {}, None
    for device in ("cpu", "cuda"):
        defs = make_defs()
        ro = Rollout(cfg, defs, device=device,
                     stack=PackedSpatialStack(cfg, defs) if packed else None)
        carry = ro.init(ro.generator(0), 0)
        if wstates is None:
            wstates = carry.stack.wrappers if prepare is None else prepare(carry.stack.wrappers)
        to_device = lambda t: t.to(device) if torch.is_tensor(t) else t
        carry = carry._replace(stack=carry.stack._replace(
            wrappers=tuple(_map_state(ws, to_device) for ws in wstates)))
        carry = ro.with_rules(carry, torch.as_tensor(rule_bits, dtype=torch.int32))
        carries[device], r = ro.run_actions(carry, torch.from_numpy(acts))
        rewards[device] = r.cpu()
    return rewards, carries


def _battery_actions(cfg, steps):
    import numpy as np

    acts = (np.random.RandomState(0).rand(steps, *cfg.action_shape) < 0.1).astype(np.float32)
    acts[steps * 5 // 8] = 1.0  # the master reset
    return acts


def phase_parity(torch):
    """64 steps of one numpy action stream through the kernel path on the
    card and the plain path on the CPU (the wrappers take their plain twins
    only for CPU tensors)."""
    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.evaluation import eval as ev

    cfg = EnvConfig(instances=10)
    bits = [ev.battery_rule_bits(rs, True) for rs in ev.DEFAULT_RULES] * 2
    rewards, _ = _card_vs_cpu(
        torch, cfg, lambda: ev.wrapper_defs(cfg, ev.DEFAULT_WRAPPERS, True),
        _battery_actions(cfg, 64), bits,
        lambda ws: ev.inject_wrapper_checkpoints(ws, ev.DEFAULT_WRAPPERS))
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
    return counts, e2e, hist


def _training_parity(torch, make_defs, what):
    """16 steps of one numpy action stream through a learning stack (dropout
    off, batch_size 4: four Adam updates a learner), kernel path on the card
    vs plain path on the CPU, from the same initial parameters."""
    import numpy as np

    from carle_tpu_torch import EnvConfig, rules

    cfg = EnvConfig(instances=8)
    acts = (np.random.RandomState(0).rand(16, *cfg.action_shape) < 0.1).astype(np.float32)
    rewards, carries = _card_vs_cpu(
        torch, cfg, lambda: make_defs(cfg, dict(train=True, dropout=False, batch_size=4)),
        acts, rules.LIFE)
    for carry in carries.values():
        check(all(int(ws.updates) == 4 for ws in carry.stack.wrappers), "parity updates")
    torch.testing.assert_close(rewards["cuda"], rewards["cpu"], rtol=2e-3, atol=0)
    diff = float(((rewards["cuda"] - rewards["cpu"]).abs() / rewards["cpu"].abs()).max())
    log(f"{what} kernel path (cuda) vs plain path (cpu), 16 steps through 4 updates: "
        f"max rel diff {diff}")
    return diff


def phase_train_parity(torch):
    from carle_tpu_torch.mcl import ae2d_def, rnd2d_def

    return _training_parity(torch, lambda cfg, kw: [rnd2d_def(cfg, **kw), ae2d_def(cfg, **kw)],
                            "training stack")


def _map_state(state, fn):
    """``fn`` over every leaf of a learner state (NamedTuple of dicts/tuples)."""
    if isinstance(state, dict):
        return {k: _map_state(v, fn) for k, v in state.items()}
    if hasattr(state, "_fields"):
        return type(state)(*(_map_state(v, fn) for v in state))
    if isinstance(state, (tuple, list)):
        return type(state)(_map_state(v, fn) for v in state)
    return fn(state)


def phase_routes(torch, timer, cuda_build):
    """The autoencoder's error and its 8 gradient leaves on 64 universes of
    256 x 256 (a frame of a real rollout) by one kernel, by two and by four,
    through the public functions and autograd, dropout off and on with one
    seed.  Times: CUDA events around forward and backward of each route; a
    route launches up to eleven kernels, so its time includes the host's gaps
    between them where the host is the slower."""
    from carle_tpu_torch import EnvConfig, nets, rules
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.mcl._online import tree_leaves, tree_unflatten
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.rollout import Rollout

    n, seed = 64, 777
    cfg = EnvConfig(instances=n)
    ro = Rollout(cfg, [], make_random_agent(64, 64, 0.1), device="cuda")
    carry, _ = ro.run(ro.init(ro.generator(0), rules.LIFE), 32)
    frame = carry.stack.env.grid[:, None].contiguous()
    check(int(frame.sum()) > 0, "the rollout frame is empty")
    params0 = init_ae_params(ro.generator(1), torch.device("cuda"))

    def run(route, drop_p):
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(params0)]
        p = tree_unflatten(params0, leaves)
        kw = dict(drop_p=drop_p, train=drop_p > 0.0, seed=seed)
        if route == "one":
            err = nets.conv_ae_loss(frame, p["conv1"], p["conv2"], p["deconv1"], p["deconv2"],
                                    frame, pools=(2, 2), **kw)
        elif route == "two":
            emb = nets.conv_encoder(frame, p["conv1"], p["conv2"], pools=(2, 2), **kw)
            err = nets.conv_decoder_loss(emb, p["deconv1"], p["deconv2"], frame, **kw)
        else:
            err = nets.ae_loss_by_stages(p, frame, frame, **kw)
        return err.detach(), torch.autograd.grad(err.mean(), leaves)

    cuda_build.reset_launch_counts()
    out = {"universes": n, "live_cells": int(frame.sum())}
    for drop_p in (0.0, DROP_P):
        one = run("one", drop_p)
        for route in ("two", "four"):
            err, grads = run(route, drop_p)
            torch.testing.assert_close(err, one[0], rtol=1e-4, atol=0)
            worst = max(_leaf_errors(grads, one[1]))
            check(worst < 1e-4, f"{route}-kernel route (drop {drop_p}) leaves differ from "
                  f"the one-kernel route's: {worst}")
            key = f"{route}_vs_one_drop_{drop_p}"
            out[key + "_max_rel_err"] = float(((err - one[0]).abs() / one[0].abs()).max())
            out[key + "_max_leaf_rel_err"] = worst
    check(not torch.equal(run("four", DROP_P)[0], run("four", 0.0)[0]),
          "dropout changed nothing in the four-kernel route")
    counts = cuda_build.launch_counts()
    for route in ("one", "two", "four"):
        out[f"{route}_kernel_ms"] = timer.ms(lambda: run(route, DROP_P), 10, warmup=2)
        out[f"{route}_kernel_ms_no_drop"] = timer.ms(lambda: run(route, 0.0), 10, warmup=2)
    log(f"routes ok: {json.dumps(out)}")
    log(f"routes launches: {json.dumps(counts)}")
    return counts, out


def phase_wrappers(torch, cuda_build, shipped):
    """All nine reward wrappers at full width, then card against CPU."""
    import numpy as np

    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.evaluation import eval as ev
    from carle_tpu_torch.mcl import ae2d_def, ae_forward, prediction_def, rnd2d_def
    from carle_tpu_torch.ops import cuda_head
    from carle_tpu_torch.rollout import Rollout

    ckpt = {name: path for name, _, path in ev.DEFAULT_WRAPPERS}
    scales = {"MorphoBonus": 1e-2, "CornerBonus": 1e-3, "SpeedDetector": 1e-2,
              "PufferDetector": 1e-3}
    specs = [[name, scales.get(name, 1.0), ckpt.get(name)] for name in NINE]
    cuda_build.reset_launch_counts()

    # (i) the battery with all nine: 5 rulesets x 32 replicas, 256 steps
    t0 = time.perf_counter()
    score, per_rule = ev.evaluate_fused_batched(steps=256, replicas=32, wrappers=specs,
                                                seed=0, verbose=False, device="cuda")
    torch.cuda.synchronize()
    battery_s = time.perf_counter() - t0
    check(math.isfinite(score) and per_rule.shape == (5,) and np.isfinite(per_rule).all(),
          f"nine-wrapper battery score {score}, per ruleset {per_rule}")

    # (ii) PredictionBonus over AE2D (two kernels) over RND2D, learning online;
    # only the prediction bonus is scaled in, so reward = 0.1 - prediction error
    n, steps = 64, 256
    cfg = EnvConfig(instances=n)
    defs = [rnd2d_def(cfg, reward_scale=0.0), ae2d_def(cfg, reward_scale=0.0, whole_ae=False),
            prediction_def(cfg)]
    ro = Rollout(cfg, defs, make_random_agent(64, 64, 0.1), device="cuda")
    carry = ro.init(ro.generator(0), rules.LIFE)
    t1 = time.perf_counter()
    carry, rewards = ro.run(carry, steps)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    check(bool(torch.isfinite(rewards).all()), "training rewards are not finite")
    updates = [int(ws.updates) for ws in carry.stack.wrappers]
    check(updates == [steps // 64] * 3, f"learners report {updates} updates")
    error = 0.1 - rewards[:, :, 0].mean(dim=1).double().cpu().numpy()   # every universe alive
    first, last = float(error[:64].mean()), float(error[-64:].mean())
    check(last < first, f"the prediction error did not fall: {first:.4e} in the first 64 "
          f"steps, {last:.4e} in the last")
    ring = carry.stack.wrappers[2].extra
    check(int(ring.count) == 5 and torch.equal(ring.frames[:, 4], carry.stack.env.grid[:, None]),
          "the frame ring does not end with the current frame")

    # (iii) ae_forward on the shipped AE2D checkpoint against the fused error
    p = shipped["AE2D"].params
    obs = carry.stack.env.grid[:, None].contiguous()
    recon = ae_forward(p, obs)
    check(recon.shape == obs.shape and float(recon.min()) >= 0.0 and float(recon.max()) <= 1.0,
          "ae_forward's reconstruction is not an image in [0, 1]")
    via_recon = ((obs.to(torch.float32) - recon) ** 2).sum(dim=(1, 2, 3))
    fused = cuda_head.ae_loss_fwd(obs, *(p[k][t] for k in ("conv1", "conv2", "deconv1", "deconv2")
                                         for t in ("w", "b")), obs)
    torch.testing.assert_close(via_recon, fused, rtol=1e-4, atol=0)
    counts = cuda_build.launch_counts()

    # card against CPU: the nine-wrapper stack frozen, then the learning stack
    small = EnvConfig(instances=10)
    bits = [ev.battery_rule_bits(rs, True) for rs in ev.DEFAULT_RULES] * 2
    both, _ = _card_vs_cpu(torch, small, lambda: ev.wrapper_defs(small, specs, True),
                           _battery_actions(small, 32), bits,
                           lambda ws: ev.inject_wrapper_checkpoints(ws, specs))
    torch.testing.assert_close(both["cuda"], both["cpu"], rtol=1e-4, atol=1e-5)
    nine_diff = float((both["cuda"] - both["cpu"]).abs().max())
    learn_diff = _training_parity(
        torch, lambda c, kw: [rnd2d_def(c, **kw), ae2d_def(c, whole_ae=False, **kw),
                              prediction_def(c, **kw)], "prediction stack")
    e2e = {
        "battery_nine_score": score, "battery_nine_per_ruleset": [float(v) for v in per_rule],
        "battery_nine_s": battery_s, "battery_nine_universe_steps_per_s": 160 * 256 / battery_s,
        "train_universes": n, "train_steps": steps, "train_s": train_s,
        "train_universe_steps_per_s": n * steps / train_s, "updates": updates,
        "prediction_error_first_64": first, "prediction_error_last_64": last,
        "ae_forward_vs_fused_max_rel_diff": float(((via_recon - fused).abs() / fused).max()),
        "nine_card_vs_cpu_max_abs_diff": nine_diff,
        "prediction_stack_card_vs_cpu_max_rel_diff": learn_diff,
    }
    log(f"wrappers ok: {json.dumps(e2e)}")
    log(f"wrappers launches: {json.dumps(counts)}")
    return counts, e2e


def _spy(wdef, record):
    """``wdef`` with each step's own reward recorded in ``record``: an
    additive wrapper's bonus, applied to a zero reward and then added (the
    same bits as its own addition), ParsimonyBonus's scaled total."""
    def apply(state, ctx, reward):
        if wdef.name.startswith("ParsimonyBonus"):
            state, out = wdef.apply(state, ctx, reward)
            record.append(out)
            return state, out
        state, bonus = wdef.apply(state, ctx, reward.new_zeros(reward.shape))
        record.append(bonus)
        return state, reward + bonus
    return wdef._replace(apply=apply)


def _stats_defs(cfg, packed, **learn):
    """The packed path's stack: the seven packed-native wrappers (or their
    dense defs) and the two training nets, AE2D by two kernels."""
    from carle_tpu_torch import mcl

    scales = dict(morpho=1e-2, corner=1e-3, speed=1e-2, puffer=1e-3)
    sfx = "_def_packed" if packed else "_def"
    make = lambda name: getattr(mcl, name + sfx)   # noqa: E731
    return [make("speed")(cfg, reward_scale=scales["speed"]),
            make("puffer")(cfg, reward_scale=scales["puffer"]),
            make("corner")(cfg, reward_scale=scales["corner"]),
            make("morpho")(cfg, reward_scale=scales["morpho"]),
            make("prediction")(cfg, **learn), make("surprise")(cfg, **learn),
            mcl.rnd2d_def(cfg, **learn), mcl.ae2d_def(cfg, whole_ae=False, **learn),
            make("parsimony")()]


def phase_packed(torch, cuda_build, uint8_history):
    """The packed path at full width: (i) train_mcl.train(packed_state=True)
    at train-64's geometry against the uint8-carry run of the train phase;
    (ii) the packed stack on 160 universes x 256 steps with the seven
    packed-native wrappers (Prediction and Surprise learning) and RND2D +
    AE2D (two kernels), each wrapper's reward held against its dense def on
    the uint8 stack (one seed, one action stream; the dense reference runs
    twice, to show what one card repeats bit for bit); (iii) that stack
    unpacks nothing; (iv) 16 steps of it on 8 universes, card against CPU.
    Each additive wrapper's own bonus is compared, ParsimonyBonus's scaled
    total: rtol 1e-4 with an atol of 1e-4 of the wrapper's largest reward
    (Speed's float32 sums in another order, Morpho's exact sums against a
    float32 conv, which ParsimonyBonus's total inherits)."""
    import numpy as np

    from carle_tpu_torch import EnvConfig, train_mcl
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.evaluation import eval as ev
    from carle_tpu_torch.parallel.packed_env import PackedSpatialStack
    from carle_tpu_torch.rollout import Rollout

    n, steps = 160, 256
    cfg = EnvConfig(instances=n)
    bits = torch.tensor([ev.battery_rule_bits(rs, True) for rs in ev.DEFAULT_RULES] * 32,
                        dtype=torch.int32)
    deltas, walls, stacks = {}, {}, {}

    def run_stack(packed, key=None):
        key = packed if key is None else key
        log_ = [[] for _ in range(9)]
        defs = [_spy(d, log_[i]) for i, d in enumerate(_stats_defs(cfg, packed))]
        stack = PackedSpatialStack(cfg, defs) if packed else None
        ro = Rollout(cfg, defs, make_random_agent(64, 64, 0.1), device="cuda", stack=stack)
        carry = ro.with_rules(ro.init(ro.generator(0), 0), bits)
        carry, _ = ro.reset(carry)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, rewards = ro.run(carry, steps)
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        deltas[key] = [torch.stack(d).cpu() for d in log_]
        stacks[key] = (ro.stack, carry)
        check(bool(torch.isfinite(rewards).all()), "packed-path rewards are not finite")

    run_stack(False)   # the dense reference, before the path's counts start
    run_stack(False, "again")
    cuda_build.reset_launch_counts()
    # (i) the trainer with the packed carry
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        hist = train_mcl.train(instances=64, height=256, width=256, steps=(1, 128),
                               batch_size=64, seed=0, log_dir=tmp, device="cuda",
                               packed_state=True)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    exact = bool(np.array_equal(hist, uint8_history))
    np.testing.assert_allclose(hist, uint8_history, rtol=1e-6, atol=0)
    # (ii) and (iii)
    run_stack(True)
    counts = cuda_build.launch_counts()
    packed_counts = cuda_build.packed_launch_counts()
    names = [d.name for d in _stats_defs(cfg, True)]
    agree = {}
    for name, got, want, again in zip(names, deltas[True], deltas[False], deltas["again"]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * max(scale, 1e-3))
        agree[name] = dict(max_abs_diff=float((got - want).abs().max()), max_abs=scale,
                           equal=bool(torch.equal(got, want)),
                           uint8_run_to_run_equal=bool(torch.equal(again, want)))
    stack, carry = stacks[True]
    check(stack.unpacks == 0, f"the all-packed-native stack unpacked {stack.unpacks} views")
    dense_stack, dense_carry = stacks[False]
    check(torch.equal(stack.universe(carry.stack), dense_stack.universe(dense_carry.stack)),
          "the packed and uint8 stacks' universes differ")
    missing = [k for k in PACKED_INPUT_KERNELS if not packed_counts.get(k)]
    check(not missing, f"kernels that never read packed words on the packed path: {missing}")
    # (iv) card against CPU, 16 steps, dropout off, four Adam updates a learner
    small = EnvConfig(instances=8)
    acts = (np.random.RandomState(0).rand(16, *small.action_shape) < 0.1).astype(np.float32)
    both, _ = _card_vs_cpu(
        torch, small, lambda: _stats_defs(small, True, train=True, dropout=False, batch_size=4),
        acts, bits[:8], packed=True)
    torch.testing.assert_close(both["cuda"], both["cpu"], rtol=2e-3, atol=1e-5)
    out = {
        "train_universes": 64, "train_steps": 512, "train_s": train_s,
        "train_history_equals_uint8_carry_bit_for_bit": exact,
        "train_history_max_rel_diff": float(np.max(np.abs(hist - uint8_history)
                                                   / np.maximum(np.abs(uint8_history), 1e-30))),
        "stack_universes": n, "stack_steps": steps,
        "stack_packed_s": walls[True], "stack_uint8_s": [walls[False], walls["again"]],
        "stack_packed_universe_steps_per_s": n * steps / walls[True],
        "wrappers_vs_dense": agree, "unpacks": stack.unpacks,
        "packed_word_launches": packed_counts,
        "card_vs_cpu_max_rel_diff": float(((both["cuda"] - both["cpu"]).abs()
                                           / both["cpu"].abs().clamp_min(1e-6)).max()),
    }
    log(f"packed ok: {json.dumps(out)}")
    log(f"packed launches: {json.dumps(counts)}")
    return counts, out


def _profile_steps(torch, ro, carry, steps, universes):
    """``steps`` steps unprofiled (wall, and the host's time to queue them)
    and again under torch.profiler: device time a step by kernel and the
    device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    carry, _ = ro.run(carry, 16)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    carry, _ = ro.run(carry, steps)
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated()
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
        "max_memory_allocated_bytes": peak,
        "top_device_us_per_step": [
            {"name": e.key[:60], "us": device_us(e) / steps,
             "calls_per_step": e.count / steps} for e in top],
        # the host's own time in each operation, under the profiler
        "top_host_us_per_step": [
            {"name": e.key[:40], "us": e.self_cpu_time_total / steps,
             "calls_per_step": e.count / steps} for e in host],
    }


def phase_profile_train(torch, steps: int = 64, packed: bool = False):
    """Where a training step's time goes: 64 universes, both nets learning,
    dropout on, Life; ``packed`` carries the universes packed (the packed
    stack, the nets reading the words)."""
    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.mcl import ae2d_def, rnd2d_def
    from carle_tpu_torch.parallel.packed_env import PackedSpatialStack
    from carle_tpu_torch.rollout import Rollout

    cfg = EnvConfig(instances=64)
    defs = [rnd2d_def(cfg), ae2d_def(cfg)]
    ro = Rollout(cfg, defs, make_random_agent(64, 64, 0.1), device="cuda",
                 stack=PackedSpatialStack(cfg, defs) if packed else None)
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
        engines_counts, engines = phase_engines(torch, cuda_build)
        routes_counts, routes = phase_routes(torch, timer, cuda_build)
        del timer
        torch.cuda.empty_cache()
        battery_counts, e2e = phase_battery(torch, cuda_build)
        parity_diff = phase_parity(torch)
        server_counts, server = phase_server(torch, cuda_build)
        train_counts, train, train_hist = phase_train(torch, cuda_build)
        train_parity_diff = phase_train_parity(torch)
        packed_counts, packed = phase_packed(torch, cuda_build, train_hist)
        wrappers_counts, wrappers = phase_wrappers(torch, cuda_build, shipped)
        bands_counts, bands = phase_bands(torch, cuda_build)
        profile = phase_profile(torch)
        log(f"profile: {json.dumps(profile)}")
        profile_train = phase_profile_train(torch)
        log(f"profile (training): {json.dumps(profile_train)}")
        profile_packed = phase_profile_train(torch, packed=True)
        log(f"profile (packed training): {json.dumps(profile_packed)}")
    except Exception:  # report the failing phase and exit non-zero
        traceback.print_exc()
        log("FAIL: see the traceback above")
        return 1

    path_counts = {"battery": battery_counts, "server": server_counts,
                   "train": train_counts, "routes": routes_counts,
                   "wrappers": wrappers_counts, "packed": packed_counts,
                   "bands": bands_counts, "engines": engines_counts}
    missing = [f"{path}:{k}" for path, needed in PATH_KERNELS.items()
               for k in needed if path_counts[path][k] == 0]
    if missing:
        log(f"FAIL: kernels not launched on the main path: {missing}")
        return 1
    kernels = []
    rows = {name: (name, source, replaces) for name, (source, replaces) in SOURCES.items()}
    rows.update(FEATURE_ROWS)
    for name, (kernel, source, replaces) in rows.items():
        r = results[name]
        launches = (path_counts["bands"][kernel] if name in FEATURE_ROWS
                    else sum(c[kernel] for c in path_counts.values()))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    report = {
        "card": card, "build_s": build_s, "kernels": kernels,
        "kernel_shapes": {k: results[k]["shape"] for k in rows},
        "kernel_details": {k: results[k] for k in rows},
        "bands_kernels": results["bands_kernels"], "bands": bands,
        "launches": path_counts,
        "e2e": e2e, "server": server, "run_actions_max_abs_diff": parity_diff,
        "train": train, "train_parity_max_rel_diff": train_parity_diff,
        "routes": routes, "wrappers": wrappers, "packed": packed, "engines": engines,
        "dropout": results["dropout"], "ae_loss_src_not_obs": results["ae_loss_src_not_obs"],
        "profile": profile, "profile_train": profile_train, "profile_packed": profile_packed,
        "total_s": time.perf_counter() - t_start,
    }
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    log(json.dumps({k: report[k] for k in ("launches", "e2e", "server", "train", "routes",
                                           "wrappers", "packed", "engines", "total_s")}))
    log(json.dumps({"bands": {k: v for k, v in bands.items() if not k.startswith("profile")},
                    "bands_kernels": results["bands_kernels"]}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
