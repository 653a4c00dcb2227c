"""Chip smoke test of carle_tpu_torch on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero without the final line:

1. build   the CUDA kernels from carle_tpu_torch/csrc (one nvcc a source,
           all at once) and print the card as nvidia-smi names it;
2. kernels each kernel against its plain PyTorch twin on the card at the
           slices' shapes (integer kernels exact, float kernels within the
           stated tolerance; the per-step CA kernel on words of cells,
           ca_step_words, every main path's, against its twin and the byte
           kernel forced at [1], [64], [160] x 256² and ragged shapes, with
           and without the master reset, bit for bit, both timed in turns
           after an L2 flush and L2-warm and by CUPTI cold and warm, the word
           kernel's registers and blocks a multiprocessor; row 2's
           redesigned kernels (bit_multi_step_words: streaming one
           generation, universes held in registers, a universe split over a
           thread-block cluster) against the present ones forced and the
           twin at the paths' shapes (packed train, packed stack, bands,
           /rollout, engines), bit for bit, both timed in turns after an L2
           flush and by CUPTI cold, their plans, registers and blocks a
           multiprocessor; at bench.py's geometry (phase_engine_kernels)
           the fixed-rule engine (row 10) on the same kernels, the rule
           folded (bit_multi_step_static_words), the column-major fixed-rule
           engine held in registers (row 11a, bit_multi_step_static_cm_words)
           and the uint8 engine on packed bits in one launch (row 12,
           ca_multi_step_bits, Life and the battery's rulesets as data), each
           against its present kernel forced and the twin, likewise; the
           head's backward specialised at the
           package's three stage widths (head2_bwd, row 9b) against the
           generic kernel forced and the twin at its three cases (each leaf
           within 1e-5 of the generic kernel's, gx bit for bit), timed in
           turns and by CUPTI cold, its plans, registers and blocks a
           multiprocessor; the head's forward at those widths (head2_fwd,
           row 9a: u8 and packed [160] at pool 2, pool 4, AE conv2 on f32
           [64], dropout at [64]) bit for bit against the generic kernel
           forced and within 1e-5 of the twin, and the loss tail's backward
           at the tail's widths (loss_tail2_bwd, row 8b: uint8, packed and
           float32 obs, dropout 0.1 and none, (2, 1) relu) against the
           generic kernel forced (gx bit for bit, each leaf within 1e-5)
           and the twin, both timed in turns and by CUPTI cold with the
           share of the bound, plans, registers and blocks a
           multiprocessor; the encoder's kernels specialised at the
           package's widths, enc3_*, also against the generic ones at
           every shape: the forward bit for bit, the gradients within 1e-5 of
           each leaf at 256² and 1e-4 on the 8192² shapes, the training
           forward's saved keep bits against the twin's Philox mask, both
           timed in turns, their registers and blocks a multiprocessor; the
           decoder loss's kernels specialised at its width, dec2_*, likewise
           against the generic ones at rows 5a-6b's shapes and at 8192²: the
           error within 1e-6 relative, gx bit for bit, each leaf within 1e-5,
           uint8 and packed obs bit for bit, the saved keep bits against the
           Philox mask on the rows whose weight is not zero, timed in turns
           with and without dropout and from the saved bits, their registers
           and blocks a multiprocessor as "dec2 occupancy"; the decoder
           stage's kernels specialised at its two widths, tail2_*, likewise
           against the generic one at rows 7a-7b's shapes and the spatial
           tier's slot blocks: the forward bit for bit, gx bit for bit, dW
           and db within 1e-5, the saved keep bits against the Philox mask,
           the backward from them the same bits as drawing them, timed in
           turns, plans, registers and blocks a multiprocessor as "tail2
           occupancy", F.conv_transpose2d's time as a part), with
           their times (CUDA events, L2 flushed
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
           instances a launch (the encoder's backward also on the instances
           past 65,535 alone); the pool ties of the 8192² and 65,600-instance
           encoder backwards separated from error (float64 twin pre-activations mark the
           windows whose top two values are equal or within 4, 16 or 64
           float32 ulps; the cotangent is zeroed where they reach; outside
           the near ties kernel against the float32 and float64 twins within
           1e-4); the head at width 8192 (column tiles) against its twin,
           and tiles forced at 256² against one tile;
   ae2d    the whole-autoencoder kernels specialised at AE2D's widths
           (csrc/ae2d_fwd.cu, ae2d_bwd.cu) against the generic instantiation
           at the same widths (error within 1e-6 relative, each gradient leaf
           within 1e-5 of its largest entry; uint8 and packed src and obs, src
           = obs and not, dropout 0 and 0.1), the training forward's saved
           keep bits against the twin's Philox mask, then both instantiations
           timed in turns at rows 4a and 4b's shapes, each call's device
           launches and time by kernel, the host's time to enqueue a
           forward on one universe, each band kernel's registers, shared
           memory and resident blocks a multiprocessor, and a training step
           and the batched battery with each instantiation in turns;
   spatial_kernels  the three halo kernels at 8192² on 4 slots of one card
           (uint8 1 and 8 generations, packed 64 with the rule as data and
           with Life fixed) against their twins and the single-device
           engines on the unsharded universe, bit for bit, with their times
           beside the engines'; the packed one's redesigned launcher
           (bit_spatial_words: temporal blocking, one launch a chunk of
           generations) against the present kernel forced, timed in turns,
           and one generation a call (the streaming kernel) by CUPTI cold,
           with the plans' registers and blocks a multiprocessor; the uint8
           one generation (halo_words) and the env mode's step with its
           action and reset flag against the present kernel forced, likewise;
           a small ragged case with a rule vector;
   engines each of the five packed and uint8 engines once at bench.py's
           geometry through its public function: all leave bench.py's
           checksum, the live-cell sum of the plain twin;
3. battery the scoring battery's entry points with the shipped checkpoints:
           evaluate_fused_batched (5 rulesets x 32 replicas = 160 universes
           of 256 x 256, 1024 steps) and evaluate_fused (5 x 256 steps x 1
           universe); then one 64-step run_actions stream through the kernel
           path on the card and the plain path on the CPU;
   submission  the Carle's Game submission harness: the per-step evaluate at
           the full protocol (SubmissionAgent, the four wrappers' class shells
           with the shipped .npz, 5 rulesets x 1024 steps of one 256²
           universe, a host round trip a step): wall, steps/s, launches a
           step, the host's share (64 steps profiled); the card against the
           CPU on a replay stream (2 x 16 steps, a master reset); the network
           agent with weights that toggle, evaluate_fused against evaluate
           (2 x 256 steps of rules that give birth on zero neighbours), its
           actions on 8 soups against the CPU's away from the threshold; a
           .pt round trip of RND2D and AE2D on the card;
4. server  the port's HTTP server on 127.0.0.1 in a thread: /health, /score
           (64 steps; the random, the network and the policy agent) and
           /rollout (256 x 256, 256 generations);
   io      pattern I/O, episode artifacts and analysis: the native RLE codec
           (160 universes of 256² ash, bodies and decode_body) and LZW (a
           256-frame 256² episode) byte for byte against their numpy / Python
           twins, each timed on the host; then, counted from zero, env._main
           (the glider sequence and the sweep at 1 and 64 instances), a logged
           256² CARLE shell (the glider sequence, 256 replayed steps with a
           master reset; ms a logged step beside an unlogged one),
           Rollout.run_logged on train-64's stack (64 universes, RND2D + AE2D
           learning, dropout on, 1024 steps, a snapshot every 256) against
           run from the same carry (rewards rtol 1e-5), run_gif (instance 0,
           256 steps, every 2, actions marked), /gif (256², 256 generations,
           every 4), /rollout's ash through /classify's census and GET / on
           the server, population_curve (160 x 256² x 1024 generations, its
           last counts = the packed engine's), classify_pattern (glider, LWSS,
           Gosper gun), scripts/soup_search_torch.py at its defaults but
           16 soups (256² x 1024 generations, --max-period 16; cut from 64
           to keep the phase under 60 s) and
           carle_tpu_torch.demos at its __main__ sizes; then, card against
           CPU, the logged shell's CSV, RLE and PNG files byte for byte,
           episode_report on its log, census on a 64² ash and the
           classifications, equal;
   policy  the policies at the eval geometry (256² universes, 64² actions,
           DEFAULT_WRAPPERS frozen with the shipped .npz): PPO on 16
           universes with the fused encoder at the policy's widths (8, 1, 2,
           2), horizon 128, 4 epochs of 4 minibatches, two iterations (ms a
           collect step, ms an update phase); REINFORCE, 64 steps; the
           shipped policy (policy_ppo.npz) through evaluate_fused (5 x 1024)
           and evaluate_fused_batched; then a PPO iteration of 32 steps and 16
           REINFORCE steps profiled (device busy share, launches a step, peak
           memory); card against CPU: one PPO iteration at 4 universes x
           horizon 8 and the shipped policy's deterministic agent (sigmoid >
           0.5) over 2 x 64 steps, the uniforms and permutations replayed from
           one numpy stream, the CPU playing the card's actions once they are
           held equal away from the draw; before the battery, rows 3a and 3b
           at the policy's widths against the generic kernels forced
           (_enc3_policy_held: forward on 16 and 512 universes, backward on
           512);
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
9. spatial the row-sharded tier at full size on 4 slots of one card: the
           halo kernels through parallel.spatial against the engines; the
           packed stack with the mesh through run_actions (8192², 64 x 64
           actions at p = 0.2): Speed dense and packed (bit for bit against
           the mesh=None stack; the packed one gathers and unpacks nothing),
           RND2D with SpaceSharding over 128 steps (2 updates, dropout on),
           AE2D with SpaceSharding, free_steps(64); RND2D with dropout off
           against BandTiling(512) (rtol 1e-4 through 2 updates); RND2D's
           step profiled; the uint8 spatial env mode (shard_carry_spatial,
           Speed + Puffer, a master reset) against the mesh=None uint8 stack,
           bit for bit, one halo_words launch and one gather a step;
9b. spatial_2d the env x space mesh at full size: 2 universes of 8192² on a
           2 x 4 mesh (one universe an env group, its rows over a ring of 4
           slots; 8 slots of one card), each held against the 4-slot
           one-axis mesh on the same 2 universes: the bare halo calls
           (parallel.spatial, 8 generations; also against their twins on
           the 2-D shards), bit for bit; the uint8 env mode (shard_carry_2d,
           Speed + Puffer, a master reset at step 40) bit for bit, two
           halo_words launches (one a ring) and one gather a step; the
           packed stack (PackedSpatialStack(env_axis="env")) with packed
           Morpho + Parsimony, bit for bit, timed against the mesh=None
           packed stack; then RND2D + AE2D on SpaceSharding(mesh, "space",
           "env") learning (dropout on, 3 updates) + Morpho + Parsimony, its
           universe bit for bit, timed and profiled (device and wall ms a
           step, launches and gathers a step, peak memory); RND2D + AE2D
           with dropout off against the one-axis mesh (rtol 1e-4 through 3
           updates);
9c. env_mesh env-batch data parallelism on one controller: a mesh of 4
           slots of the card (shard_carry's instance shards, rings of one
           slot; the nets a launch a slot, fused_head=mesh): (a) train-64
           through train(mesh=) (64 universes of 256², 16 a slot, RND2D +
           AE2D learning, dropout 0.1, 4 rulesets x 128 steps; checkpoints, 8
           updates a learner, the bonus falls; packed_state=True's history
           equal to the uint8 mesh run's, rtol 1e-6), one halo_words launch a
           ring a step; (b) train-64's stack with dropout off, 128 steps, the
           mesh against mesh=None: universe bit for bit, rewards rtol 1e-5, no
           gather; (d) the batched battery (5 x 32 x 1024, 40 universes a
           slot) through evaluate_fused_batched(mesh=), score rtol 1e-4 of
           mesh=None's, and 5 x 1 on 4 slots refused; (e) policy_logits on 16
           universes with the mesh against fused_head=True (1e-5, gradients
           1e-4 of each leaf); then (a)'s and (d)'s stacks profiled on the
           mesh and on one device (wall and device ms, launches and gathers a
           step, peak memory), and (c) the six batch-axis routes at train-64's
           shapes, dropout off and on, each slot against its twin seeded
           _shard_seed (forwards 1e-4; gradients 1e-4, the pooled routes
           TOL_TIES with the encoder's ties analysed);
9d. multiprocess several processes over one mesh (parallel/distributed.py):
           2 processes x 2 slots of cuda:0 spawned by the launcher, gloo
           (NCCL cannot put two ranks on one card: not run), every kernel
           built before the spawn, each leg held against the one-controller
           4-slot mesh run first: (a) train-64 (4 rulesets x 64 steps, cut
           from 128) through train(mesh=) with dropout off, universe bit for
           bit, history rtol 1e-5, parameters bit for bit equal across the
           processes; with dropout on the bonus falls and process 0 alone
           writes a checkpoint set; (b) 8 uint8 generations of one 8192²
           universe, 2048 rows a slot (row 13 across processes), bit for bit;
           (c) the packed stack with RND2D on the row shards of one 8192²
           universe (rows 15, 3a, 3b across processes), universe bit for bit,
           rewards rtol 1e-4; (d) the reset flag set on one process only does
           not fire, on both fires; the wall ms a step of (a)-(c) against the
           one controller, the ghost bytes and exchanges, the collectives and
           the host-staging ms a step, each child's peak memory;
9e. surfaces the outer surface (ROADMAP Queue 1 item 9): (a) the compat
           facade installed for the card drives the reference's stack
           PufferDetector(SpeedDetector(AE2D(RND2D(CARLE())))) (one 256²
           universe, the 64 x 64 action: a glider, then random toggles;
           dropout off, SURFACE_STEPS steps, 4 Adam updates a learner) held
           against the facade on the CPU from the same weights: observations
           bit for bit, rewards SURFACE_REWARD_RTOL; host tensors returned;
           the facade uninstalled after; (b) the device-memory preflight's
           price of train at 64 and 1024 universes of 256² against the peak
           torch.cuda.max_memory_allocated after the first segment, a micro
           budget refused before any segment, force_hbm completing; (c)
           serialize: train-64's history with and without it bit for bit,
           the peaks at 1024 both ways; (d) utils.profiling.trace over a few
           training steps: the trace names ca_step_words and an encoder
           kernel;
10. profile 64 steps of the batched battery and 64 training steps, uint8 and
           packed carry, under torch.profiler: device time a step by kernel,
           the device's busy share and the peak device memory;
11. report a {"kernels": [...]} line with each kernel's launches on the main
           paths (battery, submission, server, io, policy, train, routes, wrappers, packed,
           bands, engines, spatial, spatial_2d, env_mesh, multiprocess and surfaces, each
           counted from zero just before it (multiprocess: in each child, added up);
           the rows of the
           mask and the row weights count their kernel's launches on the
           bands path; a generic encoder, decoder-loss or tail kernel, the
           byte ca_step kernel, the present packed or uint8 engines or halo
           kernels (bit_multi_step, bit_multi_step_static,
           bit_multi_step_static_cm, ca_multi_step, bit_spatial_multi_step,
           spatial_multi_step, spatial_ca_step) or
           the generic head backward (head_bwd), launched on any of them
           fails the run),
           then the
           card's name and power limit,
           then the ok line.

Tolerances: float kernels vs plain twins rtol 1e-4 / atol 1e-4 (the twins
run cuDNN in full float32, TF32 off; cuDNN's own algorithms sum in other
orders); the AE error sums 65,536 squares per universe, so rtol 1e-4.
Integer engines and the packed-word inputs: bit for bit.  The packed path's
wrappers against their dense defs: rtol 1e-4 (Speed's float32 weighted sums
in another order; Morpho's exact integer sums against a float32 conv, atol
1e-4 of its largest reward).
Battery rewards, kernel path on the card vs plain path on the CPU: rtol 1e-4,
atol 1e-5 (also the per-step evaluate's trace, and the network agent's fused
trace against its per-step one).  The network agent's actions, card vs CPU:
equal where the dense output lies more than 1e-4 from logit(0.1).  Gradients, kernel vs twin: 1e-4 of each leaf's largest entry (sums
over 4 million positions in other orders; a pool window whose maxima tie in
one and differ in the last bit in the other moves one window's share).
Training rewards through 4 Adam updates, card vs CPU: rtol 2e-3 (Adam divides
by the gradient's own scale).  The policies, card vs CPU: actions equal where
the draw (the uniform, or the deterministic agent's rate) lies more than 1e-4
from sigmoid(logit); rewards and the shipped policy's trace rtol 1e-4 / atol
1e-5; PPO's parameters after 16 Adam updates within 2e-3 of each leaf's
largest entry.  The encoder at the policy's widths against the generic
kernels: the forward bit for bit, the gradients 1e-5 of each leaf's largest
entry; against the twins 1e-4.  The autoencoder's three routes against each
other: error rtol 1e-4, gradients as above (one mask, other summation
orders); ae_forward's reconstruction error against ae_loss_fwd's: rtol 1e-4.
The encoder's gradients at 8192² (band shapes and global) and on 65,600
instances of 16 x 32: 2e-3 of each leaf's largest entry over all outputs (134
and 34 million stage-1 positions: the pool-tie shares that move between
summation orders add up; see phase_band_kernels), and 1e-4 outside the pool windows whose top two values
lie within 64 float32 ulps without being equal (_tie_analysis).  Column tiles
against one tile: encoder outputs bit for bit, sums and gradients 1e-5 of each
leaf's largest entry.  Banded stack against unbanded at 8192²: rtol 1e-4.
Halo kernels against twins and engines: bit for bit; the uint8 env mode
against the mesh=None uint8 stack likewise (universe and rewards).  Sharded RND2D against
BandTiling(512): rtol 1e-4 (parameter-gradient sums in another order,
through 2 Adam updates).  Phase and build times are printed as they end.
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
# shift in one operation.  A row's horizontal pair planes (2 SHF + 2 LOP3 = 4)
# are built once and serve the three output rows that read it, so a word
# pays for one row's; the carry-save tree 4 CSAs x 2 LOP3 + n2, n3 = 10, the
# two 9-leaf mux folds 2 x 11 LOP3 + the alive/dead select = 23: 37.
# (carle_tpu/ops/bitpack.py:11 counts ~110 two-input operations: the TPU has
# no 3-input logic op.)
OPS_PER_WORD = 37
# The same count for the other engines (a word of cells a generation):
# the row-major engine with Life fixed at compile time: pairs 4, carry-save
# tree 10, Life's decision n1 & ~n2 & ~n3 & (n0 | g) 2 LOP3 = 16; column-major
# (each thread carries its neighbours' vertical triples, each column's built
# once): the east column's triple 2 SHF + 2 LOP3, count9 from the triples
# 2 CSAs x 2 LOP3 + 4 = 12, then Life's decision 2 LOP3 = 16 fixed, the two
# 10-leaf mux folds 2 x 11 LOP3 + the select = 23 as data: 35.
OPS_PER_WORD_STATIC, OPS_PER_WORD_STATIC_CM, OPS_PER_WORD_CM = 16, 16, 35
# The present uint8 engine's own count (4 cells a byte-SWAR word): column
# sums 3 IADD3, 2 SHF, count9 1 IADD3, index 1 LEA, a byte's lookup BFE + SHF
# + BFI x 4 = 19, 4.75 a cell.  It is the cost of that kernel, not of the
# work, and bounds no row: the generations of a uint8 universe can run on
# packed bits (row 12's redesigned kernel runs them so), so the uint8 rows
# 12-14 are bounded by the work's own least time (u8_bound): one read and one
# write of each cell as a byte against OPS_PER_WORD = 37 operations a word
# of 32 cells a generation, 1.156 a cell.  At 4096 x 256², 128 generations:
# 537 MB over 3.35 TB/s = 0.160 ms against 37 x 2^23 words x 128 / 16.7 T/s
# = 2.375 ms (9.757 at 19 a 4-cell word); at 8192², 8 generations: 134 MB =
# 0.0401 ms against 37 x 2^21 x 8 / 16.7 T = 0.0371 (0.1525 at 19).
OPS_PER_U8_WORD = 19
BENCH_UNIVERSES, BENCH_SIZE, BENCH_STEPS = 4096, 256, 128   # bench.py's geometry
BATTERY_RULESETS = (([3], [2, 3]), ([3, 6, 8], [2, 4, 5]), ([3, 6, 7, 8], [3, 4, 6, 7, 8]),
                    ([3], [0, 2, 3]), ([1, 3, 5, 7], [1, 3, 5, 7]))

SOURCES = {
    "ca_step_words": ("carle_tpu_torch/csrc/ca_step.cu", "carle_tpu/ops/pallas_ca.py:100"),
    "ca_step": ("carle_tpu_torch/csrc/ca_step.cu", "carle_tpu/ops/pallas_ca.py:100"),
    "bit_multi_step": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                       "carle_tpu/ops/pallas_bitpack.py:565"),
    "bit_multi_step_words": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                             "carle_tpu/ops/pallas_bitpack.py:565"),
    "bit_multi_step_static": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                              "carle_tpu/ops/pallas_bitpack.py:647"),
    "bit_multi_step_static_words": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                                    "carle_tpu/ops/pallas_bitpack.py:647"),
    "bit_multi_step_static_cm": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                                 "carle_tpu/ops/pallas_bitpack.py:736"),
    "bit_multi_step_static_cm_words": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                                       "carle_tpu/ops/pallas_bitpack.py:736"),
    "bit_multi_step_cm": ("carle_tpu_torch/csrc/bit_multi_step.cu",
                          "carle_tpu/ops/pallas_bitpack.py:770"),
    "ca_multi_step": ("carle_tpu_torch/csrc/ca_multi_step.cu",
                      "carle_tpu/ops/pallas_ca.py:153"),
    "ca_multi_step_bits": ("carle_tpu_torch/csrc/ca_multi_step.cu",
                           "carle_tpu/ops/pallas_ca.py:153"),
    "encoder_fwd": ("carle_tpu_torch/csrc/encoder_fwd.cu",
                    "carle_tpu/ops/pallas_head.py:1081"),
    "ae_loss_fwd": ("carle_tpu_torch/csrc/ae2d_fwd.cu",
                    "carle_tpu/ops/pallas_head.py:1841"),
    "encoder_bwd": ("carle_tpu_torch/csrc/encoder_bwd.cu",
                    "carle_tpu/ops/pallas_head.py:1114"),
    "enc3_fwd": ("carle_tpu_torch/csrc/enc3_fwd.cu", "carle_tpu/ops/pallas_head.py:1081"),
    "enc3_bwd": ("carle_tpu_torch/csrc/enc3_bwd.cu", "carle_tpu/ops/pallas_head.py:1114"),
    "ae_loss_bwd": ("carle_tpu_torch/csrc/ae2d_bwd.cu",
                    "carle_tpu/ops/pallas_head.py:1875"),
    "head_fwd": ("carle_tpu_torch/csrc/head_fwd.cu", "carle_tpu/ops/pallas_head.py:281"),
    "head2_fwd": ("carle_tpu_torch/csrc/head2_fwd.cu", "carle_tpu/ops/pallas_head.py:281"),
    "head_bwd": ("carle_tpu_torch/csrc/head_bwd.cu", "carle_tpu/ops/pallas_head.py:297"),
    "head2_bwd": ("carle_tpu_torch/csrc/head2_bwd.cu", "carle_tpu/ops/pallas_head.py:297"),
    "tail_fwd": ("carle_tpu_torch/csrc/tail.cu", "carle_tpu/ops/pallas_head.py:628"),
    "tail_bwd": ("carle_tpu_torch/csrc/tail.cu", "carle_tpu/ops/pallas_head.py:645"),
    "tail2_fwd": ("carle_tpu_torch/csrc/tail2_fwd.cu", "carle_tpu/ops/pallas_head.py:628"),
    "tail2_bwd": ("carle_tpu_torch/csrc/tail2_bwd.cu", "carle_tpu/ops/pallas_head.py:645"),
    "loss_tail_fwd": ("carle_tpu_torch/csrc/tail.cu", "carle_tpu/ops/pallas_head.py:794"),
    "loss_tail2_fwd": ("carle_tpu_torch/csrc/loss_tail2_fwd.cu",
                       "carle_tpu/ops/pallas_head.py:794"),
    "loss_tail_bwd": ("carle_tpu_torch/csrc/tail.cu", "carle_tpu/ops/pallas_head.py:822"),
    "loss_tail2_bwd": ("carle_tpu_torch/csrc/loss_tail2_bwd.cu",
                       "carle_tpu/ops/pallas_head.py:822"),
    "decoder_loss_fwd": ("carle_tpu_torch/csrc/decoder_loss_fwd.cu",
                         "carle_tpu/ops/pallas_head.py:1481"),
    "decoder_loss_bwd": ("carle_tpu_torch/csrc/decoder_loss_bwd.cu",
                         "carle_tpu/ops/pallas_head.py:1506"),
    "dec2_fwd": ("carle_tpu_torch/csrc/dec2_fwd.cu", "carle_tpu/ops/pallas_head.py:1481"),
    "dec2_bwd": ("carle_tpu_torch/csrc/dec2_bwd.cu", "carle_tpu/ops/pallas_head.py:1506"),
    "spatial_multi_step": ("carle_tpu_torch/csrc/halo_step.cu",
                           "carle_tpu/parallel/pallas_halo.py:222"),
    "spatial_multi_step_bits": ("carle_tpu_torch/csrc/halo_step.cu",
                                "carle_tpu/parallel/pallas_halo.py:222"),
    "spatial_ca_step": ("carle_tpu_torch/csrc/halo_step.cu",
                        "carle_tpu/parallel/pallas_halo.py:396"),
    "spatial_ca_step_words": ("carle_tpu_torch/csrc/halo_words.cu",
                              "carle_tpu/parallel/pallas_halo.py:396"),
    "bit_spatial_multi_step": ("carle_tpu_torch/csrc/halo_step.cu",
                               "carle_tpu/parallel/pallas_halo.py:327"),
    "bit_spatial_words": ("carle_tpu_torch/csrc/halo_step.cu",
                          "carle_tpu/parallel/pallas_halo.py:327"),
}
# Rows whose kernel is another row's with band tiling's feature added: the
# launches they report are their kernel's on the bands path, where every
# encoder launch carries the per-band row mask and every decoder-loss launch
# the per-band row weights.  The encoder's and the decoder loss's rows come
# twice: the kernels specialised at the package's widths (enc3_*, dec2_*),
# which every main path runs, and the generic ones (encoder_*,
# decoder_loss_*), timed at the same shapes with the specialised route
# switched off (cuda_head.ENC3_KERNELS, cuda_stages.DEC2_KERNELS).
FEATURE_ROWS = {
    "enc3_fwd_mask": ("enc3_fwd", "carle_tpu_torch/csrc/enc3_fwd.cu",
                      "carle_tpu/ops/pallas_head.py:1375"),
    "enc3_bwd_mask": ("enc3_bwd", "carle_tpu_torch/csrc/enc3_bwd.cu",
                      "carle_tpu/ops/pallas_head.py:1375"),
    "encoder_fwd_mask": ("encoder_fwd", "carle_tpu_torch/csrc/encoder_fwd.cu",
                         "carle_tpu/ops/pallas_head.py:1375"),
    "encoder_bwd_mask": ("encoder_bwd", "carle_tpu_torch/csrc/encoder_bwd.cu",
                         "carle_tpu/ops/pallas_head.py:1375"),
    "decoder_loss_fwd_em": ("decoder_loss_fwd", "carle_tpu_torch/csrc/decoder_loss_fwd.cu",
                            "carle_tpu/ops/pallas_head.py:1776"),
    "decoder_loss_bwd_em": ("decoder_loss_bwd", "carle_tpu_torch/csrc/decoder_loss_bwd.cu",
                            "carle_tpu/ops/pallas_head.py:1776"),
    "dec2_fwd_em": ("dec2_fwd", "carle_tpu_torch/csrc/dec2_fwd.cu",
                    "carle_tpu/ops/pallas_head.py:1776"),
    "dec2_bwd_em": ("dec2_bwd", "carle_tpu_torch/csrc/dec2_bwd.cu",
                    "carle_tpu/ops/pallas_head.py:1776"),
}
BAND_SIZE = 8192                     # pod_smoke.py's spatial8k universe, one of it
RND_BANDS, PRED_BANDS = 512, 128     # BandTiling(size // 16), BandTiling(size // 64)
SPATIAL_ROWS = ("spatial_ca_step", "spatial_ca_step_words", "spatial_multi_step",
                "spatial_multi_step_bits",
                "bit_spatial_multi_step",
                "bit_spatial_multi_step_static", "bit_spatial_words", "bit_spatial_words_static")
# The whole autoencoder's rows: at AE2D's widths, which every main path uses,
# the kernels specialised for them (ae2d_*) run; the generic instantiation
# (ae_loss_*) takes other widths.  A row's launches count both.
AE_INSTANTIATIONS = {"ae_loss_fwd": ("ae2d_fwd", "ae_loss_fwd"),
                     "ae_loss_bwd": ("ae2d_bwd", "ae_loss_bwd")}
# the kernels each main path must launch
PATH_KERNELS = {
    "battery": ("ca_step_words", "enc3_fwd", "ae2d_fwd"),
    "submission": ("ca_step_words", "enc3_fwd", "ae2d_fwd"),
    "server": ("ca_step_words", "bit_multi_step_words", "enc3_fwd", "ae2d_fwd"),
    "train": ("ca_step_words", "enc3_fwd", "ae2d_fwd", "enc3_bwd", "ae2d_bwd"),
    "routes": ("enc3_fwd", "enc3_bwd", "ae2d_fwd", "ae2d_bwd", "head2_fwd",
               "head2_bwd", "tail2_fwd", "tail2_bwd", "loss_tail2_fwd", "loss_tail2_bwd",
               "dec2_fwd", "dec2_bwd"),
    "wrappers": ("ca_step_words", "enc3_fwd", "enc3_bwd", "ae2d_fwd", "ae2d_bwd",
                 "dec2_fwd", "dec2_bwd", "tail2_fwd"),
    "packed": ("bit_multi_step_words", "enc3_fwd", "enc3_bwd", "ae2d_fwd", "ae2d_bwd",
               "dec2_fwd", "dec2_bwd"),
    "bands": ("bit_multi_step_words", "enc3_fwd", "enc3_bwd", "dec2_fwd", "dec2_bwd"),
    "engines": ("bit_multi_step_words", "bit_multi_step_static_words",
                "bit_multi_step_static_cm_words", "bit_multi_step_cm", "ca_multi_step_bits"),
    "spatial": ("spatial_ca_step_words", "spatial_multi_step_bits", "bit_spatial_words",
                "enc3_fwd", "enc3_bwd", "tail2_fwd", "tail2_bwd"),
    # the env x space mesh: the same kernels, a launch a ring
    "spatial_2d": ("spatial_ca_step_words", "spatial_multi_step_bits", "bit_spatial_words",
                   "enc3_fwd", "enc3_bwd", "tail2_fwd", "tail2_bwd"),
    # the policies: the env step, the frozen RND and AE2D bonuses, and the
    # policy's fused encoder forward and backward at its widths (8, 1, 2, 2)
    "policy": ("ca_step_words", "enc3_fwd", "enc3_bwd", "ae2d_fwd"),
    # pattern I/O, episode artifacts and analysis: the shells' and rollouts'
    # env steps and analysis' generations (ca_step_words), /gif's frames and
    # the soup search's engine (bit_multi_step_words)
    "io": ("ca_step_words", "bit_multi_step_words"),
    # env-batch data parallelism: the env step on rings of one slot (uint8
    # halo_words, packed bit_spatial_words), the nets a launch a slot
    "env_mesh": ("spatial_ca_step_words", "bit_spatial_words", "enc3_fwd", "enc3_bwd",
                 "ae2d_fwd", "ae2d_bwd"),
    # several processes over one mesh (the children's launches): (a) the env
    # step on rings of one slot and the nets a slot at a time, (b) the uint8
    # burst, (c) the packed halo step and the encoder on row shards
    "multiprocess": ("spatial_ca_step_words", "spatial_multi_step_bits", "bit_spatial_words",
                     "enc3_fwd", "enc3_bwd", "ae2d_fwd", "ae2d_bwd"),
    # the compat facade's reference stack on one 256² universe: rows 1, 3a,
    # 3b, 4a and 4b
    "surfaces": ("ca_step_words", "enc3_fwd", "enc3_bwd", "ae2d_fwd", "ae2d_bwd"),
}
# the generic encoder and decoder-loss kernels, which no main path may
# launch: every encoder and decoder of the package has one of the
# specialised kernels' widths
GENERIC_ENCODER = ("encoder_fwd", "encoder_bwd")
GENERIC_DECODER = ("decoder_loss_fwd", "decoder_loss_bwd")
# the generic tail kernels, which no main path may launch: every decoder stage
# of the package has one of the specialised kernels' widths (tail2_*)
GENERIC_TAIL = ("tail_fwd", "tail_bwd")
# the byte ca_step kernel, which no main path may launch: every universe of a
# main path is 256 cells wide, a width the word kernel takes
BYTE_CA_STEP = ("ca_step",)
# the present packed engine (rule as data) and packed halo kernel, which no
# main path may launch: every main path's shape takes the redesigned kernels
# (bit_multi_step_words, bit_spatial_words)
PRESENT_PACKED = ("bit_multi_step", "bit_spatial_multi_step")
# the present fixed-rule packed engines (row- and column-major), the present
# uint8 engine and the generic head kernels, which no main path may launch:
# the engines' shapes take the redesigned kernels (bit_multi_step_static_words,
# bit_multi_step_static_cm_words, ca_multi_step_bits), and every head of the
# package has one of the specialised kernels' widths (head2_fwd, head2_bwd)
PRESENT_STATIC = ("bit_multi_step_static", "bit_multi_step_static_cm", "ca_multi_step")
GENERIC_HEAD = ("head_fwd", "head_bwd")
# the present uint8 halo kernels and the generic loss-tail kernels, which no
# main path may launch: the spatial path's 8-generation burst takes the packed
# temporal-blocking kernel (spatial_multi_step_bits), its one generation and
# the env mode's step halo_words (spatial_ca_step_words), and every loss tail
# of the package has one of the specialised kernels' widths (loss_tail2_*)
PRESENT_U8_HALO = ("spatial_multi_step", "spatial_ca_step")
GENERIC_LOSS_TAIL = ("loss_tail_fwd", "loss_tail_bwd")
# the kernels the packed path must launch on packed words
PACKED_INPUT_KERNELS = ("enc3_fwd", "enc3_bwd", "ae2d_fwd", "ae2d_bwd", "dec2_fwd", "dec2_bwd")
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

    def ms(self, fn, reps: int, warmup: int = 1, flush: bool = True) -> float:
        """``flush=False``: L2-warm, the inputs left in L2 by the warm-up."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            if flush:
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


def u8_bound(cells: int, steps: int, rule_bytes: int = 4):
    """The uint8 engines' least time (rows 12-14): each cell read and written
    once as a byte, and the rule read, against the packed update's
    OPS_PER_WORD operations a word of 32 cells a generation."""
    return bound_ms(2 * cells + rule_bytes, OPS_PER_WORD * cells / 32 * steps, INT32_OPS)


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


def phase_kernels(torch, timer, shipped, philox):
    """Each kernel vs its plain twin at the slice's shapes (philox: a
    draw's operations, philox_draw_ops, for the dropout bounds)."""
    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_ca, cuda_head

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # row 1 on 160 universes of 256² (phase_ca_step); drawn first from the
    # phase's generator, so every later kernel's data is as before
    cfg = EnvConfig(instances=160)
    grid = (torch.rand(cfg.grid_shape, generator=gen, device=dev) < 0.35).to(torch.uint8)
    action = (torch.rand(cfg.action_shape, generator=gen, device=dev) * 8).to(torch.uint8)
    action[action > 3] = 0
    rule_vec = torch.randint(0, 1 << 18, (160,), generator=gen, device=dev,
                             dtype=torch.int32)
    results.update(phase_ca_step(torch, timer, cfg, grid, action, rule_vec))

    # bit_multi_step: 4096 x 256x256 x 128 generations (scalar rule) and
    # 160 universes with a rule vector: the redesigned kernels (the route,
    # bit_multi_step_words) and the present ones forced (BIT_WORDS = False),
    # each bit for bit the plain twin, timed in turns
    steps = 128
    big = bitpack.pack_grid(
        (torch.rand((4096, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8))
    small = big[:160].contiguous()
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=dev)
    mism = 0
    for packed, rule in ((big, life), (small, rule_vec)):
        got = cuda_bitpack.bit_multi_step(packed, rule, steps).to(torch.int64)
        old = _present_packed(lambda: cuda_bitpack.bit_multi_step(packed, rule, steps))
        t0 = time.perf_counter()
        want = cuda_bitpack.bit_multi_step_plain(packed, rule, steps).to(torch.int64)
        torch.cuda.synchronize()
        if packed is big:
            plain_big_ms = (time.perf_counter() - t0) * 1e3
        mism = max(mism, int((got - want).abs().max()),
                   int((old.to(torch.int64) - want).abs().max()))
    check(mism == 0, f"bit_multi_step (new or present kernel) differs from its plain twin: "
          f"max {mism}")
    words = big.numel()
    b, by = bound_ms(2 * 4 * words + 4, OPS_PER_WORD * words * steps, INT32_OPS)
    new_fn = lambda: cuda_bitpack.bit_multi_step(big, life, steps)
    timed = {}
    for route in ("words", "present", "words", "present"):
        timed.setdefault(route, []).append(
            timer.ms(new_fn if route == "words" else lambda: _present_packed(new_fn), 3))
    shape = "u32 [4096,256,8] x 128 generations, scalar rule"
    for row, route in (("bit_multi_step_words", "words"), ("bit_multi_step", "present")):
        results[row] = dict(max_abs_err=float(mism), ms=timed[route][0],
                            ms_in_turns=timed[route], plain_ms=plain_big_ms, bound_ms=b,
                            bound_by=by, library_ms=None, shape=shape)
    results["bit_multi_step_words"]["plan"] = cuda_bitpack.words_plan(
        4096, 256, 8, steps, cuda_ca._multiprocessors(dev))
    results["bit_multi_step_words"]["at_paths"] = _bit_multi_step_at_paths(
        torch, timer, big, rule_vec)
    log(f"bit_multi_step ok: {results['bit_multi_step_words']}")
    log(f"bit_multi_step (present kernel forced) ok: {results['bit_multi_step']}")

    # the encoder's forward (row 3a) and ae_loss_fwd on the battery's
    # observations, shipped weights: the specialised kernels (enc3_fwd) at
    # the three widths, bit for bit the generic kernels (encoder_fwd), both
    # timed in turns
    x = (torch.rand((160, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    rnd, ae = shipped["RND2D"], shipped["AE2D"]
    enc_err, timed = 0.0, {}
    cases = {"rnd": (rnd.params, (4, 2)), "target": (rnd.target_params, (4, 2)),
             "ae": (ae.params, (2, 2))}
    for name, (p, pools) in cases.items():
        w4 = (p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"])
        got = cuda_head.encoder_fwd(x, *w4, pools)
        want = cuda_head.encoder_fwd_plain(x, *w4, pools)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        enc_err = max(enc_err, float((got - want).abs().max()))
        _enc3_held(torch, x, w4, pools, 0.0, 0)
        fwd = lambda: cuda_head.encoder_fwd(x, *w4, pools)
        for route in ("enc3", "generic", "enc3", "generic"):
            timed.setdefault(f"{route} {name}", []).append(
                timer.ms(fwd if route == "enc3" else lambda: _generic_encoder(fwd), 20))
    p = rnd.params
    args = (x, p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"])
    parts = encoder_bound_parts(160, 256, 256, 4, 1, 4, 1, 0, False)
    b, by = _largest(parts)
    plain_ms = timer.ms(lambda: cuda_head.encoder_fwd_plain(*args, (4, 2)), 5)
    shape = "u8 [160,1,256,256], RND predictor (pools 4,2; C1=4, C2=1)"
    for row, route in (("enc3_fwd", "enc3"), ("encoder_fwd", "generic")):
        results[row] = dict(
            max_abs_err=enc_err, ms=timed[f"{route} rnd"][0], plain_ms=plain_ms, bound_ms=b,
            bound_by=by, library_ms=None, bound_parts=parts, shape=shape,
            ms_in_turns={k: v for k, v in timed.items() if k.startswith(route)},
            plan=(cuda_head._enc3_plan(160, 256, 256, 4, 1, 4, False) if route == "enc3"
                  else cuda_head._encoder_fwd_plan(256, 256, 4, 1, 4, 2, None, 160)))
        log(f"{row} ok: {results[row]}")

    q = ae.params
    ae_args = (x, q["conv1"]["w"], q["conv1"]["b"], q["conv2"]["w"], q["conv2"]["b"],
               q["deconv1"]["w"], q["deconv1"]["b"], q["deconv2"]["w"], q["deconv2"]["b"], x)
    got = cuda_head.ae_loss_fwd(*ae_args)
    again = cuda_head.ae_loss_fwd(*ae_args)
    want = cuda_head.ae_loss_fwd_plain(*ae_args)
    check(torch.equal(got, again), "ae_loss_fwd is not deterministic")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    hw = 256 * 256
    b, by = ae_bound(160, hw, 2 * 160 * hw + 160 * 4, 0, backward=False)
    results["ae_loss_fwd"] = dict(
        max_abs_err=float((got - want).abs().max()),
        max_rel_err=float(((got - want).abs() / want.abs()).max()),
        ms=timer.ms(lambda: cuda_head.ae_loss_fwd(*ae_args), 20),
        plain_ms=timer.ms(lambda: cuda_head.ae_loss_fwd_plain(*ae_args), 5),
        bound_ms=b, bound_by=by, library_ms=None,
        shape="u8 src=obs [160,1,256,256], AE2D (C1=4, C2=2, 1, 1)")
    log(f"ae_loss_fwd ok: {results['ae_loss_fwd']}")
    results.update(phase_train_kernels(torch, timer, gen, philox))
    results.update(phase_stage_kernels(torch, timer, gen, philox))
    results.update(phase_engine_kernels(torch, timer))
    phase_packed_input_kernels(torch, timer, gen, results)
    results.update(phase_band_kernels(torch, timer, gen, philox))
    torch.cuda.empty_cache()
    return results


def _present_packed(fn):
    """fn() with the present packed engine and halo kernel forced
    (cuda_bitpack.BIT_WORDS, cuda_halo.BIT_HALO_BLOCKS off)."""
    from carle_tpu_torch.ops import cuda_bitpack
    from carle_tpu_torch.parallel import cuda_halo

    cuda_bitpack.BIT_WORDS = cuda_halo.BIT_HALO_BLOCKS = False
    try:
        return fn()
    finally:
        cuda_bitpack.BIT_WORDS = cuda_halo.BIT_HALO_BLOCKS = True


def _flag_off(module, flag: str, fn):
    """fn() with ``module.flag`` off: the present or generic kernel forced
    (cuda_halo.HALO_U8_BITS, cuda_stages.LOSS_TAIL2_KERNELS)."""
    setattr(module, flag, False)
    try:
        return fn()
    finally:
        setattr(module, flag, True)


def _cupti_us(torch, timer, fn, names, what, cold=True):
    """The device µs a call of ``fn`` spends in kernels whose names hold one
    of ``names``, by CUPTI (torch.profiler), the L2 flushed before each call
    (``cold``) or the calls in a row."""
    call = (lambda: (timer.flush_buf.zero_(), fn())) if cold else fn
    rows = _device_split(torch, call, 20)["by_kernel"]
    us = sum(row["us"] for row in rows if any(k in row["name"] for k in names))
    check(us > 0, f"{what}: no CUPTI time for {names} in {rows}")
    return us


NEW_PACKED_KERNELS = ("bit_stream_kernel", "bit_regs_kernel", "bit_blocks_kernel")
U8_HALO_KERNELS = ("bit_blocks_kernel", "halo_u8_kernel")
PRESENT_PACKED_KERNELS = ("bit_multi_step_resident", "bit_step_global", "bit_halo_kernel")


def _bit_multi_step_at_paths(torch, timer, big, rule_vec):
    """Row 2 at the shapes the main paths launch it: one generation a step
    of the packed carry (train-64, the packed stack on 160 universes, the
    bands' universe of 8192²), the server's /rollout (one universe of 256²,
    256 generations) and the engines (bench.py's 4096 x 256², 128
    generations): the redesigned kernels (the route) and the present ones
    forced, bit for bit the same (and the twin's below the engines), each
    call's launches, device ms after an L2 flush in turns (new, present,
    new, present) and each kernel's own CUPTI µs cold (L2 flushed), against
    the bound; the plans and their registers and blocks a multiprocessor."""
    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_build, cuda_ca

    gen = torch.Generator(device="cuda").manual_seed(11)
    band = bitpack.pack_grid((torch.rand((1, 8192, 8192), generator=gen, device="cuda")
                              < 0.2).to(torch.uint8))
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device="cuda")
    sms = cuda_ca._multiprocessors(big.device)
    shapes = {"packed train [64,256,8] x 1": (big[:64].contiguous(), rule_vec[:64], 1),
              "packed stack [160,256,8] x 1": (big[:160].contiguous(), rule_vec, 1),
              "bands [1,8192,256] x 1": (band, life, 1),
              "server /rollout [1,256,8] x 256": (big[:1].contiguous(), life, 256),
              "engines [4096,256,8] x 128": (big, life, 128)}
    out = {}
    for label, (words, rule, steps) in shapes.items():
        new = lambda: cuda_bitpack.bit_multi_step(words, rule, steps)
        old = lambda: _present_packed(new)
        entry = {}
        for name, fn, kernel in (("new", new, cuda_bitpack.KERNEL_WORDS),
                                 ("present", old, cuda_bitpack.KERNEL)):
            before = kernel.launches
            got = fn()
            entry[f"{name}_launches_per_call"] = kernel.launches - before
            check(entry[f"{name}_launches_per_call"] >= 1, f"row 2 {label}: {name} launched none")
            if name == "new":
                first = got
            else:
                check(torch.equal(first, got), f"row 2 {label}: new and present kernels differ")
        if steps < 128:
            check(torch.equal(first.to(torch.int64), cuda_bitpack.bit_multi_step_plain(
                words, rule, steps).to(torch.int64)), f"row 2 {label}: differs from the twin")
        b, by = bound_ms(2 * 4 * words.numel() + 4 * rule.numel(),
                         OPS_PER_WORD * words.numel() * steps, INT32_OPS)
        reps = 5 if steps == 128 else 30
        for route in ("new", "present", "new", "present"):
            entry.setdefault(f"{route}_ms", []).append(timer.ms(new if route == "new" else old,
                                                                reps))
        if steps < 128:
            entry["new_cupti_cold_us"] = _cupti_us(torch, timer, new, NEW_PACKED_KERNELS, label)
            entry["present_cupti_cold_us"] = _cupti_us(torch, timer, old,
                                                       PRESENT_PACKED_KERNELS, label)
        plan = cuda_bitpack.words_plan(*words.shape, steps, sms)
        if plan[0] == "stream":
            args = (0, plan[1], 1, 1, 1, 1, plan[3])
        else:
            args = (1, *plan[1:])
        entry.update(plan=plan, occupancy=_occupancy(cuda_build, "bit_multi_step",
                                                     "bit_words_occupancy", *args)[0],
                     bound_ms=b, bound_by=by, bound_ms_per_launch=b / entry[
                         "new_launches_per_call"])
        out[label] = entry
        log(f"row 2 at {label}: {json.dumps(entry)}")
    return out


def _ca_step_bound(n, h, w, ah, aw, reset=False):
    """Row 1's least time: each cell read once and written once, the action
    window and the rules read once (under the reset only the zeros written),
    against the packed engine's operations a cell (the least any update
    needs)."""
    nbytes = n * h * w if reset else 2 * n * h * w + n * ah * aw + 4 * n
    return bound_ms(nbytes, 0 if reset else n * h * w * OPS_PER_WORD / 32, INT32_OPS)


def phase_ca_step(torch, timer, cfg160, grid160, action160, rule160):
    """Row 1: the word kernel (ca_step_words, every main path's at 256²)
    against its twin and the byte kernel forced (cuda_ca.CA_STEP_WORDS =
    False), bit for bit, at [1], [64] and [160] x 256² and a ragged shape,
    valued actions (0, 1, 2, 128, 255), scalar and per-universe rules, the
    master reset unset and set; then both timed in turns after an L2 flush
    and L2-warm, the reset set, each kernel's own device time by CUPTI after
    an L2 flush and L2-warm, and the plans' registers and blocks a
    multiprocessor."""
    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.ops import cuda_build, cuda_ca

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    values = torch.tensor([0, 1, 2, 128, 255], dtype=torch.uint8, device=dev)

    def case(cfg):
        g = (torch.rand(cfg.grid_shape, generator=gen, device=dev) < 0.35).to(torch.uint8)
        pick = torch.randint(0, 5, cfg.action_shape, generator=gen, device=dev)
        a = torch.where(torch.rand(cfg.action_shape, generator=gen, device=dev) < 0.5,
                        values[pick], values[0])
        r = torch.randint(0, 1 << 18, (cfg.instances,), generator=gen, device=dev,
                          dtype=torch.int32)
        return g, a.contiguous(), r

    def forced_bytes(fn):
        cuda_ca.CA_STEP_WORDS = False
        try:
            return fn()
        finally:
            cuda_ca.CA_STEP_WORDS = True

    cases = {n: (EnvConfig(instances=n), *case(EnvConfig(instances=n))) for n in (1, 64)}
    cases[160] = (cfg160, grid160, action160, rule160)
    ragged = EnvConfig(height=250, width=208, action_height=62, action_width=62, instances=3)
    cases["ragged"] = (ragged, *case(ragged))   # H not a multiple of a band, c0 = 73
    odd = EnvConfig(height=23, width=37, action_height=8, action_width=9, instances=3)
    flags = {"none": None, "unset": torch.tensor(False, device=dev),
             "set": torch.tensor(True, device=dev)}
    check(cuda_ca.ca_step_route(256, 256) == "words" and cuda_ca.ca_step_route(23, 37) == "bytes",
          "ca_step routes")
    for label, (cfg, g, a, r) in list(cases.items()) + [("odd", (odd, *case(odd)))]:
        for rule in (torch.tensor(rules.MORLEY, dtype=torch.int32, device=dev), r):
            for flag in flags.values():
                want = cuda_ca.ca_step_plain(g, a, rule, cfg, flag)
                got = cuda_ca.ca_step(g, a, rule, cfg, flag)
                byte = forced_bytes(lambda: cuda_ca.ca_step(g, a, rule, cfg, flag))
                check(torch.equal(got, want) and torch.equal(byte, want),
                      f"ca_step {label}: kernel, byte kernel and twin differ")
                check(bool(want.any()) == (flag is None or not bool(flag)),
                      f"ca_step {label}: the reset")
    log("ca_step: word kernel, byte kernel and twin agree bit for bit at [1], [64], "
        "[160] x 256², [3, 250, 208] and [3, 23, 37] (the byte kernel's), reset none/unset/set")

    sms = cuda_ca._multiprocessors(dev)
    timed = {}
    for label, (cfg, g, a, r) in cases.items():
        n, h, w = cfg.grid_shape
        ah, aw = cfg.eff_action_height, cfg.eff_action_width
        unset, on = flags["unset"], flags["set"]
        words = lambda: cuda_ca.ca_step(g, a, r, cfg, unset)
        byte = lambda: forced_bytes(lambda: cuda_ca.ca_step(g, a, r, cfg, unset))
        entry = {"shape": f"u8 [{n},{h},{w}], action [{n},{ah},{aw}], rule [{n}]",
                 "plan": cuda_ca.words_plan(n, h, w, sms)}
        for flush in (True, False):
            tag = "flushed" if flush else "l2_warm"
            reps = 50 if flush else 100
            for route in ("words", "bytes", "words", "bytes"):   # in turns
                entry.setdefault(f"{route}_{tag}_ms", []).append(
                    timer.ms(words if route == "words" else byte, reps, flush=flush))
        entry["words_reset_ms"] = timer.ms(lambda: cuda_ca.ca_step(g, a, r, cfg, on), 50)
        entry["bytes_reset_ms"] = timer.ms(
            lambda: forced_bytes(lambda: cuda_ca.ca_step(g, a, r, cfg, on)), 50)
        entry["bound_ms"], entry["bound_by"] = _ca_step_bound(n, h, w, ah, aw)
        entry["reset_bound_ms"] = _ca_step_bound(n, h, w, ah, aw, True)[0]
        entry["plain_ms"] = timer.ms(lambda: cuda_ca.ca_step_plain(g, a, r, cfg, unset), 5)
        # a copy of the grid moves the same bytes: the yardstick of this timer
        copy = lambda: torch.empty_like(g).copy_(g)
        entry["copy_flushed_ms"] = timer.ms(copy, 50)
        entry["copy_l2_warm_ms"] = timer.ms(copy, 100, flush=False)
        # each kernel's own device time by CUPTI, cold (the L2 flushed before
        # each call, as the bound assumes) and L2-warm (the calls in a row)
        for name, fn, kernels in (("words", words, ("ca_step_words_kernel",)),
                                  ("bytes", byte, ("ca_step_kernel",)),
                                  ("copy", copy, ("Memcpy", "copy_kernel"))):
            for tag, call in (("cold", lambda: (timer.flush_buf.zero_(), fn())),
                              ("l2_warm", fn)):
                rows = _device_split(torch, call, 20)["by_kernel"]
                us = sum(row["us"] for row in rows if any(k in row["name"] for k in kernels))
                check(us > 0, f"ca_step [{label}]: no CUPTI time for {name} in {rows}")
                entry[f"{name}_cupti_{tag}_us"] = us
        timed[label] = entry
        log(f"ca_step [{label}]: {json.dumps(entry)}")
    occupancy = {}
    for plan in sorted({cuda_ca.words_plan(*cases[n][0].grid_shape, sms) for n in (1, 64, 160)}):
        band, _, threads = plan
        smem = cuda_ca._BAR_BYTES + (band + 2) * 256
        occupancy[str(plan)] = dict(_occupancy(
            cuda_build, "ca_step", "ca_step_words_occupancy", threads, Big(smem))[0],
            dynamic_smem=smem)
    log(f"ca_step_words occupancy (W = 256): {json.dumps(occupancy)}")
    main = timed[160]
    common = dict(max_abs_err=0.0, plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                  bound_by=main["bound_by"], library_ms=None, shape=main["shape"])
    return {"ca_step_words": dict(common, ms=main["words_flushed_ms"][0], by_shape=timed,
                                  occupancy=occupancy),
            "ca_step": dict(common, ms=main["bytes_flushed_ms"][0])}


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
    battery's 5 rulesets dealt over the universes), bit for bit; rows 10,
    11a and 12 by their redesigned kernels and the present ones forced
    (_ab_at_engines)."""
    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_build, cuda_ca

    grid = _bench_grid(torch)
    n, size, steps = BENCH_UNIVERSES, BENCH_SIZE, BENCH_STEPS
    rm, cm = bitpack.pack_grid(grid), bitpack.pack_grid_cm(grid)
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device="cuda")
    vec = torch.tensor([rules.pack_rule_bits(*BATTERY_RULESETS[i % 5]) for i in range(n)],
                       dtype=torch.int32, device="cuda")
    words, cells = rm.numel(), grid.numel()
    sms = cuda_ca._multiprocessors(grid.device)
    fixed = ([3], [2, 3])
    defines = cuda_bitpack._static_define(*fixed)
    results = {}

    # row 10: the row-major fixed-rule engine (bit_multi_step_static_words)
    new = lambda: cuda_bitpack.bit_multi_step_static(rm, *fixed, steps)
    plan = cuda_bitpack.words_plan(*rm.shape, steps, sms, True, True)
    rows = _ab_at_engines(
        torch, timer, "row 10", new, lambda new=new: _present_packed(new),
        (cuda_bitpack.KERNEL_STATIC_WORDS, cuda_bitpack.KERNEL_STATIC),
        ("bit_regs_kernel", "bit_multi_step_resident"),
        lambda: cuda_bitpack.bit_multi_step_static_plain(rm, *fixed, steps),
        bound_ms(2 * 4 * words, OPS_PER_WORD_STATIC * words * steps, INT32_OPS),
        "u32 [4096,256,8] x 128, Life fixed", plan,
        _occupancy(cuda_build, "bit_multi_step", "bit_static_words_occupancy", 1, *plan[1:],
                   defines=defines)[0])
    results["bit_multi_step_static_words"], results["bit_multi_step_static"] = rows

    # row 11a: the column-major fixed-rule engine (bit_multi_step_static_cm_words)
    new = lambda: cuda_bitpack.bit_multi_step_static_cm(cm, *fixed, steps)
    plan = cuda_bitpack.cm_plan(*cm.shape, steps)
    rows = _ab_at_engines(
        torch, timer, "row 11a", new, lambda new=new: _present_packed(new),
        (cuda_bitpack.KERNEL_STATIC_CM_WORDS, cuda_bitpack.KERNEL_STATIC_CM),
        ("bit_cm_regs_kernel", "bit_multi_step_resident"),
        lambda: cuda_bitpack.bit_multi_step_static_cm_plain(cm, *fixed, steps),
        bound_ms(2 * 4 * words, OPS_PER_WORD_STATIC_CM * words * steps, INT32_OPS),
        "u32 column-major [4096,8,256] x 128, Life fixed", plan,
        _occupancy(cuda_build, "bit_multi_step", "bit_static_cm_words_occupancy", *plan[1:],
                   defines=defines)[0])
    results["bit_multi_step_static_cm_words"], results["bit_multi_step_static_cm"] = rows

    # row 12: the uint8 engine on packed bits (ca_multi_step_bits), Life and
    # the battery's rulesets as data on the card
    for label, rule in (("life", life), ("rule vector", vec)):
        new = lambda rule=rule: cuda_ca.ca_multi_step(grid, rule, steps)
        plan = cuda_ca.bits_plan(*grid.shape, steps)
        rows = _ab_at_engines(
            torch, timer, f"row 12 ({label})", new, lambda new=new: _present_u8(new),
            (cuda_ca.KERNEL_BITS, cuda_ca.KERNEL_MULTI),
            ("ca_bits_kernel", "ca_multi_step_resident"),
            lambda rule=rule: cuda_ca.ca_multi_step_plain(grid, rule, steps),
            u8_bound(cells, steps, 4 * rule.numel()), f"u8 [4096,256,256] x 128, {label}",
            plan, _occupancy(cuda_build, "ca_multi_step", "ca_bits_occupancy", *plan[1:])[0])
        if label == "life":
            results["ca_multi_step_bits"], results["ca_multi_step"] = rows
            results["ca_multi_step"]["present_ops_bound_ms"] = bound_ms(
                2 * cells + 4, OPS_PER_U8_WORD * cells // 4 * steps, INT32_OPS)[0]
        else:
            for row, r in zip(("ca_multi_step_bits", "ca_multi_step"), rows):
                results[row].update(ms_rule_vector=r["ms"], ms_runs_rule_vector=r["ms_runs"],
                                    cupti_cold_us_rule_vector=r["cupti_cold_us"])

    # row 11b: the column-major engine with the rule as data (the present kernel)
    def held(name, kernel_fn, plain_fn):
        got = kernel_fn()
        want, plain = _plain_ms(torch, plain_fn)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0, f"{name} differs from its plain twin: max {err}")
        return plain

    kfn = lambda: cuda_bitpack.bit_multi_step_cm(cm, life, steps)
    plain = held("bit_multi_step_cm", kfn,
                 lambda: cuda_bitpack.bit_multi_step_cm_plain(cm, life, steps))
    held("bit_multi_step_cm (rule vector)", lambda: cuda_bitpack.bit_multi_step_cm(cm, vec, steps),
         lambda: cuda_bitpack.bit_multi_step_cm_plain(cm, vec, steps))
    b, by = bound_ms(2 * 4 * words + 4, OPS_PER_WORD_CM * words * steps, INT32_OPS)
    results["bit_multi_step_cm"] = dict(
        max_abs_err=0.0, ms=timer.ms(kfn, 3), plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None, shape="u32 column-major [4096,8,256] x 128, Life as data",
        ms_rule_vector=timer.ms(lambda: cuda_bitpack.bit_multi_step_cm(cm, vec, steps), 3))
    for row in ("bit_multi_step_static_words", "bit_multi_step_static",
                "bit_multi_step_static_cm_words", "bit_multi_step_static_cm",
                "ca_multi_step_bits", "ca_multi_step", "bit_multi_step_cm"):
        log(f"{row} at engines: {json.dumps(results[row])}")
    return results


def _present_u8(fn):
    """fn() with the present uint8 engine forced (cuda_ca.CA_MULTI_BITS off)."""
    from carle_tpu_torch.ops import cuda_ca

    cuda_ca.CA_MULTI_BITS = False
    try:
        return fn()
    finally:
        cuda_ca.CA_MULTI_BITS = True


def _in_turns(timer, fns: dict, rounds: int = 2, reps: int = 3) -> dict:
    """{name: [ms of each round]}: each of ``fns`` timed (``reps`` calls after
    an L2 flush, timer.ms) in turns, ``rounds`` times over (a, b, a, b)."""
    ms = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            ms[name].append(timer.ms(fn, reps))
    return ms


def _ab_at_engines(torch, timer, what, new, old, kernels, cupti, plain, bound, shape, plan,
                   occupancy):
    """A row at bench.py's geometry (4096 x 256², 128 generations) through
    _ab_cases: its redesigned kernel (``new``, the route) and the present
    kernel forced (``old``), one launch a call each (``kernels``), bit for
    bit the same and the twin's (``plain``), timed in turns and by CUPTI
    cold (``cupti``: the two kernels' names); (the new row, the present
    row), each with the plan and occupancy of the new kernel."""
    plain_ms = []

    def hold(label, got, present):
        check(torch.equal(got, present), f"{what}: new and present kernels differ")
        want, ms = _plain_ms(torch, plain)
        plain_ms.append(ms)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0, f"{what} differs from its plain twin: max {err}")
        return {"new": {"max_abs_err": 0.0}, "generic": {"max_abs_err": 0.0}}

    out = _ab_cases(torch, timer, what, {shape: (new, old)}, kernels,
                    {"new": (cupti[0],), "generic": (cupti[1],)}, hold, lambda label: bound,
                    lambda label: dict(plan=plan, **occupancy))
    rows = _ab_rows(out, ("new", "present"), plain_ms[0], "the present kernel")
    rows["new"].update(plan=plan, occupancy=occupancy)
    return rows["new"], rows["present"]


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
        "enc3_fwd": lambda src, obs, p: ch.encoder_fwd(src, *enc, (4, 2), p, seed),
        "enc3_bwd": lambda src, obs, p: ch.encoder_bwd(src, *enc, g_enc, (4, 2), p, seed),
        "ae_loss_fwd": lambda src, obs, p: ch.ae_loss_fwd(src, *ps, obs, (2, 2), p, seed),
        "ae_loss_bwd": lambda src, obs, p: ch.ae_loss_bwd(src, *ps, obs, gbar, (2, 2), p, seed),
        "dec2_fwd": lambda src, obs, p: cs.decoder_loss_fwd(emb[64], *ps[4:], obs, p, seed),
        "dec2_bwd": lambda src, obs, p: cs.decoder_loss_bwd(emb[64], *ps[4:], obs, gbar, p,
                                                           seed),
        "head2_fwd": lambda src, obs, p: cs.head_fwd(src, ps[0], ps[1], 2, p, seed),
        "head_bwd": lambda src, obs, p: cs.head_bwd(src, ps[0], ps[1], g_head, 2, p, seed),
        "loss_tail_fwd": lambda src, obs, p: cs.loss_tail_fwd(mid[64], ps[6], ps[7], obs,
                                                             "sigmoid", p, seed),
        "loss_tail2_bwd": lambda src, obs, p: cs.loss_tail_bwd(mid[64], ps[6], ps[7], obs, gbar,
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
        "enc3_fwd": lambda: ch.encoder_fwd(x32[160], *enc, (4, 2)),
        "encoder_fwd": lambda: _generic_encoder(lambda: ch.encoder_fwd(x32[160], *enc, (4, 2))),
        "ae_loss_fwd": lambda: ch.ae_loss_fwd(x32[160], *ps, x32[160]),
        "enc3_bwd": lambda: ch.encoder_bwd(x32[64], *enc, g_enc, (4, 2), DROP_P, seed),
        "encoder_bwd": lambda: _generic_encoder(
            lambda: ch.encoder_bwd(x32[64], *enc, g_enc, (4, 2), DROP_P, seed)),
        "ae_loss_bwd": lambda: ch.ae_loss_bwd(x32[64], *ps, x32[64], gbar, (2, 2), DROP_P, seed),
        "dec2_fwd": lambda: cs.decoder_loss_fwd(emb[160], *ps[4:], o32[160]),
        "decoder_loss_fwd": lambda: _generic_decoder(
            lambda: cs.decoder_loss_fwd(emb[160], *ps[4:], o32[160])),
        "dec2_bwd": lambda: cs.decoder_loss_bwd(emb[64], *ps[4:], o32[64], gbar, DROP_P, seed),
        "decoder_loss_bwd": lambda: _generic_decoder(
            lambda: cs.decoder_loss_bwd(emb[64], *ps[4:], o32[64], gbar, DROP_P, seed)),
        "head2_fwd": lambda: cs.head_fwd(x32[160], ps[0], ps[1], 2),
        "head_fwd": lambda: _generic_head(lambda: cs.head_fwd(x32[160], ps[0], ps[1], 2)),
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


def phase_train_kernels(torch, timer, gen, philox):
    """The backward kernels and the dropout forwards vs their twins at the
    training path's shapes: 64 universes of 256 x 256, fresh parameters."""
    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.mcl.rnd import init_predictor_params, init_random_network_params
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
    drop["ae_loss_fwd_bound_ms"] = ae_bound(n, hw, 2 * n * hw + n * 4, philox["ops"],
                                            backward=False)
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

    # the encoder's backward (row 3b), RND predictor (pools 4,2; C1=4, C2=1):
    # the specialised kernels (enc3_bwd) against the twin and the generic
    # kernels (encoder_bwd), the saving forward's bits; then the three widths
    # timed in turns: the gradients alone (the saving forward and the
    # backward), from the saved bits (a training step's backward) and the
    # generic kernels
    errs = {}
    for p in (0.0, DROP_P):
        got = cuda_head.encoder_bwd(*enc_args, g, (4, 2), p, seed)
        want = cuda_head.encoder_bwd_plain(*enc_args, g, (4, 2), p, seed)
        errs[p] = _leaf_errors(got, want)
        check(max(errs[p]) < tol, f"encoder_bwd (drop {p}) leaves differ: {errs[p]}")
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        errs[f"vs generic {p}"] = _enc3_held(torch, x, enc_args[1:], (4, 2), p, seed, g=g)
    gen3 = torch.Generator(device=dev).manual_seed(3)   # gen's draws stay the parent's
    nets3 = {"rnd": (enc_args[1:], (4, 2)),
             "target": (tuple(init_random_network_params(EnvConfig(), gen3, dev)[k][t]
                              for k in ("conv1", "conv2") for t in ("w", "b")), (4, 2)),
             "ae": (ae_args[1:5], (2, 2))}
    timed = {}
    for name, (w4, pools) in nets3.items():
        gg = torch.randn(cuda_head.encoder_fwd(x, *w4, pools).shape, generator=gen3, device=dev)
        if name != "rnd":
            _enc3_held(torch, x, w4, pools, DROP_P, seed, g=gg)
        saved = cuda_head._encoder_fwd_launch(x, w4, pools, DROP_P, seed, None, True)[1]
        calls = {
            "enc3": lambda: cuda_head.encoder_bwd(x, *w4, gg, pools, DROP_P, seed),
            "enc3 from saved": lambda: cuda_head._enc3_bwd_kernel(x, w4, gg, pools, DROP_P,
                                                                  None, saved),
            "enc3 saving fwd": lambda: cuda_head._encoder_fwd_launch(x, w4, pools, DROP_P, seed,
                                                                     None, True),
            "generic": lambda: _generic_encoder(
                lambda: cuda_head.encoder_bwd(x, *w4, gg, pools, DROP_P, seed)),
            "generic fwd": lambda: _generic_encoder(
                lambda: cuda_head.encoder_fwd(x, *w4, pools, DROP_P, seed)),
        }
        for _ in range(2):
            for route, fn in calls.items():
                timed.setdefault(f"{route} {name}", []).append(timer.ms(fn, 10))
    c1, c2 = 4, 1
    plain_ms = timer.ms(lambda: cuda_head.encoder_bwd_plain(*enc_args, g, (4, 2), DROP_P, seed),
                        2)
    # the gradients alone draw as the forward does; from the saved bits no
    # draw, the bits read instead
    parts = encoder_bound_parts(n, h, w, c1, c2, 4, 1, philox["ops"], True)
    parts_saved = encoder_bound_parts(n, h, w, c1, c2, 4, 1, 0, True, saved=True)
    shape = "u8 [64,1,256,256], g [64,1,32,32], RND predictor, drop 0.1"
    for row, route in (("enc3_bwd", "enc3"), ("encoder_bwd", "generic")):
        b, by = _largest(parts)
        results[row] = dict(
            max_abs_err=abs_err, max_leaf_rel_err=max(errs[DROP_P]),
            max_leaf_rel_err_no_drop=max(errs[0.0]),
            max_leaf_rel_err_vs_generic=max(errs[f"vs generic {p}"] for p in (0.0, DROP_P)),
            ms=timed[f"{route} rnd"][0], plain_ms=plain_ms, bound_ms=b, bound_by=by,
            library_ms=None, bound_parts=parts, shape=shape,
            ms_in_turns={k: v for k, v in timed.items() if k.startswith(route)})
    results["enc3_bwd"].update(
        ms_from_saved=timed["enc3 from saved rnd"][0],
        bound_ms_from_saved=_largest(parts_saved)[0], bound_parts_from_saved=parts_saved)
    log(f"enc3_bwd ok: {results['enc3_bwd']}")
    log(f"encoder_bwd (generic) ok: {results['encoder_bwd']}")

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
    # forward recompute, then dW of all four layers and the cotangents of
    # three (the cells take none), and with dropout the draws
    b, by = ae_bound(n, hw, 2 * n * hw + n * 4 + 164 * 4, philox["ops"], backward=True)
    results["ae_loss_bwd"] = dict(
        max_abs_err=abs_err, max_leaf_rel_err=max(errs[DROP_P]),
        max_leaf_rel_err_no_drop=max(errs[0.0]),
        ms=timer.ms(lambda: cuda_head.ae_loss_bwd(*ae_args, gbar, (2, 2), DROP_P, seed), 10),
        ms_no_drop=timer.ms(lambda: cuda_head.ae_loss_bwd(*ae_args, gbar, (2, 2)), 10),
        plain_ms=timer.ms(
            lambda: cuda_head.ae_loss_bwd_plain(*ae_args, gbar, (2, 2), DROP_P, seed), 2),
        bound_ms=b, bound_by=by, library_ms=None,
        shape="u8 src=obs [64,1,256,256], gbar [64], AE2D, drop 0.1")
    # the training step's backward: from what its forward saved (ms above:
    # the gradients alone, which run that forward first)
    saved = cuda_head._ae_fwd_launch(x, ae_args[1:9], x, (2, 2), DROP_P, seed, True)[1]
    results["ae_loss_bwd"]["ms_from_saved"] = timer.ms(
        lambda: cuda_head._ae2d_bwd_kernel(x, ae_args[1:9], x, gbar, DROP_P, saved), 10)
    log(f"ae_loss_bwd ok: {results['ae_loss_bwd']}")
    return results


def _bits_twice(fn, what):
    """fn() twice: the same bits, returned once."""
    first, again = fn(), fn()
    check(all(bool((a == b).all()) for a, b in zip(first, again) if a is not None),
          f"{what} is not the same bit for bit from run to run")
    return first


LOSS_TAIL_FWD_KERNELS = {"new": ("loss_tail2_fwd_kernel", "row_sums_kernel"),
                         "generic": ("tail_fwd_kernel", "row_sums_kernel")}
HEAD_FWD_KERNELS = {"new": ("head2_fwd_",), "generic": ("head_fwd_kernel",)}
LOSS_TAIL_BWD_KERNELS = {"new": ("tail2_bwd_kernel", "column_sums_kernel"),
                         "generic": ("tail_bwd_kernel", "column_sums_kernel")}


def _ab_cases(torch, timer, what, cases, kernels, cupti, hold, bound, occupancy):
    """A redesigned row at each of its timed shapes (``cases``: label ->
    (call on the route, call with the generic kernel forced)): one launch a
    call of the new kernel on the route and of the generic one forced, none
    of the other (``kernels``: their counts), each the same bits twice,
    ``hold(label, new, generic)`` their checks against each other and the
    twin ({route: entry}, each with its own max_abs_err against the twin),
    then every call timed in turns after an L2 flush (new, generic, ...
    twice over) and each by CUPTI cold (``cupti``: route -> kernel names),
    beside ``bound(label)`` = (ms, by) and its share, and
    ``occupancy(label)``.  Returns {label: {route: entry}}."""
    out, fns = {}, {}
    for label, (new, old) in cases.items():
        got = {}
        for route, fn, want in (("new", new, (1, 0)), ("generic", old, (0, 1))):
            before = kernels[0].launches, kernels[1].launches
            got[route] = fn()
            made = kernels[0].launches - before[0], kernels[1].launches - before[1]
            check(made == want, f"{what} ({label}, {route}): launches of {kernels[0].name}, "
                  f"{kernels[1].name} {made}, not {want}")
            check(_same_bits(got[route], fn()), f"{what} ({label}, {route}) is not the same "
                  "bits twice")
        out[label] = hold(label, got["new"], got["generic"])
        out[label]["new"]["occupancy"] = occupancy(label)
        fns[("new", label)], fns[("generic", label)] = new, old
    turns = _in_turns(timer, fns, reps=10)
    for (route, label), runs in turns.items():
        b, by = bound(label)
        us = _cupti_us(torch, timer, fns[(route, label)], cupti[route], f"{what} {route} {label}")
        out[label][route].update(ms=sum(runs) / len(runs), ms_runs=runs, cupti_cold_us=us,
                                 bound_ms=b, bound_by=by, cold_share_of_bound=b / (us / 1e3),
                                 launches_per_call=1)
    log(f"{what} at its shapes: {json.dumps(out)}")
    return out


def _ab_rows(out, names, plain_ms, forced="the generic kernel"):
    """The kernel-table rows (new, ``forced``) of an _ab_cases result: times
    at its first case, each route's own largest error against the twin over
    every case."""
    first = next(iter(out))
    rows = {}
    for name, route in zip(names, ("new", "generic")):
        r = out[first][route]
        rows[name] = dict(max_abs_err=max(c[route]["max_abs_err"] for c in out.values()),
                          ms=r["ms"], ms_runs=r["ms_runs"], cupti_cold_us=r["cupti_cold_us"],
                          plain_ms=plain_ms, bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          library_ms=None, shape=first if route == "new" else
                          f"{first} ({forced} forced)", cases={k: v[route] for k, v in out.items()})
    return rows


def _drop_bound(nbytes, draws, p, philox):
    """(ms, by) of a kernel that moves ``nbytes`` and, with dropout (p > 0),
    draws ``draws`` Philox values: the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_draws = draws * philox["ops"] / INT32_OPS * 1e3 if p > 0 else 0.0
    return (t_bytes, "bytes") if t_bytes >= t_draws else (t_draws, "operations")


def _loss_tail2_fwd_held(torch, timer, cases, seed, philox, close):
    """Row 8a at its timed shapes (``cases``: label -> (x, wt, b, obs,
    drop_p), sigmoid): the specialised forward (loss_tail2_fwd, the route)
    against the generic kernel forced (cuda_stages.LOSS_TAIL2_KERNELS off)
    within rtol 1e-5, each against the twin (1e-4, atol 1e-3); timed in
    turns and by CUPTI cold (_ab_cases) against its bound: x, obs read once,
    the error written once, against 11 float32 operations an output
    position; at least two blocks a multiprocessor.  Returns the rows
    loss_tail2_fwd and loss_tail_fwd (the generic forced)."""
    from carle_tpu_torch.ops import cuda_build, cuda_stages as cs

    sms = cs._multiprocessors(torch.device("cuda"))
    call = lambda a: cs.loss_tail_fwd(*a[:4], "sigmoid", a[4], seed)
    calls = {label: (lambda a=a: call(a),
                     lambda a=a: _flag_off(cs, "LOSS_TAIL2_KERNELS", lambda: call(a)))
             for label, a in cases.items()}

    def hold(label, got, old):
        x, wt, b, obs, p = cases[label]
        close(got, old, f"loss_tail2_fwd vs the generic ({label})", rtol=1e-5, atol=0)
        twin = cs.loss_tail_fwd_plain(x, wt, b, obs, "sigmoid", p, seed)
        return {"new": {"max_abs_err": close(got, twin, f"loss_tail2_fwd ({label})", atol=1e-3),
                        "max_rel_err_vs_generic": float(((got - old).abs() / old.abs()).max())},
                "generic": {"max_abs_err": close(old, twin, f"loss_tail_fwd ({label})",
                                                 atol=1e-3)}}

    def bound(label):
        x, wt, b, obs, p = cases[label]
        taps = 2 * 4 * 1 * 1   # flops an output position: 2 x 2 inputs a channel pair
        nbytes = (x.numel() * 4 + obs.numel() * obs.element_size() + x.shape[0] * 4
                  + (wt.numel() + b.numel()) * 4)
        by_ops = bound_ms(nbytes, (taps + 3) * obs.shape[0] * 4 * x.shape[2] * x.shape[3],
                          FP32_FLOPS)
        return max(by_ops, _drop_bound(0, 4 * x.numel(), p, philox))

    def occupancy(label):
        x, wt, b, obs, p = cases[label]
        n, _, h, w = x.shape
        ri, tj, _ = cs._tail2_plan(n, 1, h, w, False, sms)
        kind = cs.cell_kind(obs)
        smem = cs._loss_tail2_smem(kind, 1, w, ri, tj)
        occ = _occupancy(cuda_build, "loss_tail2_fwd", "loss_tail2_fwd_occupancy", 1, 1,
                         int(p > 0), kind, Big(smem))[0]
        check(occ["blocks_per_sm"] >= 2, f"loss_tail2_fwd ({label}) keeps fewer than two "
              f"blocks a multiprocessor: {occ}")
        return dict(plan=(ri, tj), smem=smem, **occ)

    out = _ab_cases(torch, timer, "loss_tail2_fwd", calls, (cs.LOSS_TAIL2_FWD, cs.LOSS_TAIL_FWD),
                    LOSS_TAIL_FWD_KERNELS, hold, bound, occupancy)
    x, wt, b, obs, p = next(iter(cases.values()))
    plain_ms = timer.ms(lambda: cs.loss_tail_fwd_plain(x, wt, b, obs, "sigmoid", p, seed), 5)
    return _ab_rows(out, ("loss_tail2_fwd", "loss_tail_fwd"), plain_ms)


def _head2_fwd_held(torch, timer, cases, seed, philox):
    """Row 9a at its timed shapes (``cases``: label -> (x, w, b, pool, stage,
    drop_p)): the specialised forward (head2_fwd, the route) against the
    generic kernel forced (cuda_stages.HEAD2_KERNELS off) bit for bit, and
    within 1e-5 of the twin's largest entry; timed in turns and by CUPTI cold
    (_ab_cases) against its bound: bytes (x read once, the output written
    once), with dropout the larger of those and a Philox draw a pixel.
    Returns the rows head2_fwd and head_fwd (the generic forced)."""
    from carle_tpu_torch.ops import cuda_build, cuda_head, cuda_stages as cs

    sms = cs._multiprocessors(torch.device("cuda"))
    calls = {label: (lambda a=(x, w, b, pool, p, seed, stage): cs.head_fwd(*a),
                     lambda a=(x, w, b, pool, p, seed, stage): _generic_head(
                         lambda: cs.head_fwd(*a)))
             for label, (x, w, b, pool, stage, p) in cases.items()}

    def hold(label, got, old):
        x, w, b, pool, stage, p = cases[label]
        check(torch.equal(got, old), f"head2_fwd ({label}) differs from the generic kernel")
        twin = cs.head_fwd_plain(x, w, b, pool, p, seed, stage)
        rel = float((got - twin).abs().max() / twin.abs().max())
        check(rel < 1e-5, f"head2_fwd ({label}) differs from its twin: {rel}")
        return {"new": {"max_abs_err": float((got - twin).abs().max()),
                        "max_rel_err_vs_plain": rel, "bit_equal_generic": True},
                "generic": {"max_abs_err": float((old - twin).abs().max())}}

    def bound(label):
        x, w, b, pool, stage, p = cases[label]
        n, c, h, wd = cuda_head.cell_shape(x)
        nbytes = (x.numel() * x.element_size() + n * w.shape[0] * h * wd // pool ** 2 * 4
                  + (w.numel() + b.numel()) * 4)
        return _drop_bound(nbytes, n * h * wd, p, philox)

    def occupancy(label):
        x, w, b, pool, stage, p = cases[label]
        n, c, h, wd = cuda_head.cell_shape(x)
        kind = cuda_head.cell_kind(x)
        rb, tw, grid = cs._head2_fwd_plan(n, c, w.shape[0], pool, h, wd, kind != 0, sms)
        smem = cs._head2_fwd_smem(c, w.shape[0], pool, kind != 0, rb, tw)
        return dict(plan=(rb, tw, grid), smem=smem, **_occupancy(
            cuda_build, "head2_fwd", "head2_fwd_occupancy", c, w.shape[0], pool, kind,
            int(p > 0), Big(smem))[0])

    out = _ab_cases(torch, timer, "head2_fwd", calls, (cs.HEAD2_FWD, cs.HEAD_FWD),
                    HEAD_FWD_KERNELS, hold, bound, occupancy)
    x, w, b, pool, stage, p = next(iter(cases.values()))
    plain_ms = timer.ms(lambda: cs.head_fwd_plain(x, w, b, pool, p, seed, stage), 5)
    return _ab_rows(out, ("head2_fwd", "head_fwd"), plain_ms)


def _loss_tail2_bwd_held(torch, timer, cases, seed, philox):
    """Row 8b at its timed shapes (``cases``: label -> (x, wt, b, obs, gbar,
    act, stage, drop_p)): the specialised backward (loss_tail2_bwd, the
    route) against the generic kernel forced (cuda_stages.LOSS_TAIL2_KERNELS
    off): gx bit for bit, dW and db within 1e-5 of each leaf's largest entry
    of the generic kernel's and of the twin's; timed in turns and by CUPTI
    cold (_ab_cases) against its bound: bytes (x, obs and gbar read once, gx
    written once), with dropout the larger of those and a Philox draw an
    output (dropout_bounds' row 8b at its shape).  Returns the rows
    loss_tail2_bwd and loss_tail_bwd (the generic forced)."""
    from carle_tpu_torch.ops import cuda_build, cuda_stages as cs

    sms = cs._multiprocessors(torch.device("cuda"))
    call = lambda a: cs.loss_tail_bwd(*a[:6], a[7], seed, a[6])
    calls = {label: (lambda a=a: call(a),
                     lambda a=a: _flag_off(cs, "LOSS_TAIL2_KERNELS", lambda: call(a)))
             for label, a in cases.items()}

    def hold(label, got, old):
        x, wt, b, obs, gbar, act, stage, p = cases[label]
        check(torch.equal(got[2], old[2]), f"loss_tail2_bwd ({label}): gx differs from the "
              "generic kernel's")
        twin = cs.loss_tail_bwd_plain(x, wt, b, obs, gbar, act, p, seed, stage)
        worst = {"generic": max(_leaf_errors(list(got), list(old))),
                 "plain": max(_leaf_errors(list(got), list(twin)))}
        check(max(worst.values()) < 1e-5, f"loss_tail2_bwd ({label}) leaves differ: {worst}")
        abs_err = lambda out: max(float((a - t).abs().max()) for a, t in zip(out, twin))
        return {"new": {"max_abs_err": abs_err(got), "max_leaf_rel_err_vs_generic":
                        worst["generic"], "max_leaf_rel_err_vs_plain": worst["plain"],
                        "gx_bit_equal_generic": True},
                "generic": {"max_abs_err": abs_err(old),
                            "max_leaf_rel_err_vs_plain": max(_leaf_errors(list(old),
                                                                          list(twin)))}}

    def bound(label):
        x, wt, b, obs, gbar, act, stage, p = cases[label]
        nbytes = (2 * x.numel() * 4 + obs.numel() * obs.element_size() + gbar.numel() * 4
                  + 2 * (wt.numel() + b.numel()) * 4)
        return _drop_bound(nbytes, x.shape[0] * 4 * x.shape[2] * x.shape[3], p, philox)

    def occupancy(label):
        x, wt, b, obs, gbar, act, stage, p = cases[label]
        n, cin, h, w = x.shape
        ri, tj, _ = cs._tail2_plan(n, cin, h, w, True, sms)
        kind = cs.cell_kind(obs)
        smem = cs._loss_tail2_bwd_smem(kind, cin, w, ri, tj)
        return dict(plan=(ri, tj), smem=smem, **_occupancy(
            cuda_build, "loss_tail2_bwd", "loss_tail2_bwd_occupancy", cin, cs.ACTS[act],
            int(p > 0), kind, Big(smem))[0])

    out = _ab_cases(torch, timer, "loss_tail2_bwd", calls, (cs.LOSS_TAIL2_BWD, cs.LOSS_TAIL_BWD),
                    LOSS_TAIL_BWD_KERNELS, hold, bound, occupancy)
    x, wt, b, obs, gbar, act, stage, p = next(iter(cases.values()))
    plain_ms = timer.ms(lambda: cs.loss_tail_bwd_plain(x, wt, b, obs, gbar, act, p, seed, stage),
                        2)
    return _ab_rows(out, ("loss_tail2_bwd", "loss_tail_bwd"), plain_ms)


def phase_stage_kernels(torch, timer, gen, philox):
    """The single-stage kernels and the decoder loss vs their twins at the
    autoencoder's shapes (256 x 256 universes, channels 1 -> 4 -> 2 -> 1 -> 1):
    forwards on 160 universes, backwards on 64, without and with dropout 0.1;
    the head also at RND's pool 4; the decoder loss's kernels specialised at
    its width (dec2_*) against the generic ones, both timed in turns; ae_loss
    with a source that is not the target."""
    import torch.nn.functional as F

    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.ops import bitpack, cuda_build, cuda_head, cuda_stages

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

    # -- head_fwd: the kernel specialised at the three widths (head2_fwd, the
    # route) at row 9a's shapes, against the generic one forced (head_fwd)
    head_cases = {  # label: (x, w, b, pool, stage), the backward's cases
        "AE conv1, u8 [160,1,256,256] -> [160,4,128,128], pool 2": (cells, w1, b1, 2, 0),
        "AE conv2, f32 [160,4,128,128] -> [160,2,64,64], pool 2": (x1, w2, b2, 2, 1),
        "RND conv1, u8 [160,1,256,256] -> [160,4,64,64], pool 4": (cells, w1, b1, 4, 0),
    }
    words = bitpack.pack_grid(cells[:, 0])[:, None]
    fwd_cases = {  # label: (x, w, b, pool, stage, drop_p)
        "AE conv1, u8 [160,1,256,256] -> [160,4,128,128], pool 2": (cells, w1, b1, 2, 0, 0.0),
        "AE conv1, u32 [160,1,256,256] words, pool 2": (words, w1, b1, 2, 0, 0.0),
        "RND conv1, u8 [160,1,256,256] -> [160,4,64,64], pool 4": (cells, w1, b1, 4, 0, 0.0),
        "AE conv2, f32 [64,4,128,128] -> [64,2,64,64], pool 2": (x1[:nb], w2, b2, 2, 1, 0.0),
        "AE conv1, u8 [64,1,256,256], pool 2, drop 0.1": (cells[:nb], w1, b1, 2, 0, DROP_P),
        "RND conv1, u8 [64,1,256,256], pool 4, drop 0.1": (cells[:nb], w1, b1, 4, 0, DROP_P),
        "AE conv2, f32 [64,4,128,128], pool 2, drop 0.1": (x1[:nb], w2, b2, 2, 1, DROP_P),
    }
    results.update(_head2_fwd_held(torch, timer, fwd_cases, seed, philox))
    log(f"head2_fwd ok: {json.dumps(results['head2_fwd'])}")

    # -- head_bwd: the same three, the second with its input cotangent; the
    # kernel specialised at these widths (head2_bwd, the route) and the
    # generic one forced (head_bwd), each against the twin and each other
    # (1e-5 of each leaf's largest entry: the weight-gradient sums run in
    # another order; gx bit for bit), timed in turns and by CUPTI cold
    detail = {name: {} for name in ("head2_bwd", "head_bwd")}
    for label, (x, wt, b, pool, stage) in head_cases.items():
        xb = x[:nb].contiguous()
        need_dx = xb.dtype == torch.float32
        g = rand(nb, wt.shape[0], x.shape[2] // pool, x.shape[3] // pool)
        args = (xb, wt, b, g, pool)
        new = lambda p: cuda_stages.head_bwd(*args, p, seed, stage, need_dx)
        old = lambda p: _generic_head(lambda: new(p))
        plain = lambda p: cuda_stages.head_bwd_plain(*args, p, seed, stage, need_dx)
        check(cuda_stages.head_route(wt.shape[1], wt.shape[0], pool, xb.shape[3],
                                     cuda_head.cell_kind(xb), need_dx),
              f"head_bwd ({label}) does not take the specialised kernel")
        before = cuda_stages.HEAD2_BWD.launches, cuda_stages.HEAD_BWD.launches
        new(DROP_P)
        check((cuda_stages.HEAD2_BWD.launches - before[0],
               cuda_stages.HEAD_BWD.launches - before[1]) == (1, 0),
              f"head_bwd ({label}): the route did not launch head2_bwd once")
        for name, fn in (("head2_bwd", new), ("head_bwd", old)):
            e_drop, e_plain, abs_err = backward_case(name, fn, plain, label)
            detail[name][label] = {"need_dx": need_dx, "max_leaf_rel_err": e_drop,
                                   "max_leaf_rel_err_no_drop": e_plain, "max_abs_err": abs_err}
        for p in (0.0, DROP_P):
            a, t = new(p), old(p)
            worst = max(_leaf_errors(list(a[:2]), list(t[:2])))
            check(worst < 1e-5, f"head2_bwd ({label}, drop {p}) differs from the generic "
                  f"kernel: {worst}")
            detail["head2_bwd"][label][f"vs_generic_drop_{p}_max_leaf_rel_err"] = worst
            if need_dx:
                check(torch.equal(a[2], t[2]), f"head2_bwd ({label}, drop {p}): gx differs "
                      "from the generic kernel's")
        for name, fn in (("head2_bwd", new), ("head_bwd", old), ("head2_bwd", new),
                         ("head_bwd", old)):
            detail[name][label].setdefault("ms_runs", []).append(timer.ms(lambda: fn(DROP_P), 10))
        for name, fn in (("head2_bwd", new), ("head_bwd", old)):
            d = detail[name][label]
            d["ms"] = sum(d["ms_runs"]) / len(d["ms_runs"])
            d["ms_no_drop"] = timer.ms(lambda: fn(0.0), 10)
        detail["head2_bwd"][label]["cupti_cold_us"] = _cupti_us(
            torch, timer, lambda: new(DROP_P), ("head2_",), label)
        detail["head_bwd"][label]["cupti_cold_us"] = _cupti_us(
            torch, timer, lambda: old(DROP_P),
            ("head_bwd_kernel", "conv_input_grad", "column_sums"), label)
        kind, (_, _, hx, wx) = cuda_head.cell_kind(xb), cuda_head.cell_shape(xb)
        rb, tw, grid = cuda_stages._head2_plan(
            nb, wt.shape[1], wt.shape[0], pool, hx, wx, kind != 0, need_dx,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        smem = cuda_stages._head2_bwd_smem(wt.shape[1], wt.shape[0], pool, kind != 0, need_dx,
                                           rb, tw)
        detail["head2_bwd"][label].update(plan=(rb, tw, grid), occupancy=_occupancy(
            cuda_build, "head2_bwd", "head2_bwd_occupancy", wt.shape[1], wt.shape[0], pool, kind,
            1, int(need_dx), Big(smem))[0])
        if label.startswith("AE conv1"):
            plain_ms = timer.ms(lambda: plain(DROP_P), 2)
    label = next(iter(head_cases))
    # the bound at AE conv1's shape, by the convention of rows 3 and 4: stage 1
    # a table lookup (no float work), dW from the counts of a pool window's
    # tied taps (9 C multiply-adds a window and channel), x and g read once,
    # and a Philox draw a pixel; beside it the bound stated before, which
    # counted the recompute and dW as float32 work on every pixel
    nbytes = nb * hw + nb * 4 * hw // 4 * 4 + 80 * 4
    windows = nb * hw // 4
    flops = 2 * 9 * 1 * 4 * windows
    parts = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "fp32_ms": flops / FP32_FLOPS * 1e3,
             "philox_ms": nb * hw * philox["ops"] / INT32_OPS * 1e3}
    bound = max(parts.values())
    by = "bytes" if bound == parts["bytes_ms"] else "operations"
    before = bound_ms(nbytes, 2 * (2 * 9 * 1 * 4 * nb * hw), FP32_FLOPS)[0]
    shape = label.replace("160", "64") + ", g [64,4,128,128], drop 0.1"
    for name in ("head2_bwd", "head_bwd"):
        first = detail[name][label]
        results[name] = dict(
            max_abs_err=first["max_abs_err"], max_leaf_rel_err=first["max_leaf_rel_err"],
            ms=first["ms"], ms_no_drop=first["ms_no_drop"], plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, bound_parts=parts, bound_ms_stated_before=before, library_ms=None,
            shape=shape if name == "head2_bwd" else shape + " (the generic kernel forced)",
            cases=detail[name])
    log(f"head2_bwd ok: {json.dumps(results['head2_bwd'])}")
    log(f"head_bwd (generic, forced) ok: {json.dumps(results['head_bwd'])}")

    # -- the head's width repair: 8192 wide, and tiles forced at 256² ----------
    # a generator of its own: the phases after this one keep their draws
    hgen = torch.Generator(device=dev).manual_seed(8192)
    hrand = lambda *shape: torch.randn(shape, generator=hgen, device=dev)
    wide = (torch.rand((1, 1, 16, 8192), generator=hgen, device=dev) < 0.2).to(torch.uint8)
    gw = hrand(1, 4, 8, 4096)
    tiles = {"plans_8192": cuda_stages._head_bands(1, 4, 16, 8192, 2)}
    for p in (0.0, DROP_P):
        for on in (lambda fn: fn(), _generic_head):   # head2_fwd's tiles, the generic's
            close(on(lambda: cuda_stages.head_fwd(wide, w1, b1, 2, p, seed)),
                  cuda_stages.head_fwd_plain(wide, w1, b1, 2, p, seed),
                  f"head_fwd at width 8192, drop {p}")
        errs = _leaf_errors(cuda_stages.head_bwd(wide, w1, b1, gw, 2, p, seed, need_dx=True),
                            cuda_stages.head_bwd_plain(wide, w1, b1, gw, 2, p, seed,
                                                       need_dx=True))
        check(max(errs) < 1e-4, f"head_bwd at width 8192 (drop {p}) leaves differ: {errs}")
        tiles[f"width_8192_drop_{p}_max_leaf_rel_err"] = max(errs)
    x8 = cells[:nb].contiguous()
    x8[: nb // 4, :, :, :100] = 0   # blank stretches across tile edges: pool windows tie
    g8 = hrand(nb, 4, 128, 128)
    # the generic kernels' column tiles (the forward at these widths routes to
    # head2_fwd, whose tiles ignore TILE_CELLS)
    calls = {"head_fwd": lambda x: (_generic_head(
                 lambda: cuda_stages.head_fwd(x, w1, b1, 2, DROP_P, seed)),),
             "head_bwd": lambda x: cuda_stages.head_bwd(x, w1, b1, g8, 2, DROP_P, seed,
                                                        need_dx=True)}
    exact = {"head_fwd": 0, "head_bwd": 2}   # the output, the input cotangent: bit for bit
    one = {k: fn(x8) for k, fn in calls.items()}
    one_ms = {k: timer.ms(lambda: fn(x8), 10) for k, fn in calls.items()}
    try:
        cuda_head.TILE_CELLS = 48      # six tiles a row, the last ragged
        for k, fn in calls.items():
            got = _bits_twice(lambda: fn(x8), f"{k} in column tiles")
            check(torch.equal(got[exact[k]], one[k][exact[k]]),
                  f"{k} in column tiles: its output differs from one tile's")
            worst = max(_leaf_errors(got, one[k]))
            check(worst < 1e-5, f"{k} in column tiles differs from one tile: {worst}")
            tiles[k] = dict(max_leaf_rel_err=worst, ms=timer.ms(lambda: fn(x8), 10),
                            one_tile_ms=one_ms[k])
    finally:
        cuda_head.TILE_CELLS = None
    results["head_tiles"] = tiles
    log(f"head width repair ok: {json.dumps(tiles)}")

    # -- tail: the kernels specialised at the stages' widths (tail2_*), held
    # against the generic one forced at the same shapes (tail_*)
    tail_cases = {  # label: (x, wt, b, act, stage)
        "AE deconv2, f32 [160,1,128,128] -> [160,1,256,256], sigmoid": (mid, wt2, bt2, "sigmoid", 3),
        "AE deconv1, f32 [160,2,64,64] -> [160,1,128,128], relu": (emb, wt1, bt1, "relu", 2),
    }
    fwd_detail, bwd_detail = {}, {}
    err = {"tail2": 0.0, "generic": 0.0}
    for label, (x, wt, b, act, stage) in tail_cases.items():
        xb = x[:nb].contiguous()
        g = rand(nb, wt.shape[1], 2 * x.shape[2], 2 * x.shape[3])
        args = (xb, wt, b, g, act)
        fd = _tail2_held(torch, x, wt, b, act, stage, seed, label)
        for route in ("tail2", "generic"):
            on = (lambda fn: fn()) if route == "tail2" else _generic_tail
            err[route] = max(err[route], close(
                on(lambda: cuda_stages.tail_fwd(x, wt, b, act, 0.0, 0, stage)),
                cuda_stages.tail_fwd_plain(x, wt, b, act, 0.0, 0, stage), f"{route} {label}"))
            close(on(lambda: cuda_stages.tail_fwd(xb, wt, b, act, DROP_P, seed, stage)),
                  cuda_stages.tail_fwd_plain(xb, wt, b, act, DROP_P, seed, stage),
                  f"{route} {label}, dropout")
            e_drop, e_plain, abs_err = on(lambda: backward_case(
                f"{route} tail_bwd", lambda p: cuda_stages.tail_bwd(*args, p, seed, stage),
                lambda p: cuda_stages.tail_bwd_plain(*args, p, seed, stage), label))
            bwd_detail.setdefault(label, {})[route] = {
                "max_leaf_rel_err": e_drop, "max_leaf_rel_err_no_drop": e_plain,
                "max_abs_err": abs_err}
        bd = bwd_detail[label]
        bd["vs_generic"] = _tail2_bwd_held(torch, xb, wt, b, g, act, stage, seed, label)
        calls = {   # on the route in force
            "fwd": lambda: cuda_stages.tail_fwd(x, wt, b, act, 0.0, 0, stage),
            "fwd drop": lambda: cuda_stages.tail_fwd(x, wt, b, act, DROP_P, seed, stage),
            "bwd": lambda: cuda_stages.tail_bwd(*args, DROP_P, seed, stage),
            "bwd no drop": lambda: cuda_stages.tail_bwd(*args, 0.0, 0, stage),
        }
        timed = {}
        for route in ("tail2", "generic", "tail2", "generic"):
            for name, fn in calls.items():
                timed.setdefault(f"{route} {name}", []).append(timer.ms(
                    fn if route == "tail2" else lambda fn=fn: _generic_tail(fn),
                    20 if name.startswith("fwd") else 10))
        keep = cuda_stages._tail_fwd_launch(xb, wt, b, act, DROP_P, seed, stage, True)[1]
        fd.update(ms_in_turns={k: v for k, v in timed.items() if " fwd" in k},
                  ms_saving_fwd=timer.ms(lambda: cuda_stages._tail_fwd_launch(
                      xb, wt, b, act, DROP_P, seed, stage, True), 10),
                  plan=cuda_stages._tail2_plan(nf, x.shape[1], x.shape[2], x.shape[3], False,
                                               cuda_stages._multiprocessors(dev)),
                  generic_plan=cuda_stages._tail_bands(x.shape[1], 1, x.shape[2], x.shape[3])[0],
                  conv_transpose2d_ms=timer.ms(lambda: F.conv_transpose2d(
                      x, wt, b, stride=2, padding=1), 20))
        fwd_detail[label] = fd
        bd.update(ms_in_turns={k: v for k, v in timed.items() if " bwd" in k},
                  ms_from_saved=timer.ms(lambda: cuda_stages._tail2_bwd_kernel(
                      *args, DROP_P, seed, stage, keep=keep), 10),
                  plan=cuda_stages._tail2_plan(nb, x.shape[1], x.shape[2], x.shape[3], True,
                                               cuda_stages._multiprocessors(dev)),
                  generic_plan=cuda_stages._tail_bands(x.shape[1], 1, x.shape[2], x.shape[3])[1])
        if act == "sigmoid":
            plain_fwd = timer.ms(lambda: cuda_stages.tail_fwd_plain(x, wt, b, act, 0.0, 0, stage), 5)
            plain_bwd = timer.ms(lambda: cuda_stages.tail_bwd_plain(*args, DROP_P, seed, stage), 2)
    label = next(iter(tail_cases))
    taps = 2 * 4 * 1 * 1   # flops an output position: 2 x 2 inputs a channel pair
    bound, by = bound_ms(nf * (hw // 4 + hw) * 4 + 17 * 4, taps * nf * hw, FP32_FLOPS)
    for row, route in (("tail2_fwd", "tail2"), ("tail_fwd", "generic")):
        turns = fwd_detail[label]["ms_in_turns"]
        results[row] = dict(max_abs_err=err[route], ms=turns[f"{route} fwd"][0],
                            ms_drop=turns[f"{route} fwd drop"][0], plain_ms=plain_fwd,
                            bound_ms=bound, bound_by=by, library_ms=None, shape=label,
                            cases=fwd_detail if route == "tail2" else None)
        log(f"{row} ok: {results[row]}")
    bound, by = bound_ms(nb * (hw // 4 + hw + hw // 4) * 4 + 34 * 4, 3 * taps * nb * hw + 4 * nb * hw,
                         FP32_FLOPS)
    b_saved, _ = bound_ms(nb * (hw // 4 + hw + hw // 4) * 4 + nb * hw // 4 + 34 * 4,
                          3 * taps * nb * hw + 4 * nb * hw, FP32_FLOPS)
    for row, route in (("tail2_bwd", "tail2"), ("tail_bwd", "generic")):
        first = bwd_detail[label]
        turns = first["ms_in_turns"]
        results[row] = dict(
            max_abs_err=first[route]["max_abs_err"],
            max_leaf_rel_err=first[route]["max_leaf_rel_err"],
            ms=turns[f"{route} bwd"][0], ms_no_drop=turns[f"{route} bwd no drop"][0],
            plain_ms=plain_bwd, bound_ms=bound, bound_by=by, library_ms=None,
            shape="f32 x [64,1,128,128], g [64,1,256,256], sigmoid, drop 0.1",
            cases=bwd_detail if route == "tail2" else None)
    results["tail2_bwd"].update(ms_from_saved=first["ms_from_saved"], bound_ms_from_saved=b_saved)
    for row in ("tail2_bwd", "tail_bwd"):
        log(f"{row} ok: {results[row]}")

    obs_f, obs_w = obs.to(torch.float32), bitpack.pack_grid(obs)
    lt_args = (mid, wt2, bt2)
    mb, ob = mid[:nb].contiguous(), obs[:nb].contiguous()
    # -- loss_tail_fwd: the kernel specialised at the stages' widths
    # (loss_tail2_fwd, the route) at row 8a's shapes, against the generic one
    # forced (loss_tail_fwd)
    lt_fwd = "AE deconv2, f32 x [160,1,128,128], {} obs [160,1,256,256], sigmoid"
    lt_cases = {}   # label: (x, wt, b, obs, drop_p)
    for kind, o in (("u8", obs), ("u32", obs_w), ("f32", obs_f)):
        label = lt_fwd.format(kind)
        lt_cases[label] = (*lt_args, o, 0.0)
        lt_cases[label.replace("160", "64") + ", drop 0.1"] = (mb, wt2, bt2,
                                                               o[:nb].contiguous(), DROP_P)
    results.update(_loss_tail2_fwd_held(torch, timer, lt_cases, seed, philox, close))
    # -- loss_tail_bwd: the kernel specialised at the stages' widths
    # (loss_tail2_bwd, the route) at row 8b's shapes, against the generic one
    # forced (loss_tail_bwd)
    eb = emb[:nb].contiguous()
    # a generator of its own: the phases after this one keep their draws
    o128 = (torch.rand((nb, 1, 128, 128), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(128)) < 0.3
            ).to(torch.uint8)
    lt_bwd = "AE deconv2, f32 x [64,1,128,128], u8 obs [64,1,256,256], sigmoid"
    bwd_cases = {  # label: (x, wt, b, obs, gbar, act, stage, drop_p)
        lt_bwd + ", drop 0.1": (mb, wt2, bt2, ob, gbar, "sigmoid", 3, DROP_P),
        lt_bwd.replace("u8 obs", "u32 obs") + ", drop 0.1": (mb, wt2, bt2, obs_w[:nb], gbar,
                                                             "sigmoid", 3, DROP_P),
        lt_bwd.replace("u8 obs", "f32 obs") + ", drop 0.1": (mb, wt2, bt2, obs_f[:nb], gbar,
                                                             "sigmoid", 3, DROP_P),
        lt_bwd: (mb, wt2, bt2, ob, gbar, "sigmoid", 3, 0.0),
        "AE deconv1, f32 x [64,2,64,64], u8 obs [64,1,128,128], relu, drop 0.1": (
            eb, wt1, bt1, o128, gbar, "relu", 2, DROP_P),
    }
    results.update(_loss_tail2_bwd_held(torch, timer, bwd_cases, seed, philox))
    log(f"loss_tail2_bwd ok: {json.dumps(results['loss_tail2_bwd'])}")

    # -- decoder loss: the kernels specialised at the decoder's width (dec2_*),
    # held against the generic ones forced at the same shapes (decoder_loss_*)
    dec = (wt1, bt1, wt2, bt2)
    dl_args = (emb, *dec)
    eb = emb[:nb].contiguous()
    db_args = (eb, *dec, ob)
    fwd_err, bwd_err = {}, {}
    for route in ("dec2", "generic"):
        on = (lambda fn: fn()) if route == "dec2" else _generic_decoder
        got = on(lambda: cuda_stages.decoder_loss_fwd(*dl_args, obs))
        check(torch.equal(got, on(lambda: cuda_stages.decoder_loss_fwd(*dl_args, obs))),
              f"{route} decoder_loss_fwd is not deterministic")
        want = cuda_stages.decoder_loss_fwd_plain(*dl_args, obs)
        close(got, want, f"{route} decoder_loss_fwd", atol=1e-3)
        close(on(lambda: cuda_stages.decoder_loss_fwd(*dl_args, obs_f)), want,
              f"{route} decoder_loss_fwd, f32 obs", atol=1e-3)
        close(on(lambda: cuda_stages.decoder_loss_fwd(*db_args, DROP_P, seed)),
              cuda_stages.decoder_loss_fwd_plain(*db_args, DROP_P, seed),
              f"{route} decoder_loss_fwd, dropout", atol=1e-3)
        fwd_err[route] = (float((got - want).abs().max()),
                          float(((got - want).abs() / want.abs()).max()))
        bwd_err[route] = on(lambda: backward_case(
            f"{route} decoder_loss_bwd",
            lambda p: cuda_stages.decoder_loss_bwd(*db_args, gbar, p, seed),
            lambda p: cuda_stages.decoder_loss_bwd_plain(*db_args, gbar, p, seed),
            "AE2D decoder"))
    held = {"fwd 160": _dec2_held(torch, emb, dec, obs, None, 0.0, seed,
                                  words=bitpack.pack_grid(obs))}
    for p in (0.0, DROP_P):
        held[f"drop {p}"] = _dec2_held(torch, eb, dec, ob, gbar, p, seed,
                                       words=bitpack.pack_grid(ob))
    saved = cuda_stages._decoder_fwd_launch(eb, dec, ob, DROP_P, seed, None, True)[1]
    calls = {   # on the route in force
        "fwd": lambda: cuda_stages.decoder_loss_fwd(*dl_args, obs),
        "fwd drop": lambda: cuda_stages.decoder_loss_fwd(*dl_args, obs, DROP_P, seed),
        "bwd": lambda: cuda_stages.decoder_loss_bwd(*db_args, gbar, DROP_P, seed),
        "bwd no drop": lambda: cuda_stages.decoder_loss_bwd(*db_args, gbar),
    }
    timed = {}
    for route in ("dec2", "generic", "dec2", "generic"):
        for name, fn in calls.items():
            timed.setdefault(f"{route} {name}", []).append(timer.ms(
                fn if route == "dec2" else lambda fn=fn: _generic_decoder(fn),
                20 if name.startswith("fwd") else 10))
    from_saved = timer.ms(lambda: cuda_stages._dec2_bwd_kernel(eb, dec, ob, gbar, DROP_P, None,
                                                               saved), 10)
    saving_fwd = timer.ms(lambda: cuda_stages._decoder_fwd_launch(eb, dec, ob, DROP_P, seed,
                                                                  None, True), 10)
    fwd_plain = timer.ms(lambda: cuda_stages.decoder_loss_fwd_plain(*dl_args, obs), 5)
    bwd_plain = timer.ms(lambda: cuda_stages.decoder_loss_bwd_plain(*db_args, gbar, DROP_P,
                                                                     seed), 2)
    b, by, parts = _decoder_bound(nf, h, w, 1, False)
    for row, route in (("dec2_fwd", "dec2"), ("decoder_loss_fwd", "generic")):
        results[row] = dict(
            max_abs_err=fwd_err[route][0], max_rel_err=fwd_err[route][1],
            ms=timed[f"{route} fwd"][0], ms_drop=timed[f"{route} fwd drop"][0],
            plain_ms=fwd_plain, bound_ms=b, bound_by=by, library_ms=None, bound_parts=parts,
            ms_in_turns={k: v for k, v in timed.items() if k.startswith(f"{route} fwd")},
            shape="f32 x [160,2,64,64], u8 obs [160,1,256,256], AE2D decoder (2, 1, 1)")
        log(f"{row} ok: {results[row]}")
    b, by, parts = _decoder_bound(nb, h, w, 1, True, philox["ops"])
    b_saved, _, parts_saved = _decoder_bound(nb, h, w, 1, True, saved=True)
    for row, route in (("dec2_bwd", "dec2"), ("decoder_loss_bwd", "generic")):
        e_drop, e_plain, abs_err = bwd_err[route]
        results[row] = dict(
            max_abs_err=abs_err, max_leaf_rel_err=e_drop, max_leaf_rel_err_no_drop=e_plain,
            ms=timed[f"{route} bwd"][0], ms_no_drop=timed[f"{route} bwd no drop"][0],
            plain_ms=bwd_plain, bound_ms=b, bound_by=by, library_ms=None, bound_parts=parts,
            ms_in_turns={k: v for k, v in timed.items() if k.startswith(f"{route} bwd")},
            shape="f32 x [64,2,64,64], u8 obs [64,1,256,256], gbar [64], drop 0.1")
    results["dec2_fwd"].update(err_rel_vs_generic=held["fwd 160"][0]["vs_generic"],
                               plan=cuda_stages._dec2_plan(nf, h, w, False))
    results["dec2_bwd"].update(
        ms_from_saved=from_saved, ms_saving_fwd=saving_fwd, bound_ms_from_saved=b_saved,
        bound_parts_from_saved=parts_saved, plan=cuda_stages._dec2_plan(nb, h, w, True),
        vs_generic={k: {"err_rel": r, "max_leaf_rel_err": l} for k, (r, l) in held.items()})
    for row in ("dec2_bwd", "decoder_loss_bwd"):
        log(f"{row} ok: {results[row]}")

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


def _device_us(e):
    """A profiler event's own device time (µs), under either attribute name."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _device_split(torch, fn, calls: int = 5):
    """What one call of ``fn`` runs on the device, under torch.profiler: each
    kernel's and copy's µs and count a call, and the device launches a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(3):   # a session that records no device event at all is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
        if events:
            break
    rows = sorted(({"name": e.key[:90], "us": _device_us(e) / calls, "per_call": e.count / calls}
                   for e in events), key=lambda r: -r["us"])
    kernels = [r for r in rows if not r["name"].startswith("Memcpy")]
    return {"launches_per_call": sum(r["per_call"] for r in kernels),
            "copies_per_call": sum(r["per_call"] for r in rows if r not in kernels),
            "device_us_per_call": sum(r["us"] for r in rows), "by_kernel": rows}


class Big(int):
    """An argument the C function takes as long long."""


def _host_us(torch, fn, reps: int = 200) -> float:
    """The host's µs a call to enqueue ``fn``: calls in a loop without a
    synchronize, after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


def _occupancy(cuda_build, source: str, symbol: str, *args, slots: int = 4, defines=()):
    """``symbol``'s report from ``source``'s library (built with ``defines``;
    common.cuh's kernel_occupancy, four ints a kernel): registers a thread,
    static shared memory, spilled bytes, resident blocks a multiprocessor."""
    import ctypes

    lib = cuda_build.library(source, tuple(defines))
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_longlong if isinstance(a, Big) else ctypes.c_int for a in args]
                   + [ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * slots)()
    rc = fn(*(int(a) for a in args), 0, ctypes.cast(out, ctypes.c_void_p))
    check(rc == 0, f"{symbol} failed: {rc}")
    keys = ("registers", "static_smem", "spilled_bytes", "blocks_per_sm")
    return [dict(zip(keys, out[i:i + 4])) for i in range(0, slots, 4)]


def _ae_occupancy(cuda_build):
    """Registers, shared memory and resident blocks a multiprocessor of every
    band kernel of the whole autoencoder at 256² (uint8 cells), AE2D and
    generic."""
    from carle_tpu_torch.ops import cuda_head as ch

    out = {}
    ry, (ry_dec, smem_dec), (ry_enc, smem_enc) = ch._ae2d_plan(256, 256)
    for drop in (0, 1):
        for save in (0, 1):
            smem = ch._ae2d_fwd_smem(256, ry, bool(save and drop))
            out[f"ae2d_fwd drop {drop} save {save}"] = dict(
                _occupancy(cuda_build, "ae2d_fwd", "ae2d_fwd_occupancy", drop, save, Big(smem))[0],
                dynamic_smem=smem, rows=ry)
        dec, enc = _occupancy(cuda_build, "ae2d_bwd", "ae2d_bwd_occupancy", drop, Big(smem_dec),
                              Big(smem_enc), slots=8)
        out[f"ae2d_bwd decoder drop {drop}"] = dict(dec, dynamic_smem=smem_dec, rows=ry_dec)
        out[f"ae2d_bwd encoder drop {drop}"] = dict(enc, dynamic_smem=smem_enc, rows=ry_enc)
    (_, smem), (_, smem3) = ch._ae_bands(256, 256, 4, 2, 1, 1)
    (_, _, smem2), (_, _, smem1) = ch._encoder_bwd_whole(256, 256, 4, 2)
    out["generic ae_loss_fwd drop 0"] = dict(
        _occupancy(cuda_build, "ae_loss_fwd", "ae_loss_fwd_occupancy", 0, 1, 1, Big(smem))[0],
        dynamic_smem=smem)
    bwd = _occupancy(cuda_build, "ae_loss_bwd", "ae_loss_bwd_occupancy", Big(smem3), Big(smem2),
                     Big(smem1), slots=12)
    for key, occ, sm in zip(("decoder", "encoder stage 2", "encoder stage 1"), bwd,
                            (smem3, smem2, smem1)):
        out[f"generic ae_loss_bwd {key} drop 1"] = dict(occ, dynamic_smem=sm)
    return out


def _enc3_occupancy(cuda_build):
    """Registers, shared memory and resident blocks a multiprocessor of the
    specialised encoder kernels (uint8 cells) at each width on the plans of
    the main shapes: the battery's forward (160 x 256²), the training
    backward (64 x 256²) and RND's 512 bands of 32 x 8192."""
    from carle_tpu_torch.ops import cuda_head as ch

    out = {}
    shapes = {"160x256": (160, 256, 256), "64x256": (64, 256, 256),
              "bands 512x32x8192": (512, 32, 8192)}
    for label, (n, h, w) in shapes.items():
        for name, (c1, c2, p1, _) in zip(("rnd", "target", "ae", "policy"), ch.ENC3_WIDTHS):
            r2, tw, smem = ch._enc3_plan(n, h, w, c1, c2, p1, False)
            for mode in (0, 1, 2):   # no dropout, dropout, dropout saving the bits
                out[f"enc3_fwd {name} mode {mode} {label}"] = dict(
                    _occupancy(cuda_build, "enc3_fwd", "enc3_fwd_occupancy", c1, c2, p1, mode,
                               Big(smem))[0], dynamic_smem=smem, rows=r2, tile=tw)
            r2, tw, smem = ch._enc3_plan(n, h, w, c1, c2, p1, True)
            for drop in (0, 1):
                out[f"enc3_bwd {name} drop {drop} {label}"] = dict(
                    _occupancy(cuda_build, "enc3_bwd", "enc3_bwd_occupancy", c1, c2, p1, drop,
                               Big(smem))[0], dynamic_smem=smem, rows=r2, tile=tw)
    return out


def _dec2_occupancy(cuda_build):
    """Registers, shared memory and resident blocks a multiprocessor of the
    specialised decoder-loss kernels (uint8 obs) on the plans of the main
    shapes: the forward on 160 x 256², the backward on 64 x 256², and
    Prediction's 128 bands of 80 x 8192."""
    from carle_tpu_torch.ops import cuda_stages as cs

    out = {}
    shapes = {"160x256": (160, 256, 256), "64x256": (64, 256, 256),
              "bands 128x80x8192": (128, 80, 8192)}
    for label, (n, h, w) in shapes.items():
        ry, tx, _ = cs._dec2_plan(n, h, w, False)
        for mode in (0, 1, 2):   # no dropout, dropout, dropout saving the bits
            smem = cs._dec2_fwd_smem(w, ry, tx, mode == 2)
            out[f"dec2_fwd mode {mode} {label}"] = dict(
                _occupancy(cuda_build, "dec2_fwd", "dec2_fwd_occupancy", mode, Big(smem))[0],
                dynamic_smem=smem, rows=ry, tile=tx)
        ry, tx, smem = cs._dec2_plan(n, h, w, True)
        for drop in (0, 1):
            out[f"dec2_bwd drop {drop} {label}"] = dict(
                _occupancy(cuda_build, "dec2_bwd", "dec2_bwd_occupancy", drop, Big(smem))[0],
                dynamic_smem=smem, rows=ry, tile=tx)
    return out


# One Philox4x32-10 draw (philox.cuh) as the card executes it, read off the
# SASS: a kernel with nine draws at neighbouring positions less one with one,
# over eight (each draw's rounds, its four compares against keep_below, its
# counter and its bits' place in a word, as the net kernels gather them; the
# key schedule runs in uniform registers, once a warp, and counts only as
# issued instructions).
PHILOX_PROBE = r"""
#include "philox.cuh"
template <int DRAWS>
__device__ __forceinline__ void draws(const DropCfg& cfg, const int* __restrict__ xy,
                                      unsigned* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x, x = xy[2 * i], y = xy[2 * i + 1];
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < DRAWS; ++k) bits |= drop_keep_group(cfg, 1, blockIdx.y, 0, y, x + k) << (3 * k);
    out[i] = bits;
}
extern "C" __global__ void one_draw(DropCfg cfg, const int* xy, unsigned* out) {
    draws<1>(cfg, xy, out);
}
extern "C" __global__ void nine_draws(DropCfg cfg, const int* xy, unsigned* out) {
    draws<9>(cfg, xy, out);
}
"""
# Hopper's pipes for the opcodes of a draw: the FMA pipe takes the integer
# multiplies (IMAD, IMAD.HI, IMAD.WIDE, counted one each), the ALU pipe the
# logic, compares, adds, shifts and selects; each pipe takes 64 lanes a clock
# a multiprocessor (INT32_OPS) and the two work at once.  The four schedulers
# issue one warp instruction a clock each, 128 lanes: twice INT32_OPS, the
# uniform-datapath instructions included.
FMA_PIPE = ("IMAD", "IMUL", "IDP", "FFMA", "FMUL", "FADD")
ALU_PIPE = ("LOP3", "LOP", "ISETP", "IADD3", "IADD", "SHF", "SHL", "SHR", "LEA", "SEL",
            "PRMT", "MOV", "IMNMX", "IABS", "FSEL", "FSETP", "PLOP3", "P2R", "R2P", "BMSK",
            "SGXT", "FLO", "BREV")


def _sass_opcodes(sass: str):
    """{function: {opcode: count}} of cuobjdump -sass output."""
    import re

    out, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = out.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and fn is not None and m.group(1) != "NOP":
            fn[m.group(1)] = fn.get(m.group(1), 0) + 1
    return out


def philox_draw_ops(cuda_build):
    """One Philox draw's operations by pipe from the SASS that nvcc gives
    philox.cuh for sm_90a (PHILOX_PROBE): {"fma", "alu", "issue", "ops",
    "opcodes"}; "ops" is the largest of the FMA pipe's, the ALU pipe's and
    half the issued instructions, in INT32_OPS lanes."""
    work = cuda_build.build_dir().parent / "philox_probe"
    work.mkdir(parents=True, exist_ok=True)
    (work / "philox_probe.cu").write_text(PHILOX_PROBE)
    nvcc = cuda_build._nvcc()
    subprocess.run([nvcc, "-cubin", "-gencode=arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-I", str(cuda_build.CSRC), "-o", str(work / "probe.cubin"),
                    str(work / "philox_probe.cu")], check=True, capture_output=True, timeout=120)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(work / "probe.cubin")], check=True,
                          capture_output=True, text=True, timeout=60).stdout
    fns = _sass_opcodes(sass)
    check({"one_draw", "nine_draws"} <= set(fns), f"probe functions not in the SASS: {list(fns)}")
    diff = {op: (fns["nine_draws"].get(op, 0) - fns["one_draw"].get(op, 0)) / 8
            for op in set(fns["nine_draws"]) | set(fns["one_draw"])}
    diff = {op: c for op, c in sorted(diff.items()) if c}
    fma = sum(c for op, c in diff.items() if op in FMA_PIPE)
    alu = sum(c for op, c in diff.items() if op in ALU_PIPE)
    issue = sum(diff.values())
    check(fma >= 10 and issue >= 30, f"a draw's SASS looks wrong: {diff}")
    return {"fma": fma, "alu": alu, "issue": issue, "ops": max(fma, alu, issue / 2),
            "opcodes": diff, "one_draw_kernel": fns["one_draw"]}


# Draws a cell of the universe for AE2D's net: stage 1 and the last stage one
# a cell (a draw serves four channels), stage 2 and the middle stage one a
# position of the half-resolution grid.
AE2D_DRAWS_PER_CELL = 1 + 0.25 + 0.25 + 1
# AE2D's net as the AE2D kernels compute it, multiply-adds a cell.  Stage 1
# is a lookup in a 512 x 4 table of its pre-activations (512 x 36
# multiply-adds once a call); stage 2 takes 18 a cell, the middle stage 2 and
# the last 4.  The backward recomputes those 24, takes dW1 from the counts
# of set taps of a pool window's maxima (36 a stage-1 pool window: 9 a cell),
# dW2 18, dWt1 2, dWt2 4, and the stage-1 (18), embedding (2) and middle (4)
# cotangents; the cells take none.
AE2D_FWD_MACS = 18 + 2 + 4
AE2D_BWD_MACS = AE2D_FWD_MACS + (9 + 18 + 2 + 4) + (18 + 2 + 4)


def _ae_flops(n, hw, backward):
    """Float32 operations of AE2D's net on n universes of hw cells: 2 a
    multiply-add, the table once, and 3 a cell for the error (the backward: 8
    a cell for the output cotangent)."""
    table = 2 * 512 * 36
    if not backward:
        return 2 * AE2D_FWD_MACS * n * hw + table + 3 * n * hw
    return 2 * AE2D_BWD_MACS * n * hw + table + 8 * n * hw


def ae_bound_parts(n, hw, nbytes, draw_ops, backward):
    """The whole-autoencoder function's least times (ms) on n universes of hw
    cells: its bytes over the memory rate, its float32 operations over the
    float32 rate and its Philox draws (AE2D_DRAWS_PER_CELL, draw_ops each;
    0: none drawn) over the integer rate."""
    return {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "fp32_ms": _ae_flops(n, hw, backward) / FP32_FLOPS * 1e3,
            "philox_ms": n * hw * AE2D_DRAWS_PER_CELL * draw_ops / INT32_OPS * 1e3}


def ae_bound(n, hw, nbytes, draw_ops, backward):
    """(ms, kind): the largest of ae_bound_parts."""
    parts = ae_bound_parts(n, hw, nbytes, draw_ops, backward)
    t_ops = max(parts["fp32_ms"], parts["philox_ms"])
    return ((parts["bytes_ms"], "bytes") if parts["bytes_ms"] >= t_ops
            else (t_ops, "operations"))


def dropout_bounds(draw_ops):
    """Rows 5b, 7b, 8b and 9b's bounds with their Philox draws counted
    (their kernels' shapes with dropout 0.1 at 64 universes of 256²), draw_ops
    a draw: the larger of the bound stated before (float32 operations or
    bytes) and the draws' integer time.  A draw serves a position's four
    channels."""
    n, hw = 64, 65536
    draws = {   # row: (draws a cell, the bound stated before)
        "5b decoder_loss_bwd (middle 1/4, last stage 1)": (1.25, 0.00275),
        "7b tail_bwd (the output, 1)": (1.0, 0.00751),
        "8b loss_tail_bwd (the output, 1)": (1.0, 0.00376),
        # 9b: its bytes, stage 1 a table lookup (the float32 recompute counted
        # before: 0.00901)
        "9b head_bwd (the pixels, 1)": (1.0, 0.00626),
    }
    out = {}
    for row, (d, stated) in draws.items():
        philox = n * hw * d * draw_ops / INT32_OPS * 1e3
        out[row] = {"philox_ms": philox, "stated_ms": stated, "bound_ms": max(stated, philox)}
    return out


def _rel_diff(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def phase_ae2d(torch, timer, cuda_build, philox):
    """The AE2D kernels (csrc/ae2d_fwd.cu, ae2d_bwd.cu) against the generic
    kernels at AE2D's widths, in one run: error within 1e-6 relative, each
    gradient leaf within 1e-5 of its largest entry (the pre-activations keep
    the generic sums, so only the error and weight-gradient sums run in other
    orders), over uint8 and packed src and obs, src = obs and not, dropout 0
    and 0.1, a quarter of the universes half blank (exact pool ties); the
    training forward's saved keep bits against philox_keep_mask, and the
    backward from them against the backward that draws; then both timed at
    rows 4a and 4b's shapes (the forward on 160 universes without dropout, the
    training forward and the backward on 64 with dropout 0.1, in turns), each
    call's device time by kernel and its device launches (torch.profiler), the
    host's time to enqueue a forward on one universe, each band kernel's
    registers, shared memory and resident blocks a multiprocessor, and the
    bounds with philox (philox_draw_ops) a draw."""
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.ops import bitpack, cuda_head as ch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    seed = 20240229
    cells = {n: (torch.rand((n, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
             for n in (64, 160)}
    cells[64][:16, :, :128] = 0   # blank regions: whole pool windows tie
    other = (torch.rand((64, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    words, other32 = bitpack.pack_grid(cells[64]), bitpack.pack_grid(other)
    ae = init_ae_params(gen, dev)
    ps = [ae[k][t] for k in ("conv1", "conv2", "deconv1", "deconv2") for t in ("w", "b")]
    gbar = torch.randn((64,), generator=gen, device=dev) / (64 * 65536)

    def generic(fn):
        ch.AE2D_KERNELS = False
        try:
            return fn()
        finally:
            ch.AE2D_KERNELS = True

    # AE2D against the generic kernels
    pairs = {"u8 src=obs": (cells[64], cells[64]), "u8 src!=obs": (cells[64], other),
             "u32 src, u8 obs": (words, other), "u8 src, u32 obs": (cells[64], other32),
             "u32 src=obs": (words, words)}
    agree = {}
    for label, (src, obs) in pairs.items():
        for p in (0.0, DROP_P):
            fwd = lambda: ch.ae_loss_fwd(src, *ps, obs, (2, 2), p, seed)
            bwd = lambda: ch.ae_loss_bwd(src, *ps, obs, gbar, (2, 2), p, seed)
            launched = ch.AE2D_FWD.launches
            err, grads = fwd(), bwd()
            check(ch.AE2D_FWD.launches == launched + 2, "the AE2D route did not run")
            err0, grads0 = generic(fwd), generic(bwd)
            e_err, e_leaf = _rel_diff(err, err0), max(_leaf_errors(grads, grads0))
            check(e_err < 1e-6, f"AE2D error ({label}, drop {p}) vs generic: {e_err}")
            check(e_leaf < 1e-5, f"AE2D gradients ({label}, drop {p}) vs generic: {e_leaf}")
            agree[f"{label}, drop {p}"] = {"err_max_rel": e_err, "leaf_max_rel": e_leaf}
    big = cells[160]
    e_big = _rel_diff(ch.ae_loss_fwd(big, *ps, big),
                      generic(lambda: ch.ae_loss_fwd(big, *ps, big)))
    check(e_big < 1e-6, f"AE2D error at [160] vs generic: {e_big}")
    agree["u8 src=obs [160], drop 0.0"] = {"err_max_rel": e_big}

    # the training forward's saved bits are the twin's mask, stage by stage
    src = cells[64]
    err_t, saved = ch._ae_fwd_launch(src, ps, src, (2, 2), DROP_P, seed, True)
    check(torch.equal(err_t, ch.ae_loss_fwd(src, *ps, src, (2, 2), DROP_P, seed)),
          "the saving forward's error differs from the forward's")
    for stage, mask in enumerate(ch.saved_keep_masks(saved)):
        want = ch.philox_keep_mask(seed, stage, tuple(mask.shape), DROP_P, dev)
        check(torch.equal(mask, want), f"saved keep bits of stage {stage} are not the twin's")
    check(_same_bits(ch._ae2d_bwd_kernel(src, ps, src, gbar, DROP_P, saved),
                     ch.ae_loss_bwd(src, *ps, src, gbar, (2, 2), DROP_P, seed)),
          "the backward from saved bits differs from the backward that draws them")

    # times, both routes in turns, and what each call runs on the device
    calls = {
        "fwd_160_no_drop": lambda: ch.ae_loss_fwd(big, *ps, big),
        "fwd_64_drop": lambda: ch.ae_loss_fwd(src, *ps, src, (2, 2), DROP_P, seed),
        "train_fwd_64_drop": lambda: ch._ae_fwd_launch(src, ps, src, (2, 2), DROP_P, seed, True),
        "bwd_64_drop": lambda: ch.ae_loss_bwd(src, *ps, src, gbar, (2, 2), DROP_P, seed),
    }
    timed = {"ae2d": {}, "generic": {}}
    for route in ("ae2d", "generic", "ae2d", "generic"):
        for name, fn in calls.items():
            run = fn if route == "ae2d" else (lambda fn=fn: generic(fn))
            timed[route].setdefault(name, []).append(timer.ms(run, 20))
    from_saved = lambda: ch._ae2d_bwd_kernel(src, ps, src, gbar, DROP_P, saved)
    timed["ae2d"]["bwd_64_drop_from_saved"] = [timer.ms(from_saved, 20)]
    # the host's time to enqueue a call (no synchronize in the loop), the
    # routes in turns: one universe, as a step of the sequential battery
    one = big[:1].contiguous()
    host_us = {}
    for route in ("ae2d", "generic", "ae2d", "generic"):
        fwd1 = lambda: ch.ae_loss_fwd(one, *ps, one)
        host_us.setdefault(f"{route} fwd_1", []).append(
            _host_us(torch, fwd1 if route == "ae2d" else lambda: generic(fwd1)))
    split = {name: _device_split(torch, fn) for name, fn in calls.items()}
    split["bwd_64_drop_from_saved"] = _device_split(torch, from_saved)
    split.update({f"generic {name}": _device_split(torch, lambda fn=fn: generic(fn))
                  for name, fn in calls.items() if name != "train_fwd_64_drop"})
    hw = 65536
    bounds = {}
    # from the saved bits: no draw; its inputs are also the saved embedding
    # (8 bytes a universe's 16 cells) and keep bits (2 + 1/4 + 1 bytes a 16)
    saved_bytes = 64 * hw // 16 * (8 + 2 + 0.25 + 1)
    for name, args in (
            ("fwd_160_no_drop", (160, hw, 2 * 160 * hw + 160 * 4, 0, False)),
            ("fwd_64_drop", (64, hw, 2 * 64 * hw + 64 * 4, philox["ops"], False)),
            ("bwd_64_drop", (64, hw, 2 * 64 * hw + 64 * 4 + 164 * 4, philox["ops"], True)),
            ("bwd_64_drop_from_saved",
             (64, hw, 2 * 64 * hw + 64 * 4 + 164 * 4 + saved_bytes, 0, True))):
        bounds[name] = dict(zip(("bound_ms", "bound_by"), ae_bound(*args)),
                            **ae_bound_parts(*args))
    return {"vs_generic": agree, "ms": timed, "host_us": host_us, "bound_ms": bounds,
            "philox_draw": philox, "device": split, "occupancy": _ae_occupancy(cuda_build),
            "dropout_bounds": dropout_bounds(philox["ops"])}


def _tile_plans(h, w):
    """The (band, tile, shared memory) plans the encoder and decoder-loss
    kernels take at [h, w], one instance (the specialised encoder at its
    three widths, forward and backward; the generic one at the RND
    predictor's and AE's; the AE2D decoder)."""
    from carle_tpu_torch.ops import cuda_head, cuda_stages

    return {"rnd_enc3": [cuda_head._enc3_plan(1, h, w, 4, 1, 4, b) for b in (False, True)],
            "target_enc3": [cuda_head._enc3_plan(1, h, w, 2, 1, 4, b) for b in (False, True)],
            "ae_enc3": [cuda_head._enc3_plan(1, h, w, 4, 2, 2, b) for b in (False, True)],
            "rnd_encoder_fwd": cuda_head._encoder_fwd_plan(h, w, 4, 1, 4, 2),
            "rnd_encoder_bwd": cuda_head._encoder_bwd_bands(h, w, 4, 1, 4, 2),
            "ae_encoder_fwd": cuda_head._encoder_fwd_plan(h, w, 4, 2, 2, 2),
            "ae_encoder_bwd": cuda_head._encoder_bwd_bands(h, w, 4, 2, 2, 2),
            "decoder_fwd_bwd": cuda_stages._decoder_bands(h, w, 2, 1, 1)}


def encoder_bound_parts(n, h, w, c1, c2, p1, cell_bytes, draw_ops, backward, mask=False,
                        saved=False):
    """The least times (ms) of the encoder function on n instances of [h, w]
    at widths (c1, c2) and pools (p1, 2), as the specialised kernels compute
    it: stage 1 a lookup in a 512-entry table (its 512 x 9 c1 multiply-adds
    once a call), stage 2 9 c1 c2 multiply-adds a stage-1 pixel; the backward
    recomputes stage 2 and adds dW2 and the stage-1 cotangent (9 c1 c2 each a
    stage-1 position) and dW1 over the pool-routed pixels (9 c1 a stage-1
    position).  Bytes: the cells (cell_bytes a cell) once, the output or its
    cotangent and the gradients once, the row mask, and ``saved``: the keep
    bits a training forward writes and its backward reads.  draw_ops: a
    Philox draw's operations (0: no dropout, or the backward from saved
    bits), one draw a cell for stage 1 and one a stage-1 pixel for stage 2."""
    h1w1 = n * (h // p1) * (w // p1)
    s2 = h1w1 * c2 * c1 * 9
    table = 512 * c1 * 9
    macs = (3 * s2 + h1w1 * c1 * 9 if backward else s2) + table
    outs = n * c2 * (h // (2 * p1)) * (w // (2 * p1))
    nbytes = (n * h * w * cell_bytes + 4 * outs + (4 * n * (h // p1) if mask else 0)
              + (4 * (c1 * 10 + c2 * (9 * c1 + 1)) if backward else 0)
              + ((h1w1 * p1 * p1 * c1 / 8 + outs) if saved else 0))
    return {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "fp32_ms": 2 * macs / FP32_FLOPS * 1e3,
            "philox_ms": (n * h * w + h1w1) * draw_ops / INT32_OPS * 1e3}


def _largest(parts):
    """(ms, kind) of the largest part of a bound."""
    t_ops = max(parts["fp32_ms"], parts["philox_ms"])
    return ((parts["bytes_ms"], "bytes") if parts["bytes_ms"] >= t_ops
            else (t_ops, "operations"))


def _decoder_bound(n, h, w, obs_bytes, backward, draw_ops=0, em=None, saved=False):
    """(ms, kind, parts) of an AE2D decoder-loss launch ([n, 2, h/4, w/4] ->
    [n, 1, h, w]) over the work the function needs: the output rows whose
    weight em [n, h] is not zero (None: all), the middle rows they read and
    the embedding rows those read (gx is written whole).  With dropout
    (draw_ops a draw) one draw a middle position and one an output cell,
    which the forward and a backward from its inputs each draw; ``saved``: a
    backward from the saved keep bits, which reads a byte a middle position
    and draws nothing."""
    if em is None:
        out_rows, mid_rows, emb_rows = n * h, n * h // 2, n * h // 4
    else:
        rows = em != 0
        mid = _mid_rows_read(rows)
        out_rows, mid_rows = int(rows.sum()), int(mid.sum())
        emb_rows = int(_mid_rows_read(mid).sum())
    outputs, middles, embs = out_rows * w, mid_rows * (w // 2), emb_rows * (w // 4)
    d1, d2 = 8 * middles, 4 * outputs   # multiply-adds of the two stages
    rows_bytes = 0 if em is None else n * h * 4
    if backward:
        nbytes = (4 * 2 * embs + 4 * 2 * n * (h // 4) * (w // 4) + outputs * obs_bytes
                  + rows_bytes + n * 4 + 50 * 4 + (middles if saved else 0))
        flops = 2 * 3 * (d1 + d2) + 8 * outputs
    else:
        nbytes = 4 * 2 * embs + outputs * obs_bytes + rows_bytes + n * 4
        flops = 2 * (d1 + d2) + 3 * outputs
    draws = 0 if saved else middles + outputs
    parts = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "fp32_ms": flops / FP32_FLOPS * 1e3,
             "philox_ms": draws * draw_ops / INT32_OPS * 1e3}
    return (*_largest(parts), parts)


def _generic_encoder(fn):
    """fn() on the generic encoder kernels: the specialised route off."""
    from carle_tpu_torch.ops import cuda_head

    cuda_head.ENC3_KERNELS = False
    try:
        return fn()
    finally:
        cuda_head.ENC3_KERNELS = True


def _generic_decoder(fn):
    """fn() on the generic decoder-loss kernels: the specialised route off."""
    from carle_tpu_torch.ops import cuda_stages

    cuda_stages.DEC2_KERNELS = False
    try:
        return fn()
    finally:
        cuda_stages.DEC2_KERNELS = True


def _generic_head(fn):
    """fn() with the head on its generic kernels (cuda_stages.HEAD2_KERNELS
    off)."""
    from carle_tpu_torch.ops import cuda_stages

    cuda_stages.HEAD2_KERNELS = False
    try:
        return fn()
    finally:
        cuda_stages.HEAD2_KERNELS = True


def _generic_tail(fn):
    """fn() on the generic tail kernel: the specialised route off."""
    from carle_tpu_torch.ops import cuda_stages

    cuda_stages.TAIL2_KERNELS = False
    try:
        return fn()
    finally:
        cuda_stages.TAIL2_KERNELS = True


def _tail2_held(torch, x, wt, b, act, stage, seed, what):
    """The specialised tail forward against the generic one forced at the
    same inputs, dropout off and on: bit for bit; the training forward's
    saved keep bits against the twin's Philox mask."""
    from carle_tpu_torch.ops import cuda_head, cuda_stages as cs

    out = {}
    for p in (0.0, DROP_P):
        y = cs.tail_fwd(x, wt, b, act, p, seed, stage)
        check(torch.equal(y, _generic_tail(lambda: cs.tail_fwd(x, wt, b, act, p, seed, stage))),
              f"tail2_fwd ({what}, drop {p}) is not the generic kernel's bit for bit")
        out[f"drop {p} bit_for_bit_vs_generic"] = True
    y, keep = cs._tail_fwd_launch(x, wt, b, act, DROP_P, seed, stage, True)
    check(torch.equal(y, cs.tail_fwd(x, wt, b, act, DROP_P, seed, stage)),
          f"tail2_fwd ({what}): the saving forward differs")
    want = cuda_head.philox_keep_mask(seed, stage, tuple(y.shape), DROP_P, y.device)
    check(torch.equal(cs.tail2_keep_mask(keep), want),
          f"tail2_fwd ({what}): saved keep bits differ from the Philox mask")
    out["saved_keep_rate"] = float(want.float().mean())
    return out


def _tail2_bwd_held(torch, x, wt, b, g, act, stage, seed, what):
    """The specialised tail backward against the generic one forced at the
    same inputs, dropout off and on: gx bit for bit, dW and db within 1e-5
    of each leaf; from the saved keep bits (as TailFn runs it) the same bits
    as drawing them, twice."""
    from carle_tpu_torch.ops import cuda_stages as cs

    out = {}
    for p in (0.0, DROP_P):
        got = cs.tail_bwd(x, wt, b, g, act, p, seed, stage)
        ref = _generic_tail(lambda: cs.tail_bwd(x, wt, b, g, act, p, seed, stage))
        check(torch.equal(got[2], ref[2]), f"tail2_bwd ({what}, drop {p}): gx differs from "
              "the generic kernel's")
        leaf = max(_leaf_errors(got[:2], ref[:2]))
        check(leaf < 1e-5, f"tail2_bwd ({what}, drop {p}) dW, db vs the generic kernel: {leaf}")
        out[f"drop {p} max_leaf_rel_err"] = leaf
        if p > 0:
            keep = cs._tail_fwd_launch(x, wt, b, act, p, seed, stage, True)[1]
            fed = _bits_twice(lambda: cs._tail2_bwd_kernel(x, wt, b, g, act, p, seed, stage,
                                                           keep=keep), f"tail2_bwd ({what})")
            check(all(torch.equal(a, t) for a, t in zip(fed, got)),
                  f"tail2_bwd ({what}): from the saved bits differs from drawing them")
    return out


def _tail2_occupancy(cuda_build):
    """Registers, shared memory and resident blocks a multiprocessor of the
    specialised tail kernels on the plans of the main shapes: the stage
    phase's forwards on 160 and backwards on 64 universes, and the spatial
    tier's slot blocks of 8192² on 4 slots."""
    import torch

    from carle_tpu_torch.ops import cuda_stages as cs

    sms = cs._multiprocessors(torch.device("cuda"))
    out = {}
    shapes = {"deconv1 [160,2,64,64]": (160, 2, 64, 64, 0),
              "deconv2 [160,1,128,128]": (160, 1, 128, 128, 1),
              "deconv1 [64,2,64,64]": (64, 2, 64, 64, 0),
              "deconv2 [64,1,128,128]": (64, 1, 128, 128, 1),
              "slot deconv1 [1,2,514,2048]": (1, 2, 514, 2048, 0),
              "slot deconv2 [1,1,1026,4096]": (1, 1, 1026, 4096, 1)}
    for label, (n, c, h, w, act) in shapes.items():
        ri, tj, smem = cs._tail2_plan(n, c, h, w, False, sms)
        for mode in (0, 1, 2):   # no dropout, dropout, dropout saving the bits
            out[f"tail2_fwd mode {mode} {label}"] = dict(
                _occupancy(cuda_build, "tail2_fwd", "tail2_fwd_occupancy", c, act, mode,
                           Big(smem))[0], dynamic_smem=smem, rows=ri, tile=tj)
        ri, tj, smem = cs._tail2_plan(n, c, h, w, True, sms)
        for keep in (0, 1, 2):   # none, drawn, read from the saved bits
            out[f"tail2_bwd keep {keep} {label}"] = dict(
                _occupancy(cuda_build, "tail2_bwd", "tail2_bwd_occupancy", c, act, keep,
                           Big(smem))[0], dynamic_smem=smem, rows=ri, tile=tj)
    worst = min(r["blocks_per_sm"] for r in out.values())
    check(worst >= 2, f"a tail2 plan keeps fewer than two blocks a multiprocessor: {out}")
    return out


def _mid_rows_read(rows):
    """[N, H/2] bool: the middle rows that the weighted output rows ([N, H]
    bool) read (output y reads middle rows (y - 1) // 2 and the next)."""
    even, odd = rows[:, 0::2], rows[:, 1::2]
    mid = even | odd
    mid[:, 1:] |= odd[:, :-1]
    mid[:, :-1] |= even[:, 1:]
    return mid


def _dec2_held(torch, x, dec, obs, gbar, p, seed, em=None, words=None, long_sums=False):
    """The specialised decoder-loss kernels (csrc/dec2_*.cu) against the
    generic ones at one shape: the error within 1e-6 relative (the terms are
    the generic kernel's bit for bit; only the sums' order differs) or, with
    ``long_sums`` (an instance's error sums 524,288 or more squared errors,
    where float32's order alone moves the generic kernel's sum past 1e-6),
    within 1e-6 of a float64 twin of the same terms, the generic kernel's
    distance from it reported beside; with dropout the saving forward's error and
    keep bits (philox_keep_mask's on the rows whose weight is not zero and the
    middle positions they read); ``words``, obs packed, bit for bit; and (gbar
    given) gx bit for bit (every activation and cotangent is the generic
    kernel's), each gradient leaf within 1e-5 of its largest entry and the
    backward from the saved bits equal to the one that draws them.  Returns
    ({the error's relative differences}, the largest leaf difference)."""
    from carle_tpu_torch.ops import cuda_head as ch, cuda_stages as cs

    n, _, he, we = x.shape
    h, w = 4 * he, 4 * we
    check(cs.decoder_route(h, w, (2, 1, 1)), "the decoder's width does not take dec2_*")
    fwd = lambda o: cs.decoder_loss_fwd(x, *dec, o, p, seed, em)
    err = fwd(obs)
    err0 = _generic_decoder(lambda: fwd(obs))
    rel_to = lambda a, b: float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    rel = {"vs_generic": rel_to(err, err0)}
    if long_sums:
        want = cs.decoder_loss_fwd_plain(x.double(), *(t.double() for t in dec), obs, p, seed, em)
        rel.update(vs_float64=rel_to(err.double(), want),
                   generic_vs_float64=rel_to(err0.double(), want))
        check(rel["vs_float64"] < 1e-6, f"dec2_fwd (drop {p}) vs a float64 twin: {rel}")
    else:
        check(rel["vs_generic"] < 1e-6, f"dec2_fwd (drop {p}) vs the generic kernel: {rel}")
    if words is not None:
        check(torch.equal(fwd(words), err), "dec2_fwd on packed obs differs from uint8 cells")
    saved = None
    if p > 0:
        err_s, saved = cs._decoder_fwd_launch(x, dec, obs, p, seed, em, True)
        check(torch.equal(err_s, err), "dec2's saving forward differs from the forward")
        rows = (torch.ones((n, h), dtype=torch.bool, device=x.device) if em is None
                else em != 0)
        keep1, keep2 = cs.dec2_keep_masks(saved)
        want1 = ch.philox_keep_mask(seed, ch.STAGE_DEC1, tuple(keep1.shape), p, x.device)
        want2 = ch.philox_keep_mask(seed, ch.STAGE_DEC2, tuple(keep2.shape), p, x.device)
        mid = _mid_rows_read(rows)
        check(torch.equal(keep1[:, 0][mid], want1[:, 0][mid]) and
              torch.equal(keep2[:, 0][rows], want2[:, 0][rows]),
              "dec2's saved keep bits are not the twin's")
    if gbar is None:
        return rel, 0.0
    bwd = lambda o: cs.decoder_loss_bwd(x, *dec, o, gbar, p, seed, em)
    grads = _bits_twice(lambda: bwd(obs), "dec2_bwd")
    grads0 = _generic_decoder(lambda: bwd(obs))
    check(torch.equal(grads[4], grads0[4]), f"dec2_bwd's gx (drop {p}) is not the generic one")
    leaf = max(_leaf_errors(grads, grads0))
    check(leaf < 1e-5, f"dec2_bwd (drop {p}) vs the generic kernel: {leaf}")
    if saved is not None:
        check(_same_bits(cs._dec2_bwd_kernel(x, dec, obs, gbar, p, em, saved), grads),
              "dec2_bwd from the saved bits differs from the backward that draws them")
    if words is not None:
        check(_same_bits(bwd(words), grads), "dec2_bwd on packed obs differs from uint8 cells")
    return rel, leaf


def _old_plan(fn, h, w, c1, c2, p1, p2):
    """fn() with the generic forward on the plan PR 7's planner gave: the
    whole width first wherever one band of it fits a block (_pick_tile),
    for the planner repair's before and after."""
    from carle_tpu_torch.ops import cuda_head as ch

    plan = ch._pick_tile(lambda r, t: ch._encoder_smem(h, w, c1, c2, p1, p2, r, t),
                         h // (p1 * p2), (8, 4, 2, 1), w // (p1 * p2), p1 * p2)
    repaired = ch._encoder_fwd_plan
    ch._encoder_fwd_plan = lambda *a: plan
    try:
        return _generic_encoder(fn), plan
    finally:
        ch._encoder_fwd_plan = repaired


def _enc3_held(torch, x, w4, pools, p, seed, mask=None, g=None, words=None,
               tol_generic=1e-5):
    """The specialised encoder kernels (csrc/enc3_*.cu) against the generic
    ones at one shape: the forward bit for bit (every pre-activation is the
    generic kernel's), with dropout the saving forward's output and keep
    bits (philox_keep_mask's, stage by stage), and (g given) each gradient
    leaf within tol_generic of its largest entry (only the weight-gradient
    sums run in another order) and the backward from the saved bits equal to
    the one that draws them; ``words``, the same cells packed, bit for bit.
    Returns the largest leaf difference (0 without g)."""
    from carle_tpu_torch.ops import cuda_head as ch

    c1, c2, p1 = w4[0].shape[0], w4[2].shape[0], pools[0]
    check(ch.encoder_route(ch.cell_shape(x)[2], ch.cell_shape(x)[3], (c1, c2), pools),
          f"widths {(c1, c2)}, pools {pools} do not take the specialised encoder")
    fwd = lambda src: ch.encoder_fwd(src, *w4, pools, p, seed, mask)
    out = fwd(x)
    check(torch.equal(out, _generic_encoder(lambda: fwd(x))),
          f"enc3_fwd (drop {p}) differs from the generic kernel")
    if words is not None:
        check(torch.equal(fwd(words), out), "enc3_fwd on packed words differs from uint8 cells")
    saved = None
    if p > 0:
        out_s, saved = ch._encoder_fwd_launch(x, w4, pools, p, seed, mask, True)
        check(torch.equal(out_s, out), "the saving forward's output differs from the forward's")
        for stage, keep in enumerate(ch.enc3_keep_masks(saved, c1, c2, p1)):
            want = ch.philox_keep_mask(seed, stage, tuple(keep.shape), p, keep.device)
            check(torch.equal(keep, want), f"saved keep bits of stage {stage} are not the twin's")
    if g is None:
        return 0.0
    bwd = lambda src: ch.encoder_bwd(src, *w4, g, pools, p, seed, mask)
    grads = _bits_twice(lambda: bwd(x), "enc3_bwd")
    err = max(_leaf_errors(grads, _generic_encoder(lambda: bwd(x))))
    check(err < tol_generic, f"enc3_bwd (drop {p}) vs the generic kernel: {err}")
    if saved is not None:
        check(_same_bits(ch._enc3_bwd_kernel(x, w4, g, pools, p, mask, saved), grads),
              "the backward from saved bits differs from the backward that draws them")
    if words is not None:
        check(_same_bits(bwd(words), grads), "enc3_bwd on packed words differs from uint8 cells")
    return err


# the encoder's gradients at 8192² sum over 134 million stage-1 positions
# (33 times the 256² checks'): a pool window whose maxima tie in the kernel's
# summation order and differ in the last bit in cuDNN's sends its share
# elsewhere, and the moved shares reach ~1e-3 of a leaf (9.4e-4 on the bands
# phase's draw); _tie_analysis holds the rest to 1e-4
TOL_TIES = 2e-3
TIE_ULPS = (4, 16, 64)   # "a few float32 ulps": the tie test's widths, reported side by side


def _ties(torch, a, pool, ulps):
    """(exact, near) bool [N, C, H/pool, W/pool]: pool windows of the
    activation ``a`` (float64) whose two largest values are positive and
    equal, or positive and apart by at most ``ulps`` float32 ulps."""
    n, c, h, w = a.shape
    win = a.reshape(n, c, h // pool, pool, w // pool, pool).permute(0, 1, 2, 4, 3, 5)
    top = win.reshape(n, c, h // pool, w // pool, pool * pool).topk(2, dim=-1).values
    v1, v2 = top[..., 0], top[..., 1]
    ulp = torch.exp2(torch.floor(torch.log2(v1.clamp_min(1e-30))) - 23)
    return (v1 > 0) & (v1 == v2), (v1 > 0) & (v1 != v2) & (v1 - v2 <= ulps * ulp)


def _tie_analysis(torch, x, w4, g, pools, drop_p, seed, mask):
    """Separates the pool-tie effect from error in the encoder's backward.
    The twin's stage-1 and stage-2 pre-activations in float64 mark the pool
    windows whose top two values are equal (exact ties: equal neighbourhoods)
    or within a few float32 ulps (near ties; TIE_ULPS); a window's share is
    removed by zeroing the output cotangent wherever the window reaches (its
    own stage-2 output, or for a stage-1 window every output whose 3x3
    stage-2 convolution over p2 x p2 pooled positions reads it).  Reported,
    each leaf's largest difference over its largest entry:

    * kernel against the float32 twin, every tie removed (the check asked
      for), and the share of outputs left;
    * kernel against the float32 and the float64 twin with only the near
      ties removed: exact ties share equally in both, so this covers almost
      every output and measures the kernel's own error; held to 1e-4 at the
      widest width (the near ties found are then a superset);
    * the float32 twin against the float64 twin on the same cotangent: what
      the twin's summation order does to exact ties.
    """
    import torch.nn.functional as F

    from carle_tpu_torch.ops import cuda_head

    p1, p2 = pools
    w1, b1, w2, b2 = (t.double() for t in w4)
    mask64 = None if mask is None else mask.double()
    xd = cuda_head.cells(x).double()
    d1, scale = cuda_head._dropout(F.conv2d(xd, w1, b1, padding=1), cuda_head.STAGE_ENC1,
                                   drop_p, seed)
    x1 = F.max_pool2d(F.relu(d1), p1)
    if mask64 is not None:
        x1 = x1 * mask64[:, None, :, None]
    d2, _ = cuda_head._dropout(F.conv2d(x1, w2, b2, padding=1), cuda_head.STAGE_ENC2, drop_p,
                               seed)

    def float64(gc):
        return cuda_head._encoder_bwd_from_planes(xd, d1, x1, d2, w2, gc.double(), pools,
                                                  scale, mask64)

    kernel = lambda gc: cuda_head.encoder_bwd(x, *w4, gc, pools, drop_p, seed, mask)
    twin = lambda gc: cuda_head.encoder_bwd_plain(x, *w4, gc, pools, drop_p, seed, mask)
    full = float64(g)
    out = {"all_outputs": dict(kernel_vs_twin=max(_leaf_errors(kernel(g), twin(g))),
                               kernel_vs_float64=max(_leaf_errors(kernel(g), full)),
                               twin_vs_float64=max(_leaf_errors(twin(g), full)))}
    del full
    reach = lambda t: F.max_pool2d(F.max_pool2d(t.any(dim=1, keepdim=True).double(), 3,
                                                stride=1, padding=1), p2) > 0
    for ulps in TIE_ULPS:
        e1, n1 = _ties(torch, F.relu(d1), p1, ulps)
        e2, n2 = _ties(torch, F.relu(d2), p2, ulps)
        near = n2 | reach(n1)
        tied = near | e2 | reach(e1)
        g_all, g_near = g * (~tied).to(g.dtype), g * (~near).to(g.dtype)
        f64 = float64(g_near)
        out[f"{ulps}_ulps"] = dict(
            exact_stage1=int(e1.sum()), near_stage1=int(n1.sum()),
            exact_stage2=int(e2.sum()), near_stage2=int(n2.sum()), outputs=int(g.numel()),
            outputs_outside_all_ties=int((~tied).sum()),
            kernel_vs_twin_outside_all_ties=max(_leaf_errors(kernel(g_all), twin(g_all))),
            outputs_outside_near_ties=int((~near).sum()),
            kernel_vs_twin_outside_near_ties=max(_leaf_errors(kernel(g_near), twin(g_near))),
            kernel_vs_float64_outside_near_ties=max(_leaf_errors(kernel(g_near), f64)),
            twin_vs_float64_outside_near_ties=max(_leaf_errors(twin(g_near), f64)))
        del e1, n1, e2, n2, near, tied, g_all, g_near, f64
    widest = out[f"{TIE_ULPS[-1]}_ulps"]
    for key in ("kernel_vs_twin_outside_near_ties", "kernel_vs_float64_outside_near_ties"):
        check(widest[key] < 1e-4, f"encoder_bwd outside the near-tied pool windows: {key} "
              f"{widest[key]} (1e-4 of each leaf)")
    return out


def phase_band_kernels(torch, timer, gen, philox):
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
    tol_ties = TOL_TIES
    results, report, ties = {}, {}, {}
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
    fwd_err, leaf_err, leaf_generic = 0.0, 0.0, 0.0
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
        # the specialised kernels against the generic ones: the forward bit
        # for bit, the gradients within 1e-4 of each leaf (4 million stage-1
        # positions a leaf, summed in another order), the saved bits
        leaf_generic = max(leaf_generic, _enc3_held(torch, xb, w4, (4, 2), p, seed, mask, g,
                                                    words=xw, tol_generic=tol))
    n, h, w = RND_BANDS, 32, size
    fwd_parts = encoder_bound_parts(n, h, w, 4, 1, 4, 1 / 8, philox["ops"], False, mask=True)
    bwd_parts = encoder_bound_parts(n, h, w, 4, 1, 4, 1 / 8, philox["ops"], True, mask=True)
    saved_parts = encoder_bound_parts(n, h, w, 4, 1, 4, 1 / 8, 0, True, mask=True, saved=True)
    saved = cuda_head._encoder_fwd_launch(xw, w4, (4, 2), DROP_P, seed, mask, True)[1]
    calls = {
        "fwd": lambda: cuda_head.encoder_fwd(xw, *w4, (4, 2), DROP_P, seed, mask),
        "fwd u8": lambda: cuda_head.encoder_fwd(xb, *w4, (4, 2), DROP_P, seed, mask),
        "bwd": lambda: cuda_head.encoder_bwd(xw, *w4, g, (4, 2), DROP_P, seed, mask),
    }
    timed = {}
    for route in ("enc3", "generic", "enc3", "generic"):
        for name, fn in calls.items():
            timed.setdefault(f"{route} {name}", []).append(
                timer.ms(fn if route == "enc3" else lambda fn=fn: _generic_encoder(fn),
                         10 if name.startswith("fwd") else 5))
    timed["enc3 bwd from saved"] = [timer.ms(
        lambda: cuda_head._enc3_bwd_kernel(xw, w4, g, (4, 2), DROP_P, mask, saved), 5)]
    timed["enc3 saving fwd"] = [timer.ms(
        lambda: cuda_head._encoder_fwd_launch(xw, w4, (4, 2), DROP_P, seed, mask, True), 10)]
    fwd_plain = timer.ms(lambda: cuda_head.encoder_fwd_plain(xw, *w4, (4, 2), DROP_P, seed,
                                                            mask), 2)
    bwd_plain = timer.ms(lambda: cuda_head.encoder_bwd_plain(xw, *w4, g, (4, 2), DROP_P, seed,
                                                            mask), 1)
    plans = {"enc3": (cuda_head._enc3_plan(n, h, w, 4, 1, 4, False),
                      cuda_head._enc3_plan(n, h, w, 4, 1, 4, True)),
             "generic": (cuda_head._encoder_fwd_plan(h, w, 4, 1, 4, 2, None, n),
                         cuda_head._encoder_bwd_bands(h, w, 4, 1, 4, 2, None, n))}
    for route in ("enc3", "generic"):
        pre = "enc3" if route == "enc3" else "encoder"
        b, by = _largest(fwd_parts)
        results[f"{pre}_fwd_mask"] = dict(
            max_abs_err=fwd_err, ms=timed[f"{route} fwd"][0], ms_u8=timed[f"{route} fwd u8"][0],
            plain_ms=fwd_plain, bound_ms=b, bound_by=by, library_ms=None,
            bound_parts=fwd_parts, plan=plans[route][0],
            ms_in_turns={k: v for k, v in timed.items() if k.startswith(route)},
            shape=f"u32 [{n},1,32,{size // 32}] (RND bands of {size}²), mask [{n},8], drop 0.1")
        log(f"{pre}_fwd_mask ok: {results[f'{pre}_fwd_mask']}")
        b, by = _largest(bwd_parts)
        results[f"{pre}_bwd_mask"] = dict(
            max_abs_err=leaf_err, max_leaf_rel_err=leaf_err, ms=timed[f"{route} bwd"][0],
            plain_ms=bwd_plain, bound_ms=b, bound_by=by, library_ms=None,
            bound_parts=bwd_parts, plan=plans[route][1],
            shape=f"u32 [{n},1,32,{size // 32}], g [{n},1,4,{size // 8}], mask, drop 0.1")
    results["enc3_bwd_mask"].update(
        max_leaf_rel_err_vs_generic=leaf_generic, ms_from_saved=timed["enc3 bwd from saved"][0],
        ms_saving_fwd=timed["enc3 saving fwd"][0], bound_parts_from_saved=saved_parts,
        bound_ms_from_saved=_largest(saved_parts)[0])
    log(f"enc3_bwd_mask ok: {results['enc3_bwd_mask']}")
    log(f"encoder_bwd_mask (generic) ok: {results['encoder_bwd_mask']}")

    # the frozen target's band forward (C1 = 2) beside the predictor's, as the
    # bands path runs them (no dropout for the target): the specialised
    # kernel, the generic kernel on the repaired plan and on PR 7's plan
    band_fwd = {}
    for name, params, p in (("target", target, 0.0), ("predictor", rnd, DROP_P)):
        wt = conv(params)
        fwd = lambda: cuda_head.encoder_fwd(xw, *wt, (4, 2), p, seed, mask)
        old, old_plan = _old_plan(fwd, h, w, *(t.shape[0] for t in wt[::2]), 4, 2)
        check(torch.equal(old, fwd()), f"the {name}'s band forward on PR 7's plan differs")
        r = {"drop_p": p, "old_plan": old_plan,
             "plan": cuda_head._encoder_fwd_plan(h, w, wt[0].shape[0], 1, 4, 2, None, n)}
        for _ in range(2):
            r.setdefault("enc3_ms", []).append(timer.ms(fwd, 10))
            r.setdefault("generic_ms", []).append(timer.ms(lambda: _generic_encoder(fwd), 10))
            r.setdefault("generic_old_plan_ms", []).append(
                timer.ms(lambda: _old_plan(fwd, h, w, wt[0].shape[0], 1, 4, 2)[0], 10))
        band_fwd[name] = r
    report["band_forward_target_vs_predictor"] = band_fwd
    log(f"band forwards, target and predictor: {json.dumps(band_fwd)}")
    for p in (0.0, DROP_P):   # after the checks above: its float64 planes take memory
        ties[f"rnd_bands_drop_{p}"] = _tie_analysis(torch, xb, w4, g, (4, 2), p, seed, mask)
        log(f"pool ties, RND bands, drop {p}: {json.dumps(ties[f'rnd_bands_drop_{p}'])}")
        torch.cuda.empty_cache()
    del xb, xw, g

    # -- row 6: the AE2D decoder loss on 128 bands (Prediction's geometry): the
    # specialised kernels (dec2_*) and the generic ones forced --------------------
    emb = cuda_head.encoder_fwd(universe, *conv(ae), (2, 2))          # [1, 2, 2048, 2048]
    starts, win = bh.decoder_windows(size // 4, PRED_BANDS)
    eb = bh._rows(emb, starts, win)                                      # [128, 2, 20, 2048]
    ob8 = bh._rows(universe, [4 * s for s in starts], 4 * win)           # [128, 1, 80, 8192]
    ob32 = bh._rows(words, [4 * s for s in starts], 4 * win)
    em = bh.decoder_row_weights(size // 4, PRED_BANDS, 1, dev)
    em_ones = torch.ones_like(em)
    gbar = torch.randn((PRED_BANDS,), generator=gen, device=dev) / (size * size)
    fwd_err, leaf_err, held = {}, {}, {}
    for route in ("dec2", "generic"):
        on = (lambda fn: fn()) if route == "dec2" else _generic_decoder
        fwd = lambda o, p, e: on(lambda: cuda_stages.decoder_loss_fwd(eb, *dec, o, p, seed, e))
        bwd = lambda o, p, e: on(lambda: cuda_stages.decoder_loss_bwd(eb, *dec, o, gbar, p, seed,
                                                                      e))
        fwd_err[route], leaf_err[route] = 0.0, 0.0
        for p in (0.0, DROP_P):
            got = fwd(ob8, p, em)
            want = cuda_stages.decoder_loss_fwd_plain(eb, *dec, ob8, p, seed, em)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
            fwd_err[route] = max(fwd_err[route], float(((got - want).abs() / want.abs()).max()))
            check(torch.equal(fwd(ob32, p, em), got),
                  f"{route} row-weighted decoder_loss_fwd on packed obs differs from uint8")
            check(torch.equal(fwd(ob8, p, em_ones), fwd(ob8, p, None)),
                  f"{route} decoder_loss_fwd with em of ones is not the unweighted kernel")
            grads = _bits_twice(lambda: bwd(ob8, p, em), f"{route} row-weighted decoder_loss_bwd")
            errs = _leaf_errors(grads, cuda_stages.decoder_loss_bwd_plain(eb, *dec, ob8, gbar, p,
                                                                          seed, em))
            check(max(errs) < tol,
                  f"{route} row-weighted decoder_loss_bwd (drop {p}) leaves differ: {errs}")
            leaf_err[route] = max(leaf_err[route], max(errs))
            check(same(bwd(ob32, p, em), grads),
                  f"{route} row-weighted decoder_loss_bwd on packed obs differs from uint8")
            check(same(bwd(ob8, p, em_ones), bwd(ob8, p, None)),
                  f"{route} decoder_loss_bwd with em of ones is not the unweighted kernel")
            if route == "dec2":
                held[f"drop {p}"] = _dec2_held(torch, eb, dec, ob8, gbar, p, seed, em, ob32,
                                               long_sums=True)
    saved = cuda_stages._decoder_fwd_launch(eb, dec, ob32, DROP_P, seed, em, True)[1]
    calls = {   # on the route in force
        "fwd": lambda: cuda_stages.decoder_loss_fwd(eb, *dec, ob32, DROP_P, seed, em),
        "fwd no drop": lambda: cuda_stages.decoder_loss_fwd(eb, *dec, ob32, 0.0, seed, em),
        "fwd u8": lambda: cuda_stages.decoder_loss_fwd(eb, *dec, ob8, DROP_P, seed, em),
        "bwd": lambda: cuda_stages.decoder_loss_bwd(eb, *dec, ob32, gbar, DROP_P, seed, em),
        "bwd no drop": lambda: cuda_stages.decoder_loss_bwd(eb, *dec, ob32, gbar, 0.0, seed, em),
        "bwd u8": lambda: cuda_stages.decoder_loss_bwd(eb, *dec, ob8, gbar, DROP_P, seed, em),
    }
    timed = {}
    for route in ("dec2", "generic", "dec2", "generic"):
        for name, fn in calls.items():
            timed.setdefault(f"{route} {name}", []).append(timer.ms(
                fn if route == "dec2" else lambda fn=fn: _generic_decoder(fn),
                10 if name.startswith("fwd") else 5))
    from_saved = timer.ms(lambda: cuda_stages._dec2_bwd_kernel(eb, dec, ob32, gbar, DROP_P, em,
                                                               saved), 5)
    saving_fwd = timer.ms(lambda: cuda_stages._decoder_fwd_launch(eb, dec, ob32, DROP_P, seed,
                                                                  em, True), 5)
    fwd_plain = timer.ms(lambda: cuda_stages.decoder_loss_fwd_plain(eb, *dec, ob32, DROP_P,
                                                                    seed, em), 2)
    bwd_plain = timer.ms(lambda: cuda_stages.decoder_loss_bwd_plain(eb, *dec, ob32, gbar,
                                                                    DROP_P, seed, em), 1)
    n, h, w = PRED_BANDS, 4 * win, size
    shape = (f"f32 x [{n},2,{win},{size // 4}], u32 obs [{n},1,{4 * win},{size // 32}], "
             f"em [{n},{4 * win}] (16 rows of weight 0 a band), drop 0.1")
    for backward, (row_dec2, row_generic) in ((False, ("dec2_fwd_em", "decoder_loss_fwd_em")),
                                              (True, ("dec2_bwd_em", "decoder_loss_bwd_em"))):
        kind = "bwd" if backward else "fwd"
        # the bound over the weighted rows (the work the function needs); every
        # row's beside it
        b, by, parts = _decoder_bound(n, h, w, 1 / 8, backward, philox["ops"], em)
        b_all = _decoder_bound(n, h, w, 1 / 8, backward, philox["ops"])[0]
        for row, route in ((row_dec2, "dec2"), (row_generic, "generic")):
            err = leaf_err[route] if backward else fwd_err[route]
            results[row] = dict(
                max_abs_err=err, ms=timed[f"{route} {kind}"][0],
                ms_no_drop=timed[f"{route} {kind} no drop"][0],
                ms_u8=timed[f"{route} {kind} u8"][0],
                plain_ms=bwd_plain if backward else fwd_plain, bound_ms=b, bound_by=by,
                library_ms=None, bound_parts=parts, bound_ms_every_row=b_all,
                ms_in_turns={k: v for k, v in timed.items() if k.startswith(f"{route} {kind}")},
                shape=shape + (f", gbar [{n}]" if backward else ""))
    results["dec2_fwd_em"].update(plan=cuda_stages._dec2_plan(n, h, w, False))
    b_saved, _, parts_saved = _decoder_bound(n, h, w, 1 / 8, True, em=em, saved=True)
    results["dec2_bwd_em"].update(
        ms_from_saved=from_saved, ms_saving_fwd=saving_fwd, bound_ms_from_saved=b_saved,
        bound_parts_from_saved=parts_saved, plan=cuda_stages._dec2_plan(n, h, w, True),
        vs_generic={k: {"err_rel": r, "max_leaf_rel_err": l} for k, (r, l) in held.items()})
    for row in ("dec2_fwd_em", "decoder_loss_fwd_em", "dec2_bwd_em", "decoder_loss_bwd_em"):
        log(f"{row} ok: {results[row]}")
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
        _enc3_held(torch, universe, w4, pools, DROP_P, seed)
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
    rel, leaf = _dec2_held(torch, emb, dec, universe, gb1, DROP_P, seed, words=words,
                           long_sums=True)
    width["ae_decoder_loss"] = dict(
        err_rel=rel, bwd_max_leaf_rel_err_vs_generic=leaf,
        fwd_ms=timer.ms(lambda: cuda_stages.decoder_loss_fwd(emb, *dec, words, DROP_P, seed),
                        10),
        bwd_ms=timer.ms(lambda: cuda_stages.decoder_loss_bwd(emb, *dec, words, gb1, DROP_P,
                                                             seed), 5),
        bwd_max_leaf_rel_err=max(errs))
    report["width_8192"] = width
    for name, params, pools in (("rnd_predictor", rnd, (4, 2)), ("ae_encoder", ae, (2, 2))):
        w4 = conv(params)
        side = size // (pools[0] * pools[1])
        gg = torch.randn((1, params["conv2"]["w"].shape[0], side, side), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(17))
        ties[f"{name}_{size}"] = _tie_analysis(torch, universe, w4, gg, pools, DROP_P, seed,
                                               None)
        log(f"pool ties, {name} at {size}²: {json.dumps(ties[f'{name}_{size}'])}")
        torch.cuda.empty_cache()
    report["pool_ties"] = ties
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
        "enc3_fwd": lambda x: (cuda_head.encoder_fwd(x, *w4, (4, 2), DROP_P, seed),),
        "enc3_bwd": lambda x: cuda_head.encoder_bwd(x, *w4, g, (4, 2), DROP_P, seed),
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
                if k == "enc3_fwd":
                    check(same(got, one[k]), "enc3_fwd in column tiles differs from one tile")
                check(worst < 1e-5, f"{k} in column tiles differs from one tile: {worst}")
            tiles[k] = dict(max_leaf_rel_err=worst, ms=timer.ms(lambda: fn(x32), 10),
                            one_tile_ms=one_ms[k])
    finally:
        cuda_head.TILE_CELLS = None
    report["forced_tiles_256"] = tiles
    log(f"column tiles forced at 256² (48 cells a tile) ok: {json.dumps(tiles)}")

    # -- more than 65,535 instances a launch -----------------------------------
    # the encoder's gradients sum over 65,600 small universes: a near-tied
    # pool window moves its share as at 8192² (TOL_TIES over every output);
    # _tie_analysis holds the rest to 1e-4 over every instance and over the
    # instances past 65,535 alone (the cotangent zero on the others)
    n = 65_600
    xs = (torch.rand((n, 1, 16, 32), generator=gen, device=dev) < 0.3).to(torch.uint8)
    ms = (torch.rand((n, 4), generator=gen, device=dev) < 0.8).to(torch.float32)
    gs = torch.randn((n, 1, 2, 4), generator=gen, device=dev)
    torch.testing.assert_close(cuda_head.encoder_fwd(xs, *w4, (4, 2), DROP_P, seed, ms),
                               cuda_head.encoder_fwd_plain(xs, *w4, (4, 2), DROP_P, seed, ms),
                               rtol=1e-4, atol=1e-4)
    errs = _leaf_errors(cuda_head.encoder_bwd(xs, *w4, gs, (4, 2), DROP_P, seed, ms),
                        cuda_head.encoder_bwd_plain(xs, *w4, gs, (4, 2), DROP_P, seed, ms))
    check(max(errs) < TOL_TIES, f"encoder_bwd on {n} instances: {errs}")
    past = (torch.arange(n, device=dev) >= 65_535).to(gs.dtype)[:, None, None, None]
    report["instances_65600_encoder_bwd"] = {
        "max_leaf_rel_err": errs,
        "ties": _tie_analysis(torch, xs, w4, gs, (4, 2), DROP_P, seed, ms),
        "ties_past_65535": _tie_analysis(torch, xs, w4, gs * past, (4, 2), DROP_P, seed, ms)}
    log(f"encoder_bwd on {n} instances: {json.dumps(report['instances_65600_encoder_bwd'])}")
    es = torch.rand((n, 2, 4, 8), generator=gen, device=dev)
    os_ = xs.expand(n, 1, 16, 32).contiguous()
    ws = torch.rand((n, 16), generator=gen, device=dev)
    gbs = torch.randn((n,), generator=gen, device=dev)
    torch.testing.assert_close(cuda_stages.decoder_loss_fwd(es, *dec, os_, DROP_P, seed, ws),
                               cuda_stages.decoder_loss_fwd_plain(es, *dec, os_, DROP_P, seed,
                                                                  ws), rtol=1e-4, atol=1e-4)
    dec_errs = _leaf_errors(cuda_stages.decoder_loss_bwd(es, *dec, os_, gbs, DROP_P, seed, ws),
                            cuda_stages.decoder_loss_bwd_plain(es, *dec, os_, gbs, DROP_P,
                                                               seed, ws))
    check(max(dec_errs) < tol, f"decoder_loss_bwd on {n} instances: {dec_errs}")
    report["instances_65600_max_leaf_rel_err"] = max(errs + dec_errs)
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


SPATIAL_SIZE, SPATIAL_SLOTS = 8192, 4   # job_spatial8k's universe, rows over 4 mesh slots


def _spatial_mesh(torch):
    from carle_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([torch.device("cuda")] * SPATIAL_SLOTS, "space")


def phase_spatial_kernels(torch, timer, gen):
    """Rows 13-15 at 8192² on 4 slots of one card, each against its plain
    twin on the card and the single-device engine on the unsharded universe,
    bit for bit: uint8 one generation and 8, packed 64 with the rule as data
    and with Life fixed; a small ragged case ([2, 4 x 64, 128] uint8, 3
    universes packed, a per-universe rule).  Device ms after an L2 flush,
    beside the engine's at the same total shape and the bound.  Rows 13 and
    15 also with the present kernel forced, bit for bit the route's, both
    timed in turns with their launches a call (row 13: one launch for the 8
    generations against 8; its CUPTI µs cold, plan, registers and blocks a
    multiprocessor).  Row 14 likewise: halo_words (one generation) against
    the present kernel forced, one launch each, and the env mode's step with
    its action and reset flag (_row14_extras)."""
    import numpy as np

    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_build, cuda_ca
    from carle_tpu_torch.parallel import cuda_halo
    from carle_tpu_torch.parallel.mesh import gather_rows, shard_rows

    dev = torch.device("cuda")
    mesh = _spatial_mesh(torch)
    size, life = SPATIAL_SIZE, rules.LIFE
    grid = (torch.rand((1, size, size), generator=gen, device=dev) < 0.3).to(torch.uint8)
    words = bitpack.pack_grid(grid)
    g8, g32 = shard_rows(grid, mesh), shard_rows(words, mesh)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a.parts, b.parts))
    cells, word_count = size * size, size * size // 32
    # every row's rule on the card, as the spatial stack holds it: an int
    # would be copied to the card in every timed call, and that copy waits
    # for the timer's sleep, so the host's work would be timed too
    life_t = torch.tensor(life, dtype=torch.int32, device=dev)
    zero_t = torch.zeros((), dtype=torch.int32, device=dev)
    results = {}
    # bounds as the engines': the universe read once and written once (the
    # TPU kernel keeps its shard on chip across the generations), the
    # operations once a generation (the uint8 rows the packed update's:
    # u8_bound)
    cases = {  # row: (kernel call, twin call, engine call, steps, bound, shape)
        "spatial_ca_step_words": (
            lambda: cuda_halo.spatial_ca_step_cuda(g8, life_t),
            lambda: cuda_halo.spatial_ca_step_plain(g8, life),
            lambda: cuda_ca.ca_multi_step(grid, life_t, 1), 1, u8_bound(cells, 1),
            f"u8 [1,{size},{size}] over {SPATIAL_SLOTS} slots, 1 generation, Life as data"),
        "spatial_multi_step_bits": (
            lambda: cuda_halo.spatial_multi_step_cuda(g8, life_t, 8),
            lambda: cuda_halo.spatial_multi_step_plain(g8, life, 8),
            lambda: cuda_ca.ca_multi_step(grid, life_t, 8), 8, u8_bound(cells, 8),
            f"u8 [1,{size},{size}] over {SPATIAL_SLOTS} slots, 8 generations, Life as data"),
        "bit_spatial_words": (
            lambda: cuda_halo.bit_spatial_multi_step_cuda(g32, life_t, 64),
            lambda: cuda_halo.bit_spatial_multi_step_plain(g32, life, 64),
            lambda: cuda_bitpack.bit_multi_step(words, life_t, 64), 64,
            bound_ms(8 * word_count + 4, 64 * OPS_PER_WORD * word_count, INT32_OPS),
            f"u32 [1,{size},{size // 32}] over {SPATIAL_SLOTS} slots, 64 generations, "
            "Life as data"),
        "bit_spatial_words_static": (
            lambda: cuda_halo.bit_spatial_multi_step_cuda(g32, zero_t, 64, ([3], [2, 3])),
            lambda: cuda_halo.bit_spatial_multi_step_plain(g32, 0, 64, ([3], [2, 3])),
            lambda: cuda_bitpack.bit_multi_step_static(words, [3], [2, 3], 64), 64,
            bound_ms(8 * word_count, 64 * OPS_PER_WORD_STATIC * word_count, INT32_OPS),
            f"u32 [1,{size},{size // 32}] over {SPATIAL_SLOTS} slots, 64 generations, "
            "Life fixed (-DSTATIC_RULE)"),
    }
    # rows 13-15 twice: the redesigned launcher (the route:
    # spatial_ca_step_words, spatial_multi_step_bits, bit_spatial_words) and
    # the present kernel forced (a generation a launch), timed in turns
    present_u8 = lambda fn: _flag_off(cuda_halo, "HALO_U8_BITS", fn)
    present_rows = {  # row: (present row, forcing, the new and present kernels)
        "spatial_ca_step_words": ("spatial_ca_step", _present_u8_step, cuda_halo.KERNEL_WORDS,
                                  cuda_halo.KERNEL_STEP),
        "spatial_multi_step_bits": ("spatial_multi_step", present_u8, cuda_halo.KERNEL_U8_BITS,
                                    cuda_halo.KERNEL_MULTI),
        "bit_spatial_words": ("bit_spatial_multi_step", _present_packed,
                              cuda_halo.KERNEL_BIT_WORDS, cuda_halo.KERNEL_BIT),
        "bit_spatial_words_static": ("bit_spatial_multi_step_static", _present_packed,
                                     cuda_halo.KERNEL_BIT_WORDS, cuda_halo.KERNEL_BIT)}
    for name, (kernel, twin, engine, steps, (b, by), shape) in cases.items():
        got = kernel()
        check(same(got, twin()), f"{name} at {size}² differs from its twin")
        check(torch.equal(gather_rows(got), engine()),
              f"{name} at {size}² differs from the single-device engine")
        common = dict(max_abs_err=0.0, engine_ms=timer.ms(engine, 5), plain_ms=timer.ms(twin, 1),
                      bound_ms=b, bound_by=by, library_ms=None, shape=shape)
        if name not in present_rows:
            results[name] = dict(common, ms=timer.ms(kernel, 5))
            # a launch is a generation (the launcher's count): launches x (ms -
            # bound ms) ranks in one unit only per launch
            results[name].update(launches_per_call=steps,
                                 ms_per_launch=results[name]["ms"] / steps,
                                 bound_ms_per_launch=b / steps)
            log(f"{name} ok: {results[name]}")
            continue
        present_row, force, new_kernel, present_kernel = present_rows[name]
        old = lambda: force(kernel)
        check(same(got, old()), f"{name} at {size}²: new and present kernels differ")
        launches = {}
        for route, fn, k in (("new", kernel, new_kernel), ("present", old, present_kernel)):
            before = k.launches
            fn()
            launches[route] = k.launches - before
        timed = {}
        for route in ("new", "present", "new", "present"):
            timed.setdefault(route, []).append(timer.ms(kernel if route == "new" else old, 5))
        for row, route in ((name, "new"), (present_row, "present")):
            results[row] = dict(common, ms=timed[route][0], ms_in_turns=timed[route],
                                launches_per_call=launches[route],
                                ms_per_launch=timed[route][0] / launches[route],
                                bound_ms_per_launch=b / launches[route])
        if name == "spatial_ca_step_words":
            check(launches == {"new": 1, "present": 1},
                  f"{name}: {launches} launches a call, not 1 and 1")
            results[name].update(_row14_extras(torch, timer, g8, life_t, kernel, old))
        elif name == "spatial_multi_step_bits":
            check(launches == {"new": 1, "present": steps},
                  f"{name}: {launches} launches a call, not 1 and {steps}")
            t, v, rows, strip, threads = plan = cuda_halo.u8_halo_plan(size // SPATIAL_SLOTS,
                                                                       size, steps)
            results[name].update(plan=plan, occupancy=_occupancy(
                cuda_build, "halo_step", "u8_halo_bits_occupancy", v, rows, t, size // 32,
                threads)[0], cupti_cold_us={
                    route: _cupti_us(torch, timer, fn, U8_HALO_KERNELS, f"row 13 {route}")
                    for route, fn in (("new", kernel), ("present", old))})
        else:
            results[name]["plan"] = cuda_halo.halo_plan(1, size // SPATIAL_SLOTS, size // 32,
                                                        steps, SPATIAL_SLOTS,
                                                        cuda_ca._multiprocessors(dev))
        log(f"{name} ok: {results[name]}")
        log(f"{present_row} (present kernel forced) ok: {results[present_row]}")
    results["bit_spatial_words"]["one_generation"] = _halo_one_generation(
        torch, timer, g32, words, size)
    # the ragged case: 3 universes, a per-universe rule, rows 4 x 64 over 4 slots
    small = torch.from_numpy((np.random.RandomState(5).rand(3, 4 * 64, 128) < 0.35)
                             .astype(np.uint8)).to(dev)
    vec = torch.tensor([rules.LIFE, rules.MORLEY, rules.DAY_AND_NIGHT], dtype=torch.int32,
                       device=dev)
    s8 = shard_rows(small[:2].contiguous(), mesh)
    check(torch.equal(gather_rows(cuda_halo.spatial_ca_step_cuda(s8, vec[:2])),
                      cuda_ca.ca_multi_step(small[:2], vec[:2], 1)), "ragged spatial_ca_step")
    check(torch.equal(gather_rows(cuda_halo.spatial_multi_step_cuda(s8, vec[:2], 7)),
                      cuda_ca.ca_multi_step(small[:2], vec[:2], 7)), "ragged spatial_multi_step")
    sw = bitpack.pack_grid(small)
    check(torch.equal(gather_rows(cuda_halo.bit_spatial_multi_step_cuda(
        shard_rows(sw, mesh), vec, 9)), cuda_bitpack.bit_multi_step(sw, vec, 9)),
        "ragged bit_spatial_multi_step")
    log("halo kernels, ragged case ([2, 256, 128] uint8, 3 universes packed, rule vector) ok")
    results["spatial_heads"] = _slot_head_kernels(torch, timer, gen, g32)
    return results


def _present_u8_step(fn):
    """fn() with the present one-generation uint8 halo kernel forced
    (cuda_halo.HALO_U8_WORDS off)."""
    from carle_tpu_torch.parallel import cuda_halo

    return _flag_off(cuda_halo, "HALO_U8_WORDS", fn)


ROW14_KERNELS = {"new": ("halo_words_kernel",), "present": ("halo_u8_kernel",)}


def _row14_extras(torch, timer, g8, life_t, new, old):
    """Row 14 at 8192² over 4 slots beyond the bare generation (``new`` and
    ``old``: it on the route and with the present kernel forced): each one's
    CUPTI µs cold; the env mode's step (64 x 64 actions at p = 0.2 in the
    centred window, rows 4064-4127 across the slot 1 / 2 edge; the reset flag
    unset and set) on the route, one launch, against the twin and the
    present kernel forced (the window XOR-ed into clones of slots 1 and 2,
    the present kernel, the flag applied after), bit for bit, timed in turns
    with CUPTI µs cold and each case's bound; the plan, registers and blocks
    a multiprocessor."""
    import numpy as np

    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.ops import cuda_build, cuda_ca
    from carle_tpu_torch.parallel import cuda_halo

    dev = life_t.device
    size, slots = SPATIAL_SIZE, SPATIAL_SLOTS
    cells = size * size
    cfg = EnvConfig(size, size, 64, 64, 1)
    action = torch.from_numpy((np.random.RandomState(14).rand(*cfg.action_shape) < 0.2)
                              .astype(np.uint8)).to(dev)
    unset, set_ = (torch.tensor(v, device=dev) for v in (False, True))
    env = {flag: (lambda r=r: cuda_halo.spatial_env_step_cuda(g8, action, life_t, cfg, r))
           for flag, r in (("unset", unset), ("set", set_))}
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a.parts, b.parts))
    out = {"cupti_cold_us": {route: _cupti_us(torch, timer, fn, ROW14_KERNELS[route],
                                              f"row 14 {route}")
                             for route, fn in (("new", new), ("present", old))}}
    for flag, fn in env.items():
        got = fn()
        check(same(got, cuda_halo.spatial_env_step_plain(g8, action, life_t, cfg,
                                                         set_ if flag == "set" else unset))
              and same(got, _present_u8_step(fn)),
              f"row 14 env step (reset {flag}): kernel, twin and present kernel differ")
        check(bool(any(p.any() for p in got.parts)) == (flag == "unset"),
              f"row 14 env step (reset {flag}): wrong zeros")
        before = (cuda_halo.KERNEL_WORDS.launches, cuda_halo.KERNEL_STEP.launches)
        fn()
        check((cuda_halo.KERNEL_WORDS.launches - before[0],
               cuda_halo.KERNEL_STEP.launches - before[1]) == (1, 0),
              f"row 14 env step (reset {flag}): not one halo_words launch")
        fns = {"new": fn, "present": lambda fn=fn: _present_u8_step(fn)}
        timed = _in_turns(timer, fns, rounds=2, reps=5)
        bound = (bound_ms(cells + 1, 0, INT32_OPS) if flag == "set"
                 else u8_bound(cells, 1, 4 + 64 * 64 + 1))
        split = {route: _device_split(torch, f, 10) for route, f in fns.items()}
        out[f"env_step_reset_{flag}"] = {
            "ms_in_turns": timed, "bound_ms": bound[0], "bound_by": bound[1],
            "cupti_cold_us": {route: _cupti_us(torch, timer, f, ROW14_KERNELS[route],
                                               f"row 14 env step {flag} {route}")
                              for route, f in fns.items()},
            # every kernel of a call, the present route's clones and flag pass included
            "device_launches_per_call": {r: s["launches_per_call"] for r, s in split.items()},
            "device_us_per_call_in_a_row": {r: s["device_us_per_call"]
                                            for r, s in split.items()}}
    hl = size // slots
    rows, strip, threads = plan = cuda_halo.halo_words_plan(1, hl, size, slots,
                                                            cuda_ca._multiprocessors(dev))
    out.update(plan=plan, occupancy=_occupancy(cuda_build, "halo_words", "halo_words_occupancy",
                                               rows, size, threads)[0])
    log(f"row 14 extras: {json.dumps(out)}")
    return out


def _halo_one_generation(torch, timer, g32, words, size):
    """Row 15 one generation a call, as the spatial stack's step launches it
    (parallel/packed_env.py): the redesigned launcher (the streaming kernel
    over every slot) and the present kernel forced, bit for bit, device ms
    after an L2 flush in turns and each kernel's CUPTI µs cold, the plan and
    its registers and blocks a multiprocessor; and the plans' occupancy at
    the 64-generation call."""
    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import cuda_bitpack, cuda_build, cuda_ca
    from carle_tpu_torch.parallel import cuda_halo
    from carle_tpu_torch.parallel.mesh import gather_rows

    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=words.device)
    new = lambda: cuda_halo.bit_spatial_multi_step_cuda(g32, life, 1)
    old = lambda: _present_packed(new)
    check(torch.equal(gather_rows(new()), gather_rows(old())) and torch.equal(
        gather_rows(new()), cuda_bitpack.bit_multi_step(words, life, 1)),
        "row 15, one generation: new kernel, present kernel and engine differ")
    entry = {}
    for route in ("new", "present", "new", "present"):
        entry.setdefault(f"{route}_ms", []).append(timer.ms(new if route == "new" else old, 30))
    entry["new_cupti_cold_us"] = _cupti_us(torch, timer, new, NEW_PACKED_KERNELS, "row 15")
    entry["present_cupti_cold_us"] = _cupti_us(torch, timer, old, PRESENT_PACKED_KERNELS,
                                               "row 15")
    sms = cuda_ca._multiprocessors(words.device)
    hl, nw = size // SPATIAL_SLOTS, size // 32
    entry["bound_ms"] = bound_ms(8 * nw * size + 4, OPS_PER_WORD * nw * size, INT32_OPS)[0]
    occupancy = {}
    for steps in (1, 64):
        t, v, rows, strip, threads = plan = cuda_halo.halo_plan(1, hl, nw, steps, SPATIAL_SLOTS,
                                                                sms)
        occupancy[str(plan)] = _occupancy(cuda_build, "halo_step", "bit_halo_words_occupancy",
                                          v, rows if t > 1 else 0, t, nw, threads)[0]
    entry["occupancy"] = occupancy
    log(f"row 15 one generation ([1,{size},{nw}] over {SPATIAL_SLOTS} slots): "
        f"{json.dumps(entry)}")
    return entry


def _slot_head_kernels(torch, timer, gen, g32):
    """The kernels SpaceSharding launches, at the blocks the spatial path
    gives them (8192² on 4 slots), against their twins: the row-masked
    encoder on packed words at RND2D's pools (4, 2) and AE2D's (2, 2), and
    AE2D's two decoder tails (relu, then sigmoid) on their halo'd blocks;
    the first slot (its mask zeroes the rows above the universe) and the
    second; dropout off and on with the slot's seed.  Forwards within 1e-4,
    the tails' gradients within 1e-4 of each leaf, the encoder's within
    TOL_TIES and 1e-4 outside the near-tied pool windows (_tie_analysis).
    The tails' kernels (tail2_*) also against the generic one forced
    (_tail2_held, _tail2_bwd_held), both timed in turns, with the plans and
    the registers and blocks a multiprocessor they give."""
    from carle_tpu_torch import EnvConfig, nets
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.mcl.rnd import init_predictor_params
    from carle_tpu_torch.ops import cuda_build, cuda_head, cuda_stages
    from carle_tpu_torch.parallel import spatial_heads as sh

    dev = torch.device("cuda")
    seed, tol, slots = 27182, 1e-4, (0, 1)
    obs = g32.map(lambda p: p[:, None])                       # [1, 1, 2048, 256] a slot
    rnd, ae = init_predictor_params(EnvConfig(), gen, dev), init_ae_params(gen, dev)
    wb = lambda p: (p["w"], p["b"])
    out = {}

    def close(got, want, what):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol, msg=lambda m: f"{what}: {m}")
        return float((got - want).abs().max())

    for net, params, pools in (("rnd", rnd, (4, 2)), ("ae", ae, (2, 2))):
        w4 = wb(params["conv1"]) + wb(params["conv2"])
        blocks = sh._encoder_blocks(obs, pools)
        for s in slots:
            xp, mask = blocks[s]
            s_seed = sh._shard_seed(seed, s)
            label = (f"{net} encoder, slot {s}: u32 {list(xp.shape)}, pools {pools}, "
                     f"mask {list(mask.shape)} ({int(mask.sum())} rows inside)")
            r = {"fwd_max_abs_err": 0.0, "bwd_max_leaf_rel_err": 0.0,
                 "bwd_max_leaf_rel_err_vs_generic": 0.0}
            for p in (0.0, DROP_P):
                y = cuda_head.encoder_fwd(xp, *w4, pools, p, s_seed, mask)
                r["fwd_max_abs_err"] = max(r["fwd_max_abs_err"], close(
                    y, cuda_head.encoder_fwd_plain(xp, *w4, pools, p, s_seed, mask), label))
                g = torch.randn(y.shape, generator=gen, device=dev)
                grads = _bits_twice(
                    lambda: cuda_head.encoder_bwd(xp, *w4, g, pools, p, s_seed, mask), label)
                errs = _leaf_errors(grads, cuda_head.encoder_bwd_plain(xp, *w4, g, pools, p,
                                                                       s_seed, mask))
                check(max(errs) < TOL_TIES, f"{label} (drop {p}) leaves differ: {errs}")
                r["bwd_max_leaf_rel_err"] = max(r["bwd_max_leaf_rel_err"], max(errs))
                r["bwd_max_leaf_rel_err_vs_generic"] = max(
                    r["bwd_max_leaf_rel_err_vs_generic"],
                    _enc3_held(torch, xp, w4, pools, p, s_seed, mask, g, tol_generic=tol))
            r["ties_drop"] = _tie_analysis(torch, xp, w4, g, pools, DROP_P, s_seed, mask)
            fwd = lambda: cuda_head.encoder_fwd(xp, *w4, pools, DROP_P, s_seed, mask)
            bwd = lambda: cuda_head.encoder_bwd(xp, *w4, g, pools, DROP_P, s_seed, mask)
            r["fwd_ms"], r["bwd_ms"] = timer.ms(fwd, 5), timer.ms(bwd, 3)
            r["generic_fwd_ms"] = timer.ms(lambda: _generic_encoder(fwd), 5)
            r["generic_bwd_ms"] = timer.ms(lambda: _generic_encoder(bwd), 3)
            out[label] = r
            log(f"slot heads: {label} ok: {json.dumps(r)}")
            torch.cuda.empty_cache()

    # AE2D's decoder on the blocks the path gives it: its embedding, then the
    # first tail's output, each with one halo row a side
    tag = nets.SpaceSharding(obs.mesh, obs.axis)
    enc = sh.encoder_spatial(obs, ae["conv1"], ae["conv2"], pools=(2, 2), drop_p=0.0,
                             train=False, seed=None, sharding=tag)   # [1, 2, 512, 2048]
    mid = sh.tail_spatial(enc, ae["deconv1"], act="relu", drop_p=0.0, train=False, seed=None,
                          stage=nets.STAGE_DEC1, sharding=tag)       # [1, 1, 1024, 4096]
    for x, params, act, stage in ((enc, ae["deconv1"], "relu", nets.STAGE_DEC1),
                                  (mid, ae["deconv2"], "sigmoid", nets.STAGE_DEC2)):
        blocks = sh._halo_rows(x, 1)
        for s in slots:
            xp, (wt, b) = blocks[s], wb(params)
            s_seed = sh._shard_seed(seed, s)
            n, c, h, w = xp.shape
            label = f"tail {act}, slot {s}: f32 {list(xp.shape)}"
            plans = [cuda_stages._tail2_plan(n, c, h, w, bwd, cuda_stages._multiprocessors(dev))
                     for bwd in (False, True)]
            act_code = cuda_stages.ACTS[act]
            r = {"plan": plans[0], "plan_bwd": plans[1],
                 "occupancy_fwd_drop": _occupancy(cuda_build, "tail2_fwd", "tail2_fwd_occupancy",
                                                  c, act_code, 1, Big(plans[0][2]))[0],
                 "occupancy_bwd_saved": _occupancy(cuda_build, "tail2_bwd",
                                                   "tail2_bwd_occupancy", c, act_code, 2,
                                                   Big(plans[1][2]))[0],
                 "generic_plan": cuda_stages._tail_bands(c, wt.shape[1], h, w),
                 "fwd_max_abs_err": 0.0, "bwd_max_leaf_rel_err": 0.0}
            r["fwd_vs_generic"] = _tail2_held(torch, xp, wt, b, act, stage, s_seed, label)
            for p in (0.0, DROP_P):
                y = cuda_stages.tail_fwd(xp, wt, b, act, p, s_seed, stage)
                r["fwd_max_abs_err"] = max(r["fwd_max_abs_err"], close(
                    y, cuda_stages.tail_fwd_plain(xp, wt, b, act, p, s_seed, stage), label))
                g = torch.randn(y.shape, generator=gen, device=dev)
                grads = _bits_twice(
                    lambda: cuda_stages.tail_bwd(xp, wt, b, g, act, p, s_seed, stage), label)
                errs = _leaf_errors(grads, cuda_stages.tail_bwd_plain(xp, wt, b, g, act, p,
                                                                      s_seed, stage))
                check(max(errs) < tol, f"{label} (drop {p}) leaves differ: {errs}")
                r["bwd_max_leaf_rel_err"] = max(r["bwd_max_leaf_rel_err"], max(errs))
            r["bwd_vs_generic"] = _tail2_bwd_held(torch, xp, wt, b, g, act, stage, s_seed, label)
            fwd = lambda: cuda_stages.tail_fwd(xp, wt, b, act, DROP_P, s_seed, stage)
            bwd = lambda: cuda_stages.tail_bwd(xp, wt, b, g, act, DROP_P, s_seed, stage)
            keep = cuda_stages._tail_fwd_launch(xp, wt, b, act, DROP_P, s_seed, stage, True)[1]
            for turn in (1, 2):
                r[f"fwd_ms_{turn}"], r[f"bwd_ms_{turn}"] = timer.ms(fwd, 5), timer.ms(bwd, 3)
                r[f"generic_fwd_ms_{turn}"] = timer.ms(lambda: _generic_tail(fwd), 5)
                r[f"generic_bwd_ms_{turn}"] = timer.ms(lambda: _generic_tail(bwd), 3)
            r["fwd_ms"], r["bwd_ms"] = r["fwd_ms_1"], r["bwd_ms_1"]
            r["bwd_from_saved_ms"] = timer.ms(lambda: cuda_stages._tail2_bwd_kernel(
                xp, wt, b, g, act, DROP_P, s_seed, stage, keep=keep), 3)
            out[label] = r
            log(f"slot heads: {label} ok: {json.dumps(r)}")
    return out


def _env_mode_leg(torch, cfg, acts, mesh, place=None):
    """The uint8 stack with Speed + Puffer through Rollout.run_actions over
    ``acts`` (on the card; a master reset among them), the universe sharded
    over ``mesh`` by shard_carry_spatial, or by ``place(carry)`` where given
    (None and None: one tensor, row 1's ca_step_words): 4 steps warm, the middle timed (wall ms a step after a
    synchronize, the port's kernel launches and the gathers a step; the
    leg's peak memory above what was allocated before it), the last 8 under
    torch.profiler (device ms and launches a step); then one env_step alone
    (its device launches by kernel and the memory it allocates past its
    inputs).  Returns (stats, rewards, universe)."""
    from torch.profiler import ProfilerActivity, profile

    from carle_tpu_torch import rules
    from carle_tpu_torch.env import env_step
    from carle_tpu_torch.mcl import puffer_def, speed_def
    from carle_tpu_torch.ops import cuda_build
    from carle_tpu_torch.parallel import shard_carry_spatial
    from carle_tpu_torch.rollout import Rollout

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ro = Rollout(cfg, [speed_def(cfg, reward_scale=1e-2), puffer_def(cfg, reward_scale=1e-3)],
                 device="cuda")
    carry = ro.init(ro.generator(0), rules.LIFE)
    if place is not None:
        carry = place(carry)
    elif mesh is not None:
        carry = shard_carry_spatial(carry, mesh, cfg)
    carry, r_warm = ro.run_actions(carry, acts[:4])
    torch.cuda.synchronize()
    timed = acts[4:-8]
    g0, c0 = ro.stack.gathers, cuda_build.launch_counts()
    t0 = time.perf_counter()
    carry, r_timed = ro.run_actions(carry, timed)
    torch.cuda.synchronize()
    steps = len(timed)
    stats = {"steps": len(acts), "wall_ms_per_step": (time.perf_counter() - t0) * 1e3 / steps,
             "kernel_launches_per_step": {k: (v - c0[k]) / steps for k, v in
                                          cuda_build.launch_counts().items() if v != c0[k]},
             "gathers_per_step": (ro.stack.gathers - g0) / steps,
             "peak_bytes_above_start": torch.cuda.max_memory_allocated() - base}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        carry, r_prof = ro.run_actions(carry, acts[-8:])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    stats["device_ms_per_step"] = sum(_device_us(e) for e in events) / 1e3 / 8
    stats["device_launches_per_step"] = sum(e.count for e in events) / 8
    stats["top_device_us_per_step"] = [
        {"name": e.key[:60], "us": _device_us(e) / 8, "calls_per_step": e.count / 8}
        for e in sorted(events, key=_device_us, reverse=True)[:8]]
    state, action = carry.stack.env, acts[5]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    env_step(state, action, cfg)
    torch.cuda.synchronize()
    stats["env_step_bytes_allocated"] = torch.cuda.max_memory_allocated() - base
    split = _device_split(torch, lambda: env_step(state, action, cfg), 5)
    stats["env_step_device"] = {k: split[k] for k in ("launches_per_call", "device_us_per_call",
                                                      "by_kernel")}
    universe = ro.stack.universe(carry.stack)
    return stats, torch.cat([r_warm, r_timed, r_prof]), universe


def phase_spatial(torch, cuda_build):
    """The row-sharded spatial tier at full size, scripts/pod_smoke.py's
    job_rdma and job_spatial8k with a mesh ported: one universe of 8192² over
    4 slots on one card.  The halo kernels through parallel.spatial against
    the single-device engines; the packed stack with the mesh through
    Rollout.run_actions (64 x 64 actions at p = 0.2): Speed dense (cells/s,
    gathers a step), speed_def_packed (no gather, no unpack), RND2D with
    SpaceSharding learning over 128 steps (2 updates, dropout on; cells/s,
    peak memory), AE2D with SpaceSharding, free_steps(64); the sharded
    universe and rewards against the mesh=None stack (bit for bit for Speed
    and the CA), RND2D with dropout off against BandTiling(512) on the same
    draw (rtol 1e-4 through 2 updates), AE2D with dropout off against the
    mesh=None stack (rtol 1e-4 through 3 updates); the RND2D leg profiled.
    The uint8 spatial env mode (shard_carry_spatial, the unchanged Rollout;
    Speed + Puffer, a master reset at step 40) against the mesh=None uint8
    stack, bit for bit: one halo_words launch and one gather a step, its
    env_step allocating no more than the new universe (_env_mode_leg).
    The launches counted are the path's alone: the engines and the mesh=None
    legs it is held against run before the counts are zeroed, the
    comparisons with dropout off after they are read."""
    import numpy as np

    from carle_tpu_torch import EnvConfig, nets, rules
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.mcl import ae2d_def, rnd2d_def, speed_def, speed_def_packed
    from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_ca
    from carle_tpu_torch.parallel import spatial
    from carle_tpu_torch.parallel.mesh import gather_rows
    from carle_tpu_torch.parallel.packed_env import PackedSpatialStack
    from carle_tpu_torch.rollout import Rollout

    dev = torch.device("cuda")
    mesh = _spatial_mesh(torch)
    size, steps = SPATIAL_SIZE, 128
    cfg = EnvConfig(height=size, width=size, action_height=64, action_width=64, instances=1)
    acts = torch.from_numpy((np.random.RandomState(1).rand(steps, *cfg.action_shape) < 0.2)
                            .astype(np.float32))
    out = {"slots": SPATIAL_SLOTS, "devices": [str(d) for d in mesh.devices]}

    def leg(defs, n_steps, m=mesh, agent=None):
        stack = PackedSpatialStack(cfg, defs, m)
        ro = Rollout(cfg, defs, agent, device="cuda", stack=stack)
        carry = ro.init(ro.generator(0), rules.LIFE)
        carry, r0 = ro.run_actions(carry, acts[:4])   # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        g0 = stack.gathers
        t0 = time.perf_counter()
        carry, r = ro.run_actions(carry, acts[4:n_steps])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (n_steps - 4)
        stats = {"steps": n_steps, "step_ms": step_s * 1e3, "cells_per_s": size * size / step_s,
                 "gathers_per_step": (stack.gathers - g0) / (n_steps - 4),
                 "unpacks": stack.unpacks, "gathers": stack.gathers,
                 "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        return stats, torch.cat([r0, r]), stack.universe(carry.stack), carry, ro

    # what the path is held against, before its launches are counted: the
    # single-device engines and the mesh=None stack
    grid = torch.from_numpy((np.random.RandomState(0).rand(1, size, size) < 0.3)
                            .astype(np.uint8)).to(dev)
    words = bitpack.pack_grid(grid)
    engine = {"spatial_ca_step": cuda_ca.ca_multi_step(grid, rules.LIFE, 1),
              "spatial_multi_step": cuda_ca.ca_multi_step(grid, rules.LIFE, 8),
              "bit_spatial_multi_step": cuda_bitpack.bit_multi_step(words, rules.LIFE, 8)}
    speed_defs = (("speed_dense", speed_def), ("speed_packed", speed_def_packed))
    one_device = {name: leg([make(cfg, reward_scale=1e-2)], 64, None)
                  for name, make in speed_defs}
    # the uint8 spatial env mode's actions: a master reset at step 40
    env_acts = acts[:64].clone().to(dev)
    env_acts[40] = 1.0
    env_one = _env_mode_leg(torch, cfg, env_acts, None)
    cuda_build.reset_launch_counts()

    # job_rdma: the halo kernels against the single-device engines
    check(torch.equal(gather_rows(spatial.spatial_ca_step(grid, rules.LIFE, mesh)),
                      engine["spatial_ca_step"]), "spatial_ca_step")
    check(torch.equal(gather_rows(spatial.spatial_multi_step(grid, rules.LIFE, 8, mesh)),
                      engine["spatial_multi_step"]), "spatial_multi_step")
    check(torch.equal(gather_rows(spatial.bit_spatial_multi_step(words, rules.LIFE, 8, mesh)),
                      engine["bit_spatial_multi_step"]), "bit_spatial_multi_step")
    del grid, words, engine

    # Speed dense and packed, against the mesh=None stack: bit for bit
    for name, make in speed_defs:
        stats, r, universe, _, _ = leg([make(cfg, reward_scale=1e-2)], 64)
        stats_one, r_one, universe_one, _, _ = one_device.pop(name)
        check(torch.equal(universe, universe_one), f"{name}: sharded universe differs")
        check(torch.equal(r, r_one), f"{name}: sharded rewards differ from mesh=None")
        out[name] = dict(stats, mesh_none_step_ms=stats_one["step_ms"])
    check(out["speed_packed"]["gathers"] == 0 and out["speed_packed"]["unpacks"] == 0,
          "speed_def_packed on the sharded stack gathered or unpacked")
    check(out["speed_dense"]["gathers_per_step"] == 1, "Speed dense: not one gather a step")

    # the uint8 spatial env mode (Speed + Puffer, a master reset at step 40)
    # against the mesh=None uint8 stack: bit for bit, one halo_words launch
    # and one gather a step, no clone
    stats, r, universe = _env_mode_leg(torch, cfg, env_acts, mesh)
    stats_one, r_one, universe_one = env_one
    check(torch.equal(universe, universe_one) and torch.equal(r, r_one),
          "uint8 env mode: sharded universe or rewards differ from mesh=None")
    check(stats["kernel_launches_per_step"] == {"spatial_ca_step_words": 1.0},
          f"uint8 env mode: launches a step {stats['kernel_launches_per_step']}, not one "
          "spatial_ca_step_words")
    check(stats_one["kernel_launches_per_step"] == {"ca_step_words": 1.0},
          f"mesh=None uint8 stack: launches a step {stats_one['kernel_launches_per_step']}")
    check(stats["gathers_per_step"] == 1, "uint8 env mode: not one gather a step")
    check(stats["env_step_bytes_allocated"] < size * size + 2**20,
          f"uint8 env mode: env_step allocated {stats['env_step_bytes_allocated']} bytes, more "
          "than the new universe (a clone of a slot?)")
    check(int(universe.sum()) > 0, "uint8 env mode: empty universe")
    out["env_mode"] = {"sharded": stats, "mesh_none": stats_one}
    del universe, universe_one, env_one

    # RND2D learning with SpaceSharding, dropout on: 2 updates in 128 steps
    tag = nets.SpaceSharding(mesh)
    stats, r, _, carry, _ = leg([rnd2d_def(cfg, batch_size=64, fused_head=tag)], steps)
    check(bool(torch.isfinite(r).all()), "sharded RND2D rewards are not finite")
    check(int(carry.stack.wrappers[0].updates) == 2, "sharded RND2D: not 2 updates")
    out["rnd2d"] = dict(stats, updates=2, reward_first=float(r[0, 0, 0]),
                        reward_last=float(r[-1, 0, 0]))
    del carry
    # AE2D with SpaceSharding (encoder, then the decoder's tails on shards)
    stats, r, _, carry, _ = leg([ae2d_def(cfg, batch_size=4, fused_head=tag)], 12)
    check(bool(torch.isfinite(r).all()) and int(carry.stack.wrappers[0].updates) == 3,
          "sharded AE2D: rewards not finite or not 3 updates")
    out["ae2d"] = dict(stats, updates=3)
    del carry
    # free_steps(64): the halo kernel's burst
    stack = PackedSpatialStack(cfg, [], mesh)
    state = stack.init(torch.Generator(device=dev).manual_seed(0), rules.LIFE, dev)
    state = state._replace(env=state.env._replace(grid=bitpack.pack_grid(
        (torch.rand((1, size, size), device=dev) < 0.3).to(torch.uint8))))
    state = stack.free_steps(state, 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = stack.free_steps(state, 64)
    torch.cuda.synchronize()
    out["free_steps_64"] = {"cells_per_s": size * size * 64 / (time.perf_counter() - t0)}
    del state, stack
    counts = cuda_build.launch_counts()
    out["packed_launches"] = cuda_build.packed_launch_counts()
    # the env mode's times in turns (mesh=None, sharded, sharded, mesh=None)
    for name, m in (("sharded", mesh), ("mesh_none", None)):
        second = _env_mode_leg(torch, cfg, env_acts, m)[0]
        for key in ("wall_ms_per_step", "device_ms_per_step", "peak_bytes_above_start"):
            out["env_mode"][name][key] = [out["env_mode"][name][key], second[key]]
    out["env_mode"]["turns"] = "mesh_none, sharded (the path's counts), sharded, mesh_none"
    log(f"spatial path ok: {json.dumps(out)}")
    log(f"spatial launches: {json.dumps(counts)}")

    # RND2D with dropout off: sharded against BandTiling(512), same draw
    kw = dict(batch_size=64, dropout=False)
    _, r_sharded, _, c1, _ = leg([rnd2d_def(cfg, fused_head=tag, **kw)], steps)
    _, r_banded, _, c2, _ = leg([rnd2d_def(cfg, fused_head=nets.BandTiling(RND_BANDS), **kw)],
                                steps, None)
    check(int(c1.stack.wrappers[0].updates) == int(c2.stack.wrappers[0].updates) == 2,
          "sharded / banded RND2D: not 2 updates each")
    torch.testing.assert_close(r_sharded, r_banded, rtol=1e-4, atol=0)
    out["rnd2d_sharded_vs_banded_max_rel_diff"] = float(
        ((r_sharded - r_banded).abs() / r_banded.abs()).max())
    del c1, c2
    # AE2D with dropout off: sharded against the mesh=None stack (the global
    # encoder and decoder-loss kernels), same draw, through 3 updates
    kw = dict(batch_size=4, dropout=False)
    _, r_sharded, _, c1, _ = leg([ae2d_def(cfg, fused_head=tag, **kw)], 12)
    _, r_one, _, c2, _ = leg([ae2d_def(cfg, **kw)], 12, None)
    check(int(c1.stack.wrappers[0].updates) == int(c2.stack.wrappers[0].updates) == 3,
          "sharded / one-device AE2D: not 3 updates each")
    torch.testing.assert_close(r_sharded, r_one, rtol=1e-4, atol=0)
    out["ae2d_sharded_vs_mesh_none_max_rel_diff"] = float(
        ((r_sharded - r_one).abs() / r_one.abs()).max())
    del c1, c2
    torch.cuda.empty_cache()

    # where the RND2D leg's step goes (random agent, as the bands phase)
    defs = [rnd2d_def(cfg, batch_size=64, fused_head=tag)]
    ro = Rollout(cfg, defs, make_random_agent(64, 64, 0.2), device="cuda",
                 stack=PackedSpatialStack(cfg, defs, mesh))
    out["profile_rnd2d"] = _profile_steps(torch, ro, ro.init(ro.generator(0), rules.LIFE), 32, 1)
    del ro
    log(f"spatial ok: {json.dumps({k: v for k, v in out.items() if not k.startswith('profile')})}")
    return counts, out


SPATIAL_2D = (2, 4)   # the env x space mesh: env groups x slots a ring, all on one card


def _mesh_2d(torch):
    from carle_tpu_torch.parallel.mesh import Mesh

    n_env, n_space = SPATIAL_2D
    return Mesh([[torch.device("cuda")] * n_space] * n_env, ("env", "space"))


def _packed_leg(torch, cfg, defs, acts, mesh, env_axis=None, warm=2, prof=0):
    """The packed stack with ``defs`` through Rollout.run_actions over
    ``acts`` (the universes sharded over ``mesh``, with ``env_axis`` their
    instances too; None: one tensor): ``warm`` steps, the next steps timed
    (wall ms a step after a synchronize, the port's kernel launches, the
    gathers a step, the peak memory above the start), the last ``prof``
    under torch.profiler (device ms and launches a step).  Returns (stats,
    rewards, universe, carry)."""
    from torch.profiler import ProfilerActivity, profile

    from carle_tpu_torch import rules
    from carle_tpu_torch.ops import cuda_build
    from carle_tpu_torch.parallel import PackedSpatialStack, shard_carry_packed
    from carle_tpu_torch.rollout import Rollout

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stack = PackedSpatialStack(cfg, defs, mesh, env_axis=env_axis)
    ro = Rollout(cfg, device="cuda", stack=stack)
    carry = ro.init(ro.generator(0), rules.LIFE)
    if mesh is not None:
        carry = shard_carry_packed(carry, mesh, cfg, env_axis=env_axis)
    carry, r_warm = ro.run_actions(carry, acts[:warm])
    torch.cuda.synchronize()
    timed = acts[warm:len(acts) - prof]
    g0, c0 = stack.gathers, cuda_build.launch_counts()
    t0 = time.perf_counter()
    carry, r_timed = ro.run_actions(carry, timed)
    torch.cuda.synchronize()
    n = len(timed)
    stats = {"steps": len(acts), "wall_ms_per_step": (time.perf_counter() - t0) * 1e3 / n,
             "kernel_launches_per_step": {k: (v - c0[k]) / n for k, v in
                                          cuda_build.launch_counts().items() if v != c0[k]},
             "gathers_per_step": (stack.gathers - g0) / n, "unpacks": stack.unpacks,
             "peak_bytes_above_start": torch.cuda.max_memory_allocated() - base}
    rewards = [r_warm, r_timed]
    if prof:
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            carry, r_prof = ro.run_actions(carry, acts[-prof:])
            torch.cuda.synchronize()
        rewards.append(r_prof)
        events = [e for e in p.key_averages()
                  if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
        stats["device_ms_per_step"] = sum(_device_us(e) for e in events) / 1e3 / prof
        stats["device_launches_per_step"] = sum(e.count for e in events) / prof
        stats["top_device_us_per_step"] = [
            {"name": e.key[:60], "us": _device_us(e) / prof, "calls_per_step": e.count / prof}
            for e in sorted(events, key=_device_us, reverse=True)[:8]]
    return stats, torch.cat(rewards), stack.universe(carry.stack), carry


def phase_spatial_2d(torch, cuda_build):
    """The env x space mesh at full size: 2 universes of 8192², one an env
    group, on a 2 x 4 mesh of 8 slots of one card (parallel.mesh.Mesh(...,
    ("env", "space"))), each leg held against the 4-slot one-axis mesh on the
    same 2 universes (the bare halo calls timed against it in turns before
    the counts are zeroed).  The path, counted from zero: the bare halo calls
    (spatial_multi_step, bit_spatial_multi_step, 8 generations; against the
    one-axis mesh and the twins on the 2-D shards, bit for bit); the uint8
    env mode (shard_carry_2d, Speed + Puffer, a master reset at step 40;
    bit for bit, a halo_words launch a ring a step and one gather a step);
    the packed stack with env_axis="env" and packed Morpho + Parsimony (bit
    for bit; its step time against the mesh=None packed stack's); RND2D +
    AE2D with SpaceSharding(mesh, "space", "env") learning (dropout on,
    batch 4: 3 updates in 12 steps) + Morpho + Parsimony (its universe bit
    for bit; timed and profiled).  After the counts are read: RND2D + AE2D
    with dropout off against the one-axis mesh, rtol 1e-4 through 3
    updates."""
    import numpy as np

    from carle_tpu_torch import EnvConfig, nets, rules
    from carle_tpu_torch.mcl import (ae2d_def, morpho_def_packed, parsimony_def_packed,
                                     rnd2d_def)
    from carle_tpu_torch.ops import bitpack
    from carle_tpu_torch.parallel import cuda_halo, shard_carry_2d, spatial
    from carle_tpu_torch.parallel.mesh import gather_rows, shard_rows

    dev = torch.device("cuda")
    mesh1, mesh2 = _spatial_mesh(torch), _mesh_2d(torch)
    size, n_env = SPATIAL_SIZE, SPATIAL_2D[0]
    cfg = EnvConfig(height=size, width=size, action_height=64, action_width=64,
                    instances=n_env)
    acts = torch.from_numpy((np.random.RandomState(1).rand(12, *cfg.action_shape) < 0.2)
                            .astype(np.float32)).to(dev)
    env_acts = torch.from_numpy((np.random.RandomState(2).rand(64, *cfg.action_shape) < 0.2)
                                .astype(np.float32)).to(dev)
    env_acts[40] = 1.0
    out = {"mesh": "2 x 4 (env x space) on one card", "universes": n_env,
           "devices": [str(d) for d in mesh2.devices]}
    morpho = lambda: [morpho_def_packed(cfg, reward_scale=1.0), parsimony_def_packed()]
    learners = lambda tag, **kw: [rnd2d_def(cfg, batch_size=4, fused_head=tag, **kw),
                                  ae2d_def(cfg, batch_size=4, fused_head=tag, **kw)]
    tag1 = nets.SpaceSharding(mesh1)
    tag2 = nets.SpaceSharding(mesh2, "space", "env")

    # what the path is held against, before its launches are counted: the
    # one-axis mesh on the same universes, the mesh=None packed stack
    grid = torch.from_numpy((np.random.RandomState(0).rand(n_env, size, size) < 0.3)
                            .astype(np.uint8)).to(dev)
    words = bitpack.pack_grid(grid)
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=dev)
    one_axis = {"spatial_multi_step": gather_rows(spatial.spatial_multi_step(grid, life, 8,
                                                                            mesh1)),
                "bit_spatial_multi_step": gather_rows(spatial.bit_spatial_multi_step(
                    words, life, 8, mesh1))}
    x2, w2 = shard_rows(grid, mesh2, "space", "env"), shard_rows(words, mesh2, "space", "env")
    twins = {"spatial_multi_step": gather_rows(cuda_halo.spatial_multi_step_plain(x2, life, 8)),
             "bit_spatial_multi_step": gather_rows(cuda_halo.bit_spatial_multi_step_plain(
                 w2, life, 8))}
    # the bare calls' device ms, a launch a ring against one launch, in turns
    x1, w1, timer = shard_rows(grid, mesh1), shard_rows(words, mesh1), Timer(torch)
    out["halo_ms_in_turns"] = _in_turns(timer, {
        "spatial_multi_step_one_axis": lambda: spatial.spatial_multi_step(x1, life, 8),
        "spatial_multi_step_2d": lambda: spatial.spatial_multi_step(x2, life, 8),
        "bit_spatial_multi_step_one_axis": lambda: spatial.bit_spatial_multi_step(w1, life, 8),
        "bit_spatial_multi_step_2d": lambda: spatial.bit_spatial_multi_step(w2, life, 8)})
    del x1, w1, timer
    env_one = _env_mode_leg(torch, cfg, env_acts, mesh1)
    morpho_one = _packed_leg(torch, cfg, morpho(), acts[:8], mesh1)
    morpho_none = _packed_leg(torch, cfg, morpho(), acts[:8], None)
    check(torch.equal(morpho_one[1], morpho_none[1]) and torch.equal(morpho_one[2],
                                                                      morpho_none[2]),
          "packed Morpho: the one-axis mesh differs from mesh=None")
    cuda_build.reset_launch_counts()

    # the bare halo calls on the 2-D shards
    got = {"spatial_multi_step": gather_rows(spatial.spatial_multi_step(x2, life, 8)),
           "bit_spatial_multi_step": gather_rows(spatial.bit_spatial_multi_step(w2, life, 8))}
    for name, g in got.items():
        check(torch.equal(g, one_axis[name]) and torch.equal(g, twins[name]),
              f"{name} on 2-D shards differs from the one-axis mesh or the twin")
    out["halo_launches"] = {k: v for k, v in cuda_build.launch_counts().items() if v}
    del grid, words, x2, w2, got, one_axis, twins

    # the uint8 env mode on the 2-D mesh: Speed + Puffer, a master reset
    stats, r, universe = _env_mode_leg(torch, cfg, env_acts, mesh2,
                                       place=lambda c: shard_carry_2d(c, mesh2, cfg))
    stats_one, r_one, universe_one = env_one
    check(torch.equal(universe, universe_one) and torch.equal(r, r_one),
          "uint8 env mode on 2 x 4: universe or rewards differ from the one-axis mesh")
    check(stats["kernel_launches_per_step"] == {"spatial_ca_step_words": float(n_env)},
          f"uint8 env mode on 2 x 4: launches a step {stats['kernel_launches_per_step']}, "
          f"not {n_env} spatial_ca_step_words (one a ring)")
    check(stats["gathers_per_step"] == 1, "uint8 env mode on 2 x 4: not one gather a step")
    check(int(universe.sum()) > 0, "uint8 env mode on 2 x 4: empty universe")
    out["env_mode"] = {"2d": stats, "one_axis": stats_one}
    del universe, universe_one, env_one

    # packed Morpho + Parsimony on the 2-D mesh: bit for bit
    stats, r, universe, _ = _packed_leg(torch, cfg, morpho(), acts[:8], mesh2, "env", prof=2)
    check(torch.equal(r, morpho_one[1]) and torch.equal(universe, morpho_one[2]),
          "packed Morpho on 2 x 4 differs from the one-axis mesh")
    check(stats["gathers_per_step"] == 0 and stats["unpacks"] == 0,
          "packed Morpho on 2 x 4 gathered or unpacked")
    out["morpho"] = {"2d": stats, "one_axis": morpho_one[0], "mesh_none": morpho_none[0]}
    log("packed Morpho + Parsimony at 8192² x 2, wall ms a step: 2 x 4 "
        f"{stats['wall_ms_per_step']:.3f}, one-axis 4 slots "
        f"{morpho_one[0]['wall_ms_per_step']:.3f}, mesh=None "
        f"{morpho_none[0]['wall_ms_per_step']:.3f}")
    del morpho_one, morpho_none

    # the whole stack: RND2D + AE2D on the 2-D shards, learning, dropout on
    stats, r, universe_full, carry = _packed_leg(torch, cfg, learners(tag2) + morpho(), acts,
                                                 mesh2, "env", prof=4)
    check(bool(torch.isfinite(r).all()), "the 2-D stack's rewards are not finite")
    check(all(int(w.updates) == 3 for w in carry.stack.wrappers[:2]),
          "the 2-D stack: RND2D and AE2D not 3 updates each")
    out["stack"] = stats
    del carry
    counts = cuda_build.launch_counts()
    log(f"spatial_2d launches: {json.dumps({k: v for k, v in counts.items() if v})}")

    # RND2D + AE2D with dropout off: the 2-D mesh against the one-axis mesh
    _, r2, u2, c2 = _packed_leg(torch, cfg, learners(tag2, dropout=False), acts, mesh2, "env")
    _, r1, u1, c1 = _packed_leg(torch, cfg, learners(tag1, dropout=False), acts, mesh1)
    check(all(int(w.updates) == 3 for c in (c1, c2) for w in c.stack.wrappers),
          "RND2D + AE2D, dropout off: not 3 updates each")
    check(torch.equal(u2, u1) and torch.equal(universe_full, u1),
          "the 2-D stack's universe differs from the one-axis mesh's")
    torch.testing.assert_close(r2, r1, rtol=1e-4, atol=0)
    out["learners_2d_vs_one_axis_max_rel_diff"] = float(((r2 - r1).abs() / r1.abs()).max())
    del c1, c2
    torch.cuda.empty_cache()
    log(f"spatial_2d ok: {json.dumps(out)}")
    return counts, out



ENV_MESH_SLOTS = 4          # the env mesh: slots of one card, a ring of one slot each
ENV_MESH_UNIVERSES = 64     # train-64's batch, 16 universes a slot
ENV_MESH_PROFILE_STEPS = 32


def _env_mesh(torch):
    from carle_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([torch.device("cuda")] * ENV_MESH_SLOTS, "env")


def _launches_per_step(cuda_build, before, steps):
    return {k: (v - before[k]) / steps for k, v in cuda_build.launch_counts().items()
            if v != before[k]}


def _env_mesh_train(torch, train_mcl, mesh, tmp, name, **kw):
    """train_mcl.train at train-64's geometry (4 rulesets x 128 steps, RND2D +
    AE2D learning, dropout on) on ``mesh``: (history, segments, wall s), the
    learner states read back from the checkpoints checked."""
    import numpy as np

    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.checkpoint import load_pytree
    from carle_tpu_torch.mcl import ae2d_def, rnd2d_def

    segments = []
    t0 = time.perf_counter()
    hist = train_mcl.train(instances=ENV_MESH_UNIVERSES, height=256, width=256,
                           steps=(1, 128), batch_size=64, seed=0,
                           log_dir=os.path.join(tmp, name), segment_callback=segments.append,
                           device="cuda", mesh=mesh, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(hist.shape == (512,) and np.isfinite(hist).all(), f"{name}: training rewards")
    models = os.path.join(tmp, name, "models")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = EnvConfig(instances=ENV_MESH_UNIVERSES)
    for wname, make in (("RND2D", rnd2d_def), ("AE2D", ae2d_def)):
        like = make(cfg).init(gen, torch.device("cuda"))
        state = load_pytree(train_mcl._find_checkpoint(models, wname), like)
        check(int(state.updates) == 8, f"{name}: {wname} reports {int(state.updates)} "
              "updates, not 8")
    first, last = segments[0]["mean_reward"], segments[-1]["mean_reward"]
    check(last < first, f"{name}: the bonus did not fall ({first:.4e} -> {last:.4e})")
    return hist, segments, wall


def _env_mesh_stack(torch, cuda_build, cfg, mesh, steps, dropout):
    """RND2D + AE2D (batch 64) on train-64's stack, the random agent, ``steps``
    steps through Rollout.run on ``mesh`` (instance shards) or one device:
    (rewards, universe, carry, stats: wall ms, launches and gathers a step)."""
    from carle_tpu_torch import rules
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.mcl import ae2d_def, rnd2d_def
    from carle_tpu_torch.parallel import shard_carry
    from carle_tpu_torch.rollout import Rollout

    kw = dict(batch_size=64, dropout=dropout, fused_head=mesh or False)
    ro = Rollout(cfg, [rnd2d_def(cfg, **kw), ae2d_def(cfg, **kw)], make_random_agent(64, 64, 0.1),
                 device="cuda")
    carry = ro.init(ro.generator(0), rules.LIFE)
    if mesh is not None:
        carry = shard_carry(carry, mesh, cfg)
    torch.cuda.synchronize()
    c0, g0, t0 = cuda_build.launch_counts(), ro.stack.gathers, time.perf_counter()
    carry, rewards = ro.run(carry, steps)
    torch.cuda.synchronize()
    stats = {"wall_ms_per_step": (time.perf_counter() - t0) * 1e3 / steps,
             "kernel_launches_per_step": _launches_per_step(cuda_build, c0, steps),
             "gathers_per_step": (ro.stack.gathers - g0) / steps}
    return rewards, ro.stack.universe(carry.stack), carry, stats


def _env_mesh_profiles(torch, mesh):
    """Wall and device ms a step, launches, peak memory: train-64's learning
    stack (dropout on) and the batched battery's stack (160 universes, the
    shipped wrappers frozen), each on ``mesh`` and on one device
    (_profile_steps, ENV_MESH_PROFILE_STEPS steps)."""
    from carle_tpu_torch import EnvConfig, rules
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.evaluation import eval as ev
    from carle_tpu_torch.mcl import ae2d_def, rnd2d_def
    from carle_tpu_torch.parallel import shard_carry
    from carle_tpu_torch.rollout import Rollout

    out = {}
    train_cfg, battery_cfg = EnvConfig(instances=ENV_MESH_UNIVERSES), EnvConfig(instances=160)
    bits = torch.tensor([ev.battery_rule_bits(rs, True) for rs in ev.DEFAULT_RULES] * 32,
                        dtype=torch.int32)
    for name, m in (("mesh", mesh), ("mesh_none", None)):
        fused = m or False
        ro = Rollout(train_cfg, [rnd2d_def(train_cfg, fused_head=fused),
                                 ae2d_def(train_cfg, fused_head=fused)],
                     make_random_agent(64, 64, 0.1), device="cuda")
        carry = ro.init(ro.generator(0), rules.LIFE)
        carry = shard_carry(carry, m, train_cfg) if m is not None else carry
        out[f"train_{name}"] = _profile_steps(torch, ro, carry, ENV_MESH_PROFILE_STEPS,
                                              ENV_MESH_UNIVERSES)
        ro = Rollout(battery_cfg, ev.wrapper_defs(battery_cfg, ev.DEFAULT_WRAPPERS, True, fused),
                     make_random_agent(64, 64, 0.1), device="cuda")
        carry = ro.with_rules(ro.init(ro.generator(0), 0), bits)
        carry = carry._replace(stack=carry.stack._replace(
            wrappers=ev.inject_wrapper_checkpoints(carry.stack.wrappers, ev.DEFAULT_WRAPPERS)))
        carry = shard_carry(carry, m, battery_cfg) if m is not None else carry
        carry, _ = ro.reset(carry)
        g0 = ro.stack.gathers
        out[f"battery_{name}"] = _profile_steps(torch, ro, carry, ENV_MESH_PROFILE_STEPS, 160)
        out[f"battery_{name}"]["gathers_per_step"] = (
            (ro.stack.gathers - g0) / (16 + 2 * ENV_MESH_PROFILE_STEPS))
        del ro, carry
        torch.cuda.empty_cache()
    return out


def _batch_routes_held(torch, cuda_build, mesh, gen):
    """(c) The six batch-axis routes on train-64's 64 universes of 256² over
    the mesh's 4 slots (a slot's shapes: train-64's 16), dropout off and on:
    each slot's kernel output against that slot's plain twin seeded
    _shard_seed(seed, s), within 1e-4; the parameter gradients (and the
    input's, for a float input), summed over the slots by autograd, against
    the twins' summed over the slots: the pooled routes (head, encoder, AE)
    within TOL_TIES of each leaf and the encoder's slot 0 by _tie_analysis
    (1e-4 outside the near-tied pool windows), the unpooled ones within 1e-4;
    each kernel launched once a slot."""
    from carle_tpu_torch import EnvConfig, nets
    from carle_tpu_torch.mcl.ae import init_ae_params
    from carle_tpu_torch.mcl.rnd import init_predictor_params
    from carle_tpu_torch.ops import cuda_head as ch
    from carle_tpu_torch.ops import cuda_stages as cs
    from carle_tpu_torch.parallel.spatial_heads import _shard_seed

    torch.backends.cudnn.allow_tf32 = False       # the twins in full float32, as main()
    torch.backends.cuda.matmul.allow_tf32 = False  # sets them (the phase may run alone)
    dev, n, seed, slots = torch.device("cuda"), ENV_MESH_UNIVERSES, 31415, ENV_MESH_SLOTS
    k = n // slots
    rnd = init_predictor_params(EnvConfig(instances=n), gen, dev)
    ae = init_ae_params(gen, dev)
    obs = (torch.rand((n, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    with torch.no_grad():
        emb = nets.conv_encoder(obs, ae["conv1"], ae["conv2"], pools=(2, 2))   # [n, 2, 64, 64]
        mid = nets.conv_tail(emb, ae["deconv1"], act="relu")                   # [n, 1, 128, 128]
    wb = lambda *ps: [t for p in ps for t in (p["w"], p["b"])]
    pd = lambda q: [{"w": q[i], "b": q[i + 1]} for i in range(0, len(q), 2)]
    e1, d1, d2 = nets.STAGE_ENC1, nets.STAGE_DEC1, nets.STAGE_DEC2
    cases = {   # inputs, parameters, the route, the forward twin, the backward twin
        "conv_head": (
            [obs], wb(ae["conv1"]),
            lambda x, q, kw: nets.conv_head(x[0], *pd(q), pool=2, stage=e1, **kw),
            lambda x, q, p, sd: cs.head_fwd_plain(x[0], *q, 2, p, sd, e1),
            lambda x, q, g, p, sd: cs.head_bwd_plain(x[0], *q, g, 2, p, sd, e1)[:2]),
        "conv_encoder": (
            [obs], wb(rnd["conv1"], rnd["conv2"]),
            lambda x, q, kw: nets.conv_encoder(x[0], *pd(q), pools=(4, 2), **kw),
            lambda x, q, p, sd: ch.encoder_fwd_plain(x[0], *q, (4, 2), p, sd),
            lambda x, q, g, p, sd: ch.encoder_bwd_plain(x[0], *q, g, (4, 2), p, sd)),
        "conv_tail": (
            [emb], wb(ae["deconv1"]),
            lambda x, q, kw: nets.conv_tail(x[0], *pd(q), act="relu", stage=d1, **kw),
            lambda x, q, p, sd: cs.tail_fwd_plain(x[0], *q, "relu", p, sd, d1),
            lambda x, q, g, p, sd: cs.tail_bwd_plain(x[0], *q, g, "relu", p, sd, d1)),
        "conv_loss_tail": (
            [mid, obs], wb(ae["deconv2"]),
            lambda x, q, kw: nets.conv_loss_tail(x[0], *pd(q), x[1], act="sigmoid", stage=d2,
                                                 **kw),
            lambda x, q, p, sd: cs.loss_tail_fwd_plain(x[0], *q, x[1], "sigmoid", p, sd, d2),
            lambda x, q, g, p, sd: cs.loss_tail_bwd_plain(x[0], *q, x[1], g, "sigmoid", p, sd,
                                                          d2)),
        "conv_decoder_loss": (
            [emb, obs], wb(ae["deconv1"], ae["deconv2"]),
            lambda x, q, kw: nets.conv_decoder_loss(x[0], *pd(q), x[1], **kw),
            lambda x, q, p, sd: cs.decoder_loss_fwd_plain(x[0], *q, x[1], p, sd),
            lambda x, q, g, p, sd: cs.decoder_loss_bwd_plain(x[0], *q, x[1], g, p, sd)),
        "conv_ae_loss": (
            [obs, obs], wb(ae["conv1"], ae["conv2"], ae["deconv1"], ae["deconv2"]),
            lambda x, q, kw: nets.conv_ae_loss(x[0], *pd(q), x[1], pools=(2, 2), **kw),
            lambda x, q, p, sd: ch.ae_loss_fwd_plain(x[0], *q, x[1], (2, 2), p, sd),
            lambda x, q, g, p, sd: ch.ae_loss_bwd_plain(x[0], *q, x[1], g, (2, 2), p, sd)),
    }
    pooled = ("conv_head", "conv_encoder", "conv_ae_loss")
    out = {}
    for name, (inputs, flat, route, fwd, bwd) in cases.items():
        r = {"fwd_max_abs_err": 0.0, "grad_max_leaf_rel_err": 0.0, "launches_per_call": {}}
        for p in (0.0, DROP_P):
            leaves = [t.detach().requires_grad_(True) for t in flat]
            xs = [x.detach().requires_grad_(x.is_floating_point()) for x in inputs]
            c0 = cuda_build.launch_counts()
            got = nets.whole(route(xs, leaves, dict(drop_p=p, train=p > 0, seed=seed,
                                                    mesh=mesh)))
            g = torch.randn(got.shape, generator=gen, device=dev)
            wrt = leaves + ([xs[0]] if xs[0].requires_grad else [])
            grads = torch.autograd.grad(got, wrt, g)
            got = got.detach()
            launched = {k_: v - c0[k_] for k_, v in cuda_build.launch_counts().items()
                        if v != c0[k_]}
            check(launched and all(v % slots == 0 for v in launched.values()),
                  f"{name} (drop {p}): launches {launched} are not one a slot")
            r["launches_per_call"][f"drop_{p}"] = launched
            want, twin_grads = [], None
            for s in range(slots):
                part = [x.detach()[s * k:(s + 1) * k] for x in inputs]
                sd = _shard_seed(seed, s)
                want.append(fwd(part, flat, p, sd))
                gs = list(bwd(part, flat, g[s * k:(s + 1) * k], p, sd))
                twin_grads = ([[t] for t in gs] if twin_grads is None
                              else [acc + [t] for acc, t in zip(twin_grads, gs)])
            summed = [torch.stack(ts).sum(0) for ts in twin_grads[:len(leaves)]]
            summed += [torch.cat(ts) for ts in twin_grads[len(leaves):]]   # the input's
            want = torch.cat(want)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"{name} (drop {p}): {m}")
            errs = _leaf_errors(grads, summed)
            check(max(errs) < (TOL_TIES if name in pooled else 1e-4),
                  f"{name} (drop {p}): gradient leaves differ from the twins' {errs}")
            r["fwd_max_abs_err"] = max(r["fwd_max_abs_err"], float((got - want).abs().max()))
            r["grad_max_leaf_rel_err"] = max(r["grad_max_leaf_rel_err"], max(errs))
        if name == "conv_encoder":   # slot 0 with dropout: the ties apart from error
            r["ties_slot0_drop"] = _tie_analysis(torch, obs[:k], flat, g[:k], (4, 2), DROP_P,
                                                 _shard_seed(seed, 0), None)
        out[name] = r
        shown = {k_: v for k_, v in r.items() if k_ != "ties_slot0_drop"}
        log(f"env_mesh route {name}: {json.dumps(shown)}")
    return out


def phase_env_mesh(torch, cuda_build):
    """Env-batch data parallelism on one controller: a mesh of 4 slots of
    the card (make_mesh([cuda] * 4, "env"); shard_carry's instance shards,
    rings of one slot; the nets a slot at a time over the instances).  What
    the path is held against runs first: the stack of (b) and the battery of
    (d) on one device, (e)'s fused_head=True.  Then, counted from zero:
    (a) train-64 through train(mesh=): 64 universes of 256², 16 a slot,
    RND2D + AE2D learning (batch 64, dropout 0.1), 4 rulesets x 128 steps:
    checkpoints read back, 8 updates a learner, the bonus falls; the same with
    packed_state=True, its history equal to the uint8 mesh run's (rtol 1e-6,
    as the packed phase holds it); (b) train-64's stack with the learners'
    dropout off, 128 steps (2 updates), on the mesh against mesh=None: grids
    bit for bit, rewards rtol 1e-5; (d) the batched battery (5 rulesets x 32
    replicas x 1024 steps, 40 universes a slot) through
    evaluate_fused_batched(mesh=), its score rtol 1e-4 of mesh=None's; (e)
    policy_logits on 16 universes with the mesh against fused_head=True:
    values 1e-5, gradients 1e-4 of each leaf.  After the counts are read:
    5 x 1 on 4 slots raises ValueError; wall and device ms a step, launches,
    gathers and peak memory of (a)'s stack and (d)'s, mesh against mesh=None
    (_env_mesh_profiles); (c) the six routes against their twins
    (_batch_routes_held)."""
    import numpy as np

    from carle_tpu_torch import EnvConfig, train_mcl
    from carle_tpu_torch.evaluation import eval as ev
    from carle_tpu_torch.policy import init_policy_params, policy_logits

    dev = torch.device("cuda")
    mesh = _env_mesh(torch)
    cfg = EnvConfig(instances=ENV_MESH_UNIVERSES)
    out = {"mesh": f"{ENV_MESH_SLOTS} slots of one card, rings of one slot",
           "devices": [str(d) for d in mesh.devices]}

    # references, before the path's counts start
    r_none, u_none, _, stack_none = _env_mesh_stack(torch, cuda_build, cfg, None, 128, False)
    t0 = time.perf_counter()
    score_none, per_rule_none = ev.evaluate_fused_batched(steps=1024, replicas=32, seed=0,
                                                          verbose=False, device="cuda")
    torch.cuda.synchronize()
    battery_none_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(22)
    pparams = init_policy_params(gen, EnvConfig())
    pobs = (torch.rand((16, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
    pcot = torch.randn((16, 64 * 64), generator=gen, device=dev)

    def policy_run(tag):
        leaves = {k: {n: t.detach().requires_grad_(True) for n, t in v.items()}
                  for k, v in pparams.items()}
        lg = policy_logits(leaves, pobs, fused_head=tag)
        flat = [t for v in leaves.values() for t in v.values()]
        return lg.detach(), torch.autograd.grad((lg * pcot).sum(), flat)

    policy_fused = policy_run(True)
    cuda_build.reset_launch_counts()

    # (a) train(mesh=), uint8 and packed
    with tempfile.TemporaryDirectory() as tmp:
        c0 = cuda_build.launch_counts()
        hist, segments, wall = _env_mesh_train(torch, train_mcl, mesh, tmp, "uint8")
        train_launches = _launches_per_step(cuda_build, c0, 512)
        c0 = cuda_build.launch_counts()
        hist_p, _, wall_p = _env_mesh_train(torch, train_mcl, mesh, tmp, "packed",
                                            packed_state=True)
        packed_launches = _launches_per_step(cuda_build, c0, 512)
    check(train_launches.get("spatial_ca_step_words") == ENV_MESH_SLOTS,
          f"(a): {train_launches.get('spatial_ca_step_words')} halo_words launches a step, "
          f"not one a ring ({ENV_MESH_SLOTS})")
    np.testing.assert_allclose(hist_p, hist, rtol=1e-6, atol=0)
    out["train"] = {
        "universes": ENV_MESH_UNIVERSES, "steps": 512, "wall_s": wall,
        "wall_ms_per_step": wall * 1e3 / 512, "packed_wall_s": wall_p,
        "segment_universe_steps_per_s": [s["steps_per_second"] for s in segments],
        "segment_mean_reward": [s["mean_reward"] for s in segments],
        "kernel_launches_per_step": train_launches,
        "packed_kernel_launches_per_step": packed_launches,
        "packed_history_equals_uint8_bit_for_bit": bool(np.array_equal(hist_p, hist))}
    # (b) dropout off, mesh against mesh=None
    r_mesh, u_mesh, carry, stack_mesh = _env_mesh_stack(torch, cuda_build, cfg, mesh, 128, False)
    check(all(int(w.updates) == 2 for w in carry.stack.wrappers), "(b): not 2 updates each")
    check(torch.equal(u_mesh, u_none), "(b): the mesh's universe differs from mesh=None's")
    torch.testing.assert_close(r_mesh, r_none, rtol=1e-5, atol=0)
    check(stack_mesh["gathers_per_step"] == 0, "(b): the learners' stack gathered")
    out["stack_dropout_off"] = {
        "mesh": stack_mesh, "mesh_none": stack_none, "universe_bit_for_bit": True,
        "rewards_max_rel_diff": float(((r_mesh - r_none).abs() / r_none.abs()).max())}
    del carry
    # (d) the batched battery
    c0, t0 = cuda_build.launch_counts(), time.perf_counter()
    score, per_rule = ev.evaluate_fused_batched(steps=1024, replicas=32, seed=0, verbose=False,
                                                device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    battery_s = time.perf_counter() - t0
    battery_launches = _launches_per_step(cuda_build, c0, 1024)
    np.testing.assert_allclose(per_rule, per_rule_none, rtol=1e-4)
    np.testing.assert_allclose(score, score_none, rtol=1e-4)
    out["battery"] = {"score": score, "score_mesh_none": score_none,
                      "score_rel_diff": abs(score - score_none) / abs(score_none),
                      "wall_s": battery_s, "wall_s_mesh_none": battery_none_s,
                      "wall_ms_per_step": battery_s * 1e3 / 1024,
                      "wall_ms_per_step_mesh_none": battery_none_s * 1e3 / 1024,
                      "kernel_launches_per_step": battery_launches}
    # (e) the policy's encoder with the mesh
    lg, grads = policy_run(mesh)
    torch.testing.assert_close(lg, policy_fused[0], rtol=1e-5, atol=1e-5)
    errs = _leaf_errors(grads, policy_fused[1])
    check(max(errs) < 1e-4, f"(e): policy gradients differ from fused_head=True: {errs}")
    out["policy"] = {"logits_max_abs_diff": float((lg - policy_fused[0]).abs().max()),
                     "grad_max_leaf_rel_err": max(errs)}
    counts = cuda_build.launch_counts()
    log(f"env_mesh launches: {json.dumps({k: v for k, v in counts.items() if v})}")

    try:
        ev.evaluate_fused_batched(steps=1, replicas=1, verbose=False, device="cuda", mesh=mesh)
        check(False, "5 rulesets x 1 replica on 4 slots did not raise")
    except ValueError as exc:
        out["battery_5x1_refused"] = str(exc)
    torch.cuda.empty_cache()
    out["profiles"] = _env_mesh_profiles(torch, mesh)
    for leg in ("train", "battery"):
        m, none = out["profiles"][f"{leg}_mesh"], out["profiles"][f"{leg}_mesh_none"]
        log(f"env_mesh {leg}: wall ms a step {m['wall_ms_per_step']:.3f} on the mesh, "
            f"{none['wall_ms_per_step']:.3f} mesh=None; device ms a step "
            f"{m['device_ms_per_step']:.3f}, {none['device_ms_per_step']:.3f}; launches a step "
            f"{m['device_launches_per_step']:.1f}, {none['device_launches_per_step']:.1f}; "
            f"peak bytes {m['max_memory_allocated_bytes']}, "
            f"{none['max_memory_allocated_bytes']}")
    out["routes"] = _batch_routes_held(torch, cuda_build, mesh, gen)
    torch.cuda.empty_cache()
    log(f"env_mesh ok: {json.dumps({k: v for k, v in out.items() if k != 'routes'})}")
    return counts, out


# several processes over one mesh: processes x slots of cuda:0 each (gloo: NCCL
# cannot put two ranks on one card), against the one-controller 4-slot meshes
MP_PROCS, MP_SLOTS = 2, 2
MP_TRAIN_STEPS = 64          # train-64's rulesets x 64 steps (train phase: 128)
MP_SPATIAL_STEPS = 8


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _mp_stats(torch, cuda_build, distributed, run, steps):
    """run() with the crossings, launches and time a step it took: (its
    value, stats)."""
    torch.cuda.synchronize()
    distributed.reset_stats()
    c0, t0 = cuda_build.launch_counts(), time.perf_counter()
    value = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(distributed.STATS)
    return value, {
        "wall_ms_per_step": wall * 1e3 / steps,
        "ghost_bytes_per_step": st["bytes_sent"] / steps,
        "ghost_exchanges_per_step": st["exchanges"] / steps,
        "collectives_per_step": {"all_reduce": st["all_reduce"] / steps,
                                 "isend": st["messages"] / steps},
        "host_staging_ms_per_step": st["staging_s"] * 1e3 / steps,
        "kernel_launches_per_step": _launches_per_step(cuda_build, c0, steps)}


def _mp_train(torch, train_mcl, mesh, log_dir, dropout):
    """train-64 (64 universes of 256², RND2D + AE2D, batch 64, 4 rulesets x
    MP_TRAIN_STEPS steps) through train(mesh=): (history, the last carry, the
    segments' mean rewards); with ``dropout`` False the learners' dropout
    is off (the defs train builds, patched here)."""
    import functools

    segments = []
    saved = train_mcl.rnd2d_def, train_mcl.ae2d_def
    if not dropout:
        train_mcl.rnd2d_def = functools.partial(saved[0], dropout=False)
        train_mcl.ae2d_def = functools.partial(saved[1], dropout=False)
    try:
        hist = train_mcl.train(instances=ENV_MESH_UNIVERSES, height=256, width=256,
                               steps=(1, MP_TRAIN_STEPS), batch_size=64, seed=0,
                               log_dir=log_dir, segment_callback=segments.append,
                               device="cuda", mesh=mesh)
    finally:
        train_mcl.rnd2d_def, train_mcl.ae2d_def = saved
    return hist, segments[-1]["carry"], [s["mean_reward"] for s in segments]


def _mp_burst(torch, cuda_build, distributed, mesh):
    """(b): one universe of 8192², its rows over ``mesh``, MP_SPATIAL_STEPS
    uint8 generations of spatial_multi_step (row 13): (the universe, the
    burst's stats, the gather not timed)."""
    from carle_tpu_torch import rules
    from carle_tpu_torch.parallel import gather_rows, shard_rows, spatial_multi_step_cuda

    gen = torch.Generator(device="cuda").manual_seed(23)
    grid = (torch.rand((1, SPATIAL_SIZE, SPATIAL_SIZE), generator=gen, device="cuda")
            < 0.3).to(torch.uint8)
    x = shard_rows(grid, mesh)
    del grid
    spatial_multi_step_cuda(x, rules.LIFE, MP_SPATIAL_STEPS)   # warm
    out, stats = _mp_stats(torch, cuda_build, distributed,
                           lambda: spatial_multi_step_cuda(x, rules.LIFE, MP_SPATIAL_STEPS),
                           MP_SPATIAL_STEPS)
    return gather_rows(out), stats


def _mp_packed(torch, mesh):
    """(c): the packed stack with RND2D (batch 4, dropout 0.1) on the row
    shards (SpaceSharding) of one universe of 8192², 2 + MP_SPATIAL_STEPS
    steps of one seeded action stream (_packed_leg): (stats, rewards,
    universe)."""
    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.mcl import rnd2d_def
    from carle_tpu_torch.nets import SpaceSharding

    cfg = EnvConfig(height=SPATIAL_SIZE, width=SPATIAL_SIZE, instances=1)
    gen = torch.Generator(device="cuda").manual_seed(29)
    acts = (torch.rand((2 + MP_SPATIAL_STEPS, 1, 64, 64), generator=gen, device="cuda")
            < 0.1).to(torch.uint8)
    defs = [rnd2d_def(cfg, batch_size=4, fused_head=SpaceSharding(mesh))]
    stats, rewards, universe, _ = _packed_leg(torch, cfg, defs, acts, mesh)
    return stats, rewards, universe


def mp_child(argv):
    """One process of the multiprocess phase (run by the launcher of
    carle_tpu_torch/parallel/distributed.py; argv: the output directory):
    (a)-(d) on the mesh over both processes' slots, the launch counts from
    zero over them, the results to rank<r>.json."""
    import hashlib

    import torch
    import torch.distributed as dist

    from carle_tpu_torch import EnvConfig, rules, train_mcl
    from carle_tpu_torch.env import env_step, init_state, reset_flags
    from carle_tpu_torch.ops import cuda_build
    from carle_tpu_torch.parallel import distributed, gather_rows, make_mesh, shard_carry
    from carle_tpu_torch.parallel.mesh import local_batch

    out_dir = argv[0]
    rank = distributed.process_index()
    mesh, smesh = make_mesh(axis_name="env"), make_mesh(axis_name="space")
    out = {"rank": rank, "backend": distributed.backend(), "mesh": repr(mesh)}
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    steps = 4 * MP_TRAIN_STEPS
    # (a) train-64, dropout off, then on
    (hist, carry, _), out["a_stats"] = _mp_stats(
        torch, cuda_build, distributed,
        lambda: _mp_train(torch, train_mcl, mesh, os.path.join(out_dir, f"off{rank}"), False),
        steps)
    grid = carry.stack.env.grid
    out["a_universe"] = _digest(distributed.batch_gather(gather_rows(grid), local_batch(grid)))
    out["a_history"] = hist.tolist()
    sums = [None] * distributed.process_count()
    params = b"".join(t.cpu().numpy().tobytes() for w in carry.stack.wrappers
                      for v in w.params.values() for t in v.values())
    dist.all_gather_object(sums, hashlib.sha256(params).hexdigest())
    out["a_param_checksums"] = sums
    out["a_updates"] = [int(w.updates) for w in carry.stack.wrappers]
    del carry, grid
    hist_on, _, means = _mp_train(torch, train_mcl, mesh, os.path.join(out_dir, f"on{rank}"),
                                  True)
    out["a_dropout_means"] = means
    # (b) the uint8 burst, row 13 across the boundary
    universe, out["b_stats"] = _mp_burst(torch, cuda_build, distributed, smesh)
    out["b_universe"] = _digest(universe)
    del universe
    # (c) JAX's leg 3 at full width
    distributed.reset_stats()
    stats, rewards, universe = _mp_packed(torch, smesh)
    st = dict(distributed.STATS)
    n = 2 + MP_SPATIAL_STEPS
    stats.update(ghost_bytes_per_step=st["bytes_sent"] / n,
                 ghost_exchanges_per_step=st["exchanges"] / n,
                 collectives_per_step={"all_reduce": st["all_reduce"] / n,
                                       "isend": st["messages"] / n},
                 host_staging_ms_per_step=st["staging_s"] * 1e3 / n)
    out["c_stats"], out["c_rewards"] = stats, rewards.flatten().tolist()
    out["c_universe"] = _digest(universe)
    del universe
    # (d) the reset flag: set on process 0 only, then on both
    cfg = EnvConfig(instances=ENV_MESH_UNIVERSES)
    g = torch.Generator(device="cuda").manual_seed(31)
    state = init_state(cfg, rules.LIFE, "cuda")._replace(
        grid=(torch.rand(cfg.grid_shape, generator=g, device="cuda") < 0.3).to(torch.uint8))
    state = shard_carry(state, mesh, cfg)
    batch = local_batch(state.grid)
    flags = []
    for ones in (rank == 0, True):
        action = torch.full((batch.hi - batch.lo, 64, 64), 1 if ones else 0,
                            dtype=torch.uint8, device="cuda")
        new, _ = env_step(state, action, cfg)
        cleared = bool((distributed.batch_gather(gather_rows(new.grid), batch) == 0).all())
        flags.append([bool(reset_flags(action, state.grid)[0]), cleared])
    out["d_flags"] = flags
    torch.cuda.synchronize()
    out["launches"] = cuda_build.launch_counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"multiprocess child {rank}: done", flush=True)


def phase_multiprocess(torch, cuda_build):
    """Several processes over one mesh (parallel/distributed.py): MP_PROCS
    processes of MP_SLOTS slots of cuda:0 each, spawned by the launcher
    (gloo: NCCL cannot put two ranks on one card, so NCCL is not run), each
    leg held against the one-controller 4-slot mesh run here first, alone
    on the card: (a) train-64 (64 universes of 256², 16 a slot, RND2D +
    AE2D batch 64, 4 rulesets x MP_TRAIN_STEPS steps: the train phase's 128
    cut to 64) through train(mesh=) under the group with the learners'
    dropout off: the universe bit for bit, the history rtol 1e-5, the
    parameters bit for bit equal on both processes; with dropout on the
    bonus falls and process 0 alone writes one checkpoint set; (b) one
    universe of 8192², 2048 rows a slot, 8 generations of
    spatial_multi_step: row 13's T = 8 ghost rows cross processes, bit for
    bit; (c) the packed stack with RND2D on its row shards (SpaceSharding)
    on one universe of 8192², 10 steps: row 15's ghost words and rows 3a/3b's
    halo rows cross processes, the universe bit for bit, rewards rtol 1e-4;
    (d) the master reset set on one process only does not fire, set on both
    fires.  The kernels are built here before the spawn.  Returns the
    children's launch counts added up, and the report."""
    import numpy as np

    from carle_tpu_torch import train_mcl
    from carle_tpu_torch.parallel import distributed, gather_rows

    t_phase = time.perf_counter()
    out = {"processes": MP_PROCS, "slots_per_process": MP_SLOTS, "backend": "gloo",
           "nccl": "not run: one card (NCCL cannot put two ranks on one card)"}
    log(f"multiprocess: {MP_PROCS} processes x {MP_SLOTS} slots of cuda:0, gloo; NCCL not "
        "run (one card)")
    cuda_build.build_all()
    env_mesh, smesh = _env_mesh(torch), _spatial_mesh(torch)
    ref = {}
    steps = 4 * MP_TRAIN_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        (hist, carry, _), ref["a_stats"] = _mp_stats(
            torch, cuda_build, distributed,
            lambda: _mp_train(torch, train_mcl, env_mesh, os.path.join(tmp, "ref"), False),
            steps)
    ref["a_universe"] = _digest(gather_rows(carry.stack.env.grid))
    del carry
    universe, ref["b_stats"] = _mp_burst(torch, cuda_build, distributed, smesh)
    ref["b_universe"] = _digest(universe)
    del universe
    ref["c_stats"], c_rewards, universe = _mp_packed(torch, smesh)
    ref["c_universe"] = _digest(universe)
    del universe
    torch.cuda.empty_cache()
    t_spawn = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outputs = distributed.launch(os.path.abspath(__file__) + ":mp_child", MP_PROCS, [tmp],
                                     slots_per_process=MP_SLOTS, device="cuda", timeout=600,
                                     backend="gloo")
        kids = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(MP_PROCS)]
        written = {r: sorted(os.listdir(os.path.join(tmp, f"on{r}", "models")))
                   if os.path.isdir(os.path.join(tmp, f"on{r}")) else [] for r in range(MP_PROCS)}
    spawn_s = time.perf_counter() - t_spawn
    for r, kid in enumerate(kids):
        check(kid["backend"] == "gloo", f"child {r}: backend {kid['backend']}")
        check(kid["a_universe"] == ref["a_universe"], f"(a) child {r}: the universe differs "
              "from the one-controller mesh's")
        np.testing.assert_allclose(kid["a_history"], hist, rtol=1e-5, atol=0)
        check(len(set(kid["a_param_checksums"])) == 1,
              f"(a) child {r}: parameters differ across processes")
        check(kid["a_updates"] == [4, 4], f"(a) child {r}: updates {kid['a_updates']}")
        means = kid["a_dropout_means"]
        check(means[-1] < means[0], f"(a) child {r}: the bonus did not fall ({means})")
        check(kid["b_universe"] == ref["b_universe"], f"(b) child {r}: the burst differs")
        check(kid["c_universe"] == ref["c_universe"], f"(c) child {r}: the universe differs")
        np.testing.assert_allclose(kid["c_rewards"], c_rewards.flatten().cpu().numpy(),
                                   rtol=1e-4, atol=0)
        check(kid["d_flags"] == [[False, False], [True, True]],
              f"(d) child {r}: reset flags {kid['d_flags']}")
    check([len(written[r]) for r in range(MP_PROCS)] == [2] + [0] * (MP_PROCS - 1),
          f"(a): checkpoints written {written}")
    check(kids[0]["a_param_checksums"] == kids[1]["a_param_checksums"],
          "(a): the processes report different parameter checksums")
    counts = {k: sum(kid["launches"].get(k, 0) for kid in kids) for k in kids[0]["launches"]}
    for leg in ("a", "b", "c"):
        two, one = kids[0][f"{leg}_stats"], ref[f"{leg}_stats"]
        log(f"multiprocess ({leg}): wall ms a step {two['wall_ms_per_step']:.3f} "
            f"(2 processes) against {one['wall_ms_per_step']:.3f} (one controller); "
            f"ghost bytes a step {two.get('ghost_bytes_per_step', 0):.1f} in "
            f"{two.get('ghost_exchanges_per_step', 0):.2f} exchanges; collectives a step "
            f"{json.dumps(two.get('collectives_per_step'))}; host staging ms a step "
            f"{two.get('host_staging_ms_per_step', 0):.3f}")
    out.update({
        "one_controller": ref, "children": [{k: v for k, v in kid.items()
                                              if k not in ("a_history", "c_rewards")}
                                             for kid in kids],
        "peak_bytes_per_child": [kid["peak_bytes"] for kid in kids],
        "a_history_max_rel_diff": max(float(np.max(np.abs(np.asarray(k["a_history"]) - hist)
                                                   / np.abs(hist))) for k in kids),
        "c_rewards_max_rel_diff": max(float(np.max(np.abs(np.asarray(k["c_rewards"])
                                                          - c_rewards.flatten().cpu().numpy())
                                                   / np.abs(c_rewards.flatten().cpu().numpy())))
                                      for k in kids),
        "spawn_s": spawn_s, "phase_s": time.perf_counter() - t_phase,
        "child_tail": [o.splitlines()[-1] if o else "" for o in outputs]})
    log(f"multiprocess peak bytes a child: {out['peak_bytes_per_child']}; launches "
        f"(children): {json.dumps({k: v for k, v in counts.items() if v})}")
    log(f"multiprocess ok: {json.dumps({k: v for k, v in out.items() if k != 'children'})}")
    return counts, out


SURFACE_STEPS = 256          # the facade's steps, card and CPU: 4 Adam updates a learner
SURFACE_REWARD_RTOL = 2e-3   # card against CPU through Adam updates (as train_parity)
SURFACE_REWARD_ATOL = 1e-5
SURFACE_SIZES = (64, 1024)   # the preflight's universes of 256²
SURFACE_PRICE_ERROR = 0.1    # the price against the measured peak, either way
SURFACE_TRAIN_STEPS = 64     # a segment: one Adam update a learner
SURFACE_TRACE_STEPS = 4


def _facade_run(torch, compat, device, weights=None):
    """The reference's stack through the facade installed for ``device``
    (None: the card): (observations, rewards, updates, ms a step, the shells'
    states).  ``weights`` are the learners' states to start from."""
    import numpy as np

    from carle_tpu_torch.parallel.mesh import tree_map_leaves

    compat.install(device=device)
    from carle.env import CARLE
    from carle.mcl import AE2D, RND2D, PufferDetector, SpeedDetector, get_glider

    rnd = RND2D(CARLE(), dropout=False, seed=1)
    ae = AE2D(rnd, dropout=False, seed=2)
    env = PufferDetector(SpeedDetector(ae))
    if weights is not None:
        for shell, state in zip((rnd, ae), weights):
            shell._wstate = tree_map_leaves(
                lambda t: t.to(rnd.inner_env.device) if torch.is_tensor(t) else t, state)
    states = [tree_map_leaves(lambda t: t.clone() if torch.is_tensor(t) else t, s._wstate)
              for s in (rnd, ae)]
    rng = np.random.RandomState(24)
    acts = [get_glider().numpy()] + [(rng.rand(1, 1, 64, 64) < 0.02).astype(np.float32)
                                     for _ in range(SURFACE_STEPS - 1)]
    first = env.reset()
    obs, rewards = [], []
    t0 = time.perf_counter()
    for a in acts:
        o, r, d, _ = env.step(torch.from_numpy(a))
        obs.append(o)
        rewards.append(r)
    ms = (time.perf_counter() - t0) * 1e3 / SURFACE_STEPS
    check(all(t.device.type == "cpu" for t in (first, o, r, d)),
          "the facade returned tensors off the host")
    return (torch.stack(obs), torch.stack(rewards), [rnd.updates, ae.updates], ms, states,
            rnd.inner_env.device.type)


def _priced_train(torch, train_mcl, n, log_dir, **kw):
    """train at ``n`` universes of 256², one segment: (history, the price,
    the peak allocated above what was allocated before, after the segment)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    seen = []

    def after_segment(info):
        torch.cuda.synchronize()
        seen.append((info["preflight"], torch.cuda.max_memory_allocated() - before))

    hist = train_mcl.train(instances=n, steps=(1, SURFACE_TRAIN_STEPS), rules=[[[3], [2, 3]]],
                           batch_size=64, seed=0, log_dir=log_dir, mesh=False,
                           segment_callback=after_segment, device="cuda", **kw)
    price, peak = seen[0]
    return hist, price, peak


def phase_surfaces(torch, cuda_build):
    """ROADMAP Queue 1 item 9 on the card (docstring, 9e)."""
    import numpy as np

    import carle_tpu_torch.compat as compat
    from carle_tpu_torch import train_mcl
    from carle_tpu_torch.utils.preflight import GIB, HBMBudgetError
    from carle_tpu_torch.utils.profiling import TRACE_FILE, trace

    out = {}
    # (a) the facade: the CPU first, whose initial weights the card's shells take
    try:
        cpu_obs, cpu_rew, cpu_updates, cpu_ms, weights, _ = _facade_run(torch, compat, "cpu")
        cuda_build.reset_launch_counts()
        obs, rew, updates, ms, _, where = _facade_run(torch, compat, None, weights)
        counts = cuda_build.launch_counts()
    finally:
        compat.uninstall()
    check("carle" not in sys.modules, "the facade is still installed")
    check(where == "cuda", f"the facade installed with no device ran on {where}")
    check(updates == cpu_updates == [SURFACE_STEPS // 64] * 2,
          f"updates {updates} on the card, {cpu_updates} on the CPU")
    check(torch.equal(obs, cpu_obs), "facade observations differ, card against CPU")
    torch.testing.assert_close(rew, cpu_rew, rtol=SURFACE_REWARD_RTOL, atol=SURFACE_REWARD_ATOL)
    rel = float(((rew - cpu_rew).abs() / cpu_rew.abs().clamp_min(1e-30)).max())
    launched = {k: v for k, v in counts.items() if v}
    out["facade"] = {"steps": SURFACE_STEPS, "ms_per_step": ms, "cpu_ms_per_step": cpu_ms,
                     "reward_max_rel_diff": rel, "mean_reward": float(rew.mean()),
                     "alive_cells_last": float(obs[-1].sum()), "updates": updates,
                     "launches": launched}
    log(f"surfaces (a) facade: {json.dumps(out['facade'])}")

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the preflight's price against the measured peak, and (c) serialize
        priced = {}
        for n in SURFACE_SIZES:
            for serialize in (False, True):
                hist, price, peak = _priced_train(torch, train_mcl, n,
                                                  os.path.join(tmp, f"p{n}{serialize}"),
                                                  serialize=serialize)
                check(hist.shape == (SURFACE_TRAIN_STEPS,) and np.isfinite(hist).all(),
                      f"train at {n} universes")
                check(price is not None and price["temp_measured"], "the preflight on the card")
                priced[n, serialize] = (hist, price, peak)
        out["preflight"] = {
            str(n): {"peak_estimate_gib": priced[n, False][1]["peak_estimate_gib"],
                     "argument_gib": priced[n, False][1]["argument_size_in_bytes"] / GIB,
                     "temp_gib": priced[n, False][1]["temp_size_in_bytes"] / GIB,
                     "workspace_gib": priced[n, False][1]["workspace_size_in_bytes"] / GIB,
                     "slices_gib": {str(k): v / GIB
                                    for k, v in priced[n, False][1]["slices"].items()},
                     "budget_gib": priced[n, False][1]["budget_gib"],
                     "measured_peak_gib": priced[n, False][2] / GIB,
                     "error": priced[n, False][1]["peak_estimate_gib"]
                     / (priced[n, False][2] / GIB) - 1}
            for n in SURFACE_SIZES}
        log(f"surfaces (b) preflight: {json.dumps(out['preflight'])}")
        for n in SURFACE_SIZES:
            err = out["preflight"][str(n)]["error"]
            check(abs(err) < SURFACE_PRICE_ERROR, f"the preflight's price at {n} universes "
                  f"is off by {err:+.4f} of the measured peak")
        small = SURFACE_SIZES[0]
        refused = False
        try:
            train_mcl.train(instances=small, steps=(1, 8), rules=[[[3], [2, 3]]],
                            log_dir=os.path.join(tmp, "micro"), mesh=False,
                            hbm_budget_gib=1e-3, device="cuda")
        except HBMBudgetError:
            refused = True
        check(refused and not os.path.exists(os.path.join(tmp, "micro", "models")),
              "a micro budget was not refused before the first segment")
        forced = train_mcl.train(instances=small, steps=(1, 8), rules=[[[3], [2, 3]]],
                                 log_dir=os.path.join(tmp, "forced"), mesh=False,
                                 hbm_budget_gib=1e-3, force_hbm=True, device="cuda")
        check(forced.shape == (8,) and np.isfinite(forced).all(), "forced run")
        out["preflight"]["micro_budget_refused"] = refused
        log(f"surfaces (b) micro budget refused before any segment: {refused}; forced "
            f"run completed")
        check(np.array_equal(priced[small, True][0], priced[small, False][0]),
              "train-64's history with serialize differs from without")
        out["serialize"] = {
            "bit_for_bit": {str(n): bool(np.array_equal(priced[n, True][0], priced[n, False][0]))
                            for n in SURFACE_SIZES},
            "peak_gib": {str(n): {"default": priced[n, False][2] / GIB,
                                  "serialize": priced[n, True][2] / GIB}
                         for n in SURFACE_SIZES}}
        log(f"surfaces (c) serialize: {json.dumps(out['serialize'])}")

        # (d) the trace of a few training steps
        where = os.path.join(tmp, "trace")
        with trace(where):
            train_mcl.train(instances=small, steps=(1, SURFACE_TRACE_STEPS),
                            rules=[[[3], [2, 3]]], log_dir=os.path.join(tmp, "traced"),
                            mesh=False, device="cuda")
        with open(os.path.join(where, TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        names = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
        check(any("ca_step_words" in k for k in names), "no ca_step_words kernel in the trace")
        check(any("enc3_" in k for k in names), "no encoder kernel in the trace")
        out["trace"] = {"kernel_names": len(names), "events": len(events),
                        "names": [k[:48] for k in names if "enc3_" in k or "ca_step" in k
                                  or "ae2d" in k]}
        log(f"surfaces (d) trace: {json.dumps(out['trace'])}")
    return counts, out


def shipped_states(torch):
    """The shipped learner states on the card, keyed by wrapper name."""
    from carle_tpu_torch.checkpoint import learner_state_from_numpy, read_npz
    from carle_tpu_torch.evaluation.eval import DEFAULT_WRAPPERS

    return {cls.my_name: learner_state_from_numpy(read_npz(ckpt), "cuda")
            for cls, _, ckpt in DEFAULT_WRAPPERS if ckpt}


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


SUBMISSION_STEPS = 1024   # the protocol's steps a ruleset
LOGIT_TOGGLE = math.log(0.1 / 0.9)   # the network agent's threshold on its dense output
# The network agent is bias-free: on an empty universe it outputs sigmoid(0)
# and never toggles.  Rules that give birth on zero neighbours fill the
# universe after the reset, so it acts.
RULES_B0 = [[[0, 3], [2, 3]], [[0, 2, 3], [3]]]


def _replay_agent(stream):
    """An agent class that plays ``stream`` one action a call: the same
    toggles reach the card and the CPU."""

    class Replay:
        def __init__(self, **kwargs):
            self.i = 0

        def __call__(self, obs):
            self.i += 1
            return stream[self.i - 1]

    return Replay


def _toggling_network_weights():
    """Network-agent weights drawn from numpy at scales that make it toggle
    about a third of the window (its own seeded draw rarely toggles)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(5)
    w = {"conv1": rng.randn(4, 1, 3, 3) * 0.5, "conv2": rng.randn(1, 4, 3, 3) * 0.5,
         "dense": rng.randn(4096, 4096) * 0.02}
    return {k: {"w": torch.from_numpy(v.astype(np.float32))} for k, v in w.items()}


def _network_actions_held(torch, agent):
    """The tie-aware action check: the network agent on the card against its
    weights on the CPU over 8 soups of 256², equal wherever the dense output
    lies more than 1e-4 from logit(0.1).  Returns (outputs near the
    threshold, outputs, share of the window toggled)."""
    import numpy as np

    from carle_tpu_torch import agents, nets

    rng = np.random.RandomState(8)
    obs = (rng.rand(8, 1, 256, 256) < rng.uniform(0.05, 0.6, size=(8, 1, 1, 1))
           ).astype(np.float32)
    cpu = agents.RandomNetworkAgent(device="cpu")
    cpu.params = {k: {"w": v["w"].cpu()} for k, v in agent.params.items()}
    got, want = agent(obs).cpu().numpy(), cpu(obs).numpy()
    p, x = cpu.params, torch.from_numpy(obs)
    x = nets.max_pool2(torch.relu(nets.conv2d(x, p["conv1"])))
    x = nets.max_pool2(torch.relu(nets.conv2d(x, p["conv2"])))
    z = nets.linear(nets.flatten(x), p["dense"]).reshape(got.shape).numpy()
    clear = np.abs(z - LOGIT_TOGGLE) > 1e-4
    check(bool((got[clear] == want[clear]).all()),
          "the network agent's actions on the card differ from the CPU's away from "
          "the threshold")
    return int((~clear).sum()), int(z.size), float(got.mean())


def phase_submission(torch, cuda_build):
    """The Carle's Game submission harness through its public entry points:
    the per-step ``evaluate`` at the full protocol (SubmissionAgent,
    DEFAULT_WRAPPERS with the shipped .npz, 5 rulesets x 1024 steps of 256²,
    a host round trip a step), beside the battery phase's evaluate_fused;
    then the card against the CPU on a replay stream, the fused path against
    the per-step one with the network agent (2 x 256 steps of RULES_B0), and
    a .pt round trip of both learners on the card."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from carle_tpu_torch import CARLE, agents
    from carle_tpu_torch.checkpoint import save_pytree
    from carle_tpu_torch.evaluation import eval as ev
    from carle_tpu_torch.evaluation.submission import SubmissionAgent
    from carle_tpu_torch.mcl import AE2D, RND2D, save_torch_checkpoint

    steps = SUBMISSION_STEPS
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    score, trace = ev.evaluate(SubmissionAgent, ev.DEFAULT_RULES, ev.DEFAULT_WRAPPERS,
                               steps=steps, seed=0, verbose=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_build.launch_counts()
    total = len(ev.DEFAULT_RULES) * steps
    check(len(trace) == total and all(math.isfinite(v) for v in trace)
          and 0.0 <= score <= 10.0, f"per-step battery score {score}")

    # device time a step: 64 steps of one ruleset under torch.profiler
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev.evaluate(SubmissionAgent, ev.DEFAULT_RULES[:1], ev.DEFAULT_WRAPPERS, steps=64,
                    seed=1, verbose=False, device="cuda")
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    kernels = [e for e in events if not e.key.startswith("Memcpy")]
    device_ms = sum(_device_us(e) for e in events) / 1e3 / 64
    wall_ms = wall * 1e3 / total

    # the kernel path on the card against the plain path on the CPU
    rules2 = ev.DEFAULT_RULES[:2]
    acts = (np.random.RandomState(3).rand(2 * 16, 1, 1, 64, 64) < 0.1).astype(np.float32)
    acts[20] = 1.0   # the master reset
    traces = {d: np.asarray(ev.evaluate(_replay_agent(acts), rules2, ev.DEFAULT_WRAPPERS,
                                        steps=16, verbose=False, device=d)[1])
              for d in ("cpu", "cuda")}
    np.testing.assert_allclose(traces["cuda"], traces["cpu"], rtol=1e-4, atol=1e-5)
    card_vs_cpu = float(np.abs(traces["cuda"] - traces["cpu"]).max())

    with tempfile.TemporaryDirectory() as tmp:
        # the network agent, fused against per-step, 256 steps a ruleset
        weights = save_pytree(os.path.join(tmp, "rna.npz"), _toggling_network_weights())
        kw = dict(rules=RULES_B0, wrappers=ev.DEFAULT_WRAPPERS, steps=256, seed=7,
                  params_path=weights, verbose=False, device="cuda")
        toggles = []

        class Counting(agents.RandomNetworkAgent):
            def forward(self, obs):
                action = super().forward(obs)
                toggles.append(int(action.sum()))
                return action

        t1 = time.perf_counter()
        score_ps, trace_ps = ev.evaluate(Counting, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        score_f, trace_f = ev.evaluate_fused(Agent=agents.RandomNetworkAgent, **kw)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        np.testing.assert_allclose(trace_f, np.asarray(trace_ps), rtol=1e-4, atol=1e-5)
        check(sum(toggles) > 0, "the network agent never toggled")
        agent = agents.RandomNetworkAgent(device="cuda")
        agent.load_state_dict(weights)
        near, outputs, toggled = _network_actions_held(torch, agent)

        # a .pt round trip of both learners on the card
        def stack():
            inner = RND2D(CARLE(device="cuda"), seed=0)
            outer = AE2D(inner, seed=1)
            return inner, outer

        inner, outer = stack()
        ev._load_wrapper_checkpoint(inner, ev.DEFAULT_WRAPPERS[0][2])
        ev._load_wrapper_checkpoint(outer, ev.DEFAULT_WRAPPERS[1][2])
        paths = {"RND2D": os.path.join(tmp, "RND2D.pt"), "AE2D": os.path.join(tmp, "AE2D.pt")}
        save_torch_checkpoint(paths["RND2D"], inner)
        save_torch_checkpoint(paths["AE2D"], outer)
        inner2, outer2 = stack()
        ev._load_wrapper_checkpoint(inner2, paths["RND2D"])
        ev._load_wrapper_checkpoint(outer2, paths["AE2D"])
        want, got = outer.state_dict(), outer2.state_dict()
        check(list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want),
              "the .pt round trip of RND2D and AE2D does not give the same state dict")
        check(outer2._wstate.params["conv1"]["w"].device.type == "cuda",
              "a .pt loaded into a shell on the card left its weights off the card")
        rewards = []
        for env in (outer, outer2):
            env.eval()
            env.env.eval()
            env.reset()
            rewards.append(torch.cat([env.step(a)[1] for a in acts[:8]]).cpu())
        check(torch.equal(rewards[0], rewards[1]), "the .pt stack's bonuses differ")
    out = {
        "rulesets": len(ev.DEFAULT_RULES), "steps_per_ruleset": steps,
        "score": score, "wall_s": wall, "steps_per_s": total / wall,
        "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
        "host_share": 1.0 - device_ms / wall_ms,
        "kernel_launches_per_step": {k: v / total for k, v in counts.items() if v},
        "device_launches_per_step": sum(e.count for e in kernels) / 64,
        "copies_per_step": sum(e.count for e in events if e not in kernels) / 64,
        "card_vs_cpu_replay_max_abs_diff": card_vs_cpu,
        "network_rulesets": RULES_B0, "network_steps": len(toggles),
        "network_toggles_per_step": sum(toggles) / len(toggles),
        "network_per_step_s": t2 - t1, "network_fused_s": t3 - t2,
        "network_score_per_step": score_ps, "network_score_fused": score_f,
        "network_fused_vs_per_step_max_abs_diff":
            float(np.abs(trace_f - np.asarray(trace_ps)).max()),
        "network_outputs_near_threshold": near, "network_outputs": outputs,
        "network_toggle_share": toggled,
    }
    log(f"submission ok: {json.dumps(out)}")
    log(f"submission launches: {json.dumps(counts)}")
    return counts, out


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
        network = _request(conn, "POST", "/score", {"agent": "network", "steps": 64})
        check(math.isfinite(network["score"]) and 0.0 <= network["score"] <= 10.0
              and network["agent"] == "network" and len(network["per_ruleset"]) == 5,
              f"/score network {network}")
        policy = _request(conn, "POST", "/score", {"agent": "policy", "steps": 64})
        check(math.isfinite(policy["score"]) and 0.0 <= policy["score"] <= 10.0
              and policy["agent"] == "policy" and len(policy["per_ruleset"]) == 5,
              f"/score policy {policy}")
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
        f"network agent {network['score']:.4f} in {network['latency_s']} s, "
        f"policy {policy['score']:.4f} in {policy['latency_s']} s, "
        f"rollout population {roll['population']} in {roll['latency_s']} s")
    log(f"server launches: {json.dumps(counts)}")
    return counts, {"score_latency_s": score["latency_s"],
                    "network_score_latency_s": network["latency_s"],
                    "policy_score_latency_s": policy["latency_s"],
                    "rollout_latency_s": roll["latency_s"]}


IO_UNIVERSES = 160      # the RLE comparison's and population_curve's universes of 256²
IO_FRAMES = 256         # the LZW comparison's episode: frames of one 256² universe
IO_SHELL_STEPS = 256    # logged shell steps after the glider sequence
IO_RESET_AT = 100       # the master reset in the shell's replayed stream
IO_LOGGED_STEPS = 1024  # run_logged on train-64's stack
# scripts/soup_search_torch.py's default is 64 soups; cut to 16, the first
# cut when the phase passed 60 s (67.7 s on a slow host, 12.5 s of it the
# 64-soup search)
IO_SOUPS = 16


def _gif_frames(data: bytes) -> int:
    """The image blocks of a GIF89a file, read by its block structure."""
    check(data[:6] == b"GIF89a", "not a GIF89a file")
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    frames = 0

    def skip_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            pos = skip_blocks(pos + 2)
        elif data[pos] == 0x2C:
            frames += 1
            pos = skip_blocks(pos + 11)
        else:
            raise AssertionError(f"unknown GIF block 0x{data[pos]:02x} at {pos}")
    return frames


def _same_files(paths_a, paths_b, what):
    for a, b in zip(paths_a, paths_b):
        check(os.path.basename(a) == os.path.basename(b), f"{what}: {a} vs {b}")
        with open(a, "rb") as f, open(b, "rb") as g:
            check(f.read() == g.read(), f"{what}: {os.path.basename(a)} differs")


def _logged_shell(torch, device, directory, acts, logging=True):
    """env._main's glider sequence, then the replayed stream ``acts``, on a
    256² CARLE shell; returns (the RLE, PNG and CSV files, ms a stream step)."""
    import numpy as np

    from carle_tpu_torch import CARLE

    env = CARLE(logging=logging, device=device)
    env.reset()
    glider = np.zeros((1, 1, 64, 64), dtype=np.float32)
    glider[0, 0, 14, 16] = 1.0
    glider[0, 0, 15, 16:18] = 1.0
    glider[0, 0, 16, 15:18:2] = 1.0
    env.step(glider)
    for _ in range(2):
        env.step(glider * 0)
    first, then = os.path.join(directory, "glider"), os.path.join(directory, "stream")
    paths = [env.save_rle(env.get_rle(env.state.grid[0]), first), env.save_frame(first),
             env.save_log(first)]
    sync = torch.cuda.synchronize if env.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for a in acts:
        env.step(a)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / len(acts)
    paths += [env.save_rle(env.get_rle(env.state.grid[0]), then), env.save_frame(then),
              env.save_log(then)]
    return paths, ms


def _clone_carry(torch, carry):
    """A copy of a rollout carry that shares no tensor and no generator state."""
    gen = torch.Generator(device=carry.generator.device)
    gen.set_state(carry.generator.get_state())
    copy = lambda t: t.clone() if torch.is_tensor(t) else t
    return carry._replace(stack=_map_state(carry.stack, copy),
                          agent_params=_map_state(carry.agent_params, copy), generator=gen)


def phase_io(torch, cuda_build):
    """Pattern I/O, episode artifacts and analysis (ROADMAP Queue 1 item 5):
    the native codecs against their numpy twins (host time), then the io
    path through its entry points with the launch counts from zero: the
    logged shell (env._main; card = CPU byte for byte), run_logged on
    train-64's stack (rewards = run's), run_gif, /gif and /classify through
    the server, population_curve, classify_pattern, the soup search and the
    demos; then episode_report and census, card = CPU."""
    import contextlib
    import io as io_mod
    import types

    import numpy as np

    from carle_tpu_torch import EnvConfig, analysis, demos, native, rle, rules, serve
    from carle_tpu_torch import env as env_mod
    from carle_tpu_torch.agents import make_random_agent
    from carle_tpu_torch.mcl import ae2d_def, rnd2d_def
    from carle_tpu_torch.mcl.patterns import pattern_path
    from carle_tpu_torch.ops import bitpack
    from carle_tpu_torch.ops.cuda_bitpack import bit_multi_step
    from carle_tpu_torch.rollout import Rollout
    from carle_tpu_torch.utils import gif

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    try:
        import soup_search_torch
    finally:
        sys.path.pop(0)

    out, seconds = {}, {}
    t_phase = time.perf_counter()
    life = rules.LIFE

    def soups(n, size, seed, density=0.3):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return (torch.rand((n, size, size), generator=gen, device="cuda")
                < density).to(torch.uint8)

    def timed_s(name, fn, *args, **kw):
        t0 = time.perf_counter()
        value = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return value

    # -- the native codecs against their twins (host work) -----------------
    t0 = time.perf_counter()
    ash = bitpack.unpack_grid(bit_multi_step(bitpack.pack_grid(soups(IO_UNIVERSES, 256, 11)),
                                             life, 256), 256).cpu().numpy()

    def encode_all(on):
        native.NATIVE = on
        try:
            t = time.perf_counter()
            bodies = [rle.encode_grid(g, [3], [2, 3]) for g in ash]
            return bodies, (time.perf_counter() - t) * 1e3 / len(ash)
        finally:
            native.NATIVE = True

    def decode_all(on, bodies):
        native.NATIVE = on
        try:
            t = time.perf_counter()
            grids = [rle.decode_body(b.split("\n", 3)[3], 256, 256) for b in bodies]
            return grids, (time.perf_counter() - t) * 1e3 / len(bodies)
        finally:
            native.NATIVE = True

    bodies, enc_ms = encode_all(True)
    twin_bodies, enc_twin_ms = encode_all(False)
    check(bodies == twin_bodies, "native RLE bodies differ from the numpy twin's")
    grids, dec_ms = decode_all(True, bodies)
    twin_grids, dec_twin_ms = decode_all(False, bodies)
    check(all(np.array_equal(a, g) and np.array_equal(b, g)
              for a, b, g in zip(grids, twin_grids, ash)),
          "decode_body does not give back the encoded universes")
    packed = bitpack.pack_grid(soups(1, 256, 12))
    episode = torch.empty((IO_FRAMES, 256, 256), dtype=torch.uint8, device="cuda")
    for t in range(IO_FRAMES):
        episode[t].copy_(bitpack.unpack_grid(packed, 256)[0])
        packed = bit_multi_step(packed, life, 1)
    episode = episode.cpu().numpy()
    t1 = time.perf_counter()
    gif_native = gif.encode_gif(episode)
    lzw_ms = (time.perf_counter() - t1) * 1e3
    native.NATIVE = False
    try:
        t1 = time.perf_counter()
        gif_twin = gif.encode_gif(episode)
        lzw_twin_ms = (time.perf_counter() - t1) * 1e3
    finally:
        native.NATIVE = True
    check(gif_native == gif_twin, "the native LZW stream differs from _lzw_encode_py's")
    check(_gif_frames(gif_native) == IO_FRAMES, "the episode GIF's frames")
    out["codecs"] = {
        "rle_universes": IO_UNIVERSES, "ash_density": float(ash.mean()),
        "rle_body_bytes_mean": sum(len(b) for b in bodies) / len(bodies),
        "rle_encode_ms_per_universe": enc_ms, "rle_encode_twin_ms_per_universe": enc_twin_ms,
        "rle_decode_ms_per_universe": dec_ms, "rle_decode_twin_ms_per_universe": dec_twin_ms,
        "lzw_frames": IO_FRAMES, "gif_bytes": len(gif_native),
        "gif_encode_ms": lzw_ms, "gif_encode_twin_ms": lzw_twin_ms,
    }
    seconds["codecs"] = time.perf_counter() - t0

    # -- the io path through its entry points -------------------------------
    stream = (np.random.RandomState(20).rand(IO_SHELL_STEPS, 1, 1, 64, 64) < 0.02
              ).astype(np.float32)
    stream[IO_RESET_AT] = 1.0   # the master reset
    cfg = EnvConfig(instances=64)
    defs = [rnd2d_def(cfg), ae2d_def(cfg)]   # both learning, dropout on
    ro = Rollout(cfg, defs, make_random_agent(64, 64, 0.1), device="cuda")
    carry0, _ = ro.reset(ro.init(ro.generator(0), life))
    carry_run = _clone_carry(torch, carry0)
    torch.cuda.synchronize()
    pinned = types.SimpleNamespace(time=lambda: 1_700_000_000.0, sleep=time.sleep)
    with tempfile.TemporaryDirectory() as tmp:
        cuda_build.reset_launch_counts()
        t_path = time.perf_counter()
        with contextlib.redirect_stdout(io_mod.StringIO()) as sweep:
            timed_s("env_main", env_mod._main, ["--logs", os.path.join(tmp, "main"),
                                                "--frames", os.path.join(tmp, "main"),
                                                "--instances", "1", "64"])
        out["env_main"] = sweep.getvalue().strip().splitlines()
        check(len(out["env_main"]) == 2, f"env._main printed {out['env_main']}")
        real_time = env_mod.time
        env_mod.time = pinned   # both shells name their files alike
        try:
            card_files, logged_ms = timed_s("logged_shell", _logged_shell, torch, "cuda",
                                            os.path.join(tmp, "cuda"), stream)
            _, unlogged_ms = _logged_shell(torch, "cuda", os.path.join(tmp, "plain"), stream,
                                           logging=False)
        finally:
            env_mod.time = real_time
        out["shell"] = {"steps": IO_SHELL_STEPS, "logged_ms_per_step": logged_ms,
                        "unlogged_ms_per_step": unlogged_ms}

        # run_logged on train-64's stack against run from the same carry
        # (after 16 steps of a copy, so neither pays the first steps' setup)
        ro.run(_clone_carry(torch, carry0), 16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry_run, r_run = ro.run(carry_run, IO_LOGGED_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        carry, r_logged, log_path = ro.run_logged(carry0, IO_LOGGED_STEPS, snapshot_every=256,
                                                  directory=os.path.join(tmp, "run_logged"))
        torch.cuda.synchronize()
        logged_s = time.perf_counter() - t0
        seconds["run_logged"] = run_s + logged_s
        torch.testing.assert_close(r_logged, r_run, rtol=1e-5, atol=0)
        entries = rle.read_log(log_path)
        check(len(entries) == -(-IO_LOGGED_STEPS // 256),
              f"run_logged wrote {len(entries)} entries")
        t0 = time.perf_counter()
        carry, r_gif, gif_path = ro.run_gif(carry, 256, path=os.path.join(tmp, "episode.gif"),
                                            every=2, instance=0)
        torch.cuda.synchronize()
        seconds["run_gif"] = time.perf_counter() - t0
        with open(gif_path, "rb") as f:
            gif_frames = _gif_frames(f.read())
        check(gif_frames == 128 and bool(torch.isfinite(r_gif).all()), "run_gif's episode")
        out["rollout"] = {
            "universes": 64, "steps": IO_LOGGED_STEPS, "snapshot_every": 256,
            "run_ms_per_step": run_s * 1e3 / IO_LOGGED_STEPS,
            "run_logged_ms_per_step": logged_s * 1e3 / IO_LOGGED_STEPS,
            "rewards_max_abs_diff": float((r_logged - r_run).abs().max()),
            "run_gif_ms_per_step": seconds["run_gif"] * 1e3 / 256, "gif_frames": gif_frames,
        }

        # /gif and /classify through the running server
        t0 = time.perf_counter()
        srv = serve.make_server("127.0.0.1", 0, device="cuda")
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=600)
            gif_body = {"size": 256, "steps": 256, "every": 4, "seed": 3}
            gif_resp = _request(conn, "POST", "/gif", gif_body)
            roll = _request(conn, "POST", "/rollout", {"size": 256, "steps": 1024, "seed": 4})
            classify = _request(conn, "POST", "/classify",
                                {"rle": roll["rle"], "size": 256, "census": True,
                                 "max_period": 16})
            conn.request("GET", "/")
            page = conn.getresponse()
            check(page.status == 200 and b"/classify" in page.read(), "GET / demo page")
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
        check(not thread.is_alive(), "server thread did not stop")
        seconds["server"] = time.perf_counter() - t0
        data = __import__("base64").b64decode(gif_resp["gif_base64"])
        check(gif_resp["frames"] == 65 and _gif_frames(data) == 65, "/gif frames")
        grid, _, _, _ = serve._initial_grid(gif_body, torch.device("cuda"))
        want = bitpack.bit_multi_step(bitpack.pack_grid(grid.cpu()), life, 256)
        check(gif_resp["population"] == int(bitpack.unpack_grid(want, 256).sum()),
              "/gif's last frame differs from the plain engine's")
        check(sum(classify["counts"].values()) == len(classify["objects"]) > 0,
              f"/classify census {classify['counts']}")

        # population_curve, classify_pattern
        big = soups(IO_UNIVERSES, 256, 13)
        curve = timed_s("population_curve", analysis.population_curve, big, life, 1024)
        want = bitpack.bit_multi_step(bitpack.pack_grid(big), life, 1024)
        check(curve.shape == (1024, IO_UNIVERSES) and np.array_equal(
            curve[-1], bitpack.unpack_grid(want, 256).sum(dim=(1, 2)).cpu().numpy()),
            "population_curve's last counts differ from the packed engine's")

        def boxed(name):
            g = rle.read_rle(pattern_path(name)).grid
            box = np.zeros((analysis._canonical_box(g.shape[0] + 16),
                            analysis._canonical_box(g.shape[1] + 16)), np.uint8)
            box[8:8 + g.shape[0], 8:8 + g.shape[1]] = g
            return box

        patterns = {name: boxed(name) for name in ("glider_1", "lwss", "gosper_gun")}
        t0 = time.perf_counter()
        kinds = {name: analysis.classify_pattern(g, life, device="cuda")
                 for name, g in patterns.items()}
        seconds["classify_pattern"] = time.perf_counter() - t0
        check(kinds["glider_1"][:2] == ("spaceship", 4) and kinds["glider_1"].speed == 0.25
              and kinds["lwss"][:2] == ("spaceship", 4) and kinds["lwss"].speed == 0.5,
              f"classify_pattern {kinds}")

        # the soup search at its defaults but the soups, and the demos at
        # their __main__ sizes
        log(f"io: the soup search runs {IO_SOUPS} soups, cut from its default 64 to keep "
            "the phase under 60 s")
        with contextlib.redirect_stdout(io_mod.StringIO()) as soup_out:
            t0 = time.perf_counter()
            soup_search_torch.main(["--soups", str(IO_SOUPS)])
            seconds["soup_search"] = time.perf_counter() - t0
        lines = [json.loads(l) for l in soup_out.getvalue().splitlines() if l.startswith("{")]
        agg = lines[-1]["soup_search"]
        check(len(lines) == IO_SOUPS + 1 and agg["soups"] == IO_SOUPS
              and sum(agg["object_counts"].values()) > 0, f"soup search {agg}")
        demo_dir = os.path.join(tmp, "demos")
        with contextlib.redirect_stdout(io_mod.StringIO()):
            timed_s("demos", demos.main, [demo_dir])
        made = sorted(os.listdir(demo_dir))
        check(len([n for n in made if n.endswith(".npy")]) == 10
              and "episode_random_life.gif" in made, f"demo files {made}")
        path_s = time.perf_counter() - t_path
        counts = cuda_build.launch_counts()

        # card against CPU: the shell's files, episode_report, census
        env_mod.time = pinned
        try:
            cpu_files, _ = _logged_shell(torch, "cpu", os.path.join(tmp, "cpu"), stream)
        finally:
            env_mod.time = real_time
        _same_files(card_files, cpu_files, "logged shell, card vs CPU")
        reports = {d: analysis.episode_report(card_files[-1], life, max_period=16, device=d)
                   for d in ("cuda", "cpu")}
        check(reports["cuda"] == reports["cpu"], f"episode_report card vs CPU {reports}")
        small = bitpack.unpack_grid(bit_multi_step(bitpack.pack_grid(soups(1, 64, 14)), life,
                                                   128), 64)[0].cpu().numpy()
        censuses = {d: analysis.census(small, life, max_period=16, device=d)
                    for d in ("cuda", "cpu")}
        check(censuses["cuda"] == censuses["cpu"], "census card vs CPU")
        kinds_cpu = {name: analysis.classify_pattern(g, life, device="cpu")
                     for name, g in patterns.items()}
        check(kinds == kinds_cpu, f"classify_pattern card vs CPU {kinds} {kinds_cpu}")

    out.update({
        "gif": {"frames": gif_resp["frames"], "bytes": len(data),
                "latency_s": gif_resp["latency_s"]},
        "classify": {"objects": len(classify["objects"]), "counts": classify["counts"],
                     "latency_s": classify["latency_s"]},
        "population_curve": {"universes": IO_UNIVERSES, "generations": 1024,
                             "ms_per_generation": seconds["population_curve"] * 1e3 / 1024},
        "classify_pattern": {k: [c.kind, c.period, list(c.displacement)]
                             for k, c in kinds.items()},
        "soup_search": {"soups": IO_SOUPS, "soups_cut_from": 64, "size": 256, "steps": 1024,
                        "object_counts": agg["object_counts"],
                        "notable_objects": agg["notable_objects"]},
        "episode_report": reports["cuda"]["population"],
        "census_64": censuses["cuda"]["counts"],
        "path_s": path_s, "seconds": seconds, "phase_s": time.perf_counter() - t_phase,
    })
    log(f"io ok: {json.dumps(out)}")
    log(f"io launches: {json.dumps(counts)}")
    return counts, out


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

    ckpt = {cls.my_name: path for cls, _, path in ev.DEFAULT_WRAPPERS}
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

    device_us = _device_us
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


ENC3_FWD_KERNELS = {"new": ("enc3_fwd_kernel",), "generic": ("encoder_fwd_kernel",)}
ENC3_BWD_KERNELS = {"new": ("enc3_bwd_kernel", "column_sums_kernel"),
                    "generic": ("encoder_bwd_stage", "column_sums_kernel")}
POLICY_WIDTHS = (8, 1, 2, 2)   # the toggle policy's encoder (C1, C2, P1, P2)


def _enc3_policy_held(torch, timer, cuda_build):
    """Rows 3a and 3b at the policy's widths (8, 1, 2, 2), the shapes of its
    main path (the eval geometry, 256²): the forward on 16 universes (a PPO or
    REINFORCE sampling step) and on 512 (a PPO minibatch of 16 x 128 / 4),
    the backward on 512.  The specialised kernels (the route) against the
    generic ones forced (cuda_head.ENC3_KERNELS off): the forward bit for bit,
    the gradients within 1e-5 of each leaf's largest entry, each within 1e-4
    of the twin; timed in turns and by CUPTI cold (_ab_cases) against
    encoder_bound_parts (no dropout: the policy draws none).  Returns
    {"fwd": ..., "bwd": ..., "plain_ms": ...}."""
    from carle_tpu_torch.ops import cuda_head as ch
    from carle_tpu_torch.policy import init_policy_params
    from carle_tpu_torch import EnvConfig

    c1, c2, p1, p2 = POLICY_WIDTHS
    pools, dev = (p1, p2), torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    params = init_policy_params(gen, EnvConfig())
    w4 = (params["conv1"]["w"], params["conv1"]["b"], params["conv2"]["w"],
          params["conv2"]["b"])
    xs = {n: (torch.rand((n, 1, 256, 256), generator=gen, device=dev) < 0.3).to(torch.uint8)
          for n in (16, 512)}
    xs[512][:128, :, :128] = 0   # blank regions: whole pool windows tie
    g = torch.randn((512, c2, 64, 64), generator=gen, device=dev)
    fwd_cases = {f"u8 [{n},1,256,256]": n for n in (16, 512)}
    fwd_calls = {label: (lambda x=xs[n]: ch.encoder_fwd(x, *w4, pools),
                         lambda x=xs[n]: _generic_encoder(lambda: ch.encoder_fwd(x, *w4, pools)))
                 for label, n in fwd_cases.items()}

    def hold_fwd(label, got, old):
        check(torch.equal(got, old), f"enc3_fwd at the policy's widths ({label}) differs "
              "from the generic kernel")
        twin = ch.encoder_fwd_plain(xs[fwd_cases[label]], *w4, pools)
        rel = float((got - twin).abs().max() / twin.abs().max())
        check(rel < 1e-4, f"enc3_fwd at the policy's widths ({label}) vs its twin: {rel}")
        return {"new": {"max_abs_err": float((got - twin).abs().max()),
                        "max_rel_err_vs_plain": rel, "bit_equal_generic": True},
                "generic": {"max_abs_err": float((old - twin).abs().max())}}

    def plan_occupancy(n, backward):
        r2, tw, smem = ch._enc3_plan(n, 256, 256, c1, c2, p1, backward)
        occ = (_occupancy(cuda_build, "enc3_bwd", "enc3_bwd_occupancy", c1, c2, p1, 0, Big(smem))
               if backward else
               _occupancy(cuda_build, "enc3_fwd", "enc3_fwd_occupancy", c1, c2, p1, 0, Big(smem)))
        return dict(plan=(r2, tw), smem=smem, **occ[0])

    fwd = _ab_cases(
        torch, timer, "enc3_fwd (policy widths)", fwd_calls, (ch.ENC3_FWD, ch.ENCODER),
        ENC3_FWD_KERNELS, hold_fwd,
        lambda label: _largest(encoder_bound_parts(fwd_cases[label], 256, 256, c1, c2, p1, 1, 0,
                                                   False)),
        lambda label: plan_occupancy(fwd_cases[label], False))
    bwd_label = "u8 [512,1,256,256], g [512,1,64,64]"
    bwd_call = lambda: ch.encoder_bwd(xs[512], *w4, g, pools)
    twin_grads = ch.encoder_bwd_plain(xs[512], *w4, g, pools)

    def hold_bwd(label, got, old):
        vs_generic, vs_twin = max(_leaf_errors(got, old)), max(_leaf_errors(got, twin_grads))
        check(vs_generic < 1e-5, f"enc3_bwd at the policy's widths vs the generic kernel: "
              f"{vs_generic}")
        check(vs_twin < 1e-4, f"enc3_bwd at the policy's widths vs its twin: {vs_twin}")
        err = lambda gs: max(float((a - b).abs().max()) for a, b in zip(gs, twin_grads))
        return {"new": {"max_abs_err": err(got), "max_leaf_rel_err_vs_plain": vs_twin,
                        "max_leaf_rel_err_vs_generic": vs_generic},
                "generic": {"max_abs_err": err(old),
                            "max_leaf_rel_err_vs_plain": max(_leaf_errors(old, twin_grads))}}

    bwd = _ab_cases(
        torch, timer, "enc3_bwd (policy widths)",
        {bwd_label: (bwd_call, lambda: _generic_encoder(bwd_call))}, (ch.ENC3_BWD, ch.ENCODER_BWD),
        ENC3_BWD_KERNELS, hold_bwd,
        lambda label: _largest(encoder_bound_parts(512, 256, 256, c1, c2, p1, 1, 0, True)),
        lambda label: plan_occupancy(512, True))
    plain_ms = {"fwd 16": timer.ms(lambda: ch.encoder_fwd_plain(xs[16], *w4, pools), 5),
                "fwd 512": timer.ms(lambda: ch.encoder_fwd_plain(xs[512], *w4, pools), 3),
                "bwd 512": timer.ms(lambda: ch.encoder_bwd_plain(xs[512], *w4, g, pools), 2)}
    speedup = {f"{label} {shape}": r["generic"]["ms"] / r["new"]["ms"]
               for label, cases in (("fwd", fwd), ("bwd", bwd)) for shape, r in cases.items()}
    log(f"enc3 at the policy's widths {POLICY_WIDTHS}: generic ms / specialised ms "
        f"{json.dumps(speedup)}, plain ms {json.dumps(plain_ms)}")
    return {"fwd": fwd, "bwd": bwd, "plain_ms": plain_ms, "speedup": speedup}


POLICY_STEPS = 64        # REINFORCE steps of the policy phase
PPO_HORIZON, PPO_ITERS = 128, 2
DET_RATE = 0.5           # the deterministic agent's threshold on sigmoid(logit)


def _policy_stack(instances):
    """(config, frozen DEFAULT_WRAPPERS defs) at the eval geometry."""
    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.evaluation import eval as ev

    cfg = EnvConfig(instances=instances)
    return cfg, ev.wrapper_defs(cfg, ev.DEFAULT_WRAPPERS, False)


def _policy_init(trainer, seed):
    """A trainer's state with the shipped checkpoints in the frozen stack."""
    from carle_tpu_torch import rules
    from carle_tpu_torch.evaluation import eval as ev

    state = trainer.init(trainer.generator(seed), rules.LIFE)
    return state._replace(stack=state.stack._replace(
        wrappers=ev.inject_wrapper_checkpoints(state.stack.wrappers, ev.DEFAULT_WRAPPERS)))


def _device_window(torch, fn):
    """fn() once unprofiled (wall ms, peak device memory above the start) and
    once under torch.profiler: device ms and launches (kernels only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in events) / 1e3
    kernels = [e for e in events if not e.key.startswith("Memcpy")]
    top = sorted(events, key=_device_us, reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "launches": sum(e.count for e in kernels), "peak_bytes": peak,
            "peak_bytes_above_start": peak - base,
            "top_device_us": [{"name": e.key[:60], "us": _device_us(e), "count": e.count}
                              for e in top]}


def phase_policy(torch, cuda_build):
    """The policies at full width, the eval geometry (256² universes, 64²
    actions, DEFAULT_WRAPPERS frozen with the shipped .npz), counted from zero
    just before: PPO on 16 universes with the fused encoder (horizon 128, 4
    epochs of 4 minibatches), two iterations; REINFORCE on 16 universes, 64
    steps; the shipped policy through evaluate_fused (5 x 1024) and
    evaluate_fused_batched (5 universes x 1024).  After the count: a PPO
    iteration of 32 steps and a REINFORCE window profiled."""
    from carle_tpu_torch.evaluation import eval as ev
    from carle_tpu_torch.policy import PolicyTrainer, PPOTrainer

    cfg, defs = _policy_stack(16)
    ppo = PPOTrainer(cfg, defs, fused_head=True, device="cuda")
    state = _policy_init(ppo, 0)
    cfg_r, defs_r = _policy_stack(16)
    rf = PolicyTrainer(cfg_r, defs_r, fused_head=True, device="cuda")
    rstate = _policy_init(rf, 1)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    out, traces = {"ppo": []}, []
    for _ in range(PPO_ITERS):
        t0 = time.perf_counter()
        state, batch = ppo.collect(state, PPO_HORIZON)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = ppo.update(state, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        traces.append(batch.rewards.mean(dim=1).cpu())
        out["ppo"].append({"collect_ms_per_step": (t1 - t0) * 1e3 / PPO_HORIZON,
                           "update_ms": (t2 - t1) * 1e3})
    t0 = time.perf_counter()
    rstate, rtrace = rf.run(rstate, POLICY_STEPS)
    torch.cuda.synchronize()
    out["reinforce_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / POLICY_STEPS
    pair = ev.load_shipped_policy(device="cuda")
    t0 = time.perf_counter()
    score, trace = ev.evaluate_fused(Agent=pair, steps=1024, verbose=False, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    score_b, per_rule = ev.evaluate_fused_batched(Agent=pair, steps=1024, verbose=False,
                                                  device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = cuda_build.launch_counts()
    ppo_trace = torch.cat(traces)
    check(ppo_trace.shape == (PPO_ITERS * PPO_HORIZON,) and bool(torch.isfinite(ppo_trace).all()),
          "PPO trace")
    check(bool(torch.isfinite(rtrace.cpu()).all()) and rtrace.shape == (POLICY_STEPS,),
          "REINFORCE trace")
    leaves = [t for k in ("conv1", "conv2", "dense") for t in state.params[k].values()]
    check(all(bool(torch.isfinite(t).all()) for t in leaves), "PPO parameters")
    check(int(state.opt_state["count"]) == PPO_ITERS * ppo.epochs * ppo.minibatches,
          f"PPO updates {int(state.opt_state['count'])}")
    check(int(rstate.opt_state["count"]) == POLICY_STEPS, "REINFORCE updates")
    for name, v in (("sequential", score), ("batched", score_b)):
        check(math.isfinite(v) and 0.0 <= v <= 10.0, f"shipped policy {name} score {v}")
    check(trace.shape == (5 * 1024,) and per_rule.shape == (5,), "shipped policy shapes")
    out.update(
        ppo_mean_reward_first=float(traces[0].mean()), ppo_mean_reward_last=float(traces[-1].mean()),
        reinforce_mean_reward=float(rtrace.mean()),
        shipped_score=score, shipped_s=t1 - t0, shipped_steps_per_s=5 * 1024 / (t1 - t0),
        shipped_batched_score=score_b, shipped_batched_per_ruleset=[float(v) for v in per_rule],
        shipped_batched_s=t2 - t1)
    # where the time goes (after the count): 32 collect steps, an update phase
    # on the last iteration's batch (16 minibatches of 512) and 16 REINFORCE
    # steps
    out["profile_ppo_collect_32"] = _device_window(torch, lambda: ppo.collect(state, 32))
    out["profile_ppo_update"] = _device_window(torch, lambda: ppo.update(state, batch))
    out["profile_reinforce_16"] = _device_window(torch, lambda: rf.run(rstate, 16))
    for key, steps in (("profile_ppo_collect_32", 32), ("profile_ppo_update", 16),
                       ("profile_reinforce_16", 16)):
        out[key]["launches_per_step"] = out[key]["launches"] / steps
    log(f"policy: PPO ms a collect step {[r['collect_ms_per_step'] for r in out['ppo']]}, "
        f"ms an update phase {[r['update_ms'] for r in out['ppo']]}; REINFORCE "
        f"{out['reinforce_ms_per_step']:.3f} ms a step")
    for key, unit in (("profile_ppo_collect_32", "a step"), ("profile_ppo_update", "a minibatch"),
                      ("profile_reinforce_16", "a step")):
        r = out[key]
        log(f"policy {key}: wall {r['wall_ms']:.2f} ms, device {r['device_ms']:.2f} ms, busy "
            f"share {r['busy_share']:.3f}, launches {r['launches']} ({r['launches_per_step']} "
            f"{unit}), peak "
            f"memory {r['peak_bytes'] / 2**30:.3f} GiB ({r['peak_bytes_above_start'] / 2**30:.3f} "
            "above the start)")
    log(f"policy: the shipped policy's battery score {score:.5f} in {t1 - t0:.2f} s "
        f"(5 x 1024 steps), batched {score_b:.5f} in {t2 - t1:.2f} s")
    log(f"policy launches: {json.dumps(counts)}")
    return counts, out


class _ActionLedger:
    """Wraps a trainer's or agent's draw: ``record`` keeps each action the
    card takes (with its probabilities); ``check`` (the CPU's run) computes its
    own action, counts the cells where it differs from the card's recorded one
    while the draw lies more than 1e-4 from the probability, and plays the
    card's action, so both runs follow one trajectory."""

    def __init__(self):
        self.actions, self.cells, self.mismatched, self.near = [], 0, 0, 0

    def record(self, action):
        self.actions.append(action.cpu())
        return action

    def check(self, action, prob, threshold, at):
        card = self.actions[at].to(action.device)
        far = (threshold - prob).abs() > 1e-4
        self.cells += action.numel()
        self.near += int((~far).sum())
        self.mismatched += int(((card != action) & far).sum())
        return card


def _ppo_card_vs_cpu(torch):
    """One PPO iteration at 4 universes x horizon 8 (DEFAULT_WRAPPERS, the
    fused encoder, 4 epochs of 4 minibatches), on the card and on the CPU
    (the twins) from the same initial state, the uniforms and permutations
    replayed from one numpy stream in both: the CPU's actions equal the
    card's where the uniform lies more than 1e-4 from sigmoid(logit) (the CPU
    then plays the card's), the rewards within rtol 1e-4, and after the 16
    Adam updates: the conv leaves and the dense bias within 2e-3 of each
    leaf's largest entry; the dense weight (16.8 M entries) within rtol 2e-3 /
    atol 1e-6 but for at most 1e-5 of its entries, none of them more than
    Adam's bound of 2 lr an update apart (a gradient entry that sums to
    float32's rounding floor takes a full +-lr step whose sign the summation
    order decides); the updated policies' logits on the collected grids
    within rtol 2e-3 / atol 1e-4."""
    import numpy as np

    from carle_tpu_torch.policy import PPOTrainer, policy_logits

    rng = np.random.RandomState(19)
    uniforms = rng.rand(8, 4, 64 * 64).astype(np.float32)
    perms = [rng.permutation(32) for _ in range(4)]
    ledger = _ActionLedger()
    got = {}
    for device, card in (("cuda", True), ("cpu", False)):
        cfg, defs = _policy_stack(4)
        tr = PPOTrainer(cfg, defs, fused_head=True, device=device)
        state = _policy_init(tr, 0)
        if card:
            got["init"] = _map_state(state.params, lambda t: t.clone())
            got["wrappers"] = _map_state(state.stack.wrappers,
                                         lambda t: t.clone() if torch.is_tensor(t) else t)
        else:   # the card's initial state
            to = lambda t: t.to(device) if torch.is_tensor(t) else t
            state = state._replace(
                params=_map_state(got["init"], to),
                stack=state.stack._replace(wrappers=tuple(
                    _map_state(ws, to) for ws in got["wrappers"])))
        state = state._replace(opt_state=tr.opt.init(state.params))
        step = iter(range(8))
        perm_at = iter(perms)

        def sample(logits, generator, device=device, card=card, step=step):
            t = next(step)
            u = torch.from_numpy(uniforms[t]).to(device)
            prob = torch.sigmoid(logits)
            action = (u < prob).to(torch.float32)
            return ledger.record(action) if card else ledger.check(action, prob, u, t)

        tr._sample = sample
        tr._permutation = lambda generator, n, device=device, perm_at=perm_at: torch.from_numpy(
            next(perm_at)).to(device)
        state, batch = tr.collect(state, 8)
        state = tr.update(state, batch)
        with torch.no_grad():
            logits = policy_logits(state.params, batch.grids.reshape(32, 1, 256, 256), True)
        got["card" if card else "host"] = (batch.rewards.mean(dim=1).cpu(),
                                           _map_state(state.params, lambda t: t.cpu()),
                                           logits.cpu())
    torch.testing.assert_close(got["card"][0], got["host"][0], rtol=1e-4, atol=1e-5)
    leaves = lambda p: [p[k][t] for k in ("conv1", "conv2", "dense") for t in ("w", "b")]
    errs = _leaf_errors(leaves(got["card"][1]), leaves(got["host"][1]))
    moved = max(_leaf_errors(leaves(got["host"][1]),
                             leaves(_map_state(got["init"], lambda t: t.cpu()))))
    check(ledger.mismatched == 0, f"PPO card vs CPU: {ledger.mismatched} actions differ away "
          "from the draw")
    check(max(errs[:4] + errs[5:]) < 2e-3, f"PPO card vs CPU parameters after 16 updates "
          f"(conv1 w, b, conv2 w, b, dense w, b): {errs}")
    wc, wh = got["card"][1]["dense"]["w"], got["host"][1]["dense"]["w"]
    diff = (wc - wh).abs()
    beyond = int((diff > 1e-6 + 2e-3 * wh.abs()).sum())
    lr, updates = 3e-4, 16
    check(beyond <= 1e-5 * wh.numel() and float(diff.max()) <= 2 * lr * updates,
          f"PPO card vs CPU dense weight: {beyond} entries beyond rtol 2e-3, largest "
          f"difference {float(diff.max())}")
    torch.testing.assert_close(got["card"][2], got["host"][2], rtol=2e-3, atol=1e-4)
    check(moved > 0, "PPO parameters did not move")
    out = {"reward_max_abs_diff": float((got["card"][0] - got["host"][0]).abs().max()),
           "param_leaf_rel_diff": errs, "dense_w_beyond_rtol": beyond,
           "dense_w_max_abs_diff": float(diff.max()),
           "logits_max_abs_diff": float((got["card"][2] - got["host"][2]).abs().max()),
           "param_moved": moved, "near_draw_cells": ledger.near, "cells": ledger.cells}
    log(f"policy PPO card vs CPU: {json.dumps(out)}")
    return out


def _shipped_card_vs_cpu(torch):
    """The shipped policy's deterministic agent (toggle where sigmoid(logit) >
    DET_RATE) through evaluate_fused over 2 rulesets x 64 steps on the card and
    the CPU: actions equal where sigmoid(logit) lies more than 1e-4 from the
    rate (the CPU then plays the card's), the trace within rtol 1e-4 / atol
    1e-5."""
    from carle_tpu_torch import EnvConfig
    from carle_tpu_torch.agents import Agent
    from carle_tpu_torch.evaluation import eval as ev
    from carle_tpu_torch.policy import _policy_agent, policy_logits

    ledger = _ActionLedger()
    base = _policy_agent(EnvConfig(), deterministic_rate=DET_RATE)
    traces = {}
    for device, card in (("cuda", True), ("cpu", False)):
        _, params = ev.load_shipped_policy(device=device)
        calls = iter(range(2 * 64))

        def apply(p, generator, obs, card=card, calls=calls):
            action = base.apply(p, generator, obs)
            if card:
                return ledger.record(action)
            with torch.no_grad():
                prob = torch.sigmoid(policy_logits(p, obs)).reshape(action.shape)
            return ledger.check(action, prob, torch.full_like(prob, DET_RATE), next(calls))

        _, traces["card" if card else "host"] = ev.evaluate_fused(
            Agent=(Agent(init=base.init, apply=apply), params), rules=ev.DEFAULT_RULES[:2],
            steps=64, verbose=False, device=device)
    check(ledger.mismatched == 0, f"shipped policy card vs CPU: {ledger.mismatched} actions "
          "differ away from the rate")
    np_diff = abs(traces["card"] - traces["host"])
    torch.testing.assert_close(torch.from_numpy(traces["card"]), torch.from_numpy(traces["host"]),
                               rtol=1e-4, atol=1e-5)
    toggles = sum(float(a.sum()) for a in ledger.actions) / len(ledger.actions)
    out = {"trace_max_abs_diff": float(np_diff.max()), "near_rate_cells": ledger.near,
           "cells": ledger.cells, "toggles_per_step": toggles}
    check(toggles > 0, "the deterministic shipped policy never toggled")
    log(f"policy shipped deterministic agent card vs CPU: {json.dumps(out)}")
    return out


def phase_policy_parity(torch):
    return {"ppo": _ppo_card_vs_cpu(torch), "shipped": _shipped_card_vs_cpu(torch)}


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
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        value = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")
        return value

    try:
        card = card_line()
        log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        build_s = phase_build(cuda_build)
        log(f"build: {build_s:.1f} s")
        philox = philox_draw_ops(cuda_build)
        log(f"a Philox draw's SASS (sm_90a): {json.dumps(philox)}")
        shipped = shipped_states(torch)
        timer = Timer(torch)
        results = timed("kernels", phase_kernels, torch, timer, shipped, philox)
        enc3_occupancy = _enc3_occupancy(cuda_build)
        log(f"enc3 occupancy: {json.dumps(enc3_occupancy)}")
        enc3_policy = timed("enc3_policy", _enc3_policy_held, torch, timer, cuda_build)
        dec2_occupancy = _dec2_occupancy(cuda_build)
        log(f"dec2 occupancy: {json.dumps(dec2_occupancy)}")
        tail2_occupancy = _tail2_occupancy(cuda_build)
        log(f"tail2 occupancy: {json.dumps(tail2_occupancy)}")
        ae2d = timed("ae2d", phase_ae2d, torch, timer, cuda_build, philox)
        log(f"ae2d ok: {json.dumps(ae2d)}")
        results.update(timed("spatial_kernels", phase_spatial_kernels, torch, timer,
                             torch.Generator(device="cuda").manual_seed(6)))
        engines_counts, engines = timed("engines", phase_engines, torch, cuda_build)
        routes_counts, routes = timed("routes", phase_routes, torch, timer, cuda_build)
        del timer
        torch.cuda.empty_cache()
        battery_counts, e2e = timed("battery", phase_battery, torch, cuda_build)
        parity_diff = timed("parity", phase_parity, torch)
        submission_counts, submission = timed("submission", phase_submission, torch,
                                              cuda_build)
        server_counts, server = timed("server", phase_server, torch, cuda_build)
        io_counts, io = timed("io", phase_io, torch, cuda_build)
        policy_counts, policy = timed("policy", phase_policy, torch, cuda_build)
        policy_parity = timed("policy_parity", phase_policy_parity, torch)
        train_counts, train, train_hist = timed("train", phase_train, torch, cuda_build)
        train_parity_diff = timed("train_parity", phase_train_parity, torch)
        packed_counts, packed = timed("packed", phase_packed, torch, cuda_build, train_hist)
        wrappers_counts, wrappers = timed("wrappers", phase_wrappers, torch, cuda_build,
                                          shipped)
        bands_counts, bands = timed("bands", phase_bands, torch, cuda_build)
        spatial_counts, spatial = timed("spatial", phase_spatial, torch, cuda_build)
        spatial_2d_counts, spatial_2d = timed("spatial_2d", phase_spatial_2d, torch, cuda_build)
        env_mesh_counts, env_mesh = timed("env_mesh", phase_env_mesh, torch, cuda_build)
        mp_counts, multiprocess = timed("multiprocess", phase_multiprocess, torch, cuda_build)
        surfaces_counts, surfaces = timed("surfaces", phase_surfaces, torch, cuda_build)
        profile = timed("profile", phase_profile, torch)
        log(f"profile: {json.dumps(profile)}")
        profile_train = timed("profile_train", phase_profile_train, torch)
        log(f"profile (training): {json.dumps(profile_train)}")
        profile_packed = timed("profile_packed", phase_profile_train, torch, 64, True)
        log(f"profile (packed training): {json.dumps(profile_packed)}")
    except Exception:  # report the failing phase and exit non-zero
        traceback.print_exc()
        log("FAIL: see the traceback above")
        return 1

    path_counts = {"battery": battery_counts, "submission": submission_counts,
                   "server": server_counts, "io": io_counts,
                   "train": train_counts, "routes": routes_counts,
                   "wrappers": wrappers_counts, "packed": packed_counts,
                   "bands": bands_counts, "engines": engines_counts,
                   "spatial": spatial_counts, "spatial_2d": spatial_2d_counts,
                   "env_mesh": env_mesh_counts, "policy": policy_counts,
                   "multiprocess": mp_counts, "surfaces": surfaces_counts}
    missing = [f"{path}:{k}" for path, needed in PATH_KERNELS.items()
               for k in needed if path_counts[path][k] == 0]
    if missing:
        log(f"FAIL: kernels not launched on the main path: {missing}")
        return 1
    generic = {f"{path}:{k}": c[k] for path, c in path_counts.items()
               for k in GENERIC_ENCODER + GENERIC_DECODER + GENERIC_TAIL + BYTE_CA_STEP
               + PRESENT_PACKED + PRESENT_STATIC + GENERIC_HEAD + PRESENT_U8_HALO
               + GENERIC_LOSS_TAIL if c[k]}
    if generic:
        log(f"FAIL: generic encoder, decoder-loss, tail, loss-tail or head "
            f"kernels, the byte ca_step kernel or the present packed or uint8 engines or "
            f"halo kernels launched on the main paths: {generic}")
        return 1
    ae_launches = {path: {k: c[k] for ks in AE_INSTANTIATIONS.values() for k in ks}
                   for path, c in path_counts.items()}
    log(f"whole-autoencoder launches by instantiation (AE2D, generic): {json.dumps(ae_launches)}")
    kernels = []
    rows = {name: (name, source, replaces) for name, (source, replaces) in SOURCES.items()}
    rows.update(FEATURE_ROWS)
    for name, (kernel, source, replaces) in rows.items():
        r = results[name]
        launches = (path_counts["bands"][kernel] if name in FEATURE_ROWS
                    else sum(c[k] for c in path_counts.values()
                             for k in AE_INSTANTIATIONS.get(kernel, (kernel,))))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    report = {
        "card": card, "build_s": build_s, "phase_s": seconds, "kernels": kernels,
        "kernel_shapes": {k: results[k]["shape"] for k in rows},
        "kernel_details": {k: results[k] for k in rows},
        "bands_kernels": results["bands_kernels"], "bands": bands, "spatial": spatial,
        "spatial_2d": spatial_2d, "env_mesh": env_mesh, "multiprocess": multiprocess,
        "surfaces": surfaces,
        "head_tiles": results["head_tiles"], "spatial_heads": results["spatial_heads"],
        "launches": path_counts,
        "e2e": e2e, "submission": submission, "server": server, "io": io, "policy": policy,
        "policy_parity": policy_parity, "enc3_policy": enc3_policy,
        "run_actions_max_abs_diff": parity_diff,
        "train": train, "train_parity_max_rel_diff": train_parity_diff,
        "routes": routes, "wrappers": wrappers, "packed": packed, "engines": engines,
        "dropout": results["dropout"], "ae_loss_src_not_obs": results["ae_loss_src_not_obs"],
        "ae2d": ae2d, "ae_launches": ae_launches, "enc3_occupancy": enc3_occupancy,
        "dec2_occupancy": dec2_occupancy, "tail2_occupancy": tail2_occupancy,
        "profile": profile, "profile_train": profile_train, "profile_packed": profile_packed,
        "total_s": time.perf_counter() - t_start,
    }
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    log(json.dumps({k: report[k] for k in ("launches", "e2e", "submission", "server",
                                           "io", "policy", "policy_parity", "train", "routes",
                                           "wrappers", "packed", "engines", "total_s")}))
    log(json.dumps({"bands": {k: v for k, v in bands.items() if not k.startswith("profile")},
                    "bands_kernels": results["bands_kernels"]}))
    log(json.dumps({"spatial_2d": spatial_2d}))
    log(json.dumps({"env_mesh": {k: v for k, v in env_mesh.items() if k != "profiles"}}))
    log(json.dumps({"multiprocess": {k: v for k, v in multiprocess.items()
                                     if k not in ("children", "one_controller")}}))
    log(json.dumps({"surfaces": surfaces}))
    log(json.dumps({"spatial": {k: v for k, v in spatial.items() if not k.startswith("profile")},
                    "spatial_kernels": {k: results[k] for k in SPATIAL_ROWS},
                    "spatial_heads": {k: {m: v for m, v in r.items() if m != "ties_drop"}
                                      for k, r in results["spatial_heads"].items()},
                    "head_tiles": results["head_tiles"], "build_s": build_s,
                    "phase_s": seconds}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
