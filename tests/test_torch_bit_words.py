"""PERF.md rows 2 and 15 redesigned for the H100: the packed engine with the
rule as data (``bit_words_launch`` in csrc/bit_multi_step.cu) and the packed
halo kernel (``bit_halo_words_launch`` in csrc/halo_step.cu), their bodies
built for the host (the ``emulated`` fixture of tests/test_torch_emulated.py;
the register-resident kernel's blocks run as host threads, barriers and lane
shuffles included).

Held bit for bit against the plain twins, the present kernels' emulated
builds (``cuda_bitpack.BIT_WORDS`` / ``cuda_halo.BIT_HALO_BLOCKS`` off), the
JAX package's ``bit_multi_step_pallas`` in Pallas interpret mode and
``bit_spatial_multi_step_pallas(..., interpret=True)`` on the 8-device CPU
mesh: K in {0, 1, 5}, each regime's plans forced, the torus's edge shapes
(a universe one word wide, one and two rows, one-row slots, one, two, four
and eight slots), scalar and per-universe rules over five rulesets and a B0
rule, the fixed-rule halo build.  The cluster split (CL = 16) runs only on the
card (tests/test_torch_kernels.py, chip_smoke.py); its size-1 instance runs
here.  Then the planners' choices at the main paths' shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh as JMesh

from carle_tpu.ops.pallas_bitpack import bit_multi_step_pallas
from carle_tpu.parallel import pallas_halo as jhalo

from carle_tpu_torch import rules
from carle_tpu_torch.ops import bitpack, cuda_bitpack
from carle_tpu_torch.parallel import cuda_halo
from carle_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_rows
from test_torch_emulated import RULESETS, emulated  # noqa: F401  (the fixture)

B0 = rules.pack_rule_bits([0, 3], [2, 3])   # births on an empty neighbourhood
MASKS = [rules.pack_rule_bits(*r) for r in RULESETS] + [B0]
H100_SMS = 132


def _words(seed, n, h, nw, p=0.4):
    cells = (np.random.RandomState(seed).rand(n, h, 32 * nw) < p).astype(np.uint8)
    return bitpack.pack_grid(torch.from_numpy(cells))


def _rules(n):
    return [torch.tensor(m, dtype=torch.int32) for m in (MASKS[2], B0)] + [
        torch.tensor([MASKS[i % len(MASKS)] for i in range(n)], dtype=torch.int32)]


def _present(words, rule, steps):
    return cuda_bitpack._data_rule(cuda_bitpack.KERNEL, words, rule, steps, False, "")


def _forced_plans(n, h, nw, steps):
    """Every plan the shape takes: the streaming kernel at each V and a few
    strips, and (K > 1) each register-resident instantiation with CL = 1."""
    plans = [("stream", v, s, t) for v in (1, 4) if nw % v == 0
             for s, t in ((1, 64), (3, 32), (8, 256))]
    if steps > 1:
        for v, l, r, cl, g in cuda_bitpack.REGS_PLANS:
            per = h // r * l
            if (cl == 1 and v * l == nw and h % r == 0 and per <= 256 and h // r >= g
                    and (l == 1 or per % 32 == 0)):
                plans.append(("regs", v, l, r, cl, g, per * min(n, 256 // per)))
    return plans


@pytest.mark.parametrize("steps", [0, 1, 5])
@pytest.mark.parametrize("shape", [(3, 64, 8), (2, 32, 4), (5, 8, 2), (2, 5, 1), (3, 1, 8),
                                   (2, 2, 4), (2, 12, 12), (1, 40, 16)])
def test_bit_words_kernels_emulated(emulated, shape, steps):
    """Row 2's new kernels against the twin and the present kernel, bit for
    bit, by every plan the shape takes and by words_plan's own."""
    n, h, nw = shape
    words = _words(h * nw + n, n, h, nw)
    before = cuda_bitpack.KERNEL_WORDS.launches
    for rule in _rules(n):
        want = bitpack.bit_multi_step(words, rule, steps)
        assert torch.equal(_present(words, rule, steps), want)
        got = cuda_bitpack._words_kernel(words, rule, steps)
        assert torch.equal(got, want)
        for plan in _forced_plans(n, h, nw, steps):
            assert torch.equal(cuda_bitpack._words_kernel(words, rule, steps, plan), want), plan
    # K = 0 copies without a launch
    assert (cuda_bitpack.KERNEL_WORDS.launches == before) == (steps == 0)


def test_bit_words_b0_rule_flips_an_empty_torus(emulated):
    """B0 births on an empty neighbourhood: every word of an empty torus
    becomes all ones, then (survival needs 2 or 3) all zeros again."""
    empty = torch.zeros((2, 16, 8), dtype=torch.uint32)
    ones = cuda_bitpack._words_kernel(empty, B0, 1)
    assert bool((ones == 0xFFFFFFFF).all())
    for plan in (None, ("regs", 8, 1, 4, 1, 1, 8), ("regs", 2, 4, 1, 1, 2, 64)):
        two = cuda_bitpack._words_kernel(empty, B0, 2, plan)
        assert torch.equal(two, bitpack.bit_multi_step(empty, B0, 2))
        assert not bool(two.any())


def test_bit_words_launch_counts_emulated(emulated):
    """One launch a call held in registers or streamed once; K launches
    when the streaming kernel runs a generation a launch; the present
    kernel's count does not move."""
    words = _words(3, 2, 16, 8)
    present = cuda_bitpack.KERNEL.launches
    k = cuda_bitpack.KERNEL_WORDS
    for plan, steps, launches in ((("stream", 4, 2, 64), 1, 1), (("stream", 4, 2, 64), 5, 5),
                                  (("regs", 8, 1, 4, 1, 1, 8), 5, 1)):
        before = k.launches
        cuda_bitpack._words_kernel(words, rules.LIFE, steps, plan)
        assert k.launches == before + launches
    assert cuda_bitpack.KERNEL.launches == present


def test_bit_words_many_universes_emulated(emulated):
    """More than 65535 universes on the K = 1 path (the present fallback
    stops there): the streaming kernel folds universes into one grid axis."""
    n = 65537
    words = torch.from_numpy(np.random.RandomState(2).randint(
        0, 2 ** 32, size=(n, 2, 1), dtype=np.uint64).astype(np.uint32))
    rule = torch.tensor([MASKS[i % len(MASKS)] for i in range(n)], dtype=torch.int32)
    assert torch.equal(cuda_bitpack._words_kernel(words, rule, 1),
                       bitpack.bit_multi_step(words, rule, 1))


@pytest.mark.parametrize("per_instance", [False, True])
def test_bit_words_matches_pallas_interpret(emulated, per_instance):
    """The new kernels against bit_multi_step_pallas in interpret mode,
    exactly, by the default plan and the register-resident ones."""
    rng = np.random.RandomState(8)
    rule = (rng.randint(0, 1 << 18, size=4).astype(np.int32) if per_instance
            else np.int32(rules.MORLEY))
    words = _words(8, 4, 32, 4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bit_multi_step_pallas(jnp.asarray(words.numpy()), jnp.asarray(rule),
                                                jnp.asarray(6, jnp.int32)))
    r = torch.from_numpy(np.asarray(rule))
    for plan in (None, ("stream", 4, 3, 32), ("regs", 4, 1, 4, 1, 1, 32),
                 ("regs", 4, 1, 1, 1, 1, 128)):
        np.testing.assert_array_equal(cuda_bitpack._words_kernel(words, r, 6, plan).numpy(), want)


def _halo_plans(n, hl, nw, steps, slots):
    plans = [None]
    if steps >= 1:
        plans += [(1, v, 0, s, 32) for v in (1, 4) if nw % v == 0 for s in (1, 5)]
    for t in range(2, min(hl, steps, 3) + 1):
        plans += [(t, v, rows, strip, 64) for v in (1, 4) if nw % v == 0
                  for rows, strip in ((1, 1), (5, 2), (hl, 4))]
    return plans


@pytest.mark.parametrize("steps", [0, 1, 5])
@pytest.mark.parametrize("slots,hl", [(1, 16), (2, 8), (4, 1), (4, 3), (8, 2), (2, 1)])
def test_bit_halo_words_emulated(emulated, slots, hl, steps):
    """Row 15's new launcher on every slot of one device against the twin,
    the present kernel and the single-device engine, bit for bit: each plan
    the shape takes (T clamped to the slot's rows), scalar, B0 and
    per-universe rules, and the fixed-rule build."""
    n, nw = 3, 4
    words = _words(slots * 10 + hl + steps, n, slots * hl, nw)
    mesh = make_mesh([torch.device("cpu")] * slots, "space")
    x = shard_rows(words, mesh)
    for rule in _rules(n):
        want = bitpack.bit_multi_step(words, rule, steps)
        twin = cuda_halo.bit_spatial_multi_step_plain(x, rule, steps)
        present = cuda_halo._launch(cuda_halo.KERNEL_BIT, x, rule, steps, cuda_halo.KIND_U32)
        assert all(torch.equal(a, b) for a, b in zip(present.parts, twin.parts))
        for plan in _halo_plans(n, hl, nw, steps, slots):
            got = cuda_halo._launch_words(x, rule, steps, plan=plan)
            assert all(torch.equal(a, b) for a, b in zip(got.parts, twin.parts)), plan
            assert torch.equal(gather_rows(got), want)
    life = rules.pack_rule_bits([3], [2, 3])
    fixed = cuda_halo._launch_words(x, 0, steps, (f"STATIC_RULE={life:#07x}",))
    assert torch.equal(gather_rows(fixed), bitpack.bit_multi_step_static(words, [3], [2, 3], steps))


def test_bit_halo_words_launch_counts_emulated(emulated):
    """A launch a chunk of T generations (the last may be shorter), a
    generation a launch at T = 1; the present kernel's count does not move."""
    words = _words(5, 2, 4 * 8, 4)
    x = shard_rows(words, make_mesh([torch.device("cpu")] * 4, "space"))
    k, present = cuda_halo.KERNEL_BIT_WORDS, cuda_halo.KERNEL_BIT.launches
    for plan, steps, launches in (((3, 4, 8, 2, 64), 7, 3), ((1, 4, 0, 2, 64), 3, 3),
                                  (None, 1, 1)):
        before = k.launches
        got = cuda_halo._launch_words(x, rules.LIFE, steps, plan=plan)
        assert k.launches == before + launches
        assert torch.equal(gather_rows(got), bitpack.bit_multi_step(words, rules.LIFE, steps))
    got = cuda_halo.bit_spatial_multi_step_cuda(x, rules.LIFE, 4)   # the route: the new kernel
    assert torch.equal(gather_rows(got), bitpack.bit_multi_step(words, rules.LIFE, 4))
    assert cuda_halo.KERNEL_BIT.launches == present


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")
def test_bit_halo_words_matches_pallas_interpret(emulated):
    """Against bit_spatial_multi_step_pallas in interpret mode on the JAX
    8-device CPU mesh, exactly: 8 slots of 8 rows, 5 generations, by the
    default plan and forced T = 2 and 3."""
    words = _words(13, 2, 64, 4)
    rule = rules.pack_rule_bits([3, 6, 8], [2, 4, 5])
    jmesh = JMesh(np.array(jax.devices()[:8]), ("space",))
    want = np.asarray(jhalo.bit_spatial_multi_step_pallas(
        jnp.asarray(words.numpy()), rule, 5, jmesh, interpret=True))
    x = shard_rows(words, make_mesh([torch.device("cpu")] * 8, "space"))
    for plan in (None, (2, 4, 8, 2, 64), (3, 1, 3, 1, 32)):
        got = cuda_halo._launch_words(x, rule, 5, plan=plan)
        np.testing.assert_array_equal(gather_rows(got).numpy(), want)


def test_words_plan_at_the_main_paths():
    """The planner on an H100's 132 multiprocessors, at the shapes the main
    paths launch: the packed carry and stack and the bands stream one
    generation; the engines keep universes in registers; /rollout splits its
    universe over a cluster of 16; the routes take the new kernels."""
    plan = cuda_bitpack.words_plan
    assert plan(64, 256, 8, 1, H100_SMS)[:2] == ("stream", 4)
    assert plan(160, 256, 8, 1, H100_SMS)[:2] == ("stream", 4)
    assert plan(1, 8192, 256, 1, H100_SMS)[:2] == ("stream", 4)
    assert plan(4096, 256, 8, 128, H100_SMS) == ("regs", 8, 1, 4, 1, 1, 256)
    v, l, r, cl, g = cuda_bitpack.CLUSTER_PLAN
    assert plan(1, 256, 8, 256, H100_SMS) == ("regs", v, l, r, cl, g, 256 // cl // r * l)
    assert cl > 1 and (v, l, r, 1, g) in cuda_bitpack.REGS_PLANS   # its size-1 twin runs here
    assert plan(1, 8192, 256, 4, H100_SMS)[0] == "stream"       # too large for shared memory
    assert plan(2, 512, 16, 4, H100_SMS) is None                 # the present resident kernel
    assert plan(64, 256, 8, 1, H100_SMS, aligned=False)[1] == 1  # words not 16-byte aligned
    for n, h, nw, steps in ((64, 256, 8, 1), (160, 256, 8, 1), (1, 8192, 256, 1),
                            (4096, 256, 8, 128), (1, 256, 8, 256)):
        p = plan(n, h, nw, steps, H100_SMS)
        if p[0] == "stream":
            _, v, s, threads = p
            assert nw % v == 0 and 1 <= s <= cuda_bitpack.STREAM_MAX_STRIP
            assert threads == cuda_bitpack.STREAM_THREADS
            assert n * (nw // v) * -(-h // s) >= H100_SMS * 64   # the grid covers the card
    # the halo planner at 8192² over 4 slots: one generation streams; a
    # burst of 64 runs in 8 chunks of T = 8 on bands of 64 rows (the plan
    # measured best there)
    t, v, rows, strip, threads = cuda_halo.halo_plan(1, 2048, 256, 1, 4, H100_SMS)
    assert (t, rows) == (1, 0)
    t, v, rows, strip, threads = cuda_halo.halo_plan(1, 2048, 256, 64, 4, H100_SMS)
    assert (t, v, rows, threads) == (8, 4, 64, 512) and -(-64 // t) == 8
    assert 2 * (rows + 2 * t) * 256 * 4 <= cuda_halo.HALO_SMEM_BYTES
    assert cuda_halo.halo_plan(1, 1, 8, 5, 4, H100_SMS)[0] == 1   # one-row slots: T = 1
    assert cuda_halo.halo_plan(2, 3, 8, 64, 2, H100_SMS)[:3] == (3, 4, 3)  # T <= HL
    assert cuda_halo.halo_plan(1, 2048, 1024, 64, 4, H100_SMS)[:3] == (8, 4, 8)  # fewer rows fit
    assert cuda_halo.halo_plan(1, 2048, 8192, 64, 4, H100_SMS)[0] == 1  # none fit: streamed
    assert cuda_bitpack.BIT_WORDS and cuda_halo.BIT_HALO_BLOCKS
