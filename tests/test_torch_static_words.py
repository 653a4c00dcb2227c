"""PERF.md row 10 redesigned for the H100: the fixed-rule packed engine
(``bit_multi_step_static``) on the kernels of row 2, the rule folded at
compile time (``bit_static_words_launch`` in csrc/bit_multi_step.cu built
with ``-DSTATIC_RULE=<mask>``), their bodies built for the host (the
``emulated`` fixture of tests/test_torch_emulated.py; the register-resident
kernel's blocks run as host threads, barriers and lane shuffles included).

Held bit for bit against the plain twin ``bitpack.bit_multi_step_static``,
the present kernel's emulated build (``cuda_bitpack.BIT_WORDS`` off) and the
JAX package's ``bit_multi_step_pallas_static`` in Pallas interpret mode: K in
{0, 1, 5}, each regime's plans forced (the streaming kernel at each width of
words and a few strips, every register-resident instantiation with whole
universes a block), the torus's edge shapes (a universe one word wide, one
and two rows), Life, the other rulesets of the battery and a B0 rule, each a
compile-time mask.  Then the launch counts and the planner's choices at the
engines' and the spatial phase's shapes.  The cluster split runs only on the
card (tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from carle_tpu.ops.pallas_bitpack import bit_multi_step_pallas_static

from carle_tpu_torch.ops import bitpack, cuda_bitpack
from test_torch_emulated import RULESETS, emulated  # noqa: F401  (the fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B0 = ([0, 3], [2, 3])   # births on an empty neighbourhood
FIXED = list(RULESETS) + [B0]
H100_SMS = 132


def _words(seed, n, h, nw, p=0.4):
    cells = (np.random.RandomState(seed).rand(n, h, 32 * nw) < p).astype(np.uint8)
    return bitpack.pack_grid(torch.from_numpy(cells))


def _present(words, rule, steps):
    return cuda_bitpack._static_rule(cuda_bitpack.KERNEL_STATIC, words, *rule, steps, False, "")


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


@pytest.mark.parametrize("rule", range(len(FIXED)))
@pytest.mark.parametrize("steps", [0, 1, 5])
@pytest.mark.parametrize("shape", [(3, 64, 8), (2, 32, 4), (5, 8, 2), (2, 5, 1), (3, 1, 8),
                                   (2, 2, 4), (1, 16, 1)])
def test_static_words_kernels_emulated(emulated, shape, steps, rule):
    """Row 10's kernels against the twin and the present kernel, bit for
    bit, by every plan the shape takes and by words_plan's own (the route)."""
    n, h, nw = shape
    birth, survive = FIXED[rule]
    words = _words(h * nw + n + rule, n, h, nw)
    want = bitpack.bit_multi_step_static(words, birth, survive, steps)
    assert torch.equal(_present(words, (birth, survive), steps), want)
    before = cuda_bitpack.KERNEL_STATIC_WORDS.launches
    got = cuda_bitpack._words_kernel(words, None, steps, None, (birth, survive))
    assert torch.equal(got, want)
    assert (cuda_bitpack.KERNEL_STATIC_WORDS.launches == before) == (steps == 0)
    for plan in _forced_plans(n, h, nw, steps):
        assert torch.equal(cuda_bitpack._words_kernel(words, None, steps, plan,
                                                      (birth, survive)), want), plan


def test_static_words_b0_flips_an_empty_torus(emulated):
    """B0 fixed: every word of an empty torus becomes all ones, then all
    zeros again, by the streaming kernel and in registers."""
    empty = torch.zeros((2, 16, 8), dtype=torch.uint32)
    ones = cuda_bitpack._words_kernel(empty, None, 1, None, B0)
    assert bool((ones == 0xFFFFFFFF).all())
    for plan in (None, ("regs", 8, 1, 4, 1, 1, 8), ("regs", 8, 1, 8, 1, 1, 4)):
        two = cuda_bitpack._words_kernel(empty, None, 2, plan, B0)
        assert torch.equal(two, bitpack.bit_multi_step_static(empty, *B0, 2))
        assert not bool(two.any())


def test_static_words_launch_counts_emulated(emulated):
    """One launch a call held in registers or streamed once, K launches when
    the streaming kernel runs a generation a launch; neither the present
    fixed-rule kernel's count nor the data-rule launcher's moves."""
    words = _words(3, 2, 16, 8)
    k = cuda_bitpack.KERNEL_STATIC_WORDS
    others = (cuda_bitpack.KERNEL_STATIC.launches, cuda_bitpack.KERNEL_WORDS.launches)
    for plan, steps, launches in ((("stream", 4, 2, 64), 1, 1), (("stream", 4, 2, 64), 5, 5),
                                  (("regs", 8, 1, 4, 1, 1, 8), 5, 1),
                                  (("regs", 8, 1, 8, 1, 1, 4), 5, 1)):
        before = k.launches
        got = cuda_bitpack._words_kernel(words, None, steps, plan, RULESETS[0])
        assert k.launches == before + launches
        assert torch.equal(got, bitpack.bit_multi_step_static(words, *RULESETS[0], steps))
    assert (cuda_bitpack.KERNEL_STATIC.launches, cuda_bitpack.KERNEL_WORDS.launches) == others


@pytest.mark.parametrize("rule", [RULESETS[0], RULESETS[2], B0])
def test_static_words_matches_pallas_interpret(emulated, rule):
    """Against bit_multi_step_pallas_static in interpret mode, exactly, by
    the route's plan and forced register-resident and streaming plans."""
    birth, survive = rule
    words = _words(8, 4, 32, 4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bit_multi_step_pallas_static(
            jnp.asarray(words.numpy()), tuple(birth), tuple(survive), jnp.asarray(6, jnp.int32)))
    for plan in (None, ("stream", 4, 3, 32), ("regs", 4, 1, 4, 1, 1, 32),
                 ("regs", 4, 1, 1, 1, 1, 128)):
        got = cuda_bitpack._words_kernel(words, None, 6, plan, (birth, survive))
        np.testing.assert_array_equal(got.numpy(), want)


def test_static_words_plan_at_the_main_paths():
    """The planner with the rule fixed on an H100's 132 multiprocessors: the
    engines' universes stay in registers, whole universes a block; one
    generation streams; the spatial phase's whole universe of 8192² (one
    universe, 64 generations) streams a generation a launch; a universe the
    registers do not hold but shared memory does keeps the present kernel."""
    plan = cuda_bitpack.words_plan
    assert plan(4096, 256, 8, 128, H100_SMS, True, True) == ("regs", 8, 1, 8, 1, 1, 256)
    assert plan(4096, 256, 8, 128, H100_SMS) == ("regs", 8, 1, 4, 1, 1, 256)   # rule as data
    assert plan(4096, 252, 8, 128, H100_SMS, True, True)[3] == 4   # 8 rows do not divide
    assert plan(4096, 256, 4, 128, H100_SMS, True, True)[3] == 4   # no 8-row instantiation
    assert plan(4096, 256, 8, 1, H100_SMS, True, True)[:2] == ("stream", 4)
    assert plan(1, 8192, 256, 64, H100_SMS, True, True)[0] == "stream"
    assert plan(1, 8192, 256, 1, H100_SMS, True, True)[:2] == ("stream", 4)
    assert plan(2, 512, 16, 4, H100_SMS, True, True) is None
    v, l, r1, cl, g1 = cuda_bitpack.CLUSTER_PLAN
    assert plan(1, 256, 8, 256, H100_SMS, True, True) == ("regs", v, l, r1, cl, g1,
                                                          256 // cl // r1 * l)
    assert cuda_bitpack.BIT_WORDS
