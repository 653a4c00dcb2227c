"""PERF.md row 11a redesigned for the H100: the column-major fixed-rule
engine (``cuda_bitpack.bit_multi_step_static_cm``) with each universe held
in registers (``bit_static_cm_words_launch`` in csrc/bit_multi_step.cu built
with ``-DSTATIC_RULE=<mask>``, counted as
``bit_multi_step_static_cm_words``: a thread 8 columns x all H/32 word rows,
a universe at most a warp, the neighbour columns' planes by lane shuffles),
its body built for the host (the ``emulated`` fixture of
tests/test_torch_emulated.py; a block's threads run as host threads,
barriers and lane shuffles included).

Held bit for bit against the plain twin ``bitpack.bit_multi_step_static_cm``,
the present kernel's emulated build (``cuda_bitpack.BIT_WORDS`` off) and the
JAX package's ``bit_multi_step_pallas_static_cm`` in Pallas interpret mode:
H/32 in {1, 2, 8}, W in {32, 256}, K in {0, 1, 5}, the route's plan and
blocks of one warp and of 256 threads forced (a warp a universe at W = 256),
Life, the other rulesets of the battery and a B0 rule, each a compile-time
mask.  Then the launch counts and the planner's choices
at the engines' and the spatial phase's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from carle_tpu.ops.pallas_bitpack import bit_multi_step_pallas_static_cm

from carle_tpu_torch.ops import bitpack, cuda_bitpack
from test_torch_emulated import RULESETS, emulated  # noqa: F401  (the fixture)

B0 = ([0, 3], [2, 3])   # births on an empty neighbourhood
FIXED = list(RULESETS) + [B0]


def _words(seed, n, hw, w, p=0.4):
    cells = (np.random.RandomState(seed).rand(n, 32 * hw, w) < p).astype(np.uint8)
    return bitpack.pack_grid_cm(torch.from_numpy(cells))


def _present(words, rule, steps):
    return cuda_bitpack._static_rule(cuda_bitpack.KERNEL_STATIC_CM, words, *rule, steps, True, "")


def _forced_plans(n, hw, w):
    """The shape's plans: blocks of one warp and of 256 threads (the last
    block's spare universes computed and not stored)."""
    assert (hw,) in cuda_bitpack.CM_PLANS and w // cuda_bitpack.CM_COLUMNS <= 32
    return [("cm", hw, 32), ("cm", hw, 256)]


@pytest.mark.parametrize("rule", range(len(FIXED)))
@pytest.mark.parametrize("steps", [0, 1, 5])
@pytest.mark.parametrize("shape", [(3, 1, 32), (3, 2, 32), (3, 8, 32), (3, 1, 256),
                                   (2, 2, 256), (3, 8, 256)])
def test_static_cm_words_kernel_emulated(emulated, shape, steps, rule):
    """Row 11a's kernel against the twin and the present kernel, bit for
    bit, by the route's plan and by every plan the shape takes."""
    n, hw, w = shape
    birth, survive = FIXED[rule]
    words = _words(hw * w + n + rule, n, hw, w)
    want = bitpack.bit_multi_step_static_cm(words, birth, survive, steps)
    assert torch.equal(_present(words, (birth, survive), steps), want)
    plans = _forced_plans(n, hw, w)
    if steps:
        assert cuda_bitpack.cm_plan(n, hw, w, steps)[1] == hw
    for plan in [None] + plans:
        got = cuda_bitpack._cm_words_kernel(words, birth, survive, steps, plan)
        assert torch.equal(got, want), plan


def test_static_cm_words_several_blocks_emulated(emulated):
    """70 universes of 64 x 32 cells: 64 a block of 256 threads, the second
    block mostly spare; 8 a block of one warp, the last block partly spare."""
    words = _words(5, 70, 2, 32)
    want = bitpack.bit_multi_step_static_cm(words, *RULESETS[1], 7)
    for plan in (None, ("cm", 2, 256), ("cm", 2, 32)):
        assert torch.equal(cuda_bitpack._cm_words_kernel(words, *RULESETS[1], 7, plan), want)


def test_static_cm_words_b0_flips_an_empty_torus(emulated):
    """B0 fixed: every word of an empty torus becomes all ones, then all
    zeros again, by both block sizes."""
    empty = torch.zeros((2, 2, 256), dtype=torch.uint32)
    for plan in _forced_plans(2, 2, 256):
        ones = cuda_bitpack._cm_words_kernel(empty, *B0, 1, plan)
        assert bool((ones == 0xFFFFFFFF).all())
        assert not bool(cuda_bitpack._cm_words_kernel(empty, *B0, 2, plan).any())


def test_static_cm_words_launch_counts_emulated(emulated):
    """One launch a call of K >= 1 generations, none for K = 0 (a copy);
    neither the present column-major kernel's count nor the row-major
    fixed-rule launcher's moves."""
    words = _words(3, 3, 2, 256)
    k = cuda_bitpack.KERNEL_STATIC_CM_WORDS
    others = (cuda_bitpack.KERNEL_STATIC_CM.launches, cuda_bitpack.KERNEL_STATIC_WORDS.launches)
    for steps, launches in ((5, 1), (1, 1), (0, 0), (9, 1)):
        before = k.launches
        got = cuda_bitpack._cm_words_kernel(words, *RULESETS[0], steps)
        assert k.launches == before + launches
        assert torch.equal(got, bitpack.bit_multi_step_static_cm(words, *RULESETS[0], steps))
    assert (cuda_bitpack.KERNEL_STATIC_CM.launches,
            cuda_bitpack.KERNEL_STATIC_WORDS.launches) == others


def test_static_cm_words_raises_where_no_plan_holds(emulated):
    """A width whose lanes are no power of two, a universe wider than a warp,
    word rows no instantiation has, and a plan for other word rows raise (the
    route leaves those shapes to the present kernel)."""
    with pytest.raises(ValueError, match="register plan"):
        cuda_bitpack._cm_words_kernel(_words(0, 2, 2, 48), *RULESETS[0], 5)
    with pytest.raises(ValueError, match="register plan"):
        cuda_bitpack._cm_words_kernel(_words(0, 2, 1, 512), *RULESETS[0], 5)
    with pytest.raises(ValueError, match="register plan"):
        cuda_bitpack._cm_words_kernel(_words(0, 2, 3, 32), *RULESETS[0], 5)
    with pytest.raises(ValueError, match="word rows"):
        cuda_bitpack._cm_words_kernel(_words(0, 2, 2, 32), *RULESETS[0], 5, ("cm", 1, 32))


@pytest.mark.parametrize("rule", [RULESETS[0], RULESETS[2], B0])
def test_static_cm_words_matches_pallas_interpret(emulated, rule):
    """Against bit_multi_step_pallas_static_cm in interpret mode, exactly,
    by the route and both block sizes."""
    birth, survive = rule
    words = _words(8, 2, 2, 256)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bit_multi_step_pallas_static_cm(
            jnp.asarray(words.numpy()), tuple(birth), tuple(survive), jnp.asarray(6, jnp.int32)))
    for plan in [None] + _forced_plans(2, 2, 256):
        got = cuda_bitpack._cm_words_kernel(words, birth, survive, 6, plan)
        np.testing.assert_array_equal(got.numpy(), want)


def test_static_cm_words_plan_at_the_main_paths():
    """The planner on the engines' column-major universes (4096 x 256²,
    128 generations): 8 columns a thread, a warp a universe, 8 universes a
    block of 256 threads; one generation the same; a universe of 8192²
    (the spatial phase's size; 256 word rows), unaligned words, widths
    whose lanes are no power of two or more than a warp's, and K = 0 keep
    the present kernel."""
    plan = cuda_bitpack.cm_plan
    assert cuda_bitpack.CM_COLUMNS == 8
    assert plan(4096, 8, 256, 128) == ("cm", 8, 256)
    assert plan(4096, 8, 256, 1) == ("cm", 8, 256)
    assert plan(1, 256, 8192, 64) is None
    assert plan(1, 256, 8192, 1) is None
    assert plan(4096, 8, 256, 128, False) is None
    assert plan(4, 8, 96, 5) is None
    assert plan(4096, 8, 256, 0) is None
    assert plan(4, 8, 512, 5) is None
    assert plan(3, 1, 32, 5) == ("cm", 1, 32)
    assert plan(3, 16, 256, 5) is None
    assert cuda_bitpack.BIT_WORDS
