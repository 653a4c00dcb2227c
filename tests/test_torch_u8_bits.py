"""PERF.md row 12 redesigned for the H100: the uint8 engine
(``cuda_ca.ca_multi_step``) run on packed bits in one launch
(``ca_bits_launch`` in csrc/ca_multi_step.cu, counted as
``ca_multi_step_bits``: the cells packed by warp ballots on the load, the
generations in registers by csrc/bit_regs.cuh, unpacked by lane shuffles on
the store), its body built for the host (the ``emulated`` fixture of
tests/test_torch_emulated.py; a block's threads run as host threads,
barriers, ballots and lane shuffles included).

Held bit for bit against the plain twin ``ops/ca.py::ca_multi_step``, the
present kernel's emulated build (``_ca_multi_step_kernel``, which
``cuda_ca.CA_MULTI_BITS = False`` forces on the card) and the JAX package's
``ca_multi_step_pallas`` in Pallas interpret mode: K in {0, 1, 5}, the
route's plan and each register plan forced, widths of 32, 64 and 256 cells,
one and two rows, universe counts that leave a warp or a block partly empty,
Life as a scalar, a per-universe vector of the battery's rulesets and a B0
rule.  Then the launch counts and the planner's choices at the engines' and
the spatial phase's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from carle_tpu.ops.pallas_ca import ca_multi_step_pallas

from carle_tpu_torch import rules
from carle_tpu_torch.ops import cuda_ca
from test_torch_emulated import RULESETS, emulated  # noqa: F401  (the fixture)

B0 = rules.pack_rule_bits([0, 3], [2, 3])   # births on an empty neighbourhood
SHAPES = [(3, 32, 64), (2, 1, 32), (3, 2, 256), (5, 8, 256), (70, 16, 32)]


def _grid(seed, n, h, w, p=0.4):
    return torch.from_numpy((np.random.RandomState(seed).rand(n, h, w) < p).astype(np.uint8))


def _rule(kind, n):
    if kind == "life":
        return torch.tensor(rules.LIFE, dtype=torch.int32)
    if kind == "b0":
        return torch.tensor(B0, dtype=torch.int32)
    return torch.tensor([rules.pack_rule_bits(*RULESETS[i % len(RULESETS)]) for i in range(n)],
                        dtype=torch.int32)


def _forced_plans(n, h, w):
    """Each instantiation (CA_BITS_PLANS) that covers the shape."""
    plans = []
    for v, r in cuda_ca.BITS_PLANS:
        per = h // r if h % r == 0 else 0
        if 32 * v == w and per and cuda_ca.bits_threads(n, per):
            plans.append(("regs", v, r, cuda_ca.bits_threads(n, per)))
    return plans


@pytest.mark.parametrize("rule", ["life", "battery", "b0"])
@pytest.mark.parametrize("steps", [0, 1, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_u8_bits_kernel_emulated(emulated, shape, steps, rule):
    """Row 12's kernel against the twin and the present kernel, bit for bit,
    by the route's plan and by every plan the shape takes."""
    n, h, w = shape
    grid = _grid(h * w + n + steps, n, h, w)
    bits = _rule(rule, n)
    want = cuda_ca.ca_multi_step_plain(grid, bits, steps)
    assert torch.equal(cuda_ca._ca_multi_step_kernel(grid, bits, steps), want)
    plans = _forced_plans(n, h, w)
    assert plans, shape
    if steps > 1:
        assert cuda_ca.bits_plan(n, h, w, steps) in plans
    for plan in [None] * (steps > 1) + plans:
        got = cuda_ca._ca_multi_bits_kernel(grid, bits, steps, plan)
        assert torch.equal(got, want), plan


def test_u8_bits_b0_flips_an_empty_torus(emulated):
    """B0 as data: an empty torus becomes all ones, then all zeros again,
    and the bytes written are 0 and 1 only."""
    empty = torch.zeros((3, 8, 64), dtype=torch.uint8)
    b0 = _rule("b0", 3)
    for plan in (("regs", 2, 4, 32), ("regs", 2, 1, 32)):
        ones = cuda_ca._ca_multi_bits_kernel(empty, b0, 1, plan)
        assert bool((ones == 1).all())
        two = cuda_ca._ca_multi_bits_kernel(empty, b0, 2, plan)
        assert not bool(two.any())


def test_u8_bits_launch_counts_emulated(emulated):
    """One launch a call of K >= 1 generations, none for K = 0 (a copy);
    the present kernel's count does not move."""
    grid = _grid(1, 3, 32, 64)
    present = cuda_ca.KERNEL_MULTI.launches
    for steps, launches in ((5, 1), (1, 1), (0, 0), (9, 1)):
        before = cuda_ca.KERNEL_BITS.launches
        plan = None if steps > 1 else ("regs", 2, 4, 32)   # the route takes K > 1
        got = cuda_ca._ca_multi_bits_kernel(grid, rules.MORLEY, steps, plan)
        assert cuda_ca.KERNEL_BITS.launches == before + launches
        assert torch.equal(got, cuda_ca.ca_multi_step_plain(grid, rules.MORLEY, steps))
    assert cuda_ca.KERNEL_MULTI.launches == present


def test_u8_bits_raises_where_no_plan_holds(emulated):
    """A width that is not whole words and a plan for another width raise
    (the route leaves those shapes to the present kernel)."""
    with pytest.raises(ValueError, match="register plan"):
        cuda_ca._ca_multi_bits_kernel(_grid(0, 2, 8, 48), rules.LIFE, 5)
    with pytest.raises(ValueError, match="does not cover"):
        cuda_ca._ca_multi_bits_kernel(_grid(0, 2, 8, 64), rules.LIFE, 5, ("regs", 1, 4, 32))


@pytest.mark.parametrize("rule", ["life", "battery", "b0"])
def test_u8_bits_matches_pallas_interpret(emulated, rule):
    """Against ca_multi_step_pallas in interpret mode, exactly, by the
    route's plan and a forced one-row plan."""
    n, h, w = 4, 32, 64
    grid = _grid(17, n, h, w)
    bits = _rule(rule, n)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ca_multi_step_pallas(jnp.asarray(grid.numpy()),
                                               jnp.asarray(bits.numpy()), jnp.asarray(6)))
    for plan in (None, ("regs", 2, 1, 128)):
        got = cuda_ca._ca_multi_bits_kernel(grid, bits, 6, plan)
        np.testing.assert_array_equal(got.numpy(), want)


def test_u8_bits_plan_at_the_main_paths():
    """The planner: the engines' 4096 x 256², 128 generations held in
    registers, 4 rows a thread, 256 threads (the packed engine's plan with
    the rule as data); one generation, widths not a multiple of 32 and the
    spatial phase's whole universe of 8192² keep the present kernel; its
    ragged case (2 x 256 x 128, 7 generations) takes the registers."""
    plan = cuda_ca.bits_plan
    assert plan(4096, 256, 256, 128) == ("regs", 8, 4, 256)
    assert plan(4096, 256, 256, 1) is None
    assert plan(1, 8192, 8192, 8) is None
    assert plan(1, 8192, 8192, 1) is None
    assert plan(2, 256, 128, 7) == ("regs", 4, 4, 128)
    assert plan(2, 256, 100, 7) is None
    assert plan(160, 512, 512, 64) is None
    assert cuda_ca.CA_MULTI_BITS
