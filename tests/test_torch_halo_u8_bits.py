"""PERF.md row 13 redesigned for the H100: the uint8 halo burst on packed
bits with temporal blocking (``u8_halo_bits_launch`` in csrc/halo_step.cu,
counted as ``spatial_multi_step_bits``), its body built for the host (the
``emulated`` fixture of tests/test_torch_emulated.py: a block's threads run
as host threads, barriers, ballots and shuffles included).

Held bit for bit against the plain twin (``spatial_multi_step_plain``), the
present kernel's emulated build (``halo_u8_kernel``, a generation a launch),
the JAX package's ``spatial_multi_step_pallas(..., interpret=True)`` and
``carle_tpu.parallel.spatial.spatial_multi_step`` on the 8-device CPU mesh:
K in {2, 5, 9} (9 > T: two chunks, the last shorter), 1, 2 and 8 slots (one
slot its own ring neighbour), widths of 32, 64 and 256 cells, a slot shorter
than T, a band cut short by the slot's last row, Life as a scalar, the
battery's five rulesets as a per-universe vector and a B0 rule on an empty
torus.  Then the route and the planner at the spatial path's shape.  Inputs
from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from carle_tpu.parallel import pallas_halo as jhalo
from carle_tpu.parallel import spatial as jspatial

from carle_tpu_torch import rules
from carle_tpu_torch.parallel import cuda_halo
from carle_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_rows
from test_torch_emulated import RULESETS, emulated  # noqa: F401  (the fixture)

B0 = rules.pack_rule_bits([0, 3], [2, 3])   # births on an empty neighbourhood
VEC = [rules.pack_rule_bits(*r) for r in RULESETS]


def _grid(seed, shape, p=0.35):
    return torch.from_numpy((np.random.RandomState(seed).rand(*shape) < p).astype(np.uint8))


def _shards(grid, slots):
    return shard_rows(grid, make_mesh([torch.device("cpu")] * slots, "space"))


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parts, b.parts))


def _present(x, rule, steps):
    return cuda_halo._launch(cuda_halo.KERNEL_MULTI, x, rule, steps, cuda_halo.KIND_U8)


@pytest.mark.parametrize("steps", [2, 5, 9])
@pytest.mark.parametrize("slots", [1, 2, 8])
def test_u8_bits_match_twin_and_present(emulated, slots, steps):
    """The route's kernel, one launch a chunk, against the twin and the
    present kernel; Life as a scalar and the five rulesets a universe."""
    grid = _grid(10 * slots + steps, (5, 64, 64))
    x = _shards(grid, slots)
    for rule in (torch.tensor(rules.LIFE, dtype=torch.int32),
                 torch.tensor(VEC, dtype=torch.int32)):
        twin = cuda_halo.spatial_multi_step_plain(x, rule, steps)
        new, old = cuda_halo.KERNEL_U8_BITS.launches, cuda_halo.KERNEL_MULTI.launches
        got = cuda_halo._u8_multi(x, rule, steps)
        assert cuda_halo.KERNEL_U8_BITS.launches == new + -(-steps // 8)
        assert cuda_halo.KERNEL_MULTI.launches == old
        assert _same(got, twin)
        assert _same(got, _present(x, rule, steps))


@pytest.mark.parametrize("width", [32, 256])
def test_u8_bits_widths_and_forced_plans(emulated, width):
    """One word a row (V = 1) and eight (V = 4), by the planner's plan and by
    plans of short bands (the slot's last band cut short) and T = 2."""
    grid = _grid(width, (3, 48, width))
    x = _shards(grid, 2)
    rule = torch.tensor(VEC[:3], dtype=torch.int32)
    twin = cuda_halo.spatial_multi_step_plain(x, rule, 7)
    v = 4 if width // 32 % 4 == 0 else 1
    for plan in (cuda_halo.u8_halo_plan(24, width, 7), (8, v, 5, 1, 32), (2, v, 7, 2, 64)):
        assert _same(cuda_halo._launch_u8_bits(x, rule, 7, plan), twin), plan


def test_u8_bits_slot_shorter_than_t(emulated):
    """Slots of 3 rows: T shrinks to 3, the ghost rows reach the far edge of
    each ring neighbour."""
    grid = _grid(3, (2, 24, 64))
    x = _shards(grid, 8)
    plan = cuda_halo.u8_halo_plan(3, 64, 9)
    assert plan[0] == 3 and plan[2] == 3
    twin = cuda_halo.spatial_multi_step_plain(x, rules.LIFE, 9)
    assert _same(cuda_halo._launch_u8_bits(x, rules.LIFE, 9, plan), twin)
    assert _same(cuda_halo._launch_u8_bits(x, rules.LIFE, 9, (2, 1, 2, 1, 32)), twin)


def test_u8_bits_b0_rule_fills_an_empty_torus(emulated):
    """B0: an empty universe is born whole in the first generation, and from
    then on the rule's survivals decide; cells other than 0 and 1 pack as
    alive."""
    empty = torch.zeros((2, 32, 64), dtype=torch.uint8)
    x = _shards(empty, 2)
    for steps in (2, 3, 9):
        got = cuda_halo._u8_multi(x, B0, steps)
        assert _same(got, cuda_halo.spatial_multi_step_plain(x, B0, steps))
        assert _same(got, _present(x, B0, steps))
    one = cuda_halo._u8_multi(x, B0, 2)   # born full, then every cell has 8 neighbours
    assert int(gather_rows(one).sum()) == 0
    wide = _grid(8, (1, 32, 64)) * 7          # cells of 7: alive as the twin's 1
    got = cuda_halo._u8_multi(_shards(wide, 2), rules.LIFE, 4)
    want = cuda_halo.spatial_multi_step_plain(_shards((wide != 0).to(torch.uint8), 2),
                                              rules.LIFE, 4)
    assert _same(got, want)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")
def test_u8_bits_match_jax(emulated):
    """Against spatial_multi_step_pallas in interpret mode and the ppermute
    path of carle_tpu.parallel.spatial on the JAX 8-device CPU mesh: 8 slots
    of 8 rows, 9 generations (two chunks), Life and a rule a universe."""
    grid = _grid(6, (2, 64, 128), 0.3)
    jmesh = JMesh(np.array(jax.devices()[:8]), ("space",))
    x = _shards(grid, 8)
    want = np.asarray(jhalo.spatial_multi_step_pallas(
        jnp.asarray(grid.numpy()), rules.LIFE, 9, jmesh, interpret=True))
    np.testing.assert_array_equal(gather_rows(cuda_halo._u8_multi(x, rules.LIFE, 9)).numpy(),
                                  want)
    vec = np.asarray([VEC[1], B0], np.int32)
    want = np.asarray(jspatial.spatial_multi_step(jnp.asarray(grid.numpy()), jnp.asarray(vec), 9,
                                                  jmesh))
    got = cuda_halo._u8_multi(x, torch.from_numpy(vec), 9)
    np.testing.assert_array_equal(gather_rows(got).numpy(), want)


def test_u8_halo_route_and_plan():
    """The planner at the spatial path's shape (u8 [1, 8192, 8192] over 4
    slots: T = 8, bands of 64 rows, 512 threads, two packed copies of 80
    rows of 1 KB in shared memory), and the shapes that keep the present
    kernel: one generation, a width not a multiple of 32, an unaligned
    buffer, rows too wide for a band."""
    t, v, rows, strip, threads = cuda_halo.u8_halo_plan(2048, 8192, 8)
    assert (t, rows, threads) == (8, 64, 512) and v == 4
    assert 2 * (rows + 2 * t) * 8192 // 8 <= cuda_halo.HALO_SMEM_BYTES
    assert cuda_halo.u8_halo_plan(2048, 8192, 1) is None
    assert cuda_halo.u8_halo_plan(64, 100, 8) is None
    assert cuda_halo.u8_halo_plan(64, 96, 8, aligned=False) is None
    assert cuda_halo.u8_halo_plan(2048, 32 * 8192, 8) is None
    assert cuda_halo.u8_halo_plan(5, 64, 9)[:3] == (5, 1, 5)
    assert cuda_halo.HALO_U8_BITS


def test_u8_halo_flag_forces_the_present_kernel(emulated, monkeypatch):
    """HALO_U8_BITS = False and a width the packed route does not take
    launch the present kernel, a generation a launch, with the same bits."""
    grid = _grid(2, (2, 32, 96))
    x = _shards(grid, 2)
    new = cuda_halo.KERNEL_U8_BITS.launches
    monkeypatch.setattr(cuda_halo, "HALO_U8_BITS", False)
    old = cuda_halo.KERNEL_MULTI.launches
    got = cuda_halo._u8_multi(x, rules.LIFE, 4)
    assert cuda_halo.KERNEL_MULTI.launches == old + 4
    monkeypatch.setattr(cuda_halo, "HALO_U8_BITS", True)
    assert _same(got, cuda_halo._u8_multi(x, rules.LIFE, 4))
    assert cuda_halo.KERNEL_U8_BITS.launches == new + 1
    odd = _shards(_grid(3, (1, 16, 36)), 2)
    old = cuda_halo.KERNEL_MULTI.launches
    assert _same(cuda_halo._u8_multi(odd, rules.LIFE, 3),
                 cuda_halo.spatial_multi_step_plain(odd, rules.LIFE, 3))
    assert cuda_halo.KERNEL_MULTI.launches == old + 3
