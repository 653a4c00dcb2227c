"""carle_tpu_torch vs carle_tpu: the last single-chip CA engines.

The plain twins of the fixed-rule packed engine (``bit_multi_step_static``),
the column-major packed engines (``bit_multi_step_static_cm``,
``bit_multi_step_cm``) and the uint8 multi-step engine (``ca_multi_step``)
against the JAX functions: the Pallas kernels in interpret mode (as
tests/test_bitpack.py and tests/test_pallas.py run them) and the XLA static
fold, at 2 x 64 x 128 with random rules, scalar and per instance, word for
word.  The wrappers take the twins for CPU tensors; the kernels are held
against the twins in tests/test_torch_emulated.py and, on the card,
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import torch

from carle_tpu.ops import bitpack as jbitpack
from carle_tpu.ops import pallas_bitpack as jpb
from carle_tpu.ops import pallas_ca as jpca

from carle_tpu_torch import rules
from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_ca


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPE = (2, 64, 128)


def _soup(seed, shape=SHAPE, density=0.4):
    return (np.random.RandomState(seed).rand(*shape) < density).astype(np.uint8)


def _random_rule(rng):
    birth = sorted(int(d) for d in np.flatnonzero(rng.rand(9) < 0.35))
    survive = sorted(int(d) for d in np.flatnonzero(rng.rand(9) < 0.35))
    return tuple(birth), tuple(survive)


def test_pack_grid_cm_matches_jax_word_for_word():
    for shape in [(2, 64, 128), (1, 32, 40), (3, 96, 32)]:
        grid = _soup(shape[1], shape)
        got = bitpack.pack_grid_cm(torch.from_numpy(grid))
        want = np.asarray(jbitpack.pack_grid_cm(jnp.asarray(grid)))
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(bitpack.unpack_grid_cm(got, shape[1]).numpy(), grid)
    with pytest.raises(ValueError, match="height"):
        bitpack.pack_grid_cm(torch.zeros((1, 40, 64), dtype=torch.uint8))


def test_popcount_counts_every_word():
    words = np.random.RandomState(0).randint(0, 2 ** 32, size=4096, dtype=np.uint64)
    got = bitpack.popcount(torch.from_numpy(words.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), [bin(int(w)).count("1") for w in words])


@pytest.mark.parametrize("seed", range(4))
def test_static_engine_matches_jax(seed):
    """Row 10: the fixed-rule fold against the Pallas kernel (interpret) and
    the XLA fold, random rules."""
    rng = np.random.RandomState(seed)
    birth, survive = ((3,), (2, 3)) if seed == 0 else _random_rule(rng)
    packed = np.array(jbitpack.pack_grid(jnp.asarray(_soup(seed))))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpb.bit_multi_step_pallas_static(
            jnp.asarray(packed), birth, survive, jnp.asarray(5, jnp.int32)))
    got = cuda_bitpack.bit_multi_step_static(torch.from_numpy(packed), birth, survive, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    xla = np.asarray(jbitpack.bit_ca_step_static(jnp.asarray(packed), birth, survive))
    np.testing.assert_array_equal(
        bitpack.bit_ca_step_static(torch.from_numpy(packed), birth, survive).numpy(), xla)
    # the fixed rule is the data rule's function
    data = bitpack.bit_multi_step(torch.from_numpy(packed),
                                  rules.pack_rule_bits(birth, survive), 5)
    assert torch.equal(got, data)


@pytest.mark.parametrize("seed", range(3))
def test_static_cm_engine_matches_jax(seed):
    """Row 11a: the column-major fixed-rule engine."""
    rng = np.random.RandomState(10 + seed)
    birth, survive = ((3,), (2, 3)) if seed == 0 else _random_rule(rng)
    cm = np.array(jbitpack.pack_grid_cm(jnp.asarray(_soup(20 + seed))))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpb.bit_multi_step_pallas_static_cm(
            jnp.asarray(cm), birth, survive, jnp.asarray(5, jnp.int32)))
    got = cuda_bitpack.bit_multi_step_static_cm(torch.from_numpy(cm), birth, survive, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_instance", [False, True])
def test_cm_engine_matches_jax(per_instance):
    """Row 11b: the column-major engine, the rule as data."""
    rng = np.random.RandomState(30 + per_instance)
    rule = (rng.randint(0, 1 << 18, size=2).astype(np.int32) if per_instance
            else np.int32(rng.randint(0, 1 << 18)))
    cm = np.array(jbitpack.pack_grid_cm(jnp.asarray(_soup(31))))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpb.bit_multi_step_pallas_cm(
            jnp.asarray(cm), jnp.asarray(rule), jnp.asarray(5, jnp.int32)))
    got = cuda_bitpack.bit_multi_step_cm(torch.from_numpy(cm), torch.from_numpy(np.asarray(rule)),
                                         5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_instance", [False, True])
def test_ca_multi_step_matches_jax(per_instance):
    """Row 12: K uint8 generations."""
    rng = np.random.RandomState(40 + per_instance)
    rule = (rng.randint(0, 1 << 18, size=2).astype(np.int32) if per_instance
            else np.int32(rules.DAY_AND_NIGHT))
    grid = _soup(41)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpca.ca_multi_step_pallas(
            jnp.asarray(grid), jnp.asarray(rule), jnp.asarray(5)))
    got = cuda_ca.ca_multi_step(torch.from_numpy(grid), torch.from_numpy(np.asarray(rule)), 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engines_agree_on_one_checksum():
    """bench.py's check: every engine on one grid gives one live-cell sum."""
    grid = torch.from_numpy(_soup(50, (2, 64, 64), 0.5))
    life = rules.LIFE
    sums = {
        int(bitpack.unpack_grid(bitpack.bit_multi_step(bitpack.pack_grid(grid), life, 16),
                                64).sum()),
        int(bitpack.unpack_grid(cuda_bitpack.bit_multi_step_static(
            bitpack.pack_grid(grid), [3], [2, 3], 16), 64).sum()),
        int(bitpack.unpack_grid_cm(cuda_bitpack.bit_multi_step_static_cm(
            bitpack.pack_grid_cm(grid), [3], [2, 3], 16), 64).sum()),
        int(bitpack.unpack_grid_cm(cuda_bitpack.bit_multi_step_cm(
            bitpack.pack_grid_cm(grid), life, 16), 64).sum()),
        int(cuda_ca.ca_multi_step(grid, life, 16).sum()),
    }
    assert len(sums) == 1 and sums.pop() > 0


def test_engine_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError, match="cpu or cuda"):
        cuda_bitpack.bit_multi_step_cm(torch.zeros((1, 2, 64), dtype=torch.uint32,
                                                   device="meta"), 0, 1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cuda_ca.ca_multi_step(torch.zeros((1, 8, 8), dtype=torch.uint8, device="meta"), 0, 1)
    assert cuda_bitpack.resident(256, 8, 1) and not cuda_bitpack.resident(1024, 32, 1)
