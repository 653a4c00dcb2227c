"""carle_tpu_torch vs carle_tpu: the bit-packed engine.

Packed words must equal the JAX package's, word for word, through the XLA
path (``ops.bitpack.bit_multi_step``) and ``bit_multi_step_pallas`` in
Pallas interpret mode (as tests/test_pallas.py runs it).  The kernel itself
is held against this plain path in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from carle_tpu import EnvConfig as JEnvConfig, rules as jrules
from carle_tpu.env import init_state as jinit_state, multi_step as jmulti_step
from carle_tpu.ops import bitpack as jbitpack
from carle_tpu.ops.pallas_bitpack import bit_multi_step_pallas

from carle_tpu_torch import EnvConfig, rules
from carle_tpu_torch.env import init_state, multi_step
from carle_tpu_torch.ops import bitpack, cuda_bitpack


def _soup(seed, shape, density=0.35):
    return (np.random.RandomState(seed).rand(*shape) < density).astype(np.uint8)


@pytest.mark.parametrize("shape", [(2, 8, 32), (3, 17, 96), (1, 64, 256)])
def test_pack_unpack_match_jax(shape):
    grid = _soup(1, shape)
    packed = bitpack.pack_grid(torch.from_numpy(grid))
    want = np.asarray(jbitpack.pack_grid(jnp.asarray(grid)))
    assert packed.dtype == torch.uint32
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(
        bitpack.unpack_grid(packed, shape[-1]).numpy(), grid)


RULES = [rules.LIFE, rules.DAY_AND_NIGHT, rules.LIVE_FREE_OR_DIE,
         (1 << 18) - 1, 0]


@pytest.mark.parametrize("rule", RULES)
def test_bit_multi_step_matches_jax_scalar_rule(rule):
    grid = _soup(rule % 97, (2, 32, 96))
    packed = np.array(jbitpack.pack_grid(jnp.asarray(grid)))
    want = jbitpack.bit_multi_step(jnp.asarray(packed), jnp.int32(rule), 7)
    got = bitpack.bit_multi_step(torch.from_numpy(packed), rule, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    via = cuda_bitpack.bit_multi_step(torch.from_numpy(packed), rule, 7)
    np.testing.assert_array_equal(via.numpy(), np.asarray(want))


def test_bit_multi_step_matches_jax_rule_vector():
    rng = np.random.RandomState(4)
    rule = rng.randint(0, 1 << 18, size=5).astype(np.int32)
    grid = _soup(4, (5, 24, 64))
    packed = np.array(jbitpack.pack_grid(jnp.asarray(grid)))
    want = jbitpack.bit_multi_step(jnp.asarray(packed), jnp.asarray(rule), 5)
    got = cuda_bitpack.bit_multi_step(torch.from_numpy(packed),
                                      torch.from_numpy(rule), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("per_instance", [False, True])
def test_bit_multi_step_matches_pallas_interpret(per_instance):
    rng = np.random.RandomState(8)
    rule = (rng.randint(0, 1 << 18, size=4).astype(np.int32) if per_instance
            else np.int32(jrules.MORLEY))
    grid = _soup(8, (4, 32, 128))
    packed = np.array(jbitpack.pack_grid(jnp.asarray(grid)))
    with pltpu.force_tpu_interpret_mode():
        want = bit_multi_step_pallas(jnp.asarray(packed), jnp.asarray(rule),
                                     jnp.asarray(6, jnp.int32))
    got = cuda_bitpack.bit_multi_step(torch.from_numpy(packed),
                                      torch.from_numpy(np.asarray(rule)), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw", [(32, 64), (20, 45)])  # packed and per-step paths
def test_env_multi_step_matches_jax(hw):
    h, w = hw
    cfg = EnvConfig(h, w, 8, 8, 3)
    jcfg = JEnvConfig(height=h, width=w, action_height=8, action_width=8,
                      instances=3)
    grid = _soup(2, cfg.grid_shape)
    st = init_state(cfg, rules.MORLEY, device="cpu")._replace(
        grid=torch.from_numpy(grid))
    jst = jinit_state(jcfg, jrules.MORLEY)._replace(grid=jnp.asarray(grid))
    st = multi_step(st, 9, cfg)
    jst = jmulti_step(jst, 9, config=jcfg)
    np.testing.assert_array_equal(st.grid.numpy(), np.asarray(jst.grid))
    assert int(st.step_num) == int(jst.step_num)


def test_resident_choice():
    assert cuda_bitpack.resident(256, 8)       # 16 KB
    assert cuda_bitpack.resident(512, 16)      # 64 KB
    assert not cuda_bitpack.resident(1024, 32)  # 256 KB: per-generation launches
