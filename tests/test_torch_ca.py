"""carle_tpu_torch vs carle_tpu: config, rules, RLE, the CA step and the env.

Inputs come from a numpy seed and go through the JAX function and the
port's function on the CPU; grids must be equal.  ``ca_step_pallas`` runs
in Pallas interpret mode, as tests/test_pallas.py runs it.  The kernel itself
is held against this plain path in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from carle_tpu import EnvConfig as JEnvConfig, rle as jrle, rules as jrules
from carle_tpu.env import env_step as jenv_step, init_state as jinit_state
from carle_tpu.ops import pallas_ca
from carle_tpu.ops.ca import ca_step_grid as jca_step_grid, pad_action as jpad_action

from carle_tpu_torch import EnvConfig, rle, rules
from carle_tpu_torch.env import env_step, init_state
from carle_tpu_torch.ops import cuda_ca

GEOMETRIES = [  # (H, W, AH, AW, instances)
    (64, 64, 16, 16, 2),
    (23, 37, 8, 9, 3),     # odd sizes: the window shrinks by one
    (24, 40, 7, 12, 2),    # non-square, odd window
    (32, 96, 32, 32, 1),
]


def _configs(h, w, ah, aw, n):
    return (EnvConfig(h, w, ah, aw, n),
            JEnvConfig(height=h, width=w, action_height=ah, action_width=aw,
                       instances=n))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_config_geometry_matches(geom):
    cfg, jcfg = _configs(*geom)
    for attr in ("eff_action_height", "eff_action_width", "action_row_offset",
                 "action_col_offset", "grid_shape", "action_shape"):
        assert getattr(cfg, attr) == getattr(jcfg, attr), attr
    assert cfg.validate() is cfg


def test_rule_masks_match():
    for name in ("LIFE", "MORLEY", "DAY_AND_NIGHT", "LIVE_FREE_OR_DIE"):
        assert getattr(rules, name) == getattr(jrules, name)
    for text in ("B3/S23", "b36/s23", "B3678/S34678", "x9B2a/S0", "B/S"):
        assert rules.parse_rulestring(text) == jrules.parse_rulestring(text)
        assert rules.rule_bits_from_string(text) == jrules.rule_bits_from_string(text)
    rng = np.random.RandomState(0)
    for bits in rng.randint(0, 1 << 18, size=20):
        assert rules.unpack_rule_bits(int(bits)) == jrules.unpack_rule_bits(int(bits))


@pytest.mark.parametrize("shape", [(16, 16), (23, 37), (5, 120)])
def test_rle_round_trip_matches(shape):
    rng = np.random.RandomState(sum(shape))
    grid = (rng.rand(*shape) < 0.3).astype(np.uint8)
    text = rle.encode_grid(grid, [3], [2, 3], exp_id="7", step=3)
    assert text == jrle.encode_grid(grid, [3], [2, 3], exp_id="7", step=3)
    back = rle.parse_rle_text(text)
    np.testing.assert_array_equal(back.grid, grid)
    np.testing.assert_array_equal(back.grid, jrle.parse_rle_text(text).grid)
    assert (back.birth, back.survive, back.torus) == ([3], [2, 3], shape)


def test_rle_pattern_files_decode_alike():
    import glob
    import os

    import carle_tpu

    paths = sorted(glob.glob(os.path.join(os.path.dirname(carle_tpu.__file__),
                                          "patterns", "*.rle")))
    assert paths
    for path in paths:
        ours, ref = rle.read_rle(path), jrle.read_rle(path)
        np.testing.assert_array_equal(ours.grid, ref.grid)
        assert (ours.birth, ours.survive) == (ref.birth, ref.survive)


def _random_case(seed, h, w, ah, aw, n, per_instance):
    rng = np.random.RandomState(seed)
    grid = (rng.rand(n, h, w) < 0.35).astype(np.uint8)
    action = (rng.rand(n, ah - h % 2, aw - w % 2) < 0.3).astype(np.uint8)
    if per_instance:
        rule = rng.randint(0, 1 << 18, size=n).astype(np.int32)
    else:
        rule = np.int32(rng.randint(0, 1 << 18))
    return grid, action, rule


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("per_instance", [False, True])
def test_ca_step_matches_jax(geom, per_instance):
    cfg, jcfg = _configs(*geom)
    for seed in range(3):
        grid, action, rule = _random_case(seed, *geom, per_instance)
        want = jca_step_grid(jnp.asarray(grid) ^ jpad_action(jnp.asarray(action), jcfg),
                             jnp.asarray(rule))
        got = cuda_ca.ca_step(torch.from_numpy(grid), torch.from_numpy(action),
                              torch.from_numpy(np.asarray(rule)), cfg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("geom,per_instance", [(GEOMETRIES[0], False),
                                               (GEOMETRIES[2], True)])
def test_ca_step_matches_pallas_interpret(geom, per_instance):
    cfg, jcfg = _configs(*geom)
    grid, action, rule = _random_case(11, *geom, per_instance)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_ca.ca_step_pallas(jnp.asarray(grid), jnp.asarray(action),
                                        jnp.asarray(rule), config=jcfg)
    got = cuda_ca.ca_step(torch.from_numpy(grid), torch.from_numpy(action),
                          torch.from_numpy(np.asarray(rule)), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _action_stream(kind, steps, shape, rng):
    if kind == "valued":  # any nonzero value toggles; never resets
        vals = np.array([0, 0, 0, 0.5, 2.0, -1.0], np.float32)
        return vals[rng.randint(0, len(vals), size=(steps,) + shape)]
    if kind == "all_two":  # toggles everything, mean 2.0: no reset
        return np.full((steps,) + shape, 2.0, np.float32)
    if kind == "ones_then_sparse":  # master reset on the all-ones steps
        acts = (rng.rand(steps, *shape) < 0.1).astype(np.float32)
        acts[2] = 1.0
        acts[5] = 1.0
        return acts
    return np.zeros((steps,) + shape, np.float32)


@pytest.mark.parametrize("geom", [GEOMETRIES[1], GEOMETRIES[2]])
@pytest.mark.parametrize("kind", ["valued", "all_two", "ones_then_sparse", "none"])
def test_env_step_trajectory_matches(geom, kind):
    cfg, jcfg = _configs(*geom)
    rng = np.random.RandomState(5)
    rule = rng.randint(0, 1 << 18, size=cfg.instances).astype(np.int32)
    acts = _action_stream(kind, 8, cfg.action_shape, rng)
    soup = (rng.rand(*cfg.grid_shape) < 0.4).astype(np.uint8)

    st = init_state(cfg, torch.from_numpy(rule), device="cpu")
    st = st._replace(grid=torch.from_numpy(soup))
    jst = jinit_state(jcfg, jnp.asarray(rule))
    jst = jst._replace(grid=jnp.asarray(soup))
    for a in acts:
        st, obs = env_step(st, torch.from_numpy(a), cfg)
        jst, jobs = jenv_step(jst, jnp.asarray(a), config=jcfg)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        assert int(st.step_num) == int(jst.step_num)
        assert int(st.steps_since_action) == int(jst.steps_since_action)
