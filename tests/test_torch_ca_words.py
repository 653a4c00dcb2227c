"""The env step with the master reset fused into ``ca_step``, against
carle_tpu on the CPU.

``env_step`` hands the raw action bytes (or the toggles of a non-byte
action) and the batch-global reset flag to ``ca_step``, which writes zeros
under the flag; on the CPU that is ``ca_step_plain``.  Inputs come from a
numpy seed and go through ``carle_tpu.env.env_step`` and the port's on the
CPU: grids, ``step_num`` and ``steps_since_action`` must be equal, bit for
bit (no tolerance).  The kernels themselves are held against the same twin
in tests/test_torch_emulated.py (their bodies, compiled for the host) and
tests/test_torch_kernels.py (on the card).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu.env import env_step as jenv_step, init_state as jinit_state
from carle_tpu.ops.ca import ca_step_grid as jca_step_grid, pad_action as jpad_action

from carle_tpu_torch import EnvConfig, env as env_mod
from carle_tpu_torch.env import env_step, init_state
from carle_tpu_torch.ops import cuda_ca


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GEOMETRIES = [  # (H, W, AH, AW, instances): widths the word kernel takes
    (32, 64, 16, 16, 3),
    (40, 48, 13, 26, 2),   # the window from column 11: it cuts words
    (16, 16, 16, 16, 1),   # the window the whole universe
]


def _configs(h, w, ah, aw, n):
    return (EnvConfig(h, w, ah, aw, n),
            JEnvConfig(height=h, width=w, action_height=ah, action_width=aw,
                       instances=n))


def _actions(kind, steps, shape, rng):
    """An action stream of ``kind``; the reset fires on the all-ones steps."""
    sparse = (rng.rand(steps, *shape) < 0.1).astype(np.float32)
    if kind == "ones":          # all ones on steps 1 and 4: the master reset
        sparse[1] = 1.0
        sparse[4] = 1.0
        return sparse
    if kind == "twos":          # all 2.0 on steps 1 and 4: toggles, no reset
        sparse[1] = 2.0
        sparse[4] = 2.0
        return sparse
    if kind == "halves":        # 0.5 toggles like 1.0
        return sparse * 0.5
    if kind == "bytes":         # uint8 values 0, 1, 2, 128, 255, handed on raw
        values = np.array([1, 2, 128, 255], np.uint8)
        acts = np.where(sparse > 0, values[rng.randint(0, 4, sparse.shape)], 0)
        acts[3] = 1             # an all-ones uint8 step resets too
        return acts.astype(np.uint8)
    if kind == "bools":
        out = sparse > 0
        out[2] = True           # all True: mean 1.0, the reset
        return out
    return np.zeros((steps,) + shape, np.float32)   # empty


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("kind", ["ones", "twos", "halves", "bytes", "bools", "empty"])
def test_env_step_matches_jax_with_fused_reset(geom, kind):
    cfg, jcfg = _configs(*geom)
    rng = np.random.RandomState(sum(geom))
    rule = rng.randint(0, 1 << 18, size=cfg.instances).astype(np.int32)
    acts = _actions(kind, 7, cfg.action_shape, rng)
    soup = (rng.rand(*cfg.grid_shape) < 0.4).astype(np.uint8)
    st = init_state(cfg, torch.from_numpy(rule), device="cpu")._replace(
        grid=torch.from_numpy(soup))
    jst = jinit_state(jcfg, jnp.asarray(rule))._replace(grid=jnp.asarray(soup))
    resets = 0
    for a in acts:
        st, obs = env_step(st, torch.from_numpy(np.ascontiguousarray(a)), cfg)
        jst, jobs = jenv_step(jst, jnp.asarray(a), config=jcfg)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(st.grid.numpy(), np.asarray(jst.grid))
        assert int(st.step_num) == int(jst.step_num)
        assert int(st.steps_since_action) == int(jst.steps_since_action)
        resets += int(not obs.any() and int(st.step_num) == 0)
    assert resets == (2 if kind == "ones" else int(kind in ("bytes", "bools")))


def test_env_step_hands_the_reset_to_ca_step(monkeypatch):
    """The grid env_step returns is ca_step's output itself, computed with
    the flag: no pass over the grid runs after it."""
    cfg = EnvConfig(32, 32, 8, 8, 2)
    seen = {}

    def spy(grid, action, rule_bits, config, reset=None):
        seen["action"], seen["reset"] = action, reset
        seen["out"] = cuda_ca.ca_step(grid, action, rule_bits, config, reset)
        return seen["out"]

    monkeypatch.setattr(env_mod, "ca_step", spy)
    state = init_state(cfg, device="cpu")
    for value, fires in ((1.0, True), (2.0, False), (0.5, False)):
        new, obs = env_step(state, torch.full(cfg.action_shape, value), cfg)
        assert obs is seen["out"] and new.grid is seen["out"]
        assert seen["reset"].shape == () and seen["reset"].dtype == torch.bool
        assert bool(seen["reset"]) == fires
        assert seen["action"].dtype == torch.uint8 and int(seen["action"].max()) == 1
    raw = torch.full(cfg.action_shape, 255, dtype=torch.uint8)
    env_step(state, raw, cfg)
    assert seen["action"] is raw   # uint8 bytes go on as they are


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("per_instance", [False, True])
def test_ca_step_plain_reset_matches_jax(geom, per_instance):
    """ca_step_plain without the flag, with it unset, and with it set (all
    zeros) against carle_tpu's ca_step_grid after the XOR."""
    cfg, jcfg = _configs(*geom)
    rng = np.random.RandomState(7 + sum(geom))
    grid = (rng.rand(*cfg.grid_shape) < 0.4).astype(np.uint8)
    values = np.array([0, 0, 1, 2, 128, 255], np.uint8)
    action = values[rng.randint(0, len(values), cfg.action_shape)]
    rule = (rng.randint(0, 1 << 18, size=cfg.instances).astype(np.int32) if per_instance
            else np.int32(rng.randint(0, 1 << 18)))
    toggles = (jpad_action(jnp.asarray(action), jcfg) != 0).astype(jnp.uint8)
    want = np.asarray(jca_step_grid(jnp.asarray(grid) ^ toggles, jnp.asarray(rule)))
    args = (torch.from_numpy(grid), torch.from_numpy(action), torch.as_tensor(rule), cfg)
    for reset in (None, torch.tensor(False), torch.tensor(0, dtype=torch.uint8)):
        np.testing.assert_array_equal(cuda_ca.ca_step_plain(*args, reset).numpy(), want)
        np.testing.assert_array_equal(cuda_ca.ca_step(*args, reset=reset).numpy(), want)
    for reset in (torch.tensor(True), torch.tensor(1, dtype=torch.uint8)):
        out = cuda_ca.ca_step(*args, reset=reset)
        assert out.shape == cfg.grid_shape and out.dtype == torch.uint8 and not out.any()
    assert want.any()


@pytest.mark.parametrize("shape,route", [((256, 256), "words"), ((64, 64), "words"),
                                         ((32, 96), "words"), ((8192, 8192), "words"),
                                         ((23, 37), "bytes"), ((24, 40), "bytes"),
                                         ((16, 100), "bytes"), ((4, 80000), "bytes")])
def test_ca_step_route_by_shape(monkeypatch, shape, route):
    """The word kernel takes every width that is a multiple of 16 cells
    whose three-row band fits shared memory; CA_STEP_WORDS = False forces
    the byte kernel."""
    assert cuda_ca.ca_step_route(*shape) == route
    monkeypatch.setattr(cuda_ca, "CA_STEP_WORDS", False)
    assert cuda_ca.ca_step_route(*shape) == "bytes"


@pytest.mark.parametrize("n,h,w", [(1, 256, 256), (64, 256, 256), (160, 256, 256),
                                   (1, 8192, 8192), (3, 42, 48)])
def test_words_plan_fits(n, h, w):
    """The word kernel's plan on an H100 SXM's 132 multiprocessors: a band
    fits shared memory, the threads cover the band's strips of 16-byte
    columns at most once a pass."""
    band, strip, threads = cuda_ca.words_plan(n, h, w, 132)
    assert 1 <= strip <= band <= h
    assert cuda_ca._BAR_BYTES + (band + 2) * w <= cuda_ca._SMEM_BYTES
    assert threads % 32 == 0 and 32 <= threads <= 256


@pytest.mark.parametrize("n,sms,plan", [(160, 132, (30, 4, 128)), (64, 132, (30, 4, 128)),
                                        (1, 132, (6, 3, 32)), (1, 8, (14, 4, 64)),
                                        (1, 1, (30, 4, 128))])
def test_words_plan_follows_multiprocessors(n, sms, plan):
    """At 256² the plan narrows the blocks until every multiprocessor of the
    card has two; the emulated build's CPU tensors count as one."""
    assert cuda_ca.words_plan(n, 256, 256, sms) == plan
    assert cuda_ca._multiprocessors(torch.device("cpu")) == 1
