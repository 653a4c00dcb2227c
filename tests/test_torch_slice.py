"""carle_tpu_torch vs carle_tpu: the scoring slice end to end on the CPU.

The four-wrapper battery stack (RND2D, AE2D, SpeedDetector, PufferDetector,
learners frozen) runs the same numpy action stream through both packages'
``Rollout.run_actions``; per-step rewards must agree within rtol 1e-4 /
atol 1e-6.  Parameters cross from the JAX learner states to the port by
``checkpoint.learner_state_from_numpy``.  Random-agent scores are not
compared: ``jax.random`` and ``torch.Generator`` draw different actions.
"""

import http.client
import json
import os
import re
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import carle_tpu.serve as jserve
from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu.checkpoint import _path_str
from carle_tpu.mcl import ae2d_def as jae2d_def, puffer_def as jpuffer_def
from carle_tpu.mcl import rnd2d_def as jrnd2d_def, speed_def as jspeed_def
from carle_tpu.rollout import Rollout as JRollout

import carle_tpu_torch
from carle_tpu_torch import EnvConfig, rules
from carle_tpu_torch.checkpoint import (flatten, learner_state_from_numpy,
                                        load_pytree, read_npz)
from carle_tpu_torch.evaluation import eval as teval
from carle_tpu_torch.mcl import ae2d_def, puffer_def, rnd2d_def, speed_def
from carle_tpu_torch.rollout import Rollout
from carle_tpu_torch.serve import make_server


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "carle_tpu_torch", "evaluation")


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _randomise_params(state, rng):
    """The JAX learner state with every net parameter redrawn from numpy."""
    def draw(p):
        return jax.tree.map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.3), p)
    return state._replace(params=draw(state.params),
                          target_params=draw(state.target_params))


def _stacks(h, w, ah, aw, n, per_instance=False, growth_threshold=512,
            nets=True):
    """(config, JAX Rollout, port Rollout) over the battery's wrappers; the
    port's Puffer window is its module constant (patch it to match)."""
    cfg = EnvConfig(h, w, ah, aw, n)
    jcfg = JEnvConfig(height=h, width=w, action_height=ah, action_width=aw,
                      instances=n)
    jdefs, tdefs = [], []
    if nets:
        jdefs += [jrnd2d_def(jcfg, 1.0, train=False),
                  jae2d_def(jcfg, 1.0, train=False)]
        tdefs += [rnd2d_def(cfg, 1.0, train=False), ae2d_def(cfg, 1.0, train=False)]
    jdefs += [jspeed_def(jcfg, 1e-2, per_instance=per_instance),
              jpuffer_def(jcfg, 1e-3, growth_threshold=growth_threshold,
                          per_instance=per_instance)]
    tdefs += [speed_def(cfg, 1e-2, per_instance=per_instance),
              puffer_def(cfg, 1e-3, per_instance=per_instance)]
    return cfg, JRollout(jcfg, jdefs), Rollout(cfg, tdefs, device="cpu")


def _run_both(cfg, jro, tro, jwstates, actions, rule):
    jcarry = jro.init(jax.random.PRNGKey(0), rules.LIFE)
    jcarry = jcarry._replace(stack=jcarry.stack._replace(
        wrappers=tuple(jwstates) + jcarry.stack.wrappers[len(jwstates):],
        env=jcarry.stack.env._replace(rule_bits=jnp.asarray(rule))))
    carry = tro.init(tro.generator(0), rules.LIFE)
    tw = tuple(learner_state_from_numpy(_flat_numpy(s), "cpu") for s in jwstates)
    carry = carry._replace(stack=carry.stack._replace(
        wrappers=tw + carry.stack.wrappers[len(tw):]))
    carry = tro.with_rules(carry, torch.as_tensor(rule))
    _, want = jro.run_actions(jcarry, jnp.asarray(actions))
    _, got = tro.run_actions(carry, torch.from_numpy(actions))
    return got.numpy(), np.asarray(want)


def _actions(rng, steps, cfg, rate=0.1):
    acts = (rng.rand(steps, *cfg.action_shape) < rate).astype(np.float32)
    acts[steps // 2] = 1.0  # all ones: the batch-global master reset
    return acts


def test_battery_stack_matches_jax_with_carried_params():
    cfg, jro, tro = _stacks(64, 64, 32, 32, 3)
    rng = np.random.RandomState(0)
    jcarry = jro.init(jax.random.PRNGKey(1), rules.LIFE)
    jw = [_randomise_params(s, rng) for s in jcarry.stack.wrappers[:2]]
    rule = rng.randint(0, 1 << 18, size=3).astype(np.int32)
    acts = _actions(rng, 32, cfg)
    acts[5:9] = 0.0  # action-free stretch
    got, want = _run_both(cfg, jro, tro, jw, acts, rule)
    assert got.shape == want.shape == (32, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_battery_stack_matches_jax_with_shipped_checkpoints():
    from carle_tpu.checkpoint import load_pytree as jload_pytree

    cfg, jro, tro = _stacks(256, 256, 64, 64, 1)
    jcarry = jro.init(jax.random.PRNGKey(2), rules.LIFE)
    jw = [jload_pytree(os.path.join(SHIPPED, f), s) for f, s in
          zip(("RND2D_mcl.npz", "AE2D_mcl.npz"), jcarry.stack.wrappers[:2])]
    rng = np.random.RandomState(3)
    got, want = _run_both(cfg, jro, tro, jw, _actions(rng, 8, cfg),
                          np.int32(rules.MORLEY))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("per_instance", [False, True])
def test_speed_and_puffer_match_jax(per_instance, monkeypatch):
    from carle_tpu_torch.mcl import puffer

    monkeypatch.setattr(puffer, "GROWTH_THRESHOLD", 4)  # a short window fires
    cfg, jro, tro = _stacks(32, 32, 8, 8, 4, per_instance=per_instance,
                            growth_threshold=4, nets=False)
    rng = np.random.RandomState(4)
    acts = np.zeros((40,) + cfg.action_shape, np.float32)
    acts[0] = (rng.rand(*cfg.action_shape) < 0.5)
    acts[20, :2] = (rng.rand(2, *cfg.action_shape[1:]) < 0.5)  # some instances act
    rule = np.full(4, rules.pack_rule_bits([3, 6], [2, 3]), np.int32)  # HighLife grows
    got, want = _run_both(cfg, jro, tro, [], acts, rule)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert (want > 0).any()


def test_shipped_checkpoints_load_whole():
    like = rnd2d_def(EnvConfig()).init(torch.Generator().manual_seed(0), "cpu")
    for name in ("RND2D_mcl.npz", "AE2D_mcl.npz"):
        flat = read_npz(os.path.join(SHIPPED, name))
        state = learner_state_from_numpy(flat, "cpu")
        assert set(flatten(state)) == set(flat)
        for key, t in flatten(state).items():
            np.testing.assert_array_equal(t.numpy(), flat[key].astype(t.numpy().dtype))
    loaded = load_pytree(os.path.join(SHIPPED, "RND2D_mcl.npz"), like)
    assert int(loaded.updates) == 256 and loaded.params["dense"]["w"].shape == (16, 1024)


def test_battery_entry_points_on_cpu():
    score, per_rule = teval.evaluate_fused_batched(steps=6, replicas=2, seed=3,
                                                   verbose=False, device="cpu")
    again, _ = teval.evaluate_fused_batched(steps=6, replicas=2, seed=3,
                                            verbose=False, device="cpu")
    assert per_rule.shape == (5,) and np.isfinite(per_rule).all()
    assert score == again and 0.0 <= score <= 10.0
    score, trace = teval.evaluate_fused(steps=3, verbose=False, device="cpu")
    assert trace.shape == (15,) and np.isfinite(score)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.evaluate_fused(steps=1, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        carle_tpu_torch.init_state(EnvConfig())


def _post(conn, path, body):
    conn.request("POST", path, json.dumps(body))
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_server_endpoints_on_cpu():
    srv = make_server("127.0.0.1", 0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
        assert health["ok"] and health["device"] == "cpu"
        status, score = _post(conn, "/score", {"steps": 4})
        assert status == 200 and len(score["per_ruleset"]) == 5
        status, seq = _post(conn, "/score", {"steps": 2, "batched": False,
                                             "seeds": [0, 1]})
        assert status == 200 and len(seq["per_ruleset"]) == 5
        assert len(seq["per_seed"]) == 2
        glider = "x = 3, y = 3, rule = B3/S23\nbo$2bo$3o!"
        body = {"rle": glider, "steps": 12, "size": 64}
        status, roll = _post(conn, "/rollout", body)
        want = jserve._rollout(dict(body))
        assert status == 200
        assert (roll["population"], roll["rle"]) == (want["population"], want["rle"])
        status, pol = _post(conn, "/score", {"agent": "policy", "steps": 2, "batched": False})
        want, _ = teval.evaluate_fused(Agent=teval.load_shipped_policy(device="cpu"), steps=2,
                                       verbose=False, device="cpu")
        assert status == 200 and pol["agent"] == "policy"
        assert pol["score"] == pytest.approx(want, rel=1e-12)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_port_imports_neither_jax_nor_carle_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|optax|carle_tpu)(\.|\s|$)",
                         re.MULTILINE)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "carle_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert len(files) > 10 and not offenders, offenders
