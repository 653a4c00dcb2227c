"""carle_tpu_torch vs carle_tpu: the Carle's Game submission surface on the CPU.

The per-step ``evaluate`` (the agent class called on each observation of the
``CARLE`` shell in the wrappers' class shells), the class agents, the
submission API, the Speed and Puffer shells, ``_resolve_fused_agent`` and the
entry points that take agents (``train(agent_fn=)``, ``/score``).  The
protocol's geometry: 256² universes, 64² actions, here over 2 rulesets x 4
steps with the shipped ``.npz`` checkpoints.

Cross-package runs play one numpy action stream (a replay agent) on both
sides: a flipped toggle would split the universes, and the network agent's
threshold on ``sigmoid(dense)`` can flip between packages where the dense
output lies within float error of ``logit(0.1)``.  So the network agent is
held action by action on the same observations, outputs within 1e-4 of the
threshold excluded and counted.  Traces: rtol 1e-4 / atol 1e-5 (the frozen
stack's float32 sums in other orders); the training run through Adam updates
rtol 2e-3 (tests/test_torch_train.py).  The port's random agents draw from
torch generators, so their actions are held within the port only.
"""

import contextlib
import functools
import http.client
import io
import json
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import carle_tpu
import carle_tpu.train_mcl as jtrain_mcl
from carle_tpu import agents as jagents
from carle_tpu import mcl as jmcl
from carle_tpu.checkpoint import save_pytree as jsave_pytree
from carle_tpu.evaluation import eval as jeval

from carle_tpu_torch import CARLE, agents, nets, train_mcl
from carle_tpu_torch import mcl as tmcl
from carle_tpu_torch.checkpoint import save_pytree
from carle_tpu_torch.evaluation import eval as teval
from carle_tpu_torch.evaluation import submission
from carle_tpu_torch.mcl import patterns as tpatterns
from carle_tpu_torch.serve import make_server

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them
    (the 256² twins here ran 10-40x slower under that load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RULES = [[[3], [2, 3]], [[2], [0]]]   # Life and the held-out outgroup
# The network agent is bias-free: on an empty universe its output is
# sigmoid(0) = 0.5 and it never toggles.  Rules that give birth on zero
# neighbours fill the universe after the reset, so it acts.
RULES_B0 = [[[0, 3], [2, 3]], [[0, 2, 3], [3]]]
STEPS = 4
LOGIT = float(np.log(0.1 / 0.9))      # the network agent's threshold on its dense output


def _stream(seed, steps, inst=1, p=0.1):
    return (np.random.RandomState(seed).rand(steps, inst, 1, 64, 64) < p).astype(np.float32)


ACTS = _stream(0, len(RULES) * STEPS)


def replay_agent(stream):
    """An agent class that plays ``stream`` one action a call, whatever the
    observation: the same toggles reach both packages."""

    class Replay:
        def __init__(self, **kwargs):
            self.i = 0

        def __call__(self, obs):
            self.i += 1
            return stream[self.i - 1]

        def load_state_dict(self, state_dict):
            pass

    return Replay


_JAX = {}


def _jax_once(key, fn):
    """The JAX side, computed once a session (its shells compile at 256²)."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


# ---------------------------------------------------------------------------
# (a) the per-step evaluate against carle_tpu's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compat", [True, False])
def test_evaluate_matches_jax_per_step_trace(compat, capsys):
    def jax_side():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            score, trace = jeval.evaluate(replay_agent(ACTS), RULES, jeval.DEFAULT_WRAPPERS,
                                          steps=STEPS, reference_compat=compat)
        return score, np.asarray(trace), out.getvalue()

    jscore, jtrace, jprinted = _jax_once(("evaluate", compat), jax_side)
    capsys.readouterr()
    score, trace = teval.evaluate(replay_agent(ACTS), RULES, teval.DEFAULT_WRAPPERS,
                                  steps=STEPS, reference_compat=compat, device="cpu")
    printed = capsys.readouterr().out
    assert isinstance(trace, list) and len(trace) == len(RULES) * STEPS
    np.testing.assert_allclose(np.asarray(trace), jtrace, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(score, jscore, rtol=1e-4)
    assert printed == jprinted   # "cumulative score = ..." letter for letter
    assert printed.count("cumulative score = ") == len(RULES)


def test_evaluate_protocol():
    wrappers = [[tmcl.SpeedDetector, 1e-2, None], [tmcl.ParsimonyBonus, 1.0, None]]
    score, trace = teval.evaluate(submission.SubmissionAgent, RULES, wrappers, steps=6,
                                  verbose=False, device="cpu")
    assert len(trace) == 12
    assert np.isfinite(score)


def test_evaluate_survive_bug_compat_flag():
    captured = {}

    class Probe(tmcl.CornerBonus):
        def reset(self):
            captured["birth"] = list(self.inner_env.birth)
            captured["survive"] = list(self.inner_env.survive)
            return super().reset()

    rules = [[[3, 6], [2, 3]]]
    teval.evaluate(submission.SubmissionAgent, rules, [[Probe, 1.0, None]], steps=1,
                   verbose=False, device="cpu")
    assert captured["survive"] == [3, 6]  # the bug, replicated
    teval.evaluate(submission.SubmissionAgent, rules, [[Probe, 1.0, None]], steps=1,
                   reference_compat=False, verbose=False, device="cpu")
    assert captured["survive"] == [2, 3]  # the fix


def test_npz_checkpoint_load_preserves_spec_reward_scale():
    captured = {}

    class Probe(tmcl.RND2D):
        def reset(self):
            captured["scale"] = self.reward_scale
            captured["updates"] = int(self._wstate.updates)
            return super().reset()

    teval.evaluate(submission.SubmissionAgent, [[[3], [2, 3]]],
                   [[Probe, 0.25, teval._HERE + "/RND2D_mcl.npz"]], steps=1,
                   verbose=False, device="cpu")
    assert captured["scale"] == 0.25
    assert captured["updates"] > 0   # the shipped learner state, not a fresh one


def test_evaluate_freezes_learners_and_takes_raising_wrappers():
    seen = {}

    class NoBatch(tmcl.SpeedDetector):
        @property
        def batch_size(self):
            raise AttributeError("no update cycle")

        @batch_size.setter
        def batch_size(self, value):
            raise AttributeError("no update cycle")

    class Spy(tmcl.AE2D):
        def reset(self):
            seen["batch_size"] = self.batch_size
            seen["train"] = self._train
            return super().reset()

    # a checkpoint's whole learner state (its batch_size too) replaces the
    # shell's, as in carle_tpu; eval() is what freezes it
    specs = [[tmcl.RND2D, 1.0, teval._HERE + "/RND2D_mcl.npz"], [Spy, 1.0, None],
             [NoBatch, 1e-2, None]]
    score, trace = teval.evaluate(submission.SubmissionAgent, RULES, specs, steps=3,
                                  verbose=False, device="cpu")
    assert len(trace) == 6 and np.isfinite(score)
    assert seen == {"batch_size": 3 * len(RULES), "train": False}


def test_class_agents_and_evaluate_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (agents.RandomAgent, agents.RandomNetworkAgent, submission.SubmissionAgent,
                  lambda: teval.evaluate(submission.SubmissionAgent, RULES,
                                         teval.DEFAULT_WRAPPERS, steps=1, verbose=False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_per_step_cli_on_cpu(capsys):
    teval.main(["--per-step", "--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("cumulative score = ") == 5
    assert "mean evaluation score is" in out


# ---------------------------------------------------------------------------
# (b) the network agent with JAX's weights carried across
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _toggling_weights():
    """Network-agent weights drawn from numpy at scales that make it toggle
    about a third of the window (its own seeded draw rarely toggles at all)."""
    rng = np.random.RandomState(5)
    w = {"conv1": rng.randn(4, 1, 3, 3) * 0.5, "conv2": rng.randn(1, 4, 3, 3) * 0.5,
         "dense": rng.randn(4096, 4096) * 0.02}
    return {k: v.astype(np.float32) for k, v in w.items()}


@functools.lru_cache(maxsize=None)
def _jax_network_agent():
    """JAX's network agent with the toggling weights."""
    w = _toggling_weights()
    jagent = jagents.RandomNetworkAgent(seed=5)
    jagent.params = {k: {"w": jnp.asarray(v)} for k, v in w.items()}
    return jagent, w


@pytest.fixture(scope="module")
def toggling_npz(tmp_path_factory):
    params = {k: {"w": torch.from_numpy(v)} for k, v in _toggling_weights().items()}
    return save_pytree(str(tmp_path_factory.mktemp("rna") / "rna.npz"), params)


def _observations():
    rng = np.random.RandomState(8)
    density = rng.uniform(0.05, 0.6, size=(8, 1, 1, 1))
    return (rng.rand(8, 1, 256, 256) < density).astype(np.float32)


def _dense_outputs(agent, obs):
    p = agent.params
    x = nets.max_pool2(torch.relu(nets.conv2d(obs, p["conv1"])))
    x = nets.max_pool2(torch.relu(nets.conv2d(x, p["conv2"])))
    return nets.linear(nets.flatten(x), p["dense"])


@pytest.mark.parametrize("route", ["npz", "network_state_dict", "sequential_state_dict",
                                   "pt"])
def test_random_network_agent_matches_jax_actions(route, tmp_path):
    jagent, w = _jax_network_agent()
    agent = agents.RandomNetworkAgent(seed=0, device="cpu")
    if route == "npz":
        agent.load_state_dict(jsave_pytree(str(tmp_path / "rna.npz"), jagent.params))
    else:
        prefix = "" if route == "sequential_state_dict" else "network."
        sd = {f"{prefix}{i}.weight": torch.from_numpy(w[k])
              for i, k in ((0, "conv1"), (3, "conv2"), (7, "dense"))}
        if route == "pt":
            torch.save(sd, str(tmp_path / "rna.pt"))
            sd = str(tmp_path / "rna.pt")
        agent.load_state_dict(sd)
    for k in w:
        np.testing.assert_array_equal(agent.params[k]["w"].numpy(), w[k])
        assert set(agent.params[k]) == {"w"}   # bias-free, as the reference

    obs = _observations()
    want = np.asarray(_jax_once("rna_actions", lambda: np.asarray(jagent(obs))))
    got = agent(obs)
    assert got.dtype == torch.float32 and got.shape == (8, 1, 64, 64)
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    z = _dense_outputs(agent, torch.from_numpy(obs)).reshape(8, 1, 64, 64).numpy()
    clear = np.abs(z - LOGIT) > 1e-4
    near = int((~clear).sum())
    print(f"{near} of {z.size} dense outputs lie within 1e-4 of logit(0.1)")
    assert near < z.size // 100
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    assert 0.05 < float(got.mean()) < 0.6   # the policy toggles, and not everything


# ---------------------------------------------------------------------------
# (c) within the port: the fused paths score every agent spec
# ---------------------------------------------------------------------------

# the agent-spec checks need no nets: Speed and Puffer read the universe
CHEAP = [[tmcl.SpeedDetector, 1e-2, None], [tmcl.PufferDetector, 1e-3, None]]


def test_evaluate_fused_network_agent_matches_per_step(toggling_npz):
    kw = dict(rules=RULES_B0, wrappers=teval.DEFAULT_WRAPPERS, steps=STEPS, verbose=False,
              seed=7, params_path=toggling_npz, device="cpu")
    score_ps, trace_ps = teval.evaluate(agents.RandomNetworkAgent, **kw)
    score_f, trace_f = teval.evaluate_fused(Agent=agents.RandomNetworkAgent, **kw)
    np.testing.assert_allclose(trace_f, np.asarray(trace_ps), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(score_f, score_ps, rtol=1e-4)


@pytest.mark.parametrize("batched", [False, True])
def test_random_agent_class_scores_as_the_baseline(batched):
    fn = teval.evaluate_fused_batched if batched else teval.evaluate_fused
    kw = dict(rules=RULES, wrappers=CHEAP, steps=STEPS, verbose=False, seed=3, device="cpu")
    base_score, base = fn(Agent=None, toggle_rate=0.1, **kw)
    for spec in (agents.RandomAgent, submission.SubmissionAgent,
                 agents.RandomAgent(seed=3, device="cpu")):
        score, got = fn(Agent=spec, **kw)
        np.testing.assert_array_equal(got, base)
        assert score == base_score


def test_every_agent_spec_scores_as_its_class(toggling_npz):
    """A class with params_path, an instance (loaded, or with params_path),
    an (Agent, params) pair and a functional agent with agent_params score
    alike, on the fused, batched and per-step paths."""
    kw = dict(rules=RULES_B0, wrappers=CHEAP, steps=STEPS, verbose=False, seed=3,
              device="cpu")
    inst = agents.RandomNetworkAgent(seed=11, device="cpu")
    inst.load_state_dict(toggling_npz)
    _, by_class = teval.evaluate_fused(Agent=agents.RandomNetworkAgent,
                                       params_path=toggling_npz, **kw)
    _, seeded = teval.evaluate_fused(Agent=agents.RandomNetworkAgent, **kw)
    assert not np.array_equal(by_class, seeded)   # the loaded weights act
    for spec, extra in ((inst, {}), (agents.RandomNetworkAgent(device="cpu"),
                                     {"params_path": toggling_npz}),
                        ((inst._agent, inst.params), {}),
                        (inst._agent, {"agent_params": inst.params})):
        _, got = teval.evaluate_fused(Agent=spec, **extra, **kw)
        np.testing.assert_array_equal(got, by_class)
    score, per_rule = teval.evaluate_fused_batched(Agent=agents.RandomNetworkAgent,
                                                   params_path=toggling_npz, **kw)
    assert per_rule.shape == (2,) and np.isfinite(score)
    _, trace = teval.evaluate(agents.RandomNetworkAgent, params_path=toggling_npz, **kw)
    np.testing.assert_allclose(np.asarray(trace), by_class, rtol=1e-4, atol=1e-5)


class _NoPolicy:
    def __init__(self, **kwargs):
        pass

    def load_state_dict(self, state_dict):
        pass


def _spec(kind, package):
    fn = package.make_random_agent()
    return {"none": None, "functional": fn, "pair": (fn, {}), "class": _NoPolicy,
            "instance": _NoPolicy()}[kind]


_BAD_SPECS = {
    "none_with_params_path": ("none", "x.npz", None, ValueError),
    "none_with_agent_params": ("none", None, {}, ValueError),
    "functional_with_params_path": ("functional", "x.npz", None, ValueError),
    "pair_with_params_path": ("pair", "x.npz", None, ValueError),
    "pair_with_agent_params": ("pair", None, {}, ValueError),
    "class_without_agent": ("class", None, None, TypeError),
    "instance_without_agent": ("instance", None, None, TypeError),
}


@pytest.mark.parametrize("case", sorted(_BAD_SPECS))
def test_resolve_fused_agent_refuses_as_jax_does(case):
    kind, params_path, agent_params, error = _BAD_SPECS[case]
    with pytest.raises(error) as got:
        teval._resolve_fused_agent(_spec(kind, agents), params_path, agent_params,
                                   teval.EnvConfig(), 0.1, 0, torch.device("cpu"))
    with pytest.raises(error) as want:
        jeval._resolve_fused_agent(_spec(kind, jagents), params_path, agent_params,
                                   carle_tpu.EnvConfig(), 0.1, 0)
    assert str(got.value).split()[:3] == str(want.value).split()[:3]


def test_seeder_agent_and_tile_pattern_match_jax():
    glider = tpatterns.get_glider()[0, 0, 32:35, 31:34]   # the 3 x 3 cells
    for copies, spacing in ((1, 4), (6, 3), (40, 2)):
        np.testing.assert_array_equal(
            agents.tile_pattern(glider, copies, spacing),
            jagents.tile_pattern(glider, copies, spacing))
    with pytest.raises(ValueError):
        agents.tile_pattern(glider, 1000)
    bank = [agents.tile_pattern(glider, 4), tpatterns.get_morley_puffer(), glider[None]]
    obs = np.zeros((5, 1, 256, 256), np.float32)
    obs[1, 0, 3, 4] = obs[3, 0, 200, 100] = 1.0   # instances 1 and 3 are alive
    seeder, jseeder = agents.make_seeder_agent(bank), jagents.make_seeder_agent(bank)
    got = seeder.apply({}, None, torch.from_numpy(obs))
    want = jseeder.apply({}, jax.random.PRNGKey(0), jnp.asarray(obs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[1].sum()) == float(got[3].sum()) == 0.0
    assert all(float(got[i].sum()) > 0.0 for i in (0, 2, 4))
    with pytest.raises(ValueError, match="exceeds"):
        agents.make_seeder_agent(np.ones((65, 3)))
    score, trace = teval.evaluate_fused(Agent=agents.make_seeder_agent(glider), rules=RULES,
                                        wrappers=CHEAP, steps=STEPS, verbose=False,
                                        device="cpu")
    assert np.isfinite(score) and trace.shape == (len(RULES) * STEPS,)


# ---------------------------------------------------------------------------
# (d) the Speed and Puffer shells over CARLE against JAX's
# ---------------------------------------------------------------------------


def test_speed_and_puffer_shells_match_jax():
    acts = _stream(4, 16, inst=2, p=0.05)
    acts[4:12] = 0.0   # action-free steps fill the Puffer window
    kw = dict(instances=2)
    env = tmcl.SpeedDetector(tmcl.PufferDetector(CARLE(device="cpu", **kw), seed=1,
                                                 growth_threshold=4), seed=2)
    jenv = jmcl.SpeedDetector(jmcl.PufferDetector(carle_tpu.CARLE(**kw), seed=1,
                                                  growth_threshold=4), seed=2)
    for shell, jshell in ((env, jenv), (env.env, jenv.env)):
        assert shell.my_name == jshell.my_name
    assert env.speed_modulator == jenv.speed_modulator == 32.0
    assert (env.env.growth_threshold, env.env.growing_steps) == (
        jenv.env.growth_threshold, jenv.env.growing_steps) == (4, 0)
    assert tmcl.PufferDetector(CARLE(device="cpu")).growth_threshold == 512
    env.rules_from_string("B3/S23"), jenv.rules_from_string("B3/S23")
    env.reset(), jenv.reset()
    fired = 0.0
    for a in acts:
        _, reward, _, _ = env.step(a)
        _, jreward, _, _ = jenv.step(a)
        np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), rtol=1e-4, atol=1e-5)
        assert reward.shape == (2, 1)
        fired = max(fired, float(reward.min()))
    assert fired > 1.0   # the puffer bonus fired on both instances (batch-global)


# ---------------------------------------------------------------------------
# (f) train(agent_fn=...) and (g) /score's network agent
# ---------------------------------------------------------------------------


def _bank_agents(K):
    """(JAX, port) functional agents whose action is ``bank[sum(obs) % K]``:
    exact in both packages, so the trajectories cannot split."""

    def japply(params, key, obs):
        return params["bank"][jnp.sum(obs, axis=(1, 2, 3)).astype(jnp.int32) % K][:, None]

    def tapply(params, generator, obs):
        return params["bank"][obs.sum(dim=(1, 2, 3)).to(torch.int64) % K][:, None]

    return (jagents.Agent(init=lambda key: {}, apply=japply),
            agents.Agent(init=lambda generator: {}, apply=tapply))


def test_train_agent_fn_matches_jax(monkeypatch, tmp_path):
    rng = np.random.RandomState(12)
    bank = (rng.rand(5, 64, 64) < 0.08).astype(np.float32)
    kw = dict(instances=2, steps=(1, 4), rules=RULES, height=64, width=64, batch_size=2,
              seed=0, resume_from=str(tmp_path / "init"))
    jcfg = carle_tpu.EnvConfig(height=64, width=64, action_height=64, action_width=64)
    for name, jdef in (("RND2D", jmcl.rnd2d_def), ("AE2D", jmcl.ae2d_def)):
        state = jdef(jcfg, batch_size=2).init(jax.random.PRNGKey(len(name)))
        state = state._replace(params=jax.tree.map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.3),
            state.params))
        jsave_pytree(str(tmp_path / "init" / f"{name}.npz"), state)
    for module, rnd, ae in ((jtrain_mcl, jmcl.rnd2d_def, jmcl.ae2d_def),
                            (train_mcl, tmcl.rnd2d_def, tmcl.ae2d_def)):
        monkeypatch.setattr(module, "rnd2d_def", functools.partial(rnd, dropout=False))
        monkeypatch.setattr(module, "ae2d_def", functools.partial(ae, dropout=False))
    jagent, tagent = _bank_agents(len(bank))
    want = jtrain_mcl.train(agent_fn=(jagent, {"bank": jnp.asarray(bank)}),
                            log_dir=str(tmp_path / "jax"), **kw)
    got = train_mcl.train(agent_fn=(tagent, {"bank": torch.from_numpy(bank)}),
                          log_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert got.shape == want.shape == (len(RULES) * 4,)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    # a class agent trains too, on its own seeded weights
    hist = train_mcl.train(agent_fn=agents.RandomNetworkAgent, instances=1, steps=(1, 2),
                           rules=RULES[:1], height=64, width=64,
                           log_dir=str(tmp_path / "rna"), device="cpu")
    assert hist.shape == (2,) and np.isfinite(hist).all()


def _post(conn, path, body):
    conn.request("POST", path, json.dumps(body))
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_score_serves_the_network_agent_on_cpu(tmp_path):
    donor = agents.RandomNetworkAgent(seed=4, device="cpu")
    path = save_pytree(str(tmp_path / "rna.npz"), donor.params)
    srv = make_server("127.0.0.1", 0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
        status, net = _post(conn, "/score", {"agent": "network", "steps": 2})
        assert status == 200 and net["agent"] == "network" and np.isfinite(net["score"])
        assert len(net["per_ruleset"]) == 5
        body = {"agent": "network", "steps": 2, "batched": False, "params_path": path}
        status, seq = _post(conn, "/score", body)
        want, _ = teval.evaluate_fused(Agent=donor, steps=2, verbose=False, device="cpu")
        assert status == 200 and seq["score"] == pytest.approx(want, rel=1e-12)
        status, pol = _post(conn, "/score", {"agent": "policy", "steps": 2, "batched": False})
        want, _ = teval.evaluate_fused(Agent=teval.load_shipped_policy(device="cpu"), steps=2,
                                       verbose=False, device="cpu")
        assert status == 200 and pol["score"] == pytest.approx(want, rel=1e-12)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
