"""carle_tpu_torch vs carle_tpu: the toggle policy and its trainers on the CPU.

``policy_logits`` on both routes (the port's plain autograd path against
JAX's plain path; its fused encoder's twin against JAX's
``make_fused_encoder`` in interpret mode, ``force_kernel=True``): logits rtol
1e-5, gradients rtol 1e-4 / atol 1e-5.  The optimiser (global-norm clip, then
Adam) against optax: rtol 1e-5.  The trainers run with the same uniforms and
permutations on both sides: the tests draw JAX's from its key splits
(``policy.py:118``, ``:123``, ``:295``, ``:376``) and replay them into the
port's ``_uniform`` and ``_permutation``.  Five REINFORCE steps: params rtol
1e-4 / atol 1e-6; PPO iterations (immediate and discounted credit) through 4
Adam updates: params rtol 2e-3 (the training tests' tolerance through Adam);
the reward traces and baselines rtol 1e-5.  The shipped policy's
parameters are JAX's exactly; its deterministic agent's battery score (2
rulesets x 8 steps, Speed only, 256² universes) rtol 1e-4.  Small
geometries: 32 x 64 universes with 16 x 16 actions (``test_pallas_head.py``'s
policy case), 32² x 8 instances with 8 x 8 actions (``test_policy.py``'s).
"""

import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carle_tpu import EnvConfig as JEnvConfig, rules as jrules
from carle_tpu import policy as jpolicy
from carle_tpu.evaluation import eval as jeval
from carle_tpu.mcl.base import WrapperDef as JWrapperDef, default_on_reset as jreset
from carle_tpu.mcl.speed import SpeedDetector as JSpeed

from carle_tpu_torch import EnvConfig, policy, rules
from carle_tpu_torch.evaluation import eval as teval
from carle_tpu_torch.mcl import SpeedDetector
from carle_tpu_torch.mcl.base import WrapperDef, default_on_reset
from carle_tpu_torch.ops import cuda_head as ch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WIDE = dict(height=32, width=64, action_height=16, action_width=16)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_close(got, want, rtol, atol):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(jax.tree.map(lambda t: t.detach().numpy(), got))):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _toggle_defs(sign):
    """reward = sign * mean(action), a dense learnable signal, in both
    packages."""

    def japply(state, ctx, reward):
        return state, reward + sign * jnp.mean(ctx.action.astype(jnp.float32), axis=(1, 2))[:, None]

    def tapply(state, ctx, reward):
        return state, reward + sign * ctx.action.to(torch.float32).mean(dim=(1, 2))[:, None]

    return (JWrapperDef(name="toggle", init=lambda key: (), apply=japply, on_reset=jreset),
            WrapperDef(name="toggle", init=lambda gen, dev: (), apply=tapply,
                       on_reset=default_on_reset))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_policy_logits_match_jax(fused):
    cfg = JEnvConfig(instances=4, **WIDE)
    params = jpolicy.init_policy_params(jax.random.PRNGKey(0), cfg)
    obs = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(1), 0.3, (4, 1, 32, 64)),
                     np.float32)
    co = np.random.RandomState(2).randn(4, 256).astype(np.float32)

    def jloss(p):
        lg = jpolicy.policy_logits(p, jnp.asarray(obs), force_kernel=fused)
        return jnp.sum(lg * co), lg

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    leaves = jax.tree.map(lambda t: t.requires_grad_(True), _torch_tree(params))
    cells = torch.from_numpy(obs.astype(np.uint8)) if fused else torch.from_numpy(obs)
    got = policy.policy_logits(leaves, cells, fused_head=fused)
    (got * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    _assert_tree_close(jax.tree.map(lambda t: t.grad, leaves), jgrads, 1e-4, 1e-5)
    # the fused route reads uint8 cells; a float observation is cast to them
    if fused:
        again = policy.policy_logits(leaves, torch.from_numpy(obs), fused_head=True)
        assert torch.equal(again, got)
    with pytest.raises(ValueError, match="mesh must be"):
        policy.policy_logits(leaves, cells, fused_head=object())


def test_policy_logits_mesh_matches_fused_and_jax():
    """``fused_head=mesh`` (8 cpu slots: the encoder a slot at a time over the
    instances) against ``fused_head=True`` (values 1e-5, gradients 1e-4) and
    against carle_tpu's policy_logits with its 8-device mesh, the observation
    sharded over it (its plain path, as carle_tpu runs off the TPU)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from carle_tpu.parallel import make_mesh as jmake_mesh
    from carle_tpu_torch.parallel import make_mesh

    cfg = JEnvConfig(instances=8, **WIDE)
    params = jpolicy.init_policy_params(jax.random.PRNGKey(3), cfg)
    obs = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(4), 0.3, (8, 1, 32, 64)),
                     np.float32)
    co = np.random.RandomState(5).randn(8, 256).astype(np.float32)
    jmesh = jmake_mesh(axis_name="env")
    jobs = jax.device_put(jnp.asarray(obs), NamedSharding(jmesh, PartitionSpec("env")))

    def jloss(p):
        lg = jpolicy.policy_logits(p, jobs, fused_head=jmesh)
        return jnp.sum(lg * co), lg

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    cells = torch.from_numpy(obs.astype(np.uint8))
    out = {}
    for name, tag in (("mesh", make_mesh([torch.device("cpu")] * 8, "env")), ("fused", True)):
        leaves = jax.tree.map(lambda t: t.requires_grad_(True), _torch_tree(params))
        got = policy.policy_logits(leaves, cells, fused_head=tag)
        (got * torch.from_numpy(co)).sum().backward()
        out[name] = (got.detach(), jax.tree.map(lambda t: t.grad, leaves))
    (got, grads), (fused, fused_grads) = out["mesh"], out["fused"]
    np.testing.assert_allclose(got.numpy(), fused.numpy(), rtol=1e-5, atol=1e-6)
    _assert_tree_close(grads, jax.tree.map(lambda t: t.numpy(), fused_grads), 1e-4, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    _assert_tree_close(grads, jgrads, 1e-4, 1e-5)


@pytest.mark.parametrize("scale", [0.3, 40.0], ids=["below", "above"])
def test_clipped_adam_matches_optax(scale):
    """Global norms below and above 1 (the clip's threshold), three steps."""
    rng = np.random.RandomState(3)
    params = {"a": {"w": rng.randn(3, 4).astype(np.float32)}, "b": rng.randn(5).astype(np.float32)}
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2))
    jp, js = jax.tree.map(jnp.asarray, params), opt.init(jax.tree.map(jnp.asarray, params))
    tp = _torch_tree(params)
    tadam = policy.ClippedAdam(1e-2)
    ts = tadam.init(tp)
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.randn(*a.shape) * scale / 4).astype(np.float32),
                             params)
        norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in jax.tree.leaves(grads))))
        assert (norm > 1.0) == (scale > 1.0)
        updates, js = opt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, updates)
        tp, ts = tadam.update(_torch_tree(grads), ts, tp)
    _assert_tree_close(tp, jp, 1e-5, 1e-7)
    adam = js[1][0]
    _assert_tree_close(ts["mu"], adam.mu, 1e-5, 1e-8)
    _assert_tree_close(ts["nu"], adam.nu, 1e-5, 1e-10)
    assert int(ts["count"]) == int(adam.count) == 3


def _replay(stream):
    """A draw method that returns the next array of ``stream`` as a tensor."""
    it = iter(stream)
    return lambda generator, shape: torch.from_numpy(np.array(next(it))).reshape(tuple(shape))


def _port_state(trainer, jstate):
    """The port's trainer state holding JAX's parameters, on a fresh stack."""
    gen = trainer.generator(0)
    state = trainer.init(gen, rules.LIFE)
    params = _torch_tree(jstate.params)
    return state._replace(params=params, opt_state=trainer.opt.init(params))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_reinforce_steps_match_jax(fused):
    """Five REINFORCE steps with JAX's uniforms replayed: the parameters and
    Adam's moments after each update, the EMA baseline and the reward trace."""
    cfg = dict(instances=4, **WIDE)
    jdef, tdef = _toggle_defs(+1.0)
    jt = jpolicy.PolicyTrainer(JEnvConfig(**cfg), [jdef], lr=0.02, entropy_beta=0.01,
                               fused_head=fused)
    tt = policy.PolicyTrainer(EnvConfig(**cfg), [tdef], lr=0.02, entropy_beta=0.01,
                              fused_head=fused, device="cpu")
    jstate = jt.init(jax.random.PRNGKey(1), jrules.LIFE)
    uniforms, key = [], jstate.key
    for _ in range(5):
        key, k_sample, _ = jax.random.split(key, 3)
        uniforms.append(jax.random.uniform(k_sample, (4, 256)))
    tt._uniform = _replay(uniforms)
    tstate = _port_state(tt, jstate)
    jtrace = []
    for _ in range(5):
        jstate, r = jt._step(jstate, None)
        jtrace.append(float(r))
    tstate, ttrace = tt.run(tstate, 5)
    np.testing.assert_allclose(ttrace.numpy(), jtrace, rtol=1e-5)
    np.testing.assert_allclose(float(tstate.baseline), float(jstate.baseline), rtol=1e-5)
    _assert_tree_close(tstate.params, jstate.params, 1e-4, 1e-6)
    adam = jstate.opt_state[1][0]
    _assert_tree_close(tstate.opt_state["mu"], adam.mu, 1e-4, 1e-7)
    _assert_tree_close(tstate.opt_state["nu"], adam.nu, 1e-4, 1e-9)
    assert int(tstate.opt_state["count"]) == 5


def test_ppo_minibatch_matches_jax():
    """One clipped-surrogate update on the same samples and indices: the
    port's grids reach its encoder as uint8."""
    cfg = dict(instances=4, **WIDE)
    jt = jpolicy.PPOTrainer(JEnvConfig(**cfg), [], fused_head=True)
    tt = policy.PPOTrainer(EnvConfig(**cfg), [], fused_head=True, device="cpu")
    params = jpolicy.init_policy_params(jax.random.PRNGKey(4), JEnvConfig(**cfg))
    rng = np.random.RandomState(5)
    grids = (rng.rand(16, 32, 64) < 0.3).astype(np.uint8)
    actions = rng.rand(16, 256) < 0.05
    logp_old = np.asarray(jnp.sum(-optax.sigmoid_binary_cross_entropy(
        jpolicy.policy_logits(params, jnp.asarray(grids, jnp.float32)[:, None], True),
        jnp.asarray(actions, jnp.float32)), axis=1)) + rng.randn(16).astype(np.float32) * 0.1
    adv = rng.randn(16).astype(np.float32)
    idx = np.array([3, 7, 0, 12, 9, 14, 1, 5])
    (jp, js), _ = jt._minibatch_update((params, jt.opt.init(params)), jnp.asarray(idx),
                                       jnp.asarray(grids), jnp.asarray(actions),
                                       jnp.asarray(adv), jnp.asarray(logp_old), 0.01)
    tp = _torch_tree(params)
    tp, ts = tt._minibatch_update(tp, tt.opt.init(tp), torch.from_numpy(idx),
                                  torch.from_numpy(grids), torch.from_numpy(actions),
                                  torch.from_numpy(adv), torch.from_numpy(logp_old), 0.01)
    _assert_tree_close(tp, jp, 1e-4, 1e-6)
    _assert_tree_close(ts["mu"], js[1][0].mu, 1e-4, 1e-7)


@pytest.mark.parametrize("gamma,fused", [(0.0, True), (0.9, False)],
                         ids=["immediate-fused", "discounted-plain"])
def test_ppo_iteration_matches_jax(gamma, fused):
    """A whole iteration (collect 8 steps of 4 instances, 2 epochs of 2
    minibatches) with JAX's uniforms and permutations replayed: the trace,
    the baseline and the parameters after the 4 updates.  With gamma > 0 the
    discounted returns centred per timestep are the credit."""
    cfg = dict(instances=4, **WIDE)
    jdef, tdef = _toggle_defs(+1.0)
    kw = dict(lr=0.02, entropy_beta=0.01, epochs=2, minibatches=2, gamma=gamma,
              fused_head=fused)
    jt = jpolicy.PPOTrainer(JEnvConfig(**cfg), [jdef], **kw)
    tt = policy.PPOTrainer(EnvConfig(**cfg), [tdef], device="cpu", **kw)
    jstate = jt.init(jax.random.PRNGKey(6), jrules.LIFE)
    tstate = _port_state(tt, jstate)
    uniforms, key = [], jstate.key
    for _ in range(8):
        key, k_sample, _ = jax.random.split(key, 3)
        uniforms.append(jax.random.uniform(k_sample, (4, 256)))
    _, k_perm = jax.random.split(key)
    perms = [jax.random.permutation(k, 32) for k in jax.random.split(k_perm, 2)]
    tt._uniform = _replay(uniforms)
    tt._permutation = lambda generator, n: torch.from_numpy(np.array(perms.pop(0)))
    jstate, jtrace = jt.run(jstate, horizon=8)
    tstate, ttrace = tt.run(tstate, 8)
    np.testing.assert_allclose(ttrace.numpy(), np.asarray(jtrace), rtol=1e-5)
    np.testing.assert_allclose(float(tstate.baseline), float(jstate.baseline), rtol=1e-5,
                               atol=1e-7)
    # through 4 Adam updates (Adam divides by the gradient's own scale)
    _assert_tree_close(tstate.params, jstate.params, 2e-3, 1e-6)
    assert int(tstate.opt_state["count"]) == 4


def test_ppo_credit_centres_discounted_returns():
    """_credit against the JAX package's reverse scan and per-timestep
    centring; one instance keeps the raw returns."""
    rewards = np.random.RandomState(7).rand(6, 3).astype(np.float32)

    def jcredit(r, inst):
        _, ret = jax.lax.scan(lambda c, x: (x + 0.8 * c, x + 0.8 * c), jnp.zeros_like(r[0]),
                              r, reverse=True)
        return ret - jnp.mean(ret, axis=1, keepdims=True) if inst > 1 else ret

    for inst in (3, 1):
        tt = policy.PPOTrainer(EnvConfig(instances=inst, **WIDE), [], gamma=0.8, device="cpu")
        got = tt._credit(torch.from_numpy(rewards[:, :inst]))
        np.testing.assert_allclose(got.numpy(), np.asarray(jcredit(rewards[:, :inst], inst)),
                                   rtol=1e-5, atol=1e-6)
    tt = policy.PPOTrainer(EnvConfig(instances=3, **WIDE), [], device="cpu")
    assert torch.equal(tt._credit(torch.from_numpy(rewards)), torch.from_numpy(rewards))


def test_ppo_rejects_fewer_samples_than_minibatches():
    tt = policy.PPOTrainer(EnvConfig(instances=2, **WIDE), [], minibatches=4, device="cpu")
    state = tt.init(tt.generator(0), rules.LIFE)
    with pytest.raises(ValueError, match="must be >= minibatches"):
        tt.run(state, 1)
    assert int(state.stack.env.step_num) == 0


def test_policy_learns_to_toggle_more():
    """With reward = +mean(action), REINFORCE on the fused encoder's twin
    pushes the toggle rate well above its ~5% init (test_policy.py's check)."""
    _, tdef = _toggle_defs(+1.0)
    tt = policy.PolicyTrainer(EnvConfig(height=32, width=32, action_height=8, action_width=8,
                                        instances=8), [tdef], lr=0.02, entropy_beta=0.01,
                              fused_head=True, device="cpu")
    state = tt.init(tt.generator(1), rules.LIFE)
    state, trace = tt.run(state, 300)
    trace = trace.numpy()
    assert np.isfinite(trace).all()
    assert trace[-20:].mean() > trace[:20].mean() + 0.1
    assert trace[-20:].mean() > 0.2
    action = tt.as_agent().apply(state.params, tt.generator(2), torch.zeros(8, 1, 32, 32))
    assert action.shape == (8, 1, 8, 8) and set(action.unique().tolist()) <= {0.0, 1.0}


def test_shipped_policy_equals_jax():
    jagent, jparams = jeval.load_shipped_policy()
    agent, params = teval.load_shipped_policy(device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), params))
    assert len(flat) == len(got) == 6
    for (path, want), g in zip(flat, got):
        assert g.dtype == np.float32 and np.array_equal(g, np.asarray(want)), path
    with open(teval.SHIPPED_POLICY, "rb") as a, open(jeval._HERE + "/policy_ppo.npz", "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match=".npz"):
        teval.load_shipped_policy("policy.pt", device="cpu")


def test_shipped_deterministic_policy_scores_like_jax():
    """The shipped parameters' deterministic agent (toggle where sigmoid(logit)
    > 0.04) over 2 rulesets x 8 steps of one 256² universe with Speed:
    evaluate_fused in both packages."""
    rules_ = [[[3], [2, 3]], [[3, 6, 8], [2, 4, 5]]]
    _, jparams = jeval.load_shipped_policy()
    _, params = teval.load_shipped_policy(device="cpu")
    jagent = jpolicy._policy_agent(JEnvConfig(), deterministic_rate=0.04)
    agent = policy._policy_agent(EnvConfig(), deterministic_rate=0.04)
    want, jtrace = jeval.evaluate_fused(Agent=(jagent, jparams), rules=rules_,
                                        wrappers=[[JSpeed, 1e-2, None]], steps=8,
                                        verbose=False)
    got, trace = teval.evaluate_fused(Agent=(agent, params), rules=rules_,
                                      wrappers=[[SpeedDetector, 1e-2, None]], steps=8,
                                      verbose=False, device="cpu")
    assert np.abs(np.asarray(jtrace)).max() > 0
    np.testing.assert_allclose(trace, np.asarray(jtrace), rtol=1e-4, atol=1e-5)
    assert got == pytest.approx(want, rel=1e-4)


def test_eval_cli_agent_policy():
    """--agent policy scores the shipped policy (fused and batched); it has
    no per-step shell, and random takes no parameters."""
    for extra in ([], ["--batched"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            teval.main(["--agent", "policy", "--steps", "2", "--device", "cpu", *extra])
        assert "mean evaluation score is" in out.getvalue()
    for bad in (["--agent", "policy", "--per-step"],
                ["--agent", "random", "--agent-params", "x.npz"]):
        with pytest.raises(SystemExit) as exc, contextlib.redirect_stderr(io.StringIO()):
            teval.main([*bad, "--steps", "2", "--device", "cpu"])
        assert exc.value.code == 2


@pytest.mark.parametrize("n", [16, 512])
def test_encoder_plan_at_the_policy_shapes(n):
    """The policy's encoder at the eval geometry (sampling 16 universes, a
    PPO minibatch of 16 x 128 / 4) takes the specialised route with plans
    that leave two blocks a multiprocessor."""
    assert ch.encoder_route(256, 256, (8, 1), (2, 2))
    for backward in (False, True):
        r2, tw, smem = ch._enc3_plan(n, 256, 256, 8, 1, 2, backward)
        assert r2 >= 1 and tw >= 1 and smem <= 113 * 1024
