"""carle_tpu_torch vs carle_tpu: env-batch data parallelism on one controller.

The port splits the instance batch over a mesh of 8 ``cpu`` slots
(``make_mesh([cpu] * 8, "env")``; ``shard_carry``: the universes as instance
shards, rings of one slot, everything else whole on the home device; the
nets a slot at a time over the instances, ``fused_head=mesh``) and is held
against ``carle_tpu`` on its 8-device CPU mesh (tests/conftest.py), as
tests/test_parallel.py and tests/test_drivers.py run it, and against the
port's ``mesh=None`` runs:

* the sharded RND2D rollout (test_parallel.py's case) and the placement of
  the grid, the rule bits and leaves whose inner dimension equals the
  instances (``env_sharding``, also on a 2 x 4 mesh: the env axis's extent);
* the six batch-axis routes: with dropout on against a loop over the slots
  seeded by ``spatial_heads._shard_seed``, on tensors and on instance
  shards; with dropout off their parameter gradients against ``mesh=None``;
* the master reset, batch-global across slots (uint8 and packed);
* ``train(mesh=)`` (test_drivers.py's case, the learners' dropout turned off
  by patching the defs ``train`` builds), with ``packed_state``, and
  ``resolve_mesh``; ``evaluate_fused_batched(mesh=)`` and its refusal;
  ``make_mesh()`` without CUDA.

Inputs and learner parameters come from numpy seeds, the learners' dropout
off on both sides.  Tolerances: grids bit for bit; rewards rtol 1e-6 / atol
1e-6 (test_parallel.py's bound); ``train``'s histories rtol 1e-5 / atol 1e-6
(test_drivers.py's); the battery's score rtol 1e-4; routes with dropout bit
for bit against the slot loop; gradients 1e-5 of each leaf's largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import carle_tpu.mcl as jmcl
from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu import rules as jrules
from carle_tpu.checkpoint import _path_str
from carle_tpu.env import env_step as jenv_step
from carle_tpu.env import init_state as jinit_state
from carle_tpu.parallel import env_sharding as jenv_sharding
from carle_tpu.parallel import make_mesh as jmake_mesh
from carle_tpu.parallel import shard_carry as jshard_carry
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch import EnvConfig, nets, rules, train_mcl
from carle_tpu_torch import mcl as tmcl
from carle_tpu_torch.checkpoint import learner_state_from_numpy
from carle_tpu_torch.evaluation import eval as teval
from carle_tpu_torch.ops.bitpack import pack_grid
from carle_tpu_torch.parallel import (PackedSpatialStack, RowShards, env_sharding, make_mesh,
                                      replicate, shard_carry)
from carle_tpu_torch.parallel.mesh import Mesh, env_layout, env_slots
from carle_tpu_torch.parallel.spatial_heads import _shard_seed
from carle_tpu_torch.rollout import Rollout


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")

CPU = torch.device("cpu")
CFG = EnvConfig(64, 64, 16, 16, 8)
JCFG = JEnvConfig(height=64, width=64, action_height=16, action_width=16, instances=8)
KW = dict(batch_size=4, dropout=False)


def _mesh():
    return make_mesh([CPU] * 8, "env")


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shared_learners(jcarry, carry, rng):
    """Both carries' learner states from numpy-drawn parameters
    (tests/test_torch_spatial.py's helper)."""
    jw, tw = [], []
    for js, ts in zip(jcarry.stack.wrappers, carry.stack.wrappers):
        if not hasattr(js, "params"):
            jw.append(js)
            tw.append(ts)
            continue
        flat = {k: (rng.randn(*v.shape).astype(np.float32) * 0.3
                    if k.startswith(("params/", "target_params/")) else v)
                for k, v in _flat_numpy(js).items()}
        leaves = jax.tree_util.tree_flatten_with_path(js)[0]
        jw.append(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(js),
            [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves]))
        tw.append(learner_state_from_numpy(flat, "cpu"))
    return (jcarry._replace(stack=jcarry.stack._replace(wrappers=tuple(jw))),
            carry._replace(stack=carry.stack._replace(wrappers=tuple(tw))))


# ---------------------------------------------------------------------------
# the sharded rollout and the placement (test_parallel.py's two cases)
# ---------------------------------------------------------------------------


def test_sharded_rollout_matches_jax_and_mesh_none():
    """RND2D (batch 4) over 8 steps of one numpy action stream: the port on 8
    cpu slots (the net a slot at a time over the instances, no gather)
    against carle_tpu's sharded run and the port's mesh=None run."""
    actions = (np.random.RandomState(5).rand(8, 8, 16, 16) < 0.2).astype(np.uint8)
    jro = JRollout(JCFG, [jmcl.rnd2d_def(JCFG, **KW)])
    jcarry = jro.init(jax.random.PRNGKey(0), jrules.LIFE)
    out = {}
    for name, mesh in (("mesh", _mesh()), ("none", None)):
        ro = Rollout(CFG, [tmcl.rnd2d_def(CFG, fused_head=mesh or False, **KW)], device="cpu")
        carry = ro.init(ro.generator(0), rules.LIFE)
        jc, carry = _shared_learners(jcarry, carry, np.random.RandomState(7))   # same draws
        if mesh is not None:
            carry = shard_carry(carry, mesh, CFG)
            grid = carry.stack.env.grid
            assert isinstance(grid, RowShards) and grid.env_axis == "env"
            assert [tuple(p.shape) for p in grid.parts] == [(1, 64, 64)] * 8
        carry, r = ro.run_actions(carry, torch.from_numpy(actions))
        assert [int(w.updates) for w in carry.stack.wrappers] == [2]
        out[name] = (r.numpy(), ro.stack.universe(carry.stack).numpy(), ro.stack.gathers)
    jc = jshard_carry(jc, jmake_mesh(axis_name="env"), JCFG)
    jc, jr = jro.run_actions(jc, jnp.asarray(actions))
    (r, grid, gathers), (r1, grid1, _) = out["mesh"], out["none"]
    np.testing.assert_array_equal(grid, np.asarray(jc.stack.env.grid))
    np.testing.assert_array_equal(grid, grid1)
    np.testing.assert_allclose(r, np.asarray(jr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r, r1, rtol=1e-6, atol=1e-6)
    assert gathers == 0   # the net reads the instance shards


def test_env_sharding_places_like_jax():
    """env_sharding's spec against carle_tpu's on the grid, the rule bits, a
    [8] statistic, leaves whose inner dimension equals the instances, a batch
    that does not divide, and on 2 x 4 meshes (the env axis's extent, not the
    slot count); shard_carry's layout."""
    jmesh = jmake_mesh(axis_name="env")
    jmesh2 = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("env", "space"))
    mesh, mesh2 = _mesh(), Mesh([[CPU] * 4] * 2, ("env", "space"))
    cases = [(np.zeros((8, 64, 64), np.uint8), 8), (np.int32(0), 8), (np.zeros(8), 8),
             (np.zeros((64, 8)), 8), (np.zeros((2, 8, 8)), 8), (np.zeros((6, 4)), 6),
             (np.zeros((3, 4)), 3)]
    for leaf, n in cases:
        for m, jm in ((mesh, jmesh), (mesh2, jmesh2)):
            want = tuple(jenv_sharding(jm, leaf, n).spec)
            got = env_sharding(m, torch.as_tensor(leaf), n)
            assert (got or ()) == want, (leaf.shape, n, m)
    ro = Rollout(CFG, [tmcl.speed_def(CFG, per_instance=True)], device="cpu")
    carry = shard_carry(ro.init(ro.generator(0), rules.LIFE), mesh, CFG)
    grid = carry.stack.env.grid
    assert grid.mesh is env_layout(mesh) and grid.mesh.shape == {"env": 8, "space": 1}
    assert env_slots(mesh2) == (CPU, CPU)
    assert all(isinstance(t, torch.Tensor) for t in (carry.stack.env.rule_bits,
                                                     carry.stack.wrappers[0].center_of_mass))
    whole = replicate(carry, mesh)
    assert torch.equal(whole.stack.env.grid, ro.stack.universe(carry.stack))
    with pytest.raises(ValueError, match="first axis"):
        env_layout(mesh2, "space")


# ---------------------------------------------------------------------------
# the six batch-axis routes
# ---------------------------------------------------------------------------


def _route_case(name, rng):
    """(function of (inputs, params, mesh, **dropout), inputs, params) of one
    route at small shapes: 8 instances, cells of 16 x 16."""
    cells = lambda c=1: torch.from_numpy((rng.rand(8, c, 16, 16) < 0.4).astype(np.uint8))
    floats = lambda c, h: torch.from_numpy(rng.rand(8, c, h, h).astype(np.float32))
    conv = lambda o, i: {"w": torch.from_numpy(rng.randn(o, i, 3, 3).astype(np.float32) * 0.4),
                         "b": torch.from_numpy(rng.randn(o).astype(np.float32) * 0.1)}
    deconv = lambda i, o: {"w": torch.from_numpy(rng.randn(i, o, 4, 4).astype(np.float32) * 0.4),
                           "b": torch.from_numpy(rng.randn(o).astype(np.float32) * 0.1)}
    if name == "head":
        return (lambda x, p, m, **d: nets.conv_head(x[0], p[0], pool=2, mesh=m, **d),
                [cells()], [conv(4, 1)])
    if name == "encoder":
        return (lambda x, p, m, **d: nets.conv_encoder(x[0], *p, pools=(4, 2), mesh=m, **d),
                [cells()], [conv(4, 1), conv(1, 4)])
    if name == "tail":
        return (lambda x, p, m, **d: nets.conv_tail(x[0], p[0], act="relu", mesh=m, **d),
                [floats(2, 8)], [deconv(2, 1)])
    if name == "loss_tail":
        return (lambda x, p, m, **d: nets.conv_loss_tail(x[0], p[0], x[1], act="sigmoid",
                                                         mesh=m, **d),
                [floats(1, 8), cells()], [deconv(1, 1)])
    if name == "decoder_loss":
        return (lambda x, p, m, **d: nets.conv_decoder_loss(x[0], *p, x[1], mesh=m, **d),
                [floats(2, 4), cells()], [deconv(2, 1), deconv(1, 1)])
    return (lambda x, p, m, **d: nets.conv_ae_loss(x[0], *p, x[1], pools=(2, 2), mesh=m, **d),
            [cells(), cells()], [conv(4, 1), conv(2, 4), deconv(2, 1), deconv(1, 1)])


ROUTES = ("head", "encoder", "tail", "loss_tail", "decoder_loss", "ae_loss")


def _as(inputs, kind, mesh):
    """The inputs as tensors or as instance shards on the mesh's layout."""
    if kind == "tensor":
        return inputs
    layout = env_layout(mesh)
    return [RowShards([x[s:s + 1] for s in range(8)], layout, "space", "env") for x in inputs]


@pytest.mark.parametrize("kind", ["tensor", "shards"])
@pytest.mark.parametrize("name", ROUTES)
def test_batch_route_matches_slot_loop_and_mesh_none(name, kind):
    """With dropout on, each slot's output is the unsharded function's on
    its instances seeded by _shard_seed (bit for bit); with dropout off the
    parameter gradients (and the input's, for the float inputs) equal
    mesh=None's within 1e-5 of each leaf's largest entry."""
    mesh, seed = _mesh(), 12345
    fn, inputs, params = _route_case(name, np.random.RandomState(ROUTES.index(name)))
    drop = dict(drop_p=0.1, train=True, seed=seed)
    got = nets.whole(fn(_as(inputs, kind, mesh), params, mesh, **drop))
    want = torch.cat([fn([x[s:s + 1] for x in inputs], params, None,
                         **dict(drop, seed=_shard_seed(seed, s))) for s in range(8)])
    assert torch.equal(got, want)
    assert not torch.equal(got, fn(inputs, params, None, **drop))   # the slots' own masks

    floats = [x.requires_grad_(True) for x in inputs if x.dtype == torch.float32]
    grads = {}
    for tag in ("mesh", "none"):
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()} for p in params]
        x = _as(inputs, kind, mesh) if tag == "mesh" else inputs
        out = nets.whole(fn(x, leaves, mesh if tag == "mesh" else None))
        cot = torch.from_numpy(np.random.RandomState(9).randn(*out.shape).astype(np.float32))
        flat = [v for p in leaves for v in p.values()] + (floats if kind == "tensor" else [])
        grads[tag] = torch.autograd.grad((out * cot).sum(), flat)
    for g, w in zip(*grads.values()):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), name


def test_routes_refuse_a_batch_that_does_not_divide():
    """The tag decides the route: 6 instances over 8 slots raise, naming both."""
    x = torch.zeros((6, 1, 16, 16), dtype=torch.uint8)
    p = {"w": torch.zeros((4, 1, 3, 3)), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match="6 instances does not divide over the 8 slots"):
        nets.conv_head(x, p, pool=2, mesh=_mesh())
    assert nets.check_mesh(_mesh()) is not None and nets.fused_route(_mesh()) is not None


# ---------------------------------------------------------------------------
# the master reset across slots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["uint8", "packed"])
def test_master_reset_is_batch_global_across_slots(packed):
    """Actions whose mean is 1.0 over the batch and 0.5 / 1.5 on every slot
    reset every universe; a slot whose action is all ones in a batch whose
    mean is not 1.0 resets nothing.  The sharded stack against mesh=None and
    carle_tpu's env_step, bit for bit."""
    rng = np.random.RandomState(11)
    acts = (rng.rand(5, 8, 16, 16) < 0.3).astype(np.float32)
    acts[2] = np.where(np.arange(8) < 4, 0.5, 1.5)[:, None, None]
    acts[3, 0] = 1.0
    jstate = jinit_state(JCFG)._replace(
        grid=jnp.asarray((rng.rand(8, 64, 64) < 0.3).astype(np.uint8)))
    grids = {}
    for name, mesh in (("mesh", _mesh()), ("none", None)):
        layout = None if mesh is None else env_layout(mesh)
        stack = (PackedSpatialStack(CFG, (), layout, "space", "env" if mesh else None)
                 if packed else None)
        ro = Rollout(CFG, device="cpu", stack=stack)
        carry = ro.init(ro.generator(0), rules.LIFE)
        start = torch.from_numpy(np.array(jstate.grid))
        carry = carry._replace(stack=carry.stack._replace(
            env=carry.stack.env._replace(grid=pack_grid(start) if packed else start)))
        if mesh is not None:
            carry = shard_carry(carry, mesh, CFG)
            assert isinstance(carry.stack.env.grid, RowShards)
        seen = []
        for a in acts:
            carry, _ = ro.run_actions(carry, torch.from_numpy(a[None]))
            seen.append(ro.stack.universe(carry.stack).numpy())
        grids[name] = np.stack(seen)
    want, state = [], jstate
    for a in acts:
        state, _ = jenv_step(state, jnp.asarray(a), config=JCFG)
        want.append(np.asarray(state.grid))
    np.testing.assert_array_equal(grids["mesh"], grids["none"])
    np.testing.assert_array_equal(grids["mesh"], np.stack(want))
    assert grids["mesh"][2].sum() == 0 and grids["mesh"][3].sum() > 0


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_train_mesh_matches_single_device(tmp_path, monkeypatch):
    """train on 8 cpu slots (test_drivers.py's case; the learners' dropout
    off in both runs) against mesh=None, and with packed_state against the
    uint8 mesh run."""
    monkeypatch.setattr(train_mcl, "rnd2d_def", functools.partial(tmcl.rnd2d_def,
                                                                  dropout=False))
    monkeypatch.setattr(train_mcl, "ae2d_def", functools.partial(tmcl.ae2d_def, dropout=False))
    kw = dict(instances=8, steps=[1, 6], rules=[[[3], [2, 3]]], height=64, width=64,
              batch_size=2, seed=0, device="cpu")
    single = train_mcl.train(log_dir=str(tmp_path / "single"), mesh=None, **kw)
    sharded = train_mcl.train(log_dir=str(tmp_path / "mesh"), mesh=_mesh(), **kw)
    packed = train_mcl.train(log_dir=str(tmp_path / "packed"), mesh=_mesh(),
                             packed_state=True, **kw)
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(packed, sharded)
    assert len(list((tmp_path / "mesh" / "models").glob("*.npz"))) == 2


def test_resolve_mesh():
    """train's mesh argument: a Mesh as given, auto off the card none, off
    none, on without CUDA raises (make_mesh), anything else ValueError."""
    mesh = _mesh()
    assert train_mcl.resolve_mesh(mesh, 8, "cpu") is mesh
    assert train_mcl.resolve_mesh("auto", 8, "cpu") is None
    assert train_mcl.resolve_mesh(False, 8) is None and train_mcl.resolve_mesh(None, 8) is None
    with pytest.raises(ValueError, match="mesh must be"):
        train_mcl.resolve_mesh("yes", 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="found none"):
            train_mcl.resolve_mesh(True, 8)


def test_evaluate_fused_batched_mesh_matches_single_device():
    """The battery (2 rulesets x 4 replicas, 4 steps, the shipped wrappers)
    on 8 cpu slots against mesh=None; 5 x 1 on 8 slots raises ValueError
    naming both figures."""
    kw = dict(rules=teval.DEFAULT_RULES[:2], replicas=4, steps=4, verbose=False,
              device="cpu")
    score, per_rule = teval.evaluate_fused_batched(mesh=_mesh(), **kw)
    score1, per_rule1 = teval.evaluate_fused_batched(**kw)
    np.testing.assert_allclose(per_rule, per_rule1, rtol=1e-4)
    np.testing.assert_allclose(score, score1, rtol=1e-4)
    with pytest.raises(ValueError, match="5 x 1 = 5 instances do not divide over the 8"):
        teval.evaluate_fused_batched(steps=1, verbose=False, device="cpu", mesh=_mesh())


def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: make_mesh() takes it")
    with pytest.raises(RuntimeError, match="found none"):
        make_mesh()


# ---------------------------------------------------------------------------
# the 64-bit batch-axis seeds
# ---------------------------------------------------------------------------


def _slot_outputs(seed):
    """The encoder with dropout 0.1 on the batch-axis route of 8 cpu slots, an
    instance a slot, at ``seed``: [8, ...], row s slot s's output."""
    rng = np.random.RandomState(13)
    x = torch.from_numpy((rng.rand(8, 1, 16, 16) < 0.5).astype(np.uint8))
    p1 = {"w": torch.from_numpy(rng.randn(4, 1, 3, 3).astype(np.float32)),
          "b": torch.from_numpy(rng.rand(4).astype(np.float32))}
    p2 = {"w": torch.from_numpy(rng.randn(1, 4, 3, 3).astype(np.float32)),
          "b": torch.from_numpy(rng.rand(1).astype(np.float32))}
    out = nets.conv_encoder(x, p1, p2, pools=(4, 2), drop_p=0.1, train=True, seed=seed,
                            mesh=_mesh())
    return x, p1, p2, out


def test_prediction_slot_masks_differ_from_ae2d():
    """Prediction's stream bit (1 << 58) survives a slot's seed: on every slot
    its kernel seed (stream + 2 seed + 1) draws another mask than AE2D's
    (2 seed + 1), as with mesh=None."""
    from carle_tpu_torch.mcl.prediction import SEED_STREAM_SHIFT

    step = (5 << 24) + 3   # a step's seed (rollout.py's drop_seed)
    ae = _slot_outputs(2 * step + 1)[3]
    pred = _slot_outputs((1 << SEED_STREAM_SHIFT) + 2 * step + 1)[3]
    for s in range(8):
        assert not torch.equal(pred[s], ae[s]), f"slot {s} draws AE2D's mask"


def test_train_seeds_128_apart_draw_different_masks():
    """Two runs whose seeds are 128 apart draw different masks on every slot
    at RND2D's first step (kernel seed 2 (drop_seed + 1))."""
    ro = Rollout(CFG, [], device="cpu")
    seeds = [2 * (ro.init(ro.generator(g), rules.LIFE).drop_seed + 1) for g in (3, 3 + 128)]
    a, b = (_slot_outputs(sd)[3] for sd in seeds)
    for s in range(8):
        assert not torch.equal(a[s], b[s]), f"slot {s} draws the same mask"


def test_slot_zero_draws_what_mesh_none_draws():
    """Slot 0 of the mesh draws the mask of mesh=None at the same seed (one
    whose high word is set): bit for bit."""
    seed = (1 << 58) + (77 << 25) + 11
    x, p1, p2, out = _slot_outputs(seed)
    alone = nets.conv_encoder(x[:1], p1, p2, pools=(4, 2), drop_p=0.1, train=True, seed=seed)
    assert torch.equal(out[:1], alone)
    assert [_shard_seed(seed, s) for s in (0, 1)] == [seed, seed + 0x3779B1]
