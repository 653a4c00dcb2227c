"""carle_tpu_torch's outer surface against carle_tpu's, on the CPU.

* ``train``'s positional signature: arguments 1-20 are carle_tpu's, in its
  order (the reference's ``train(agent_fn, instances, steps, rules, mcl)``
  first), and the same positional call trains in both packages;
* the top level exports carle_tpu's names (and ``resolve_device``);
* the device-memory preflight (utils/preflight.py) through ``train``: a
  micro budget refuses before any segment, ``force_hbm`` completes, the
  default does not engage off the card, a roomy budget leaves the history
  bit for bit, and the price's parts; the CLI's flags;
* ``serialize=True`` on the uint8 and packed stacks: the history bit for
  bit the default's (carle_tpu's own case), the step context given
  back as given between wrappers;
* ``utils/profiling.py``: ``Throughput`` and ``trace`` (tests/test_utils.py's
  cases);
* the build directory (builddir.py): a read-only copy of the package builds
  its native codec into the user cache, or where the environment variable
  says, and the library's output equals the numpy codec's.
"""

import inspect
import json
import os
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

import carle_tpu
from carle_tpu import train_mcl as jtrain_mcl
from carle_tpu.agents import RandomAgent as JRandomAgent

import carle_tpu_torch
from carle_tpu_torch import builddir, rle, train_mcl
from carle_tpu_torch.agents import RandomAgent
from carle_tpu_torch.config import EnvConfig
from carle_tpu_torch.mcl import WrapperStack
from carle_tpu_torch.mcl.base import Lazy, StepCtx, WrapperDef, default_on_reset
from carle_tpu_torch.utils import preflight
from carle_tpu_torch.utils.profiling import TRACE_FILE, Throughput, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = [[[3], [2, 3]]]
KW = dict(instances=2, steps=[1, 8], rules=RULES, height=64, width=64, batch_size=4,
          seed=0, mesh=False, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# train's signature and the top level
# ---------------------------------------------------------------------------


def test_train_takes_jax_arguments_in_jax_order(tmp_path):
    """The positional call trains in both packages (the history's shape, its
    values finite); on the parent the fifth argument landed in ``height``."""
    jparams = list(inspect.signature(jtrain_mcl.train).parameters)
    params = inspect.signature(train_mcl.train).parameters
    assert list(params)[:20] == jparams[:20]
    assert params["serialize"].kind is params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert "launch_budget_s" not in params

    args = (2, (1, 4), RULES, None, 64, 64, 4, 0)
    want = jtrain_mcl.train(JRandomAgent, *args, str(tmp_path / "jax"), None, None, False)
    got = train_mcl.train(RandomAgent, *args, str(tmp_path / "port"), None, None, False,
                          device="cpu")
    assert got.shape == np.asarray(want).shape == (4,)
    assert np.isfinite(got).all() and np.isfinite(np.asarray(want)).all()
    # mcl is unused and fused_head selects nothing: the history is the same bits
    again = train_mcl.train(RandomAgent, *args[:3], ["RND2D", "AE2D"], *args[4:],
                            str(tmp_path / "again"), fused_head=True, mesh=False,
                            device="cpu")
    np.testing.assert_array_equal(again, got)


def test_top_level_exports_carle_tpus_names():
    assert set(carle_tpu_torch.__all__) == set(carle_tpu.__all__) | {"resolve_device"}
    for name in carle_tpu_torch.__all__:
        assert getattr(carle_tpu_torch, name) is not None, name
    assert carle_tpu_torch.__version__ == carle_tpu.__version__
    from carle_tpu_torch import Rollout, RolloutCarry  # noqa: F401  (the names import)


# ---------------------------------------------------------------------------
# The device-memory preflight
# ---------------------------------------------------------------------------


def test_preflight_refuses_over_budget_before_any_segment(tmp_path):
    with pytest.raises(preflight.HBMBudgetError) as exc:
        train_mcl.train(log_dir=str(tmp_path / "a"), hbm_budget_gib=1e-6, **KW)
    assert "force" in str(exc.value)
    analysis = exc.value.analysis
    assert analysis["peak_estimate_gib"] > 1e-6 and analysis["temp_measured"] is False
    assert analysis["temp_size_in_bytes"] == 0 and analysis["device"] == "cpu"
    models = tmp_path / "a" / "models"
    assert not models.is_dir() or not os.listdir(models)


def test_preflight_forced_completes(tmp_path, capsys):
    history = train_mcl.train(log_dir=str(tmp_path / "b"), hbm_budget_gib=1e-6,
                              force_hbm=True, **KW)
    assert history.shape == (8,)
    assert "Proceeding (forced)" in capsys.readouterr().out


def test_preflight_default_does_not_engage_on_the_cpu(tmp_path, capsys):
    carry = {"grid": torch.zeros(4, 8, 8, dtype=torch.uint8)}
    assert preflight.check_hbm_budget(lambda c: c, carry) is None
    history = train_mcl.train(log_dir=str(tmp_path / "c"), **KW)
    assert history.shape == (8,)
    assert "preflight" not in capsys.readouterr().out


def test_roomy_budget_leaves_the_history_bit_for_bit(tmp_path):
    plain = train_mcl.train(log_dir=str(tmp_path / "plain"), **KW)
    priced = train_mcl.train(log_dir=str(tmp_path / "priced"), hbm_budget_gib=64.0, **KW)
    np.testing.assert_array_equal(priced, plain)


@pytest.mark.parametrize("packed", [False, True], ids=["uint8", "packed"])
@pytest.mark.parametrize("mesh", [False, True], ids=["one-device", "mesh"])
def test_the_probe_runs_on_every_stack_and_leaves_the_run(tmp_path, monkeypatch, packed, mesh):
    """The card's pricing path on the CPU: the probe steps the slices' carries
    (the run's wrapper states on new universes, off the mesh) for uint8 and
    packed stacks, with and without a mesh of 4 cpu slots; the history is the
    unpriced run's, bit for bit."""
    from carle_tpu_torch.parallel.mesh import make_mesh

    steps = []

    def transient(fn, args, kwargs, device):
        carry = preflight.copy_tree(args)[0]
        assert isinstance(carry.stack.env.grid, torch.Tensor)   # off the mesh
        steps.append(int(carry.stack.env.grid.shape[0]))
        fn(carry, **kwargs)
        return 0, 0

    kw = dict(KW, instances=8, packed_state=packed,
              mesh=make_mesh([torch.device("cpu")] * 4, "env") if mesh else False)
    plain = train_mcl.train(log_dir=str(tmp_path / "plain"), **kw)
    monkeypatch.setattr(preflight, "_transient", transient)
    monkeypatch.setattr(preflight, "device_of", lambda tree: torch.device("cuda"))
    priced = train_mcl.train(log_dir=str(tmp_path / "priced"), hbm_budget_gib=64.0, **kw)
    assert steps == [2, 2, 4]   # the warm-up, then the two slices
    np.testing.assert_array_equal(priced, plain)


def test_price_counts_each_storage_once_and_cuts_per_instance_fields():
    from carle_tpu_torch.env import init_state

    cfg = EnvConfig(height=64, width=64, action_height=16, action_width=16, instances=4)
    state = init_state(cfg, 6152, "cpu")
    w = torch.zeros(10, 3)
    tree = {"env": state._replace(rule_bits=torch.arange(4, dtype=torch.int32)),
            "w": w, "view": w[2:], "gen": torch.Generator().manual_seed(3)}
    want = 4 * 64 * 64 + 4 * 4 + 120 + sum(t.untyped_storage().nbytes()
                                           for t in (state.step_num, state.steps_since_action))
    assert preflight.tensor_bytes(tree) == want
    cut = train_mcl.cut_instances(tree, 4, 2)
    assert tuple(cut["env"].grid.shape) == (2, 64, 64) and tuple(cut["env"].rule_bits.shape) == (2,)
    assert cut["w"] is w and cut["env"].step_num is state.step_num   # not declared per-instance
    copied = preflight.copy_tree(tree)
    assert copied["w"] is not w and torch.equal(copied["w"], w)
    assert torch.equal(copied["gen"].get_state(), tree["gen"].get_state())
    mem = preflight.price_program(lambda t: t, tree)
    assert mem["argument_size_in_bytes"] == want
    assert mem["peak_estimate_gib"] == want / 2 ** 30


def test_cli_takes_the_preflight_and_serialize_flags(tmp_path, capsys):
    argv = ["--device", "cpu", "--instances", "2", "--epochs", "1", "--steps-per-rule", "4",
            "--batch-size", "4", "--size", "64", "--mesh", "off", "--log-dir"]
    with pytest.raises(preflight.HBMBudgetError):
        train_mcl.main(argv + [str(tmp_path / "a"), "--hbm-budget-gib", "1e-6"])
    train_mcl.main(argv + [str(tmp_path / "b"), "--hbm-budget-gib", "1e-6", "--force",
                           "--serialize", "--fused-head"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["segments"] == 4


# ---------------------------------------------------------------------------
# serialize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["uint8", "packed"])
def test_serialize_is_the_default_bit_for_bit(tmp_path, packed):
    h_default = train_mcl.train(log_dir=str(tmp_path / "a"), packed_state=packed, **KW)
    h_serial = train_mcl.train(log_dir=str(tmp_path / "b"), packed_state=packed,
                               serialize=True, **KW)
    np.testing.assert_array_equal(h_serial, h_default)


def test_serialized_stack_gives_each_wrapper_the_context_as_given():
    """Each wrapper after the first sees the float observation recomputed,
    not the tensor the previous wrapper's read left in the context."""
    cfg = EnvConfig(height=64, width=64, action_height=16, action_width=16, instances=2)
    seen = []

    def spy(state, ctx, reward):
        seen.append(ctx.obs)
        return state, reward + ctx.obs.sum(dim=(1, 2, 3))[:, None]

    defs = [WrapperDef(f"spy{i}", lambda g, d: (), spy, default_on_reset) for i in range(2)]
    action = (torch.rand(2, 16, 16, generator=torch.Generator().manual_seed(1)) < 0.3)
    rewards = {}
    for serialize in (False, True):
        seen.clear()
        stack = WrapperStack(cfg, defs, serialize=serialize)
        state = stack.init(torch.Generator().manual_seed(0), 6152, torch.device("cpu"))
        _, _, rewards[serialize] = stack.transition(state, action.to(torch.uint8))
        assert torch.equal(seen[0], seen[1])
        assert (seen[0] is seen[1]) is not serialize
    assert torch.equal(rewards[True], rewards[False])

    ctx = StepCtx(obs_cells=Lazy(lambda: torch.ones(2, 1, 4, 4, dtype=torch.uint8)),
                  obs=Lazy(lambda cells: cells.to(torch.float32), "obs_cells"))
    assert ctx.obs.dtype == torch.float32 and ctx.obs_cells.dtype == torch.uint8
    assert isinstance(ctx.released()._values["obs"], Lazy)
    assert torch.equal(ctx.released().obs, ctx.obs)


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def test_throughput_counter():
    t = Throughput(instances=4, cells_per_instance=100)
    t.add(10)
    assert t.steps_per_second > 0
    assert abs(t.cell_updates_per_second / (t.steps_per_second * 100) - 1) < 0.5
    assert "steps / second" in t.report() and "cell updates/s" in t.report()
    assert "cell updates" not in Throughput(instances=2).report()


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with trace(str(d)) as prof:
        torch.ones((8, 8)).sum()
    files = [p for p in d.rglob("*") if p.is_file()]
    assert files == [d / TRACE_FILE]
    events = json.loads((d / TRACE_FILE).read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
    assert prof.key_averages()


# ---------------------------------------------------------------------------
# The build directory
# ---------------------------------------------------------------------------

BUILD_PROBE = r"""
import json, sys
import numpy as np
from carle_tpu_torch import native, rle

grid = (np.random.RandomState(5).rand(37, 53) < 0.4).astype(np.uint8)
body = native.encode_body(grid)
print(json.dumps({"lib": str(native.library_path("rle_codec")), "body": body,
                  "file": native.__file__}))
"""


def _read_only_copy(tmp_path):
    """The package copied into a directory that no one may write."""
    ro = tmp_path / "site"
    shutil.copytree(os.path.join(REPO, "carle_tpu_torch"), ro / "carle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path in [ro, *ro.rglob("*")]:
        mode = path.stat().st_mode
        path.chmod(mode & ~(stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH))
    return ro


def _build_in(tmp_path, ro, extra_env):
    env = {k: v for k, v in os.environ.items() if k != builddir.ENV_VAR}
    env.update(PYTHONPATH=str(ro), PYTHONDONTWRITEBYTECODE="1", **extra_env)
    out = subprocess.run([sys.executable, "-c", BUILD_PROBE], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _restore_writes(ro):
    for path in [ro, *ro.rglob("*")]:
        path.chmod(path.stat().st_mode | stat.S_IWUSR)


@pytest.mark.parametrize("chosen", ["cache", "variable"])
def test_read_only_package_builds_its_codec_elsewhere(tmp_path, chosen):
    ro = _read_only_copy(tmp_path)
    cache, custom = tmp_path / "cache", tmp_path / "custom"
    extra = {"XDG_CACHE_HOME": str(cache)}
    if chosen == "variable":
        extra[builddir.ENV_VAR] = str(custom)
    try:
        report = _build_in(tmp_path, ro, extra)
    finally:
        _restore_writes(ro)
    lib = report["lib"]
    assert report["file"].startswith(str(ro))
    root = cache / "carle_tpu_torch" if chosen == "cache" else custom
    assert lib.startswith(str(root / "carle_tpu_torch_native")) and os.path.isfile(lib)
    assert not (ro / "build").exists() and not list(ro.rglob("*.so"))
    grid = (np.random.RandomState(5).rand(37, 53) < 0.4).astype(np.uint8)
    assert report["body"] == rle._encode_body_py(grid)


def test_build_root_resolution(monkeypatch, tmp_path):
    """The variable first, then a writable checkout's build/, then the user
    cache; nothing is resolved at import."""
    from carle_tpu_torch import native
    from carle_tpu_torch.ops import cuda_build

    monkeypatch.delenv(builddir.ENV_VAR, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert native.BUILD_DIR is None and cuda_build.BUILD_DIR is None
    assert builddir.root() == builddir.CHECKOUT / "build"   # this checkout
    assert cuda_build.build_dir() == builddir.CHECKOUT / "build" / "carle_tpu_torch_kernels"
    monkeypatch.setattr(builddir, "_writable", lambda path: False)
    assert builddir.root() == tmp_path / "xdg" / "carle_tpu_torch"
    assert native.build_dir() == tmp_path / "xdg" / "carle_tpu_torch" / "carle_tpu_torch_native"
    monkeypatch.setenv(builddir.ENV_VAR, str(tmp_path / "mine"))
    assert cuda_build.library_path("ca_step").parent == (tmp_path / "mine"
                                                         / "carle_tpu_torch_kernels")
    monkeypatch.setattr(builddir, "CHECKOUT", tmp_path)   # no setup.py beside the package
    monkeypatch.delenv(builddir.ENV_VAR)
    monkeypatch.setattr(builddir, "_writable", lambda path: True)
    assert builddir.root() == tmp_path / "xdg" / "carle_tpu_torch"


# ---------------------------------------------------------------------------
# The supervisor (carle_tpu's own cases, for its scripts/train_supervisor.py)
# ---------------------------------------------------------------------------

SUPERVISOR = os.path.join("scripts", "train_supervisor_torch.py")


# the children train on one intra-op thread: the tier-1 run's workers share the cores
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _events(stdout):
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith('{"supervisor"')]


def test_supervisor_recovers_from_an_injected_kill(tmp_path):
    """The first child is killed once its progress file records 2 of the 8
    segments; the relaunch resumes past them and the run completes.  The
    kill is triggered by the recorded progress: the 6 segments after it
    outlast the supervisor's 0.05 s poll by far."""
    proc = subprocess.run(
        [sys.executable, SUPERVISOR, "--log-dir", str(tmp_path / "logs"),
         "--max-restarts", "3", "--backoff-seconds", "0.1", "--poll-seconds", "0.05",
         "--inject-kill-after-segments", "2",
         "--device", "cpu", "--instances", "2", "--epochs", "2", "--steps-per-rule", "16",
         "--batch-size", "8", "--size", "64", "--mesh", "off"],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=ONE_THREAD)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    events = _events(proc.stdout)
    kinds = [e["supervisor"] for e in events]
    assert "inject_kill" in kinds and "restart" in kinds
    done = events[-1]
    assert done["supervisor"] == "done" and done["restarts"] >= 1
    assert done["completed_segments"] == 8
    relaunch = [e for e in events if e["supervisor"] == "launch"][-1]
    assert relaunch["skip_segments"] >= 2


def test_supervisor_clears_stale_progress(tmp_path):
    log_dir = tmp_path / "logs"
    log_dir.mkdir()
    (log_dir / "progress.json").write_text(json.dumps({"completed_segments": 4}))
    tiny = ["--device", "cpu", "--instances", "2", "--epochs", "1", "--steps-per-rule", "4",
            "--batch-size", "4", "--size", "64", "--mesh", "off"]
    proc = subprocess.run([sys.executable, SUPERVISOR, "--log-dir", str(log_dir),
                           "--max-restarts", "0"] + tiny,
                          cwd=REPO, capture_output=True, text=True, timeout=600, env=ONE_THREAD)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    events = _events(proc.stdout)
    assert "cleared_stale_progress" in [e["supervisor"] for e in events]
    assert [e for e in events if e["supervisor"] == "launch"][0]["skip_segments"] == 0
    assert events[-1]["completed_segments"] == 4
    # --resume honours the (now complete) progress file: the child skips every segment
    proc2 = subprocess.run([sys.executable, SUPERVISOR, "--log-dir", str(log_dir),
                            "--max-restarts", "0", "--resume"] + tiny,
                           cwd=REPO, capture_output=True, text=True, timeout=600, env=ONE_THREAD)
    assert proc2.returncode == 0, proc2.stdout + proc2.stderr
    events2 = _events(proc2.stdout)
    assert events2[0]["supervisor"] == "launch" and events2[0]["skip_segments"] == 4
