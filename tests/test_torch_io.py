"""carle_tpu_torch vs carle_tpu: pattern I/O and episode artifacts on the CPU.

Every comparison here is exact (byte for byte or bit for bit; no tolerance):
the RLE bodies of the native codec and its numpy twin against
``carle_tpu.rle.encode_grid`` and the decoders against the grids; the LZW
streams of the native encoder and ``_lzw_encode_py`` against
``carle_tpu.utils.gif._lzw_encode_py``; PNG and GIF files; the ``CARLE``
shell's CSV log, RLE and PNG files after the same replayed steps with a
master reset (the time-based ``exp_id`` pinned); ``Rollout.run_logged``'s
CSV and ``run_gif``'s GIF under an agent that draws nothing (4 universes of
64²); ``/gif`` on the port's server against ``carle_tpu.serve._gif``
through the ``rle`` branch; ``universe(state, instance)`` of the uint8 and
packed stacks against ``carle_tpu``'s.  A failed native build raises.
Inputs are drawn from numpy seeds.
"""

import base64
import http.client
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carle_tpu import CARLE as JCARLE, EnvConfig as JEnvConfig, rle as jrle, rules as jrules
from carle_tpu import serve as jserve
from carle_tpu.agents import Agent as JAgent
from carle_tpu.mcl.base import WrapperStack as JWrapperStack
from carle_tpu.ops import bitpack as jbitpack
from carle_tpu.parallel.packed_env import PackedSpatialStack as JPackedSpatialStack
from carle_tpu.rollout import Rollout as JRollout
from carle_tpu.utils import gif as jgif
from carle_tpu.utils import png as jpng

from carle_tpu_torch import CARLE, EnvConfig, native, rle, rules, serve
from carle_tpu_torch.agents import Agent, make_random_agent
from carle_tpu_torch.mcl import parsimony_def, speed_def
from carle_tpu_torch.mcl.base import WrapperStack
from carle_tpu_torch.ops import bitpack
from carle_tpu_torch.parallel.mesh import make_mesh, shard_rows
from carle_tpu_torch.parallel.packed_env import PackedSpatialStack
from carle_tpu_torch.rollout import Rollout
from carle_tpu_torch.utils import gif, png


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def pinned_clock(monkeypatch):
    """Both packages name their files by ``int(time.time())``: pin it."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def route(request, monkeypatch):
    """Each codec test runs on the native codec and on its twin."""
    monkeypatch.setattr(native, "NATIVE", request.param)
    return request.param


def _grid(seed, shape, p):
    return (np.random.RandomState(seed).rand(*shape) < p).astype(np.uint8)


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape,p", [(0, (1, 1), 0.5), (1, (7, 13), 0.5),
                                          (2, (64, 64), 0.02), (3, (50, 77), 0.3),
                                          (4, (256, 256), 0.3), (5, (33, 200), 0.97)])
def test_rle_bodies_match_jax(route, seed, shape, p):
    g = _grid(seed, shape, p)
    want = jrle.encode_grid(g, [3, 6], [2, 3], exp_id="9", step=4, torus=(300, 300))
    got = rle.encode_grid(g, [3, 6], [2, 3], exp_id="9", step=4, torus=(300, 300))
    assert got == want
    body = got.split("\n", 3)[3]
    np.testing.assert_array_equal(rle.decode_body(body, *shape), g)
    np.testing.assert_array_equal(rle.decode_body(body, *shape), jrle.decode_body(body, *shape))
    # clipped and padded decodes agree too
    for h, w in ((shape[0] + 3, shape[1] + 5), (max(1, shape[0] // 2), max(1, shape[1] // 2))):
        np.testing.assert_array_equal(rle.decode_body(body, h, w), jrle.decode_body(body, h, w))
    assert rle.parse_rle_text(got).grid.tolist() == jrle.parse_rle_text(want).grid.tolist()


def test_native_and_numpy_bodies_agree():
    g = _grid(6, (97, 131), 0.4)
    assert native.encode_body(g) == rle._encode_body_py(g)
    body = rle._encode_body_py(g, wrap=20)
    np.testing.assert_array_equal(native.decode_body(body, 97, 131),
                                  rle._decode_body_py(body, 97, 131))
    assert native.available() and native.gif_available()


@pytest.mark.parametrize("seed,n,nsym,mcs", [(0, 0, 2, 2), (1, 1, 2, 2), (2, 5000, 2, 2),
                                             (3, 20000, 4, 2), (4, 70000, 16, 4),
                                             (5, 9000, 256, 8)])
def test_lzw_matches_jax(seed, n, nsym, mcs):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, nsym, size=n).astype(np.uint8)
    if n > 1000:   # long runs too: the dictionary grows long codes and resets
        idx[n // 3: n // 2] = 0
    want = jgif._lzw_encode_py(idx, mcs)
    assert gif._lzw_encode_py(idx, mcs) == want
    assert native.lzw_encode(idx, mcs) == want


def test_png_and_gif_files_match_jax(route, tmp_path):
    g = _grid(7, (40, 56), 0.3)
    assert png.png_bytes(255 * g) == jpng.png_bytes(255 * g)
    rgb = np.random.RandomState(8).randint(0, 256, size=(9, 11, 3)).astype(np.uint8)
    assert png.png_bytes(rgb) == jpng.png_bytes(rgb)
    frames = np.stack([_grid(s, (40, 56), 0.3) for s in range(5)])
    frames[2, 3:9, 4:7] = 2
    for kw in ({}, {"fps": 7.0, "scale": 3, "loop": False}):
        assert gif.encode_gif(frames, **kw) == jgif.encode_gif(frames, **kw)
    path = gif.write_gif(str(tmp_path / "e.gif"), frames[0])
    with open(path, "rb") as f:
        assert f.read() == jgif.encode_gif(frames[0])


def test_palette_errors(route):
    frames = np.full((1, 4, 4), 4, dtype=np.uint8)   # the default palette has 4 colours
    with pytest.raises(ValueError, match="palette"):
        gif.encode_gif(frames)
    with pytest.raises(ValueError, match="palette index out of range"):
        native.lzw_encode(np.array([0, 1, 5], np.uint8), 2)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    (tmp_path / "rle_codec.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    with pytest.raises(RuntimeError, match="native build of rle_codec.cpp failed"):
        native.encode_body(np.ones((2, 2), np.uint8))
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_sources_are_the_ports_own():
    pkg = os.path.dirname(os.path.abspath(native.__file__))
    assert os.path.abspath(native.SRC) == pkg
    for name in ("rle_codec", "gif_lzw"):
        assert (native.SRC / f"{name}.cpp").exists()
        assert native.library_path(name).parent.name == "carle_tpu_torch_native"


# ---------------------------------------------------------------------------
# The CARLE shell's files
# ---------------------------------------------------------------------------

SHELL = dict(width=64, height=64, action_width=16, action_height=16)


def _shell_stream():
    acts = (np.random.RandomState(9).rand(12, 1, 1, 16, 16) < 0.2).astype(np.float32)
    acts[5] = 1.0        # the master reset: clears the universe and the log
    acts[7, 0, 0, :4, :4] = 2.0   # 2.0 toggles without resetting
    return acts


def _drive_shell(env, tmp):
    env.reset()
    env.rules_from_string("B36/S23")
    outs = {}
    for i, a in enumerate(_shell_stream()):
        env.step(a)
        if i == 3:
            outs["rle_mid"] = env.save_rle(env.get_rle(env.state.grid[0]), tmp)
    outs["rle"] = env.save_rle(env.get_rle(env.state.grid[0]), tmp)
    outs["action_rle"] = env.save_rle(env.get_rle(env.action, action=True),
                                      os.path.join(tmp, "a"))
    outs["frame"] = env.save_frame(tmp)
    outs["log"] = env.save_log(tmp)
    return outs


def test_shell_files_match_jax(tmp_path, pinned_clock):
    want = _drive_shell(JCARLE(logging=True, **SHELL), str(tmp_path / "jax"))
    env = CARLE(logging=True, device="cpu", **SHELL)
    got = _drive_shell(env, str(tmp_path / "torch"))
    assert len(env.log) == 6   # the steps after the master reset
    for k in want:
        assert os.path.basename(got[k]) == os.path.basename(want[k])
        with open(got[k], "rb") as f, open(want[k], "rb") as g:
            assert f.read() == g.read(), k
    assert env.read_csv(got["log"]) == JCARLE(**SHELL).read_csv(want["log"])
    # the RLE round trip and the pattern helpers
    env2 = CARLE(device="cpu", **SHELL)
    env2.load_universe(got["rle"])
    assert env2.birth == [3, 6] and torch.equal(env2.state.grid, env.state.grid)
    with pytest.raises(ValueError, match="wrong size"):
        CARLE(device="cpu", width=32, height=32, action_width=16,
              action_height=16).load_universe(got["rle"])
    body = env.read_rle(got["rle"])
    np.testing.assert_array_equal(env.rle_to_grid(body), JCARLE(**SHELL).rle_to_grid(body))
    np.testing.assert_array_equal(env.action_padding(env.action),
                                  JCARLE(**SHELL).action_padding(env.action))


def test_shell_logging_branch_and_master_reset():
    env = CARLE(logging=True, device="cpu", **SHELL)
    env.reset()
    a = np.zeros((1, 1, 16, 16), np.float32)
    a[0, 0, 4, 4:7] = 1
    env.step(a)
    env.step(a * 0)
    assert len(env.log) == 2
    first_action, first_universe = env.log[0]
    assert "(action)" in first_action and "3o" in first_action
    assert rle.parse_rle_text(first_universe).grid.sum() == 0   # before the step
    env.step(np.ones((1, 1, 16, 16), np.float32))
    assert env.log == [] and env.step_number == 0
    env.reset()
    assert env.log == []


def test_shell_main_sequence(tmp_path, capsys):
    from carle_tpu_torch.env import _main

    _main(["--device", "cpu", "--logs", str(tmp_path / "logs"),
           "--frames", str(tmp_path / "frames"), "--instances", "2"])
    logs = sorted(os.listdir(tmp_path / "logs"))
    assert [n.split("1")[0] for n in logs] == ["carle_log", "universe"]
    assert len(os.listdir(tmp_path / "frames")) == 1
    assert "CA updates per second with 2x vectorization" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Rollout.run_logged and run_gif
# ---------------------------------------------------------------------------

CFG = dict(height=64, width=64, action_height=16, action_width=16, instances=4)
MASK = (np.random.RandomState(10).rand(4, 1, 16, 16) < 0.1).astype(np.float32)


def _jax_mask_agent(cfg):
    """Toggles the dead cells under a fixed mask: a function of the
    observation alone, so both packages act alike."""
    top, left = cfg.action_row_offset, cfg.action_col_offset
    mask = jnp.asarray(MASK)

    def apply(params, key, obs):
        window = obs[:, :, top:top + 16, left:left + 16]
        return mask * (1.0 - window)

    return JAgent(init=lambda key: {}, apply=apply)


def _mask_agent(cfg):
    top, left = cfg.action_row_offset, cfg.action_col_offset
    mask = torch.from_numpy(MASK)

    def apply(params, generator, obs):
        window = obs[:, :, top:top + 16, left:left + 16]
        return mask * (1.0 - window)

    return Agent(init=lambda generator: {}, apply=apply)


def _seeded(grid_seed):
    return _grid(grid_seed, (4, 64, 64), 0.25)


def _runs(tmp_path, which, **kw):
    """(JAX's, the port's) output paths of ``which`` from the same seeded universes."""
    jcfg, cfg = JEnvConfig(**CFG), EnvConfig(**CFG)
    jro = JRollout(jcfg, agent=_jax_mask_agent(jcfg))
    jcarry = jro.init(jax.random.PRNGKey(0), jrules.pack_rule_bits([3, 6], [2, 3]))
    jcarry = jcarry._replace(stack=jcarry.stack._replace(
        env=jcarry.stack.env._replace(grid=jnp.asarray(_seeded(11)))))
    ro = Rollout(cfg, agent=_mask_agent(cfg), device="cpu")
    carry = ro.init(ro.generator(0), rules.pack_rule_bits([3, 6], [2, 3]))
    carry = carry._replace(stack=carry.stack._replace(
        env=carry.stack.env._replace(grid=torch.from_numpy(_seeded(11)))))
    if which == "logged":
        _, jrew, want = jro.run_logged(jcarry, directory=str(tmp_path / "jax"), **kw)
        _, rew, got = ro.run_logged(carry, directory=str(tmp_path / "torch"), **kw)
    else:
        _, jrew, want = jro.run_gif(jcarry, path=str(tmp_path / "jax.gif"), **kw)
        _, rew, got = ro.run_gif(carry, path=str(tmp_path / "torch.gif"), **kw)
    assert tuple(rew.shape) == tuple(np.shape(jrew)) == (kw["num_steps"], 4, 1)
    return want, got


@pytest.mark.parametrize("kw", [dict(num_steps=10, snapshot_every=4, instance=2,
                                     save_png=True)])
def test_run_logged_matches_jax(tmp_path, pinned_clock, kw):
    want, got = _runs(tmp_path, "logged", **kw)
    assert os.path.basename(got) == os.path.basename(want)
    with open(got, "rb") as f, open(want, "rb") as g:
        data = f.read()
        assert data == g.read()
    assert data.count(b"(action)") == 3   # steps 4, 8 and 10
    pngs = sorted(n for n in os.listdir(tmp_path / "jax") if n.endswith(".png"))
    assert pngs == sorted(n for n in os.listdir(tmp_path / "torch") if n.endswith(".png"))
    for n in pngs:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "torch" / n).read_bytes()


@pytest.mark.parametrize("kw", [dict(num_steps=9, chunk=4, every=2, instance=1),
                                dict(num_steps=6, chunk=6, every=1, mark_actions=False,
                                     scale=2)])
def test_run_gif_matches_jax(tmp_path, kw):
    want, got = _runs(tmp_path, "gif", **kw)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_logged_rewards_equal_run(tmp_path):
    """Logging only reads: run_logged and run_gif give run's rewards and
    carry from the same carry (a random agent, so the draws must match)."""
    cfg = EnvConfig(**CFG)
    ro = Rollout(cfg, wrappers=[speed_def(cfg), parsimony_def()],
                 agent=make_random_agent(16, 16, 0.2), device="cpu")

    def fresh():
        carry = ro.init(ro.generator(3), rules.LIFE)
        return ro.reset(carry)[0]

    c0, r0 = ro.run(fresh(), 12)
    c1, r1, _ = ro.run_logged(fresh(), 12, snapshot_every=5, directory=str(tmp_path))
    c2, r2, _ = ro.run_gif(fresh(), 12, path=str(tmp_path / "e.gif"), chunk=5)
    for c, r in ((c1, r1), (c2, r2)):
        assert torch.equal(r, r0)
        assert torch.equal(c.stack.env.grid, c0.stack.env.grid)
        assert c.drop_seed == c0.drop_seed


# ---------------------------------------------------------------------------
# WrapperStack.universe(state, instance)
# ---------------------------------------------------------------------------


def test_stack_universe_instance_matches_jax():
    cfg, jcfg = EnvConfig(**CFG), JEnvConfig(**CFG)
    g = _seeded(12)
    jst = JWrapperStack(jcfg)
    js = jst.init(jax.random.PRNGKey(0), jrules.LIFE)
    js = js._replace(env=js.env._replace(grid=jnp.asarray(g)))
    st = WrapperStack(cfg)
    s = st.init(torch.Generator().manual_seed(0), rules.LIFE, torch.device("cpu"))
    s = s._replace(env=s.env._replace(grid=torch.from_numpy(g)))
    jpk = JPackedSpatialStack(jcfg)
    jps = jpk.init(jax.random.PRNGKey(0), jrules.LIFE)
    jps = jps._replace(env=jps.env._replace(grid=jbitpack.pack_grid(jnp.asarray(g))))
    pk = PackedSpatialStack(cfg)
    ps = pk.init(torch.Generator().manual_seed(0), rules.LIFE, torch.device("cpu"))
    ps = ps._replace(env=ps.env._replace(grid=bitpack.pack_grid(torch.from_numpy(g))))
    mesh = make_mesh([torch.device("cpu")] * 4, "space")
    shards = s._replace(env=s.env._replace(grid=shard_rows(torch.from_numpy(g), mesh)))
    for i in (None, 0, 3):
        want = np.asarray(jst.universe(js, i))
        np.testing.assert_array_equal(np.asarray(jpk.universe(jps, i)), want)
        for got in (st.universe(s, i), pk.universe(ps, i), st.universe(shards, i)):
            np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# /gif and the index page
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    srv = serve.make_server("127.0.0.1", 0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, json.dumps(body))
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


GLIDER_RLE = "x = 3, y = 3, rule = B3/S23\nbo$2bo$3o!"


@pytest.mark.parametrize("body", [
    {"rle": GLIDER_RLE, "size": 40, "steps": 10, "every": 4},
    {"rle": GLIDER_RLE, "size": 64, "steps": 8, "every": 3, "rule": "B36/S23", "scale": 2,
     "fps": 5},
])
def test_gif_endpoint_matches_jax(server, body):
    status, got = _post(server, "/gif", body)
    assert status == 200, got
    want = jserve._gif(dict(body))
    for k in ("rule", "generations", "frames", "population", "gif_base64"):
        assert got[k] == want[k], k
    assert base64.b64decode(got["gif_base64"])[:6] == b"GIF89a"


def test_index_page_and_gif_errors(server):
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=60)
    conn.request("GET", "/")
    resp = conn.getresponse()
    page = resp.read().decode()
    assert resp.status == 200 and "/gif" in page and "/classify" in page
    status, err = _post(server, "/gif", {"size": 64, "steps": 4, "rule": "nonsense"})
    assert status == 400 and "error" in err
