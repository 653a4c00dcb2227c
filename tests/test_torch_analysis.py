"""carle_tpu_torch vs carle_tpu: pattern analytics on the CPU.

``classify_pattern`` (block, blinker, glider, LWSS, the Gosper gun, a rule
case, died, aperiodic), ``population_curve``, ``extract_objects`` across
the torus seam, ``census`` and ``episode_report`` on a logged episode, the
analysis CLI, ``scripts/soup_search_torch.py --quick --device cpu`` and
``/classify`` on the port's server (through the ``rle`` branch): equal to
``carle_tpu``'s, integers and labels exactly, floats (speeds, the growth
slope, mean toggles) within rtol 1e-12.  Inputs are drawn from numpy seeds.
"""

import http.client
import json
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carle_tpu import CARLE as JCARLE, analysis as janalysis, rle as jrle, rules as jrules
from carle_tpu import serve as jserve
from carle_tpu.ops import bitpack as jbitpack

from carle_tpu_torch import CARLE, analysis, serve
from carle_tpu_torch.mcl.patterns import pattern_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _place(pattern, size=48, at=(20, 20)):
    g = np.zeros((size, size) if np.isscalar(size) else size, dtype=np.uint8)
    g[at[0]:at[0] + pattern.shape[0], at[1]:at[1] + pattern.shape[1]] = pattern
    return g


def _asset(name):
    return jrle.read_rle(pattern_path(name)).grid


R_PENTOMINO = np.array([[0, 1, 1], [1, 1, 0], [0, 1, 0]], np.uint8)

CASES = {
    "block": (_place(np.ones((2, 2), np.uint8)), jrules.LIFE, 64),
    "blinker": (_place(np.ones((1, 3), np.uint8)), jrules.LIFE, 64),
    "glider": (_place(_asset("glider_1")), jrules.LIFE, 64),
    "lwss": (_place(_asset("lwss")), jrules.LIFE, 64),
    "gosper_gun": (_place(_asset("gosper_gun"), size=(32, 64), at=(8, 8)), jrules.LIFE, 64),
    "bar_b2s0": (_place(np.ones((1, 3), np.uint8)), jrules.pack_rule_bits([2], [0]), 64),
    "died": (_place(np.ones((1, 1), np.uint8)), jrules.LIFE, 64),
    "empty": (np.zeros((16, 16), np.uint8), jrules.LIFE, 64),
    "aperiodic": (_place(R_PENTOMINO, size=64, at=(30, 30)), jrules.LIFE, 16),
    "odd_shape": (_place(_asset("glider_2"), size=(21, 27), at=(5, 5)), jrules.LIFE, 12),
    "horizon_0": (_place(np.ones((2, 2), np.uint8)), jrules.LIFE, 0),
}


def _same_classification(got, want):
    assert (got.kind, got.period, tuple(got.displacement), got.population) == \
        (want.kind, want.period, tuple(want.displacement), want.population)
    np.testing.assert_allclose(got.speed, want.speed, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_classify_pattern_matches_jax(case):
    grid, bits, horizon = CASES[case]
    want = janalysis.classify_pattern(grid, bits, max_period=horizon)
    got = analysis.classify_pattern(grid, bits, max_period=horizon, device="cpu")
    _same_classification(got, want)
    # a CPU tensor picks its own device
    _same_classification(analysis.classify_pattern(torch.from_numpy(grid), bits,
                                                   max_period=horizon), want)


def test_classify_expected_kinds():
    kinds = {c: analysis.classify_pattern(g, b, max_period=m, device="cpu").kind
             for c, (g, b, m) in CASES.items()}
    assert kinds["block"] == "still-life" and kinds["blinker"] == "oscillator"
    assert kinds["glider"] == kinds["lwss"] == "spaceship"
    assert kinds["died"] == kinds["empty"] == "died"
    assert kinds["aperiodic"] == kinds["horizon_0"] == "aperiodic"
    with pytest.raises(ValueError, match="one \\[H, W\\] grid"):
        analysis.classify_pattern(np.zeros((2, 8, 8), np.uint8), jrules.LIFE, device="cpu")


def test_population_curve_matches_jax():
    rng = np.random.RandomState(0)
    batch = (rng.rand(3, 40, 48) < 0.3).astype(np.uint8)
    bits = jrules.pack_rule_bits([3, 6], [2, 3])
    want = janalysis.population_curve(batch, bits, 20)
    got = analysis.population_curve(batch, bits, 20, device="cpu")
    assert got.shape == (20, 3) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    glider = _place(_asset("glider_1"))
    np.testing.assert_array_equal(analysis.population_curve(glider, jrules.LIFE, 12,
                                                            device="cpu"),
                                  janalysis.population_curve(glider, jrules.LIFE, 12))


def _seam_grid():
    g = np.zeros((40, 40), np.uint8)
    g[0, 10:13] = 1            # a blinker split by the top/bottom seam
    g[39, 11] = 1
    g[20, 38:40] = 1           # an object across the left/right seam
    g[21, 0:2] = 1
    g[10:12, 20:22] = 1        # a block
    glider = _asset("glider_1")
    g[28:28 + glider.shape[0], 20:20 + glider.shape[1]] = glider
    return g


def test_extract_objects_across_seam_match_jax():
    for g in (_seam_grid(), (np.random.RandomState(1).rand(48, 40) < 0.2).astype(np.uint8)):
        want = janalysis.extract_objects(g)
        got = analysis.extract_objects(torch.from_numpy(g))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(analysis.extract_objects(_seam_grid())) == 4


@pytest.mark.parametrize("seed,density,rule", [(2, 0.0, "B3/S23"), (3, 0.35, "B3/S23"),
                                               (4, 0.2, "B36/S23")])
def test_census_matches_jax(seed, density, rule):
    bits = jrules.pack_rule_bits(*jrules.parse_rulestring(rule))
    g = (np.random.RandomState(seed).rand(64, 64) < density).astype(np.uint8)
    g = np.asarray(jbitpack.unpack_grid(jbitpack.bit_multi_step(
        jbitpack.pack_grid(jnp.asarray(g[None])), jnp.asarray(bits), 48), 64))[0]
    want = janalysis.census(g, bits, max_period=16)
    got = analysis.census(g, bits, max_period=16, device="cpu")
    assert got["counts"] == want["counts"]
    assert len(got["objects"]) == len(want["objects"])
    for a, b in zip(got["objects"], want["objects"]):
        assert {k: v for k, v in a.items() if k != "speed"} == \
            {k: v for k, v in b.items() if k != "speed"}
        np.testing.assert_allclose(a["speed"], b["speed"], rtol=RTOL)


def test_census_seam_objects():
    rep = analysis.census(_seam_grid(), jrules.LIFE, device="cpu")
    assert rep == janalysis.census(_seam_grid(), jrules.LIFE)
    assert rep["counts"]["spaceship"] == 1 and rep["counts"]["still-life"] == 1


def _log_episode(env, tmp):
    env.reset()
    a = np.zeros((1, 1, 16, 16), dtype=np.float32)
    a[0, 0, 4, 5] = 1
    a[0, 0, 5, 5:7] = 1
    a[0, 0, 6, 4] = 1
    a[0, 0, 6, 6] = 1
    env.step(a)   # a glider placed (5 toggles)
    rng = np.random.RandomState(5)
    for i in range(9):
        env.step((rng.rand(1, 1, 16, 16) < 0.05).astype(np.float32) if i == 4
                 else np.zeros_like(a))
    return env.save_log(tmp)


def _same_report(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _same_report(got[k], v)
        elif isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=RTOL)
        else:
            assert got[k] == v, k


def test_episode_report_matches_jax(tmp_path):
    kw = dict(height=48, width=48, action_height=16, action_width=16, logging=True)
    path = _log_episode(CARLE(device="cpu", **kw), str(tmp_path))
    jpath = _log_episode(JCARLE(**kw), str(tmp_path / "jax"))
    for bits in (None, jrules.LIFE):
        want = janalysis.episode_report(jpath, bits, max_period=16)
        got = analysis.episode_report(path, bits, max_period=16, device="cpu")
        _same_report(got, want)
    assert got["steps"] == 10 and "final_pattern" in got
    empty = tmp_path / "empty.csv"
    empty.write_text("action,universe,\n")
    assert analysis.episode_report(str(empty), jrules.LIFE, device="cpu") == {"steps": 0}


def test_analysis_cli_matches_jax(tmp_path, capsys):
    universe = _seam_grid()
    path = tmp_path / "universe.rle"
    path.write_text(jrle.encode_grid(universe, [3], [2, 3]))
    log = _log_episode(CARLE(device="cpu", height=48, width=48, action_height=16,
                             action_width=16, logging=True), str(tmp_path))
    runs = {}
    for name, argv in (("glider", [pattern_path("glider_1")]),
                       ("rule", [pattern_path("lwss"), "--rule", "B36/S23"]),
                       ("census", [str(path), "--census", "--max-period", "16"]),
                       ("report", [log, "--report", "--max-period", "16"])):
        assert analysis._main(argv + ["--device", "cpu"]) == 0
        runs[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    glider = _asset("glider_1")
    box = np.zeros((32, 32), np.uint8)
    box[8:8 + glider.shape[0], 8:8 + glider.shape[1]] = glider
    c = janalysis.classify_pattern(box, jrules.LIFE, max_period=64)
    assert runs["glider"] == {"rule": "B3/S23", "kind": c.kind, "period": c.period,
                              "displacement": list(c.displacement), "speed": c.speed,
                              "population": c.population}
    assert runs["rule"]["rule"] == "B36/S23"
    assert runs["census"] == {"rule": "B3/S23",
                              **janalysis.census(universe, jrules.LIFE, max_period=16)}
    _same_report(runs["report"], janalysis.episode_report(log, jrules.LIFE, max_period=16))


def test_soup_search_quick_matches_jax(capsys):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import soup_search_torch
    finally:
        sys.path.pop(0)
    assert soup_search_torch.main(["--quick", "--device", "cpu"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == 9   # 8 soups + the aggregate
    agg = lines[-1]["soup_search"]
    assert agg["soups"] == 8 and sum(agg["object_counts"].values()) > 0
    # the same soups (the script's torch draw) through JAX's engine and census
    gen = torch.Generator().manual_seed(0)
    soups = (torch.rand((8, 64, 64), generator=gen) < 0.3).to(torch.uint8).numpy()
    finals = np.asarray(jbitpack.unpack_grid(jbitpack.bit_multi_step(
        jbitpack.pack_grid(jnp.asarray(soups)), jnp.asarray(jrules.LIFE), 64), 64))
    totals = {}
    for line, final in zip(lines[:-1], finals):
        rep = janalysis.census(final, jrules.LIFE, max_period=16)
        assert line["counts"] == rep["counts"]
        assert line["ash_density"] == round(float(final.sum()) / 4096, 5)
        for k, n in rep["counts"].items():
            totals[k] = totals.get(k, 0) + n
    assert agg["object_counts"] == totals


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


@pytest.mark.parametrize("body", [
    {"rle": "x = 3, y = 3, rule = B3/S23\nbo$2bo$3o!", "size": 32},
    {"rle": jrle.encode_grid(_seam_grid(), [3], [2, 3]), "size": 40, "census": True,
     "max_period": 16},
    {"rle": "x = 3, y = 1\n3o!", "size": 32, "rule": "B2/S0", "max_period": 8},
])
def test_classify_endpoint_matches_jax(server, body):
    status, got = _post(server, "/classify", body)
    assert status == 200, got
    want = jserve._classify(dict(body))
    got.pop("latency_s")
    want.pop("latency_s")
    assert got == want
