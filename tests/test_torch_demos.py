"""carle_tpu_torch's demo drivers on the CPU, at small step counts.

Every demo runs end to end and writes its files (.npy reward curves, PNG
frames, the episode GIF).  Each draws from torch generators where
``carle_tpu.demos`` draws from keys (PredictionBonus' and the learners'
initial weights, the random agent, MorphoBonus' nucleation noise on reset),
so none gives JAX's reward curve, and each is checked as
``tests/test_demos.py`` checks JAX's: shapes, finite values, a positive
morphology reward while the duck cruises, a GIF89a file with its frames.
``python -m carle_tpu_torch.demos`` runs through ``main``.
"""

import os

import numpy as np
import pytest
import torch

from carle_tpu_torch import demos


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_prediction_demo(tmp_path):
    total = demos.prediction_demo(str(tmp_path), predictable_steps=8, random_steps=4,
                                  device="cpu")
    curve = np.load(str(tmp_path / "prediction_demo_rewards.npy"))
    assert curve.shape == (12,) and np.isfinite(curve).all()
    np.testing.assert_allclose(total, curve.sum(), rtol=1e-5)
    assert os.path.exists(str(tmp_path / "prediction_demo_final.png"))


def test_wrapper_agent_demo(tmp_path):
    demos.wrapper_agent_demo(str(tmp_path), steps=3, device="cpu")
    for leg in ("pentadecathlon", "random"):
        for wrapper in ("AE2D", "RND2D"):
            for rules in ("life", "mouse_maze"):
                base = str(tmp_path / f"{leg}_{wrapper}_{rules}")
                curve = np.load(base + ".npy")
                assert curve.shape == (3,) and np.isfinite(curve).all()
                assert os.path.exists(base + "_final.png")


def test_morpho_spaceship_demo(tmp_path):
    demos.morpho_spaceship_demo(str(tmp_path), steps=4, device="cpu")
    base = str(tmp_path / "morpho_spaceship")
    curve = np.load(base + ".npy")
    assert curve.shape == (4,)
    # the duck is a Life spaceship: the morphology reward tracking it stays
    # positive while it cruises
    assert np.all(curve > 0)
    assert os.path.exists(base + "_final.png")


def test_episode_gif_demo_and_main(tmp_path, monkeypatch):
    path = demos.episode_gif_demo(str(tmp_path), steps=8, device="cpu")
    with open(path, "rb") as f:
        data = f.read()
    assert data[:6] == b"GIF89a"
    assert data.count(b"\x21\xf9\x04") == 4   # a frame every second of 8 steps
    # the __main__ driver calls the four demos with its outdir and device
    called = []
    names = ("prediction_demo", "wrapper_agent_demo", "morpho_spaceship_demo",
             "episode_gif_demo")
    for name in names:
        monkeypatch.setattr(demos, name, lambda outdir, *a, _name=name, device=None, **k:
                            called.append((_name, outdir, device)))
    demos.main([str(tmp_path / "out"), "--device", "cpu"])
    assert called == [(name, str(tmp_path / "out"), "cpu") for name in names]
