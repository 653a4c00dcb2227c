"""The six CUDA kernels of carle_tpu_torch against their plain twins.

These tests need an NVIDIA card and the CUDA toolkit; without a card they
skip.  They import neither JAX nor carle_tpu, so they also run where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Integer kernels must equal their twins exactly; float kernels agree within
rtol/atol 1e-4 (the twins run cuDNN in full float32, TF32 off, summing in
other orders); the AE error must also be bit-for-bit repeatable.  Gradients
agree within 1e-4 of each leaf's largest entry and are bit-for-bit repeatable;
with dropout the kernels and the twins draw the same Philox mask, or nothing
would agree.  The non-kernel checks at the end run everywhere.
"""

import numpy as np
import pytest
import torch

from carle_tpu_torch import EnvConfig, rules
from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_build, cuda_ca, cuda_head


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False       # the plain twins are the
    torch.backends.cuda.matmul.allow_tf32 = False  # reference: full float32
    return torch.device("cuda")


def _soup(seed, shape, density=0.35):
    return (np.random.RandomState(seed).rand(*shape) < density).astype(np.uint8)


def _params(rng, shapes):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(64, 64, 16, 16, 2), (23, 37, 8, 9, 3),
                                  (24, 40, 7, 12, 2), (256, 256, 64, 64, 16)])
def test_ca_step_kernel_matches_plain(cuda, geom):
    h, w, ah, aw, n = geom
    cfg = EnvConfig(h, w, ah, aw, n)
    rng = np.random.RandomState(h)
    grid = torch.from_numpy(_soup(h, cfg.grid_shape)).to(cuda)
    action = torch.from_numpy(
        rng.randint(0, 4, size=cfg.action_shape).astype(np.uint8)).to(cuda)
    for rule in (torch.tensor(rules.LIFE, dtype=torch.int32),
                 torch.from_numpy(rng.randint(0, 1 << 18, size=n).astype(np.int32))):
        rule = rule.to(cuda)
        before = cuda_ca.KERNEL.launches
        got = cuda_ca.ca_step(grid, action, rule, cfg)
        assert cuda_ca.KERNEL.launches == before + 1
        assert torch.equal(got, cuda_ca.ca_step_plain(grid, action, rule, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,nw", [(8, 256, 8), (2, 512, 16), (1, 1024, 32),
                                    (3, 16, 1)])
def test_bit_multi_step_kernel_matches_plain(cuda, n, h, nw):
    """Resident 256x256 and 512x512, the per-generation fallback at
    1024x1024, and a one-word universe."""
    rng = np.random.RandomState(n + h)
    packed = bitpack.pack_grid(torch.from_numpy(_soup(n + h, (n, h, 32 * nw)))).to(cuda)
    for rule in (torch.tensor(rules.LIFE, dtype=torch.int32),
                 torch.from_numpy(rng.randint(0, 1 << 18, size=n).astype(np.int32))):
        rule = rule.to(cuda)
        for steps in (0, 1, 5):
            got = cuda_bitpack.bit_multi_step(packed, rule, steps)
            want = cuda_bitpack.bit_multi_step_plain(packed, rule, steps)
            assert torch.equal(got.to(torch.int64), want.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("pools,c1,c2,shape", [
    ((4, 2), 4, 1, (16, 256, 256)),   # RND predictor
    ((4, 2), 2, 1, (5, 256, 256)),    # RND target
    ((2, 2), 4, 2, (16, 256, 256)),   # AE encoder
    ((2, 2), 4, 2, (3, 32, 64)),
    ((4, 2), 4, 1, (2, 40, 24)),
])
def test_encoder_kernel_matches_plain(cuda, pools, c1, c2, shape):
    n, h, w = shape
    rng = np.random.RandomState(n * h)
    x = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])]
    got = cuda_head.encoder_fwd(x, *ps, pools)
    torch.testing.assert_close(got, cuda_head.encoder_fwd_plain(x, *ps, pools),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 256, 256), (3, 32, 64), (2, 44, 20)])
def test_ae_loss_kernel_matches_plain(cuda, shape):
    n, h, w = shape
    rng = np.random.RandomState(n * h)
    x = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,),
                                            (2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])]
    got = cuda_head.ae_loss_fwd(x, *ps, x)
    assert torch.equal(got, cuda_head.ae_loss_fwd(x, *ps, x))  # fixed-order sums
    torch.testing.assert_close(got, cuda_head.ae_loss_fwd_plain(x, *ps, x),
                               rtol=1e-4, atol=1e-4)


def _assert_leaves_close(got, want, tol=1e-4):
    for a, b in zip(got, want):
        scale = float(b.abs().max()) or 1.0
        torch.testing.assert_close(a / scale, b / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("pools,c1,c2,shape", [
    ((4, 2), 4, 1, (8, 256, 256)),    # RND predictor
    ((2, 2), 4, 2, (8, 256, 256)),    # AE encoder
    ((2, 2), 5, 3, (3, 24, 40)),      # ragged bands, two Philox groups
    ((4, 4), 2, 2, (2, 80, 32)),
])
def test_encoder_dropout_and_backward_kernels_match_plain(cuda, pools, c1, c2, shape,
                                                          drop_p):
    n, h, w = shape
    rng = np.random.RandomState(n * h + c1)
    x = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    x[0, 0, : h // 2] = 0   # a blank band: whole pool windows tie
    ps = [p.to(cuda) for p in _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])]
    ps[1] = ps[1].abs()
    g = torch.from_numpy(rng.randn(n, c2, h // (pools[0] * pools[1]),
                                   w // (pools[0] * pools[1])).astype(np.float32)).to(cuda)
    seed = 1234567891011 + h
    got = cuda_head.encoder_fwd(x, *ps, pools, drop_p, seed)
    torch.testing.assert_close(got, cuda_head.encoder_fwd_plain(x, *ps, pools, drop_p, seed),
                               rtol=1e-4, atol=1e-4)
    before = cuda_head.ENCODER_BWD.launches
    grads = cuda_head.encoder_bwd(x, *ps, g, pools, drop_p, seed)
    assert cuda_head.ENCODER_BWD.launches == before + 1
    again = cuda_head.encoder_bwd(x, *ps, g, pools, drop_p, seed)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # fixed-order sums
    _assert_leaves_close(grads, cuda_head.encoder_bwd_plain(x, *ps, g, pools, drop_p, seed))
    # through autograd: the Function's backward is the kernel
    leaves = [p.clone().requires_grad_(True) for p in ps]
    out = cuda_head.encoder(x, *leaves, pools, drop_p, seed)
    auto = torch.autograd.grad((out * g).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(auto, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("shape,chans", [((8, 256, 256), (4, 2, 1, 1)),
                                         ((3, 24, 40), (4, 2, 1, 1)),
                                         ((2, 16, 48), (3, 2, 2, 2)),
                                         ((1, 72, 16), (5, 2, 1, 1))])
def test_ae_loss_dropout_and_backward_kernels_match_plain(cuda, shape, chans, drop_p):
    n, h, w = shape
    c1, c2, cm, co = chans
    rng = np.random.RandomState(n * h)
    src = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    src[0, 0, : h // 2] = 0
    obs = torch.from_numpy(_soup(n + 1, (n, co, h, w), 0.3)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,),
                                            (c2, cm, 4, 4), (cm,), (cm, co, 4, 4), (co,)])]
    ps[1] = ps[1].abs()
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    seed = 987654321012345 + w
    got = cuda_head.ae_loss_fwd(src, *ps, obs, (2, 2), drop_p, seed)
    torch.testing.assert_close(
        got, cuda_head.ae_loss_fwd_plain(src, *ps, obs, (2, 2), drop_p, seed),
        rtol=1e-4, atol=1e-4)
    grads = cuda_head.ae_loss_bwd(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    again = cuda_head.ae_loss_bwd(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    _assert_leaves_close(grads, cuda_head.ae_loss_bwd_plain(src, *ps, obs, gbar, (2, 2),
                                                           drop_p, seed))
    leaves = [p.clone().requires_grad_(True) for p in ps]
    err = cuda_head.ae_loss(src, *leaves, obs, (2, 2), drop_p, seed)
    auto = torch.autograd.grad((err * gbar).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(auto, grads))


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    cfg = EnvConfig(32, 32, 8, 8, 2)
    grid = torch.zeros(cfg.grid_shape, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        cuda_ca.ca_step(grid, torch.zeros(cfg.action_shape, device=cuda),
                        rules.LIFE, cfg)
    with pytest.raises(ValueError, match="uint8"):  # float cells: not the kernel's
        cuda_head.encoder_fwd(grid[:, None].float(), *[p.to(cuda) for p in _params(
            np.random.RandomState(0), [(4, 1, 3, 3), (4,), (1, 4, 3, 3), (1,)])], (4, 2))


def test_launch_table_covers_every_source():
    assert set(cuda_build.KERNELS) == set(cuda_build.SOURCES)
    for name in cuda_build.SOURCES:
        assert (cuda_build.CSRC / f"{name}.cu").exists()
        assert cuda_build.library_path(name).name.startswith(name + "-")


def test_counts_reset():
    cuda_build.KERNELS["ca_step"].launches = 3
    cuda_build.reset_launch_counts()
    assert set(cuda_build.launch_counts().values()) == {0}
