"""The port's ResNet, head, weight converter and augmentation core held
against the JAX package on the CPU, in float32, with the same weights
(converted from Flax) and the same crop offsets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbalanced_regression_tpu.data.augment import normalize_only as j_normalize_only
from imbalanced_regression_tpu.data.augment import random_crop_flip_normalize as j_crop_flip
from imbalanced_regression_tpu.models import resnet as jresnet
from imbalanced_regression_tpu_torch.convert import from_flax
from imbalanced_regression_tpu_torch.data.augment import (
    crop_flip_normalize,
    normalize_only,
    random_crop_flip_normalize,
    to_unit_float,
)
from imbalanced_regression_tpu_torch.models.resnet import (
    RegressionHead,
    ResNetBackbone,
    resnet50_backbone,
)


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flax_tiny(rng, n=6, size=32):
    x = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    jb = jresnet.ResNetBackbone(stage_sizes=(1, 1), width=8, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jb.init(jax.random.key(1), jnp.asarray(x), train=False))
    # non-trivial BN parameters and running statistics, so that a swapped
    # scale/bias or mean/var would show
    r = np.random.default_rng(5)
    variables = jax.tree.map(lambda a: a + r.uniform(0.1, 0.5, a.shape).astype(np.float32)
                             if a.ndim == 1 else a, variables)
    return jb, variables, x


def test_converted_tiny_resnet_matches_flax(rng):
    jb, variables, x = _flax_tiny(rng)
    tb = ResNetBackbone(stage_sizes=(1, 1), width=8, dtype=torch.float32)
    sd = from_flax(variables)["backbone"]
    tb.load_state_dict(sd)  # strict: every name maps

    # eval: running statistics
    tb.eval()
    want = np.asarray(jb.apply(variables, jnp.asarray(x), train=False))
    got = tb(torch.as_tensor(x)).detach().numpy()
    # float32 convolutions summed in another order on each side: 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    # train: batch statistics, and the running statistics they update
    tb.train()
    want, updates = jb.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = tb(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    want_sd = from_flax({"params": variables["params"],
                         "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])})["backbone"]
    got_sd = tb.state_dict()
    for k, v in want_sd.items():
        if "running" in k:
            # Flax folds in the *biased* batch variance with momentum 0.9;
            # float32 reductions in another order: 1e-4
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_converted_head_matches_flax(rng):
    enc = rng.normal(size=(5, 16)).astype(np.float32)
    jh = jresnet.RegressionHead()
    hp = jax.tree.map(np.asarray, jh.init(jax.random.key(0), jnp.asarray(enc))["params"])
    th = RegressionHead(16)
    th.load_state_dict(from_flax(None, hp)["head"])
    want = np.asarray(jh.apply({"params": hp}, jnp.asarray(enc)))
    np.testing.assert_allclose(th(torch.as_tensor(enc)).detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_resnet50_param_count_and_init():
    bb = resnet50_backbone()
    assert sum(p.numel() for p in bb.parameters()) == 23_508_032  # PARITY row 10
    assert bb.out_features == 2048
    gen = torch.Generator().manual_seed(0)
    bb.reset_parameters(gen)
    # He-normal, fan-out: std sqrt(2 / (k*k*out)); 3% on ~37k-590k draws
    for conv in (bb.conv1, bb.layer3[0].conv2, bb.layer4[0].downsample[0]):
        o, _, kh, kw = conv.weight.shape
        assert abs(conv.weight.std().item() / np.sqrt(2.0 / (kh * kw * o)) - 1) < 0.03
    head = RegressionHead(2048)
    head.reset_parameters(gen)
    w = head.linear.weight
    # lecun normal: unit-variance truncated normal scaled to sqrt(1/fan_in),
    # cut at two of its own standard deviations
    std = np.sqrt(1 / 2048)
    assert abs(w.std().item() / std - 1) < 0.1
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7
    assert torch.count_nonzero(head.linear.bias) == 0


def test_bf16_backbone_keeps_f32_params(rng):
    bb = ResNetBackbone(stage_sizes=(1,), width=8, dtype=torch.bfloat16)
    x = torch.as_tensor(rng.normal(size=(4, 16, 16, 3)).astype(np.float32))
    out = bb(x)
    assert out.dtype == torch.float32 and out.shape == (4, 32)
    assert all(p.dtype == torch.float32 for p in bb.parameters())
    assert bb.layer1[0].bn1.running_var.dtype == torch.float32
    feats = ResNetBackbone(stage_sizes=(1, 1), width=8, return_features=True,
                           dtype=torch.float32)(x)
    assert [f.shape[1] for f in feats] == [32, 64]


def test_head_dropout_uses_generator(rng):
    head = RegressionHead(16, dropout=0.5)
    enc = torch.as_tensor(rng.normal(size=(8, 16)).astype(np.float32))
    a = head(enc, generator=torch.Generator().manual_seed(3))
    b = head(enc, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    head.eval()
    torch.testing.assert_close(head(enc), head.linear(enc), rtol=0, atol=0)


# --------------------------------------------------------------------- augment


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_augment_core_matches_jax(rng, dtype):
    n, h, w, pad = 6, 12, 10, 4
    if dtype == np.uint8:
        images = rng.integers(0, 256, size=(n, h, w, 3)).astype(np.uint8)
    else:
        images = rng.uniform(0, 1, size=(n, h, w, 3)).astype(np.float32)
    key = jax.random.key(7)
    want = np.asarray(j_crop_flip(key, jnp.asarray(images), padding=pad))
    # the offsets and flips the JAX function draws from this key
    ky, kx, kf = jax.random.split(key, 3)
    offs_y = np.array(jax.random.randint(ky, (n,), 0, 2 * pad + 1))
    offs_x = np.array(jax.random.randint(kx, (n,), 0, 2 * pad + 1))
    flips = np.array(jax.random.bernoulli(kf, 0.5, (n,)))
    assert flips.any() and not flips.all()
    got = crop_flip_normalize(torch.as_tensor(images), torch.as_tensor(offs_y),
                              torch.as_tensor(offs_x), torch.as_tensor(flips), padding=pad)
    # same float32 ops on the same pixels: bit-equal
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(normalize_only(torch.as_tensor(images)).numpy(),
                                  np.asarray(j_normalize_only(jnp.asarray(images))))


def test_random_augment_draws_from_generator(rng):
    images = torch.as_tensor(rng.integers(0, 256, size=(4, 8, 8, 3)).astype(np.uint8))
    a = random_crop_flip_normalize(images, torch.Generator().manual_seed(1), padding=2)
    b = random_crop_flip_normalize(images, torch.Generator().manual_seed(1), padding=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (4, 8, 8, 3) and a.dtype == torch.float32
    assert float(a.min()) >= -1.0 and float(a.max()) <= 1.0
    assert to_unit_float(images).max() <= 1.0
