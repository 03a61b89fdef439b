"""The port's NYUD2 slice held against the JAX package on the CPU: the depth
encoder-decoder and head from converted Flax weights (train and eval), the
channel knobs, bilinear upsampling against ``jax.image.resize``, the
photometric augment fed the JAX function's own draws, the per-pixel LDS
weights, the synthetic data, the depth metrics and per-epoch test, and the
``tasks/nyud2`` driver end to end on ``--device cpu`` at a tiny size.
Inputs are made with seeded numpy and handed to both sides."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbalanced_regression_tpu.data import nyud2 as jnyud2
from imbalanced_regression_tpu.models import depth_encdec as jdepth
from imbalanced_regression_tpu.ops.lds import prepare_weights_depth
from imbalanced_regression_tpu.tasks import nyud2 as jtask
from imbalanced_regression_tpu.utils.metrics import DepthEvaluator as JDepthEvaluator
from imbalanced_regression_tpu_torch.convert import depth_from_flax
from imbalanced_regression_tpu_torch.data import nyud2
from imbalanced_regression_tpu_torch.models.depth_encdec import (
    DepthEncoderDecoder,
    DepthHead,
    _resize_bilinear,
    depth_feature_dim,
)
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.tasks import nyud2 as task
from imbalanced_regression_tpu_torch.utils.metrics import DepthEvaluator

T = torch.as_tensor


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.cache
def _flax_depth(hw):
    """A tiny Flax DepthEncoderDecoder + DepthHead (stage sizes (1, 1, 1, 1),
    width 8, float32) at ``hw``, with non-trivial BN parameters and running
    statistics, so that a swapped scale/bias or mean/var would show."""
    x = np.random.default_rng(11).normal(size=(2, *hw, 3)).astype(np.float32)
    jm = jdepth.DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(x), train=False))
    r = np.random.default_rng(5)
    variables = jax.tree.map(lambda a: a + r.uniform(0.1, 0.5, a.shape).astype(np.float32)
                             if a.ndim == 1 else a, variables)
    jh = jdepth.DepthHead()
    feats = jm.apply(variables, jnp.asarray(x), train=False)
    hp = jax.tree.map(np.asarray, jh.init(jax.random.key(1), feats)["params"])
    return jm, jh, variables, hp, x


def _scaled_close(got, want, rtol):
    """Within ``rtol`` of the largest magnitude: the maps run through ten
    float32 convolutions summed in another order on each side."""
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


# 64x96; and 60x76, where the encoder's stages are 15x19, 8x10, 4x5 and
# 2x3: strided convs and the max pool on odd maps, where the port's
# symmetric k // 2 padding must match Flax's, and decoder upsamplings at
# non-integer ratios
@pytest.mark.parametrize("hw", [(64, 96), (60, 76)])
@pytest.mark.parametrize("train", [False, True])
def test_converted_depth_model_matches_flax(train, hw):
    jm, jh, variables, hp, x = _flax_depth(hw)
    tm = DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8, dtype=torch.float32)
    th = DepthHead(tm.out_features)
    sd = depth_from_flax(variables, hp)
    tm.load_state_dict(sd["backbone"])  # strict: every name maps
    th.load_state_dict(sd["head"])
    tm.train(train)
    if train:
        want, updates = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x), train=False)
    want_pred = np.asarray(jh.apply({"params": hp}, want))
    with torch.no_grad():
        hook = tm(T(x))
        pred = th(hook)
    # the hook is an NHWC float32 view of the channels_last map: contiguous
    assert hook.shape == want.shape == (2, hw[0] // 2, hw[1] // 2, 72)
    assert hook.dtype == torch.float32
    assert hook.is_contiguous()
    # train mode normalizes with batch statistics, over as few as 12 values
    # a channel (the 2x3 stage-4 maps of 2 images), which amplify rounding
    tol = 1e-4 if train else 1e-5
    _scaled_close(hook.numpy(), np.asarray(want), tol)
    _scaled_close(pred.numpy(), want_pred, tol)
    if train:
        want_sd = depth_from_flax({"params": variables["params"],
                                   "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])})
        got_sd = tm.state_dict()
        for k, v in want_sd["backbone"].items():
            if "running" in k:
                # Flax folds in the biased batch variance with momentum 0.9
                np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=k)


@pytest.mark.parametrize("mff,dmin", [(16, 0), (32, 0), (16, 24), (32, 24)])
def test_channel_knobs_match_jax(mff, dmin):
    """The hook width follows the knobs as in the JAX model
    (``test_nyud2.py:40-51``) and as ``depth_feature_dim`` says."""
    x = np.zeros((1, 64, 96, 3), np.float32)
    jm = jdepth.DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8, mff_features=mff,
                                    decoder_min_features=dmin, dtype=jnp.float32)
    want = jax.eval_shape(lambda a: jm.init_with_output(jax.random.key(0), a, train=False)[0],
                          jnp.asarray(x))
    tm = DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8, mff_features=mff,
                             decoder_min_features=dmin, dtype=torch.float32).eval()
    with torch.no_grad():
        got = tm(T(x))
    assert got.shape == want.shape == (1, 32, 48, depth_feature_dim(8 * 32, mff, dmin))
    assert tm.out_features == got.shape[-1]
    assert depth_feature_dim(2048) == jdepth.depth_feature_dim(2048) == 128


@pytest.mark.parametrize("src,dst", [((8, 10), (15, 19)), ((8, 10), (16, 20)), ((57, 76), (114, 152))])
def test_bilinear_upsample_matches_jax_resize(rng, src, dst):
    """The port's float32 resize against ``jax.image.resize(bilinear)``
    (the same as ``F.interpolate(bilinear, align_corners=False)`` when
    upsampling), at non-integer ratios too
    (the encoder's odd stage sizes at 228x304: 57x76 → 29x38 → 15x19 → 8x10)."""
    x = rng.normal(size=(2, *src, 5)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 5), method="bilinear"))
    got = _resize_bilinear(T(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1).numpy()
    # the same two-tap weights, computed in another order: float32 rounding
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


RESIZES = [((8, 10), (15, 19)), ((8, 10), (16, 20)), ((57, 76), (114, 152))]


def _bf16(rng, shape):
    """Normal values rounded to bf16, as float32 numpy (exact in both)."""
    return np.array(jnp.asarray(rng.normal(size=shape), jnp.bfloat16).astype(jnp.float32))


def _bf16_close(got, want):
    """Within 2**-7 of the largest magnitude: both sides resize in bf16 with
    float32 accumulation, but round the weights, the intermediate map and
    the output at other places (a bf16 rounding is 2**-9 of the value)."""
    _scaled_close(got, want, 2.0**-7)


@pytest.mark.parametrize("src,dst", RESIZES)
def test_bf16_resize_matches_jax_resize(rng, src, dst):
    """A bf16 map is resized in bf16, against ``jax.image.resize`` on the
    same bf16 map (the JAX model's ``_resize_bilinear``)."""
    x = _bf16(rng, (2, *src, 5))
    want = jdepth._resize_bilinear(jnp.asarray(x, jnp.bfloat16), *dst)
    got = _resize_bilinear(T(x).to(torch.bfloat16).permute(0, 3, 1, 2), dst)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    _bf16_close(got.permute(0, 2, 3, 1).float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("src,dst", RESIZES)
def test_bf16_resize_gradient_matches_jax_vjp(rng, src, dst):
    """The gradient of the bf16 resize in the map, against ``jax.vjp`` of the
    JAX resize, for the same bf16 map and cotangent."""
    x, g = _bf16(rng, (2, *src, 5)), _bf16(rng, (2, *dst, 5))
    _, vjp = jax.vjp(lambda a: jdepth._resize_bilinear(a, *dst), jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = T(x).to(torch.bfloat16).permute(0, 3, 1, 2).requires_grad_(True)
    _resize_bilinear(xt, dst).backward(T(g).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert xt.grad.dtype == torch.bfloat16
    _bf16_close(xt.grad.permute(0, 2, 3, 1).float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_keeps_dtype_with_autocast_off(rng, monkeypatch, dtype):
    """Under bf16 autocast the resize returns its input's dtype, and every
    product inside it runs with autocast off (a spy on ``torch.matmul``)."""
    seen = []
    matmul = torch.matmul

    def spy(a, b):
        seen.append((torch.is_autocast_enabled("cpu"), a.dtype, b.dtype))
        return matmul(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    x = T(rng.normal(size=(2, 3, 8, 10)).astype(np.float32)).to(dtype)
    with torch.autocast(device_type="cpu", dtype=torch.bfloat16):
        y = _resize_bilinear(x, (15, 19))
        assert torch.is_autocast_enabled("cpu")
    assert y.dtype == dtype and y.shape == (2, 3, 15, 19)
    assert seen == [(False, dtype, dtype)] * 2


def test_encoder_stage_sizes_at_reference_crop():
    """At 228x304 the encoder's stages are 57x76, 29x38, 15x19, 8x10 (the
    port's symmetric k // 2 padding matches the JAX padding=1 on odd maps),
    and the hook is at 114x152."""
    tm = DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=4, mff_features=2,
                             dtype=torch.float32).eval()
    x = torch.zeros(1, 228, 304, 3)
    with torch.no_grad():
        stages = tm.encoder(x)
        hook = tm(x)
    assert [tuple(s.shape[2:]) for s in stages] == [(57, 76), (29, 38), (15, 19), (8, 10)]
    assert hook.shape == (1, 114, 152, depth_feature_dim(4 * 32, 2))
    jm = jdepth.DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=4, mff_features=2,
                                    dtype=jnp.float32)
    want = jax.eval_shape(lambda a: jm.init_with_output(jax.random.key(0), a, train=False)[0],
                          jnp.zeros((1, 228, 304, 3)))
    assert want.shape == hook.shape


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_photometric_core_matches_jax(rng, dtype):
    n = 4
    if dtype == np.uint8:
        images = rng.integers(0, 256, size=(n, 12, 10, 3)).astype(np.uint8)
    else:
        images = rng.uniform(0, 1, size=(n, 12, 10, 3)).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jnyud2.nyud2_train_photometric(key, jnp.asarray(images)))
    # the draws the JAX function makes from this key (data/nyud2.py:73-87)
    r_light, r_b, r_c, r_s = jax.random.split(key, 4)
    alpha = np.array(jax.random.normal(r_light, (n, 3)) * 0.1)
    factors = [np.array(jax.random.uniform(r, (n, 1, 1, 1), minval=0.6, maxval=1.4))
               for r in (r_b, r_c, r_s)]
    got = nyud2.photometric(T(images), T(alpha), *map(T, factors)).numpy()
    # the same float32 formula; the 3-channel dots and the per-image mean
    # are summed in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_photometric_draws_and_normalize(rng):
    images = T(rng.integers(0, 256, size=(4, 8, 8, 3)).astype(np.uint8))
    a = nyud2.nyud2_train_photometric(images, torch.Generator().manual_seed(1))
    b = nyud2.nyud2_train_photometric(images, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (4, 8, 8, 3) and a.dtype == torch.float32 and torch.isfinite(a).all()
    assert not torch.equal(a, nyud2.imagenet_normalize(images))
    # the eval transform: the same float32 ops as the JAX one
    np.testing.assert_allclose(nyud2.imagenet_normalize(images).numpy(),
                               np.asarray(jnyud2.imagenet_normalize(jnp.asarray(images.numpy()))),
                               rtol=1e-6, atol=1e-6)


def test_pixel_weight_fn_matches_jax(rng):
    weights = prepare_weights_depth(nyud2.TRAIN_BUCKET_NUM, "inverse", lds=True)
    depth = rng.uniform(0.0, 12.0, size=(2, 6, 8, 1)).astype(np.float32)
    depth[0, 0, :4, 0] = [0.75, 2.0, 9.99, 10.0]
    want = np.asarray(jnyud2.make_pixel_weight_fn(weights)({"target": jnp.asarray(depth)}))
    got = nyud2.make_pixel_weight_fn(weights)({"target": T(depth)}).numpy()
    np.testing.assert_array_equal(got, want)  # a table lookup: bit-equal
    assert nyud2.TRAIN_BUCKET_NUM == jnyud2.TRAIN_BUCKET_NUM
    assert nyud2.make_pixel_weight_fn(None) is None


@pytest.mark.parametrize("img_hw,depth_hw", [((64, 96), (32, 48)), ((228, 304), (114, 152))])
def test_synthetic_depth_dataset_matches_jax(img_hw, depth_hw):
    got = nyud2.synthetic_depth_dataset(3, img_hw=img_hw, depth_hw=depth_hw, seed=2)
    want = jnyud2.synthetic_depth_dataset(3, img_hw=img_hw, depth_hw=depth_hw, seed=2)
    for k in ("input", "target"):
        np.testing.assert_array_equal(got[k], want[k])  # the same numpy code
    assert got["input"].shape == (3, *img_hw, 3) and got["target"].shape == (3, *depth_hw, 1)


@pytest.mark.parametrize("train", [True, False])
def test_load_nyud2_split_matches_jax(tmp_path, rng, train):
    """The real-data loader (CSV of image/depth paths, PIL geometry) against
    the JAX one on generated 640x480 files: 8-bit train depth, 16-bit test
    depth, a balanced mask for the test split."""
    from PIL import Image

    rows = []
    for i in range(3):
        img = rng.integers(0, 256, size=(480, 640, 3)).astype(np.uint8)
        dep = (rng.integers(0, 256, size=(480, 640)).astype(np.uint8) if train
               else rng.integers(500, 10000, size=(480, 640)).astype(np.uint16))
        Image.fromarray(img).save(tmp_path / f"rgb{i}.jpg")
        Image.fromarray(dep).save(tmp_path / f"depth{i}.png")
        rows.append(f"data/rgb{i}.jpg,data/depth{i}.png")
    (tmp_path / "split.csv").write_text("\n".join(rows) + "\n")
    mask = None
    if not train:
        mask = "mask.npy"
        np.save(tmp_path / mask, rng.random((3, 228, 304)) > 0.5)
    got = nyud2.load_nyud2_split(str(tmp_path), "split.csv", train=train, mask_file=mask, limit=2)
    want = jnyud2.load_nyud2_split(str(tmp_path), "split.csv", train=train, mask_file=mask,
                                   limit=2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])  # the same numpy/PIL code
    depth_hw = nyud2.DEPTH_HW if train else nyud2.IMG_HW
    assert got["input"].shape == (2, *nyud2.IMG_HW, 3) and got["target"].shape == (2, *depth_hw, 1)


class _FixedPredictor:
    """Stands in for either trainer in ``test_epoch``: predicts a fixed
    function of the batch's images at half the depth resolution."""

    def predict_batch(self, state, batch, count):
        img = np.asarray(batch["input"], np.float32)[:count, ::4, ::4, :1]
        return 0.5 + img / 40.0


def test_test_epoch_matches_jax(rng):
    """Upsampling to the depth resolution and the balanced per-pixel mask,
    over a padded last batch, against the JAX ``test_epoch``."""
    data = jnyud2.synthetic_depth_dataset(5, img_hw=(32, 48), depth_hw=(16, 24), seed=4)
    data["target"][0, :2] = np.nan  # NaN depths are excluded from every metric
    data["mask"] = rng.random((5, 16, 24)) > 0.3
    want = jtask.test_epoch(_FixedPredictor(), None, dict(data), 2)
    got = task.test_epoch(_FixedPredictor(), None, dict(data), 2)
    for shot in ("overall", "many", "medium", "few"):
        for k, v in want[shot].items():
            # float64 metrics of predictions upsampled in float32 by each side
            np.testing.assert_allclose(got[shot][k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{shot} {k}")
    assert got["overall"]["NUM"] > 0


def test_depth_evaluator_matches_jax(rng):
    pred = rng.uniform(0.5, 10.0, size=(3, 8, 8, 1)).astype(np.float32)
    depth = rng.uniform(0.5, 10.0, size=(3, 8, 8, 1)).astype(np.float32)
    depth[0, 0, 0, 0] = np.nan
    mask = rng.random((3, 8, 8, 1)) > 0.4
    got, want = DepthEvaluator(), JDepthEvaluator()
    for ev in (got, want):
        ev(pred[mask], depth[mask])
        ev(pred[:1], depth[:1])
    g, w = got.evaluate_shot(), want.evaluate_shot()
    for shot in w:
        for k, v in w[shot].items():
            np.testing.assert_array_equal(g[shot][k], v)  # the same numpy code


# ----------------------------------------------------------------------- driver


def _config(tmp_path, **kw):
    base = dict(device="cpu", synthetic_size=24, batch_size=8,
                test_batch_size=8, epoch=3, store_root=str(tmp_path), lds=True,
                reweight="inverse", fds=True, stage_sizes=(1, 1, 1, 1), width=8, lr=1e-3,
                save_ckpt=0)
    base.update(kw)
    return task.NYUDConfig(**base)


def test_nyud2_driver_on_cpu(tmp_path):
    ck.reset_launch_counts()
    result = task.run(_config(tmp_path))
    history = result["history"]
    assert [h["epoch"] for h in history] == [0, 1, 2]
    assert all(math.isfinite(h["train_loss"]) and math.isfinite(h["test_rmse"]) for h in history)
    assert math.isfinite(result["test"]["overall"]["RMSE"]) and result["test"]["overall"]["NUM"] > 0
    assert result["best_rmse"] == min(h["test_rmse"] for h in history)
    # epoch 2 smooths with the snapshot of epoch 1's pass (start_smooth = 1)
    assert [h["fds_calibrating"] for h in history] == [False, False, True]
    fds = result["state"].fds
    assert fds.epoch == 2 and fds.running_var.shape == (93, 72)
    # 19 train images at the reference's 228x304 crop, 4 in the FDS subset
    # (a pass per epoch), pixels tracked
    assert result["state"].backbone.encoder.conv1.weight.shape[0] == 8
    assert float(fds.num_samples_tracked.sum()) > 0
    assert set(result["best_snapshot"]) == {"backbone", "head", "fds"}
    # on the CPU every wrapper takes its plain version: no launches
    assert all(fn.launches == 0 for fn in ck.KERNEL_WRAPPERS)
    store = tmp_path / task.NYUDConfig(**{**vars(_config(tmp_path))}).derived_store_name()
    assert (store / "metrics.jsonl").exists()


def test_parse_nyud_config_matches_jax():
    argv = ["--synthetic_size", "160", "--fds", "--lds", "--reweight", "inverse",
            "--save_ckpt", "0"]
    got = task.parse_nyud_config(argv)
    want = jtask.parse_nyud_config(argv)
    for field in ("dataset", "loss", "lr", "epoch", "batch_size", "bucket_start", "lds_sigma",
                  "fds_sigma", "weight_decay", "test_batch_size", "stage_sizes", "width",
                  "mff_features", "decoder_min_features", "fds", "lds", "reweight",
                  "synthetic_size"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.derived_store_name() == want.derived_store_name()


@pytest.mark.parametrize("kw", [dict(num_devices=2), dict(max_steps_per_run=5)])
def test_unported_flags_raise(tmp_path, kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        task.run(_config(tmp_path, **kw))


def test_default_device_is_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--synthetic_size", "24", "--save_ckpt", "0", "--store_root", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        task.main(argv)
