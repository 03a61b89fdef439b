"""NYUD2-DIR data pipeline on PyTorch: paired image/depth transforms,
per-pixel LDS weights, synthetic stand-in.

The JAX package's ``data/nyud2.py`` (reference ``nyud2-dir/loaddata.py`` +
``nyu_transform.py``): the host keeps the paired *geometric* augmentation of
real data (scale-240 with nearest-neighbour depth, flip, ±5° rotation,
centre crop 304x228 with depth at 152x114); the *photometric* augmentation
(PCA lighting, colour jitter) and the ImageNet normalization run on the
device, on the whole batch (:func:`nyud2_train_photometric`). Per-pixel LDS
weights are looked up on the device from the per-bucket table
(:func:`make_pixel_weight_fn`).

:func:`photometric` is the deterministic core: it takes the random draws as
tensors, so a test can feed it the JAX function's own draws.
:func:`nyud2_train_photometric` draws them from a ``torch.Generator``.

PIL is imported only inside the real-data loader.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from imbalanced_regression_tpu_torch.data.augment import to_unit_float
from imbalanced_regression_tpu_torch.ops.binning import bin_index_depth
from imbalanced_regression_tpu_torch.parallel import mesh as dp

# Global per-bucket pixel counts of the NYUD2 train split (loaddata.py:11-19).
TRAIN_BUCKET_NUM = [
    0, 0, 0, 0, 0, 0, 0, 25848691, 24732940, 53324326, 69112955, 54455432,
    95637682, 71403954, 117244217, 84813007, 126524456, 84486706, 133130272,
    95464874, 146051415, 146133612, 96561379, 138366677, 89680276, 127689043,
    81608990, 119121178, 74360607, 106839384, 97595765, 66718296, 90661239,
    53103021, 83340912, 51365604, 71262770, 42243737, 65860580, 38415940,
    53647559, 54038467, 28335524, 41485143, 32106001, 35936734, 23966211,
    32018765, 19297203, 31503743, 21681574, 16363187, 25743420, 12769509,
    17675327, 13147819, 15798560, 9547180, 14933200, 9663019, 12887283,
    11803562, 7656609, 11515700, 7756306, 9046228, 5114894, 8653419, 6859433,
    8001904, 6430700, 3305839, 6318461, 3486268, 5621065, 4030498, 3839488,
    3220208, 4483027, 2555777, 4685983, 3145082, 2951048, 2762369, 2367581,
    2546089, 2343867, 2481579, 1722140, 3018892, 2325197, 1952354, 2047038,
    1858707, 2052729, 1348558, 2487278, 1314198, 3338550, 1132666,
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
PCA_EIGVEC = np.array(
    [[-0.5675, 0.7192, 0.4009],
     [-0.5808, -0.0045, -0.8140],
     [-0.5836, -0.6948, 0.4203]], np.float32)
LUMA = np.array([0.299, 0.587, 0.114], np.float32)
# the reference's train crop (nyu_transform.py): images 228x304, depth at half
IMG_HW = (228, 304)
DEPTH_HW = (114, 152)


# ---------------------------------------------------------------------------
# device-side photometric augmentation
# ---------------------------------------------------------------------------


_ON_DEVICE: dict = {}  # the constants above on each device they were asked for on


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` (one of the module's constant arrays) on ``like``'s device,
    copied there once: a host copy in every step would also bar the step
    from a CUDA graph. Under ``torch.export`` (and ``torch.compile``) the
    copy is the traced program's constant and is kept out of the cache,
    which holds real tensors only."""
    if torch.compiler.is_compiling():
        return torch.as_tensor(a, device=like.device)
    key = (id(a), like.device)
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.as_tensor(a, device=like.device)
    return t


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (or [0, 1] float) NHWC → ImageNet-normalized float32."""
    x = to_unit_float(images)
    return (x - _const(IMAGENET_MEAN, x)) / _const(IMAGENET_STD, x)


def photometric(images: torch.Tensor, alpha: torch.Tensor, brightness: torch.Tensor,
                contrast: torch.Tensor, saturation: torch.Tensor) -> torch.Tensor:
    """PCA lighting with the scaled draws ``alpha`` [N, 3], then brightness,
    contrast and saturation with factors [N, 1, 1, 1], then the ImageNet
    normalization (host equivalents: ``nyu_transform.py:203-347``)."""
    x = to_unit_float(images)
    luma = _const(LUMA, x)
    rgb = (alpha * _const(PCA_EIGVAL, x)) @ _const(PCA_EIGVEC, x).T  # [N, 3]
    x = x + rgb[:, None, None, :]
    x = x * brightness
    mean_lum = (x @ luma).mean(dim=(1, 2), keepdim=True)[..., None]  # [N, 1, 1, 1]
    x = x * contrast + mean_lum * (1 - contrast)
    gray = (x @ luma)[..., None]
    x = x * saturation + gray * (1 - saturation)
    return (x - _const(IMAGENET_MEAN, x)) / _const(IMAGENET_STD, x)


def nyud2_train_photometric(images: torch.Tensor, generator=None,
                            lighting_std: float = 0.1, jitter: float = 0.4) -> torch.Tensor:
    """:func:`photometric` with per-sample draws from ``generator`` on the
    images' device: ``alpha ~ N(0, lighting_std)``, the three jitter factors
    uniform in [1 - jitter, 1 + jitter]. Under a mesh ``generator`` is a
    :class:`parallel.mesh.ShardedGenerator`: this rank's rows of the global
    batch's draws."""
    n = images.shape[0]
    dev = images.device
    alpha = dp.randn((n, 3), generator, dev) * lighting_std

    def factor():
        u = dp.rand((n, 1, 1, 1), generator, dev)
        return (1 - jitter) + 2 * jitter * u

    brightness, contrast, saturation = factor(), factor(), factor()
    return photometric(images, alpha, brightness, contrast, saturation)


def make_pixel_weight_fn(bucket_weights):
    """Per-pixel weight lookup on the device from the per-bucket LDS table
    (replaces the host ``_get_weights``, ``loaddata.py:58-67``): ``weight_fn
    (batch)`` maps ``batch["target"]`` depths to weights of the same shape.
    Returns None when re-weighting is off (uniform weights)."""
    if bucket_weights is None:
        return None
    table = torch.as_tensor(np.asarray(bucket_weights, np.float32))
    on_device = {}  # the table on each device it was asked for on, copied once

    def weight_fn(batch: dict) -> torch.Tensor:
        target = batch["target"]
        idx = bin_index_depth(target, table.shape[0], 0)
        dev_table = on_device.get(target.device)
        if dev_table is None:
            dev_table = on_device[target.device] = table.to(target.device)
        return dev_table[idx.long()]

    return weight_fn


# ---------------------------------------------------------------------------
# host-side paired geometric pipeline (real data)
# ---------------------------------------------------------------------------


def _paired_train_sample(image, depth, rng, img_hw=IMG_HW, depth_hw=DEPTH_HW):
    """PIL-based geometry matching nyu_transform.py: scale-240 (nearest for
    depth), random hflip, ±5° rotation, center crop, half-res depth."""
    from PIL import Image
    from scipy import ndimage

    image = _scale_short_side(image, 240, Image.BILINEAR)
    depth = _scale_short_side(depth, 240, Image.NEAREST)
    if rng.random() < 0.5:
        image = image.transpose(Image.FLIP_LEFT_RIGHT)
        depth = depth.transpose(Image.FLIP_LEFT_RIGHT)
    angle = rng.uniform(-5.0, 5.0)
    image = Image.fromarray(ndimage.rotate(np.asarray(image), angle, reshape=False, order=2))
    depth = Image.fromarray(ndimage.rotate(np.asarray(depth), angle, reshape=False, order=2))
    image = _center_crop(image, (img_hw[1], img_hw[0]))
    depth = _center_crop(depth, (img_hw[1], img_hw[0])).resize((depth_hw[1], depth_hw[0]))
    img = np.asarray(image, np.uint8)
    dep = np.asarray(depth, np.float32) / 255.0 * 10.0  # 8-bit train depth → meters
    return img, dep


def _scale_short_side(img, size, interpolation):
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        return img.resize((size, int(size * h / w)), interpolation)
    return img.resize((int(size * w / h), size), interpolation)


def _center_crop(img, size_wh):
    w, h = img.size
    tw, th = size_wh
    x1 = int(round((w - tw) / 2.0))
    y1 = int(round((h - th) / 2.0))
    return img.crop((x1, y1, tw + x1, th + y1))


def load_nyud2_split(data_dir: str, csv_name: str, train: bool, seed: int = 0,
                     mask_file: str | None = None, limit: int | None = None) -> dict:
    """Load a NYUD2 CSV split into arrays (images uint8 NHWC, depth f32 NHW1).
    Each CSV row holds the image and depth paths, with a leading directory
    that ``data_dir`` replaces."""
    from PIL import Image

    with open(os.path.join(data_dir, csv_name), newline="") as fh:
        rows = [row for row in csv.reader(fh) if row]
    if limit:
        rows = rows[:limit]
    rng = np.random.default_rng(seed)
    images, depths = [], []
    for row in rows:
        img_path = os.path.join(data_dir, "/".join(row[0].split("/")[1:]))
        dep_path = os.path.join(data_dir, "/".join(row[1].split("/")[1:]))
        with Image.open(img_path) as im, Image.open(dep_path) as dp:
            if train:
                img, dep = _paired_train_sample(im, dp, rng)
            else:
                im2 = _center_crop(_scale_short_side(im, 240, Image.BILINEAR), (304, 228))
                dp2 = _center_crop(_scale_short_side(dp, 240, Image.NEAREST), (304, 228))
                img = np.asarray(im2, np.uint8)
                dep = np.asarray(dp2, np.float32) / 1000.0  # 16-bit test depth
        images.append(img)
        depths.append(dep)
    out = {"input": np.stack(images), "target": np.stack(depths)[..., None]}
    if mask_file:
        out["mask"] = np.load(os.path.join(data_dir, mask_file))
    return out


# ---------------------------------------------------------------------------
# synthetic stand-in
# ---------------------------------------------------------------------------


def synthetic_depth_dataset(n: int, img_hw=(64, 96), depth_hw=(32, 48), seed: int = 0) -> dict:
    """Images with depth-correlated gradients; depths in [0.7, 10] m with an
    imbalanced (exponential-ish) distribution like real indoor scenes."""
    rng = np.random.default_rng(seed)
    h, w = depth_hw
    base = rng.uniform(0.7, 4.0, size=(n, 1, 1)).astype(np.float32)
    slope = rng.uniform(0.0, 6.0, size=(n, 1, 1)).astype(np.float32)
    yy = np.linspace(0, 1, h, dtype=np.float32)[None, :, None]
    depth = np.clip(base + slope * yy + 0.1 * rng.normal(size=(n, h, w)).astype(np.float32),
                    0.7, 10.0)
    ih, iw = img_hw
    img_small = (depth - 0.7) / 9.3
    img = np.repeat(np.repeat(img_small, ih // h, axis=1), iw // w, axis=2)
    img = np.stack([img, 1 - img, img**2], axis=-1)
    img = (img * 255 + rng.normal(0, 8, size=img.shape)).clip(0, 255).astype(np.uint8)
    return {"input": img, "target": depth[..., None].astype(np.float32)}
