"""The port's real-data input path for the age suite against the JAX
package's, on the CPU: the native JPEG loader (``data/native_loader.py``),
the ram / mmap / stream image modes and the prefetcher
(``data/streaming.py``), and the meta-CSV reader (``data/age.py``, the
``csv`` module against ``pd.read_csv``). Inputs are made from a seed with
numpy and written with PIL; the committed fixture set
(``tests/data/torch_age_jpegs/``, written by ``tests/torch_age_jpegs.py``)
is decoded by both loaders too. Every comparison is bit for bit."""

import glob
import os
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from imbalanced_regression_tpu.data import native_loader as jloader
from imbalanced_regression_tpu.data import streaming as jstreaming
from imbalanced_regression_tpu.data.age import load_age_datasets as jax_load_age_datasets
from imbalanced_regression_tpu.utils.config import ExperimentConfig as JaxConfig
from imbalanced_regression_tpu_torch.data import native_loader, streaming
from imbalanced_regression_tpu_torch.data.age import load_age_datasets
from imbalanced_regression_tpu_torch.utils.config import ExperimentConfig

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_age_jpegs")


def _photo(rng, h, w):
    """Smooth structured RGB content with mild noise (a resize of iid noise
    would compare nothing)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 80 * np.sin(xx / 7 + yy / 11), 127 + 60 * np.cos(yy / 5),
                    127 + 50 * np.sin((xx + yy) / 9)], -1)
    return (img + rng.normal(0, 4, img.shape)).clip(0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """RGB JPEGs larger and smaller than the decode size (a 40x30 one is
    upscaled), a grayscale JPEG and a PNG (the native decoder rejects it)."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(120, 90), (64, 64), (200, 150), (30, 40), (77, 101)]):
        paths.append(str(root / f"rgb{i}.jpg"))
        Image.fromarray(_photo(rng, h, w)).save(paths[-1], quality=int(rng.integers(85, 96)))
    paths.append(str(root / "gray.jpg"))
    Image.fromarray(_photo(rng, 90, 70)[..., 0], mode="L").save(paths[-1], quality=90)
    paths.append(str(root / "x.png"))
    Image.fromarray(_photo(rng, 50, 60)).save(paths[-1])
    return paths


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("threads", [1, 4])
def test_decode_matches_jax(images, threads, native, monkeypatch):
    """Bit-equal to the JAX loader: through the native library (the PNG
    through PIL), and where the library cannot be built (every file through
    PIL, here on ``threads`` threads)."""
    if not native:
        monkeypatch.setattr(native_loader, "get_lib", lambda: None)
        monkeypatch.setattr(jloader, "get_lib", lambda: None)
    got = native_loader.decode_resize_batch(images, 64, threads=threads)
    want = jloader.decode_resize_batch(images, 64, threads=threads)
    assert got.shape == (len(images), 64, 64, 3) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    assert got[-1].any()  # the PNG went through PIL in both, not a zeroed slot
    empty = native_loader.decode_resize_batch([], 64, threads=threads)
    assert empty.shape == (0, 64, 64, 3) and np.array_equal(
        empty, jloader.decode_resize_batch([], 64, threads=threads))


def test_fixture_set_decodes_equal_with_both_loaders(monkeypatch):
    """The committed fixtures (48 baseline RGB, one grayscale, one
    progressive JPEG): every one decoded natively (none goes to PIL), bit
    for bit as the JAX loader decodes it."""
    paths = sorted(glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert len(paths) == 50 and sum(os.path.getsize(p) for p in paths) < 1.5e6
    want = jloader.decode_resize_batch(paths, 224, threads=4)

    def refuse(paths, *args):
        raise AssertionError(f"the native decoder rejected {paths}")

    monkeypatch.setattr(native_loader, "_pil_decode", refuse)
    assert np.array_equal(native_loader.decode_resize_batch(paths, 224, threads=4), want)


@pytest.mark.parametrize("unavailable", ["PIL", "PIL and the native loader"])
def test_decode_without_pil_raises_naming_files(images, monkeypatch, unavailable):
    """Where PIL is not installed, what the native decoder cannot take (the
    PNG; every file when the library is unavailable) raises, naming the
    files; no slot comes back zeroed."""
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
    jpegs = images[:-1]
    assert np.array_equal(native_loader.decode_resize_batch(jpegs, 32),
                          jloader.decode_resize_batch(jpegs, 32))
    if unavailable != "PIL":
        monkeypatch.setattr(native_loader, "get_lib", lambda: None)
    bad = images if unavailable != "PIL" else images[-1:]
    with pytest.raises(RuntimeError, match="PIL is not installed") as err:
        native_loader.decode_resize_batch(images, 32)
    assert os.path.basename(bad[0]) in str(err.value)


def test_lazy_array_matches_eager(images):
    lazy = streaming.LazyImageArray(images, 48, threads=2)
    eager = jloader.decode_resize_batch(images, 48, threads=2)
    assert lazy.shape == eager.shape and len(lazy) == len(images) and lazy.dtype == np.uint8
    assert np.array_equal(lazy[3], eager[3])
    assert np.array_equal(lazy[np.int64(5)], eager[5])
    assert np.array_equal(lazy[1:6:2], eager[1:6:2])
    idx = np.array([6, 0, 3, 6])
    assert np.array_equal(lazy[idx], eager[idx])
    assert np.array_equal(lazy[[2, 1]], eager[[2, 1]])
    with pytest.raises(TypeError):
        np.asarray(lazy)


@pytest.mark.parametrize("img_size", [32, 224])
def test_corpus_signature_matches_jax(images, img_size):
    for paths in (images, images[::-1], images[:1], []):
        assert streaming.corpus_signature(paths, img_size) == \
            jstreaming.corpus_signature(paths, img_size)


def test_mmap_cache_roundtrip_marker_and_size(images, tmp_path, monkeypatch):
    cache = str(tmp_path / "cache")
    m = streaming.build_mmap_cache(images, 40, cache, threads=2, chunk=3)
    assert isinstance(m, np.memmap) and m.shape == (len(images), 40, 40, 3)
    eager = jloader.decode_resize_batch(images, 40, threads=2)
    assert np.array_equal(np.asarray(m), eager)
    sig = streaming.corpus_signature(images, 40)
    npy = os.path.join(cache, f"images_{sig}.npy")
    assert open(npy + ".ok").read() == sig
    # the JAX package's cache of the same corpus: the same file name and bytes
    jcache = str(tmp_path / "jcache")
    jstreaming.build_mmap_cache(images, 40, jcache, threads=2, chunk=4)
    with open(npy, "rb") as a, open(os.path.join(jcache, os.path.basename(npy)), "rb") as b:
        assert a.read() == b.read()

    calls = []
    real = native_loader.decode_resize_batch

    def counting(paths, *a, **kw):
        calls.append(len(paths))
        return real(paths, *a, **kw)

    monkeypatch.setattr(native_loader, "decode_resize_batch", counting)
    streaming.build_mmap_cache(images, 40, cache, threads=2, chunk=3)
    assert calls == []  # a complete cache is mapped, not decoded again
    os.remove(npy + ".ok")  # a build that never finished
    again = streaming.build_mmap_cache(images, 40, cache, threads=2, chunk=3)
    assert calls == [3, 3, 1] and np.array_equal(np.asarray(again), eager)
    other = streaming.build_mmap_cache(images, 24, cache, threads=2)
    assert other.shape[1:3] == (24, 24)
    assert len(glob.glob(os.path.join(cache, "images_*.npy"))) == 2


def test_prefetch_keeps_order():
    items = [{"i": i} for i in range(50)]
    got = list(streaming.prefetch_batches(iter(items), depth=3,
                                          transform=lambda b: {"i": b["i"] * 2}))
    assert [b["i"] for b in got] == [2 * i for i in range(50)]


def test_prefetch_reraises_producer_error():
    def producer():
        yield {"i": 0}
        raise ValueError("decode failed")

    it = streaming.prefetch_batches(producer())
    assert next(it) == {"i": 0}
    with pytest.raises(ValueError, match="decode failed"):
        next(it)


def test_prefetch_early_close_stops_producer():
    """Closing the consumer early unblocks a producer waiting on a full
    queue; it stops after at most one more batch, and close waits for it."""
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"i": i}
            i += 1

    it = streaming.prefetch_batches(endless(), depth=2)
    assert [next(it)["i"] for _ in range(3)] == [0, 1, 2]
    time.sleep(0.05)  # the producer fills the queue and blocks
    it.close()
    n = len(produced)
    assert not any(t.name == "batch-prefetch" and t.is_alive() for t in threading.enumerate())
    assert n <= 3 + 2 + 2
    time.sleep(0.05)
    assert len(produced) == n


@pytest.mark.parametrize("n,size,mode,budget", [
    (100, 224, "auto", 8.0), (16_488, 224, "auto", 8.0), (191_509, 224, "auto", 8.0),
    (53_131, 224, "auto", 8.0), (53_132, 224, "auto", 8.0), (10, 32, "stream", 8.0),
    (10**6, 224, "ram", 8.0), (1000, 224, "auto", 0.1)])
def test_choose_data_mode_matches_jax(n, size, mode, budget):
    got = streaming.choose_data_mode(n, size, mode, budget)
    assert got == jstreaming.choose_data_mode(n, size, mode, budget)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """48 JPEGs (36x44 to 60x60) and ``agedb.csv``: splits interleaved in the
    file, an imbalanced train split, a blank line, an extra column."""
    root = tmp_path_factory.mktemp("agedb")
    (root / "faces").mkdir()
    rng = np.random.default_rng(1)
    rows = []
    for i in range(48):
        path = f"faces/{i:03d}.jpg"
        h, w = int(rng.integers(36, 61)), int(rng.integers(44, 61))
        Image.fromarray(_photo(rng, h, w)).save(root / path, quality=92)
        split = ("val", "test")[i % 2] if i % 4 == 0 else "train"
        age = int(rng.integers(25, 35)) if split == "train" and i % 3 else int(rng.integers(0, 101))
        rows.append(f"{age},{path},{split},agedb")
    (root / "agedb.csv").write_text("age,path,split,source\n" + "\n".join(rows) + "\n\n")
    return str(root)


def _compare_inputs(got, want):
    if isinstance(want, jstreaming.LazyImageArray):
        assert isinstance(got, streaming.LazyImageArray) and got.shape == want.shape
        idx = np.arange(len(want))
        return np.array_equal(got[idx], want[idx])
    return type(got) is type(want) and np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("mode", ["ram", "mmap", "stream"])
@pytest.mark.parametrize("reweight,lds", [("none", False), ("sqrt_inv", False), ("inverse", True)])
def test_load_age_datasets_matches_jax(corpus, tmp_path, mode, reweight, lds):
    kw = dict(dataset="agedb", data_dir=corpus, img_size=32, workers=2, data_mode=mode,
              reweight=reweight, lds=lds, lds_ks=9, max_target=101)
    got = load_age_datasets(ExperimentConfig(cache_dir=str(tmp_path / "port"), **kw))
    want = jax_load_age_datasets(JaxConfig(cache_dir=str(tmp_path / "jax"), **kw))
    df = pd.read_csv(os.path.join(corpus, "agedb.csv"))
    for g, w, split in zip(got[:3], want[:3], ("train", "val", "test")):
        assert _compare_inputs(g["input"], w["input"]), split
        assert g["target"].dtype == np.float32 and g["target"].shape == (len(w["target"]), 1)
        assert np.array_equal(g["target"], w["target"])
        assert len(g["target"]) == (df["split"] == split).sum()
    assert got[0]["weight"].dtype == np.float32
    assert np.array_equal(got[0]["weight"], want[0]["weight"])
    assert (reweight == "none") == bool((got[0]["weight"] == 1).all())
    assert got[3].dtype == want[3].dtype and np.array_equal(got[3], want[3])


def test_missing_meta_csv_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="agedb.csv"):
        load_age_datasets(ExperimentConfig(dataset="agedb", data_dir=str(tmp_path)))


@pytest.mark.parametrize("skip", [0, 2, 5])
def test_batch_iterator_skip_leaves_batches_ungathered(images, skip):
    """``batch_iterator(skip=k)`` yields the full stream's batches from k on
    and never indexes the data for the first k (a resumed epoch's stream)."""
    from imbalanced_regression_tpu_torch.data.batching import batch_iterator

    lazy = streaming.LazyImageArray(images, 16, threads=1)
    taken = []

    class Counting(streaming.LazyImageArray):
        def __getitem__(self, sel):
            taken.append(np.asarray(sel).tolist())
            return super().__getitem__(sel)

    data = {"input": Counting(images, 16, threads=1), "target": np.arange(len(images))[:, None]}
    rng = lambda: np.random.default_rng(3)  # noqa: E731
    full = list(batch_iterator({"input": lazy, "target": data["target"]}, 1, rng=rng()))
    got = list(batch_iterator(data, 1, rng=rng(), skip=skip))
    assert len(got) == len(full) - skip == len(taken)
    for g, f in zip(got, full[skip:]):
        assert np.array_equal(g["input"], f["input"]) and np.array_equal(g["target"], f["target"])
