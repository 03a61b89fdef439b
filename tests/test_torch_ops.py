"""The port's ops held against the JAX package on the CPU: the numpy copies
(kernel windows, binning, LDS weights), the losses, bucket smoothing,
calibration (against ``calibrate_gathered`` and the Pallas kernel in
interpret mode), and segment moments (against the one-hot path,
``pallas_moments`` and, for the split-precision version, ``pallas_moments_v2``).
The kernel-vs-plain checks that need the card are in ``test_torch_cuda.py``.

Inputs are made with seeded numpy and handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbalanced_regression_tpu.ops import binning as jbinning
from imbalanced_regression_tpu.ops import kernels as jkernels
from imbalanced_regression_tpu.ops import lds as jlds
from imbalanced_regression_tpu.ops import losses as jlosses
from imbalanced_regression_tpu.ops.calibrate import calibrate_gathered as j_calibrate_gathered
from imbalanced_regression_tpu.ops.calibrate import calibrate_mean_var as j_calibrate_mean_var
from imbalanced_regression_tpu.ops.moments import bucket_moments as j_bucket_moments
from imbalanced_regression_tpu.ops.pallas_kernels import (
    pallas_calibrate,
    pallas_moments,
    pallas_moments_v2,
)
from imbalanced_regression_tpu.ops.smoothing import smooth_bucket_stats as j_smooth
from imbalanced_regression_tpu_torch.ops import binning, kernels, lds, losses
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.ops.calibrate import (
    calibrate_gathered,
    calibrate_indexed,
    calibrate_indexed_grad,
    calibrate_mean_var,
)
from imbalanced_regression_tpu_torch.ops.moments import bucket_moments, zero_moments
from imbalanced_regression_tpu_torch.ops.smoothing import smooth_bucket_stats

T = torch.as_tensor


# ---------------------------------------------------------------- numpy copies


@pytest.mark.parametrize("kernel", ["gaussian", "triang", "laplace"])
@pytest.mark.parametrize("ks,sigma", [(5, 2.0), (9, 1.0), (1, 1.0)])
def test_kernel_windows_equal_jax(kernel, ks, sigma):
    # exact copies of the same numpy/scipy code: bit-equal
    np.testing.assert_array_equal(kernels.get_lds_kernel_window(kernel, ks, sigma),
                                  jkernels.get_lds_kernel_window(kernel, ks, sigma))
    np.testing.assert_array_equal(kernels.get_fds_kernel_window(kernel, ks, sigma),
                                  jkernels.get_fds_kernel_window(kernel, ks, sigma))


def test_binning_equal_jax(rng):
    labels = np.concatenate([rng.uniform(0, 5, 300), [0.0, 2.6, 5.0, 4.9999]]).astype(np.float32)
    np.testing.assert_array_equal(binning.bin_index_hist_np(labels, 50),
                                  jbinning.bin_index_hist_np(labels, 50))
    np.testing.assert_array_equal(binning.hist_bin_edges(50), jbinning.hist_bin_edges(50))
    depth = rng.uniform(0, 12, 500).astype(np.float32)
    want = np.asarray(jbinning.bin_index_depth(jnp.asarray(depth), 100, 7))
    np.testing.assert_array_equal(binning.bin_index_depth(depth, 100, 7), want)
    np.testing.assert_array_equal(binning.bin_index_depth(T(depth), 100, 7).numpy(), want)
    ages = rng.uniform(0, 130, 500).astype(np.float32)
    want = np.asarray(jbinning.bin_index_age(jnp.asarray(ages), 121))
    np.testing.assert_array_equal(binning.bin_index_age(ages, 121), want)
    np.testing.assert_array_equal(binning.bin_index_age(T(ages), 121).numpy(), want)


@pytest.mark.parametrize("reweight", ["none", "sqrt_inv", "inverse"])
@pytest.mark.parametrize("lds_on", [False, True])
@pytest.mark.parametrize("kernel", ["gaussian", "triang", "laplace"])
def test_lds_weights_equal_jax(rng, reweight, lds_on, kernel):
    if lds_on and reweight == "none":
        with pytest.raises(ValueError):
            lds.prepare_weights_age([1.0], reweight, lds=True)
        return
    kw = dict(lds=lds_on, lds_kernel=kernel, lds_ks=5, lds_sigma=2.0)
    ages = np.clip(np.round(rng.normal(35, 12, 400)), 0, 120).astype(np.float32)
    sts = rng.uniform(0, 5, 400).astype(np.float32)
    counts = rng.integers(1, 5000, 100)

    def same(a, b):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)  # same numpy code: bit-equal

    same(lds.prepare_weights_age(ages, reweight, **kw), jlds.prepare_weights_age(ages, reweight, **kw))
    same(lds.prepare_weights_hist(sts, reweight, **kw), jlds.prepare_weights_hist(sts, reweight, **kw))
    same(lds.prepare_weights_depth(counts, reweight, **kw),
         jlds.prepare_weights_depth(counts, reweight, **kw))


# ---------------------------------------------------------------------- losses


@pytest.mark.parametrize("name", ["mse", "l1", "focal_mse", "focal_l1", "huber"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_and_grads_match_jax(rng, name, weighted):
    p = rng.normal(30, 10, (16, 1)).astype(np.float32)
    t = rng.normal(30, 10, (16, 1)).astype(np.float32)
    t[:3] = p[:3] + 0.3  # inside the huber quadratic zone
    w = rng.uniform(0.2, 3.0, (16, 1)).astype(np.float32) if weighted else None
    jf, tf = jlosses.LOSS_REGISTRY[name], losses.LOSS_REGISTRY[name]

    jval, jgrad = jax.value_and_grad(lambda a: jf(a, jnp.asarray(t), None if w is None else jnp.asarray(w)))(
        jnp.asarray(p))
    pt = T(p).clone().requires_grad_(True)
    val = tf(pt, T(t), None if w is None else T(w))
    val.backward()
    # float32 on both sides; the mean is reduced in another order: 1e-6 relative
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------- smoothing


@pytest.mark.parametrize("kernel,ks", [("gaussian", 5), ("triang", 9), ("laplace", 3)])
def test_smoothing_matches_jax(rng, kernel, ks):
    stats = rng.normal(size=(20, 6)).astype(np.float32)
    window = kernels.get_fds_kernel_window(kernel, ks, 2.0)
    got = smooth_bucket_stats(T(stats), window).numpy()
    # same float32 taps in the same order: bit-equal up to FMA contraction
    np.testing.assert_allclose(got, np.asarray(j_smooth(jnp.asarray(stats), window)),
                               rtol=1e-6, atol=1e-7)
    # conv1d (cross-correlation) on the reflect-padded stats, window unflipped
    half = (ks - 1) // 2
    x = torch.nn.functional.pad(T(stats).T[None], (half, half), mode="reflect")
    ref = torch.nn.functional.conv1d(x.reshape(6, 1, -1), T(window.astype(np.float32))[None, None])
    np.testing.assert_allclose(got, ref[:, 0].T.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- calibrate


def _calibrate_inputs(rng, n=50, d=40, b=12):
    x = rng.normal(size=(n, d)).astype(np.float32)
    e = rng.integers(0, b, size=n).astype(np.int32)
    e[:3] = -1  # rows outside every bucket pass through
    ok = rng.random(n) > 0.2
    m1 = rng.normal(size=(b, d)).astype(np.float32)
    v1 = rng.uniform(0.01, 3.0, size=(b, d)).astype(np.float32)
    m2 = rng.normal(size=(b, d)).astype(np.float32)
    v2 = rng.uniform(0.01, 3.0, size=(b, d)).astype(np.float32)
    v1[2, :] = 0.0  # all-zero v1 row → identity for bucket 2
    v1[5, 3] = 0.0  # single zero column
    v2[6, 1] = -1.0  # negative v2 (positive-mode column guard)
    v2[7, :5] = 100.0  # ratio above clip_max
    return x, e, ok, (m1, v1, m2, v2)


MODES = [("nonzero", (0.1, 10.0)), ("positive", (0.5, 2.0))]


@pytest.mark.parametrize("mode,clips", MODES)
def test_calibrate_indexed_matches_jax(rng, mode, clips):
    x, e, ok, stats = _calibrate_inputs(rng)
    v1sum = stats[1].sum(1)
    got = calibrate_indexed(T(x), T(e), T(ok), *map(T, stats), T(v1sum), *clips, mode).numpy()
    pal = np.asarray(pallas_calibrate(jnp.asarray(x), jnp.asarray(e), jnp.asarray(ok),
                                      tuple(map(jnp.asarray, stats)), jnp.asarray(v1sum),
                                      clips[0], clips[1], mode))
    safe = np.maximum(e, 0)
    row_ok = ok & (e >= 0)
    gathered = np.asarray(j_calibrate_gathered(
        jnp.asarray(x), *(jnp.asarray(s[safe]) for s in stats), jnp.asarray(row_ok),
        clips[0], clips[1], mode))
    # identical float32 formula; the Pallas kernel's HIGHEST-precision
    # one-hot gather reassembles each f32 value from bf16 passes: 1e-5
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, gathered, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[:3], x[:3])  # e = -1 rows pass through
    np.testing.assert_array_equal(got[e == 2], x[e == 2])  # zero v1 row


@pytest.mark.parametrize("mode,clips", MODES)
def test_calibrate_grad_matches_jax(rng, mode, clips):
    x, e, ok, stats = _calibrate_inputs(rng)
    v1sum = stats[1].sum(1)
    g = rng.normal(size=x.shape).astype(np.float32)

    def f(xj):
        out = pallas_calibrate(xj, jnp.asarray(e), jnp.asarray(ok), tuple(map(jnp.asarray, stats)),
                               jnp.asarray(v1sum), clips[0], clips[1], mode)
        return jnp.sum(out * g)

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = T(x).clone().requires_grad_(True)
    out = ck.FDSCalibrate.apply(xt, T(e), T(ok), *map(T, stats), T(v1sum), *clips, mode)
    (out * T(g)).sum().backward()
    explicit = calibrate_indexed_grad(T(g), T(e), T(ok), T(stats[1]), T(stats[3]), T(v1sum),
                                      *clips, mode).numpy()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    # the explicit K2 formula is autograd's gradient of the plain K1
    np.testing.assert_allclose(explicit, xt.grad.numpy(), rtol=1e-6, atol=1e-7)


def test_calibrate_bf16_input(rng):
    x, e, ok, stats = _calibrate_inputs(rng)
    xb = T(x).to(torch.bfloat16)
    got = calibrate_indexed(xb, T(e), T(ok), *map(T, stats), T(stats[1].sum(1)), 0.1, 10.0,
                            "nonzero")
    assert got.dtype == torch.float32
    want = calibrate_indexed(xb.float(), T(e), T(ok), *map(T, stats), T(stats[1].sum(1)), 0.1,
                             10.0, "nonzero")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_calibrate_mean_var_matches_jax(rng):
    x = rng.normal(size=(30, 8)).astype(np.float32)
    m1, m2 = rng.normal(size=(2, 8)).astype(np.float32)
    v1, v2 = rng.uniform(0.1, 2.0, size=(2, 8)).astype(np.float32)
    v1[3] = 0.0
    for mode in ("nonzero", "positive"):
        got = calibrate_mean_var(T(x), T(m1), T(v1), T(m2), T(v2), mode=mode).numpy()
        want = np.asarray(j_calibrate_mean_var(jnp.asarray(x), m1, v1, m2, v2, mode=mode))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    zero = calibrate_mean_var(T(x), T(m1), T(np.zeros(8, np.float32)), T(m2), T(v2)).numpy()
    np.testing.assert_array_equal(zero, x)
    with pytest.raises(ValueError):
        calibrate_gathered(T(x), T(x), T(x), T(x), T(x), T(np.ones(30, bool)), 0.1, 10.0, "bogus")


# --------------------------------------------------------------------- moments


@pytest.mark.parametrize("n,d,b", [(64, 32, 10), (100, 130, 21), (7, 8, 3), (300, 512, 100)])
def test_moments_match_jax(rng, n, d, b):
    feats = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, b, size=n).astype(np.int32)
    idx[:2] = -1  # masked-out samples
    got = bucket_moments(T(feats), T(idx), b)
    pc, pt, pq = pallas_moments(jnp.asarray(feats), jnp.asarray(idx), b)
    valid = idx >= 0
    ref = j_bucket_moments(jnp.asarray(feats[valid]), jnp.asarray(idx[valid]), b, use_pallas=False)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(pc))  # counts are exact
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    # float32 sums in another order: 1e-5
    for want in ((pt, pq), (ref.total, ref.total_sq)):
        np.testing.assert_allclose(got.total.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.total_sq.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    mean, var = got.mean_var()
    jmean, jvar = ref.mean_var()
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-4, atol=1e-5)


def test_moments_valid_edges_and_add(rng):
    feats = rng.normal(size=(20, 4)).astype(np.float32)
    idx = rng.integers(0, 5, size=20).astype(np.int32)
    valid = rng.random(20) > 0.3
    is_lo = np.zeros(20, bool)
    is_lo[np.flatnonzero(~valid)[:1]] = True  # an edge label on a masked-out row only
    is_hi = valid & (idx == 4)
    got = bucket_moments(T(feats), T(idx), 5, valid=T(valid), edge_labels=(T(is_lo), T(is_hi)))
    want = j_bucket_moments(jnp.asarray(feats), jnp.asarray(idx), 5, valid=jnp.asarray(valid),
                            edge_labels=(jnp.asarray(is_lo), jnp.asarray(is_hi)), use_pallas=False)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert bool(got.has_lo) == bool(want.has_lo) and bool(got.has_hi) == bool(want.has_hi)
    total = zero_moments(5, 4, device="cpu").add_(got).add_(got)
    np.testing.assert_allclose(total.total.numpy(), 2 * got.total.numpy(), rtol=1e-6)
    assert bool(total.has_hi) == bool(got.has_hi)
    # masking a row out equals leaving it out; float32 sums of the same terms
    # with zeros in between, in another blocking: 1e-6
    kept = bucket_moments(T(feats[valid]), T(idx[valid]), 5)
    torch.testing.assert_close(got.count, kept.count, rtol=0, atol=0)
    torch.testing.assert_close(got.total, kept.total, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.total_sq, kept.total_sq, rtol=1e-6, atol=1e-6)
    # the split-precision selector takes the same mask and edges; its three
    # bf16 terms rebuild each float32 value: 1e-6
    v2 = bucket_moments(T(feats), T(idx), 5, valid=T(valid), edge_labels=(T(is_lo), T(is_hi)),
                        use_kernel="v2")
    torch.testing.assert_close(v2.count, got.count, rtol=0, atol=0)
    torch.testing.assert_close(v2.total, got.total, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(v2.total_sq, got.total_sq, rtol=1e-6, atol=1e-6)
    assert bool(v2.has_lo) == bool(got.has_lo) and bool(v2.has_hi) == bool(got.has_hi)
    with pytest.raises(ValueError, match="use_kernel"):
        bucket_moments(T(feats), T(idx), 5, use_kernel=False)


@pytest.mark.parametrize("n,d,b", [(64, 32, 10), (100, 130, 21), (300, 512, 100)])
def test_moments_v2_match_jax(rng, n, d, b):
    """K4's plain version and the ``use_kernel="v2"`` selector against the
    Pallas kernel in interpret mode, the JAX ``use_pallas="v2"`` selector and
    a float64 one-hot oracle, at ``test_pallas.py``'s shapes and scales."""
    feats = (rng.normal(size=(n, d)) * rng.uniform(0.1, 30.0, size=(1, d))).astype(np.float32)
    idx = rng.integers(0, b, size=n).astype(np.int32)
    idx[:2] = -1  # masked-out samples
    plain = ck.segment_moments_v2_plain(T(feats), T(idx), b)
    sel = bucket_moments(T(feats), T(idx), b, use_kernel="v2")
    pal = pallas_moments_v2(jnp.asarray(feats), jnp.asarray(idx), b)
    jsel = j_bucket_moments(jnp.asarray(feats), jnp.asarray(idx), b, use_pallas="v2")
    onehot = np.zeros((n, b))
    onehot[np.arange(n)[idx >= 0], idx[idx >= 0]] = 1.0
    f64 = feats.astype(np.float64)
    oracle = (onehot.sum(0), onehot.T @ f64, onehot.T @ f64**2)
    for got in (plain, (sel.count, sel.total, sel.total_sq)):
        got = [t.numpy() for t in got]
        np.testing.assert_array_equal(got[0], oracle[0])  # counts are exact
        for want in (pal, (jsel.count, jsel.total, jsel.total_sq), oracle):
            np.testing.assert_array_equal(got[0], np.asarray(want[0]))
            # float32 sums of the same split terms in another order: the
            # tolerance of the TPU kernel's own test (test_pallas.py:141)
            np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=2e-6, atol=1e-5)
            np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=2e-6, atol=1e-5)


def test_split3_matches_jax(rng):
    from imbalanced_regression_tpu.ops.pallas_kernels import _split3

    x = (rng.normal(size=(64, 16)) * np.logspace(-3, 3, 16)).astype(np.float32)
    want = _split3(jnp.asarray(x))
    got = ck.split3(T(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        # round-to-nearest-even casts and exact float32 subtractions: bit-equal
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
    # three terms rebuild float32 to within its last bits
    rebuilt = sum(h.double() for h in got).numpy()
    np.testing.assert_allclose(rebuilt, x, rtol=2**-23, atol=0)


def test_row_chunks():
    """The row split is a function of the shapes and the card's SM count:
    one chunk for the age path's batch (no second pass), enough to fill a
    132-SM card at NYUD2's pixel batch, never under MIN_CHUNK_ROWS rows."""
    assert ck.row_chunks(64, 2048 // 32, 132) == 1
    assert ck.row_chunks(554_496, 128 // 32, 132) == 33  # K3: 4 x 33 = 132 blocks
    assert ck.row_chunks(554_496, 128 // 16, 2 * 132) == 33  # 8 column tiles x 33 = 264 blocks
    assert ck.row_chunks(8192, 64, 132) == 3
    assert ck.row_chunks(3 * ck.MIN_CHUNK_ROWS, 1, 1000) == 3
    assert ck.row_chunks(0, 4, 132) == 1


@pytest.mark.parametrize("n,d,kernel,chunks", [
    (64, 2048, "short", 1),  # the age stats pass
    (554_496, 128, "split", 33),  # the NYUD2 stats pass: 4 column tiles x 33 chunks
    (ck.SHORT_BATCH_MAX_ROWS, 2048, "short", 1),  # the last N of the short-batch kernel
    (ck.SHORT_BATCH_MAX_ROWS + 1, 2048, "split", 3),  # the first of the row split
    (0, 2048, "short", 1),  # an empty batch
])
def test_moments_plan(n, d, kernel, chunks):
    """K3's plan is a function of the shapes and the SM count: the
    short-batch kernel (one pass) up to SHORT_BATCH_MAX_ROWS rows, the row
    split with its chunks beyond."""
    assert ck.moments_plan(n, d, 132) == ck.MomentsPlan(kernel, chunks)


@pytest.mark.parametrize("n,d,chunks", [
    (554_496, 128, 49),  # the NYUD2 stats pass: 8 column tiles x 49 = 392 of 396 slots
    (64, 2048, 1),  # the age batch: 128 column tiles, one chunk
    (8192, 2048, 3),  # 3 x 128 = 384 blocks
    (5000, 4352, 1),  # 272 column tiles: one chunk, the wave left to the card
    (17, 24, 1),
    (0, 128, 1),  # an empty batch
    (3 * ck.MIN_CHUNK_ROWS, 8, 3),  # no chunk under MIN_CHUNK_ROWS rows
])
def test_v2_chunks(n, d, chunks):
    """K4's row chunks fill one wave of V2_BLOCKS_PER_SM blocks on a 132-SM
    card and never more: a function of the shapes and the SM count."""
    assert ck.v2_chunks(n, d, 132) == chunks
    assert chunks == 1 or chunks * -(-d // 16) <= ck.V2_BLOCKS_PER_SM * 132


# ---------------------------------------------------------- kernel wrappers (CPU)


def test_wrappers_take_plain_version_on_cpu(rng):
    """On a CPU tensor each wrapper returns its plain version and counts no
    launch."""
    x, e, ok, stats = _calibrate_inputs(rng)
    v1sum = stats[1].sum(1)
    ck.reset_launch_counts()
    out = ck.calibrate_forward(T(x), T(e), T(ok), *map(T, stats), T(v1sum), 0.1, 10.0, "nonzero")
    torch.testing.assert_close(out, calibrate_indexed(T(x), T(e), T(ok), *map(T, stats), T(v1sum),
                                                      0.1, 10.0, "nonzero"), rtol=0, atol=0)
    g = ck.calibrate_backward(T(x), T(e), T(ok), T(stats[1]), T(stats[3]), T(v1sum), 0.1, 10.0,
                              "nonzero")
    assert g.shape == x.shape
    c, s, q = ck.segment_moments(T(x), T(e), 12)
    assert c.sum().item() == (e >= 0).sum()
    c2, _, _ = ck.segment_moments_v2(T(x), T(e), 12)
    torch.testing.assert_close(c2, c, rtol=0, atol=0)
    assert len(ck.KERNEL_WRAPPERS) == 10
    assert all(fn.launches == 0 for fn in ck.KERNEL_WRAPPERS)
    assert not ck.segment_moments.kernels


def test_wrappers_reject_other_devices():
    meta = torch.empty((4, 4), device="meta")
    for fn in (ck.segment_moments, ck.segment_moments_v2):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta, torch.zeros(4, dtype=torch.int32, device="meta"), 3)


def test_kernel_sources_and_build_key():
    """The build is keyed by the sources: the library name is stable and
    lives in the package's build directory, which git ignores."""
    path = ck.library_path()
    assert path.parent == ck.BUILD_DIR and path.name.startswith("libfds_kernels_")
    assert path == ck.library_path()
    src = (ck.SOURCE_DIR / "fds_kernels.cu").read_text()
    for entry in ("fds_calibrate_fwd", "fds_calibrate_bwd", "fds_segment_moments",
                  "fds_moments_short_max_rows"):
        assert f"int {entry}(" in src
    v2 = (ck.SOURCE_DIR / "moments_v2.cu").read_text()
    for entry in ("fds_segment_moments_v2", "fds_moments_v2_blocks_per_sm"):
        assert f"int {entry}(" in v2
    lstm = (ck.SOURCE_DIR / "lstm_cell.cu").read_text()
    for entry in ("lstm_cell_fwd", "lstm_cell_bwd"):
        assert f"int {entry}(" in lstm
    moe = (ck.SOURCE_DIR / "moe_dispatch.cu").read_text()
    for entry in ("moe_dispatch_fwd", "moe_dispatch_bwd", "moe_combine_fwd", "moe_combine_bwd",
                  "moe_max_k"):
        assert f"int {entry}(" in moe
    assert set(ck._SIGNATURES) == {"fds_calibrate_fwd", "fds_calibrate_bwd", "fds_segment_moments",
                                   "fds_segment_moments_v2", "fds_moments_short_max_rows",
                                   "fds_moments_v2_blocks_per_sm", "lstm_cell_fwd",
                                   "lstm_cell_bwd", "moe_dispatch_fwd", "moe_dispatch_bwd",
                                   "moe_combine_fwd", "moe_combine_bwd", "moe_max_k"}
    # the plan's threshold is the short-batch kernel's limit; K4's chunks
    # assume the occupancy its register cap gives
    assert f"kShortMaxRows = {ck.SHORT_BATCH_MAX_ROWS};" in src
    assert f"kMinBlocksPerSM = {ck.V2_BLOCKS_PER_SM};" in v2
    assert f"kMaxK = {ck.MOE_MAX_K};" in moe and f"kMaxHeld = {ck.MOE_MAX_HELD};" in moe
    assert "kMaxRouteSlots = 200 * 1024;" in moe and ck.MOE_MAX_SLOTS == 200 * 1024
    assert "--use_fast_math" not in " ".join(ck.NVCC_FLAGS)
