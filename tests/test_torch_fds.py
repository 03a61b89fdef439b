"""The port's FDS state machine held against the JAX package on the CPU:
multi-epoch update → snapshot → smooth sequences for the age, hist and depth
groupings, edge gating, the epoch gates, empty-bucket imputation, dense
per-pixel hooks with the split-precision moments selector, and the numpy
state converter. Inputs are made with seeded numpy and handed to both
sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbalanced_regression_tpu import fds as jfds
from imbalanced_regression_tpu.ops.binning import bin_index_hist_np
from imbalanced_regression_tpu_torch import fds
from imbalanced_regression_tpu_torch.convert import fds_state_from_numpy
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck

T = torch.as_tensor
STATE_FIELDS = ("running_mean", "running_var", "running_mean_last_epoch", "running_var_last_epoch",
                "smoothed_mean_last_epoch", "smoothed_var_last_epoch", "num_samples_tracked")


def _configs(grouping, **kw):
    jcfg = {"age": jfds.FDSConfig.for_age, "hist": jfds.FDSConfig.for_sts,
            "depth": jfds.FDSConfig.for_depth}[grouping](**kw)
    tcfg = {"age": fds.FDSConfig.for_age, "hist": fds.FDSConfig.for_sts,
            "depth": fds.FDSConfig.for_depth}[grouping](**kw)
    return jcfg, tcfg


def _batch(rng, grouping, n, d, cfg):
    feats = (rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=(1, d))).astype(np.float32)
    if grouping == "age":
        labels = rng.integers(0, cfg.bucket_num + 8, size=n).astype(np.float32)
        labels[:2] = [cfg.bucket_start, cfg.bucket_num - 1]  # exact edge labels present
        return feats, labels[:, None], None
    if grouping == "hist":
        labels = rng.uniform(0, 5, size=n).astype(np.float32)
        labels = labels[labels < 3.5]  # leave the upper buckets empty → imputation
        return feats[: len(labels)], labels[:, None], bin_index_hist_np(labels, cfg.bucket_num)
    labels = rng.uniform(0.5, 10.0, size=n).astype(np.float32)
    return feats, labels, None


def _assert_states_close(tstate, jstate, rtol, atol):
    assert tstate.epoch == int(jstate.epoch)
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("grouping,kw", [
    ("age", dict(feature_dim=12, bucket_num=20, bucket_start=2, momentum=0.9)),
    ("age", dict(feature_dim=12, bucket_num=20, momentum=None)),
    ("hist", dict(feature_dim=10, bucket_num=25)),
    ("depth", dict(feature_dim=8, bucket_num=100, bucket_start=7)),
])
def test_fds_sequence_matches_jax(rng, grouping, kw):
    """Three epochs of (two-batch moments → snapshot → EMA update), then
    calibration with the resulting snapshot, in both packages."""
    jcfg, tcfg = _configs(grouping, **kw)
    jstate, tstate = jfds.fds_init(jcfg), fds.fds_init(tcfg, device="cpu")
    for epoch in range(3):
        jm, tm = jfds.fds_zero_moments(jcfg), fds.fds_zero_moments(tcfg, device="cpu")
        for _ in range(2):
            feats, labels, bidx = _batch(rng, grouping, 48, tcfg.feature_dim, tcfg)
            jm = jm + jfds.fds_bucket_moments(jcfg, feats, labels,
                                              None if bidx is None else jnp.asarray(bidx))
            tm.add_(fds.fds_bucket_moments(tcfg, T(feats), T(labels),
                                           None if bidx is None else T(bidx)))
        jstate = jfds.fds_apply_moments(jcfg, jfds.fds_update_last_epoch_stats(jcfg, jstate, epoch),
                                        jm, epoch)
        tstate = fds.fds_apply_moments(tcfg, fds.fds_update_last_epoch_stats(tcfg, tstate, epoch),
                                       tm, epoch)
        # float32 moments summed in another order, then variances of
        # differences: 1e-4 relative
        _assert_states_close(tstate, jstate, rtol=1e-4, atol=1e-5)
    assert np.abs(tstate.smoothed_mean_last_epoch.numpy()).sum() > 0  # non-trivial snapshot

    feats, labels, bidx = _batch(rng, grouping, 40, tcfg.feature_dim, tcfg)
    for use_pallas in (False, True):
        want = np.asarray(jfds.fds_smooth(jcfg, jstate, feats, labels, 3,
                                          None if bidx is None else jnp.asarray(bidx),
                                          use_pallas=use_pallas))
        got = fds.fds_smooth(tcfg, tstate, T(feats), T(labels), 3,
                             None if bidx is None else T(bidx)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert not np.allclose(got, feats)


@pytest.mark.parametrize("use_kernel", [None, "v2"])
def test_dense_depth_hook_matches_jax(rng, use_kernel):
    """NYUD2's hook is a per-pixel map [N, H, W, C] with [N, H, W, 1] depth
    targets: the moments (K3, or K4 with ``use_kernel="v2"``) and the
    calibration take it as N*H*W rows, as the JAX functions do."""
    jcfg, tcfg = _configs("depth", feature_dim=16)
    feats = (rng.normal(size=(3, 6, 8, 16)) * rng.uniform(0.1, 30.0, size=16)).astype(np.float32)
    depth = rng.uniform(0.5, 10.0, size=(3, 6, 8, 1)).astype(np.float32)
    want = jfds.fds_bucket_moments(jcfg, feats, depth,
                                   use_pallas="v2" if use_kernel == "v2" else False)
    got = fds.fds_bucket_moments(tcfg, T(feats), T(depth), use_kernel=use_kernel)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    # float32 sums in another order (v2: of the same bf16 split terms); the
    # tolerance of the TPU kernel's own test (test_pallas.py:141)
    np.testing.assert_allclose(got.total.numpy(), np.asarray(want.total), rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(got.total_sq.numpy(), np.asarray(want.total_sq), rtol=2e-6,
                               atol=1e-5)

    jstate = jfds.fds_update_last_epoch_stats(
        jcfg, jfds.fds_apply_moments(jcfg, jfds.fds_init(jcfg), want, 0), 1)
    tstate = fds.fds_update_last_epoch_stats(
        tcfg, fds.fds_apply_moments(tcfg, fds.fds_init(tcfg, device="cpu"), got, 0), 1)
    smoothed = fds.fds_smooth(tcfg, tstate, T(feats), T(depth), 1)
    assert smoothed.shape == feats.shape
    np.testing.assert_allclose(smoothed.numpy(), np.asarray(jfds.fds_smooth(jcfg, jstate, feats,
                                                                            depth, 1)),
                               rtol=1e-4, atol=1e-4)
    assert not np.allclose(smoothed.numpy(), feats)


def test_age_edge_gating_matches_jax(rng):
    """Pooled out-of-range labels act only when the exact edge label is in
    the batch, for both the update and the calibration."""
    jcfg, tcfg = _configs("age", feature_dim=6, bucket_num=10, bucket_start=2)
    feats = rng.normal(size=(30, 6)).astype(np.float32)
    labels = rng.integers(3, 9, size=30).astype(np.float32)
    labels[:4] = [0.0, 1.0, 12.0, 15.0]  # pooled, but no exact edge label
    jstate, tstate = jfds.fds_init(jcfg), fds.fds_init(tcfg, device="cpu")
    jstate = jfds.fds_update_running_stats(jcfg, jstate, feats, labels, 0)
    tstate = fds.fds_update_running_stats(tcfg, tstate, T(feats), T(labels), 0)
    _assert_states_close(tstate, jstate, rtol=1e-5, atol=1e-6)
    assert tstate.num_samples_tracked[0] == 0 and tstate.num_samples_tracked[-1] == 0
    jstate = jfds.fds_update_last_epoch_stats(jcfg, jstate, 1)
    tstate = fds.fds_update_last_epoch_stats(tcfg, tstate, 1)
    want = np.asarray(jfds.fds_smooth(jcfg, jstate, feats, labels, 1))
    got = fds.fds_smooth(tcfg, tstate, T(feats), T(labels), 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[:4], feats[:4])


def test_epoch_gates(rng):
    cfg = fds.FDSConfig.for_age(feature_dim=4, bucket_num=8, start_update=1, start_smooth=2)
    state = fds.fds_init(cfg, device="cpu")
    feats = T(rng.normal(size=(10, 4)).astype(np.float32))
    labels = T(rng.integers(1, 6, size=10).astype(np.float32))
    # identity before start_smooth, without touching the kernels
    ck.reset_launch_counts()
    assert fds.fds_smooth(cfg, state, feats, labels, 1) is feats
    # stale epoch: update skipped
    assert fds.fds_update_running_stats(cfg, state, feats, labels, 0) is state
    # snapshot only on epoch == state.epoch + 1
    assert fds.fds_update_last_epoch_stats(cfg, state, 1) is state
    assert fds.fds_update_last_epoch_stats(cfg, state, 2).epoch == 2
    reset = fds.fds_reset(fds.fds_update_running_stats(cfg, state, feats, labels, 1))
    assert reset.epoch == 1 and float(reset.num_samples_tracked.sum()) == 0.0
    with pytest.raises(ValueError, match="feature dimension"):
        fds.fds_smooth(cfg, state, feats[:, :3], labels, 2)
    with pytest.raises(ValueError, match="bucket_idx"):
        fds.fds_bucket_moments(fds.FDSConfig.for_sts(feature_dim=4), feats, labels)


def test_fds_state_from_numpy_roundtrip(rng):
    jcfg = jfds.FDSConfig.for_age(feature_dim=5, bucket_num=9)
    jstate = jfds.fds_init(jcfg)
    jstate = jfds.fds_update_running_stats(
        jcfg, jstate, rng.normal(size=(20, 5)).astype(np.float32),
        rng.integers(0, 9, size=20).astype(np.float32), 0)
    arrays = {f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS + ("epoch",)}
    tstate = fds_state_from_numpy(arrays, device="cpu")
    _assert_states_close(tstate, jstate, rtol=0, atol=0)
    with pytest.raises(KeyError):
        fds_state_from_numpy({"epoch": 0}, device="cpu")
