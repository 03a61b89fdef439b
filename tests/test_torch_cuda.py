"""The CUDA kernels against their plain PyTorch versions on the card, at the
age slice's shapes (N = 128 rows, D = 2048, B = 100 buckets) with the corner
cases of the JAX tests. Marked ``cuda``: they skip where there is no GPU.

This file imports neither jax nor the JAX package, so it also runs on a
machine with only PyTorch; there, skip the repository's conftest (which
imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.ops.calibrate import calibrate_indexed, calibrate_indexed_grad
N, D, B = 128, 2048, 100
MODES = [("nonzero", (0.1, 10.0)), ("positive", (0.5, 2.0))]


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none. Decided
    when the test runs, never at import, so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


def _inputs(rng, dev):
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    x = rng.normal(size=(N, D)).astype(np.float32)
    e = rng.integers(0, B, size=N).astype(np.int32)
    e[:3] = -1  # rows outside every bucket pass through
    ok = rng.random(N) > 0.2
    m1, m2 = rng.normal(size=(2, B, D)).astype(np.float32)
    v1, v2 = rng.uniform(0.01, 3.0, size=(2, B, D)).astype(np.float32)
    v1[2, :] = 0.0  # all-zero v1 row
    v1[5, 3] = 0.0  # single zero column
    v2[6, 1] = -1.0  # negative v2 (positive-mode column guard)
    v2[7, :5] = 100.0  # ratio above clip_max
    return t(x), t(e), t(ok), tuple(map(t, (m1, v1, m2, v2))), t(v1.sum(1))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,clips", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_calibrate_kernels_match_plain(cuda_device, mode, clips, dtype):
    x, e, ok, stats, v1sum = _inputs(np.random.default_rng(0), cuda_device)
    args = (x.to(dtype), e, ok, *stats, v1sum, *clips, mode)
    # IEEE division/sqrt and unfused mul/add in the plain version's order
    torch.testing.assert_close(ck.calibrate_forward(*args), calibrate_indexed(*args),
                               rtol=1e-6, atol=1e-6)
    g = torch.randn(N, D, device=cuda_device)
    bargs = (g, e, ok, stats[1], stats[3], v1sum, *clips, mode)
    torch.testing.assert_close(ck.calibrate_backward(*bargs), calibrate_indexed_grad(*bargs),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_calibrate_autograd_uses_kernels(cuda_device):
    x, e, ok, stats, v1sum = _inputs(np.random.default_rng(1), cuda_device)
    ck.reset_launch_counts()
    xg = x.clone().requires_grad_(True)
    ck.FDSCalibrate.apply(xg, e, ok, *stats, v1sum, 0.1, 10.0, "nonzero").square().sum().backward()
    xp = x.clone().requires_grad_(True)
    calibrate_indexed(xp, e, ok, *stats, v1sum, 0.1, 10.0, "nonzero").square().sum().backward()
    torch.testing.assert_close(xg.grad, xp.grad, rtol=1e-6, atol=1e-6)
    assert (ck.calibrate_forward.launches, ck.calibrate_backward.launches) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [N, 8192])
def test_moments_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(2)
    feats = torch.as_tensor(rng.normal(size=(n, D)).astype(np.float32)).to(cuda_device)
    idx = rng.integers(0, B, size=n).astype(np.int32)
    idx[::7] = -1
    idx = torch.as_tensor(idx).to(cuda_device)
    c, s, q = ck.segment_moments(feats, idx, B)
    pc, ps, pq = ck.segment_moments_plain(feats, idx, B)
    torch.testing.assert_close(c, pc, rtol=0, atol=0)  # counts are exact
    # float32 sums in another order than the one-hot matmul
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(q, pq, rtol=1e-5, atol=1e-5)
    c2, s2, q2 = ck.segment_moments(feats, idx, B)
    assert torch.equal(c, c2) and torch.equal(s, s2) and torch.equal(q, q2)  # deterministic


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    x, e, ok, stats, v1sum = _inputs(np.random.default_rng(3), cuda_device)
    with pytest.raises(TypeError):
        ck.calibrate_forward(x, e.long(), ok, *stats, v1sum, 0.1, 10.0, "nonzero")
    with pytest.raises(ValueError, match="contiguous"):
        ck.calibrate_forward(x.T.contiguous().T, e, ok, *stats, v1sum, 0.1, 10.0, "nonzero")
    with pytest.raises(ValueError, match="is on"):
        ck.segment_moments(x, e.cpu(), B)
