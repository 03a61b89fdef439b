"""The CUDA kernels against their plain PyTorch versions on the card, at the
age slice's shapes (N = 128 rows, D = 2048, B = 100 buckets) with the corner
cases of the JAX tests, and the segment-moments kernels (K3, K4) also
against a float64 reference at shapes that take one and several row
chunks; the depth decoder's bf16 resize under CUDA autocast (bf16 maps
into every UpProjection's convolutions, its gradient against float64); the
kernels at the AgeDB-DIR batch (N = 256, D = 2048, B = 97); and the
prefetched staging of train batches through pinned memory on a side
stream (byte-equal batches with the pinned ring reused, an age epoch and
stats pass bit-equal to the synchronous copies); frozen predictors
exported and reloaded on the card, bit-equal to ``predict_batch``; and
data parallelism on the card: a float32 ResNet-50 step on two gloo ranks
sharing it against one process, and a one-rank NCCL step bit-equal to the
step without a mesh. Marked ``cuda``: they skip where there is no GPU.

This file imports neither jax nor the JAX package, so it also runs on a
machine with only PyTorch; there, skip the repository's conftest (which
imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imbalanced_regression_tpu_torch.models.depth_encdec import DepthEncoderDecoder, _resize_bilinear
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
@pytest.mark.parametrize("factored", [True, False])
def test_calibrate_kernels_take_many_rows(cuda_device, monkeypatch, factored):
    """Many rows (4 x 65,535 + 5), as NYUD2's per-pixel rows are (554,496 at
    batch 32), in the factored form and in the direct one (the plan with
    the factored form's least rows out of reach)."""
    if not factored:
        monkeypatch.setattr(ck, "FACTORED_ROWS_PER_BUCKET", 2**40)
        ck.calibrate_plan.cache_clear()
    rng = np.random.default_rng(5)
    n, d, b = 4 * 65_535 + 5, 8, 10
    t = lambda a: torch.as_tensor(a).to(cuda_device)  # noqa: E731
    x = t(rng.normal(size=(n, d)).astype(np.float32))
    e = t(rng.integers(-1, b, size=n).astype(np.int32))
    ok = t(rng.random(n) > 0.2)
    m1, m2 = (t(rng.normal(size=(b, d)).astype(np.float32)) for _ in range(2))
    v1, v2 = (t(rng.uniform(0.01, 3.0, size=(b, d)).astype(np.float32)) for _ in range(2))
    args = (x, e, ok, m1, v1, m2, v2, v1.sum(1), 0.2, 5.0, "positive")
    sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert ck.calibrate_plan(n, d, b, sm).factored == factored
    torch.testing.assert_close(ck.calibrate_forward(*args), calibrate_indexed(*args),
                               rtol=1e-6, atol=1e-6)
    bargs = (x, e, ok, v1, v2, v1.sum(1), 0.2, 5.0, "positive")
    torch.testing.assert_close(ck.calibrate_backward(*bargs), calibrate_indexed_grad(*bargs),
                               rtol=1e-6, atol=1e-6)
    ck.calibrate_plan.cache_clear()  # the monkeypatched constant goes back after the test


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


# K1/K2 at the boundary of calibrate_plan's two forms of K1, the factored
# form's least rows and one row short of it, at D = 128 (16-byte loads) and
# D = 130 (the scalar path); no N is a multiple of a block's rows. K2 runs
# its direct form at both.
CALIBRATE_REGIMES = ["factored", "direct_one_row_short", "scalar_factored",
                     "scalar_direct_one_row_short"]


def _regime_case(name: str, sm_count: int):
    """(N, D, B, factored) of case ``name`` on a card with ``sm_count`` SMs."""
    d, b = (130, 12) if name.startswith("scalar") else (128, 93)
    least = ck.FACTORED_ROWS_PER_BUCKET * b * sm_count
    return (least - 1, d, b, False) if name.endswith("short") else (least + 5, d, b, True)


def _regime_inputs(dev, n, d, b, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=dev)
    e = torch.randint(-1, b + 1, (n,), generator=gen, device=dev, dtype=torch.int32)  # -1 and B too
    ok = torch.rand(n, generator=gen, device=dev) > 0.2
    m1, m2 = torch.randn(2, b, d, generator=gen, device=dev)
    v1, v2 = 0.01 + 2.99 * torch.rand(2, b, d, generator=gen, device=dev)
    v1[2] = 0.0  # all-zero v1 row
    v1[3] = 1e-15  # v1sum below 1e-10
    v1[:, 5] = 0.0  # a zero column
    v2[6, 1] = -1.0  # negative v2
    v2[7, :5] = 100.0  # ratio above clip_max
    x[e == 2] = -0.0  # passed through with its sign bit
    return x, e, ok, (m1.contiguous(), v1.contiguous(), m2.contiguous(), v2.contiguous()), v1.sum(1)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", CALIBRATE_REGIMES)
def test_calibrate_regimes_bit_equal(cuda_device, regime):
    sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n, d, b, factored = _regime_case(regime, sm)
    plan = ck.calibrate_plan(n, d, b, sm)
    assert plan.factored == factored and plan.cols == (1 if d % 4 else 4), plan
    assert not ck.calibrate_plan(n, d, b, sm, bwd=True).factored  # K2: the direct form
    x, e, ok, stats, v1sum = _regime_inputs(cuda_device, n, d, b, seed=len(regime))
    g = torch.randn(n, d, device=cuda_device)
    for mode, clips in MODES:
        for xs in (x, x.to(torch.bfloat16)):
            args = (xs, e, ok, *stats, v1sum, *clips, mode)
            assert torch.equal(ck.calibrate_forward(*args), calibrate_indexed(*args)), (mode, xs.dtype)
        bargs = (g, e, ok, stats[1], stats[3], v1sum, *clips, mode)
        assert torch.equal(ck.calibrate_backward(*bargs), calibrate_indexed_grad(*bargs)), mode


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


def _moments_inputs(n, d, b, dev, pattern="random", dtype=torch.float32):
    """Features with a per-column scale (as ``test_pallas.py`` gives K4's
    TPU version) in ``dtype``, and bucket indices: uniform ("random"), all
    in one bucket ("one"), in runs along rows of 152 pixels ("runs": a ramp
    of at most 0.2 buckets a pixel from a random bucket in each row, as a
    depth map's rows in NHWC order give), or none ("none": every row -1);
    every 7th row outside the buckets."""
    rng = np.random.default_rng(4)
    feats = (rng.normal(size=(n, d)) * rng.uniform(0.1, 30.0, size=(1, d))).astype(np.float32)
    if pattern == "random":
        idx = rng.integers(0, b, size=n)
    elif pattern == "one":
        idx = np.full(n, b // 2)
    elif pattern == "none":
        idx = np.full(n, -1)
    else:
        rows = -(-n // 152)
        ramp = rng.uniform(0, b, size=(rows, 1)) + rng.uniform(-0.2, 0.2, size=(rows, 1)) * np.arange(152)
        idx = np.clip(np.floor(ramp), 0, b - 1).reshape(-1)[:n]
    idx = idx.astype(np.int32)
    idx[::7] = -1
    return torch.as_tensor(feats).to(dev).to(dtype), torch.as_tensor(idx).to(dev)


def _float64_moments(feats, idx, b):
    """counts, sums, sums of squares and sums of |f| in float64."""
    valid = (idx >= 0) & (idx < b)
    f, i = feats[valid].double(), idx[valid].long()
    zeros = lambda: torch.zeros((b, feats.shape[1]), dtype=torch.float64, device=feats.device)  # noqa: E731
    count = torch.zeros(b, dtype=torch.float64, device=feats.device).index_add_(
        0, i, torch.ones_like(i, dtype=torch.float64))
    return count, zeros().index_add_(0, i, f), zeros().index_add_(0, i, f * f), \
        zeros().index_add_(0, i, f.abs())


F32, BF16 = torch.float32, torch.bfloat16
SHORT = ck.SHORT_BATCH_MAX_ROWS
# (N, D, B, index pattern, feature dtype): the age shape (K3's short-batch
# kernel, one row chunk), in float32 and bf16 (its 8-byte vector loads); the
# short kernel's last N and the row split's first; the short kernel on a
# ragged last column tile (D % 4 != 0), in float32 and bf16 (its scalar
# loads); 3 chunks with ragged column tiles; 33 chunks at D = 128 (the NYUD2
# hook width) on a 132-SM card; the row split in one chunk (so many column
# tiles that they fill the card alone, no second pass); every row in one
# bucket (the row split's merge takes whole groups; the short kernel's one
# warp takes every row); runs of equal buckets as depth maps give; bf16 at
# the NYUD2 stats-pass shape; 512 buckets on both K3 kernels (beyond K4's
# 128, so K3 only); for K4's register design: all 16 of its eight-bucket
# tiles (B = 128) and one (B = 1), a ragged last column tile (D = 24) and a
# half one (D = 8), odd D (its scalar loads), one full 16-row step and one
# row (N = 17), and no row in any bucket
MOMENT_CASES = [
    (N, D, B, "random", F32), (N, D, B, "random", BF16), (SHORT, D, B, "random", F32),
    (SHORT + 1, D, B, "random", F32), (300, 130, 21, "random", F32),
    (300, 130, 21, "random", BF16), (3000, 100, 21, "random", F32),
    (50_000, 128, 93, "random", F32), (5000, 4352, 8, "random", F32),
    (50_000, 128, 93, "one", F32), (64, D, B, "one", F32),
    (50_000, 128, 93, "runs", F32), (554_496, 128, 93, "random", BF16),
    (64, D, 512, "random", F32), (20_000, 64, 512, "random", F32),
    (50_000, 128, 128, "random", F32), (3000, 128, 1, "random", F32),
    (3000, 24, 21, "random", F32), (3000, 8, 21, "random", F32), (300, 7, 21, "random", F32),
    (17, 128, 93, "random", F32), (3000, 128, 93, "none", F32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,n,d,b,pattern,dtype", [
    (kernel, *case) for kernel in ("segment_moments", "segment_moments_v2") for case in MOMENT_CASES
    if kernel == "segment_moments" or (case[4] == F32 and case[2] <= ck.V2_MAX_BUCKETS)])
def test_moments_kernels_match_float64(cuda_device, kernel, n, d, b, pattern, dtype):
    feats, idx = _moments_inputs(n, d, b, cuda_device, pattern, dtype)
    fn, plain = getattr(ck, kernel), getattr(ck, f"{kernel}_plain")
    ck.reset_launch_counts()
    c, s, q = fn(feats, idx, b)
    assert fn.launches == 1
    if kernel == "segment_moments":
        sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        assert ck.segment_moments.kernels == {ck.moments_plan(n, d, sm).kernel: 1}
    count, total, total_sq, total_abs = _float64_moments(feats, idx, b)
    torch.testing.assert_close(c.double(), count, rtol=0, atol=0)  # counts are exact
    # float32 sums in row order, against exact ones: within 1e-5 of the
    # bucket's sum of |f| (of f*f for the sums of squares)
    assert bool(((s.double() - total).abs() <= 1e-5 * total_abs).all())
    assert bool(((q.double() - total_sq).abs() <= 1e-5 * total_sq).all())
    pc, ps, pq = plain(feats, idx, b)
    torch.testing.assert_close(c, pc, rtol=0, atol=0)
    # the plain one-hot matmul sums in another order
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-5 * float(total_abs.max()))
    torch.testing.assert_close(q, pq, rtol=1e-5, atol=1e-5 * float(total_sq.max()))
    c2, s2, q2 = fn(feats, idx, b)
    assert torch.equal(c, c2) and torch.equal(s, s2) and torch.equal(q, q2)  # deterministic


@pytest.mark.cuda
def test_upprojections_convolve_bf16_maps(cuda_device):
    """Under CUDA autocast every UpProjection resizes its bf16 map in bf16, so
    each of its convolutions gets a bf16 input (``F.interpolate`` would hand
    them float32 maps)."""
    model = DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8).to(
        cuda_device, memory_format=torch.channels_last)
    seen = []
    ups = [*model.d_up, *model.mff_up]
    for up in ups:
        for conv in (up.conv1, up.conv1_2, up.conv2):
            conv.register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    hook = model(x)
    hook.sum().backward()
    assert seen == [torch.bfloat16] * (3 * len(ups))


# the gradient of the bf16 resize against float64: the weights, the width
# pass and the output are each rounded to bf16 (2**-9 of a value), about
# 2**-7.5 of the largest magnitude in all; bf16 atomic adds (~870 into each
# input pixel at 8x10 -> 114x152) lose about 2**-4.5
RESIZE_TOL = 2.0**-6


@pytest.mark.cuda
def test_bf16_resize_gradient_matches_float64(cuda_device):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 64, 8, 10, generator=gen).to(torch.bfloat16)
    g = torch.randn(4, 64, 114, 152, generator=gen).to(torch.bfloat16)
    xt = x.to(cuda_device, memory_format=torch.channels_last).requires_grad_(True)
    y = _resize_bilinear(xt, (114, 152))
    y.backward(g.to(cuda_device, memory_format=torch.channels_last))
    x64 = x.to(cuda_device, torch.float64).requires_grad_(True)
    y64 = F.interpolate(x64, size=(114, 152), mode="bilinear", align_corners=False)
    y64.backward(g.to(cuda_device, torch.float64))
    assert y.dtype == xt.grad.dtype == torch.bfloat16
    assert y.is_contiguous(memory_format=torch.channels_last)
    for got, want in ((y.detach(), y64.detach()), (xt.grad, x64.grad)):
        err = float((got.double() - want).abs().max())
        assert err <= RESIZE_TOL * float(want.abs().max()), (err, float(want.abs().max()))


@pytest.mark.cuda
def test_moments_v2_rejects_bad_inputs(cuda_device):
    feats, idx = _moments_inputs(64, 32, 8, cuda_device)
    with pytest.raises(TypeError):
        ck.segment_moments_v2(feats.to(torch.bfloat16), idx, 8)
    with pytest.raises(ValueError, match="buckets"):
        ck.segment_moments_v2(feats, idx, ck.V2_MAX_BUCKETS + 1)


# ---------------------------------------------------------------- STS-B shape
STS_N, STS_D, STS_B = 128, 12000, 50  # batch 128, the 12000-d pair embedding, 50 buckets


@pytest.mark.cuda
def test_kernels_at_sts_shape(cuda_device):
    """K1 and K2 bit-equal to their plain versions and K3 within 1e-5 at the
    STS-B shape (12000 = 93 x 128 + 96: the last column tile is partial),
    with an empty bucket and rows of a bucket whose v1 sums to under 1e-10."""
    rng = np.random.default_rng(11)
    t = lambda a: torch.as_tensor(a).to(cuda_device)  # noqa: E731
    x = rng.normal(size=(STS_N, STS_D)).astype(np.float32)
    e = rng.integers(0, STS_B - 1, size=STS_N).astype(np.int32)  # bucket 49 stays empty
    e[:4] = 3
    ok = rng.random(STS_N) > 0.1
    m1, m2 = rng.normal(size=(2, STS_B, STS_D)).astype(np.float32)
    v1, v2 = rng.uniform(0.01, 3.0, size=(2, STS_B, STS_D)).astype(np.float32)
    v1[3] = 1e-15  # v1sum 1.2e-11: those rows pass through
    v2[5, :7] = -1.0
    x, e, ok, m1, v1, m2, v2 = map(t, (x, e, ok, m1, v1, m2, v2))
    args = (x, e, ok, m1, v1, m2, v2, v1.sum(1), 0.5, 2.0, "positive")
    out = ck.calibrate_forward(*args)
    assert torch.equal(out, calibrate_indexed(*args))
    assert torch.equal(out[:4], x[:4])
    g = torch.randn(STS_N, STS_D, device=cuda_device)
    bargs = (g, e, ok, v1, v2, v1.sum(1), 0.5, 2.0, "positive")
    assert torch.equal(ck.calibrate_backward(*bargs), calibrate_indexed_grad(*bargs))
    ck.reset_launch_counts()
    c, s, q = ck.segment_moments(x, e, STS_B)
    assert ck.segment_moments.kernels == {"short": 1}
    pc, ps, pq = ck.segment_moments_plain(x, e, STS_B)
    torch.testing.assert_close(c, pc, rtol=0, atol=0)
    assert c[-1] == 0 and not s[-1].any() and not q[-1].any()
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-5 * float(ps.abs().max()))
    torch.testing.assert_close(q, pq, rtol=1e-5, atol=1e-5 * float(pq.abs().max()))


def _sts_encoder(dtype, lstm_impl="fused"):
    from imbalanced_regression_tpu_torch.models.bilstm_pair import PairBiLSTMEncoder

    enc = PairBiLSTMEncoder(40, d_word=16, d_hid=24, n_layers=2, n_highway=1, train_words=True,
                            lstm_impl=lstm_impl, dtype=dtype)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    return enc.eval()


def _sts_batch(device):
    rng = np.random.default_rng(12)
    out = {}
    for col, steps in (("1", 9), ("2", 6)):
        lengths = rng.integers(1, steps + 1, 12)
        mask = (np.arange(steps)[None] < lengths[:, None]).astype(np.float32)
        out[f"tokens{col}"] = torch.as_tensor(rng.integers(2, 40, (12, steps)).astype(np.int32)
                                              * mask.astype(np.int32)).to(device)
        out[f"mask{col}"] = torch.as_tensor(mask).to(device)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)])
def test_pair_encoder_on_card_matches_cpu(cuda_device, dtype, tol):
    """The STS-B encoder's forward and weight gradients on the card against
    the same weights on the CPU (TF32 off): the output within 1e-5 of its
    largest magnitude in float32 and within 2^-6 in bf16; each gradient
    within 1e-4 (float32) or 2^-4 (bf16, forty bf16 rounds of the
    recurrence on each side, in other summation orders) of its largest."""
    _hold_encoder_on_card(cuda_device, dtype, tol, "fused")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)])
def test_per_direction_pair_encoder_on_card_matches_cpu(cuda_device, dtype, tol):
    """The same for the per-direction BiLSTM layout (``lstm_impl="flax"``)."""
    _hold_encoder_on_card(cuda_device, dtype, tol, "flax")


def _hold_encoder_on_card(cuda_device, dtype, tol, lstm_impl):
    from imbalanced_regression_tpu_torch.train import set_numerics

    set_numerics()
    cpu = _sts_encoder(dtype, lstm_impl)
    card = _sts_encoder(dtype, lstm_impl).to(cuda_device)
    outs = []
    for mod, dev in ((cpu, "cpu"), (card, cuda_device)):
        out = mod(_sts_batch(dev))
        out.square().sum().backward()
        outs.append((out.detach().cpu(), {k: p.grad.cpu() for k, p in mod.named_parameters()}))
    (want, want_g), (got, got_g) = outs
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    for k, w in want_g.items():
        g_tol = 10 * tol if dtype == torch.float32 else 4 * tol
        assert float((got_g[k] - w).abs().max()) <= g_tol * float(w.abs().max()), k


# ------------------------------------------- AgeDB-DIR batch and staged input
# the AgeDB-DIR recipe's batch (K1/K2/K3 rows on the real-data path) and its
# buckets: bucket_num 100 from bucket_start 3
AGEDB_N, AGEDB_B = 256, 97


@pytest.mark.cuda
def test_kernels_at_agedb_batch(cuda_device):
    """K1 and K2 within 1e-6 of their plain versions and K3 (its short-batch
    kernel) within 1e-5 at N = 256, D = 2048, B = 97, with the corner cases
    of the JAX tests."""
    rng = np.random.default_rng(14)
    t = lambda a: torch.as_tensor(a).to(cuda_device)  # noqa: E731
    x = rng.normal(size=(AGEDB_N, D)).astype(np.float32)
    e = rng.integers(0, AGEDB_B, size=AGEDB_N).astype(np.int32)
    e[:3] = -1
    ok = rng.random(AGEDB_N) > 0.2
    m1, m2 = rng.normal(size=(2, AGEDB_B, D)).astype(np.float32)
    v1, v2 = rng.uniform(0.01, 3.0, size=(2, AGEDB_B, D)).astype(np.float32)
    v1[2, :] = 0.0
    v2[6, 1] = -1.0
    x, e, ok, m1, v1, m2, v2 = map(t, (x, e, ok, m1, v1, m2, v2))
    for mode, clips in MODES:
        for xs in (x, x.to(torch.bfloat16)):
            args = (xs, e, ok, m1, v1, m2, v2, v1.sum(1), *clips, mode)
            torch.testing.assert_close(ck.calibrate_forward(*args), calibrate_indexed(*args),
                                       rtol=1e-6, atol=1e-6)
        g = torch.randn(AGEDB_N, D, device=cuda_device)
        bargs = (g, e, ok, v1, v2, v1.sum(1), *clips, mode)
        torch.testing.assert_close(ck.calibrate_backward(*bargs), calibrate_indexed_grad(*bargs),
                                   rtol=1e-6, atol=1e-6)
    ck.reset_launch_counts()
    c, s, q = ck.segment_moments(x, e, AGEDB_B)
    assert ck.segment_moments.kernels == {"short": 1}
    pc, ps, pq = ck.segment_moments_plain(x, e, AGEDB_B)
    torch.testing.assert_close(c, pc, rtol=0, atol=0)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-5 * float(ps.abs().max()))
    torch.testing.assert_close(q, pq, rtol=1e-5, atol=1e-5 * float(pq.abs().max()))


@pytest.mark.cuda
def test_pinned_staging_equals_host_batches(cuda_device):
    """200 batches prefetched through pinned buffers on a side stream, while
    the compute stream lags behind the copies (a sleep kernel before each
    read): every device batch equals its host batch byte for byte, so the
    compute stream waited on each copy and no block was handed out again
    while it was read; the ring's pinned buffers were allocated once and
    reused."""
    import contextlib

    from imbalanced_regression_tpu_torch.data.staging import PinnedStager
    from imbalanced_regression_tpu_torch.data.streaming import prefetch_batches

    rng = np.random.default_rng(15)
    host = [{"input": rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8),
             "target": rng.normal(size=(64, 1)).astype(np.float32),
             "nested": {"idx": rng.integers(-1, 9, 64).astype(np.int32)}, "count": 64}
            for _ in range(200)]
    stager = PinnedStager(cuda_device, torch.cuda.Stream(cuda_device))
    copies = []
    with contextlib.closing(prefetch_batches(iter(host), transform=stager)) as staged:
        for item in staged:
            b = item.wait()
            torch.cuda._sleep(1_000_000)
            copies.append({"input": b["input"].clone(), "target": b["target"].clone(),
                           "idx": b["nested"]["idx"].clone()})
            del b, item
    torch.cuda.synchronize()
    assert len(copies) == 200
    for h, c in zip(host, copies):
        assert np.array_equal(c["input"].cpu().numpy(), h["input"])
        assert np.array_equal(c["target"].cpu().numpy(), h["target"])
        assert np.array_equal(c["idx"].cpu().numpy(), h["nested"]["idx"])
    slots = len(stager.buffers)
    assert stager.allocations == 3 * slots
    assert all(buf.is_pinned() for slot in stager.buffers for buf in slot.values())
    assert len({buf.data_ptr() for slot in stager.buffers for buf in slot.values()}) == 3 * slots


@pytest.mark.cuda
def test_staged_age_epoch_matches_synchronous_copies(cuda_device):
    """One age epoch (K1 and K2 from ``start_smooth = 0``) and a stats pass
    (K3) through the prefetching staging give losses, weights and FDS
    moments bit-equal to the same steps fed by the synchronous
    ``_to_device`` copy (``cudnn.deterministic``)."""
    from imbalanced_regression_tpu_torch.data.augment import random_crop_flip_normalize
    from imbalanced_regression_tpu_torch.data.batching import batch_iterator
    from imbalanced_regression_tpu_torch.data.synthetic import synthetic_age_dataset
    from imbalanced_regression_tpu_torch.fds import FDSConfig
    from imbalanced_regression_tpu_torch.models.resnet import RegressionHead, ResNetBasicBackbone
    from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig

    def trainer():
        return Trainer(ResNetBasicBackbone(stage_sizes=(1, 1), width=8, dtype=torch.float32),
                       RegressionHead(16), TrainerConfig(loss="l1", lr=1e-3),
                       fds_config=FDSConfig.for_age(feature_dim=16, bucket_num=100,
                                                    start_smooth=0),
                       train_augment=random_crop_flip_normalize, device=cuda_device)

    data = synthetic_age_dataset(n=160, img_size=32, seed=3)
    data["weight"] = np.linspace(0.5, 1.5, 160, dtype=np.float32)[:, None]
    batches = lambda k: batch_iterator(data, 16, rng=np.random.default_rng(k))  # noqa: E731
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        staged_t, sync_t = trainer(), trainer()
        staged, sync = staged_t.init_state(0), sync_t.init_state(0)
        ck.reset_launch_counts()
        staged, staged_loss = staged_t.train_epoch(staged, batches(0), 0)
        staged = staged_t.fds_epoch_pass(staged, batches(1), 0)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}
        losses = []
        for b in batches(0):
            sync, loss, _ = sync_t.train_step(sync, b, 0)
            losses.append(float(loss))
        sync = sync_t._fds_pass(sync, (sync_t._to_device(b) for b in batches(1)), 0)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before
    assert launches["calibrate_forward"] == 10 and launches["calibrate_backward"] == 10
    assert launches["segment_moments"] == 10
    counts = np.full(len(losses), 16)
    assert staged_loss == float((np.asarray(losses, np.float32) * counts).sum() / counts.sum())
    for part in ("backbone", "head"):
        got, want = getattr(staged, part).state_dict(), getattr(sync, part).state_dict()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for f in ("running_mean", "running_var", "smoothed_mean_last_epoch",
              "smoothed_var_last_epoch", "num_samples_tracked"):
        assert torch.equal(getattr(staged.fds, f), getattr(sync.fds, f)), f


# ------------------------------------------------------------------- serving
def _serving_model(kind: str, dtype: torch.dtype, dev):
    """(trainer, state, input): a tiny age ResNet on uint8 32x32 images, or
    a tiny depth encoder-decoder on float32 64x96 images, on the card."""
    from imbalanced_regression_tpu_torch.data.augment import normalize_only
    from imbalanced_regression_tpu_torch.data.nyud2 import imagenet_normalize
    from imbalanced_regression_tpu_torch.models.depth_encdec import (
        DepthHead,
        depth_feature_dim,
    )
    from imbalanced_regression_tpu_torch.models.resnet import RegressionHead, ResNetBasicBackbone
    from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig

    rng = np.random.default_rng(15)
    if kind == "age":
        trainer = Trainer(ResNetBasicBackbone(stage_sizes=(1, 1), width=8, dtype=dtype),
                          RegressionHead(16), TrainerConfig(), eval_transform=normalize_only,
                          device=dev)
        x = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    else:
        trainer = Trainer(DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8, dtype=dtype),
                          DepthHead(depth_feature_dim(8 * 32)), TrainerConfig(loss="mse"),
                          eval_transform=imagenet_normalize, device=dev)
        x = rng.random((4, 64, 96, 3), dtype=np.float32)
    return trainer, trainer.init_state(0), x


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype", [("age", torch.float32), ("age", torch.bfloat16),
                                        ("depth", torch.bfloat16)])
def test_exported_predictor_on_card_matches_predict_batch(cuda_device, kind, dtype):
    """A predictor exported on the card (the default platform) and reloaded
    there (the default device) gives ``Trainer.predict_batch``'s
    predictions on the same batch bit for bit under ``cudnn.deterministic``:
    both run the same aten ops with the same weights in the same layouts.
    The artifact's cpu program, loaded on request, agrees within 1e-5
    (float32) or 2^-6 (bf16) of the largest magnitude."""
    from imbalanced_regression_tpu_torch.serving import export_predictor, load_predictor

    trainer, state, x = _serving_model(kind, dtype, cuda_device)
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        blob = export_predictor(trainer, state, x, platforms=("cuda", "cpu"))
        predict = load_predictor(blob)
        got = predict(x)
        want = trainer.predict_batch(state, {"input": x, "target": np.zeros((len(x), 1))})
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before
    assert predict.device.type == "cuda" and predict.platforms == ("cuda", "cpu")
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.array_equal(got, want), float(np.abs(got - want).max())
    on_cpu = load_predictor(blob, "cpu")
    assert on_cpu.device.type == "cpu"
    tol = 1e-5 if dtype == torch.float32 else 2.0**-6
    assert float(np.abs(on_cpu(x) - want).max()) <= tol * float(np.abs(want).max())


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_one_process(cuda_device):
    """One float32 step of the ResNet-50 Trainer (TF32 off, FDS
    calibrating, SGD) on two gloo ranks sharing the card, against one
    process on the same weights and global batch of 32 at 224x224: the
    ranks bit-identical; the loss within 1e-5 relative and the BN running
    buffers and the head's weights within rtol 1e-4 / atol 1e-5 (JAX
    ``tests/test_parallel.py``'s bounds). The backbone's float32 gradients
    at init are ill-conditioned (the one-process step on inputs scaled by 1
    + 2^-23 moves some weights by ~4e-4), so its update may differ from one
    process's by at most 4 times that perturbed step's gap."""
    import torch_parallel_ranks as ranks

    from imbalanced_regression_tpu_torch.parallel.launch import run_ranks

    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        dp = run_ranks(ranks.resnet50_dp_rank, 2, backend="gloo", timeout_s=600)
        one = ranks.resnet50_step(None, "cuda")
        perturbed = ranks.resnet50_step(None, "cuda", perturb=2.0**-23)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before
    assert dp[0]["digest"] == dp[1]["digest"]
    np.testing.assert_allclose(dp[0]["loss"], one["loss"], rtol=1e-5)
    for k, v in one["buffers"].items():
        torch.testing.assert_close(dp[0]["buffers"][k], v, rtol=1e-4, atol=1e-5, msg=k)
    for k, v in one["weights"].items():
        if k.startswith("head."):
            torch.testing.assert_close(dp[0]["weights"][k], v, rtol=1e-4, atol=1e-5, msg=k)
    backbone = [k for k in one["weights"] if k.startswith("backbone.")]
    gap = ranks.update_gap(dp[0]["weights"], one["weights"], one["before"], backbone)
    noise = ranks.update_gap(perturbed["weights"], one["weights"], one["before"], backbone)
    assert gap <= 4 * noise, (gap, noise)


@pytest.mark.cuda
def test_nccl_one_rank_step_is_bit_equal_to_no_mesh(cuda_device):
    """A one-rank NCCL group through ``create_mesh``: the step's
    collectives run on NCCL (the gradient all-reduce, the replication, the
    FDS edge gate) and leave it bit-equal to the step without a mesh, under
    ``cudnn.deterministic``."""
    import torch.distributed as dist
    import torch_parallel_ranks as ranks

    from imbalanced_regression_tpu_torch.parallel.mesh import create_mesh

    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        mesh = create_mesh(1, backend="nccl", device="cuda")
        try:
            got = ranks.resnet50_step(mesh, "cuda")
        finally:
            dist.destroy_process_group()
        want = ranks.resnet50_step(None, "cuda")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before
    assert mesh.backend == "nccl" and mesh.stats.calls > 0
    assert got["loss"] == want["loss"] and got["digest"] == want["digest"]
