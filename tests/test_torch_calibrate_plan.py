"""K1/K2's (FDS calibrate, forward and backward) launch plan and their
factored form, on the CPU.

``calibrate_plan`` (``ops/cuda_kernels.py``) is pure Python: every thread
has a column at the port's widths, the scalar path where D % 4 != 0, the
factored form from its least rows on, the form each of the port's shapes
takes, the grid inside CUDA's launch limits. The factored form is what
the factor and gather kernels compute: the factor ``sqrt(clip(v2 / v1))``
once per (bucket, column) on [B, D], with the column guard and the v1sum
guard folded in as identity entries (factor 1, m1 = +0, m2 = -0), then
gathered by row. It is
held bit-equal to the plain versions ``calibrate_indexed`` /
``calibrate_indexed_grad`` and within the existing tolerance of JAX's
``pallas_calibrate`` run as ``tests/test_torch_ops.py`` runs it.

Inputs are made with seeded numpy and handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbalanced_regression_tpu.ops.pallas_kernels import pallas_calibrate
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.ops.calibrate import calibrate_indexed, calibrate_indexed_grad

T = torch.as_tensor
H100_SMS = 132
N_DEPTH = 32 * 114 * 152  # the NYUD2 train step's pixel rows
MAX_GRID_X, MAX_GRID_Y = 2**31 - 1, 65535  # CUDA's launch limits
MODES = [("nonzero", (0.1, 10.0)), ("positive", (0.5, 2.0))]
# (N, D, B): the corner-case inputs' own size, and the tutorial's train
# step (a 64-wide MLP hook, 51 buckets), whose row tile is narrower than a
# warp
SHAPES = [pytest.param((72, 40, 12), id="N72"), pytest.param((128, 64, 51), id="tutorial")]


# ------------------------------------------------------------------ the plan


def _threads_per_row(plan) -> int:
    return plan.block_x * plan.grid_y


@pytest.mark.parametrize("d,block_x", [(128, 32), (2048, 64), (12000, 60), (64, 16)])
@pytest.mark.parametrize("n", [64, 128, 256, N_DEPTH])
def test_plan_gives_every_thread_a_column(d, block_x, n):
    plan = ck.calibrate_plan(n, d, 93, H100_SMS)
    assert plan.cols == 4 and plan.block_x == block_x
    # the threads of a row's tiles are exactly its column groups, and a
    # block is as many whole rows of a tile as it holds
    assert _threads_per_row(plan) * plan.cols == d
    assert plan.block_y == ck.CALIBRATE_THREADS // block_x
    assert plan.block_y * plan.grid_x >= n > plan.block_y * (plan.grid_x - 1)


@pytest.mark.parametrize("n", [10, 128, N_DEPTH])
def test_plan_takes_scalar_path(n):
    for d in (130, 127, 2046):
        plan = ck.calibrate_plan(n, d, 12, H100_SMS)
        assert plan.cols == 1 and _threads_per_row(plan) >= d
        assert _threads_per_row(plan) - d < plan.grid_y  # fewer idle threads than tiles
    # an unaligned pointer (vec=False) also takes it at D % 4 == 0
    assert ck.calibrate_plan(n, 128, 12, H100_SMS, vec=False).cols == 1


@pytest.mark.parametrize("nb", [12, 93, 151, 455])
def test_factored_form_starts_at_its_least_rows(nb):
    least = ck.FACTORED_ROWS_PER_BUCKET * nb * H100_SMS
    assert ck.calibrate_plan(least, 128, nb, H100_SMS).factored
    assert not ck.calibrate_plan(least - 1, 128, nb, H100_SMS).factored
    assert not ck.calibrate_plan(least, 128, nb, H100_SMS, bwd=True).factored  # K2: direct
    # the launch does not depend on the form
    assert ck.calibrate_plan(least, 128, nb, H100_SMS)[:5] == \
        ck.calibrate_plan(least, 128, nb, H100_SMS, bwd=True)[:5]


@pytest.mark.parametrize("bwd", [False, True])
def test_plan_forms_at_the_port_shapes(bwd):
    # K1 at the NYUD2 step's rows and a rank's takes the factored form; K2
    # there, and both at the age, bench, AgeDB-DIR, STS-B and tutorial
    # batches, the direct one
    for n in (N_DEPTH, N_DEPTH // 2):
        assert ck.calibrate_plan(n, 128, 93, H100_SMS, bwd).factored == (not bwd)
    for n, d, nb in ((64, 2048, 100), (128, 2048, 100), (256, 2048, 97), (128, 12000, 50),
                      (128, 64, 51)):
        assert not ck.calibrate_plan(n, d, nb, H100_SMS, bwd).factored, (n, d)


@pytest.mark.parametrize("d", [4, 8, 128, 130, 2048, 12000, 65_536, 2**22])
@pytest.mark.parametrize("n", [1, 100, N_DEPTH, 10 * N_DEPTH])
def test_plan_grid_within_launch_limits(d, n):
    plan = ck.calibrate_plan(n, d, 93, H100_SMS)
    assert 1 <= plan.grid_x <= MAX_GRID_X and 1 <= plan.grid_y <= MAX_GRID_Y
    assert plan.block_x * plan.block_y <= ck.CALIBRATE_THREADS
    assert plan.grid_y * plan.block_x * plan.cols >= d
    assert plan.grid_x * plan.block_y >= n


# ------------------------------------------------------------ factored form


def _factored_tables(m1, v1, m2, v2, v1sum, clip_min, clip_max, mode):
    """The factored form's table: (m1, factor, m2) [B, D], an entry the
    guards turn off being (+0, 1, -0)."""
    col_ok = (v1 != 0) if mode == "nonzero" else (v1 > 0) & (v2 >= 0)
    on = col_ok & (v1sum >= 1e-10)[:, None]
    s = torch.where(on, torch.sqrt(torch.clamp(v2 / v1, clip_min, clip_max)), torch.ones_like(v1))
    return torch.where(on, m1, 0.0), s, torch.where(on, m2, -0.0)


def _rows(e, ok, nb):
    valid = (e >= 0) & (e < nb)
    return torch.where(valid, e, 0).long(), valid & ok


def factored_forward(x, e, ok, m1, v1, m2, v2, v1sum, clip_min, clip_max, mode):
    t1, s, t2 = _factored_tables(m1, v1, m2, v2, v1sum, clip_min, clip_max, mode)
    ei, on = _rows(e, ok, m1.shape[0])
    x = x.to(torch.float32)
    return torch.where(on[:, None], (x - t1[ei]) * s[ei] + t2[ei], x)


def factored_backward(g, e, ok, v1, v2, v1sum, clip_min, clip_max, mode):
    _, s, _ = _factored_tables(v1, v1, v1, v2, v1sum, clip_min, clip_max, mode)
    ei, on = _rows(e, ok, v1.shape[0])
    return torch.where(on[:, None], g * s[ei], g)


def _inputs(rng, n=72, d=40, b=12, nan=False):
    """Random statistics with every corner the guards see: rows with e = -1
    and e >= B, ok = False, an all-zero v1 row, a zero v1 column, a bucket
    whose positive v1 sums below 1e-10, a negative v2, ratios beyond both
    clips, signed zeros in x where it passes through, and with ``nan`` NaN
    ratios (a NaN v2, inf / inf)."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    e = rng.integers(0, b, size=n).astype(np.int32)
    e[:3] = -1
    e[3:5] = b
    e[5] = b + 7
    e[6:9] = 2  # the zero v1 row
    e[9:12] = 3  # the bucket below the v1sum guard
    e[12:16] = 9  # the NaN bucket
    ok = rng.random(n) > 0.2
    ok[6:16] = True
    m1, m2 = rng.normal(size=(2, b, d)).astype(np.float32)
    v1, v2 = rng.uniform(0.01, 3.0, size=(2, b, d)).astype(np.float32)
    v1[2] = 0.0
    v1[3] = 1e-13  # v1sum 4e-12 at d = 40
    v1[:, 7] = 0.0  # a zero column in every bucket
    v1[5, 3] = 0.0
    v2[6, 1] = -1.0
    v2[7, :5] = 100.0
    v2[8, :3] = 1e-6
    x[6:12] = -0.0  # rows that pass through keep their sign bit
    x[:, 7] = -0.0
    if nan:
        v2[9, 2] = np.nan
        v1[9, 4] = v2[9, 4] = np.inf
    return x, e, ok, (m1, v1, m2, v2), v1.sum(1)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode,clips", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_factored_form_is_bit_equal_to_plain(rng, mode, clips, dtype, shape):
    x, e, ok, stats, v1sum = _inputs(rng, *shape, nan=True)
    args = (T(x).to(dtype), T(e), T(ok), *map(T, stats), T(v1sum), *clips, mode)
    got, want = factored_forward(*args), calibrate_indexed(*args)
    assert torch.equal(_bits(got), _bits(want))  # NaNs and signed zeros too
    assert torch.isnan(want).any() or mode == "positive"
    assert (_bits(got[6:12, :7]) == _bits(T(x[6:12, :7]).to(dtype).float())).all()
    g = T(rng.normal(size=x.shape).astype(np.float32))
    g[6:12] = -0.0
    bargs = (g, T(e), T(ok), T(stats[1]), T(stats[3]), T(v1sum), *clips, mode)
    assert torch.equal(_bits(factored_backward(*bargs)), _bits(calibrate_indexed_grad(*bargs)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode,clips", MODES)
def test_factored_form_matches_pallas(rng, mode, clips, shape):
    x, e, ok, stats, v1sum = _inputs(rng, *shape)
    got = factored_forward(T(x), T(e), T(ok), *map(T, stats), T(v1sum), *clips, mode).numpy()
    jargs = (jnp.asarray(e), jnp.asarray(ok), tuple(map(jnp.asarray, stats)), jnp.asarray(v1sum),
             clips[0], clips[1], mode)
    pal = np.asarray(pallas_calibrate(jnp.asarray(x), *jargs))
    # the Pallas kernel's HIGHEST-precision one-hot gather reassembles each
    # f32 value from bf16 passes: 1e-5, as for calibrate_indexed
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)
    g = rng.normal(size=x.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda xj: jnp.sum(pallas_calibrate(xj, *jargs) * g))(jnp.asarray(x)))
    dx = factored_backward(T(g), T(e), T(ok), T(stats[1]), T(stats[3]), T(v1sum), *clips, mode)
    np.testing.assert_allclose(dx.numpy(), want, rtol=1e-5, atol=1e-6)
