"""The STS-B BiLSTM's layer Function (``models/bilstm_pair.py``
``FusedLSTMLayer``) and its cell kernels (``csrc/lstm_cell.cu``).

On the CPU, where the Function runs the plain cell
(``ops/lstm_cell.py``): ``FusedBiLSTM`` against the eager autograd loop
it ran before the Function, which ``exported_recurrence`` keeps (the
module run with ``torch.compiler.is_exporting`` patched to true), its
forward bit for bit in float32 and in bf16, its gradients within 1e-5 of the largest
in float32 (the recurrent kernel's gradient is now one product over every
step, summed in another order) and within 2^-4 in bf16 (there the eager
loop summed 40 products in bf16); ``torch.autograd.gradcheck`` in float64;
a no-grad forward that saves nothing; the exported recurrence equal to
the eager one.

On the card (marked ``cuda``): the cell kernels against the plain cell run
on the card, at the STS-B cell's rows and width (512 x 1500) and at a
ragged shape (7 x 37, one unit a thread), forward with grad on and under
``no_grad``: the saved gate pre-activations bit for bit, ``h`` and ``c``
within 2e-6 of the largest; backward gradients within 1e-5 (float32) or
2^-6 (bf16, one bf16 rounding of each gate gradient, which unfused and
fused float32 arithmetic can move by an ulp) of the largest; and the
launch counts of a train forward and backward.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_lstm_cell.py -q
"""

import pytest
import torch

from imbalanced_regression_tpu_torch.models import bilstm_pair as bp
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.ops import lstm_cell


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _module(dtype, d_in=6, hid=5, seed=0):
    mod = bp.FusedBiLSTM(d_in, hid, 2, dtype)
    mod.reset_parameters(torch.Generator().manual_seed(seed))
    return mod


def _run(mod, x, lengths, proj):
    """Output and parameter gradients of ``sum(mod(x) * proj)``."""
    mod.zero_grad()
    out = mod(x, lengths)
    (out.float() * proj).sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in mod.named_parameters()}


@pytest.mark.parametrize("dtype,g_tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-4)])
@pytest.mark.parametrize("lengths", [[7, 3, 1, 5], [2, 2, 2, 2]])
def test_layer_function_matches_the_eager_loop(monkeypatch, dtype, g_tol, lengths):
    mod = _module(dtype)
    gen = torch.Generator().manual_seed(1)
    steps = max(lengths)
    x = torch.randn(len(lengths), steps, 6, generator=gen).to(dtype)
    lengths = torch.tensor(lengths)
    proj = torch.randn(len(lengths), steps, 10, generator=gen)
    got, got_g = _run(mod, x, lengths, proj)
    # the eager loop: exported_recurrence's ATen ops under autograd
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    want, want_g = _run(mod, x, lengths, proj)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    for k, w in want_g.items():
        assert _rel(got_g[k], w) <= g_tol, k


@pytest.mark.parametrize("rows,steps,hid", [(3, 4, 2), (2, 1, 3), (4, 3, 4)])
def test_layer_function_gradcheck_float64(rows, steps, hid):
    gen = torch.Generator().manual_seed(rows * steps)
    xw = torch.randn(rows, steps, 4 * hid, generator=gen, dtype=torch.float64).requires_grad_()
    w_h = (0.5 * torch.randn(hid, 4 * hid, generator=gen, dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: bp.FusedLSTMLayer.apply(a, b, True), (xw, w_h))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_grad_forward_saves_no_gates(monkeypatch, dtype):
    """Under ``no_grad`` (the stats pass, predict, serving) the cell gets
    no gates buffer; its states equal the forward with grad on."""
    mod = _module(dtype)
    x = torch.randn(3, 5, 6, generator=torch.Generator().manual_seed(2)).to(dtype)
    lengths = torch.tensor([5, 2, 4])
    want = mod(x, lengths)
    seen = []
    plain = ck.lstm_cell_forward

    def spy(xw, hw, c_all, hs, hprev, gates, t):
        seen.append(gates)
        return plain(xw, hw, c_all, hs, hprev, gates, t)

    monkeypatch.setattr(ck, "lstm_cell_forward", spy)
    with torch.no_grad():
        got = mod(x, lengths)
    assert got.grad_fn is None and torch.equal(got, want.detach())
    assert len(seen) == 2 * 5 and all(g is None for g in seen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exported_recurrence_equals_the_layer_function(dtype):
    """``torch.export`` traces the ATen recurrence (no kernel call, no
    in-place buffer writes); the exported program gives the eager module's
    bits."""
    mod = _module(dtype).eval()
    x = torch.randn(3, 6, 6, generator=torch.Generator().manual_seed(3)).to(dtype)
    lengths = torch.tensor([6, 1, 4])
    with torch.no_grad():
        program = torch.export.export(mod, (x, lengths))
        want = mod(x, lengths)
    targets = {str(n.target) for n in program.graph.nodes}
    assert not any("copy_" in t or "slice_scatter" in t for t in targets), targets
    assert torch.equal(program.module()(x, lengths), want)


# ----------------------------------------------------------- card tests
def _layer_inputs(rows, steps, hid, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    xw = torch.randn(rows, steps, 4 * hid, generator=gen).to(dtype).to(dev)
    w_h = (torch.randn(hid, 4 * hid, generator=gen) / hid ** 0.5).to(dev)
    dhs = torch.randn(rows, steps, hid, generator=gen).to(dev)
    return xw, w_h, dhs


def _plain_cells(monkeypatch):
    monkeypatch.setattr(ck, "lstm_cell_forward", lstm_cell.lstm_cell_forward_plain)
    monkeypatch.setattr(ck, "lstm_cell_backward", lstm_cell.lstm_cell_backward_plain)


def _layer(xw, w_h, dhs, grad: bool):
    """The layer Function's states, its saved gates and cell states (None
    under ``no_grad``), and with ``grad`` its gradients from ``dhs``."""
    xw = xw.clone().requires_grad_(grad)
    w_h = w_h.clone().requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        hs = bp.FusedLSTMLayer.apply(xw, w_h, grad)
    if not grad:
        assert hs.grad_fn is None
        return hs, None, None
    gates, c_all, _, _ = hs.grad_fn.saved_tensors
    dxw, dw = torch.autograd.grad(hs, (xw, w_h), dhs)
    return hs.detach(), (gates, c_all), (dxw, dw)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,hid", [(512, 1500), (7, 37)])
@pytest.mark.parametrize("dtype,g_tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)])
@pytest.mark.parametrize("grad", [True, False])
def test_cell_kernels_match_the_plain_cell(cuda_device, monkeypatch, rows, hid, dtype, g_tol,
                                           grad):
    from imbalanced_regression_tpu_torch.train import set_numerics

    set_numerics()
    xw, w_h, dhs = _layer_inputs(rows, 5, hid, dtype, cuda_device)
    ck.reset_launch_counts()
    got, got_saved, got_g = _layer(xw, w_h, dhs, grad)
    torch.cuda.synchronize()
    assert ck.lstm_cell_forward.launches == 5
    assert ck.lstm_cell_backward.launches == (5 if grad else 0)
    _plain_cells(monkeypatch)
    want, want_saved, want_g = _layer(xw, w_h, dhs, grad)
    assert _rel(got, want) <= 2e-6
    if grad:
        assert torch.equal(got_saved[0], want_saved[0])
        assert _rel(got_saved[1], want_saved[1]) <= 2e-6
        for g, w in zip(got_g, want_g):
            assert g.dtype == w.dtype and _rel(g, w) <= g_tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_forward_and_backward_launch_two_cells_a_step(cuda_device, dtype):
    """A forward and backward of a 2-layer ``FusedBiLSTM`` over 9 steps:
    9 forward and 9 backward cell kernels a layer, 2 x 9 x 2 in all."""
    mod = _module(dtype, d_in=16, hid=24).to(cuda_device)
    x = torch.randn(6, 9, 16, device=cuda_device).to(dtype)
    lengths = torch.tensor([9, 4, 1, 7, 9, 2], device=cuda_device)
    ck.reset_launch_counts()
    mod(x, lengths).float().square().sum().backward()
    torch.cuda.synchronize()
    assert ck.lstm_cell_forward.launches == ck.lstm_cell_backward.launches == 2 * 9
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in mod.parameters())
