"""The port's single-card entry (``imbalanced_regression_tpu_torch/entry.py``)
against the JAX ``__graft_entry__.entry`` on the same weights, and the two
``logging_tools`` helpers of this slice (``profile_trace``,
``enable_nan_debug``), on the CPU.

The JAX entry's Flax variables go through ``convert.from_flax`` into the
port's modules; a seeded batch of 2 random 224x224 images goes through
both forwards. bf16 (the entry's compute type): within 2^-7 of the largest
output magnitude (measured 5.2e-4 relative: two bf16 convolution stacks
rounding in different orders). float32 (``resnet50_backbone(dtype=
float32)`` on both sides): within 1e-4 of the largest magnitude (measured
1.6e-6)."""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from imbalanced_regression_tpu.models.resnet import RegressionHead as JaxHead
from imbalanced_regression_tpu.models.resnet import resnet50_backbone as jax_resnet50
from imbalanced_regression_tpu_torch import entry as port_entry
from imbalanced_regression_tpu_torch.convert import from_flax
from imbalanced_regression_tpu_torch.models.resnet import resnet50_backbone
from imbalanced_regression_tpu_torch.parallel import dryrun
from imbalanced_regression_tpu_torch.utils.logging_tools import enable_nan_debug, profile_trace

BF16_TOL = 2.0**-7
F32_TOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def both():
    """The JAX entry (its forward, variables and head params on the host)
    and the port's entry on the CPU with those weights loaded."""
    jax_forward, (b_vars, h_params, _) = __graft_entry__.entry()
    b_vars, h_params = jax.device_get(b_vars), jax.device_get(h_params)
    forward, (backbone, head, x) = port_entry.entry(device="cpu")
    sd = from_flax(b_vars, h_params)
    backbone.load_state_dict(sd["backbone"])
    head.load_state_dict(sd["head"])
    images = np.random.default_rng(0).uniform(-1.0, 1.0, size=(2, 224, 224, 3)).astype(np.float32)
    return dict(jax_forward=jax_forward, b_vars=b_vars, h_params=h_params, sd=sd,
                forward=forward, backbone=backbone, head=head, images=images)


def test_entry_on_the_cpu_gives_8_by_1_float32():
    forward, (backbone, head, x) = port_entry.entry(device="cpu")
    assert x.shape == (8, 224, 224, 3) and x.dtype == torch.float32 and not x.any()
    assert backbone.dtype == torch.bfloat16 and not backbone.training and not head.training
    assert all(p.dtype == torch.float32 and p.device.type == "cpu"
               for p in [*backbone.parameters(), *head.parameters()])
    out = forward(backbone, head, x)
    assert out.shape == (8, 1) and out.dtype == torch.float32 and torch.isfinite(out).all()
    # the weights come from the seeded generator: a second entry is identical
    _, (backbone2, _, _) = port_entry.entry(device="cpu")
    for a, b in zip(backbone.state_dict().values(), backbone2.state_dict().values()):
        assert torch.equal(a, b)


def test_entry_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()


def test_entry_module_holds_the_dry_run():
    assert port_entry.dryrun_multichip is dryrun.dryrun_multichip


def test_entry_matches_jax_in_bf16(both):
    want = np.asarray(both["jax_forward"](both["b_vars"], both["h_params"],
                                          jnp.asarray(both["images"])))
    got = both["forward"](both["backbone"], both["head"], torch.as_tensor(both["images"])).numpy()
    assert got.shape == want.shape == (2, 1)
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def test_entry_weights_match_jax_in_float32(both):
    backbone = jax_resnet50(dtype=jnp.float32)
    encoding = backbone.apply(both["b_vars"], jnp.asarray(both["images"]), train=False)
    want = np.asarray(JaxHead().apply({"params": both["h_params"]}, encoding))
    port = resnet50_backbone(dtype=torch.float32).eval()
    port.load_state_dict(both["sd"]["backbone"])
    got = both["forward"](port, both["head"], torch.as_tensor(both["images"])).numpy()
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


def test_profile_trace_writes_a_trace_naming_an_aten_op(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.randn(8, 8) @ torch.randn(8, 8)
    (path,) = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mm" in names
    assert "aten::mm" in {e.key for e in prof.key_averages()}


def test_enable_nan_debug_raises_forward_and_backward():
    zero, nan = torch.tensor(0.0), torch.tensor([float("nan")])
    try:
        enable_nan_debug()
        with pytest.raises(FloatingPointError, match="div"):
            zero / zero
        nan.view(1, 1)  # a view computes nothing: the NaN came from before
        torch.empty(64)  # unwritten memory is not a result
        with pytest.raises(FloatingPointError, match="add"):
            nan + 1.0
        x = torch.tensor(0.0, requires_grad=True)
        y = torch.sqrt(x) * 0.0  # finite forward; d sqrt / dx at 0 times 0 is NaN
        assert y.item() == 0.0
        with pytest.raises((FloatingPointError, RuntimeError)), pytest.warns(UserWarning):
            y.backward()
    finally:
        enable_nan_debug(False)
    assert torch.isnan(zero / zero)
    x = torch.tensor(0.0, requires_grad=True)
    (torch.sqrt(x) * 0.0).backward()
    assert torch.isnan(x.grad)
    assert not torch.is_anomaly_enabled()
