"""The port's ResNet family held against the Flax models on the CPU: the
BasicBlock ResNet-18/34 and a bottleneck stack from converted weights
(forward in train and eval mode, BN running statistics after the train-mode
forward), the name/shape mapping of every registry depth, remat against no
remat, and the torchvision state-dict mapping onto the depth encoder.
Inputs are made with seeded numpy and handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbalanced_regression_tpu.models import resnet as jresnet
from imbalanced_regression_tpu.tasks import age as jage
from imbalanced_regression_tpu_torch.convert import from_flax, from_torchvision_resnet
from imbalanced_regression_tpu_torch.models import resnet
from imbalanced_regression_tpu_torch.models.depth_encdec import DepthEncoderDecoder
from imbalanced_regression_tpu_torch.tasks import age, nyud2

T = torch.as_tensor


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _perturbed(variables):
    """Non-trivial BN scale/bias and running statistics, so that a swapped
    pair or a misplaced downsample BN shows."""
    r = np.random.default_rng(5)
    return jax.tree.map(lambda a: a + r.uniform(0.1, 0.5, a.shape).astype(np.float32)
                        if a.ndim == 1 else a, variables)


@pytest.mark.parametrize("basic,stage_sizes", [(True, (1, 1)), (True, (2, 1)), (False, (2, 1))],
                         ids=["basic-1-1", "basic-2-1", "bottleneck-2-1"])
def test_converted_family_matches_flax(rng, basic, stage_sizes):
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    jcls = jresnet.ResNetBasicBackbone if basic else jresnet.ResNetBackbone
    jm = jcls(stage_sizes=stage_sizes, width=8, dtype=jnp.float32)
    variables = _perturbed(jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(x),
                                                            train=False)))
    tcls = resnet.ResNetBasicBackbone if basic else resnet.ResNetBackbone
    tm = tcls(stage_sizes=stage_sizes, width=8, dtype=torch.float32)
    tm.load_state_dict(from_flax(variables)["backbone"])

    want_eval = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm.eval()
    with torch.no_grad():
        got_eval = tm(T(x)).numpy()
    # float32 convolutions in another summation order: 1e-5
    np.testing.assert_allclose(got_eval, want_eval, rtol=1e-5, atol=1e-5)

    want, updates = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(T(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = from_flax({"params": variables["params"],
                       "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])})["backbone"]
    for k, v in tm.state_dict().items():
        if "running" in k:
            # batch moments of float32 maps, reduced in another order
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    assert tm.out_features == (8 * 2 if basic else 8 * 2 * 4)


@pytest.mark.parametrize("model", sorted(jage.BACKBONES))
def test_registry_depths_map_onto_flax_names(model):
    """Every ``--model`` of the JAX registry: the Flax variables (shapes only,
    by ``jax.eval_shape``) convert into a strict ``load_state_dict`` of the
    port's backbone function, and the encoding widths agree."""
    jfn, jdim = jage.BACKBONES[model]
    tfn, tdim = age.BACKBONES[model]
    assert tdim == jdim
    jm = jfn(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                            train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = tfn(dtype=torch.float32)
    tm.load_state_dict(from_flax(zeros)["backbone"])  # strict: names and shapes
    assert tm.stage_sizes == jm.stage_sizes and tm.out_features == tdim


def _grads_and_buffers(cls, remat, x):
    m = cls(stage_sizes=(2, 1), width=8, dtype=torch.float32, remat=remat)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.train()
    loss = m(x).square().sum()
    loss.backward()
    return (loss.detach(), {k: p.grad for k, p in m.named_parameters()},
            {k: b for k, b in m.named_buffers()})


@pytest.mark.parametrize("remat", resnet.REMAT_MODES)
@pytest.mark.parametrize("cls", [resnet.ResNetBackbone, resnet.ResNetBasicBackbone],
                         ids=["bottleneck", "basic"])
def test_remat_matches_plain_step(rng, cls, remat):
    """One forward + backward with ``remat`` gives the same loss, gradients
    and BN running buffers as without: the recompute must not fold the batch
    into the running statistics a second time. Bit-equal: the recompute runs
    the same float32 operations on the same inputs."""
    x = T(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    want = _grads_and_buffers(cls, None, x)
    got = _grads_and_buffers(cls, remat, x)
    assert torch.equal(got[0], want[0])
    for part in (1, 2):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), k


def test_unknown_remat_mode_raises():
    with pytest.raises(ValueError, match="remat"):
        resnet.ResNetBackbone(stage_sizes=(1,), width=8, remat="everything")


def _torchvision_state_dict(rng):
    """A state dict with torchvision's ResNet key names: the port's own
    ResNet-50 layout at width 8 with random values, plus torchvision's
    ``num_batches_tracked`` buffers and ``fc`` head."""
    src = resnet.ResNetBackbone(stage_sizes=(1, 1, 1, 1), width=8, dtype=torch.float32)
    sd = {k: T(rng.normal(size=v.shape).astype(np.float32)) for k, v in src.state_dict().items()}
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 0.5
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    sd["fc.weight"] = T(rng.normal(size=(1000, 256)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_torchvision_state_dict_loads_into_depth_encoder(rng, tmp_path):
    sd = _torchvision_state_dict(rng)
    path = tmp_path / "resnet.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)  # a DataParallel save
    model = DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8, dtype=torch.float32)

    class State:
        backbone = model

    nyud2.load_pretrained_encoder(State, str(path))
    ref = resnet.ResNetBackbone(stage_sizes=(1, 1, 1, 1), width=8, return_features=True,
                                dtype=torch.float32)
    ref.load_state_dict(from_torchvision_resnet(sd))
    x = T(rng.normal(size=(2, 64, 96, 3)).astype(np.float32))
    model.eval()
    ref.eval()
    with torch.no_grad():
        for got, want in zip(model.encoder(x), ref(x)):
            assert torch.equal(got, want)


def test_torchvision_mapping_refuses_other_keys(rng):
    sd = _torchvision_state_dict(rng)
    with pytest.raises(KeyError, match="not a ResNet backbone key"):
        from_torchvision_resnet({**sd, "avgpool.scale": torch.ones(1)})
    encoder = resnet.ResNetBackbone(stage_sizes=(1, 1, 1, 1), width=8, return_features=True)
    del sd["layer4.0.conv3.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        encoder.load_state_dict(from_torchvision_resnet(sd))
