"""The port's STS-B pair encoder held against the Flax ``PairBiLSTMEncoder``
on the CPU, from the same weights (``convert.stsb_from_flax``): the packed
reversal, the highway, the fused BiLSTM and the whole encoder in float32
(forward within 1e-5 of the largest magnitude, gradients against
``jax.grad`` within 1e-4 of the largest), the bf16 encoder within 2^-6,
uneven lengths and columns padded to different lengths; the init (the
orthogonal gate blocks, lecun-normal Dense, the GloVe table); and the
frozen word embeddings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_stsb_tiny import pair_input, token_batch

from imbalanced_regression_tpu.models import bilstm_pair as jbp
from imbalanced_regression_tpu_torch.convert import stsb_from_flax
from imbalanced_regression_tpu_torch.models import bilstm_pair as bp
from imbalanced_regression_tpu_torch.models.resnet import RegressionHead
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig

V, D_WORD, D_HID = 23, 6, 5


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def test_flip_padded_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 7, 3)).astype(np.float32)
    lengths = np.array([7, 1, 3, 5, 2, 6], np.int32)
    got = bp.flip_padded(torch.as_tensor(x), torch.as_tensor(lengths)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbp.flip_padded(jnp.asarray(x), jnp.asarray(lengths))))
    np.testing.assert_array_equal(bp.flip_padded(torch.as_tensor(got), torch.as_tensor(lengths)), x)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_highway_matches_flax(n_layers):
    rng = np.random.default_rng(n_layers)
    x = rng.normal(size=(4, 3, D_WORD)).astype(np.float32)
    jmod = jbp.Highway(n_layers)
    params = _np(jmod.init(jax.random.key(0), x)["params"])
    want = np.asarray(jmod.apply({"params": params}, x))
    mod = bp.Highway(D_WORD, n_layers)
    sd = stsb_from_flax({"params": {"embed": {"embedding": np.zeros((1, D_WORD))},
                                    "highway": params, "bilstm": {}}})["backbone"]
    mod.load_state_dict({k.removeprefix("highway."): v for k, v in sd.items()
                         if k.startswith("highway.")})
    np.testing.assert_allclose(mod(torch.as_tensor(x)).detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_fused_bilstm_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 6, D_WORD)).astype(np.float32)
    _, mask = token_batch(rng, 5, 6, V)
    lengths = mask.sum(1).astype(np.int32)
    jmod = jbp.FusedBiLSTM(D_HID, 2)
    params = _np(jmod.init(jax.random.key(1), x, lengths)["params"])
    want = np.asarray(jmod.apply({"params": params}, x, lengths))
    mod = bp.FusedBiLSTM(D_WORD, D_HID, 2)
    sd = stsb_from_flax({"params": {"embed": {"embedding": np.zeros((1, D_WORD))},
                                    "bilstm": params}})["backbone"]
    mod.load_state_dict({k.removeprefix("bilstm."): v for k, v in sd.items()
                         if k.startswith("bilstm.")})
    got = mod(torch.as_tensor(x), torch.as_tensor(lengths)).detach().numpy()
    assert got.shape == want.shape == (5, 6, 2 * D_HID)
    # valid positions only: padded ones carry states nobody reads
    valid = mask[..., None] > 0
    assert _rel(np.where(valid, got, 0), np.where(valid, want, 0)) <= 1e-5


def _pair(dtype, jdtype, n_highway=1, table=None, train_words=False):
    jmod = jbp.PairBiLSTMEncoder(vocab_size=V, d_word=D_WORD, d_hid=D_HID, n_layers=2,
                                 n_highway=n_highway, train_words=train_words,
                                 embedding_table=table, dtype=jdtype)
    batch = pair_input(np.random.default_rng(2), 6, 7, 4, V)
    variables = _np(jmod.init(jax.random.key(2), batch, train=False))
    mod = bp.PairBiLSTMEncoder(V, D_WORD, D_HID, 2, n_highway, train_words=train_words,
                               embedding_table=table, dtype=dtype)
    mod.load_state_dict(stsb_from_flax(variables)["backbone"])
    return jmod, variables, mod.eval(), batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_pair_encoder_float32_forward_and_gradients_match_flax():
    """Eval mode; lengths 1..7 in the first column, 1..4 in the second, so
    the second column is right-padded by the encoder. Gradients in every
    weight of the encoder (embeddings trained) of a fixed random
    projection of the pair embedding."""
    jmod, variables, mod, batch = _pair(torch.float32, jnp.float32, train_words=True)
    want = np.asarray(jmod.apply(variables, batch, train=False))
    got = mod(_torch_batch(batch))
    assert got.shape == want.shape == (6, 8 * D_HID) and got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) <= 1e-5

    proj = np.random.default_rng(3).normal(size=want.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jmod.apply({"params": p}, batch, train=False) * proj))(
        variables["params"])
    (got * torch.as_tensor(proj)).sum().backward()
    want_g = stsb_from_flax({"params": _np(jgrads)})["backbone"]
    grads = {k: p.grad for k, p in mod.named_parameters()}
    assert grads.keys() == want_g.keys()
    for k, w in want_g.items():
        assert _rel(grads[k].numpy(), w.numpy()) <= 1e-4, k


def test_pair_encoder_bf16_matches_flax():
    jmod, variables, mod, batch = _pair(torch.bfloat16, jnp.bfloat16, n_highway=0)
    want = np.asarray(jmod.apply(variables, batch, train=False), np.float32)
    got = mod(_torch_batch(batch))
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) <= 2.0**-6


def test_glove_table_init_and_frozen_embeddings():
    table = np.random.default_rng(4).normal(size=(V, D_WORD)).astype(np.float32)
    jmod, variables, mod, batch = _pair(torch.float32, jnp.float32, table=table)
    np.testing.assert_array_equal(variables["params"]["embed"]["embedding"], table)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(mod.embed.weight.detach().numpy(), table)
    # frozen (train_words false): no gradient, and requires_grad_ keeps it so
    mod.requires_grad_(True)
    assert not mod.embed.weight.requires_grad
    mod(_torch_batch(batch)).sum().backward()
    assert mod.embed.weight.grad is None
    assert mod.bilstm.input_proj_0.weight.grad is not None
    # the trainer's optimizer holds no frozen parameter, and channels_last
    # leaves the encoder's 2-d and 3-d parameters as they were
    trainer = Trainer(mod, RegressionHead(8 * D_HID), TrainerConfig(loss="mse"), device="cpu")
    state = trainer.init_state(0)
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert id(mod.embed.weight) not in held and id(mod.bilstm.recurrent_kernel_0) in held
    assert all(p.is_contiguous() for p in state.backbone.parameters())


def test_init_distributions():
    """Each recurrent gate block orthogonal; Dense kernels lecun-normal
    (std sqrt(1/fan_in)) with zero biases; embeddings normal(1)."""
    mod = bp.PairBiLSTMEncoder(50, 40, 30, 2, 1)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    for layer in range(2):
        w = getattr(mod.bilstm, f"recurrent_kernel_{layer}").detach().double()
        for k in range(4):
            block = w[:, k * 30:(k + 1) * 30]
            torch.testing.assert_close(block.T @ block, torch.eye(30, dtype=torch.float64),
                                       rtol=0, atol=1e-6)
        proj = getattr(mod.bilstm, f"input_proj_{layer}")
        assert not proj.bias.any()
        assert abs(proj.weight.std().item() * proj.weight.shape[1] ** 0.5 - 1.0) < 0.05
        assert proj.weight.abs().max() <= 2.0 / proj.weight.shape[1] ** 0.5 / 0.8796 + 1e-6
    assert abs(mod.embed.weight.std().item() - 1.0) < 0.05
    # a Flax init has the same orthogonal blocks
    jmod = jbp.PairBiLSTMEncoder(vocab_size=50, d_word=40, d_hid=30, n_layers=1)
    batch = pair_input(np.random.default_rng(0), 2, 3, 3, 50)
    rk = np.asarray(jmod.init(jax.random.key(0), batch, train=False)["params"]["bilstm"]
                    ["recurrent_kernel_0"], np.float64)
    np.testing.assert_allclose(rk[:, :30].T @ rk[:, :30], np.eye(30), atol=1e-5)


def test_dropout_draws_from_the_generator():
    _, _, mod, batch = _pair(torch.float32, jnp.float32)
    mod.train()
    runs = [mod(_torch_batch(batch), torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    mod.eval()
    torch.testing.assert_close(mod(_torch_batch(batch), torch.Generator().manual_seed(5)),
                               mod(_torch_batch(batch)), rtol=0, atol=0)


def test_converter_refuses_the_per_direction_layout():
    """The per-direction layout converts (``tests/test_torch_stsb_flax_layout.py``);
    a ``bilstm`` key of neither layout is refused."""
    with pytest.raises(KeyError, match="not a BiLSTM parameter of either layout"):
        stsb_from_flax({"params": {"embed": {"embedding": np.zeros((2, 3))},
                                   "bilstm": {"LSTMCell_0": {}}}})
