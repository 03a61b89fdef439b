"""The port's per-direction BiLSTM (``lstm_impl="flax"``) held against the
JAX package's ``BiLSTM`` and ``PairBiLSTMEncoder(lstm_impl='flax')`` on the
CPU, from the same weights (``convert.stsb_from_flax``): float32 forward
within 1e-5 of the largest magnitude on the valid positions, gradients of
every encoder weight against ``jax.grad`` within 1e-4 of the largest, bf16
within 2^-6; lengths from 1 to the full width, the two sentence columns
padded to different lengths; the init's distributions and parameter
shapes; the converter's cell names."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_stsb_tiny import pair_input

from imbalanced_regression_tpu.models import bilstm_pair as jbp
from imbalanced_regression_tpu_torch.convert import stsb_from_flax
from imbalanced_regression_tpu_torch.models import bilstm_pair as bp

V, D_WORD, D_HID, STEPS = 23, 6, 5, 7


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


def _bilstm_sd(params):
    sd = stsb_from_flax({"params": {"embed": {"embedding": np.zeros((1, D_WORD))},
                                    "bilstm": params}})["backbone"]
    return {k.removeprefix("bilstm."): v for k, v in sd.items() if k.startswith("bilstm.")}


@pytest.mark.parametrize("dtype,jdtype,tol", [(torch.float32, jnp.float32, 1e-5),
                                              (torch.bfloat16, jnp.bfloat16, 2.0**-6)])
def test_bilstm_matches_flax(dtype, jdtype, tol):
    """Two layers; lengths 1..STEPS (one row of each length)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(STEPS, STEPS, D_WORD)).astype(np.float32)
    lengths = np.arange(1, STEPS + 1, dtype=np.int32)[::-1].copy()
    jmod = jbp.BiLSTM(D_HID, 2, dtype=jdtype)
    params = _np(jmod.init(jax.random.key(1), jnp.asarray(x, jdtype), lengths)["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x, jdtype), lengths), np.float32)
    mod = bp.BiLSTM(D_WORD, D_HID, 2, dtype)
    mod.load_state_dict(_bilstm_sd(params))
    got = mod(torch.as_tensor(x).to(dtype), torch.as_tensor(lengths))
    # Flax's carry is float32 (the cell's param_dtype), so is the output
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == want.shape == (STEPS, STEPS, 2 * D_HID)
    valid = (np.arange(STEPS)[None, :] < lengths[:, None])[..., None]
    assert _rel(np.where(valid, got.detach().numpy(), 0), np.where(valid, want, 0)) <= tol


def _pair(dtype, jdtype, n_highway=1, train_words=False):
    jmod = jbp.PairBiLSTMEncoder(vocab_size=V, d_word=D_WORD, d_hid=D_HID, n_layers=2,
                                 n_highway=n_highway, train_words=train_words,
                                 lstm_impl="flax", dtype=jdtype)
    batch = pair_input(np.random.default_rng(2), 6, STEPS, 4, V)
    variables = _np(jmod.init(jax.random.key(2), batch, train=False))
    mod = bp.PairBiLSTMEncoder(V, D_WORD, D_HID, 2, n_highway, train_words=train_words,
                               lstm_impl="flax", dtype=dtype)
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
    assert any(k.startswith("bilstm.recurrent_biases_") for k in grads)
    for k, w in want_g.items():
        assert _rel(grads[k].numpy(), w.numpy()) <= 1e-4, k


def test_pair_encoder_bf16_matches_flax():
    jmod, variables, mod, batch = _pair(torch.bfloat16, jnp.bfloat16, n_highway=0)
    want = np.asarray(jmod.apply(variables, batch, train=False), np.float32)
    got = mod(_torch_batch(batch))
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) <= 2.0**-6


def test_init_distributions_and_shapes():
    """A Flax init converts onto exactly the module's parameters; each
    direction's recurrent gate blocks are orthogonal, its input kernels
    lecun-normal (std sqrt(1/fan_in), truncated at 2 std), its biases 0."""
    h, d = 30, 40
    mod = bp.PairBiLSTMEncoder(50, d, h, 2, lstm_impl="flax")
    mod.reset_parameters(torch.Generator().manual_seed(0))
    jmod = jbp.PairBiLSTMEncoder(vocab_size=50, d_word=d, d_hid=h, n_layers=2, lstm_impl="flax")
    batch = pair_input(np.random.default_rng(0), 2, 3, 3, 50)
    sd = stsb_from_flax(_np(jmod.init(jax.random.key(0), batch, train=False)))["backbone"]
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in mod.state_dict().items()}
    for layer, fan_in in ((0, d), (1, 2 * h)):
        wh = getattr(mod.bilstm, f"recurrent_kernels_{layer}").detach().double()
        wi = getattr(mod.bilstm, f"input_kernels_{layer}").detach()
        assert not getattr(mod.bilstm, f"recurrent_biases_{layer}").any()
        for direction in range(2):
            for k in range(4):
                block = wh[direction, :, k * h:(k + 1) * h]
                torch.testing.assert_close(block.T @ block, torch.eye(h, dtype=torch.float64),
                                           rtol=0, atol=1e-6)
            assert abs(wi[direction].std().item() * fan_in ** 0.5 - 1.0) < 0.05
            assert wi[direction].abs().max() <= 2.0 / fan_in ** 0.5 / 0.8796 + 1e-6
        assert not torch.equal(wi[0], wi[1]) and not torch.equal(wh[0], wh[1])
    # a Flax init has orthogonal gate blocks too
    rk = sd["bilstm.recurrent_kernels_0"].double()
    torch.testing.assert_close(rk[1, :, :h].T @ rk[1, :, :h], torch.eye(h, dtype=torch.float64),
                               rtol=0, atol=1e-5)


def test_converter_reads_cells_inside_rnn():
    """``RNN_{k}/cell`` (a Flax version that names the cell inside its
    ``nn.RNN``) converts as ``OptimizedLSTMCell_{k}`` does."""
    _, variables, _, _ = _pair(torch.float32, jnp.float32, n_highway=0)
    cells = variables["params"]["bilstm"]
    renamed = {"params": {**variables["params"],
                          "bilstm": {k.replace("OptimizedLSTMCell", "RNN"): {"cell": v}
                                     for k, v in cells.items()}}}
    want, got = stsb_from_flax(variables)["backbone"], stsb_from_flax(renamed)["backbone"]
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    with pytest.raises(KeyError, match="not two a layer"):
        stsb_from_flax({"params": {"embed": {"embedding": np.zeros((2, 3))},
                                   "bilstm": {"OptimizedLSTMCell_0": cells["OptimizedLSTMCell_0"]}}})


def test_unknown_lstm_impl_is_refused():
    with pytest.raises(ValueError, match="lstm_impl"):
        bp.PairBiLSTMEncoder(10, 4, 3, 1, lstm_impl="cudnn")
