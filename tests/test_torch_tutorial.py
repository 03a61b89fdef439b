"""The port's DIR tutorial (``imbalanced_regression_tpu_torch/tutorial/
tutorial.py``) held against the JAX ``tutorial/tutorial.py``, and the
port's notebook maker (``imbalanced_regression_tpu_torch/tools/
make_notebook.py``) against the JAX tool and ``nbformat``, on the CPU.

Both scripts run as they are (``runpy.run_path``; the port's with
``--device cpu``). The JAX run's initial Flax params (``jax.random.key(0)``
/ ``key(1)``) go through ``convert.mlp_from_flax`` into the port's MLP,
whose ``train`` then takes the same numpy rng (``default_rng(0)`` after
the data draws). Tolerances: the data and the LDS weights equal; the 13
first-epoch losses (no FDS calibration yet) within 1e-5 relative
(measured 3.9e-7: one Adam update order against another); the final
overall and per-shot MAE after 15 epochs with FDS within 1% relative
(measured at most 1.3e-3, the few-shot region; 2.8e-4 overall)."""

import json
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imbalanced_regression_tpu_torch.convert import mlp_from_flax
from imbalanced_regression_tpu_torch.tools import make_notebook
from tools.make_notebook import parse_percent_script as jax_parse_percent_script

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "tutorial" / "tutorial.py"
SCRIPT = REPO / "imbalanced_regression_tpu_torch" / "tutorial" / "tutorial.py"
NOTEBOOK = SCRIPT.with_suffix(".ipynb")
FIRST_EPOCH_RTOL = 1e-5
FINAL_MAE_RTOL = 0.01


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs():
    """Both tutorials run once, then the port's train loop again from the
    JAX run's initial params on the same rng stream."""
    with pytest.MonkeyPatch.context() as mp:
        torch.set_num_threads(2)
        jx = runpy.run_path(str(JAX_SCRIPT))
        mp.setattr(sys, "argv", [str(SCRIPT), "--device", "cpu"])
        port = runpy.run_path(str(SCRIPT))
    params = {"backbone": jx["backbone"].init(jax.random.key(0), jx["X"][:1])["params"],
              "head": jx["head"].init(jax.random.key(1), jnp.zeros((1, 64)))["params"]}
    sd = mlp_from_flax(jax.device_get(params))
    backbone, head = port["make_model"](torch.Generator().manual_seed(0), "cpu")
    backbone.load_state_dict(sd["backbone"])
    head.load_state_dict(sd["head"])
    rng = np.random.default_rng(0)
    X, y = port["make_data"](rng)
    _, losses = port["train"](backbone, head, X, y, port["weights"], rng)
    overall, shots = port["evaluate"](backbone, head, X, y)
    return dict(jax=jx, port=port, params=params, X=X, y=y, losses=losses, overall=overall,
                shots=shots)


def test_data_and_lds_weights_equal(runs):
    jx, port = runs["jax"], runs["port"]
    assert len(port["y"]) == 1749
    for name in ("X", "y", "weights"):
        np.testing.assert_array_equal(port[name], jx[name])
    np.testing.assert_array_equal(port["window"], jx["window"])
    np.testing.assert_array_equal(runs["X"], jx["X"])


def test_first_epoch_losses_match_jax(runs):
    """The JAX train step over epoch 0's 13 batches from the same params
    and permutation (FDS does not calibrate before ``start_smooth`` = 1)."""
    jx = runs["jax"]
    rng = np.random.default_rng(0)
    runs["port"]["make_data"](rng)
    params, opt_state = runs["params"], jx["tx"].init(runs["params"])
    fds_state = jx["fds_init"](jx["fds_cfg"])
    xj, yj, wj = jnp.asarray(runs["X"]), jnp.asarray(runs["y"]), jnp.asarray(jx["weights"])
    perm, want = rng.permutation(len(runs["y"])), []
    for s in range(0, len(perm) - 128 + 1, 128):
        idx = perm[s:s + 128]
        params, opt_state, loss = jx["train_step"](params, opt_state, fds_state, xj[idx], yj[idx],
                                                   wj[idx], 0)
        want.append(float(loss))
    assert len(runs["losses"]) == 15 and all(len(e) == 13 for e in runs["losses"])
    np.testing.assert_allclose(runs["losses"][0], want, rtol=FIRST_EPOCH_RTOL, atol=0)


def test_final_metrics_match_jax(runs):
    """The JAX run's final predictions (its evaluation cell's ``preds``)
    against the port's 15 epochs from the same params: overall and each
    shot region's MAE."""
    jx = runs["jax"]
    preds, y = np.asarray(jx["preds"]), jx["y"]
    want = jx["regression_metrics"](preds, y)
    shots = jx["shot_metrics"](preds, np.round(y), np.round(y), many_shot_thr=50, low_shot_thr=10)
    np.testing.assert_allclose(runs["overall"]["l1"], want["l1"], rtol=FINAL_MAE_RTOL)
    for region in ("many", "median", "low"):
        np.testing.assert_allclose(runs["shots"][region]["l1"], shots[region]["l1"],
                                   rtol=FINAL_MAE_RTOL)


@pytest.mark.parametrize("script", [JAX_SCRIPT, SCRIPT], ids=["jax_tutorial", "port_tutorial"])
def test_parse_percent_script_equals_jax(script):
    text = script.read_text()
    assert make_notebook.parse_percent_script(text) == jax_parse_percent_script(text)


def test_port_tutorial_follows_jax_cell_for_cell():
    def kinds(path):
        return [k for k, _ in make_notebook.parse_percent_script(path.read_text())]

    assert kinds(SCRIPT) == kinds(JAX_SCRIPT)


def test_make_notebook_executes_and_validates(tmp_path):
    nbformat = pytest.importorskip("nbformat")
    dst = tmp_path / "tutorial.ipynb"
    make_notebook.main([str(SCRIPT), str(dst), "--device", "cpu"])
    nb = nbformat.read(str(dst), as_version=4)
    nbformat.validate(nb)
    cells = make_notebook.parse_percent_script(SCRIPT.read_text())
    code = [c for c in nb.cells if c.cell_type == "code"]
    assert len(code) == sum(k == "code" for k, _ in cells)
    assert [c.execution_count for c in code] == list(range(1, len(code) + 1))
    assert code[0].outputs[0].text.startswith("device: cpu")
    printed = "".join(o.text for c in code for o in c.outputs)
    assert "1749 samples" in printed and "epoch 10: loss" in printed and "low {" in printed


def test_make_notebook_no_execute_writes_no_outputs(tmp_path):
    dst = tmp_path / "t.ipynb"
    make_notebook.main([str(SCRIPT), str(dst), "--no-execute"])
    nb = json.loads(dst.read_text())
    assert all(c["outputs"] == [] and c["execution_count"] is None
               for c in nb["cells"] if c["cell_type"] == "code")


def test_make_notebook_exits_nonzero_on_a_cell_error(tmp_path):
    src, dst = tmp_path / "bad.py", tmp_path / "bad.ipynb"
    src.write_text("# %%\nprint('first')\n\n# %%\nraise ValueError('cell two fails')\n")
    proc = subprocess.run([sys.executable, "-m", make_notebook.__name__, str(src), str(dst),
                           "--device", "cpu"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode != 0 and "cell two fails" in proc.stderr
    assert not dst.exists()


def test_committed_notebook_in_sync_with_its_script():
    nb = json.loads(NOTEBOOK.read_text())
    cells = make_notebook.parse_percent_script(SCRIPT.read_text())
    assert [(c["cell_type"], "".join(c["source"])) for c in nb["cells"]] == cells
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert [c["execution_count"] for c in code] == list(range(1, len(code) + 1))
    assert code[0]["outputs"][0]["text"][0].startswith("device: ")
    with_outputs = [bool(c["outputs"]) for c in code]
    assert with_outputs == [True, True, True, False, True, True]  # the model cell prints nothing
