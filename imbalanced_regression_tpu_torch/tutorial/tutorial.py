# %% [markdown]
# # Hands-on Tutorial: Deep Imbalanced Regression on PyTorch + CUDA
#
# PyTorch walkthrough of LDS and FDS on a small tabular regression problem —
# the port's counterpart of the JAX package's `tutorial/tutorial.py`, cell
# for cell. It shows how to apply the framework's building blocks to a
# *custom* dataset:
#
# 1. inspect the (imbalanced) label distribution,
# 2. turn it into LDS effective-density sample weights,
# 3. train a small MLP regressor with weighted losses,
# 4. add FDS feature calibration on the penultimate layer,
# 5. evaluate with shot-partitioned (many/median/few) metrics.
#
# Run as a script (`python -m imbalanced_regression_tpu_torch.tutorial.tutorial
# [--device cuda|cpu]`, on the card unless `--device cpu` is given) or open in
# a notebook UI that understands `# %%` cells. On the card, FDS calibration
# runs as the port's CUDA kernels (forward and backward on every train step
# from epoch 1 on, the bucket moments in every statistics pass).

# %%
import argparse

import numpy as np
import torch
import torch.nn as nn

from imbalanced_regression_tpu_torch.ops import (
    get_lds_kernel_window,
    prepare_weights_age,
    weighted_l1_loss,
)
from imbalanced_regression_tpu_torch.fds import (
    FDSConfig, fds_init, fds_smooth, fds_update_last_epoch_stats,
    fds_update_running_stats,
)
from imbalanced_regression_tpu_torch.utils.metrics import shot_metrics, regression_metrics
from imbalanced_regression_tpu_torch.models.resnet import dense_reset_
from imbalanced_regression_tpu_torch.train import resolve_device

# parse_known_args: a notebook kernel's own arguments do no harm
parser = argparse.ArgumentParser(description="The DIR tutorial.")
parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = resolve_device(parser.parse_known_args()[0].device)
print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")

# %% [markdown]
# ## 1. An imbalanced regression dataset
#
# A housing-style tabular problem: 13 features, a continuous price-like
# target whose distribution has a heavy head and a sparse tail (most targets
# cluster around 20, few above 40) — the classic DIR setting.

# %%
def make_data(rng, n=2000, d=13):
    X = rng.normal(size=(n, d)).astype(np.float32)
    true_w = rng.normal(size=(d,)).astype(np.float32)
    y = 22.0 + X @ true_w * 3.0 + rng.normal(0, 2.0, n).astype(np.float32)
    y = np.clip(y, 0, 50)
    # amplify the imbalance: subsample the tail
    keep = (y < 35) | (rng.random(n) < 0.15)
    return X[keep], y[keep]


rng = np.random.default_rng(0)
X, y = make_data(rng)
print(f"{len(y)} samples; labels 0-50; >35: {(y > 35).sum()} samples")

# %% [markdown]
# ## 2. LDS: from empirical density to sample weights
#
# The empirical label histogram is smoothed with a gaussian kernel window —
# acknowledging that nearby labels are informative for each other — and the
# *effective* density is inverted into per-sample weights (mean 1).

# %%
window = get_lds_kernel_window("gaussian", ks=5, sigma=2)
print("LDS kernel window:", np.round(window, 4))
weights = prepare_weights_age(y, reweight="sqrt_inv", max_target=51, lds=True,
                              lds_kernel="gaussian", lds_ks=5, lds_sigma=2)
print("weight of a tail sample:", weights[y > 40][:3])
print("weight of a head sample:", weights[(y > 20) & (y < 25)][:3])

# %% [markdown]
# ## 3. A small MLP regressor (PyTorch), trained with weighted L1
#
# Initialized as Flax's `Dense` is (lecun-normal kernel, zero bias), from an
# explicit generator. `train` runs the whole loop of section 4, so that it
# can be run again from other initial weights.

# %%
class MLPBackbone(nn.Module):
    def __init__(self, in_features: int = 13, hidden: int = 64):
        super().__init__()
        self.dense0 = nn.Linear(in_features, hidden)
        self.dense1 = nn.Linear(hidden, hidden)

    def forward(self, x):
        x = torch.relu(self.dense0(x))
        return torch.relu(self.dense1(x))  # penultimate features — the FDS hook point


def make_model(generator, device):
    backbone, head = MLPBackbone(), nn.Linear(64, 1)
    for layer in (backbone.dense0, backbone.dense1, head):
        dense_reset_(layer, generator)
    return backbone.to(device), head.to(device)


backbone, head = make_model(torch.Generator().manual_seed(0), device)

fds_cfg = FDSConfig.for_age(feature_dim=64, bucket_num=51, bucket_start=0,
                            start_update=0, start_smooth=1, ks=5, sigma=2)


def train(backbone, head, X, y, weights, rng, epochs=15, batch=128):
    """Adam at 1e-3 on the LDS-weighted L1 loss, FDS calibrating from
    ``start_smooth`` on; ``rng`` draws each epoch's permutation. Returns
    the final FDS state and each epoch's step losses."""
    dev = next(backbone.parameters()).device
    Xt, yt, wt = (torch.as_tensor(a, device=dev) for a in (X, y, weights))
    opt = torch.optim.Adam([*backbone.parameters(), *head.parameters()], lr=1e-3)
    fds_state = fds_init(fds_cfg, device=dev)
    losses = []
    for epoch in range(epochs):
        perm = rng.permutation(len(y))
        step_losses = []
        for s in range(0, len(y) - batch + 1, batch):
            idx = torch.as_tensor(perm[s : s + batch], device=dev)
            feats = fds_smooth(fds_cfg, fds_state, backbone(Xt[idx]), yt[idx], epoch)
            loss = weighted_l1_loss(head(feats), yt[idx, None], wt[idx, None])
            opt.zero_grad()
            loss.backward()
            opt.step()
            step_losses.append(loss.detach())
        with torch.no_grad():
            feats = backbone(Xt)
        fds_state = fds_update_last_epoch_stats(fds_cfg, fds_state, epoch)
        fds_state = fds_update_running_stats(fds_cfg, fds_state, feats, yt, epoch)
        losses.append(torch.stack(step_losses).tolist())
        if epoch % 5 == 0:
            print(f"epoch {epoch}: loss {losses[-1][-1]:.3f}")
    return fds_state, losses


# %% [markdown]
# ## 4. Training loop with the FDS lifecycle
#
# Per epoch: train with smoothed features → snapshot + kernel-smooth the
# running bucket statistics → update them with this epoch's features.

# %%
fds_state, losses = train(backbone, head, X, y, weights, rng)

# %% [markdown]
# ## 5. Shot-partitioned evaluation
#
# Regions are defined by *training* label frequency: many (>100 samples),
# median, few (<20). The balanced error across regions is the DIR headline.

# %%
def evaluate(backbone, head, X, y):
    dev = next(backbone.parameters()).device
    with torch.no_grad():
        preds = head(backbone(torch.as_tensor(X, device=dev)))[:, 0].cpu().numpy()
    shots = shot_metrics(preds, np.round(y), np.round(y), many_shot_thr=50, low_shot_thr=10)
    return regression_metrics(preds, y), shots


overall, shots = evaluate(backbone, head, X, y)
print("overall:", {k: round(v, 3) for k, v in overall.items()})
for region in ("many", "median", "low"):
    print(region, {k: round(v, 3) for k, v in shots[region].items()})

# %% [markdown]
# That's the whole recipe. For real workloads use the task drivers
# (`imbalanced_regression_tpu_torch.tasks.{age,stsb,nyud2}`), which add the
# unified trainer (data parallelism over `torch.distributed`, on-device
# augmentation, checkpoints with bit-exact resume, the CUDA FDS kernels) on
# top of these primitives.
