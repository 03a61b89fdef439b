"""Weighted regression losses.

API names and semantics match the reference (``imdb-wiki-dir/loss.py:5-48``,
byte-identical across suites there): the per-element loss is multiplied by the
(broadcast) sample weights and then averaged over *all* elements. They compute
in the input dtype and reduce in float32 for bf16 stability.
"""

from __future__ import annotations

import torch


def _weighted_mean(loss, weights):
    if weights is not None:
        loss = loss * torch.broadcast_to(weights, loss.shape)
    return loss.to(torch.float32).mean()


def weighted_mse_loss(inputs, targets, weights=None):
    return _weighted_mean((inputs - targets) ** 2, weights)


def weighted_l1_loss(inputs, targets, weights=None):
    return _weighted_mean(torch.abs(inputs - targets), weights)


def _focal_scale(inputs, targets, activate: str, beta: float, gamma: float):
    err = torch.abs(inputs - targets)
    if activate == "tanh":
        return torch.tanh(beta * err) ** gamma
    return (2.0 * torch.sigmoid(beta * err) - 1.0) ** gamma


def weighted_focal_mse_loss(inputs, targets, weights=None, activate="sigmoid", beta=0.2, gamma=1.0):
    loss = (inputs - targets) ** 2 * _focal_scale(inputs, targets, activate, beta, gamma)
    return _weighted_mean(loss, weights)


def weighted_focal_l1_loss(inputs, targets, weights=None, activate="sigmoid", beta=0.2, gamma=1.0):
    loss = torch.abs(inputs - targets) * _focal_scale(inputs, targets, activate, beta, gamma)
    return _weighted_mean(loss, weights)


def weighted_huber_loss(inputs, targets, weights=None, beta=1.0):
    l1 = torch.abs(inputs - targets)
    loss = torch.where(l1 < beta, 0.5 * l1**2 / beta, l1 - 0.5 * beta)
    return _weighted_mean(loss, weights)


LOSS_REGISTRY = {
    "mse": weighted_mse_loss,
    "l1": weighted_l1_loss,
    "focal_mse": weighted_focal_mse_loss,
    "focal_l1": weighted_focal_l1_loss,
    "huber": weighted_huber_loss,
}
