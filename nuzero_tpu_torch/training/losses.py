"""Loss functions, batched (counterpart of ``nuzero_tpu/training/losses.py``;
ref ``Utils/Functions/loss_functions.py`` + ``Training/AlphaZero.py:327,891-939``).

- ``cel``: cross-entropy with soft targets and label smoothing 0.02;
- ``kld``: KL(target || log_softmax(pred)), torch ``KLDivLoss``'s default
  'mean over elements' reduction;
- ``mse_policy``: softmax MSE over the actions with a non-zero target;
- ``se``/``ae``: squared / absolute error.

``normalize_policy`` divides the policy loss by log(num_actions), as the
JAX package does (its documented intent, where the reference divides by
log(batch_size)).
"""

from __future__ import annotations

import math

import torch

LABEL_SMOOTHING = 0.02


def cel(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with label smoothing; [B, A] -> [B]."""
    num_actions = logits.shape[-1]
    smoothed = target * (1.0 - LABEL_SMOOTHING) + LABEL_SMOOTHING / num_actions
    return -(smoothed * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def kld(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """KL divergence, target in probability space; [B, A] -> [B], the sum
    over actions divided by the number of actions."""
    logp = torch.log_softmax(logits, dim=-1)
    elt = torch.where(
        target > 0, target * (torch.log(target.clamp(min=1e-30)) - logp), 0.0
    )
    return elt.sum(dim=-1) / logits.shape[-1]


def mse_policy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Softmax MSE counting only non-zero-target actions; [B, A] -> [B]."""
    p = torch.softmax(logits, dim=-1)
    nz = target != 0
    per = torch.where(nz, (target - p) ** 2, 0.0).sum(dim=-1)
    return per / nz.sum(dim=-1).clamp(min=1)


def se(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (target - pred) ** 2


def ae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (target - pred).abs()


POLICY_LOSSES = {"CEL": cel, "KLD": kld, "MSE": mse_policy}
VALUE_LOSSES = {"SE": se, "AE": ae}


def combined_loss(
    policy_logits: torch.Tensor,
    value_pred: torch.Tensor,
    policy_target: torch.Tensor,
    value_target: torch.Tensor,
    *,
    policy_loss: str = "CEL",
    value_loss: str = "SE",
    normalize_policy: bool = False,
):
    """Batch-mean (value, policy, combined) losses."""
    p = POLICY_LOSSES[policy_loss](policy_logits, policy_target).mean()
    v = VALUE_LOSSES[value_loss](value_pred, value_target).mean()
    if normalize_policy:
        p = p / math.log(policy_logits.shape[-1])
    return v, p, p + v
