"""The head-sums contract, plain part of ``ops/pallas/fused_head.py``.

A training forward given ``head_targets`` returns, instead of
probabilities, a dict of per-sample fp32 reductions that every dice-family
loss and the confusion-matrix metrics are computed from
(:func:`..losses.loss_from_sums`, ``train.steps``). Here the dict is
computed from the materialized probabilities, as the JAX package does on
every path but its fused head kernel (K5, ``_head_fwd_kernel``), which is
not ported yet (ROADMAP queue 2, K5).
"""

from __future__ import annotations

from typing import Dict

import torch

SUM_KEYS = ("i", "p", "t", "it", "pt", "tt", "ir", "pr", "tr")
CLIP_EPS = 1e-7


def head_sums_reference(preds: torch.Tensor, targets: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Sigmoid head: per-sample ``(B,)`` sums keyed by :data:`SUM_KEYS`.

    Targets are binarized at > 0.5. ``i/p/t`` are the soft dice sums,
    ``it/pt/tt`` the counts at > 0.5, and ``ir/pr/tr`` the Keras int-cast
    counts (a probability counts only when it reaches 1.0).
    """
    y = (preds[..., 0] if preds.dim() == 4 else preds).float()
    t = ((targets[..., 0] if targets.dim() == 4 else targets) > 0.5).float()
    pred = (y > 0.5).float()
    tth = (t > 0.5).float()
    yr = (y >= 1.0).float()
    tr = torch.floor(t).clamp(0.0, 1.0)
    ax = (1, 2)
    return {
        "i": (y * t).sum(dim=ax),
        "p": y.sum(dim=ax),
        "t": t.sum(dim=ax),
        "it": (pred * tth).sum(dim=ax),
        "pt": pred.sum(dim=ax),
        "tt": tth.sum(dim=ax),
        "ir": (yr * tr).sum(dim=ax),
        "pr": yr.sum(dim=ax),
        "tr": tr.sum(dim=ax),
    }


def head_sums_reference_mc(
    preds: torch.Tensor, targets: torch.Tensor, num_classes: int
) -> Dict[str, torch.Tensor]:
    """Softmax head: per-class ``i/p/t`` (B, C), the clipped CCE sum (B,)
    and the per-sample argmax confusion matrix ``cm`` (B, C, C)."""
    y = preds.float()
    if targets.dim() == 4:
        tid = targets.argmax(dim=-1) if targets.shape[-1] == num_classes > 1 else targets[..., 0]
    else:
        tid = targets
    tid = torch.round(tid.float()).long().clamp(0, num_classes - 1)
    t1 = torch.nn.functional.one_hot(tid, num_classes).float()
    p1 = torch.nn.functional.one_hot(y.argmax(dim=-1), num_classes).float()
    b = y.shape[0]
    ax = (1, 2)
    return {
        "i": (y * t1).sum(dim=ax),
        "p": y.sum(dim=ax),
        "t": t1.sum(dim=ax),
        "cce": (-t1 * torch.log(y.clamp(CLIP_EPS, 1.0))).sum(dim=(1, 2, 3)),
        "cm": torch.einsum(
            "bni,bnj->bij", t1.reshape(b, -1, num_classes), p1.reshape(b, -1, num_classes)
        ),
    }
