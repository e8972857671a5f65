"""Segmentation losses, port of ``unet_image_segmentation_tpu/ops/losses.py``.

``dice``, ``iou`` (alias ``jaccard``), ``bce`` (probabilities clipped to
[1e-7, 1-1e-7]) and ``cce`` (clipped to [1e-7, 1]) on materialized
probabilities, and :func:`loss_from_sums` on the head-sums contract
(:mod:`.fused_head`), with the same formulas in the same order.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from unet_image_segmentation_tpu_torch.ops.metrics import SMOOTH, dice_coef, iou_coef


def dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return 1.0 - dice_coef(y_true, y_pred)


def iou_loss(y_true: torch.Tensor, y_pred: torch.Tensor, smooth: float = SMOOTH) -> torch.Tensor:
    return 1.0 - iou_coef(y_true, y_pred, smooth=smooth)


jaccard_loss = iou_loss


def bce_loss(y_true: torch.Tensor, y_pred: torch.Tensor, eps: float = SMOOTH) -> torch.Tensor:
    """Binary cross-entropy on probabilities (Keras clipping), mean over all."""
    y_true = y_true.float()
    y_pred = y_pred.float().clamp(eps, 1.0 - eps)
    return -(y_true * torch.log(y_pred) + (1.0 - y_true) * torch.log(1.0 - y_pred)).mean()


def categorical_ce_loss(
    y_true: torch.Tensor, y_pred: torch.Tensor, eps: float = SMOOTH
) -> torch.Tensor:
    """Categorical cross-entropy on softmax probabilities, mean over pixels."""
    y_pred = y_pred.float().clamp(eps, 1.0)
    return (-(y_true.float() * torch.log(y_pred)).sum(dim=-1)).mean()


SUMS_LOSSES = ("dice", "iou", "jaccard")
SUMS_LOSSES_MULTICLASS = SUMS_LOSSES + ("cce",)


def sums_loss_supported(name: str, num_classes: int) -> bool:
    """Can :func:`loss_from_sums` express this loss for this head?"""
    return name in (SUMS_LOSSES_MULTICLASS if num_classes > 1 else SUMS_LOSSES)


def loss_from_sums(name: str, sums: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Loss from the per-sample head sums (``i``, ``p``, ``t``[, ``cce``])."""
    if name == "cce":
        if "cce" not in sums:
            raise ValueError("loss 'cce' needs the multiclass head sums (key 'cce')")
        npix = sums["t"].sum(dim=-1)
        return (sums["cce"] / npix.clamp_min(1.0)).mean()
    i, p, t = sums["i"], sums["p"], sums["t"]
    if name == "dice":
        coef = (2.0 * i + SMOOTH) / (t + p + SMOOTH)
    elif name in ("iou", "jaccard"):
        coef = (i + SMOOTH) / (t + p - i + SMOOTH)
    else:
        raise ValueError(
            f"loss {name!r} is not expressible from the head sums; "
            f"available: {SUMS_LOSSES_MULTICLASS}"
        )
    return 1.0 - coef.mean()


_LOSSES: Dict[str, Callable[..., torch.Tensor]] = {
    "dice": dice_loss,
    "iou": iou_loss,
    "jaccard": jaccard_loss,
    "bce": bce_loss,
    "cce": categorical_ce_loss,
}


def get_loss(name: str) -> Callable[..., torch.Tensor]:
    try:
        return _LOSSES[name]
    except KeyError:
        raise ValueError(f"Unknown loss {name!r}; available: {sorted(_LOSSES)}") from None
