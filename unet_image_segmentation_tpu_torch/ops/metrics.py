"""Segmentation metrics, port of ``unet_image_segmentation_tpu/ops/metrics.py``.

* :func:`dice_coef` / :func:`iou_coef`: fp32, sums over the spatial axes
  per (sample, channel), Keras smoothing 1e-7, mean over the rest.
* :func:`confusion_matrix`: Keras ``MeanIoU``'s int-cast of raw
  probabilities with ``threshold=None`` (anything below 1.0 counts as
  class 0), or a binarization at ``threshold`` first. Counts are exact:
  they are taken with ``bincount`` on int64.
* :func:`mean_iou_from_cm` / :func:`per_class_iou_from_cm`.
* :class:`MeanIoUState` and :func:`mean_iou_init` / :func:`mean_iou_update`
  / :func:`mean_iou_result`: a confusion matrix accumulated over batches.
* :func:`sample_iou`: one smoothed IoU per sample of binarized masks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

SMOOTH = 1e-7  # Keras backend epsilon


def _sums(y_true: torch.Tensor, y_pred: torch.Tensor):
    y_true, y_pred = y_true.float(), y_pred.float()
    inter = (y_true * y_pred).sum(dim=(1, 2))
    return inter, y_true.sum(dim=(1, 2)), y_pred.sum(dim=(1, 2))


def dice_coef(y_true: torch.Tensor, y_pred: torch.Tensor, smooth: float = SMOOTH) -> torch.Tensor:
    """``mean((2*I + s) / (|T| + |P| + s))`` over (batch, channels)."""
    inter, st, sp = _sums(y_true, y_pred)
    return ((2.0 * inter + smooth) / (st + sp + smooth)).mean()


def iou_coef(y_true: torch.Tensor, y_pred: torch.Tensor, smooth: float = SMOOTH) -> torch.Tensor:
    """``mean((I + s) / (|T| + |P| - I + s))`` over (batch, channels)."""
    inter, st, sp = _sums(y_true, y_pred)
    return ((inter + smooth) / (st + sp - inter + smooth)).mean()


def confusion_matrix(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    num_classes: int,
    threshold: Optional[float] = None,
) -> torch.Tensor:
    """(num_classes, num_classes) fp32 counts, rows = true class."""
    if threshold is not None:
        y_pred = y_pred > threshold
        y_true = y_true > threshold
    # float -> int truncates toward zero, as the JAX astype(int32) does
    t = y_true.to(torch.int64).reshape(-1).clamp(0, num_classes - 1)
    p = y_pred.to(torch.int64).reshape(-1).clamp(0, num_classes - 1)
    counts = torch.bincount(t * num_classes + p, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes).float()


def _iou_per_class(cm: torch.Tensor) -> torch.Tensor:
    tp = torch.diagonal(cm)
    denom = cm.sum(dim=0) + cm.sum(dim=1) - tp
    valid = denom > 0
    return torch.where(valid, tp / torch.where(valid, denom, torch.ones_like(denom)),
                       torch.zeros_like(denom))


def mean_iou_from_cm(cm: torch.Tensor) -> torch.Tensor:
    """Keras MeanIoU reduction: mean over classes with a nonzero denominator."""
    tp = torch.diagonal(cm)
    denom = cm.sum(dim=0) + cm.sum(dim=1) - tp
    n_valid = (denom > 0).float().sum().clamp_min(1.0)
    return _iou_per_class(cm).sum() / n_valid


def per_class_iou_from_cm(cm: torch.Tensor) -> torch.Tensor:
    """Per-class IoU vector (classes with no pixels report 0)."""
    return _iou_per_class(cm)


class MeanIoUState(NamedTuple):
    """Confusion-matrix counts accumulated over batches."""

    cm: torch.Tensor


def mean_iou_init(num_classes: int = 2) -> MeanIoUState:
    return MeanIoUState(cm=torch.zeros((num_classes, num_classes), dtype=torch.float32))


def mean_iou_update(
    state: MeanIoUState,
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    threshold: Optional[float] = None,
) -> MeanIoUState:
    num_classes = state.cm.shape[0]
    cm = confusion_matrix(y_true, y_pred, num_classes, threshold)
    return MeanIoUState(cm=state.cm + cm.to(state.cm.device))


def mean_iou_result(state: MeanIoUState) -> torch.Tensor:
    return mean_iou_from_cm(state.cm)


def sample_iou(y_true: torch.Tensor, y_pred: torch.Tensor, smooth: float = SMOOTH) -> torch.Tensor:
    """Per-sample IoU of already-binarized masks: ``(I + s) / (|T| + |P| - I
    + s)`` over every axis but the batch axis, or over all of a 2-D mask (a
    scalar)."""
    y_true, y_pred = y_true.float(), y_pred.float()
    axes = tuple(range(1, y_true.dim())) if y_true.dim() > 2 else tuple(range(y_true.dim()))
    inter = (y_true * y_pred).sum(dim=axes)
    union = y_true.sum(dim=axes) + y_pred.sum(dim=axes) - inter
    return (inter + smooth) / (union + smooth)
