"""The train, eval and predict steps.

Port of ``unet_image_segmentation_tpu/train/steps.py`` (single device):
forward -> loss -> backward -> AdamW update -> the metric bundle.

* ``loss``: the batch loss (mean over the batch, as Keras).
* ``dice``: dice_coef.
* ``cm_raw``: 2x2 confusion matrix with Keras MeanIoU's int-cast of the
  probabilities (pessimistic; for parity with reference logs).
* ``cm_thresh``: the confusion matrix at > 0.5 (deployed semantics).

With ``use_pallas`` on a separable BatchNorm model and a loss that the
head sums express (the dice family; + cce for a softmax head), the model
returns the head-sums dict and loss and metrics come from it, as in the
JAX package. Metrics stay on the device; the loop fetches them once per
epoch.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from unet_image_segmentation_tpu_torch.models.unet import UNet
from unet_image_segmentation_tpu_torch.ops.losses import (
    get_loss,
    loss_from_sums,
    sums_loss_supported,
)
from unet_image_segmentation_tpu_torch.ops.metrics import SMOOTH, confusion_matrix, dice_coef
from unet_image_segmentation_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


def prep_masks(masks: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Loss-ready masks: binary passthrough; class ids -> one-hot (C > 1)."""
    if num_classes <= 1 or (masks.dim() == 4 and masks.shape[-1] == num_classes):
        return masks
    labels = masks[..., 0] if masks.dim() == 4 else masks
    return torch.nn.functional.one_hot(labels.long(), num_classes).float()


def metric_bundle_sums(sums: Metrics, masks: torch.Tensor) -> Metrics:
    """The binary bundle from the per-sample head sums: TP = I, FP = P - I,
    FN = T - I, TN = pixels - TP - FP - FN."""
    dice = ((2.0 * sums["i"] + SMOOTH) / (sums["t"] + sums["p"] + SMOOTH)).mean()
    npix = float(masks.shape[0] * masks.shape[1] * masks.shape[2])

    def cm(ik: str, pk: str, tk: str) -> torch.Tensor:
        i, p, t = sums[ik].sum(), sums[pk].sum(), sums[tk].sum()
        return torch.stack([torch.stack([npix - p - t + i, p - i]), torch.stack([t - i, i])])

    return {"dice": dice, "cm_raw": cm("ir", "pr", "tr"), "cm_thresh": cm("it", "pt", "tt")}


def metric_bundle_sums_mc(sums: Metrics) -> Metrics:
    """The multiclass bundle from the softmax head sums."""
    dice = ((2.0 * sums["i"] + SMOOTH) / (sums["t"] + sums["p"] + SMOOTH)).mean()
    cm = sums["cm"].sum(dim=0)
    return {"dice": dice, "cm_raw": cm, "cm_thresh": cm}


def metric_bundle(masks: torch.Tensor, preds: torch.Tensor, num_classes: int) -> Metrics:
    nc = max(num_classes, 2)
    if num_classes > 1:
        true_cls = masks[..., 0] if masks.dim() == preds.dim() else masks
        cm_raw = confusion_matrix(true_cls, preds.argmax(dim=-1), nc)
        return {"dice": dice_coef(prep_masks(masks, num_classes), preds),
                "cm_raw": cm_raw, "cm_thresh": cm_raw}
    return {
        "dice": dice_coef(masks, preds),
        "cm_raw": confusion_matrix(masks, preds, nc, threshold=None),
        "cm_thresh": confusion_matrix(masks, preds, nc, threshold=0.5),
    }


def uses_head_sums(model: UNet, loss_name: str) -> bool:
    return (
        model.use_pallas
        and model.use_batch_norm
        and model.conv_type == "separable"
        and sums_loss_supported(loss_name, model.num_classes)
    )


def draw_dropout_seeds(model: UNet, generator: torch.Generator):
    """One int32 seed per dropout site (index = site), or None without dropout."""
    if model.dropout_rate <= 0.0:
        return None
    depth = len(model.filters)
    return torch.randint(-2**31, 2**31, (depth + 1,), generator=generator,
                         dtype=torch.int64).tolist()


def make_train_step(
    model: UNet, loss_name: str = "dice"
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Metrics]:
    """``step(state, images, masks) -> metrics``; updates ``state`` in place."""
    loss_core = get_loss(loss_name)
    head_sums = uses_head_sums(model, loss_name)

    def step(state: TrainState, images: torch.Tensor, masks: torch.Tensor) -> Metrics:
        seeds = draw_dropout_seeds(model, state.generator)
        state.optimizer.zero_grad(set_to_none=True)
        if head_sums:
            out = model(images, train=True, head_targets=masks, dropout_seeds=seeds)
            loss = loss_from_sums(loss_name, out)
        else:
            out = model(images, train=True, dropout_seeds=seeds)
            loss = loss_core(prep_masks(masks, model.num_classes), out)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            if not head_sums:
                bundle = metric_bundle(masks, out.detach(), model.num_classes)
            elif model.num_classes > 1:
                bundle = metric_bundle_sums_mc({k: v.detach() for k, v in out.items()})
            else:
                bundle = metric_bundle_sums({k: v.detach() for k, v in out.items()}, masks)
        return {"loss": loss.detach(), **bundle}

    return step


def make_eval_step(
    model: UNet, loss_name: str = "dice"
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Metrics]:
    """Validation step: running BatchNorm statistics, no dropout. With
    ``use_pallas`` every separable block runs the eval kernel K8."""
    loss_core = get_loss(loss_name)

    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor, masks: torch.Tensor) -> Metrics:
        preds = model(images)
        loss = loss_core(prep_masks(masks, model.num_classes), preds)
        return {"loss": loss, **metric_bundle(masks, preds, model.num_classes)}

    return step


def make_predict_fn(model: UNet) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pure forward (inference) closure over the model's current weights."""
    return torch.no_grad()(lambda images: model(images))
