"""The train, eval and predict steps.

Port of ``unet_image_segmentation_tpu/train/steps.py``: forward -> loss ->
backward -> AdamW update -> the metric bundle, on one device or on a
('data', 'spatial') mesh of ranks (:mod:`..parallel.mesh`), each rank
running the whole step on its shard as the JAX ``shard_map`` step does.

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

On a mesh the model must carry the mesh's groups
(``model.set_groups(mesh.group, mesh.spatial_group)``): the BatchNorm
moments are the mesh batch's. The gradients are summed over the mesh and
divided by the data degree (row shards' partials add up to their batch
shard's gradient, equal batch shards average to the global batch's); the
loss is averaged. A row-sharded (spatial > 1) step computes what the
unsharded step computes, as the JAX package's GSPMD-partitioned step does:

* a loss with a sums form (the dice family; + cce for a softmax head)
  takes the per-sample head sums of this rank's rows (the fused chains'
  or the composed head's), summed over the spatial group with the
  identity cotangent;
* any other loss (bce) takes its value and the metrics from the
  probabilities gathered over the spatial group
  (:meth:`..parallel.mesh.Mesh.gather_rows`, whose backward keeps this
  rank's rows);
* where the model cannot take the row shards
  (:meth:`..models.unet.UNet.runs_on_row_shards`: a local height that
  does not survive every pool, or a ``use_pallas`` model outside the
  fused chains, whose K8 takes whole images) each data row's images are
  gathered first and run whole on every rank of the row, the dropout
  seeds folded with the data index only; the gradient sum is then divided
  by the whole mesh's size.

The metrics of a row-sharded step are the data row's already and are
reduced over the data group only.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from unet_image_segmentation_tpu_torch.models.unet import UNet
from unet_image_segmentation_tpu_torch.ops.losses import (
    get_loss,
    loss_from_sums,
    sums_loss_supported,
)
from unet_image_segmentation_tpu_torch.ops.hash_dropout import fold_seed
from unet_image_segmentation_tpu_torch.ops.metrics import SMOOTH, confusion_matrix, dice_coef
from unet_image_segmentation_tpu_torch.parallel.mesh import Mesh
from unet_image_segmentation_tpu_torch.parallel.reduce import all_sum, replicated_sum
from unet_image_segmentation_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


def prep_masks(masks: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Loss-ready masks: binary passthrough; class ids -> one-hot (C > 1)."""
    if num_classes <= 1 or (masks.dim() == 4 and masks.shape[-1] == num_classes):
        return masks
    labels = masks[..., 0] if masks.dim() == 4 else masks
    return torch.nn.functional.one_hot(labels.long(), num_classes).float()


def metric_bundle_sums(sums: Metrics, masks: torch.Tensor, npix_scale: int = 1) -> Metrics:
    """The binary bundle from the per-sample head sums: TP = I, FP = P - I,
    FN = T - I, TN = pixels - TP - FP - FN. ``npix_scale``: on row shards
    ``masks`` holds 1/n of each sample's rows while the sums are the whole
    sample's."""
    dice = ((2.0 * sums["i"] + SMOOTH) / (sums["t"] + sums["p"] + SMOOTH)).mean()
    npix = float(masks.shape[0] * masks.shape[1] * masks.shape[2] * npix_scale)

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


def draw_dropout_seeds(model: UNet, generator: torch.Generator, mesh: Optional[Mesh] = None,
                       fold_rows: bool = True):
    """One int32 seed per dropout site (index = site), or None without
    dropout. On a mesh every rank draws the same seeds, then folds in its
    data index, and on row shards its spatial index (JAX ``fold_in`` of the
    axis indices), so each shard's masks differ. ``fold_rows=False``: the
    row's ranks run the same whole images and keep the same seeds."""
    if model.dropout_rate <= 0.0:
        return None
    depth = len(model.filters)
    seeds = torch.randint(-2**31, 2**31, (depth + 1,), generator=generator,
                          dtype=torch.int64).tolist()
    if mesh is not None and mesh.size > 1:
        seeds = [fold_seed(s, mesh.data_index) for s in seeds]
        if mesh.shape["spatial"] > 1 and fold_rows:
            seeds = [fold_seed(s, mesh.spatial_index) for s in seeds]
    return seeds


def _check_mesh_model(model: UNet, mesh: Optional[Mesh]) -> bool:
    """Raise where ``model`` does not carry ``mesh``'s groups; True on row
    shards."""
    if mesh is None or mesh.size == 1:
        return False
    if model.use_batch_norm and model.groups.bn is not mesh.group:
        raise ValueError("a step on a mesh needs model.set_groups(mesh.group, ...) "
                         "(BatchNorm moments are the mesh batch's)")
    if mesh.shape["spatial"] == 1:
        if model.groups.spatial is not None:
            raise ValueError("the model has a spatial group but the mesh no row shards")
        return False
    if model.groups.spatial is not mesh.spatial_group:
        raise ValueError("the row-sharded train step needs "
                         "model.set_groups(mesh.group, mesh.spatial_group)")
    return True


def _reduce_metrics(metrics: Metrics, group, ranks: int) -> Metrics:
    """Per-shard metrics -> the global batch's: confusion matrices are
    counts (summed), the scalars means over equal shards (averaged)."""
    if group is None:
        return metrics
    return {k: all_sum(v, group) if k.startswith("cm_") else all_sum(v, group) / ranks
            for k, v in metrics.items()}


def _sum_gradients(params, mesh: Mesh, ranks: int) -> None:
    """Every gradient summed over the mesh in one collective, divided by
    ``ranks``: the data degree, or the mesh's size where every rank of a
    data row computed the same whole images' gradient."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_sum(torch.cat([g.reshape(-1) for g in grads]), mesh.group)
    flat /= ranks
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(
    model: UNet, loss_name: str = "dice", mesh: Optional[Mesh] = None
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Metrics]:
    """``step(state, images, masks) -> metrics``; updates ``state`` in place.
    On a mesh ``images`` and ``masks`` are this rank's shard
    (:meth:`..parallel.mesh.Mesh.shard`) and the metrics the global batch's."""
    loss_core = get_loss(loss_name)
    rows = _check_mesh_model(model, mesh)
    sharded = mesh is not None and mesh.size > 1
    sums_form = sums_loss_supported(loss_name, model.num_classes)

    def step(state: TrainState, images: torch.Tensor, masks: torch.Tensor) -> Metrics:
        # a shard the model cannot take on rows: the row's whole images
        whole = rows and not model.runs_on_row_shards(images.shape[1], train=True)
        if whole:
            images, masks = mesh.gather_rows(images), mesh.gather_rows(masks)
        on_rows = rows and not whole
        head_sums = sums_form if on_rows else uses_head_sums(model, loss_name)
        seeds = draw_dropout_seeds(model, state.generator, mesh, fold_rows=not whole)
        kw = dict(train=True, dropout_seeds=seeds,
                  spatial_group=mesh.spatial_group if on_rows else None)
        state.optimizer.zero_grad(set_to_none=True)
        if head_sums:
            out = model(images, head_targets=masks, **kw)
            if on_rows:
                out = {k: replicated_sum(v, mesh.spatial_group) for k, v in out.items()}
            loss = loss_from_sums(loss_name, out)
        else:
            out = model(images, **kw)
            if on_rows:   # no sums form: the loss of the gathered rows
                out, masks = mesh.gather_rows(out), mesh.gather_rows(masks)
            loss = loss_core(prep_masks(masks, model.num_classes), out)
        loss.backward()
        if sharded:
            _sum_gradients(model.parameters(), mesh, mesh.size if whole else mesh.shape["data"])
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            if not head_sums:
                bundle = metric_bundle(masks, out.detach(), model.num_classes)
            elif model.num_classes > 1:
                bundle = metric_bundle_sums_mc({k: v.detach() for k, v in out.items()})
            else:
                bundle = metric_bundle_sums({k: v.detach() for k, v in out.items()}, masks,
                                            mesh.shape["spatial"] if on_rows else 1)
            metrics = {"loss": loss.detach(), **bundle}
            if rows:   # the row's ranks hold the same numbers: reduce over the data group
                metrics = _reduce_metrics(metrics, mesh.data_group, mesh.shape["data"])
            elif sharded:
                metrics = _reduce_metrics(metrics, mesh.group, mesh.size)
        return metrics

    return step


def make_eval_step(
    model: UNet, loss_name: str = "dice", mesh: Optional[Mesh] = None
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Metrics]:
    """Validation step: running BatchNorm statistics, no dropout. With
    ``use_pallas`` every separable block runs the eval kernel K8.

    On a mesh ``images`` and ``masks`` are this rank's shard and the metrics
    are reduced over the data group. On row shards each rank first gathers
    its data row's rows and evaluates the whole images of its batch shard
    through the module path (K8 per block, which takes whole images only);
    the JAX package evaluates there through the XLA module under GSPMD,
    whose numbers are the whole images'."""
    loss_core = get_loss(loss_name)
    sharded = mesh is not None and mesh.size > 1

    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor, masks: torch.Tensor) -> Metrics:
        if sharded:
            images, masks = mesh.gather_rows(images), mesh.gather_rows(masks)
        preds = model(images)
        loss = loss_core(prep_masks(masks, model.num_classes), preds)
        metrics = {"loss": loss, **metric_bundle(masks, preds, model.num_classes)}
        if sharded:
            metrics = _reduce_metrics(metrics, mesh.data_group, mesh.shape["data"])
        return metrics

    return step


def make_predict_fn(model: UNet) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pure forward (inference) closure over the model's current weights."""
    return torch.no_grad()(lambda images: model(images))
