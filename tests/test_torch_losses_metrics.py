"""The port's losses, metrics and head sums against the JAX package's.

Losses and sums are fp32 reductions in other orders: they match to 1e-6.
Confusion-matrix counts are exact, in Keras' int-cast mode and at > 0.5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.ops import losses as jl
from unet_image_segmentation_tpu.ops import metrics as jm
from unet_image_segmentation_tpu.ops.pallas import fused_head as jfh
from unet_image_segmentation_tpu_torch.ops import fused_head as tfh
from unet_image_segmentation_tpu_torch.ops import losses as tl
from unet_image_segmentation_tpu_torch.ops import metrics as tm

TOL = dict(rtol=1e-6, atol=1e-6)


def _binary(seed=0, shape=(3, 16, 16, 1)):
    rng = np.random.RandomState(seed)
    preds = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    preds.flat[:7] = [0.0, 1.0, 1.0, 0.5, 0.49999997, 0.50000006, 0.9999999]
    targets = (rng.uniform(0.0, 1.0, shape) > 0.6).astype(np.float32)
    return preds, targets


def _multiclass(seed=1, shape=(2, 8, 8), nc=3):
    rng = np.random.RandomState(seed)
    logits = rng.standard_normal(shape + (nc,)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = rng.randint(0, nc, shape)
    return probs.astype(np.float32), ids


@pytest.mark.parametrize("name", ["dice", "iou", "jaccard", "bce"])
def test_binary_losses_match(name):
    preds, targets = _binary()
    want = float(jl.get_loss(name)(jnp.asarray(targets), jnp.asarray(preds)))
    got = float(tl.get_loss(name)(torch.from_numpy(targets), torch.from_numpy(preds)))
    np.testing.assert_allclose(got, want, **TOL)


def test_cce_loss_matches():
    probs, ids = _multiclass()
    onehot = np.eye(3, dtype=np.float32)[ids]
    want = float(jl.get_loss("cce")(jnp.asarray(onehot), jnp.asarray(probs)))
    got = float(tl.get_loss("cce")(torch.from_numpy(onehot), torch.from_numpy(probs)))
    np.testing.assert_allclose(got, want, **TOL)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="Unknown loss"):
        tl.get_loss("focal")


def test_head_sums_binary_match():
    preds, targets = _binary(seed=2)
    targets = targets * 0.9 + 0.05  # soft targets: binarized at > 0.5 on both sides
    want = jfh.head_sums_reference(jnp.asarray(preds), jnp.asarray(targets))
    got = tfh.head_sums_reference(torch.from_numpy(preds), torch.from_numpy(targets))
    assert set(got) == set(jfh.SUM_KEYS) == set(tfh.SUM_KEYS)
    for k in jfh.SUM_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_head_sums_multiclass_match():
    probs, ids = _multiclass(seed=3)
    tgt = ids[..., None].astype(np.float32)
    want = jfh.head_sums_reference_mc(jnp.asarray(probs), jnp.asarray(tgt), 3)
    got = tfh.head_sums_reference_mc(torch.from_numpy(probs), torch.from_numpy(tgt), 3)
    for k in ("i", "p", "t", "cce", "cm"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


@pytest.mark.parametrize("name", ["dice", "iou", "jaccard"])
def test_loss_from_sums_matches(name):
    preds, targets = _binary(seed=4)
    sums_j = jfh.head_sums_reference(jnp.asarray(preds), jnp.asarray(targets))
    sums_t = tfh.head_sums_reference(torch.from_numpy(preds), torch.from_numpy(targets))
    want = float(jl.loss_from_sums(name, sums_j))
    got = float(tl.loss_from_sums(name, sums_t))
    np.testing.assert_allclose(got, want, **TOL)
    # the sums form equals the composed loss on the same (binary) masks
    composed = float(tl.get_loss(name)(torch.from_numpy(targets), torch.from_numpy(preds)))
    np.testing.assert_allclose(got, composed, rtol=1e-5)


def test_loss_from_sums_cce_and_support():
    probs, ids = _multiclass(seed=5)
    tgt = ids[..., None].astype(np.float32)
    sums_j = jfh.head_sums_reference_mc(jnp.asarray(probs), jnp.asarray(tgt), 3)
    sums_t = tfh.head_sums_reference_mc(torch.from_numpy(probs), torch.from_numpy(tgt), 3)
    np.testing.assert_allclose(float(tl.loss_from_sums("cce", sums_t)),
                               float(jl.loss_from_sums("cce", sums_j)), **TOL)
    for name in ("dice", "iou", "jaccard", "bce", "cce"):
        for nc in (1, 3):
            assert tl.sums_loss_supported(name, nc) == jl.sums_loss_supported(name, nc)
    with pytest.raises(ValueError, match="not expressible"):
        tl.loss_from_sums("bce", sums_t)


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_confusion_matrix_counts_exact(threshold):
    preds, targets = _binary(seed=6, shape=(4, 32, 32, 1))
    want = np.asarray(jm.confusion_matrix(jnp.asarray(targets), jnp.asarray(preds), 2, threshold))
    got = tm.confusion_matrix(torch.from_numpy(targets), torch.from_numpy(preds), 2, threshold)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum().item() == preds.size
    np.testing.assert_allclose(float(tm.mean_iou_from_cm(got)),
                               float(jm.mean_iou_from_cm(jnp.asarray(want))), **TOL)


def test_multiclass_cm_and_ious_exact():
    probs, ids = _multiclass(seed=7, shape=(2, 16, 16), nc=4)
    pred_cls = probs.argmax(-1)
    want = np.asarray(jm.confusion_matrix(jnp.asarray(ids), jnp.asarray(pred_cls), 4))
    got = tm.confusion_matrix(torch.from_numpy(ids), torch.from_numpy(pred_cls), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    cm = got.clone()
    cm[3, :] = 0.0  # a class that never occurs
    cm[:, 3] = 0.0
    np.testing.assert_allclose(tm.per_class_iou_from_cm(cm).numpy(),
                               np.asarray(jm.per_class_iou_from_cm(jnp.asarray(cm.numpy()))), **TOL)
    np.testing.assert_allclose(float(tm.mean_iou_from_cm(cm)),
                               float(jm.mean_iou_from_cm(jnp.asarray(cm.numpy()))), **TOL)


def test_dice_and_iou_coef_match():
    preds, targets = _binary(seed=8, shape=(2, 8, 8, 2))
    for jf, tf in ((jm.dice_coef, tm.dice_coef), (jm.iou_coef, tm.iou_coef)):
        np.testing.assert_allclose(
            float(tf(torch.from_numpy(targets), torch.from_numpy(preds))),
            float(jf(jnp.asarray(targets), jnp.asarray(preds))), **TOL)


@pytest.mark.parametrize("num_classes", [1, 3])
def test_metric_bundles_match_jax(num_classes):
    """The train step's metric bundle, from probabilities and from the head
    sums, against the JAX step's; the two forms agree with each other."""
    from unet_image_segmentation_tpu.train import steps as jsteps
    from unet_image_segmentation_tpu_torch.train import steps as tsteps

    if num_classes == 1:
        preds, masks = _binary(seed=9)
        sums_t = tfh.head_sums_reference(torch.from_numpy(preds), torch.from_numpy(masks))
        sums_j = jfh.head_sums_reference(jnp.asarray(preds), jnp.asarray(masks))
        got_s = tsteps.metric_bundle_sums(sums_t, torch.from_numpy(masks))
        want_s = jsteps._metric_bundle_sums(sums_j, jnp.asarray(masks))
    else:
        preds, ids = _multiclass(seed=10, nc=num_classes)
        masks = ids[..., None].astype(np.float32)
        sums_t = tfh.head_sums_reference_mc(torch.from_numpy(preds), torch.from_numpy(masks), 3)
        sums_j = jfh.head_sums_reference_mc(jnp.asarray(preds), jnp.asarray(masks), 3)
        got_s = tsteps.metric_bundle_sums_mc(sums_t)
        want_s = jsteps._metric_bundle_sums_mc(sums_j)
    got = tsteps.metric_bundle(torch.from_numpy(masks), torch.from_numpy(preds), num_classes)
    want = jsteps._metric_bundle(jnp.asarray(masks), jnp.asarray(preds), num_classes)
    for bundle_t, bundle_j in ((got, want), (got_s, want_s), (got_s, want)):
        np.testing.assert_allclose(float(bundle_t["dice"]), float(bundle_j["dice"]), **TOL)
        for k in ("cm_raw", "cm_thresh"):
            np.testing.assert_array_equal(bundle_t[k].numpy(), np.asarray(bundle_j[k]))
