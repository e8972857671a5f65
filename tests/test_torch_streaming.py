"""The port's preprocessing and StreamingPredictor against the JAX package's.

``ops.preprocess`` (the resize matrices and products, nearest resize, frame
preprocessing, probability postprocessing) and ``StreamingPredictor`` (float
and int8, BGR and RGB, probabilities and thresholded masks, the shape
guard) on the same numpy weights and uint8 frames: a 64 px U-Net with
filters (8, 16), fp32, batch 2. The port serves its kernel graph
(``use_pallas=True``; the CPU runs K7's plain version); the JAX float
stream runs its module path, its int8 stream its Pallas int8 graph in
interpret mode, as the JAX package's own tests run them. The JAX
``StreamingPredictor`` reads a stand-in for its ``Predictor`` (the
attributes it reads, on the same variables), so no JAX checkpoint is
written.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.models.unet import UNet as JaxUNet
from unet_image_segmentation_tpu.ops import preprocess as jpre
from unet_image_segmentation_tpu.streaming import StreamingPredictor as JaxStreamingPredictor
from unet_image_segmentation_tpu_torch.inference import Predictor
from unet_image_segmentation_tpu_torch.models.unet import UNet, recalibrate_batch_norm
from unet_image_segmentation_tpu_torch.ops import fused_sepconv as tfs
from unet_image_segmentation_tpu_torch.ops import preprocess as pre
from unet_image_segmentation_tpu_torch.streaming import StreamingPredictor
from unet_image_segmentation_tpu_torch.train.checkpoint import save_inference_variables
from unet_image_segmentation_tpu_torch.weights import flax_from_state_dict

HW = 64
FILTERS = (8, 16)
PROB_TOL = 1e-4


@pytest.mark.parametrize("out_size,in_size", [(24, 37), (80, 53), (1024, 1080), (1080, 1024),
                                              (7, 7), (1, 5)])
def test_resize_matrix_copy_equals_jax(out_size, in_size):
    np.testing.assert_array_equal(pre._resize_matrix(out_size, in_size),
                                  jpre._resize_matrix(out_size, in_size))
    for mine, theirs in zip(pre._linear_coords(out_size, in_size),
                            jpre._linear_coords(out_size, in_size)):
        np.testing.assert_array_equal(mine, theirs)


def test_resize_matrices_reach_the_device_once():
    """A stream resizes every batch with the same matrices: each is copied
    to its device on first use and reused after."""
    cpu = torch.device("cpu")
    first = pre._matrix(24, 37, cpu)
    assert pre._matrix(24, 37, cpu) is first and first.device == cpu
    np.testing.assert_array_equal(first.numpy(), jpre._resize_matrix(24, 37))


@pytest.mark.parametrize("out_hw", [(24, 80), (37, 53), (16, 53), (37, 20)])
def test_resizes_match_jax(out_hw):
    """Bilinear within 1e-6 (two fp32 products each way), nearest exactly,
    the same size passed through."""
    x = np.random.RandomState(1).rand(2, 37, 53, 3).astype(np.float32)
    got = pre.resize_bilinear(torch.from_numpy(x), out_hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, *out_hw, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpre.resize_bilinear(jnp.asarray(x),
                                                                          out_hw)), atol=1e-6)
    np.testing.assert_array_equal(pre.resize_nearest(torch.from_numpy(x), out_hw).numpy(),
                                  np.asarray(jpre.resize_nearest(jnp.asarray(x), out_hw)))
    same = torch.from_numpy(x)
    assert pre.resize_bilinear(same, (37, 53)) is same


@pytest.mark.parametrize("pad_to,dtype_name", [(None, "float32"), ((40, 64), "float32"),
                                               ((32, 48), "bfloat16")])
def test_preprocess_and_postprocess_match_jax(pad_to, dtype_name):
    frames = (np.random.RandomState(2).rand(2, 45, 70, 3) * 255).astype(np.uint8)
    got = pre.preprocess_frames(torch.from_numpy(frames), (32, 48), pad_to, dtype_name)
    want = np.asarray(jpre.preprocess_frames(jnp.asarray(frames), (32, 48), pad_to,
                                             dtype_name).astype(jnp.float32))
    assert got.dtype == getattr(torch, dtype_name) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-6 if dtype_name == "float32" else 2 ** -8)
    probs = np.random.RandomState(3).rand(2, 32, 48, 1).astype(np.float32)
    np.testing.assert_allclose(pre.postprocess_probs(torch.from_numpy(probs), (45, 70)).numpy(),
                               np.asarray(jpre.postprocess_probs(jnp.asarray(probs), (45, 70))),
                               atol=1e-6)


def seeded_model(root, seed):
    """(port checkpoint, Flax-layout numpy tree) of one seeded U-Net whose
    BatchNorm statistics are those of a numpy batch."""
    net = UNet(num_classes=1, filters=FILTERS, dropout_rate=0.0,
               generator=torch.Generator().manual_seed(seed), device="cpu")
    recalibrate_batch_norm(net, torch.from_numpy(
        np.random.RandomState(seed).rand(4, HW, HW, 3).astype(np.float32)))
    ckpt = str(root / "ckpt")
    save_inference_variables(ckpt, net.state_dict(), {"num_classes": 1, "filters": list(FILTERS),
                                                      "dropout_rate": 0.0})
    return ckpt, flax_from_state_dict(net.state_dict())


def jax_predictor(variables, quantize=None):
    """What the JAX StreamingPredictor reads of a JAX Predictor: the module
    path's model and variables, or a pending int8 serving graph."""
    return SimpleNamespace(
        model=JaxUNet(num_classes=1, filters=FILTERS, dropout_rate=0.0),
        variables=jax.tree_util.tree_map(jnp.asarray, variables), image_size=(HW, HW),
        forward_fn=None, _quantize=quantize,
        serving_kwargs=dict(num_classes=1, depth=len(FILTERS), compute_dtype=jnp.float32)
        if quantize else None)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return seeded_model(tmp_path_factory.mktemp("stream"), 0)


def _frames(seed, hw, n=2):
    return (np.random.RandomState(seed).rand(n, *hw, 3) * 255).astype(np.uint8)


def _hold_masks(masks, probs, threshold=0.5, tol=PROB_TOL):
    """Masks equal to ``probs > threshold`` except within ``tol`` of it."""
    assert masks.dtype == np.uint8 and masks.shape == probs.shape
    near = np.abs(probs - threshold) <= tol
    np.testing.assert_array_equal(masks[~near], (probs > threshold)[~near])


@pytest.mark.parametrize("frame_hw,channel_order", [((96, 96), "bgr"), ((96, 96), "rgb"),
                                                    ((72, 120), "bgr"), ((72, 120), "rgb")])
def test_stream_matches_jax(checkpoints, frame_hw, channel_order):
    """Probabilities within 1e-4 of the JAX stream's, masks equal except
    within 1e-4 of the threshold; the kernel graph launches nothing here."""
    ckpt, variables = checkpoints
    frames = _frames(10 + frame_hw[1], frame_hw)
    jstream = JaxStreamingPredictor(jax_predictor(variables), frame_hw, batch_size=2,
                                    threshold=None, channel_order=channel_order)
    want = np.asarray(jstream(frames))
    pred = Predictor(ckpt, image_size=(HW, HW), use_pallas=True, device="cpu")
    tfs.reset_launch_counts()
    probs = StreamingPredictor(pred, frame_hw, batch_size=2, threshold=None,
                               channel_order=channel_order)(frames)
    masks = StreamingPredictor(pred, frame_hw, batch_size=2, threshold=0.5,
                               channel_order=channel_order)(frames)
    assert sum(tfs.LAUNCHES.values()) == 0
    assert probs.dtype == np.float32 and probs.shape == want.shape == (2, *frame_hw)
    np.testing.assert_allclose(probs, want, atol=PROB_TOL)
    _hold_masks(masks, want)


def test_stream_module_path_and_shape_guard(checkpoints):
    """The module-path Predictor streams the same answer; a frame of another
    size or another batch is refused."""
    ckpt, _ = checkpoints
    frames = _frames(20, (72, 120))
    on = StreamingPredictor(Predictor(ckpt, image_size=(HW, HW), use_pallas=True, device="cpu"),
                            (72, 120), batch_size=2, threshold=None)
    off = StreamingPredictor(Predictor(ckpt, image_size=(HW, HW), device="cpu"), (72, 120),
                             batch_size=2, threshold=None)
    np.testing.assert_allclose(on(frames), off(frames), atol=PROB_TOL)
    with pytest.raises(ValueError, match="stream shape"):
        on(_frames(21, (64, 64)))
    with pytest.raises(ValueError, match="stream shape"):
        on(_frames(22, (72, 120), n=3))
    dev = on.run_device(torch.from_numpy(frames))
    assert isinstance(dev, torch.Tensor) and tuple(dev.shape) == (2, 72, 120)


def test_int8_stream_matches_jax(checkpoints):
    """A pending int8 graph calibrates on the first batch's resized input:
    the scales equal JAX's, the probabilities within 5e-3 of JAX's int8
    stream, the masks >= 99.9% equal (the int8 graphs' bars of
    tests/test_torch_quant_serving.py)."""
    ckpt, variables = checkpoints
    frames = _frames(30, (96, 96))
    jstream = JaxStreamingPredictor(jax_predictor(variables, "int8"), (96, 96), batch_size=2,
                                    threshold=None)
    want = np.asarray(jstream(frames))
    pred = Predictor(ckpt, image_size=(HW, HW), use_pallas=True, quantize="int8", device="cpu")
    stream = StreamingPredictor(pred, (96, 96), batch_size=2, threshold=None)
    assert stream._quant_pending and pred.forward_fn is None
    got = stream(frames)
    assert not stream._quant_pending
    assert stream.quant_scales == {k: float(v) for k, v in jstream.quant_scales.items()}
    assert got.shape == want.shape and np.abs(got - want).max() <= 5e-3
    assert ((got > 0.5) == (want > 0.5)).mean() >= 0.999
    np.testing.assert_array_equal(stream(frames), got)   # built once, reused
