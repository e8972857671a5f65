"""The port's int8 serving against the JAX package's.

K7's int8 I/O mode (its plain version on the CPU), the calibration, the
int8 graph and ``Predictor(quantize='int8')`` against the JAX package's
``serving_quant`` and ``fused_sepconv_pair`` (Pallas in interpret mode, as
its own tests run it), and the MeanIoU metrics against JAX's. fp32, 32 px,
filters (16, 32), batch 2; the same numpy weights and inputs on both sides.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu import serving_quant as jsq
from unet_image_segmentation_tpu.ops import metrics as jmetrics
from unet_image_segmentation_tpu.ops.pallas import fused_sepconv as jfs
from unet_image_segmentation_tpu_torch import serving_quant as sq
from unet_image_segmentation_tpu_torch.config import ModelConfig
from unet_image_segmentation_tpu_torch.inference import Predictor
from unet_image_segmentation_tpu_torch.models.unet import build_unet, recalibrate_batch_norm
from unet_image_segmentation_tpu_torch.ops import fused_sepconv as tfs
from unet_image_segmentation_tpu_torch.ops import metrics
from unet_image_segmentation_tpu_torch.train.checkpoint import save_inference_variables
from unet_image_segmentation_tpu_torch.weights import flax_from_state_dict

HW = 32
FILTERS = (16, 32)
S_X, S_X2 = 2.0 ** -7, 2.0 ** -6


def _block(rng, c, f, bn):
    blk = {
        "depthwise_kernel": rng.randn(3, 3, c, 1).astype(np.float32) * 0.3,
        "pointwise_kernel": rng.randn(1, 1, c, f).astype(np.float32) * 0.3,
    }
    if bn:
        blk.update(
            scale=rng.rand(f).astype(np.float32) + 0.5,
            offset=rng.randn(f).astype(np.float32) * 0.1,
            mean=rng.randn(f).astype(np.float32) * 0.1,
            var=rng.rand(f).astype(np.float32) + 0.5,
        )
    else:
        blk["bias"] = rng.randn(f).astype(np.float32) * 0.1
    return blk


def _torch(blk):
    return {k: torch.from_numpy(v) for k, v in blk.items()}


def _jax(blk):
    return {k: jnp.asarray(v) for k, v in blk.items()}


def _pair_inputs(rng, mode, bn, f=16, h=16):
    """(q, q2 or None, block1, block2, in_scale): int8 x in [-127, 127] (the
    decoder's upsample stream) or [0, 127], x2 in [0, 127]."""
    two = mode == "x2"
    c = 2 * f if two else f
    q = rng.randint(-127 if two else 0, 128, size=(2, h, h, f)).astype(np.int8)
    q2 = rng.randint(0, 128, size=(2, h, h, f)).astype(np.int8) if two else None
    return q, q2, _block(rng, c, f, bn), _block(rng, f, f, bn), (S_X, S_X2) if two else S_X


def _float_pair(q, q2, b1, b2, in_scale, pool):
    s = in_scale if q2 is not None else (in_scale, None)
    x = sq.dequantize(torch.from_numpy(q), s[0], torch.float32)
    x2 = sq.dequantize(torch.from_numpy(q2), s[1], torch.float32) if q2 is not None else None
    return tfs.fused_sepconv_pair(x, _torch(b1), _torch(b2), pool=pool, x2=x2)


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "bias"])
@pytest.mark.parametrize("mode", ["pool", "x2"])
def test_plain_int8_pair_is_the_quantized_float_pair(mode, bn):
    """With pow2 scales and fp32 compute, the plain int8 pair equals
    quantizing the plain float pair's output on the dequantized input, bit
    for bit (pool on; two streams with two scales, folded per channel)."""
    rng = np.random.RandomState(11)
    q, q2, b1, b2, in_scale = _pair_inputs(rng, mode, bn)
    pool = mode == "pool"
    yf = _float_pair(q, q2, b1, b2, in_scale, pool)
    s_out = sq.pow2_scale(float((yf[0] if pool else yf).max()))
    yq = tfs.fused_sepconv_pair(
        torch.from_numpy(q), _torch(b1), _torch(b2), pool=pool,
        x2=torch.from_numpy(q2) if q2 is not None else None,
        in_scale=in_scale, out_scale=s_out, compute_dtype=torch.float32)
    for got, want in zip(yq if pool else (yq,), yf if pool else (yf,)):
        assert got.dtype == torch.int8
        assert torch.equal(got, sq.quantize(want, s_out))
        assert 0 < int(got.max()) <= 127 and int(got.min()) >= 0


@pytest.mark.parametrize("mode", ["pool", "x2"])
def test_plain_int8_pair_matches_the_jax_kernel(mode):
    """The port's plain int8 pair against the JAX int8 pair kernel: no
    element more than 1 quantum apart, >= 99.9% equal (the two sum in other
    orders, and a sum within an ulp of a half quantum rounds either way)."""
    rng = np.random.RandomState(12)
    q, q2, b1, b2, in_scale = _pair_inputs(rng, mode, bn=True)
    pool = mode == "pool"
    yf = _float_pair(q, q2, b1, b2, in_scale, pool)
    s_out = sq.pow2_scale(float((yf[0] if pool else yf).max()))
    got = tfs.fused_sepconv_pair(
        torch.from_numpy(q), _torch(b1), _torch(b2), pool=pool,
        x2=torch.from_numpy(q2) if q2 is not None else None,
        in_scale=in_scale, out_scale=s_out, compute_dtype=torch.float32)
    b, h, w, f = q.shape
    kw = dict(in_scale=in_scale, out_scale=s_out, compute_dtype=jnp.float32)
    if pool:
        y, _, pooled = jfs.fused_sepconv_pair(jnp.asarray(q), _jax(b1), _jax(b2), pool=True, **kw)
        want = (np.asarray(y).reshape(b, h, w, f),
                np.asarray(pooled).reshape(b, h // 2, w // 2, f))
    else:
        p = jfs.pair_pack(2 * f, f, f, w)
        packed = (b, h, w // p, p * f)
        y = jfs.fused_sepconv_pair(jnp.asarray(q.reshape(packed)), _jax(b1), _jax(b2),
                                   in_packed=p, x2=jnp.asarray(q2.reshape(packed)), **kw)
        got, want = (got,), (np.asarray(y).reshape(b, h, w, f),)
    for g, wnt in zip(got, want):
        assert wnt.dtype == np.int8
        diff = np.abs(g.numpy().astype(np.int32) - wnt.astype(np.int32))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.999


@pytest.fixture(scope="module", params=[1, 3], ids=["binary", "3class"])
def model(request, tmp_path_factory):
    """(Flax-layout numpy tree, port checkpoint dir, classes) of one seeded
    U-Net with BatchNorm recalibrated on a numpy scene."""
    nc = request.param
    cfg = ModelConfig(image_height=HW, image_width=HW, filters=FILTERS, num_classes=nc)
    net = build_unet(cfg, device="cpu")
    rng = np.random.RandomState(20 + nc)
    sd = {}
    for key, value in net.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("kernel"):
            lim = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * math.prod(shape[:-2])))
            sd[key] = torch.from_numpy(rng.uniform(-lim, lim, shape).astype(np.float32))
        else:
            sd[key] = value
    net.load_state_dict(sd)
    recalibrate_batch_norm(net, torch.from_numpy(rng.rand(4, HW, HW, 3).astype(np.float32)))
    ckpt = str(tmp_path_factory.mktemp(f"quant{nc}") / "ckpt")
    save_inference_variables(ckpt, net.state_dict(), {"num_classes": nc, "filters": list(FILTERS)})
    return flax_from_state_dict(net.state_dict()), ckpt, nc


def _images(seed, n=2):
    return np.random.RandomState(seed).rand(n, HW, HW, 3).astype(np.float32)


def _jax_tree(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def test_calibration_scales_equal_jax(model):
    variables, _, nc = model
    x = _images(30)
    kw = dict(num_classes=nc, depth=len(FILTERS))
    mine = sq.calibrate_chained(variables, torch.from_numpy(x), compute_dtype=torch.float32, **kw)
    theirs = jsq.calibrate_chained(_jax_tree(variables), jnp.asarray(x),
                                   compute_dtype=jnp.float32, **kw)
    assert mine == {k: float(v) for k, v in theirs.items()}
    assert set(mine) == {"input", "enc1", "enc2", "bneck", "dec2_up", "dec2", "dec1_up", "dec1"}
    assert all(math.log2(s).is_integer() for s in mine.values())


def test_int8_graph_matches_jax(model):
    """The whole int8 graph (plain K7 int8 on the CPU) against JAX's on the
    same scales: probabilities within 5e-3, masks >= 99.9% equal, softmax
    rows summing to 1."""
    variables, _, nc = model
    x = _images(31)
    kw = dict(num_classes=nc, depth=len(FILTERS))
    scales = sq.calibrate_chained(variables, torch.from_numpy(x), compute_dtype=torch.float32,
                                  **kw)
    tfs.reset_launch_counts()
    got = sq.build_serving_forward_quant(variables, scales, compute_dtype=torch.float32,
                                         device="cpu", **kw)(torch.from_numpy(x)).numpy()
    assert sum(tfs.LAUNCHES.values()) == 0   # the CPU runs the plain K7 int8
    want = np.asarray(jsq.build_serving_forward_quant(
        _jax_tree(variables), scales, compute_dtype=jnp.float32, **kw)(jnp.asarray(x)))
    assert got.shape == want.shape == (2, HW, HW, nc)
    assert np.abs(got - want).max() <= 5e-3
    if nc == 1:
        assert ((got > 0.5) == (want > 0.5)).mean() >= 0.999
    else:
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-3)


def test_predictor_calibrates_on_the_first_bucketed_batch(model, monkeypatch):
    """The first predict batch, padded to its bucket, is the calibration
    sample; the graph is built once and later batches reuse it."""
    variables, ckpt, nc = model
    pred = Predictor(ckpt, image_size=(HW, HW), use_pallas=True, quantize="int8", device="cpu")
    assert pred.quant_scales is None
    assert pred.serving_kwargs == dict(num_classes=nc, depth=2, compute_dtype=torch.float32)
    x = _images(32, n=3)
    out = pred.predict(x)
    padded = torch.from_numpy(np.concatenate([x, np.zeros_like(x[:1])]))
    scales = sq.calibrate_chained(variables, padded, **pred.serving_kwargs)
    assert pred.quant_scales == scales
    want = sq.build_serving_forward_quant(variables, scales, **pred.serving_kwargs,
                                          device="cpu")(padded)[:3].numpy()
    np.testing.assert_array_equal(out, want)
    forward = pred._forward
    monkeypatch.setattr(sq, "calibrate_chained", None)   # no second calibration
    again = pred.predict(x[:2])
    assert pred._forward is forward and pred.quant_scales == scales
    np.testing.assert_array_equal(again, out[:2])


def test_predictor_int8_refuses_the_module_path(model):
    _, ckpt, _ = model
    with pytest.raises(ValueError, match="use_pallas"):
        Predictor(ckpt, image_size=(HW, HW), quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="unsupported quantize"):
        Predictor(ckpt, image_size=(HW, HW), use_pallas=True, quantize="int4", device="cpu")


def test_quantize_and_pow2_scale_match_jax():
    x = np.random.RandomState(40).randn(4, 7, 5).astype(np.float32) * 3
    x[0, 0, :3] = [0.5 * 2.0 ** -4, 1.5 * 2.0 ** -4, -2.5 * 2.0 ** -4]   # ties: half to even
    for s in (2.0 ** -4, 2.0 ** -7):
        np.testing.assert_array_equal(sq.quantize(torch.from_numpy(x), s).numpy(),
                                      np.asarray(jsq.quantize(jnp.asarray(x), s)))
        np.testing.assert_array_equal(
            sq.dequantize(sq.quantize(torch.from_numpy(x), s), s, torch.float32).numpy(),
            np.asarray(jsq.dequantize(jsq.quantize(jnp.asarray(x), s), s, jnp.float32)))
    for m in (0.0, -1.0, float("inf"), float("nan"), 1e-9, 1.0, 127.0, 127.5, 3e4):
        assert sq.pow2_scale(m) == jsq.pow2_scale(m)


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_iou_metrics_equal_jax(threshold):
    """sample_iou (batched and 2-D) and the MeanIoU state over two batches,
    against the JAX package's, exactly."""
    rng = np.random.RandomState(41)
    batches = [(rng.rand(3, 9, 11, 1) > 0.6, rng.rand(3, 9, 11, 1)) for _ in range(2)]
    state, jstate = metrics.mean_iou_init(2), jmetrics.mean_iou_init(2)
    for truth, prob in batches:
        t, p = truth.astype(np.float32), prob.astype(np.float32)
        pred = (p > 0.5).astype(np.float32)
        np.testing.assert_array_equal(
            metrics.sample_iou(torch.from_numpy(t), torch.from_numpy(pred)).numpy(),
            np.asarray(jmetrics.sample_iou(jnp.asarray(t), jnp.asarray(pred))))
        assert float(metrics.sample_iou(torch.from_numpy(t[0, ..., 0]),
                                        torch.from_numpy(pred[0, ..., 0]))) == float(
            jmetrics.sample_iou(jnp.asarray(t[0, ..., 0]), jnp.asarray(pred[0, ..., 0])))
        state = metrics.mean_iou_update(state, torch.from_numpy(t), torch.from_numpy(p),
                                        threshold)
        jstate = jmetrics.mean_iou_update(jstate, jnp.asarray(t), jnp.asarray(p), threshold)
    np.testing.assert_array_equal(state.cm.numpy(), np.asarray(jstate.cm))
    assert float(metrics.mean_iou_result(state)) == float(jmetrics.mean_iou_result(jstate))
