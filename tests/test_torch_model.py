"""Port UNet eval forward and serving graph against the JAX package.

Weights are drawn with numpy (glorot-uniform kernels, random BN and bias
terms) in the shapes both packages share; BatchNorm statistics are then
recalibrated on the input, so activations keep a realistic scale and
outputs are not a constant 0.5, and the same tree goes to JAX through the
bridge.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.config import ModelConfig
from unet_image_segmentation_tpu_torch.config import ModelConfig as TorchModelConfig
from unet_image_segmentation_tpu.models.unet import build_unet as build_unet_jax
from unet_image_segmentation_tpu.serving import build_serving_forward_chained
from unet_image_segmentation_tpu_torch.models.unet import build_unet, recalibrate_batch_norm
from unet_image_segmentation_tpu_torch.ops import fused_sepconv as tfs
from unet_image_segmentation_tpu_torch.serving import build_serving_forward
from unet_image_segmentation_tpu_torch.weights import flax_from_state_dict, state_dict_from_flax

FWD_TOL = dict(rtol=0, atol=2e-5)         # the test_tf_parity.py bar
SERVE_TOL = dict(rtol=1e-3, atol=2e-4)    # the test_serving.py bar


def numpy_weights(model, seed):
    """A state_dict for ``model`` drawn from ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, value in model.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("kernel"):
            receptive = math.prod(shape[:-2])
            lim = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * receptive))
            arr = rng.uniform(-lim, lim, shape)
        elif key.endswith(("bn.scale", "bn.var")):
            arr = rng.uniform(0.5, 1.5, shape)
        else:  # conv and BN biases, BN means
            arr = 0.1 * rng.standard_normal(shape)
        sd[key] = torch.from_numpy(arr.astype(np.float32))
    return sd


def _setup(hw, seed=0, **kw):
    """(cfg, JAX model, flax variables, port model, input) with shared weights."""
    cfg = ModelConfig(image_height=hw, image_width=hw, dropout_rate=0.0, **kw)
    jmodel = build_unet_jax(cfg)
    tcfg = TorchModelConfig(image_height=hw, image_width=hw, dropout_rate=0.0, **kw)
    tmodel = build_unet(tcfg, device="cpu")
    tmodel.load_state_dict(numpy_weights(tmodel, seed))
    x = np.random.RandomState(seed + 7).rand(2, hw, hw, 3).astype(np.float32)
    if cfg.use_batch_norm:
        recalibrate_batch_norm(tmodel, torch.from_numpy(x))
    variables = jax.tree_util.tree_map(jnp.asarray, flax_from_state_dict(tmodel.state_dict()))
    return cfg, jmodel, variables, tmodel, x


def _jax_forward(jmodel, variables, x):
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    return np.asarray(apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize(
    "hw,kw",
    [
        (32, dict(filters=(8, 16))),
        (32, dict(filters=(8, 16), num_classes=3)),
        (32, dict(filters=(8, 16), conv_type="full")),
        (32, dict(filters=(8, 16), use_batch_norm=False)),
        (32, dict()),  # the full 64..512 ladder, bottleneck 1024
    ],
)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_unet_eval_matches_flax(hw, kw, use_pallas):
    """Composed path, and the use_pallas path (plain K8 on the CPU)."""
    cfg, jmodel, variables, tmodel, x = _setup(hw, **kw)
    for block in tmodel.modules():
        if hasattr(block, "use_pallas"):
            block.use_pallas = use_pallas
    want = _jax_forward(jmodel, variables, x)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, hw, hw, cfg.num_classes)
    if cfg.use_batch_norm:
        assert want.std() > 1e-2  # recalibrated: not a constant map
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("filters,num_classes", [((8, 16), 1), ((8, 16), 3)])
def test_serving_matches_jax_chained(filters, num_classes):
    cfg, _, variables, _, x = _setup(32, filters=filters, num_classes=num_classes)
    want = np.asarray(
        build_serving_forward_chained(
            variables, num_classes=num_classes, depth=len(filters), compute_dtype=jnp.float32
        )(jnp.asarray(x))
    )
    tfs.reset_launch_counts()
    forward = build_serving_forward(
        flax_from_state_dict(state_dict_from_flax(variables)), num_classes=num_classes,
        depth=len(filters), compute_dtype=torch.float32, device="cpu",
    )
    got = forward(torch.from_numpy(x)).numpy()
    assert tfs.LAUNCHES["sepconv_pair"] == 0  # the CPU runs the plain K7
    np.testing.assert_allclose(got, want, **SERVE_TOL)


def test_serving_full_ladder_matches_module_path():
    cfg, jmodel, variables, tmodel, x = _setup(32, seed=1)
    forward = build_serving_forward(
        flax_from_state_dict(tmodel.state_dict()), compute_dtype=torch.float32, device="cpu"
    )
    got = forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax_forward(jmodel, variables, x), **SERVE_TOL)


def test_serving_bf16_matches_jax_chained_bf16():
    """bf16 on both sides, same rounding points (depthwise sum, y1, block
    output). Sums run in different orders, so a bf16 value may round the
    other way: probabilities agree to 2e-2, masks on >= 99% of pixels."""
    cfg, _, variables, _, x = _setup(32, seed=2, filters=(8, 16))
    want = np.asarray(
        build_serving_forward_chained(variables, depth=2, compute_dtype=jnp.bfloat16)(
            jnp.asarray(x)
        )
    )
    forward = build_serving_forward(
        flax_from_state_dict(state_dict_from_flax(variables)), depth=2,
        compute_dtype=torch.bfloat16, device="cpu",
    )
    got = forward(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert ((got > 0.5) == (want > 0.5)).mean() >= 0.99


def test_serving_rejects_full_conv_model():
    cfg, _, variables, _, _ = _setup(16, filters=(8, 16), conv_type="full")
    with pytest.raises(ValueError, match="separable"):
        build_serving_forward(flax_from_state_dict(state_dict_from_flax(variables)),
                              depth=2, device="cpu")
