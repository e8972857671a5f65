"""Port ops/conv.py against the JAX package's ops/conv.py, fp32, <= 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.ops import conv as jops
from unet_image_segmentation_tpu_torch.ops import conv as tops

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cases(rng):
    x = _rand(rng, 2, 8, 12, 6)
    x2 = _rand(rng, 2, 8, 12, 5)
    dw = _rand(rng, 3, 3, 6, 1)
    dw_pair = _rand(rng, 3, 3, 11, 1)
    pw = _rand(rng, 1, 1, 6, 7)
    pw_pair = _rand(rng, 1, 1, 11, 7)
    bias = _rand(rng, 7)
    full = _rand(rng, 3, 3, 6, 7)
    up = _rand(rng, 2, 2, 4, 6)
    up_b = _rand(rng, 4)
    stats = [_rand(rng, 6), np.abs(_rand(rng, 6)) + 0.1, _rand(rng, 6), _rand(rng, 6)]
    return {
        "depthwise_same": ("depthwise_conv2d", (x, dw), {}),
        "depthwise_valid": ("depthwise_conv2d", (x, dw), {"padding": "VALID"}),
        "pointwise_4d": ("pointwise_conv2d", (x, pw, bias), {}),
        "pointwise_2d": ("pointwise_conv2d", (x, pw[0, 0]), {}),
        "separable": ("separable_conv2d", (x, dw, pw, bias), {}),
        "separable_pair": ("separable_conv2d_pair", (x, x2, dw_pair, pw_pair, bias), {}),
        "conv2d": ("conv2d", (x, full, bias), {}),
        "conv_transpose_2x2": ("conv_transpose_2x2", (x, up, up_b), {}),
        "max_pool_2x2": ("max_pool_2x2", (x,), {}),
        "batch_norm_inference": ("batch_norm_inference", (x, *stats), {}),
    }


CASE_NAMES = list(_cases(np.random.RandomState(0)).keys())


@pytest.mark.parametrize("case", CASE_NAMES)
def test_op_matches_jax(case):
    name, args, kwargs = _cases(np.random.RandomState(7))[case]
    want = np.asarray(getattr(jops, name)(*map(jnp.asarray, args), **kwargs))
    got = getattr(tops, name)(*map(torch.from_numpy, args), **kwargs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_conv_transpose_column_order():
    """One tap per output pixel: out[2h+i, 2w+j, f] = sum_c x[h,w,c] K[i,j,f,c]."""
    rng = np.random.RandomState(1)
    x, k = _rand(rng, 1, 2, 3, 4), _rand(rng, 2, 2, 5, 4)
    y = tops.conv_transpose_2x2(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    want = np.einsum("hwc,ijfc->hiwjf", x[0], k).reshape(4, 6, 5)
    np.testing.assert_allclose(y[0], want, **TOL)


def test_bad_inputs_raise():
    x = torch.zeros(1, 3, 4, 2)
    with pytest.raises(ValueError):
        tops.max_pool_2x2(x)
    with pytest.raises(ValueError):
        tops.depthwise_conv2d(x, torch.zeros(3, 3, 2, 2))
    with pytest.raises(ValueError):
        tops.conv_transpose_2x2(x, torch.zeros(2, 2, 3, 5))
