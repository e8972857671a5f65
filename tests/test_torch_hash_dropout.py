"""The port's position-hash dropout against the JAX package's, bit for bit.

The keep mask is a pure function of logical NHWC coordinates and a seed,
so the two packages must produce identical masks, values and gradients
for any shape, rate and int32 seed (negative seeds included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.ops import hash_dropout as jhd
from unet_image_segmentation_tpu_torch.ops import hash_dropout as thd

CASES = [
    ((2, 16, 16, 8), 0.2, 12345),
    ((2, 16, 16, 8), 0.2, -12345),
    ((1, 8, 24, 3), 0.5, -(2**31)),
    ((3, 4, 4, 32), 0.1, 2**31 - 1),
    ((2, 32, 32, 16), 0.7, 0),
]


@pytest.mark.parametrize("shape,rate,seed", CASES)
def test_keep_mask_bit_identical(shape, rate, seed):
    thresh = jhd.keep_threshold(rate)
    assert thd.keep_threshold(rate) == thresh
    want = np.asarray(jhd.array_keep_mask(shape, 1, shape[-1], jnp.int32(seed), thresh))
    got = thd.keep_mask(shape, seed, thresh).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 < got.mean() < 1.0


def test_mix_hash_wraps_like_int32():
    """Indices past 2^31 wrap to negative int32, and every product wraps;
    the hashes agree bit for bit over the int32 range's edges."""
    idx = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1, 123456789],
                   np.int64).astype(np.uint32).view(np.int32)
    for seed in (0, -1, 987654321, -(2**31), 2**32 + 7):
        jseed = jnp.int32(np.int64(seed).astype(np.int32))
        want = np.asarray(jhd.mix_hash(jnp.asarray(idx), jseed))
        got = thd.mix_hash(torch.from_numpy(idx), seed).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rate,seed", CASES[:3])
def test_hash_dropout_values_and_gradient(shape, rate, seed, dtype):
    x = np.random.RandomState(0).standard_normal(shape).astype(np.float32)
    g = np.random.RandomState(1).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want, vjp = jax.vjp(lambda v: jhd.hash_dropout(v, jnp.int32(seed), rate), jx)
    (want_g,) = vjp(jnp.asarray(g, dtype))

    tdtype = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdtype).requires_grad_()
    got = thd.hash_dropout(tx, seed, rate)
    got.backward(torch.from_numpy(g).to(tdtype))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(tx.grad.float().numpy(), np.asarray(want_g.astype(jnp.float32)))


def test_zero_rate_is_identity():
    x = torch.randn(1, 4, 4, 2)
    assert thd.hash_dropout(x, 7, 0.0) is x
