"""The port's decoder feed (K6) against the JAX package's ``fused_upconcat``.

On the CPU the port's wrappers run their kernels' plain versions inside the
same autograd Function the card runs; the JAX kernel runs in interpret
mode, as its own tests run it. The JAX kernel takes the skip and emits the
concat packed at p = 2, ``(B, 2H, W, 2F)`` and ``(B, 2H, W, 4F)``: plain
reshapes of the port's NHWC ``(B, 2H, 2W, F)`` and ``(B, 2H, 2W, 2F)``.
Inputs come from ``np.random.RandomState``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.ops.pallas import fused_upconcat as jfu
from unet_image_segmentation_tpu_torch.ops import conv as conv_ops
from unet_image_segmentation_tpu_torch.ops import fused_upconcat as tfu

B, H, W, C, F = 1, 8, 8, 128, 64   # a shape the JAX kernel takes


def _inputs(seed, b=B, h=H, w=W, c=C, f=F):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, w, c).astype(np.float32),
            (rng.randn(2, 2, f, c) * 0.2).astype(np.float32),
            (rng.randn(f) * 0.1).astype(np.float32),
            rng.rand(b, 2 * h, 2 * w, f).astype(np.float32))


def _jax(x, k, bias, skip, dtype):
    """JAX fused_upconcat: (cat, grads of sum(cat * sin(cat)) in x, k, bias, skip)."""
    b, h2, w2, f = skip.shape

    def loss(x, k, bias, skip):
        cat = jfu.fused_upconcat(x, k, bias, skip.reshape(b, h2, w2 // 2, 2 * f), 2)
        assert cat is not None, "the JAX kernel should take this shape"
        cat = cat.reshape(b, h2, w2, 2 * f).astype(jnp.float32)
        return jnp.sum(cat * jnp.sin(cat)), cat

    args = (jnp.asarray(x, dtype), jnp.asarray(k), jnp.asarray(bias), jnp.asarray(skip, dtype))
    (_, cat), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    return np.asarray(cat), [np.asarray(g, np.float32) for g in grads]


def _port(x, k, bias, skip, dtype):
    args = [torch.from_numpy(x).to(dtype), torch.from_numpy(k), torch.from_numpy(bias),
            torch.from_numpy(skip).to(dtype)]
    for t in args:
        t.requires_grad_()
    cat = tfu.fused_upconcat(*args)
    assert cat.dtype == dtype and cat.shape == skip.shape[:3] + (2 * skip.shape[3],)
    catf = cat.float()
    (catf * torch.sin(catf)).sum().backward()
    return catf.detach().numpy(), [t.grad.float().numpy() for t in args]


def test_upconcat_matches_jax_fp32():
    x, k, bias, skip = _inputs(0)
    tfu.reset_launch_counts()
    cat_t, grads_t = _port(x, k, bias, skip, torch.float32)
    assert sum(tfu.LAUNCHES.values()) == 0  # the CPU runs the plain K6
    cat_j, grads_j = _jax(x, k, bias, skip, jnp.float32)
    np.testing.assert_allclose(cat_t, cat_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cat_t[..., F:], skip)
    for name, a, b in zip(("x", "kernel", "bias", "skip"), grads_t, grads_j):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


def test_upconcat_matches_jax_bf16():
    """bf16 in and out: the two packages round at the same points (fp32
    sums, the bias added in fp32, one rounding), so they agree within bf16
    noise; the weight and bias gradients are fp32 sums of bf16 products."""
    x, k, bias, skip = _inputs(1)
    cat_t, grads_t = _port(x, k, bias, skip, torch.bfloat16)
    cat_j, grads_j = _jax(x, k, bias, skip, jnp.bfloat16)
    np.testing.assert_allclose(cat_t, cat_j, rtol=2e-2, atol=2e-2)
    for name, a, b in zip(("x", "kernel", "bias", "skip"), grads_t, grads_j):
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel <= 2e-2, (name, rel)


@pytest.mark.parametrize("shape", [(2, 4, 6, 16, 8), (1, 3, 5, 12, 4)])
def test_upconcat_backward_is_autograd_of_composed_feed(shape):
    """Any width (the port has no lane constraint): the plain forward is
    the composed ``conv_transpose_2x2`` + concat in fp32, and the
    hand-written backward equals autograd through it."""
    x, k, bias, skip = _inputs(2, *shape)
    tx, tk, tb, ts = (torch.from_numpy(a).requires_grad_() for a in (x, k, bias, skip))
    cat = tfu.fused_upconcat(tx, tk, tb, ts)
    ref = torch.cat([conv_ops.conv_transpose_2x2(tx, tk, tb), ts], dim=-1)
    np.testing.assert_allclose(cat.detach().numpy(), ref.detach().numpy(), rtol=1e-6, atol=1e-6)
    g = torch.from_numpy(np.random.RandomState(3).randn(*cat.shape).astype(np.float32))
    got = torch.autograd.grad(cat, (tx, tk, tb, ts), g)
    want = torch.autograd.grad(ref, (tx, tk, tb, ts), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_upconcat_bias_rounds_once_in_bf16():
    """The bias is added in fp32 before the one rounding to bf16 (the Pallas
    kernel's rounding), not to the rounded product."""
    x = torch.tensor([1.0, 2.0 ** -8], dtype=torch.bfloat16).reshape(1, 1, 1, 2)
    k = torch.ones(2, 2, 1, 2)
    bias = torch.tensor([2.0 ** -9])
    cat = tfu.upconcat(x, k, bias, torch.zeros(1, 2, 2, 1, dtype=torch.bfloat16))
    # one rounding: 1 + 2^-8 + 2^-9 is nearer 1 + 2^-7 than 1
    assert torch.equal(cat[..., 0].float(), torch.full((1, 2, 2), 1.0 + 2.0 ** -7))
    # the composed feed rounds the product 1 + 2^-8 (a tie) to 1 first
    composed = conv_ops.conv_transpose_2x2(x, k, bias)
    assert torch.equal(composed[..., 0].float(), torch.ones(1, 2, 2))
