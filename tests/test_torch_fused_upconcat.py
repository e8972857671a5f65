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

from unet_image_segmentation_tpu.ops import conv as jconv
from unet_image_segmentation_tpu.ops.pallas import fused_upconcat as jfu
from unet_image_segmentation_tpu_torch.ops import conv as conv_ops
from unet_image_segmentation_tpu_torch.ops import fused_upconcat as tfu
from unet_image_segmentation_tpu_torch.ops.fused_train import SMEM_MAX
from unet_image_segmentation_tpu_torch.troubleshoot import roofline

B, H, W, C, F = 1, 8, 8, 128, 64   # a shape the JAX kernel takes
# (B, H, W, C, F) off the lane-aligned widths the JAX kernel takes: odd and
# unequal sides, C and F off every tile and vector width of the port's
RAGGED = [(2, 9, 13, 48, 8), (3, 6, 10, 200, 40), (2, 5, 3, 96, 24)]


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


@pytest.mark.parametrize("shape", [(2, 4, 6, 16, 8), (1, 3, 5, 12, 4)] + RAGGED)
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


@pytest.mark.parametrize("shape", RAGGED)
def test_upconcat_matches_jax_composed_feed_at_ragged_widths(shape):
    """At widths the JAX kernel does not take, the JAX U-Net composes
    ``ops/conv.py:conv_transpose_2x2`` + concat; the port's feed (the plain
    K6 on the CPU) matches it, forward and backward, in fp32 (where the
    two bias conventions agree) within fp32 summation-order noise."""
    x, k, bias, skip = _inputs(4, *shape)
    g = np.random.RandomState(5).randn(*skip.shape[:3], 2 * skip.shape[3]).astype(np.float32)

    def composed(x, k, bias, skip):
        return jnp.concatenate([jconv.conv_transpose_2x2(x, k, bias), skip], axis=-1)

    cat_j, vjp = jax.vjp(composed, *(jnp.asarray(a) for a in (x, k, bias, skip)))
    grads_j = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, k, bias, skip)]
    cat_t = tfu.fused_upconcat(*args)
    grads_t = torch.autograd.grad(cat_t, args, torch.from_numpy(g))
    np.testing.assert_allclose(cat_t.detach().numpy(), np.asarray(cat_j), rtol=1e-5, atol=1e-5)
    for name, a, b in zip(("x", "kernel", "bias", "skip"), grads_t, grads_j):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


_PATH_FEEDS = [(32, h, h, c, f) for _, c, f, h in roofline.upconcat_shapes(256, (64, 128, 256, 512))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", _PATH_FEEDS + [(2, 8, 16, 48, 8)] + RAGGED)
def test_upconcat_plan_covers_the_feed(shape, dtype):
    """The forward and dx grids hold one CTA for every 128-pixel tile of x
    and 128-column tile of the GEMM (4F forward, C for dx), so every pixel
    and column once; the d_kernel grid covers (C, 4F) and its splits every
    pixel, in no more than whole waves of two CTAs an SM where the tiles
    allow; both layouts fit a CTA's 227 KB of shared memory."""
    b, h, w, c, f = shape
    plan = tfu.upconcat_plan(b, h, w, c, f, dtype, 132)
    p, tiles = b * h * w, -(-b * h * w // 128)
    assert tiles * 128 >= p > (tiles - 1) * 128
    for cols, col_tiles, grid in ((4 * f, plan.tiles_fwd, plan.grid_fwd),
                                  (c, plan.tiles_dx, plan.grid_dx)):
        assert col_tiles * 128 >= cols > (col_tiles - 1) * 128
        assert grid == (tiles * col_tiles,)
        # block -> (pixel tile, column tile), the column tiles of a pixel tile adjacent
        cover = {(blk // col_tiles, blk % col_tiles) for blk in range(grid[0])}
        assert cover == {(t, j) for t in range(tiles) for j in range(col_tiles)}
    assert plan.grid_dw == (-(-4 * f // 128), -(-c // 128), plan.splits)
    kd = 64 if dtype == torch.bfloat16 else 32
    assert plan.per % kd == 0 and (plan.splits - 1) * plan.per < p <= plan.splits * plan.per
    out_tiles = plan.grid_dw[0] * plan.grid_dw[1]
    assert plan.splits == 1 or out_tiles * plan.splits <= 2 * 132 + out_tiles
    assert max(plan.smem, plan.smem_dw) <= SMEM_MAX == 232448


def test_upconcat_plan_by_hand():
    """dec1 at batch 32 (x 128 px, C = 128, F = 64), bf16: 4096 pixel
    tiles by two column tiles forward, one for dx; 3 stages of A [128][72]
    and B [64][136] in bf16 and 128 pixel indices; d_kernel's two 128-column
    tiles over 131 splits of 4032 pixels (63 chunks of 64), 3 stages of x
    and dup [64][136], on a card of 132 SMs; on one of 114, 114 splits."""
    plan = tfu.upconcat_plan(32, 128, 128, 128, 64, torch.bfloat16, 132)
    assert (plan.tiles_fwd, plan.tiles_dx, plan.grid_fwd, plan.grid_dx) == (2, 1, (8192,), (4096,))
    assert plan.smem == 2 * (3 * 128 * 72 + 3 * 64 * 136) + 4 * 128 == 108032
    assert plan.smem_dw == 2 * 3 * 64 * 2 * 136 == 104448
    assert (plan.splits, plan.per, plan.grid_dw) == (131, 4032, (2, 1, 131))
    assert tfu.upconcat_plan(32, 128, 128, 128, 64, torch.bfloat16, 114)[3:5] == (114, 4608)
    # dec4 (C = 1024, F = 512), fp32: 16 and 8 column tiles; d_kernel's 128
    # tiles take 2 splits, one wave of 256 CTAs
    deep = tfu.upconcat_plan(32, 16, 16, 1024, 512, torch.float32, 132)
    assert (deep.tiles_fwd, deep.tiles_dx, deep.splits) == (16, 8, 2)
    assert deep.smem == 4 * (3 * 128 * 36 + 3 * 32 * 136) + 4 * 128 == 108032


def test_upconcat_plan_refuses_what_the_kernels_cannot_launch():
    with pytest.raises(ValueError, match="empty"):
        tfu.upconcat_plan(1, 0, 4, 8, 8, torch.float32, 132)
    with pytest.raises(TypeError, match="float16"):
        tfu.upconcat_plan(1, 4, 4, 8, 8, torch.float16, 132)
    with pytest.raises(ValueError, match="output pixels"):
        tfu.upconcat_plan(2 ** 13, 256, 256, 8, 8, torch.bfloat16, 132)


# K6's fp32 d_kernel in its split-K order and in JAX's tile order
# (troubleshoot/upconcat_digits.py), of max |plain d_kernel| at 2 x 32 x 32
# pixels (C = 24, 4F = 80): (ii), (iii) and JAX's order in 4 runs of 512
# pixels, (iv) serial over all 2048 (measured 3.9e-7 (the plain d_kernel's
# own distance from fp64), 3.0e-7, 7.1e-7, 1.0e-6, 3.0e-7)
UPCONCAT_ORDER_TOL = {"fp64": 1e-6, "fp32": 2e-6, "3xtf32": 2e-6, "fp32_one_split": 1e-5,
                      "jax_tiles": 2e-6}


def test_upconcat_digit_orders_match_the_plain_d_kernel():
    """(i)-(iv) and (vi) of ``upconcat_digits`` on the tool's seeded inputs
    (x a ReLU'd feed, so non-negative) equal the plain K6 backward's
    d_kernel within UPCONCAT_ORDER_TOL, on the split plan ``upconcat_plan``
    gives and on JAX's row tiles; ``d_kernel_fp64`` is the plain d_kernel
    in fp64."""
    from unet_image_segmentation_tpu_torch.troubleshoot import upconcat_digits as ud

    b, h, c, f = 2, 32, 24, 20
    d = ud.inputs(b, c, f, h)
    assert d["x"].min() == 0 and d["x"].max() > 0 and d["g"].shape == (b, 2 * h, 2 * h, 2 * f)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    want = tfu.upconcat_bwd_reference(t["x"], t["kernel"], t["g"])[1]
    want = want.permute(3, 0, 1, 2).reshape(c, 4 * f).double()
    exact = ud.d_kernel_fp64(t["x"], t["g"])
    assert exact.dtype == torch.float64 and exact.shape == (c, 4 * f)
    scale = want.abs().max().item()
    assert (exact - want).abs().max().item() <= 1e-6 * scale
    plan = tfu.upconcat_plan(b, h, h, c, f, torch.float32, 132)
    assert (plan.splits, plan.per) == (4, 512)
    rows = ud.jax_tile_rows(2 * h, h, c, f) // 2 * h
    assert rows == 512
    got = ud.orders(t["x"].reshape(-1, c).numpy(), ud.dup_of(t["g"], f).contiguous().numpy(),
                    plan.per, plan.splits, rows)
    assert set(got) == set(UPCONCAT_ORDER_TOL)
    for name, v in got.items():
        err = (torch.from_numpy(np.asarray(v)).double() - want).abs().max().item()
        assert err <= UPCONCAT_ORDER_TOL[name] * scale, (name, err)


@pytest.mark.parametrize("batch,per,splits", [(32, (4096, 4096, 4000, 4000), (2, 8, 33, 132)),
                                              (2, (512,) * 4, (1, 4, 16, 64))])
def test_upconcat_digits_take_the_kernels_split_plan(batch, per, splits):
    """The tool's emulations take ``upconcat_plan``'s fp32 d_kernel splits at
    the four 256 px feeds (dec4 -> dec1) on a card of 132 SMs: ~4000 pixels a
    split at batch 32, 512 at the gates' batch of 2."""
    from unet_image_segmentation_tpu_torch.troubleshoot import upconcat_digits as ud

    assert list(ud.FEEDS) == ["dec4", "dec3", "dec2", "dec1"]
    for name, p, s in zip(ud.FEEDS, per, splits):
        c, f, h = ud.FEEDS[name]
        plan = ud.plan(name, batch, 132)
        assert plan == tfu.upconcat_plan(batch, h, h, c, f, torch.float32, 132)
        assert (plan.per, plan.splits) == (p, s), name


@pytest.mark.parametrize("feed", ["dec4", "dec3", "dec2", "dec1"])
def test_upconcat_digits_take_the_jax_kernels_row_tile(feed):
    """The tool's copy of the JAX kernel's row-tile rule gives its tile at
    each 256 px feed (the JAX kernel takes the feed at p = 2)."""
    from unet_image_segmentation_tpu_torch.troubleshoot import upconcat_digits as ud

    c, f, h = ud.FEEDS[feed]
    x = jnp.zeros((2, h, h, c), jnp.float32)
    meta = jfu._supported(x, jnp.zeros((2, 2, f, c)), jnp.zeros((2, 2 * h, h, 2 * f)), 2)
    assert meta is not None and meta[0] == ud.jax_tile_rows(2 * h, h, c, f) == \
        jfu._pick_tile(2 * h, h, c, f, 2 * f)
