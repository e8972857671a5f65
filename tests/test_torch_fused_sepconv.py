"""Plain K8 / K7 of the port against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their kernels' plain versions, and the
JAX kernels run in Pallas interpret mode, as the JAX package's own tests
run them. fp32 throughout; both sides sum in fp32 in different orders, so
the bar is 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.ops import conv as jops
from unet_image_segmentation_tpu.ops.pallas import fused_sepconv as jfs
from unet_image_segmentation_tpu_torch.ops import fused_sepconv as tfs
from unet_image_segmentation_tpu_torch.ops.kernels import build

TOL = dict(rtol=1e-5, atol=1e-5)
HW = 16


def _block(rng, c, f, bn=True, bias=False):
    blk = {
        "depthwise_kernel": rng.uniform(-0.5, 0.5, (3, 3, c, 1)).astype(np.float32),
        "pointwise_kernel": rng.uniform(-0.5, 0.5, (1, 1, c, f)).astype(np.float32),
    }
    if bias:
        blk["bias"] = rng.standard_normal(f).astype(np.float32) * 0.1
    if bn:
        blk.update(
            scale=rng.uniform(0.5, 1.5, f).astype(np.float32),
            offset=(rng.standard_normal(f) * 0.1).astype(np.float32),
            mean=(rng.standard_normal(f) * 0.1).astype(np.float32),
            var=rng.uniform(0.5, 1.5, f).astype(np.float32),
        )
    return blk


def _jax(blk):
    return {k: jnp.asarray(v) for k, v in blk.items()}


def _torch(blk):
    return {k: torch.from_numpy(v) for k, v in blk.items()}


def _x(rng, c):
    return rng.standard_normal((2, HW, HW, c)).astype(np.float32)


@pytest.mark.parametrize(
    "c,f,bn,bias,relu",
    [
        (3, 8, True, False, True),     # the image input block
        (8, 16, True, False, True),
        (16, 16, True, True, True),    # BN and conv bias folded together
        (16, 8, False, True, True),    # no-BN block: bias only
        (8, 16, True, False, False),   # affine without ReLU
    ],
)
def test_block_plain_matches_jax(c, f, bn, bias, relu):
    rng = np.random.RandomState(c * 100 + f)
    x, blk = _x(rng, c), _block(rng, c, f, bn, bias)
    names = dict(bias="bias", scale="bn_scale", offset="bn_offset", mean="bn_mean", var="bn_var")
    j = _jax(blk)
    want = jfs.fused_sepconv_bn_relu(
        jnp.asarray(x), j["depthwise_kernel"], j["pointwise_kernel"], relu=relu,
        **{names[k]: v for k, v in j.items() if k in names},
    )
    t = _torch(blk)
    got = tfs.fused_sepconv_bn_relu(
        torch.from_numpy(x), t["depthwise_kernel"], t["pointwise_kernel"], relu=relu,
        **{names[k]: v for k, v in t.items() if k in names},
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "c,f1,f2,mode",
    [
        (3, 8, 8, "pool"),      # encoder stage 1: 3-channel input, fused pool
        (8, 16, 16, "pool"),
        (16, 16, 8, "plain"),   # bottleneck-like, no pool
        (8, 8, 8, "x2"),        # decoder stage: [x | x2] two-stream input
        (16, 16, 16, "x2"),
    ],
)
def test_pair_plain_matches_jax(c, f1, f2, mode):
    """For x2 JAX gets the concat; for the pool JAX's version is
    max_pool_2x2 of the pair output."""
    rng = np.random.RandomState(c * 1000 + f1 * 10 + f2)
    cin = 2 * c if mode == "x2" else c
    b1, b2 = _block(rng, cin, f1), _block(rng, f1, f2)
    x = _x(rng, c)
    x2 = _x(rng, c) if mode == "x2" else None
    xin = np.concatenate([x, x2], axis=-1) if mode == "x2" else x
    want = jfs.fused_sepconv_pair(jnp.asarray(xin), _jax(b1), _jax(b2))
    assert want is not None
    got = tfs.fused_sepconv_pair(
        torch.from_numpy(x), _torch(b1), _torch(b2), pool=mode == "pool",
        x2=torch.from_numpy(x2) if x2 is not None else None,
    )
    if mode == "pool":
        got, pooled = got
        np.testing.assert_allclose(
            pooled.numpy(), np.asarray(jops.max_pool_2x2(want)), **TOL
        )
        assert pooled.shape == (2, HW // 2, HW // 2, f2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pair_zero_pads_y1_not_block1_past_the_edge():
    """Block 2's 'same' padding sees zero y1 outside the image. Evaluating
    block 1 on a padded input and cropping afterwards differs at the edge."""
    rng = np.random.RandomState(5)
    b1, b2 = _torch(_block(rng, 4, 8)), _torch(_block(rng, 8, 8))
    x = torch.from_numpy(_x(rng, 4))
    w1, w2 = tfs.prepare_block(b1, x.dtype), tfs.prepare_block(b2, x.dtype)
    got = tfs.sepconv_pair(x, w1, w2)
    xp = torch.nn.functional.pad(x, (0, 0, 2, 2, 2, 2))
    wrong = tfs.sepconv_block_reference(tfs.sepconv_block_reference(xp, w1), w2)[:, 2:-2, 2:-2]
    inner = (slice(None), slice(2, -2), slice(2, -2))
    torch.testing.assert_close(got[inner], wrong[inner], rtol=1e-5, atol=1e-5)
    assert (got[:, 0] - wrong[:, 0]).abs().max() > 1e-3


def test_bf16_rounding_points():
    """In bf16 the plain block rounds the depthwise sum before the pointwise
    and returns bf16; fp32 math on the same bf16 inputs differs by at most a
    few bf16 ulps."""
    rng = np.random.RandomState(11)
    blk = _torch(_block(rng, 16, 16))
    x = torch.from_numpy(_x(rng, 16)).to(torch.bfloat16)
    w16 = tfs.prepare_block(blk, torch.bfloat16)
    y16 = tfs.sepconv_block(x, w16)
    assert y16.dtype == torch.bfloat16
    w32 = tfs.BlockWeights(w16.dw.float(), w16.pw.float(), w16.scale, w16.shift)
    y32 = tfs.sepconv_block(x.float(), w32)
    torch.testing.assert_close(y16.float(), y32, rtol=2e-2, atol=2e-2)


def test_cpu_path_launches_nothing():
    rng = np.random.RandomState(2)
    tfs.reset_launch_counts()
    b1, b2 = _torch(_block(rng, 3, 8)), _torch(_block(rng, 8, 8))
    x = torch.from_numpy(_x(rng, 3))
    tfs.fused_sepconv_pair(x, b1, b2, pool=True)
    tfs.fused_sepconv_bn_relu(x, b1["depthwise_kernel"], b1["pointwise_kernel"])
    xg = x.clone().requires_grad_()
    y, s, q = tfs.sepconv_apply_stats(xg, b1["depthwise_kernel"], b1["pointwise_kernel"])
    (y.sum() + s.sum() + q.sum() + tfs.sepconv_apply(xg, b2["depthwise_kernel"][:, :, :3],
                                                     b1["pointwise_kernel"]).sum()).backward()
    assert tfs.LAUNCHES == {"sepconv_block": 0, "sepconv_pair": 0, "sepconv_stats": 0,
                            "sepconv_bwd": 0}


def test_kernel_build_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        build.load_library()


def test_kernel_sources_hash_into_library_name():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libunet_kernels_") and path.suffix == ".so"
    names = {p.name for p in build.CSRC.glob("*.cu")}
    assert {"sepconv_block.cu", "sepconv_pair.cu"} <= names
    for name in ("sepconv_block.cu", "sepconv_pair.cu"):
        note = (build.CSRC / name).read_text().split("#include")[0]
        assert "Replaces the TPU kernel" in note and "bounds it on the H100" in note
