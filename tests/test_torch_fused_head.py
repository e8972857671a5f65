"""The port's fused head (K5 with the last decoder chain) against the JAX
package's ``fused_head_train``.

On the CPU the port's chain links and head run their kernels' plain
versions inside the same autograd Function the card runs; the JAX kernels
run in interpret mode, as the JAX package's own tests run them. Inputs come
from ``np.random.RandomState`` (the shapes of ``tests/test_fused_head.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.ops.losses import loss_from_sums as jax_loss_from_sums
from unet_image_segmentation_tpu.ops.pallas import fused_head as jfh
from unet_image_segmentation_tpu_torch.ops import fused_head as tfh
from unet_image_segmentation_tpu_torch.ops import fused_train as tft
from unet_image_segmentation_tpu_torch.ops.losses import loss_from_sums


def _case(seed, b, h, w, c0, f):
    rng = np.random.RandomState(seed)
    blocks, c = [], c0
    for _ in range(2):
        blocks.append(((rng.randn(3, 3, c, 1) * 0.3).astype(np.float32),
                       (rng.randn(1, 1, c, f) * 0.1).astype(np.float32),
                       (rng.rand(f) + 0.5).astype(np.float32),
                       rng.randn(f).astype(np.float32)))
        c = f
    w_head = (rng.randn(1, 1, f, 1) * 0.2).astype(np.float32)
    b_head = rng.randn(1).astype(np.float32)
    x = rng.rand(b, h, w, c0).astype(np.float32)
    t = (rng.rand(b, h, w, 1) > 0.5).astype(np.float32)
    return x, blocks, w_head, b_head, t


def _run_jax(x, blocks, w_head, b_head, t, loss_name, dtype=jnp.float32):
    def loss(x, blocks, wh, bh):
        sums, stats = jfh.fused_head_train(x.astype(dtype), blocks, wh, bh, jnp.asarray(t))
        return jax_loss_from_sums(loss_name, sums), (sums, stats)

    args = (jnp.asarray(x), [tuple(map(jnp.asarray, blk)) for blk in blocks],
            jnp.asarray(w_head), jnp.asarray(b_head))
    (l, (sums, stats)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    gx, gb, gw, gbh = grads
    flat = [np.asarray(gx)] + [np.asarray(a) for blk in gb for a in blk] + \
        [np.asarray(gw), np.asarray(gbh)]
    return float(l), {k: np.asarray(v) for k, v in sums.items()}, stats, flat


def _run_port(x, blocks, w_head, b_head, t, loss_name, dtype=torch.float32):
    tx = torch.from_numpy(x).requires_grad_()
    tblocks = [[torch.from_numpy(a).requires_grad_() for a in blk] for blk in blocks]
    tw, tb = torch.from_numpy(w_head).requires_grad_(), torch.from_numpy(b_head).requires_grad_()
    sums, stats = tfh.fused_head_train(tx.to(dtype), tblocks, tw, tb, torch.from_numpy(t))
    loss = loss_from_sums(loss_name, sums)
    loss.backward()
    flat = [tx.grad.numpy()] + [a.grad.numpy() for blk in tblocks for a in blk] + \
        [tw.grad.numpy(), tb.grad.numpy()]
    return float(loss.detach()), {k: v.detach().numpy() for k, v in sums.items()}, stats, flat


@pytest.mark.parametrize("shape,loss_name", [
    ((2, 16, 64, 32, 64), "dice"),
    ((1, 8, 32, 16, 32), "iou"),
])
def test_fused_head_matches_jax(shape, loss_name):
    x, blocks, w_head, b_head, t = _case(sum(shape), *shape)
    tfh.reset_launch_counts()
    lt, st, mt, gt = _run_port(x, blocks, w_head, b_head, t, loss_name)
    assert sum(tfh.LAUNCHES.values()) == 0  # the CPU runs the plain K5
    lj, sj, mj, gj = _run_jax(x, blocks, w_head, b_head, t, loss_name)
    assert set(st) == set(sj) == set(tfh.SUM_KEYS)
    for k in tfh.SUM_KEYS:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-5, err_msg=k)
    assert st["p"].min() > 0 and st["t"].min() > 0
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    for (m1, v1), (m2, v2) in zip(mt, mj):
        np.testing.assert_allclose(m1.numpy(), np.asarray(m2), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(v1.numpy(), np.asarray(v2), rtol=1e-3, atol=1e-5)
    assert len(gt) == len(gj) == 1 + 8 + 2
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b.reshape(a.shape), rtol=2e-4, atol=2e-6)


def test_fused_head_bf16_rounding_point():
    """bf16: the logit rounds where the composed head rounds (the conv
    output cast and a same-dtype bias add), in both packages."""
    x, blocks, w_head, b_head, t = _case(5, 1, 8, 64, 32, 64)
    _, st, _, _ = _run_port(x, blocks, w_head, b_head, t, "dice", torch.bfloat16)
    _, sj, _, _ = _run_jax(x, blocks, w_head, b_head, t, "dice", jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tblocks = [[torch.from_numpy(a) for a in blk] for blk in blocks]
    z, _ = tft.chain_reference(tx, tblocks)
    logits = (torch.matmul(z, torch.from_numpy(w_head).reshape(-1, 1).to(torch.bfloat16))
              + torch.from_numpy(b_head).to(torch.bfloat16)).float()
    composed = tfh.head_sums_reference(torch.sigmoid(logits), torch.from_numpy(t))
    for k in ("i", "p", "t"):
        np.testing.assert_allclose(st[k], sj[k], rtol=2e-3, err_msg=k)
        np.testing.assert_allclose(st[k], composed[k].numpy(), rtol=2e-3, err_msg=k)


def _head_case(seed, b=2, h=4, wd=6, f=8, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    y = torch.from_numpy((rng.randint(-4, 5, (b, h, wd, f)) * 0.25).astype(np.float32)).to(dtype)
    a = torch.from_numpy((1.0 + 0.5 * rng.randint(0, 3, f)).astype(np.float32))
    sh = torch.from_numpy((0.25 * rng.randint(-2, 3, f)).astype(np.float32))
    mean = torch.from_numpy((0.1 * rng.randn(f)).astype(np.float32))
    rstd = torch.from_numpy((1.0 + rng.rand(f)).astype(np.float32))
    w = torch.from_numpy((rng.randn(f) * 0.5).astype(np.float32)).to(dtype).float()
    hb = torch.tensor([0.1]).to(dtype).float()
    t = torch.from_numpy((rng.rand(b, h, wd) > 0.5).astype(np.uint8))
    return y, torch.stack([a, sh, mean, rstd]), w, hb, t


def test_head_bwd_is_autograd_of_head_and_masks_exact_zeros():
    """The plain K5 backward equals autograd through the plain forward's
    differentiable sums, on quarter-step inputs where ``a*y+b`` is exactly
    0 on many pixels (the ReLU passes no gradient there)."""
    y, aff4, w, hb, t = _head_case(0)
    wl = y.float() * aff4[0] + aff4[1]
    assert (wl == 0).float().mean() > 0.05
    gsc = torch.tensor([[0.7, -0.3], [-1.1, 0.4]])
    dzt, S, T, dw, db = tfh.head_bwd(y, t, aff4, w, hb, gsc)
    assert (dzt[wl == 0] == 0).all()

    z = wl.clamp_min(0.0).requires_grad_()
    wr, hbr = w.clone().requires_grad_(), hb.clone().requires_grad_()
    p = torch.sigmoid(torch.matmul(z, wr) + hbr)
    tf = t.float()
    obj = (gsc[:, 0] * (p * tf).sum(dim=(1, 2)) + gsc[:, 1] * p.sum(dim=(1, 2))).sum()
    gz, gw, gb = torch.autograd.grad(obj, (z, wr, hbr))
    gz = torch.where(wl > 0, gz, torch.zeros_like(gz))
    np.testing.assert_allclose(dzt.numpy(), gz.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dw.numpy(), gw.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), gb.numpy(), rtol=1e-5, atol=1e-6)
    yhat = (y.float() - aff4[2]) * aff4[3]
    np.testing.assert_allclose(S.numpy(), gz.sum(dim=(0, 1, 2)).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(T.numpy(), (gz * yhat).sum(dim=(0, 1, 2)).numpy(),
                               rtol=1e-5, atol=1e-6)
    sums = tfh.head_fwd_sums(y, t, aff4[:2].contiguous(), w, hb)
    want = tfh.head_sums_reference(p.detach()[..., None], tf)
    for i, k in enumerate(tfh.SUM_KEYS):
        np.testing.assert_allclose(sums[:, i].numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)


def test_head_bwd_bf16_rounds_dl_for_dzt_and_dw_only():
    """bf16: dzt and dw use the rounded dl = bf16(dlog); db the unrounded dlog."""
    y, aff4, w, hb, t = _head_case(1, dtype=torch.bfloat16)
    gsc = torch.tensor([[0.9, -0.2], [0.3, 0.5]])
    dzt, _, _, dw, db = tfh.head_bwd(y, t, aff4, w, hb, gsc)
    assert dzt.dtype == torch.bfloat16
    wl = y.float() * aff4[0] + aff4[1]
    z = wl.clamp_min(0.0).to(torch.bfloat16).float()
    lf = torch.matmul(z, w).to(torch.bfloat16).float()
    p = torch.sigmoid((lf + hb).to(torch.bfloat16).float())
    dlog = (gsc[:, 0, None, None] * t.float() + gsc[:, 1, None, None]) * p * (1 - p)
    dl = dlog.to(torch.bfloat16).float()
    np.testing.assert_allclose(db.numpy(), dlog.sum().reshape(1).numpy(), rtol=1e-6)
    np.testing.assert_allclose(dw.numpy(), (z * dl[..., None]).sum(dim=(0, 1, 2)).numpy(),
                               rtol=1e-6, atol=1e-7)
    want = torch.where(wl > 0, dl[..., None] * w, torch.zeros_like(wl)).to(torch.bfloat16)
    assert torch.equal(dzt, want)


def test_head_supported_widths():
    assert tfh.head_supported(64, torch.bfloat16) and tfh.head_supported(64, torch.float32)
    assert tfh.head_supported(8, torch.float32) and not tfh.head_supported(4, torch.bfloat16)
    assert not tfh.head_supported(512, torch.bfloat16) and tfh.head_supported(256, torch.bfloat16)


# K5's plan (the streaming body): dec1 of the 256 px and 512 px models at
# their batches, the narrowest and widest widths each dtype takes, widths
# off the powers of two, and samples whose pixels are no whole number of
# runs (ragged last runs)
_HEAD_PLAN_SHAPES = [
    pytest.param(32, 256 * 256, 64, id="dec1-256px-b32"),
    pytest.param(8, 512 * 512, 64, id="dec1-512px-b8"),
    pytest.param(2, 20 * 36, 8, id="20x36-f8"),
    pytest.param(3, 20 * 36, 24, id="20x36-f24"),
    pytest.param(3, 20 * 36, 40, id="20x36-f40"),
    pytest.param(2, 9 * 13, 40, id="9x13-f40"),
    pytest.param(3, 20 * 36, 128, id="20x36-f128"),
    pytest.param(2, 20 * 36, 256, id="20x36-f256"),
]


@pytest.mark.parametrize("nc", [1, 2, 3, 4], ids=["k5", "k11-2", "k11-3", "k11-4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,hw,f", _HEAD_PLAN_SHAPES)
def test_head_plan(b, hw, f, dtype, nc):
    """K5 (nc = 1) and K11 (nc classes) share the plan: groups of L lanes
    (the power of two at or above F/V) take L pixels at a time, at most one
    pixel a thread of 512; runs of a whole number of groups, about 64 KB of
    y; the CTAs' contiguous run ranges cover every pixel of every sample
    exactly once; the ring's 3 stages in shared memory; at most one CTA an
    SM of a 132-SM card (__launch_bounds__(512, 1)). The rows of partial
    sums and the shared memory follow each kernel's layout (head_smem of
    head.cu, head_mc_smem of head_mc.cu): K11's backward holds S, T and dw of 4
    channels a thread, then a table of a, b, mean, rstd and w ((4+NC) F
    floats) and hb (4 floats), and the run's dlb (16 bytes a pixel)."""
    if not tfh.head_supported(f, dtype):
        with pytest.raises(ValueError):
            tfh.head_plan(b, hw, f, dtype, 132, nc)
        return
    sms = 132
    plan = tfh.head_plan(b, hw, f, dtype, sms, nc)
    e = dtype.itemsize
    g = f // (16 // e)
    assert plan.lanes >= g and plan.lanes < 2 * max(g, 1) and plan.lanes & (plan.lanes - 1) == 0
    assert plan.lanes <= plan.pixels <= 512 and plan.pixels % plan.lanes == 0
    assert plan.pixels * f * e <= 65536 or plan.pixels == plan.lanes
    assert plan.pixels == 512 or (plan.pixels + plan.lanes) * f * e > 65536
    runs = -(-hw // plan.pixels)
    assert plan.runs == b * runs and 1 <= plan.ctas == min(sms, plan.runs)
    assert plan.stage == plan.pixels * f * e + -(-plan.pixels // 16) * 16 + 32
    ring = 3 * (-(-plan.stage // 128) * 128)
    assert plan.smem_fwd == 64 + max(ring, 512 * 16)
    if nc == 1:
        assert plan.smem_bwd == 64 + max(ring, 512 * 12 * (16 // e))
        sums = 9
    else:
        assert plan.smem_bwd == (64 + max(ring, 512 * 16 * (2 + nc)) + ((4 + nc) * f + 4) * 4 +
                                 512 * 16)
        sums = 3 * nc + 1 + nc * nc
        assert tfh.mc_sum_count(nc) == sums
    assert max(plan.smem_fwd, plan.smem_bwd) <= tft.SMEM_MAX
    assert (plan.ld_fwd, plan.ld_bwd) == (-(-sums * b // 4) * 4,
                                          -(-((2 + nc) * f + nc) // 4) * 4)
    covered = np.zeros(b * hw, np.int32)
    for lo, hi in tft.stream_ranges(plan.runs, plan.ctas):
        for u in range(lo, hi):
            s, k = divmod(u, runs)
            p0 = k * plan.pixels
            covered[s * hw + p0:s * hw + min(hw, p0 + plan.pixels)] += 1
    assert (covered == 1).all()


def test_head_plan_refuses_class_counts_outside_the_kernels():
    with pytest.raises(ValueError):
        tfh.head_plan(2, 64, 64, torch.bfloat16, 132, 0)
    with pytest.raises(ValueError):
        tfh.head_plan(2, 64, 64, torch.bfloat16, 132, tfh.MAX_MC_CLASSES + 1)


def _jax_head_kernels(y, t, aff4, w, hb, gsc, p):
    """The JAX head kernels (head_fwd_sums, head_bwd) at pack p on fp32
    numpy inputs, their panels folded as _head_core's VJP folds them:
    ``(sums (B, 9), dzt, S, T, dw, db)``."""
    b, h, wd, f = y.shape
    y_p = jnp.asarray(y.reshape(b, h, wd // p, p * f))
    t_exp = jfh.expand_targets(jnp.asarray(t.astype(np.float32)), p)
    wsel, bvec = jfh._head_mats(jnp.asarray(w), jnp.asarray(hb[0]), p, f, jnp.float32)
    aff4 = jnp.asarray(aff4)
    panel = jfh.head_fwd_sums(y_p, t_exp, aff4[:2], wsel, bvec, p)
    sums = np.stack([np.asarray(panel[:, row, :].sum(axis=-1)) for row in jfh._SUM_ROWS], 1)
    g = np.zeros((b, 8, jfh.COLS), np.float32)
    g[:, 0, :], g[:, 1, :] = gsc[:, :1], gsc[:, 1:]
    dzt, st, dw_panel, db_row = jfh.head_bwd(y_p, t_exp, aff4, wsel, bvec, jnp.asarray(g), p)
    st = np.asarray(st)[:2].reshape(2, p, f).sum(axis=1)
    dwp = np.asarray(dw_panel).reshape(p, f, jfh.COLS)
    dw = sum(dwp[j, :, j] for j in range(p))
    db = np.asarray(jnp.sum(db_row[0] * bvec[1])).reshape(1)
    return sums, np.asarray(dzt).reshape(b, h, wd, f), st[0], st[1], dw, db


@pytest.mark.parametrize("b,h,wd,f,p", [
    pytest.param(2, 20, 32, 8, 16, id="b2-20x32-f8-p16"),
    pytest.param(3, 4, 32, 24, 16, id="b3-4x32-f24-p16"),
    pytest.param(2, 4, 32, 40, 16, id="b2-4x32-f40-p16"),
    pytest.param(3, 4, 16, 200, 16, id="b3-4x16-f200-p16"),
    pytest.param(2, 20, 36, 128, 1, id="b2-20x36-f128-p1"),
    pytest.param(3, 4, 6, 256, 1, id="b3-4x6-f256-p1"),
])
def test_head_kernels_match_jax_at_ragged_widths(b, h, wd, f, p):
    """Plain K5 (forward sums and backward) against the JAX head kernels in
    fp32 at the narrowest widths, widths off the powers of two, the widest,
    and ragged rows, on quarter-step inputs where a*y+b is exactly 0 on
    many values: the sums to 1e-5 relative (the bar of
    test_fused_head_matches_jax), dzt to an fp32 rounding, S, T, dw, db as
    sums over B*H*W values."""
    y, aff4, w, hb, t = _head_case(b * 100 + f, b, h, wd, f)
    gsc = torch.from_numpy(np.random.RandomState(f).randn(b, 2).astype(np.float32))
    assert ((y * aff4[0] + aff4[1]) == 0).float().mean() > 0.02
    sums = tfh.head_fwd_sums(y, t, aff4[:2].contiguous(), w, hb)
    port = tfh.head_bwd(y, t, aff4, w, hb, gsc)
    want = _jax_head_kernels(y.numpy(), t.numpy(), aff4.numpy(), w.numpy(), hb.numpy(),
                             gsc.numpy(), p)
    np.testing.assert_allclose(sums.numpy(), want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port[0].numpy(), want[1], rtol=1e-5, atol=1e-6)
    for got, ref in zip(port[1:], want[2:]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
