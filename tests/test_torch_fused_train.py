"""The port's training chains (K1-K4 orchestration) against the JAX package's.

On the CPU the port's wrappers run their kernels' plain versions inside
the same autograd Function the card runs; the JAX chains run their Pallas
kernels in interpret mode, as the JAX package's own tests run them. Inputs
come from ``np.random.RandomState``; outputs, batch moments and every
gradient (input and weights) are held to the bars of
``tests/test_fused_train.py`` (fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.ops.pallas import fused_train as jft
from unet_image_segmentation_tpu_torch.ops import fused_train as tft

HW = 16
OUT_TOL = dict(atol=2e-4, rtol=1e-4)


def _blocks(rng, channels):
    blocks, c = [], channels[0]
    for f in channels[1:]:
        blocks.append((
            (rng.randn(3, 3, c, 1) * 0.4).astype(np.float32),
            (rng.randn(1, 1, c, f) * 0.4).astype(np.float32),
            (1.0 + 0.1 * rng.randn(f)).astype(np.float32),
            (0.05 * rng.randn(f)).astype(np.float32),
        ))
        c = f
    return blocks


def _assert_grads(got, want):
    """The bar of tests/test_fused_train.py: atol 3e-3 * max(1, max|want|), rtol 2e-3."""
    for a, b in zip(got, want):
        scale = max(1.0, float(np.max(np.abs(b))))
        np.testing.assert_allclose(a, b, atol=3e-3 * scale, rtol=2e-3)


def _run_jax(x, blocks, pool, drop_rate, seed):
    def loss(x, blocks):
        if pool:
            z_p, _, pooled_p, stats = jft.fused_chain_train_pool(x, blocks, pool_to_pack=1)
            b, h, w, _ = x.shape
            f = blocks[-1][1].shape[-1]
            z = z_p.reshape(b, h, w, f)
            pooled = pooled_p.reshape(b, h // 2, w // 2, f)
            return jnp.sum(z * z) + jnp.sum(pooled ** 3), (z, pooled, stats)
        z, stats = jft.fused_chain_train(x, blocks, drop_rate=drop_rate,
                                         drop_seed=jnp.int32(seed) if drop_rate else None)
        return jnp.sum(z * z), (z, None, stats)

    jblocks = [tuple(jnp.asarray(t) for t in b) for b in blocks]
    (l, (z, pooled, stats)), (gx, gb) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jblocks)
    grads = [np.asarray(gx)] + [np.asarray(t) for b in gb for t in b]
    return float(l), z, pooled, stats, grads


def _run_torch(x, blocks, pool, drop_rate, seed):
    tx = torch.from_numpy(x).requires_grad_()
    tblocks = [[torch.from_numpy(t).requires_grad_() for t in b] for b in blocks]
    if pool:
        z, pooled, stats = tft.fused_chain_train_pool(tx, tblocks)
        loss = (z * z).sum() + (pooled ** 3).sum()
    else:
        z, stats = tft.fused_chain_train(tx, tblocks, drop_rate=drop_rate,
                                         drop_seed=seed if drop_rate else None)
        pooled = None
        loss = (z * z).sum()
    loss.backward()
    grads = [tx.grad.numpy()] + [t.grad.numpy() for b in tblocks for t in b]
    return float(loss), z, pooled, stats, grads


@pytest.mark.parametrize(
    "channels,pool,drop_rate",
    [
        ((8, 8), False, 0.0),
        ((8, 8, 16), False, 0.0),
        ((3, 8, 8), False, 0.0),     # the image input: no padding in the port
        ((8, 8, 16), True, 0.0),
        ((3, 8, 8), True, 0.0),      # encoder stage 1 shape
        ((16, 8, 8), False, 0.2),    # decoder chain with fused input dropout
        ((8, 8, 16), False, 0.5),
    ],
)
def test_chain_matches_jax(channels, pool, drop_rate):
    rng = np.random.RandomState(7 + channels[-1] + int(10 * drop_rate))
    x = rng.rand(2, HW, HW, channels[0]).astype(np.float32)
    blocks = _blocks(rng, channels)
    seed = -987654321
    tft.reset_launch_counts()
    lt, zt, pt, st, gt = _run_torch(x, blocks, pool, drop_rate, seed)
    assert sum(tft.LAUNCHES.values()) == 0  # the CPU runs the plain K1-K4
    lj, zj, pj, sj, gj = _run_jax(x, blocks, pool, drop_rate, seed)
    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(zj), **OUT_TOL)
    if pool:
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), **OUT_TOL)
    assert len(st) == len(sj) == len(blocks)
    for (mt, vt), (mj, vj) in zip(st, sj):
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **OUT_TOL)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **OUT_TOL)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert len(gt) == len(gj) == 1 + 4 * len(blocks)
    _assert_grads(gt, gj)


def test_chain_matches_reference_autograd():
    """The Function's hand-written backward equals autograd through the
    composed chain (``chain_reference``), dropout on."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(2, HW, HW, 16).astype(np.float32)).requires_grad_()
    blocks = [[torch.from_numpy(t).requires_grad_() for t in b]
              for b in _blocks(rng, (16, 8, 8))]
    params = [x] + [t for b in blocks for t in b]
    z, stats = tft.fused_chain_train(x, blocks, drop_rate=0.3, drop_seed=77)
    g_fused = torch.autograd.grad((z * z).sum(), params)
    zr, stats_r = tft.chain_reference(x, blocks, drop_rate=0.3, drop_seed=77)
    g_ref = torch.autograd.grad((zr * zr).sum(), params)
    np.testing.assert_allclose(z.detach().numpy(), zr.detach().numpy(), atol=1e-6)
    for (m, v), (mr, vr) in zip(stats, stats_r):
        np.testing.assert_allclose(m.numpy(), mr.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(v.numpy(), vr.detach().numpy(), atol=1e-6)
    _assert_grads([g.numpy() for g in g_fused], [g.numpy() for g in g_ref])


def _pool_case(rng, f, h=8):
    """Raw y on 9 levels: after the ReLU many 2x2 windows hold exact ties."""
    y = (rng.randint(-4, 5, (2, h, h, f)) * 0.25).astype(np.float32)
    aff4 = np.stack([1.0 + 0.5 * np.abs(rng.randn(f)), 0.1 * rng.randn(f),
                     0.1 * rng.randn(f), 1.0 + 0.5 * np.abs(rng.randn(f))]).astype(np.float32)
    gs = rng.randn(2, h, h, f).astype(np.float32)
    gp = rng.randn(2, h // 2, h // 2, f).astype(np.float32)
    return y, aff4, gs, gp


def test_tail_pool_and_tie_backward_match_jax_kernels():
    """Plain K3/K4 against the JAX kernels ``_tail_pool_p1`` and
    ``_tail_pool_bwd_p1`` on inputs with ties: the pooled cotangent goes to
    the first maximum of each window."""
    rng = np.random.RandomState(11)
    y, aff4, gs, gp = _pool_case(rng, 128)
    zj, pj = jft._tail_pool_p1(jnp.asarray(y), jnp.asarray(aff4[0]), jnp.asarray(aff4[1]))
    zt, pt = tft.tail_pool(torch.from_numpy(y), torch.from_numpy(aff4[0]),
                           torch.from_numpy(aff4[1]))
    # XLA may fuse a*y+b into one FMA: z agrees to an fp32 rounding
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=1e-6)
    win = zt.reshape(2, 4, 2, 4, 2, 128)
    tied = (win == win.amax(dim=(2, 4), keepdim=True)).sum(dim=(2, 4)) > 1
    assert tied.float().mean() > 0.2  # windows whose maximum occurs twice or more

    dj, stj = jft._tail_pool_bwd_p1(jnp.asarray(y), jnp.asarray(gs), jnp.asarray(gp),
                                    jnp.asarray(aff4))
    dt, stt = tft.tail_pool_bwd(torch.from_numpy(y), torch.from_numpy(gs), torch.from_numpy(gp),
                                torch.from_numpy(aff4))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(stt.numpy(), np.asarray(stj)[:2], atol=1e-5, rtol=1e-6)


def test_tail_pool_bwd_routes_ties_to_first_max():
    """Hand-made windows: an all-equal window sends the pooled cotangent to
    its top-left cell only; a tie of the two bottom cells to the left one."""
    y = torch.tensor([[[[1.0], [1.0]], [[1.0], [1.0]]],
                      [[[0.0], [0.0]], [[2.0], [2.0]]]]).reshape(2, 2, 2, 1)
    aff4 = torch.tensor([[1.0], [0.0], [0.0], [1.0]])
    gs = torch.zeros(2, 2, 2, 1)
    gp = torch.ones(2, 1, 1, 1)
    dzt, _ = tft.tail_pool_bwd(y, gs, gp, aff4)
    np.testing.assert_array_equal(dzt[..., 0].numpy(),
                                  [[[1.0, 0.0], [0.0, 0.0]], [[0.0, 0.0], [1.0, 0.0]]])


def test_link_wrappers_reject_dropout_with_affine():
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="exclusive"):
        tft.chain_fwd(x, torch.zeros(3, 3, 2), torch.zeros(2, 2), torch.ones(2, 2),
                      tft.Dropout(1, 0.5))
