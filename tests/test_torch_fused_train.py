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
from unet_image_segmentation_tpu_torch.troubleshoot import roofline

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


_BWD_PLAN_SHAPES = [
    pytest.param(2, 8, 8, 3, 33, id="c3-f33"),
    pytest.param(3, 20, 36, 3, 48, id="ragged-20x36-c3-f48"),
    pytest.param(2, 13, 11, 5, 33, id="ragged-c5-f33"),
    pytest.param(2, 16, 16, 64, 1024, id="c64-f1024"),
    pytest.param(3, 20, 36, 200, 72, id="ragged-c200-f72"),
    pytest.param(2, 16, 16, 1024, 33, id="c1024-f33"),
    pytest.param(32, 16, 16, 1024, 1024, id="bneck2-batch32"),
    pytest.param(32, 256, 256, 64, 64, id="enc1.2-batch32"),
    pytest.param(65535, 8, 8, 128, 128, id="batch-65535"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,w,c,f", _BWD_PLAN_SHAPES)
def test_chain_bwd_plan(b, h, w, c, f, dtype):
    """Pass (a): a CTA per 8x8 tile, C slice and sample, the slice 64 wide
    only where C fits it, so gy is built once per tile up to C = 128 and
    C/128 times past it; two CTAs an SM by shared memory. Pass (b): dpw
    tiles of 64 or 128 covering C x F, splits of whole KC-pixel chunks that
    cover the B*H*W pixels, each split non-empty; the grids within CUDA's
    limits."""
    plan = tft.chain_bwd_plan(b, h, w, c, f, dtype)
    kc = {torch.bfloat16: 32, torch.float32: 16}[dtype]
    assert plan.wc == (64 if c <= 64 else 128)
    assert plan.grid_a == (-(-h // 8) * -(-w // 8), -(-c // plan.wc), b)
    assert plan.grid_a[1] == max(1, -(-c // 128))
    assert 2 * (plan.smem_a + 1024) <= 228 * 1024 and plan.smem_b <= tft.SMEM_MAX == 232448
    assert plan.tm in (64, 128) and plan.tn in (64, 128)
    assert plan.tm >= min(c, 128) or c > 64 and plan.tm == 128
    p = b * h * w
    assert plan.per % kc == 0 and (plan.splits - 1) * plan.per < p <= plan.splits * plan.per
    assert plan.grid_b == (-(-f // plan.tn), -(-c // plan.tm), plan.splits)
    assert plan.grid_b[2] <= 65535 and plan.grid_a[0] < 2 ** 31
    assert plan.cols_b == c * f
    assert plan.cm % (16 // dtype.itemsize) == 0 and c <= plan.cm < c + 16 // dtype.itemsize
    assert tft.chain_bwd_plan(b, h, w, c, f, dtype, bias=True).cols_b == c * f + f


def test_chain_bwd_plan_by_hand():
    """bf16 enc1.2 of the 256 px step at batch 32: 1024 tiles of 64 channels;
    dpw in one 64x64 tile, 264 splits of 7968 pixels (2^21 / 264 = 7944.2,
    rounded up to 32-pixel chunks); the shared memory of TileSmem /
    DpwSmem in chain_bwd.cu."""
    plan = tft.chain_bwd_plan(32, 256, 256, 64, 64, torch.bfloat16)
    assert plan.grid_a == (1024, 1, 32) and plan.wc == 64
    # 4 stages of g [112][40], y [100][40], pw [64][40] (bf16) and comb [6][32]
    assert plan.smem_a == 4 * (2 * (112 + 100 + 64) * 40 + 4 * 6 * 32) == 91392
    assert (plan.tm, plan.tn, plan.splits, plan.per) == (64, 64, 264, 7968)
    assert plan.smem_b == 2 * 4 * 32 * (72 + 72) == 36864
    deep = tft.chain_bwd_plan(32, 16, 16, 1024, 1024, torch.float32)
    assert deep.grid_a == (4, 8, 32)
    assert deep.smem_a == 4 * (4 * (112 + 100 + 128) * 20 + 4 * 6 * 16) == 110336
    assert deep.smem_a > 2 * 4 * 100 * 136   # dm and x [100][136] (fp32) in the stages' place
    assert deep.grid_b[:2] == (8, 8) and deep.smem_b == 4 * 4 * 16 * (136 + 136)


def test_chain_bwd_plan_refuses_what_the_kernel_cannot_launch():
    with pytest.raises(ValueError, match="batch"):
        tft.chain_bwd_plan(65536, 8, 8, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="empty"):
        tft.chain_bwd_plan(1, 8, 8, 0, 64, torch.bfloat16)
    with pytest.raises(TypeError):
        tft.chain_bwd_plan(1, 8, 8, 64, 64, torch.float16)


def test_chain_bwd_work_by_hand():
    """One 8x8 tile, C = 3, F = 8, bf16: one CTA of a 64-wide slice whose
    first warp column (16 channels) alone holds C; F pads to one k16 step;
    pass (b) one 64x64 tile with one m16 tile and one warp's 16 columns
    over 64 pixels."""
    work = tft.chain_bwd_work(1, 8, 8, 3, 8, torch.bfloat16)
    assert work.pass_a_mma == 112 * 16 * 16
    assert work.pass_b_mma == 16 * 16 * 64
    assert work.elementwise == 64 * 3 * 27
    assert work.useful == 64 * (2 * 3 * 8 + 27 * 3)
    assert work.executed == work.pass_a_mma + work.pass_b_mma + work.elementwise
    fp32 = tft.chain_bwd_work(1, 8, 8, 3, 8, torch.float32)   # F = 8: one k8 step
    assert fp32.pass_a_mma == 112 * 16 * 8 and fp32.pass_b_mma == 16 * 16 * 64
    # C = 200, F = 72 at 20x36: two slices (128 + 72 channels: 3 of 4 warp
    # columns of the second), 3 x 5 tiles; F in chunks of 32 (32, 32, 8 -> 16)
    # pass (b): 128 + 80 rows of m16 tiles holding C, F in one 128 tile of
    # which 3 warp columns (96) hold F, 3 splits of 480 pixels over 1440
    work = tft.chain_bwd_work(2, 20, 36, 200, 72, torch.bfloat16)
    assert work.pass_a_mma == 2 * 15 * 112 * (128 + 96) * 80
    plan = tft.chain_bwd_plan(2, 20, 36, 200, 72, torch.bfloat16)
    assert (plan.tm, plan.tn, plan.splits, plan.per) == (128, 128, 3, 480)
    assert work.pass_b_mma == (128 + 80) * 96 * 1440


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_chain_bwd_work_on_the_unet_links(dtype):
    """At the 256 px step's links only the ring (112 GEMM rows for 64
    pixels), the slice width and the mma depth are left: at most 1.4x
    executed over useful, but at enc1.1, whose 3 input channels take one
    16-channel warp column of dm and one m16 tile of dpw."""
    for name, c, f, h, *_ in roofline.chain_links(256, (64, 128, 256, 512)):
        work = tft.chain_bwd_work(32, h, h, c, f, dtype)
        ratio = work.executed / work.useful
        assert 1.0 < ratio <= (6.5 if name == "enc1.1" else 1.4), (name, ratio)


# K1's and K8's launch plans: every link of the 256 px step at batch 32, and
# the ragged shapes of chip_smoke.py (partial slices, C off the vector and
# the mma depth, F off 16, a partial last cluster slice, over one chunk and
# over a partial last chunk)
_FWD_PLAN_SHAPES = (
    [pytest.param(32, h, h, c, f, id=f"256px-{name}")
     for name, c, f, h, *_ in roofline.chain_links(256, (64, 128, 256, 512))]
    + [pytest.param(3, 20, 36, 32, 64, id="ragged-20x36"),
       pytest.param(2, 24, 24, 3, 48, id="ragged-c3-f48"),
       pytest.param(3, 10, 14, 5, 33, id="ragged-c5-f33"),
       pytest.param(2, 12, 20, 200, 72, id="ragged-c200-f72"),
       pytest.param(3, 9, 9, 12, 300, id="ragged-f300"),
       pytest.param(3, 12, 20, 200, 300, id="ragged-c200-f300"),
       pytest.param(65535, 8, 8, 16, 1024, id="batch-65535")]
)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,w,c,f", _FWD_PLAN_SHAPES)
def test_fwd_plan(b, h, w, c, f, dtype):
    """A cluster of n CTAs whose slices (multiples of 16, within the GEMM
    width) cover F exactly, n the fewest that fit 128-wide slices; two CTAs
    an SM by shared memory; per tiles a cluster, the clusters covering the
    batch's tiles, at least 8 waves of two CTAs an SM (of a 132-SM card)
    where there are tiles for it; the grid within CUDA's limits."""
    plan = tft.fwd_plan(b, h, w, c, f, dtype, 132)
    assert plan.n in (1, 2, 4, 8) and (plan.n == 1 or (plan.n // 2) * 128 < f <= plan.n * 128)
    assert plan.s % 16 == 0 and plan.s <= plan.width in (64, 128)
    assert plan.width == (64 if plan.s <= 64 else 128)
    assert (plan.n - 1) * plan.s < f <= plan.n * plan.s
    assert 2 * (plan.smem + 1024) <= 228 * 1024
    tiles = b * plan.tiles_y * plan.tiles_x
    assert (plan.tiles_y, plan.tiles_x) == (-(-h // 8), -(-w // 8))
    assert 1 <= plan.per <= 8 and plan.grid == (plan.n * -(-tiles // plan.per),)
    assert plan.per == 1 or plan.grid[0] >= 16 * 132
    assert plan.grid[0] < 2 ** 31
    assert tft.fwd_plan_args(plan) == (plan.n, plan.s, plan.width, plan.per, plan.smem)


def test_fwd_plan_by_hand():
    """bf16 enc1.2 of the 256 px step at batch 32: one CTA a cluster, 64
    channels wide, 8 of the 32768 tiles a cluster; the shared memory of
    FwdSmem in sepconv_fwd.cuh. fp32 bneck.2: a cluster of 8 128-wide
    slices, one tile a cluster (128 tiles). The tiles a cluster follow the
    card's SM count: 8192 tiles of a 128-channel block at 128 px take 3 a
    cluster on 132 SMs (2731 CTAs), 4 on 114 (2048 CTAs)."""
    plan = tft.fwd_plan(32, 256, 256, 64, 64, torch.bfloat16, 132)
    assert (plan.n, plan.s, plan.width, plan.per) == (1, 64, 64, 8)
    assert plan.grid == (4096,)
    # x halo [2][100][64] and taps [2][9][64], A [2][64][72], pw [2][64][72]
    # in bf16, then the sums [4][64] in fp32
    assert plan.smem == 2 * (2 * 100 * 64 + 2 * 9 * 64 + 2 * 64 * 72 + 2 * 64 * 72) + 16 * 64
    assert plan.smem == 65792
    deep = tft.fwd_plan(32, 16, 16, 1024, 1024, torch.float32, 132)
    assert (deep.n, deep.s, deep.width, deep.per, deep.grid) == (8, 128, 128, 1, (1024,))
    # fp32: chunks of 32 channels, A twice (TF32 hi and lo) [2][2][64][36]
    assert deep.smem == 4 * (2 * 100 * 32 + 2 * 9 * 32 + 4 * 64 * 36 + 2 * 32 * 136) + 16 * 128
    # F = 300: four slices of 80 (the last holds 60); F = 33: one of 48
    assert tft.fwd_plan(3, 9, 9, 12, 300, torch.bfloat16, 132)[:3] == (4, 80, 128)
    assert tft.fwd_plan(3, 10, 14, 5, 33, torch.bfloat16, 132)[:3] == (1, 48, 64)
    assert tft.fwd_plan(32, 128, 128, 128, 128, torch.bfloat16, 132).per == 3
    assert tft.fwd_plan(32, 128, 128, 128, 128, torch.bfloat16, 114).per == 4


def test_fwd_plan_refuses_what_the_kernel_cannot_launch():
    with pytest.raises(ValueError, match="at most 1024"):
        tft.fwd_plan(1, 16, 16, 64, 1025, torch.bfloat16, 132)
    with pytest.raises(ValueError, match="batch"):
        tft.fwd_plan(65536, 8, 8, 64, 64, torch.bfloat16, 132)
    with pytest.raises(ValueError, match="empty"):
        tft.fwd_plan(1, 8, 0, 64, 64, torch.float32, 132)
    with pytest.raises(TypeError):
        tft.fwd_plan(1, 8, 8, 64, 64, torch.float16, 132)


def test_fwd_work_by_hand():
    """One 8x8 tile, C = 3, F = 16, bf16: the depthwise of one 16-deep
    (padded) chunk on the 64 pixels; the products of the first warp column
    (16 of the 64-wide slice) over that depth. C = 200, F = 72 at 12 x 20,
    batch 2: 2 x 6 tiles; chunks of 64, 64, 64 and 8 -> 16 channels; one
    128-wide slice of which 3 warp columns (96) hold F."""
    work = tft.fwd_work(1, 8, 8, 3, 16, torch.bfloat16)
    assert work == (64 * 9 * 16, 64 * 9 * 3, 64 * 16 * 16, 64 * 3 * 16)
    assert work.executed == 64 * 9 * 16 + 64 * 16 * 16 and work.useful == 64 * (27 + 48)
    fp32 = tft.fwd_work(1, 8, 8, 3, 16, torch.float32)   # k8 steps: C pads to 8
    assert (fp32.dw_executed, fp32.mma_executed) == (64 * 9 * 8, 64 * 16 * 8)
    work = tft.fwd_work(2, 12, 20, 200, 72, torch.bfloat16)
    assert work.dw_executed == 2 * 6 * 64 * 9 * 208
    assert work.mma_executed == 2 * 6 * 64 * 96 * 208
    assert work.useful == 2 * 12 * 20 * (9 * 200 + 200 * 72)
    # F = 300 over four 80-wide slices: 3 + 3 + 3 + 2 active warp columns of 32
    work = tft.fwd_work(1, 8, 8, 32, 300, torch.bfloat16)
    assert work.mma_executed == 64 * 32 * (96 * 3 + 64) and work.dw_executed == 64 * 9 * 32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_fwd_work_on_the_unet_links(dtype):
    """The cluster shares each tile's depthwise, so at the 256 px step's
    links nothing is recomputed: executed equals useful but at enc1.1, whose
    3 input channels fill one mma depth (16 in bf16, 8 in fp32). Summed over
    the 18 links: 1.011 (bf16), 1.004 (fp32)."""
    executed = useful = 0
    for name, c, f, h, *_ in roofline.chain_links(256, (64, 128, 256, 512)):
        work = tft.fwd_work(32, h, h, c, f, dtype)
        depth = 16 if dtype == torch.bfloat16 else 8
        want = depth / 3 if name == "enc1.1" else 1.0
        assert work.dw_executed / work.dw_useful == pytest.approx(want), name
        assert work.mma_executed / work.mma_useful == pytest.approx(want), name
        executed, useful = executed + work.executed, useful + work.useful
    assert executed / useful == pytest.approx(1.0115 if dtype == torch.bfloat16 else 1.0044,
                                              abs=5e-4)
    assert useful == 32 * sum(h * h * (9 * c + c * f) for _, c, f, h, *_ in
                              roofline.chain_links(256, (64, 128, 256, 512)))


# K4's plan (the streaming body): the 256 px and 512 px steps' boundaries at
# batch 32, ragged rows and widths off the powers of two (strips of a
# partial last run), one window a row, and the widest F the wrapper takes
# in fp32 (1024; bf16 2048)
_POOL_PLAN_SHAPES = (
    [pytest.param(32, h, h, f, id=f"{px}px-{name}")
     for px in (256, 512) for name, f, h in roofline.pool_shapes(px, (64, 128, 256, 512))]
    + [pytest.param(2, 20, 36, 40, id="ragged-20x36-f40"),
       pytest.param(3, 20, 36, 200, id="ragged-20x36-f200"),
       pytest.param(3, 6, 2, 16, id="one-window-rows"),
       pytest.param(2, 4, 34, 1024, id="widest-fp32"),
       pytest.param(2, 4, 34, 2048, id="widest-bf16")]
)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,w,f", _POOL_PLAN_SHAPES)
def test_pool_bwd_plan(b, h, w, f, dtype):
    """Strips of n windows of one pooled row, n * F/4 threads at work (at
    most the CTA's 512, 4 channels each); the CTAs' contiguous strip ranges
    cover every window of the batch exactly once, a row's last strip taking
    what is left; the ring's 3 stages in shared memory; at most one CTA an
    SM of a 132-SM card (the kernel's occupancy: __launch_bounds__(512,
    1))."""
    sms = 132
    plan = tft.pool_bwd_plan(b, h, w, f, dtype, sms)
    e = dtype.itemsize
    g = f // 4
    h2, w2 = h // 2, w // 2
    assert 1 <= plan.n <= w2 and plan.n * g <= 512
    assert plan.n == w2 or (plan.n + 1) * g > 512
    per_row = -(-w2 // plan.n)
    assert plan.strips == b * h2 * per_row
    assert 1 <= plan.ctas <= sms and plan.ctas == min(sms, plan.strips)
    assert plan.stage == 9 * plan.n * f * e
    assert plan.smem == 64 + max(3 * (-(-plan.stage // 128) * 128), 512 * 2 * 4 * 4)
    assert plan.smem <= tft.SMEM_MAX
    covered = np.zeros((b * h2, w2), np.int32)
    ranges = tft.stream_ranges(plan.strips, plan.ctas)
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.strips
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))
    for lo, hi in ranges:
        for u in range(lo, hi):
            row, px0 = divmod(u, per_row)
            px0 *= plan.n
            covered[row, px0:px0 + min(plan.n, w2 - px0)] += 1
    assert (covered == 1).all()


def test_pool_bwd_plan_by_hand():
    """bf16 enc1 of the 256 px step at batch 32: 16 groups of 4 channels,
    so 32 windows a strip (512 threads), 4 strips a pooled row, 16384
    strips on 132 CTAs; a stage holds 2 x 64 pixels of y and of gs and 32
    of gp."""
    plan = tft.pool_bwd_plan(32, 256, 256, 64, torch.bfloat16, 132)
    assert (plan.n, plan.strips, plan.ctas) == (32, 32 * 128 * 4, 132)
    assert plan.stage == (2 * 64 * 2 + 32) * 64 * 2 == 36864
    assert plan.smem == 64 + 3 * 36864
    deep = tft.pool_bwd_plan(32, 32, 32, 512, torch.float32, 132)
    assert (deep.n, deep.strips, deep.stage) == (4, 32 * 16 * 4, 9 * 4 * 512 * 4)
    ragged = tft.pool_bwd_plan(3, 20, 36, 200, torch.bfloat16, 132)
    assert (ragged.n, ragged.strips, ragged.ctas) == (10, 3 * 10 * 2, 60)


def test_pool_bwd_plan_refuses_what_the_kernel_cannot_launch():
    with pytest.raises(ValueError, match="even"):
        tft.pool_bwd_plan(1, 5, 8, 64, torch.bfloat16, 132)
    with pytest.raises(ValueError, match="multiple"):
        tft.pool_bwd_plan(1, 4, 8, 60, torch.bfloat16, 132)
    with pytest.raises(ValueError, match="at most"):
        tft.pool_bwd_plan(1, 4, 8, 2056, torch.float32, 132)
    with pytest.raises(TypeError):
        tft.pool_bwd_plan(1, 4, 8, 64, torch.float16, 132)


def _pack_rows(a, p):
    """(B, H, W, F) -> the JAX kernels' (B, H, W/p, p*F)."""
    b, h, w, f = a.shape
    return a.reshape(b, h, w // p, p * f)


@pytest.mark.parametrize("b,h,w,f,p", [
    pytest.param(3, 20, 36, 128, 1, id="b3-20x36-f128-p1"),
    pytest.param(2, 20, 36, 256, 1, id="b2-20x36-f256-p1"),
    pytest.param(2, 20, 32, 40, 16, id="b2-20x32-f40-p16"),
    pytest.param(3, 20, 32, 200, 16, id="b3-20x32-f200-p16"),
])
def test_tail_pool_bwd_matches_jax_at_ragged_shapes(b, h, w, f, p):
    """Plain K4 against the JAX kernels at ragged rows and widths off the
    powers of two, on inputs with ties: ``_tail_pool_bwd_p1`` where F is a
    multiple of 128, else ``_tail_pool_bwd_packed`` at the pack the JAX
    chain uses (16 windows' worth of lanes). dzt to an fp32 rounding, S and
    T as sums over B*H*W values (the bars of the tied test above)."""
    rng = np.random.RandomState(b * 1000 + f)
    y = (rng.randint(-4, 5, (b, h, w, f)) * 0.25).astype(np.float32)
    aff4 = np.stack([1.0 + 0.5 * np.abs(rng.randn(f)), 0.1 * rng.randn(f),
                     0.1 * rng.randn(f), 1.0 + 0.5 * np.abs(rng.randn(f))]).astype(np.float32)
    gs = rng.randn(b, h, w, f).astype(np.float32)
    gp = rng.randn(b, h // 2, w // 2, f).astype(np.float32)
    dt, stt = tft.tail_pool_bwd(*map(torch.from_numpy, (y, gs, gp, aff4)))
    if p == 1:
        dj, stj = jft._tail_pool_bwd_p1(*map(jnp.asarray, (y, gs, gp, aff4)))
    else:
        dj, stj = jft._tail_pool_bwd_packed(
            jnp.asarray(_pack_rows(y, p)), jnp.asarray(_pack_rows(gs, p)),
            jnp.asarray(_pack_rows(gp, p // 2)), jnp.asarray(aff4), p, f)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj).reshape(b, h, w, f), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(stt.numpy(), np.asarray(stj)[:2], atol=1e-4, rtol=1e-5)
