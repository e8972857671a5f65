"""The port's softmax head (K11 with the last decoder chain) against the JAX
package's ``fused_head_train``.

On the CPU the port's chain links and head run their kernels' plain
versions inside the same autograd Function the card runs; the JAX kernels
run in interpret mode, as the JAX package's own tests run them. Inputs come
from ``np.random.RandomState`` (the shapes of ``tests/test_fused_head.py``'s
multiclass cases). fp32 unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.ops.losses import loss_from_sums as jax_loss_from_sums
from unet_image_segmentation_tpu.ops.pallas import fused_head as jfh
from unet_image_segmentation_tpu_torch.models.unet import UNet
from unet_image_segmentation_tpu_torch.ops import fused_head as tfh
from unet_image_segmentation_tpu_torch.ops.kernels import build
from unet_image_segmentation_tpu_torch.ops.losses import loss_from_sums

SUMS_TOL = dict(rtol=1e-5, atol=1e-4)   # tests/test_fused_head.py's multiclass bar


def _case(seed, b, h, w, c0, f, nc, w_scale=0.2, tied=False):
    rng = np.random.RandomState(seed)
    blocks, c = [], c0
    for _ in range(2):
        blocks.append(((rng.randn(3, 3, c, 1) * 0.3).astype(np.float32),
                       (rng.randn(1, 1, c, f) * 0.1).astype(np.float32),
                       (rng.rand(f) + 0.5).astype(np.float32),
                       rng.randn(f).astype(np.float32)))
        c = f
    w_head = (rng.randn(1, 1, f, nc) * w_scale).astype(np.float32)
    b_head = rng.randn(nc).astype(np.float32)
    if tied:  # every class gets the same logit on every pixel
        w_head[...] = w_head[..., :1]
        b_head[:] = b_head[0]
    x = rng.rand(b, h, w, c0).astype(np.float32)
    t = rng.randint(0, nc, size=(b, h, w, 1)).astype(np.float32)
    return x, blocks, w_head, b_head, t


def _run_jax(x, blocks, w_head, b_head, t, loss_name, dtype=jnp.float32):
    def loss(x, blocks, wh, bh):
        out = jfh.fused_head_train(x.astype(dtype), blocks, wh, bh, jnp.asarray(t))
        assert out is not None, "the JAX multiclass head should be feasible here"
        sums, stats = out
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


def _hold_to_jax(port, jax_out, loss_rtol=1e-5):
    lt, st, mt, gt = port
    lj, sj, mj, gj = jax_out
    assert set(st) == set(sj) == set(tfh.MC_KEYS)
    for k in ("i", "p", "t", "cce"):
        np.testing.assert_allclose(st[k], sj[k], err_msg=k, **SUMS_TOL)
    np.testing.assert_array_equal(st["cm"], sj["cm"])   # counts: exact
    np.testing.assert_allclose(lt, lj, rtol=loss_rtol)
    for (m1, v1), (m2, v2) in zip(mt, mj):
        np.testing.assert_allclose(m1.numpy(), np.asarray(m2), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(v1.numpy(), np.asarray(v2), rtol=1e-3, atol=1e-5)
    assert len(gt) == len(gj) == 1 + 8 + 2
    for a, b in zip(gt, gj):
        scale = max(float(np.max(np.abs(b))), 1e-6)
        np.testing.assert_allclose(a, b.reshape(a.shape), rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("shape,nc,loss_name", [
    ((2, 16, 64, 32, 64), 3, "cce"),
    ((1, 8, 32, 16, 32), 4, "dice"),
])
def test_fused_head_mc_matches_jax(shape, nc, loss_name):
    """Sums (1e-5), the confusion matrix (exact), BatchNorm moments (1e-4)
    and every gradient (2e-4) of the loss, against JAX's K11."""
    x, blocks, w_head, b_head, t = _case(sum(shape) + nc, *shape, nc)
    tfh.reset_launch_counts()
    port = _run_port(x, blocks, w_head, b_head, t, loss_name)
    assert sum(tfh.LAUNCHES.values()) == 0  # the CPU runs the plain K11
    _hold_to_jax(port, _run_jax(x, blocks, w_head, b_head, t, loss_name))
    sums = port[1]
    assert sums["cm"].sum() == np.prod(shape[:3]) and (sums["cm"].sum(axis=1) > 0).all()


def test_fused_head_mc_tied_logits_take_the_first_class():
    """Identical head columns: every pixel's logits tie, the softmax is
    uniform and the argmax takes class 0 in both packages."""
    x, blocks, w_head, b_head, t = _case(11, 1, 8, 32, 16, 32, 3, tied=True)
    port = _run_port(x, blocks, w_head, b_head, t, "cce")
    _hold_to_jax(port, _run_jax(x, blocks, w_head, b_head, t, "cce"))
    cm = port[1]["cm"][0]
    assert cm[:, 1:].sum() == 0 and cm[:, 0].sum() == 8 * 32
    np.testing.assert_allclose(port[1]["p"], 8 * 32 / 3, rtol=1e-5)


def test_fused_head_mc_probabilities_below_the_clip():
    """Large head weights: the true class's probability falls below 1e-7 on
    many pixels, where the clipped CCE passes no gradient."""
    x, blocks, w_head, b_head, t = _case(12, 1, 8, 32, 16, 32, 3, w_scale=12.0)
    port = _run_port(x, blocks, w_head, b_head, t, "cce")
    # the mean CCE term against the clipped one, -log(1e-7): many pixels sit there
    clipped = port[1]["cce"][0] / (8 * 32) / -np.log(1e-7)
    assert clipped > 0.1, clipped
    _hold_to_jax(port, _run_jax(x, blocks, w_head, b_head, t, "cce"), loss_rtol=1e-5)


def test_fused_head_mc_bf16_rounding_point():
    """bf16: both packages round z, the logit and dl where the Pallas
    kernels do; the sums agree to bf16 noise, the counts to a few pixels."""
    x, blocks, w_head, b_head, t = _case(5, 1, 8, 64, 32, 64, 3)
    _, st, _, _ = _run_port(x, blocks, w_head, b_head, t, "cce", torch.bfloat16)
    _, sj, _, _ = _run_jax(x, blocks, w_head, b_head, t, "cce", jnp.bfloat16)
    for k in ("i", "p", "t", "cce"):
        np.testing.assert_allclose(st[k], sj[k], rtol=2e-3, err_msg=k)
    assert np.abs(st["cm"] - sj["cm"]).sum() <= 0.01 * 8 * 64


def _head_case(seed, nc, b=2, h=4, wd=6, f=8, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    y = torch.from_numpy((rng.randint(-4, 5, (b, h, wd, f)) * 0.25).astype(np.float32)).to(dtype)
    a = torch.from_numpy((1.0 + 0.5 * rng.randint(0, 3, f)).astype(np.float32))
    sh = torch.from_numpy((0.25 * rng.randint(-2, 3, f)).astype(np.float32))
    mean = torch.from_numpy((0.1 * rng.randn(f)).astype(np.float32))
    rstd = torch.from_numpy((1.0 + rng.rand(f)).astype(np.float32))
    w = torch.from_numpy((rng.randn(f, nc) * 0.5).astype(np.float32)).to(dtype).float()
    hb = torch.from_numpy((0.1 * rng.randn(nc)).astype(np.float32)).to(dtype).float()
    t = torch.from_numpy(rng.randint(0, nc, (b, h, wd)).astype(np.uint8))
    gsc = torch.from_numpy(rng.randn(b, 2 * nc + 1).astype(np.float32))
    return y, torch.stack([a, sh, mean, rstd]), w, hb, t, gsc


@pytest.mark.parametrize("nc", [2, 4])
def test_head_bwd_mc_is_autograd_of_head_and_masks_exact_zeros(nc):
    """The plain K11 backward equals autograd through the softmax head's
    differentiable sums (I, P, clipped CCE), on quarter-step inputs where
    ``a*y+b`` is exactly 0 on many pixels; the plain forward's sums equal
    the composed head's."""
    y, aff4, w, hb, t, gsc = _head_case(nc, nc)
    wl = y.float() * aff4[0] + aff4[1]
    assert (wl == 0).float().mean() > 0.05
    dzt, S, T, dw, db = tfh.head_bwd_mc(y, t, aff4, w, hb, gsc)
    assert (dzt[wl == 0] == 0).all() and dw.shape == (8, nc) and db.shape == (nc,)

    z = wl.clamp_min(0.0).requires_grad_()
    wr, hbr = w.clone().requires_grad_(), hb.clone().requires_grad_()
    p = torch.softmax(torch.matmul(z, wr) + hbr, dim=-1)
    t1 = torch.nn.functional.one_hot(t.long(), nc).float()
    cce = (-t1 * torch.log(p.clamp_min(tfh.CLIP_EPS))).sum(dim=(1, 2, 3))
    obj = (gsc[:, :nc] * (p * t1).sum(dim=(1, 2))).sum() + \
        (gsc[:, nc:2 * nc] * p.sum(dim=(1, 2))).sum() + (gsc[:, 2 * nc] * cce).sum()
    gz, gw, gb = torch.autograd.grad(obj, (z, wr, hbr))
    gz = torch.where(wl > 0, gz, torch.zeros_like(gz))
    np.testing.assert_allclose(dzt.numpy(), gz.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), gw.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), gb.numpy(), rtol=1e-5, atol=1e-6)
    yhat = (y.float() - aff4[2]) * aff4[3]
    np.testing.assert_allclose(S.numpy(), gz.sum(dim=(0, 1, 2)).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(T.numpy(), (gz * yhat).sum(dim=(0, 1, 2)).numpy(),
                               rtol=1e-5, atol=1e-6)
    sums = tfh.mc_sums_dict(tfh.head_fwd_sums_mc(y, t, aff4[:2].contiguous(), w, hb), nc)
    want = tfh.head_sums_reference_mc(p.detach(), t.float(), nc)
    for k in tfh.MC_KEYS:
        np.testing.assert_allclose(sums[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-5,
                                   err_msg=k)


def test_head_bwd_mc_bf16_rounds_dl_for_dzt_and_dw_only():
    """bf16: dzt and dw use dl rounded to bf16; db the unrounded dl."""
    nc = 3
    y, aff4, w, hb, t, gsc = _head_case(7, nc, dtype=torch.bfloat16)
    dzt, _, _, dw, db = tfh.head_bwd_mc(y, t, aff4, w, hb, gsc)
    assert dzt.dtype == torch.bfloat16
    wl = y.float() * aff4[0] + aff4[1]
    z = wl.clamp_min(0.0).to(torch.bfloat16).float()
    lf = torch.matmul(z, w).to(torch.bfloat16).float()
    p = torch.softmax((lf + hb).to(torch.bfloat16).float(), dim=-1)
    t1 = torch.nn.functional.one_hot(t.long(), nc).float()
    g = gsc[:, None, None, :]
    dy = g[..., :nc] * t1 + g[..., nc:2 * nc] - g[..., 2 * nc:] * t1 / p
    dl = p * (dy - (p * dy).sum(dim=-1, keepdim=True))
    dlb = dl.to(torch.bfloat16).float()
    np.testing.assert_allclose(db.numpy(), dl.sum(dim=(0, 1, 2)).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), torch.einsum("bhwf,bhwc->fc", z, dlb).numpy(),
                               rtol=1e-5, atol=1e-6)
    want = torch.where(wl > 0, torch.matmul(dlb, w.t()), torch.zeros_like(wl))
    np.testing.assert_allclose(dzt.float().numpy(), want.to(torch.bfloat16).float().numpy(),
                               rtol=1e-2, atol=1e-6)


def test_five_classes_take_the_composed_sums(monkeypatch):
    """More than 4 classes is outside K11: JAX's ``fused_head_train``
    returns None, the port's raises, and a U-Net with ``fused_head='all'``
    computes the composed sums, equal to 'off''s."""
    nc = tfh.MAX_MC_CLASSES + 1
    x, blocks, w_head, b_head, t = _case(3, 1, 8, 32, 16, 32, nc)
    assert jfh.fused_head_train(jnp.asarray(x), [tuple(map(jnp.asarray, b)) for b in blocks],
                                jnp.asarray(w_head), jnp.asarray(b_head), jnp.asarray(t)) is None
    assert not tfh.fused_head_feasible(32, torch.float32, nc)
    with pytest.raises(ValueError, match="no head kernel"):
        tfh.fused_head_train(torch.from_numpy(x),
                             [[torch.from_numpy(a) for a in b] for b in blocks],
                             torch.from_numpy(w_head), torch.from_numpy(b_head),
                             torch.from_numpy(t))

    calls = []
    real = tfh.fused_head_train
    monkeypatch.setattr("unet_image_segmentation_tpu_torch.models.unet.fused_head_train",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    img = torch.from_numpy(np.random.RandomState(4).rand(2, 16, 16, 3).astype(np.float32))
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, nc, (2, 16, 16, 1))).float()
    out = {}
    for mode in ("all", "off"):
        model = UNet(num_classes=nc, filters=(8, 16), dropout_rate=0.0, use_pallas=True,
                     fused_head=mode, generator=torch.Generator().manual_seed(8))
        out[mode] = model(img, train=True, head_targets=ids)
    assert not calls
    for k in tfh.MC_KEYS:
        assert torch.equal(out["all"][k], out["off"][k]), k
    assert out["all"]["cm"].shape == (2, nc, nc)


def _transposed_dots(z, w, v, lanes):
    """fp32 emulation of the card's K11 logit reduction for one group of
    ``lanes`` lanes and as many pixels (z (lanes, F), w (F, NC)): lane g
    sums the products of its chunk of V channels of each pixel in channel
    order, then McDot::node's tree, evaluated depth first, pairs the lanes
    by the xor bits lanes/2, ..., 1, each lane keeping the pixels whose bit
    matches its own. Returns (lanes, NC): row g the sum lane g holds, that
    of pixel g. Lanes past F/V hold zeros."""
    f, nc = w.shape
    g = f // v
    ids = np.arange(lanes)

    def leaf(i):
        d = np.zeros((lanes, nc), np.float32)
        for lane in range(g):
            for j in range(v):
                prod = (z[i, lane * v + j] * w[lane * v + j]).astype(np.float32)
                d[lane] = prod if j == 0 else (d[lane] + prod).astype(np.float32)
        return d

    def node(off, i):
        if off == lanes:
            return leaf(i)
        lo, hi = node(2 * off, i), node(2 * off, i + off)
        upper = (ids & off).astype(bool)[:, None]
        send, keep = np.where(upper, lo, hi), np.where(upper, hi, lo)
        return (keep + send[ids ^ off]).astype(np.float32)

    return node(1, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("nc", [2, 3, 4])
@pytest.mark.parametrize("chunks", [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 25, 32])
def test_transposed_group_dots_equal_the_butterfly_bit_for_bit(chunks, nc, dtype):
    """K11's kernels leave lane g of a group with pixel g's dots through a
    transposing reduction; the plain version (_group_dot) emulates an xor
    butterfly that leaves every lane with the whole sum. fp32 addition is
    commutative, so the two are equal bit for bit, for groups of 1 to 32
    lanes, narrower chunks counts than lanes (zero lanes) included, on data
    spread over many magnitudes so that any other order of the sums shows."""
    v = 16 // dtype.itemsize
    f = chunks * v
    lanes = 1
    while lanes < chunks:
        lanes *= 2
    rng = np.random.RandomState(chunks * 10 + nc)
    scale = 10.0 ** rng.uniform(-3, 3, (lanes, f))
    z = torch.from_numpy((rng.randn(lanes, f) * scale).astype(np.float32)).to(dtype).float()
    w = torch.from_numpy(rng.randn(f, nc).astype(np.float32)).to(dtype).float()
    want = tfh._group_dot(z, w, dtype).numpy()
    got = _transposed_dots(z.numpy(), w.numpy(), v, lanes)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if chunks > 1:   # the check can see an order: one sequential sum differs
        seq = np.zeros((lanes, nc), np.float32)
        zn, wn = z.numpy(), w.numpy()
        for j in range(f):
            seq = (seq + (zn[:, j:j + 1] * wn[j]).astype(np.float32)).astype(np.float32)
        assert (seq != want).any()


def _jax_head_kernels_mc(y, t, aff4, w, hb, gsc, p):
    """The JAX softmax head kernels (head_fwd_sums_mc, head_bwd_mc) at pack
    p on fp32 numpy inputs, their panels folded as _head_core's VJP folds
    them: ``(sums (B, 3NC+1+NC^2), dzt, S, T, dw (F, NC), db (NC,))``."""
    b, h, wd, f = y.shape
    nc = w.shape[1]
    y_p = jnp.asarray(y.reshape(b, h, wd // p, p * f))
    t_exp = jfh.expand_target_ids(jnp.asarray(t.astype(np.float32)), p)
    wsel, bvec = jfh._head_mats_mc(jnp.asarray(w), jnp.asarray(hb), p, f, nc, jnp.float32)
    aff4 = jnp.asarray(aff4)
    panel = np.asarray(jfh.head_fwd_sums_mc(y_p, t_exp, aff4[:2], wsel, bvec, p, nc))
    sums = panel[:, :tfh.mc_sum_count(nc), :].sum(axis=-1)
    g = np.zeros((b, jfh.N_ROWS_MC, jfh.COLS), np.float32)
    g[:, :2 * nc, :] = gsc[:, :2 * nc, None]
    g[:, 3 * nc, :] = gsc[:, 2 * nc, None]
    dzt, st, dw_panel, db_row = jfh.head_bwd_mc(y_p, t_exp, aff4, wsel, bvec, jnp.asarray(g),
                                                p, nc)
    st = np.asarray(st)[:2].reshape(2, p, f).sum(axis=1)
    dwp = np.asarray(dw_panel).reshape(nc, p, f, jfh.COLS)
    dw = np.stack([sum(dwp[c, j, :, j] for j in range(p)) for c in range(nc)], axis=-1)
    db = np.asarray(db_row)[:nc].sum(axis=-1)
    return sums, np.asarray(dzt).reshape(b, h, wd, f), st[0], st[1], dw, db


@pytest.mark.parametrize("b,h,wd,f,p,nc,tied", [
    pytest.param(2, 20, 32, 8, 16, 2, False, id="b2-20x32-f8-p16-nc2"),
    pytest.param(3, 4, 32, 24, 16, 3, True, id="b3-4x32-f24-p16-nc3-tied"),
    pytest.param(2, 4, 32, 40, 16, 4, False, id="b2-4x32-f40-p16-nc4"),
    pytest.param(3, 4, 16, 200, 16, 3, False, id="b3-4x16-f200-p16-nc3"),
    pytest.param(2, 20, 36, 128, 1, 4, True, id="b2-20x36-f128-p1-nc4-tied"),
    pytest.param(3, 4, 6, 256, 1, 2, False, id="b3-4x6-f256-p1-nc2"),
])
def test_head_mc_kernels_match_jax_at_ragged_widths(b, h, wd, f, p, nc, tied):
    """Plain K11 (forward sums and backward) against the JAX softmax head
    kernels in fp32 at the narrowest widths, widths off the powers of two,
    the widest, and ragged rows, on quarter-step inputs where a*y+b is
    exactly 0 on many values, with class ids of NC + 1 (in no class) on
    some pixels and, in the tied cases, classes 0 and 1 sharing their head
    column and bias: the sums to 1e-5 relative (the bar of
    test_fused_head_mc_matches_jax), the confusion matrix exactly, dzt to
    an fp32 rounding, S, T, dw and db as sums over B*H*W values."""
    y, aff4, w, hb, t, gsc = _head_case(b * 100 + f + nc, nc, b, h, wd, f)
    if tied:
        w[:, 1], hb[1] = w[:, 0], hb[0]
    t[:, ::3, ::5] = nc + 1
    assert ((y * aff4[0] + aff4[1]) == 0).float().mean() > 0.02
    sums = tfh.head_fwd_sums_mc(y, t, aff4[:2].contiguous(), w, hb)
    port = tfh.head_bwd_mc(y, t, aff4, w, hb, gsc)
    want = _jax_head_kernels_mc(y.numpy(), t.numpy(), aff4.numpy(), w.numpy(), hb.numpy(),
                                gsc.numpy(), p)
    cm0 = 3 * nc + 1
    np.testing.assert_allclose(sums[:, :cm0].numpy(), want[0][:, :cm0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sums[:, cm0:].numpy(), want[0][:, cm0:])
    assert sums[:, cm0:].sum() == b * h * wd - int((t > nc).sum())
    if tied:   # class 1 ties class 0 everywhere, and the first wins
        assert sums[:, cm0:].reshape(b, nc, nc)[:, :, 1].sum() == 0
    np.testing.assert_allclose(port[0].numpy(), want[1], rtol=1e-5, atol=1e-6)
    for got, ref in zip(port[1:], want[2:]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_k11_runs_on_the_streaming_body():
    """K11's kernels stream runs through stream_sums.cuh's ring and sum
    their CTAs' rows inside the launch (last_cta_sums): no second launch
    for the row sums, no grid sized for one card, and no workspace entry;
    their C entries take head_plan's (pixels, ctas, smem) and the arrival
    counter (test_c_entries_match_their_ctypes_signatures holds their rows)."""
    src = (build.CSRC / "head_mc.cu").read_text()
    assert "stream_units(" in src and "last_cta_sums(" in src
    for gone in ("reduce_rows", "blocks_per_sample", "528", "unet_head_mc_workspace"):
        assert gone not in src, gone
    assert "reduce_rows" not in (build.CSRC / "head.cu").read_text()
    assert not any("head_mc" in name for name in build.WORKSPACE_SIGNATURES)
