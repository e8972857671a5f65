"""Per-block fused training against the JAX package: K9 (the sepconv with
its BatchNorm sums), K10 (the sepconv backward), the K8 block's composed
backward, the Flax ``ConvBlock(use_pallas=True)`` in train mode and a
BatchNorm-free U-Net train step.

JAX runs its Pallas kernels in interpret mode, as its own tests run them;
at C=3 no lane packing fits and JAX runs its XLA fallback, the same
function. The port runs the kernels' plain versions on the CPU. Inputs
come from ``np.random.RandomState``. fp32 unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (
    _batch,
    _cfg,
    _param_bar,
    _port_cfg,
    _port_params,
    _setup,
    _spy,
    _tree_np,
)
from unet_image_segmentation_tpu.models.layers import ConvBlock as JaxConvBlock
from unet_image_segmentation_tpu.models.unet import build_unet as build_unet_jax
from unet_image_segmentation_tpu.ops.pallas import fused_sepconv as jfs
from unet_image_segmentation_tpu.ops.pallas import fused_sepconv_bwd as jfsb
from unet_image_segmentation_tpu.train.state import create_train_state as create_state_jax
from unet_image_segmentation_tpu.train.steps import make_train_step as make_step_jax
from unet_image_segmentation_tpu_torch.models.layers import ConvBlock
from unet_image_segmentation_tpu_torch.ops import fused_sepconv as tfs
from unet_image_segmentation_tpu_torch.train.state import create_train_state
from unet_image_segmentation_tpu_torch.train.steps import make_train_step
from unet_image_segmentation_tpu_torch.weights import state_dict_from_flax

# (B, H, W, C, F): C=16, F=32 at W=32 packs 8 pixels a lane row in JAX;
# C=3 is the U-Net's input block, where JAX falls back to XLA
SHAPES = [pytest.param((2, 8, 32, 16, 32), id="packed"), pytest.param((2, 8, 16, 3, 16), id="c3")]
ACT_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, b, h, w, c, f):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(b, h, w, c).astype(np.float32),
        dw=(rng.randn(3, 3, c, 1) * 0.3).astype(np.float32),
        pw=(rng.randn(1, 1, c, f) * 0.1).astype(np.float32),
        bias=rng.randn(f).astype(np.float32),
        g=rng.randn(b, h, w, f).astype(np.float32),
        gs=rng.randn(f).astype(np.float32),
        gq=(0.1 * rng.randn(f)).astype(np.float32),
    )


def _grads_close(got, want, rtol=1e-4):
    """Gradients to rtol of each tensor, and to 1e-5 of its largest value."""
    for a, b in zip(got, want):
        b = np.asarray(b).reshape(np.shape(a))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5 * max(float(np.abs(b).max()), 1e-6))


def _torch_leaves(k, names):
    return [torch.from_numpy(k[n]).requires_grad_() for n in names]


@pytest.mark.parametrize("shape", SHAPES)
def test_sepconv_apply_stats_matches_jax(shape):
    """y, Σy, Σy², and the gradients of a loss that reads all three (the
    moments' cotangents fold into the output's)."""
    k = _inputs(sum(shape), *shape)

    def jloss(x, dw, pw):
        y, s, q = jfs.sepconv_apply_stats(x, dw, pw)
        obj = jnp.sum(y * k["g"]) + jnp.sum(s * k["gs"]) + jnp.sum(q * k["gq"])
        return obj, (y, s, q)

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(k[n]) for n in ("x", "dw", "pw")))
    leaves = _torch_leaves(k, ("x", "dw", "pw"))
    tfs.reset_launch_counts()
    got = tfs.sepconv_apply_stats(*leaves)
    obj = (got[0] * torch.from_numpy(k["g"])).sum() + (got[1] * torch.from_numpy(k["gs"])).sum() \
        + (got[2] * torch.from_numpy(k["gq"])).sum()
    obj.backward()
    assert sum(tfs.LAUNCHES.values()) == 0  # the CPU runs the plain K9/K10
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), **ACT_TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    _grads_close([t.grad.numpy() for t in leaves], jgrads)


@pytest.mark.parametrize("shape", SHAPES)
def test_sepconv_bwd_matches_jax(shape):
    """The plain K10 against ``sepconv_bwd_pallas``; at C=3, where no JAX
    kernel applies, against the VJP of JAX's composed sepconv."""
    k = _inputs(sum(shape) + 1, *shape)
    c, f = shape[3], shape[4]
    x, g = jnp.asarray(k["x"]), jnp.asarray(k["g"])
    dwk, pww = jnp.asarray(k["dw"].reshape(3, 3, c)), jnp.asarray(k["pw"].reshape(c, f))
    want = jfsb.sepconv_bwd_pallas(x, g, dwk, pww, interpret=True)
    if c == 3:
        assert want is None

        def ref(x, dwk, pww, shift):
            return jfs._xla_reference(x, dwk, pww, jnp.ones((f,), jnp.float32), shift, False)

        _, vjp = jax.vjp(ref, x, dwk, pww, jnp.zeros((f,), jnp.float32))
        want = vjp(g)
    got = tfs.sepconv_bwd(*(torch.from_numpy(a) for a in (
        k["x"], k["g"], k["dw"].reshape(3, 3, c), k["pw"].reshape(c, f))))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **ACT_TOL)
    _grads_close([t.numpy() for t in got[1:]], want[1:])


@pytest.mark.parametrize("shape", SHAPES)
def test_sepconv_apply_matches_jax(shape):
    """The plain sepconv with bias (K8 forward, K10 backward) and its
    gradients (cf. tests/test_pallas.py)."""
    k = _inputs(sum(shape) + 2, *shape)
    names = ("x", "dw", "pw", "bias")

    def jloss(*args):
        y = jfs.sepconv_apply(*args)
        return jnp.sum(y * k["g"]), y

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(k[n]) for n in names))
    leaves = _torch_leaves(k, names)
    got = tfs.sepconv_apply(*leaves)
    (got * torch.from_numpy(k["g"])).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ACT_TOL)
    _grads_close([t.grad.numpy() for t in leaves], jgrads)


def _block_pair(k, c, f, use_bn, dtype):
    """A port ConvBlock and the Flax one with the same numpy weights."""
    block = ConvBlock(c, f, use_batch_norm=use_bn, use_pallas=True)
    params = {"sepconv": {"depthwise_kernel": k["dw"], "pointwise_kernel": k["pw"]}}
    variables = {}
    rng = np.random.RandomState(c + f)
    if use_bn:
        bn = {"scale": (rng.rand(f) + 0.5).astype(np.float32),
              "bias": (0.1 * rng.randn(f)).astype(np.float32)}
        stats = {"mean": (0.1 * rng.randn(f)).astype(np.float32),
                 "var": (rng.rand(f) + 0.5).astype(np.float32)}
        params["bn"] = bn
        variables["batch_stats"] = {"bn": stats}
    else:
        params["sepconv"]["bias"] = k["bias"]
    variables["params"] = params
    sd = state_dict_from_flax(variables)
    block.load_state_dict({n: torch.from_numpy(np.asarray(v)) for n, v in sd.items()})
    jblock = JaxConvBlock(features=f, use_batch_norm=use_bn, dtype=dtype, use_pallas=True)
    return block, jblock, jax.tree_util.tree_map(jnp.asarray, variables)


def _run_blocks(k, c, f, use_bn, tdtype=torch.float32, jdtype=jnp.float32):
    """Train-mode forward, the gradient of sum(out * g) and the running
    statistics after the step, in both packages: ((out, grads, stats) x 2)."""
    block, jblock, variables = _block_pair(k, c, f, use_bn, jdtype)

    def jloss(params, x):
        out, mut = jblock.apply({**variables, "params": params}, x, train=True,
                                mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * k["g"]), (out, mut)

    (_, (jout, jmut)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(k["x"]))
    jgrads = state_dict_from_flax({"params": _tree_np(jgp)})
    jstats = state_dict_from_flax(_tree_np(jmut)) if use_bn else {}

    tfs.reset_launch_counts()
    x = torch.from_numpy(k["x"]).to(tdtype).requires_grad_()
    out = block(x, train=True)
    (out.float() * torch.from_numpy(k["g"])).sum().backward()
    assert sum(tfs.LAUNCHES.values()) == 0
    got_grads = {n: p.grad.numpy() for n, p in block.named_parameters()}
    got_stats = {n: b.numpy() for n, b in block.named_buffers()}
    assert set(got_grads) == set(jgrads) and set(got_stats) == set(jstats)
    return ((out.detach().float().numpy(), x.grad.float().numpy(), got_grads, got_stats),
            (np.asarray(jout, np.float32), np.asarray(jgx, np.float32), jgrads, jstats))


@pytest.mark.parametrize("use_bn", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_conv_block_train_matches_flax(shape, use_bn):
    """The per-block train forward (K9 + batch moments + BN + ReLU with BN;
    K8 with bias and ReLU without), its gradients and the running
    statistics against the Flax ConvBlock with ``use_pallas``."""
    k = _inputs(sum(shape) + 3, *shape)
    (out, gx, grads, stats), (jout, jgx, jgrads, jstats) = _run_blocks(
        k, shape[3], shape[4], use_bn)
    assert out.std() > 0.1
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=2e-5)
    _grads_close([gx] + [grads[n] for n in sorted(grads)],
                 [jgx] + [jgrads[n] for n in sorted(grads)], rtol=2e-4)
    for n, v in stats.items():
        np.testing.assert_allclose(v, jstats[n], rtol=1e-5, atol=1e-6, err_msg=n)


def test_conv_block_train_bf16_matches_flax():
    """bf16 with BatchNorm: both packages round the depthwise sum, y and dx
    to bf16 where the Pallas kernels do and cast ddw/dpw to bf16; sums run
    in other orders, so a bf16 value may round the other way. Bar: 2e-2 of
    each tensor's largest value (the card's bf16 kernel bar)."""
    k = _inputs(7, 2, 8, 32, 16, 32)
    (out, gx, grads, stats), (jout, jgx, jgrads, jstats) = _run_blocks(
        k, 16, 32, True, torch.bfloat16, jnp.bfloat16)
    pairs = [(out, jout), (gx, jgx)] + [(grads[n], jgrads[n]) for n in grads] + \
        [(stats[n], jstats[n]) for n in stats]
    for a, b in pairs:
        b = np.asarray(b, np.float32).reshape(a.shape)
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max()


def test_bn_off_unet_train_step_tracks_jax(monkeypatch):
    """A U-Net without BatchNorm trains block by block with ``use_pallas``
    (K8 forward, the composed backward) in both packages: one step from
    the same weights and batch, loss 1e-4, then the weights
    (:func:`_param_bar`)."""
    cfg = _cfg(use_pallas=True, dropout_rate=0.0, use_batch_norm=False)
    tmodel, variables = _setup(cfg, seed=4)
    assert "batch_stats" not in variables
    jmodel = build_unet_jax(cfg.model)
    jstate = create_state_jax(cfg, model=jmodel)
    jstate = jstate.replace(params=variables["params"],
                            opt_state=jstate.tx.init(variables["params"]))
    calls = _spy(monkeypatch, tfs, "sepconv_block")
    x, m = _batch(50)
    jstate, jmet = make_step_jax(jmodel, "dice", donate=False)(jstate, jnp.asarray(x),
                                                                jnp.asarray(m))
    state = create_train_state(_port_cfg(cfg), model=tmodel, device="cpu")
    met = make_train_step(tmodel, "dice")(state, torch.from_numpy(x), torch.from_numpy(m))
    assert len(calls) == 10  # every block of the (8, 16) U-Net, once
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-4)
    want = state_dict_from_flax(_tree_np({"params": jstate.params}))
    _param_bar(_port_params(tmodel), {k: v.numpy() for k, v in want.items()},
               cfg.train.learning_rate, 1)
