"""The port's training path against the JAX package's, U-Net filters (8, 16) at 32 px.

Both packages get the same numpy weights (through the bridge), inputs and
dropout seeds: the JAX seeds are recorded by wrapping ``seed_from_rng``
during an eager ``apply`` and handed to the port. Each package gets its own
``Config``, the port's converted from the JAX one through ``to_dict``. On
the CPU the port's fused chains, decoder feed and head run their kernels'
plain versions; the JAX ones run their Pallas kernels in interpret mode.
fp32 throughout.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_model import numpy_weights
from unet_image_segmentation_tpu.config import Config
from unet_image_segmentation_tpu.models.unet import build_unet as build_unet_jax
from unet_image_segmentation_tpu.ops import hash_dropout as jhd
from unet_image_segmentation_tpu.ops.pallas import fused_head as jfh
from unet_image_segmentation_tpu.train.state import create_train_state as create_state_jax
from unet_image_segmentation_tpu.train.steps import make_train_step as make_step_jax
from unet_image_segmentation_tpu_torch.config import Config as TorchConfig
from unet_image_segmentation_tpu_torch.inference import Predictor
from unet_image_segmentation_tpu_torch.models.unet import build_unet
from unet_image_segmentation_tpu_torch.ops import fused_head as tfh
from unet_image_segmentation_tpu_torch.train import checkpoint as ckpt
from unet_image_segmentation_tpu_torch.train.state import create_train_state, load_optax_adam_state
from unet_image_segmentation_tpu_torch.train.steps import make_predict_fn, make_train_step
from unet_image_segmentation_tpu_torch.weights import flax_from_state_dict, state_dict_from_flax

HW = 32
FWD_TOL = dict(rtol=0, atol=2e-5)   # the test_tf_parity.py bar


def _cfg(**model):
    kw = dict(image_height=HW, image_width=HW, filters=(8, 16), fused_head="off",
              dropout_impl="hash")
    kw.update(model)
    return Config().override(**{f"model__{k}": v for k, v in kw.items()},
                             train__batch_size=2)


def _port_cfg(cfg):
    """The port's own Config holding the same settings as a JAX Config."""
    return TorchConfig.from_dict(cfg.to_dict())


def _setup(cfg, seed=0):
    tmodel = build_unet(_port_cfg(cfg).model, device="cpu")
    sd = numpy_weights(tmodel, seed)
    tmodel.load_state_dict(sd)
    variables = jax.tree_util.tree_map(jnp.asarray, flax_from_state_dict(sd))
    return tmodel, variables


def _batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, HW, HW, 3).astype(np.float32)
    m = (rng.rand(2, HW, HW, 1) > 0.6).astype(np.float32)
    return x, m


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads_bar(got, want):
    """tests/test_fused_train.py's bar: atol 3e-3 * max(1, max|want|), rtol 2e-3."""
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, atol=3e-3 * scale, rtol=2e-3)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_forward_stats_and_grads_match_jax(use_pallas, dropout, monkeypatch):
    cfg = _cfg(use_pallas=use_pallas, dropout_rate=dropout)
    tmodel, variables = _setup(cfg)
    x, _ = _batch(3)
    jmodel = build_unet_jax(cfg.model)

    seeds = []
    record = jhd.seed_from_rng

    def recording(rng):
        s = record(rng)
        seeds.append(int(s))
        return s

    monkeypatch.setattr(jhd, "seed_from_rng", recording)

    def loss(params):
        out, mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(5)})
        return jnp.sum(out * out), (out, mut["batch_stats"])

    (_, (want, want_stats)), want_grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    # dropout sites: 0 after the bottleneck, then decoder stage 2 (none on dec1)
    assert len(seeds) == (2 if dropout else 0)
    site_seeds = {0: seeds[0], 2: seeds[1]} if dropout else None

    got = tmodel(torch.from_numpy(x), train=True, dropout_seeds=site_seeds)
    (got * got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    assert np.asarray(want).std() > 1e-2

    got_stats = flax_from_state_dict(dict(tmodel.named_buffers()))["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(got_stats),
                    jax.tree_util.tree_leaves(_tree_np(want_stats))):
        np.testing.assert_allclose(a, b, **FWD_TOL)
    got_grads = flax_from_state_dict({k: p.grad for k, p in tmodel.named_parameters()})["params"]
    leaves_t = jax.tree_util.tree_leaves(got_grads)
    leaves_j = jax.tree_util.tree_leaves(_tree_np(want_grads))
    assert len(leaves_t) == len(leaves_j) == 46
    for a, b in zip(leaves_t, leaves_j):
        _grads_bar(a, b)


def _param_bar(got: dict, want: dict, lr: float, steps: int) -> None:
    """Adam moves a parameter by about lr per step whatever its gradient's
    size, so a gradient near zero whose sign differs between the packages
    (summation-order noise) moves the two copies up to 2*lr apart per step.
    Bar: every parameter within 2*lr*steps + 1e-5, and 99.9% of all
    elements within 1e-5."""
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 2 * lr * steps + 1e-5, diffs.max()
    assert (diffs <= 1e-5).mean() >= 0.999, (diffs <= 1e-5).mean()


def _jax_state(cfg, variables):
    jmodel = build_unet_jax(cfg.model)
    state = create_state_jax(cfg, model=jmodel)
    params = variables["params"]
    return jmodel, state.replace(params=params, batch_stats=variables["batch_stats"],
                                 opt_state=state.tx.init(params))


def _port_params(tmodel):
    sd = {k: v.detach() for k, v in tmodel.state_dict().items()}
    return {k: v.numpy() for k, v in sd.items()}


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name``."""
    calls = []
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("fused_head", ["off", "auto"])
def test_three_train_steps_track_jax(fused_head, monkeypatch):
    """make_train_step with the fused chains (use_pallas, no dropout: the
    jitted JAX step derives its seeds inside), the fused decoder feed and,
    with ``fused_head='auto'``, the fused head in both packages, from the
    same weights and batches: loss per step within 1e-4 relative, then
    weights and BatchNorm statistics after step 3 (:func:`_param_bar`)."""
    cfg = _cfg(use_pallas=True, dropout_rate=0.0, fused_head=fused_head)
    tmodel, variables = _setup(cfg, seed=1)
    jmodel, jstate = _jax_state(cfg, variables)
    jcalls = _spy(monkeypatch, jfh, "head_fwd_sums")
    tcalls = _spy(monkeypatch, tfh, "head_fwd_sums")
    jstep = make_step_jax(jmodel, "dice", donate=False)
    state = create_train_state(_port_cfg(cfg), model=tmodel, device="cpu")
    step = make_train_step(tmodel, "dice")
    for i in range(3):
        x, m = _batch(10 + i)
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(m))
        met = step(state, torch.from_numpy(x), torch.from_numpy(m))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(met["dice"]), float(jmet["dice"]), rtol=1e-4)
        np.testing.assert_array_equal(met["cm_thresh"].numpy(), np.asarray(jmet["cm_thresh"]))
    assert state.step == 3
    # the head kernel ran in both packages exactly when it should
    assert (len(jcalls) > 0) == (len(tcalls) == 3) == (fused_head == "auto")
    want = state_dict_from_flax(_tree_np({"params": jstate.params,
                                          "batch_stats": jstate.batch_stats}))
    _param_bar(_port_params(tmodel), {k: v.numpy() for k, v in want.items()},
               cfg.train.learning_rate, 3)


def test_resume_from_optax_state_tracks_jax():
    """One JAX step, then the JAX train state (weights, BN statistics and
    optax's ScaleByAdamState) carried into the port; two more steps in
    each package agree."""
    cfg = _cfg(use_pallas=True, dropout_rate=0.0)
    _, variables = _setup(cfg, seed=2)
    jmodel, jstate = _jax_state(cfg, variables)
    jstep = make_step_jax(jmodel, "dice", donate=False)
    x, m = _batch(20)
    jstate, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(m))

    tmodel = build_unet(_port_cfg(cfg).model, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(_tree_np(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})))
    state = create_train_state(_port_cfg(cfg), model=tmodel, device="cpu")
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    load_optax_adam_state(state, int(adam.count), _tree_np(adam.mu), _tree_np(adam.nu))
    step = make_train_step(tmodel, "dice")
    for i in range(2):
        x, m = _batch(21 + i)
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(m))
        met = step(state, torch.from_numpy(x), torch.from_numpy(m))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-4)
    want = state_dict_from_flax(_tree_np({"params": jstate.params,
                                          "batch_stats": jstate.batch_stats}))
    _param_bar(_port_params(tmodel), {k: v.numpy() for k, v in want.items()},
               cfg.train.learning_rate, 2)


def test_fused_head_all_multiclass_needs_k11(monkeypatch):
    """'all' with a softmax head runs the multiclass head kernel K11 in both
    packages: three cce train steps of a 3-class model from the same
    weights and class-id batches track JAX (loss and dice 1e-4, the
    confusion matrix exact, then weights and BatchNorm statistics,
    :func:`_param_bar`). 'auto' keeps the composed multiclass sums."""
    cfg = _cfg(use_pallas=True, dropout_rate=0.0, fused_head="all", num_classes=3)
    tmodel, variables = _setup(cfg, seed=3)
    jmodel, jstate = _jax_state(cfg, variables)
    jcalls = _spy(monkeypatch, jfh, "head_fwd_sums_mc")
    tcalls = _spy(monkeypatch, tfh, "head_fwd_sums_mc")
    jstep = make_step_jax(jmodel, "cce", donate=False)
    state = create_train_state(_port_cfg(cfg), model=tmodel, device="cpu")
    step = make_train_step(tmodel, "cce")
    for i in range(3):
        x, _ = _batch(30 + i)
        m = np.random.RandomState(40 + i).randint(0, 3, (2, HW, HW, 1)).astype(np.float32)
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(m))
        met = step(state, torch.from_numpy(x), torch.from_numpy(m))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(met["dice"]), float(jmet["dice"]), rtol=1e-4)
        np.testing.assert_array_equal(met["cm_thresh"].numpy(), np.asarray(jmet["cm_thresh"]))
    assert len(jcalls) > 0 and len(tcalls) == 3
    want = state_dict_from_flax(_tree_np({"params": jstate.params,
                                          "batch_stats": jstate.batch_stats}))
    _param_bar(_port_params(tmodel), {k: v.numpy() for k, v in want.items()},
               cfg.train.learning_rate, 3)

    tmodel.fused_head = "auto"
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 3, (2, HW, HW, 1))).float()
    sums = tmodel(torch.from_numpy(_batch(4)[0]), train=True, head_targets=ids)
    assert set(sums) == set(tfh.MC_KEYS) and len(tcalls) == 3


def test_fused_head_auto_sums_equal_composed(monkeypatch):
    """The port's 'auto' (K5's plain version) and 'off' (the composed head)
    give the same sums, fp32, rtol 1e-5, and the same gradients."""
    cfg = _port_cfg(_cfg(use_pallas=True, dropout_rate=0.0, fused_head="auto"))
    x, m = _batch(4)
    out = {}
    for mode in ("auto", "off"):
        tmodel = build_unet(cfg.model, device="cpu", generator=torch.Generator().manual_seed(6))
        tmodel.fused_head = mode
        calls = _spy(monkeypatch, tfh, "head_fwd_sums")
        sums = tmodel(torch.from_numpy(x), train=True, head_targets=torch.from_numpy(m))
        assert len(calls) == (mode == "auto")
        assert set(sums) == set(tfh.SUM_KEYS)
        (sums["i"].sum() - 0.5 * sums["p"].sum()).backward()
        out[mode] = sums, {k: p.grad for k, p in tmodel.named_parameters()}
    (s_on, g_on), (s_off, g_off) = out["auto"], out["off"]
    for k in tfh.SUM_KEYS:
        np.testing.assert_allclose(s_on[k].detach().numpy(), s_off[k].detach().numpy(),
                                   rtol=1e-5, err_msg=k)
    assert s_on["p"].min() > 0 and s_on["t"].min() > 0
    for k, g in g_off.items():
        _grads_bar(g_on[k].numpy(), g.numpy())


def test_save_restore_state_roundtrip(tmp_path):
    cfg = _cfg(use_pallas=True, dropout_rate=0.2)
    state = create_train_state(_port_cfg(cfg), device="cpu")
    step = make_train_step(state.model, "dice")
    x, m = _batch(5)
    step(state, torch.from_numpy(x), torch.from_numpy(m))
    ckpt.save_state(str(tmp_path / "last"), state, meta={"epoch": 0})
    other = create_train_state(
        _port_cfg(_cfg(use_pallas=True, dropout_rate=0.2).override(train__seed=9)), device="cpu")
    ckpt.restore_state(str(tmp_path / "last"), other)
    assert other.step == 1 and ckpt.read_meta(str(tmp_path))["epoch"] == 0
    for (k, a), b in zip(state.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), k
    a = step(state, torch.from_numpy(x), torch.from_numpy(m))
    b = make_train_step(other.model, "dice")(other, torch.from_numpy(x), torch.from_numpy(m))
    assert float(a["loss"]) == float(b["loss"])  # same weights, moments and dropout seeds


def test_fit_one_epoch_writes_best_that_predictor_serves(tmp_path):
    from unet_image_segmentation_tpu.data.synthetic import write_synthetic_dataset
    from unet_image_segmentation_tpu_torch.train.loop import fit

    root = write_synthetic_dataset(str(tmp_path / "ds"), n_train=8, n_val=4,
                                   image_size=(HW, HW))
    cfg = _port_cfg(_cfg(use_pallas=True).override(
        train__epochs=1, train__batch_size=4, data__root=root,
        train__model_out=str(tmp_path / "model"), train__log_dir=str(tmp_path / "logs"),
        data__num_workers=1))
    res = fit(cfg, device="cpu", verbose=False)
    assert res.epochs_run == 1 and res.best_epoch == 0
    assert np.isfinite(res.history["loss"][0])
    meta = ckpt.read_meta(cfg.train.model_out)
    assert meta["epoch"] == 0 and meta["learning_rate"] == pytest.approx(2e-3)
    assert os.path.exists(os.path.join(cfg.train.model_out, "last", ckpt.STATE_FILE))
    pred = Predictor(cfg.train.model_out, (HW, HW), use_pallas=True, device="cpu")
    x = np.random.RandomState(0).rand(3, HW, HW, 3).astype(np.float32)
    out = pred.predict(x)
    assert out.shape == (3, HW, HW, 1) and np.isfinite(out).all()
    # best/ holds the trained model: the serving graph (plain K7) answers as
    # the trained module's eval forward (plain K8) does
    want = make_predict_fn(res.state.model)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)


def test_cli_train_main_cpu_returns_zero(tmp_path):
    from unet_image_segmentation_tpu.data.synthetic import write_synthetic_dataset
    from unet_image_segmentation_tpu_torch.cli import train as cli

    root = write_synthetic_dataset(str(tmp_path / "ds"), n_train=4, n_val=2,
                                   image_size=(HW, HW))
    rc = cli.main([
        "--epochs", "1", "--batch-size", "2", "--image-size", str(HW), "--data-root", root,
        "--model-out", str(tmp_path / "model"), "--log-dir", str(tmp_path / "logs"),
        "--set", "model__filters=[8,16]", "--pallas", "--device", "cpu",
    ])
    assert rc == 0
    with open(tmp_path / "model" / "best" / "model.json") as f:
        assert json.load(f)["filters"] == [8, 16]
