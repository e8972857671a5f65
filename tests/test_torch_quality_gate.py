"""The port's binary 256 px quality gate (``troubleshoot/quality_gate_256.py``)
and the modules it ports, against the JAX package's, on the CPU.

* the scene renderer's copy draws the original's bits, and the port's pack
  writers write the JAX package's bytes;
* at the gate's full size the data stage's packs have the pinned digests,
  and so do the JAX package's own ``write_synthetic_dataset(style='hard')``
  + ``pack_directory_dataset``; the gate's packed batches are the ones the
  JAX gate trained on (its ``make_loaders`` through its ``fit``'s
  autopack);
* the torch stage at 32 px (filters (8, 16); the kernels' plain versions)
  runs its seeds, refuses changed inputs, and the report takes its setup
  from the stamp;
* one seed from JAX's initial weights against JAX ``fit`` +
  ``make_predict_fn`` on the same data: per-epoch training loss within 1e-4
  relative, val IoU within 1e-3 absolute, fp32. The JAX side runs its fused
  chains' reference, the composed XLA path (its Pallas kernels in interpret
  mode take ~90 s for these 8 steps on the CPU; the JAX package's own tests hold
  the chains to that path).
"""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("cv2")

from unet_image_segmentation_tpu_torch.troubleshoot import quality_gate_256 as q  # noqa: E402

SMALL = q.Protocol(image_size=32, n_train=8, n_val=8, epochs=2, seeds=(2301, 7))
SMALL_MODEL = {"model__filters": [8, 16]}
LOSS_RTOL = 1e-4
IOU_ATOL = 1e-3
BN_STATS_TOL = 2e-5   # of each statistic's max |value|; measured 2.9e-6 (bneck_block1's mean)


@pytest.fixture(scope="module")
def gate_dir(tmp_path_factory):
    """The data stage at the gate's protocol."""
    workdir = str(tmp_path_factory.mktemp("q256"))
    q.stage_data(workdir)
    return workdir


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("q32"))
    q.stage_data(workdir, protocol=SMALL)
    return workdir


@pytest.fixture(scope="module")
def small_results(small_dir):
    """Both legs of the torch stage at 32 px, kernels (plain versions) and composed."""
    kernels = q.stage_torch(small_dir, device="cpu", protocol=SMALL, overrides=SMALL_MODEL,
                            verbose=False)
    composed = q.stage_torch(small_dir, device="cpu", composed=True, protocol=SMALL,
                             overrides=SMALL_MODEL, verbose=False)
    return kernels, composed


@pytest.mark.parametrize("style", ["easy", "hard"])
@pytest.mark.parametrize("seed", [0, 230, 2301])
def test_synthetic_copy_renders_the_originals_bits(seed, style):
    from unet_image_segmentation_tpu.data import synthetic as theirs
    from unet_image_segmentation_tpu_torch.data import synthetic as mine

    name = "render_sample_hard" if style == "hard" else "render_sample"
    for h, w in ((48, 40), (256, 256)):
        got = getattr(mine, name)(np.random.RandomState(seed), h, w)
        want = getattr(theirs, name)(np.random.RandomState(seed), h, w)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mask_mode", ["binary", "class_id"])
def test_pack_writers_write_the_jax_bytes(tmp_path, mask_mode):
    from unet_image_segmentation_tpu.data import packed as jax_packed
    from unet_image_segmentation_tpu.data.loader import DirectoryDataset as JaxDirectoryDataset
    from unet_image_segmentation_tpu.data.synthetic import (
        write_synthetic_dataset,
        write_synthetic_multiclass_dataset,
    )
    from unet_image_segmentation_tpu_torch.data import packed
    from unet_image_segmentation_tpu_torch.data.loader import DirectoryDataset

    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (5, 12, 10, 3)).astype(np.uint8)
    masks = rng.randint(0, 4 if mask_mode == "class_id" else 256, (5, 12, 10, 1)).astype(np.uint8)
    class_id = mask_mode == "class_id"
    packed.write_pack(str(tmp_path / "mine.upk"), images, masks, class_id)
    jax_packed.write_pack(str(tmp_path / "theirs.upk"), images, masks, class_id)
    assert (tmp_path / "mine.upk").read_bytes() == (tmp_path / "theirs.upk").read_bytes()

    write = write_synthetic_multiclass_dataset if class_id else write_synthetic_dataset
    root = write(str(tmp_path / "ds"), n_train=4, n_val=2, image_size=(24, 20), style="hard")
    kw = dict(frames_dir=os.path.join(root, "train_frames", "image"),
              masks_dir=os.path.join(root, "train_masks", "image"), image_size=(16, 16),
              shuffle=False, mask_mode=mask_mode)
    packed.pack_directory_dataset(DirectoryDataset(**kw), str(tmp_path / "dir_mine.upk"))
    jax_packed.pack_directory_dataset(JaxDirectoryDataset(**kw), str(tmp_path / "dir_theirs.upk"))
    mine = (tmp_path / "dir_mine.upk").read_bytes()
    assert mine == (tmp_path / "dir_theirs.upk").read_bytes()
    assert len(mine) == 64 + 4 * 16 * 16 * 4


def test_gate_packs_have_the_pinned_digests(gate_dir, tmp_path):
    """The data stage's packs, and the JAX package's own data path on the
    same parameters, give :data:`SCENE_SHA256`: 64 + 128 records of
    256x256x3 + 256x256x1 bytes."""
    from unet_image_segmentation_tpu.data.loader import DirectoryDataset
    from unet_image_segmentation_tpu.data.packed import pack_directory_dataset
    from unet_image_segmentation_tpu.data.synthetic import write_synthetic_dataset

    stamp = q.check_inputs(gate_dir)
    assert stamp["sha256"] == q.SCENE_SHA256
    assert stamp["records"] == {"train": [64, 256, 256, 3, 1], "val": [128, 256, 256, 3, 1]}
    assert stamp["protocol"] == {"image_size": 256, "batch": 2, "n_train": 64, "n_val": 128,
                                 "epochs": 24, "seeds": [2301, 7, 23, 42], "data_seed": 230}
    sizes = sum(os.path.getsize(q.pack_path(gate_dir, s)) for s in q.SPLITS)
    assert sizes == 2 * 64 + 192 * 256 * 256 * 4   # 50.3 MB

    root = write_synthetic_dataset(str(tmp_path / "ds"), n_train=64, n_val=128,
                                   image_size=(256, 256), style="hard")
    for split in q.SPLITS:
        ds = DirectoryDataset(frames_dir=os.path.join(root, f"{split}_frames", "image"),
                              masks_dir=os.path.join(root, f"{split}_masks", "image"),
                              image_size=(256, 256), shuffle=False)
        path = str(tmp_path / f"{split}.upk")
        pack_directory_dataset(ds, path)
        assert q.sha256_file(path) == q.SCENE_SHA256[split], split


def test_packed_batches_are_the_jax_gates_batches(gate_dir, tmp_path, seed=2301):
    """The gate's datasets pass ``fit``'s autopack unchanged and serve, for
    epochs 0 and 1, the batches the JAX gate's ``fit`` trained and validated
    on: JAX ``make_loaders`` on the scene directory, through its autopack
    (the pack-through first epoch, then its pack)."""
    from unet_image_segmentation_tpu.config import Config as JaxConfig
    from unet_image_segmentation_tpu.data.autopack import maybe_autopack as jax_autopack
    from unet_image_segmentation_tpu.data.loader import make_loaders as jax_loaders
    from unet_image_segmentation_tpu.troubleshoot import quality_gate_256 as jq
    from unet_image_segmentation_tpu_torch.data.autopack import maybe_autopack

    cfg = q.gate_config(q.GATE_PROTOCOL, seed, str(tmp_path))
    assert cfg.data.auto_pack
    mine = q.gate_datasets(gate_dir, cfg)
    jcfg = JaxConfig.from_dict(cfg.to_dict()).override(
        data__root=os.path.join(gate_dir, "ds"), data__pack_dir=str(tmp_path / "pack"))
    theirs = [jax_autopack(ds, pack_dir=jcfg.data.pack_dir, verbose=False)
              for ds in jax_loaders(jcfg)]
    for ds, jds in zip(mine, theirs):
        assert maybe_autopack(ds, pack_dir=str(tmp_path / "mine"), verbose=False) is ds
        assert len(ds) == len(jds)
        for epoch in (0, 1):
            got = list(ds.batches(cfg.train.batch_size, epoch=epoch,
                                  steps=len(ds) // cfg.train.batch_size, num_workers=1))
            want = list(jds.batches(cfg.train.batch_size, epoch=epoch,
                                    steps=len(jds) // cfg.train.batch_size, num_workers=1))
            assert len(got) == len(want) == len(ds) // 2
            for (gi, gm), (wi, wm) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gm, wm)
        assert jds.packed_active
    # the predict inputs: the JAX gate's _load_arrays' val split
    xva, yva = q.split_arrays(gate_dir, "val")
    _, (jxva, jyva) = jq._load_arrays(os.path.join(gate_dir, "ds"))
    np.testing.assert_array_equal(xva, jxva)
    np.testing.assert_array_equal(yva, jyva)


def test_thresholded_iou_equals_jax():
    from unet_image_segmentation_tpu.troubleshoot.quality_gate_256 import _thresholded_iou

    rng = np.random.RandomState(7)
    for _ in range(5):
        t = (rng.rand(4, 16, 16, 1) > 0.6).astype(np.float32)
        p = rng.rand(4, 16, 16, 1).astype(np.float32)
        assert q._thresholded_iou(t, p) == _thresholded_iou(t, p)
        assert q._thresholded_iou(t, p, 0.3) == _thresholded_iou(t, p, 0.3)
    assert q._thresholded_iou(np.zeros(4), np.zeros(4)) == _thresholded_iou(np.zeros(4),
                                                                           np.zeros(4)) == 1.0


@pytest.mark.parametrize("leg", [0, 1], ids=["kernels", "composed"])
def test_torch_stage_runs_every_seed_on_the_cpu(small_dir, small_results, leg):
    res = small_results[leg]
    stamp = q.check_inputs(small_dir, SMALL)
    assert res["sha256"] == stamp["sha256"] and res["protocol"] == SMALL.to_dict()
    assert res["device"] == "cpu" and res["card"] is None and res["overrides"] == SMALL_MODEL
    assert res["leg"] == ("composed" if leg else "kernels")
    with open(os.path.join(small_dir, q.RESULTS[bool(leg)])) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert list(res["seeds"]) == ["2301", "7"]
    for rec in res["seeds"].values():
        assert rec["epochs"] == 2 and rec["steps"] == 8
        assert 0.0 <= rec["val_iou"] <= 1.0 and 0.0 <= rec["val_iou_bn_recalibrated"] <= 1.0
        assert len(rec["val_mean_io_u_per_epoch"]) == len(rec["loss_per_epoch"]) == 2
        assert len(rec["epoch_seconds"]) == 2
        assert all(np.isfinite(rec["loss_per_epoch"]))
        # the CPU runs the kernels' plain versions: no launch counted
        assert not any(rec["launches_per_step"].values())
        assert rec["launches_per_val_forward"] == 0
        assert rec["launches_first_predict"] == {"sepconv_block": 0}
    # one seed, other weights: the two seeds trained apart
    assert res["seeds"]["2301"]["loss_per_epoch"] != res["seeds"]["7"]["loss_per_epoch"]


def test_report_takes_its_setup_from_the_stamp(small_dir, small_results, tmp_path):
    out = str(tmp_path / "QUALITY_256_TORCH.json")
    art = q.stage_report(small_dir, out)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(art))
    with open(os.path.join(small_dir, q.STAMP)) as f:
        stamp = json.load(f)
    setup = art["setup"]
    assert (setup["image_size"], setup["n_train"], setup["n_val"], setup["epochs"],
            setup["batch"]) == (32, 8, 8, 2, 2)
    assert setup["bn_updates"] == 8 and setup["seeds"] == [2301, 7]
    assert setup["sha256"] == stamp["sha256"] and setup["scene_style"] == stamp["style"] == "hard"
    assert setup["cv2"] == stamp["cv2"] and setup["records"] == stamp["records"]
    assert setup["overrides"] == SMALL_MODEL and "not run" in setup["tf_leg"]
    with open(q.REFERENCE) as f:
        ref = json.load(f)
    jax_iou = dict(zip(ref["setup"]["seeds"], ref["val_iou_jax_per_seed"]))
    assert art["seeds"] == [7, 2301]   # the JAX record's order
    ious = [small_results[0]["seeds"][str(s)]["val_iou"] for s in (7, 2301)]
    assert art["val_iou_torch_per_seed"] == ious
    assert art["val_iou_bn_recalibrated_per_seed"] == [
        small_results[0]["seeds"][str(s)]["val_iou_bn_recalibrated"] for s in (7, 2301)]
    assert art["val_iou_jax_per_seed"] == [jax_iou[7], jax_iou[2301]]
    assert art["delta_per_seed"] == [ious[0] - jax_iou[7], ious[1] - jax_iou[2301]]
    assert art["within_gate"] == (np.mean(ious) >= ref["val_iou_jax_mean"] - 0.005)
    assert art["composed"]["seeds"] == [7, 2301]
    # results of other packs are refused
    other = str(tmp_path / "w")
    shutil.copytree(small_dir, other)
    with open(os.path.join(other, q.STAMP), "w") as f:
        json.dump({**stamp, "sha256": {**stamp["sha256"], "val": "0" * 64}}, f)
    with pytest.raises(ValueError, match="other packs"):
        q.stage_report(other, out)


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 1]))


@pytest.mark.parametrize("change", ["pack byte", "stamp epochs", "protocol", "scenes", "no card"])
def test_torch_stage_refuses_changed_inputs(small_dir, gate_dir, tmp_path, change):
    workdir = str(tmp_path / "w")
    if change == "scenes":
        # a changed byte in a pack of the gate's scenes, the stamp made to match
        shutil.copytree(gate_dir, workdir, ignore=shutil.ignore_patterns("ds"))
        _flip_byte(q.pack_path(workdir, "val"), 64 + 5000)
        stamp = q.write_stamp(workdir, q.GATE_PROTOCOL, "hard", "any")
        assert stamp["sha256"]["val"] != q.SCENE_SHA256["val"]
        with pytest.raises(ValueError, match="not the gate's scenes"):
            q.stage_torch(workdir, device="cpu")
        return
    shutil.copytree(small_dir, workdir, ignore=shutil.ignore_patterns(
        "ds", "kernels", "composed", "torch_results*.json"))
    q.check_inputs(workdir, SMALL)
    if change == "pack byte":
        _flip_byte(q.pack_path(workdir, "train"), 64 + 123)
        match, protocol = "is not the stamp's", SMALL
    elif change == "stamp epochs":
        with open(os.path.join(workdir, q.STAMP)) as f:
            stamp = json.load(f)
        stamp["protocol"]["epochs"] = 3
        with open(os.path.join(workdir, q.STAMP), "w") as f:
            json.dump(stamp, f)
        match, protocol = "protocol", SMALL
    elif change == "protocol":
        match, protocol = "protocol", q.GATE_PROTOCOL
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            q.stage_torch(workdir, protocol=SMALL, overrides=SMALL_MODEL)
        return
    with pytest.raises(ValueError, match=match):
        q.stage_torch(workdir, device="cpu", protocol=protocol, overrides=SMALL_MODEL,
                      verbose=False)
    assert not os.path.exists(os.path.join(workdir, q.RESULTS[False]))


def test_one_seed_tracks_jax_fit(small_dir, tmp_path):
    """The gate's seed run from JAX's initial weights (carried through
    ``weights.py``) against JAX ``fit`` + ``make_predict_fn`` on the same
    scenes and batches: per-epoch loss within 1e-4 relative, val IoU within
    1e-3 absolute, and every BatchNorm's final running mean and variance
    within 2e-5 of the largest |value| of JAX's ``batch_stats``, fp32."""
    import jax
    import jax.numpy as jnp

    from unet_image_segmentation_tpu.config import Config as JaxConfig
    from unet_image_segmentation_tpu.models.unet import build_unet as jax_build_unet
    from unet_image_segmentation_tpu.parallel.mesh import create_mesh
    from unet_image_segmentation_tpu.train import callbacks as jcb
    from unet_image_segmentation_tpu.train.loop import fit as jax_fit
    from unet_image_segmentation_tpu.train.state import make_root_key, state_from_variables
    from unet_image_segmentation_tpu.train.steps import make_predict_fn as jax_predict_fn
    from unet_image_segmentation_tpu.troubleshoot import quality_gate_256 as jq
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.train.state import create_train_state
    from unet_image_segmentation_tpu_torch.weights import state_dict_from_flax

    seed = SMALL.seeds[1]
    cfg = q.gate_config(SMALL, seed, str(tmp_path / "torch"), overrides=SMALL_MODEL)
    jcfg = JaxConfig.from_dict(cfg.to_dict()).override(
        model__use_pallas=False, data__root=os.path.join(small_dir, "ds"),
        data__pack_dir=str(tmp_path / "pack"), data__num_workers=1,
        train__model_out=str(tmp_path / "jax" / "model"), train__log_dir=str(tmp_path / "jax"))
    # JAX's initial weights, as its create_train_state draws them (jitted)
    jmodel = jax_build_unet(jcfg.model)
    params_rng, _ = jax.random.split(make_root_key(jcfg))
    dummy = jnp.zeros((1, *jcfg.model.input_shape), jnp.float32)
    variables = jax.jit(lambda r: jmodel.init({"params": r}, dummy, train=False))(params_rng)
    jstate = state_from_variables(jcfg, variables, jmodel)

    model = build_unet(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    state = create_train_state(cfg, model=model, device="cpu")
    xva, yva = q.split_arrays(small_dir, "val")
    rec = q.run_seed(cfg, small_dir, "cpu", xva, yva, state=state, verbose=False)

    tcfg = jcfg.train
    callbacks = [   # fit's own but the checkpoint and TensorBoard writers
        jcb.EarlyStopping(monitor=tcfg.monitor, mode=tcfg.monitor_mode,
                          patience=tcfg.early_stop_patience, verbose=False),
        jcb.ReduceLROnPlateau(monitor=tcfg.monitor, mode=tcfg.monitor_mode,
                              factor=tcfg.reduce_lr_factor, patience=tcfg.reduce_lr_patience,
                              min_lr=tcfg.min_lr, verbose=False),
    ]
    res = jax_fit(jcfg, state=jstate, callbacks=callbacks, verbose=False,
                  mesh=create_mesh(data=1, devices=jax.devices()[:1]))
    _, (jxva, jyva) = jq._load_arrays(os.path.join(small_dir, "ds"))
    predict = jax_predict_fn(jmodel, res.state.params, res.state.batch_stats)
    preds = np.concatenate([np.asarray(predict(jxva[i:i + 8])) for i in range(0, len(jxva), 8)])
    want_iou = jq._thresholded_iou(jyva, preds)

    assert rec["steps"] == int(res.state.step) == int(state.step) == 8
    np.testing.assert_allclose(rec["loss_per_epoch"], res.history["loss"], rtol=LOSS_RTOL)
    assert abs(rec["val_iou"] - want_iou) <= IOU_ATOL, (rec["val_iou"], want_iou)
    assert rec["loss_per_epoch"][1] < rec["loss_per_epoch"][0]   # it trains
    # the running statistics the gate's final weights are scored with
    want_stats = state_dict_from_flax(
        {"batch_stats": jax.tree_util.tree_map(np.asarray, res.state.batch_stats)})
    got = state.model.state_dict()
    assert len(want_stats) == 2 * 10   # 10 BatchNorms at filters (8, 16)
    errs = {k: float((got[k] - v).abs().max() / v.abs().max()) for k, v in want_stats.items()}
    assert max(errs.values()) <= BN_STATS_TOL, max(errs.items(), key=lambda kv: kv[1])
    assert all(float(got[k].abs().max()) > 0 for k in want_stats if k.endswith(".mean"))


# --products: the composed leg at another product precision (troubleshoot/products.py)

PRODUCT_RTOL = 1e-6   # of each product's max |fp64 value|


def _close(got, want, rtol=PRODUCT_RTOL):
    err = (got.double() - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), (err, want.abs().max().item())


def _products_model():
    import torch

    from unet_image_segmentation_tpu_torch.models.unet import UNet

    model = UNet(filters=(8, 16), dropout_rate=0.0, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    model.train()
    return model


def test_bf16x1_products_are_exact_products_of_rounded_operands():
    """Every MXU-type product of a 32 px composed model's training forward
    goes through the bf16x1 matmul; each one, forward and both gradient
    products (a seeded cotangent), equals the fp64 product of its operands
    rounded to bf16 within 1e-6 of its max |value|, which the unrounded
    operands' product misses; a full conv2d likewise."""
    import torch

    from unet_image_segmentation_tpu_torch.ops import conv as conv_ops
    from unet_image_segmentation_tpu_torch.troubleshoot import products as pr

    model = _products_model()
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    seen = []
    with pr.product_precision("bf16x1"):
        wrapped = conv_ops.torch.matmul
        assert wrapped is pr.bf16x1_matmul

        def record(a, b):
            seen.append((a.detach().clone(), b.detach().clone()))
            return wrapped(a, b)

        conv_ops.torch.matmul = record   # a name of the context's view, gone with it
        model(x, train=True).sum().backward()
    assert conv_ops.torch is torch and conv_ops.F is torch.nn.functional
    # 10 ConvBlocks (the decoder's on the stored concat), 2 transpose-ups, the head
    assert len(seen) == 13
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    gen = torch.Generator().manual_seed(2)
    r = pr.bf16_round
    missed = 0
    for a, b in seen:
        a, b = a.requires_grad_(), b.requires_grad_()
        y = pr.bf16x1_matmul(a, b)
        g = torch.randn(y.shape, generator=gen)
        y.backward(g)
        a64, b64, g64 = r(a.detach()).double(), r(b.detach()).double(), r(g).double()
        want = a64 @ b64
        _close(y, want)
        _close(a.grad, g64 @ b64.T)
        _close(b.grad, a64.reshape(-1, a.shape[-1]).T @ g64.reshape(-1, b.shape[-1]))
        exact = a.detach().double() @ b.detach().double()
        missed += (exact - want).abs().max().item() > PRODUCT_RTOL * want.abs().max().item()
    assert missed == len(seen)
    # a full 3x3 conv (conv_type 'full'), against fp64 autograd on the rounded operands
    xc = torch.rand(2, 9, 7, 5, generator=gen).requires_grad_()
    k = (torch.rand(3, 3, 5, 6, generator=gen) - 0.5).requires_grad_()
    with pr.product_precision("bf16x1"):
        y = conv_ops.conv2d(xc, k)
    g = torch.randn(y.shape, generator=gen)
    y.backward(g)
    x64, k64 = r(xc.detach()).double().requires_grad_(), r(k.detach()).double().requires_grad_()
    y64 = conv_ops.conv2d(x64, k64)
    y64.backward(r(g).double())
    _close(y, y64.detach())
    _close(xc.grad, x64.grad)
    _close(k.grad, k64.grad)


def test_bf16x1_leaves_the_depthwise_unrounded():
    import torch

    from unet_image_segmentation_tpu_torch.ops import conv as conv_ops
    from unet_image_segmentation_tpu_torch.troubleshoot import products as pr

    gen = torch.Generator().manual_seed(3)
    x = torch.rand(2, 8, 8, 5, generator=gen)
    k = torch.rand(3, 3, 5, 1, generator=gen)
    w = torch.rand(5, 7, generator=gen)
    want, pw = conv_ops.depthwise_conv2d(x, k), conv_ops.pointwise_conv2d(x, w)
    with pr.product_precision("bf16x1"):
        got, pw_rounded = conv_ops.depthwise_conv2d(x, k), conv_ops.pointwise_conv2d(x, w)
    assert torch.equal(got, want)
    assert not torch.equal(pw_rounded, pw)


def test_products_fp32_is_the_gates_own_stage(small_dir, small_results):
    """``--products fp32`` touches nothing, and the kernel leg's stage gives
    today's numbers bit for bit (all but the clocks)."""
    import torch

    from unet_image_segmentation_tpu_torch.ops import conv as conv_ops
    from unet_image_segmentation_tpu_torch.troubleshoot import products as pr

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with pr.product_precision("fp32"):
        assert conv_ops.torch is torch and conv_ops.F is torch.nn.functional
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    res = q.stage_torch(small_dir, device="cpu", protocol=SMALL, overrides=SMALL_MODEL,
                        verbose=False, products="fp32", seeds=(2301,),
                        out_name="torch_results_fp32.json")
    clocks = {"seconds", "fit_seconds", "epoch_seconds", "step_mean_ms_per_epoch"}
    want = small_results[0]
    assert res["path"] == want["path"] and res["products"] == "fp32"
    assert list(res["seeds"]) == ["2301"]
    assert {k: v for k, v in res["seeds"]["2301"].items() if k not in clocks} == \
        {k: v for k, v in want["seeds"]["2301"].items() if k not in clocks}


@pytest.mark.parametrize("products", ["tf32", "bf16x1"])
def test_products_other_than_fp32_need_the_composed_leg(small_dir, tmp_path, capsys, products):
    from unet_image_segmentation_tpu_torch.troubleshoot import quality_gate_512mc as mc

    with pytest.raises(ValueError, match="composed leg only"):
        q.stage_torch(small_dir, device="cpu", protocol=SMALL, overrides=SMALL_MODEL,
                      verbose=False, products=products)
    for main in (q.main, mc.main):
        with pytest.raises(SystemExit):
            main(["--workdir", str(tmp_path), "--stage", "torch", "--products", products])
        assert "add --composed" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("case,verdict", [
    ({"kernels": False, "composed_fp32": False, "composed_tf32": False,
      "composed_bf16x1": True}, "reference property"),
    ({"kernels": False, "composed_fp32": False, "composed_tf32": False,
      "composed_bf16x1": False}, "open"),
    ({"kernels": False, "composed_fp32": True, "composed_tf32": False,
      "composed_bf16x1": True}, "kernels at fault"),
    ({"kernels": True, "composed_fp32": True, "composed_tf32": True,
      "composed_bf16x1": True}, "other"),
])
def test_products_verdict_applies_the_rule(case, verdict):
    assert q.products_verdict(case).startswith(verdict)


def test_products_legs_write_their_own_files_and_report(small_dir, small_results, tmp_path):
    """The composed leg at bf16x1 (a protocol seed and one extra) lands in
    files of its own, never the gate's (so would tf32's); the products
    report reads them beside a kernel leg's seeds file and applies the
    rule."""
    workdir = str(tmp_path / "w")
    shutil.copytree(small_dir, workdir, ignore=shutil.ignore_patterns(
        "ds", "kernels", "composed", "torch_results*.json"))
    res = q.stage_torch(workdir, device="cpu", composed=True, protocol=SMALL,
                        overrides=SMALL_MODEL, verbose=False, products="bf16x1", extra=1,
                        seeds=(2301,))
    assert res["products"] == "bf16x1" and res["leg"] == "composed"
    assert sorted(n for n in os.listdir(workdir) if n.startswith("torch_results")) == [
        "torch_results_composed_bf16x1.json", "torch_results_extra_composed_bf16x1.json"]
    assert [q.results_name(True, "tf32", extra) for extra in (False, True)] == [
        "torch_results_composed_tf32.json", "torch_results_extra_composed_tf32.json"]
    assert [q.results_name(c, "fp32", e) for c in (False, True) for e in (False, True)] == [
        q.RESULTS[False], q.RESULTS_EXTRA, q.RESULTS[True], "torch_results_extra_composed.json"]
    with open(q.REFERENCE) as f:
        reference = json.load(f)
    seeds = str(tmp_path / "seeds.json")
    q.seeds_report(small_results[0], {"seeds": {}}, reference, seeds)
    out = str(tmp_path / "products.json")
    art = q.products_report(workdir, out, seeds_path=seeds)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(art))
    assert list(art["legs"]) == ["kernels", "composed_bf16x1"]
    bar = reference["val_iou_jax_mean"] - q.GATE
    assert art["bar"] == bar and "kernel_protocol_seeds" not in art
    for name, leg in art["legs"].items():
        assert leg["seeds"] == ([2301, 7] if name == "kernels" else [2301, 101])
        n_at = sum(v >= bar for v in leg["val_iou_per_seed"])
        assert leg["seeds_at_bar"] == n_at
        assert leg["reproduces_records"] == ((n_at / len(leg["seeds"])) ** 4 >= q.REPRODUCES)
    assert art["verdict"] == q.products_verdict(
        {k: v["reproduces_records"] for k, v in art["legs"].items()})
