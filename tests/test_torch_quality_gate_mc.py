"""The port's 3-class quality gate (``troubleshoot/quality_gate_512mc.py``)
against the JAX package's, on the CPU.

* ``_per_class_iou`` is JAX's;
* the 256 px protocol's data stage writes the pinned digests, and so does
  the JAX package's own data path (``write_synthetic_multiclass_dataset``,
  ``make_loaders`` with class-id masks, its autopack). The 512 px packs
  take ~21 s on both paths, more than this file's budget allows: their
  digests are pinned from the same two paths run once and checked by the
  data and torch stages;
* the gate's packed batches at 32 px are the JAX gate's (``make_loaders``
  through its autopack) for epochs 0 and 1, and the val arrays are its
  ``_load_arrays``';
* the torch stage at 32 px (filters (8, 16); the kernels' plain versions)
  runs two seeds of one epoch on the kernel and composed legs and one on
  the fused-head 'all' leg, refuses changed inputs, and the report takes its
  setup from the stamp;
* one seed from JAX's initial weights against JAX ``fit`` +
  ``make_predict_fn`` on its composed path, ``cce`` and 3 classes:
  per-epoch training loss within 1e-4 relative, per-class IoU within 1e-3
  absolute, fp32.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("cv2")

from unet_image_segmentation_tpu_torch.troubleshoot import quality_gate_256 as q  # noqa: E402
from unet_image_segmentation_tpu_torch.troubleshoot import quality_gate_512mc as mc  # noqa: E402

SMALL = q.Protocol(image_size=32, n_train=8, n_val=8, epochs=1, seeds=(2301, 7), num_classes=3,
                   mask_mode="class_id", loss="cce")
TWO_EPOCHS = q.Protocol(**{**dataclasses.asdict(SMALL), "epochs": 2})
SMALL_MODEL = {"model__filters": [8, 16]}
LOSS_RTOL = 1e-4
IOU_ATOL = 1e-3
# Every BatchNorm's final running mean within 2e-5 of its running standard
# deviation, its running variance within 2e-5 of its max (measured 4.0e-6 and
# 9e-7). The means sit near 0 (max |mean| 0.01-0.05 against variances near
# 0.93), where 8 AdamW steps part the two packages' weights by up to 0.26 lr.
BN_STATS_TOL = 2e-5
LEGS = {"kernels": {}, "composed": {"composed": True}, "all": {"fused_head_all": True}}


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("q32mc"))
    mc.stage_data(workdir, SMALL)
    return workdir


@pytest.fixture(scope="module")
def small_results(small_dir):
    return {leg: mc.stage_torch(small_dir, SMALL, device="cpu", overrides=SMALL_MODEL,
                                verbose=False, **kw) for leg, kw in LEGS.items()}


@pytest.mark.parametrize("case", range(4))
def test_per_class_iou_equals_jax(case):
    from unet_image_segmentation_tpu.troubleshoot.quality_gate_512mc import _per_class_iou

    rng = np.random.RandomState(case)
    n = 3 + case % 2
    t = rng.randint(0, n, (4, 16, 16))
    p = rng.randint(0, n - (case == 3), (4, 16, 16))   # case 3: a class never predicted
    assert mc._per_class_iou(t, p, n) == _per_class_iou(t, p, n)
    assert mc._per_class_iou(t, t, n) == _per_class_iou(t, t, n) == [1.0] * n


def test_protocols_are_the_jax_gates():
    from unet_image_segmentation_tpu.troubleshoot import quality_gate_512mc as jmc

    for hw in (512, 256):
        d = mc.protocol(hw).to_dict()
        assert d == {"image_size": hw, "batch": jmc.BATCH, "n_train": jmc.N_TRAIN,
                     "n_val": jmc.N_VAL, "epochs": jmc.EPOCHS, "seeds": list(jmc.SEEDS),
                     "data_seed": 230, "num_classes": jmc.N_CLASSES, "mask_mode": "class_id",
                     "loss": "cce"}
        assert mc.pinned(mc.protocol(hw)) == mc.SCENE_SHA256[hw]
    assert mc.PREDICT_BATCH == 4 and mc.pinned(mc.protocol(512, epochs=12)) is None
    # the binary gate's stamp keeps its seven fields
    assert sorted(q.GATE_PROTOCOL.to_dict()) == sorted(
        ["image_size", "batch", "n_train", "n_val", "epochs", "seeds", "data_seed"])


def test_gate_packs_have_the_pinned_digests(tmp_path):
    """The 256 px protocol's data stage, and the JAX data path on the same
    parameters, give :data:`SCENE_SHA256`: 64 + 64 class-id records."""
    from unet_image_segmentation_tpu.config import Config as JaxConfig
    from unet_image_segmentation_tpu.data.autopack import maybe_autopack as jax_autopack
    from unet_image_segmentation_tpu.data.loader import make_loaders as jax_loaders
    from unet_image_segmentation_tpu.data.synthetic import write_synthetic_multiclass_dataset

    proto = mc.protocol(256)
    workdir = str(tmp_path / "mine")
    stamp = mc.stage_data(workdir, proto)
    assert stamp["sha256"] == mc.SCENE_SHA256[256]
    assert stamp["records"] == {"train": [64, 256, 256, 3, 1], "val": [64, 256, 256, 3, 1]}
    assert q.check_inputs(workdir, proto, mc.pinned(proto)) == stamp

    root = write_synthetic_multiclass_dataset(str(tmp_path / "ds"), n_train=64, n_val=64,
                                              image_size=(256, 256), num_classes=3, style="hard")
    jcfg = JaxConfig().override(model__image_height=256, model__image_width=256,
                                model__num_classes=3, data__root=root,
                                data__mask_mode="class_id", data__pack_dir=str(tmp_path / "pk"),
                                train__batch_size=2, train__seed=2301)
    for split, ds in zip(q.SPLITS, jax_loaders(jcfg)):
        jds = jax_autopack(ds, pack_dir=jcfg.data.pack_dir, verbose=False)
        for _ in jds.batches(2, epoch=0, steps=len(jds) // 2, num_workers=1):
            pass
        assert jds.packed_active
        assert q.sha256_file(jds.pack_path) == mc.SCENE_SHA256[256][split], split


def test_packed_batches_are_the_jax_gates_batches(small_dir, tmp_path, monkeypatch, seed=7):
    from unet_image_segmentation_tpu.config import Config as JaxConfig
    from unet_image_segmentation_tpu.data.autopack import maybe_autopack as jax_autopack
    from unet_image_segmentation_tpu.data.loader import make_loaders as jax_loaders
    from unet_image_segmentation_tpu.troubleshoot import quality_gate_512mc as jmc

    cfg = q.gate_config(SMALL, seed, str(tmp_path))
    assert (cfg.model.num_classes, cfg.data.mask_mode, cfg.train.loss) == (3, "class_id", "cce")
    mine = q.gate_datasets(small_dir, cfg)
    jcfg = JaxConfig.from_dict(cfg.to_dict()).override(
        data__root=os.path.join(small_dir, "ds"), data__pack_dir=str(tmp_path / "pack"))
    theirs = [jax_autopack(ds, pack_dir=jcfg.data.pack_dir, verbose=False)
              for ds in jax_loaders(jcfg)]
    for ds, jds in zip(mine, theirs):
        assert ds.mask_is_class_id and len(ds) == len(jds)
        for epoch in (0, 1):
            got = list(ds.batches(2, epoch=epoch, steps=len(ds) // 2, num_workers=1))
            want = list(jds.batches(2, epoch=epoch, steps=len(jds) // 2, num_workers=1))
            assert len(got) == len(want) == len(ds) // 2
            for (gi, gm), (wi, wm) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gm, wm)
            assert set(np.unique(np.concatenate([m for _, m in got]))) <= {0.0, 1.0, 2.0}
        assert jds.packed_active
    monkeypatch.setattr(jmc, "HW", SMALL.image_size)
    (jxtr, jytr), (jxva, jyva) = jmc._load_arrays(os.path.join(small_dir, "ds"))
    for split, (jx, jy) in zip(q.SPLITS, ((jxtr, jytr), (jxva, jyva))):
        x, y = q.split_arrays(small_dir, split)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("leg", list(LEGS))
def test_torch_stage_runs_every_seed_on_the_cpu(small_dir, small_results, leg):
    res = small_results[leg]
    stamp = q.check_inputs(small_dir, SMALL)
    assert res["sha256"] == stamp["sha256"] and res["protocol"] == SMALL.to_dict()
    assert res["device"] == "cpu" and res["card"] is None
    assert res["fused_head"] == ("all" if leg == "all" else "auto")
    name = {"kernels": q.RESULTS[False], "composed": q.RESULTS[True], "all": mc.RESULTS_ALL}[leg]
    with open(os.path.join(small_dir, name)) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert list(res["seeds"]) == (["2301"] if leg == "all" else ["2301", "7"])
    for rec in res["seeds"].values():
        assert rec["epochs"] == 1 and rec["steps"] == 4
        for key in ("per_class_iou", "per_class_iou_bn_recalibrated"):
            assert len(rec[key]) == 3 and all(0.0 <= v <= 1.0 for v in rec[key])
        assert rec["mean_iou"] == pytest.approx(np.mean(rec["per_class_iou"]))
        assert rec["stale_gap"] == pytest.approx(rec["mean_iou_bn_recalibrated"] - rec["mean_iou"])
        assert len(rec["bn_log_var_ratio"]) == 2 * 2 * 2 + 2   # 2 stages x 2 ways + bottleneck
        assert np.isfinite(list(rec["bn_log_var_ratio"].values())).all()
        assert len(rec["val_mean_io_u_per_epoch"]) == len(rec["loss_per_epoch"]) == 1
        assert np.isfinite(rec["loss_per_epoch"]).all()
        assert not any(rec["launches_per_step"].values())   # plain versions on the CPU
        assert rec["launches_per_val_forward"] == 0


def test_report_takes_its_setup_from_the_stamp(small_dir, small_results, tmp_path):
    out = str(tmp_path / "QUALITY_256_MC_TORCH.json")
    ref_path = mc.reference_path(256)
    art = mc.stage_report(small_dir, out, ref_path)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(art))
    with open(os.path.join(small_dir, q.STAMP)) as f:
        stamp = json.load(f)
    with open(ref_path) as f:
        ref = json.load(f)
    setup = art["setup"]
    assert (setup["image_size"], setup["num_classes"], setup["loss"], setup["n_train"],
            setup["n_val"], setup["epochs"], setup["bn_updates"]) == (32, 3, "cce", 8, 8, 1, 4)
    assert setup["sha256"] == stamp["sha256"] and setup["cv2"] == stamp["cv2"]
    assert setup["jax_record"] == "QUALITY_256_MC.json" and "not run" in setup["tf_leg"]
    runs = small_results["kernels"]["seeds"]
    assert art["gate_seeds"] == ref["setup"]["seeds"] == [7, 2301]
    per_class = [np.mean([runs[str(s)]["per_class_iou"][c] for s in (7, 2301)])
                 for c in range(3)]
    assert art["per_class_iou_torch"] == pytest.approx(per_class)
    assert art["mean_iou_torch"] == pytest.approx(np.mean(per_class))
    assert art["delta"] == pytest.approx(art["mean_iou_torch"] - ref["mean_iou_jax"])
    assert art["within_gate"] == (art["mean_iou_torch"] >= ref["mean_iou_jax"] - 0.005)
    assert art["per_seed_jax"] == ref["per_seed_jax"]
    assert art["composed"]["seeds"] == [2301, 7]
    assert art["fused_head_all"]["seeds"] == art["fused_head_all"]["gate_seeds"] == [2301]
    # the 512 px record has one seed
    art512 = mc.stage_report(small_dir, str(tmp_path / "512.json"), mc.reference_path(512))
    assert art512["gate_seeds"] == [2301]
    assert art512["mean_iou_torch"] == pytest.approx(runs["2301"]["mean_iou"])
    # results of other packs are refused
    other = str(tmp_path / "w")
    shutil.copytree(small_dir, other)
    with open(os.path.join(other, q.STAMP), "w") as f:
        json.dump({**stamp, "sha256": {**stamp["sha256"], "train": "0" * 64}}, f)
    with pytest.raises(ValueError, match="other packs"):
        mc.stage_report(other, out, ref_path)


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 1]))


@pytest.mark.parametrize("change", ["pack byte", "protocol", "class count", "binary protocol",
                                    "pinned scenes", "no card"])
def test_torch_stage_refuses_changed_inputs(small_dir, tmp_path, change):
    workdir = str(tmp_path / "w")
    shutil.copytree(small_dir, workdir, ignore=shutil.ignore_patterns(
        "ds", "kernels", "composed", "torch_results*.json"))
    q.check_inputs(workdir, SMALL)
    proto, match = SMALL, "protocol"
    if change == "pack byte":
        _flip_byte(q.pack_path(workdir, "val"), 64 + 321)
        match = "is not the stamp's"
    elif change == "protocol":
        proto = TWO_EPOCHS
    elif change == "class count":
        proto = q.Protocol(**{**dataclasses.asdict(SMALL), "num_classes": 4})
    elif change == "binary protocol":
        proto = q.Protocol(**{k: v for k, v in dataclasses.asdict(SMALL).items()
                              if k not in ("num_classes", "mask_mode", "loss")})
    elif change == "pinned scenes":
        # hard scenes held to digests that are not theirs
        with pytest.raises(ValueError, match="not the gate's scenes"):
            q.check_inputs(workdir, SMALL, mc.SCENE_SHA256[256])
        return
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mc.stage_torch(workdir, SMALL, overrides=SMALL_MODEL)
        return
    with pytest.raises(ValueError, match=match):
        mc.stage_torch(workdir, proto, device="cpu", overrides=SMALL_MODEL, verbose=False)
    assert not os.path.exists(os.path.join(workdir, q.RESULTS[False]))


def test_cli_runs_the_report(small_dir, small_results, tmp_path):
    out = str(tmp_path / "cli.json")
    assert mc.main(["--workdir", small_dir, "--stage", "report", "--hw", "256",
                    "--out", out]) == 0
    with open(out) as f:
        assert json.load(f)["setup"]["jax_record"] == "QUALITY_256_MC.json"
    with pytest.raises(SystemExit):
        mc.main(["--workdir", small_dir, "--stage", "torch", "--composed", "--fused-head-all"])


def test_one_seed_tracks_jax_fit(tmp_path):
    """The gate's seed run from JAX's initial weights (carried through
    ``weights.py``) against JAX ``fit`` + ``make_predict_fn`` on the same
    class-id scenes and batches, ``cce``, 3 classes: per-epoch loss within
    1e-4 relative, per-class IoU within 1e-3 absolute, every BatchNorm's
    final running mean within 2e-5 of JAX's running standard deviation and
    its variance within 2e-5 of JAX's largest, fp32."""
    import jax
    import jax.numpy as jnp

    from unet_image_segmentation_tpu.config import Config as JaxConfig
    from unet_image_segmentation_tpu.models.unet import build_unet as jax_build_unet
    from unet_image_segmentation_tpu.parallel.mesh import create_mesh
    from unet_image_segmentation_tpu.train import callbacks as jcb
    from unet_image_segmentation_tpu.train.loop import fit as jax_fit
    from unet_image_segmentation_tpu.train.state import make_root_key, state_from_variables
    from unet_image_segmentation_tpu.train.steps import make_predict_fn as jax_predict_fn
    from unet_image_segmentation_tpu.troubleshoot.quality_gate_512mc import _per_class_iou
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.train.state import create_train_state
    from unet_image_segmentation_tpu_torch.weights import state_dict_from_flax

    workdir = str(tmp_path / "data")
    mc.stage_data(workdir, TWO_EPOCHS)
    seed = TWO_EPOCHS.seeds[0]
    cfg = q.gate_config(TWO_EPOCHS, seed, str(tmp_path / "torch"), overrides=SMALL_MODEL)
    jcfg = JaxConfig.from_dict(cfg.to_dict()).override(
        model__use_pallas=False, data__root=os.path.join(workdir, "ds"),
        data__pack_dir=str(tmp_path / "pack"), data__num_workers=1,
        train__model_out=str(tmp_path / "jax" / "model"), train__log_dir=str(tmp_path / "jax"))
    jmodel = jax_build_unet(jcfg.model)
    params_rng, _ = jax.random.split(make_root_key(jcfg))
    dummy = jnp.zeros((1, *jcfg.model.input_shape), jnp.float32)
    variables = jax.jit(lambda r: jmodel.init({"params": r}, dummy, train=False))(params_rng)
    jstate = state_from_variables(jcfg, variables, jmodel)

    model = build_unet(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    state = create_train_state(cfg, model=model, device="cpu")
    xva, yva = q.split_arrays(workdir, "val")
    rec = q.run_seed(cfg, workdir, "cpu", xva, yva, state=state, verbose=False,
                     scoring=mc.SCORING)

    tcfg = jcfg.train
    callbacks = [jcb.EarlyStopping(monitor=tcfg.monitor, mode=tcfg.monitor_mode,
                                   patience=tcfg.early_stop_patience, verbose=False)]
    res = jax_fit(jcfg, state=jstate, callbacks=callbacks, verbose=False,
                  mesh=create_mesh(data=1, devices=jax.devices()[:1]))
    predict = jax_predict_fn(jmodel, res.state.params, res.state.batch_stats)
    ids = np.concatenate([np.argmax(np.asarray(predict(xva[i:i + 4])), -1)
                          for i in range(0, len(xva), 4)])
    want = _per_class_iou(yva[..., 0].astype(np.int32), ids, 3)

    assert rec["steps"] == int(res.state.step) == int(state.step) == 8
    np.testing.assert_allclose(rec["loss_per_epoch"], res.history["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(rec["per_class_iou"], want, rtol=0, atol=IOU_ATOL)
    assert rec["loss_per_epoch"][1] < rec["loss_per_epoch"][0]   # it trains
    want_stats = state_dict_from_flax(
        {"batch_stats": jax.tree_util.tree_map(np.asarray, res.state.batch_stats)})
    got = state.model.state_dict()
    errs = {}
    for k, v in want_stats.items():
        scale = want_stats[k[:-4] + "var"].sqrt() if k.endswith(".mean") else v.abs().max()
        errs[k] = float(((got[k] - v).abs() / scale).max())
    assert len(errs) == 2 * 10 and max(errs.values()) <= BN_STATS_TOL, errs


def test_extra_seeds_and_the_seeds_report(small_dir, small_results, tmp_path, monkeypatch):
    """``--extra-seeds`` and ``--products`` reach the binary gate's stage
    (seeds 101.. into a file of their own); the fused-head 'all' leg takes
    no extra seeds. The seeds report lists every seed of the kernel leg's
    files (the protocol's and the extra ones) per class, final and
    recalibrated, counts the seeds at JAX's MeanIoU minus 0.005, and tells
    whether the protocol seeds have the gate's bits."""
    with pytest.raises(ValueError, match="no extra seeds"):
        mc.stage_torch(small_dir, SMALL, device="cpu", fused_head_all=True, extra=1)
    seen = {}
    monkeypatch.setattr(q, "stage_torch", lambda *a, **kw: seen.update(kw))
    mc.stage_torch(small_dir, SMALL, device="cpu", composed=True, extra=3, products="bf16x1")
    assert (seen["extra"], seen["products"], seen["composed"]) == (3, "bf16x1", True)
    monkeypatch.undo()
    workdir = str(tmp_path / "w")
    shutil.copytree(small_dir, workdir, ignore=shutil.ignore_patterns(
        "ds", "kernels", "composed", "torch_results_*.json"))
    kernels = small_results["kernels"]
    with open(os.path.join(workdir, q.RESULTS_EXTRA), "w") as f:   # seed 7's run as seed 101
        json.dump({**kernels, "seeds": {"101": kernels["seeds"]["7"]}}, f)
    gate = str(tmp_path / "gate.json")
    with open(gate, "w") as f:
        json.dump({"per_seed_torch": {s: r["per_class_iou"]
                                      for s, r in kernels["seeds"].items()}}, f)
    ref_path = mc.reference_path(512)
    out = str(tmp_path / "seeds.json")
    art = mc.seeds_report(workdir, out, ref_path, gate_path=gate)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(art))
    with open(ref_path) as f:
        bar = json.load(f)["mean_iou_jax"] - mc.GATE
    leg = art["legs"]["kernels"]
    assert list(art["legs"]) == ["kernels"] and leg["seeds"] == [2301, 7, 101]
    assert art["kernel_protocol_seeds_same_bits_as_gate"]
    assert leg["seeds_at_bar"] == sum(v >= bar for v in leg["mean_iou_per_seed"])
    assert leg["seeds_at_bar_bn_recalibrated"] == sum(
        v >= bar for v in leg["mean_iou_bn_recalibrated_per_seed"])
    assert all(len(v) == 3 for v in leg["per_class_iou_bn_recalibrated_per_seed"].values())
    with open(gate, "w") as f:
        json.dump({"per_seed_torch": {"2301": [0.0, 0.0, 0.0]}}, f)
    assert not mc.seeds_report(workdir, out, ref_path, gate_path=gate)[
        "kernel_protocol_seeds_same_bits_as_gate"]
