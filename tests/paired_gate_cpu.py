"""Paired run of the binary quality gate's protocol, JAX package against the
port, on the CPU at a reduced size: a diagnostic, not a test (pytest does
not collect it).

For each seed the JAX package draws the initial weights (as its
``create_train_state`` does); the port gets the same weights through
``weights.py``. Both train on the same scenes and batches with the gate's
protocol (batch 2, 24 epochs, BatchNorm on, dropout 0, no flips, fp32):
the port through ``troubleshoot/quality_gate_256.run_seed`` (``use_pallas``;
the kernels' plain versions on the CPU), the JAX package through its
``fit`` on its composed XLA path (its Pallas chains in interpret mode are
far too slow on the CPU). Printed and written for each seed and package:
the final thresholded val IoU; the recalibrated val IoU (the final weights
with every BatchNorm's statistics taken from the train images by the
port's ``recalibrate_batch_norm``; JAX's final ``params`` and
``batch_stats`` are carried into the port's composed model through
``weights.py`` for it); the stale gap ``g`` (recalibrated minus final);
each BatchNorm's ``log(running var / recalibrated var)``; the number of
epoch-to-epoch falls of the val MeanIoU at 0.5 larger than 0.05 after
epoch 10; per-epoch validation MeanIoU and the relative gap of the two
training losses.

``--shard i/n`` runs every n-th seed from the i-th into ``paired_i.json``,
so that shards can run side by side on one data stage;
``--summarize`` reads the ``paired.json`` and ``paired_<i>.json`` of the
workdir (and of ``--more`` workdirs: other seeds on the same scenes) and
prints the verdict: the port's mean ``g`` against JAX's, the mean paired
difference with its standard error; each package's seeds that end on a
good epoch (final within ``GOOD_ENDING`` of recalibrated); each
BatchNorm's mean log ratio in both; and each seed's log ratio averaged
over the BatchNorms, port minus JAX, with its mean, standard error,
median and a two-sided sign test. A fault: the port's gap beyond JAX's by
more than two standard errors, or the ratios apart by two standard errors
with a sign test below 5%.

Usage (from the repository root)::

    python tests/paired_gate_cpu.py --workdir build/paired64 --image-size 64 \\
        --filters 16,32,64 --seeds 23,2301,7,42,101,102,103,104 [--shard 0/2]
    python tests/paired_gate_cpu.py --workdir build/paired64 --summarize [--more DIR ...]
"""

import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOOD_ENDING = 0.01   # final val IoU within this of the recalibrated one


def summarize(wd: str, more=()) -> dict:
    import math

    import numpy as np

    seeds = {}
    for d in (wd, *more):
        paths = glob.glob(os.path.join(d, "paired.json")) + \
            glob.glob(os.path.join(d, "paired_[0-9]*.json"))
        for path in sorted(paths):
            with open(path) as f:
                seeds.update(json.load(f)["seeds"])
    names = sorted(seeds)
    pkgs = ("torch", "jax")
    out = {"seeds": [int(s) for s in names]}
    for pkg in pkgs:
        for key in ("val_iou", "val_iou_bn_recalibrated", "stale_gap", "late_drops"):
            v = np.array([seeds[s][pkg][key] for s in names], np.float64)
            out[f"{pkg}_{key}"] = {"mean": float(v.mean()), "std": float(v.std(ddof=1)),
                                   "per_seed": v.tolist()}
    # a seed ends on a good epoch when its final score is within GOOD_ENDING
    # of its recalibrated one
    for pkg in pkgs:
        good = [int(s) for s in names if abs(seeds[s][pkg]["stale_gap"]) <= GOOD_ENDING]
        out[f"{pkg}_good_endings"] = {"within": GOOD_ENDING, "count": len(good),
                                      "of": len(names), "seeds": good}
    d = np.array([seeds[s]["torch"]["stale_gap"] - seeds[s]["jax"]["stale_gap"] for s in names])
    se = float(d.std(ddof=1) / np.sqrt(len(d)))
    out["stale_gap_difference"] = {"mean": float(d.mean()), "se": se,
                                   "in_se": float(d.mean()) / se if se else None}
    layers = list(seeds[names[0]]["torch"]["bn_log_var_ratio"])
    ratio = {pkg: np.array([[seeds[s][pkg]["bn_log_var_ratio"][n] for n in layers]
                            for s in names]) for pkg in pkgs}
    diff = ratio["torch"] - ratio["jax"]
    out["bn_log_var_ratio"] = {
        n: {"torch": float(ratio["torch"][:, i].mean()), "jax": float(ratio["jax"][:, i].mean()),
            "difference": float(diff[:, i].mean()),
            "se": float(diff[:, i].std(ddof=1) / np.sqrt(len(names)))}
        for i, n in enumerate(layers)}
    # a systematic parting: the layers whose mean difference is beyond two
    # standard errors, and on which side
    apart = [n for n, r in out["bn_log_var_ratio"].items() if abs(r["difference"]) > 2 * r["se"]]
    out["layers_apart_by_2se"] = {"count": len(apart), "of": len(layers),
                                  "port_higher": sum(out["bn_log_var_ratio"][n]["difference"] > 0
                                                     for n in apart)}
    out["mean_log_var_ratio"] = {pkg: float(ratio[pkg].mean()) for pkg in pkgs}
    per_seed = diff.mean(axis=1)
    neg = int((per_seed < 0).sum())
    n = len(per_seed)
    tail = sum(math.comb(n, k) for k in range(min(neg, n - neg) + 1)) / 2 ** n
    out["log_var_ratio_difference_per_seed"] = {
        "per_seed": per_seed.tolist(), "mean": float(per_seed.mean()),
        "se": float(per_seed.std(ddof=1) / np.sqrt(n)), "median": float(np.median(per_seed)),
        "negative": neg, "of": n, "sign_test_p": min(1.0, 2 * tail)}
    # a fault: the port's gap beyond JAX's by more than two standard errors,
    # or its log ratios apart from JAX's both on average (two standard
    # errors) and seed by seed (a sign test at 5%)
    r = out["log_var_ratio_difference_per_seed"]
    gap_fault = d.mean() > 2 * se
    ratio_fault = abs(r["mean"]) > 2 * r["se"] and r["sign_test_p"] < 0.05
    out["verdict"] = ("fault: " + " and ".join(
        w for w, f in (("the port's stale gap exceeds JAX's by more than two standard errors",
                        gap_fault), ("the log variance ratios part systematically", ratio_fault))
        if f) if gap_fault or ratio_fault else
        "no fault: the stale gaps agree within two standard errors and the log variance "
        "ratios do not part systematically")
    with open(os.path.join(wd, "paired_summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    for pkg in pkgs:
        print(pkg, {k: round(out[f"{pkg}_{k}"]["mean"], 4)
                    for k in ("val_iou", "val_iou_bn_recalibrated", "stale_gap", "late_drops")})
    print("seeds ending on a good epoch (final within", GOOD_ENDING, "of recalibrated):",
          {pkg: f"{out[f'{pkg}_good_endings']['count']} of {len(names)}" for pkg in pkgs})
    print("stale gap, port minus JAX:", out["stale_gap_difference"])
    print("mean log(running var / recalibrated var):", out["mean_log_var_ratio"])
    print("layers apart by > 2 se:", out["layers_apart_by_2se"])
    print("mean log ratio over the BatchNorms, port minus JAX, per seed:",
          {k: v for k, v in out["log_var_ratio_difference_per_seed"].items() if k != "per_seed"})
    print(out["verdict"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--filters", default="16,32,64")
    p.add_argument("--seeds", default="23,2301,7,42")
    p.add_argument("--epochs", type=int, default=24,
                   help="a shorter run holds the two packages' statistics while their "
                   "trajectories are still close")
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--shard", default="0/1", help="i/n: every n-th seed from the i-th")
    p.add_argument("--summarize", action="store_true")
    p.add_argument("--more", nargs="*", default=(), help="more workdirs for --summarize")
    args = p.parse_args(argv)
    if args.summarize:
        summarize(args.workdir, args.more)
        return 0

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from unet_image_segmentation_tpu.config import Config as JaxConfig
    from unet_image_segmentation_tpu.models.unet import build_unet as jax_build_unet
    from unet_image_segmentation_tpu.parallel.mesh import create_mesh
    from unet_image_segmentation_tpu.train.callbacks import EarlyStopping
    from unet_image_segmentation_tpu.train.loop import fit as jax_fit
    from unet_image_segmentation_tpu.train.state import make_root_key, state_from_variables
    from unet_image_segmentation_tpu.train.steps import make_predict_fn
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.train.state import create_train_state
    from unet_image_segmentation_tpu_torch.troubleshoot import quality_gate_256 as q
    from unet_image_segmentation_tpu_torch.weights import state_dict_from_flax

    torch.set_num_threads(args.threads)
    seeds = tuple(int(s) for s in args.seeds.split(","))
    shard, shards = (int(v) for v in args.shard.split("/"))
    protocol = q.Protocol(image_size=args.image_size, seeds=seeds, epochs=args.epochs)
    overrides = {"model__filters": [int(f) for f in args.filters.split(",")]}
    wd = args.workdir
    if not os.path.exists(os.path.join(wd, q.STAMP)):
        q.stage_data(wd, protocol=protocol)
    q.check_inputs(wd, protocol)
    xva, yva = q.split_arrays(wd, "val")
    out = {"protocol": protocol.to_dict(), "overrides": overrides, "seeds": {}}
    out_path = os.path.join(wd, f"paired_{shard}.json" if shards > 1 else "paired.json")
    for seed in seeds[shard::shards]:
        cfg = q.gate_config(protocol, seed, os.path.join(wd, "torch"), overrides=overrides)
        jcfg = JaxConfig.from_dict(cfg.to_dict()).override(
            model__use_pallas=False, data__root=os.path.join(wd, "ds"),
            data__pack_dir=os.path.join(wd, f"jax_pack{shard}"), data__num_workers=1,
            train__model_out=os.path.join(wd, "jax", f"model{seed}"),
            train__log_dir=os.path.join(wd, "jax", f"logs{seed}"))
        jmodel = jax_build_unet(jcfg.model)
        params_rng, _ = jax.random.split(make_root_key(jcfg))
        dummy = jnp.zeros((1, *jcfg.model.input_shape), jnp.float32)
        variables = jax.jit(lambda r: jmodel.init({"params": r}, dummy, train=False))(params_rng)
        model = build_unet(cfg.model, device="cpu")
        model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
        t0 = time.perf_counter()
        rec = q.run_seed(cfg, wd, "cpu", xva, yva,
                         state=create_train_state(cfg, model=model, device="cpu"), verbose=False)
        t1 = time.perf_counter()
        res = jax_fit(jcfg, state=state_from_variables(jcfg, variables, jmodel),
                      callbacks=[EarlyStopping(monitor=jcfg.train.monitor, patience=1000,
                                               verbose=False)],
                      verbose=False, mesh=create_mesh(data=1, devices=jax.devices()[:1]))
        predict = make_predict_fn(jmodel, res.state.params, res.state.batch_stats)
        preds = np.concatenate([np.asarray(predict(xva[i:i + 8])) for i in range(0, len(xva), 8)])
        jax_iou = q._thresholded_iou(yva, preds)
        # JAX's final weights and running statistics in the port's model
        final = jax.tree_util.tree_map(np.asarray, {"params": res.state.params,
                                                    "batch_stats": res.state.batch_stats})
        carried = build_unet(cfg.model, device="cpu")
        carried.load_state_dict(state_dict_from_flax(final))
        jax_recal, jax_log_var = q.recalibrated(carried, cfg, wd, "cpu", xva, yva)
        jax_thresh = res.history["val_mean_io_u_thresh"]
        loss_gap = [abs(a / b - 1) for a, b in zip(rec["loss_per_epoch"], res.history["loss"])]
        out["seeds"][str(seed)] = {
            "torch": {
                "val_iou": rec["val_iou"],
                "val_iou_bn_recalibrated": rec["val_iou_bn_recalibrated"],
                "stale_gap": rec["stale_gap"], "late_drops": rec["late_drops"],
                "bn_log_var_ratio": rec["bn_log_var_ratio"],
                "val_thresh": rec["val_mean_io_u_thresh_per_epoch"],
            },
            "jax": {
                "val_iou": jax_iou, "val_iou_bn_recalibrated": jax_recal["val_iou"],
                "stale_gap": jax_recal["val_iou"] - jax_iou, "late_drops": q.late_drops(jax_thresh),
                "bn_log_var_ratio": jax_log_var,
                "val_thresh": jax_thresh,
            },
            "loss_rel_gap": loss_gap,
            "seconds": {"torch": t1 - t0, "jax": time.perf_counter() - t1},
        }
        r = out["seeds"][str(seed)]
        for pkg in ("torch", "jax"):
            v = r[pkg]
            print(f"seed {seed} {pkg:5s}: val IoU {v['val_iou']:.4f}, recalibrated "
                  f"{v['val_iou_bn_recalibrated']:.4f}, g {v['stale_gap']:+.4f}, late drops "
                  f"{v['late_drops']}, mean log var ratio "
                  f"{np.mean(list(v['bn_log_var_ratio'].values())):+.4f}", flush=True)
        print("  training loss, relative gap", [f"{g:.1e}" for g in loss_gap], flush=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
