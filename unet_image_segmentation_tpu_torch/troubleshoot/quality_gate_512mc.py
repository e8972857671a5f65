"""The 3-class trained-quality gate of the port (512 px, or 256 px with
``--hw 256``), on the card.

Port of ``unet_image_segmentation_tpu/troubleshoot/quality_gate_512mc.py``
with its protocol unchanged: ``write_synthetic_multiclass_dataset(...,
style='hard')`` scenes (background, document quad, a round seal; the
port's verbatim copy of ``data/synthetic.py``), 64 train and 64 val,
class-id masks, loss ``cce``, batch 2, 24 epochs = 768 steps, BatchNorm on,
dropout 0, no flips, early-stop and reduce-LR patience 1000, fp32 with TF32
off, seeds (2301, 7). Training goes through ``fit`` with ``use_pallas=True``
and ``fused_head='auto'``, as the JAX gate configures it: the fused
training chains K1-K4 and K6 each step, the softmax head composed, K8 in
every validation and predict forward. The val images are predicted in
batches of 4, arg-maxed and scored by :func:`_per_class_iou`; the gate
passes when the port's MeanIoU over the seeds of the JAX record
(``QUALITY_512_MC.json``: seed 2301; ``QUALITY_256_MC.json``: 7 and 2301)
is at least JAX's minus 0.005 (the project's 0.5% MeanIoU gate).

The stages are :mod:`.quality_gate_256`'s, with this protocol and scoring:

* ``data`` (where cv2 is): renders, packs (class-id ``.upk``, 64 + 64
  records) and stamps under ``<workdir>``; the packs must have the digests
  of :data:`SCENE_SHA256`, those of the JAX package's own data path (held
  by the tests).
* ``torch`` (on the card; ``--device cpu`` only for tests): the kernel leg
  into ``torch_results.json``, ``--composed`` (``use_pallas=False``) into
  ``torch_results_composed.json``, ``--fused-head-all`` (the softmax head
  K11 in every step; seed 2301 only) into
  ``torch_results_fused_head_all.json``. It refuses changed packs, stamps
  or protocols. ``--extra-seeds N`` then runs seeds 101..100+N of the same
  leg into a file of their own, never the gate's; ``--composed --products
  tf32|bf16x1`` runs the composed leg at another product precision
  (:mod:`.products`), also into files of its own.
* ``report`` (anywhere): ``QUALITY_<hw>_MC_TORCH.json`` beside the JAX
  record, which it only reads.
* ``seeds`` (anywhere): ``QUALITY_<hw>_MC_TORCH_SEEDS.json``, every seed of
  the kernel leg and of each composed leg at each product precision in the
  workdir, per class, final and recalibrated, and the seeds whose MeanIoU
  reaches JAX's minus 0.005.

Usage::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.quality_gate_512mc \\
        --workdir build/q512mc --stage data            # where cv2 is
    python -m ... --workdir build/q512mc --stage torch [--composed | --fused-head-all]
    python -m ... --workdir build/q512mc --stage report  # QUALITY_512_MC_TORCH.json
    python -m ... --workdir build/q512mc --stage torch --extra-seeds 6  # 2301, 7, 101-106
    python -m ... --workdir build/q512mc --stage seeds   # QUALITY_512_MC_TORCH_SEEDS.json
    python -m ... --workdir build/q256mc --hw 256 --stage data   # the 256 px protocol
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

from unet_image_segmentation_tpu_torch.troubleshoot import quality_gate_256 as q

HW = 512
BATCH = 2
N_CLASSES = 3
N_TRAIN, N_VAL = 64, 64
EPOCHS = 24  # 768 BN updates
SEEDS = (2301, 7)
ALL_LEG_SEEDS = (2301,)
PREDICT_BATCH = 4
GATE = q.GATE

# The packs of each side's protocol, as the data stage and the JAX
# package's write_synthetic_multiclass_dataset + make_loaders(class_id) +
# autopack write them.
SCENE_SHA256 = {
    512: {
        "train": "9a36605d2d2d56743be9903092112fa99eced7a82db471b543442be55db22b13",
        "val": "d15ee9d603b496d4b26c1c7bfb4cc395ebe079acd98d3a3f0b9900b0f95d4f36",
    },
    256: {
        "train": "529b7c0cebaaf99ab0251839da6a2c464f178b9a98231cdab247f66d0972f108",
        "val": "14894aab1e5a9ffd30cc454268d9b732781781e8f3e9b38192982922e9006f2f",
    },
}

RESULTS_ALL = "torch_results_fused_head_all.json"


def protocol(hw: int = HW, seeds=SEEDS, epochs: int = EPOCHS) -> q.Protocol:
    return q.Protocol(image_size=hw, batch=BATCH, n_train=N_TRAIN, n_val=N_VAL, epochs=epochs,
                      seeds=tuple(seeds), num_classes=N_CLASSES, mask_mode="class_id",
                      loss="cce")


def pinned(proto: q.Protocol) -> Optional[Dict[str, str]]:
    """The digests the protocol's hard scenes must have (the gate's
    protocols only; any other size or schedule has none)."""
    if proto.image_size in SCENE_SHA256 and proto == protocol(proto.image_size):
        return SCENE_SHA256[proto.image_size]
    return None


def reference_path(hw: int) -> str:
    return os.path.join(q.ROOT, f"QUALITY_{hw}_MC.json")


def _per_class_iou(y_true_ids: np.ndarray, y_pred_ids: np.ndarray, n: int):
    ious = []
    for c in range(n):
        t = y_true_ids == c
        p = y_pred_ids == c
        inter = float(np.logical_and(t, p).sum())
        union = float(np.logical_or(t, p).sum())
        ious.append((inter + 1e-7) / (union + 1e-7))
    return ious


def _score(y_true: np.ndarray, pred_ids: np.ndarray) -> Dict[str, object]:
    ious = _per_class_iou(y_true[..., 0].astype(np.int32), pred_ids, N_CLASSES)
    return {"per_class_iou": ious, "mean_iou": float(np.mean(ious))}


SCORING = q.Scoring(PREDICT_BATCH, _score, "mean_iou", post=lambda p: np.argmax(p, -1))


def stage_data(workdir: str, proto: q.Protocol) -> dict:
    """Render, pack and stamp the class-id scenes (needs cv2)."""
    return q.stage_data(workdir, style="hard", protocol=proto, pinned=pinned(proto))


def stage_torch(workdir: str, proto: q.Protocol, device="cuda", composed: bool = False,
                fused_head_all: bool = False, overrides: Optional[dict] = None,
                verbose: bool = True, extra: int = 0, products: str = "fp32") -> dict:
    """The seeds of the protocol through ``fit`` on the device, one leg: the
    kernel leg, ``composed`` (``use_pallas=False``, at ``products``) or
    ``fused_head_all`` (the kernel leg with the softmax head fused,
    :data:`ALL_LEG_SEEDS`); ``extra`` more seeds after them (not on the
    'all' leg)."""
    if composed and fused_head_all:
        raise ValueError("the fused-head 'all' leg is a kernel leg: not with composed")
    if fused_head_all and extra:
        raise ValueError("the fused-head 'all' leg runs seed 2301 only: no extra seeds")
    if fused_head_all:
        overrides = {**(overrides or {}), "model__fused_head": "all"}
        return q.stage_torch(workdir, device=device, protocol=proto, overrides=overrides,
                             verbose=verbose, scoring=SCORING, pinned=pinned(proto),
                             seeds=tuple(s for s in ALL_LEG_SEEDS if s in proto.seeds),
                             out_name=RESULTS_ALL)
    return q.stage_torch(workdir, device=device, composed=composed, protocol=proto,
                         overrides=overrides, verbose=verbose, scoring=SCORING,
                         pinned=pinned(proto), extra=extra, products=products)


def _leg_summary(res: dict, jax_seeds) -> dict:
    seeds = [int(s) for s in res["seeds"]]
    runs = [res["seeds"][str(s)] for s in seeds]
    gate_seeds = [s for s in jax_seeds if str(s) in res["seeds"]]
    per_class = [res["seeds"][str(s)]["per_class_iou"] for s in gate_seeds]
    first = runs[0]
    return {
        "path": res["path"],
        "fused_head": res.get("fused_head"),
        "seeds": seeds,
        "per_seed_torch": {str(s): r["per_class_iou"] for s, r in zip(seeds, runs)},
        "mean_iou_per_seed": [r["mean_iou"] for r in runs],
        "per_seed_bn_recalibrated": {str(s): r["per_class_iou_bn_recalibrated"]
                                     for s, r in zip(seeds, runs)},
        "mean_iou_bn_recalibrated_per_seed": [r["mean_iou_bn_recalibrated"] for r in runs],
        "stale_gap_per_seed": [r["stale_gap"] for r in runs],
        "late_drops_per_seed": [r["late_drops"] for r in runs],
        "gate_seeds": gate_seeds,
        # as the JAX report: each class averaged over the seeds, then over classes
        "per_class_iou_torch": ([float(np.mean([p[c] for p in per_class]))
                                 for c in range(N_CLASSES)] if per_class else None),
        "mean_iou_torch": (float(np.mean([np.mean(p) for p in per_class]))
                           if per_class else None),
        "val_mean_io_u_per_epoch": {str(s): r["val_mean_io_u_per_epoch"]
                                    for s, r in zip(seeds, runs)},
        "val_mean_io_u_thresh_per_epoch": {str(s): r["val_mean_io_u_thresh_per_epoch"]
                                           for s, r in zip(seeds, runs)},
        "best_epoch": {str(s): r["best_epoch"] for s, r in zip(seeds, runs)},
        "steps": {str(s): r["steps"] for s, r in zip(seeds, runs)},
        "seconds": {str(s): r["seconds"] for s, r in zip(seeds, runs)},
        "launches_per_step": first["launches_per_step"],
        "launches_per_val_forward": first["launches_per_val_forward"],
        "launches_first_predict": first["launches_first_predict"],
        "native_loader": all(r["native_loader"] for r in runs),
    }


def stage_report(workdir: str, out: str, ref_path: str) -> dict:
    """``out`` from the stamp, the legs' results and the JAX record (read only)."""
    with open(os.path.join(workdir, q.STAMP)) as f:
        stamp = json.load(f)
    with open(ref_path) as f:
        reference = json.load(f)
    legs = {}
    for name, fname in (("kernels", q.RESULTS[False]), ("composed", q.RESULTS[True]),
                        ("fused_head_all", RESULTS_ALL)):
        path = os.path.join(workdir, fname)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            res = json.load(f)
        if res["sha256"] != stamp["sha256"] or res["protocol"] != stamp["protocol"]:
            raise ValueError(f"{fname} was run on other packs or another protocol than "
                             f"{q.STAMP} records")
        legs[name] = res
    if "kernels" not in legs:
        raise ValueError(f"no {q.RESULTS[False]} under {workdir}: run the torch stage first")
    kernels = legs["kernels"]
    proto = stamp["protocol"]
    jax_seeds = reference["setup"]["seeds"]
    summary = _leg_summary(kernels, jax_seeds)
    jax_mean = reference["mean_iou_jax"]
    setup = {
        "image_size": proto["image_size"], "num_classes": proto["num_classes"],
        "mask_mode": proto["mask_mode"], "loss": proto["loss"], "epochs": proto["epochs"],
        "batch": proto["batch"], "n_train": proto["n_train"], "n_val": proto["n_val"],
        "bn": True, "dropout": 0.0,
        "bn_updates": proto["epochs"] * (proto["n_train"] // proto["batch"]),
        "seeds": summary["seeds"], "protocol_seeds": proto["seeds"],
        "data_seed": proto["data_seed"], "scene_style": stamp["style"], "cv2": stamp["cv2"],
        "records": stamp["records"], "sha256": stamp["sha256"],
        "overrides": kernels["overrides"], "torch_path": kernels["path"],
        "fused_head": kernels.get("fused_head"), "device": kernels["device"],
        "card": kernels["card"], "torch": kernels["torch"], "cuda": kernels["cuda"],
        "predict": f"batches of {PREDICT_BATCH}, argmax, per-class IoU over the val images",
        "jax_record": os.path.basename(ref_path),
        "jax_path": reference["setup"]["jax_path"],
        "gate": reference["setup"]["gate"] + ": within_gate = the port's MeanIoU over the JAX "
                f"record's seeds >= JAX's - {GATE}",
        "tf_leg": "not run: the TF reference checkout is not in this repository and the card "
                  "has no TF; the JAX record's TF numbers are not compared",
    }
    artifact = {
        "setup": setup,
        "jax_seeds": jax_seeds,
        "per_class_iou_jax": reference["per_class_iou_jax"],
        "mean_iou_jax": jax_mean,
        **summary,
        "delta": (summary["mean_iou_torch"] - jax_mean
                  if summary["mean_iou_torch"] is not None else None),
        "within_gate": bool(summary["mean_iou_torch"] is not None
                            and summary["mean_iou_torch"] >= jax_mean - GATE),
    }
    if "per_seed_jax" in reference:
        artifact["per_seed_jax"] = reference["per_seed_jax"]
    for name in ("composed", "fused_head_all"):
        artifact[name] = (_leg_summary(legs[name], jax_seeds) if name in legs else
                          {"not_run": f"no results of the {name} leg under the workdir"})
    with open(out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps({k: v for k, v in artifact.items()
                      if k not in ("composed", "fused_head_all")}, indent=1))
    return artifact


def seeds_report(workdir: str, out: str, ref_path: str,
                 gate_path: Optional[str] = None) -> dict:
    """``out``: every seed of the kernel leg and of each composed leg at each
    product precision found in the workdir (protocol and extra seeds), per
    class, final and recalibrated, and the seeds whose MeanIoU reaches JAX's
    minus :data:`GATE`; whether the kernel leg's protocol seeds have the
    gate's bits (``gate_path``, default ``QUALITY_<hw>_MC_TORCH.json``). Not
    a gate: the gate's fields stay in the gate's artifact."""
    from unet_image_segmentation_tpu_torch.troubleshoot.products import PRODUCTS

    with open(os.path.join(workdir, q.STAMP)) as f:
        stamp = json.load(f)
    with open(ref_path) as f:
        reference = json.load(f)
    bar = reference["mean_iou_jax"] - GATE
    hw = stamp["protocol"]["image_size"]
    legs = {}
    for name, composed, products in ([("kernels", False, "fp32")]
                                     + [(f"composed_{p}", True, p) for p in PRODUCTS]):
        runs = q.leg_runs(workdir, composed, products, stamp)
        if runs is None:
            continue
        seeds = list(runs["seeds"])
        recs = [runs["seeds"][s] for s in seeds]
        final = [r["mean_iou"] for r in recs]
        recal = [r["mean_iou_bn_recalibrated"] for r in recs]
        legs[name] = {
            "path": runs["path"], "card": runs["card"], "seeds": [int(s) for s in seeds],
            "per_class_iou_per_seed": {s: r["per_class_iou"] for s, r in zip(seeds, recs)},
            "per_class_iou_bn_recalibrated_per_seed": {
                s: r["per_class_iou_bn_recalibrated"] for s, r in zip(seeds, recs)},
            "mean_iou_per_seed": final,
            "mean_iou_bn_recalibrated_per_seed": recal,
            "mean_iou": q._mean_sem(final),
            "mean_iou_bn_recalibrated": q._mean_sem(recal),
            "per_class_iou_bn_recalibrated_mean": np.mean(
                [r["per_class_iou_bn_recalibrated"] for r in recs], 0).tolist(),
            "stale_gap": q._mean_sem([r["stale_gap"] for r in recs]),
            "late_drops_per_seed": [r["late_drops"] for r in recs],
            "seconds_per_seed": [r["seconds"] for r in recs],
            "seeds_at_bar": int(sum(v >= bar for v in final)),
            "seeds_at_bar_bn_recalibrated": int(sum(v >= bar for v in recal)),
        }
    if "kernels" not in legs:
        raise ValueError(f"no {q.RESULTS[False]} under {workdir}: run the torch stage first")
    with open(gate_path or os.path.join(q.ROOT, f"QUALITY_{hw}_MC_TORCH.json")) as f:
        gate = json.load(f)
    kern = legs["kernels"]["per_class_iou_per_seed"]
    art = {
        "what": f"the 3-class {hw} px gate's protocol over more seeds (101.. after the "
                "protocol's): per seed and class, final and with recalibrated BatchNorm "
                f"statistics. A diagnostic, not a gate: QUALITY_{hw}_MC_TORCH.json holds the "
                "gate",
        "protocol": stamp["protocol"], "sha256": stamp["sha256"],
        "mean_iou_jax": reference["mean_iou_jax"],
        "per_class_iou_jax": reference["per_class_iou_jax"], "bar": bar,
        "legs": legs,
        "kernel_protocol_seeds_same_bits_as_gate": all(
            kern[s] == gate["per_seed_torch"][s] for s in gate["per_seed_torch"] if s in kern),
    }
    with open(out, "w") as f:
        json.dump(art, f, indent=2)
    for name, leg in legs.items():
        print(f"{name}: MeanIoU {leg['mean_iou']}, recalibrated "
              f"{leg['mean_iou_bn_recalibrated']}, {leg['seeds_at_bar']} / "
              f"{leg['seeds_at_bar_bn_recalibrated']} recalibrated of {len(leg['seeds'])} at "
              f"{bar:.4f}")
    print(f"kernel protocol seeds same bits as the gate: "
          f"{art['kernel_protocol_seeds_same_bits_as_gate']} -> {out}")
    return art


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--stage", required=True, choices=["data", "torch", "report", "seeds"])
    p.add_argument("--hw", type=int, default=HW,
                   help="image side; 256 runs the same 3-class protocol at the JAX record "
                   "QUALITY_256_MC.json's size")
    p.add_argument("--seeds", type=int, default=len(SEEDS),
                   help="run only the first N seeds of the protocol (a changed protocol: the "
                   "data stage must be run with it too)")
    p.add_argument("--epochs", type=int, default=EPOCHS,
                   help="override the 24-epoch (768-step) schedule (a changed protocol)")
    p.add_argument("--device", default="cuda",
                   help="the torch stage's device (the card; 'cpu' only for tests)")
    leg = p.add_mutually_exclusive_group()
    leg.add_argument("--composed", action="store_true",
                     help="the torch stage with use_pallas=False, into its own results file")
    leg.add_argument("--fused-head-all", action="store_true",
                     help="the torch stage with fused_head='all' (K11 each step), seed "
                     f"{ALL_LEG_SEEDS[0]} only, into {RESULTS_ALL}")
    p.add_argument("--extra-seeds", type=int, default=0, metavar="N",
                   help="the torch stage then runs seeds 101..100+N of the leg into a file of "
                   "their own (never the gate's results)")
    p.add_argument("--products", default="fp32", choices=["fp32", "tf32", "bf16x1"],
                   help="the composed leg's product precision (see quality_gate_256); with "
                   "--composed only")
    p.add_argument("--out", default=None, help="default QUALITY_<hw>_MC_TORCH.json at the root "
                   "(the seeds stage: QUALITY_<hw>_MC_TORCH_SEEDS.json)")
    args = p.parse_args(argv)
    if args.products != "fp32" and not args.composed:
        p.error(f"--products {args.products} runs on the composed leg only: add --composed")
    proto = protocol(args.hw, SEEDS[:args.seeds], args.epochs)
    os.makedirs(args.workdir, exist_ok=True)
    if args.stage == "data":
        stage_data(args.workdir, proto)
    elif args.stage == "torch":
        stage_torch(args.workdir, proto, device=args.device, composed=args.composed,
                    fused_head_all=args.fused_head_all, extra=args.extra_seeds,
                    products=args.products)
    elif args.stage == "seeds":
        out = args.out or os.path.join(q.ROOT, f"QUALITY_{args.hw}_MC_TORCH_SEEDS.json")
        seeds_report(args.workdir, out, reference_path(args.hw))
    else:
        out = args.out or os.path.join(q.ROOT, f"QUALITY_{args.hw}_MC_TORCH.json")
        stage_report(args.workdir, out, reference_path(args.hw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
