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
far too slow on the CPU). Printed and written for each seed: both packages'
per-epoch validation MeanIoU at threshold 0.5, the relative gap of their
per-epoch training losses, and the final thresholded val IoU of each.

Usage (from the repository root)::

    python tests/paired_gate_cpu.py --workdir build/paired64 --image-size 64 \\
        --filters 16,32,64 --seeds 23,2301,7,42
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--filters", default="16,32,64")
    p.add_argument("--seeds", default="23,2301,7,42")
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)

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
    protocol = q.Protocol(image_size=args.image_size, seeds=seeds)
    overrides = {"model__filters": [int(f) for f in args.filters.split(",")]}
    wd = args.workdir
    if not os.path.exists(os.path.join(wd, q.STAMP)):
        q.stage_data(wd, protocol=protocol)
    q.check_inputs(wd, protocol)
    xva, yva = q.split_arrays(wd, "val")
    out = {"protocol": protocol.to_dict(), "overrides": overrides, "seeds": {}}
    for seed in seeds:
        cfg = q.gate_config(protocol, seed, os.path.join(wd, "torch"), overrides=overrides)
        jcfg = JaxConfig.from_dict(cfg.to_dict()).override(
            model__use_pallas=False, data__root=os.path.join(wd, "ds"),
            data__pack_dir=os.path.join(wd, "jax_pack"), data__num_workers=1,
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
        loss_gap = [abs(a / b - 1) for a, b in zip(rec["loss_per_epoch"], res.history["loss"])]
        out["seeds"][str(seed)] = {
            "torch_val_iou": rec["val_iou"], "jax_val_iou": jax_iou,
            "torch_val_thresh": rec["val_mean_io_u_thresh_per_epoch"],
            "jax_val_thresh": res.history["val_mean_io_u_thresh"],
            "loss_rel_gap": loss_gap,
            "seconds": {"torch": t1 - t0, "jax": time.perf_counter() - t1},
        }
        print(f"seed {seed}: val IoU port {rec['val_iou']:.4f}, JAX {jax_iou:.4f}", flush=True)
        print("  val MeanIoU@0.5 port", [round(v, 3) for v in rec["val_mean_io_u_thresh_per_epoch"]])
        print("  val MeanIoU@0.5 JAX ", [round(v, 3) for v in res.history["val_mean_io_u_thresh"]])
        print("  training loss, relative gap", [f"{g:.1e}" for g in loss_gap], flush=True)
        with open(os.path.join(wd, "paired.json"), "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
