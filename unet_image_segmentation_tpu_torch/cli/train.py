"""Training CLI of the port.

The flags of the JAX package's ``cli/train.py`` (config files,
``--set section__key=value`` overrides, loss, image size, ``--bf16``,
``--pallas``, ``--resume`` ...), parsed into the same :class:`Config`, plus
``--device`` (default ``cuda``). Nothing moves to the CPU unless
``--device cpu`` is given. ``--mesh DATA,SPATIAL`` lays the job's ranks out
as the training mesh (``fit`` clamps the spatial degree to the ranks
present). A job of several ranks is launched with torchrun, one process a
rank; the CLI joins the process group (env://) with gloo when ranks share
a card, NCCL when each has its own.

Usage:
  python -m unet_image_segmentation_tpu_torch.cli.train \\
      --config configs/tpu_train_256_bf16.json --data-root <dataset> --device cuda
  torchrun --nproc_per_node 2 -m unet_image_segmentation_tpu_torch.cli.train \\
      --config configs/highres_1024.json --mesh 1,2 --data-root <dataset>
"""

from __future__ import annotations

import argparse
import json
import sys

from unet_image_segmentation_tpu_torch.config import Config


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Train the U-Net for semantic segmentation (PyTorch/CUDA port)."
    )
    # Reference-compatible flags (defaults mirror scripts/train.py:71-76).
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--model-out", type=str, default=None,
                   help="Checkpoint directory (best/ + last/ + meta.json).")
    p.add_argument("--config", type=str, default=None,
                   help="JSON config file (overridden by explicit flags).")
    p.add_argument("--data-root", type=str, default=None)
    p.add_argument("--loss", type=str, default=None,
                   choices=["dice", "iou", "jaccard", "bce", "cce"])
    p.add_argument("--image-size", type=int, default=None,
                   help="Square input resolution (256/512/1024).")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--mask-mode", type=str, default=None,
                   choices=["binary", "class_id"],
                   help="class_id = integer label masks (multi-class).")
    p.add_argument("--conv-type", type=str, default=None,
                   choices=["separable", "full"])
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (fp32 params).")
    p.add_argument("--pallas", dest="pallas", action="store_true", default=None,
                   help="Train through the fused CUDA kernels (model.use_pallas).")
    p.add_argument("--no-pallas", dest="pallas", action="store_false",
                   help="Force the composed PyTorch train step.")
    p.add_argument("--mesh", type=str, default=None, metavar="DATA,SPATIAL",
                   help="Mesh of the job's ranks: batch over DATA, image rows over "
                        "SPATIAL (launch the ranks with torchrun).")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="section__key=value",
                   help="Generic config override (JSON-parsed value), e.g. "
                        "--set model__use_pallas=true --set data__prefetch=8. "
                        "Repeatable.")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="Resume from <model-out>/last.")
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu).")
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> Config:
    """The :class:`Config` the flags describe: the config file (or the
    defaults), then each given flag, then the ``--set`` overrides."""
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    overrides = {}
    if args.epochs is not None:
        overrides["train__epochs"] = args.epochs
    if args.batch_size is not None:
        overrides["train__batch_size"] = args.batch_size
    if args.learning_rate is not None:
        overrides["train__learning_rate"] = args.learning_rate
    if args.weight_decay is not None:
        overrides["train__weight_decay"] = args.weight_decay
    if args.model_out is not None:
        overrides["train__model_out"] = args.model_out
    if args.data_root is not None:
        overrides["data__root"] = args.data_root
    if args.loss is not None:
        overrides["train__loss"] = args.loss
    if args.image_size is not None:
        overrides["model__image_height"] = args.image_size
        overrides["model__image_width"] = args.image_size
    if args.num_classes is not None:
        overrides["model__num_classes"] = args.num_classes
    if args.mask_mode is not None:
        overrides["data__mask_mode"] = args.mask_mode
    if args.conv_type is not None:
        overrides["model__conv_type"] = args.conv_type
    if args.bf16:
        overrides["model__compute_dtype"] = "bfloat16"
    if args.pallas is not None:
        overrides["model__use_pallas"] = args.pallas
    if args.mesh is not None:
        try:
            data_ax, spatial_ax = (int(v) for v in args.mesh.split(","))
        except ValueError:
            raise SystemExit(f"--mesh expects 'DATA,SPATIAL' integers, got {args.mesh!r}")
        overrides["mesh__data_axis"] = data_ax
        overrides["mesh__spatial_axis"] = spatial_ax
    for item in args.sets:
        key, sep, raw = item.partition("=")
        if not sep:
            raise SystemExit(f"--set expects section__key=value, got {item!r}")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw  # bare strings need no quotes
        overrides[key] = value
    if args.seed is not None:
        overrides["train__seed"] = args.seed
    if args.resume:
        overrides["train__resume"] = True
    if args.log_dir is not None:
        overrides["train__log_dir"] = args.log_dir
    return cfg.override(**overrides) if overrides else cfg


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = config_from_args(args)
    t = cfg.train
    print("--- Training Configuration ---")
    print(f"Epochs        : {t.epochs}")
    print(f"Batch Size    : {t.batch_size}")
    print(f"Learning Rate : {t.learning_rate}")
    print(f"Weight Decay  : {t.weight_decay} (AdamW)")
    print(f"Loss          : {t.loss}")
    print(f"Model Output  : {t.model_out}")
    print(f"Input Shape   : {cfg.model.input_shape}")
    print(f"Fused Kernels : {cfg.model.use_pallas} (fused_head={cfg.model.fused_head})")
    print(f"Device        : {args.device}")
    print(f"Seed          : {t.seed}")
    print("------------------------------")

    from unet_image_segmentation_tpu_torch.parallel import distributed
    from unet_image_segmentation_tpu_torch.train.loop import fit

    distributed.initialize(device=args.device)   # a no-op in one process
    try:
        result = fit(cfg, device=args.device)
    except KeyboardInterrupt:
        print("\n--- Training interrupted by user ---")
        print(f"Best/last checkpoints (if any) are under {t.model_out}")
        return 1
    except FileNotFoundError as e:
        print(f"\n--- Dataset error ---\n{e}")
        print("Expected layout (reference contract):")
        print(f"  {cfg.data.root}/{{train,val}}_{{frames,masks}}/image/*.png")
        return 1
    print(f"Best {t.monitor}: {result.best_score:.4f} (epoch {result.best_epoch + 1}); "
          f"model saved to {t.model_out}/best")
    return 0


if __name__ == "__main__":
    sys.exit(main())
