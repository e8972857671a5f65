"""Training CLI of the port.

The JAX package's flags (its ``parse_args``/``config_from_args``, reused:
config files, ``--set section__key=value`` overrides, loss, image size,
``--bf16``, ``--pallas``, ``--resume`` ...) plus ``--device`` (default
``cuda``). Nothing moves to the CPU unless ``--device cpu`` is given.

Usage:
  python -m unet_image_segmentation_tpu_torch.cli.train \\
      --config configs/tpu_train_256_bf16.json --set model__fused_head=off --device cuda
"""

from __future__ import annotations

import argparse
import sys

from unet_image_segmentation_tpu.cli import train as jax_cli


def parse_args(argv=None) -> argparse.Namespace:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", type=str, default="cuda",
                     help="torch device to train on (cuda, cuda:N or cpu).")
    known, rest = pre.parse_known_args(argv)
    args = jax_cli.parse_args(rest)
    args.device = known.device
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = jax_cli.config_from_args(args)
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

    from unet_image_segmentation_tpu_torch.train.loop import fit

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
