"""Dataset evaluation CLI of the port (MeanIoU benchmark).

Same flags, checks and printout as ``unet_image_segmentation_tpu.cli.benchmark``
(positional input dir, ``--model --iou_threshold --pred_threshold
--low_score_log --batch-size --image-glob --image-size --pallas --bf16
--quant``), plus ``--device`` (default ``cuda``), as the port's inference
CLI has it. ``--quant int8`` needs ``--pallas``; ``--pallas`` needs a CUDA
device except with ``--quant int8``, whose graph runs on the CPU with the
kernels' plain versions.

Usage:
  python -m unet_image_segmentation_tpu_torch.cli.benchmark DIR [options]
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Evaluate dataset-level MeanIoU against JSON quad ground truth."
    )
    p.add_argument("input_dir", type=str,
                   help="Directory containing images/ and ground_truth/.")
    p.add_argument("--model", type=str, default="./models/model",
                   help="Port checkpoint dir (model.pt) or Keras .h5 file.")
    p.add_argument("--iou_threshold", type=float, default=0.9,
                   help="Per-sample IoU below this is flagged/logged.")
    p.add_argument("--pred_threshold", type=float, default=0.5,
                   help="Probability binarization threshold.")
    p.add_argument("--low_score_log", type=str, default=None,
                   help="Optional CSV path for below-threshold files.")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-glob", type=str, default="*.tif")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--pallas", action="store_true",
                   help="Hand-written CUDA kernels (fused sepconv pairs); needs CUDA.")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--quant", type=str, default=None, choices=["int8"],
                   help="int8-quantized serving graph (needs --pallas).")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device for the forward pass.")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not os.path.isdir(args.input_dir):
        print(f"Error: input directory not found -> {args.input_dir}")
        return 1
    for name in ("images", "ground_truth"):
        if not os.path.isdir(os.path.join(args.input_dir, name)):
            print(f"Error: '{os.path.join(args.input_dir, name)}' not found.")
            return 1
    if not os.path.exists(args.model):
        print(f"Error: model checkpoint not found -> {args.model}")
        return 1
    if not (0.0 <= args.pred_threshold <= 1.0):
        print(f"Error: pred_threshold must be in [0, 1] -> {args.pred_threshold}")
        return 1
    if not (0.0 <= args.iou_threshold <= 1.0):
        print(f"Error: iou_threshold must be in [0, 1] -> {args.iou_threshold}")
        return 1
    if args.quant and not args.pallas:
        print("Error: --quant int8 runs the int8 kernel graph and needs --pallas")
        return 1
    if args.pallas and args.device != "cuda" and not args.quant:
        print("Error: --pallas runs CUDA kernels and needs --device cuda (on the CPU only "
              "with --quant int8, which runs the kernels' plain versions)")
        return 1

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: no CUDA device is available; pass --device cpu to run on the CPU")
        return 1

    from unet_image_segmentation_tpu_torch.evaluation import evaluate
    from unet_image_segmentation_tpu_torch.inference import Predictor

    print(f"Loading model: {args.model} ...")
    predictor = Predictor(
        args.model,
        image_size=(args.image_size, args.image_size),
        compute_dtype="bfloat16" if args.bf16 else "float32",
        use_pallas=args.pallas,
        quantize=args.quant,
        device=args.device,
    )
    try:
        result = evaluate(
            predictor,
            args.input_dir,
            iou_threshold=args.iou_threshold,
            pred_threshold=args.pred_threshold,
            batch_size=args.batch_size,
            image_glob=args.image_glob,
            low_score_log=args.low_score_log,
        )
    except FileNotFoundError as e:
        print(f"Error: {e}")
        return 1

    print("=" * 30)
    print(f"Overall Mean IoU: {result.mean_iou:.4f}")
    print("=" * 30)
    if result.low_iou:
        print(f"Files below IoU threshold ({args.iou_threshold:.2f}):")
        for file_id, score in result.low_iou:
            print(f"  - IoU: {score:.4f} | File: {file_id}")
        if args.low_score_log:
            print(f"Low-score CSV saved to {args.low_score_log}")
    else:
        print(f"No files below the IoU threshold ({args.iou_threshold:.2f}).")
    print(
        f"Evaluated {result.n_evaluated} images in {result.elapsed_sec:.2f}s "
        f"({result.images_per_sec:.1f} img/s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
