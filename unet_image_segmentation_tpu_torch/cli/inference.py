"""Inference CLI of the port.

Same flags and checks as ``unet_image_segmentation_tpu.cli.inference``, plus
``--device`` (default ``cuda``). ``--pallas`` runs the hand-written CUDA
kernels and needs a CUDA device; ``--pallas --quant int8`` runs the int8
graph, on the CPU (``--device cpu``) with the kernels' plain versions.
Nothing falls back to the CPU unasked: the CPU is used only with
``--device cpu``.

Usage:
  python -m unet_image_segmentation_tpu_torch.cli.inference IMG [options]
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Segment a document image and crop the detected object."
    )
    p.add_argument("input", type=str, help="Path to the input image.")
    p.add_argument("--output_mask", type=str,
                   default="./outputs_test/output_mask.png")
    p.add_argument("--output_cropped", type=str,
                   default="./outputs_test/output_cropped.png")
    p.add_argument("--model", type=str, default="./models/model",
                   help="Port checkpoint dir (model.pt) or Keras .h5 file.")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="Probability binarization threshold (0, 1).")
    p.add_argument("--min_area", type=float, default=100.0,
                   help="Minimum contour area for cropping.")
    p.add_argument("--crop-mode", type=str, default="bbox",
                   choices=["bbox", "warp"],
                   help="bbox = reference crop; warp = quad perspective warp.")
    p.add_argument("--channel-order", type=str, default="bgr",
                   choices=["bgr", "rgb"],
                   help="bgr reproduces the reference inference exactly.")
    p.add_argument("--image-size", type=int, default=256,
                   help="Model input resolution.")
    p.add_argument("--pallas", action="store_true",
                   help="Hand-written CUDA kernels (fused sepconv pairs); needs CUDA.")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations for the forward pass.")
    p.add_argument("--quant", type=str, default=None, choices=["int8"],
                   help="int8-quantized serving graph (needs --pallas).")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device for the forward pass.")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not os.path.isfile(args.input):
        print(f"Error: input image not found -> {args.input}")
        return 1
    if not os.path.exists(args.model):
        print(f"Error: model checkpoint not found -> {args.model}")
        return 1
    if not (0.0 < args.threshold < 1.0):
        print(f"Error: threshold must be in (0, 1) -> {args.threshold}")
        return 1

    import torch

    if args.quant and not args.pallas:
        print("Error: --quant int8 runs the int8 kernel graph and needs --pallas")
        return 1
    # the float kernel graph on the CPU would only repeat the module path;
    # the int8 graph has no such twin, so its plain versions run there
    if args.pallas and args.device != "cuda" and not args.quant:
        print("Error: --pallas runs CUDA kernels and needs --device cuda (on the CPU only "
              "with --quant int8, which runs the kernels' plain versions)")
        return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: no CUDA device is available; pass --device cpu to run "
              "on the CPU" + (" (without --pallas)" if args.pallas and not args.quant else ""))
        return 1

    from unet_image_segmentation_tpu_torch.inference import Predictor, run_inference

    print(f"Loading model from {args.model} ...")
    predictor = Predictor(
        args.model,
        image_size=(args.image_size, args.image_size),
        compute_dtype="bfloat16" if args.bf16 else "float32",
        use_pallas=args.pallas,
        quantize=args.quant,
        device=args.device,
    )
    result = run_inference(
        predictor,
        args.input,
        output_mask=args.output_mask,
        output_cropped=args.output_cropped,
        threshold=args.threshold,
        min_contour_area=args.min_area,
        crop_mode=args.crop_mode,
        channel_order=args.channel_order,
    )
    if result["bbox"] is not None:
        x, y, w, h = result["bbox"]
        print(f"Crop region: x={x} y={y} w={w} h={h}")
    print("Inference finished.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
