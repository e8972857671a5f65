"""Export CLI of the port — serving/mobile artifacts from a checkpoint.

Same subcommands and flags as ``unet_image_segmentation_tpu.cli.export``,
with the port's ``torch.export`` artifact in place of StableHLO; ``pt2``
also takes ``--device`` (default ``cuda``), the device the artifact is
exported on and runs on:

  python -m unet_image_segmentation_tpu_torch.cli.export pt2 CKPT OUT_DIR \
      [--device cuda|cpu]
  python -m unet_image_segmentation_tpu_torch.cli.export tflite CKPT OUT.tflite \
      [--optimize] [--float16] [--int8] [--rep-images DIR]

``CKPT`` is a port checkpoint directory (``model.pt``) or a Keras ``.h5``.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Export a trained model for serving.")
    sub = p.add_subparsers(dest="format", required=True)

    shared = argparse.ArgumentParser(add_help=False)
    shared.add_argument("model", type=str,
                        help="Port checkpoint dir (model.pt) or Keras .h5 file.")
    shared.add_argument("--image-size", type=int, default=256)
    shared.add_argument("--batch-size", type=int, default=1)
    shared.add_argument("--labels", type=str, default=None,
                        help="Labels file (one class per line).")

    sp = sub.add_parser("pt2", parents=[shared],
                        help="torch.export artifact + metadata sidecar.")
    sp.add_argument("out_dir", type=str)
    sp.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="Device the artifact is exported on and runs on.")

    tp = sub.add_parser("tflite", parents=[shared],
                        help=".tflite flatbuffer (requires TensorFlow).")
    tp.add_argument("output", type=str)
    tp.add_argument("--optimize", action="store_true",
                    help="Apply tf.lite.Optimize.DEFAULT.")
    tp.add_argument("--float16", action="store_true",
                    help="Store weights as float16.")
    tp.add_argument("--int8", action="store_true",
                    help="Full integer quantization (random representative "
                         "data unless --rep-images points at a directory).")
    tp.add_argument("--rep-images", type=str, default=None,
                    help="Directory of images for int8 calibration.")
    return p.parse_args(argv)


def _load(args, device="cpu"):
    from unet_image_segmentation_tpu_torch.models.unet import UNet
    from unet_image_segmentation_tpu_torch.train.checkpoint import load_inference_variables

    state_dict, kwargs = load_inference_variables(args.model)
    kwargs = {
        k: v
        for k, v in (kwargs or {}).items()
        if k in ("num_classes", "filters", "dropout_rate", "use_batch_norm", "conv_type")
    }
    model = UNet(**kwargs)
    model.load_state_dict(state_dict)
    model.to(device)
    labels = None
    if args.labels:
        with open(args.labels) as f:
            labels = [line.strip() for line in f if line.strip()]
    return model, labels


def _rep_images(directory, size):
    """Up to 16 images of ``directory``, resized to ``size``, float32 in
    [0, 1], in the channel order ``cv2.imread`` gives (as the JAX CLI)."""
    import cv2
    import numpy as np

    from unet_image_segmentation_tpu_torch.data.loader import list_images

    rep = []
    for path in list_images(directory)[:16]:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        rep.append(cv2.resize(img, size[::-1]).astype(np.float32) / 255.0)
    return rep


def main(argv=None) -> int:
    args = parse_args(argv)
    if not os.path.exists(args.model):
        print(f"Error: checkpoint not found -> {args.model}")
        return 1
    size = (args.image_size, args.image_size)

    if args.format == "pt2":
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            print("Error: no CUDA device is available; pass --device cpu to export "
                  "for the CPU")
            return 1
        from unet_image_segmentation_tpu_torch.export.pt2 import export_pt2

        model, labels = _load(args, args.device)
        artifact = export_pt2(
            model, args.out_dir,
            batch_size=args.batch_size, image_size=size, labels=labels,
            device=args.device,
        )
        print(f"torch.export artifact written: {artifact}")
        print(f"Metadata sidecar: {os.path.join(args.out_dir, 'metadata.json')}")
        return 0

    from unet_image_segmentation_tpu_torch.export.tflite import convert_to_tflite, tf_available

    if not tf_available():
        print("Error: TensorFlow unavailable; 'tflite' export needs it. "
              "Use 'pt2' for the TF-free artifact.")
        return 1
    model, labels = _load(args)
    rep = _rep_images(args.rep_images, size) if args.rep_images else None
    out = convert_to_tflite(
        model, args.output,
        batch_size=args.batch_size, image_size=size,
        optimize=args.optimize, float16=args.float16,
        int8=args.int8, representative_images=rep, labels=labels,
    )
    size_kb = os.path.getsize(out) / 1024
    print(f"TFLite model written: {out} ({size_kb:.0f} KiB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
