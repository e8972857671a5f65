"""Serving export: a ``torch.export`` artifact + metadata sidecar.

Counterpart of ``unet_image_segmentation_tpu/export/stablehlo.py``: the
eval forward ``model(x, train=False)`` is traced by ``torch.export`` at a
fixed NHWC float32 input shape and saved with ``torch.export.save``
(loadable by ``torch.export.load`` without the Python model code), and the
descriptive metadata is written as a JSON sidecar with the JAX package's
keys and values (``format`` and ``torch_version`` excepted).

A ``use_pallas`` model's graph holds one ``unet.sepconv_block`` node a
ConvBlock: K8, the registered op of :mod:`..ops.fused_sepconv`, the
counterpart of the TPU kernel's Mosaic custom call. Such a graph loads
where that module is imported (:func:`load_pt2` imports it) and runs the
kernel on the card. A graph without ``use_pallas`` holds only ATen ops and
loads in a process that imports nothing but ``torch``.

The artifact runs on the device it was exported on: the graph keeps the
device of the weights and of the constants its forward creates. So
:func:`export_pt2` exports on ``device`` (the card by default) and
:func:`load_pt2` refuses a program whose weights lie on another device.

Artifact layout under ``out_dir``:
    model.pt2            torch.export.save of the exported program
    metadata.json        sidecar (the JAX package's schema)
    labels.txt           one class name per line (reference scripts/labels.txt)
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from unet_image_segmentation_tpu_torch.models.unet import resolve_device

DEFAULT_LABELS = ["background", "segmentation"]  # reference scripts/labels.txt
ARTIFACT = "model.pt2"


class ForwardModule(nn.Module):
    """``model(images, train=False)`` as a module of one input, the
    counterpart of the JAX package's ``make_forward_fn``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images, train=False)


def export_pt2(
    model: nn.Module,
    out_dir: str,
    batch_size: int = 1,
    image_size: Tuple[int, int] = (256, 256),
    channels: int = 3,
    labels: Optional[Sequence[str]] = None,
    model_name: str = "unet-image-segmentation-tpu",
    version: str = "v1",
    author: str = "unet_image_segmentation_tpu",
    license_str: str = "MIT",
    device: Union[str, torch.device] = "cuda",
) -> str:
    """Export the forward pass + metadata. Returns the artifact path.

    ``model`` is moved to ``device`` (the card unless the caller asks for
    another; it raises when the card is missing) and traced there under
    ``torch.no_grad()`` at the input ``(batch_size, h, w, channels)``
    float32.
    """
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    h, w = image_size
    model.to(device)
    example = torch.zeros((batch_size, h, w, channels), dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(ForwardModule(model), (example,))
    artifact = os.path.join(out_dir, ARTIFACT)
    torch.export.save(program, artifact)

    labels = list(labels or DEFAULT_LABELS)
    with open(os.path.join(out_dir, "labels.txt"), "w") as f:
        f.write("\n".join(labels) + "\n")

    num_classes = getattr(model, "num_classes", 1)
    metadata = {
        "name": model_name,
        "description": (
            "Semantic segmentation U-Net: per-pixel "
            + ("sigmoid probability mask (binary)" if num_classes == 1
               else f"{num_classes}-class softmax map")
        ),
        "version": version,
        "author": author,
        "license": license_str,
        "input": {
            "shape": [batch_size, h, w, channels],
            "dtype": "float32",
            "color_space": "RGB",
            "normalization": {"mean": [0.0], "std": [255.0]},
            "value_range": [0.0, 1.0],
        },
        "output": {
            "shape": [batch_size, h, w, num_classes],
            "dtype": "float32",
            "semantics": "probability mask",
            "binarization_threshold": 0.5,
        },
        "labels_file": "labels.txt",
        "labels": labels,
        "format": "torch.export",
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f, indent=2)
    return artifact


def load_pt2(
    out_dir: str, device: Union[str, torch.device] = "cuda"
) -> Tuple[Callable[[np.ndarray], np.ndarray], Optional[Dict]]:
    """Load an exported artifact; returns (callable, metadata dict).

    The callable takes a numpy batch of the exported shape and returns the
    probabilities as numpy, as the JAX package's ``load_stablehlo`` does.
    ``device`` must be the device the program was exported on.
    """
    # registers unet::sepconv_block, which a use_pallas graph calls
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv  # noqa: F401

    device = resolve_device(device)
    program = torch.export.load(os.path.join(out_dir, ARTIFACT))
    held = {t.device.type for t in program.state_dict.values()}
    if held and held != {device.type}:
        raise ValueError(f"{out_dir}: the program's weights lie on {sorted(held)}, not "
                         f"{device.type}; export it on the device it is to run on")
    module = program.module()
    meta_path = os.path.join(out_dir, "metadata.json")
    metadata = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)

    def call(images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(device)
        with torch.no_grad():
            return module(x).cpu().numpy()

    return call, metadata
