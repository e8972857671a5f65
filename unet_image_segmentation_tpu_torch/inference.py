"""Single-image and batched inference.

Port of ``unet_image_segmentation_tpu/inference.py``, its host code
re-implemented here:

* preprocess: BGR image -> float32/255 -> bilinear resize to the model size
  (normalize, then resize);
* forward: the serving graph of fused kernels (``use_pallas=True``), its
  int8 twin (``quantize='int8'``, :mod:`.serving_quant`) or the module
  path;
* postprocess: bilinear-resize the probabilities to the original size, then
  threshold; bbox or quad-warp crop through :mod:`.utils.image`.

``Predictor`` uses the device it is given and nothing else: with
``use_pallas=True`` it builds the kernel graph or raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from unet_image_segmentation_tpu_torch.utils.image import (
    binarize_mask,
    extract_object_from_mask,
    largest_contour_bbox,
)
from unet_image_segmentation_tpu_torch.models.unet import UNet
from unet_image_segmentation_tpu_torch.serving import build_serving_forward
from unet_image_segmentation_tpu_torch.serving_quant import (
    build_serving_forward_quant,
    calibrate_chained,
)
from unet_image_segmentation_tpu_torch.train.checkpoint import load_inference_variables
from unet_image_segmentation_tpu_torch.weights import flax_from_state_dict

_MODEL_KWARGS = ("num_classes", "filters", "dropout_rate", "use_batch_norm", "conv_type")


class Predictor:
    """Checkpoint-backed forward pass with power-of-two batch buckets.

    ``predict`` pads a ragged batch up to the next power of two, so a
    dataset's last partial batch runs at a shape already seen.

    ``quantize='int8'`` serves the int8 graph (:mod:`.serving_quant`): the
    first ``predict`` batch, after the bucket padding, is the calibration
    sample (``quant_scales``); the graph is built then, once, and later
    batches reuse it. ``serving_kwargs`` holds the graph's ``num_classes``,
    ``depth`` and ``compute_dtype``. Two departures from the JAX
    ``Predictor``, both so that nothing hides the kernel: ``quantize``
    without ``use_pallas=True`` raises ``ValueError`` (JAX warns and ignores
    it), and a failure while building or running the int8 graph raises
    (JAX warns and serves the float graph).
    """

    def __init__(
        self,
        model_path: str,
        image_size: Tuple[int, int] = (256, 256),
        compute_dtype: str = "float32",
        use_pallas: bool = False,
        quantize: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        if quantize and not use_pallas:
            raise ValueError("quantize='int8' runs the int8 kernel graph and needs use_pallas=True")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        state_dict, inferred = load_inference_variables(model_path)
        kwargs = {k: v for k, v in (inferred or {}).items() if k in _MODEL_KWARGS}
        dtype = getattr(torch, compute_dtype)
        self.model = UNet(dtype=dtype, **kwargs)
        self.model.load_state_dict(state_dict)
        self.image_size = image_size
        self.serving_kwargs: Optional[Dict[str, Any]] = None
        self.quant_scales: Optional[Dict[str, float]] = None
        self._quantize = quantize
        self._forward = None
        if use_pallas:
            if kwargs.get("conv_type", "separable") != "separable":
                raise ValueError("use_pallas=True needs a separable-conv model")
            self.variables = flax_from_state_dict(state_dict)
            self.serving_kwargs = dict(num_classes=self.model.num_classes,
                                       depth=len(self.model.filters), compute_dtype=dtype)
            if not quantize:
                self._forward = build_serving_forward(
                    self.variables, **self.serving_kwargs, device=self.device)
        else:
            self.model.to(self.device)
            self._forward = torch.no_grad()(self.model)

    @property
    def num_classes(self) -> int:
        return self.model.num_classes

    @property
    def forward_fn(self):
        """The forward ((B, H, W, C) float tensor on the device -> fp32
        probabilities on it) for composing into larger pipelines such as
        :class:`.streaming.StreamingPredictor`; None while an int8 graph
        waits for its calibration batch (JAX's is the float graph then)."""
        return self._forward

    def predict(self, images: np.ndarray) -> np.ndarray:
        """(B, H, W, C) float32 -> (B, H, W, num_classes) probabilities."""
        b = int(images.shape[0])
        bucket = 1 << max(b - 1, 0).bit_length()
        if bucket != b:
            pad = np.zeros((bucket - b, *images.shape[1:]), dtype=images.dtype)
            images = np.concatenate([np.asarray(images), pad], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(self.device)
        if self._quantize == "int8":
            # the first batch is the calibration sample; built once
            self.quant_scales = calibrate_chained(self.variables, x, **self.serving_kwargs)
            self._forward = build_serving_forward_quant(
                self.variables, self.quant_scales, **self.serving_kwargs, device=self.device)
            self._quantize = None
        out = self._forward(x)
        return out[:b].float().cpu().numpy()


def preprocess_image(
    img_bgr: np.ndarray,
    target_hw: Tuple[int, int],
    channel_order: str = "bgr",
) -> np.ndarray:
    """Normalize (1/255) then bilinear-resize; returns (1, H, W, 3) float32."""
    import cv2

    if channel_order == "rgb":
        img_bgr = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)
    img = img_bgr.astype(np.float32) / 255.0
    th, tw = target_hw
    if img.shape[:2] != (th, tw):
        img = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
    return img[None]


def postprocess_mask(
    prob_mask: np.ndarray,
    orig_hw: Tuple[int, int],
    threshold: float = 0.5,
) -> np.ndarray:
    """(H, W, 1) probabilities -> (origH, origW) uint8 {0, 255} mask:
    bilinear resize to the original size, then threshold."""
    import cv2

    if prob_mask.ndim == 3 and prob_mask.shape[-1] == 1:
        prob_mask = prob_mask[..., 0]
    oh, ow = orig_hw
    if prob_mask.shape != (oh, ow):
        prob_mask = cv2.resize(prob_mask, (ow, oh), interpolation=cv2.INTER_LINEAR)
    return binarize_mask(prob_mask, threshold)


def run_inference(
    predictor: Predictor,
    input_path: str,
    output_mask: str = "./outputs_test/output_mask.png",
    output_cropped: str = "./outputs_test/output_cropped.png",
    threshold: float = 0.5,
    min_contour_area: float = 100.0,
    crop_mode: str = "bbox",
    channel_order: str = "bgr",
    verbose: bool = True,
) -> Dict[str, Any]:
    """Full single-image pipeline. Returns a result summary dict."""
    import cv2

    original_bgr = cv2.imread(input_path, cv2.IMREAD_COLOR)
    if original_bgr is None:
        raise IOError(f"could not read image {input_path}")
    orig_hw = original_bgr.shape[:2]

    batch = preprocess_image(original_bgr, predictor.image_size, channel_order)
    prob = predictor.predict(batch)[0]
    if predictor.num_classes > 1:
        # softmax head: upsample each class, argmax to a class map; the saved
        # mask holds class ids and the crop uses the foreground (class > 0)
        oh, ow = orig_hw
        prob_up = np.stack(
            [
                cv2.resize(prob[..., c], (ow, oh), interpolation=cv2.INTER_LINEAR)
                for c in range(prob.shape[-1])
            ],
            axis=-1,
        )
        class_map = np.argmax(prob_up, axis=-1).astype(np.uint8)
        binary_mask = (class_map > 0).astype(np.uint8) * 255
        mask_to_save = class_map
    else:
        binary_mask = postprocess_mask(prob, orig_hw, threshold)
        mask_to_save = binary_mask

    os.makedirs(os.path.dirname(os.path.abspath(output_mask)), exist_ok=True)
    cv2.imwrite(output_mask, mask_to_save)
    if verbose:
        print(f"Saved binary mask -> {output_mask}")

    result: Dict[str, Any] = {
        "mask_path": output_mask,
        "cropped_path": None,
        "bbox": None,
        "mask_area_frac": float((binary_mask > 0).mean()),
        "num_classes": predictor.num_classes,
    }

    cropped = None
    if crop_mode == "warp":
        warped_rgb = extract_object_from_mask(
            binary_mask, original_bgr, min_contour_area=min_contour_area
        )
        if warped_rgb is not None:
            cropped = cv2.cvtColor(warped_rgb, cv2.COLOR_RGB2BGR)
    else:
        bbox = largest_contour_bbox(binary_mask, min_contour_area)
        if bbox is not None:
            x, y, w, h = bbox
            cropped = original_bgr[y : y + h, x : x + w]
            result["bbox"] = bbox
    if cropped is not None and cropped.size:
        os.makedirs(os.path.dirname(os.path.abspath(output_cropped)), exist_ok=True)
        cv2.imwrite(output_cropped, cropped)
        result["cropped_path"] = output_cropped
        if verbose:
            print(f"Saved cropped object -> {output_cropped}")
    elif verbose:
        print("No contour above min area; cropped image not saved.")
    return result
