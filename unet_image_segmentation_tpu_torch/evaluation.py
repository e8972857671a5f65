"""Dataset evaluation: the batched MeanIoU benchmark.

Port of ``unet_image_segmentation_tpu/evaluation.py``, with its semantics:

* pairs ``<dir>/images/**/<glob>`` with ``<dir>/ground_truth/<relpath>.json``
  (:func:`find_pairs`; the glob defaults to ``*.tif``);
* ground truth: the JSON ``"quad"`` polygon rasterized filled at the size of
  the companion .tif/.png/.jpg (else 2048x2048), nearest-resized to the
  model size, binarized ``> 128`` (:func:`rasterize_quad_mask`);
* images: BGR, /255, bilinear resize (:func:`load_eval_image`);
* the last batch padded to the batch size by repeating its last image;
  per-sample smoothed IoU of the binarized predictions, the below-threshold
  list (ascending) and its CSV, and the dataset's confusion-matrix MeanIoU.

The loop body is :func:`evaluate_batches`, a batched core over ``(ids,
images, masks)`` arrays; :func:`evaluate` feeds it from a thread pool that
reads the files (cv2 is imported only there), and a caller with arrays in
memory feeds it directly.
"""

from __future__ import annotations

import glob as globlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unet_image_segmentation_tpu_torch.inference import Predictor
from unet_image_segmentation_tpu_torch.ops.metrics import (
    MeanIoUState,
    mean_iou_result,
    mean_iou_update,
    sample_iou,
)


def find_pairs(input_dir: str, image_glob: str = "*.tif") -> List[Dict[str, str]]:
    """The (image, JSON) pairs under ``input_dir``, sorted by image path."""
    images_root = os.path.join(input_dir, "images")
    gt_root = os.path.join(input_dir, "ground_truth")
    files = sorted(globlib.glob(os.path.join(images_root, "**", image_glob), recursive=True))
    pairs = []
    for img_path in files:
        rel = os.path.relpath(img_path, images_root)
        base = os.path.splitext(rel)[0]
        json_path = os.path.join(gt_root, base + ".json")
        if os.path.isfile(json_path):
            pairs.append({"image": img_path, "json": json_path, "id": base})
    return pairs


def rasterize_quad_mask(
    json_path: str,
    target_hw: Tuple[int, int],
    default_size: Tuple[int, int] = (2048, 2048),
) -> np.ndarray:
    """JSON 'quad' -> (H, W) uint8 {0,1} mask at model resolution."""
    import cv2

    with open(json_path) as f:
        quad = json.load(f).get("quad", [])

    # the companion image's size is the canvas
    orig_h = orig_w = -1
    img_base = json_path.replace(
        os.sep + "ground_truth" + os.sep, os.sep + "images" + os.sep
    )[: -len(".json")]
    for ext in (".tif", ".png", ".jpg"):
        candidate = img_base + ext
        if os.path.exists(candidate):
            probe = cv2.imread(candidate, cv2.IMREAD_UNCHANGED)
            if probe is not None:
                orig_h, orig_w = probe.shape[:2]
                break
    if orig_h <= 0 or orig_w <= 0:
        orig_h, orig_w = default_size

    canvas = np.zeros((orig_h, orig_w), np.uint8)
    if quad:
        pts = np.asarray(quad, np.int32).reshape(-1, 1, 2)
        cv2.drawContours(canvas, [pts], -1, color=255, thickness=cv2.FILLED)
    th, tw = target_hw
    resized = cv2.resize(canvas, (tw, th), interpolation=cv2.INTER_NEAREST)
    return (resized > 128).astype(np.uint8)


def load_eval_image(img_path: str, target_hw: Tuple[int, int]) -> np.ndarray:
    """BGR -> /255 -> bilinear resize to ``target_hw``."""
    import cv2

    img = cv2.imread(img_path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read {img_path}")
    img = img.astype(np.float32) / 255.0
    th, tw = target_hw
    if img.shape[:2] != (th, tw):
        img = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
    return img


@dataclass
class EvalResult:
    mean_iou: float
    per_sample: List[Tuple[str, float]] = field(default_factory=list)
    low_iou: List[Tuple[str, float]] = field(default_factory=list)
    n_evaluated: int = 0
    elapsed_sec: float = 0.0
    images_per_sec: float = 0.0


def evaluate_batches(
    predictor: Predictor,
    batches: Iterable[Tuple[Sequence[str], np.ndarray, np.ndarray]],
    iou_threshold: float = 0.9,
    pred_threshold: float = 0.5,
    batch_size: int = 8,
    total: Optional[int] = None,
    verbose: bool = False,
) -> EvalResult:
    """The batched core of :func:`evaluate`: each item of ``batches`` is
    ``(ids, images (n, H, W, 3) float32, masks (n, H, W) {0,1})`` with ``n <=
    batch_size``; a short batch is padded to ``batch_size`` by repeating its
    last image. The elapsed time counts from the first item's request, so it
    includes whatever producing the items costs."""
    t0 = time.perf_counter()
    # counts accumulate in float64: a cell may pass 2^24 pixels
    state = MeanIoUState(cm=torch.zeros((2, 2), dtype=torch.float64))
    per_sample: List[Tuple[str, float]] = []
    for ids, imgs, masks in batches:
        n = len(ids)
        pad = batch_size - n
        if pad > 0:  # the predictor's shape stays the batch size's
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
        probs = predictor.predict(imgs)[:n]
        preds = torch.from_numpy((probs > pred_threshold).astype(np.uint8))
        truth = torch.from_numpy(np.asarray(masks)[..., None])
        ious = sample_iou(truth, preds)
        state = mean_iou_update(state, truth, preds)
        per_sample.extend((i, float(iou)) for i, iou in zip(ids, ious.tolist()))
        if verbose:
            print(f"\rEvaluating [{len(per_sample)}/{total or '?'}]", end="")
    if verbose:
        print()
    elapsed = time.perf_counter() - t0
    low = sorted([(i, s) for i, s in per_sample if s < iou_threshold], key=lambda t: t[1])
    return EvalResult(
        mean_iou=float(mean_iou_result(state)),
        per_sample=per_sample,
        low_iou=low,
        n_evaluated=len(per_sample),
        elapsed_sec=elapsed,
        images_per_sec=len(per_sample) / elapsed if elapsed > 0 else 0.0,
    )


def evaluate(
    predictor: Predictor,
    input_dir: str,
    iou_threshold: float = 0.9,
    pred_threshold: float = 0.5,
    batch_size: int = 8,
    image_glob: str = "*.tif",
    num_workers: int = 8,
    low_score_log: Optional[str] = None,
    verbose: bool = True,
) -> EvalResult:
    """MeanIoU of ``predictor`` over the pairs under ``input_dir``; the
    files are read in ``num_workers`` threads while the predictor runs, and
    the below-threshold files go to the ``low_score_log`` CSV."""
    pairs = find_pairs(input_dir, image_glob)
    if not pairs:
        raise FileNotFoundError(f"no image/JSON pairs under {input_dir} (glob {image_glob!r})")
    target_hw = predictor.image_size

    def load_pair(pair):
        return load_eval_image(pair["image"], target_hw), rasterize_quad_mask(pair["json"],
                                                                              target_hw)

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        def batches():
            for start in range(0, len(pairs), batch_size):
                chunk = pairs[start:start + batch_size]
                loaded = list(pool.map(load_pair, chunk))
                yield ([p["id"] for p in chunk], np.stack([im for im, _ in loaded]),
                       np.stack([mk for _, mk in loaded]))

        result = evaluate_batches(predictor, batches(), iou_threshold, pred_threshold,
                                  batch_size, total=len(pairs), verbose=verbose)
    if low_score_log:
        log_dir = os.path.dirname(low_score_log)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        with open(low_score_log, "w") as f:
            f.write("FileID,MeanIoU_Score\n")
            for file_id, score in result.low_iou:
                f.write(f"{file_id},{score:.4f}\n")
    return result
