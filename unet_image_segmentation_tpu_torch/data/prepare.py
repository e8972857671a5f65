"""Offline 16x dataset augmenter.

Rebuilds reference ``scripts/prepare_dataset.py`` (SURVEY.md §2.1): for each
raw (image, quad-JSON) pair, emit 4 geometric variants (identity / rot90 CW /
rot90 CCW / horizontal flip) x 4 blur variants (none / median-9 / Gaussian-9
/ box-9) = 16 ``.tif`` + ``.json`` outputs.  Quad annotations for
transformed variants are re-derived from the transformed mask via
``minAreaRect`` + ``boxPoints`` (reference ``prepare_dataset.py:44-58`` —
using ``np.intp`` instead of the deprecated ``np.int0``, SURVEY.md §7.4).
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import shutil
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from unet_image_segmentation_tpu_torch.data.midv import quad_to_mask


def read_annotated_image(
    img_path: str, json_path: str
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], List]:
    """Load (image, rasterized mask, quad) for one raw pair."""
    import cv2

    image = cv2.imread(img_path)
    if image is None:
        return None, None, []
    with open(json_path) as f:
        quad = json.load(f).get("quad", [])
    mask = quad_to_mask(quad, image.shape[:2])
    return image, mask, quad


def quad_from_mask(mask: np.ndarray) -> Dict[str, List]:
    """Re-derive a quad annotation from a transformed binary mask."""
    import cv2

    contours, _ = cv2.findContours(mask, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return {"quad": []}
    approx = cv2.approxPolyDP(contours[0], 10, True)
    box = cv2.boxPoints(cv2.minAreaRect(approx)).astype(np.intp)
    return {"quad": [[int(x), int(y)] for x, y in box]}


def geometric_variants(image: np.ndarray, mask: np.ndarray, quad: List):
    """Yield (image, mask, quad_info) for the 4 geometric transforms."""
    import cv2

    yield image.copy(), mask.copy(), {"quad": quad}
    for rot in (cv2.ROTATE_90_CLOCKWISE, cv2.ROTATE_90_COUNTERCLOCKWISE):
        im = cv2.rotate(image, rot)
        mk = cv2.rotate(mask, rot)
        yield im, mk, quad_from_mask(mk)
    im = cv2.flip(image, 1)
    mk = cv2.flip(mask, 1)
    yield im, mk, quad_from_mask(mk)


def blur_variants(image: np.ndarray):
    """Yield the 4 blur variants (none / median / Gaussian / box, k=9)."""
    import cv2

    yield image
    yield cv2.medianBlur(image, 9)
    yield cv2.GaussianBlur(image, (9, 9), 0)
    yield cv2.blur(image, (9, 9))


def adjust_brightness_contrast(
    image: np.ndarray, alpha: float = 1.0, beta: float = 0.0
) -> np.ndarray:
    """Contrast (alpha) / brightness (beta) helper (parity with the
    reference's unused ``change_brightness_contrast``)."""
    import cv2

    return cv2.convertScaleAbs(image, alpha=alpha, beta=beta)


def augment_dataset(
    import_glob: str,
    annotation_glob: str,
    image_out_dir: str,
    annotation_out_dir: str,
) -> int:
    """Run the 16x augmentation; returns number of outputs written."""
    import cv2

    for d in (image_out_dir, annotation_out_dir):
        if os.path.exists(d):
            shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d, exist_ok=True)

    imgs = sorted(globlib.glob(import_glob))
    labels = sorted(globlib.glob(annotation_glob))
    if len(imgs) != len(labels):
        print(
            f"Warning: {len(imgs)} images vs {len(labels)} annotations; "
            "pairing by sorted order"
        )
    written = 0
    for i, (img_path, json_path) in enumerate(zip(imgs, labels)):
        image, mask, quad = read_annotated_image(img_path, json_path)
        if image is None:
            print(f"Warning: unreadable {img_path}; skipping")
            continue
        stem = os.path.basename(img_path).split(".")[0]
        img_dir = os.path.join(image_out_dir, stem)
        ann_dir = os.path.join(annotation_out_dir, stem)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(ann_dir, exist_ok=True)
        for j, (im, mk, quad_info) in enumerate(geometric_variants(image, mask, quad)):
            for k, variant in enumerate(blur_variants(im)):
                name = f"{stem}_{i}_{j}_{k}"
                with open(os.path.join(ann_dir, name + ".json"), "w") as f:
                    json.dump(quad_info, f)
                cv2.imwrite(os.path.join(img_dir, name + ".tif"), variant)
                written += 1
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="16x offline augmentation (rotations/flip x blurs)."
    )
    p.add_argument("--import_files", default="../datasets/data/images/raw_selfie/*")
    p.add_argument("--annotation_dir", default="../datasets/data/ground_truth/raw_selfie/*")
    p.add_argument("--image_result_dir", default="../datasets/data/images/selfie/")
    p.add_argument("--annotation_result_dir", default="../datasets/data/ground_truth/selfie/")
    args = p.parse_args(argv)
    n = augment_dataset(
        args.import_files,
        args.annotation_dir,
        args.image_result_dir,
        args.annotation_result_dir,
    )
    print(f"Wrote {n} augmented image/annotation pairs")
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
