"""Host-side contour/warp post-processing (OpenCV).

The port's own copy of ``unet_image_segmentation_tpu/utils/image.py``.
``cv2`` is imported inside each function that needs it, so the module
imports where OpenCV is not installed.

Geometry post-processing is inherently sequential, tiny-cost host work —
the one part of the stack that stays off-device.  API parity with the
reference library (``utils/image.py``):

* :func:`order_points` — order 4 quad corners TL/TR/BR/BL
  (reference ``utils/image.py:5-32``).
* :func:`four_point_transform` — perspective-warp a quad region to a
  rectangle sized by its max edge lengths (``utils/image.py:34-77``).
* :func:`extract_object_from_mask` — threshold -> optional bilateral +
  median smoothing -> external contours by area -> first 4-vertex
  approxPolyDP(eps=0.02*arcLength) above min area -> warp -> RGB
  (``utils/image.py:80-181``).  This is the provided-but-unwired quad-warp
  crop mode; the default inference crop is the bbox mode in
  :func:`largest_contour_bbox` (reference ``scripts/inference.py:172-197``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def order_points(pts: np.ndarray) -> np.ndarray:
    """Order 4 points as [top-left, top-right, bottom-right, bottom-left].

    TL has the min coordinate sum, BR the max; TR has the min (y - x)
    difference, BL the max — the classic sum/diff trick.
    """
    pts = np.asarray(pts, dtype=np.float32)
    if pts.shape != (4, 2):
        raise ValueError(f"expected (4, 2) points, got {pts.shape}")
    ordered = np.empty((4, 2), dtype=np.float32)
    sums = pts.sum(axis=1)
    diffs = np.diff(pts, axis=1).ravel()
    ordered[0] = pts[np.argmin(sums)]
    ordered[2] = pts[np.argmax(sums)]
    ordered[1] = pts[np.argmin(diffs)]
    ordered[3] = pts[np.argmax(diffs)]
    return ordered


def four_point_transform(image: np.ndarray, pts: np.ndarray) -> Optional[np.ndarray]:
    """Perspective-warp the quad ``pts`` out of ``image``.

    Output size = max of opposing edge lengths (int-truncated), matching
    the reference's sizing rule so warped crops are pixel-identical.
    """
    import cv2

    rect = order_points(pts)
    tl, tr, br, bl = rect

    def _dist(a, b) -> int:
        return int(np.sqrt(((a - b) ** 2).sum()))

    width = max(_dist(br, bl), _dist(tr, tl))
    height = max(_dist(tr, br), _dist(tl, bl))
    if width <= 0 or height <= 0:
        return None
    dst = np.array(
        [[0, 0], [width - 1, 0], [width - 1, height - 1], [0, height - 1]],
        dtype=np.float32,
    )
    matrix = cv2.getPerspectiveTransform(rect, dst)
    return cv2.warpPerspective(image, matrix, (width, height))


def binarize_mask(mask: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Float [0,1] / uint8 / bool mask -> uint8 {0, 255}."""
    if mask.dtype in (np.float32, np.float64):
        return ((mask > threshold).astype(np.uint8)) * 255
    if mask.dtype == np.bool_:
        return mask.astype(np.uint8) * 255
    return mask.astype(np.uint8)


def extract_object_from_mask(
    mask: np.ndarray,
    image: np.ndarray,
    threshold: float = 0.5,
    bilateral_params: Optional[Tuple[int, int, int]] = (11, 17, 17),
    median_ksize: Optional[int] = 5,
    approx_poly_epsilon_factor: float = 0.02,
    min_contour_area: float = 100.0,
) -> Optional[np.ndarray]:
    """Quad-warp crop: find the largest ~quadrilateral object and rectify it.

    Returns the warped object in RGB, or None when no 4-vertex contour of
    sufficient area exists.
    """
    import cv2

    if mask is None or image is None:
        return None
    if mask.shape[:2] != image.shape[:2]:
        raise ValueError(
            f"mask {mask.shape[:2]} and image {image.shape[:2]} size mismatch"
        )
    work = binarize_mask(mask, threshold)
    if work.ndim == 3:
        work = work[:, :, 0] if work.shape[2] != 3 else cv2.cvtColor(work, cv2.COLOR_BGR2GRAY)

    if bilateral_params is not None:
        work = cv2.bilateralFilter(work, *bilateral_params)
    if median_ksize is not None and median_ksize > 1 and median_ksize % 2 == 1:
        work = cv2.medianBlur(work, median_ksize)
    if cv2.countNonZero(work) == 0:
        return None

    contours, _ = cv2.findContours(work, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    quad = None
    for contour in sorted(contours, key=cv2.contourArea, reverse=True):
        area = cv2.contourArea(contour)
        if area < min_contour_area:
            break
        eps = approx_poly_epsilon_factor * cv2.arcLength(contour, True)
        approx = cv2.approxPolyDP(contour, eps, True)
        if len(approx) == 4:
            quad = approx.reshape(4, 2)
            break
    if quad is None:
        return None
    warped = four_point_transform(image, quad)
    if warped is None:
        return None
    return cv2.cvtColor(warped, cv2.COLOR_BGR2RGB)


def largest_contour_bbox(
    binary_mask: np.ndarray, min_contour_area: float = 100.0
) -> Optional[Tuple[int, int, int, int]]:
    """Bounding box (x, y, w, h) of the largest contour above min area.

    The default inference crop rule (reference scripts/inference.py:172-190).
    """
    import cv2

    contours, _ = cv2.findContours(
        binary_mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    if not contours:
        return None
    largest = max(contours, key=cv2.contourArea)
    if cv2.contourArea(largest) <= min_contour_area:
        return None
    return tuple(cv2.boundingRect(largest))
