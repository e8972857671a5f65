"""Synthetic MIDV-style dataset generation.

Produces small document-on-background images with filled-quad masks that
look statistically like the MIDV rasterization output (reference
``scripts/download_dataset_midv.py:52-67``), for CPU-runnable convergence
tests and benchmarking without the FTP download.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def random_quad(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A convex-ish document quad occupying 30-80% of the frame."""
    cx, cy = rng.uniform(0.35, 0.65) * w, rng.uniform(0.35, 0.65) * h
    hw, hh = rng.uniform(0.15, 0.4) * w, rng.uniform(0.15, 0.4) * h
    base = np.array(
        [[cx - hw, cy - hh], [cx + hw, cy - hh], [cx + hw, cy + hh], [cx - hw, cy + hh]]
    )
    jitter = rng.uniform(-0.05, 0.05, (4, 2)) * [w, h]
    quad = np.clip(base + jitter, 0, [w - 1, h - 1])
    return quad.astype(np.float32)


def render_sample(
    rng: np.random.RandomState, h: int, w: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (image_uint8 RGB, mask_uint8 {0,255}, quad (4,2))."""
    import cv2

    quad = random_quad(rng, h, w)
    img = rng.randint(0, 80, (h, w, 3), dtype=np.uint8)  # dark background
    img = cv2.GaussianBlur(img, (5, 5), 0)
    doc_color = rng.randint(150, 255, 3).tolist()
    cv2.fillPoly(img, [quad.astype(np.int32)], doc_color)
    # Some texture lines on the "document"
    for _ in range(4):
        p1 = quad[0] + rng.rand(2) * (quad[2] - quad[0])
        p2 = quad[0] + rng.rand(2) * (quad[2] - quad[0])
        cv2.line(img, tuple(p1.astype(int)), tuple(p2.astype(int)), (60, 60, 90), 1)
    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [quad.astype(np.int32)], 255)
    return img, mask, quad


def random_quad_hard(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A perspective-distorted document quad, 6-60% of the frame."""
    cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
    hw, hh = rng.uniform(0.16, 0.4) * w, rng.uniform(0.16, 0.4) * h
    base = np.array(
        [[-hw, -hh], [hw, -hh], [hw, hh], [-hw, hh]], np.float32
    )
    # in-plane rotation + independent corner jitter ~ perspective
    ang = rng.uniform(0, 2 * np.pi)
    rot = np.array(
        [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]], np.float32
    )
    quad = base @ rot.T + [cx, cy]
    quad += rng.uniform(-0.07, 0.07, (4, 2)) * [w, h]
    return np.clip(quad, 0, [w - 1, h - 1]).astype(np.float32)


def render_sample_hard(
    rng: np.random.RandomState, h: int, w: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hard variant for quality gating: clutter, occlusion, perspective.

    The easy scenes (:func:`render_sample`) are solved to IoU ~ 1.0 by both
    stacks, so a 0.5% acceptance gate has no discriminating power there
    (round-3 verdict).  These scenes are tuned so the TF reference lands
    well below saturation at 256px / 24 epochs:

    * **clutter** — 2-5 bright document-LIKE distractor quads and ellipses
      that are NOT in the mask (shape, not brightness, must be learned),
    * **occlusion** — 0-2 dark blobs overlapping the document; the mask
      stays the full quad (the MIDV convention: fingers over an ID card
      don't shrink its ground-truth quad, download_dataset_midv.py:52-67),
    * **perspective** — rotated quads with strong corner jitter,
    * **photometry** — lighting gradient, Gaussian noise, reduced
      document/background contrast.

    Returns (image_uint8 RGB, mask_uint8 {0,255}, quad (4,2)).
    """
    import cv2

    quad = random_quad_hard(rng, h, w)
    # textured mid-gray background (less contrast with the document)
    img = rng.randint(30, 130, (h, w, 3), dtype=np.uint8)
    img = cv2.GaussianBlur(img, (7, 7), 0)
    # clutter: bright distractor quads/ellipses, document-like colors
    for _ in range(rng.randint(1, 4)):
        if rng.rand() < 0.6:
            dq = random_quad_hard(rng, h, w) * rng.uniform(0.3, 0.8)
            dq += rng.uniform(0, 0.4, 2) * [w, h]
            dq = np.clip(dq, 0, [w - 1, h - 1])
            color = rng.randint(110, 200, 3).tolist()
            cv2.fillPoly(img, [dq.astype(np.int32)], color)
        else:
            center = (rng.randint(0, w), rng.randint(0, h))
            axes = (rng.randint(3, max(4, w // 8)), rng.randint(3, max(4, h // 8)))
            color = rng.randint(110, 200, 3).tolist()
            cv2.ellipse(img, center, axes, rng.uniform(0, 180), 0, 360, color, -1)
    # the document itself: dimmer than the easy variant, textured
    doc_color = rng.randint(130, 230, 3).tolist()
    cv2.fillPoly(img, [quad.astype(np.int32)], doc_color)
    for _ in range(rng.randint(3, 8)):
        p1 = quad[0] + rng.rand(2) * (quad[2] - quad[0])
        p2 = quad[0] + rng.rand(2) * (quad[2] - quad[0])
        shade = rng.randint(40, 120, 3).tolist()
        cv2.line(img, tuple(p1.astype(int)), tuple(p2.astype(int)), shade, 1)
    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [quad.astype(np.int32)], 255)
    # occlusion blobs over the document (mask unchanged — MIDV convention)
    center = quad.mean(axis=0)
    for _ in range(rng.randint(0, 3)):
        r = rng.randint(max(2, min(h, w) // 16), max(3, min(h, w) // 9))
        cx = int(np.clip(center[0] + rng.randint(-w // 6, w // 6 + 1), 0, w - 1))
        cy = int(np.clip(center[1] + rng.randint(-h // 6, h // 6 + 1), 0, h - 1))
        color = rng.randint(10, 90, 3).tolist()
        cv2.circle(img, (cx, cy), r, color, -1)
    # lighting gradient + sensor noise
    gx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :]
    gy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None]
    grad = 1.0 + rng.uniform(-0.25, 0.25) * gx + rng.uniform(-0.25, 0.25) * gy
    fimg = img.astype(np.float32) * grad[..., None]
    fimg += rng.normal(0.0, rng.uniform(3.0, 9.0), fimg.shape)
    img = np.clip(fimg, 0, 255).astype(np.uint8)
    return img, mask, quad


def write_synthetic_dataset(
    root: str,
    n_train: int = 16,
    n_val: int = 4,
    image_size: Tuple[int, int] = (64, 64),
    seed: int = 230,
    style: str = "easy",
) -> str:
    """Write the reference directory contract under ``root``.

    Layout (reference scripts/train.py:79-82):
    ``{root}/{train,val}_{frames,masks}/image/image{N}.png``

    ``style='hard'`` uses :func:`render_sample_hard` (cluttered, occluded,
    perspective scenes for the de-saturated quality gate).
    """
    import cv2

    render = render_sample_hard if style == "hard" else render_sample
    rng = np.random.RandomState(seed)
    h, w = image_size
    splits = {"train": n_train, "val": n_val}
    for split, n in splits.items():
        fdir = os.path.join(root, f"{split}_frames", "image")
        mdir = os.path.join(root, f"{split}_masks", "image")
        os.makedirs(fdir, exist_ok=True)
        os.makedirs(mdir, exist_ok=True)
        for i in range(n):
            img, mask, _ = render(rng, h, w)
            cv2.imwrite(os.path.join(fdir, f"image{i:04d}.png"), img[..., ::-1])
            cv2.imwrite(os.path.join(mdir, f"image{i:04d}.png"), mask)
    return root


def write_synthetic_multiclass_dataset(
    root: str,
    n_train: int = 16,
    n_val: int = 4,
    image_size: Tuple[int, int] = (64, 64),
    num_classes: int = 3,
    seed: int = 230,
    style: str = "easy",
) -> str:
    """Multi-class variant (BASELINE configs[3]): class-id masks.

    Class 0 = background, 1 = document quad, 2 = a circular 'seal'
    (and further ellipses for num_classes > 3). Masks store raw class ids.
    ``style='hard'`` renders the cluttered/occluded scenes of
    :func:`render_sample_hard` (the de-saturated quality-gate style).
    """
    import cv2

    render = render_sample_hard if style == "hard" else render_sample
    rng = np.random.RandomState(seed)
    h, w = image_size
    for split, n in {"train": n_train, "val": n_val}.items():
        fdir = os.path.join(root, f"{split}_frames", "image")
        mdir = os.path.join(root, f"{split}_masks", "image")
        os.makedirs(fdir, exist_ok=True)
        os.makedirs(mdir, exist_ok=True)
        for i in range(n):
            img, mask255, quad = render(rng, h, w)
            mask = (mask255 > 0).astype(np.uint8)  # class 1
            center = quad.mean(axis=0)
            for cls in range(2, num_classes):
                r = max(2, int(0.08 * min(h, w)))
                cx = int(center[0] + rng.randint(-r, r + 1))
                cy = int(center[1] + rng.randint(-r, r + 1))
                color = rng.randint(0, 120, 3).tolist()
                cv2.circle(img, (cx, cy), r, color, -1)
                cv2.circle(mask, (cx, cy), r, int(cls), -1)
            cv2.imwrite(os.path.join(fdir, f"image{i:04d}.png"), img[..., ::-1])
            cv2.imwrite(os.path.join(mdir, f"image{i:04d}.png"), mask)
    return root


def synthetic_batch(
    rng: np.random.RandomState,
    batch_size: int,
    image_size: Tuple[int, int] = (256, 256),
) -> Tuple[np.ndarray, np.ndarray]:
    """In-memory (images, masks) float32 batch for benchmarks."""
    h, w = image_size
    imgs = np.empty((batch_size, h, w, 3), np.float32)
    masks = np.empty((batch_size, h, w, 1), np.float32)
    for i in range(batch_size):
        img, mask, _ = render_sample(rng, h, w)
        imgs[i] = img.astype(np.float32) / 255.0
        masks[i] = (mask.astype(np.float32) / 255.0)[..., None]
    return imgs, masks
