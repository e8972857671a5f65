"""Device-side preprocessing: resize, normalise, pad.

Port of ``unet_image_segmentation_tpu/ops/preprocess.py``. Compact uint8
frames go to the device, and the float work (normalise, bilinear resize,
optional pad) runs there.

:func:`resize_bilinear` reproduces OpenCV's ``INTER_LINEAR`` convention
(half-pixel-centre sampling, edge clamping), so device outputs match a
host cv2 pipeline within float tolerance. It runs as two products with
banded (out, in) interpolation matrices, two entries a row, as the JAX
package computes it; they are plain fp32 matmuls, run with TF32 off so
that the card's answer is the CPU's within fp32 rounding.

:func:`_linear_coords` and :func:`_resize_matrix` are copies of the JAX
package's numpy helpers.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _linear_coords(out_size: int, in_size: int):
    """OpenCV INTER_LINEAR source coordinates: half-pixel centres, clamped."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1.0)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


@functools.lru_cache(maxsize=64)
def _resize_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) interpolation matrix: row o holds (1-frac) at lo[o] and
    frac at hi[o] (accumulated when they coincide at a clamped edge)."""
    lo, hi, frac = _linear_coords(out_size, in_size)
    mat = np.zeros((out_size, in_size), np.float32)
    np.add.at(mat, (np.arange(out_size), lo), 1.0 - frac)
    np.add.at(mat, (np.arange(out_size), hi), frac)
    return mat


@contextlib.contextmanager
def fp32_products() -> Iterator[None]:
    """Matmuls in full fp32 (TF32 off) inside the block, the flag restored
    after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@functools.lru_cache(maxsize=64)
def _matrix(out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    """The (out, in) matrix on ``device``, copied there once: a stream
    resizes every batch with the same four matrices."""
    return torch.from_numpy(_resize_matrix(out_size, in_size)).to(device)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (..., H, W, C) -> (..., H', W', C), cv2 convention,
    fp32 and contiguous out (x itself when the size does not change).

    Two fp32 products with the banded matrices: each output row (column) is
    a two-term convex combination of input rows (columns)."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    out = x.float()
    with fp32_products():
        if oh != h:
            out = torch.einsum("ij,...jwc->...iwc", _matrix(oh, h, x.device), out)
        if ow != w:
            out = torch.einsum("kj,...hjc->...hkc", _matrix(ow, w, x.device), out)
    return out.contiguous()


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize with OpenCV's INTER_NEAREST index rule
    (``src = floor(dst * in / out)``)."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    yi = np.minimum((np.arange(oh) * (h / oh)).astype(np.int32), h - 1)
    xi = np.minimum((np.arange(ow) * (w / ow)).astype(np.int32), w - 1)
    x = torch.index_select(x, x.dim() - 3, torch.from_numpy(yi).to(x.device, torch.int64))
    return torch.index_select(x, x.dim() - 2, torch.from_numpy(xi).to(x.device, torch.int64))


def preprocess_frames(
    frames_u8: torch.Tensor,
    out_hw: Tuple[int, int],
    pad_to: Optional[Tuple[int, int]] = None,
    dtype_name: str = "float32",
) -> torch.Tensor:
    """uint8 frames (..., H, W, C) -> /255 -> bilinear resize -> zero pad at
    the bottom and right up to ``pad_to`` -> ``dtype_name``, the
    reference's normalise-then-resize order."""
    x = resize_bilinear(frames_u8.float() / 255.0, out_hw)
    if pad_to is not None and tuple(pad_to) != tuple(out_hw):
        (ph, pw), (oh, ow) = pad_to, out_hw
        x = F.pad(x, (0, 0, 0, pw - ow, 0, ph - oh))
    return x.to(getattr(torch, dtype_name))


def postprocess_probs(probs: torch.Tensor, orig_hw: Tuple[int, int]) -> torch.Tensor:
    """Probabilities resized back to the original resolution (bilinear);
    the threshold stays with the caller."""
    return resize_bilinear(probs, orig_hw)
