"""Functional convolution ops in plain torch, NHWC with Keras-layout kernels.

Counterpart of ``unet_image_segmentation_tpu/ops/conv.py``; shapes and
semantics are the same:

* depthwise kernel  ``(kh, kw, C, 1)``
* pointwise kernel  ``(1, 1, C, F)`` or ``(C, F)``
* full kernel       ``(kh, kw, C, F)``
* transpose kernel  ``(2, 2, F, C)``

Kernels are cast to the activation dtype before use, as the JAX ops do.

Besides 'SAME' and 'VALID', the 3x3 convs take ``padding='ROWS_PADDED'``:
the input's rows already hold the halo rows (a row shard padded by
:func:`..parallel.halo.halo_exchange_grad`), so rows are 'VALID' and
columns 'SAME'.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _padding(padding: str, kw: int):
    if padding.upper() == "SAME":
        return "same"
    if padding.upper() == "VALID":
        return 0
    if padding.upper() == "ROWS_PADDED":
        if kw % 2 == 0:
            raise ValueError(f"'ROWS_PADDED' needs an odd kernel width, got {kw}")
        return (0, kw // 2)
    raise ValueError(f"padding must be 'SAME', 'VALID' or 'ROWS_PADDED', got {padding!r}")


def depthwise_conv2d(
    x: torch.Tensor, kernel: torch.Tensor, *, padding: str = "SAME"
) -> torch.Tensor:
    """Depthwise 2-D conv, channel multiplier 1. x (B,H,W,C); kernel (kh,kw,C,1)."""
    kh, kw, c, mult = kernel.shape
    if mult != 1:
        raise ValueError("depth multiplier != 1 not supported")
    w = kernel[..., 0].permute(2, 0, 1).unsqueeze(1).to(x.dtype)  # (C,1,kh,kw)
    return _nhwc(F.conv2d(_nchw(x), w, padding=_padding(padding, kw), groups=c))


def pointwise_conv2d(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """1x1 conv as a matmul. kernel (1,1,C,F) or (C,F)."""
    if kernel.dim() == 4:
        kernel = kernel.reshape(kernel.shape[-2], kernel.shape[-1])
    y = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def separable_conv2d(
    x: torch.Tensor,
    depthwise_kernel: torch.Tensor,
    pointwise_kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    padding: str = "SAME",
) -> torch.Tensor:
    """SeparableConv2D = depthwise then pointwise (+ optional bias)."""
    y = depthwise_conv2d(x, depthwise_kernel, padding=padding)
    return pointwise_conv2d(y, pointwise_kernel, bias)


def separable_conv2d_pair(
    a: torch.Tensor,
    b: torch.Tensor,
    depthwise_kernel: torch.Tensor,
    pointwise_kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    padding: str = "SAME",
) -> torch.Tensor:
    """``separable_conv2d(cat([a, b], -1), ...)`` as two half-convs summed.

    Depthwise acts per channel and the 1x1 conv is linear in channels, so
    the concat factors exactly; the kernels are sliced views.
    """
    ca = a.shape[-1]
    pw = pointwise_kernel.reshape(pointwise_kernel.shape[-2], pointwise_kernel.shape[-1])
    ya = depthwise_conv2d(a, depthwise_kernel[:, :, :ca], padding=padding)
    yb = depthwise_conv2d(b, depthwise_kernel[:, :, ca:], padding=padding)
    y = torch.matmul(ya, pw[:ca].to(ya.dtype)) + torch.matmul(yb, pw[ca:].to(yb.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    padding: str = "SAME",
) -> torch.Tensor:
    """Plain 2-D conv; kernel (kh, kw, C, F)."""
    w = kernel.permute(3, 2, 0, 1).to(x.dtype)  # (F, C, kh, kw)
    y = _nhwc(F.conv2d(_nchw(x), w, padding=_padding(padding, kernel.shape[1])))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv_transpose_2x2(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Keras ``Conv2DTranspose(F, kernel_size=2, strides=2, padding='same')``.

    With kernel == stride every output pixel takes exactly one tap:
    ``out[2h+i, 2w+j, f] = sum_c x[h, w, c] * K[i, j, f, c]``. One
    (B*H*W, C) x (C, 4F) product, columns in (di, dj, f) order, then a
    pixel shuffle.
    """
    b, h, w, c = x.shape
    kh, kw, f, c_in = kernel.shape
    if (kh, kw) != (2, 2) or c_in != c:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit input {tuple(x.shape)}")
    wmat = kernel.permute(3, 0, 1, 2).reshape(c, 4 * f).to(x.dtype)
    y = torch.matmul(x, wmat).reshape(b, h, w, 2, 2, f)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, f)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool over NHWC."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"odd spatial dims {tuple(x.shape)}")
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def batch_norm_inference(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-3,
) -> torch.Tensor:
    """Inference-mode BN as a folded affine (Keras epsilon 1e-3)."""
    scale = gamma * torch.rsqrt(var + eps)
    offset = beta - mean * scale
    return x * scale.to(x.dtype) + offset.to(x.dtype)
