"""Product precision of the quality gates' diagnostic legs (``--products``).

The JAX records of the gates were made on a TPU, where XLA computes an fp32
matmul or convolution in one bf16 pass unless told otherwise: each operand
rounded to bf16 (to nearest, ties to even), the products exact, the sums in
fp32. The port's gates run fp32 with TF32 off. :func:`product_precision`
sets one of three modes for the span of a run of the composed path
(``use_pallas=False``):

* ``fp32``: nothing changes (the gates' own numerics);
* ``tf32``: cuBLAS and cuDNN may compute fp32 products in TF32
  (``torch.backends.cuda.matmul.allow_tf32``, ``cudnn.allow_tf32``);
* ``bf16x1``: one bf16 pass per product, as on a TPU. Every MXU-type
  product of :mod:`..ops.conv` (the pointwise and transpose-up matmuls, a
  full ``conv2d``) takes its two operands rounded to bf16 and runs in fp32
  with TF32 off, so each product is exact and only the sums round; in the
  backward, each of the two gradient products takes its operands rounded
  too (the cotangent and the saved operand). The depthwise ``conv2d``
  (``groups > 1``) stays fp32: a TPU runs it on the VPU.

The modes live here only: for the span of the context the ``torch`` and
``F`` names that :mod:`..ops.conv` calls through are replaced by views whose
``matmul`` / ``conv2d`` round, and restored after. The model code and
``Config`` are untouched.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from unet_image_segmentation_tpu_torch.ops import conv as conv_ops

PRODUCTS = ("fp32", "tf32", "bf16x1")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest, ties to even), in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class _RoundOperand(torch.autograd.Function):
    """Rounds an operand to bf16 on the way in; its cotangent passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return bf16_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """Passes a product's output as it is; rounds its cotangent to bf16, the
    operand of both gradient products."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return bf16_round(g)


def bf16x1_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` in one bf16 pass, forward and backward."""
    return _RoundCotangent.apply(torch.matmul(_RoundOperand.apply(a), _RoundOperand.apply(b)))


def bf16x1_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """``F.conv2d`` with a full kernel in one bf16 pass, forward and backward;
    a grouped (depthwise) conv as it is."""
    if groups != 1:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    y = F.conv2d(_RoundOperand.apply(x), _RoundOperand.apply(weight), None, stride, padding,
                 dilation)
    y = _RoundCotangent.apply(y)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


class _View:
    """A module's names, some replaced."""

    def __init__(self, module, **names):
        self._module = module
        vars(self).update(names)

    def __getattr__(self, name):
        return getattr(self._module, name)


@contextlib.contextmanager
def product_precision(products: str = "fp32"):
    """The span of a run with fp32 products as ``products`` says (one of
    :data:`PRODUCTS`); the TF32 flags and :mod:`..ops.conv`'s names are
    restored on exit."""
    if products not in PRODUCTS:
        raise ValueError(f"products must be one of {PRODUCTS}, got {products!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    names = (conv_ops.torch, conv_ops.F)
    try:
        if products != "fp32":
            allow = products == "tf32"
            torch.backends.cuda.matmul.allow_tf32 = allow
            torch.backends.cudnn.allow_tf32 = allow
        if products == "bf16x1":
            conv_ops.torch = _View(torch, matmul=bf16x1_matmul)
            conv_ops.F = _View(F, conv2d=bf16x1_conv2d)
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        conv_ops.torch, conv_ops.F = names
