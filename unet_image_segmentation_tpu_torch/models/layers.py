"""U-Net building blocks as ``nn.Module``s (eval and train forward).

Port of ``unet_image_segmentation_tpu/models/layers.py``. Parameters keep
the Keras layouts and names of the JAX package, so the
:mod:`..weights` bridge only renames:

* ``SeparableConv``: ``depthwise_kernel (k,k,C,1)``, ``pointwise_kernel
  (1,1,C,F)``, ``bias (F,)``
* ``Conv``: ``kernel (k,k,C,F)``, ``bias (F,)``
* ``BatchNorm``: parameters ``scale``, ``bias``; buffers ``mean``, ``var``
  (Keras epsilon 1e-3, momentum 0.99)
* ``TransposeUp``: ``kernel (2,2,F,C)``, ``bias (F,)``

On row shards (a ``spatial_group``, the ranks holding an image's rows),
the composed ``SeparableConv`` and ``Conv`` pad their input with the
neighbour shards' halo rows (:func:`..parallel.halo.halo_exchange_grad`)
and convolve rows 'VALID', columns 'SAME'; a composed ``ConvBlock``'s
BatchNorm sums its moments over its ``group``.

Initialisation is glorot-uniform with fan_avg over the Keras-shaped kernel
(the JAX package's ``variance_scaling(1.0, "fan_avg", "uniform")``), drawn
from an explicit ``torch.Generator``. Modules are built on the CPU; move
them with ``.to(device)``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from unet_image_segmentation_tpu_torch.ops import conv as conv_ops
from unet_image_segmentation_tpu_torch.ops.fused_sepconv import (
    fused_sepconv_bn_relu,
    sepconv_apply_stats,
)
from unet_image_segmentation_tpu_torch.parallel.halo import halo_exchange_grad
from unet_image_segmentation_tpu_torch.parallel.reduce import all_sum_grad


def glorot_uniform(shape: Sequence[int], generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keras glorot_uniform on a Keras-shaped kernel (fans from the last two axes)."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


class SeparableConv(nn.Module):
    """Depthwise (k x k) then pointwise (1x1) conv; Keras SeparableConv2D."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        self.depthwise_kernel = nn.Parameter(glorot_uniform((k, k, in_features, 1), generator))
        self.pointwise_kernel = nn.Parameter(
            glorot_uniform((1, 1, in_features, features), generator)
        )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor, x2: Optional[torch.Tensor] = None,
                spatial_group=None) -> torch.Tensor:
        """``spatial_group``: ``x`` (and ``x2``) are row shards over it."""
        pad = "SAME"
        if spatial_group is not None:
            k = self.depthwise_kernel.shape[0] // 2
            x, pad = halo_exchange_grad(x, spatial_group, k), "ROWS_PADDED"
            if x2 is not None:
                x2 = halo_exchange_grad(x2, spatial_group, k)
        if x2 is not None:
            return conv_ops.separable_conv2d_pair(
                x, x2, self.depthwise_kernel, self.pointwise_kernel, self.bias, padding=pad
            )
        return conv_ops.separable_conv2d(x, self.depthwise_kernel, self.pointwise_kernel,
                                         self.bias, padding=pad)


class Conv(nn.Module):
    """Plain Conv2D with a Keras-shaped kernel (kh, kw, C, F)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        self.kernel = nn.Parameter(glorot_uniform((k, k, in_features, features), generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor, spatial_group=None) -> torch.Tensor:
        """``spatial_group``: ``x`` is a row shard over it."""
        if self.kernel.shape[0] == 1:
            return conv_ops.pointwise_conv2d(x, self.kernel, self.bias)
        if spatial_group is None:
            return conv_ops.conv2d(x, self.kernel, self.bias)
        x = halo_exchange_grad(x, spatial_group, self.kernel.shape[0] // 2)
        return conv_ops.conv2d(x, self.kernel, self.bias, padding="ROWS_PADDED")


class BatchNorm(nn.Module):
    """Keras BatchNormalization (epsilon 1e-3, momentum 0.99), as the JAX
    package's flax ``nn.BatchNorm`` computes it.

    Training: batch moments in fp32 over the compute-dtype input (mean of
    x and of x², variance ``max(E[x²] - mean², 0)``, biased), normalize with
    them, cast back to the input dtype, and move the running statistics
    toward them. Stock ``nn.BatchNorm2d`` (epsilon 1e-5, momentum 0.1,
    unbiased running variance, NCHW) is not this layer. With a process
    ``group`` (flax ``axis_name``) the moments are the group's batch: the
    sums of x and x² are all-reduced over it, and their cotangents too.
    """

    eps = 1e-3
    momentum = 0.99

    def __init__(self, features: int, group=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.group = group

    @torch.no_grad()
    def update_stats(self, batch_mean: torch.Tensor, batch_var: torch.Tensor) -> None:
        """``running = momentum * running + (1 - momentum) * batch`` (biased var)."""
        self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * batch_mean)
        self.var.copy_(self.momentum * self.var + (1 - self.momentum) * batch_var)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return conv_ops.batch_norm_inference(
                x, self.mean, self.var, self.scale, self.bias, self.eps
            )
        xf = x.float()
        if self.group is None:
            mean, sq = xf.mean(dim=(0, 1, 2)), (xf * xf).mean(dim=(0, 1, 2))
        else:
            n = xf.numel() // xf.shape[-1] * torch.distributed.get_world_size(self.group)
            sums = all_sum_grad(torch.stack([xf.sum(dim=(0, 1, 2)),
                                             (xf * xf).sum(dim=(0, 1, 2))]), self.group)
            mean, sq = sums[0] / n, sums[1] / n
        var = (sq - mean * mean).clamp_min(0.0)
        self.update_stats(mean, var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    """[Separable]Conv -> BN -> ReLU (reference conv_block).

    ``use_pallas=True`` runs a 3x3 separable block through the fused
    kernels of :mod:`..ops.fused_sepconv`, as the JAX ``ConvBlock._fused_call``
    does:

    * eval: one kernel with BN folded in (K8, :func:`fused_sepconv_bn_relu`);
    * training with BN: the sepconv and its batch sums in one kernel (K9,
      :func:`sepconv_apply_stats`, backward K10), then the batch moments
      (variance ``E[y²] - mean²``, not clamped), the running statistics'
      update and ``relu((y - mean) * rsqrt(var + eps) * scale + offset)``;
    * without BN, training or eval: K8 with the conv bias and ReLU, whose
      gradient is the composed block's.

    The U-Net's own training forward runs BN blocks in pairs through the
    fused chains (:mod:`..ops.fused_train`), reading their raw parameters
    from :meth:`chain_params`; the per-block path serves a ``ConvBlock``
    trained on its own. On row shards (``spatial_group``) a composed block
    exchanges halo rows before its conv; a ``use_pallas`` block raises
    there, since K8 and K9 take whole images only.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_batch_norm: bool = True, conv_type: str = "separable",
                 use_pallas: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if conv_type not in ("separable", "full"):
            raise ValueError(f"conv_type must be 'separable'|'full', got {conv_type!r}")
        self.conv_type = conv_type
        self.kernel_size = kernel_size
        self.use_pallas = use_pallas
        conv_cls = SeparableConv if conv_type == "separable" else Conv
        conv = conv_cls(in_features, features, kernel_size, use_bias=not use_batch_norm,
                        generator=generator)
        if conv_type == "separable":
            self.sepconv = conv
        else:
            self.conv = conv
        self.bn = BatchNorm(features) if use_batch_norm else None

    def chain_params(self):
        """``(depthwise (3,3,C,1), pointwise (1,1,C,F), bn scale, bn offset)``
        for the fused training chain (the JAX ``params_only`` call)."""
        if self.conv_type != "separable" or self.bn is None:
            raise ValueError("the fused training chain needs separable blocks with BatchNorm")
        sep = self.sepconv
        return sep.depthwise_kernel, sep.pointwise_kernel, self.bn.scale, self.bn.bias

    def forward(
        self, x: torch.Tensor, x2: Optional[torch.Tensor] = None, train: bool = False,
        spatial_group=None,
    ) -> torch.Tensor:
        fused = self.use_pallas and self.conv_type == "separable" and self.kernel_size == 3
        if fused and spatial_group is not None:
            raise ValueError("K8/K9 take whole images: a use_pallas block runs no row shard "
                             "(gather the row's images, or build the model without use_pallas)")
        if fused:
            if x2 is not None:
                x = torch.cat([x, x2], dim=-1)
            sep, bn = self.sepconv, self.bn
            if bn is None:
                return fused_sepconv_bn_relu(
                    x, sep.depthwise_kernel, sep.pointwise_kernel, bias=sep.bias
                )
            if not train:
                return fused_sepconv_bn_relu(
                    x, sep.depthwise_kernel, sep.pointwise_kernel,
                    bn_scale=bn.scale, bn_offset=bn.bias, bn_mean=bn.mean, bn_var=bn.var,
                    eps=bn.eps,
                )
            if bn.group is not None:
                raise ValueError("per-block training (K9/K10) takes no BatchNorm group; a "
                                 "sharded U-Net trains through the fused chains")
            y, s, q = sepconv_apply_stats(x, sep.depthwise_kernel, sep.pointwise_kernel)
            n = y.shape[0] * y.shape[1] * y.shape[2]
            mean = s / n
            var = q / n - mean * mean
            bn.update_stats(mean, var)
            out = (y.float() - mean) * (torch.rsqrt(var + bn.eps) * bn.scale) + bn.bias
            return torch.relu(out).to(x.dtype)
        if self.conv_type == "separable":
            x = self.sepconv(x, x2, spatial_group)
        else:
            if x2 is not None:
                x = torch.cat([x, x2], dim=-1)
            x = self.conv(x, spatial_group)
        if self.bn is not None:
            x = self.bn(x, train)
        return torch.relu(x)


class TransposeUp(nn.Module):
    """Conv2DTranspose(features, k=2, s=2, 'same') as matmul + pixel shuffle."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(glorot_uniform((2, 2, features, in_features), generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv_transpose_2x2(x, self.kernel, self.bias)
