"""The U-Net as an ``nn.Module``, eval forward only.

Port of ``unet_image_segmentation_tpu/models/unet.py`` with ``train=False``:

* encoder: per stage two ConvBlocks, skip saved, 2x2 max pool;
* bottleneck: two ConvBlocks at twice the last width (dropout is inactive
  in eval mode, so no dropout module is declared);
* decoder: per stage a 2x2 transpose-up, then block 1 over ``[up | skip]``
  without storing the concat (separable blocks factor it into two
  half-convs) and block 2;
* head: 1x1 conv in the compute dtype, then sigmoid (one class) or softmax
  in fp32.

Submodule names follow the JAX package (``enc{s}_block{n}``,
``bneck_block{n}``, ``dec{s}_upsample``, ``dec{s}_block{n}``,
``output_mask``), so ``state_dict`` keys are the Flax paths joined by dots.
The training-mode branches (batch statistics, dropout, the fused training
chains) come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from unet_image_segmentation_tpu.config import ModelConfig
from unet_image_segmentation_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvBlock,
    TransposeUp,
)
from unet_image_segmentation_tpu_torch.ops.conv import max_pool_2x2


class UNet(nn.Module):
    def __init__(
        self,
        num_classes: int = 1,
        filters: Sequence[int] = (64, 128, 256, 512),
        dropout_rate: float = 0.2,
        use_batch_norm: bool = True,
        conv_type: str = "separable",
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        in_channels: int = 3,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.filters = tuple(filters)
        self.dropout_rate = dropout_rate  # eval forward: inactive
        self.dtype = dtype

        def block(cin: int, feat: int) -> ConvBlock:
            return ConvBlock(cin, feat, use_batch_norm=use_batch_norm, conv_type=conv_type,
                             use_pallas=use_pallas, generator=generator)

        depth = len(self.filters)
        cin = in_channels
        for i, f in enumerate(self.filters):
            setattr(self, f"enc{i + 1}_block1", block(cin, f))
            setattr(self, f"enc{i + 1}_block2", block(f, f))
            cin = f
        bneck = self.filters[-1] * 2
        self.bneck_block1 = block(cin, bneck)
        self.bneck_block2 = block(bneck, bneck)
        cin = bneck
        for i, f in enumerate(reversed(self.filters)):
            stage = depth - i
            setattr(self, f"dec{stage}_upsample", TransposeUp(cin, f, generator=generator))
            setattr(self, f"dec{stage}_block1", block(2 * f, f))
            setattr(self, f"dec{stage}_block2", block(f, f))
            cin = f
        self.output_mask = Conv(cin, num_classes, kernel_size=1, generator=generator)
        self.eval()
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> probabilities (B, H, W, num_classes), fp32."""
        if x.dim() != 4:
            raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
        depth = len(self.filters)
        h, w = x.shape[1], x.shape[2]
        if h % (2**depth) or w % (2**depth):
            raise ValueError(f"spatial dims {h}x{w} must be divisible by {2**depth}")
        x = x.to(self.dtype)
        skips = []
        for stage in range(1, depth + 1):
            x = getattr(self, f"enc{stage}_block2")(getattr(self, f"enc{stage}_block1")(x))
            skips.append(x)
            x = max_pool_2x2(x)
        x = self.bneck_block2(self.bneck_block1(x))
        for stage in range(depth, 0, -1):
            x = getattr(self, f"dec{stage}_upsample")(x)
            x = getattr(self, f"dec{stage}_block1")(x, skips[stage - 1])
            x = getattr(self, f"dec{stage}_block2")(x)
        logits = self.output_mask(x).float()
        if self.num_classes == 1:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)


def build_unet(
    cfg: ModelConfig,
    device: Union[str, torch.device, None] = None,
    generator: Optional[torch.Generator] = None,
) -> UNet:
    """Construct a :class:`UNet` from a :class:`ModelConfig`."""
    return UNet(
        num_classes=cfg.num_classes,
        filters=tuple(cfg.filters),
        dropout_rate=cfg.dropout_rate,
        use_batch_norm=cfg.use_batch_norm,
        conv_type=cfg.conv_type,
        dtype=getattr(torch, cfg.compute_dtype),
        use_pallas=cfg.use_pallas,
        in_channels=cfg.image_channels,
        generator=generator,
        device=device,
    )


@torch.no_grad()
def recalibrate_batch_norm(model: UNet, images: torch.Tensor) -> None:
    """Set every BatchNorm's running mean/var to the batch statistics of its
    input on ``images`` (biased variance), layer by layer in forward order.

    Gives randomly initialised weights realistic activation scales, so that
    outputs are not a constant 0.5. Needs the composed path: the fused
    kernels fold BN and never call the BatchNorm module.
    """
    if any(isinstance(m, ConvBlock) and m.use_pallas for m in model.modules()):
        raise ValueError("recalibrate a model built with use_pallas=False")

    def set_stats(bn: BatchNorm, args):
        y = args[0].float()
        bn.mean.copy_(y.mean(dim=(0, 1, 2)))
        bn.var.copy_(y.var(dim=(0, 1, 2), unbiased=False))

    handles = [
        m.register_forward_pre_hook(set_stats) for m in model.modules()
        if isinstance(m, BatchNorm)
    ]
    try:
        model(images)
    finally:
        for h in handles:
            h.remove()
