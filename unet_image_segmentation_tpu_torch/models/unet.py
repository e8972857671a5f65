"""The U-Net as an ``nn.Module``, eval and train forward.

Port of ``unet_image_segmentation_tpu/models/unet.py``:

* encoder: per stage two ConvBlocks, skip saved, 2x2 max pool;
* bottleneck: two ConvBlocks at twice the last width, then dropout (train);
* decoder: per stage a 2x2 transpose-up, then block 1 over ``[up | skip]``
  and block 2; dropout on the concat of every stage but the last (train);
  in eval the concat is never stored (separable blocks factor it into two
  half-convs);
* head: 1x1 conv in the compute dtype, then sigmoid (one class) or softmax
  in fp32; with ``head_targets`` the forward returns the head-sums dict
  (:mod:`..ops.fused_head`) instead of probabilities.

Training with ``use_pallas`` on a separable BatchNorm model runs each
stage's block pair as one fused chain (:mod:`..ops.fused_train`, kernels
K1-K4): ``fused_chain_train_pool`` per encoder stage, ``fused_chain_train``
for the bottleneck and the decoder stages with their dropout fused into the
first link. Every decoder stage's input ``[up | skip]`` comes from the
fused decoder feed (:mod:`..ops.fused_upconcat`, K6). With ``head_targets``
and ``fused_head`` 'all', or 'auto' with one class, the last decoder stage,
the head and the sums run as :func:`..ops.fused_head.fused_head_train`: the
sigmoid head through K5, the softmax head of 2..4 classes through K11.
'auto' keeps the composed sums for a softmax head, as in the JAX package,
and so does 'all' for more than 4 classes or a width the kernels do not
take. Without BatchNorm a ``use_pallas`` model trains block by block: each
ConvBlock runs K8 forward with the composed backward. Without
``use_pallas`` the composed modules run under autograd. Dropout is always
the position hash of :mod:`..ops.hash_dropout`, with explicit per-site
seeds (site 0 after the bottleneck, site ``s`` on decoder stage ``s``).

On a mesh (JAX ``bn_axis_name`` / ``spatial_axis_name``),
:meth:`UNet.set_groups` gives the model ``bn_group``, the
group whose batch every BatchNorm normalizes (the chains all-reduce their
sums over it, the composed BatchNorm its moments), and ``spatial_group``,
the ranks holding an image's row shards, which the train step checks.
A forward takes whole images unless its caller passes ``spatial_group``
(the train step and :func:`..parallel.halo.spatial_sharded_forward` do).
A row-sharded forward runs in training and in eval where
:meth:`UNet.runs_on_row_shards` says so:

* through the fused chains where they train the model: each link
  exchanges its halo rows (K1's halo mode);
* otherwise through the composed modules, the JAX package's GSPMD-XLA
  path written out: each 3x3 conv pads its shard with a halo row from
  each neighbour (:func:`..parallel.halo.halo_exchange_grad`, whose
  backward returns the halo rows' cotangents), while the pool, the
  transpose-up, the concat and the head are row-local. K8 and K9 take
  whole images only: a ``use_pallas`` block raises on a row shard, and
  the callers run such a model on the row's gathered images.

On row shards the dropout drops each shard with its own folded seeds
before any halo is exchanged (so halo rows hold dropped values), and with
``head_targets`` the sums are this rank's rows' (the train step sums them
over the group).

Submodule names follow the JAX package (``enc{s}_block{n}``,
``bneck_block{n}``, ``dec{s}_upsample``, ``dec{s}_block{n}``,
``output_mask``), so ``state_dict`` keys are the Flax paths joined by dots.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from unet_image_segmentation_tpu_torch.config import ModelConfig
from unet_image_segmentation_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvBlock,
    TransposeUp,
)
from unet_image_segmentation_tpu_torch.ops.conv import max_pool_2x2
from unet_image_segmentation_tpu_torch.ops.fused_head import (
    fused_head_feasible,
    fused_head_train,
    head_sums_reference,
    head_sums_reference_mc,
)
from unet_image_segmentation_tpu_torch.ops.fused_train import (
    Groups,
    fused_chain_train,
    fused_chain_train_pool,
)
from unet_image_segmentation_tpu_torch.ops.fused_upconcat import fused_upconcat
from unet_image_segmentation_tpu_torch.ops.hash_dropout import hash_dropout


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
        fused_head: str = "auto",
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.filters = tuple(filters)
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.use_batch_norm = use_batch_norm
        self.conv_type = conv_type
        if fused_head not in ("auto", "all", "off"):
            raise ValueError(f"fused_head must be 'auto'|'all'|'off', got {fused_head!r}")
        self.fused_head = fused_head

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
        self.set_groups()
        self.eval()
        if device is not None:
            self.to(device)

    def set_groups(self, bn_group=None, spatial_group=None) -> None:
        """The mesh groups (None: one rank): the chains' and every composed
        BatchNorm's ``bn_group``, and the ``spatial_group`` the train step
        holds its mesh to (a forward is given its row group)."""
        self.groups = Groups(bn_group, spatial_group)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = bn_group

    def runs_on_row_shards(self, height: int, train: bool = False) -> bool:
        """Whether a forward can take row shards of local ``height``: every
        pool keeps the shard's rows whole, and no block would run K8 or K9,
        which take whole images (a ``use_pallas`` separable model does so
        outside the training chains, which need BatchNorm)."""
        if height % 2 ** len(self.filters):
            return False
        kernel_blocks = self.use_pallas and self.conv_type == "separable"
        return not kernel_blocks or (train and self.use_batch_norm)

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        head_targets: Optional[torch.Tensor] = None,
        dropout_seeds: Optional[Sequence[int]] = None,
        spatial_group=None,
    ):
        """(B, H, W, C) -> probabilities (B, H, W, num_classes), fp32, or with
        ``head_targets`` the head-sums dict.

        ``train=True`` normalizes with batch moments and updates the
        BatchNorm running statistics; with ``dropout_rate > 0`` it needs
        ``dropout_seeds``, int32 seeds indexed by dropout site (0 for the
        bottleneck, ``s`` for decoder stage ``s``). ``spatial_group``: the
        group whose ranks hold ``x``'s rows (None: ``x`` holds whole images).
        """
        if x.dim() != 4:
            raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
        depth = len(self.filters)
        h, w = x.shape[1], x.shape[2]
        if h % (2**depth) or w % (2**depth):
            what = "a row shard's" if spatial_group is not None else "spatial"
            raise ValueError(f"{what} dims {h}x{w} must be divisible by {2**depth}")
        use_chain = (
            train and self.use_pallas and self.use_batch_norm and self.conv_type == "separable"
        )
        drop = train and self.dropout_rate > 0.0
        if drop and dropout_seeds is None:
            raise ValueError("a training forward with dropout needs dropout_seeds")
        groups = Groups(self.groups.bn, spatial_group)
        rows = spatial_group is not None
        # as the JAX package: 'auto' fuses the sigmoid head only, and a head
        # no kernel takes (over 4 classes, a width K5/K11 cannot read) keeps
        # the composed sums
        fuse_head = use_chain and head_targets is not None and (
            self.fused_head == "all" or (self.fused_head == "auto" and self.num_classes == 1)
        ) and fused_head_feasible(self.filters[0], self.dtype, self.num_classes)

        def pair(prefix: str):
            return getattr(self, f"{prefix}_block1"), getattr(self, f"{prefix}_block2")

        def chain_blocks(b1: ConvBlock, b2: ConvBlock):
            return [b1.chain_params(), b2.chain_params()]

        def update_bn(stats, b1: ConvBlock, b2: ConvBlock) -> None:
            for (mean, var), blk in zip(stats, (b1, b2)):
                blk.bn.update_stats(mean, var)

        def run_pair(x, prefix, drop_site=None):
            b1, b2 = pair(prefix)
            rate = self.dropout_rate if drop_site is not None else 0.0
            seed = dropout_seeds[drop_site] if drop_site is not None else None
            if use_chain:
                if rows and rate > 0.0:
                    # the halo rows must be dropped out values: the row
                    # shard drops out before its chain (JAX hoists it too)
                    x, rate, seed = hash_dropout(x, seed, rate), 0.0, None
                z, stats = fused_chain_train(x, chain_blocks(b1, b2), drop_rate=rate,
                                             drop_seed=seed, groups=groups)
                update_bn(stats, b1, b2)
                return z
            if rate > 0.0:
                x = hash_dropout(x, seed, rate)
            return b2(b1(x, train=train, spatial_group=spatial_group), train=train,
                      spatial_group=spatial_group)

        x = x.to(self.dtype)
        skips = []
        for stage in range(1, depth + 1):
            if use_chain:
                b1, b2 = pair(f"enc{stage}")
                skip, x, stats = fused_chain_train_pool(x, chain_blocks(b1, b2),
                                                        groups=groups)
                update_bn(stats, b1, b2)
            else:
                skip = run_pair(x, f"enc{stage}")
                x = max_pool_2x2(skip)
            skips.append(skip)
        x = run_pair(x, "bneck")
        if drop:
            x = hash_dropout(x, dropout_seeds[0], self.dropout_rate)
        for stage in range(depth, 0, -1):
            upsample = getattr(self, f"dec{stage}_upsample")
            b1, b2 = pair(f"dec{stage}")
            if use_chain:
                cat = fused_upconcat(x, upsample.kernel, upsample.bias, skips[stage - 1])
            elif train:
                # training stores the concat: one dropout mask spans both halves
                cat = torch.cat([upsample(x), skips[stage - 1]], dim=-1)
            else:
                x = b2(b1(upsample(x), skips[stage - 1], spatial_group=spatial_group),
                       spatial_group=spatial_group)
                continue
            if stage == 1 and fuse_head:
                out = self.output_mask
                sums, stats = fused_head_train(cat, chain_blocks(b1, b2), out.kernel, out.bias,
                                               head_targets, groups=groups)
                update_bn(stats, b1, b2)
                return sums
            x = run_pair(cat, f"dec{stage}", stage if drop and stage > 1 else None)
        logits = self.output_mask(x).float()
        preds = torch.sigmoid(logits) if self.num_classes == 1 else torch.softmax(logits, dim=-1)
        if head_targets is not None:
            if self.num_classes == 1:
                return head_sums_reference(preds, head_targets)
            return head_sums_reference_mc(preds, head_targets, self.num_classes)
        return preds


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and no CUDA
    device is available (an entry point never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA device is available")
    return device


def build_unet(
    cfg: ModelConfig,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
) -> UNet:
    """Construct a :class:`UNet` from a :class:`ModelConfig` on ``device``
    (the card unless the caller asks for another device)."""
    device = resolve_device(device)
    return UNet(
        num_classes=cfg.num_classes,
        filters=tuple(cfg.filters),
        dropout_rate=cfg.dropout_rate,
        use_batch_norm=cfg.use_batch_norm,
        conv_type=cfg.conv_type,
        dtype=getattr(torch, cfg.compute_dtype),
        use_pallas=cfg.use_pallas,
        in_channels=cfg.image_channels,
        fused_head=getattr(cfg, "fused_head", "auto"),
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
