"""Halo exchange for row-sharded images.

Port of ``unet_image_segmentation_tpu/parallel/halo.py`` and of the
row-sharded training chains' boundary-row exchange (JAX
``ops/pallas/fused_train.py`` ``_edge_halo_exchange`` and the reverse
``ppermute`` of the halos' cotangents). An image's rows are split over the
mesh's ``spatial`` ranks; a 3x3 receptive field at a shard boundary needs
rows of the neighbour shards:

* :func:`halo_exchange` pads the local shard with ``halo`` rows from each
  neighbour, and zeros at the true image edges ('same' padding) (the
  sharded serving graphs);
* :func:`edge_halo_exchange` gives a training chain's link its (B, 2, W, C)
  halo, the row above the shard and the row below, which K1's halo mode
  takes in place of its zero padding rows, and sends each halo row's
  cotangent back to the rank that owns the row.

The exchange is one collective that every backend takes on every device:
each rank writes its rows into its slot of a zeroed (n, 2, ...) buffer,
and one ``all_reduce(SUM)`` over the spatial group gives every rank every
slot. Adding zeros is exact in every
dtype (int8 too). Gloo takes only ``broadcast`` and ``all_reduce`` on CUDA
tensors and NCCL refuses two ranks on one card, so point-to-point sends,
the JAX package's ``ppermute``, would not run on one card shared by two
ranks. The price: the reduced buffer is ``n`` times the rows each rank
sends.

The composed modules' row-sharded path (the JAX package leaves it to
GSPMD, which inserts the same exchanges) is written here by hand:

* :func:`halo_exchange_grad` is :func:`halo_exchange` under autograd: its
  backward keeps the cotangent of the shard's own rows and sends the halo
  rows' cotangents back to the ranks that own those rows, through the same
  single ``all_reduce``, where they are added into the first and last rows;
* :func:`sharded_conv3x3_rows` wraps a row-local op that needs 1-row halos;
* :func:`spatial_sharded_forward` is the module path's eval forward on this
  rank's batch and row shard (JAX ``spatial_sharded_forward``): the composed
  modules exchange a halo before every 3x3 conv; where the model cannot
  take row shards (a height whose shards do not survive every pool, or
  ``use_pallas`` blocks, whose K8 takes whole images) each rank runs its
  row's gathered images whole.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist


def halo_exchange(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                  halo: int = 1) -> torch.Tensor:
    """The local (B, H_local, W, C) shard padded to (B, H_local + 2*halo, W,
    C) with ``halo`` rows of the previous and the next rank of ``group``
    (ordered by rank); zeros above the first shard and below the last.
    ``group`` None: a shard that is the whole image."""
    if not 0 < halo <= x.shape[1]:
        raise ValueError(f"halo_exchange: halo {halo} with {x.shape[1]} local rows")
    n, i = (1, 0) if group is None else (dist.get_world_size(group),
                                         dist.get_group_rank(group, dist.get_rank()))
    zeros = x.new_zeros((x.shape[0], halo, *x.shape[2:]))
    if n == 1:
        return torch.cat([zeros, x, zeros], dim=1)
    buf = x.new_zeros((n, 2, x.shape[0], halo, *x.shape[2:]))
    buf[i, 0] = x[:, :halo]
    buf[i, 1] = x[:, -halo:]
    dist.all_reduce(buf, group=group)
    top = buf[i - 1, 1] if i > 0 else zeros
    bottom = buf[i + 1, 0] if i < n - 1 else zeros
    return torch.cat([top, x, bottom], dim=1)


def edge_halo_exchange(top: torch.Tensor, bot: torch.Tensor,
                       group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """A chain link's halo on row shards: this rank's first row ``top`` and
    last row ``bot`` (B, 1, W, C) in; out (B, 2, W, C), row 0 the previous
    rank's ``bot``, row 1 the next rank's ``top``, zeros past the first and
    the last rank (the 'same' padding at the image's edges).

    The training forward sends z rows this way; its backward sends each
    halo row's cotangent back to the rank whose row it was by the same
    exchange (``top``/``bot`` the cotangents of the rows above and below
    the shard come back as those of its own first and last row)."""
    return halo_exchange(torch.cat([top, bot], dim=1), group, halo=1)[:, [0, 3]]


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, halo):
        ctx.group, ctx.halo = group, halo
        return halo_exchange(x, group, halo)

    @staticmethod
    def backward(ctx, g):
        k = ctx.halo
        # the halo rows' cotangents go back to their owners: the rows above
        # the shard were the previous rank's last rows, those below the
        # next rank's first; the exchange of [top | bottom] hands each rank
        # the previous rank's bottom and the next rank's top
        recv = halo_exchange(torch.cat([g[:, :k], g[:, -k:]], dim=1), ctx.group, k)
        dx = g[:, k:-k].clone()
        dx[:, :k] += recv[:, :k]
        dx[:, -k:] += recv[:, -k:]
        return dx, None, None


def halo_exchange_grad(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                       halo: int = 1) -> torch.Tensor:
    """:func:`halo_exchange` whose backward returns each halo row's
    cotangent to the rank that owns the row (added into its first or last
    rows); the image edges' zero rows take none."""
    return _HaloExchange.apply(x, group, halo)


def sharded_conv3x3_rows(
    kernel_apply: Callable[[torch.Tensor], torch.Tensor],
    group: Optional[dist.ProcessGroup],
) -> Callable[[torch.Tensor], torch.Tensor]:
    """A 'same'-padding row-local op needing 1-row halos, on row shards:
    ``kernel_apply`` maps (B, H_local + 2, W, C) -> (B, H_local + 2, W, C');
    the returned function exchanges the halos, applies it and trims them."""

    def local_fn(x_local: torch.Tensor) -> torch.Tensor:
        return kernel_apply(halo_exchange(x_local, group, halo=1))[:, 1:-1]

    return local_fn


def spatial_sharded_forward(model, mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The module path's eval forward on row shards, the counterpart of the
    JAX package's GSPMD-partitioned ``spatial_sharded_forward``: this rank's
    shard (:meth:`..mesh.Mesh.shard`: its samples, its rows) -> the
    probabilities of its rows. Each 3x3 conv of the composed modules takes
    a 1-row halo from the neighbour shards; pool, transpose-up, concat and
    the head are row-local. Where the model cannot take the shards
    (:meth:`..models.unet.UNet.runs_on_row_shards`: a height that does not
    survive every pool, or K8 blocks) the rank runs the whole images of its
    samples, gathered from the row's ranks, and keeps its rows."""

    def forward(x_local: torch.Tensor) -> torch.Tensor:
        if model.runs_on_row_shards(x_local.shape[1]):
            return model(x_local, spatial_group=mesh.spatial_group)
        whole = model(mesh.gather_rows(x_local))
        return whole[:, mesh.row_slice(whole.shape[1])]

    return forward
