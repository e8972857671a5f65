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

:func:`sharded_conv3x3_rows` wraps a row-local op that needs 1-row halos.
The JAX module's ``spatial_sharded_forward`` (GSPMD partitioning the
module path) has no PyTorch counterpart; the explicit sharded serving
graphs (``serving.build_serving_forward_sharded`` and its int8 twin) take
its place.
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
