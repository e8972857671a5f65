"""A ('data', 'spatial') mesh over the process group's ranks.

Port of ``unet_image_segmentation_tpu/parallel/mesh.py``. PyTorch has no
sharded arrays that a compiler partitions: each rank holds its own shard
and calls the collectives itself. So the mesh here is the layout of the
ranks and the groups the collectives run over:

* rank ``r`` sits at ``(data, spatial) = divmod(r, spatial)``, row-major as
  the JAX mesh's ``reshape(data, spatial)``;
* the batch is split over ``data`` (:meth:`Mesh.batch_slice`) and image
  rows over ``spatial`` (:meth:`Mesh.row_slice`); :meth:`Mesh.shard` takes
  both;
* each data row's ranks form a ``spatial_group`` (``dist.new_group``), the
  group of the halo exchange (:mod:`.halo`) and of the head sums of a
  row-sharded training step; the ranks with one spatial index form a
  ``data_group``, over which that step's metrics are reduced; ``group``
  names the whole mesh (the BatchNorm sums and the gradients);
* :meth:`Mesh.gather` puts every rank's shard back together on every rank,
  :meth:`Mesh.gather_rows` the rows of a data row's ranks (under autograd,
  each rank's rows taking their slice of the cotangent).

In one process (no process group) the mesh is (1, 1) and has no groups; a
group of one rank is None too.
:func:`pad_batch_to_devices` is a copy of the JAX package's numpy helper.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """This rank's place in a ('data', 'spatial') layout of the ranks."""

    def __init__(self, data: int, spatial: int, rank: int = 0,
                 spatial_group: Optional[dist.ProcessGroup] = None,
                 data_group: Optional[dist.ProcessGroup] = None):
        self.shape = {"data": data, "spatial": spatial}
        self.size = data * spatial
        self.rank = rank
        self.data_index, self.spatial_index = divmod(rank, spatial)
        self.spatial_group = spatial_group
        self.data_group = data_group

    @property
    def group(self) -> Optional[dist.ProcessGroup]:
        """The whole mesh (every rank of the process group), None in one
        rank: the group of the BatchNorm sums and the gradient sum."""
        return dist.group.WORLD if self.size > 1 else None

    def _part(self, n: int, axis: str, what: str) -> slice:
        parts = self.shape[axis]
        if n % parts:
            raise ValueError(f"{what} {n} is not divisible by the mesh's {axis}={parts}")
        i = self.data_index if axis == "data" else self.spatial_index
        return slice(i * (n // parts), (i + 1) * (n // parts))

    def batch_slice(self, batch: int) -> slice:
        """This rank's samples of a batch of ``batch``."""
        return self._part(batch, "data", "batch")

    def row_slice(self, rows: int) -> slice:
        """This rank's rows of an image of ``rows`` rows."""
        return self._part(rows, "spatial", "image height")

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of an NHWC batch, its samples and its rows,
        contiguous."""
        return x[self.batch_slice(x.shape[0]), self.row_slice(x.shape[1])].contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's shard (of :meth:`shard`'s layout) put together, on
        every rank: each rank writes its shard into a zeroed tensor of the
        whole shape and one ``all_reduce(SUM)`` adds them. Adding zeros is
        exact in every dtype, and ``all_reduce`` is a collective that gloo
        takes on CUDA tensors too."""
        b, h = local.shape[0] * self.shape["data"], local.shape[1] * self.shape["spatial"]
        out = torch.zeros((b, h, *local.shape[2:]), dtype=local.dtype, device=local.device)
        out[self.batch_slice(b), self.row_slice(h)] = local
        if self.size > 1:
            dist.all_reduce(out)
        return out

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The rows of this rank's data row put back together: the whole
        images of its samples, on each of the row's ranks (one
        ``all_reduce`` of a zeroed tensor over the spatial group).

        Differentiable: every rank of the row computes the same loss from
        the gathered rows, so a rank's rows take the cotangent of their own
        slice, and no cotangent crosses ranks."""
        if self.spatial_group is None:
            return local
        return _GatherRows.apply(local, self)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh):
        h = local.shape[1] * mesh.shape["spatial"]
        ctx.rows = mesh.row_slice(h)
        out = local.new_zeros((local.shape[0], h, *local.shape[2:]))
        out[:, ctx.rows] = local
        dist.all_reduce(out, group=mesh.spatial_group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.rows], None


def create_mesh(data: int = -1, spatial: int = 1) -> Mesh:
    """The ('data', 'spatial') mesh of the process group's ranks (one
    process: (1, 1)). ``data=-1``: all the ranks ``spatial`` leaves. Every
    rank calls it, with the same arguments, as it creates the groups."""
    joined = dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if joined else (1, 0)
    if data == -1:
        if world % spatial:
            raise ValueError(f"{world} ranks not divisible by spatial={spatial}")
        data = world // spatial
    if data < 1 or spatial < 1 or data * spatial != world:
        raise ValueError(f"mesh {data}x{spatial} does not lay out the {world} ranks")
    # every rank creates every group, in the same order: the spatial groups
    # (one a data index), then the data groups (one a spatial index)
    spatial_group = data_group = None
    if joined and spatial > 1:
        for d in range(data):
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if d == rank // spatial:
                spatial_group = g
    if joined and data > 1:
        for s in range(spatial):
            g = dist.new_group(list(range(s, world, spatial)))
            if s == rank % spatial:
                data_group = g
    return Mesh(data, spatial, rank, spatial_group, data_group)


def pad_batch_to_devices(images: np.ndarray, n: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis to a multiple of ``n`` (returns pad count).

    Needed because sharded batch dims must divide evenly; padded rows are
    masked out of metrics by callers.
    """
    b = images.shape[0]
    pad = (-b) % n
    if pad:
        images = np.concatenate([images, np.repeat(images[-1:], pad, 0)], 0)
    return images, pad

