"""The serving forward: one fused block-pair kernel (K7) per stage.

Port of ``unet_image_segmentation_tpu/serving.py``'s chained graph
(``_chained_forward``), without its TPU layout machinery (lane packing,
``pair_pack``, column strips). Reading a standard U-Net variable tree, it
runs

* each encoder stage as one K7 call with ``pool=True``, which returns the
  skip and the pooled input of the next stage;
* the bottleneck as one K7 call;
* each decoder stage as a plain 2x2 transpose-up, then one K7 call with
  ``x2=skip``, so the ``[up | skip]`` concat is never stored;
* the head as a plain 1x1 conv in the compute dtype, then sigmoid or
  softmax in fp32.

Weights are cast, BN-folded and moved to the device once, when the forward
is built (:func:`serving_weights`, which the int8 graph of
:mod:`.serving_quant` shares). On a CUDA device the pair calls launch the
kernel; on the CPU they run its plain version.

:func:`build_serving_forward_sharded` is the same graph on row shards
(JAX ``build_serving_forward_sharded``, its ``shard_map`` replaced by one
process a rank of a :class:`.parallel.mesh.Mesh`): before each pair a
2-row halo exchange (:func:`.parallel.halo.halo_exchange`), K7 with edge
flags on the padded slab, the halo rows trimmed after it
(:func:`halo_pair`); the pools, transpose-ups and the head are row-local.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from unet_image_segmentation_tpu_torch.ops import conv as conv_ops
from unet_image_segmentation_tpu_torch.ops.fused_sepconv import (
    BlockWeights,
    prepare_block,
    sepconv_pair,
)
from unet_image_segmentation_tpu_torch.parallel.halo import halo_exchange
from unet_image_segmentation_tpu_torch.parallel.mesh import Mesh


def _tensor(value: Any, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value), dtype=torch.float32, device=device)


def _block(params: Dict, stats: Dict, name: str, dtype, device) -> BlockWeights:
    p = params[name]
    block = {
        "depthwise_kernel": _tensor(p["sepconv"]["depthwise_kernel"], device),
        "pointwise_kernel": _tensor(p["sepconv"]["pointwise_kernel"], device),
    }
    if "bias" in p["sepconv"]:
        block["bias"] = _tensor(p["sepconv"]["bias"], device)
    if "bn" in p:
        block.update(
            scale=_tensor(p["bn"]["scale"], device),
            offset=_tensor(p["bn"]["bias"], device),
            mean=_tensor(stats[name]["bn"]["mean"], device),
            var=_tensor(stats[name]["bn"]["var"], device),
        )
    return prepare_block(block, dtype, device=device)


Pair = Tuple[BlockWeights, BlockWeights]


class ServingWeights(NamedTuple):
    """A U-Net's serving weights on the device: a K7 pair (block 1, block 2)
    in the compute dtype per encoder stage and for the bottleneck; per
    decoder stage ``(kernel (2,2,F,C), bias (F,), pair)`` of its transpose-up
    (fp32) and its K7 pair; the head's ``(kernel (1,1,F,NC), bias (NC,))``
    in fp32."""

    enc: List[Pair]
    bneck: Pair
    dec: Dict[int, Tuple[torch.Tensor, torch.Tensor, Pair]]
    head: Tuple[torch.Tensor, torch.Tensor]


def serving_weights(
    variables: Dict[str, Any],
    depth: int,
    compute_dtype: torch.dtype,
    device: Union[str, torch.device],
) -> ServingWeights:
    """The weights both serving graphs read, from a Flax-layout tree
    (``params`` and, with BatchNorm, ``batch_stats``) of a separable-conv
    U-Net: the blocks BN-folded (:func:`.ops.fused_sepconv.prepare_block`)."""
    device = torch.device(device)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if "sepconv" not in params["enc1_block1"]:
        raise ValueError("the serving graph needs a separable-conv model")

    def pair(prefix: str) -> Pair:
        return (
            _block(params, stats, f"{prefix}_block1", compute_dtype, device),
            _block(params, stats, f"{prefix}_block2", compute_dtype, device),
        )

    dec = {}
    for s in range(depth, 0, -1):
        up = params[f"dec{s}_upsample"]
        dec[s] = (_tensor(up["kernel"], device), _tensor(up["bias"], device), pair(f"dec{s}"))
    head = params["output_mask"]
    return ServingWeights(
        enc=[pair(f"enc{s}") for s in range(1, depth + 1)],
        bneck=pair("bneck"),
        dec=dec,
        head=(_tensor(head["kernel"], device), _tensor(head["bias"], device)),
    )


def halo_pair(mesh: Mesh, launch: Callable) -> Callable:
    """One of K7's wrappers (``launch(x, w1, w2, pool=, x2=, edge_flags=)``)
    on row shards of ``mesh``'s spatial group: x (and x2) padded with 2
    halo rows from each neighbour (zeros at the image edges), K7 on the
    slab with the edge flags of this shard (first, last), the halo rows
    trimmed from y and the halo's pooled row from the pool (the local rows
    are even, so the slab's pooled rows keep their pairs)."""
    n, i = mesh.shape["spatial"], mesh.spatial_index
    flags = (int(i == 0), int(i == n - 1))

    def pair(x, w1, w2, pool=False, x2=None):
        xp = halo_exchange(x, mesh.spatial_group, 2)
        x2p = halo_exchange(x2, mesh.spatial_group, 2) if x2 is not None else None
        out = launch(xp, w1, w2, pool=pool, x2=x2p, edge_flags=flags)
        if pool:
            return out[0][:, 2:-2].contiguous(), out[1][:, 1:-1].contiguous()
        return out[:, 2:-2].contiguous()

    return pair


def check_shard_rows(mesh: Mesh, rows: int, width: int, depth: int) -> None:
    """A row shard the sharded graphs take: rows and width divisible by
    ``2**depth`` and, with halos, at least 2 rows a shard at the deepest
    stage (the JAX graph's ``x[:, -2:]`` silently takes one there)."""
    if rows % (1 << depth) or width % (1 << depth):
        raise ValueError(f"shard {rows}x{width}: rows and width must be divisible by "
                         f"{1 << depth} (image height by {mesh.shape['spatial'] << depth})")
    if mesh.shape["spatial"] > 1 and rows >> depth < 2:
        raise ValueError(f"shard of {rows} rows: {rows >> depth} at the deepest stage, the "
                         "2-row halo needs 2")


def _make_forward(weights: ServingWeights, num_classes: int, compute_dtype: torch.dtype,
                  device: torch.device, pair: Callable) -> Callable[[torch.Tensor], torch.Tensor]:
    """The float graph's body; ``pair(x, w1, w2, pool=, x2=)`` runs each K7
    pair."""
    enc, bneck = weights.enc, weights.bneck
    dec = {s: (k.to(compute_dtype), b.to(compute_dtype), blocks)
           for s, (k, b, blocks) in weights.dec.items()}
    head_k, head_b = (t.to(compute_dtype) for t in weights.head)
    depth = len(enc)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device=device, dtype=compute_dtype).contiguous()
        skips = []
        for w1, w2 in enc:
            skip, x = pair(x, w1, w2, pool=True)
            skips.append(skip)
        x = pair(x, *bneck)
        for s in range(depth, 0, -1):
            k, b, (w1, w2) = dec[s]
            up = conv_ops.conv_transpose_2x2(x, k, b)
            x = pair(up, w1, w2, x2=skips[s - 1])
        logits = conv_ops.pointwise_conv2d(x, head_k, head_b).float()
        if num_classes == 1:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)

    return forward


def build_serving_forward(
    variables: Dict[str, Any],
    num_classes: int = 1,
    depth: int = 4,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Serving forward over a separable-conv U-Net variable tree.

    ``variables`` is the Flax-layout tree (``params`` and, with BatchNorm,
    ``batch_stats``), as numpy arrays or CPU tensors. The returned function maps
    (B, H, W, C) images on ``device`` to fp32 probabilities
    (B, H, W, num_classes).
    """
    device = torch.device(device)
    weights = serving_weights(variables, depth, compute_dtype, device)
    return _make_forward(weights, num_classes, compute_dtype, device, sepconv_pair)


def build_serving_forward_sharded(
    variables: Dict[str, Any],
    mesh: Mesh,
    num_classes: int = 1,
    depth: int = 4,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The serving forward on this rank's shard of ``mesh``: the batch on
    'data', image rows on 'spatial' (:meth:`.parallel.mesh.Mesh.shard`).

    Every rank of the mesh builds it and calls it together. The returned
    function maps this rank's (B / data, H / spatial, W, C) shard to its fp32
    probabilities (B / data, H / spatial, W, num_classes);
    :meth:`~.parallel.mesh.Mesh.gather` puts the shards together. With one
    spatial rank this is :func:`build_serving_forward` on the rank's
    samples. Raises when the shard's rows or width are not divisible by
    ``2**depth``, or a shard has fewer than 2 rows at the deepest stage.
    """
    device = torch.device(device)
    weights = serving_weights(variables, depth, compute_dtype, device)
    pair = sepconv_pair if mesh.shape["spatial"] == 1 else halo_pair(mesh, sepconv_pair)
    local = _make_forward(weights, num_classes, compute_dtype, device, pair)

    def forward(x: torch.Tensor) -> torch.Tensor:
        check_shard_rows(mesh, x.shape[1], x.shape[2], depth)
        return local(x)

    return forward
