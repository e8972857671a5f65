"""The int8 serving forward: the serving graph with int8 tensors between
its kernels.

Port of ``unet_image_segmentation_tpu/serving_quant.py``. Weights, BN
affines and all compute stay in the compute dtype and fp32: only the
tensors that cross device memory between the kernels (stage outputs,
skips, pooled tensors, decoder upsamples) are stored as ``q =
round(x / s)`` in int8, with a per-tensor power-of-two scale ``s`` from a
one-batch calibration (:func:`calibrate_chained`). Power-of-two scales fold
exactly into the neighbouring linear ops: the input scale into the next
block's depthwise taps, ``1/s_out`` into the producing block's BN affine
(:func:`.ops.fused_sepconv.fold_int8`), the decoder's input scale into the
transpose-up kernel, the last stage's into the head's kernel. So each K7
call runs in its int8 I/O mode, and the quantization error is the rounding
of the activations alone. The 2x2 max pools commute with the (monotone)
quantization.

The graph (:func:`build_serving_forward_quant`) is the float graph's
(:mod:`.serving`) with K7's int8 calls: each encoder stage one call with
``pool=True``, the bottleneck one call, each decoder stage a plain 2x2
transpose-up of the int8 input cast to the compute dtype, quantized, then
one call with ``x2=skip`` and ``in_scale=(s_up, s_skip)``; the head a 1x1
conv in the compute dtype, then sigmoid or softmax in fp32. The JAX graph's
float and no-pool fallbacks exist for TPU lane-packing misfits and are left
out: K7 takes every shape of the graph, and its plan raises on one it
cannot take.

:func:`build_serving_forward_sharded_quant` is the JAX package's row-sharded
int8 graph, with its own numerics: int8 halos and edge flags around each
int8 I/O pair of the encoder and bottleneck, the pools on int8; in each
decoder stage the float ``[transpose-up | dequantized skip]`` (the
transpose-up's kernel scaled by the input's scale) into K7's
float-in/int8-out mode; the head on the last stage, its kernel scaled.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Union

import torch

from unet_image_segmentation_tpu_torch.ops import conv as conv_ops
from unet_image_segmentation_tpu_torch.ops.fused_sepconv import (
    BlockWeights,
    fold_int8,
    sepconv_pair_int8,
    sepconv_pair_quant_out,
)
from unet_image_segmentation_tpu_torch.parallel.mesh import Mesh
from unet_image_segmentation_tpu_torch.serving import (
    ServingWeights,
    check_shard_rows,
    halo_pair,
    serving_weights,
)


def quantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric int8 quantization: ``q = clip(round(x / s), -127, 127)``
    (round half to even)."""
    return torch.clamp(torch.round(x.float() * (1.0 / scale)), -127.0, 127.0).to(torch.int8)


def dequantize(q: torch.Tensor, scale: float, dtype: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    return q.to(dtype) * torch.tensor(scale, dtype=dtype, device=q.device)


def pow2_scale(max_abs: float) -> float:
    """Smallest power-of-two scale covering ``max_abs`` within int8; 1.0 for
    a maximum that is not a positive finite number."""
    m = float(max_abs)
    if not math.isfinite(m) or m <= 0.0:
        return 1.0
    return 2.0 ** math.ceil(math.log2(m / 127.0))


def _plain_block(x: torch.Tensor, w: BlockWeights) -> torch.Tensor:
    """Composed sepconv + BN + ReLU block (the calibration path, no
    kernels): depthwise and pointwise in x's dtype, the affine in fp32."""
    y = conv_ops.depthwise_conv2d(x, w.dw.unsqueeze(-1))
    y = conv_ops.pointwise_conv2d(y, w.pw)
    return (y.float() * w.scale + w.shift).clamp_min(0.0).to(x.dtype)


@torch.no_grad()
def calibrate_chained(
    variables: Dict[str, Any],
    sample: torch.Tensor,
    num_classes: int = 1,
    depth: int = 4,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, float]:
    """One-batch activation-range calibration of the int8 graph.

    Runs the float forward with composed ops over ``sample`` (on its device)
    and returns the power-of-two scales keyed as the int8 graph reads them:
    ``input``, ``enc{1..depth}``, ``bneck``, ``dec{s}_up`` and ``dec{s}``.
    ``num_classes`` is accepted for the JAX signature; the head needs no
    scale.
    """
    del num_classes
    w = serving_weights(variables, depth, compute_dtype, sample.device)
    maxes = {"input": sample.abs().max().float()}
    x = sample.to(compute_dtype)
    skips = []
    for stage, (w1, w2) in enumerate(w.enc, 1):
        x = _plain_block(_plain_block(x, w1), w2)
        maxes[f"enc{stage}"] = x.max().float()
        skips.append(x)
        x = conv_ops.max_pool_2x2(x)
    x = _plain_block(_plain_block(x, w.bneck[0]), w.bneck[1])
    maxes["bneck"] = x.max().float()
    for stage in range(depth, 0, -1):
        kernel, bias, (w1, w2) = w.dec[stage]
        x = conv_ops.conv_transpose_2x2(x, kernel, bias)
        maxes[f"dec{stage}_up"] = x.abs().max().float()
        x = torch.cat([x, skips[stage - 1]], dim=-1)
        x = _plain_block(_plain_block(x, w1), w2)
        maxes[f"dec{stage}"] = x.max().float()
    return {k: pow2_scale(v.item()) for k, v in maxes.items()}


def _fold_encoder(w: ServingWeights, scales: Dict[str, float]):
    """The encoder's and the bottleneck's K7 pairs folded for int8 I/O."""
    s_cur, enc = scales["input"], []
    for stage, (w1, w2) in enumerate(w.enc, 1):
        s_out = scales[f"enc{stage}"]
        enc.append(fold_int8(w1, w2, s_cur, s_out, w1.dw.shape[-1]))
        s_cur = s_out
    return enc, fold_int8(*w.bneck, s_cur, scales["bneck"], w.bneck[0].dw.shape[-1])


def build_serving_forward_quant(
    variables: Dict[str, Any],
    scales: Dict[str, float],
    num_classes: int = 1,
    depth: int = 4,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The int8 serving forward over a separable-conv U-Net variable tree.

    ``scales`` comes from :func:`calibrate_chained` (or any dict with its
    keys; powers of two keep the folds exact). The weights are prepared and
    the scales folded into them once, here. The returned function maps
    (B, H, W, C) float images to fp32 probabilities (B, H, W, num_classes) on
    ``device``.
    """
    device = torch.device(device)
    w = serving_weights(variables, depth, compute_dtype, device)
    enc, bneck = _fold_encoder(w, scales)
    s_cur = scales["bneck"]
    dec = {}
    for stage in range(depth, 0, -1):
        kernel, bias, (w1, w2) = w.dec[stage]
        s_up, s_out = scales[f"dec{stage}_up"], scales[f"dec{stage}"]
        # the input's scale folds into the (linear) transpose-up kernel
        dec[stage] = ((kernel * s_cur).to(compute_dtype), bias.to(compute_dtype), s_up,
                      fold_int8(w1, w2, (s_up, scales[f"enc{stage}"]), s_out, kernel.shape[2]))
        s_cur = s_out
    head_k = (w.head[0] * s_cur).to(compute_dtype)
    head_b = w.head[1].to(compute_dtype)
    s_in = scales["input"]

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        xq = quantize(x.to(device), s_in).contiguous()
        skips = []
        for w1, w2 in enc:
            skip, xq = sepconv_pair_int8(xq, w1, w2, pool=True)
            skips.append(skip)
        xq = sepconv_pair_int8(xq, *bneck)
        for stage in range(depth, 0, -1):
            kernel, bias, s_up, (w1, w2) = dec[stage]
            up = conv_ops.conv_transpose_2x2(xq.to(compute_dtype), kernel, bias)
            xq = sepconv_pair_int8(quantize(up, s_up), w1, w2, x2=skips[stage - 1])
        logits = conv_ops.pointwise_conv2d(xq.to(compute_dtype), head_k, head_b).float()
        if num_classes == 1:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)

    return forward


def build_serving_forward_sharded_quant(
    variables: Dict[str, Any],
    scales: Dict[str, float],
    mesh: Mesh,
    num_classes: int = 1,
    depth: int = 4,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The row-sharded int8 serving forward on this rank's shard of
    ``mesh`` (JAX ``build_serving_forward_sharded_quant``).

    As :func:`.serving.build_serving_forward_sharded`: every rank builds and
    calls it together, and it maps this rank's (B / data, H / spatial, W, C)
    float shard to its fp32 probabilities. The halos are int8 where the
    tensors are (the encoder and the bottleneck; zero is 0 in int8, so the
    zero halo at the image edge stays 'same' padding) and float in the
    decoder. With one spatial rank it runs the same graph without halos.
    """
    device = torch.device(device)
    w = serving_weights(variables, depth, compute_dtype, device)
    enc, bneck = _fold_encoder(w, scales)
    s_cur, dec = scales["bneck"], {}
    for stage in range(depth, 0, -1):
        kernel, bias, (w1, w2) = w.dec[stage]
        s_out = scales[f"dec{stage}"]
        # the input's scale folds into the transpose-up; the float concat
        # goes into K7 unscaled, its output scale folded into block 2
        dec[stage] = ((kernel * s_cur).to(compute_dtype), bias.to(compute_dtype),
                      scales[f"enc{stage}"], fold_int8(w1, w2, None, s_out, kernel.shape[2]))
        s_cur = s_out
    head_k = (w.head[0] * s_cur).to(compute_dtype)
    head_b = w.head[1].to(compute_dtype)
    s_in = scales["input"]
    if mesh.shape["spatial"] == 1:
        pair_q8, pair_qo = sepconv_pair_int8, sepconv_pair_quant_out
    else:
        pair_q8 = halo_pair(mesh, sepconv_pair_int8)
        pair_qo = halo_pair(mesh, sepconv_pair_quant_out)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        check_shard_rows(mesh, x.shape[1], x.shape[2], depth)
        xq = quantize(x.to(device), s_in).contiguous()
        skips = []
        for w1, w2 in enc:
            skip, xq = pair_q8(xq, w1, w2, pool=True)
            skips.append(skip)
        xq = pair_q8(xq, *bneck)
        for stage in range(depth, 0, -1):
            kernel, bias, s_skip, (w1, w2) = dec[stage]
            up = conv_ops.conv_transpose_2x2(xq.to(compute_dtype), kernel, bias)
            skip = dequantize(skips[stage - 1], s_skip, compute_dtype)
            xq = pair_qo(up, w1, w2, x2=skip)
        logits = conv_ops.pointwise_conv2d(xq.to(compute_dtype), head_k, head_b).float()
        if num_classes == 1:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)

    return forward
