"""The serving path's fused separable-conv kernels, K8 (one block) and K7 (a pair).

Port of ``unet_image_segmentation_tpu/ops/pallas/fused_sepconv.py``:

* :func:`fused_sepconv_bn_relu` (K8, TPU kernel ``_sepconv_kernel_db``):
  ``relu?((dw3x3(x) -> dtype) . pw * scale + shift)`` in one pass, BN folded
  into ``scale``/``shift``. CUDA source: ``kernels/csrc/sepconv_block.cu``.
* :func:`fused_sepconv_pair` (K7, TPU kernel ``_sepconv_pair_kernel_db``):
  two such blocks with ReLU, block 1's output never leaving the chip,
  optionally with the 2x2 max pool of the output (``pool=True``) and a
  two-stream input ``[x | x2]`` (``x2=``). CUDA source:
  ``kernels/csrc/sepconv_pair.cu``.

Each kernel's wrapper (:func:`sepconv_block`, :func:`sepconv_pair`) takes
weights already cast to the compute dtype and fp32 affines
(:class:`BlockWeights`). Given a CPU tensor it runs the plain PyTorch
version beside it (``*_reference``); given a CUDA tensor it launches the
kernel on the current stream or raises. :data:`LAUNCHES` counts kernel
launches, and only those.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from unet_image_segmentation_tpu_torch.ops.conv import max_pool_2x2
from unet_image_segmentation_tpu_torch.ops.kernels import build

LAUNCHES: Dict[str, int] = {"sepconv_block": 0, "sepconv_pair": 0}

_MAX_BATCH = 65535  # gridDim.z


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class BlockWeights(NamedTuple):
    """One sepconv block in kernel form: taps (3,3,C) and pointwise (C,F) in
    the compute dtype, scale and shift (F,) in fp32."""

    dw: torch.Tensor
    pw: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor


def fold_affine(
    f: int,
    bias: Optional[torch.Tensor] = None,
    bn_scale: Optional[torch.Tensor] = None,
    bn_offset: Optional[torch.Tensor] = None,
    bn_mean: Optional[torch.Tensor] = None,
    bn_var: Optional[torch.Tensor] = None,
    eps: float = 1e-3,
    device: Union[str, torch.device, None] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN (+ conv bias) as ``y * scale + shift``: ``scale = gamma *
    rsqrt(var + eps)``, ``shift = beta - mean * scale (+ bias * scale)``."""
    if bn_scale is not None:
        scale = (bn_scale * torch.rsqrt(bn_var + eps)).float()
        shift = (bn_offset - bn_mean * scale).float()
        if bias is not None:
            shift = shift + bias * scale
    else:
        scale = torch.ones(f, dtype=torch.float32, device=device)
        shift = (
            bias.float() if bias is not None
            else torch.zeros(f, dtype=torch.float32, device=device)
        )
    return scale.to(device).contiguous(), shift.to(device).contiguous()


def prepare_block(
    block: Dict[str, torch.Tensor],
    dtype: torch.dtype,
    eps: float = 1e-3,
    device: Union[str, torch.device, None] = None,
) -> BlockWeights:
    """A block dict (``depthwise_kernel``, ``pointwise_kernel``, optional
    ``bias`` and BN ``scale``/``offset``/``mean``/``var``) in kernel form."""
    dwk, pwk = block["depthwise_kernel"], block["pointwise_kernel"]
    c, f = pwk.shape[-2], pwk.shape[-1]
    device = device if device is not None else dwk.device
    scale, shift = fold_affine(
        f, block.get("bias"), block.get("scale"), block.get("offset"),
        block.get("mean"), block.get("var"), eps, device,
    )
    return BlockWeights(
        dwk.reshape(3, 3, c).to(device=device, dtype=dtype).contiguous(),
        pwk.reshape(c, f).to(device=device, dtype=dtype).contiguous(),
        scale,
        shift,
    )


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# --------------------------------------------------------------------------


def sepconv_block_reference(
    x: torch.Tensor, w: BlockWeights, relu: bool = True
) -> torch.Tensor:
    """Plain version of K8: fp32 depthwise, rounded to x.dtype, fp32 pointwise."""
    c = x.shape[-1]
    taps = w.dw.float().permute(2, 0, 1).unsqueeze(1)  # (C, 1, 3, 3)
    d = F.conv2d(x.float().permute(0, 3, 1, 2), taps, padding=1, groups=c)
    d = d.permute(0, 2, 3, 1).to(x.dtype)
    y = torch.matmul(d.float(), w.pw.float()) * w.scale + w.shift
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x.dtype)


def sepconv_pair_reference(
    x: torch.Tensor,
    w1: BlockWeights,
    w2: BlockWeights,
    pool: bool = False,
    x2: Optional[torch.Tensor] = None,
):
    """Plain version of K7: two plain blocks with ReLU. y1 is rounded to
    x.dtype, and block 2's zero padding is the zero y1 outside the image."""
    xin = torch.cat([x, x2], dim=-1) if x2 is not None else x
    y = sepconv_block_reference(sepconv_block_reference(xin, w1), w2)
    if pool:
        return y, max_pool_2x2(y)
    return y


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_cuda_input(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous NHWC tensor, got {tuple(x.shape)}")
    if not 0 < x.shape[0] <= _MAX_BATCH:
        raise ValueError(f"{name}: batch {x.shape[0]} outside 1..{_MAX_BATCH}")


def _check_weights(w: BlockWeights, c: int, x: torch.Tensor, name: str) -> int:
    f = w.pw.shape[-1]
    expect = [
        (w.dw, (3, 3, c), x.dtype),
        (w.pw, (c, f), x.dtype),
        (w.scale, (f,), torch.float32),
        (w.shift, (f,), torch.float32),
    ]
    for t, shape, dtype in expect:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(
                f"{name}: weight {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"expected {shape} {dtype} on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous")
    return f


def sepconv_block(
    x: torch.Tensor, w: BlockWeights, relu: bool = True
) -> torch.Tensor:
    """K8 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return sepconv_block_reference(x, w, relu)
    _check_cuda_input(x, "sepconv_block")
    b, h, wd, c = x.shape
    f = _check_weights(w, c, x, "sepconv_block")
    lib = build.load_library()
    out = torch.empty((b, h, wd, f), dtype=x.dtype, device=x.device)
    status = lib.unet_sepconv_block(
        x.data_ptr(), w.dw.data_ptr(), w.pw.data_ptr(), w.scale.data_ptr(),
        w.shift.data_ptr(), out.data_ptr(), b, h, wd, c, f, int(relu),
        build.DTYPE_CODE[x.dtype], build.stream_handle(x.device),
    )
    build.check(status, "sepconv_block")
    LAUNCHES["sepconv_block"] += 1
    return out


def sepconv_pair(
    x: torch.Tensor,
    w1: BlockWeights,
    w2: BlockWeights,
    pool: bool = False,
    x2: Optional[torch.Tensor] = None,
):
    """K7 on a CUDA tensor, its plain version on a CPU tensor.

    Returns ``y`` or, with ``pool=True``, ``(y, max_pool_2x2(y))``.
    """
    if x.device.type == "cpu":
        return sepconv_pair_reference(x, w1, w2, pool=pool, x2=x2)
    _check_cuda_input(x, "sepconv_pair")
    b, h, wd, cx = x.shape
    cx2 = 0
    if x2 is not None:
        _check_cuda_input(x2, "sepconv_pair x2")
        if x2.shape[:3] != x.shape[:3] or x2.dtype != x.dtype or x2.device != x.device:
            raise ValueError(
                f"sepconv_pair: x2 {tuple(x2.shape)} {x2.dtype} does not match "
                f"x {tuple(x.shape)} {x.dtype}"
            )
        cx2 = x2.shape[-1]
    f1 = _check_weights(w1, cx + cx2, x, "sepconv_pair block1")
    f2 = _check_weights(w2, f1, x, "sepconv_pair block2")
    if pool and (h % 2 or wd % 2):
        raise ValueError(f"sepconv_pair: pool needs even H and W, got {h}x{wd}")
    lib = build.load_library()
    out = torch.empty((b, h, wd, f2), dtype=x.dtype, device=x.device)
    pooled = (
        torch.empty((b, h // 2, wd // 2, f2), dtype=x.dtype, device=x.device)
        if pool else None
    )
    status = lib.unet_sepconv_pair(
        x.data_ptr(), x2.data_ptr() if x2 is not None else None,
        w1.dw.data_ptr(), w1.pw.data_ptr(), w1.scale.data_ptr(), w1.shift.data_ptr(),
        w2.dw.data_ptr(), w2.pw.data_ptr(), w2.scale.data_ptr(), w2.shift.data_ptr(),
        out.data_ptr(), pooled.data_ptr() if pooled is not None else None,
        b, h, wd, cx, cx2, f1, f2, build.DTYPE_CODE[x.dtype],
        build.stream_handle(x.device),
    )
    build.check(status, "sepconv_pair")
    LAUNCHES["sepconv_pair"] += 1
    return (out, pooled) if pool else out


# --------------------------------------------------------------------------
# Entry points with the JAX package's signatures
# --------------------------------------------------------------------------


def fused_sepconv_bn_relu(
    x: torch.Tensor,
    depthwise_kernel: torch.Tensor,         # (3, 3, C, 1)
    pointwise_kernel: torch.Tensor,         # (1, 1, C, F) or (C, F)
    bias: Optional[torch.Tensor] = None,
    bn_scale: Optional[torch.Tensor] = None,
    bn_offset: Optional[torch.Tensor] = None,
    bn_mean: Optional[torch.Tensor] = None,
    bn_var: Optional[torch.Tensor] = None,
    eps: float = 1e-3,
    relu: bool = True,
) -> torch.Tensor:
    """Fused inference block: sepconv (+bias) (+folded BN) (+ReLU), K8."""
    block = {"depthwise_kernel": depthwise_kernel, "pointwise_kernel": pointwise_kernel}
    if bias is not None:
        block["bias"] = bias
    if bn_scale is not None:
        block.update(scale=bn_scale, offset=bn_offset, mean=bn_mean, var=bn_var)
    return sepconv_block(x, prepare_block(block, x.dtype, eps, x.device), relu)


def fused_sepconv_pair(
    x: torch.Tensor,
    block1: Dict[str, torch.Tensor],
    block2: Dict[str, torch.Tensor],
    eps: float = 1e-3,
    pool: bool = False,
    x2: Optional[torch.Tensor] = None,
):
    """Inference ConvBlock pair (sepconv+BN+ReLU twice) in one kernel, K7.

    ``block1``/``block2`` are dicts as in :func:`prepare_block`. With
    ``x2`` block 1 reads the channel concat ``[x | x2]`` from both tensors;
    with ``pool`` the result is ``(y, pooled)``.
    """
    w1 = prepare_block(block1, x.dtype, eps, x.device)
    w2 = prepare_block(block2, x.dtype, eps, x.device)
    return sepconv_pair(x, w1, w2, pool=pool, x2=x2)
