"""The decoder feed: 2x2/stride-2 transpose conv + bias, then ``[up | skip]``.

Port of ``unet_image_segmentation_tpu/ops/pallas/fused_upconcat.py`` (K6)
without its TPU layout machinery (lane packing, row-pair views, the
permutation and regroup matmuls): on the card the concat is a plain NHWC
tensor, so every decoder stage takes this path, whatever its skip's width.
Hand-written CUDA kernels (``kernels/csrc/upconcat.cu``: one tensor-core
body for both dtypes and every width, bf16 on ``mma.sync``, fp32 as
3xTF32), each direction beside its plain PyTorch version:

* :func:`upconcat` (TPU ``_fwd_kernel``): ``x (B,H,W,C)`` and the Keras
  transpose kernel ``(2,2,F,C)`` give ``up[2i+di, 2j+dj, f] = Σ_c x[i,j,c]
  K[di,dj,f,c] + bias[f]``, accumulated in fp32 with the bias added in fp32
  and rounded once to the compute dtype T (the Pallas kernel's rounding);
  the output ``cat (B,2H,2W,2F)`` holds ``up`` in channels ``[0, F)`` and
  ``skip`` in ``[F, 2F)``.
* :func:`upconcat_bwd` (TPU ``_bwd_kernel``): from the cotangent ``g`` of
  ``cat``, ``dx = dup . W^T`` (``dup`` read in T, fp32 sums, written in T),
  ``d_skip = g[..., F:]``, ``d_kernel = Σ x ⊗ dup`` and ``d_bias = Σ dup``
  (fp32).

:func:`upconcat_plan` is the kernels' launch plan, which the C entries
check. The composed feed of the JAX package (``ops/conv.py:
conv_transpose_2x2``) rounds the product to T before a T-dtype bias add;
this one, like the Pallas kernel, adds the bias in fp32. In fp32 the two
agree. Each wrapper runs its plain version on a CPU tensor and its kernel
on a CUDA tensor (or raises); :data:`LAUNCHES` counts kernel launches and
only those.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from unet_image_segmentation_tpu_torch.ops import fused_train as ft
from unet_image_segmentation_tpu_torch.ops.kernels import build

LAUNCHES: Dict[str, int] = {"upconcat": 0, "upconcat_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _wmat(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(2,2,F,C) -> (C, 4F) in ``dtype``, columns in (di, dj, f) order."""
    c, f = kernel.shape[3], kernel.shape[2]
    return kernel.permute(3, 0, 1, 2).reshape(c, 4 * f).to(dtype).contiguous()


def _wt(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(2,2,F,C) -> (4F, C) in ``dtype``: the kernel as it lies, the
    transpose of :func:`_wmat`."""
    c, f = kernel.shape[3], kernel.shape[2]
    return kernel.reshape(4 * f, c).to(dtype).contiguous()


# --------------------------------------------------------------------------
# The kernels' launch plan
# --------------------------------------------------------------------------

# kernels/csrc/upconcat.cu: the forward and dx take 128 pixels of x by 128
# GEMM columns a CTA through a 3-stage ring of build.CHUNK-deep chunks;
# d_kernel takes 128x128 (C, 4F) tiles, pixels in chunks of the same depth
# through a 3-stage ring, split-K so the grid fills whole waves of
# _DW_CTAS_PER_SM CTAs an SM of the card, with at least _DW_MIN_SPLIT pixels
# a split
_FEED_TILE, _FEED_STAGES = 128, 3
_DW_TILE, _DW_STAGES = 128, 3
_DW_CTAS_PER_SM, _DW_MIN_SPLIT = 2, 512


class UpconcatPlan(NamedTuple):
    """K6's launch. Forward: ``tiles_fwd`` column tiles of 128 over 4F for
    each 128-pixel tile of x, one CTA each, the column tiles of a pixel tile
    neighbours on the 1-D grid ``grid_fwd``; dx the same over C
    (``tiles_dx``, ``grid_dx``); ``smem`` bytes of dynamic shared memory a
    CTA of either. d_kernel: 128x128 tiles of (C, 4F), split-K over
    ``splits`` runs of ``per`` pixels, on ``grid_dw`` (4F tiles, C tiles,
    splits), ``smem_dw`` bytes."""

    tiles_fwd: int
    tiles_dx: int
    smem: int
    splits: int
    per: int
    smem_dw: int
    grid_fwd: Tuple[int]
    grid_dx: Tuple[int]
    grid_dw: Tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def upconcat_plan(b: int, h: int, w: int, c: int, f: int, dtype: torch.dtype,
                  sms: int) -> UpconcatPlan:
    """K6's launch plan for x ``(b, h, w, c)`` and ``f`` output channels in
    ``dtype`` on a card of ``sms`` streaming multiprocessors
    (:func:`.kernels.build.sm_count`). The layouts are ``FeedSmem`` and
    ``DwSmem`` of ``upconcat.cu``, which checks the byte counts. Raises on
    what the kernels cannot launch."""
    if min(b, h, w, c, f) < 1:
        raise ValueError(f"upconcat: empty shape B={b} H={h} W={w} C={c} F={f}")
    if dtype not in build.CHUNK:
        raise TypeError(f"upconcat: dtype {dtype} not supported (float32, bfloat16)")
    p = b * h * w
    if 4 * p >= 2 ** 31:
        raise ValueError(f"upconcat: {4 * p} output pixels, at most 2^31 - 1")
    kc, _ = build.CHUNK[dtype]
    e = dtype.itemsize
    v = 16 // e
    # in T: A stages [3][128][kc + v] and B stages [3][kc][128 + 8]; the
    # output pixels of the tile's rows (128 int)
    smem = e * (_FEED_STAGES * _FEED_TILE * (kc + v) + _FEED_STAGES * kc * (_FEED_TILE + 8)) \
        + 4 * _FEED_TILE
    smem_dw = e * _DW_STAGES * kc * 2 * (_DW_TILE + 8)   # stages of x and dup [kc][128 + 8]
    for nbytes in (smem, smem_dw):
        if nbytes > ft.SMEM_MAX:
            raise ValueError(f"upconcat: {nbytes} bytes of shared memory, at most {ft.SMEM_MAX}")
    tiles = _cdiv(p, _FEED_TILE)
    tiles_fwd, tiles_dx = _cdiv(4 * f, _FEED_TILE), _cdiv(c, _FEED_TILE)
    out_tiles = _cdiv(c, _DW_TILE) * _cdiv(4 * f, _DW_TILE)
    splits = max(1, min(_DW_CTAS_PER_SM * sms // out_tiles, _cdiv(p, _DW_MIN_SPLIT)))
    per = _cdiv(_cdiv(p, splits), kc) * kc
    splits = _cdiv(p, per)
    if splits > 65535:
        raise ValueError(f"upconcat: {splits} d_kernel splits, at most 65535")
    return UpconcatPlan(tiles_fwd, tiles_dx, smem, splits, per, smem_dw, (tiles * tiles_fwd,),
                        (tiles * tiles_dx,), (_cdiv(4 * f, _DW_TILE), _cdiv(c, _DW_TILE), splits))


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# --------------------------------------------------------------------------


def upconcat_reference(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, skip: torch.Tensor
) -> torch.Tensor:
    """Plain K6 forward: ``cat (B,2H,2W,2F)`` in x.dtype."""
    b, h, w, c = x.shape
    f = kernel.shape[2]
    y = torch.matmul(x.float(), _wmat(kernel, x.dtype).float()) + bias.float().repeat(4)
    up = y.to(x.dtype).reshape(b, h, w, 2, 2, f).permute(0, 1, 3, 2, 4, 5)
    return torch.cat([up.reshape(b, 2 * h, 2 * w, f), skip.to(x.dtype)], dim=-1).contiguous()


def upconcat_bwd_reference(
    x: torch.Tensor, kernel: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K6 backward: ``(dx (T), d_kernel (2,2,F,C) fp32, d_bias (F,) fp32,
    d_skip (T))``."""
    b, h, w, c = x.shape
    f = kernel.shape[2]
    dup = (g[..., :f].reshape(b, h, 2, w, 2, f).permute(0, 1, 3, 2, 4, 5)
           .reshape(b * h * w, 4 * f).float())
    dx = torch.matmul(dup, _wmat(kernel, g.dtype).float().t()).to(x.dtype).reshape(b, h, w, c)
    dwm = torch.matmul(x.reshape(-1, c).float().t(), dup)              # (C, 4F)
    d_kernel = dwm.reshape(c, 2, 2, f).permute(1, 2, 3, 0).contiguous()
    d_bias = dup.sum(dim=0).reshape(4, f).sum(dim=0)
    return dx.contiguous(), d_kernel, d_bias, g[..., f:].contiguous()


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, shape, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {t.device}")
    if t.dtype not in build.DTYPE_CODE or t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype} (float32 or bfloat16)")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def upconcat(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, skip: torch.Tensor
) -> torch.Tensor:
    """K6 forward on a CUDA tensor, its plain version on a CPU tensor.

    ``x (B,H,W,C)`` and ``skip (B,2H,2W,F)`` in one dtype T, ``kernel
    (2,2,F,C)`` (cast to T), ``bias (F,)`` (fp32). Returns ``cat``.
    """
    if x.device.type == "cpu":
        return upconcat_reference(x, kernel, bias, skip)
    b, h, w, c = x.shape
    f = kernel.shape[2]
    _check(x, "upconcat x", (b, h, w, c), x.dtype)
    _check(skip, "upconcat skip", (b, 2 * h, 2 * w, f), x.dtype)
    if tuple(kernel.shape) != (2, 2, f, c):
        raise ValueError(f"upconcat: kernel {tuple(kernel.shape)} does not fit x {tuple(x.shape)}")
    wmat = _wmat(kernel, x.dtype)
    bvec = bias.float().contiguous()
    if bvec.shape != (f,) or bvec.device != x.device:
        raise ValueError(f"upconcat: bias {tuple(bias.shape)} on {bias.device}, expected ({f},)")
    plan = upconcat_plan(b, h, w, c, f, x.dtype, build.sm_count(x.device))
    lib = build.load_library()
    cat = torch.empty((b, 2 * h, 2 * w, 2 * f), dtype=x.dtype, device=x.device)
    status = lib.unet_upconcat(
        x.data_ptr(), wmat.data_ptr(), bvec.data_ptr(), skip.data_ptr(), cat.data_ptr(),
        b, h, w, c, f, plan.tiles_fwd, plan.smem,
        build.DTYPE_CODE[x.dtype], build.stream_handle(x.device),
    )
    build.check(status, "upconcat")
    LAUNCHES["upconcat"] += 1
    return cat


def upconcat_bwd(
    x: torch.Tensor, kernel: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 backward on a CUDA tensor, its plain version on a CPU tensor:
    ``(dx, d_kernel (2,2,F,C) fp32, d_bias (F,) fp32, d_skip)``."""
    if x.device.type == "cpu":
        return upconcat_bwd_reference(x, kernel, g)
    b, h, w, c = x.shape
    f = kernel.shape[2]
    _check(x, "upconcat_bwd x", (b, h, w, c), x.dtype)
    _check(g, "upconcat_bwd g", (b, 2 * h, 2 * w, 2 * f), x.dtype)
    if tuple(kernel.shape) != (2, 2, f, c):
        raise ValueError(f"upconcat_bwd: kernel {tuple(kernel.shape)} does not fit x")
    wt = _wt(kernel, x.dtype)
    plan = upconcat_plan(b, h, w, c, f, x.dtype, build.sm_count(x.device))
    lib = build.load_library()
    dx = torch.empty_like(x)
    d_skip = torch.empty((b, 2 * h, 2 * w, f), dtype=x.dtype, device=x.device)
    dwb = torch.empty((c + 1, 4 * f), dtype=torch.float32, device=x.device)  # d_kernel; d_bias row
    work = torch.empty(lib.unet_upconcat_bwd_workspace(b, h, w, c, f, plan.splits),
                       dtype=torch.float32, device=x.device)
    status = lib.unet_upconcat_bwd(
        x.data_ptr(), wt.data_ptr(), g.data_ptr(), dx.data_ptr(), d_skip.data_ptr(),
        work.data_ptr(), dwb.data_ptr(), b, h, w, c, f, plan.tiles_dx, plan.smem,
        plan.splits, plan.per, plan.smem_dw, build.DTYPE_CODE[x.dtype],
        build.stream_handle(x.device),
    )
    build.check(status, "upconcat_bwd")
    LAUNCHES["upconcat_bwd"] += 1
    d_kernel = dwb[:c].reshape(c, 2, 2, f).permute(1, 2, 3, 0).contiguous()
    return dx, d_kernel, dwb[c].reshape(4, f).sum(dim=0), d_skip


# --------------------------------------------------------------------------
# Autograd
# --------------------------------------------------------------------------


class _UpConcat(torch.autograd.Function):
    """``cat = [transpose_up(x) + bias | skip]`` with the K6 backward."""

    @staticmethod
    def forward(ctx, x, kernel, bias, skip):
        ctx.save_for_backward(x, kernel)
        ctx.bias_dtype = bias.dtype
        return upconcat(x, kernel, bias, skip)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        dx, d_kernel, d_bias, d_skip = upconcat_bwd(x, kernel, g.to(x.dtype).contiguous())
        return dx, d_kernel.to(kernel.dtype), d_bias.to(ctx.bias_dtype), d_skip


def fused_upconcat(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    skip: torch.Tensor,
) -> torch.Tensor:
    """Decoder feed ``[TransposeUp(x) | skip]`` (B,2H,2W,2F) in x.dtype,
    differentiable in all four inputs. ``kernel (2,2,F,C)`` in the Keras
    transpose layout; ``bias`` (F,) or None."""
    if bias is None:
        bias = torch.zeros(kernel.shape[2], dtype=torch.float32, device=x.device)
    return _UpConcat.apply(x.contiguous(), kernel, bias, skip.to(x.dtype).contiguous())
