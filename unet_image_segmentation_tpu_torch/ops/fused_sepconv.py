"""The fused separable-conv kernels: K8 (one block), K7 (a pair), and the
per-block training kernels K9 (forward with the BatchNorm sums) and K10
(backward).

Port of ``unet_image_segmentation_tpu/ops/pallas/fused_sepconv.py`` and
``fused_sepconv_bwd.py``:

* :func:`fused_sepconv_bn_relu` (K8, TPU kernel ``_sepconv_kernel_db``):
  ``relu?((dw3x3(x) -> dtype) . pw * scale + shift)`` in one pass, BN folded
  into ``scale``/``shift``. CUDA source: ``kernels/csrc/sepconv_block.cu``,
  the forward body of ``sepconv_fwd.cuh`` (shared with K1) with K8's
  epilogue; its launch plan is :func:`..fused_train.fwd_plan` and
  :func:`..fused_train.fwd_work` counts the multiply-adds it executes.
* :func:`fused_sepconv_pair` (K7, TPU kernel ``_sepconv_pair_kernel_db``):
  two such blocks with ReLU, block 1's output never leaving the chip,
  optionally with the 2x2 max pool of the output (``pool=True``) and a
  two-stream input ``[x | x2]`` (``x2=``). CUDA source:
  ``kernels/csrc/sepconv_pair.cu``, one thread-block cluster per 8x8 tile;
  :func:`pair_plan` chooses its launch and :func:`pair_work` counts the
  multiply-adds it executes. Its int8 I/O mode (:func:`sepconv_pair_int8`,
  the TPU kernel's ``quant_out`` with int8 input): int8 x (and x2) in,
  int8 y (and pooled) out, the compute in the weights' dtype, the scales
  folded into the weights beforehand (:func:`fold_int8`). Its
  float-in/int8-out mode (:func:`sepconv_pair_quant_out`, ``quant_out``
  with a float input): x (and x2) in the compute dtype, int8 y (and
  pooled). Each mode takes ``edge_flags=(top, bottom)`` for row-sharded
  serving: x is a row shard with 2 halo rows each side, and a set flag
  says that side's halo rows lie beyond the true image edge, so y1 is zero
  on them (the TPU kernel's ``edge_flags``).
* :func:`sepconv_stats` (K9, TPU kernel ``_sepconv_kernel_db_stats``): the
  plain sepconv ``y = (dw3x3(x) -> dtype) . pw`` rounded to the dtype, with
  the per-channel Σy and Σy² of the rounded y. CUDA source: the
  ``unet_sepconv_stats`` entry of ``kernels/csrc/chain_fwd.cu``: K1's
  forward body and epilogue with no prologue (no input transform, no
  dropout), on K1's launch plan :func:`..fused_train.fwd_plan`.
* :func:`sepconv_bwd` (K10, TPU kernel ``fused_sepconv_bwd.py:_bwd_kernel``):
  ``dx`` (written in the dtype), ``ddw``, ``dpw`` and ``dbias`` of the plain
  sepconv from x and the cotangent g. CUDA source: the ``unet_sepconv_bwd``
  entry of ``kernels/csrc/chain_bwd.cu`` (K2's two passes without the
  BatchNorm backward, plus Σg; its launch plan is
  :func:`..fused_train.chain_bwd_plan` with the dbias row).

Each kernel's wrapper takes weights already cast to the compute dtype (and
K7/K8 fp32 affines, :class:`BlockWeights`). Given a CPU tensor it runs the
plain PyTorch version beside it (``*_reference``); given a CUDA tensor it
launches the kernel on the current stream or raises. :data:`LAUNCHES`
counts kernel launches, and only those.

K8 is the registered PyTorch op ``unet::sepconv_block``
(:func:`sepconv_block_op`: CUDA, CPU, fake and autograd implementations),
the counterpart of the TPU kernel's Mosaic custom call, so that
``torch.export`` keeps it as one node a block and an exported graph runs
the kernel (:mod:`..export.pt2`).

The differentiable entry points follow the JAX custom VJPs:
:func:`fused_sepconv_bn_relu` runs the op (K8 forward, the composed
backward: ``_sepconv_core``), :func:`sepconv_apply` K8 forward and K10
backward (``_sepconv_plain``), :func:`sepconv_apply_stats` K9 forward and K10
backward (``_sepconv_stats``: the cotangents of Σy and Σy² fold into the
output cotangent, ``g = T(gy + gs + 2 y gq)``, and ``ddw``/``dpw`` are
rounded to the dtype, as the JAX VJP casts them to the kernels' dtype).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from unet_image_segmentation_tpu_torch.ops import fused_train as ft
from unet_image_segmentation_tpu_torch.ops.conv import max_pool_2x2
from unet_image_segmentation_tpu_torch.ops.kernels import build

# K7's launches count under their I/O mode (float, int8 I/O, float in and
# int8 out); those that carry edge flags count under sepconv_pair_edge too
LAUNCHES: Dict[str, int] = {"sepconv_block": 0, "sepconv_pair": 0, "sepconv_pair_int8": 0,
                            "sepconv_pair_quant_out": 0, "sepconv_pair_edge": 0,
                            "sepconv_stats": 0, "sepconv_bwd": 0}

EdgeFlags = Optional[Tuple[Union[int, bool], Union[int, bool]]]

_MAX_BATCH = 65535  # gridDim.y of K7, gridDim.z of the others

# K7's launch plan (kernels/csrc/sepconv_pair.cu): a cluster of up to 8 CTAs
# per 8x8 output tile, each owning a slice of at most 128 channels of F1 and
# of F2; the shared memory a CTA may use (227 KB)
_PAIR_SLICE = 128
_PAIR_MAX_CLUSTER = 8
SMEM_MAX = ft.SMEM_MAX


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
    d = ft._depthwise(x, w.dw).to(x.dtype)
    y = torch.matmul(d.float(), w.pw.float()) * w.scale + w.shift
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x.dtype)


def _kill_edges(y1: torch.Tensor, edge_flags: EdgeFlags) -> torch.Tensor:
    """y1 with its first (last) 2 rows zeroed where the top (bottom) edge
    flag is set."""
    top, bot = edge_flags or (0, 0)
    if not (top or bot):
        return y1
    y1 = y1.clone()
    if top:
        y1[:, :2] = 0
    if bot:
        y1[:, -2:] = 0
    return y1


def sepconv_pair_reference(
    x: torch.Tensor,
    w1: BlockWeights,
    w2: BlockWeights,
    pool: bool = False,
    x2: Optional[torch.Tensor] = None,
    edge_flags: EdgeFlags = None,
):
    """Plain version of K7: two plain blocks with ReLU. y1 is rounded to
    x.dtype, and block 2's zero padding is the zero y1 outside the image
    (and on the rows ``edge_flags`` kill)."""
    xin = torch.cat([x, x2], dim=-1) if x2 is not None else x
    y1 = _kill_edges(sepconv_block_reference(xin, w1), edge_flags)
    y = sepconv_block_reference(y1, w2)
    if pool:
        return y, max_pool_2x2(y)
    return y


def fold_int8(
    w1: BlockWeights,
    w2: BlockWeights,
    in_scale: Optional[Union[float, Tuple[float, float]]],
    out_scale: float,
    cx: int,
) -> Tuple[BlockWeights, BlockWeights]:
    """K7's int8 folds, in the JAX wrapper's order: block 1's taps times the
    input scale in the compute dtype (per channel for a two-stream call, the
    first ``cx`` channels by ``s_x`` of ``in_scale = (s_x, s_x2)``, the rest
    by ``s_x2``; none for a float input, ``in_scale=None``), block 2's scale
    and shift times ``float32(1 / out_scale)``. With power-of-two scales
    both folds are exact."""
    t, c = w1.dw.dtype, w1.dw.shape[-1]
    inv = torch.tensor(1.0 / out_scale, dtype=torch.float32, device=w2.scale.device)
    w2 = w2._replace(scale=(w2.scale * inv).contiguous(), shift=(w2.shift * inv).contiguous())
    if in_scale is None:
        return w1, w2
    if isinstance(in_scale, (tuple, list)):
        s_x, s_x2 = in_scale
        vec = torch.cat([torch.full((cx,), s_x, dtype=t), torch.full((c - cx,), s_x2, dtype=t)])
    else:
        vec = torch.tensor(in_scale, dtype=t)
    return w1._replace(dw=(w1.dw * vec.to(w1.dw.device)).contiguous()), w2


def sepconv_pair_int8_reference(
    xq: torch.Tensor,
    w1: BlockWeights,
    w2: BlockWeights,
    pool: bool = False,
    x2: Optional[torch.Tensor] = None,
    edge_flags: EdgeFlags = None,
):
    """Plain version of K7's int8 I/O mode on weights folded by
    :func:`fold_int8`: int8 x (and x2) cast to the compute dtype (nothing
    dequantized), then :func:`sepconv_pair_quant_out_reference`."""
    t = w1.dw.dtype
    return sepconv_pair_quant_out_reference(
        xq.to(t), w1, w2, pool=pool, x2=x2.to(t) if x2 is not None else None,
        edge_flags=edge_flags)


def sepconv_pair_quant_out_reference(
    x: torch.Tensor,
    w1: BlockWeights,
    w2: BlockWeights,
    pool: bool = False,
    x2: Optional[torch.Tensor] = None,
    edge_flags: EdgeFlags = None,
):
    """Plain version of K7's float-in/int8-out mode on weights whose block 2
    is folded by ``1/out_scale`` (:func:`fold_int8` with ``in_scale=None``):
    x (and x2) in the compute dtype, block 1 as in
    :func:`sepconv_pair_reference`, block 2's affine and ReLU in fp32, then
    ``round(min(y2, 127))`` straight from fp32 (round half to even; no
    rounding to the compute dtype before it, as the TPU kernel's
    ``quant_out`` does), stored as int8; the pool takes the rounded values.
    With fp32 compute this is ``quantize`` of the float pair's output."""
    t = w1.dw.dtype
    xin = torch.cat([x, x2], dim=-1) if x2 is not None else x
    y1 = _kill_edges(sepconv_block_reference(xin, w1), edge_flags)
    d = ft._depthwise(y1, w2.dw).to(t)
    y = torch.matmul(d.float(), w2.pw.float()) * w2.scale + w2.shift
    q = y.clamp_min(0.0).clamp_max(127.0).round().to(torch.int8)
    if pool:
        return q, max_pool_2x2(q)
    return q


def sepconv_stats_reference(
    x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K9: ``(y, Σy, Σy²)``, plain K1 with no input transform: the
    depthwise sum is rounded to x.dtype, the pointwise accumulates in fp32,
    y is rounded, and the sums are taken over the rounded y in fp32."""
    return ft.chain_fwd_reference(x, dw, pw)


def sepconv_bwd_reference(
    x: torch.Tensor, g: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K10: ``(dx, ddw (3,3,C), dpw (C,F), dbias (F,))``, the grads fp32.

    dm = g.pw^T in fp32 (never rounded); dx is the correlation of dm with
    the flipped taps, rounded to x.dtype; ddw = Σ shifted x * dm; the
    recomputed depthwise m is rounded before dpw = m^T.g; dbias = Σg. The
    image edges are zero ('same' padding).
    """
    c = x.shape[-1]
    h, w = x.shape[1], x.shape[2]
    gf = g.float()
    dm = torch.matmul(gf, pw.float().t())
    flipped = dw.float().flip(0, 1).permute(2, 0, 1).unsqueeze(1)
    dx = F.conv2d(dm.permute(0, 3, 1, 2), flipped, padding=1, groups=c).permute(0, 2, 3, 1)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    ddw = torch.stack([
        torch.stack([(xp[:, i:i + h, j:j + w] * dm).sum(dim=(0, 1, 2)) for j in range(3)])
        for i in range(3)
    ])
    m = ft._depthwise(x, dw).to(x.dtype)
    dpw = torch.matmul(m.reshape(-1, c).float().t(), gf.reshape(-1, gf.shape[-1]))
    return dx.to(x.dtype).contiguous(), ddw, dpw, gf.sum(dim=(0, 1, 2))


# --------------------------------------------------------------------------
# K7's launch plan
# --------------------------------------------------------------------------


class PairPlan(NamedTuple):
    """K7's launch: ``n`` CTAs a cluster (1, 2, 4 or 8), CTA r owning F1
    channels ``[r*s1, (r+1)*s1)`` and F2 channels ``[r*s2, (r+1)*s2)`` (cut
    at F1 and F2), both padded to ``width`` (64 or 128) in its GEMM tiles;
    ``tiles_y * tiles_x`` 8x8 output tiles an image, ``n`` CTAs each; the
    grid ``(n * tiles, batch)``; ``smem`` bytes of dynamic shared memory a
    CTA."""

    n: int
    s1: int
    s2: int
    width: int
    tiles_y: int
    tiles_x: int
    grid: Tuple[int, int]
    smem: int


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def slice_ranges(n: int, s: int, f: int) -> list:
    """The ``[start, end)`` channels of each of the ``n`` slices of ``f``
    channels ``s`` wide (the last ones may be short or empty)."""
    return [(min(r * s, f), min((r + 1) * s, f)) for r in range(n)]


def pair_plan(h: int, w: int, c: int, f1: int, f2: int, dtype: torch.dtype,
              batch: int = 1, int8: bool = False) -> PairPlan:
    """K7's launch plan for ``batch`` (H, W) images with C input channels (x
    and x2 together) and widths F1, F2 in the compute ``dtype``; with
    ``int8`` the x tiles hold 1-byte values. The shared-memory layout is
    ``PairSmem`` of ``sepconv_pair.cu``, which checks the byte count."""
    if min(h, w, c, f1, f2) < 1:
        raise ValueError(f"sepconv_pair: empty shape H={h} W={w} C={c} F1={f1} F2={f2}")
    if not 0 < batch <= _MAX_BATCH:
        raise ValueError(f"sepconv_pair: batch {batch} outside 1..{_MAX_BATCH}")
    if dtype not in build.CHUNK:
        raise TypeError(f"sepconv_pair: dtype {dtype} not supported (float32, bfloat16)")
    fmax = max(f1, f2)
    if fmax > _PAIR_SLICE * _PAIR_MAX_CLUSTER:
        raise ValueError(f"sepconv_pair: F1={f1}, F2={f2}; at most "
                         f"{_PAIR_SLICE * _PAIR_MAX_CLUSTER} channels ({_PAIR_MAX_CLUSTER} "
                         f"CTAs of {_PAIR_SLICE})")
    n = 1
    while n * _PAIR_SLICE < fmax:
        n *= 2
    s1, s2 = _round_up(-(-f1 // n), 16), _round_up(-(-f2 // n), 16)
    width = 64 if max(s1, s2) <= 64 else 128
    kc, _ = build.CHUNK[dtype]
    e = dtype.itemsize
    xb = 1 if int8 else e
    ldk, ldn = kc + 16 // e, width + 8
    # fp32 affines (4 x width), then in T the dw1 taps (2 x 9 x kc), dw2
    # taps (9 x width) and weight chunks (2 x kc x ldn); then block 1's x
    # halo tiles (2 x 144 px x kc, in int8 or T) and dw1 chunks (2 x 112 x
    # ldk), whose place block 2's y1 (100 x ldn), d2 (64 x ldn) and pulled d2
    # chunks (2 x 64 x ldk) take, the larger of the two
    front = 16 * width + e * (2 * 9 * kc + 9 * width + 2 * kc * ldn)
    tiles = xb * 2 * 144 * kc + e * 2 * 112 * ldk
    block2 = e * ((100 + 64) * ldn + 2 * 64 * ldk)
    smem = front + max(tiles, block2)
    if smem > SMEM_MAX:
        raise ValueError(f"sepconv_pair: {smem} bytes of shared memory, at most {SMEM_MAX}")
    ty, tx = -(-h // 8), -(-w // 8)
    return PairPlan(n, s1, s2, width, ty, tx, (n * ty * tx, batch), smem)


def pair_work(h: int, w: int, c: int, f1: int, f2: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(executed, useful) multiply-adds of one K7 call on one image. Useful:
    ``H*W*(9C + C*F1 + 9F1 + F1*F2)``. Executed: what :func:`pair_plan`'s
    launch issues, each product counted once (fp32 issues three TF32
    products for each): dw1 on the 10x10 ring of every 8x8 tile with C
    padded to the mma depth in each chunk, GEMM1 over 112 rows and every
    CTA's padded width, dw2 over the padded widths, GEMM2 for every CTA with
    F2 channels over the chunks of every F1 slice."""
    p = pair_plan(h, w, c, f1, f2, dtype)
    kc, ks = build.CHUNK[dtype]
    cpad = sum(min(kc, _round_up(c - c0, ks)) for c0 in range(0, c, kc))
    k2 = sum(min(kc, _round_up(hi - lo - k0, ks))
             for lo, hi in slice_ranges(p.n, p.s1, f1) for k0 in range(0, hi - lo, kc))
    ctas2 = sum(hi > lo for lo, hi in slice_ranges(p.n, p.s2, f2))
    nw = p.n * p.width
    tile = 100 * 9 * cpad + 112 * nw * cpad + 64 * 9 * nw + 64 * p.width * ctas2 * k2
    return p.tiles_y * p.tiles_x * tile, h * w * (9 * c + c * f1 + 9 * f1 + f1 * f2)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_cuda_input(x: torch.Tensor, name: str, dtypes=tuple(build.DTYPE_CODE)) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not supported ({', '.join(map(str, dtypes))})")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous NHWC tensor, got {tuple(x.shape)}")
    if not 0 < x.shape[0] <= _MAX_BATCH:
        raise ValueError(f"{name}: batch {x.shape[0]} outside 1..{_MAX_BATCH}")


def _check_weights(w: BlockWeights, c: int, x: torch.Tensor, name: str,
                   dtype: Optional[torch.dtype] = None) -> int:
    """The block's width; its taps and pointwise in ``dtype`` (x's by default)."""
    f = w.pw.shape[-1]
    dtype = dtype or x.dtype
    _check_tensors(x, name, [
        (w.dw, (3, 3, c), dtype),
        (w.pw, (c, f), dtype),
        (w.scale, (f,), torch.float32),
        (w.shift, (f,), torch.float32),
    ])
    return f


def _check_tensors(x: torch.Tensor, name: str, expect) -> None:
    """Each ``(tensor, shape, dtype)`` of ``expect`` contiguous on x's device."""
    for t, shape, dtype in expect:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(
                f"{name}: weight {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"expected {shape} {dtype} on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous")


@torch.library.custom_op("unet::sepconv_block", mutates_args=(), device_types="cpu")
def sepconv_block_op(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """K8 as the registered op ``unet::sepconv_block``: the kernel on a CUDA
    tensor, its plain version on a CPU tensor, an empty (B, H, W, F) tensor
    of x's dtype when traced (``torch.export``); differentiable, its
    gradient the composed block's (JAX ``_sepconv_core``)."""
    return sepconv_block_reference(x, BlockWeights(dw, pw, scale, shift), relu)


@sepconv_block_op.register_kernel("cuda")
def _sepconv_block_cuda(x, dw, pw, scale, shift, relu):
    _check_cuda_input(x, "sepconv_block")
    b, h, wd, c = x.shape
    w = BlockWeights(dw, pw, scale, shift)
    f = _check_weights(w, c, x, "sepconv_block")
    plan = ft.fwd_plan(b, h, wd, c, f, x.dtype, build.sm_count(x.device))
    lib = build.load_library()
    out = torch.empty((b, h, wd, f), dtype=x.dtype, device=x.device)
    status = lib.unet_sepconv_block(
        x.data_ptr(), dw.data_ptr(), pw.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), b, h, wd, c, f, int(relu), *ft.fwd_plan_args(plan),
        build.DTYPE_CODE[x.dtype], build.stream_handle(x.device),
    )
    build.check(status, "sepconv_block")
    LAUNCHES["sepconv_block"] += 1
    return out


@sepconv_block_op.register_fake
def _sepconv_block_fake(x, dw, pw, scale, shift, relu):
    return x.new_empty((*x.shape[:3], pw.shape[-1]))


def _sepconv_block_setup(ctx, inputs, output):
    *tensors, relu = inputs
    ctx.save_for_backward(*tensors)
    ctx.relu = relu


def _sepconv_block_backward(ctx, g):
    """Autograd through the plain K8, as the JAX ``_sepconv_core`` VJP
    differentiates its XLA reference."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        y = sepconv_block_reference(leaves[0], BlockWeights(*leaves[1:]), ctx.relu)
        grads = torch.autograd.grad(y, leaves, g)
    return (*grads, None)


sepconv_block_op.register_autograd(_sepconv_block_backward, setup_context=_sepconv_block_setup)


def sepconv_block(
    x: torch.Tensor, w: BlockWeights, relu: bool = True
) -> torch.Tensor:
    """K8 on a CUDA tensor, its plain version on a CPU tensor (the op
    :func:`sepconv_block_op`)."""
    return sepconv_block_op(x, w.dw, w.pw, w.scale, w.shift, relu)


def _pair(x, w1, w2, pool, x2, edge_flags, reference, key, in_int8=False, out_int8=False):
    """One K7 call in a mode: ``reference`` on a CPU tensor, else the
    kernel, counted under ``key`` (and ``sepconv_pair_edge`` with flags)."""
    if x.device.type == "cpu":
        return reference(x, w1, w2, pool=pool, x2=x2, edge_flags=edge_flags)
    out, pooled = pair_launch(build.load_library(), x, w1, w2, pool, x2, in_int8=in_int8,
                              out_int8=out_int8, edge_flags=edge_flags)
    LAUNCHES[key] += 1
    if edge_flags is not None:
        LAUNCHES["sepconv_pair_edge"] += 1
    return (out, pooled) if pool else out


def sepconv_pair(
    x: torch.Tensor,
    w1: BlockWeights,
    w2: BlockWeights,
    pool: bool = False,
    x2: Optional[torch.Tensor] = None,
    edge_flags: EdgeFlags = None,
):
    """K7 on a CUDA tensor, its plain version on a CPU tensor.

    Returns ``y`` or, with ``pool=True``, ``(y, max_pool_2x2(y))``.
    ``edge_flags=(top, bottom)``: x is a row shard with 2 halo rows each
    side; a set flag zeroes y1 on that side's 2 halo rows.
    """
    return _pair(x, w1, w2, pool, x2, edge_flags, sepconv_pair_reference, "sepconv_pair")


def sepconv_pair_int8(
    xq: torch.Tensor,
    w1: BlockWeights,
    w2: BlockWeights,
    pool: bool = False,
    x2: Optional[torch.Tensor] = None,
    edge_flags: EdgeFlags = None,
):
    """K7's int8 I/O mode on a CUDA tensor, its plain version
    (:func:`sepconv_pair_int8_reference`) on a CPU tensor.

    ``xq`` (and ``x2``) int8; the weights in the compute dtype, folded by
    :func:`fold_int8`. Returns int8 ``y`` or, with ``pool=True``, ``(y,
    max_pool_2x2(y))``. ``edge_flags`` as in :func:`sepconv_pair`.
    """
    return _pair(xq, w1, w2, pool, x2, edge_flags, sepconv_pair_int8_reference,
                 "sepconv_pair_int8", in_int8=True, out_int8=True)


def sepconv_pair_quant_out(
    x: torch.Tensor,
    w1: BlockWeights,
    w2: BlockWeights,
    pool: bool = False,
    x2: Optional[torch.Tensor] = None,
    edge_flags: EdgeFlags = None,
):
    """K7's float-in/int8-out mode on a CUDA tensor, its plain version
    (:func:`sepconv_pair_quant_out_reference`) on a CPU tensor.

    ``x`` (and ``x2``) in the weights' compute dtype; block 2 folded by
    ``1/out_scale`` (:func:`fold_int8` with ``in_scale=None``). Returns int8
    ``y`` or, with ``pool=True``, ``(y, max_pool_2x2(y))``. ``edge_flags``
    as in :func:`sepconv_pair`.
    """
    return _pair(x, w1, w2, pool, x2, edge_flags, sepconv_pair_quant_out_reference,
                 "sepconv_pair_quant_out", out_int8=True)


def pair_launch(lib, x: torch.Tensor, w1: BlockWeights, w2: BlockWeights, pool: bool,
                x2: Optional[torch.Tensor], in_int8: bool = False, out_int8: bool = False,
                edge_flags: EdgeFlags = None,
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Check K7's inputs, launch ``lib``'s ``unet_sepconv_pair`` on them
    (the kernel library, or an instrumented build of ``sepconv_pair.cu``)
    and return ``(y, pooled or None)``. With ``in_int8`` x and x2 are int8,
    with ``out_int8`` y and pooled (int8 in only with int8 out); the compute
    dtype is the weights'. Counts nothing."""
    if in_int8 and not out_int8:
        raise ValueError("sepconv_pair: an int8 input needs an int8 output")
    dtypes = (torch.int8,) if in_int8 else tuple(build.DTYPE_CODE)
    _check_cuda_input(x, "sepconv_pair", dtypes)
    t = w1.dw.dtype
    if t not in build.DTYPE_CODE:
        raise TypeError(f"sepconv_pair: compute dtype {t} not supported (float32, bfloat16)")
    if not in_int8 and x.dtype != t:
        raise TypeError(f"sepconv_pair: x is {x.dtype}, the weights {t}")
    b, h, wd, cx = x.shape
    cx2 = 0
    if x2 is not None:
        _check_cuda_input(x2, "sepconv_pair x2", dtypes)
        if x2.shape[:3] != x.shape[:3] or x2.dtype != x.dtype or x2.device != x.device:
            raise ValueError(
                f"sepconv_pair: x2 {tuple(x2.shape)} {x2.dtype} does not match "
                f"x {tuple(x.shape)} {x.dtype}"
            )
        cx2 = x2.shape[-1]
    f1 = _check_weights(w1, cx + cx2, x, "sepconv_pair block1", t)
    f2 = _check_weights(w2, f1, x, "sepconv_pair block2", t)
    if pool and (h % 2 or wd % 2):
        raise ValueError(f"sepconv_pair: pool needs even H and W, got {h}x{wd}")
    top, bot = (int(bool(e)) for e in (edge_flags or (0, 0)))
    if (top or bot) and h < 4:
        raise ValueError(f"sepconv_pair: edge flags need a slab of at least 4 rows, got {h}")
    plan = pair_plan(h, wd, cx + cx2, f1, f2, t, b, int8=in_int8)
    ot = torch.int8 if out_int8 else t
    out = torch.empty((b, h, wd, f2), dtype=ot, device=x.device)
    pooled = (
        torch.empty((b, h // 2, wd // 2, f2), dtype=ot, device=x.device)
        if pool else None
    )
    status = lib.unet_sepconv_pair(
        x.data_ptr(), x2.data_ptr() if x2 is not None else None,
        w1.dw.data_ptr(), w1.pw.data_ptr(), w1.scale.data_ptr(), w1.shift.data_ptr(),
        w2.dw.data_ptr(), w2.pw.data_ptr(), w2.scale.data_ptr(), w2.shift.data_ptr(),
        out.data_ptr(), pooled.data_ptr() if pooled is not None else None,
        b, h, wd, cx, cx2, f1, f2, plan.n, plan.s1, plan.s2, plan.width, plan.smem,
        build.DTYPE_CODE[t], int(in_int8), int(out_int8), top, bot, build.stream_handle(x.device),
    )
    build.check(status, "sepconv_pair")
    return out, pooled


def sepconv_stats(
    x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9 on a CUDA tensor, its plain version on a CPU tensor.

    ``dw`` (3,3,C) and ``pw`` (C,F) in x.dtype. Returns ``(y (B,H,W,F),
    Σy (F,), Σy² (F,))``, the sums fp32.
    """
    if x.device.type == "cpu":
        return sepconv_stats_reference(x, dw, pw)
    _check_cuda_input(x, "sepconv_stats")
    b, h, wd, c = x.shape
    f = pw.shape[-1]
    _check_tensors(x, "sepconv_stats", [(dw, (3, 3, c), x.dtype), (pw, (c, f), x.dtype)])
    plan = ft.fwd_plan(b, h, wd, c, f, x.dtype, build.sm_count(x.device))
    lib = build.load_library()
    y = torch.empty((b, h, wd, f), dtype=x.dtype, device=x.device)
    sums = torch.empty((2, f), dtype=torch.float32, device=x.device)
    work = torch.empty(lib.unet_chain_fwd_workspace(b, h, wd, c, f),
                       dtype=torch.float32, device=x.device)
    status = lib.unet_sepconv_stats(
        x.data_ptr(), dw.data_ptr(), pw.data_ptr(), y.data_ptr(), work.data_ptr(),
        sums.data_ptr(), b, h, wd, c, f, *ft.fwd_plan_args(plan), build.DTYPE_CODE[x.dtype],
        build.stream_handle(x.device),
    )
    build.check(status, "sepconv_stats")
    LAUNCHES["sepconv_stats"] += 1
    return y, sums[0], sums[1]


def sepconv_bwd(
    x: torch.Tensor, g: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10 on a CUDA tensor, its plain version on a CPU tensor.

    ``x`` (B,H,W,C) and the cotangent ``g`` (B,H,W,F) in one dtype, ``dw``
    and ``pw`` in it too. Returns ``(dx (B,H,W,C), ddw (3,3,C), dpw (C,F),
    dbias (F,))``, the weight grads fp32.
    """
    if x.device.type == "cpu":
        return sepconv_bwd_reference(x, g, dw, pw)
    return sepconv_bwd_with_m(x, g, dw, pw)[:4]


def sepconv_bwd_with_m(
    x: torch.Tensor, g: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10 on a CUDA tensor, as :func:`sepconv_bwd`, and the (B,H,W,CM)
    depthwise ``m`` its pass (b) consumed (its first C channels;
    ``troubleshoot/dpw_digits.py`` reads it)."""
    _check_cuda_input(x, "sepconv_bwd x")
    _check_cuda_input(g, "sepconv_bwd g")
    b, h, wd, c = x.shape
    f = pw.shape[-1]
    if tuple(g.shape) != (b, h, wd, f) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"sepconv_bwd: g {tuple(g.shape)} {g.dtype}, expected "
                         f"{(b, h, wd, f)} {x.dtype} on {x.device}")
    _check_tensors(x, "sepconv_bwd", [(dw, (3, 3, c), x.dtype), (pw, (c, f), x.dtype)])
    plan = ft.chain_bwd_plan(b, h, wd, c, f, x.dtype, bias=True)
    lib = build.load_library()
    dx = torch.empty_like(x)
    m = torch.empty((b, h, wd, plan.cm), dtype=x.dtype, device=x.device)  # depthwise(x), rounded
    sums = torch.empty((11, c), dtype=torch.float32, device=x.device)  # ddw (9), two zero rows
    dpwb = torch.empty((c + 1, f), dtype=torch.float32, device=x.device)  # dpw, then dbias
    work = torch.empty(lib.unet_sepconv_bwd_workspace(b, h, wd, c, f, plan.splits),
                       dtype=torch.float32, device=x.device)
    status = lib.unet_sepconv_bwd(
        x.data_ptr(), g.data_ptr(), dw.data_ptr(), pw.data_ptr(), dx.data_ptr(), m.data_ptr(),
        work.data_ptr(), sums.data_ptr(), dpwb.data_ptr(), b, h, wd, c, f,
        *ft.plan_args(plan), build.DTYPE_CODE[x.dtype], build.stream_handle(x.device),
    )
    build.check(status, "sepconv_bwd")
    LAUNCHES["sepconv_bwd"] += 1
    return dx, sums[:9].reshape(3, 3, c), dpwb[:c], dpwb[c], m


# --------------------------------------------------------------------------
# Differentiable blocks (the JAX custom VJPs)
# --------------------------------------------------------------------------


class _SepconvPlain(torch.autograd.Function):
    """Plain sepconv plus bias: K8 forward (scale 1, shift = bias, no
    ReLU), K10 backward (JAX ``_sepconv_plain``)."""

    @staticmethod
    def forward(ctx, x, dw, pw, bias):
        ctx.save_for_backward(x, dw, pw, bias)
        ones = torch.ones(pw.shape[-1], dtype=torch.float32, device=x.device)
        return sepconv_block_op(x, dw, pw, ones, bias.float().contiguous(), False)

    @staticmethod
    def backward(ctx, g):
        x, dw, pw, bias = ctx.saved_tensors
        dx, ddw, dpw, dbias = sepconv_bwd(x, g.to(x.dtype).contiguous(), dw, pw)
        return dx, ddw.to(dw.dtype), dpw.to(pw.dtype), dbias.to(bias.dtype)


class _SepconvStats(torch.autograd.Function):
    """K9 forward, K10 backward (JAX ``_sepconv_stats``)."""

    @staticmethod
    def forward(ctx, x, dw, pw):
        y, s, q = sepconv_stats(x, dw, pw)
        ctx.save_for_backward(x, dw, pw, y)
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        x, dw, pw, y = ctx.saved_tensors
        # Σy and Σy² are elementwise functions of y: fold their cotangents in
        g_eff = (gy.float() + gs + y.float() * (2.0 * gq)).to(x.dtype).contiguous()
        dx, ddw, dpw, _ = sepconv_bwd(x, g_eff, dw, pw)
        return dx, ddw.to(dw.dtype), dpw.to(pw.dtype)


def _kernel_form(x: torch.Tensor, depthwise_kernel: torch.Tensor,
                 pointwise_kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Taps (3,3,C) and pointwise (C,F) in x.dtype (a differentiable cast)."""
    c, f = x.shape[-1], pointwise_kernel.shape[-1]
    return (depthwise_kernel.reshape(3, 3, c).to(x.dtype).contiguous(),
            pointwise_kernel.reshape(c, f).to(x.dtype).contiguous())


def sepconv_apply(
    x: torch.Tensor,
    depthwise_kernel: torch.Tensor,         # (3, 3, C, 1)
    pointwise_kernel: torch.Tensor,         # (1, 1, C, F) or (C, F)
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain separable conv (no BN, no ReLU): K8 forward, K10 backward. A
    zero bias stands in when none is given."""
    dw, pw = _kernel_form(x, depthwise_kernel, pointwise_kernel)
    if bias is None:
        bias = torch.zeros(pw.shape[-1], dtype=torch.float32, device=x.device)
    return _SepconvPlain.apply(x.contiguous(), dw, pw, bias)


def sepconv_apply_stats(
    x: torch.Tensor,
    depthwise_kernel: torch.Tensor,         # (3, 3, C, 1)
    pointwise_kernel: torch.Tensor,         # (1, 1, C, F) or (C, F)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain separable conv and the per-channel ``(Σy, Σy²)`` of its
    output, fp32, for the training block's batch moments: K9 forward, K10
    backward. Returns ``(y, sum, sum_sq)``."""
    dw, pw = _kernel_form(x, depthwise_kernel, pointwise_kernel)
    return _SepconvStats.apply(x.contiguous(), dw, pw)


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
    """Fused block: sepconv (+bias) (+folded BN) (+ReLU), K8 forward; its
    gradient is the composed block's (JAX ``_sepconv_core``)."""
    block = {"depthwise_kernel": depthwise_kernel, "pointwise_kernel": pointwise_kernel}
    if bias is not None:
        block["bias"] = bias
    if bn_scale is not None:
        block.update(scale=bn_scale, offset=bn_offset, mean=bn_mean, var=bn_var)
    w = prepare_block(block, x.dtype, eps, x.device)
    return sepconv_block(x.contiguous(), w, relu)


def fused_sepconv_pair(
    x: torch.Tensor,
    block1: Dict[str, torch.Tensor],
    block2: Dict[str, torch.Tensor],
    eps: float = 1e-3,
    pool: bool = False,
    x2: Optional[torch.Tensor] = None,
    in_scale: Optional[Union[float, Tuple[float, float]]] = None,
    out_scale: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = None,
    edge_flags: EdgeFlags = None,
):
    """Inference ConvBlock pair (sepconv+BN+ReLU twice) in one kernel, K7.

    ``block1``/``block2`` are dicts as in :func:`prepare_block`. With
    ``x2`` block 1 reads the channel concat ``[x | x2]`` from both tensors;
    with ``pool`` the result is ``(y, pooled)``; ``edge_flags=(top,
    bottom)`` as in :func:`sepconv_pair`.

    Int8, as the JAX wrapper's ``quant_in`` follows x's dtype and
    ``quant_out`` follows ``out_scale``: an int8 ``x`` (and ``x2``) is worth
    ``q * in_scale`` (a pair ``(s_x, s_x2)`` for two streams) and needs
    ``out_scale``; with ``out_scale`` y (and pooled) are returned as int8 in
    units of ``out_scale``. The compute dtype is ``compute_dtype``, else
    bf16 for an int8 x and x's dtype for a float one; the scales fold into
    the weights (:func:`fold_int8`). The kernel has no int8-in/float-out
    mode.
    """
    quant_in, quant_out = x.dtype == torch.int8, out_scale is not None
    if quant_in != (in_scale is not None) or (quant_in and not quant_out):
        raise ValueError("fused_sepconv_pair: an int8 x takes in_scale and out_scale; a float x "
                         "takes no in_scale")
    dtype = compute_dtype or (torch.bfloat16 if quant_in else x.dtype)
    w1 = prepare_block(block1, dtype, eps, x.device)
    w2 = prepare_block(block2, dtype, eps, x.device)
    kw = dict(pool=pool, edge_flags=edge_flags)
    if not quant_out:
        return sepconv_pair(x.to(dtype), w1, w2, x2=x2.to(dtype) if x2 is not None else None,
                            **kw)
    w1, w2 = fold_int8(w1, w2, in_scale, out_scale, x.shape[-1])
    if quant_in:
        return sepconv_pair_int8(x, w1, w2, x2=x2, **kw)
    return sepconv_pair_quant_out(x.to(dtype), w1, w2,
                                  x2=x2.to(dtype) if x2 is not None else None, **kw)
