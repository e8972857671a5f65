"""The segmentation head and its loss/metric sums, composed and fused (K5).

Port of ``unet_image_segmentation_tpu/ops/pallas/fused_head.py``. A
training forward given ``head_targets`` returns, instead of probabilities,
a dict of per-sample fp32 reductions keyed by :data:`SUM_KEYS` that every
dice-family loss and the confusion-matrix metrics are computed from
(:func:`..losses.loss_from_sums`, ``train.steps``).

* :func:`head_sums_reference` / :func:`head_sums_reference_mc` compute the
  dict from materialized probabilities (the composed head).
* :func:`fused_head_train` runs the last decoder chain's links (K1/K2 of
  :mod:`.fused_train`), then the sigmoid head fused into the chain's exit:
  :func:`head_fwd_sums` (TPU ``_head_fwd_kernel``) applies the last block's
  BatchNorm affine and ReLU, the 1x1 conv and the sigmoid per pixel and
  keeps only the sums; :func:`head_bwd` (TPU ``_head_bwd_kernel``)
  recomputes that, forms the head's backward and hands the chain its exit
  cotangent ``dzt`` with the BatchNorm reductions S and T. Both are
  hand-written CUDA (``kernels/csrc/head.cu``) beside plain PyTorch versions;
  a wrapper runs the plain version on a CPU tensor and the kernel on a CUDA
  tensor, or raises. :data:`LAUNCHES` counts kernel launches.

Rounding points are the Pallas kernels' (compute dtype T): z rounds to T,
the logit is ``T(T(Σ z w_T) + T(bias))`` with the dot in fp32, the sigmoid
is fp32; backward ``dl = T(dlog)`` feeds ``dzt = dl w_T`` (fp32, masked,
written in T) and ``dw = Σ z dl``, while ``db = Σ dlog`` takes the
unrounded ``dlog``. Targets are binarized at > 0.5. The TPU kernels' lane
expansion of the targets and block-diagonal weight panels have no
counterpart here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from unet_image_segmentation_tpu_torch.ops import fused_train as ft
from unet_image_segmentation_tpu_torch.ops.kernels import build

SUM_KEYS = ("i", "p", "t", "it", "pt", "tt", "ir", "pr", "tr")
CLIP_EPS = 1e-7

LAUNCHES: Dict[str, int] = {"head_fwd": 0, "head_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def head_supported(f: int, dtype: torch.dtype) -> bool:
    """Whether K5 takes a last decoder width ``f`` in ``dtype``: whole
    16-byte vectors of channels, at most 32 of them a pixel."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return f % vec == 0 and f // vec <= 32


# --------------------------------------------------------------------------
# Composed head sums
# --------------------------------------------------------------------------


def head_sums_reference(preds: torch.Tensor, targets: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Sigmoid head: per-sample ``(B,)`` sums keyed by :data:`SUM_KEYS`.

    Targets are binarized at > 0.5. ``i/p/t`` are the soft dice sums,
    ``it/pt/tt`` the counts at > 0.5, and ``ir/pr/tr`` the Keras int-cast
    counts (a probability counts only when it reaches 1.0).
    """
    y = (preds[..., 0] if preds.dim() == 4 else preds).float()
    t = ((targets[..., 0] if targets.dim() == 4 else targets) > 0.5).float()
    return dict(zip(SUM_KEYS, _sums(y, t).unbind(1)))


def head_sums_reference_mc(
    preds: torch.Tensor, targets: torch.Tensor, num_classes: int
) -> Dict[str, torch.Tensor]:
    """Softmax head: per-class ``i/p/t`` (B, C), the clipped CCE sum (B,)
    and the per-sample argmax confusion matrix ``cm`` (B, C, C)."""
    y = preds.float()
    if targets.dim() == 4:
        tid = targets.argmax(dim=-1) if targets.shape[-1] == num_classes > 1 else targets[..., 0]
    else:
        tid = targets
    tid = torch.round(tid.float()).long().clamp(0, num_classes - 1)
    t1 = torch.nn.functional.one_hot(tid, num_classes).float()
    p1 = torch.nn.functional.one_hot(y.argmax(dim=-1), num_classes).float()
    b = y.shape[0]
    ax = (1, 2)
    return {
        "i": (y * t1).sum(dim=ax),
        "p": y.sum(dim=ax),
        "t": t1.sum(dim=ax),
        "cce": (-t1 * torch.log(y.clamp(CLIP_EPS, 1.0))).sum(dim=(1, 2, 3)),
        "cm": torch.einsum(
            "bni,bnj->bij", t1.reshape(b, -1, num_classes), p1.reshape(b, -1, num_classes)
        ),
    }


def _sums(y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, 9) fp32 sums in :data:`SUM_KEYS` order of probabilities ``y`` and
    0/1 targets ``t``, both (B, H, W)."""
    pred = (y > 0.5).float()
    tth = (t > 0.5).float()
    yr = (y >= 1.0).float()
    tr = torch.floor(t).clamp(0.0, 1.0)
    ax = (1, 2)
    return torch.stack([
        (y * t).sum(dim=ax), y.sum(dim=ax), t.sum(dim=ax),
        (pred * tth).sum(dim=ax), pred.sum(dim=ax), tth.sum(dim=ax),
        (yr * tr).sum(dim=ax), yr.sum(dim=ax), tr.sum(dim=ax),
    ], dim=1)


# --------------------------------------------------------------------------
# Plain versions of K5
# --------------------------------------------------------------------------


def _head_logits(y, a, b, w, hb):
    """``(a*y+b, z, l)``: the exit's affine, z rounded to y.dtype, and the
    fp32 logit with the kernel's rounding points (``w``, ``hb`` already in
    y.dtype's values)."""
    wl = y.float() * a + b
    z = wl.clamp_min(0.0).to(y.dtype)
    lf = torch.matmul(z.float(), w)
    return wl, z, (lf.to(y.dtype).float() + hb).to(y.dtype).float()


def head_fwd_sums_reference(
    y: torch.Tensor, targets: torch.Tensor, aff: torch.Tensor, w: torch.Tensor, hb: torch.Tensor
) -> torch.Tensor:
    """Plain K5 forward: the (B, 9) sums of the head on ``relu(a*y+b)``.
    ``targets`` (B,H,W) uint8 0/1; ``aff`` (2,F) fp32; ``w`` (F,) and
    ``hb`` (1,) fp32 holding values rounded to y.dtype."""
    _, _, l = _head_logits(y, aff[0], aff[1], w, hb)
    return _sums(1.0 / (1.0 + torch.exp(-l)), targets.float())


def head_bwd_reference(
    y: torch.Tensor, targets: torch.Tensor, aff4: torch.Tensor, w: torch.Tensor,
    hb: torch.Tensor, gsc: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K5 backward: ``(dzt (T), S, T, dw (F,), db (1,))``, the sums
    fp32. ``aff4`` rows a, b, mean, rstd; ``gsc`` (B, 2) the per-sample
    cotangents of the ``i`` and ``p`` sums."""
    wl, z, l = _head_logits(y, aff4[0], aff4[1], w, hb)
    p = 1.0 / (1.0 + torch.exp(-l))
    dy = gsc[:, 0, None, None] * targets.float() + gsc[:, 1, None, None]
    dlog = dy * p * (1.0 - p)
    dl = dlog.to(y.dtype).float()
    dzt = torch.where(wl > 0, dl[..., None] * w, torch.zeros_like(wl))
    yhat = (y.float() - aff4[2]) * aff4[3]
    ax = (0, 1, 2)
    return (dzt.to(y.dtype).contiguous(), dzt.sum(dim=ax), (dzt * yhat).sum(dim=ax),
            (z.float() * dl[..., None]).sum(dim=ax), dlog.sum().reshape(1))


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_inputs(y, targets, aff, w, hb, rows: int, name: str) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {y.device}")
    if y.dtype not in build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {y.dtype} not supported (float32, bfloat16)")
    if y.dim() != 4 or not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned NHWC y")
    b, h, w_, f = y.shape
    if not head_supported(f, y.dtype):
        raise ValueError(f"{name}: F={f} in {y.dtype} is not a K5 width")
    if tuple(targets.shape) != (b, h, w_) or targets.dtype != torch.uint8 or \
            not targets.is_contiguous() or targets.device != y.device:
        raise ValueError(f"{name}: targets must be contiguous uint8 ({b}, {h}, {w_}) on {y.device}")
    for t, shape, tname in ((aff, (rows, f), "aff"), (w, (f,), "w"), (hb, (1,), "hb")):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != y.device or \
                not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be a contiguous fp32 {shape} on {y.device}")


def head_fwd_sums(
    y: torch.Tensor, targets: torch.Tensor, aff: torch.Tensor, w: torch.Tensor, hb: torch.Tensor
) -> torch.Tensor:
    """K5 forward on a CUDA tensor, its plain version on a CPU tensor: (B, 9)."""
    if y.device.type == "cpu":
        return head_fwd_sums_reference(y, targets, aff, w, hb)
    _check_inputs(y, targets, aff, w, hb, 2, "head_fwd_sums")
    b, h, wd, f = y.shape
    code = build.DTYPE_CODE[y.dtype]
    lib = build.load_library()
    sums = torch.empty((b, len(SUM_KEYS)), dtype=torch.float32, device=y.device)
    work = torch.empty(lib.unet_head_workspace(b, h * wd, f, code, 0),
                       dtype=torch.float32, device=y.device)
    status = lib.unet_head_fwd(
        y.data_ptr(), targets.data_ptr(), aff.data_ptr(), w.data_ptr(), hb.data_ptr(),
        work.data_ptr(), sums.data_ptr(), b, h * wd, f, code, build.stream_handle(y.device),
    )
    build.check(status, "head_fwd_sums")
    LAUNCHES["head_fwd"] += 1
    return sums


def head_bwd(
    y: torch.Tensor, targets: torch.Tensor, aff4: torch.Tensor, w: torch.Tensor,
    hb: torch.Tensor, gsc: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 backward on a CUDA tensor, its plain version on a CPU tensor:
    ``(dzt, S, T, dw, db)``."""
    if y.device.type == "cpu":
        return head_bwd_reference(y, targets, aff4, w, hb, gsc)
    _check_inputs(y, targets, aff4, w, hb, 4, "head_bwd")
    b, h, wd, f = y.shape
    if tuple(gsc.shape) != (b, 2) or gsc.dtype != torch.float32 or not gsc.is_contiguous():
        raise ValueError(f"head_bwd: gsc must be a contiguous fp32 ({b}, 2)")
    code = build.DTYPE_CODE[y.dtype]
    lib = build.load_library()
    dzt = torch.empty_like(y)
    out = torch.empty(3 * f + 1, dtype=torch.float32, device=y.device)
    work = torch.empty(lib.unet_head_workspace(b, h * wd, f, code, 1),
                       dtype=torch.float32, device=y.device)
    status = lib.unet_head_bwd(
        y.data_ptr(), targets.data_ptr(), aff4.data_ptr(), w.data_ptr(), hb.data_ptr(),
        gsc.data_ptr(), dzt.data_ptr(), work.data_ptr(), out.data_ptr(), b, h * wd, f, code,
        build.stream_handle(y.device),
    )
    build.check(status, "head_bwd")
    LAUNCHES["head_bwd"] += 1
    return dzt, out[:f], out[f:2 * f], out[2 * f:3 * f], out[3 * f:]


# --------------------------------------------------------------------------
# The last decoder chain with the fused head (autograd)
# --------------------------------------------------------------------------


class _HeadChain(torch.autograd.Function):
    """``z_in -> [link]*N -> head -> sums`` with the fused backward.

    Outputs the (B, 9) sums, then mean and var per block (no gradient).
    Targets are data: they get no gradient.
    """

    @staticmethod
    def forward(ctx, z_in, targets, w_head, b_head, eps: float, *flat):
        ys, stats, (a, b) = ft._chain_links_fwd(z_in, flat, eps, None)
        dt = z_in.dtype
        w = w_head.reshape(-1).to(dt).float().contiguous()
        hb = b_head.reshape(1).to(dt).float().contiguous()
        sums = head_fwd_sums(ys[-1], targets, torch.stack([a, b]).contiguous(), w, hb)
        ctx.save_for_backward(z_in, targets, w_head, b_head, *ys, *flat, *stats)
        ctx.eps, ctx.n_blocks = eps, len(flat) // 4
        ctx.mark_non_differentiable(*stats)
        return (sums, *stats)

    @staticmethod
    def backward(ctx, g_sums, *_):
        nb, eps = ctx.n_blocks, ctx.eps
        saved = ctx.saved_tensors
        z_first, targets, w_head, b_head = saved[:4]
        ys = saved[4:4 + nb]
        flat = saved[4 + nb:4 + 5 * nb]
        stats = saved[4 + 5 * nb:]
        dt = z_first.dtype
        mean, r, a, b = ft._bn_terms(flat[-4:], stats[-2:], eps)
        aff4 = torch.stack([a, b, mean.float(), r.float()]).contiguous()
        w = w_head.reshape(-1).to(dt).float().contiguous()
        hb = b_head.reshape(1).to(dt).float().contiguous()
        # only i and p carry a cotangent: t is data, the counts are step functions
        gsc = g_sums[:, :2].float().contiguous()
        dzt, S, T, dw, db = head_bwd(ys[-1], targets, aff4, w, hb, gsc)
        dz_in, grads = ft._chain_links_bwd(z_first, ys, flat, stats, eps, None, dzt, S, T, True)
        return (dz_in, None, dw.reshape(w_head.shape).to(w_head.dtype),
                db.reshape(b_head.shape).to(b_head.dtype), None, *grads)


def fused_head_train(
    z_in: torch.Tensor,
    blocks: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]],
    w_head: torch.Tensor,
    b_head: Optional[torch.Tensor],
    targets: torch.Tensor,
    eps: float = 1e-3,
):
    """The last decoder chain, the sigmoid head and the loss/metric sums.

    ``blocks`` as for :func:`.fused_train.fused_chain_train`; ``w_head`` the
    head Conv kernel (1,1,F,1), ``b_head`` its bias (1,); ``targets``
    (B,H,W[,1]) masks, binarized at > 0.5. Returns ``(sums, stats)``:
    ``sums`` maps :data:`SUM_KEYS` to per-sample (B,) fp32 reductions,
    ``stats`` the per-block batch moments.
    """
    if b_head is None:
        b_head = torch.zeros(1, dtype=torch.float32, device=z_in.device)
    t = targets[..., 0] if targets.dim() == 4 else targets
    t = (t > 0.5).to(torch.uint8).contiguous()
    flat = ft._prep_blocks(z_in.dtype, z_in.shape[-1], blocks)
    out = _HeadChain.apply(z_in.contiguous(), t, w_head, b_head, eps, *flat)
    return dict(zip(SUM_KEYS, out[0].unbind(1))), ft._stat_pairs(out[1:])
