"""The segmentation head and its loss/metric sums, composed and fused (K5, K11).

Port of ``unet_image_segmentation_tpu/ops/pallas/fused_head.py``. A
training forward given ``head_targets`` returns, instead of probabilities,
a dict of per-sample fp32 reductions that every dice-family loss, the CCE
loss and the confusion-matrix metrics are computed from
(:func:`..losses.loss_from_sums`, ``train.steps``): the :data:`SUM_KEYS` of
the sigmoid head, or ``i``/``p``/``t`` (B, C), ``cce`` (B,) and ``cm``
(B, C, C) of the softmax head.

* :func:`head_sums_reference` / :func:`head_sums_reference_mc` compute the
  dict from materialized probabilities (the composed head).
* :func:`fused_head_train` runs the last decoder chain's links (K1/K2 of
  :mod:`.fused_train`), then the head fused into the chain's exit. One class:
  :func:`head_fwd_sums` (K5, TPU ``_head_fwd_kernel``) applies the last
  block's BatchNorm affine and ReLU, the 1x1 conv and the sigmoid per pixel
  and keeps only the sums; :func:`head_bwd` (TPU ``_head_bwd_kernel``)
  recomputes that, forms the head's backward and hands the chain its exit
  cotangent ``dzt`` with the BatchNorm reductions S and T. Two to
  :data:`MAX_MC_CLASSES` classes: :func:`head_fwd_sums_mc` and
  :func:`head_bwd_mc` (K11, TPU ``_head_fwd_kernel_mc`` /
  ``_head_bwd_kernel_mc``) do the same for the softmax head, with the
  clipped CCE sum and the argmax confusion matrix. All four are
  hand-written CUDA (``kernels/csrc/head.cu`` and ``head_mc.cu``, on the
  streaming body of ``stream_sums.cuh`` with the launch plan
  :func:`head_plan`) beside plain PyTorch versions; a wrapper runs the
  plain version on a CPU tensor and the kernel on a CUDA tensor, or
  raises. :data:`LAUNCHES` counts kernel launches.

Rounding points are the Pallas kernels' (compute dtype T): z rounds to T,
a logit is ``T(T(Σ z w_T) + T(bias))`` with the dot in fp32, the sigmoid
and softmax are fp32; backward ``dl = T(dlogit)`` feeds ``dzt = Σ dl w_T``
(fp32, masked, written in T) and ``dw = Σ z dl``, while ``db = Σ dlogit``
takes the unrounded one. Sigmoid targets are binarized at > 0.5; softmax
targets are class ids, rounded (an id of C or more counts in no class).
The TPU kernels' lane expansion of the targets and block-diagonal weight
panels have no counterpart here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from unet_image_segmentation_tpu_torch.ops import fused_train as ft
from unet_image_segmentation_tpu_torch.ops.kernels import build

SUM_KEYS = ("i", "p", "t", "it", "pt", "tt", "ir", "pr", "tr")
MC_KEYS = ("i", "p", "t", "cce", "cm")
MAX_MC_CLASSES = 4  # the softmax head kernel K11 takes 2..4 classes
CLIP_EPS = 1e-7

LAUNCHES: Dict[str, int] = {"head_fwd": 0, "head_bwd": 0, "head_fwd_mc": 0, "head_bwd_mc": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def head_supported(f: int, dtype: torch.dtype) -> bool:
    """Whether K5 takes a last decoder width ``f`` in ``dtype``: whole
    16-byte vectors of channels, at most 32 of them a pixel."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return f % vec == 0 and f // vec <= 32


def fused_head_feasible(f: int, dtype: torch.dtype, num_classes: int) -> bool:
    """Whether :func:`fused_head_train` takes this head (the JAX package's
    ``fused_head_feasible``): one class (K5) or 2..:data:`MAX_MC_CLASSES`
    (K11), at a last decoder width the kernels take. Else the caller keeps
    the composed head."""
    return (num_classes == 1 or 2 <= num_classes <= MAX_MC_CLASSES) and head_supported(f, dtype)


def mc_sum_count(nc: int) -> int:
    """Columns of K11's per-sample sums: I, P, T (nc each), CCE, CM (nc*nc)."""
    return 3 * nc + 1 + nc * nc


def mc_sums_dict(sums: torch.Tensor, nc: int) -> Dict[str, torch.Tensor]:
    """K11's (B, 3nc+1+nc^2) sums as the softmax head's dict."""
    return {
        "i": sums[:, :nc], "p": sums[:, nc:2 * nc], "t": sums[:, 2 * nc:3 * nc],
        "cce": sums[:, 3 * nc], "cm": sums[:, 3 * nc + 1:].reshape(-1, nc, nc),
    }


def target_ids(targets: torch.Tensor) -> torch.Tensor:
    """(B,H,W[,1]) class-id masks, or one-hot (B,H,W,C), as the (B,H,W)
    uint8 ids K11 reads (JAX ``expand_target_ids`` without the lanes): ids
    stored as floats are rounded, not floored."""
    if targets.dim() == 4:
        targets = targets.argmax(dim=-1).float() if targets.shape[-1] > 1 else targets[..., 0]
    return torch.round(targets.float()).to(torch.uint8).contiguous()


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
# Plain versions of K11
# --------------------------------------------------------------------------


def _group_dot(z: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``Σ_f z_f w_fc`` (..., NC) in K11's order: the channels of one
    16-byte vector of ``dtype`` in sequence, then the xor butterfly over the
    pixel's group of vectors, each product and sum rounded to fp32 on its
    own, so that the kernel's logits equal these bit for bit."""
    f, nc = w.shape
    v = 16 // torch.empty((), dtype=dtype).element_size()
    g = f // v
    lanes = 1
    while lanes < g:
        lanes *= 2
    prod = (z[..., :, None] * w).reshape(*z.shape[:-1], g, v, nc)
    s = prod[..., 0, :]
    for j in range(1, v):
        s = s + prod[..., j, :]
    if lanes > g:
        s = torch.cat([s, s.new_zeros(*s.shape[:-2], lanes - g, nc)], dim=-2)
    idx = torch.arange(lanes, device=z.device)
    off = lanes // 2
    while off:
        s = s + s[..., idx ^ off, :]
        off //= 2
    return s[..., 0, :]


def _head_mc_probs(y, a, b, w, hb):
    """``(a*y+b, z, p)``: the exit's affine, z rounded to y.dtype (as fp32)
    and the fp32 softmax (..., NC) of the logits ``T(T(z.w) + hb)``, with
    K11's arithmetic in K11's order (``w`` (F,NC), ``hb`` (NC,) in y.dtype's
    values)."""
    wl = y.float() * a + b
    z = wl.clamp_min(0.0).to(y.dtype).float()
    lf = _group_dot(z, w, y.dtype)
    l = (lf.to(y.dtype).float() + hb).to(y.dtype).float()
    e = torch.exp(l - l.amax(dim=-1, keepdim=True))
    s = e[..., 0]
    for c in range(1, e.shape[-1]):
        s = s + e[..., c]
    return wl, z, e / s[..., None]


def _one_hot_ids(ids: torch.Tensor, nc: int) -> torch.Tensor:
    """fp32 one-hot of uint8 class ids; an id >= nc is in no class."""
    return (ids.long()[..., None] == torch.arange(nc, device=ids.device)).float()


def head_fwd_sums_mc_reference(
    y: torch.Tensor, targets: torch.Tensor, aff: torch.Tensor, w: torch.Tensor, hb: torch.Tensor
) -> torch.Tensor:
    """Plain K11 forward: the (B, 3NC+1+NC^2) sums I | P | T | CCE | CM of
    the softmax head on ``relu(a*y+b)``. ``targets`` (B,H,W) uint8 class
    ids; ``aff`` (2,F) fp32; ``w`` (F,NC) and ``hb`` (NC,) fp32 holding
    values rounded to y.dtype. The argmax takes the first maximal class."""
    nc = w.shape[1]
    _, _, p = _head_mc_probs(y, aff[0], aff[1], w, hb)
    t1 = _one_hot_ids(targets, nc)
    cls = torch.arange(nc, device=y.device)
    pred = torch.where(p == p.amax(dim=-1, keepdim=True), cls, nc).amin(dim=-1)
    p1 = torch.nn.functional.one_hot(pred, nc).float()
    b, ax = y.shape[0], (1, 2)
    cm = torch.einsum("bni,bnj->bij", t1.reshape(b, -1, nc), p1.reshape(b, -1, nc))
    cce = (-t1 * torch.log(p.clamp_min(CLIP_EPS))).sum(dim=(1, 2, 3))
    return torch.cat([(p * t1).sum(dim=ax), p.sum(dim=ax), t1.sum(dim=ax), cce[:, None],
                      cm.reshape(b, -1)], dim=1)


def head_bwd_mc_reference(
    y: torch.Tensor, targets: torch.Tensor, aff4: torch.Tensor, w: torch.Tensor,
    hb: torch.Tensor, gsc: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K11 backward: ``(dzt (T), S, T, dw (F,NC), db (NC,))``, the
    sums fp32. ``aff4`` rows a, b, mean, rstd; ``gsc`` (B, 2NC+1) the
    per-sample cotangents of the I and P sums and of the CCE sum. The CCE
    clip at 1e-7 passes no gradient below it."""
    nc = w.shape[1]
    wl, z, p = _head_mc_probs(y, aff4[0], aff4[1], w, hb)
    t1 = _one_hot_ids(targets, nc)
    g = gsc[:, None, None, :]
    q = torch.where(p >= CLIP_EPS, -t1 / p.clamp_min(CLIP_EPS), torch.zeros_like(p))
    dy = (g[..., :nc] * t1 + g[..., nc:2 * nc]) + g[..., 2 * nc:] * q
    ydot = p[..., 0] * dy[..., 0]
    for c in range(1, nc):
        ydot = ydot + p[..., c] * dy[..., c]
    dl = p * (dy - ydot[..., None])
    dlb = dl.to(y.dtype).float()
    v = dlb[..., 0:1] * w[:, 0]
    for c in range(1, nc):
        v = v + dlb[..., c:c + 1] * w[:, c]
    dzt = torch.where(wl > 0, v, torch.zeros_like(v))
    yhat = (y.float() - aff4[2]) * aff4[3]
    ax = (0, 1, 2)
    dw = torch.matmul(z.reshape(-1, z.shape[-1]).t(), dlb.reshape(-1, nc))
    return (dzt.to(y.dtype).contiguous(), dzt.sum(dim=ax), (dzt * yhat).sum(dim=ax), dw,
            dl.sum(dim=ax))


# --------------------------------------------------------------------------
# K5's and K11's launch plan (the streaming body of kernels/csrc/stream_sums.cuh)
# --------------------------------------------------------------------------

# bytes of y a stage of the heads' ring aims at
_HEAD_STAGE_BYTES = 65536


class HeadPlan(NamedTuple):
    """K5's or K11's launch: runs of ``pixels`` consecutive pixels of one
    sample (the last run of a sample may be shorter), ``runs`` of them in
    all; ``ctas`` CTAs of :data:`..kernels.build.STREAM_THREADS` threads,
    one an SM, CTA c taking the runs of :func:`.fused_train.stream_ranges`;
    groups of ``lanes`` threads (the power of two at or above F/V, V
    channels of 16 bytes) take ``lanes`` pixels at a time, a lane one
    16-byte channel chunk of each; a stage of ``stage`` bytes holds a run's
    y and targets; ``smem_fwd`` and ``smem_bwd`` bytes of dynamic shared
    memory a CTA of the forward and the backward (``head_smem`` of
    ``head.cu``, ``head_mc_smem`` of ``head_mc.cu``, which check them); ``ld_fwd`` and
    ``ld_bwd`` floats a CTA's row of partial sums (K5: B*9 and 3F+1; K11:
    B*(3NC+1+NC^2) and (2+NC)F+NC; rounded up to 4)."""

    lanes: int
    pixels: int
    runs: int
    ctas: int
    stage: int
    smem_fwd: int
    smem_bwd: int
    ld_fwd: int
    ld_bwd: int


def head_plan(b: int, hw: int, f: int, dtype: torch.dtype, sms: int, nc: int = 1) -> HeadPlan:
    """The plan of K5 (``nc`` = 1) or K11 (``nc`` classes, 2 to
    :data:`MAX_MC_CLASSES`) for ``b`` samples of ``hw`` pixels of F channels
    in ``dtype`` on a card of ``sms`` streaming multiprocessors: runs of
    about :data:`_HEAD_STAGE_BYTES` of y, a whole number of lane groups, at
    most one pixel a thread. Raises on a width :func:`head_supported`
    refuses."""
    if dtype not in build.DTYPE_CODE or min(b, hw) < 1 or not head_supported(f, dtype) or \
            not (nc == 1 or 2 <= nc <= MAX_MC_CLASSES):
        raise ValueError(f"head_plan: no head launch for B={b} HW={hw} F={f} NC={nc} "
                         f"in {dtype}")
    e = dtype.itemsize
    vec = 16 // e
    lanes = 1
    while lanes < f // vec:
        lanes *= 2
    threads = build.STREAM_THREADS
    pixels = min(threads, max(lanes, _HEAD_STAGE_BYTES // (f * e) // lanes * lanes))
    runs = b * -(-hw // pixels)
    # y [pixels][F], then the targets' 16-byte aligned span around the run
    stage = pixels * f * e + -(-pixels // 16) * 16 + 32
    if nc == 1:
        # the backward's block sums: S, T and dw, 3V floats a thread
        smem_fwd = build.stream_smem(stage, threads * 16)
        smem_bwd = build.stream_smem(stage, threads * 12 * vec)
        sums = 9
    else:
        # the backward's block sums: S, T and dw of 4 channels, (2+NC) 16
        # bytes a thread; then its table of a, b, mean, rstd and w ((4+NC)F
        # floats) and hb (4), and the run's dlb (16 bytes a pixel)
        smem_fwd = build.stream_smem(stage, threads * 16)
        smem_bwd = build.stream_smem(stage, threads * 16 * (2 + nc)) + \
            ((4 + nc) * f + 4) * 4 + threads * 16
        sums = mc_sum_count(nc)
    return HeadPlan(lanes, pixels, runs, min(runs, sms), stage, smem_fwd, smem_bwd,
                    -(-sums * b // 4) * 4, -(-((2 + nc) * f + nc) // 4) * 4)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_inputs(y, targets, aff, w, hb, rows: int, name: str, nc: int = 1) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {y.device}")
    if y.dtype not in build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {y.dtype} not supported (float32, bfloat16)")
    if y.dim() != 4 or not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned NHWC y")
    b, h, w_, f = y.shape
    if not head_supported(f, y.dtype):
        raise ValueError(f"{name}: F={f} in {y.dtype} is not a head kernel width")
    if tuple(targets.shape) != (b, h, w_) or targets.dtype != torch.uint8 or \
            not targets.is_contiguous() or targets.device != y.device or \
            targets.data_ptr() % 16:
        raise ValueError(f"{name}: targets must be contiguous, 16-byte aligned uint8 "
                         f"({b}, {h}, {w_}) on {y.device}")
    w_shape = (f,) if nc == 1 else (f, nc)
    for t, shape, tname in ((aff, (rows, f), "aff"), (w, w_shape, "w"), (hb, (nc,), "hb")):
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
    plan = head_plan(b, h * wd, f, y.dtype, build.sm_count(y.device))
    lib = build.load_library()
    sums = torch.empty((b, len(SUM_KEYS)), dtype=torch.float32, device=y.device)
    work = torch.empty((plan.ctas, plan.ld_fwd), dtype=torch.float32, device=y.device)
    status = lib.unet_head_fwd(
        y.data_ptr(), targets.data_ptr(), aff.data_ptr(), w.data_ptr(), hb.data_ptr(),
        work.data_ptr(), sums.data_ptr(), build.arrival_counter(y.device).data_ptr(), b,
        h * wd, f, plan.pixels, plan.ctas, plan.smem_fwd, build.DTYPE_CODE[y.dtype],
        build.stream_handle(y.device),
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
    if tuple(gsc.shape) != (b, 2) or gsc.dtype != torch.float32 or not gsc.is_contiguous() \
            or gsc.device != y.device:
        raise ValueError(f"head_bwd: gsc must be a contiguous fp32 ({b}, 2)")
    plan = head_plan(b, h * wd, f, y.dtype, build.sm_count(y.device))
    lib = build.load_library()
    dzt = torch.empty_like(y)
    out = torch.empty(3 * f + 1, dtype=torch.float32, device=y.device)
    work = torch.empty((plan.ctas, plan.ld_bwd), dtype=torch.float32, device=y.device)
    status = lib.unet_head_bwd(
        y.data_ptr(), targets.data_ptr(), aff4.data_ptr(), w.data_ptr(), hb.data_ptr(),
        gsc.data_ptr(), dzt.data_ptr(), work.data_ptr(), out.data_ptr(),
        build.arrival_counter(y.device).data_ptr(), b, h * wd, f, plan.pixels, plan.ctas,
        plan.smem_bwd, build.DTYPE_CODE[y.dtype], build.stream_handle(y.device),
    )
    build.check(status, "head_bwd")
    LAUNCHES["head_bwd"] += 1
    return dzt, out[:f], out[f:2 * f], out[2 * f:3 * f], out[3 * f:]


def _check_mc(w: torch.Tensor, name: str) -> int:
    nc = w.shape[-1] if w.dim() == 2 else 0
    if not 2 <= nc <= MAX_MC_CLASSES:
        raise ValueError(f"{name}: w must be (F, NC) with NC in 2..{MAX_MC_CLASSES}, "
                         f"got {tuple(w.shape)}")
    return nc


def head_fwd_sums_mc(
    y: torch.Tensor, targets: torch.Tensor, aff: torch.Tensor, w: torch.Tensor, hb: torch.Tensor
) -> torch.Tensor:
    """K11 forward on a CUDA tensor, its plain version on a CPU tensor:
    (B, 3NC+1+NC^2) sums I | P | T | CCE | CM."""
    if y.device.type == "cpu":
        return head_fwd_sums_mc_reference(y, targets, aff, w, hb)
    nc = _check_mc(w, "head_fwd_sums_mc")
    _check_inputs(y, targets, aff, w, hb, 2, "head_fwd_sums_mc", nc)
    b, h, wd, f = y.shape
    plan = head_plan(b, h * wd, f, y.dtype, build.sm_count(y.device), nc)
    lib = build.load_library()
    sums = torch.empty((b, mc_sum_count(nc)), dtype=torch.float32, device=y.device)
    work = torch.empty((plan.ctas, plan.ld_fwd), dtype=torch.float32, device=y.device)
    status = lib.unet_head_fwd_mc(
        y.data_ptr(), targets.data_ptr(), aff.data_ptr(), w.data_ptr(), hb.data_ptr(),
        work.data_ptr(), sums.data_ptr(), build.arrival_counter(y.device).data_ptr(), b,
        h * wd, f, nc, plan.pixels, plan.ctas, plan.smem_fwd, build.DTYPE_CODE[y.dtype],
        build.stream_handle(y.device),
    )
    build.check(status, "head_fwd_sums_mc")
    LAUNCHES["head_fwd_mc"] += 1
    return sums


def head_bwd_mc(
    y: torch.Tensor, targets: torch.Tensor, aff4: torch.Tensor, w: torch.Tensor,
    hb: torch.Tensor, gsc: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11 backward on a CUDA tensor, its plain version on a CPU tensor:
    ``(dzt, S, T, dw (F,NC), db (NC,))``."""
    if y.device.type == "cpu":
        return head_bwd_mc_reference(y, targets, aff4, w, hb, gsc)
    nc = _check_mc(w, "head_bwd_mc")
    _check_inputs(y, targets, aff4, w, hb, 4, "head_bwd_mc", nc)
    b, h, wd, f = y.shape
    if tuple(gsc.shape) != (b, 2 * nc + 1) or gsc.dtype != torch.float32 or \
            not gsc.is_contiguous() or gsc.device != y.device:
        raise ValueError(f"head_bwd_mc: gsc must be a contiguous fp32 ({b}, {2 * nc + 1})")
    plan = head_plan(b, h * wd, f, y.dtype, build.sm_count(y.device), nc)
    lib = build.load_library()
    dzt = torch.empty_like(y)
    out = torch.empty((2 + nc) * f + nc, dtype=torch.float32, device=y.device)
    work = torch.empty((plan.ctas, plan.ld_bwd), dtype=torch.float32, device=y.device)
    status = lib.unet_head_bwd_mc(
        y.data_ptr(), targets.data_ptr(), aff4.data_ptr(), w.data_ptr(), hb.data_ptr(),
        gsc.data_ptr(), dzt.data_ptr(), work.data_ptr(), out.data_ptr(),
        build.arrival_counter(y.device).data_ptr(), b, h * wd, f, nc, plan.pixels, plan.ctas,
        plan.smem_bwd, build.DTYPE_CODE[y.dtype], build.stream_handle(y.device),
    )
    build.check(status, "head_bwd_mc")
    LAUNCHES["head_bwd_mc"] += 1
    return (dzt, out[:f], out[f:2 * f], out[2 * f:(2 + nc) * f].reshape(f, nc),
            out[(2 + nc) * f:])


# --------------------------------------------------------------------------
# The last decoder chain with the fused head (autograd)
# --------------------------------------------------------------------------


def _head_weights(w_head: torch.Tensor, b_head: torch.Tensor, dt: torch.dtype):
    """The head kernel's ``w`` ((F,) for one class, else (F,NC)) and ``hb``
    (NC,), fp32 holding values rounded to ``dt``."""
    nc = w_head.shape[-1]
    w = w_head.reshape(-1, nc).to(dt).float()
    hb = b_head.reshape(nc).to(dt).float().contiguous()
    return (w.reshape(-1) if nc == 1 else w).contiguous(), hb


class _HeadChain(torch.autograd.Function):
    """``z_in -> [link]*N -> head -> sums`` with the fused backward.

    Outputs the sums ((B, 9) for one class, K5; (B, 3NC+1+NC^2) for NC
    classes, K11), then mean and var per block (no gradient). Targets are
    data: they get no gradient.
    """

    @staticmethod
    def forward(ctx, z_in, targets, w_head, b_head, eps: float, groups: ft.Groups, *flat):
        ys, stats, (a, b), halos = ft._chain_links_fwd(z_in, flat, eps, None, groups)
        w, hb = _head_weights(w_head, b_head, z_in.dtype)
        fwd = head_fwd_sums if w_head.shape[-1] == 1 else head_fwd_sums_mc
        sums = fwd(ys[-1], targets, torch.stack([a, b]).contiguous(), w, hb)
        ctx.save_for_backward(z_in, targets, w_head, b_head, *ys, *flat, *stats, *halos)
        ctx.eps, ctx.n_blocks, ctx.groups = eps, len(flat) // 4, groups
        ctx.mark_non_differentiable(*stats)
        return (sums, *stats)

    @staticmethod
    def backward(ctx, g_sums, *_):
        nb, eps = ctx.n_blocks, ctx.eps
        saved = ctx.saved_tensors
        z_first, targets, w_head, b_head = saved[:4]
        ys = saved[4:4 + nb]
        flat = saved[4 + nb:4 + 5 * nb]
        stats = saved[4 + 5 * nb:4 + 7 * nb]
        halos = saved[4 + 7 * nb:]
        mean, r, a, b = ft._bn_terms(flat[-4:], stats[-2:], eps)
        aff4 = torch.stack([a, b, mean.float(), r.float()]).contiguous()
        w, hb = _head_weights(w_head, b_head, z_first.dtype)
        nc = w_head.shape[-1]
        # only the dice sums I and P (and CCE) carry a cotangent: T is data,
        # the counts are step functions
        g_sums = g_sums.float()
        if nc == 1:
            gsc = g_sums[:, :2].contiguous()
            dzt, S, T, dw, db = head_bwd(ys[-1], targets, aff4, w, hb, gsc)
        else:
            gsc = torch.cat([g_sums[:, :2 * nc], g_sums[:, 3 * nc:3 * nc + 1]], dim=1).contiguous()
            dzt, S, T, dw, db = head_bwd_mc(ys[-1], targets, aff4, w, hb, gsc)
        # S and T over this rank's pixels: the links' backward all-reduces
        # them; dw and db stay this rank's partials, as the links' gradients
        dz_in, grads = ft._chain_links_bwd(z_first, ys, flat, stats, eps, None, dzt, S, T, True,
                                           ctx.groups, halos)
        return (dz_in, None, dw.reshape(w_head.shape).to(w_head.dtype),
                db.reshape(b_head.shape).to(b_head.dtype), None, None, *grads)


def fused_head_train(
    z_in: torch.Tensor,
    blocks: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]],
    w_head: torch.Tensor,
    b_head: Optional[torch.Tensor],
    targets: torch.Tensor,
    eps: float = 1e-3,
    groups: ft.Groups = ft.Groups(),
):
    """The last decoder chain, the head and the loss/metric sums.

    ``blocks`` as for :func:`.fused_train.fused_chain_train`; ``w_head`` the
    head Conv kernel (1,1,F,NC), ``b_head`` its bias (NC,). One class (the
    sigmoid head, K5): ``targets`` (B,H,W[,1]) masks, binarized at > 0.5,
    and ``sums`` maps :data:`SUM_KEYS` to per-sample (B,) reductions. 2 to
    :data:`MAX_MC_CLASSES` classes (the softmax head, K11): ``targets``
    class ids (B,H,W[,1]) or one-hot (B,H,W,NC), and ``sums`` maps
    :data:`MC_KEYS` to ``i``/``p``/``t`` (B,NC), ``cce`` (B,) and ``cm``
    (B,NC,NC). Returns ``(sums, stats)``, ``stats`` the per-block batch
    moments. Raises on a head :func:`fused_head_feasible` refuses: the
    caller composes the head there. ``groups`` as for
    :func:`.fused_train.fused_chain_train`; on row shards the sums are this
    rank's rows' (the train step sums them over the spatial group).
    """
    nc = w_head.shape[-1]
    f = blocks[-1][1].shape[-1]
    if not fused_head_feasible(f, z_in.dtype, nc):
        raise ValueError(f"fused_head_train: no head kernel for {nc} classes at F={f} "
                         f"in {z_in.dtype}")
    if b_head is None:
        b_head = torch.zeros(nc, dtype=torch.float32, device=z_in.device)
    if nc == 1:
        t = targets[..., 0] if targets.dim() == 4 else targets
        t = (t > 0.5).to(torch.uint8).contiguous()
    else:
        t = target_ids(targets)
    flat = ft._prep_blocks(z_in.dtype, z_in.shape[-1], blocks)
    out = _HeadChain.apply(z_in.contiguous(), t, w_head, b_head, eps, groups, *flat)
    sums = dict(zip(SUM_KEYS, out[0].unbind(1))) if nc == 1 else mc_sums_dict(out[0], nc)
    return sums, ft._stat_pairs(out[1:])
