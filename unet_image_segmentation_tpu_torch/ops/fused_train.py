"""The training chains: [sepconv -> BatchNorm(batch stats) -> ReLU] x N.

Port of ``unet_image_segmentation_tpu/ops/pallas/fused_train.py`` without
its TPU layout machinery (lane packing, narrow-input padding). Four
hand-written CUDA kernels carry a chain, each beside its plain PyTorch
version (``*_reference``):

* :func:`chain_fwd` (K1, ``kernels/csrc/chain_fwd.cu`` on the forward body
  of ``sepconv_fwd.cuh``, shared with K8; launch plan :func:`fwd_plan`,
  work :func:`fwd_work`): one forward link, optional hash dropout or the
  previous link's BN affine + ReLU on the input, the sepconv, and the
  link's Σy and Σy² (TPU kernel ``_fwd_train_kernel``); in its halo mode
  a row shard's padding rows are its neighbours' z rows;
* :func:`chain_bwd` (K2, ``kernels/csrc/chain_bwd.cu``): one backward link,
  the link's BN backward folded into per-channel constants, the sepconv
  backward, and the previous link's BN reductions S and T
  (``_bwd_train_kernel``);
* :func:`tail_pool` (K3, ``kernels/csrc/tail_pool.cu``): the encoder
  boundary, skip ``z = relu(a*y+b)`` and its 2x2 max pool
  (``_tail_pool_kernel*``);
* :func:`tail_pool_bwd` (K4, same file, on the streaming body of
  ``stream_sums.cuh``; launch plan :func:`pool_bwd_plan`): its backward,
  first-max pool routing, ReLU mask, S and T (``_tail_pool_bwd_kernel*``).

:func:`fused_chain_train` and :func:`fused_chain_train_pool` run a chain
through one ``torch.autograd.Function`` (the counterpart of the JAX
``_chain_core`` custom VJP). The forward saves only the chain input and the
raw link outputs ``ys``; normalized activations and ReLU masks are
recomputed in the backward. Each wrapper runs its plain version on a CPU
tensor and its kernel on a CUDA tensor (or raises), so the CPU tests drive
the same orchestration the card runs. :data:`LAUNCHES` counts wrapper
calls that launched a kernel, and only those. On a mesh (:class:`Groups`)
the BatchNorm sums are all-reduced over the mesh and, on row shards, each
link exchanges its edge rows (K1's halo mode) and its backward adds the
halo rows' terms outside K2 (:func:`_halo_bwd`), as the JAX chain does.

Rounding points follow the Pallas kernels (bf16 compute dtype T):
K1 rounds the dropped input and the transformed input ``relu(a*x+b)`` to
T, the depthwise sum to T before the pointwise, and y to T before its
Σy/Σy²; K2 rounds ``gy`` to T and the recomputed depthwise ``m`` to T
before ``dpw``, keeps the recomputed input z and ``dm`` in fp32, and
writes ``dx`` in T; K3 rounds z to T and pools the rounded values; K4
takes the pooled cotangent in T and writes dzt in T. Every sum is fp32.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from unet_image_segmentation_tpu_torch.ops import hash_dropout as hd
from unet_image_segmentation_tpu_torch.ops.kernels import build
from unet_image_segmentation_tpu_torch.parallel.halo import edge_halo_exchange
from unet_image_segmentation_tpu_torch.parallel.reduce import all_sum

# K1 launches in the halo mode count under chain_fwd_halo too
LAUNCHES: Dict[str, int] = {"chain_fwd": 0, "chain_fwd_halo": 0, "chain_bwd": 0, "tail_pool": 0,
                            "tail_pool_bwd": 0}

_MAX_BATCH = 65535  # gridDim.z of K2 and K9; K1 and K8 hold to it too

# K8's and K1's launch plan (kernels/csrc/sepconv_fwd.cuh): chunks of
# build.CHUNK input channels; a cluster of up to 8 CTAs, each owning a slice
# of at most 128 channels of F
_FWD_SLICE, _FWD_MAX_CLUSTER = 128, 8
# tiles a cluster takes in turn: at most 8, and no fewer CTAs than 8 waves
# of two an SM of the card, so the last wave's part stays small
_FWD_CTAS_PER_SM, _FWD_MAX_PER = 16, 8

# K2's launch plan (kernels/csrc/chain_bwd.cu): per dtype the GEMM depth
# staged at once (F channels in pass (a), pixels in pass (b)), the mma's
# depth and the elements of 16 bytes; the ring and GEMM rows of an 8x8 tile
# and the cp.async stages; the shared memory a CTA may use (227 KB, K7's too);
# pass (b)'s split-K aims at this many CTAs (two a SM of a 132-SM card) with
# at least this many pixels a split
_BWD_CHUNK = {torch.bfloat16: (32, 16, 8), torch.float32: (16, 8, 4)}
_RING_PX, _GEMM_ROWS, _TILE, _STAGES = 100, 112, 8, 4
SMEM_MAX = 232448
_BWD_TARGET_CTAS = 264
_BWD_MIN_SPLIT = 512


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Dropout(NamedTuple):
    """Hash dropout of a chain's input: per-site int32 seed and rate."""

    seed: int
    rate: float

    @property
    def thresh(self) -> int:
        return hd.keep_threshold(self.rate)

    @property
    def scale(self) -> float:
        return hd.inv_keep(self.rate)


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# --------------------------------------------------------------------------


def _depthwise(z: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """fp32 3x3 'same' depthwise of NHWC ``z`` with taps (3,3,C)."""
    c = z.shape[-1]
    taps = dw.float().permute(2, 0, 1).unsqueeze(1)  # (C, 1, 3, 3)
    out = F.conv2d(z.float().permute(0, 3, 1, 2), taps, padding=1, groups=c)
    return out.permute(0, 2, 3, 1)


def _relu_affine(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (x.float() * a + b).clamp_min(0.0)


def chain_fwd_reference(
    x: torch.Tensor,
    dw: torch.Tensor,
    pw: torch.Tensor,
    in_aff: Optional[torch.Tensor] = None,
    drop: Optional[Dropout] = None,
    halo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K1: ``(y, Σy, Σy²)``.

    z = dropout(x) (rounded to x.dtype) or relu(a*x+b) (rounded) or x;
    'same' zero padding applies to z; the depthwise sum is rounded to
    x.dtype, the pointwise accumulates in fp32, y is rounded, and the sums
    are taken over the rounded y in fp32. The halo mode: ``halo`` (B,2,W,C)
    z rows above and below a row shard join z as its rows -1 and H (the
    JAX package's halo-augmented slab: the affine before the concatenation,
    the 'same' sepconv of the taller slab, its two extra rows sliced off).
    """
    z = x
    if drop is not None:
        z = hd.apply_keep(x, hd.keep_mask(x.shape, drop.seed, drop.thresh, x.device), drop.scale)
    if in_aff is not None:
        z = _relu_affine(x, in_aff[0], in_aff[1]).to(x.dtype)
    if halo is not None:
        h = halo.to(x.dtype)
        z = torch.cat([h[:, :1], z, h[:, 1:]], dim=1)
    d = _depthwise(z, dw).to(x.dtype)
    if halo is not None:
        d = d[:, 1:-1]
    y = torch.matmul(d.float(), pw.float()).to(x.dtype).contiguous()
    yf = y.float()
    return y, yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))


def chain_bwd_reference(
    x: torch.Tensor,
    g: torch.Tensor,
    y: torch.Tensor,
    in_aff: Optional[torch.Tensor],
    comb: torch.Tensor,
    dw: torch.Tensor,
    pw: torch.Tensor,
    mask_combine: bool,
    drop: Optional[Dropout] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain K2: ``(dx, ddw (3,3,C), dpw (C,F), st (2,C) or None)``.

    ``comb`` rows: A, B, C, mean_out, a_out, b_out. ``in_aff`` rows
    (links after the first): in_a, in_b, in_mean, in_rstd.
    gy = A*(g [* (a_out*y+b_out > 0)]) + B + (y-mean_out)*C, rounded;
    z is recomputed in fp32; dm = gy.pw^T in fp32; dz is the correlation
    of dm with the flipped taps; m = depthwise(z) rounded; dpw = m^T.gy.
    """
    dt = x.dtype
    yf, gf = y.float(), g.float()
    if mask_combine:
        gf = torch.where(yf * comb[4] + comb[5] > 0, gf, torch.zeros_like(gf))
    gy = (gf * comb[0] + comb[1] + (yf - comb[3]) * comb[2]).to(dt)
    keep = None
    if in_aff is not None:
        z = _relu_affine(x, in_aff[0], in_aff[1])
    elif drop is not None:
        keep = hd.keep_mask(x.shape, drop.seed, drop.thresh, x.device)
        z = torch.where(keep, x.float() * drop.scale, torch.zeros_like(x, dtype=torch.float32))
    else:
        z = x.float()
    dm = torch.matmul(gy.float(), pw.float().t())
    c = x.shape[-1]
    flipped = dw.float().flip(0, 1).permute(2, 0, 1).unsqueeze(1)
    dz = F.conv2d(dm.permute(0, 3, 1, 2), flipped, padding=1, groups=c).permute(0, 2, 3, 1)
    st = None
    if in_aff is not None:
        xf = x.float()
        dzt = torch.where(xf * in_aff[0] + in_aff[1] > 0, dz, torch.zeros_like(dz))
        xhat = (xf - in_aff[2]) * in_aff[3]
        st = torch.stack([dzt.sum(dim=(0, 1, 2)), (dzt * xhat).sum(dim=(0, 1, 2))])
        dx = dzt.to(dt)
    elif keep is not None:
        dx = torch.where(keep, dz * drop.scale, torch.zeros_like(dz)).to(dt)
    else:
        dx = dz.to(dt)
    h, w = x.shape[1], x.shape[2]
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    ddw = torch.stack([
        torch.stack([(zp[:, i:i + h, j:j + w] * dm).sum(dim=(0, 1, 2)) for j in range(3)])
        for i in range(3)
    ])
    m = _depthwise(z, dw).to(dt)
    dpw = torch.matmul(m.reshape(-1, c).float().t(), gy.reshape(-1, gy.shape[-1]).float())
    return dx.contiguous(), ddw, dpw, st


def tail_pool_reference(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K3: skip ``z = relu(a*y+b)`` rounded, and the 2x2 max of it."""
    z = _relu_affine(y, a, b).to(y.dtype)
    bsz, h, w, f = z.shape
    pooled = z.reshape(bsz, h // 2, 2, w // 2, 2, f).amax(dim=(2, 4))
    return z.contiguous(), pooled.contiguous()


def _first_max_masks(zc: torch.Tensor):
    """Window cells (00, 01, 10, 11) of (B,H/2,2,W/2,2,F) and, per cell,
    whether it is the first maximum in row-major order."""
    a00, a01 = zc[:, :, 0, :, 0], zc[:, :, 0, :, 1]
    a10, a11 = zc[:, :, 1, :, 0], zc[:, :, 1, :, 1]
    m00 = (a00 >= a01) & (a00 >= a10) & (a00 >= a11)
    m01 = (a01 > a00) & (a01 >= a10) & (a01 >= a11)
    m10 = (a10 > a00) & (a10 > a01) & (a10 >= a11)
    m11 = (a11 > a00) & (a11 > a01) & (a11 > a10)
    return m00, m01, m10, m11


def tail_pool_bwd_reference(
    y: torch.Tensor, gs: torch.Tensor, gp: torch.Tensor, aff4: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4: ``(dzt, st (2,F))``. ``aff4`` rows: a, b, mean, rstd.

    The pooled cotangent (in y.dtype) goes to the first maximum of each
    window, compared on the rounded z; the skip cotangent is added; the ReLU
    mask is ``a*y+b > 0``; S = Σdzt and T = Σdzt*(y-mean)*rstd from the fp32
    dzt, which is returned rounded to y.dtype.
    """
    bsz, h, w, f = y.shape
    yf = y.float()
    wlin = yf * aff4[0] + aff4[1]
    zc = wlin.clamp_min(0.0).to(y.dtype).float().reshape(bsz, h // 2, 2, w // 2, 2, f)
    gpf = gp.float()
    zero = torch.zeros_like(gpf)
    m00, m01, m10, m11 = _first_max_masks(zc)
    top = torch.stack([torch.where(m00, gpf, zero), torch.where(m01, gpf, zero)], dim=3)
    bot = torch.stack([torch.where(m10, gpf, zero), torch.where(m11, gpf, zero)], dim=3)
    g_pool = torch.stack([top, bot], dim=2).reshape(bsz, h, w, f)
    gz = gs.float() + g_pool
    dzt = torch.where(wlin > 0, gz, torch.zeros_like(gz))
    yhat = (yf - aff4[2]) * aff4[3]
    st = torch.stack([dzt.sum(dim=(0, 1, 2)), (dzt * yhat).sum(dim=(0, 1, 2))])
    return dzt.to(y.dtype).contiguous(), st


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# --------------------------------------------------------------------------
# K8's and K1's launch plan and work
# --------------------------------------------------------------------------


class FwdPlan(NamedTuple):
    """The launch of K8 and K1 (the forward body of ``sepconv_fwd.cuh``):
    ``n`` CTAs a cluster (1, 2, 4 or 8), CTA r owning F channels ``[r*s,
    (r+1)*s)`` (cut at F), padded to ``width`` (64 or 128) in its GEMM
    tile; ``tiles_y * tiles_x`` 8x8 output tiles an image; a cluster takes
    ``per`` consecutive tiles of the batch's ``B * tiles`` in turn, the next
    tile's first chunk in flight under the last one's epilogue; the grid
    ``(n * ceil(B * tiles / per),)``; ``smem`` bytes of dynamic shared
    memory a CTA. The depthwise of each input chunk is split over the
    cluster's CTAs and shared through distributed shared memory, so it runs
    once per tile at every F."""

    n: int
    s: int
    width: int
    per: int
    tiles_y: int
    tiles_x: int
    grid: Tuple[int]
    smem: int


def _fwd_slicing(b: int, h: int, w: int, c: int, f: int,
                 dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(n, s, width)`` of :class:`FwdPlan` for these dimensions: the fewest
    CTAs a cluster whose 128-wide slices hold F, the slice rounded up to 16
    channels, the GEMM width that holds it. Raises on what the kernels
    cannot launch."""
    if min(b, h, w, c, f) < 1:
        raise ValueError(f"sepconv forward: empty shape B={b} H={h} W={w} C={c} F={f}")
    if b > _MAX_BATCH:
        raise ValueError(f"sepconv forward: batch {b} outside 1..{_MAX_BATCH}")
    if dtype not in build.CHUNK:
        raise TypeError(f"sepconv forward: dtype {dtype} not supported (float32, bfloat16)")
    if f > _FWD_SLICE * _FWD_MAX_CLUSTER:
        raise ValueError(f"sepconv forward: F={f}; at most {_FWD_SLICE * _FWD_MAX_CLUSTER} "
                         f"channels ({_FWD_MAX_CLUSTER} CTAs of {_FWD_SLICE})")
    n = 1
    while n * _FWD_SLICE < f:
        n *= 2
    s = -(-_cdiv(f, n) // 16) * 16
    return n, s, 64 if s <= 64 else 128


def fwd_plan(b: int, h: int, w: int, c: int, f: int, dtype: torch.dtype, sms: int) -> FwdPlan:
    """K8's and K1's launch plan for ``b`` (H, W) images, C input and F
    output channels in ``dtype`` on a card of ``sms`` streaming
    multiprocessors (:func:`..kernels.build.sm_count`). The shared-memory
    layout is ``FwdSmem`` of ``sepconv_fwd.cuh``, which checks the byte
    count. ``per`` keeps at least :data:`_FWD_CTAS_PER_SM` CTAs an SM (8
    waves of two) where the tiles allow it, at most :data:`_FWD_MAX_PER`
    tiles a cluster."""
    n, s, width = _fwd_slicing(b, h, w, c, f, dtype)
    kc, _ = build.CHUNK[dtype]
    e = dtype.itemsize
    ldk, ldn = kc + 16 // e, width + 8
    # in T: x halo tiles (2 x 100 px x kc) and taps (2 x 9 x kc), the A
    # buffers (2 x 64 x ldk; fp32 twice, TF32 hi and lo) and pw chunks (2 x
    # kc x ldn); then fp32 column sums (4 x width)
    smem = e * (2 * _RING_PX * kc + 2 * 9 * kc + 2 * (2 if e == 4 else 1) * 64 * ldk +
                2 * kc * ldn) + 4 * 4 * width
    if smem > SMEM_MAX:
        raise ValueError(f"sepconv forward: {smem} bytes of shared memory, at most {SMEM_MAX}")
    ty, tx = _cdiv(h, _TILE), _cdiv(w, _TILE)
    tiles = b * ty * tx
    per = max(1, min(_FWD_MAX_PER, tiles * n // (_FWD_CTAS_PER_SM * sms)))
    if n * _cdiv(tiles, per) >= 2 ** 31:
        raise ValueError(f"sepconv forward: {tiles} tiles, too many for one grid")
    return FwdPlan(n, s, width, per, ty, tx, (n * _cdiv(tiles, per),), smem)


class FwdWork(NamedTuple):
    """Multiply-adds of one K8 or K1 call: the depthwise on the CUDA cores
    and the pointwise products on the tensor cores, each executed (what
    :func:`fwd_plan`'s launch issues; a product counted once, though fp32
    issues three TF32 products for each) and useful (``B*H*W*9C`` and
    ``B*H*W*C*F``)."""

    dw_executed: int
    dw_useful: int
    mma_executed: int
    mma_useful: int

    @property
    def executed(self) -> int:
        return self.dw_executed + self.mma_executed

    @property
    def useful(self) -> int:
        return self.dw_useful + self.mma_useful


def fwd_work(b: int, h: int, w: int, c: int, f: int, dtype: torch.dtype) -> FwdWork:
    """:class:`FwdWork` of one K8 or K1 call. Per 8x8 tile (all 64 pixels,
    at the ragged edge too) and chunk of C, padded to the mma depth: the
    depthwise once for the tile (the cluster's CTAs split the chunk), the
    products over the 64 rows and the columns of every CTA's active warps
    (a quarter of the width each; the warps wholly past the slice skip)."""
    n, s, width = _fwd_slicing(b, h, w, c, f, dtype)
    kc, ks = build.CHUNK[dtype]
    cpad = sum(min(kc, _cdiv(c - c0, ks) * ks) for c0 in range(0, c, kc))
    quarter = width // 4
    cols = sum(quarter * min(4, _cdiv(hi - lo, quarter))
               for lo, hi in ((min(r * s, f), min((r + 1) * s, f)) for r in range(n)))
    tiles = b * _cdiv(h, _TILE) * _cdiv(w, _TILE)
    p = b * h * w
    return FwdWork(tiles * 64 * 9 * cpad, p * 9 * c, tiles * 64 * cols * cpad, p * c * f)


# --------------------------------------------------------------------------
# K2's launch plan and work
# --------------------------------------------------------------------------


class BwdPlan(NamedTuple):
    """K2's (and K10's) launch. Pass (a): a CTA per 8x8 output tile, ``wc``
    channels of C (64 or 128) and sample, on the grid ``grid_a``
    (tiles, C slices, batch), ``smem_a`` bytes of dynamic shared memory.
    Pass (b): ``tm`` x ``tn`` tiles of dpw (64 or 128 each), split-K over
    ``splits`` runs of ``per`` pixels, on ``grid_b`` (F tiles, C tiles,
    splits), ``smem_b`` bytes. No cluster. ``cols_b`` floats a split's
    partial (C*F, plus F for K10's dbias row); ``cm`` the channels of the
    recomputed depthwise m that pass (a) hands pass (b): C rounded up to 16
    bytes, so pass (b) stages it with cp.async at any C."""

    wc: int
    tiles_y: int
    tiles_x: int
    grid_a: Tuple[int, int, int]
    smem_a: int
    tm: int
    tn: int
    splits: int
    per: int
    grid_b: Tuple[int, int, int]
    smem_b: int
    cols_b: int
    cm: int


def chain_bwd_plan(b: int, h: int, w: int, c: int, f: int, dtype: torch.dtype,
                   bias: bool = False) -> BwdPlan:
    """K2's launch plan for ``b`` (H, W) images, C input and F output
    channels in ``dtype``; ``bias`` for K10 (its dbias row). The layouts
    are ``TileSmem`` and ``DpwSmem`` of ``chain_bwd.cu``, which checks the
    byte counts."""
    if min(b, h, w, c, f) < 1:
        raise ValueError(f"chain_bwd: empty shape B={b} H={h} W={w} C={c} F={f}")
    if b > _MAX_BATCH:
        raise ValueError(f"chain_bwd: batch {b} outside 1..{_MAX_BATCH}")
    if dtype not in _BWD_CHUNK:
        raise TypeError(f"chain_bwd: dtype {dtype} not supported (float32, bfloat16)")
    p = b * h * w
    if p >= 2 ** 31:
        raise ValueError(f"chain_bwd: {p} pixels, at most 2^31 - 1")
    kc, _, v = _BWD_CHUNK[dtype]
    e = dtype.itemsize
    wc = 64 if c <= 64 else 128
    # pass (a): stages of g (then gy) [112][kc + v], y [100][kc + v] and pw
    # [wc][kc + v] in T and comb [6][kc] in fp32, then in their place dm
    # [100][wc + 8] in fp32 and x [100][wc + 8] in T
    stage = e * (_GEMM_ROWS + _RING_PX + wc) * (kc + v) + 4 * 6 * kc
    smem_a = max(_STAGES * stage, (4 + e) * _RING_PX * (wc + 8))
    tm, tn = (64 if c <= 64 else 128), (64 if f <= 64 else 128)
    smem_b = e * _STAGES * kc * (tm + 8 + tn + 8)   # stages of m [kc][tm + 8], gy [kc][tn + 8]
    for smem in (smem_a, smem_b):
        if smem > SMEM_MAX:
            raise ValueError(f"chain_bwd: {smem} bytes of shared memory, at most {SMEM_MAX}")
    out_tiles = _cdiv(c, tm) * _cdiv(f, tn)
    splits = max(1, min(_cdiv(_BWD_TARGET_CTAS, out_tiles), _cdiv(p, _BWD_MIN_SPLIT)))
    per = _cdiv(_cdiv(p, splits), kc) * kc
    splits = _cdiv(p, per)
    ty, tx = _cdiv(h, _TILE), _cdiv(w, _TILE)
    return BwdPlan(wc, ty, tx, (ty * tx, _cdiv(c, wc), b), smem_a, tm, tn, splits, per,
                   (_cdiv(f, tn), _cdiv(c, tm), splits), smem_b, c * f + (f if bias else 0),
                   _cdiv(c, v) * v)


class BwdWork(NamedTuple):
    """Multiply-adds of one K2 call: what :func:`chain_bwd_plan`'s launch
    executes on the tensor cores in each pass (each product counted once;
    fp32 issues three TF32 products for each) and on the CUDA cores (dz,
    ddw and m over the tile pixels), and the useful ones,
    ``B*H*W*(2*C*F + 27*C)``."""

    pass_a_mma: int
    pass_b_mma: int
    elementwise: int
    useful: int

    @property
    def executed(self) -> int:
        return self.pass_a_mma + self.pass_b_mma + self.elementwise


def chain_bwd_work(b: int, h: int, w: int, c: int, f: int, dtype: torch.dtype) -> BwdWork:
    """:class:`BwdWork` of one K2 (or K10) call. Pass (a): per CTA 112
    GEMM rows x the columns of its active warps (a quarter of ``wc`` each,
    idle past C) x F padded to the mma depth in each chunk, and 64 pixels x
    27 for each channel of its slice that C holds. Pass (b): per output
    tile the rows of its m16 tiles that hold C, the columns of its active
    warps, and each split's pixels padded to the mma depth."""
    plan = chain_bwd_plan(b, h, w, c, f, dtype)
    kc, ks, _ = _BWD_CHUNK[dtype]
    p = b * h * w
    ctas = b * plan.tiles_y * plan.tiles_x
    fpad = sum(_cdiv(min(kc, f - f0), ks) * ks for f0 in range(0, f, kc))
    quarter = plan.wc // 4
    cols_a = sum(quarter * min(4, _cdiv(min(plan.wc, c - c0), quarter))
                 for c0 in range(0, c, plan.wc))
    pass_a = ctas * _GEMM_ROWS * cols_a * fpad
    elementwise = ctas * 64 * c * 27
    rows_b = sum(16 * min(plan.tm // 16, _cdiv(min(plan.tm, c - c0), 16))
                 for c0 in range(0, c, plan.tm))
    cols_b = sum(plan.tn // 4 * min(4, _cdiv(min(plan.tn, f - f0), plan.tn // 4))
                 for f0 in range(0, f, plan.tn))
    depth = (plan.splits - 1) * plan.per + _cdiv(p - (plan.splits - 1) * plan.per, ks) * ks
    return BwdWork(pass_a, rows_b * cols_b * depth, elementwise, p * (2 * c * f + 27 * c))


# --------------------------------------------------------------------------
# K4's launch plan (the streaming body of kernels/csrc/stream_sums.cuh)
# --------------------------------------------------------------------------


# channels a K4 thread takes (kPoolCh of tail_pool.cu)
_POOL_CH = 4


class PoolBwdPlan(NamedTuple):
    """K4's launch: strips of ``n`` windows of one pooled row (the last strip
    of a row may be shorter), ``strips`` of them in all; ``ctas`` CTAs of
    :data:`..kernels.build.STREAM_THREADS` threads, one an SM, CTA c taking
    the strips of :func:`stream_ranges`; a stage holds a strip's two rows of y
    and of gs and its segment of gp, ``stage`` bytes; ``smem`` bytes of
    dynamic shared memory a CTA (``pool_bwd_smem`` of ``tail_pool.cu``,
    which checks it). Each thread takes one window x 4 channels of a strip,
    so ``n * F / 4`` threads work."""

    n: int
    strips: int
    ctas: int
    stage: int
    smem: int


def pool_bwd_plan(b: int, h: int, w: int, f: int, dtype: torch.dtype, sms: int) -> PoolBwdPlan:
    """K4's plan for ``b`` (H, W) images of F channels in ``dtype`` on a card
    of ``sms`` streaming multiprocessors: as many windows a strip as the
    CTA's threads take at once (one window x 4 channels each), at most a
    pooled row. Raises on what the kernel cannot launch."""
    if dtype not in build.DTYPE_CODE:
        raise TypeError(f"tail_pool_bwd: dtype {dtype} not supported (float32, bfloat16)")
    if min(b, h, w, f) < 1 or h % 2 or w % 2:
        raise ValueError(f"tail_pool_bwd: B={b} H={h} W={w} F={f}; H and W even and positive")
    e = dtype.itemsize
    vec = 16 // e
    if f % vec or f // _POOL_CH > build.STREAM_THREADS:
        raise ValueError(f"tail_pool_bwd: F={f} must be a multiple of {vec} and at most "
                         f"{build.STREAM_THREADS * _POOL_CH}")
    n = max(1, min(build.STREAM_THREADS // (f // _POOL_CH), w // 2))
    strips = b * (h // 2) * _cdiv(w // 2, n)
    stage = 9 * n * f * e   # y and gs: 2 rows x 2n pixels each; gp: n pixels
    smem = build.stream_smem(stage, build.STREAM_THREADS * 2 * _POOL_CH * 4)
    return PoolBwdPlan(n, strips, min(strips, sms), stage, smem)


def stream_ranges(units: int, ctas: int) -> List[Tuple[int, int]]:
    """The contiguous ``[begin, end)`` of ``units`` that each of ``ctas``
    CTAs of the streaming body takes (``unit_range`` of stream_sums.cuh)."""
    return [(units * c // ctas, units * (c + 1) // ctas) for c in range(ctas)]


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_act(t: torch.Tensor, name: str, shape=None, dtype=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {t.device}")
    if t.dtype not in build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous NHWC tensor, got {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_small(t: Optional[torch.Tensor], name: str, shape, dtype, device) -> None:
    if t is None:
        return
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
            f"expected {tuple(shape)} {dtype} on {device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _drop_args(drop: Optional[Dropout]):
    """(seed as a signed 32-bit int, threshold, scale) for the C entry points."""
    if drop is None:
        return 0, 0, 1.0
    seed = int(drop.seed) & 0xFFFFFFFF
    return seed - (1 << 32) if seed >= 1 << 31 else seed, drop.thresh, drop.scale


def chain_fwd(
    x: torch.Tensor,
    dw: torch.Tensor,
    pw: torch.Tensor,
    in_aff: Optional[torch.Tensor] = None,
    drop: Optional[Dropout] = None,
    halo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on a CUDA tensor, its plain version on a CPU tensor.

    ``dw`` (3,3,C) and ``pw`` (C,F) in x.dtype; ``in_aff`` (2,C) fp32 rows
    a, b; ``drop`` and ``in_aff`` are exclusive (dropout fuses on a chain's
    first link only). ``halo`` (B,2,W,C) in x.dtype: the halo mode of a row
    shard, z rows above (0) and below (1) it, zeros at the image's edge;
    exclusive with ``drop`` (row-sharded chains drop out before the chain);
    a launch with it also counts under ``chain_fwd_halo``. Returns ``(y
    (B,H,W,F), Σy (F,), Σy² (F,))``, the sums over the shard's own rows.
    """
    if drop is not None and in_aff is not None:
        raise ValueError("chain_fwd: dropout and the input affine are exclusive")
    if drop is not None and halo is not None:
        raise ValueError("chain_fwd: dropout and the halo are exclusive (row-sharded chains "
                         "drop out before the chain)")
    if x.device.type == "cpu":
        return chain_fwd_reference(x, dw, pw, in_aff, drop, halo)
    _check_act(x, "chain_fwd x")
    b, h, w, c = x.shape
    f = pw.shape[-1]
    if not 0 < b <= _MAX_BATCH:
        raise ValueError(f"chain_fwd: batch {b} outside 1..{_MAX_BATCH}")
    _check_small(dw, "chain_fwd dw", (3, 3, c), x.dtype, x.device)
    _check_small(pw, "chain_fwd pw", (c, f), x.dtype, x.device)
    _check_small(in_aff, "chain_fwd in_aff", (2, c), torch.float32, x.device)
    _check_small(halo, "chain_fwd halo", (b, 2, w, c), x.dtype, x.device)
    plan = fwd_plan(b, h, w, c, f, x.dtype, build.sm_count(x.device))
    lib = build.load_library()
    y = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    sums = torch.empty((2, f), dtype=torch.float32, device=x.device)
    work = torch.empty(lib.unet_chain_fwd_workspace(b, h, w, c, f),
                       dtype=torch.float32, device=x.device)
    seed, thresh, scale = _drop_args(drop)
    status = lib.unet_chain_fwd(
        x.data_ptr(), dw.data_ptr(), pw.data_ptr(), _ptr(in_aff), _ptr(halo), y.data_ptr(),
        work.data_ptr(), sums.data_ptr(), b, h, w, c, f, seed, thresh, scale,
        *fwd_plan_args(plan), build.DTYPE_CODE[x.dtype], build.stream_handle(x.device),
    )
    build.check(status, "chain_fwd")
    LAUNCHES["chain_fwd"] += 1
    if halo is not None:
        LAUNCHES["chain_fwd_halo"] += 1
    return y, sums[0], sums[1]


def chain_bwd(
    x: torch.Tensor,
    g: torch.Tensor,
    y: torch.Tensor,
    in_aff: Optional[torch.Tensor],
    comb: torch.Tensor,
    dw: torch.Tensor,
    pw: torch.Tensor,
    mask_combine: bool,
    drop: Optional[Dropout] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K2 on a CUDA tensor, its plain version on a CPU tensor.

    ``x`` (B,H,W,C) the link's input in its pre-affine form, ``g`` and
    ``y`` (B,H,W,F) the raw cotangent and the link's raw output, all in
    one dtype; ``in_aff`` (4,C) and ``comb`` (6,F) fp32. Returns
    ``(dx, ddw (3,3,C), dpw (C,F), st (2,C) or None)``, the grads fp32.
    """
    if drop is not None and in_aff is not None:
        raise ValueError("chain_bwd: dropout and the input affine are exclusive")
    if x.device.type == "cpu":
        return chain_bwd_reference(x, g, y, in_aff, comb, dw, pw, mask_combine, drop)
    _check_act(x, "chain_bwd x")
    b, h, w, c = x.shape
    f = pw.shape[-1]
    if not 0 < b <= _MAX_BATCH:
        raise ValueError(f"chain_bwd: batch {b} outside 1..{_MAX_BATCH}")
    _check_act(g, "chain_bwd g", (b, h, w, f), x.dtype)
    _check_act(y, "chain_bwd y", (b, h, w, f), x.dtype)
    _check_small(dw, "chain_bwd dw", (3, 3, c), x.dtype, x.device)
    _check_small(pw, "chain_bwd pw", (c, f), x.dtype, x.device)
    _check_small(in_aff, "chain_bwd in_aff", (4, c), torch.float32, x.device)
    _check_small(comb, "chain_bwd comb", (6, f), torch.float32, x.device)
    plan = chain_bwd_plan(b, h, w, c, f, x.dtype)
    lib = build.load_library()
    dx = torch.empty_like(x)
    m = torch.empty((b, h, w, plan.cm), dtype=x.dtype, device=x.device)  # depthwise(z), rounded
    gy = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    sums = torch.empty((11, c), dtype=torch.float32, device=x.device)  # ddw (9), S, T
    dpw = torch.empty((c, f), dtype=torch.float32, device=x.device)
    work = torch.empty(lib.unet_chain_bwd_workspace(b, h, w, c, f, plan.splits),
                       dtype=torch.float32, device=x.device)
    seed, thresh, scale = _drop_args(drop)
    status = lib.unet_chain_bwd(
        x.data_ptr(), g.data_ptr(), y.data_ptr(), _ptr(in_aff), comb.data_ptr(),
        dw.data_ptr(), pw.data_ptr(), dx.data_ptr(), m.data_ptr(), gy.data_ptr(),
        work.data_ptr(), sums.data_ptr(), dpw.data_ptr(), b, h, w, c, f,
        int(mask_combine), seed, thresh, scale, *plan_args(plan),
        build.DTYPE_CODE[x.dtype], build.stream_handle(x.device),
    )
    build.check(status, "chain_bwd")
    LAUNCHES["chain_bwd"] += 1
    st = sums[9:11] if in_aff is not None else None
    return dx, sums[:9].reshape(3, 3, c), dpw, st


def fwd_plan_args(plan: FwdPlan) -> Tuple[int, ...]:
    """The plan as the C entries of K8 and K1 take it: (n, s, width, per,
    smem)."""
    return plan.n, plan.s, plan.width, plan.per, plan.smem


def plan_args(plan: BwdPlan) -> Tuple[int, ...]:
    """The plan as the C entries of K2 and K10 take it: (wc, tm, tn, splits,
    per, smem_a, smem_b)."""
    return plan.wc, plan.tm, plan.tn, plan.splits, plan.per, plan.smem_a, plan.smem_b


def _check_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel loads 16-byte vectors; data is not 16-byte aligned")


def _check_pool_shape(y: torch.Tensor, name: str) -> None:
    _check_act(y, name)
    _check_aligned(y, name)
    b, h, w, f = y.shape
    vec = 16 // y.element_size()
    if h % 2 or w % 2:
        raise ValueError(f"{name}: pool needs even H and W, got {h}x{w}")
    if f % vec or f // vec > 256:
        raise ValueError(f"{name}: F={f} must be a multiple of {vec} and at most {256 * vec}")


def tail_pool(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on a CUDA tensor, its plain version on a CPU tensor: ``(z, pooled)``."""
    if y.device.type == "cpu":
        return tail_pool_reference(y, a, b)
    _check_pool_shape(y, "tail_pool y")
    bsz, h, w, f = y.shape
    aff = torch.stack([a, b]).float().contiguous()
    _check_small(aff, "tail_pool aff", (2, f), torch.float32, y.device)
    lib = build.load_library()
    z = torch.empty_like(y)
    pooled = torch.empty((bsz, h // 2, w // 2, f), dtype=y.dtype, device=y.device)
    status = lib.unet_tail_pool(
        y.data_ptr(), aff.data_ptr(), z.data_ptr(), pooled.data_ptr(), bsz, h, w, f,
        build.DTYPE_CODE[y.dtype], build.stream_handle(y.device),
    )
    build.check(status, "tail_pool")
    LAUNCHES["tail_pool"] += 1
    return z, pooled


def tail_pool_bwd(
    y: torch.Tensor, gs: torch.Tensor, gp: torch.Tensor, aff4: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on a CUDA tensor, its plain version on a CPU tensor: ``(dzt, st (2,F))``."""
    if y.device.type == "cpu":
        return tail_pool_bwd_reference(y, gs, gp, aff4)
    _check_pool_shape(y, "tail_pool_bwd y")
    bsz, h, w, f = y.shape
    _check_act(gs, "tail_pool_bwd gs", y.shape, y.dtype)
    _check_act(gp, "tail_pool_bwd gp", (bsz, h // 2, w // 2, f), y.dtype)
    _check_aligned(gs, "tail_pool_bwd gs")
    _check_aligned(gp, "tail_pool_bwd gp")
    _check_small(aff4, "tail_pool_bwd aff4", (4, f), torch.float32, y.device)
    plan = pool_bwd_plan(bsz, h, w, f, y.dtype, build.sm_count(y.device))
    lib = build.load_library()
    dzt = torch.empty_like(y)
    st = torch.empty((2, f), dtype=torch.float32, device=y.device)
    work = torch.empty((plan.ctas, 2 * f), dtype=torch.float32, device=y.device)
    status = lib.unet_tail_pool_bwd(
        y.data_ptr(), gs.data_ptr(), gp.data_ptr(), aff4.data_ptr(), dzt.data_ptr(),
        work.data_ptr(), st.data_ptr(), build.arrival_counter(y.device).data_ptr(), bsz, h, w,
        f, plan.n, plan.ctas, plan.smem, build.DTYPE_CODE[y.dtype],
        build.stream_handle(y.device),
    )
    build.check(status, "tail_pool_bwd")
    LAUNCHES["tail_pool_bwd"] += 1
    return dzt, st


# --------------------------------------------------------------------------
# Chain orchestration (autograd Function) and its composed reference
# --------------------------------------------------------------------------


def affine_from_stats(gamma, beta, mean, var, eps):
    """BatchNorm with batch moments as ``y * a + b`` (fp32)."""
    a = (gamma * torch.rsqrt(var + eps)).float()
    return a, (beta - mean * a).float()


def _boundary_bwd_plain(y, g_z, a_out, b_out, mean, r):
    """Reductions of the masked output gradient at a chain's non-pool exit
    (plain elementwise, as the JAX package computes it outside any kernel)."""
    yf = y.float()
    dzt = torch.where(yf * a_out + b_out > 0, g_z.float(), torch.zeros_like(yf))
    return dzt.sum(dim=(0, 1, 2)), (dzt * ((yf - mean) * r)).sum(dim=(0, 1, 2))


def _unflatten(flat) -> List[Tuple[torch.Tensor, ...]]:
    return [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)]


def _bn_terms(block, stats, eps: float):
    """``(mean, rstd, a, b)`` of one block's batch-moment BatchNorm."""
    gamma, beta = block[2], block[3]
    mean, var = stats
    r = torch.rsqrt(var + eps)
    a = (gamma * r).float()
    return mean, r, a, (beta - mean * a).float()


class Groups(NamedTuple):
    """The process groups of a sharded chain (None: one rank): ``bn`` the
    ranks whose pixels one BatchNorm normalizes (the whole mesh; its sums
    are all-reduced over it), ``spatial`` the ranks holding an image's row
    shards (the links exchange halos over it)."""

    bn: Optional[dist.ProcessGroup] = None
    spatial: Optional[dist.ProcessGroup] = None


def _ranks(group: Optional[dist.ProcessGroup]) -> int:
    return dist.get_world_size(group) if group is not None else 1


def halo_row_contrib(h_row: torch.Tensor, ktap: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """What one halo row adds to the adjacent output row of a 'same' 3x3
    separable conv (JAX ``_halo_row_contrib``): the (B,1,W,C) row correlated
    along W with one tap triple ``ktap`` (3,C) of the depthwise (``dw[0]``
    pairs with the row above, ``dw[2]`` with the row below), then the
    pointwise (C,F); fp32 in, (B,1,W,F) fp32 out."""
    _, m = _row_taps(h_row, ktap)
    return torch.matmul(m, pw.float())


def _row_taps(h_row, ktap):
    """``((prev, h, nxt), m)``: the row's values at w - 1, w and w + 1 (zero
    past the edges) and their sum weighted by the tap triple, fp32."""
    h, k = h_row.float(), ktap.float()
    z = torch.zeros_like(h[:, :, :1])
    prev = torch.cat([z, h[:, :, :-1]], dim=2)
    nxt = torch.cat([h[:, :, 1:], z], dim=2)
    return (prev, h, nxt), prev * k[0] + h * k[1] + nxt * k[2]


def halo_row_contrib_vjp(h_row, ktap, pw, g):
    """The vjp of :func:`halo_row_contrib` at cotangent ``g`` (B,1,W,F),
    in closed form, fp32: ``(d_h_row (B,1,W,C), d_ktap (3,C), d_pw (C,F))``."""
    k, p = ktap.float(), pw.float()
    dm = torch.matmul(g, p.t())                        # (B,1,W,C)
    (prev, h, nxt), m = _row_taps(h_row, ktap)
    d_k = torch.stack([(prev * dm).sum(dim=(0, 1, 2)), (h * dm).sum(dim=(0, 1, 2)),
                       (nxt * dm).sum(dim=(0, 1, 2))])
    d_h = dm * k[1]
    d_h[:, :, :-1] += dm[:, :, 1:] * k[0]              # h[w] is prev at w + 1
    d_h[:, :, 1:] += dm[:, :, :-1] * k[2]              # h[w] is nxt at w - 1
    c, f = p.shape
    d_p = torch.matmul(m.reshape(-1, c).t(), g.reshape(-1, f))
    return d_h, d_k, d_p


def _chain_links_fwd(z_in: torch.Tensor, flat, eps: float, drop: Optional[Dropout],
                     groups: Groups = Groups()):
    """The links of a chain, K1 once per block: ``(ys, stats, (a, b), halos)``.

    ``ys`` are the raw link outputs, ``stats`` the flat per-block batch
    mean and var, ``(a, b)`` the last block's BatchNorm affine, which the
    chain's exit applies (JAX ``_chain_fwd_impl``), and ``halos`` each
    link's (B,2,W,C) halo on row shards (``groups.spatial``), else empty.
    On row shards each link's z rows at the shard's edges (link 0's from
    ``z_in``, a later link's ``relu(a*y+b)`` of the previous raw rows,
    rounded) are exchanged and K1 runs in its halo mode; Σy and Σy² are
    all-reduced over ``groups.bn`` before the moments.
    """
    n = z_in.shape[0] * z_in.shape[1] * z_in.shape[2] * _ranks(groups.bn)
    x, in_aff, ys, stats, halos = z_in, None, [], [], []
    for k, (dw, pw, gamma, beta) in enumerate(_unflatten(flat)):
        kw = {}
        if groups.spatial is not None:
            top, bot = x[:, :1], x[:, -1:]
            if in_aff is not None:
                top, bot = (_relu_affine(r, in_aff[0], in_aff[1]).to(x.dtype) for r in (top, bot))
            kw["halo"] = edge_halo_exchange(top, bot, groups.spatial)
            halos.append(kw["halo"])
        y, s, q = chain_fwd(x, dw, pw, in_aff, drop if k == 0 else None, **kw)
        sq = all_sum(torch.stack([s, q]), groups.bn)
        mean = sq[0] / n
        var = sq[1] / n - mean * mean
        a, b = affine_from_stats(gamma, beta, mean, var, eps)
        in_aff = torch.stack([a, b])
        ys.append(y)
        stats += [mean, var]
        x = y
    return ys, stats, (in_aff[0], in_aff[1]), halos


def _edge_rows(t: torch.Tensor) -> torch.Tensor:
    """A shard's first and last rows (B,2,W,C), fp32."""
    return torch.cat([t[:, :1], t[:, -1:]], dim=1).float()


def _halo_bwd(x_in, in_aff, g_raw, y, masked, comb, dw, pw, halo, spatial):
    """A link's halo terms on row shards (JAX ``_chain_bwd_links``' spatial
    part), after K2: gy rebuilt at the shard's two edge rows, the vjp of
    :func:`halo_row_contrib` for the halo above (taps ``dw[0]``) and below
    (``dw[2]``), the halos' cotangents sent back to their owners. Returns
    ``(ddw_add (3,3,C), dpw_add, recv (B,2,W,C), st_add)``: the weight
    gradients' missing halo terms, what this shard's first and last rows of
    dx gain (masked by its own boundary ReLU after an affine), and, after
    an affine, that gain's share of the previous block's S and T (else
    None)."""
    gf, yf = _edge_rows(g_raw), _edge_rows(y)
    if not masked:
        gf = torch.where(yf * comb[4] + comb[5] > 0, gf, torch.zeros_like(gf))
    gy = gf * comb[0] + comb[1] + (yf - comb[3]) * comb[2]
    dwf = dw.float()
    d_top, ddw_top, dpw_top = halo_row_contrib_vjp(halo[:, :1], dwf[0], pw, gy[:, :1])
    d_bot, ddw_bot, dpw_bot = halo_row_contrib_vjp(halo[:, 1:], dwf[2], pw, gy[:, 1:])
    ddw_add = torch.stack([ddw_top, torch.zeros_like(ddw_top), ddw_bot])
    recv = edge_halo_exchange(d_top, d_bot, spatial)   # back to the rows' ranks
    st_add = None
    if in_aff is not None:
        # dx carries the masked dz: mask what comes in by this shard's own
        # boundary ReLU and add its share of the previous block's S and T
        xf = _edge_rows(x_in)
        recv = torch.where(xf * in_aff[0] + in_aff[1] > 0, recv, torch.zeros_like(recv))
        xhat = (xf - in_aff[2]) * in_aff[3]
        st_add = torch.stack([recv.sum(dim=(0, 1, 2)), (recv * xhat).sum(dim=(0, 1, 2))])
    return ddw_add, dpw_top + dpw_bot, recv, st_add


def _chain_links_bwd(z_first, ys, flat, stats, eps: float, drop: Optional[Dropout],
                     g_raw, S_loc, T_loc, masked: bool, groups: Groups = Groups(), halos=()):
    """The links' backward, K2 once per block, last block first (JAX
    ``_chain_bwd_links``): ``(dz_in, grads)``.

    ``g_raw`` is the cotangent of the last raw link output, already masked
    by the exit's ReLU when ``masked`` (else K2 folds the mask in), and
    ``S_loc``, ``T_loc`` the exit's BatchNorm reductions over this rank's
    pixels, all-reduced over ``groups.bn`` for the combine constants (the
    normalized batch is the mesh's). ``grads`` are per block ``ddw, dpw,
    dgamma, dbeta`` in the parameters' dtypes, this rank's partials (the
    train step sums them over the mesh). On row shards (``groups.spatial``,
    ``halos`` from :func:`_chain_links_fwd`) each link adds its halo terms
    (:func:`_halo_bwd`).
    """
    blocks = _unflatten(flat)
    nb = len(blocks)
    pairs = [(stats[2 * k], stats[2 * k + 1]) for k in range(nb)]
    n = z_first.shape[0] * z_first.shape[1] * z_first.shape[2] * _ranks(groups.bn)
    grads: List[Optional[torch.Tensor]] = [None] * (4 * nb)
    dz_in = None
    st = all_sum(torch.stack([S_loc, T_loc]), groups.bn)
    S, T = st[0], st[1]
    for k in range(nb - 1, -1, -1):
        dw, pw, gamma, beta = blocks[k]
        mean, r, a_out, b_out = _bn_terms(blocks[k], pairs[k], eps)
        comb = torch.stack([
            a_out,
            -(a_out * S) / n,
            -(a_out * r * T) / n,
            mean.float(),
            a_out,
            b_out,
        ]).float().contiguous()
        if k > 0:
            pm, pr, pa, pb = _bn_terms(blocks[k - 1], pairs[k - 1], eps)
            in_aff = torch.stack([pa, pb, pm.float(), pr.float()]).contiguous()
            x_in = ys[k - 1]
        else:
            in_aff, x_in = None, z_first
        g_raw = g_raw.contiguous()
        dx, ddw, dpw, st_prev = chain_bwd(
            x_in, g_raw, ys[k], in_aff, comb, dw, pw,
            mask_combine=not masked, drop=drop if k == 0 else None,
        )
        if groups.spatial is not None:
            ddw_add, dpw_add, recv, st_add = _halo_bwd(
                x_in, in_aff, g_raw, ys[k], masked, comb, dw, pw, halos[k], groups.spatial)
            ddw, dpw = ddw + ddw_add, dpw + dpw_add
            dx = dx.clone()
            dx[:, :1] += recv[:, :1].to(dx.dtype)
            dx[:, -1:] += recv[:, 1:].to(dx.dtype)
            if st_add is not None:
                st_prev = st_prev + st_add
        grads[4 * k:4 * k + 4] = [
            ddw.to(dw.dtype), dpw.to(pw.dtype), T_loc.to(gamma.dtype), S_loc.to(beta.dtype),
        ]
        if k > 0:
            S_loc, T_loc = st_prev[0], st_prev[1]
            st = all_sum(st_prev, groups.bn)
            S, T = st[0], st[1]
            g_raw, masked = dx, True
        else:
            dz_in = dx
    return dz_in, grads


class _Chain(torch.autograd.Function):
    """``z_in -> [link]*N -> boundary`` with the fused backward.

    Inputs after the static ones: per block ``(dw (3,3,C), pw (C,F)`` in
    the compute dtype, ``gamma, beta)`` in fp32. Outputs ``z`` (and
    ``pooled`` with ``pool``), then mean and var per block; the moments
    feed the running statistics and carry no gradient.
    """

    @staticmethod
    def forward(ctx, z_in, eps: float, drop: Optional[Dropout], pool: bool, groups: Groups,
                *flat):
        ys, stats, (a, b), halos = _chain_links_fwd(z_in, flat, eps, drop, groups)
        if pool:
            outs = tail_pool(ys[-1], a, b)
        else:
            outs = (_relu_affine(ys[-1], a, b).to(z_in.dtype),)
        ctx.save_for_backward(z_in, *ys, *flat, *stats, *halos)
        ctx.n_blocks, ctx.eps, ctx.drop, ctx.pool = len(flat) // 4, eps, drop, pool
        ctx.groups = groups
        ctx.mark_non_differentiable(*stats)
        return (*outs, *stats)

    @staticmethod
    def backward(ctx, *grads):
        nb, eps = ctx.n_blocks, ctx.eps
        saved = ctx.saved_tensors
        z_first, ys = saved[0], saved[1:1 + nb]
        flat = saved[1 + nb:1 + 5 * nb]
        stats = saved[1 + 5 * nb:1 + 7 * nb]
        halos = saved[1 + 7 * nb:]
        mean, r, a_out, b_out = _bn_terms(flat[-4:], stats[-2:], eps)
        g_z = grads[0].to(z_first.dtype).contiguous()
        if ctx.pool:
            g_pool = grads[1].to(z_first.dtype).contiguous()
            aff4 = torch.stack([a_out, b_out, mean.float(), r.float()]).contiguous()
            g_raw, st = tail_pool_bwd(ys[-1], g_z, g_pool, aff4)
            S, T, masked = st[0], st[1], True
        else:
            S, T = _boundary_bwd_plain(ys[-1], g_z, a_out, b_out, mean, r)
            g_raw, masked = g_z, False
        dz_in, grads_out = _chain_links_bwd(z_first, ys, flat, stats, eps, ctx.drop,
                                            g_raw, S, T, masked, ctx.groups, halos)
        return (dz_in, None, None, None, None, *grads_out)


def _prep_blocks(dtype: torch.dtype, c: int, blocks) -> List[torch.Tensor]:
    """Flat ``[dw (3,3,C), pw (C,F), gamma, beta] * N``; kernels in ``dtype``."""
    flat = []
    for dw, pw, gamma, beta in blocks:
        f = pw.shape[-1]
        flat += [
            dw.reshape(3, 3, c).to(dtype).contiguous(),
            pw.reshape(c, f).to(dtype).contiguous(),
            gamma,
            beta,
        ]
        c = f
    return flat


def _stat_pairs(flat_stats) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    return tuple((flat_stats[i], flat_stats[i + 1]) for i in range(0, len(flat_stats), 2))


def fused_chain_train(
    z_in: torch.Tensor,
    blocks: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]],
    eps: float = 1e-3,
    drop_rate: float = 0.0,
    drop_seed: Optional[int] = None,
    groups: Groups = Groups(),
):
    """Train-mode ConvBlock chain ``z_in -> [sepconv -> BN -> ReLU] x N``.

    ``blocks``: per block ``(depthwise (3,3,C[,1]), pointwise ([1,1,]C,F),
    bn_scale (F,), bn_offset (F,))``. With ``drop_rate > 0`` the chain's
    input gets hash dropout with ``drop_seed``, fused into the first link.
    ``groups``: on a mesh, the BatchNorm group (the moments are the mesh
    batch's) and the row shards' group (halos every link; no dropout, the
    caller drops out before the chain). Returns ``(z_out, ((batch_mean,
    batch_var), ...))``.
    """
    flat = _prep_blocks(z_in.dtype, z_in.shape[-1], blocks)
    drop = None
    if drop_rate > 0.0:
        if drop_seed is None:
            raise ValueError("fused_chain_train: drop_rate > 0 needs a drop_seed")
        if groups.spatial is not None:
            raise ValueError("fused_chain_train: row-sharded chains take no dropout; drop out "
                             "before the chain")
        drop = Dropout(int(drop_seed), float(drop_rate))
    out = _Chain.apply(z_in.contiguous(), eps, drop, False, groups, *flat)
    return out[0], _stat_pairs(out[1:])


def fused_chain_train_pool(
    z_in: torch.Tensor,
    blocks: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]],
    eps: float = 1e-3,
    groups: Groups = Groups(),
):
    """Encoder chain with the 2x2 max pool fused into its boundary.

    Returns ``(z, pooled, stats)``: the stage activation (the skip), its
    2x2 max pool (the next stage's input) and the per-block moments.
    ``groups`` as for :func:`fused_chain_train`.
    """
    flat = _prep_blocks(z_in.dtype, z_in.shape[-1], blocks)
    out = _Chain.apply(z_in.contiguous(), eps, None, True, groups, *flat)
    return out[0], out[1], _stat_pairs(out[2:])


def chain_reference(
    z_in: torch.Tensor,
    blocks,
    eps: float = 1e-3,
    drop_rate: float = 0.0,
    drop_seed: Optional[int] = None,
):
    """Composed autograd chain with the same semantics as :func:`fused_chain_train`:
    per block sepconv -> moments of the rounded output -> normalize -> ReLU."""
    z = z_in
    if drop_rate > 0.0:
        z = hd.hash_dropout(z, drop_seed, drop_rate)
    n = z.shape[0] * z.shape[1] * z.shape[2]
    stats = []
    c = z.shape[-1]
    for dw, pw, gamma, beta in blocks:
        f = pw.shape[-1]
        d = _depthwise(z, dw.reshape(3, 3, c).to(z.dtype)).to(z.dtype)
        y = torch.matmul(d.float(), pw.reshape(c, f).to(z.dtype).float()).to(z.dtype)
        yf = y.float()
        mean = yf.sum(dim=(0, 1, 2)) / n
        var = (yf * yf).sum(dim=(0, 1, 2)) / n - mean * mean
        stats.append((mean, var))
        a, b = affine_from_stats(gamma, beta, mean, var, eps)
        z = (yf * a + b).clamp_min(0.0).to(z_in.dtype)
        c = f
    return z, stats
