"""Deterministic position-hash dropout, bit-exact with the JAX package.

Port of ``unet_image_segmentation_tpu/ops/hash_dropout.py``. The keep mask
is a pure function of each element's logical NHWC coordinates and a
per-site seed: the murmur3 fmix32 finalizer of ``idx ^ seed`` on wrapping
32-bit integers, with ``idx = ((b*H + h)*W + w)*C + c``. The chain kernels
(``kernels/csrc/chain_*.cu``) regenerate the same bits from the same
coordinates, so no mask is ever stored.

The hash runs on int32 tensors, as in the JAX package: products wrap mod
2^32, and torch's arithmetic right shift is made logical by masking the
sign-extended high bits after each ``>>``.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_POS = 0x7FFFFFFF


def _as_int32(v: int) -> int:
    """The int32 whose bits are the low 32 bits of ``v``."""
    v &= _MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


_M1 = _as_int32(0x85EBCA6B)  # murmur3 fmix32 multipliers
_M2 = _as_int32(0xC2B2AE35)


def fold_seed(seed: int, value: int) -> int:
    """A dropout seed with an index folded in (the counterpart of JAX
    ``random.fold_in`` for a data or spatial index): the hash of ``seed``
    and the hash of ``value + 1``, an int32, the same on every rank."""
    folded = mix_hash(mix_hash(torch.tensor([value + 1], dtype=torch.int32), 0), seed)
    return int(folded[0])


def keep_threshold(rate: float) -> int:
    """31-bit threshold: keep iff ``hash & 0x7fffffff < threshold``."""
    return min(int(round((1.0 - rate) * 2147483648.0)), 2147483647)


def inv_keep(rate: float) -> float:
    """The scale of kept elements, ``1 / (1 - rate)``."""
    return 1.0 / (1.0 - rate)


def mix_hash(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3 fmix32 of ``idx ^ seed`` on int32 ``idx``."""
    h = idx ^ _as_int32(seed)
    h = h ^ ((h >> 16) & 0xFFFF)
    h = h * _M1
    h = h ^ ((h >> 13) & 0x7FFFF)
    h = h * _M2
    return h ^ ((h >> 16) & 0xFFFF)


def keep_mask(shape, seed: int, thresh: int, device=None) -> torch.Tensor:
    """Boolean keep mask of an NHWC tensor of ``shape``."""
    n = 1
    for d in shape:
        n *= d
    if n <= 1 << 31:
        idx = torch.arange(n, dtype=torch.int32, device=device)
    else:  # the flat logical index wraps like the int32 original
        idx = torch.arange(n, dtype=torch.int64, device=device)
        idx = (((idx + (1 << 31)) & _MASK32) - (1 << 31)).to(torch.int32)
    return (mix_hash(idx.reshape(shape), seed) & _POS) < thresh


def apply_keep(x: torch.Tensor, keep: torch.Tensor, scale: float) -> torch.Tensor:
    """``where(keep, x * scale, 0)`` scaled in fp32, cast back to x.dtype."""
    scaled = x.float() * torch.tensor(scale, dtype=torch.float32)
    return torch.where(keep, scaled, torch.zeros_like(scaled)).to(x.dtype)


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed: int, rate: float):
        keep = keep_mask(x.shape, seed, keep_threshold(rate), x.device)
        ctx.seed, ctx.rate = seed, rate
        ctx.shape, ctx.device = x.shape, x.device
        return apply_keep(x, keep, inv_keep(rate))

    @staticmethod
    def backward(ctx, g):
        # the mask is regenerated from the coordinates, never stored
        keep = keep_mask(ctx.shape, ctx.seed, keep_threshold(ctx.rate), ctx.device)
        return apply_keep(g, keep, inv_keep(ctx.rate)), None, None


def hash_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Stateless dropout of the NHWC tensor ``x``; differentiable."""
    if rate <= 0.0:
        return x
    return _HashDropout.apply(x, int(seed), float(rate))
