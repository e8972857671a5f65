"""Where K10/K2's fp32 ``dpw`` loses digits: pass (b)'s sums, emulated.

``dpw = m^T . gy`` sums over the B*H*W pixels (2M at the 256 px stage of
batch 32). Pass (b) of ``csrc/chain_bwd.cu`` cuts them into
``chain_bwd_plan``'s ``splits`` splits of ``per`` pixels, sums each split
into one fp32 accumulator on the tensor cores (3xTF32 products, chunks of
``KC`` pixels), and ``reduce_rows`` sums the splits' partial rows in a fixed
order. :func:`decompose` computes ``dpw`` five ways from the fp32 ``m`` and
``gy`` that pass (b) consumes, and each one's max error over ``max|fp64|``:

* (i) ``fp64``: m and gy in fp64, the reference;
* (ii) ``fp32``: fp32 fused multiply-adds in pass (b)'s order, one serial
  accumulator a split (each product exact, each sum rounded), the partials
  summed in ``reduce_rows``' order;
* (iii) ``3xtf32``: (ii) with each product as the kernel's 3xTF32
  (``split_tf32``: hi = tf32(v), lo = tf32(v - hi); lo_m*hi_g, hi_m*lo_g,
  hi_m*hi_g, fused into the accumulator in that order);
* (iv) ``fp32_one_split``: (ii) with one split;
* (v) ``kernel``: the kernel's own ``dpw``.

(ii)-(iv) split the products from the depth of a split's serial sum and
the cross-split sum; (v) against (iii) is what the tensor cores' own sums
add. The emulations run in numpy on the host; a fused multiply-add is an
exact fp64 product and one fp64 sum rounded to fp32 (a double rounding only
at a tie of 2^-53). Usage on the card::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.dpw_digits [--batch 32 2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

# enc1.1 of the 256 px U-Net: RGB in, 64 out (``roofline.chain_links``)
BLOCK = ("enc1.1", 3, 64, 256)
SEED = 2019
RED_ROWS = 512   # kRedRows of train_common.cuh: the rows one colsum block sums
RED_LANES = 8    # threadIdx.y of colsum_kernel: each sums every 8th row


def inputs(batch: int, c: int = BLOCK[1], f: int = BLOCK[2], hw: int = BLOCK[3],
           seed: int = SEED) -> Dict[str, np.ndarray]:
    """Seeded fp32 x (B,H,W,C), gy (B,H,W,F) in [-1, 1), taps (3,3,C) and
    pointwise (C,F): the same on every machine."""
    rng = np.random.RandomState(seed)
    return {
        "x": (rng.rand(batch, hw, hw, c) * 2 - 1).astype(np.float32),
        "g": (rng.rand(batch, hw, hw, f) * 2 - 1).astype(np.float32),
        "dw": (rng.randn(3, 3, c) / 3).astype(np.float32),
        "pw": (rng.randn(c, f) / np.sqrt(c)).astype(np.float32),
    }


def tf32(v: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, ties away
    from zero."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_partials(m: np.ndarray, g: np.ndarray, per: int, splits: int,
                   products: str = "fp32", device=None) -> np.ndarray:
    """(splits, C, F) fp32: split s sums pixels [s*per, (s+1)*per) of m (P, C)
    and g (P, F) serially, one fused multiply-add a product (``products``
    'fp32'), or three in 3xTF32's order ('3xtf32'). With a ``device`` the
    serial sums run there in torch (the same IEEE operations, so the same
    bits as in numpy); the result comes back as numpy."""
    p, c = m.shape
    f = g.shape[1]
    if splits * per < p:
        raise ValueError(f"{splits} splits of {per} pixels do not cover {p}")
    if products not in ("fp32", "3xtf32"):
        raise ValueError(f"products must be 'fp32' or '3xtf32', got {products!r}")
    pad = splits * per - p   # zero pixels: a fused add of 0 * 0 leaves acc as it is
    mm = np.concatenate([m, np.zeros((pad, c), np.float32)]).reshape(splits, per, c)
    gg = np.concatenate([g, np.zeros((pad, f), np.float32)]).reshape(splits, per, f)
    # each product's (m, g) operands in the order they are added, in fp64
    # (exact), so every step is a fused multiply-add rounded once to fp32
    if products == "fp32":
        terms = [(mm, gg)]
    else:
        mh, gh = tf32(mm), tf32(gg)
        terms = [(tf32(mm - mh), gh), (mh, tf32(gg - gh)), (mh, gh)]
    acc = np.zeros((splits, c, f), np.float32)
    if device is None:
        terms = [(a.astype(np.float64), b.astype(np.float64)) for a, b in terms]
        f32 = lambda v: v.astype(np.float32)   # noqa: E731
    else:
        import torch

        terms = [tuple(torch.from_numpy(v).to(device, torch.float64) for v in t)
                 for t in terms]
        acc = torch.from_numpy(acc).to(device)
        f32 = lambda v: v.float()   # noqa: E731
    for k in range(per):
        for a, b in terms:
            acc = f32(acc + a[:, k, :, None] * b[:, k, None, :])
    return acc if device is None else acc.cpu().numpy()


def reduce_rows(part: np.ndarray) -> np.ndarray:
    """``reduce_rows`` of train_common.cuh on (rows, ...) fp32: blocks of
    :data:`RED_ROWS` rows, each the fp32 sum of :data:`RED_LANES` serial
    sums of every 8th row, in lane order; again over the blocks' rows until
    one is left."""
    rows = part.astype(np.float32)
    while True:
        blocks = []
        for r0 in range(0, rows.shape[0], RED_ROWS):
            block = rows[r0:r0 + RED_ROWS]
            total = np.zeros(rows.shape[1:], np.float32)
            for lane in range(RED_LANES):
                s = np.zeros(rows.shape[1:], np.float32)
                for r in range(lane, block.shape[0], RED_LANES):
                    s = s + block[r]
                total = total + s
            blocks.append(total)
        rows = np.stack(blocks)
        if rows.shape[0] == 1:
            return rows[0]


def pass_b_order(m: np.ndarray, g: np.ndarray, per: int, splits: int,
                 products: str = "fp32", device=None) -> np.ndarray:
    """(C, F) fp32: ``dpw`` in pass (b)'s order (:func:`split_partials`, then
    :func:`reduce_rows`)."""
    return reduce_rows(split_partials(m, g, per, splits, products, device))


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got.astype(np.float64) - ref).max() / np.abs(ref).max())


def exact(m: np.ndarray, g: np.ndarray) -> np.ndarray:
    """(i): ``m^T . g`` in fp64."""
    return m.astype(np.float64).T @ g.astype(np.float64)


def orders(m: np.ndarray, g: np.ndarray, per: int, splits: int,
           device=None) -> Dict[str, np.ndarray]:
    """(i)-(iv) of the module docstring from fp32 m (P, C) and gy (P, F),
    the serial sums on ``device`` (numpy when None)."""
    return {
        "fp64": exact(m, g),
        "fp32": pass_b_order(m, g, per, splits, device=device),
        "3xtf32": pass_b_order(m, g, per, splits, "3xtf32", device),
        "fp32_one_split": pass_b_order(m, g, -(-m.shape[0] // 8) * 8, 1, device=device),
    }


def decompose(m: np.ndarray, g: np.ndarray, per: int, splits: int,
              kernel: Optional[np.ndarray] = None, device=None) -> Dict[str, float]:
    """Each way's max |error| over max|fp64| (:func:`orders`, and the
    kernel's ``dpw`` when given)."""
    got = orders(m, g, per, splits, device)
    ref = got.pop("fp64")
    if kernel is not None:
        got["kernel"] = kernel
    return {name: rel_err(v, ref) for name, v in got.items()}


def kernel_run(x, g, dw, pw):
    """K10 on CUDA tensors: its (C, F) dpw and the (P, C) fp32 m its pass
    (b) consumed, as numpy, and the plan it ran."""
    import torch

    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
    from unet_image_segmentation_tpu_torch.ops import fused_train as ft

    b, h, w, c = x.shape
    plan = ft.chain_bwd_plan(b, h, w, c, pw.shape[1], x.dtype, bias=True)
    _, _, dpw, _, m = fs.sepconv_bwd_with_m(x, g, dw, pw)
    torch.cuda.synchronize()
    return dpw.cpu().numpy(), m[..., :c].reshape(-1, c).cpu().numpy(), plan


def run(batch: int, device="cuda", data: Optional[Dict[str, np.ndarray]] = None) -> dict:
    """The five ways at :data:`BLOCK` and ``batch`` on the card, from
    :func:`inputs` (or ``data``: x, g, dw, pw)."""
    import torch

    data = data or inputs(batch)
    t = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    kernel, m, plan = kernel_run(t["x"], t["g"], t["dw"], t["pw"])
    f = data["g"].shape[-1]
    err = decompose(m, data["g"].reshape(-1, f), plan.per, plan.splits, kernel)
    return {"block": BLOCK[0], "shape": list(data["g"].shape[:3]) + [m.shape[1], f],
            "splits": plan.splits, "per": plan.per, "rel_err": err}


def line(res: dict) -> str:
    e = res["rel_err"]
    return (f"dpw digits at {res['block']} {res['shape']} (splits {res['splits']} x "
            f"{res['per']}), max err / max|fp64|: (ii) fp32 FMA in pass (b)'s order "
            f"{e['fp32']:.2e}, (iii) its products as 3xTF32 {e['3xtf32']:.2e}, (iv) one split "
            f"{e['fp32_one_split']:.2e}, (v) the kernel {e['kernel']:.2e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, nargs="+", default=[32, 2])
    p.add_argument("--out", default=os.path.join("build", "dpw_digits.json"))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("dpw_digits: no CUDA device", file=sys.stderr)
        return 1
    results = [run(b) for b in args.batch]
    for r in results:
        print(line(r), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
