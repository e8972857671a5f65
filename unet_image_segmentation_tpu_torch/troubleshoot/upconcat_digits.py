"""Where K6's fp32 ``d_kernel`` loses digits: its split-K sums, emulated.

``d_kernel = x^T . dup`` (C, 4F) sums over the B*H*W pixels of a decoder
feed's input x (524288 at dec1 of the 256 px U-Net at batch 32).
``upconcat_dw_kernel`` of ``csrc/upconcat.cu`` cuts them into
``upconcat_plan``'s ``splits`` splits of ``per`` pixels, sums each split of
a 128x128 output tile on the tensor cores (3xTF32 products, ``gemm_cols``)
and ``reduce_rows`` sums the splits' partial rows in a fixed order: the
order of K10's fp32 ``dpw`` (:mod:`.dpw_digits`), whose emulations this
tool reuses. The JAX package's ``_bwd_kernel``
(``ops/pallas/fused_upconcat.py``) takes one fp32 ``dot_general`` a (batch,
row tile) of ``th/2 * W`` pixels and adds it into an fp32 scratch, tile by
tile. On one 128x128 output tile (channels 0..127, columns 0..127 of
(di, dj, f)), from the fp32 x and dup the kernel consumes, each way's max
error over ``max|fp64|``:

* (i) ``fp64``, the reference;
* (ii) ``fp32``: fp32 fused multiply-adds in the kernel's split order, the
  partials summed in ``reduce_rows``' order;
* (iii) ``3xtf32``: (ii) with the kernel's 3xTF32 products;
* (iv) ``fp32_one_split``: (ii) with one split;
* (v) ``kernel``: K6's own fp32 ``d_kernel``;
* (vi) ``jax_tiles``: JAX's tile order, each tile's dot as serial fp32
  fused multiply-adds, the tiles added in grid order
  (``tests/upconcat_digits_cpu.py`` runs the JAX kernel itself on the CPU).

The inputs are seeded numpy (:func:`inputs`; x non-negative, as a ReLU'd
feed is), the same on every machine. The serial sums run in fp64 on the
card (:func:`.dpw_digits.split_partials`: the same bits as numpy's). Usage
on the card::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.upconcat_digits \\
        [--run dec4:32 dec3:32 dec2:32 dec1:32 dec1:2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

from unet_image_segmentation_tpu_torch.troubleshoot import dpw_digits as dd
from unet_image_segmentation_tpu_torch.troubleshoot import roofline

# the decoder feeds of the 256 px U-Net: name -> (C, F, H) of x (B,H,H,C)
FEEDS = {name: (c, f, h) for name, c, f, h in roofline.upconcat_shapes(256, (64, 128, 256, 512))}
RUNS = tuple(f"{name}:32" for name in FEEDS) + ("dec1:2",)
TILE = 128      # the d_kernel output tile taken apart: rows c < 128, columns n < 128
SEED = 2020
JAX_TILE_BUDGET = 12 * 1024 * 1024   # vmem_budget(6) at the JAX package's default scale 2.0


def inputs(batch: int, c: int, f: int, h: int, seed: int = SEED) -> Dict[str, np.ndarray]:
    """Seeded fp32 x (B,H,H,C) = max(N(0, 1), 0), the cat cotangent g
    (B,2H,2H,2F) in [-1, 1) and the transpose kernel (2,2,F,C), each from
    its own stream, drawn an image at a time."""
    rx, rg, rk = (np.random.RandomState([seed, i]) for i in range(3))
    return {
        "x": np.stack([np.maximum(rx.randn(h, h, c), 0).astype(np.float32)
                       for _ in range(batch)]),
        "g": np.stack([(rg.rand(2 * h, 2 * h, 2 * f) * 2 - 1).astype(np.float32)
                       for _ in range(batch)]),
        "kernel": (rk.randn(2, 2, f, c) / np.sqrt(c)).astype(np.float32),
    }


def dup_of(g, f: int):
    """(P, 4F) ``dup`` of the cat cotangent g (B,2H,2W,2F) (a torch tensor),
    columns in (di, dj, f) order, as the kernel gathers it."""
    b, h2, w2, _ = g.shape
    return (g[..., :f].reshape(b, h2 // 2, 2, w2 // 2, 2, f).permute(0, 1, 3, 2, 4, 5)
            .reshape(-1, 4 * f))


def d_kernel_fp64(x, g):
    """(C, 4F) fp64 ``x^T . dup`` of torch tensors x (B,H,W,C), g (B,2H,2W,2F)
    on their device."""
    c, f = x.shape[-1], g.shape[-1] // 2
    return x.reshape(-1, c).double().t() @ dup_of(g, f).double()


def jax_tile_rows(h2: int, w: int, c: int, f: int,
                  budget: int = JAX_TILE_BUDGET) -> Optional[int]:
    """The JAX kernel's output-row tile for a feed of 2H = ``h2`` rows
    (``_pick_tile`` of its ``ops/pallas/fused_upconcat.py``): the largest
    even divisor of ``h2`` from 32 down whose working set fits the budget."""
    for th in (32, 16, 8, 4, 2):
        if h2 % th:
            continue
        th2 = th // 2
        per = th2 * w * c * 2 + th * w * 2 * f * 2 + th * w * 4 * f * 2 + th2 * w * 4 * f * 4
        if 3 * per + c * 4 * f * 2 <= budget:
            return th
    return None


def jax_order(m: np.ndarray, g: np.ndarray, rows: int, device=None) -> np.ndarray:
    """(C, N) fp32: each run of ``rows`` pixels (a JAX tile) summed by serial
    fp32 fused multiply-adds, the tiles' sums added into one fp32 total in
    order."""
    if m.shape[0] % rows:
        raise ValueError(f"{m.shape[0]} pixels are not whole tiles of {rows}")
    total = np.zeros((m.shape[1], g.shape[1]), np.float32)
    for part in dd.split_partials(m, g, rows, m.shape[0] // rows, device=device):
        total = total + part
    return total


def orders(m: np.ndarray, g: np.ndarray, per: int, splits: int, rows: int,
           device=None) -> Dict[str, np.ndarray]:
    """(i)-(iv) and (vi) of the module docstring from fp32 m (P, C) and dup
    (P, N)."""
    return {**dd.orders(m, g, per, splits, device), "jax_tiles": jax_order(m, g, rows, device)}


def plan(name: str, batch: int, sms: int):
    """K6's fp32 launch plan (``upconcat_plan``) at feed ``name`` and
    ``batch`` on a card of ``sms`` multiprocessors: the d_kernel split order
    (``splits`` x ``per``) the emulations take."""
    import torch

    from unet_image_segmentation_tpu_torch.ops import fused_upconcat as fu

    c, f, h = FEEDS[name]
    return fu.upconcat_plan(batch, h, h, c, f, torch.float32, sms)


def kernel_tile(name: str, batch: int, device="cuda", data=None):
    """K6's fp32 d_kernel at feed ``name`` and ``batch`` on the card, from
    :func:`inputs` (or ``data``): its :data:`TILE` x :data:`TILE` output
    tile, the fp32 x and dup columns that tile sums (P, TILE), as numpy, and
    the launch plan."""
    import torch

    from unet_image_segmentation_tpu_torch.ops import fused_upconcat as fu
    from unet_image_segmentation_tpu_torch.ops.kernels import build

    c, f, h = FEEDS[name]
    data = inputs(batch, c, f, h) if data is None else data
    t = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    d_kernel = fu.upconcat_bwd(t["x"], t["kernel"], t["g"])[1]
    kernel = d_kernel.permute(3, 0, 1, 2).reshape(c, 4 * f)[:TILE, :TILE].cpu().numpy()
    m = t["x"].reshape(-1, c)[:, :TILE].cpu().numpy()
    g = dup_of(t["g"], f)[:, :TILE].contiguous().cpu().numpy()
    return kernel, m, g, plan(name, batch, build.sm_count(t["x"].device))


def run(name: str, batch: int, device="cuda") -> dict:
    """The six ways at feed ``name`` and ``batch`` on the card, from
    :func:`inputs`, on the output tile :data:`TILE` x :data:`TILE`."""
    c, f, h = FEEDS[name]
    kernel, m, g, kplan = kernel_tile(name, batch, device)
    rows = jax_tile_rows(2 * h, h, c, f) // 2 * h
    t0 = time.perf_counter()
    got = orders(m, g, kplan.per, kplan.splits, rows, device)
    ref = dd.exact(m, g)
    err = {k: dd.rel_err(v, ref) for k, v in {**got, "kernel": kernel}.items() if k != "fp64"}
    return {"feed": name, "shape": [batch, h, h, c, f], "tile": [TILE, TILE],
            "splits": kplan.splits, "per": kplan.per, "jax_tile_pixels": rows,
            "emulation_seconds": time.perf_counter() - t0, "rel_err": err}


def line(res: dict) -> str:
    e = res["rel_err"]
    return (f"K6 fp32 d_kernel digits at {res['feed']} {res['shape']} (splits {res['splits']} "
            f"x {res['per']}; one {res['tile'][0]}x{res['tile'][1]} output tile), max err / "
            f"max|fp64|: (ii) fp32 FMA in the kernel's order {e['fp32']:.2e}, (iii) its "
            f"products as 3xTF32 {e['3xtf32']:.2e}, (iv) one split {e['fp32_one_split']:.2e}, "
            f"(v) the kernel {e['kernel']:.2e}, (vi) JAX's tile order (tiles of "
            f"{res['jax_tile_pixels']}) {e['jax_tiles']:.2e}; (v) / (vi) "
            f"{e['kernel'] / e['jax_tiles']:.2f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run", nargs="+", default=list(RUNS), metavar="FEED:BATCH")
    p.add_argument("--out", default=os.path.join("build", "upconcat_digits.json"))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("upconcat_digits: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = roofline.card()
    results = []
    for spec in args.run:
        name, batch = spec.split(":")
        res = run(name, int(batch))
        print(f"{line(res)} [{card}; emulated on the card in "
              f"{res['emulation_seconds']:.1f} s]", flush=True)
        results.append({**res, "card": card})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
