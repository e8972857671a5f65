"""K6's fp32 ``d_kernel`` against fp64 in the JAX package's order, on the CPU:
a diagnostic, not a test (pytest does not collect it).

The inputs are ``troubleshoot/upconcat_digits.inputs(batch, *FEEDS[feed])``:
seeded numpy, the same on every machine, so the port's kernel run on the
card (``python -m unet_image_segmentation_tpu_torch.troubleshoot.upconcat_digits``)
meets the same numbers. JAX's order is its ``fused_upconcat(x, kernel,
bias, skip_packed, 2)`` backward as the JAX package runs it on the CPU: the
Pallas ``_bwd_kernel`` in interpret mode, one fp32 ``dot_general`` a
(batch, row tile), added into an fp32 scratch tile by tile. Printed beside
it, the tool's emulation of that order (serial fp32 fused multiply-adds a
tile). Each: max |d_kernel - fp64| / max|fp64| on the tool's output tile
(channels 0..127, columns 0..127 of (di, dj, f)), fp64 of the same fp32 x
and dup.

Usage (from the repository root)::

    JAX_PLATFORMS=cpu python tests/upconcat_digits_cpu.py [--batch 2 32] [--feed dec1]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def jax_d_kernel(d, f):
    """JAX's (C, 4F) d_kernel of the tool's inputs and its row tile."""
    import jax
    import jax.numpy as jnp

    from unet_image_segmentation_tpu.ops.pallas import fused_upconcat as jfu

    x, kernel = jnp.asarray(d["x"]), jnp.asarray(d["kernel"])
    b, h, w, c = x.shape
    skip = jnp.zeros((b, 2 * h, w, 2 * f), jnp.float32)   # packed at p = 2
    bias = jnp.zeros((f,), jnp.float32)
    meta = jfu._supported(x, kernel, skip, 2)
    if meta is None:
        raise SystemExit(f"the JAX kernel does not take x {x.shape}")
    _, vjp = jax.vjp(lambda x_, k_: jfu.fused_upconcat(x_, k_, bias, skip, 2), x, kernel)
    # the cat cotangent (B,2H,2W,2F) packed at p = 2: (B,2H,W,4F)
    dk = vjp(jnp.asarray(d["g"]).reshape(b, 2 * h, w, 4 * f))[1]
    return np.asarray(jnp.transpose(dk, (3, 0, 1, 2)).reshape(c, 4 * f)), meta[0]


def main(argv=None) -> int:
    import torch

    from unet_image_segmentation_tpu_torch.troubleshoot import dpw_digits as dd
    from unet_image_segmentation_tpu_torch.troubleshoot import upconcat_digits as ud

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, nargs="+", default=[2, 32])
    p.add_argument("--feed", default="dec1", choices=sorted(ud.FEEDS))
    p.add_argument("--out", default=os.path.join("build", "upconcat_digits_cpu.json"))
    args = p.parse_args(argv)
    c, f, h = ud.FEEDS[args.feed]
    tile = ud.TILE
    results = []
    for batch in args.batch:
        d = ud.inputs(batch, c, f, h)
        t0 = time.perf_counter()
        got, th = jax_d_kernel(d, f)
        t_jax = time.perf_counter() - t0
        m = d["x"].reshape(-1, c)[:, :tile]
        g = ud.dup_of(torch.from_numpy(d["g"]), f)[:, :tile].contiguous().numpy()
        del d
        ref = dd.exact(m, g)
        rows = th // 2 * h
        if th != ud.jax_tile_rows(2 * h, h, c, f):
            raise SystemExit(f"the tool's JAX tile {ud.jax_tile_rows(2 * h, h, c, f)} is not "
                             f"the JAX kernel's {th}")
        err = {"jax": dd.rel_err(got[:tile, :tile], ref),
               "jax_tiles": dd.rel_err(ud.jax_order(m, g, rows), ref)}
        res = {"feed": args.feed, "shape": [batch, h, h, c, f], "tile": [tile, tile],
               "jax_tile_rows": th, "jax_tile_pixels": rows, "jax_seconds": t_jax,
               "rel_err": err}
        results.append(res)
        print(f"{args.feed} {res['shape']}: max err / max|fp64| on a {tile}x{tile} tile: JAX "
              f"(fused_upconcat._bwd_kernel, interpret mode, {m.shape[0] // rows} tiles of "
              f"{rows} pixels) {err['jax']:.3e}; the tool's emulation of its order "
              f"{err['jax_tiles']:.3e} (JAX's backward in {t_jax:.1f} s)", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
