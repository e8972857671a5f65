"""K10's fp32 ``dpw`` against fp64 in the JAX package's order and in the
port's pass-(b) order, on the CPU: a diagnostic, not a test (pytest does
not collect it).

The inputs are ``troubleshoot/dpw_digits.inputs(batch)``: seeded numpy, the
same on every machine, so the port's kernel run on the card
(``python -m unet_image_segmentation_tpu_torch.troubleshoot.dpw_digits
--batch 2``) meets the same numbers. JAX's order is its per-block backward
as the JAX package runs it on the CPU: ``fused_sepconv_bwd.sepconv_bwd_pallas``
in interpret mode (``dpw_tile`` a row tile, summed over the tiles and the
images), or, where no lane packing fits (C = 3 at enc1.1), the composed-XLA
VJP of ``fused_sepconv._stats_reference`` that the package falls back to.
The port's orders (ii)-(iv) of ``dpw_digits`` run from the port's plain
fp32 ``m``. Each line: max |dpw - fp64| / max|fp64|, fp64 of the same fp32
``m`` and ``g``.

Usage (from the repository root)::

    JAX_PLATFORMS=cpu python tests/dpw_digits_cpu.py [--batch 2] [--block enc1.1 enc1.2]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCKS = {"enc1.1": (3, 64, 256), "enc1.2": (64, 64, 256)}


def jax_dpw(d):
    import jax
    import jax.numpy as jnp

    from unet_image_segmentation_tpu.ops.pallas import fused_sepconv as jfs
    from unet_image_segmentation_tpu.ops.pallas import fused_sepconv_bwd as jfsb

    x, g, dw, pw = (jnp.asarray(d[k]) for k in ("x", "g", "dw", "pw"))
    grads = jfsb.sepconv_bwd_pallas(x, g, dw, pw, interpret=True)
    if grads is not None:
        return np.asarray(grads[2]), "fused_sepconv_bwd._bwd_kernel (interpret mode)"
    f = pw.shape[1]
    _, vjp = jax.vjp(jfs._stats_reference, x, dw, pw)
    zero = jnp.zeros((f,), jnp.float32)
    return np.asarray(vjp((g, zero, zero))[2]), "composed-XLA VJP of _stats_reference"


def main(argv=None) -> int:
    import torch

    from unet_image_segmentation_tpu_torch.ops import fused_train as ft
    from unet_image_segmentation_tpu_torch.troubleshoot import dpw_digits as dd

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--block", nargs="+", default=["enc1.1"], choices=sorted(BLOCKS))
    p.add_argument("--out", default=os.path.join("build", "dpw_digits_cpu.json"))
    args = p.parse_args(argv)
    results = []
    for name in args.block:
        c, f, hw = BLOCKS[name]
        d = dd.inputs(args.batch, c, f, hw)
        t0 = time.perf_counter()
        got, how = jax_dpw(d)
        t_jax = time.perf_counter() - t0
        m = ft._depthwise(torch.from_numpy(d["x"]), torch.from_numpy(d["dw"]))
        m = m.reshape(-1, c).numpy()
        plan = ft.chain_bwd_plan(args.batch, hw, hw, c, f, torch.float32, bias=True)
        err = dd.decompose(m, d["g"].reshape(-1, f), plan.per, plan.splits)
        err["jax"] = dd.rel_err(got, dd.exact(m, d["g"].reshape(-1, f)))
        res = {"block": name, "shape": [args.batch, hw, hw, c, f], "splits": plan.splits,
               "per": plan.per, "jax_path": how, "jax_seconds": t_jax, "rel_err": err,
               "port_over_jax": err["fp32"] / err["jax"]}
        results.append(res)
        print(f"{name} {res['shape']}: max err / max|fp64|: JAX ({how}) {err['jax']:.3e}; "
              f"port (ii) fp32 FMA in pass (b)'s order ({plan.splits} x {plan.per}) "
              f"{err['fp32']:.3e}, (iii) 3xTF32 products {err['3xtf32']:.3e}, (iv) one split "
              f"{err['fp32_one_split']:.3e}; (ii) / JAX {res['port_over_jax']:.2f}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
