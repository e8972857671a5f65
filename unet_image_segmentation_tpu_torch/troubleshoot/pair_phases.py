"""Where K7's time goes inside a CTA, stage by stage, on the card.

Builds ``csrc/sepconv_pair.cu`` alone with ``-DUNET_PAIR_PHASES`` (thread 0
of every CTA stamps ``clock64`` at the marks below; the kernel library
proper carries none of them), runs it at the nine stage shapes of the
256 px U-Net at batch 32 in bf16 and fp32, and prints each stage's time
(CUDA events, the instrumented build) beside the mean cycles a CTA spends
in each phase (:data:`PHASES`). A CTA's cycles include the time its SM gave
to the other CTA it holds (two a SM where registers and shared memory
allow), so they are shares of a CTA's life, not its own work.

Writes ``build/pair_phases.json``. Needs a CUDA card::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.pair_phases \\
        [--iters 5] [--batch 32] [--out build/pair_phases.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
from unet_image_segmentation_tpu_torch.ops.kernels import build
from unet_image_segmentation_tpu_torch.troubleshoot import roofline

HW = 256
FILTERS = (64, 128, 256, 512)
SEED = 2301
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "pair_phases.json")
# the spans between the kernel's PAIR_PHASE marks, in order
PHASES = (
    "staging",    # the slice's affines and dw2 taps requested
    "x chunk 0",  # chunk 0's x halo tile, dw1 taps and pw1 rows requested
    "wait",       # the cluster's first barrier; chunk 0 landed
    "block 1",    # dw1 on the ring and GEMM1 over every chunk, the cluster barriers
    "y1",         # GEMM2's first weights requested; y1 = relu(affine) into shared memory
    "dw2",        # block 2's depthwise, then the cluster barrier
    "GEMM2",      # over every CTA's d2 slice
    "epilogue",   # y2, the pool and their stores
)


def stage_inputs(gen: torch.Generator, dev, dtype, batch: int, stage: tuple):
    """Seeded K7 inputs at one stage: ``(x, w1, w2, pool, x2)``."""
    _, cx, cx2, f1, f2, h, mode = stage

    def rnd(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * scale

    def weights(c, f):
        return fs.prepare_block({
            "depthwise_kernel": rnd(3, 3, c, 1, scale=(6 / (9 * c + 9)) ** 0.5),
            "pointwise_kernel": rnd(1, 1, c, f, scale=(6 / (c + f)) ** 0.5),
            "scale": 1 + 0.5 * rnd(f), "offset": 0.1 * rnd(f),
            "mean": 0.1 * rnd(f), "var": 0.02 + 0.05 * rnd(f).abs(),
        }, dtype, device=dev)

    w1, w2 = weights(cx + cx2, f1), weights(f1, f2)
    x = rnd(batch, h, h, cx).to(dev, dtype)
    x2 = rnd(batch, h, h, cx2).to(dev, dtype) if cx2 else None
    return x, w1, w2, mode == "pool", x2


def measure(lib, x, w1, w2, pool, x2, iters: int) -> dict:
    """One stage: its mean time a call and the mean cycles of a CTA a phase."""
    b, h, w = x.shape[:3]
    plan = fs.pair_plan(h, w, x.shape[-1] + (x2.shape[-1] if x2 is not None else 0),
                        w1.pw.shape[-1], w2.pw.shape[-1], x.dtype, b)
    ctas = plan.grid[0] * plan.grid[1]
    marks = torch.zeros((ctas, len(PHASES)), dtype=torch.int64, device=x.device)
    build.check(lib.unet_pair_phases_buffer(marks.data_ptr()), "unet_pair_phases_buffer")
    fs.pair_launch(lib, x, w1, w2, pool, x2)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fs.pair_launch(lib, x, w1, w2, pool, x2)
    end.record()
    torch.cuda.synchronize()
    cum = marks.double().mean(dim=0).tolist()
    cycles = [c - p for c, p in zip(cum, [0.0] + cum[:-1])]
    return {"ms": start.elapsed_time(end) / iters, "ctas": ctas, "cluster": plan.n,
            "cycles_per_cta": cum[-1], "phase_cycles": dict(zip(PHASES, cycles))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("pair_phases: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib = build.load_variant("sepconv_pair.cu", ["UNET_PAIR_PHASES"])
    lib.unet_pair_phases_buffer.argtypes = [ctypes.c_void_p]
    lib.unet_pair_phases_buffer.restype = ctypes.c_int
    card = roofline.card()
    print(f"K7 phases, batch {args.batch}, {HW} px: ms a call (instrumented build), mean "
          f"cycles a CTA, and its share a phase [{card}]")
    rows = {}
    gen = torch.Generator().manual_seed(SEED)
    for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for stage in roofline.stage_shapes(HW, FILTERS):
            row = measure(lib, *stage_inputs(gen, dev, dtype, args.batch, stage), args.iters)
            rows[f"{stage[0]} {dname}"] = row
            shares = ", ".join(f"{k} {100 * v / row['cycles_per_cta']:.0f}%"
                               for k, v in row["phase_cycles"].items())
            print(f"  {stage[0]} {dname}: {row['ms']:.3f} ms, {row['ctas']} CTAs in clusters "
                  f"of {row['cluster']}, {row['cycles_per_cta']:.0f} cycles a CTA: {shares}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "batch": args.batch, "stages": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
