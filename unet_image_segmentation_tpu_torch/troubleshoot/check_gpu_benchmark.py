"""CPU-vs-GPU matmul micro-benchmark.

Port of ``unet_image_segmentation_tpu/troubleshoot/check_tpu_benchmark.py``
in the shape of the reference's own ``check_gpu_benchmark.py``: a 4096x4096
matmul, warm-ups, then repeated trials, timed on the CPU in fp32 and on the
card in fp32 (TF32 off, so full fp32 on the CUDA cores) and bf16 (the
tensor cores), each against the card's peak for its type, with the
reference's speedup bands (> 1.1x faster, < 0.9x slower). ``torch.matmul``
is what it measures: the tool checks the installed library, not the port's
kernels. Exit code 1 when no card is present.

Usage: python -m unet_image_segmentation_tpu_torch.troubleshoot.check_gpu_benchmark
       [--matrix 4096] [--warmup 3] [--trials 20] [--runs 3] [--cpu-trials N] [--cpu-runs N]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import List

import numpy as np
import torch

from unet_image_segmentation_tpu_torch.troubleshoot import roofline


def benchmark_matmul(device: torch.device, dtype: torch.dtype, n: int, warmup: int,
                     trials: int, runs: int) -> List[float]:
    """Seconds per ``n``x``n`` matmul, one mean per run of ``trials``."""
    a = torch.from_numpy(np.random.RandomState(0).randn(n, n).astype(np.float32))
    a = a.to(device=device, dtype=dtype)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    times = []
    for _ in range(runs):
        for _ in range(warmup):
            torch.matmul(a, a)
        sync()
        t0 = time.perf_counter()
        for _ in range(trials):
            torch.matmul(a, a)
        sync()
        times.append((time.perf_counter() - t0) / trials)
    return times


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--matrix", type=int, default=4096)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--cpu-trials", type=int, default=None, help="trials of the CPU leg "
                   "(default --trials; a 4096^3 CPU matmul is ~137 GFLOP)")
    p.add_argument("--cpu-runs", type=int, default=None, help="runs of the CPU leg "
                   "(default --runs)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_gpu_benchmark: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = torch.device("cuda")
    print(f"card {roofline.card()}; {args.matrix}x{args.matrix} matmul, TF32 off "
          "(fp32 runs in full fp32)")
    flops = 2 * args.matrix ** 3
    legs = [("cpu/fp32", torch.device("cpu"), torch.float32, "float32",
             args.cpu_trials or args.trials, args.cpu_runs or args.runs),
            ("cuda/fp32", gpu, torch.float32, "float32", args.trials, args.runs),
            ("cuda/bf16", gpu, torch.bfloat16, "bfloat16", args.trials, args.runs)]
    results = {}
    for label, device, dtype, dname, trials, runs in legs:
        times = benchmark_matmul(device, dtype, args.matrix, args.warmup, trials, runs)
        mean = statistics.mean(times)
        std = statistics.stdev(times) if len(times) > 1 else 0.0
        tflops = flops / mean / 1e12
        results[label] = mean
        peak = "" if device.type == "cpu" else (
            f", {100 * tflops * 1e12 / roofline.PEAK_OPS_PER_S[dname]:.1f}% of the card's "
            f"{roofline.PEAK_OPS_PER_S[dname] / 1e12:.0f} TFLOP/s")
        print(f"  {label}: {mean * 1e3:.3f} ms +- {std * 1e3:.3f} over {runs} run(s) of "
              f"{trials} ({tflops:.2f} TFLOP/s{peak})")
    best = min((k for k in results if k.startswith("cuda")), key=results.get)
    speedup = results["cpu/fp32"] / results[best]
    if speedup > 1.1:
        print(f"the card ({best}) is {speedup:.1f}x FASTER than the CPU")
    elif speedup < 0.9:
        print(f"the card ({best}) is {1 / speedup:.1f}x SLOWER than the CPU (!)")
    else:
        print("the card and the CPU perform similarly (!)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
