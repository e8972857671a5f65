"""The eval step's images/s of two checkouts of the port, in turns on one card.

``make_eval_step`` (``fit``'s validation step) of the 256 px binary U-Net
(filters 64..512, bottleneck 1024) with ``use_pallas``: 18 K8 launches a
step, at batch 32, fp32 and bf16, TF32 off, seeded weights with BatchNorm
statistics recalibrated on the batch. Each run is a process of its own that
imports the package of one checkout (this one, or ``--against DIR``, e.g.
the parent commit unpacked with ``git archive``); the runs go in the order
other, this, this, other, so that a drift of the card's clocks shows as a
spread and not as a difference. Each run takes ``--rounds`` rates of
``--reps`` steps each on the host clock, after warm-up steps, and checks
the step's K8 launches with that checkout's counter. Each run also takes
the host's cost of one K8 call, ``fused_sepconv.sepconv_block`` at a
shape so small that the launch bounds it ((1, 8, 8, 8) fp32): µs a call
over ``CALLS`` calls, ``--rounds`` times, which bounds what the wrapper's
dispatch adds to a step (18 calls).

    python -m unet_image_segmentation_tpu_torch.troubleshoot.eval_ab --against DIR

Prints each run's rates and, per dtype, each checkout's mean and range
beside the card's name and power limit; writes ``build/eval_ab.json``.
Exit code 1 when no card is present or a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FILTERS = (64, 128, 256, 512)
IMAGE, BATCH, K8_LAUNCHES = 256, 32, 18
DTYPES = ("float32", "bfloat16")
RUN_TIMEOUT = 900   # a checkout's first run builds its kernels
CALLS = 2000


def child(rounds: int, reps: int, seed: int) -> dict:
    """One run, in a process whose ``unet_image_segmentation_tpu_torch`` is
    the checkout's under test."""
    import torch

    import unet_image_segmentation_tpu_torch as pkg
    from unet_image_segmentation_tpu_torch.models.unet import UNet, recalibrate_batch_norm
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
    from unet_image_segmentation_tpu_torch.train.steps import make_eval_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(BATCH, IMAGE, IMAGE, 3, generator=gen).to(dev)
    m = (torch.rand(BATCH, IMAGE, IMAGE, 1, generator=gen) > 0.5).float().to(dev)
    plain = UNet(filters=FILTERS, generator=torch.Generator().manual_seed(seed), device=dev)
    recalibrate_batch_norm(plain, x)
    out = {"package": os.path.dirname(pkg.__file__),
           "k8_registered_op": hasattr(fs, "sepconv_block_op"), "rates": {}, "loss": {}}
    for dname in DTYPES:
        model = UNet(filters=FILTERS, dtype=getattr(torch, dname), use_pallas=True, device=dev)
        model.load_state_dict(plain.state_dict())
        step = make_eval_step(model, "dice")
        fs.reset_launch_counts()
        loss = float(step(None, x, m)["loss"])
        torch.cuda.synchronize()
        if fs.LAUNCHES["sepconv_block"] != K8_LAUNCHES:
            raise AssertionError(f"{dname}: {fs.LAUNCHES['sepconv_block']} K8 launches a step, "
                                 f"expected {K8_LAUNCHES}")
        for _ in range(3):
            step(None, x, m)
        torch.cuda.synchronize()
        rates = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                step(None, x, m)
            torch.cuda.synchronize()
            rates.append(reps * BATCH / (time.perf_counter() - t0))
        out["rates"][dname], out["loss"][dname] = rates, loss
    c = 8
    xs = torch.rand(1, 8, 8, c, generator=gen).to(dev)
    w = fs.BlockWeights(torch.rand(3, 3, c, generator=gen).to(dev),
                        torch.rand(c, c, generator=gen).to(dev),
                        torch.ones(c, device=dev), torch.zeros(c, device=dev))
    for _ in range(200):
        fs.sepconv_block(xs, w)
    out["k8_call_us"] = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fs.sepconv_block(xs, w)
        torch.cuda.synchronize()
        out["k8_call_us"].append(1e6 * (time.perf_counter() - t0) / CALLS)
    return out


def run(root: str, args) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", "--rounds", str(args.rounds),
         "--reps", str(args.reps), "--seed", str(args.seed)],
        cwd=root, env=env, capture_output=True, text=True, timeout=RUN_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {root} failed:\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if os.path.realpath(res["package"]) != os.path.realpath(
            os.path.join(root, "unet_image_segmentation_tpu_torch")):
        raise RuntimeError(f"run in {root} imported {res['package']}")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", type=str, help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--seed", type=int, default=2301)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.rounds, args.reps, args.seed)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("eval_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if not args.against:
        p.error("--against DIR is required")
    from unet_image_segmentation_tpu_torch.troubleshoot import roofline

    smi = roofline.card()
    other = os.path.abspath(args.against)
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        res = run(root, args)
        runs.append({"checkout": label, "root": root, **res})
        print(f"{label} ({root}, K8 a registered op: {res['k8_registered_op']}): " + "; ".join(
            f"{d} " + " / ".join(f"{r:.1f}" for r in res["rates"][d]) + " images/s"
            for d in DTYPES) + "; a K8 call on the host " +
            " / ".join(f"{t:.2f}" for t in res["k8_call_us"]) + f" µs [{smi}]", flush=True)
    summary = {"k8_call_us": {}}
    for label in ("other", "this"):
        calls = [t for run_ in runs if run_["checkout"] == label for t in run_["k8_call_us"]]
        summary["k8_call_us"][label] = statistics.mean(calls)
    print(f"a K8 call on the host, µs: other {summary['k8_call_us']['other']:.2f}, this "
          f"{summary['k8_call_us']['this']:.2f}; {K8_LAUNCHES} a step")
    for d in DTYPES:
        summary[d] = {}
        for label in ("other", "this"):
            rates = [r for run_ in runs if run_["checkout"] == label for r in run_["rates"][d]]
            summary[d][label] = {"mean": statistics.mean(rates), "min": min(rates),
                                 "max": max(rates)}
        a, b = summary[d]["other"], summary[d]["this"]
        print(f"{d} eval step at batch {BATCH}, images/s: other {a['mean']:.1f} "
              f"({a['min']:.1f}-{a['max']:.1f}), this {b['mean']:.1f} "
              f"({b['min']:.1f}-{b['max']:.1f}), this / other {b['mean'] / a['mean']:.4f} "
              f"[{smi}]")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "eval_ab.json"), "w") as f:
        json.dump({"card": smi, "runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
