#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's serving path on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its lines; any failure ends the run with a non-zero
exit code and no result line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels from ``csrc/*.cu`` with nvcc for sm_90a;
3. K8 (one sepconv block) against its plain PyTorch version at every block
   shape of the 256x256 binary U-Net, batch 2, fp32 and bf16;
4. K7 (a fused block pair) likewise at the nine stage shapes, ``pool=True``
   on the encoder stages and ``x2`` on the decoder stages;
5. the main path at full width (filters 64..512, bottleneck 1024, 256x256):
   a port checkpoint of seeded weights, ``Predictor(use_pallas=True)``
   answering batches of 1, 5 (bucketed to 8) and 32 in fp32 and bf16, held
   against a ``Predictor`` with kernels off on the same card; the module
   path with ``use_pallas=True`` (K8 in every ConvBlock) likewise; the
   launch counters of that run; images/s at batch 32, kernels on and off;
6. each kernel's time at batch 32 beside its plain version's, summed over
   the path's shapes, then the kernels' JSON line and the result line.

TF32 is off throughout (``allow_tf32 = False`` for matmul and cuDNN), so the
plain versions compute in full fp32 like the kernels. Relative errors are
``max|kernel - plain| / max|plain|``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPORT = os.path.join(ROOT, "build", "chip_smoke.json")  # all numbers of the run

IMAGE = 256
FILTERS = (64, 128, 256, 512)
BATCH_CHECK = 2          # batch of the kernel comparisons
BATCH_SERVE = 32         # batch of the throughput runs and kernel timings
REQUESTS = (1, 5, 32)    # 5 runs in the bucket of 8
SEED = 2301

# kernel vs plain, relative to max|plain|: fp32 differs only by summation
# order; bf16 may differ by one bf16 rounding (2^-8) of an intermediate
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Predictor probabilities (max abs) and thresholded-mask agreement, kernels
# on vs off. In bf16 the kernels-off module path rounds to bf16 after every
# op (depthwise, pointwise, BN) where the kernels round only where the JAX
# serving graph does, so the two bf16 answers differ by more than bf16 noise.
PROB_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
MASK_MIN_AGREE = {"float32": 0.999, "bfloat16": 0.98}
PAIR_LAUNCHES_PER_FORWARD = 9
BLOCK_LAUNCHES_PER_FORWARD = 18


def stage_shapes():
    """(name, Cx, Cx2, F1, F2, H, mode) of the nine K7 calls at 256 px."""
    shapes, c, h = [], 3, IMAGE
    for s, f in enumerate(FILTERS, 1):
        shapes.append((f"enc{s}", c, 0, f, f, h, "pool"))
        c, h = f, h // 2
    shapes.append(("bneck", c, 0, 2 * c, 2 * c, h, "plain"))
    for s in range(len(FILTERS), 0, -1):
        f = FILTERS[s - 1]
        h *= 2
        shapes.append((f"dec{s}", f, f, f, f, h, "x2"))
    return shapes


def block_shapes():
    """Distinct (C, F, H) of the 18 K8 blocks at 256 px."""
    out = []
    for _, cx, cx2, f1, f2, h, _ in stage_shapes():
        for shape in ((cx + cx2, f1, h), (f1, f2, h)):
            if shape not in out:
                out.append(shape)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from unet_image_segmentation_tpu_torch.inference import Predictor
    from unet_image_segmentation_tpu_torch.models.layers import BatchNorm
    from unet_image_segmentation_tpu_torch.models.unet import UNet, recalibrate_batch_norm
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
    from unet_image_segmentation_tpu_torch.ops.kernels import build
    from unet_image_segmentation_tpu_torch.train.checkpoint import save_inference_variables

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    report = {"stages": {}, "blocks": {}, "predictor": {}}

    # ---- 1. the card -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    report["card"] = smi

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: nvcc {' '.join(build.NVCC_FLAGS[:2])} -> {build.library_path().name}, "
          f"nvcc {build.build_seconds} s, load {time.perf_counter() - t0:.2f} s")

    def rnd(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * scale

    def weights(c, f, dtype):
        blk = {
            "depthwise_kernel": rnd(3, 3, c, 1, scale=(6 / (9 * c + 9)) ** 0.5),
            "pointwise_kernel": rnd(1, 1, c, f, scale=(6 / (c + f)) ** 0.5),
            "scale": 1 + 0.5 * rnd(f), "offset": 0.1 * rnd(f),
            "mean": 0.1 * rnd(f), "var": 0.02 + 0.05 * rnd(f).abs(),
        }
        return fs.prepare_block(blk, dtype, device=dev)

    def rel_err(got, want):
        err = (got.float() - want.float()).abs().max().item()
        return err, err / max(want.float().abs().max().item(), 1e-30)

    worst_abs = {"sepconv_block": 0.0, "sepconv_pair": 0.0}

    def judge(name, label, dtype_name, pairs):
        for got, want in pairs:
            if got.shape != want.shape or not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name} {label} {dtype_name}: bad output {tuple(got.shape)}")
            err, rel = rel_err(got, want)
            worst_abs[name] = max(worst_abs[name], err)
            tol = KERNEL_TOL[dtype_name]
            print(f"  {name} {label} {dtype_name}: max_abs_err {err:.3e} rel {rel:.3e} "
                  f"(tol {tol:g}) {'ok' if rel <= tol else 'FAIL'}")
            if not rel <= tol:
                raise AssertionError(f"{name} {label} {dtype_name}: rel err {rel} > {tol}")

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # ---- 3. K8 vs plain -----------------------------------------------------
    print("K8 sepconv_block vs plain, batch 2:")
    for dname, dtype in dtypes.items():
        for c, f, h in block_shapes():
            w = weights(c, f, dtype)
            x = rnd(BATCH_CHECK, h, h, c).to(dev, dtype)
            got = fs.sepconv_block(x, w)
            want = fs.sepconv_block_reference(x, w)
            torch.cuda.synchronize()
            judge("sepconv_block", f"{c}->{f}@{h}", dname, [(got, want)])

    # ---- 4. K7 vs plain -----------------------------------------------------
    print("K7 sepconv_pair vs plain, batch 2:")
    for dname, dtype in dtypes.items():
        for name, cx, cx2, f1, f2, h, mode in stage_shapes():
            w1, w2 = weights(cx + cx2, f1, dtype), weights(f1, f2, dtype)
            x = rnd(BATCH_CHECK, h, h, cx).to(dev, dtype)
            x2 = rnd(BATCH_CHECK, h, h, cx2).to(dev, dtype) if cx2 else None
            got = fs.sepconv_pair(x, w1, w2, pool=mode == "pool", x2=x2)
            want = fs.sepconv_pair_reference(x, w1, w2, pool=mode == "pool", x2=x2)
            torch.cuda.synchronize()
            pairs = list(zip(got, want)) if mode == "pool" else [(got, want)]
            label = f"{name} ({cx}{'|%d' % cx2 if cx2 else ''})->{f1}->{f2}@{h} {mode}"
            judge("sepconv_pair", label, dname, pairs)

    # ---- 5. main path -------------------------------------------------------
    print(f"main path: U-Net filters {FILTERS} at {IMAGE}x{IMAGE}, seeded weights")
    model = UNet(filters=FILTERS, generator=gen, device=dev)
    scenes = synthetic_scenes(64, IMAGE, SEED)
    recalibrate_batch_norm(model, torch.from_numpy(scenes[:8]).to(dev))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mean.add_(0.05 * rnd(*m.mean.shape).to(dev) * m.var.sqrt())
                m.var.mul_(1 + 0.2 * rnd(*m.var.shape).to(dev))
    kwargs = {"num_classes": 1, "filters": list(FILTERS), "use_batch_norm": True,
              "conv_type": "separable"}
    state = model.state_dict()
    del model
    with tempfile.TemporaryDirectory() as tmp:
        save_inference_variables(tmp, state, kwargs)
        on = {d: Predictor(tmp, (IMAGE, IMAGE), compute_dtype=d, use_pallas=True, device=dev)
              for d in dtypes}
        off = {d: Predictor(tmp, (IMAGE, IMAGE), compute_dtype=d, use_pallas=False, device=dev)
               for d in dtypes}
    modules = {}
    for dname, dtype in dtypes.items():
        m = UNet(filters=FILTERS, dtype=dtype, use_pallas=True)
        m.load_state_dict(state)
        modules[dname] = m.to(dev)

    # the run whose launches are counted: requests through the kernels
    fs.reset_launch_counts()
    outputs = {}
    for dname in dtypes:
        for n in REQUESTS:
            outputs[(dname, n)] = on[dname].predict(scenes[:n])
        with torch.no_grad():
            outputs[(dname, "module")] = modules[dname](
                torch.from_numpy(scenes[:BATCH_CHECK]).to(dev)).cpu().numpy()
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    forwards = len(REQUESTS) * len(dtypes)
    print(f"launches: {launches} over {forwards} Predictor forwards and "
          f"{len(dtypes)} module forwards")
    want_pair = PAIR_LAUNCHES_PER_FORWARD * forwards
    want_block = BLOCK_LAUNCHES_PER_FORWARD * len(dtypes)
    if launches["sepconv_pair"] != want_pair or launches["sepconv_block"] != want_block:
        raise AssertionError(
            f"expected {want_pair} K7 and {want_block} K8 launches, got {launches}")
    print(f"  K7 launches per Predictor forward: {launches['sepconv_pair'] // forwards}")

    import numpy as np

    for dname in dtypes:
        cases = [(n, on[dname], n) for n in REQUESTS] + [("module", None, BATCH_CHECK)]
        for key, _, n in cases:
            got = outputs[(dname, key)]
            want = off[dname].predict(scenes[:n])
            if got.shape != (n, IMAGE, IMAGE, 1) or not np.isfinite(got).all():
                raise AssertionError(f"bad output {got.shape} for {dname} {key}")
            err = float(np.abs(got - want).max())
            agree = float(((got > 0.5) == (want > 0.5)).mean())
            fg = float((want > 0.5).mean())
            ok = err <= PROB_TOL[dname] and agree >= MASK_MIN_AGREE[dname]
            label = f"batch {key}" if key != "module" else f"module path batch {n}"
            print(f"  {dname} {label}: prob max_abs_err {err:.3e} (tol {PROB_TOL[dname]:g}), "
                  f"mask agreement {agree:.6f} (min {MASK_MIN_AGREE[dname]}), "
                  f"foreground {fg:.3f} {'ok' if ok else 'FAIL'}")
            report["predictor"][f"{dname} {label}"] = {"max_abs_err": err, "mask_agree": agree}
            if not ok:
                raise AssertionError(f"{dname} {label}: kernels disagree with the plain path")

    batch = scenes[:BATCH_SERVE]
    for dname in dtypes:
        rates = {}
        for label, pred in (("on", on[dname]), ("off", off[dname]),
                            ("on", on[dname]), ("off", off[dname])):
            rates.setdefault(label, []).append(images_per_second(pred, batch, torch))
        msg = ", ".join(f"kernels {k} {' / '.join(f'{r:.1f}' for r in v)}"
                        for k, v in rates.items())
        print(f"  Predictor {dname} batch {BATCH_SERVE} images/s: {msg} [{smi}]")
        report["predictor"][f"{dname} images_per_s"] = rates

    # ---- 6. kernel timings --------------------------------------------------
    print(f"kernel timings, batch {BATCH_SERVE}, ms (kernel / plain) [{smi}]:")
    totals = {}
    for dname, dtype in dtypes.items():
        tot = {"sepconv_pair": [0.0, 0.0], "sepconv_block": [0.0, 0.0]}
        for name, cx, cx2, f1, f2, h, mode in stage_shapes():
            w1, w2 = weights(cx + cx2, f1, dtype), weights(f1, f2, dtype)
            x = rnd(BATCH_SERVE, h, h, cx).to(dev, dtype)
            x2 = rnd(BATCH_SERVE, h, h, cx2).to(dev, dtype) if cx2 else None
            kw = dict(pool=mode == "pool", x2=x2)
            t_k = time_ms(lambda: fs.sepconv_pair(x, w1, w2, **kw), torch)
            t_p = time_ms(lambda: fs.sepconv_pair_reference(x, w1, w2, **kw), torch)
            tot["sepconv_pair"][0] += t_k
            tot["sepconv_pair"][1] += t_p
            print(f"  K7 {name} {dtype_label(dname)}: {t_k:.3f} / {t_p:.3f}")
            report["stages"][f"{name} {dname}"] = [t_k, t_p]
            for c, f in ((cx + cx2, f1), (f1, f2)):
                w = weights(c, f, dtype)
                xb = rnd(BATCH_SERVE, h, h, c).to(dev, dtype)
                t_k = time_ms(lambda: fs.sepconv_block(xb, w), torch)
                t_p = time_ms(lambda: fs.sepconv_block_reference(xb, w), torch)
                tot["sepconv_block"][0] += t_k
                tot["sepconv_block"][1] += t_p
                print(f"  K8 {c}->{f}@{h} {dtype_label(dname)}: {t_k:.3f} / {t_p:.3f}")
                report["blocks"][f"{c}->{f}@{h} {dname}"] = [t_k, t_p]
        totals[dname] = tot
        print(f"  {dname} totals over the path: K7 {tot['sepconv_pair'][0]:.3f} / "
              f"{tot['sepconv_pair'][1]:.3f}, K8 {tot['sepconv_block'][0]:.3f} / "
              f"{tot['sepconv_block'][1]:.3f}")

    kernels = []
    for name, src, line in (
        ("sepconv_pair", "sepconv_pair.cu", 903),
        ("sepconv_block", "sepconv_block.cu", 300),
    ):
        t_k, t_p = totals["bfloat16"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"unet_image_segmentation_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": f"unet_image_segmentation_tpu/ops/pallas/fused_sepconv.py:{line}",
            "launches": launches[name],
            "max_abs_err": worst_abs[name],
            "ms": t_k,
            "plain_ms": t_p,
        })
    report["kernels"] = kernels
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1)
    print("ms / plain_ms: bf16, batch 32, summed over the path's 9 pair and 18 block shapes")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def dtype_label(dname):
    return "bf16" if dname == "bfloat16" else "fp32"


def time_ms(fn, torch, reps=10):
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def images_per_second(predictor, batch, torch, reps=5):
    """Host-clock rate of ``Predictor.predict`` (host copies included)."""
    predictor.predict(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        predictor.predict(batch)
    torch.cuda.synchronize()
    return reps * len(batch) / (time.perf_counter() - t0)


def synthetic_scenes(n, size, seed):
    """Document-like scenes in numpy: a bright quadrilateral on a textured
    background, float32 in [0, 1], (n, size, size, 3)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        bg = rng.uniform(0.0, 0.4, 3) + 0.1 * rng.standard_normal((size, size, 1))
        cy, cx = rng.uniform(0.3, 0.7, 2) * size
        hh, hw = rng.uniform(0.15, 0.35, 2) * size
        ang = rng.uniform(-0.6, 0.6)
        u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        inside = (np.abs(u) < hw) & (np.abs(v) < hh)
        img = np.broadcast_to(bg, (size, size, 3)).copy()
        img[inside] = rng.uniform(0.6, 1.0, 3)
        out[i] = np.clip(img, 0.0, 1.0)
    return out


if __name__ == "__main__":
    sys.exit(main())
