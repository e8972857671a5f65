"""Per-kernel attribution of the fused train step's device time on the card.

Port of ``unet_image_segmentation_tpu/troubleshoot/step_attribution.py``.
Profiles the 256 px, batch-32, bf16 fused train step (``use_pallas``, the
default ``Config`` otherwise: dice, ``fused_head`` 'auto', so K5 runs) with
:func:`..utils.profiling.trace`, reads the Chrome trace with
:mod:`.profile_summary`, and maps every device kernel to its source: each
``__global__`` entry of ``ops/kernels/csrc/`` is a site (``file:line``,
found by scanning the sources) with its K label and part
(:data:`.roofline.ENTRIES`); every other kernel is PyTorch glue, rolled up
by kernel family (``--glue-detail`` also lists the largest glue kernels
one by one). The JAX tool maps HLO ops to ``source_file:line``; here the
kernel names are the sites.

The record (``build/step_attribution.json`` by default) holds the device,
kernel and glue ms a step, the ms and launches a step of each site, each
kernel's ms, launches and bound (:func:`.roofline.bounds_ms` over the
step's shapes), the launches the wrappers' own counters saw, the wall time a
step under the profiler and the device's idle share. It fails when the
trace holds no device time or fewer kernels than the host launched, when
the device was busier than the wall clock allows on one stream, or when
sites and glue do not add up to the busy time.

Usage (needs a CUDA card)::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.step_attribution \\
        [--warmup 12] [--steps 10] [--glue-detail] [--out build/step_attribution.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from unet_image_segmentation_tpu_torch.ops.kernels import build
from unet_image_segmentation_tpu_torch.troubleshoot import profile_summary, roofline
from unet_image_segmentation_tpu_torch.utils.profiling import hard_sync, trace

HW = 256
BATCH = 32
STEPS = 10
WARMUP = 12
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "step_attribution.json")
# share by which the profiler's device time may exceed the events' wall
# time, and by which sites plus glue may differ from the busy time (the two
# clocks' jitter; one stream runs the step, so kernels do not overlap)
JITTER = 0.02
GLUE_MIN_MS = 0.05        # glue families listed in the record
GLUE_OP_MIN_MS = 0.03     # glue kernels listed one by one with --glue-detail
STEP_SPAN = "step_attribution.step"   # the record_function span of an attributed step

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def kernel_sites(csrc=build.CSRC) -> Dict[str, str]:
    """``__global__`` entry -> ``file:line`` of its definition, for every
    CUDA source and header under ``csrc`` (comments skipped)."""
    sites = {}
    for path in sorted(list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh"))):
        text = re.sub(r"//[^\n]*", lambda m: " " * len(m.group()), path.read_text())
        for m in _GLOBAL.finditer(text):
            sites[m.group(1)] = f"{path.name}:{text.count(chr(10), 0, m.start()) + 1}"
    return sites


def glue_family(name: str) -> str:
    """A PyTorch kernel's family: its function's base name and, where its
    template arguments name one, the innermost operation it runs (a
    functor, or a ``*_cuda``/``*_impl``/``*_out``/``*_scalar`` function)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    base = re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()
    head = name[:name.rfind("(")] if "(" in name else name
    ops = re.findall(r"[A-Za-z_]\w*(?:[Ff]unctor\w*|_cuda|_impl|_out|_scalar)\b",
                     head.split("<", 1)[1] if "<" in head else "")
    return f"{base}[{ops[-1]}]" if ops else base


def attribute(summary: dict, steps: int, sites: Dict[str, str]) -> dict:
    """Split a :func:`.profile_summary.summarize` result over ``steps``
    steps into the port's kernel sites and PyTorch glue, per step."""
    entry_ms, entry_n, glue, glue_ops = {}, {}, {}, []
    for name, ms in {**summary["kernels"], **summary["copies"]}.items():
        n = summary["launches"][name]
        entry = roofline.entry_of(name) if name in summary["kernels"] else None
        if entry is None:
            fam = glue_family(name)
            glue[fam] = glue.get(fam, 0.0) + ms / steps
            glue_ops.append((ms / steps, n / steps, name))
            continue
        entry_ms[entry] = entry_ms.get(entry, 0.0) + ms
        entry_n[entry] = entry_n.get(entry, 0) + n
    calls = roofline.wrapper_launches(entry_n)
    per_site, site_launches, per_kernel = {}, {}, {}
    for entry, ms in sorted(entry_ms.items(), key=lambda kv: -kv[1]):
        site = f"{sites.get(entry, '?')} {entry}"
        per_site[site], site_launches[site] = ms / steps, entry_n[entry] / steps
        wrapper = roofline.ENTRIES[entry][0] or roofline.SUMS
        row = per_kernel.setdefault(wrapper, {
            "label": roofline.label_of(entry), "ms": 0.0,
            "launches": calls.get(wrapper, entry_n[entry]) / steps})
        row["ms"] += ms / steps
    return {
        "device_ms_per_step": summary["busy_ms"] / steps,
        "kernel_ms_per_step": sum(per_site.values()),
        "glue_ms_per_step": sum(glue.values()),
        "per_site_ms": per_site,
        "per_site_launches": site_launches,
        "per_kernel": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1]["ms"])),
        "glue_ms": dict(sorted(glue.items(), key=lambda kv: -kv[1])),
        "glue_ops": [{"ms": ms, "launches": n, "kernel": name}
                     for ms, n, name in sorted(glue_ops, reverse=True)],
        "trace_idle_share": summary["idle_share"],
    }


def _counters():
    from unet_image_segmentation_tpu_torch.ops import (
        fused_head, fused_sepconv, fused_train, fused_upconcat)

    return fused_train, fused_upconcat, fused_head, fused_sepconv


def profile_train_step(step, state, x, m, device, steps: int, warmup: int, shapes=None,
                       batch: Optional[int] = None, dname: str = "bfloat16",
                       trace_dir: Optional[str] = None, glue_detail: bool = False) -> dict:
    """Run ``warmup`` steps, then trace one lead-in step and ``steps`` steps
    of ``step(state, x, m)`` on the card, and attribute the device time of
    the ``steps`` steps (:func:`attribute`); their wall time a step is the
    stream's, from CUDA events around them.
    ``shapes`` (wrapper -> call shapes, :func:`.roofline.train_step_shapes`)
    at ``batch`` in ``dname`` gives each kernel's bound. The trace goes to
    ``trace_dir`` (emptied first), else to a temporary directory."""
    from torch.profiler import record_function

    for _ in range(warmup):
        step(state, x, m)
    hard_sync(device)
    mods = _counters()
    tmp = None
    if trace_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="unet_attr_")
        trace_dir = tmp.name
    else:
        shutil.rmtree(trace_dir, ignore_errors=True)
    try:
        with trace(trace_dir, device):
            # a lead-in step, then the steps, queued behind it with no gap
            # on the stream (the events time the stream, not the host)
            step(state, x, m)
            for mod in mods:
                mod.reset_launch_counts()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(steps):
                with record_function(STEP_SPAN):
                    step(state, x, m)
            end.record()
            hard_sync(device)
            wall = start.elapsed_time(end) / steps
        summary = profile_summary.summarize(trace_dir, within=STEP_SPAN)
    finally:
        if tmp is not None:
            tmp.cleanup()
    counters = {k: v / steps for mod in mods for k, v in mod.LAUNCHES.items() if v}
    rec = attribute(summary, steps, kernel_sites())
    if not glue_detail:
        rec.pop("glue_ops")
    else:
        rec["glue_ops"] = [op for op in rec["glue_ops"] if op["ms"] >= GLUE_OP_MIN_MS]
    rec["glue_ms"] = {k: v for k, v in rec["glue_ms"].items() if v >= GLUE_MIN_MS}
    busy = rec["device_ms_per_step"]
    if busy <= 0:
        raise AssertionError("torch.profiler traced no device time")
    profile_summary.check_complete(summary, "step_attribution")
    if busy > wall * (1 + JITTER):
        raise AssertionError(f"device busy {busy:.3f} ms a step exceeds the wall time "
                             f"{wall:.3f} ms")
    total = rec["kernel_ms_per_step"] + rec["glue_ms_per_step"]
    if abs(total - busy) > JITTER * busy:
        raise AssertionError(f"sites {rec['kernel_ms_per_step']:.3f} + glue "
                             f"{rec['glue_ms_per_step']:.3f} ms != busy {busy:.3f} ms")
    for wrapper, row in rec["per_kernel"].items():
        if shapes and wrapper in shapes:
            row["bound_ms"], row["bound_by"] = roofline.sum_bounds(wrapper, shapes[wrapper],
                                                                   dname, batch)
    rec.update(steps=steps, warmup=warmup, wall_ms_per_step=wall, idle_share=1 - busy / wall,
               counter_launches_per_step=counters)
    return rec


def build_step(device, image: int = HW, batch: int = BATCH):
    """The step ``step_attribution`` profiles, as the JAX tool builds it:
    the default ``Config`` at ``image`` px, bf16, ``use_pallas``, ``batch``;
    seeded weights and seeded numpy inputs. Returns (cfg, state, step, x, m)."""
    from unet_image_segmentation_tpu_torch.config import Config
    from unet_image_segmentation_tpu_torch.train.state import create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step

    cfg = Config().override(model__image_height=image, model__image_width=image,
                            model__compute_dtype="bfloat16", model__use_pallas=True,
                            train__batch_size=batch)
    state = create_train_state(cfg, device=device)
    step = make_train_step(state.model, cfg.train.loss)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, image, image, 3).astype(np.float32)).to(device)
    m = torch.from_numpy((rng.rand(batch, image, image, 1) > 0.5).astype(np.float32)).to(device)
    return cfg, state, step, x, m


def print_record(rec: dict, top: int = 8) -> None:
    print(f"wall {rec['wall_ms_per_step']:.3f} ms a step under the profiler; device busy "
          f"{rec['device_ms_per_step']:.3f} (kernels {rec['kernel_ms_per_step']:.3f}, glue "
          f"{rec['glue_ms_per_step']:.3f}), idle share {rec['idle_share']:.4f}")
    print(f"  {'kernel':<15} {'label':<5} {'ms/step':>9} {'launches':>8} {'bound ms':>9}  x bound")
    for wrapper, row in rec["per_kernel"].items():
        bound = row.get("bound_ms")
        extra = (f"{bound:9.3f}  {row['ms'] / bound:6.1f} ({row['bound_by']})"
                 if bound else f"{'-':>9}")
        print(f"  {wrapper:<15} {row['label']:<5} {row['ms']:9.3f} {row['launches']:8.1f} "
              f"{extra}")
    for site, ms in rec["per_site_ms"].items():
        print(f"    {site:<45} {ms:9.3f} ms {rec['per_site_launches'][site]:6.1f}x")
    print("  glue families, ms a step: " + "; ".join(
        f"{k} {v:.3f}" for k, v in list(rec["glue_ms"].items())[:top]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    p.add_argument("--warmup", type=int, default=WARMUP)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--glue-detail", action="store_true",
                   help="also list the largest PyTorch glue kernels one by one")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_attribution: no CUDA device is available; it attributes the card's "
              "device time", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    cfg, state, step, x, m = build_step(device)
    mc = cfg.model
    rec = profile_train_step(
        step, state, x, m, device, args.steps, args.warmup,
        shapes=roofline.train_step_shapes(mc.image_height, mc.filters, mc.num_classes),
        batch=BATCH, dname=mc.compute_dtype,
        trace_dir=os.path.splitext(args.out)[0] + "_trace", glue_detail=args.glue_detail)
    rec = {"config": f"{HW}px b{BATCH} {mc.compute_dtype} fused train step (use_pallas, "
                     f"fused_head {mc.fused_head}), {args.steps} steps after {args.warmup}",
           "card": roofline.card(), **rec}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=2)
    print(rec["config"] + f" [{rec['card']}]")
    print_record(rec)
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
