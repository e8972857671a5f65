"""K12b's instructions and the rate it sustains, on the card's machine.

Compiles ``csrc/probes.cu`` to a cubin with the build's flags and counts
the SASS opcodes of each FMA-probe kernel (``cuobjdump -sass``): whether
bf16's ``__hfma2`` is a native ``HFMA2.BF16_V2``, or conversions and fp32
``FFMA``. Then times K12b (``ops/probes.fma_probe``, from a CUDA graph as
``link_floors`` does) at phase 12's shape and at longer runs, more steps
and more elements, where the launch's ramp and tail weigh less: the rate
it sustains against its bound. Writes ``build/probe_sass.json``::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.probe_sass
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict

import numpy as np

from unet_image_segmentation_tpu_torch.troubleshoot import roofline

# (elements, steps): phase 12's, then 8x the steps, 8x the elements, both
RUNS = ((1024 * 512, 2048), (1024 * 512, 16384), (8 * 1024 * 512, 2048),
        (8 * 1024 * 512, 16384))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "probe_sass.json")
_FUNCTION = re.compile(r"Function : (\S+)")
_OPCODE = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)")


def opcode_counts(sass: str) -> Dict[str, Dict[str, int]]:
    """``cuobjdump -sass`` text -> {function: {opcode: count}}."""
    out, fn = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            fn = m.group(1)
            out[fn] = collections.Counter()
            continue
        m = _OPCODE.search(line)
        if m and fn is not None:
            out[fn][m.group(1)] += 1
    return {fn: dict(c.most_common()) for fn, c in out.items()}


def probe_sass() -> Dict[str, Dict[str, int]]:
    """The opcode counts of the FMA-probe kernels of ``csrc/probes.cu``."""
    from unet_image_segmentation_tpu_torch.ops.kernels import build

    out = build.BUILD_DIR / "probe_sass"
    out.mkdir(parents=True, exist_ok=True)
    cubin = out / "probes.cubin"
    cmd = [build._nvcc(), *build.NVCC_FLAGS[:4], "-cubin", "-o", str(cubin),
           str(build.CSRC / "probes.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build._raise_on_failure(cmd, proc.returncode, proc.stdout)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    return {fn: c for fn, c in opcode_counts(sass).items() if "fma_probe" in fn}


def sustained(dname: str, n: int, k: int, device="cuda") -> dict:
    """K12b's ms at ``n`` elements and ``k`` steps, its Gop/s and its share
    of the bound."""
    import torch

    from unet_image_segmentation_tpu_torch.ops import probes
    from unet_image_segmentation_tpu_torch.troubleshoot.link_floors import graph_ms
    from unet_image_segmentation_tpu_torch.utils.profiling import hard_sync

    x = torch.from_numpy(np.random.RandomState(0).rand(n).astype(np.float32) * 1e-3)
    x = x.to(device=device, dtype=getattr(torch, dname))
    probes.fma_probe(x, k)
    hard_sync(device)
    ms = graph_ms(lambda: probes.fma_probe(x, k), 5)
    bound, _ = roofline.bounds_ms("fma_probe", (n, k), dname)
    return {"elements": n, "steps": k, "ms": ms, "gops": 2 * k * n / (ms * 1e-3) / 1e9,
            "bound_ms": bound, "bound_share": bound / ms}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_sass: no CUDA device", file=sys.stderr)
        return 1
    card = roofline.card()
    report = {"card": card, "sass": probe_sass(), "rates": {}}
    for fn, counts in report["sass"].items():
        print(f"{fn}: " + ", ".join(f"{op} {c}" for op, c in list(counts.items())[:8]))
    for dname in ("bfloat16", "float32"):
        report["rates"][dname] = [sustained(dname, n, k) for n, k in RUNS]
        for r in report["rates"][dname]:
            print(f"K12b {dname} {r['elements']} elements x {r['steps']} steps: "
                  f"{r['ms'] * 1e3:.2f} us, {r['gops'] / 1e3:.1f} TFLOP/s, "
                  f"{100 * r['bound_share']:.1f}% of its {r['bound_ms'] * 1e3:.2f} us bound "
                  f"[{card}]", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
