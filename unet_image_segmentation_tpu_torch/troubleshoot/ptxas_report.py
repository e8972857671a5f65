"""Registers, stack frames and compile time of the CUDA kernels, by source.

Compiles the sources of ``ops/kernels/csrc/`` named on the command line
(all of them by default) as the library build does, one ``nvcc`` process a
source, all started together, with ``-Xptxas -v`` added, and reads what
ptxas says of each ``__global__`` instance: its registers, its stack frame
and its spill stores and loads. A stack frame means a thread keeps part of
its state in local memory; at 16 warps an SM (the streaming body's CTAs) a
thread has 128 registers. It also reports each source's wall time from the
start to the end of its ``nvcc``: the library build waits for the slowest.

The record (``build/ptxas_report.json`` by default) holds per source its
seconds and per instance the entry (``roofline.entry_of``), its template
arguments (``bf16``/``fp32`` and the integers, in order), registers, stack
frame, spill stores and spill loads. Exit code 1 when ``nvcc`` is missing
or a compile fails, or with ``--no-stack`` when an instance of a source
holds a stack frame.

Usage (needs the CUDA toolkit: the card's machine)::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.ptxas_report \\
        [head.cu head_mc.cu ...] [--no-stack] [--out build/ptxas_report.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

from unet_image_segmentation_tpu_torch.ops.kernels import build
from unet_image_segmentation_tpu_torch.troubleshoot import roofline

OUT = os.path.join(os.path.dirname(build.BUILD_DIR), "ptxas_report.json")

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_TYPES = {"13__nv_bfloat16": "bf16", "f": "fp32"}


def template_args(mangled: str, entry: str) -> List[str]:
    """The template arguments of a mangled instance of ``entry``: ``bf16``
    or ``fp32`` for the dtype, then the integers, in order."""
    at = mangled.find(entry) + len(entry)
    if mangled[at:at + 1] != "I":
        return []
    args, at = [], at + 1
    while at < len(mangled) and mangled[at] != "E":
        kind = next((k for k in _TYPES if mangled.startswith(k, at)), None)
        if kind is not None:
            args.append(_TYPES[kind])
            at += len(kind)
        elif mangled.startswith("Li", at):
            end = mangled.index("E", at)
            args.append(mangled[at + 2:end])
            at = end + 1
        else:
            break
    return args


def parse(log: str) -> List[Dict[str, object]]:
    """Each ``__global__`` instance ptxas reports in ``log``: the entry, its
    template arguments, registers, stack frame and spill bytes."""
    out, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = roofline.entry_of(m.group(1)) or m.group(1)
            cur = {"entry": entry, "args": template_args(m.group(1), entry), "mangled": m.group(1),
                   "registers": None, "stack": 0, "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def compile_sources(names: List[str]) -> Dict[str, Dict[str, object]]:
    """Compile each source with ``-Xptxas -v``, all at once: name -> its
    seconds and instances (:func:`parse`). Raises when a compile fails."""
    nvcc = build._nvcc()
    with tempfile.TemporaryDirectory(prefix="unet_ptxas_") as tmp:
        pending, t0 = {}, time.perf_counter()
        for name in names:
            cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                   os.path.join(tmp, name + ".o"), str(build.CSRC / name)]
            log = open(os.path.join(tmp, name + ".log"), "w+")   # a file: no pipe to fill
            pending[name] = (cmd, log, subprocess.Popen(cmd, stdout=log,
                                                        stderr=subprocess.STDOUT, text=True))
        out = {}
        try:
            while pending:
                for name, (cmd, log, proc) in list(pending.items()):
                    if proc.poll() is None:
                        continue
                    seconds = time.perf_counter() - t0
                    log.seek(0)
                    text = log.read()
                    log.close()
                    del pending[name]
                    build._raise_on_failure(cmd, proc.returncode, text)
                    out[name] = {"seconds": seconds, "instances": parse(text)}
                time.sleep(0.05)
        finally:   # a failed compile stops the others
            for _, log, proc in pending.values():
                proc.kill()
                proc.wait()
                log.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", help="sources under ops/kernels/csrc (default: all)")
    ap.add_argument("--no-stack", action="store_true",
                    help="exit 1 when an instance holds a stack frame")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    names = args.sources or [p.name for p in build._sources()[0]]
    try:
        build._nvcc()
    except RuntimeError as err:
        print(f"FAIL: {err}; ptxas_report needs the CUDA toolkit")
        return 1
    rec = compile_sources(names)
    framed = []
    for name in names:
        r = rec[name]
        regs = [i["registers"] for i in r["instances"] if i["registers"] is not None]
        print(f"{name}: {r['seconds']:.1f} s, {len(r['instances'])} instances, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}")
        for i in r["instances"]:
            if i["stack"] or i["spill_stores"] or i["spill_loads"]:
                framed.append((name, i))
                print(f"  {i['entry']}<{', '.join(i['args'])}>: {i['registers']} registers, "
                      f"{i['stack']} bytes stack frame, {i['spill_stores']} / "
                      f"{i['spill_loads']} bytes spill stores / loads")
    print(f"{len(framed)} instance(s) with a stack frame or spills")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return 1 if args.no_stack and framed else 0


if __name__ == "__main__":
    sys.exit(main())
