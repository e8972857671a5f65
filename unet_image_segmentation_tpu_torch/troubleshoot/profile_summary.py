"""Summarize a ``torch.profiler`` Chrome trace: device time by kernel.

Port of ``unet_image_segmentation_tpu/troubleshoot/profile_summary.py``.
The JAX tool parses ``jax.profiler``'s XSpace protobufs; the port reads
what :func:`..utils.profiling.trace` writes, torch.profiler's Chrome-trace
JSON (the ``*.pt.trace.json`` files under a directory, or one file of any
name), with nothing but ``json``, so a trace taken on the card can be read
anywhere.

Per trace: device time summed by kernel name over the events of category
``kernel`` (memcpy and memset events as rows of their own), launches by
name, the host's kernel-launch calls and when those whose kernel the trace
lacks were made (:func:`check_complete`), the device's busy time as the
union of those intervals, the traced window (first to last event of any
kind) and the share of it the device sat idle; optionally (``within``) only
for the work the host launched inside the spans of one
``torch.profiler.record_function`` name.

Usage::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.profile_summary \\
        TRACE_DIR_OR_FILE [--top 30]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

KERNEL = "kernel"
COPIES = ("gpu_memcpy", "gpu_memset")
HOST_API = ("cuda_runtime", "cuda_driver")   # the host's calls, kernel launches among them
ANNOTATION = "user_annotation"               # a torch.profiler.record_function span


def trace_files(path: str) -> List[str]:
    """``path`` itself if it is a file, else the ``*.pt.trace.json`` files under it."""
    if os.path.isfile(path):
        return [path]
    return sorted(glob.glob(os.path.join(path, "**", "*.pt.trace.json"), recursive=True))


def read_events(path: str) -> List[dict]:
    """The complete ("X") events of one Chrome trace."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]


def union_ms(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in the intervals' unit / 1e3."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def summarize_events(events: List[dict], within: Optional[str] = None) -> Dict[str, object]:
    """The summary of one trace's complete events (times in ms; Chrome
    traces count microseconds). With ``within``, only the device work the
    host launched inside its ``record_function(within)`` spans counts, and
    the window runs from the first span's start to the end of the last
    span or of its work."""
    spans = None
    if within is not None:
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                       if e.get("cat") == ANNOTATION and e["name"] == within)
        if not spans:
            raise ValueError(f"no {within!r} span in the trace")

    def inside(ts: float) -> bool:
        return spans is None or any(s <= ts <= t for s, t in spans)

    calls: Dict[object, float] = {}   # the host's launch calls: correlation id -> ts
    region = set()                    # correlation ids of the host's calls that count
    for e in events:
        if e.get("cat") in HOST_API and inside(float(e["ts"])):
            corr = e.get("args", {}).get("correlation", id(e))
            region.add(corr)
            if "LaunchKernel" in e["name"]:
                calls[corr] = float(e["ts"])
    kernels: Dict[str, float] = {}
    copies: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    device: List[Tuple[float, float]] = []
    recorded = set()
    for e in events:
        cat = e.get("cat")
        corr = e.get("args", {}).get("correlation")
        if (cat != KERNEL and cat not in COPIES) or (spans is not None and corr not in region):
            continue
        recorded.add(corr)
        ts, dur, name = float(e["ts"]), float(e["dur"]), e["name"]
        rows = kernels if cat == KERNEL else copies
        rows[name] = rows.get(name, 0.0) + dur / 1e3
        launches[name] = launches.get(name, 0) + 1
        device.append((ts, ts + dur))
    bounds = spans + device if spans is not None else [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]
    start = min((s for s, _ in bounds), default=0.0)
    window = (max((t for _, t in bounds), default=0.0) - start) / 1e3
    busy = union_ms(device)
    lost = sorted((ts - start) / 1e3 for c, ts in calls.items() if c not in recorded)
    return {"kernels": kernels, "copies": copies, "launches": launches,
            "launch_calls": len(calls), "lost_launch_ms": lost, "busy_ms": busy,
            "window_ms": window, "idle_share": 1.0 - busy / window if window > 0 else None}


def check_complete(summary: Dict[str, object], what: str) -> None:
    """Raise if the trace lacks a kernel the host launched (in the spans)."""
    lost = summary["lost_launch_ms"]
    if lost:
        raise AssertionError(
            f"{what}: the trace lacks {len(lost)} of the {summary['launch_calls']} kernels the "
            f"host launched, launched {lost[0]:.3f}..{lost[-1]:.3f} ms into the "
            f"{summary['window_ms']:.3f} ms window")


def summarize(path: str, within: Optional[str] = None) -> Dict[str, object]:
    """:func:`summarize_events` over every trace file at ``path`` (rows,
    launches, busy and window times added up across files)."""
    files = trace_files(path)
    if not files:
        raise FileNotFoundError(f"no Chrome trace (*.pt.trace.json) at {path}")
    out: Dict[str, object] = {"files": files, "kernels": {}, "copies": {}, "launches": {},
                              "launch_calls": 0, "lost_launch_ms": [], "busy_ms": 0.0,
                              "window_ms": 0.0}
    for f in files:
        one = summarize_events(read_events(f), within)
        for key in ("kernels", "copies", "launches"):
            for name, v in one[key].items():
                out[key][name] = out[key].get(name, 0) + v
        for key in ("launch_calls", "lost_launch_ms", "busy_ms", "window_ms"):
            out[key] += one[key]
    w = out["window_ms"]
    out["idle_share"] = 1.0 - out["busy_ms"] / w if w > 0 else None
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("logdir", help="a trace directory or one Chrome-trace file")
    p.add_argument("--top", type=int, default=30)
    args = p.parse_args(argv)
    s = summarize(args.logdir)
    busy = s["busy_ms"]
    idle = s["idle_share"]
    print(f"== {len(s['files'])} trace file(s): window {s['window_ms']:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {'n/a' if idle is None else f'{idle:.4f}'} ==")
    rows = sorted({**s["kernels"], **s["copies"]}.items(), key=lambda kv: -kv[1])
    for name, ms in rows[: args.top]:
        share = 100 * ms / busy if busy else 0.0
        print(f"{ms:10.3f} ms {share:5.1f}% {s['launches'][name]:6d}x  {name[:120]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
