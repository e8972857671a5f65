"""Profiling and step timing.

Port of ``unet_image_segmentation_tpu/utils/profiling.py``:

* :func:`trace`: a ``torch.profiler`` trace of a code region, written into
  a directory as a Chrome trace (``*.pt.trace.json``, which TensorBoard's
  PyTorch profiler plugin, Perfetto and ``troubleshoot/profile_summary``
  read). On the card it records the CPU and the CUDA kernels, and raises
  when it recorded no device time (the JAX version degrades to a warning;
  a trace that silently does not happen is worse than an error). On the
  CPU it records CPU activity only.
* :func:`hard_sync`: wait for the device.
* :class:`StepTimer`: per-step wall time over windows of steps, the device
  synchronised once per window (``train/loop.py:fit`` reports it).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, Iterator, List, Union

import numpy as np
import torch


def hard_sync(device: Union[str, torch.device]) -> None:
    """Wait until the device has finished its queued work (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Idle seconds a CUDA trace holds before and after its region. On the H100,
# minutes into a process, traces that began or ended with the region's
# kernels lacked some of them (up to 14 of 35 in a short trace); with this
# margin none was lost. torch.profiler keeps only the kernels whose device
# timestamps fall inside its window on the host's clock, so the margin keeps
# the region's kernels inside it however the two clocks disagree.
CUDA_TRACE_GUARD_S = 0.5


@contextlib.contextmanager
def trace(log_dir: str, device: Union[str, torch.device] = "cuda") -> Iterator[None]:
    """Trace the region into ``log_dir`` as a Chrome trace. ``device``
    "cuda" (the default) records the CPU and the card's kernels, with
    :data:`CUDA_TRACE_GUARD_S` of idle time around the region, and raises
    if no CUDA device is present or if the trace holds no device time;
    "cpu" records CPU activity only. A caller that counts kernels counts
    what the host launched inside ``record_function`` spans and checks that
    the trace holds each of them
    (:func:`..troubleshoot.profile_summary.summarize`'s ``within`` and
    ``lost_launch_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    guard = 0.0
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: device 'cuda' requested but no CUDA device is available")
        activities.append(ProfilerActivity.CUDA)
        guard = CUDA_TRACE_GUARD_S
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        hard_sync(device)
        time.sleep(guard)
        yield
        hard_sync(device)
        time.sleep(guard)
    path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if device.type == "cuda" and not any(
            getattr(ev, "self_device_time_total", 0.0) > 0 for ev in prof.key_averages()):
        raise RuntimeError(f"trace: torch.profiler recorded no device time ({path}); "
                           "CUDA tracing (CUPTI) is unavailable here")


class StepTimer:
    """Per-step wall time, averaged over windows of ``sync_every`` steps; the
    device is synchronized once per window, not once per step."""

    def __init__(self, device: Union[str, torch.device], sync_every: int = 32):
        self.device = torch.device(device)
        self.sync_every = max(1, sync_every)
        self.times: List[float] = []
        self._n = 0
        self._t0 = time.perf_counter()

    def lap(self) -> None:
        self._n += 1
        if self._n % self.sync_every == 0:
            hard_sync(self.device)
            self.times.append((time.perf_counter() - self._t0) / self.sync_every)
            self._t0 = time.perf_counter()

    def summary(self) -> Dict[str, float]:
        if self._n == 0:
            return {}
        out = {"steps": float(self._n)}
        if self.times:
            ts = self.times[1:] if len(self.times) > 2 else self.times  # drop warm-up
            out.update(mean_ms=float(np.mean(ts)) * 1e3, p50_ms=float(np.median(ts)) * 1e3,
                       max_ms=max(ts) * 1e3)
        return out
