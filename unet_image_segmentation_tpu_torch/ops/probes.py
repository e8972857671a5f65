"""K12: the card's launch-overhead and FMA-rate probes.

Port of the two Pallas probes of
``unet_image_segmentation_tpu/troubleshoot/link_floors.py``, each a
hand-written CUDA kernel (``kernels/csrc/probes.cu``) beside its plain
PyTorch version:

* :func:`dispatch_probe` (K12a, ``measure_dispatch_ms``'s body): ``x + 1``
  on an (8, 128) fp32 tensor, a kernel that does nothing worth timing, so
  its time is the cost of a launch;
* :func:`fma_probe` (K12b, ``measure_vpu_rate``'s body): ``k`` dependent
  steps ``acc = acc * one_eps + x`` from ``acc = x``, ``one_eps = 1.000001``
  rounded to the dtype, one fused multiply-add per element per step with
  ``acc`` in registers, so its rate is the card's elementwise FMA rate.

Each wrapper runs its plain version on a CPU tensor and its kernel on a
CUDA tensor (or raises). :data:`LAUNCHES` counts kernel launches and only
those. In bf16 ``one_eps`` rounds to exactly 1.0, so the loop is
``acc + x`` and its "rate" counts adds; the kernel's ``__hfma2`` and the
plain version's separate multiply and add then agree bit for bit. In fp32
they differ only by the fused rounding, at most ``k * 2**-24`` relative.
"""

from __future__ import annotations

from typing import Dict

import torch

from unet_image_segmentation_tpu_torch.ops.kernels import build

LAUNCHES: Dict[str, int] = {"dispatch_probe": 0, "fma_probe": 0}

ONE_EPS = 1.000001
_MAX_N = 2**30  # elements a probe takes (int32 indexing with headroom)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def one_eps(dtype: torch.dtype) -> torch.Tensor:
    """1.000001 rounded to ``dtype`` (1.0 exactly in bf16)."""
    return torch.tensor(ONE_EPS, dtype=dtype)


def dispatch_probe_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain K12a: ``x + 1``."""
    return x + 1.0


def fma_probe_reference(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain K12b: ``k`` steps of ``acc = acc * one_eps + x`` in x.dtype,
    the multiply and the add each rounded."""
    e = one_eps(x.dtype).to(x.device)
    acc = x.clone()
    for _ in range(k):
        acc = acc * e + x
    return acc


def _check(x: torch.Tensor, name: str, dtypes) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not supported ({', '.join(map(str, dtypes))})")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned tensor")
    if not 0 < x.numel() <= _MAX_N:
        raise ValueError(f"{name}: {x.numel()} elements, expected 1..{_MAX_N}")


def dispatch_probe(x: torch.Tensor) -> torch.Tensor:
    """K12a on a CUDA fp32 tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return dispatch_probe_reference(x)
    _check(x, "dispatch_probe", (torch.float32,))
    lib = build.load_library()
    out = torch.empty_like(x)
    status = lib.unet_dispatch_probe(x.data_ptr(), out.data_ptr(), x.numel(),
                                     build.stream_handle(x.device))
    build.check(status, "dispatch_probe")
    LAUNCHES["dispatch_probe"] += 1
    return out


def fma_probe(x: torch.Tensor, k: int) -> torch.Tensor:
    """K12b on a CUDA tensor (fp32, or bf16 with an even element count),
    its plain version on a CPU tensor."""
    if k < 0:
        raise ValueError(f"fma_probe: k = {k} < 0")
    if x.device.type == "cpu":
        return fma_probe_reference(x, k)
    _check(x, "fma_probe", tuple(build.DTYPE_CODE))
    if x.dtype == torch.bfloat16 and x.numel() % 2:
        raise ValueError("fma_probe: bf16 takes an even number of elements (bf16x2 pairs)")
    lib = build.load_library()
    out = torch.empty_like(x)
    status = lib.unet_fma_probe(x.data_ptr(), out.data_ptr(), x.numel(), int(k),
                                float(one_eps(x.dtype)), build.DTYPE_CODE[x.dtype],
                                build.stream_handle(x.device))
    build.check(status, "fma_probe")
    LAUNCHES["fma_probe"] += 1
    return out
