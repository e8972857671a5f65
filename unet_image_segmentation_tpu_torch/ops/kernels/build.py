"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/kernels/`` at the repository root, named by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the cached library. Nothing is built at import time,
and nothing is built on a machine without CUDA.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

# the dtype argument of every entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# mma_common.cuh's ChunkCfg<T>: per dtype the depth of a staged GEMM chunk
# (channels or pixels) and the mma's depth, which the launch plans mirror
CHUNK = {torch.bfloat16: (64, 16), torch.float32: (32, 8)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (all return int = cudaError_t)
SIGNATURES = {
    # x, dw, pw, scale, shift, out, B, H, W, C, F, relu, n, s, width, per,
    # smem, dtype, stream
    "unet_sepconv_block": [_P] * 6 + [_I] * 12 + [_P],
    # x, x2, dw1, pw1, scale1, shift1, dw2, pw2, scale2, shift2, out,
    # pooled, B, H, W, Cx, Cx2, F1, F2, n, s1, s2, width, smem, dtype,
    # in_int8, out_int8, edge_top, edge_bot, stream
    "unet_sepconv_pair": [_P] * 12 + [_I] * 17 + [_P],
    # x, dw, pw, in_aff, halo, y, work, sums, B, H, W, C, F, seed, thresh,
    # drop_scale, n, s, width, per, smem, dtype, stream
    "unet_chain_fwd": [_P] * 8 + [_I] * 7 + [_F] + [_I] * 6 + [_P],
    # x, g, y, in_aff, comb, dw, pw, dx, m, gy, work, sums, dpw, B, H, W, C,
    # F, mask_combine, seed, thresh, drop_scale, wc, tm, tn, splits, per,
    # smem_a, smem_b, dtype, stream
    "unet_chain_bwd": [_P] * 13 + [_I] * 8 + [_F] + [_I] * 8 + [_P],
    # y, aff, z, pooled, B, H, W, F, dtype, stream
    "unet_tail_pool": [_P] * 4 + [_I] * 5 + [_P],
    # y, gs, gp, aff4, dzt, work, st, counter, B, H, W, F, n, ctas, smem,
    # dtype, stream
    "unet_tail_pool_bwd": [_P] * 8 + [_I] * 8 + [_P],
    # x, wmat, bias, skip, cat, B, H, W, C, F, tiles_n, smem, dtype, stream
    "unet_upconcat": [_P] * 5 + [_I] * 8 + [_P],
    # x, wt, g, dx, d_skip, work, dwb, B, H, W, C, F, tiles_n, smem, splits,
    # per, smem_dw, dtype, stream
    "unet_upconcat_bwd": [_P] * 7 + [_I] * 11 + [_P],
    # y, tgt, aff, w, hb, work, sums, counter, B, HW, F, pixels, ctas, smem,
    # dtype, stream
    "unet_head_fwd": [_P] * 8 + [_I] * 7 + [_P],
    # y, tgt, aff4, w, hb, gsc, dzt, work, out, counter, B, HW, F, pixels,
    # ctas, smem, dtype, stream
    "unet_head_bwd": [_P] * 10 + [_I] * 7 + [_P],
    # y, tgt, aff, w, hb, work, sums, counter, B, HW, F, NC, pixels, ctas,
    # smem, dtype, stream
    "unet_head_fwd_mc": [_P] * 8 + [_I] * 8 + [_P],
    # y, tgt, aff4, w, hb, gsc, dzt, work, out, counter, B, HW, F, NC, pixels,
    # ctas, smem, dtype, stream
    "unet_head_bwd_mc": [_P] * 10 + [_I] * 8 + [_P],
    # x, dw, pw, y, work, sums, B, H, W, C, F, n, s, width, per, smem, dtype,
    # stream
    "unet_sepconv_stats": [_P] * 6 + [_I] * 11 + [_P],
    # x, g, dw, pw, dx, m, work, sums, dpwb, B, H, W, C, F, wc, tm, tn,
    # splits, per, smem_a, smem_b, dtype, stream
    "unet_sepconv_bwd": [_P] * 9 + [_I] * 13 + [_P],
    # x, out, n, stream
    "unet_dispatch_probe": [_P] * 2 + [_I, _P],
    # x, out, n, k, one_eps, dtype, stream
    "unet_fma_probe": [_P] * 2 + [_I] * 2 + [_F, _I, _P],
}
# Workspace sizes in floats (return long long): B, H, W, C, F (K1) / B, H,
# W, C, F, splits (K2, K10, K6). K4's, K5's and K11's are a row of partial
# sums a CTA of their plans.
WORKSPACE_SIGNATURES = {
    "unet_chain_fwd_workspace": [_I] * 5,
    "unet_chain_bwd_workspace": [_I] * 6,
    "unet_sepconv_bwd_workspace": [_I] * 6,
    "unet_upconcat_bwd_workspace": [_I] * 6,
}

# stream_sums.cuh, the streaming body of K4, K5 and K11: threads a CTA
# (kStreamThreads), stages of the ring, bytes of its mbarriers ahead of
# the stages, and the stages' alignment
STREAM_THREADS = 512
STREAM_STAGES, STREAM_BAR_BYTES, STAGE_ALIGN = 3, 64, 128


def stream_smem(stage: int, red: int) -> int:
    """Shared-memory bytes of the streaming body (``stream_smem`` of
    stream_sums.cuh): the mbarriers, then the ring of :data:`STREAM_STAGES`
    stages of ``stage`` bytes (each on a :data:`STAGE_ALIGN` boundary), or
    the ``red`` bytes of block sums that reuse its space, the larger."""
    ring = -(-stage // STAGE_ALIGN) * STAGE_ALIGN * STREAM_STAGES
    return STREAM_BAR_BYTES + max(ring, red)


_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the nvcc run, None if cached


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _raise_on_failure(cmd, returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{log}")


def _digest(flags, paths) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return digest.hexdigest()[:16]


def _bind(lib: ctypes.CDLL, signatures, restype) -> None:
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def library_path() -> Path:
    cu, cuh = _sources()
    return BUILD_DIR / f"libunet_kernels_{_digest(NVCC_FLAGS, cu + cuh)}.so"


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the CUDA kernels need a CUDA device; none is available"
        )
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu, _ = _sources()
        tag = f"{out.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        compiles = [
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(cu, objs)
        ]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(compiles, procs, logs):
            _raise_on_failure(cmd, proc.returncode, log)
        link = [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _raise_on_failure(link, proc.returncode, proc.stdout)
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, out)
        for obj in objs:
            obj.unlink()
    lib = ctypes.CDLL(str(out))
    _bind(lib, SIGNATURES, ctypes.c_int)
    _bind(lib, WORKSPACE_SIGNATURES, ctypes.c_longlong)
    lib.unet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.unet_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def load_variant(source: str, defines) -> ctypes.CDLL:
    """Build (once per source hash and flags) and load one source of
    ``csrc/`` alone with extra ``-D`` defines, for a troubleshoot tool that
    needs an instrumented copy of a kernel beside the library proper; its
    entry points take :data:`SIGNATURES`."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; none is available")
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    src = CSRC / source
    out = BUILD_DIR / f"lib{src.stem}_{_digest(flags, [src, *_sources()[1]])}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-shared", "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _raise_on_failure(cmd, proc.returncode, proc.stdout)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _bind(lib, {n: a for n, a in SIGNATURES.items() if hasattr(lib, n)}, ctypes.c_int)
    return lib


def check(status: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error for its launch."""
    if status != 0:
        msg = _lib.unet_cuda_error_string(status).decode() if _lib else ""
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {msg}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def arrival_counter(device: torch.device) -> torch.Tensor:
    """The zeroed 32-bit cell through which the CTAs of one K4, K5 or K11 launch
    find the last of them to arrive (``last_cta_sums`` of stream_sums.cuh),
    one per stream of each card, so launches on two streams never share
    one; every launch leaves it 0 again."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, stream_handle(device))
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count
