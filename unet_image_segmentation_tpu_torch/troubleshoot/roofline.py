"""The card's published peaks and the least time of each kernel's work.

One home for what the troubleshoot tools and ``chip_smoke.py`` hold the
kernels' times against:

* the published peaks of one NVIDIA H100 SXM (data sheet and the Hopper
  white paper, dense, at the full 700 W power limit);
* :func:`bounds_ms`, the least time the card could take for one call of a
  kernel at a shape: the larger of the bytes it must move (each input read
  once, each output written once) over the memory rate and its operations
  (2 per multiply-add) over the peak for their type;
* the shapes of the U-Net's kernel calls (:func:`chain_links`,
  :func:`train_step_shapes`, ...), at which the bounds are evaluated;
* :data:`KERNELS` and :data:`ENTRIES`, the port's kernels: each wrapper's
  K label, CUDA source and the TPU kernel it replaces, and each
  ``__global__`` entry's wrapper and part.

The JAX package's counterparts are the floor arithmetic of
``troubleshoot/link_floors.py`` and ``bench.py``'s datasheet bandwidth.
"""

from __future__ import annotations

import re
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

# device memory, bytes/s
PEAK_BYTES_PER_S = 3.35e12
# operations/s of the units the kernels' math runs on: bf16 on the tensor
# cores (989 TFLOP/s), fp32 on the CUDA cores (67 TFLOP/s)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# the CUDA cores alone (K12b's elementwise FMAs): fp32 67 TFLOP/s, bf16x2
# FMAs 133.8 TFLOP/s (Hopper white paper)
PEAK_CUDA_CORE_OPS_PER_S = {"bfloat16": 133.8e12, "float32": 67e12}
# TF32 on the tensor cores (the fp32 products of K1, K2, K6, K7, K8, K9 and
# K10 run as 3xTF32: three TF32 products for each)
PEAK_TF32_OPS_PER_S = 495e12

# wrapper (its key in an ops module's LAUNCHES) -> (K label, CUDA source
# under ops/kernels/csrc/, the TPU kernel it replaces under
# unet_image_segmentation_tpu/, file:line of the function reaching pallas_call)
KERNELS: Dict[str, Tuple[str, str, str]] = {
    "sepconv_pair": ("K7", "sepconv_pair.cu", "ops/pallas/fused_sepconv.py:903"),
    # K7's int8 I/O and float-in/int8-out modes: the same kernel, other
    # template instances; its edge flags: run-time arguments of every mode
    "sepconv_pair_int8": ("K7 int8", "sepconv_pair.cu", "ops/pallas/fused_sepconv.py:903"),
    "sepconv_pair_quant_out": ("K7 float-in/int8-out", "sepconv_pair.cu",
                               "ops/pallas/fused_sepconv.py:903"),
    "sepconv_pair_edge": ("K7 edge flags", "sepconv_pair.cu", "ops/pallas/fused_sepconv.py:903"),
    "sepconv_block": ("K8", "sepconv_block.cu", "ops/pallas/fused_sepconv.py:300"),
    "chain_fwd": ("K1", "chain_fwd.cu", "ops/pallas/fused_train.py:93"),
    # K1's halo mode (row-sharded training): a run-time argument of the
    # same kernel and instances
    "chain_fwd_halo": ("K1 halo mode", "chain_fwd.cu", "ops/pallas/fused_train.py:93"),
    "chain_bwd": ("K2", "chain_bwd.cu", "ops/pallas/fused_train.py:1422"),
    "tail_pool": ("K3", "tail_pool.cu", "ops/pallas/fused_train.py:468"),
    "tail_pool_bwd": ("K4", "tail_pool.cu", "ops/pallas/fused_train.py:1068"),
    "upconcat": ("K6", "upconcat.cu", "ops/pallas/fused_upconcat.py:153"),
    "upconcat_bwd": ("K6", "upconcat.cu", "ops/pallas/fused_upconcat.py:203"),
    "head_fwd": ("K5", "head.cu", "ops/pallas/fused_head.py:119"),
    "head_bwd": ("K5", "head.cu", "ops/pallas/fused_head.py:433"),
    "head_fwd_mc": ("K11", "head_mc.cu", "ops/pallas/fused_head.py:303"),
    "head_bwd_mc": ("K11", "head_mc.cu", "ops/pallas/fused_head.py:635"),
    "sepconv_stats": ("K9", "chain_fwd.cu", "ops/pallas/fused_sepconv.py:631"),
    "sepconv_bwd": ("K10", "chain_bwd.cu", "ops/pallas/fused_sepconv_bwd.py:40"),
    "dispatch_probe": ("K12a", "probes.cu", "troubleshoot/link_floors.py:56"),
    "fma_probe": ("K12b", "probes.cu", "troubleshoot/link_floors.py:87"),
}

SUMS = "sums"  # label of reduce_rows' colsum_kernel (K1, K2, K6, K9, K10's row sums)
# __global__ entry -> (wrapper, part). A wrapper call launches each of its
# parts once. K7's int8 and float-in/int8-out instances share the entry of
# its float ones, so a trace counts them all under sepconv_pair.
ENTRIES: Dict[str, Tuple[Optional[str], str]] = {
    "sepconv_pair_cluster_kernel": ("sepconv_pair", "pair"),
    "sepconv_block_kernel": ("sepconv_block", "block"),
    "chain_fwd_kernel": ("chain_fwd", "link"),
    "chain_bwd_tile_kernel": ("chain_bwd", "pass (a)"),
    "chain_bwd_dpw_kernel": ("chain_bwd", "pass (b)"),
    "tail_pool_kernel": ("tail_pool", "boundary"),
    "tail_pool_bwd_kernel": ("tail_pool_bwd", "boundary"),
    "upconcat_fwd_kernel": ("upconcat", "feed"),
    "upconcat_dx_kernel": ("upconcat_bwd", "dx"),
    "upconcat_dw_kernel": ("upconcat_bwd", "dw"),
    "head_fwd_kernel": ("head_fwd", "head"),
    "head_bwd_kernel": ("head_bwd", "head"),
    "head_fwd_mc_kernel": ("head_fwd_mc", "head"),
    "head_bwd_mc_kernel": ("head_bwd_mc", "head"),
    "sepconv_stats_kernel": ("sepconv_stats", "block"),
    "sepconv_bwd_tile_kernel": ("sepconv_bwd", "pass (a)"),
    "sepconv_bwd_dpw_kernel": ("sepconv_bwd", "pass (b)"),
    "colsum_kernel": (None, "fixed-order sums"),
    "dispatch_probe_kernel": ("dispatch_probe", "probe"),
    "fma_probe_f32_kernel": ("fma_probe", "probe"),
    "fma_probe_bf16_kernel": ("fma_probe", "probe"),
}

_IDENT = re.compile(r"[A-Za-z_]\w*")


_MANGLED = re.compile("|".join(f"{len(e)}{e}" for e in sorted(ENTRIES, key=len, reverse=True)))


def entry_of(kernel_name: str) -> Optional[str]:
    """The port's ``__global__`` entry a profiler kernel name belongs to,
    demangled (``void unet::(anonymous namespace)::chain_bwd_tile_kernel<
    __nv_bfloat16>(...)``) or mangled (``..._121chain_bwd_tile_kernelI...``),
    or None for any other kernel."""
    hit = next((t for t in _IDENT.findall(kernel_name) if t in ENTRIES), None)
    if hit is None:
        m = _MANGLED.search(kernel_name)
        hit = m.group().lstrip("0123456789") if m else None
    return hit


def label_of(entry: str) -> str:
    """The K label of a ``__global__`` entry (``sums`` for colsum_kernel)."""
    wrapper = ENTRIES[entry][0]
    return KERNELS[wrapper][0] if wrapper else SUMS


def wrapper_launches(entry_counts: Dict[str, int]) -> Dict[str, int]:
    """Wrapper calls from launches counted by entry: a call launches each of
    its wrapper's parts once, so it is the count of its most-launched part."""
    parts: Dict[Tuple[str, str], int] = {}
    for entry, n in entry_counts.items():
        wrapper, part = ENTRIES[entry]
        if wrapper:
            parts[(wrapper, part)] = parts.get((wrapper, part), 0) + n
    out: Dict[str, int] = {}
    for (wrapper, _), n in parts.items():
        out[wrapper] = max(out.get(wrapper, 0), n)
    return out


# ---------------------------------------------------------------------------
# the U-Net's kernel shapes
# ---------------------------------------------------------------------------


_PAIR_MODES = ("sepconv_pair", "sepconv_pair_int8", "sepconv_pair_quant_out",
               "sepconv_pair_edge")


def stage_shapes(image: int, filters: Sequence[int]) -> List[tuple]:
    """(name, Cx, Cx2, F1, F2, H, mode) of the K7 calls of one forward. A K7
    shape may carry its width W after the mode (a row shard's slab, H + 4
    rows by W); without it W = H."""
    shapes, c, h = [], 3, image
    for s, f in enumerate(filters, 1):
        shapes.append((f"enc{s}", c, 0, f, f, h, "pool"))
        c, h = f, h // 2
    shapes.append(("bneck", c, 0, 2 * c, 2 * c, h, "plain"))
    for s in range(len(filters), 0, -1):
        f = filters[s - 1]
        h *= 2
        shapes.append((f"dec{s}", f, f, f, f, h, "x2"))
    return shapes


def chain_links(image: int, filters: Sequence[int]) -> List[tuple]:
    """(name, C, F, H, in_aff, drop, mask_combine) of the chain links of one
    fused train step, in the modes the chains run them: the input affine on
    every second link, dropout on the first link of the decoder stages but
    dec1, and the output's ReLU mask folded into K2 where the chain's exit
    does not apply it: the bottleneck's and dec4..dec2's second links (the
    pool backward K4 masks the encoders' cotangents, the fused head's
    backward K5/K11 dec1's; with ``fused_head`` off dec1.2 takes the mask)."""
    links, c, h = [], 3, image
    for s, f in enumerate(filters, 1):
        links += [(f"enc{s}.1", c, f, h, False, False, False),
                  (f"enc{s}.2", f, f, h, True, False, False)]
        c, h = f, h // 2
    links += [("bneck.1", c, 2 * c, h, False, False, False),
              ("bneck.2", 2 * c, 2 * c, h, True, False, True)]
    for s in range(len(filters), 0, -1):
        f = filters[s - 1]
        h *= 2
        links += [(f"dec{s}.1", 2 * f, f, h, False, s > 1, False),
                  (f"dec{s}.2", f, f, h, True, False, s > 1)]
    return links


def shard_links(image: int, filters: Sequence[int], shards: int) -> List[tuple]:
    """(name, C, F, H, W) of the chain links of one rank of ``shards`` row
    shards: each link's H / shards rows by W, the shapes K1's halo mode
    runs at."""
    return [(name, c, f, h // shards, h) for name, c, f, h, *_ in chain_links(image, filters)]


def pool_shapes(image: int, filters: Sequence[int]) -> List[tuple]:
    """(name, F, H) of the encoder boundaries."""
    return [(f"enc{s}", f, image >> (s - 1)) for s, f in enumerate(filters, 1)]


def upconcat_shapes(image: int, filters: Sequence[int]) -> List[tuple]:
    """(name, C, F, H) of the decoder feeds: x (B,H,H,C) -> cat (B,2H,2H,2F)."""
    out, c, h = [], 2 * filters[-1], image >> len(filters)
    for s in range(len(filters), 0, -1):
        f = filters[s - 1]
        out.append((f"dec{s}", c, f, h))
        c, h = f, 2 * h
    return out


def train_step_shapes(image: int, filters: Sequence[int], num_classes: int) -> Dict[str, list]:
    """Wrapper -> the shapes of its calls in one fused train step (the
    chains, the boundaries, the decoder feeds and the fused head: K5 for one
    class, K11 for more)."""
    links, pools, feeds = (chain_links(image, filters), pool_shapes(image, filters),
                           upconcat_shapes(image, filters))
    head = ({"head_fwd": [(filters[0], image)], "head_bwd": [(filters[0], image)]}
            if num_classes == 1 else
            {"head_fwd_mc": [(filters[0], num_classes, image)],
             "head_bwd_mc": [(filters[0], num_classes, image)]})
    return {"chain_fwd": links, "chain_bwd": links, "tail_pool": pools, "tail_pool_bwd": pools,
            "upconcat": feeds, "upconcat_bwd": feeds, **head}


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------


def work(name: str, shape: tuple, dname: str, batch: int = 1) -> Tuple[float, float]:
    """(bytes, operations) of one call of wrapper ``name`` at ``shape`` in
    ``dname`` at ``batch``: each input read once, each output written once;
    2 operations per multiply-add."""
    e = 4 if dname == "float32" else 2
    if name in _PAIR_MODES:
        _, cx, cx2, f1, f2, h, mode, *w = shape
        c, px = cx + cx2, batch * h * (w[0] if w else h)
        out = px * f2 * (1.25 if mode == "pool" else 1.0)
        # x and x2, y and pooled: int8 or T (the edge flags move no bytes)
        io_in = 1 if name == "sepconv_pair_int8" else e
        io_out = 1 if name in ("sepconv_pair_int8", "sepconv_pair_quant_out") else e
        nbytes = io_in * px * c + io_out * out + e * (9 * c + c * f1 + 9 * f1 + f1 * f2)
        ops = sum(pair_ops(shape, batch))
    elif name == "sepconv_block":
        c, f, h = shape
        px = batch * h * h
        nbytes, ops = e * (px * (c + f) + 9 * c + c * f), 2 * px * (9 * c + c * f)
    elif name == "chain_fwd_halo":                   # x, halo -> y, Σy, Σy²
        _, c, f, h, w = shape
        px = batch * h * w
        nbytes = e * (px * (c + f) + batch * 2 * w * c + 9 * c + c * f) + 4 * 2 * f
        ops = 2 * px * (9 * c + c * f)
    elif name in ("chain_fwd", "chain_bwd", "sepconv_stats", "sepconv_bwd"):
        _, c, f, h = shape[:4]
        px = batch * h * h
        if name in ("chain_fwd", "sepconv_stats"):   # x -> y, Σy, Σy²
            nbytes = e * (px * (c + f) + 9 * c + c * f) + 4 * 2 * f
            ops = 2 * px * (9 * c + c * f)
        elif name == "chain_bwd":                    # x, g, y -> dx, ddw, dpw, S, T
            nbytes = e * (px * (c + 2 * f + c) + 9 * c + c * f) + 4 * (11 * c + c * f)
            ops = 2 * px * (2 * c * f + 27 * c)      # dm, dpw; dz, ddw, m
        else:                                        # x, g -> dx, ddw, dpw, dbias
            nbytes = e * (px * (2 * c + f) + 9 * c + c * f) + 4 * (9 * c + c * f + f)
            ops = 2 * px * (2 * c * f + 27 * c) + px * f
    elif name in ("tail_pool", "tail_pool_bwd"):
        _, f, h = shape
        px = batch * h * h
        nbytes = e * px * f * (2.25 if name == "tail_pool" else 3.25)
        ops = px * f * (3 if name == "tail_pool" else 8)
    elif name in ("upconcat", "upconcat_bwd"):
        _, c, f, h = shape
        px = batch * h * h
        gemm = 2 * px * c * 4 * f
        if name == "upconcat":    # x, skip, W -> cat
            nbytes, ops = e * (px * c + 4 * px * f + 4 * c * f + 8 * px * f), gemm
        else:                     # x, g, W -> dx, d_skip, d_kernel, d_bias
            nbytes = e * (2 * px * c + 8 * px * f + 4 * px * f + 4 * c * f) + 4 * 4 * c * f
            ops = 2 * gemm
    elif name in ("head_fwd_mc", "head_bwd_mc"):
        f, nc, h = shape
        px = batch * h * h
        if name == "head_fwd_mc":  # y, targets -> 3nc+1+nc^2 sums a sample
            nbytes, ops = e * px * f + px, px * ((3 + 2 * nc) * f + 12 * nc + 20)
        else:                      # y, targets -> dzt, S, T, dw, db
            nbytes, ops = 2 * e * px * f + px, px * ((7 + 6 * nc) * f + 30 * nc)
    elif name in ("head_fwd", "head_bwd"):
        f, h = shape
        px = batch * h * h
        if name == "head_fwd":     # y, targets -> 9 sums a sample
            nbytes, ops = e * px * f + px, px * (6 * f + 20)
        else:                      # y, targets -> dzt, S, T, dw, db
            nbytes, ops = 2 * e * px * f + px, px * (14 * f + 24)
    elif name == "dispatch_probe":  # x -> x + 1, fp32
        (n,) = shape
        nbytes, ops = 2 * 4 * n, n
    elif name == "fma_probe":       # x -> k FMAs an element
        n, k = shape
        nbytes, ops = 2 * e * n, 2 * k * n
    else:
        raise KeyError(f"no bound for kernel {name!r}")
    return float(nbytes), float(ops)


def pair_ops(shape: tuple, batch: int = 1) -> Tuple[float, float]:
    """(products, depthwise) operations of one K7 call at a stage ``shape``:
    the two pointwise GEMMs and the two 3x3 depthwise convolutions."""
    _, cx, cx2, f1, f2, h, _, *w = shape
    c, px = cx + cx2, batch * h * (w[0] if w else h)
    return 2.0 * px * (c * f1 + f1 * f2), 2.0 * px * (9 * c + 9 * f1)


def bwd_ops(name: str, shape: tuple, batch: int = 1) -> Tuple[float, float]:
    """(products, elementwise) operations of one K2 or K10 call at a link
    ``shape``: dm and dpw (2*C*F multiply-adds a pixel), and dz, ddw and m
    (27*C), plus K10's dbias sum (F adds a pixel)."""
    _, c, f, h = shape[:4]
    px = batch * h * h
    return 2.0 * px * 2 * c * f, 2.0 * px * 27 * c + (px * f if name == "sepconv_bwd" else 0)


def fwd_ops(name: str, shape: tuple, batch: int = 1) -> Tuple[float, float]:
    """(products, depthwise) operations of one K8 or K1 call: the pointwise
    product (C*F multiply-adds a pixel) and the 3x3 depthwise (9*C). K8's
    shape is (C, F, H), K1's a link (name, C, F, H, ...), K1's halo mode a
    row shard's link (name, C, F, H, W)."""
    c, f, h = shape if name == "sepconv_block" else shape[1:4]
    px = batch * h * (shape[4] if name == "chain_fwd_halo" else h)
    return 2.0 * px * c * f, 2.0 * px * 9 * c


def feed_ops(name: str, shape: tuple, batch: int = 1) -> Tuple[float, float]:
    """(products, elementwise) operations of one K6 call at a decoder feed
    ``shape`` (name, C, F, H): the forward's GEMM of C*4F multiply-adds a
    pixel of x, the backward's two (dx and d_kernel); nothing else worth
    counting (the bias adds and d_bias sums are 1/(2C) of the products)."""
    _, c, f, h = shape
    gemm = 2.0 * batch * h * h * c * 4 * f
    return (gemm if name == "upconcat" else 2 * gemm), 0.0


# wrapper -> its (products, elementwise) operations, for the kernels whose
# products run on the tensor cores and the rest on the CUDA cores
_SPLIT_OPS = {**{name: lambda name, shape, batch: pair_ops(shape, batch)
                 for name in _PAIR_MODES},
              "sepconv_block": fwd_ops, "chain_fwd": fwd_ops, "chain_fwd_halo": fwd_ops,
              "sepconv_stats": fwd_ops,
              "chain_bwd": bwd_ops, "sepconv_bwd": bwd_ops,
              "upconcat": feed_ops, "upconcat_bwd": feed_ops}


def bounds_ms(name: str, shape: tuple, dname: str, batch: int = 1) -> Tuple[float, str]:
    """The least time, in ms, the card could take for one call of wrapper
    ``name`` at ``shape`` in ``dname``, and which of "bytes" and
    "operations" bounds it. K12b's FMAs are held to the CUDA cores' peak.
    The products of K1, K2, K6, K7, K8, K9 and K10 run on the tensor cores
    (bf16; fp32 as 3xTF32, three TF32 products each) while their depthwise
    and elementwise work runs on the CUDA cores in fp32, the two at once.
    Every other kernel's operations (K3-K5, K11, K12a) are held to
    :data:`PEAK_OPS_PER_S`."""
    nbytes, ops = work(name, shape, dname, batch)
    peaks = PEAK_CUDA_CORE_OPS_PER_S if name == "fma_probe" else PEAK_OPS_PER_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peaks[dname] * 1e3
    if name in _SPLIT_OPS:
        gemm, rest = _SPLIT_OPS[name](name, shape, batch)
        tc = (gemm / PEAK_OPS_PER_S["bfloat16"] if dname == "bfloat16"
              else 3 * gemm / PEAK_TF32_OPS_PER_S)
        t_ops = max(tc, rest / PEAK_OPS_PER_S["float32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sum_bounds(name: str, shapes: Sequence[tuple], dname: str, batch: int = 1
               ) -> Tuple[float, str]:
    """:func:`bounds_ms` summed over ``shapes``; the limit that bounds most of
    the sum."""
    parts = [bounds_ms(name, shape, dname, batch) for shape in shapes]
    by = {lim: sum(t for t, b in parts if b == lim) for lim in ("bytes", "operations")}
    return sum(t for t, _ in parts), max(by, key=by.get)


def nvidia_smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` for the first card."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card() -> str:
    """The card's name and power limit, as every time and rate is labelled."""
    return nvidia_smi("name,power.limit")
