"""Per-link K1 and K2 floor table on the card, with the card's probes (K12).

Port of ``unet_image_segmentation_tpu/troubleshoot/link_floors.py``. It
measures the card's launch overhead and elementwise FMA rate with the two
K12 probes (:mod:`..ops.probes`), then times the chain's link kernels, the
forward K1 (:func:`..ops.fused_train.chain_fwd`) and the backward K2
(:func:`..ops.fused_train.chain_bwd`), alone at each of the 18 links of the
256 px, batch-32 train step, in the modes the step runs them
(:func:`stage_table`). K1's row: ms a call against its bytes floor, the
model of its route (:func:`k1_model_ms`: its products at the measured
product rate, its depthwise and prologue at K12b's) and its executed over
useful multiply-adds (:func:`..ops.fused_train.fwd_work`). K2's row holds
each link's time against

* its bytes floor: x, g, y and dx once each, plus weights and sums, over
  the card's memory rate (:func:`.roofline.work`);
* a model of the route K2 takes (:func:`k2_instructions`, from
  :func:`..ops.fused_train.chain_bwd_plan` and ``chain_bwd.cu``): its
  products (dm in pass (a), dpw in pass (b), the multiply-adds the plan
  executes) at the product rate of a 4096^3 ``torch.matmul`` on the card
  (:func:`measure_product_rate`: bf16, or TF32 with three TF32 products
  for each fp32 one, as K2's 3xTF32 issues them), plus its CUDA-core
  instructions (gy, z, dz, dx, m, ddw, S, T and the row sums) at the fp32
  FMA rate K12b measured.

A ``torch.profiler`` pass over the same calls splits each link's time into
pass (a) (``chain_bwd_tile_kernel``: gy, dm, dz, dx, m, ddw, S, T), pass (b)
(``chain_bwd_dpw_kernel``: dpw), the fixed-order row sums
(``colsum_kernel``) and any PyTorch glue. Each row also gives the
executed over useful multiply-adds (:func:`..ops.fused_train.chain_bwd_work`).

Writes ``build/link_floors.json`` and prints the table. Needs a CUDA card::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.link_floors \\
        [--iters 20] [--dtype bfloat16|float32] [--out build/link_floors.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from unet_image_segmentation_tpu_torch.ops import fused_train as ft
from unet_image_segmentation_tpu_torch.ops import probes
from unet_image_segmentation_tpu_torch.troubleshoot import (
    check_gpu_benchmark, profile_summary, roofline)
from unet_image_segmentation_tpu_torch.utils.profiling import hard_sync, trace

HW = 256
BATCH = 32
FILTERS = (64, 128, 256, 512)
WARMUP = 5
DISPATCH_SHAPE = (8, 128)
DISPATCH_LAUNCHES = 2000     # back-to-back launches timed with CUDA events
HOST_ITERS = 200             # launch-and-synchronise rounds timed on the host clock
FMA_K = 2048
FMA_SHAPE = (1024, 512)
PROFILED_CALLS = 5           # calls per link under the profiler
CALL_SPAN = "link_floors"   # + ".<link>": the record_function span of a profiled call
SEED = 2301
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "link_floors.json")

# K2's pass-(a) tile and ring, its threads a CTA, and the rows one
# colsum_kernel block sums (chain_bwd.cu, train_common.cuh)
TILE, RING_PX, THREADS, RED_ROWS = 8, 100, 256, 512
PRODUCT_MATRIX = 4096        # side of the matmul that measures the product rate


def stage_table(image: int = HW, filters=FILTERS):
    """The 18 links (name, C, F, H, in_aff, drop, mask_combine) of one train
    step, in the modes the step runs them (:func:`.roofline.chain_links`).
    The image enters enc1.1 with its 3 channels: K2 masks C, so nothing is
    padded to 16 as on the TPU, and every link runs."""
    return roofline.chain_links(image, filters)


def _event_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int, replays: int = 5) -> float:
    """Device time per call of ``fn``, from ``n`` calls captured in one CUDA
    graph and replayed: the device's own cost of each launch, with the
    host's cost of issuing it taken away."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, replays) / n


def measure_dispatch_ms(device="cuda", launches: int = DISPATCH_LAUNCHES,
                        host_iters: int = HOST_ITERS) -> Dict[str, float]:
    """K12a's cost of one launch, in ms: ``device_ms``, on the device, over
    ``launches`` launches replayed from one CUDA graph (what each kernel
    boundary costs a stream the host keeps fed); ``stream_ms``, per launch
    over ``launches`` back-to-back launches from Python (the host's issue
    rate through the wrapper, when the kernels are shorter than it);
    ``host_ms``, per launch-and-synchronise on the host clock; and
    ``library_ms``, ``x + 1`` (the one PyTorch call that computes K12a's
    function) timed like ``device_ms``."""
    x = torch.zeros(DISPATCH_SHAPE, dtype=torch.float32, device=device)
    for _ in range(10):
        probes.dispatch_probe(x)
    hard_sync(device)
    stream_ms = _event_ms(lambda: probes.dispatch_probe(x), launches)
    t0 = time.perf_counter()
    for _ in range(host_iters):
        probes.dispatch_probe(x)
        torch.cuda.synchronize(device)
    host_ms = (time.perf_counter() - t0) * 1e3 / host_iters
    return {"device_ms": graph_ms(lambda: probes.dispatch_probe(x), launches),
            "stream_ms": stream_ms, "host_ms": host_ms,
            "library_ms": graph_ms(lambda: x + 1.0, launches),
            "bound_ms": roofline.bounds_ms("dispatch_probe", (x.numel(),), "float32")[0]}


def measure_fma_rate(dtype: str = "float32", device="cuda", k: int = FMA_K,
                     iters: int = 10) -> Dict[str, float]:
    """K12b's elementwise FMA rate on register-resident data: ``ms`` per call
    at (1024, 512) and ``k`` steps, from ``iters`` calls replayed from a CUDA
    graph (back to back from Python, the host's issue gaps showed in a call
    this short), ``gops`` = 2*k*N / time in Gop/s, and its bound (the CUDA
    cores' peak for the dtype). In bf16 one_eps rounds to 1.0, so the loop
    adds (``probes`` module docstring)."""
    x = torch.from_numpy(np.random.RandomState(0).rand(*FMA_SHAPE).astype(np.float32) * 1e-3)
    x = x.to(device=device, dtype=getattr(torch, dtype))
    for _ in range(3):
        probes.fma_probe(x, k)
    hard_sync(device)
    ms = graph_ms(lambda: probes.fma_probe(x, k), iters)
    bound, _ = roofline.bounds_ms("fma_probe", (x.numel(), k), dtype)
    return {"ms": ms, "gops": 2 * k * x.numel() / (ms * 1e-3) / 1e9, "bound_ms": bound,
            "bound_share": bound / ms}


measure_vpu_rate = measure_fma_rate  # the JAX tool's name for the same probe


def measure_product_rate(dname: str, device="cuda") -> float:
    """Operations a second of the tensor cores' products, from a
    :data:`PRODUCT_MATRIX`-square ``torch.matmul`` timed as
    ``check_gpu_benchmark`` times it: bf16 operands for "bfloat16", TF32
    for "float32" (K2's fp32 products issue three TF32 products each)."""
    dtype = torch.bfloat16 if dname == "bfloat16" else torch.float32
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = dname == "float32"
    try:
        secs = min(check_gpu_benchmark.benchmark_matmul(
            torch.device(device), dtype, PRODUCT_MATRIX, warmup=3, trials=10, runs=2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2 * PRODUCT_MATRIX ** 3 / secs


def k2_plan(b: int, h: int, w: int, c: int, f: int, dname: str = "bfloat16") -> Dict[str, int]:
    """K2's launch plan (:func:`..ops.fused_train.chain_bwd_plan`): pass
    (a)'s CTAs and per-tile partial rows, pass (b)'s splits."""
    plan = ft.chain_bwd_plan(b, h, w, c, f, getattr(torch, dname))
    ctas = plan.grid_a[0] * plan.grid_a[1] * plan.grid_a[2]
    return {"ctas_a": ctas, "rows_a": b * plan.tiles_y * plan.tiles_x, "splits": plan.splits,
            "wc": plan.wc, "kc": ft._BWD_CHUNK[getattr(torch, dname)][0]}


def _colsum_adds(rows: int, cols: int) -> int:
    total = 0
    while rows > RED_ROWS:
        total += rows * cols
        rows = math.ceil(rows / RED_ROWS)
    return total + rows * cols


def k2_instructions(b: int, h: int, w: int, c: int, f: int, in_aff: bool, drop: bool,
                    mask: bool, dname: str = "bfloat16") -> Dict[str, int]:
    """What K2 executes for one call, by part, counted from chain_bwd.cu
    on :func:`k2_plan`'s launch. ``pass_a_mma`` and ``pass_b_mma``: the
    multiply-adds of dm and dpw on the tensor cores
    (:func:`..ops.fused_train.chain_bwd_work`, padding included). The
    CUDA cores' fp32 instructions: ``pass_a_fma``, per CTA gy over the 100
    ring pixels and every chunk's KC channels (3 a value, +2 for the output
    mask), then per tile pixel and channel of the slice that C holds 27
    FMAs for dz, m and ddw, +6 for the input affine's mask, S and T, +1 for
    dropout, and the z of the sliding window's new column (two values a
    pixel in bands of two rows; 3 instructions each with the affine, 1
    with dropout), then the row groups' sum of 11 partials;
    ``sums``: the adds of the fixed-order row sums."""
    plan = k2_plan(b, h, w, c, f, dname)
    work = ft.chain_bwd_work(b, h, w, c, f, getattr(torch, dname))
    wc, kc = plan["wc"], plan["kc"]
    tiles = plan["rows_a"]
    gy = RING_PX * math.ceil(f / kc) * kc * (3 + 2 * mask)
    per_channel = TILE * TILE * (27 + 6 * in_aff + drop + 2 * (3 * in_aff + drop)) + \
        THREADS // wc * 11
    pass_a = plan["ctas_a"] * gy + tiles * c * per_channel
    sums = _colsum_adds(plan["rows_a"], 11 * c) + _colsum_adds(plan["splits"], c * f)
    return {"pass_a_mma": work.pass_a_mma, "pass_b_mma": work.pass_b_mma, "pass_a_fma": pass_a,
            "sums": sums}


def k2_model_ms(instr: Dict[str, int], dname: str, product_ops: float,
                fma_gops: float) -> Dict[str, float]:
    """ms of each of K2's parts at the measured rates: the products at
    ``product_ops`` operations a second (three TF32 products for each fp32
    one), the CUDA-core instructions at ``fma_gops`` / 2 FMA instructions
    a ns (K12b's fp32 rate)."""
    per_product = 2 * (3 if dname == "float32" else 1) / product_ops * 1e3
    fma_ms = 2 / (fma_gops * 1e9) * 1e3
    pass_a = instr["pass_a_mma"] * per_product + instr["pass_a_fma"] * fma_ms
    return {"pass_a": pass_a, "pass_b": instr["pass_b_mma"] * per_product,
            "sums": instr["sums"] * fma_ms}


def k1_instructions(b: int, h: int, w: int, c: int, f: int, in_aff: bool, drop: bool,
                    dname: str = "bfloat16") -> Dict[str, int]:
    """What K1 executes for one call, counted from sepconv_fwd.cuh and
    chain_fwd.cu for :func:`..ops.fused_train.fwd_plan`'s launch:
    ``mma``, the products on the tensor cores, and ``depthwise``, its
    multiply-adds on the CUDA cores (:func:`..ops.fused_train.fwd_work`,
    padding included); ``prologue``, the CUDA cores' instructions of the
    input transform on the staged halo (100 pixels a tile for every channel
    of C: 3 a value for the affine and its ReLU, 11 for the dropout's hash,
    test and scale); ``sums``, the adds of the fixed-order row sums."""
    work = ft.fwd_work(b, h, w, c, f, getattr(torch, dname))
    tiles = b * -(-h // TILE) * -(-w // TILE)
    prologue = tiles * RING_PX * c * (3 * in_aff + 11 * drop)
    return {"mma": work.mma_executed, "depthwise": work.dw_executed, "prologue": prologue,
            "sums": _colsum_adds(tiles, 2 * f)}


def k1_model_ms(instr: Dict[str, int], dname: str, product_ops: float,
                fma_gops: float) -> float:
    """ms of K1's work at the measured rates: the products at
    ``product_ops`` operations a second (three TF32 products for each fp32
    one), the rest (depthwise, prologue, sums) at ``fma_gops`` / 2
    instructions a ns (K12b's fp32 rate)."""
    per_product = 2 * (3 if dname == "float32" else 1) / product_ops * 1e3
    fma_ms = 2 / (fma_gops * 1e9) * 1e3
    return instr["mma"] * per_product + (
        instr["depthwise"] + instr["prologue"] + instr["sums"]) * fma_ms


def link_inputs(rnd, dev, dtype, batch: int, c: int, f: int, h: int, in_aff: bool,
                drop: bool, w: Optional[int] = None) -> dict:
    """Seeded inputs of one link for K1 and K2 at H x W (W = H unless
    given); ``rnd(*shape, scale=1.0)`` draws uniform [-scale, scale). y is
    the plain K1 output, so K2's masks see the values the step gives it."""
    w = h if w is None else w
    x = rnd(batch, h, w, c).to(dev, dtype)
    dw = rnd(3, 3, c, scale=(6 / (9 * c + 9)) ** 0.5).to(dev, dtype)
    pw = rnd(c, f, scale=(6 / (c + f)) ** 0.5).to(dev, dtype)
    aff2 = aff4 = None
    if in_aff:
        aff4 = torch.stack([1 + 0.5 * rnd(c), 0.1 * rnd(c), 0.1 * rnd(c),
                            1 + 0.5 * rnd(c).abs()]).to(dev).contiguous()
        aff2 = aff4[:2].contiguous()
    d = ft.Dropout(-123456789, 0.2) if drop else None
    y = ft.chain_fwd_reference(x, dw, pw, aff2, d)[0]
    g = rnd(batch, h, w, f).to(dev, dtype)
    comb = torch.stack([1 + 0.5 * rnd(f), 0.01 * rnd(f), 0.01 * rnd(f), 0.1 * rnd(f),
                        1 + 0.5 * rnd(f), 0.1 * rnd(f)]).to(dev).contiguous()
    return dict(x=x, dw=dw, pw=pw, aff2=aff2, aff4=aff4, drop=d, y=y, g=g, comb=comb)


def _split(summary: dict, calls: int) -> Dict[str, float]:
    """ms per call of K2's passes, its row sums and other kernels, and the
    kernels launched per call, from the trace of ``calls`` calls."""
    parts = {"pass_a": 0.0, "pass_b": 0.0, "sums": 0.0, "glue": 0.0}
    names = {"chain_bwd_tile_kernel": "pass_a", "chain_bwd_dpw_kernel": "pass_b",
             "colsum_kernel": "sums"}
    for name, ms in {**summary["kernels"], **summary["copies"]}.items():
        part = names.get(roofline.entry_of(name) if name in summary["kernels"] else None, "glue")
        parts[part] += ms / calls
    parts["kernels_per_call"] = sum(summary["launches"].values()) / calls
    return parts


def time_links(dname: str, iters: int, fma_gops: float, product_ops: float, launch_ms: float,
               device="cuda"):
    """The per-link rows (and their totals): K1 and K2 each timed with CUDA
    events after :data:`WARMUP` calls, one launch counted per timed call;
    then, in one trace, :data:`PROFILED_CALLS` more K2 calls a link, each
    link's split by pass; each beside the model of its route at the
    measured rates (:func:`k1_model_ms`, :func:`k2_model_ms`)."""
    dtype = getattr(torch, dname)
    links = stage_table()

    def link_args(c, f, h, in_aff, drop, mask, seed):
        gen = torch.Generator(device=device).manual_seed(seed)

        def rnd(*shape, scale=1.0):
            return (torch.rand(*shape, generator=gen, device=device) * 2 - 1) * scale

        k = link_inputs(rnd, device, dtype, BATCH, c, f, h, in_aff, drop)
        return ((k["x"], k["dw"], k["pw"], k["aff2"], k["drop"]),
                (k["x"], k["g"], k["y"], k["aff4"], k["comb"], k["dw"], k["pw"], mask, k["drop"]))

    def timed_calls(name, kernel, fn):
        for _ in range(WARMUP):
            fn()
        hard_sync(device)
        ft.reset_launch_counts()
        out = (_event_ms(fn, iters), ft.LAUNCHES[kernel])
        if out[1] != iters:
            raise AssertionError(f"{name}: {out[1]} {kernel} launches for {iters} timed calls")
        return out

    timed, timed_k1 = [], []
    for i, (name, c, f, h, in_aff, drop, mask) in enumerate(links):
        fwd, args = link_args(c, f, h, in_aff, drop, mask, SEED + i)
        timed_k1.append(timed_calls(name, "chain_fwd", lambda: ft.chain_fwd(*fwd)))
        timed.append(timed_calls(name, "chain_bwd", lambda: ft.chain_bwd(*args)))
        del fwd, args
    with tempfile.TemporaryDirectory(prefix="unet_links_") as tdir:
        with trace(tdir, device):
            for i, (name, c, f, h, in_aff, drop, mask) in enumerate(links):
                _, args = link_args(c, f, h, in_aff, drop, mask, SEED + i)
                ft.chain_bwd(*args)
                for _ in range(PROFILED_CALLS):
                    with record_function(f"{CALL_SPAN}.{name}"):
                        ft.chain_bwd(*args)
                del args
        events = [e for path in profile_summary.trace_files(tdir)
                  for e in profile_summary.read_events(path)]
    rows, executed, useful, k1_executed, k1_useful = [], 0, 0, 0, 0
    for (name, c, f, h, in_aff, drop, mask), (ms, launches), (k1_ms, k1_launches) in zip(
            links, timed, timed_k1):
        summary = profile_summary.summarize_events(events, within=f"{CALL_SPAN}.{name}")
        profile_summary.check_complete(summary, f"link_floors {name}")
        split = _split(summary, PROFILED_CALLS)
        minus = ms - split["kernels_per_call"] * launch_ms
        nbytes, _ = roofline.work("chain_bwd", (name, c, f, h), dname, BATCH)
        bytes_ms = nbytes / roofline.PEAK_BYTES_PER_S * 1e3
        instr = k2_instructions(BATCH, h, h, c, f, in_aff, drop, mask, dname)
        model = k2_model_ms(instr, dname, product_ops, fma_gops)
        model_ms = sum(model.values())
        work = ft.chain_bwd_work(BATCH, h, h, c, f, dtype)
        executed, useful = executed + work.executed, useful + work.useful
        k1_work = ft.fwd_work(BATCH, h, h, c, f, dtype)
        k1_executed, k1_useful = k1_executed + k1_work.executed, k1_useful + k1_work.useful
        k1_bytes, _ = roofline.work("chain_fwd", (name, c, f, h), dname, BATCH)
        k1_bytes_ms = k1_bytes / roofline.PEAK_BYTES_PER_S * 1e3
        k1_model = k1_model_ms(k1_instructions(BATCH, h, h, c, f, in_aff, drop, dname), dname,
                               product_ops, fma_gops)
        k1_minus = k1_ms - 2 * launch_ms   # K1 and its row sums
        modes = [m for m, on in (("affine", in_aff), ("dropout", drop), ("mask", mask)) if on]
        rows.append({
            "link": name, "shape": f"{c}->{f}@{h}", "modes": modes or ["plain"],
            "launches": launches, "ms": ms, "minus_launch_ms": minus,
            "pass_a_ms": split["pass_a"], "pass_b_ms": split["pass_b"],
            "sums_ms": split["sums"], "glue_ms": split["glue"],
            "kernels_per_call": split["kernels_per_call"],
            "bytes_ms": bytes_ms, "x_bytes": minus / bytes_ms,
            "model_ms": model_ms, "model_pass_a_ms": model["pass_a"],
            "model_pass_b_ms": model["pass_b"], "model_sums_ms": model["sums"],
            "x_model": minus / model_ms, "executed_over_useful": work.executed / work.useful,
            "k1_launches": k1_launches, "k1_ms": k1_ms, "k1_minus_launch_ms": k1_minus,
            "k1_bytes_ms": k1_bytes_ms, "k1_x_bytes": k1_minus / k1_bytes_ms,
            "k1_model_ms": k1_model, "k1_x_model": k1_minus / k1_model,
            "k1_executed_over_useful": k1_work.executed / k1_work.useful,
        })
    totals = {key: sum(r[key] for r in rows) for key in (
        "ms", "minus_launch_ms", "pass_a_ms", "pass_b_ms", "sums_ms", "glue_ms", "bytes_ms",
        "model_ms", "model_pass_a_ms", "model_pass_b_ms", "model_sums_ms", "k1_ms",
        "k1_minus_launch_ms", "k1_bytes_ms", "k1_model_ms")}
    totals["executed_over_useful"] = executed / useful
    totals["k1_executed_over_useful"] = k1_executed / k1_useful
    totals["k1_x_bytes"] = totals["k1_minus_launch_ms"] / totals["k1_bytes_ms"]
    totals["k1_x_model"] = totals["k1_minus_launch_ms"] / totals["k1_model_ms"]
    totals["x_bytes"] = totals["minus_launch_ms"] / totals["bytes_ms"]
    totals["x_model"] = totals["minus_launch_ms"] / totals["model_ms"]
    return rows, totals


def print_table(rec: dict) -> None:
    print(f"  K1 {'link':<8} {'C->F@H':<14} {'modes':<15} {'ms':>7} {'-launch':>7} "
          f"{'bytes':>6} {'x':>6} {'model':>7} {'x':>5} {'exec/use':>8}")
    for r in rec["links"]:
        print(f"  K1 {r['link']:<8} {r['shape']:<14} {','.join(r['modes']):<15} "
              f"{r['k1_ms']:7.3f} {r['k1_minus_launch_ms']:7.3f} {r['k1_bytes_ms']:6.3f} "
              f"{r['k1_x_bytes']:6.1f} {r['k1_model_ms']:7.3f} {r['k1_x_model']:5.2f} "
              f"{r['k1_executed_over_useful']:8.3f}")
    t = rec["totals"]
    print(f"  K1 TOTAL {t['k1_minus_launch_ms']:.3f} ms (less launches) against the bytes floor "
          f"{t['k1_bytes_ms']:.3f} ({t['k1_x_bytes']:.1f}x) and the model {t['k1_model_ms']:.3f} "
          f"({t['k1_x_model']:.2f}x); executed / useful multiply-adds "
          f"{t['k1_executed_over_useful']:.3f}")
    print(f"  K2 {'link':<8} {'C->F@H':<14} {'modes':<15} {'ms':>7} {'-launch':>7} {'(a)':>7} "
          f"{'(b)':>7} {'sums':>6} {'glue':>6} {'bytes':>6} {'x':>6} {'model(a)':>8} "
          f"{'model(b)':>8} {'x':>5} {'exec/use':>8}")
    for r in rec["links"]:
        print(f"  K2 {r['link']:<8} {r['shape']:<14} {','.join(r['modes']):<15} {r['ms']:7.3f} "
              f"{r['minus_launch_ms']:7.3f} {r['pass_a_ms']:7.3f} {r['pass_b_ms']:7.3f} "
              f"{r['sums_ms']:6.3f} {r['glue_ms']:6.3f} {r['bytes_ms']:6.3f} "
              f"{r['x_bytes']:6.1f} {r['model_pass_a_ms']:8.3f} {r['model_pass_b_ms']:8.3f} "
              f"{r['x_model']:5.2f} {r['executed_over_useful']:8.3f}")
    print(f"  K2 TOTAL {t['minus_launch_ms']:.3f} ms (less launches; pass (a) "
          f"{t['pass_a_ms']:.3f}, "
          f"pass (b) {t['pass_b_ms']:.3f}, sums {t['sums_ms']:.3f}, glue {t['glue_ms']:.3f}) "
          f"against the bytes floor {t['bytes_ms']:.3f} ({t['x_bytes']:.1f}x) and the model "
          f"{t['model_ms']:.3f} ({t['x_model']:.2f}x; pass (a) {t['model_pass_a_ms']:.3f}, "
          f"pass (b) {t['model_pass_b_ms']:.3f}; products at {rec['product_tops']:.1f} Top/s, "
          f"CUDA-core instructions at K12b's fp32 rate); executed / useful multiply-adds "
          f"{t['executed_over_useful']:.3f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("link_floors: no CUDA device is available; it measures the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = roofline.card()
    dispatch = measure_dispatch_ms(device)
    fma = {d: measure_fma_rate(d, device) for d in ("float32", "bfloat16")}
    print(f"[{card}] K12a launch: {dispatch['device_ms'] * 1e3:.2f} us a launch on the device "
          f"(x + 1: {dispatch['library_ms'] * 1e3:.2f} us), {dispatch['stream_ms'] * 1e3:.2f} us "
          f"back to back from the host, {dispatch['host_ms'] * 1e3:.2f} us a "
          "launch-and-synchronise; K12b FMA rate: " + ", ".join(
              f"{d} {v['gops']:.0f} Gop/s ({100 * v['bound_share']:.1f}% of its bound)"
              for d, v in fma.items()))
    product_ops = measure_product_rate(args.dtype, device)
    print(f"[{card}] product rate ({'TF32' if args.dtype == 'float32' else 'bf16'} "
          f"{PRODUCT_MATRIX}^3 torch.matmul): {product_ops / 1e12:.1f} Top/s")
    rows, totals = time_links(args.dtype, args.iters, fma["float32"]["gops"], product_ops,
                              dispatch["device_ms"], device)
    rec = {"config": f"{HW}px b{BATCH} {args.dtype}, K1 and K2 links alone, {args.iters} timed "
                     f"calls after {WARMUP}", "card": card, "dtype": args.dtype,
           "iters": args.iters, "dispatch": dispatch, "fma": fma,
           "product_tops": product_ops / 1e12, "links": rows, "totals": totals}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=2)
    print_table(rec)
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
