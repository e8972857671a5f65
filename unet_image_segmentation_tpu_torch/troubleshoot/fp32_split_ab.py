"""Where the fp32 3xTF32 products should split their operands, on the card.

fp32 products run as three TF32 products on the tensor cores, each operand
split into a TF32 hi and lo part. This tool builds variants of
``csrc/upconcat.cu`` (K6) and ``csrc/chain_bwd.cu`` (K2/K10) from this
checkout's sources beside the library proper and times them against the
sources as they are, in fp32 at the 256 px U-Net's shapes at batch 32:

* ``tree``: the sources; each warp splits the fragments it loads; K2/K10's
  pass (b) holds the B fragments of a depth (``gemm_cols``), K6's fp32
  d_kernel the A fragments of a pair of depths (``dw_gemm_fp32``);
* ``split2`` / ``split3``: K6's forward and dx split A once where its
  stage lands, as K8 and K1 do, the lo parts in a buffer of their own, on
  a 2-stage ring (two CTAs an SM) or the 3-stage ring (one CTA an SM);
* ``afirst``: K2/K10's pass (b) holds the A fragments of a depth and
  splits B one fragment at a time (``gemm_3xtf32``'s order);
* ``one_acc``: K6's d_kernel and K2/K10's pass (b) sum every mma depth of
  a split into one accumulator in ``gemm_cols``' order, as before their
  fresh fragments; beside the times, K10's dpw at enc1.1 against
  fp64 at batch 32 and 2 (``dpw_digits``' inputs) and K6's d_kernel on
  ``upconcat_digits``' output tile at the four feeds at batch 32 and dec1
  at batch 2 (its inputs), for it and the tree.

Each variant is held to the plain versions (fp32 bars) before it is
timed; ``afirst`` must match the tree bit for bit. Writes
``build/fp32_split_ab.json``. Needs a CUDA card::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.fp32_split_ab [--iters 10]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from typing import Dict

import torch

from unet_image_segmentation_tpu_torch.ops import fused_sepconv as fs
from unet_image_segmentation_tpu_torch.ops import fused_train as ft
from unet_image_segmentation_tpu_torch.ops import fused_upconcat as fu
from unet_image_segmentation_tpu_torch.ops.kernels import build
from unet_image_segmentation_tpu_torch.troubleshoot import dpw_digits, roofline, upconcat_digits
from unet_image_segmentation_tpu_torch.troubleshoot.link_floors import link_inputs

HW = 256
FILTERS = (64, 128, 256, 512)
BATCH = 32
SEED = 2301
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "fp32_split_ab.json")
VARIANTS = ("tree", "split2", "split3", "afirst", "one_acc")
FEED_VARIANTS = ("tree", "split2", "split3", "one_acc")   # the variants of upconcat.cu
LINK_VARIANTS = ("tree", "afirst", "one_acc")   # the variants of chain_bwd.cu
DIGIT_VARIANTS = ("tree", "one_acc")

# 3xTF32 products with A split where it was staged (Ah, Al row-major, read
# with ldmatrix), each B fragment split just before its products
_SPLIT_A = r"""
template <int MT, int NT, int LDA, int LDB>
__device__ __forceinline__ void ab_gemm_presplit(float (&acc)[MT][NT][4], const float* Ah,
                                                 const float* Al, const float* B, int mt0,
                                                 int n0, int ksteps, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int off = ((mt0 + mi) * 16 + (lane & 15)) * LDA + ks * 8 + (lane >> 4) * 4;
      ldsm_x4(ah[mi], Ah + off);
      ldsm_x4(al[mi], Al + off);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_tf32(B[(ks * 8 + t + 4 * h) * LDB + n0 + ni * 8 + g], bh[h], bl[h]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) mma_3xtf32(acc[mi][ni], ah[mi], al[mi], bh, bl);
    }
  }
}
"""

# gemm_cols<float, kFresh>'s product (A [k][LDA] pixel-major, each depth into
# a fresh fragment, then added) in gemm_3xtf32's order
_A_FIRST = r"""
template <int MT, int NT, int LDA, int LDB>
__device__ __forceinline__ void ab_gemm_afirst(float (&acc)[MT][NT][4], const float* A,
                                               const float* B, int mt0, int n0, int ksteps,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const float* p = A + (ks * 8 + t) * LDA + (mt0 + mi) * 16 + g;
      split_tf32(p[0], ah[mi][0], al[mi][0]);
      split_tf32(p[8], ah[mi][1], al[mi][1]);
      split_tf32(p[4 * LDA], ah[mi][2], al[mi][2]);
      split_tf32(p[4 * LDA + 8], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_tf32(B[(ks * 8 + t + 4 * h) * LDB + n0 + ni * 8 + g], bh[h], bl[h]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        float d[4] = {};
        mma_3xtf32(d, ah[mi], al[mi], bh, bl);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += d[r];
      }
    }
  }
}
"""

# K6's forward / dx: split chunk i's A in place (hi) and into the lo buffer
# once it has landed, then a barrier before the products
_SPLIT_PASS = """    cp_async_commit();
    if constexpr (sizeof(T) == 4) {
      float* Ah = reinterpret_cast<float*>(As + st * kBM * LDK);
      float* Alo = reinterpret_cast<float*>(smem + L::Al);
      for (int idx = tid; idx < kBM * G; idx += kThreads) {
        const int r = idx / G, j = (idx % G) * V;
        const float4 v = *reinterpret_cast<const float4*>(Ah + r * LDK + j);
        uint32_t h[4], l[4];
        split_tf32(v.x, h[0], l[0]);
        split_tf32(v.y, h[1], l[1]);
        split_tf32(v.z, h[2], l[2]);
        split_tf32(v.w, h[3], l[3]);
        *reinterpret_cast<uint4*>(Ah + r * LDK + j) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(Alo + r * LDK + j) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      __syncthreads();
    }
    if (active) {"""


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f"fp32_split_ab: the source no longer holds {old[:60]!r} "
                         f"{count} time(s); update the variant")
    return src.replace(old, new)


def _inject(src: str, helper: str) -> str:
    return _sub(src, "namespace unet {\nnamespace {\n", "namespace unet {\nnamespace {\n" + helper)


def _upconcat_split(src: str, stages: int) -> str:
    """K6 with A split where staged on a ``stages``-deep fp32 ring; the
    launchers size shared memory from the variant's layout."""
    src = _inject(src, _SPLIT_A)
    src = _sub(src, "tiles_n == (N + kBN - 1) / kBN && smem == FeedSmem<T>::bytes",
               "tiles_n == (N + kBN - 1) / kBN")
    src = _sub(src, "  const dim3 grid((unsigned)((P + kBM - 1) / kBM * tiles_n), 1, 1);",
               "  smem = FeedSmem<T>::bytes;\n"
               "  const dim3 grid((unsigned)((P + kBM - 1) / kBM * tiles_n), 1, 1);", 2)
    src = _sub(src, "struct FeedSmem {\n",
               f"struct FeedSmem {{\n  static constexpr int S = sizeof(T) == 4 ? {stages} : kStages;\n")
    src = _sub(src, """  static constexpr int As = 0, Bs = As + e * kStages * kBM * LDK;
  static constexpr int upix = Bs + e * kStages * KC * LDN;""",
               """  static constexpr int As = 0, Bs = As + e * S * kBM * LDK;
  static constexpr int Al = Bs + e * S * KC * LDN;
  static constexpr int upix = Al + (e == 4 ? 4 * kBM * LDK : 0);""")
    head = "__device__ __forceinline__ void feed_gemm("
    a = src.index(head)
    b = src.index("  cp_async_wait_all();\n  __syncthreads();\n\n  // the tile in T", a)
    body = src[a:b].replace("kStages", "L::S")
    body = _sub(body, "    cp_async_commit();\n    if (active) {", _SPLIT_PASS)
    body = _sub(body, "gemm_3xtf32<2, 8, LDK, LDN>(acc, A, B, wm * 2, wn * 64, ksteps, lane);",
                "ab_gemm_presplit<2, 8, LDK, LDN>(acc, reinterpret_cast<const float*>(A), "
                "reinterpret_cast<const float*>(smem + L::Al), B, wm * 2, wn * 64, ksteps, lane);")
    return src[:a] + body + src[b:]


def variant_sources(csrc=build.CSRC) -> Dict[str, Dict[str, str]]:
    """The sources of every variant but ``tree`` (the library proper):
    ``{variant: {file name: source}}``, only the files the variant changes."""
    up = (csrc / "upconcat.cu").read_text()
    cb = (csrc / "chain_bwd.cu").read_text()
    dw = "dw_gemm_fp32<2, 8, LD, LD, KC / KS>(acc, xs(st), gb, wm * 2, wn * 64, lane);"
    dw_one = ("gemm_cols<2, 8, LD, LD>(acc, xs(st), gb, wm * 2, nm, wn * 64, "
              "(min(KC, p_end - p0) + KS - 1) / KS, lane);")
    dpw = """        gemm_cols<MT, NT, LDA, LDB, true>(acc, ms(st), gb, wm * MT, nm, wn * (TN / 4), ksteps,
                                          lane);"""

    return {
        "split2": {"upconcat.cu": _upconcat_split(up, 2)},
        "split3": {"upconcat.cu": _upconcat_split(up, 3)},
        "afirst": {"chain_bwd.cu": _sub(_inject(cb, _A_FIRST), dpw,
                                        "        ab_gemm_afirst<MT, NT, LDA, LDB>(acc, "
                                        "ms(st), gb, wm * MT, wn * (TN / 4), ksteps, lane);")},
        "one_acc": {"upconcat.cu": _sub(up, dw, dw_one),
                    "chain_bwd.cu": _sub(cb, "gemm_cols<MT, NT, LDA, LDB, true>(",
                                         "gemm_cols<MT, NT, LDA, LDB>(")},
    }


class _Library:
    """The kernel library with one variant's entries in place of its own."""

    def __init__(self, base, libs):
        self._base, self._libs = base, libs

    def __getattr__(self, name):
        for lib in self._libs:
            if hasattr(lib, name):
                return getattr(lib, name)
        return getattr(self._base, name)


def _build_variants(sources):
    """Compile every variant file into its own shared library, one nvcc
    process each, all started together; returns ``{variant: [CDLL]}``."""
    out = build.BUILD_DIR / "fp32_split_ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for variant, files in sources.items():
        for name, text in files.items():
            src = out / f"{variant}_{name}"
            src.write_text(text)
            lib = out / f"lib{variant}_{src.stem}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
                   "-o", str(lib), str(src)]
            jobs[(variant, lib)] = (cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {v: [] for v in sources}
    for (variant, path), (cmd, proc) in jobs.items():
        build._raise_on_failure(cmd, proc.wait(), proc.stdout.read())
        lib = ctypes.CDLL(str(path))
        build._bind(lib, {n: a for n, a in build.SIGNATURES.items() if hasattr(lib, n)},
                    ctypes.c_int)
        build._bind(lib, {n: a for n, a in build.WORKSPACE_SIGNATURES.items()
                          if hasattr(lib, n)}, ctypes.c_longlong)
        libs[variant].append(lib)
    return libs


def _ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp_min(1e-30)).item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fp32_split_ab needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = roofline.card()
    base = build.load_library()
    libs = {v: _Library(base, ls) for v, ls in _build_variants(variant_sources()).items()}
    libs["tree"] = base
    gen = torch.Generator().manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * scale

    rnd.gen = gen
    report = {"card": card, "feeds": {}, "links": {}}
    print(f"fp32 K6 at batch {BATCH}, ms forward / backward by variant (one_acc's bf16 "
          f"backward bit for bit the tree's) [{card}]:")
    for name, c, f, h in roofline.upconcat_shapes(HW, FILTERS):
        x, g = rnd(BATCH, h, h, c).to(dev), rnd(BATCH, 2 * h, 2 * h, 2 * f).to(dev)
        kern = rnd(2, 2, f, c, scale=(6 / (4 * (c + f))) ** 0.5).to(dev)
        bias, skip = (0.1 * rnd(f)).to(dev), rnd(BATCH, 2 * h, 2 * h, f).to(dev)
        fwd, bwd = (x, kern, bias, skip), (x, kern, g)
        want_cat, want = fu.upconcat_reference(*fwd), fu.upconcat_bwd_reference(*bwd)
        times = {v: [0.0, 0.0] for v in FEED_VARIANTS}
        for rnd_i in range(2):   # two rounds, the second in reverse order
            for v in FEED_VARIANTS if rnd_i == 0 else FEED_VARIANTS[::-1]:
                build._lib = libs[v]
                if rnd_i == 0:
                    got = fu.upconcat_bwd(*bwd)
                    errs = [_rel(fu.upconcat(*fwd), want_cat), _rel(got[0], want[0]),
                            _rel(got[1], want[1]), _rel(got[2], want[2])]
                    if max(errs[:2]) > 1e-4 or max(errs[2:]) > 5e-4 or \
                            not torch.equal(got[3], want[3]):
                        raise AssertionError(f"{v} at {name}: errors {errs}")
                times[v][0] += _ms(lambda: fu.upconcat(*fwd), args.iters) / 2
                times[v][1] += _ms(lambda: fu.upconcat_bwd(*bwd), args.iters) / 2
        # one_acc differs from the tree in fp32 only: bf16 bit for bit
        bf16 = (x.bfloat16(), kern, g.bfloat16())
        outs = []
        for v in DIGIT_VARIANTS:
            build._lib = libs[v]
            outs.append(fu.upconcat_bwd(*bf16))
        build._lib = base
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"one_acc at {name}: K6's bf16 backward is not the tree's")
        report["feeds"][name] = times
        print(f"  {name} {c}->{f}@{h}: " + ", ".join(
            f"{v} {t[0]:.3f} / {t[1]:.3f}" for v, t in times.items()))
    print(f"fp32 K2 / K10 at batch {BATCH}, ms by variant (afirst bit for bit the tree's, "
          "one_acc held to plain):")
    tot = {v: [0.0, 0.0] for v in LINK_VARIANTS}
    for name, c, f, h, in_aff, drop, mc in roofline.chain_links(HW, FILTERS):
        k = link_inputs(rnd, dev, torch.float32, BATCH, c, f, h, in_aff, drop)
        k2 = (k["x"], k["g"], k["y"], k["aff4"], k["comb"], k["dw"], k["pw"], mc, k["drop"])
        k10 = (k["x"], k["g"], k["dw"], k["pw"])
        outs, times = {}, {v: [0.0, 0.0] for v in tot}
        for rnd_i in range(2):
            for v in LINK_VARIANTS if rnd_i == 0 else LINK_VARIANTS[::-1]:
                build._lib = libs[v]
                if rnd_i == 0:
                    outs[v] = [t for t in (*ft.chain_bwd(*k2), *fs.sepconv_bwd(*k10))
                               if t is not None]
                    if v == "one_acc":   # its ddw and dpw (K2, K10) against plain
                        got = (ft.chain_bwd(*k2), fs.sepconv_bwd(*k10))
                        want = (ft.chain_bwd_reference(*k2), fs.sepconv_bwd_reference(*k10))
                        errs = [_rel(a[i], b[i]) for a, b in zip(got, want) for i in (1, 2)]
                        if max(errs) > 5e-4:
                            raise AssertionError(f"one_acc at {name}: errors {errs}")
                times[v][0] += _ms(lambda: ft.chain_bwd(*k2), args.iters) / 2
                times[v][1] += _ms(lambda: fs.sepconv_bwd(*k10), args.iters) / 2
        build._lib = base
        if not all(torch.equal(a, b) for a, b in zip(outs["tree"], outs["afirst"])):
            raise AssertionError(f"afirst at {name}: not bit for bit the tree's")
        for v in tot:
            tot[v][0] += times[v][0]
            tot[v][1] += times[v][1]
        report["links"][name] = times
        print(f"  {name} {c}->{f}@{h}: " + ", ".join(
            f"{v} {t[0]:.3f} / {t[1]:.3f}" for v, t in times.items()))
    print("  over the 18 links: " + ", ".join(
        f"{v} K2 {t[0]:.3f}, K10 {t[1]:.3f}" for v, t in tot.items()))
    report["dpw_digits"] = {}
    for batch in (32, 2):
        data = dpw_digits.inputs(batch)
        t = {key: torch.from_numpy(val).to(dev) for key, val in data.items()}
        errs = {}
        for v in ("tree", "one_acc"):
            build._lib = libs[v]
            dpw, m, _ = dpw_digits.kernel_run(t["x"], t["g"], t["dw"], t["pw"])
            g = data["g"].reshape(-1, data["g"].shape[-1])
            errs[v] = dpw_digits.rel_err(dpw, dpw_digits.exact(m, g))
        build._lib = base
        report["dpw_digits"][batch] = errs
        print(f"  K10 fp32 dpw at {dpw_digits.BLOCK[0]}, batch {batch}, max err / max|fp64|: "
              + ", ".join(f"{v} {e:.2e}" for v, e in errs.items()))
    report["upconcat_digits"] = {}
    for spec in upconcat_digits.RUNS:
        name, batch = spec.split(":")
        data = upconcat_digits.inputs(int(batch), *upconcat_digits.FEEDS[name])
        errs = {}
        for v in DIGIT_VARIANTS:
            build._lib = libs[v]
            kernel, m, g, _ = upconcat_digits.kernel_tile(name, int(batch), dev, data)
            errs[v] = dpw_digits.rel_err(kernel, dpw_digits.exact(m, g))
        build._lib = base
        report["upconcat_digits"][spec] = errs
        print(f"  K6 fp32 d_kernel at {name}, batch {batch}, one "
              f"{upconcat_digits.TILE}x{upconcat_digits.TILE} tile, max err / max|fp64|: "
              + ", ".join(f"{v} {e:.2e}" for v, e in errs.items()))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
