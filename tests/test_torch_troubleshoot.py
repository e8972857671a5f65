"""The port's troubleshoot tools on the CPU.

K12's plain versions against copies of the JAX probe kernels
(``troubleshoot/link_floors.py:56-57`` and ``:87-93``) run through
``pl.pallas_call(..., interpret=True)`` with the same VMEM specs; the link
table against the JAX tool's; the bounds, the K2 instruction count and the
kernel-site map by hand; the Chrome-trace reader on hand-written and real
CPU traces; ``fit`` with ``profile_dir``; and every tool's refusal to run
without a card unless asked for the CPU. Inputs come from numpy seeds.
"""

import collections
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from unet_image_segmentation_tpu.troubleshoot import link_floors as jax_link_floors
from unet_image_segmentation_tpu_torch.config import Config
from unet_image_segmentation_tpu_torch.ops import fused_train as ft
from unet_image_segmentation_tpu_torch.ops import probes
from unet_image_segmentation_tpu_torch.train import loop
from unet_image_segmentation_tpu_torch.train.state import create_train_state
from unet_image_segmentation_tpu_torch.train.steps import make_train_step
from unet_image_segmentation_tpu_torch.troubleshoot import (
    check_gpu_benchmark,
    check_install,
    dpw_digits,
    fp32_split_ab,
    link_floors,
    pair_phases,
    probe_sass,
    profile_summary,
    roofline,
    step_attribution,
    upconcat_digits,
)
from unet_image_segmentation_tpu_torch.utils import profiling

FMA_K = 64
_VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _jax_dispatch(x):
    """The body of the JAX tool's measure_dispatch_ms kernel."""
    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                          in_specs=[_VMEM], out_specs=_VMEM, interpret=True)(x)


def _jax_fma(x, k):
    """The body of the JAX tool's measure_vpu_rate kernel, k steps."""
    dt = x.dtype

    def kernel(x_ref, o_ref):
        one_eps = jnp.asarray(1.000001, dt)

        def body(i, acc):
            return acc * one_eps + x_ref[...]

        o_ref[...] = jax.lax.fori_loop(0, k, body, x_ref[...])

    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, dt),
                          in_specs=[_VMEM], out_specs=_VMEM, interpret=True)(x)


def test_dispatch_probe_matches_the_jax_kernel_exactly():
    x = np.random.RandomState(0).randn(8, 128).astype(np.float32)
    want = np.asarray(_jax_dispatch(jnp.asarray(x)))
    got = probes.dispatch_probe(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fma_probe_matches_the_jax_kernel(dtype):
    """bf16: bit for bit (one_eps rounds to 1.0, the loop only adds and
    saturates); fp32: within K * 2^-24 of max|want| (FMA contraction)."""
    x = (np.random.RandomState(1).rand(16, 128) * 1e-3).astype(np.float32)
    want = np.asarray(_jax_fma(jnp.asarray(x).astype(dtype), FMA_K).astype(jnp.float32))
    got = probes.fma_probe(torch.from_numpy(x).to(getattr(torch, dtype)), FMA_K).float().numpy()
    if dtype == "bfloat16":
        assert float(probes.one_eps(torch.bfloat16)) == 1.0
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= FMA_K * 2.0 ** -24 * np.abs(want).max()
        assert not np.array_equal(got, x * (FMA_K + 1))   # one_eps != 1 in fp32


def test_probe_wrappers_run_their_plain_versions_on_the_cpu():
    probes.reset_launch_counts()
    x = torch.from_numpy(np.random.RandomState(2).rand(4, 6).astype(np.float32))
    assert torch.equal(probes.dispatch_probe(x), x + 1)
    assert torch.equal(probes.fma_probe(x, 3), probes.fma_probe_reference(x, 3))
    assert probes.LAUNCHES == {"dispatch_probe": 0, "fma_probe": 0}
    with pytest.raises(ValueError, match="k = -1"):
        probes.fma_probe(x, -1)


def test_stage_table_has_the_jax_chain_shapes():
    """18 links with the JAX table's (C, F, H), but enc1.1 takes the 3 image
    channels (K2 masks C; the TPU chain pads them to 16)."""
    want = []
    for _, h, c_in, f1, f2, _ in jax_link_floors.stage_table():
        want += [(c_in, f1, h), (f1, f2, h)]
    got = [(c, f, h) for _, c, f, h, *_ in link_floors.stage_table()]
    assert len(got) == 18
    assert want[0] == (16, 64, 256) and got[0] == (3, 64, 256)
    assert got[1:] == want[1:]


def test_stage_table_modes_are_those_of_the_train_step(monkeypatch):
    """The (C, F, H, input affine, dropout, output mask) of every K1/K2 call
    of a fused train step are the table's links, at 32 px, filters (8, 16)."""
    seen = collections.Counter()
    fwd, bwd = ft.chain_fwd, ft.chain_bwd

    def spy_fwd(x, dw, pw, in_aff=None, drop=None):
        seen[("fwd", x.shape[-1], pw.shape[-1], x.shape[1], in_aff is not None,
              drop is not None)] += 1
        return fwd(x, dw, pw, in_aff, drop)

    def spy_bwd(x, g, y, in_aff, comb, dw, pw, mask_combine, drop=None):
        seen[("bwd", x.shape[-1], pw.shape[-1], x.shape[1], in_aff is not None,
              drop is not None, bool(mask_combine))] += 1
        return bwd(x, g, y, in_aff, comb, dw, pw, mask_combine, drop)

    monkeypatch.setattr(ft, "chain_fwd", spy_fwd)
    monkeypatch.setattr(ft, "chain_bwd", spy_bwd)
    cfg = Config().override(model__image_height=32, model__image_width=32,
                            model__filters=(8, 16), model__use_pallas=True,
                            model__dropout_rate=0.3, train__batch_size=2)
    state = create_train_state(cfg, device="cpu")
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32))
    m = torch.from_numpy((rng.rand(2, 32, 32, 1) > 0.5).astype(np.float32))
    make_train_step(state.model, "dice")(state, x, m)
    want = collections.Counter()
    for _, c, f, h, aff, drop, mask in link_floors.stage_table(32, (8, 16)):
        want[("fwd", c, f, h, aff, drop)] += 1
        want[("bwd", c, f, h, aff, drop, mask)] += 1
    assert seen == want


def test_bounds_by_hand():
    # K2 at enc1.2 (64 -> 64 @ 256), batch 32, bf16: x, g, y, dx once each
    # (2 bytes), dw and pw, then ddw, S, T and dpw in fp32
    px = 32 * 256 * 256
    nbytes = 2 * (px * (64 + 2 * 64 + 64) + 9 * 64 + 64 * 64) + 4 * (11 * 64 + 64 * 64)
    assert nbytes == 1_073_770_368
    link = ("enc1.2", 64, 64, 256, True, False, False)
    assert roofline.bounds_ms("chain_bwd", link, "bfloat16", 32) == \
        pytest.approx((nbytes / 3.35e12 * 1e3, "bytes"))
    # fp32: 4-byte activations (0.641 ms) outweigh its 2*(2*C*F + 27*C)
    # operations a pixel (0.621 ms even if all ran on the CUDA cores)
    nbytes32 = 4 * (px * 256 + 9 * 64 + 64 * 64) + 4 * (11 * 64 + 64 * 64)
    ops = 2 * px * (2 * 64 * 64 + 27 * 64)
    assert roofline.work("chain_bwd", link, "float32", 32) == (nbytes32, ops)
    assert roofline.bounds_ms("chain_bwd", link, "float32", 32) == \
        pytest.approx((nbytes32 / 3.35e12 * 1e3, "bytes"))
    assert ops / 67e12 * 1e3 == pytest.approx(0.62101, rel=1e-4)
    # K12b at (1024, 512), K = 2048: 2.15 GFLOP, bound by operations
    n = 1024 * 512
    assert roofline.bounds_ms("fma_probe", (n, 2048), "float32") == \
        pytest.approx((0.032052, "operations"), rel=1e-4)
    assert roofline.bounds_ms("fma_probe", (n, 2048), "bfloat16") == \
        pytest.approx((0.016050, "operations"), rel=1e-4)
    assert roofline.work("fma_probe", (n, 2048), "float32") == (2 * 4 * n, 2 * 2048 * n)
    # K12a: 4 KiB in, 4 KiB out
    assert roofline.bounds_ms("dispatch_probe", (1024,), "float32") == \
        pytest.approx((8192 / 3.35e12 * 1e3, "bytes"))
    total, by = roofline.sum_bounds("chain_bwd", link_floors.stage_table(), "bfloat16", 32)
    assert by == "bytes" and total == pytest.approx(sum(
        roofline.bounds_ms("chain_bwd", lk, "bfloat16", 32)[0]
        for lk in link_floors.stage_table()))


def test_k7_bound_by_hand():
    """K7 at the bottleneck (512 -> 1024 -> 1024 @ 16), batch 32: its
    products on the tensor cores (bf16 at 989 TFLOP/s; fp32 as 3xTF32,
    three TF32 products each at 495) while the depthwise runs on the CUDA
    cores (67 TFLOP/s fp32), the larger of the two against the bytes."""
    stage = ("bneck", 512, 0, 1024, 1024, 16, "plain")
    px = 32 * 16 * 16
    gemm, dw = 2 * px * (512 * 1024 + 1024 * 1024), 2 * px * (9 * 512 + 9 * 1024)
    assert roofline.pair_ops(stage, 32) == (gemm, dw)
    nbytes = 2 * (px * (512 + 1024) + 9 * 512 + 512 * 1024 + 9 * 1024 + 1024 * 1024)
    assert roofline.work("sepconv_pair", stage, "bfloat16", 32) == (nbytes, gemm + dw)
    assert roofline.bounds_ms("sepconv_pair", stage, "bfloat16", 32) == \
        pytest.approx((gemm / 989e12 * 1e3, "operations"))
    assert roofline.bounds_ms("sepconv_pair", stage, "float32", 32) == \
        pytest.approx((3 * gemm / 495e12 * 1e3, "operations"))
    # enc1 (3 -> 64 -> 64 @ 256, pooled): fp32's 4-byte activations bound it
    enc1 = ("enc1", 3, 0, 64, 64, 256, "pool")
    px = 32 * 256 * 256
    nbytes32 = 4 * (px * 3 + px * 64 * 1.25 + 27 + 3 * 64 + 9 * 64 + 64 * 64)
    assert roofline.bounds_ms("sepconv_pair", enc1, "float32", 32) == \
        pytest.approx((nbytes32 / 3.35e12 * 1e3, "bytes"))


def test_k7_int8_bound_by_hand():
    """K7's int8 I/O mode moves 1-byte x, x2, y and pooled values beside
    its weights in the compute dtype, with the float mode's operations: the
    nine stages' bytes bound at batch 32 in bf16 is the float one less the
    activations' second byte; in fp32 the stages the float mode's bytes
    bound (enc1, dec1) fall to their 3xTF32 products' bound."""
    dec1 = ("dec1", 64, 64, 64, 64, 256, "x2")
    px = 32 * 256 * 256
    weights = 9 * 128 + 128 * 64 + 9 * 64 + 64 * 64
    for dname, e in (("bfloat16", 2), ("float32", 4)):
        nbytes = px * (128 + 64) + e * weights
        assert roofline.work("sepconv_pair_int8", dec1, dname, 32) == (
            nbytes, sum(roofline.pair_ops(dec1, 32)))
        assert roofline.work("sepconv_pair", dec1, dname, 32)[0] == e * px * (128 + 64) + \
            e * weights
    stages = roofline.stage_shapes(256, (64, 128, 256, 512))
    t8, by8 = roofline.sum_bounds("sepconv_pair_int8", stages, "bfloat16", 32)
    t16, by16 = roofline.sum_bounds("sepconv_pair", stages, "bfloat16", 32)
    assert by8 == by16 == "bytes" and 0.44 < t8 < 0.46 < 0.73 < t16 < 0.74
    for stage in stages:   # fewer bytes, the same operations
        t8, by8 = roofline.bounds_ms("sepconv_pair_int8", stage, "float32", 32)
        t32, by32 = roofline.bounds_ms("sepconv_pair", stage, "float32", 32)
        assert t8 <= t32 and (by32 == "bytes" or (t8, by8) == (t32, by32))
    name = ("void unet::(anonymous namespace)::sepconv_pair_cluster_kernel<__nv_bfloat16, 128, 1>"
            "(unet::(anonymous namespace)::PairArgs<__nv_bfloat16, signed char>)")
    assert roofline.entry_of(name) == "sepconv_pair_cluster_kernel"
    assert roofline.KERNELS["sepconv_pair_int8"][1:] == roofline.KERNELS["sepconv_pair"][1:]


def test_k7_quant_out_and_edge_bounds_by_hand():
    """K7's float-in/int8-out mode reads C elements in the compute dtype and
    writes F2 bytes a pixel; its edge flags move nothing more than the float
    mode (the same bytes and operations). A slab shape carries its width
    after the mode: (H + 4) x W pixels."""
    dec1 = ("dec1", 64, 64, 64, 64, 516, "x2", 1024)
    px = 2 * 516 * 1024
    weights = 9 * 128 + 128 * 64 + 9 * 64 + 64 * 64
    for dname, e in (("bfloat16", 2), ("float32", 4)):
        assert roofline.work("sepconv_pair_quant_out", dec1, dname, 2) == (
            e * px * 128 + px * 64 + e * weights, sum(roofline.pair_ops(dec1, 2)))
        assert roofline.work("sepconv_pair_edge", dec1, dname, 2) == \
            roofline.work("sepconv_pair", dec1, dname, 2)
        assert roofline.work("sepconv_pair", dec1, dname, 2)[0] == e * px * 192 + e * weights
    assert roofline.pair_ops(dec1, 2) == roofline.pair_ops(("dec1", 64, 64, 64, 64, 516, "x2",
                                                            1024), 2)
    square = ("enc1", 3, 0, 64, 64, 256, "pool")
    assert roofline.work("sepconv_pair", square, "bfloat16", 32) == \
        roofline.work("sepconv_pair", square + (256,), "bfloat16", 32)
    for name in ("sepconv_pair_quant_out", "sepconv_pair_edge"):
        assert roofline.KERNELS[name][1:] == roofline.KERNELS["sepconv_pair"][1:]


def test_pair_phases_marks_match_the_kernel():
    """Every PAIR_PHASE mark of sepconv_pair.cu names one of the tool's
    phases, in order, and the kernel's buffer holds as many a CTA."""
    from unet_image_segmentation_tpu_torch.ops.kernels import build

    src = (build.CSRC / "sepconv_pair.cu").read_text()
    marks = [int(m) for m in re.findall(r"PAIR_PHASE\((\d+)\)", src)]
    assert marks == list(range(len(pair_phases.PHASES)))
    assert f"kPairPhases = {len(pair_phases.PHASES)};" in src


def test_pair_phases_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pair_phases.main(["--iters", "1"]) == 1
    assert "CUDA card" in capsys.readouterr().err


def test_eval_ab_needs_a_card(monkeypatch, capsys):
    from unet_image_segmentation_tpu_torch.troubleshoot import eval_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert eval_ab.main(["--against", "."]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_fp32_split_ab_variants_build_from_the_sources():
    """Each variant of fp32_split_ab applies to the kernels' sources as they
    are: it changes the files it names, brings its product, and K6's
    split-A variants re-size the forward/dx stages (a changed source that a
    variant no longer fits raises)."""
    from unet_image_segmentation_tpu_torch.ops.kernels import build

    variants = fp32_split_ab.variant_sources()
    assert ("tree",) + tuple(variants) == fp32_split_ab.VARIANTS
    for name, files in variants.items():
        for fname, src in files.items():
            assert src != (build.CSRC / fname).read_text()
    for stages in (2, 3):
        src = variants[f"split{stages}"]["upconcat.cu"]
        assert f"sizeof(T) == 4 ? {stages} : kStages" in src
        assert src.count("ab_gemm_presplit<2, 8, LDK, LDN>(") == 1
    assert all(src.count("ab_gemm_afirst<") == 1 for src in variants["afirst"].values())
    # one_acc: K6's d_kernel and K2/K10's pass (b) back on one accumulator a
    # split, where the sources put fp32's mma depths into fresh fragments
    assert set(variants["one_acc"]) == {"upconcat.cu", "chain_bwd.cu"}
    fresh = "dw_gemm_fp32<2, 8, LD, LD, KC / KS>("
    assert (build.CSRC / "upconcat.cu").read_text().count(fresh) == 1
    k6 = variants["one_acc"]["upconcat.cu"]
    assert fresh not in k6 and k6.count("gemm_cols<2, 8, LD, LD>(") == 2
    assert "gemm_cols<MT, NT, LDA, LDB, true>(" not in variants["one_acc"]["chain_bwd.cu"]
    assert {v for v, files in variants.items() if "upconcat.cu" in files} == \
        set(fp32_split_ab.FEED_VARIANTS) - {"tree"}
    with pytest.raises(ValueError, match="update the variant"):
        fp32_split_ab._upconcat_split("namespace unet {\nnamespace {\n", 2)


def test_fp32_split_ab_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        fp32_split_ab.main(["--iters", "1"])


def test_k2_instruction_count_by_hand():
    """One 8x8 tile, C = 3 (one 64-wide slice), F = 8, no modes, bf16: dm
    on 112 GEMM rows x the first warp column's 16 channels x one k16 step;
    dpw on one m16 tile x one warp's 16 columns x 64 pixels; on the CUDA
    cores gy over the ring and the 32 channels of the chunk, 27 FMAs a
    pixel for each of the 3 channels, the 4 row groups' sum of 11 partials."""
    got = link_floors.k2_instructions(1, 8, 8, 3, 8, False, False, False)
    pass_a = 100 * 32 * 3 + 64 * 3 * 27 + 3 * 4 * 11
    assert got == {"pass_a_mma": 112 * 16 * 16, "pass_b_mma": 16 * 16 * 64, "pass_a_fma": pass_a,
                   "sums": 11 * 3 + 3 * 8}
    # the input affine (its mask, S, T, and z of 2 new values a pixel) and
    # the output mask (2 more a gy value)
    modes = link_floors.k2_instructions(1, 8, 8, 3, 8, True, False, True)
    assert modes["pass_a_fma"] == pass_a + 100 * 32 * 2 + 64 * 3 * (6 + 2 * 3)
    drop = link_floors.k2_instructions(1, 8, 8, 3, 8, False, True, False)
    assert drop["pass_a_fma"] == pass_a + 64 * 3 * (1 + 2 * 1)
    fp32 = link_floors.k2_instructions(1, 8, 8, 3, 8, False, False, False, "float32")
    assert fp32["pass_a_mma"] == 112 * 16 * 8   # F = 8 is one k8 step; chunks of 16
    assert fp32["pass_a_fma"] == 100 * 16 * 3 + 64 * 3 * 27 + 3 * 4 * 11
    plan = link_floors.k2_plan(32, 256, 256, 64, 64)
    assert plan["ctas_a"] == 32 * 1024 and plan["rows_a"] == 32 * 1024
    # 264 splits asked, 7944.2 pixels each rounded up to 7968 (32-pixel chunks)
    assert plan["splits"] == -(-32 * 256 * 256 // 7968) == 264
    # a 128-wide slice has 2 row groups; C = 1024 takes 8 slices a tile
    deep = link_floors.k2_plan(32, 16, 16, 1024, 1024)
    assert deep["ctas_a"] == 4 * 8 * 32 and deep["wc"] == 128
    got = link_floors.k2_instructions(32, 16, 16, 1024, 1024, True, False, True)
    assert got["pass_a_fma"] == deep["ctas_a"] * (
        100 * 1024 * 5 + 128 * (64 * (27 + 6 + 6) + 2 * 11))


def test_k2_model_by_hand():
    """Products at the measured product rate (three TF32 products for each
    fp32 one), CUDA-core instructions at K12b's fp32 rate (2 operations an
    FMA instruction)."""
    instr = {"pass_a_mma": 10 ** 9, "pass_b_mma": 5 * 10 ** 8, "pass_a_fma": 2 * 10 ** 8,
             "sums": 10 ** 6}
    bf16 = link_floors.k2_model_ms(instr, "bfloat16", 500e12, 50e3)
    assert bf16 == pytest.approx({"pass_a": 2e9 / 500e12 * 1e3 + 4e8 / 50e12 * 1e3,
                                  "pass_b": 1e9 / 500e12 * 1e3, "sums": 2e6 / 50e12 * 1e3})
    fp32 = link_floors.k2_model_ms(instr, "float32", 250e12, 50e3)
    assert fp32["pass_b"] == pytest.approx(3 * 1e9 / 250e12 * 1e3)


def test_k2_k10_bounds_on_their_route_by_hand():
    """K2 and K10 at the bottleneck's second link (1024 -> 1024 @ 16),
    batch 32: dm and dpw on the tensor cores (bf16 at 989 TFLOP/s; fp32 as
    3xTF32 at 495) beside the 27*C elementwise multiply-adds on the CUDA
    cores (67 TFLOP/s fp32), the larger of the two against the bytes."""
    link = ("bneck.2", 1024, 1024, 16, True, False, True)
    px = 32 * 16 * 16
    gemm, rest = 2 * px * 2 * 1024 * 1024, 2 * px * 27 * 1024
    assert roofline.bwd_ops("chain_bwd", link, 32) == (gemm, rest)
    assert roofline.bwd_ops("sepconv_bwd", link, 32) == (gemm, rest + px * 1024)
    assert roofline.bounds_ms("chain_bwd", link, "bfloat16", 32) == \
        pytest.approx((gemm / 989e12 * 1e3, "operations"))
    assert roofline.bounds_ms("chain_bwd", link, "float32", 32) == \
        pytest.approx((3 * gemm / 495e12 * 1e3, "operations"))
    # enc1.1 (3 -> 64 @ 256): the bytes bound it in both dtypes
    enc = ("enc1.1", 3, 64, 256, False, False, False)
    for dname in ("bfloat16", "float32"):
        nbytes, _ = roofline.work("chain_bwd", enc, dname, 32)
        assert roofline.bounds_ms("chain_bwd", enc, dname, 32) == \
            pytest.approx((nbytes / 3.35e12 * 1e3, "bytes"))


def test_k1_k8_bounds_on_their_route_by_hand():
    """K1, K8 and K9 at the bottleneck's second block (1024 -> 1024 @ 16),
    batch 32: the pointwise products on the tensor cores (bf16 at 989
    TFLOP/s; fp32 as 3xTF32 at 495) beside the 9*C depthwise on the CUDA
    cores (67 TFLOP/s fp32), the larger against the bytes. K9 runs K1's
    body, so it has K1's bound."""
    link = ("bneck.2", 1024, 1024, 16, True, False, True)
    px = 32 * 16 * 16
    gemm, dw = 2 * px * 1024 * 1024, 2 * px * 9 * 1024
    assert roofline.fwd_ops("chain_fwd", link, 32) == (gemm, dw)
    assert roofline.fwd_ops("sepconv_block", (1024, 1024, 16), 32) == (gemm, dw)
    for name, shape in (("chain_fwd", link), ("sepconv_block", (1024, 1024, 16))):
        assert roofline.bounds_ms(name, shape, "bfloat16", 32) == \
            pytest.approx((gemm / 989e12 * 1e3, "operations"))
        assert roofline.bounds_ms(name, shape, "float32", 32) == \
            pytest.approx((3 * gemm / 495e12 * 1e3, "operations"))
    nbytes32, ops = roofline.work("sepconv_stats", link, "float32", 32)
    assert ops == gemm + dw
    assert roofline.fwd_ops("sepconv_stats", link, 32) == (gemm, dw)
    assert roofline.bounds_ms("sepconv_stats", link, "float32", 32) == \
        pytest.approx((3 * gemm / 495e12 * 1e3, "operations"))
    # enc1.2 (64 -> 64 @ 256): the bytes bound K1 in both dtypes, and K9 in bf16
    enc = ("enc1.2", 64, 64, 256, True, False, False)
    for dname in ("bfloat16", "float32"):
        nbytes, _ = roofline.work("chain_fwd", enc, dname, 32)
        assert roofline.bounds_ms("chain_fwd", enc, dname, 32) == \
            pytest.approx((nbytes / 3.35e12 * 1e3, "bytes"))
    # over the 18 links: bf16 bytes-bound (1.272 ms); fp32 3.07 ms, for K9
    # too (its FMA route was held to 5.39 ms of CUDA-core operations)
    links = link_floors.stage_table()
    bf16 = roofline.sum_bounds("chain_fwd", links, "bfloat16", 32)
    assert bf16[1] == "bytes" and bf16[0] == pytest.approx(1.2722, abs=1e-3)
    fp32 = roofline.sum_bounds("chain_fwd", links, "float32", 32)
    assert fp32[0] == pytest.approx(3.0722, abs=1e-3)
    assert roofline.sum_bounds("sepconv_stats", links, "float32", 32)[0] == \
        pytest.approx(3.0722, abs=1e-3)
    assert roofline.sum_bounds("sepconv_stats", links, "bfloat16", 32) == bf16


def test_k6_bounds_on_their_route_by_hand():
    """K6 at dec1 (x 128 -> cat 2x64 @ 256 px) and dec4 (1024 -> 2x512 @ 32
    px), batch 32: its products (C*4F multiply-adds a pixel of x forward,
    twice that backward) on the tensor cores (bf16 at 989 TFLOP/s; fp32 as
    3xTF32, three TF32 products each at 495), the larger against the
    bytes: x, skip and cat (forward), x, g, dx and d_skip (backward)."""
    dec1, dec4 = ("dec1", 128, 64, 128), ("dec4", 1024, 512, 16)
    px = 32 * 128 * 128
    gemm = 2 * px * 128 * 4 * 64
    assert roofline.feed_ops("upconcat", dec1, 32) == (gemm, 0.0)
    assert roofline.feed_ops("upconcat_bwd", dec1, 32) == (2 * gemm, 0.0)
    nbytes = 2 * (px * 128 + 4 * px * 64 + 4 * 128 * 64 + 8 * px * 64)
    assert roofline.bounds_ms("upconcat", dec1, "bfloat16", 32) == \
        pytest.approx((nbytes / 3.35e12 * 1e3, "bytes"))
    assert roofline.bounds_ms("upconcat", dec1, "float32", 32) == \
        pytest.approx((2 * nbytes / 3.35e12 * 1e3, "bytes"))
    px4 = 32 * 16 * 16
    gemm4 = 2 * px4 * 1024 * 4 * 512
    assert roofline.bounds_ms("upconcat_bwd", dec4, "float32", 32) == \
        pytest.approx((3 * 2 * gemm4 / 495e12 * 1e3, "operations"))
    # over the four feeds: bf16 bytes-bound both ways (0.528 and 0.632 ms);
    # fp32 1.258 forward (dec4 and dec3 on their products), 1.891 backward
    feeds = roofline.upconcat_shapes(256, (64, 128, 256, 512))
    fwd, bwd = (roofline.sum_bounds(n, feeds, "bfloat16", 32) for n in ("upconcat", "upconcat_bwd"))
    assert fwd == pytest.approx((0.5275, "bytes"), abs=1e-4)
    assert bwd == pytest.approx((0.6316, "bytes"), abs=1e-4)
    assert roofline.sum_bounds("upconcat", feeds, "float32", 32)[0] == \
        pytest.approx(1.2580, abs=1e-4)
    assert roofline.sum_bounds("upconcat_bwd", feeds, "float32", 32) == \
        pytest.approx((1.8906, "operations"), abs=1e-4)


def test_k1_instruction_count_and_model_by_hand():
    """One 8x8 tile, C = 3, F = 16, bf16: the products and depthwise of
    fwd_work, the prologue over the 100 halo pixels of each of the 3
    channels (3 instructions a value with the affine, 11 with the dropout),
    and one row of 32 partial sums; the model prices the products at the
    product rate and the rest at K12b's."""
    got = link_floors.k1_instructions(1, 8, 8, 3, 16, False, False)
    assert got == {"mma": 64 * 16 * 16, "depthwise": 64 * 9 * 16, "prologue": 0, "sums": 32}
    assert link_floors.k1_instructions(1, 8, 8, 3, 16, True, False)["prologue"] == 100 * 3 * 3
    assert link_floors.k1_instructions(1, 8, 8, 3, 16, False, True)["prologue"] == 100 * 3 * 11
    instr = {"mma": 10 ** 9, "depthwise": 10 ** 8, "prologue": 10 ** 7, "sums": 10 ** 6}
    assert link_floors.k1_model_ms(instr, "bfloat16", 500e12, 50e3) == pytest.approx(
        2e9 / 500e12 * 1e3 + 2 * 1.11e8 / 50e12 * 1e3)
    assert link_floors.k1_model_ms(instr, "float32", 250e12, 50e3) == pytest.approx(
        6e9 / 250e12 * 1e3 + 2 * 1.11e8 / 50e12 * 1e3)


def test_forward_entries_map_to_k1_k8_and_k9():
    """The __global__ entries of the forward kernels are mapped: K8's, K1's
    and K9's, all on the forward body of sepconv_fwd.cuh, each its own
    entry; the body's header defines none of its own."""
    sites = step_attribution.kernel_sites()
    assert sites["sepconv_block_kernel"].startswith("sepconv_block.cu:")
    assert sites["chain_fwd_kernel"].startswith("chain_fwd.cu:")
    assert sites["sepconv_stats_kernel"].startswith("chain_fwd.cu:")
    assert not any(site.startswith("sepconv_fwd.cuh:") for site in sites.values())
    assert [roofline.label_of(e) for e in ("sepconv_block_kernel", "chain_fwd_kernel",
                                           "sepconv_stats_kernel")] == ["K8", "K1", "K9"]
    name = ("void unet::(anonymous namespace)::chain_fwd_kernel<__nv_bfloat16, 128, true>"
            "(unet::FwdArgs<__nv_bfloat16>, float const*)")
    assert roofline.entry_of(name) == "chain_fwd_kernel"


def test_every_kernel_entry_maps_to_a_label():
    sites = step_attribution.kernel_sites()
    assert set(sites) == set(roofline.ENTRIES), set(sites) ^ set(roofline.ENTRIES)
    assert sites["chain_bwd_tile_kernel"].startswith("chain_bwd.cu:")
    assert sites["colsum_kernel"].startswith("train_common.cuh:")
    for entry in sites:
        label = roofline.label_of(entry)
        assert label.startswith("K") or label == roofline.SUMS, entry
        wrapper = roofline.ENTRIES[entry][0]
        assert wrapper is None or wrapper in roofline.KERNELS
    from unet_image_segmentation_tpu_torch.ops import (
        fused_head, fused_sepconv, fused_upconcat)
    counters = set()
    for mod in (ft, fused_upconcat, fused_head, fused_sepconv, probes):
        counters |= set(mod.LAUNCHES)
    assert counters == set(roofline.KERNELS)
    for _, src, _ in roofline.KERNELS.values():
        assert os.path.exists(os.path.join(link_floors.ROOT, "unet_image_segmentation_tpu_torch",
                                           "ops", "kernels", "csrc", src))
    name = ("void unet::(anonymous namespace)::upconcat_dx_kernel<__nv_bfloat16>"
            "(unet::(anonymous namespace)::FeedArgs<__nv_bfloat16>)")
    assert roofline.entry_of(name) == "upconcat_dx_kernel"
    assert roofline.entry_of("void unet::(anonymous namespace)::head_fwd_mc_kernel<float, 16, 3>"
                             "(f)") == "head_fwd_mc_kernel"
    assert roofline.entry_of("void at::native::elementwise_kernel<128, 2>(int)") is None
    assert roofline.entry_of("_ZN4unet12_GLOBAL__N_121chain_bwd_tile_kernelI13__nv_bfloat16EEvPKT_"
                             ) == "chain_bwd_tile_kernel"   # mangled, as some profilers name it


def _event(cat, name, ts, dur, correlation=None):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": correlation}}


TILE = "void unet::(anonymous namespace)::chain_bwd_tile_kernel<__nv_bfloat16>(float)"
DPW = "void unet::(anonymous namespace)::chain_bwd_dpw_kernel<__nv_bfloat16>(float)"
COLSUM = "void unet::(anonymous namespace)::colsum_kernel(float const*, int, int, float*)"
MUL = ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, "
       "float, float, at::native::binary_internal::MulFunctor<float> >, std::array<char*, 3ul> "
       ">(int, at::native::BinaryFunctor<float>, std::array<char*, 3ul>)")


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": [
            {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}}] + events}, f)


def test_profile_summary_on_a_hand_written_trace(tmp_path):
    """Kernels at [0, 10) and [5, 15) overlap, [30, 40) and a memcpy at
    [50, 55) stand alone, a CPU op spans [-10, 100): busy 30 us of 110. Of
    the two launch calls, the one at 20 us has no kernel in the trace."""
    _write_trace(tmp_path / "a.pt.trace.json", [
        _event("cpu_op", "aten::mul", -10.0, 110.0),
        _event("kernel", TILE, 0.0, 10.0, 1), _event("kernel", DPW, 5.0, 10.0, 2),
        _event("kernel", TILE, 30.0, 10.0, 3),
        _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 50.0, 5.0, 4),
        _event("cuda_runtime", "cudaLaunchKernel", -5.0, 2.0, 1),
        _event("cuda_runtime", "cudaLaunchKernel", 20.0, 2.0, 9),
        _event("cuda_runtime", "cudaMemcpyAsync", 45.0, 2.0, 4),
    ])
    for path in (tmp_path, tmp_path / "a.pt.trace.json"):
        s = profile_summary.summarize(str(path))
        assert s["kernels"] == {TILE: 0.020, DPW: 0.010}
        assert s["copies"] == {"Memcpy HtoD (Pageable -> Device)": 0.005}
        assert s["launches"][TILE] == 2 and s["launch_calls"] == 2
        assert s["lost_launch_ms"] == [pytest.approx(0.030)]
        assert s["busy_ms"] == pytest.approx(0.030)
        assert s["window_ms"] == pytest.approx(0.110)
        assert s["idle_share"] == pytest.approx(1 - 30 / 110)
    assert profile_summary.main([str(tmp_path), "--top", "2"]) == 0


def test_profile_summary_within_spans(tmp_path):
    """Only the work launched inside the "step" spans counts: a lead-in
    kernel launched before them is left out, and a launch inside them
    whose kernel the trace lacks is reported."""
    _write_trace(tmp_path / "b.pt.trace.json", [
        _event("cuda_runtime", "cudaLaunchKernel", 0.0, 1.0, 1),
        _event("kernel", TILE, 2.0, 5.0, 1),
        _event("user_annotation", "step", 10.0, 20.0),
        _event("cuda_runtime", "cudaLaunchKernel", 11.0, 1.0, 2),
        _event("cuda_runtime", "cudaLaunchKernel", 12.0, 1.0, 3),
        _event("cuda_runtime", "cudaMemsetAsync", 13.0, 1.0, 4),
        _event("kernel", DPW, 15.0, 20.0, 2),
        _event("gpu_memset", "Memset (Device)", 36.0, 2.0, 4),
    ])
    s = profile_summary.summarize(str(tmp_path), within="step")
    assert s["kernels"] == {DPW: 0.020} and s["copies"] == {"Memset (Device)": 0.002}
    assert s["launch_calls"] == 2 and s["lost_launch_ms"] == [pytest.approx(0.002)]
    with pytest.raises(AssertionError, match="lacks 1 of the 2 kernels"):
        profile_summary.check_complete(s, "step")
    assert s["busy_ms"] == pytest.approx(0.022) and s["window_ms"] == pytest.approx(0.028)
    with pytest.raises(ValueError, match="no 'other' span"):
        profile_summary.summarize(str(tmp_path), within="other")


def test_profile_summary_reads_the_ports_cpu_trace(tmp_path):
    with profiling.trace(str(tmp_path), "cpu"):
        a = torch.ones(8, 8)
        (a @ a).sum()
    s = profile_summary.summarize(str(tmp_path))
    assert len(s["files"]) == 1 and s["files"][0].endswith(".pt.trace.json")
    assert s["kernels"] == {} and s["busy_ms"] == 0.0
    assert s["window_ms"] > 0 and s["idle_share"] == 1.0


def test_attribute_splits_sites_sums_and_glue():
    """Two steps: K2's two passes once a step each, two row sums a step,
    and PyTorch glue rolled up by family."""
    summary = {"kernels": {TILE: 6.0, DPW: 2.0, COLSUM: 0.4, MUL: 1.0},
               "copies": {"Memcpy HtoD (Pageable -> Device)": 0.2},
               "launches": {TILE: 2, DPW: 2, COLSUM: 4, MUL: 10,
                            "Memcpy HtoD (Pageable -> Device)": 2},
               "busy_ms": 9.6, "idle_share": 0.1}
    rec = step_attribution.attribute(summary, 2, step_attribution.kernel_sites())
    assert rec["device_ms_per_step"] == pytest.approx(4.8)
    assert rec["kernel_ms_per_step"] == pytest.approx(4.2)
    assert rec["glue_ms_per_step"] == pytest.approx(0.6)
    k2 = rec["per_kernel"]["chain_bwd"]
    assert k2["label"] == "K2" and k2["ms"] == pytest.approx(4.0) and k2["launches"] == 1
    assert rec["per_kernel"]["sums"] == {"label": "sums", "ms": pytest.approx(0.2),
                                         "launches": 2}
    site = next(s for s in rec["per_site_ms"] if s.endswith(" chain_bwd_tile_kernel"))
    assert site.startswith("chain_bwd.cu:") and rec["per_site_ms"][site] == pytest.approx(3.0)
    assert rec["glue_ms"] == {"vectorized_elementwise_kernel[MulFunctor]": pytest.approx(0.5),
                              "Memcpy HtoD": pytest.approx(0.1)}


def test_trace_on_the_card_without_one_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(str(tmp_path), "cuda"):
            pass


def test_step_timer_lives_in_profiling():
    assert loop.StepTimer is profiling.StepTimer
    timer = profiling.StepTimer("cpu", sync_every=2)
    for _ in range(6):
        timer.lap()
    s = timer.summary()
    assert s["steps"] == 6.0 and len(timer.times) == 3 and s["max_ms"] >= s["p50_ms"] >= 0


class _Scenes:
    """In-memory dataset: ``len`` and ``batches`` as the loaders have them."""

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.images = rng.rand(n, 32, 32, 3).astype(np.float32)
        self.masks = (rng.rand(n, 32, 32, 1) > 0.6).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def batches(self, batch_size, epoch=0, steps=None, num_workers=0):
        n = len(self) // batch_size if steps is None else min(len(self) // batch_size, steps)
        for b in range(n):
            sl = slice(b * batch_size, (b + 1) * batch_size)
            yield self.images[sl], self.masks[sl]


@pytest.mark.parametrize("profile_steps", [1, 5])
def test_fit_profile_dir_traces_and_trains_alike(tmp_path, profile_steps):
    """``profile_dir`` traces the first ``profile_steps`` steps of the first
    epoch (all 3 of them when that is more) and changes nothing else."""
    results = {}
    for mode in ("plain", "profiled"):
        cfg = Config().override(
            model__image_height=32, model__image_width=32, model__filters=(8, 16),
            model__use_pallas=True, train__batch_size=2, train__epochs=2,
            train__model_out=str(tmp_path / mode / "model"),
            train__log_dir=str(tmp_path / mode / "logs"),
            train__profile_dir=str(tmp_path / "trace") if mode == "profiled" else None,
            train__profile_steps=profile_steps)
        results[mode] = loop.fit(cfg, _Scenes(6, 0), _Scenes(2, 1), device="cpu",
                                 verbose=False)
    plain, prof = results["plain"], results["profiled"]
    assert prof.epochs_run == plain.epochs_run == 2
    assert prof.state.step == plain.state.step == 6
    timing = {"epoch_time_sec", "step_mean_ms", "step_p50_ms", "step_max_ms"}
    assert set(prof.history) == set(plain.history)
    for k, v in plain.history.items():
        if k not in timing:
            assert prof.history[k] == v, k
    for (k, a), b in zip(plain.state.model.state_dict().items(),
                         prof.state.model.state_dict().values()):
        assert torch.equal(a, b), k
    s = profile_summary.summarize(str(tmp_path / "trace"))
    assert len(s["files"]) == 1 and s["window_ms"] > 0
    events = profile_summary.read_events(s["files"][0])
    steps = sum(e["name"] == "Optimizer.step#AdamW.step" for e in events)
    assert steps == min(profile_steps, 3)


def test_check_install_on_the_cpu_passes():
    assert check_install.main(["--device", "cpu"]) == 0


@pytest.mark.parametrize("tool", [check_install, check_gpu_benchmark, link_floors,
                                  step_attribution, dpw_digits, upconcat_digits,
                                  probe_sass],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_tools_refuse_to_run_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) != 0
    out = capsys.readouterr()
    assert "no CUDA device" in out.out + out.err


def test_probe_sass_counts_each_kernels_opcodes():
    sass = """
        Function : _ZN4unet12_GLOBAL__N_121fma_probe_bf16_kernelEPK14__nv_bfloat162PS1_iif
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*1140*/                   HFMA2.BF16_V2 R10, R11, R0.reuse.H0_H0, R21 ;
        /*1160*/                   HFMA2.BF16_V2 R9, R9, R0.reuse.H0_H0, R15 ;
        /*1170*/              @!P0 BRA 0x1100 ;
        Function : _ZN4unet12_GLOBAL__N_120fma_probe_f32_kernelEPKfPfiif
        /*0040*/                   FFMA R5, R5, R2, R4 ;
    """
    counts = probe_sass.opcode_counts(sass)
    assert list(counts) == [
        "_ZN4unet12_GLOBAL__N_121fma_probe_bf16_kernelEPK14__nv_bfloat162PS1_iif",
        "_ZN4unet12_GLOBAL__N_120fma_probe_f32_kernelEPKfPfiif"]
    assert list(counts.values()) == [{"HFMA2.BF16_V2": 2, "LDC": 1, "BRA": 1}, {"FFMA": 1}]


def _ptxas_lines(mangled, frame, regs):
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    {frame[0]} bytes stack frame, {frame[1]} bytes spill stores, {frame[2]} bytes "
            f"spill loads\nptxas info    : Used {regs} registers, used 1 barriers, 452 bytes "
            "cmem[0]\n")


_HEAD_MC = "_ZN4unet39_GLOBAL__N__a9798811_10_head_mc_cu_9a09901418"
_PTXAS_LOG = (
    _ptxas_lines(_HEAD_MC + "head_bwd_mc_kernelI13__nv_bfloat16Li8ELi3EEEvPKT_PKhPKfS9_S9_S9_PS3_"
                 "PfSB_Pjiiiiii", (0, 0, 0), 120) +
    _ptxas_lines(_HEAD_MC + "head_fwd_mc_kernelIfLi0ELi4EEEvPKT_PKhPKfS8_S8_PfS9_Pjiiiiii",
                 (24, 32, 32), 128) +
    _ptxas_lines("_ZN4unet39_GLOBAL__N__a9798811_7_head_cu_1d4213c513colsum_kernelEPKfiiPf",
                 (0, 0, 0), 26))


def test_ptxas_report_reads_each_instance():
    """ptxas_report names each __global__ instance by its entry and template
    arguments and reads its registers, stack frame and spills."""
    from unet_image_segmentation_tpu_torch.troubleshoot import ptxas_report

    got = [(i["entry"], i["args"], i["registers"], i["stack"], i["spill_stores"],
            i["spill_loads"]) for i in ptxas_report.parse(_PTXAS_LOG)]
    assert got == [("head_bwd_mc_kernel", ["bf16", "8", "3"], 120, 0, 0, 0),
                   ("head_fwd_mc_kernel", ["fp32", "0", "4"], 128, 24, 32, 32),
                   ("colsum_kernel", [], 26, 0, 0, 0)]


def test_ptxas_report_needs_nvcc(monkeypatch, capsys):
    from unet_image_segmentation_tpu_torch.ops.kernels import build
    from unet_image_segmentation_tpu_torch.troubleshoot import ptxas_report

    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_nvcc", missing)
    assert ptxas_report.main(["head_mc.cu"]) == 1
    assert "needs the CUDA toolkit" in capsys.readouterr().out
