"""Plain K8 / K7 of the port against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their kernels' plain versions, and the
JAX kernels run in Pallas interpret mode, as the JAX package's own tests
run them. fp32 throughout; both sides sum in fp32 in different orders, so
the bar is 1e-5.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.ops import conv as jops
from unet_image_segmentation_tpu.ops.pallas import fused_sepconv as jfs
from unet_image_segmentation_tpu_torch.ops import fused_sepconv as tfs
from unet_image_segmentation_tpu_torch.ops.kernels import build
from unet_image_segmentation_tpu_torch.troubleshoot import roofline

TOL = dict(rtol=1e-5, atol=1e-5)
HW = 16


def _block(rng, c, f, bn=True, bias=False):
    blk = {
        "depthwise_kernel": rng.uniform(-0.5, 0.5, (3, 3, c, 1)).astype(np.float32),
        "pointwise_kernel": rng.uniform(-0.5, 0.5, (1, 1, c, f)).astype(np.float32),
    }
    if bias:
        blk["bias"] = rng.standard_normal(f).astype(np.float32) * 0.1
    if bn:
        blk.update(
            scale=rng.uniform(0.5, 1.5, f).astype(np.float32),
            offset=(rng.standard_normal(f) * 0.1).astype(np.float32),
            mean=(rng.standard_normal(f) * 0.1).astype(np.float32),
            var=rng.uniform(0.5, 1.5, f).astype(np.float32),
        )
    return blk


def _jax(blk):
    return {k: jnp.asarray(v) for k, v in blk.items()}


def _torch(blk):
    return {k: torch.from_numpy(v) for k, v in blk.items()}


def _x(rng, c):
    return rng.standard_normal((2, HW, HW, c)).astype(np.float32)


@pytest.mark.parametrize(
    "c,f,bn,bias,relu",
    [
        (3, 8, True, False, True),     # the image input block
        (8, 16, True, False, True),
        (16, 16, True, True, True),    # BN and conv bias folded together
        (16, 8, False, True, True),    # no-BN block: bias only
        (8, 16, True, False, False),   # affine without ReLU
    ],
)
def test_block_plain_matches_jax(c, f, bn, bias, relu):
    rng = np.random.RandomState(c * 100 + f)
    x, blk = _x(rng, c), _block(rng, c, f, bn, bias)
    names = dict(bias="bias", scale="bn_scale", offset="bn_offset", mean="bn_mean", var="bn_var")
    j = _jax(blk)
    want = jfs.fused_sepconv_bn_relu(
        jnp.asarray(x), j["depthwise_kernel"], j["pointwise_kernel"], relu=relu,
        **{names[k]: v for k, v in j.items() if k in names},
    )
    t = _torch(blk)
    got = tfs.fused_sepconv_bn_relu(
        torch.from_numpy(x), t["depthwise_kernel"], t["pointwise_kernel"], relu=relu,
        **{names[k]: v for k, v in t.items() if k in names},
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "c,f1,f2,mode,hw,route",
    [
        pytest.param(3, 8, 8, "pool", (HW, HW), "pair", id="3-8-8-pool"),  # image input, pool
        pytest.param(8, 16, 16, "pool", (HW, HW), "pair", id="8-16-16-pool"),
        pytest.param(16, 16, 8, "plain", (HW, HW), "pair", id="16-16-8-plain"),  # no pool
        pytest.param(8, 8, 8, "x2", (HW, HW), "pair", id="8-8-8-x2"),  # [x | x2] input
        pytest.param(16, 16, 16, "x2", (HW, HW), "pair", id="16-16-16-x2"),
        # ragged: H not a multiple of 8, H != W, F not a multiple of 16
        pytest.param(16, 16, 16, "plain", (12, 24), "pair", id="ragged-12x24"),
        pytest.param(8, 24, 24, "pool", (10, 16), "pair", id="ragged-10x16-f24-pool"),
        pytest.param(8, 24, 24, "x2", (12, 16), "pair", id="ragged-12x16-f24-x2"),
        # no lane packing fits W (JAX returns None): its two single blocks
        pytest.param(3, 40, 40, "plain", (14, 18), "blocks", id="ragged-14x18-f40-blocks"),
        pytest.param(8, 40, 24, "pool", (6, 10), "blocks", id="ragged-6x10-f40-24-blocks"),
    ],
)
def test_pair_plain_matches_jax(c, f1, f2, mode, hw, route):
    """For x2 JAX gets the concat; for the pool JAX's version is
    max_pool_2x2 of the pair output. Where no lane packing of JAX's pair
    kernel fits (``route`` "blocks"), ``fused_sepconv_pair`` returns None
    and JAX's serving graph runs two single-block kernels
    (``serving._pair``), and so does the reference here."""
    h, w = hw
    rng = np.random.RandomState(c * 1000 + f1 * 10 + f2 + (0 if hw == (HW, HW) else h * w))
    cin = 2 * c if mode == "x2" else c
    b1, b2 = _block(rng, cin, f1), _block(rng, f1, f2)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    x2 = rng.standard_normal((2, h, w, c)).astype(np.float32) if mode == "x2" else None
    xin = np.concatenate([x, x2], axis=-1) if mode == "x2" else x
    want = jfs.fused_sepconv_pair(jnp.asarray(xin), _jax(b1), _jax(b2))
    assert (want is None) == (route == "blocks")
    if want is None:
        want = xin
        for blk in (b1, b2):
            j = _jax(blk)
            want = jfs.fused_sepconv_bn_relu(
                jnp.asarray(want), j["depthwise_kernel"], j["pointwise_kernel"],
                bn_scale=j["scale"], bn_offset=j["offset"], bn_mean=j["mean"], bn_var=j["var"])
    got = tfs.fused_sepconv_pair(
        torch.from_numpy(x), _torch(b1), _torch(b2), pool=mode == "pool",
        x2=torch.from_numpy(x2) if x2 is not None else None,
    )
    if mode == "pool":
        got, pooled = got
        np.testing.assert_allclose(
            pooled.numpy(), np.asarray(jops.max_pool_2x2(want)), **TOL
        )
        assert pooled.shape == (2, h // 2, w // 2, f2)
    assert got.shape == (2, h, w, f2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# K7's launch plans: (H, W, C, F1, F2, batch) at every stage of the 256,
# 512 and 1024 px models (filters 64..512, bottleneck 1024), at ragged
# shapes (chip_smoke.py's phase 4) and at the batch limits
_PLAN_SHAPES = (
    [pytest.param(h, h, cx + cx2, f1, f2, 1, id=f"{px}px-{name}")
     for px in (256, 512, 1024)
     for name, cx, cx2, f1, f2, h, _ in roofline.stage_shapes(px, (64, 128, 256, 512))]
    + [pytest.param(20, 36, 32, 64, 64, 2, id="ragged-20x36"),
       pytest.param(24, 24, 3, 48, 48, 3, id="ragged-cx3-f48"),
       pytest.param(16, 16, 160, 80, 80, 2, id="ragged-x2-80"),
       pytest.param(18, 18, 64, 200, 200, 3, id="ragged-pool18-f200"),
       pytest.param(13, 11, 16, 40, 24, 2, id="ragged-f1-ne-f2"),
       pytest.param(8, 8, 16, 16, 1024, 2, id="ragged-f1-16-f2-1024"),
       pytest.param(256, 256, 3, 64, 64, 1, id="batch-1"),
       pytest.param(16, 16, 512, 1024, 1024, 65535, id="batch-65535")]
)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("h,w,c,f1,f2,batch", _PLAN_SHAPES)
def test_pair_plan(h, w, c, f1, f2, batch, dtype):
    """The cluster's slices cover F1 and F2 exactly, each within the GEMM
    width and starting on a 16-channel boundary; at most 8 CTAs a cluster;
    the shared memory within the 227 KB a CTA may use; the grid within
    CUDA's limits."""
    plan = tfs.pair_plan(h, w, c, f1, f2, dtype, batch)
    assert plan.n in (1, 2, 4, 8)
    assert plan.width in (64, 128)
    for f, s in ((f1, plan.s1), (f2, plan.s2)):
        ranges = tfs.slice_ranges(plan.n, s, f)
        assert s % 16 == 0 and s <= plan.width
        assert ranges[0][0] == 0 and ranges[-1][1] == f
        assert all(lo == prev_hi for (_, prev_hi), (lo, _) in zip(ranges, ranges[1:]))
        assert all(lo % 16 == 0 and 0 <= hi - lo <= s for lo, hi in ranges)
        assert ranges[0][1] > 0
    assert 0 < plan.smem <= tfs.SMEM_MAX == 232448
    assert plan.grid == (plan.n * -(-h // 8) * -(-w // 8), batch)
    assert plan.grid[0] < 2 ** 31 and plan.grid[1] <= 65535


def test_pair_plan_refuses_what_the_kernel_cannot_launch():
    with pytest.raises(ValueError, match="at most 1024"):
        tfs.pair_plan(16, 16, 64, 1025, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="batch"):
        tfs.pair_plan(16, 16, 64, 64, 64, torch.bfloat16, 65536)
    with pytest.raises(TypeError):
        tfs.pair_plan(16, 16, 64, 64, 64, torch.float16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("h,w,c,f1,f2,batch", _PLAN_SHAPES)
def test_pair_plan_int8(h, w, c, f1, f2, batch, dtype):
    """The int8 I/O mode takes the float plan's cluster, slices and grid;
    its x tiles hold a byte a value, so its shared memory is the float
    plan's less the tiles' other bytes where block 2's buffers still fit,
    and never more: an SM holds as many of its CTAs."""
    plan = tfs.pair_plan(h, w, c, f1, f2, dtype, batch)
    q = tfs.pair_plan(h, w, c, f1, f2, dtype, batch, int8=True)
    assert q._replace(smem=plan.smem) == plan
    kc, _ = build.CHUNK[dtype]
    e = dtype.itemsize
    ldk, ldn = kc + 16 // e, plan.width + 8
    # affines, taps and weight chunks; then the x tiles and dw1 chunks, or
    # block 2's y1, d2 and pulled d2 chunks in their place, the larger
    front = 16 * plan.width + e * (18 * kc + 9 * plan.width + 2 * kc * ldn)
    block2 = e * (164 * ldn + 128 * ldk)
    assert plan.smem == front + max(e * 288 * kc + e * 224 * ldk, block2)
    assert q.smem == front + max(288 * kc + e * 224 * ldk, block2) <= plan.smem
    assert (2 * (q.smem + 1024) <= 228 * 1024) >= (2 * (plan.smem + 1024) <= 228 * 1024)


def test_pair_work_by_hand():
    """One 8x8 tile, C = 3, F1 = F2 = 16, bf16: one cluster of one CTA,
    width 64; C pads to one k16 step; GEMM2 runs one 16-deep chunk."""
    executed, useful = tfs.pair_work(8, 8, 3, 16, 16, torch.bfloat16)
    assert useful == 64 * (27 + 48 + 144 + 256)
    assert executed == 100 * 9 * 16 + 112 * 64 * 16 + 64 * 9 * 64 + 64 * 64 * 16
    # the U-Net's stages: only the ring, the GEMM rows' padding to 112 and
    # the input's padding to one mma step are left, at most 1.6x
    for name, cx, cx2, f1, f2, h, _ in roofline.stage_shapes(256, (64, 128, 256, 512)):
        for dtype in (torch.bfloat16, torch.float32):
            executed, useful = tfs.pair_work(h, h, cx + cx2, f1, f2, dtype)
            assert 1.0 < executed / useful <= 1.6, (name, dtype, executed / useful)


def test_pair_zero_pads_y1_not_block1_past_the_edge():
    """Block 2's 'same' padding sees zero y1 outside the image. Evaluating
    block 1 on a padded input and cropping afterwards differs at the edge."""
    rng = np.random.RandomState(5)
    b1, b2 = _torch(_block(rng, 4, 8)), _torch(_block(rng, 8, 8))
    x = torch.from_numpy(_x(rng, 4))
    w1, w2 = tfs.prepare_block(b1, x.dtype), tfs.prepare_block(b2, x.dtype)
    got = tfs.sepconv_pair(x, w1, w2)
    xp = torch.nn.functional.pad(x, (0, 0, 2, 2, 2, 2))
    wrong = tfs.sepconv_block_reference(tfs.sepconv_block_reference(xp, w1), w2)[:, 2:-2, 2:-2]
    inner = (slice(None), slice(2, -2), slice(2, -2))
    torch.testing.assert_close(got[inner], wrong[inner], rtol=1e-5, atol=1e-5)
    assert (got[:, 0] - wrong[:, 0]).abs().max() > 1e-3


def test_bf16_rounding_points():
    """In bf16 the plain block rounds the depthwise sum before the pointwise
    and returns bf16; fp32 math on the same bf16 inputs differs by at most a
    few bf16 ulps."""
    rng = np.random.RandomState(11)
    blk = _torch(_block(rng, 16, 16))
    x = torch.from_numpy(_x(rng, 16)).to(torch.bfloat16)
    w16 = tfs.prepare_block(blk, torch.bfloat16)
    y16 = tfs.sepconv_block(x, w16)
    assert y16.dtype == torch.bfloat16
    w32 = tfs.BlockWeights(w16.dw.float(), w16.pw.float(), w16.scale, w16.shift)
    y32 = tfs.sepconv_block(x.float(), w32)
    torch.testing.assert_close(y16.float(), y32, rtol=2e-2, atol=2e-2)


def test_cpu_path_launches_nothing():
    rng = np.random.RandomState(2)
    tfs.reset_launch_counts()
    b1, b2 = _torch(_block(rng, 3, 8)), _torch(_block(rng, 8, 8))
    x = torch.from_numpy(_x(rng, 3))
    tfs.fused_sepconv_pair(x, b1, b2, pool=True)
    tfs.fused_sepconv_bn_relu(x, b1["depthwise_kernel"], b1["pointwise_kernel"])
    xg = x.clone().requires_grad_()
    y, s, q = tfs.sepconv_apply_stats(xg, b1["depthwise_kernel"], b1["pointwise_kernel"])
    (y.sum() + s.sum() + q.sum() + tfs.sepconv_apply(xg, b2["depthwise_kernel"][:, :, :3],
                                                     b1["pointwise_kernel"]).sum()).backward()
    tfs.fused_sepconv_pair(torch.round(x * 20).clamp(-127, 127).to(torch.int8), b1, b2,
                           pool=True, in_scale=0.0625, out_scale=0.125, edge_flags=(1, 0))
    tfs.fused_sepconv_pair(x, b1, b2, out_scale=0.125, edge_flags=(0, 1))
    tfs.fused_sepconv_pair(x, b1, b2, edge_flags=(1, 1))
    assert tfs.LAUNCHES == {"sepconv_block": 0, "sepconv_pair": 0, "sepconv_pair_int8": 0,
                            "sepconv_pair_quant_out": 0, "sepconv_pair_edge": 0,
                            "sepconv_stats": 0, "sepconv_bwd": 0}


def test_kernel_build_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        build.load_library()


def test_kernel_sources_hash_into_library_name():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libunet_kernels_") and path.suffix == ".so"
    names = {p.name for p in build.CSRC.glob("*.cu")}
    assert {"sepconv_block.cu", "sepconv_pair.cu"} <= names
    for name in ("sepconv_block.cu", "sepconv_pair.cu"):
        note = (build.CSRC / name).read_text().split("#include")[0]
        assert "Replaces the TPU kernel" in note and "bounds it on the H100" in note


def _c_entries():
    """``extern "C"`` entry -> the kinds of its parameters ("pointer",
    "int", "float"), read from every source under ``csrc/``."""
    entries = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern "C"\s+[\w\s*]+?\b(\w+)\s*\(([^)]*)\)\s*\{', text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            entries[m.group(1)] = ["pointer" if "*" in p else p.rsplit(None, 1)[0]
                                   for p in params]
    return entries


def test_c_entries_match_their_ctypes_signatures():
    """Every ``extern "C"`` entry under csrc/ takes as many parameters, of
    the same kinds, as its row in build.SIGNATURES / WORKSPACE_SIGNATURES
    (ctypes would otherwise pass garbage, which only the card would show).
    The error-string helper and the phase-buffer hook of K7's instrumented
    build are bound by hand and have no row."""
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
    entries = _c_entries()
    rows = {**build.SIGNATURES, **build.WORKSPACE_SIGNATURES}
    assert set(entries) - set(rows) == {"unet_cuda_error_string", "unet_pair_phases_buffer"}
    assert set(rows) <= set(entries), set(rows) - set(entries)
    for name, argtypes in rows.items():
        assert entries[name] == [kinds[t] for t in argtypes], name
    # K9 takes K1's plan: (n, s, width, per, smem) after the shape
    assert entries["unet_sepconv_stats"] == ["pointer"] * 6 + ["int"] * 11 + ["pointer"]


@pytest.mark.parametrize("px", [256, 512])
def test_k8_route_on_the_unet_blocks(px):
    """K8's 18 blocks (two a K7 stage) take the plan of the forward body
    (fused_train.fwd_plan): one CTA a tile up to F = 128, else a cluster of
    F / 128 CTAs sharing each tile's depthwise, so only enc1.1's 3 input
    channels, padded to one mma depth, are executed past the useful work."""
    from unet_image_segmentation_tpu_torch.ops import fused_train as tft

    for name, cx, cx2, f1, f2, h, _ in roofline.stage_shapes(px, (64, 128, 256, 512)):
        for c, f in ((cx + cx2, f1), (f1, f2)):
            plan = tft.fwd_plan(32, h, h, c, f, torch.bfloat16, 132)
            assert plan.n == max(1, f // 128) and plan.n * plan.s == max(f, 64 * plan.n)
            work = tft.fwd_work(32, h, h, c, f, torch.bfloat16)
            assert work.executed / work.useful == pytest.approx(16 / 3 if c == 3 else 1.0)


def test_forward_kernels_take_their_products_to_the_tensor_cores():
    """K8, K1 and K9 run their pointwise products on mma.sync through the
    forward body (sepconv_fwd.cuh: warp_gemm in bf16, warp_gemm_split's
    3xTF32 in fp32); K9's entry, sepconv_stats_kernel, is that body without
    a prologue, and no source holds an fp32-FMA GEMM any more."""
    body = (build.CSRC / "sepconv_fwd.cuh").read_text()
    assert "warp_gemm<" in body and "warp_gemm_split<" in body and "smem_gemm" not in body
    k8 = (build.CSRC / "sepconv_block.cu").read_text()
    assert "sepconv_fwd_tiles<" in k8 and "smem_gemm" not in k8
    k1 = (build.CSRC / "chain_fwd.cu").read_text()
    assert "sepconv_fwd_tiles<" in k1
    stats = k1.index("sepconv_stats_kernel(")
    end = k1.index("\n}\n", stats)
    assert stats < k1.index("sepconv_fwd_tiles<T, W, false>", stats) < end
    assert "stats_epilogue<" in k1[stats:end]
    for src in build.CSRC.glob("*.cu*"):
        text = src.read_text()
        assert "smem_gemm" not in text and "gemm_8x4" not in text, src.name


# K10/K2's dpw in pass (b)'s order (troubleshoot/dpw_digits.py)
# of max |plain dpw| at 2 x 64 x 64 pixels: (ii) and (iii) in splits of 512
# pixels, (iv) serial over all 8192 (measured up to 3.8e-6)
DPW_ORDER_TOL = {"fp64": 1e-6, "fp32": 2e-6, "3xtf32": 2e-6, "fp32_one_split": 1e-5}


@pytest.mark.parametrize("c,f", [(3, 64), (5, 24)])
def test_dpw_pass_b_order_matches_the_plain_dpw(c, f):
    """(i)-(iv) of ``dpw_digits``, from the plain K10's fp32 m and the
    cotangent, equal its dpw within DPW_ORDER_TOL, on the split plan
    ``chain_bwd_plan`` gives; tf32() rounds to 10 mantissa bits, ties away
    from zero."""
    import numpy as np

    from unet_image_segmentation_tpu_torch.ops import fused_train as ft
    from unet_image_segmentation_tpu_torch.troubleshoot import dpw_digits as dd

    d = dd.inputs(2, c, f, 64)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    want = tfs.sepconv_bwd_reference(t["x"], t["g"], t["dw"], t["pw"])[2].double()
    m = ft._depthwise(t["x"], t["dw"]).reshape(-1, c).numpy()
    plan = ft.chain_bwd_plan(2, 64, 64, c, f, torch.float32, bias=True)
    assert plan.splits > 1
    got = dd.orders(m, d["g"].reshape(-1, f), plan.per, plan.splits)
    assert set(got) == {"fp64", "fp32", "3xtf32", "fp32_one_split"}
    for name, v in got.items():
        err = (torch.from_numpy(np.asarray(v)).double() - want).abs().max().item()
        assert err <= DPW_ORDER_TOL[name] * want.abs().max().item(), (name, err)
    v = np.array([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12], np.float32)
    np.testing.assert_array_equal(dd.tf32(v), [1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1])
    hi = dd.tf32(d["g"][0, 0])
    assert not (hi.view(np.uint32) & 0x1FFF).any()
