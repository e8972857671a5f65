"""The port's row-sharded serving against the JAX package's.

* K7's edge-flag and float-in/int8-out modes, their plain versions (the
  CPU path) against the JAX pair kernel in interpret mode with
  ``edge_flags`` and ``out_scale``, at ragged shapes, all four flag pairs;
  and shards of an image padded with their neighbours' rows, run with the
  flags and stitched, against the whole image.
* Under gloo in spawned processes (one a rank, a ``file://`` rendezvous
  under ``tmp_path``, each child with its own timeout): the process group's
  initialisation, an all_reduce and ``halo_exchange`` (3 ranks) against
  JAX ``halo_exchange`` on the CPU mesh, and the two sharded serving
  graphs and the sharded ``StreamingPredictor`` (a (data=2, spatial=2)
  mesh, 4 ranks) against JAX's on ``create_mesh(data=2, spatial=2)``, at
  the JAX tests' bars. The JAX side runs while the ranks do.

fp32, a 64 px U-Net with filters (8, 16), depth 2, batch 4.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from test_torch_streaming import FILTERS, HW, jax_predictor
from unet_image_segmentation_tpu import serving as jserving
from unet_image_segmentation_tpu import serving_quant as jsq
from unet_image_segmentation_tpu.models.unet import UNet as JaxUNet
from unet_image_segmentation_tpu.models.unet import init_unet
from unet_image_segmentation_tpu.ops.pallas import fused_sepconv as jfs
from unet_image_segmentation_tpu.parallel import halo as jhalo
from unet_image_segmentation_tpu.parallel.mesh import create_mesh as jax_create_mesh
from unet_image_segmentation_tpu.streaming import StreamingPredictor as JaxStreamingPredictor
from unet_image_segmentation_tpu_torch import serving, serving_quant as sq
from unet_image_segmentation_tpu_torch.ops import fused_sepconv as tfs
from unet_image_segmentation_tpu_torch.parallel import distributed, mesh as tmesh
from unet_image_segmentation_tpu_torch.train.checkpoint import save_inference_variables
from unet_image_segmentation_tpu_torch.weights import state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = [(0, 0), (1, 0), (0, 1), (1, 1)]
FRAME = (96, 96)
CHILD_TIMEOUT = 120
S_X, S_X2 = 2.0 ** -7, 2.0 ** -6


def _block(rng, c, f):
    return {
        "depthwise_kernel": rng.randn(3, 3, c, 1).astype(np.float32) * 0.3,
        "pointwise_kernel": rng.randn(1, 1, c, f).astype(np.float32) * 0.3,
        "scale": rng.rand(f).astype(np.float32) + 0.5,
        "offset": rng.randn(f).astype(np.float32) * 0.1,
        "mean": rng.randn(f).astype(np.float32) * 0.1,
        "var": rng.rand(f).astype(np.float32) + 0.5,
    }


def _torch(blk):
    return {k: torch.from_numpy(v) for k, v in blk.items()}


def _jax(blk):
    return {k: jnp.asarray(v) for k, v in blk.items()}


# (label, Cx, Cx2, F, H, W, pool): slabs of 10 and 12 rows (the JAX pair
# kernel's row tiles take no 20-row slab at these widths), 3 and 5 input
# channels, F = 8 and 24, and the two-stream input
PAIR_CASES = [("c3", 3, 0, 8, 10, 16, False), ("c5-pool", 5, 0, 24, 12, 16, True),
              ("x2", 24, 24, 24, 10, 32, False)]


def _pair_case(label):
    _, cx, cx2, f, h, w, pool = next(c for c in PAIR_CASES if c[0] == label)
    rng = np.random.RandomState(sum(map(ord, label)))
    x = rng.rand(2, h, w, cx).astype(np.float32)
    x2 = rng.rand(2, h, w, cx2).astype(np.float32) if cx2 else None
    return x, x2, _block(rng, cx + cx2, f), _block(rng, f, f), pool


@functools.lru_cache(maxsize=None)
def _jax_pair_fn(label, kind):
    """The JAX pair kernel of a case, jitted with the edge flags traced, so
    the four flag pairs share one compile; ``kind`` float, quant_out (a
    float x with ``out_scale``) or int8 (int8 I/O). Its two-stream form
    reads lane-packed inputs."""
    x, x2, b1, b2, pool = _pair_case(label)
    b, h, w, c = x.shape
    f = b2["pointwise_kernel"].shape[-1]
    kw = {}
    if kind != "float":
        kw["out_scale"] = _out_scale(label)
    if kind == "int8":
        kw.update(in_scale=(S_X, S_X2) if x2 is not None else S_X, compute_dtype=jnp.float32)
    p = jfs.pair_pack(2 * c, f, f, w) if x2 is not None else None

    def run(xx, xx2, top, bot):
        if p is None:
            return jfs.fused_sepconv_pair(xx, _jax(b1), _jax(b2), pool=pool,
                                          edge_flags=(top, bot), **kw)
        packed = (b, h, w // p, p * c)
        return jfs.fused_sepconv_pair(xx.reshape(packed), _jax(b1), _jax(b2), in_packed=p,
                                      x2=xx2.reshape(packed), edge_flags=(top, bot), **kw)

    return jax.jit(run)


def _jax_pair(label, kind, x, x2, flags):
    b, h, w, _ = x.shape
    f, pool = _pair_case(label)[3]["pointwise_kernel"].shape[-1], _pair_case(label)[4]
    out = _jax_pair_fn(label, kind)(jnp.asarray(x), None if x2 is None else jnp.asarray(x2),
                                    *flags)
    assert out is not None
    if pool:
        return (np.asarray(out[0]).reshape(b, h, w, f),
                np.asarray(out[2]).reshape(b, h // 2, w // 2, f))
    return (np.asarray(out).reshape(b, h, w, f),)


def _out_scale(label):
    """A pow2 output scale covering the unflagged float pair's output."""
    x, x2, b1, b2, pool = _pair_case(label)
    return sq.pow2_scale(float(_port_pair(x, x2, b1, b2, pool, None)[0].max()))


def _port_pair(x, x2, b1, b2, pool, flags, **kw):
    out = tfs.fused_sepconv_pair(torch.from_numpy(x), _torch(b1), _torch(b2), pool=pool,
                                 x2=torch.from_numpy(x2) if x2 is not None else None,
                                 edge_flags=flags, **kw)
    return tuple(t.numpy() for t in (out if pool else (out,)))


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: f"top{f[0]}-bot{f[1]}")
@pytest.mark.parametrize("label", [c[0] for c in PAIR_CASES])
def test_plain_edge_flag_pair_matches_jax(label, flags):
    """fp32 within 1e-5 of the JAX kernel; a set flag zeroes y1 on that
    side's 2 halo rows, so the output differs from the unflagged one there."""
    x, x2, b1, b2, pool = _pair_case(label)
    got = _port_pair(x, x2, b1, b2, pool, flags)
    for g, w in zip(got, _jax_pair(label, "float", x, x2, flags)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    plain = _port_pair(x, x2, b1, b2, pool, None)[0]
    changed = np.abs(got[0] - plain).max(axis=(0, 2, 3)) > 0
    assert changed[:3].any() == bool(flags[0]) and changed[-3:].any() == bool(flags[1])
    assert not changed[3:-3].any()


def _quanta_apart(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: f"top{f[0]}-bot{f[1]}")
@pytest.mark.parametrize("label", [c[0] for c in PAIR_CASES])
def test_plain_int8_edge_and_quant_out_pairs_match_jax(label, flags):
    """K7's int8 I/O mode with edge flags and its float-in/int8-out mode
    (JAX: a float x with ``out_scale``), plain, against the JAX kernel: no
    element more than 1 quantum apart, >= 99.9% equal. In fp32 the
    float-in/int8-out pair is also the quantized float pair, bit for bit."""
    x, x2, b1, b2, pool = _pair_case(label)
    s_out = _out_scale(label)
    yf = _port_pair(x, x2, b1, b2, pool, flags)
    got = _port_pair(x, x2, b1, b2, pool, flags, out_scale=s_out)
    for g, w, f in zip(got, _jax_pair(label, "quant_out", x, x2, flags), yf):
        assert g.dtype == np.int8
        _quanta_apart(g, w)
        np.testing.assert_array_equal(g, sq.quantize(torch.from_numpy(f), s_out).numpy())
    q = sq.quantize(torch.from_numpy(x), S_X).numpy()
    q2 = sq.quantize(torch.from_numpy(x2), S_X2).numpy() if x2 is not None else None
    in_scale = (S_X, S_X2) if x2 is not None else S_X
    got = _port_pair(q, q2, b1, b2, pool, flags, in_scale=in_scale, out_scale=s_out,
                     compute_dtype=torch.float32)
    for g, w in zip(got, _jax_pair(label, "int8", q, q2, flags)):
        _quanta_apart(g, w)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["float", "quant_out", "int8"])
def test_padded_shards_stitch_to_the_whole_image(n, mode):
    """Row shards of a 20 x 36 image, each padded with its neighbours' 2
    rows (zeros at the image edges) and run with its edge flags, trimmed
    and stitched, equal the plain pair on the whole image (pool on)."""
    rng = np.random.RandomState(40 + n)
    w1 = tfs.prepare_block(_torch(_block(rng, 5, 24)), torch.float32)
    w2 = tfs.prepare_block(_torch(_block(rng, 24, 16)), torch.float32)
    x = torch.from_numpy(rng.rand(2, 20 * n // 2, 36, 5).astype(np.float32))
    fn = tfs.sepconv_pair
    if mode != "float":
        w1, w2 = tfs.fold_int8(w1, w2, 2.0 ** -7 if mode == "int8" else None, 2.0 ** -4, 5)
        fn = tfs.sepconv_pair_int8 if mode == "int8" else tfs.sepconv_pair_quant_out
        if mode == "int8":
            x = sq.quantize(x, 2.0 ** -7)
    whole = fn(x, w1, w2, pool=True)
    rows = x.shape[1] // n
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 2, 2))
    parts = [fn(xp[:, i * rows:(i + 1) * rows + 4].contiguous(), w1, w2, pool=True,
                edge_flags=(int(i == 0), int(i == n - 1))) for i in range(n)]
    stitched = (torch.cat([y[:, 2:-2] for y, _ in parts], 1),
                torch.cat([p[:, 1:-1] for _, p in parts], 1))
    for got, want in zip(stitched, whole):
        if mode == "float":
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        else:
            assert (got.int() - want.int()).abs().max() <= 1
            assert (got == want).float().mean() >= 0.999


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize()
    distributed.initialize("localhost:1", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized() and not distributed.is_multihost()
    info = distributed.process_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    mesh = tmesh.create_mesh()
    assert mesh.shape == {"data": 1, "spatial": 1} and mesh.spatial_group is None
    with pytest.raises(ValueError):
        tmesh.create_mesh(data=2)
    with pytest.raises(ValueError):
        distributed.initialize("localhost:1", num_processes=2)


# (device, LOCAL_WORLD_SIZE, the host's cards, backend): the CPU always takes
# gloo; CUDA takes NCCL when every rank of the host has its own card, gloo
# when ranks share one; None where the layout is unknown (an explicit
# launch of 8 ranks on 2 hosts, say, without LOCAL_WORLD_SIZE): it raises
BACKEND_CASES = [("cpu", None, 8, "gloo"), ("cpu", "4", 8, "gloo"), ("cuda", "4", 4, "nccl"),
                 ("cuda", "2", 1, "gloo"), ("cuda", None, 4, None)]


@pytest.mark.parametrize("device,local,cards,want", BACKEND_CASES,
                         ids=lambda v: str(v))
def test_initialize_picks_the_backend_from_the_device(monkeypatch, device, local, cards, want):
    """``initialize`` with explicit arguments (rank 5 of 8) joins with the
    backend the served device and the host's layout call for, and refuses
    to guess a layout it cannot see."""
    joined = []
    monkeypatch.setattr(distributed, "_join", lambda *a: joined.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    if want is None:
        with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
            distributed.initialize("host0:29500", num_processes=8, process_id=5, device=device)
        assert not joined
        distributed.initialize("host0:29500", num_processes=8, process_id=5, backend="nccl",
                               device=device)
        want = "nccl"
    else:
        distributed.initialize("host0:29500", num_processes=8, process_id=5, device=device)
    assert joined == [(want, "tcp://host0:29500", 8, 5)]


def test_sharded_stream_refuses_what_would_change_its_graph(tmp_path):
    """A mesh serves the float kernel graph: a pending int8 Predictor is
    refused (JAX serves the float graph). A module-path Predictor streams on
    the mesh through the composed row-sharded forward (JAX partitions the
    module path with GSPMD); on one rank its answer is the unsharded one."""
    from test_torch_streaming import seeded_model
    from unet_image_segmentation_tpu_torch.inference import Predictor
    from unet_image_segmentation_tpu_torch.streaming import StreamingPredictor

    ckpt, _ = seeded_model(tmp_path, 5)
    mesh = tmesh.create_mesh()
    int8 = Predictor(ckpt, image_size=(HW, HW), use_pallas=True, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="float graph"):
        StreamingPredictor(int8, FRAME, batch_size=2, mesh=mesh)
    frames = (np.random.RandomState(6).rand(2, *FRAME, 3) * 255).astype(np.uint8)
    module = Predictor(ckpt, image_size=(HW, HW), device="cpu")
    np.testing.assert_array_equal(
        StreamingPredictor(module, FRAME, batch_size=2, mesh=mesh)(frames),
        StreamingPredictor(module, FRAME, batch_size=2)(frames))
    pred = Predictor(ckpt, image_size=(HW, HW), use_pallas=True, device="cpu")
    np.testing.assert_array_equal(StreamingPredictor(pred, FRAME, batch_size=2, mesh=mesh)(frames),
                                  StreamingPredictor(pred, FRAME, batch_size=2)(frames))


def test_sharded_graph_refuses_shards_it_cannot_take():
    """Rows not divisible by 2**depth, or fewer than 2 rows a shard at the
    deepest stage (the JAX graph silently takes one there), raise."""
    mesh2 = tmesh.Mesh(1, 2, rank=0)
    with pytest.raises(ValueError, match="divisible"):
        serving.check_shard_rows(mesh2, 12, 16, 3)
    with pytest.raises(ValueError, match="deepest stage"):
        serving.check_shard_rows(mesh2, 8, 16, 3)
    serving.check_shard_rows(mesh2, 16, 16, 3)
    serving.check_shard_rows(tmesh.Mesh(1, 1), 8, 16, 3)   # no halo, no bound


# --------------------------------------------------------------------------
# spawned ranks
# --------------------------------------------------------------------------

_CHILD = r'''
import json, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from unet_image_segmentation_tpu_torch.parallel import distributed, halo, mesh as tmesh

job, rank, world, tmp = {job!r}, int(sys.argv[1]), {world}, {tmp!r}
distributed.initialize("file://" + tmp + "/store", num_processes=world, process_id=rank,
                       device="cpu")
assert distributed.is_multihost()
info = distributed.process_info()
assert info["process_count"] == world and info["process_index"] == rank
assert info["backend"] == "gloo"
out = {{}}
if job == "halo":
    t = torch.full((3,), float(rank + 1))
    torch.distributed.all_reduce(t)
    out["sum"] = t.numpy()
    mesh = tmesh.create_mesh(data=1, spatial=world)
    x = np.load(tmp + "/x.npy")
    for dtype in ("float32", "bfloat16", "int8"):
        local = mesh.shard(torch.from_numpy(x).to(getattr(torch, dtype)))
        for h in (1, 2):
            out[f"{{dtype}} {{h}}"] = halo.halo_exchange(local, mesh.spatial_group, h).float().numpy()
        assert torch.equal(mesh.gather(local), torch.from_numpy(x).to(getattr(torch, dtype)))
else:
    from unet_image_segmentation_tpu_torch import serving, serving_quant as sq
    from unet_image_segmentation_tpu_torch.inference import Predictor
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as tfs
    from unet_image_segmentation_tpu_torch.streaming import StreamingPredictor
    mesh = tmesh.create_mesh(data=2, spatial=2)
    pred = Predictor(tmp + "/ckpt", image_size=({hw}, {hw}), use_pallas=True, device="cpu")
    x = torch.from_numpy(np.load(tmp + "/x.npy"))
    with open(tmp + "/scales.json") as f:
        scales = json.load(f)
    kw = dict(num_classes=1, depth=2, compute_dtype=torch.float32, device="cpu")
    tfs.reset_launch_counts()
    fwd = serving.build_serving_forward_sharded(pred.variables, mesh, **kw)
    out["float"] = mesh.gather(fwd(mesh.shard(x))).numpy()
    fwd = sq.build_serving_forward_sharded_quant(pred.variables, scales, mesh, **kw)
    out["quant"] = mesh.gather(fwd(mesh.shard(x))).numpy()
    frames = np.load(tmp + "/frames.npy")
    out["probs"] = StreamingPredictor(pred, frames.shape[1:3], batch_size=len(frames),
                                      threshold=None, mesh=mesh)(frames)
    module = Predictor(tmp + "/ckpt", image_size=({hw}, {hw}), device="cpu")
    out["module probs"] = StreamingPredictor(module, frames.shape[1:3], batch_size=len(frames),
                                             threshold=None, mesh=mesh)(frames)
    assert sum(tfs.LAUNCHES.values()) == 0   # the CPU runs K7's plain versions
torch.distributed.barrier()
np.savez(tmp + f"/out{{rank}}.npz", **out)
torch.distributed.destroy_process_group()
print("RANK_OK", rank, flush=True)
'''


def _spawn(job, world, tmp):
    """Start ``world`` ranks of ``job``; they rendezvous through a file
    under ``tmp``."""
    code = _CHILD.format(root=ROOT, job=job, world=world, tmp=str(tmp), hw=HW)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _join(procs, tmp):
    """Wait for every rank (each within CHILD_TIMEOUT seconds); a rank that
    fails or hangs fails the test. Returns each rank's outputs."""
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank did not finish within {CHILD_TIMEOUT} s")
        logs.append(log)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in log, log[-3000:]
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(len(procs))]


def test_halo_exchange_matches_jax(tmp_path):
    """3 ranks joined by ``initialize`` with an explicit address (a file://
    rendezvous): an all_reduce sums across them (the counterpart of
    tests/test_multihost.py), and halos of 1 and 2 rows of 12 rows in fp32,
    bf16 and int8 equal JAX ``halo_exchange`` on a 3-device spatial mesh,
    zeros at the edges."""
    x = np.random.RandomState(3).randint(-100, 100, (2, 12, 5, 4)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    procs = _spawn("halo", 3, tmp_path)
    mesh = jax_create_mesh(data=1, spatial=3)
    want = {}
    for h in (1, 2):
        fn = shard_map(lambda xl, h=h: jhalo.halo_exchange(xl, "spatial", h), mesh=mesh,
                       in_specs=P(None, "spatial"), out_specs=P(None, "spatial"),
                       check_vma=False)
        want[h] = np.asarray(fn(jnp.asarray(x))).reshape(2, 3, 4 + 2 * h, 5, 4)
    outs = _join(procs, tmp_path)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["sum"], np.full(3, 6.0, np.float32))
        for dtype in ("float32", "bfloat16", "int8"):
            for h in (1, 2):
                np.testing.assert_array_equal(out[f"{dtype} {h}"], want[h][:, r])


def test_sharded_serving_and_stream_match_jax(tmp_path):
    """(data=2, spatial=2), 4 ranks: the sharded float graph within 2e-5 of
    JAX's (tests/test_serving.py's bar), the sharded int8 graph with at most
    0.1% of its probabilities more than 1e-5 from JAX's and none 5e-3
    (tests/test_quant_serving.py's, on its model), and the sharded
    StreamingPredictor's probabilities within 1e-4 of JAX's (its module
    path, which GSPMD partitions over the mesh; the masks are these
    probabilities thresholded, as tests/test_torch_streaming.py holds),
    served by the kernel graph and by a module-path Predictor (the composed
    modules' row-sharded forward); every rank returns the whole answer."""
    # the JAX tests' model, JAX-initialised from PRNGKey(2); the variables
    # do not depend on the init input's size, and init under jit gives the
    # same bits as init_unet's eager run, in a third of its time
    model = JaxUNet(num_classes=1, filters=FILTERS, dropout_rate=0.0)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: init_unet(model, key, (16, 16, 3)))(jax.random.PRNGKey(2)))
    save_inference_variables(str(tmp_path / "ckpt"), state_dict_from_flax(variables),
                             {"num_classes": 1, "filters": list(FILTERS), "dropout_rate": 0.0})
    rng = np.random.RandomState(4)
    x = rng.rand(4, HW, HW, 3).astype(np.float32)
    frames = (rng.rand(4, *FRAME, 3) * 255).astype(np.uint8)
    kw = dict(num_classes=1, depth=2)
    scales = sq.calibrate_chained(variables, torch.from_numpy(x), compute_dtype=torch.float32,
                                  **kw)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "frames.npy", frames)
    with open(tmp_path / "scales.json", "w") as f:
        json.dump(scales, f)
    procs = _spawn("serving", 4, tmp_path)

    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    mesh = jax_create_mesh(data=2, spatial=2)
    kw["compute_dtype"] = jnp.float32
    want_float = np.asarray(jserving.build_serving_forward_sharded(jvars, mesh, **kw)(
        jnp.asarray(x)))
    want_quant = np.asarray(jsq.build_serving_forward_sharded_quant(jvars, scales, mesh, **kw)(
        jnp.asarray(x)))
    want_probs = np.asarray(JaxStreamingPredictor(jax_predictor(variables), FRAME, batch_size=4,
                                                  threshold=None, mesh=mesh)(frames))
    for out in _join(procs, tmp_path):
        np.testing.assert_allclose(out["float"], want_float, atol=2e-5, rtol=1e-4)
        diff = np.abs(out["quant"] - want_quant)
        assert float((diff > 1e-5).mean()) <= 1e-3 and diff.max() < 5e-3, diff.max()
        np.testing.assert_allclose(out["probs"], want_probs, atol=1e-4)
        np.testing.assert_allclose(out["module probs"], want_probs, atol=1e-4)
