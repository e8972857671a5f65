"""The port's row-sharded and data-parallel training against the JAX package's.

* K1's halo mode: the plain version (the CPU path of ``chain_fwd(...,
  halo=)``) against JAX ``_fwd_train_pallas(halo=)`` in interpret mode where
  the JAX kernel takes the shape (16 channels, 16 columns), and against the
  JAX chain's halo-augmented slab (``_chain_fwd_impl``'s path for a link no
  lane packing fits) at ragged shapes: H 10 and 16, W 12, C 3/5/16, F 8/24;
  halo above, below and both; the input affine on and off. fp32: y and its
  sums within 1e-5 of max(1, max|JAX|).
* ``halo_row_contrib`` and its closed-form vjp against JAX
  ``_halo_row_contrib`` and ``jax.vjp``.
* Under gloo in spawned processes (one a rank, a ``file://`` rendezvous
  under the test's directory, each child with its own timeout, the JAX
  numbers computed in the parent while the ranks run), one job of 2 ranks
  and one of 4: the sharded chain, the pool chain and the head chain over 2
  and 4 row shards against the JAX sharded chains on the CPU mesh
  (``tests/test_spatial_train.py``'s bars: forward 2e-4, moments 1e-5,
  gradients and dx 3e-4), and the whole train step on meshes (1, 2), (2, 1)
  and (2, 2) (32 px, batch 4, filters (8, 16), dropout 0): the gradients
  the optimizer took (summed over the ranks, divided by the data degree)
  within 3e-4 of each tensor's max|g| of the JAX unsharded XLA model's
  gradient of the global batch's loss; loss and dice rtol 2e-5 against
  that same JAX step (one jit of ``jax.value_and_grad`` and the
  optimizer's update, from the same weights; a JAX mesh step's numerics
  are its), parameters after the step within 4.5e-3 (JAX's own test's bar: Adam's
  first step moves a weight by about +-lr whatever its gradient, so this
  only bounds the optimizer's composition), BatchNorm statistics within
  1e-4. In the same jobs: the composed step (BatchNorm moments over the
  group) on a (2, 1) mesh, its gradients against the one-process composed
  step's and JAX's (3e-4 of max|g|); ``fit`` on two row shards (its
  config's mesh) against ``fit`` in one process, with the dice loss through
  the chains and with bce, which drops to the composed row-sharded path.
* ``fit`` refuses a batch the data degree does not divide, and in one
  process clamps the 1024 px config's spatial degree to 1 with the JAX
  package's Note. The launch plans at the 1024 px shard shapes,
  and K1's halo-mode bound by hand.

About 35 s alone on the CPU: the JAX sharded chains (~21 s) are most of
it.
"""

import dataclasses
import math
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

from test_torch_model import numpy_weights
from unet_image_segmentation_tpu.config import Config
from unet_image_segmentation_tpu.models.unet import build_unet as build_unet_jax
from unet_image_segmentation_tpu.ops import losses as jlosses
from unet_image_segmentation_tpu.ops.pallas import fused_head as jfh
from unet_image_segmentation_tpu.ops.pallas import fused_train as jft
from unet_image_segmentation_tpu.parallel.mesh import create_mesh as jax_create_mesh
from unet_image_segmentation_tpu.train.state import create_train_state as create_state_jax
from unet_image_segmentation_tpu.train.steps import (
    _metric_bundle,
    _prep_masks,
    _psum_replicated_cotangent,
)
from unet_image_segmentation_tpu_torch.config import Config as TorchConfig
from unet_image_segmentation_tpu_torch.models.unet import build_unet
from unet_image_segmentation_tpu_torch.ops import fused_train as tft
from unet_image_segmentation_tpu_torch.ops import hash_dropout as thd
from unet_image_segmentation_tpu_torch.parallel.mesh import Mesh
from unet_image_segmentation_tpu_torch.train import loop
from unet_image_segmentation_tpu_torch.train.state import create_train_state
from unet_image_segmentation_tpu_torch.train.steps import make_train_step
from unet_image_segmentation_tpu_torch.weights import flax_from_state_dict, state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 240
HALO_TOL = 1e-5   # of max(1, max|JAX|): y, and the sums over its pixels
FWD_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_spatial_train.py's bars
MOMENT_TOL = dict(rtol=0, atol=1e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
GRAD_REL = 3e-4   # a step's gradient tensors, of their max|g|
STEP_MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
HW, BATCH, FILTERS = 32, 4, (8, 16)
# the chains of the spawned jobs: (B, H, W, channels) of the plain and pool
# chains (no lane packing fits: the JAX chain runs its halo-augmented slabs)
# and of the head chain (16 columns pack the head's 8 channels 16-fold)
CHAIN = (2, 16, 12, (8, 8, 8))
HEAD = (2, 16, 16, (16, 8, 8))


# --------------------------------------------------------------------------
# K1's halo mode, plain, against JAX
# --------------------------------------------------------------------------


def _link_inputs(seed, b, h, w, c, f):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    dw = (rng.randn(3, 3, c) * 0.3).astype(np.float32)
    pw = (rng.randn(c, f) * 0.3).astype(np.float32)
    aff = np.stack([1 + 0.3 * rng.randn(c), 0.2 * rng.randn(c)]).astype(np.float32)
    halo = np.abs(rng.randn(b, 2, w, c)).astype(np.float32)
    return x, dw, pw, aff, halo


def _jax_halo_slab(x, dw, pw, aff, halo):
    """The JAX chain's link on a halo-augmented slab (``_chain_fwd_impl``
    where no packing fits): the affine, the halo rows concatenated, the
    'same' sepconv, the two extra rows sliced off; the sums over y."""
    z = jnp.asarray(x)
    if aff is not None:
        z = jnp.maximum(z * aff[0] + aff[1], 0.0)
    z_aug = jnp.concatenate([halo[:, :1], z, halo[:, 1:]], axis=1)
    y = jft._sepconv_raw(z_aug, jnp.asarray(dw), jnp.asarray(pw))[:, 1:-1]
    return np.asarray(y), np.asarray(y.sum(axis=(0, 1, 2))), np.asarray((y * y).sum(axis=(0, 1, 2)))


def _port_halo_link(x, dw, pw, aff, halo):
    y, s, q = tft.chain_fwd(*(torch.from_numpy(a) for a in (x, dw, pw)),
                            None if aff is None else torch.from_numpy(aff), None,
                            torch.from_numpy(halo))
    return y.numpy(), s.numpy(), q.numpy()


HALO_SIDES = {"above": (1, 0), "below": (0, 1), "both": (1, 1)}


def _close(got, want, msg):
    want = np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    assert err <= HALO_TOL * max(1.0, float(np.max(np.abs(want)))), (msg, err)


@pytest.mark.parametrize("h", [10, 16])
@pytest.mark.parametrize("c", [3, 5, 16])
@pytest.mark.parametrize("f", [8, 24])
def test_plain_halo_link_matches_the_jax_halo_slab(h, c, f):
    """W = 12: no lane packing fits these widths, so the JAX chain runs the
    link on its halo-augmented slab; each side and the affine on and off."""
    x, dw, pw, aff, halo = _link_inputs(h * 100 + c * 10 + f, 2, h, 12, c, f)
    for side, keep in HALO_SIDES.items():
        hl = halo * np.asarray(keep, np.float32)[None, :, None, None]
        for a in (aff, None):
            got = _port_halo_link(x, dw, pw, a, hl)
            want = _jax_halo_slab(x, dw, pw, a, hl)
            for g, w_ in zip(got, want):
                _close(g, w_, f"{side} affine {a is not None}")


@pytest.mark.parametrize("f", [8, 24])
def test_plain_halo_link_matches_the_jax_kernel(f):
    """16 channels on 16 columns pack 16-fold: the JAX K1 itself
    (``_fwd_train_pallas(halo=)``, interpret mode) takes the halo."""
    x, dw, pw, aff, halo = _link_inputs(f, 2, 16, 16, 16, f)
    for side, a in (("both", aff), ("above", None), ("below", aff)):
        hl = halo * np.asarray(HALO_SIDES[side], np.float32)[None, :, None, None]
        want = jft._fwd_train_pallas(
            jnp.asarray(x), jnp.asarray(dw), jnp.asarray(pw),
            None if a is None else jnp.asarray(a[0]), None if a is None else jnp.asarray(a[1]),
            halo=jnp.asarray(hl))
        assert want is not None
        for g, w_ in zip(_port_halo_link(x, dw, pw, a, hl), want):
            _close(g, w_, side)


def test_zero_halo_is_the_link_without_one():
    x, dw, pw, aff, halo = _link_inputs(5, 2, 10, 12, 5, 8)
    for a in (aff, None):
        got = _port_halo_link(x, dw, pw, a, np.zeros_like(halo))
        want = tft.chain_fwd(torch.from_numpy(x), torch.from_numpy(dw), torch.from_numpy(pw),
                             None if a is None else torch.from_numpy(a))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_.numpy())


def test_chain_fwd_refuses_dropout_with_a_halo():
    x, dw, pw, _, halo = _link_inputs(6, 2, 10, 12, 5, 8)
    with pytest.raises(ValueError, match="dropout and the halo"):
        tft.chain_fwd(torch.from_numpy(x), torch.from_numpy(dw), torch.from_numpy(pw), None,
                      tft.Dropout(7, 0.2), torch.from_numpy(halo))


@pytest.mark.parametrize("b,w,c,f", [(2, 12, 5, 8), (1, 9, 16, 24)])
def test_halo_row_contrib_and_its_vjp_match_jax(b, w, c, f):
    rng = np.random.RandomState(b * w + c)
    h_row = rng.randn(b, 1, w, c).astype(np.float32)
    ktap = rng.randn(3, c).astype(np.float32)
    pw = rng.randn(c, f).astype(np.float32)
    g = rng.randn(b, 1, w, f).astype(np.float32)
    want, vjp = jax.vjp(jft._halo_row_contrib, *(jnp.asarray(a) for a in (h_row, ktap, pw)))
    got = tft.halo_row_contrib(*(torch.from_numpy(a) for a in (h_row, ktap, pw)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got_vjp = tft.halo_row_contrib_vjp(*(torch.from_numpy(a) for a in (h_row, ktap, pw, g)))
    for name, gv, wv in zip(("d_h_row", "d_ktap", "d_pw"), got_vjp, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_fold_seed_gives_each_index_its_own_seed():
    seeds = {thd.fold_seed(12345, i) for i in range(64)}
    assert len(seeds) == 64 and all(-2**31 <= s < 2**31 for s in seeds)
    assert thd.fold_seed(12345, 3) == thd.fold_seed(12345 + 2**32, 3)   # the low 32 bits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_plans_at_the_1024_px_shapes(dtype):
    """K1's plan at the 18 links of a rank of 2 row shards of the 1024 px
    model at batch 4 (512 x 1024), and K4's at its four boundaries
    (1024..128 px, batch 4): every F channel in a slice, and K4's strips
    covering every pooled window once."""
    from unet_image_segmentation_tpu_torch.troubleshoot import roofline

    for name, c, f, h, w in roofline.shard_links(1024, (64, 128, 256, 512), 2):
        assert w == 2 * h, name   # half the rows of a square image
        plan = tft.fwd_plan(BATCH, h, w, c, f, dtype, 132)
        assert plan.n * plan.s >= f and plan.grid[0] % plan.n == 0
        assert plan.tiles_y * plan.tiles_x == math.ceil(h / 8) * math.ceil(w / 8)
    for name, f, h in roofline.pool_shapes(1024, (64, 128, 256, 512)):
        plan = tft.pool_bwd_plan(BATCH, h, h, f, dtype, 132)
        assert plan.strips == BATCH * (h // 2) * math.ceil(h // 2 / plan.n)
        ranges = tft.stream_ranges(plan.strips, plan.ctas)
        assert ranges[0][0] == 0 and ranges[-1][1] == plan.strips
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_halo_mode_bound_by_hand():
    """K1's halo mode moves K1's bytes plus the two halo rows and does its
    operations; a shard link's shape carries its width."""
    from unet_image_segmentation_tpu_torch.troubleshoot import roofline

    link = ("dec1.2", 64, 64, 512, 1024)
    px = 4 * 512 * 1024
    for dname, e in (("bfloat16", 2), ("float32", 4)):
        nbytes, ops = roofline.work("chain_fwd_halo", link, dname, 4)
        assert nbytes == e * (px * 128 + 4 * 2 * 1024 * 64 + 9 * 64 + 64 * 64) + 8 * 64
        assert ops == 2 * px * (9 * 64 + 64 * 64)
    assert roofline.KERNELS["chain_fwd_halo"][1:] == roofline.KERNELS["chain_fwd"][1:]


# --------------------------------------------------------------------------
# fit's mesh and path selection
# --------------------------------------------------------------------------


def _port_cfg(**over):
    cfg = TorchConfig().override(model__image_height=HW, model__image_width=HW,
                                 model__filters=FILTERS, model__use_pallas=True,
                                 model__dropout_rate=0.0, train__batch_size=BATCH)
    return cfg.override(**over) if over else cfg


@pytest.mark.parametrize("over,match", [
    ({"train__batch_size": 3}, "not divisible by data-parallel"),
])
def test_fit_raises_where_the_port_has_no_sharded_path(over, match):
    """``fit``'s check of its config against its mesh, on a (2, 1) mesh
    laid out by hand (the check runs before anything crosses ranks): a
    batch the data degree does not divide has no layout, as in JAX. Every
    row-sharded configuration trains (``tests/test_torch_spatial_module.py``
    holds the composed row-sharded path, where the chains cannot go, to JAX's
    GSPMD step)."""
    with pytest.raises(ValueError, match=match):
        loop._model_config(_port_cfg(**over), Mesh(2, 1))


class _Memory:
    def __init__(self, x, m):
        self.x, self.m = x, m

    def __len__(self):
        return len(self.x)

    def batches(self, batch_size, epoch=0, steps=None, num_workers=0):
        for i in range(min(len(self.x) // batch_size, steps or len(self.x))):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            yield self.x[sl], self.m[sl]


def test_fit_clamps_the_spatial_degree_in_one_process(tmp_path, capsys):
    """``configs/highres_1024.json`` asks for 2 row shards; one process has
    one rank, so fit clamps it to 1 with the JAX package's Note, and trains
    (at 32 px, filters (8, 16) here)."""
    with open(os.path.join(ROOT, "configs", "highres_1024.json")) as f:
        cfg = TorchConfig.from_json(f.read())
    assert cfg.mesh.spatial_axis == 2
    cfg = cfg.override(model__image_height=HW, model__image_width=HW, model__filters=FILTERS,
                       model__compute_dtype="float32", train__epochs=1,
                       train__model_out=str(tmp_path / "m"), train__log_dir=str(tmp_path / "l"))
    rng = np.random.RandomState(4)
    x = rng.rand(8, HW, HW, 3).astype(np.float32)
    m = (rng.rand(8, HW, HW, 1) > 0.5).astype(np.float32)
    res = loop.fit(cfg, _Memory(x[:4], m[:4]), _Memory(x[4:], m[4:]), device="cpu")
    assert "Note: mesh spatial=2 clamped to 1 (1 rank(s) present)." in capsys.readouterr().out
    assert res.epochs_run == 1 and np.isfinite(res.history["loss"][-1])


# --------------------------------------------------------------------------
# spawned ranks: the sharded chains and steps
# --------------------------------------------------------------------------

_CHILD = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from unet_image_segmentation_tpu_torch.config import Config
from unet_image_segmentation_tpu_torch.models.unet import build_unet
from unet_image_segmentation_tpu_torch.ops import fused_head as tfh, fused_train as tft
from unet_image_segmentation_tpu_torch.ops.losses import loss_from_sums
from unet_image_segmentation_tpu_torch.parallel import distributed, mesh as tmesh
from unet_image_segmentation_tpu_torch.parallel.reduce import all_sum, replicated_sum
from unet_image_segmentation_tpu_torch.train.state import create_train_state
from unet_image_segmentation_tpu_torch.train.steps import make_train_step

rank, world, tmp = int(sys.argv[1]), {world}, {tmp!r}
torch.set_num_threads(1)
distributed.initialize("file://" + tmp + "/store{world}", num_processes=world, process_id=rank,
                       device="cpu")
inp = dict(np.load(tmp + "/inputs.npz"))
out = {{}}
mesh = tmesh.create_mesh(data=1, spatial=world)
groups = tft.Groups(mesh.group, mesh.spatial_group)


def blocks(prefix):
    n = sum(1 for k in inp if k.startswith(prefix + " dw"))
    return [tuple(torch.from_numpy(inp[f"{{prefix}} {{p}}{{i}}"]).requires_grad_()
                  for p in ("dw", "pw", "gamma", "beta")) for i in range(n)]


def finish(tag, val, x_loc, params, outs, partial=True):
    val.backward()
    out[tag + " val"] = (all_sum(val.detach(), mesh.group) if partial else val.detach()).numpy()
    out[tag + " dx"] = mesh.gather(x_loc.grad).numpy()
    for i, p in enumerate(params):
        out[f"{{tag}} d{{i}}"] = all_sum(p.grad, mesh.group).numpy()
    for name, t in outs.items():
        out[f"{{tag}} {{name}}"] = t.detach().numpy()


for pool in (False, True):
    x_loc = mesh.shard(torch.from_numpy(inp["chain x"])).requires_grad_()
    blk = blocks("chain")
    if pool:
        z, pooled, stats = tft.fused_chain_train_pool(x_loc, blk, groups=groups)
        val = (z.float() ** 2).sum() + torch.sin(pooled.float()).sum()
        outs = dict(z=mesh.gather(z), pooled=mesh.gather(pooled))
    else:
        z, stats = tft.fused_chain_train(x_loc, blk, groups=groups)
        val = (z.float() ** 2).sum()
        outs = dict(z=mesh.gather(z))
    outs.update({{f"m{{i}}": torch.stack(s) for i, s in enumerate(stats)}})
    finish("pool" if pool else "chain", val, x_loc, [t for b in blk for t in b], outs)

x_loc = mesh.shard(torch.from_numpy(inp["head x"])).requires_grad_()
blk = blocks("head")
w = torch.from_numpy(inp["head w"]).requires_grad_()
b = torch.from_numpy(inp["head b"]).requires_grad_()
sums, stats = tfh.fused_head_train(x_loc, blk, w, b, mesh.shard(torch.from_numpy(inp["head t"])),
                                   groups=groups)
loss = loss_from_sums("dice", {{k: replicated_sum(v, mesh.spatial_group)
                                for k, v in sums.items()}})
finish("head", loss, x_loc, [t for bl in blk for t in bl] + [w, b],
       {{f"m{{i}}": torch.stack(s) for i, s in enumerate(stats)}}, partial=False)

cfg = Config.from_json(open(tmp + "/config.json").read())
state_dict = {{k[6:]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("model ")}}
x, m = torch.from_numpy(inp["step x"]), torch.from_numpy(inp["step m"])
for data, spatial in {meshes!r}:
    smesh = tmesh.create_mesh(data=data, spatial=spatial)
    model = build_unet(cfg.model, device="cpu")
    model.set_groups(smesh.group, smesh.spatial_group)
    model.load_state_dict(state_dict)
    state = create_train_state(cfg, model=model, device="cpu")
    met = make_train_step(model, "dice", smesh)(state, smesh.shard(x), smesh.shard(m))
    tag = f"step {{data}}x{{spatial}}"
    out.update({{f"{{tag}} {{k}}": v.numpy() for k, v in met.items()}})
    out.update({{f"{{tag}} sd {{k}}": v.numpy() for k, v in model.state_dict().items()}})
    # the step's gradients as the optimizer took them (summed over the mesh)
    out.update({{f"{{tag}} grad {{n}}": p.grad.numpy() for n, p in model.named_parameters()}})
if world == 2:   # the composed step (BatchNorm moments over the group) on (2, 1)
    ccfg = Config.from_dict({{**cfg.to_dict(), "model": {{**cfg.to_dict()["model"],
                                                       "use_pallas": False}}}})
    smesh = tmesh.create_mesh(data=2, spatial=1)
    model = build_unet(ccfg.model, device="cpu")
    model.set_groups(smesh.group)
    model.load_state_dict(state_dict)
    state = create_train_state(ccfg, model=model, device="cpu")
    met = make_train_step(model, "dice", smesh)(state, smesh.shard(x), smesh.shard(m))
    out["composed loss"] = met["loss"].numpy()
    out.update({{f"composed sd {{k}}": v.numpy() for k, v in model.state_dict().items()}})
    out.update({{f"composed grad {{n}}": p.grad.numpy() for n, p in model.named_parameters()}})
if world == 2:   # fit on the config's mesh: (1, 2) over the two ranks
    from unet_image_segmentation_tpu_torch.train.loop import fit

    class Memory:
        def __init__(self, x, m):
            self.x, self.m = x, m

        def __len__(self):
            return len(self.x)

        def batches(self, batch_size, epoch=0, steps=None, num_workers=0):
            for i in range(len(self.x) // batch_size):
                yield self.x[i * batch_size:(i + 1) * batch_size], \
                    self.m[i * batch_size:(i + 1) * batch_size]

    fcfg = Config.from_json(open(tmp + "/fit_config.json").read())
    fx, fm = inp["fit x"], inp["fit m"]
    res = fit(fcfg, Memory(fx[:8], fm[:8]), Memory(fx[8:], fm[8:]), device="cpu")
    out["fit loss"] = np.array(res.history["loss"])
    out["fit val_loss"] = np.array(res.history["val_loss"])
    import os
    out["fit files"] = np.array(sorted(os.listdir(fcfg.train.model_out)))
    # bce has no sums form: fit drops use_pallas and trains the composed rows
    import contextlib, io
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = fit(fcfg.override(train__loss="bce", train__model_out=fcfg.train.model_out + "_bce"),
                  Memory(fx[:8], fm[:8]), Memory(fx[8:], fm[8:]), device="cpu")
    out["fit bce loss"] = np.array(res.history["loss"])
    out["fit bce val_loss"] = np.array(res.history["val_loss"])
    out["fit bce printed"] = np.array(printed.getvalue())
if rank == 0:
    np.savez(tmp + "/out{world}.npz", **out)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print("RANK_OK", rank, flush=True)
'''


def _spawn(world, tmp):
    code = _CHILD.format(root=ROOT, world=world, tmp=str(tmp), meshes=STEP_MESHES[world])
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _join(procs, tmp, world):
    """Wait for every rank (each within CHILD_TIMEOUT seconds); a rank that
    fails or hangs fails the test. Returns rank 0's outputs."""
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
    return dict(np.load(tmp / f"out{world}.npz"))


def _chain_blocks(rng, chans):
    out = []
    for c, f in zip(chans[:-1], chans[1:]):
        out.append(((rng.randn(3, 3, c) * 0.3).astype(np.float32),
                    (rng.randn(c, f) * 0.3).astype(np.float32),
                    (1.0 + 0.1 * rng.randn(f)).astype(np.float32),
                    (0.1 * rng.randn(f)).astype(np.float32)))
    return out


def _inputs():
    """Every input of the spawned jobs, from seeded numpy."""
    rng = np.random.RandomState(2301)
    inp = {}
    for tag, (b, h, w, chans) in (("chain", CHAIN), ("head", HEAD)):
        inp[f"{tag} x"] = (rng.randn(b, h, w, chans[0]) * 0.5).astype(np.float32)
        for i, blk in enumerate(_chain_blocks(rng, chans)):
            for name, a in zip(("dw", "pw", "gamma", "beta"), blk):
                inp[f"{tag} {name}{i}"] = a
    b, h, w, chans = HEAD
    inp["head w"] = (rng.randn(1, 1, chans[-1], 1) * 0.5).astype(np.float32)
    inp["head b"] = np.array([0.1], np.float32)
    inp["head t"] = (rng.rand(b, h, w, 1) > 0.5).astype(np.float32)
    inp["step x"] = rng.rand(BATCH, HW, HW, 3).astype(np.float32)
    inp["step m"] = (rng.rand(BATCH, HW, HW, 1) > 0.5).astype(np.float32)
    inp["fit x"] = rng.rand(12, HW, HW, 3).astype(np.float32)
    inp["fit m"] = (rng.rand(12, HW, HW, 1) > 0.5).astype(np.float32)
    return inp


def _fit_cfg(tmp):
    """The port config ``fit`` trains on two row shards (and unsharded): 2
    epochs of 2 steps, the mesh asking for 2 row shards."""
    return TorchConfig.from_dict(_step_cfg().to_dict()).override(
        train__epochs=2, train__model_out=str(tmp / "fit"), train__log_dir=str(tmp / "logs"),
        mesh__spatial_axis=2)


def _blocks_of(inp, tag):
    n = sum(1 for k in inp if k.startswith(tag + " dw"))
    return [tuple(jnp.asarray(inp[f"{tag} {p}{i}"]) for p in ("dw", "pw", "gamma", "beta"))
            for i in range(n)]


def _jax_chains(inp, n):
    """The JAX sharded plain, pool and head chains over ``n`` row shards:
    their outputs (gathered), moments, loss, input cotangent and parameter
    gradients (psum'd over the shards)."""
    mesh = jax_create_mesh(data=1, spatial=n, devices=jax.devices()[:n])
    spec = P(None, "spatial", None, None)
    kw = dict(axis_name="spatial", spatial_axis="spatial")
    out = {}

    def run(loss_fn, x, flat, n_out):
        def local(x_l, *fp):
            (val, aux), grads = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
                x_l, list(fp))
            return (jax.lax.psum(val, "spatial"), aux, grads[0],
                    jax.lax.psum(grads[1], "spatial"))

        fn = shard_map(local, mesh=mesh, in_specs=(spec,) + (P(),) * len(flat),
                       out_specs=(P(), n_out, spec, P()), check_vma=False)
        return jax.jit(fn)(x, *flat)

    def unflat(fp):
        return [tuple(fp[i:i + 4]) for i in range(0, len(fp), 4)]

    x = jnp.asarray(inp["chain x"])
    flat = [t for b in _blocks_of(inp, "chain") for t in b]

    def plain(x_l, fp):
        z, stats = jft.fused_chain_train(x_l, unflat(fp), **kw)
        return jnp.sum(z.astype(jnp.float32) ** 2), (z, stats)

    val, (z, stats), dx, dp = run(plain, x, flat, (spec, P()))
    out["chain"] = dict(val=val, z=z, stats=stats, dx=dx, dp=dp)

    def pooled(x_l, fp):
        z_p, p, pool, stats = jft.fused_chain_train_pool(x_l, unflat(fp), pool_to_pack=1, **kw)
        b_, h_, w_, f_ = x_l.shape[0], x_l.shape[1], x_l.shape[2], fp[-3].shape[-1]
        z = z_p.reshape(b_, h_, w_, f_)
        pool = pool.reshape(b_, h_ // 2, w_ // 2, f_)
        val = jnp.sum(z.astype(jnp.float32) ** 2) + jnp.sum(jnp.sin(pool.astype(jnp.float32)))
        return val, (z, pool, stats)

    val, (z, pool, stats), dx, dp = run(pooled, x, flat, (spec, spec, P()))
    out["pool"] = dict(val=val, z=z, pooled=pool, stats=stats, dx=dx, dp=dp)

    x = jnp.asarray(inp["head x"])
    flat = [t for b in _blocks_of(inp, "head") for t in b] + [jnp.asarray(inp["head w"]),
                                                               jnp.asarray(inp["head b"])]
    t_all = jnp.asarray(inp["head t"])

    def head(x_l, fp, t_l):
        res = jfh.fused_head_train(x_l, unflat(fp[:-2]), fp[-2], fp[-1], t_l, **kw)
        assert res is not None
        sums, stats = res
        sums = _psum_replicated_cotangent(sums, "spatial")
        return jlosses.loss_from_sums("dice", sums), stats

    def local_head(x_l, t_l, *fp):
        (val, stats), grads = jax.value_and_grad(
            lambda a, b: head(a, b, t_l), argnums=(0, 1), has_aux=True)(x_l, list(fp))
        return val, stats, grads[0], jax.lax.psum(grads[1], "spatial")

    fn = shard_map(local_head, mesh=mesh, in_specs=(spec, spec) + (P(),) * len(flat),
                   out_specs=(P(), P(), spec, P()), check_vma=False)
    val, stats, dx, dp = jax.jit(fn)(x, t_all, *flat)
    out["head"] = dict(val=val, stats=stats, dx=dx, dp=dp)
    return out


def _step_cfg():
    return Config().override(model__image_height=HW, model__image_width=HW,
                             model__filters=FILTERS, model__use_pallas=True,
                             model__dropout_rate=0.0, train__batch_size=BATCH)


def _jax_step(inp, sd):
    """The JAX package's unsharded XLA train step (``use_pallas`` off) on
    the global batch from the weights ``sd``, as one jit of
    ``jax.value_and_grad`` and the optimizer's update (``make_train_step``'s
    body without a mesh): its metrics, the weights and statistics after it,
    and the gradient every sharded step must take, by parameter name. A
    mesh step's numerics are this step's (``make_train_step(mesh=)``: equal
    shards, moments and gradients reduced over the mesh)."""
    cfg = _step_cfg()
    model = build_unet_jax(dataclasses.replace(cfg.model, use_pallas=False))
    tx = create_state_jax(cfg, model=model).tx
    variables = jax.tree_util.tree_map(jnp.asarray, flax_from_state_dict(sd))
    x, m = jnp.asarray(inp["step x"]), jnp.asarray(inp["step m"])

    def step(params, stats, opt_state):
        def loss(p):
            preds, mutated = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                         mutable=["batch_stats"])
            return jlosses.get_loss("dice")(_prep_masks(m, 1), preds), (
                preds, mutated["batch_stats"])

        (val, (preds, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        new_params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return {"loss": val, **_metric_bundle(m, preds, 1)}, new_params, new_stats, grads

    params = variables["params"]
    met, new_params, new_stats, grads = jax.jit(step)(params, variables["batch_stats"],
                                                      tx.init(params))

    def by_name(tree):
        return {k: v.numpy() for k, v in state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, tree)).items()}

    return ({k: np.asarray(v) for k, v in met.items()},
            by_name({"params": new_params, "batch_stats": new_stats}),
            by_name({"params": grads}))


def _close_grads(got, want, msg):
    """Each gradient tensor within GRAD_REL of its max|g|."""
    for name, g in want.items():
        err = float(np.max(np.abs(got[name] - g)))
        assert err <= GRAD_REL * float(np.max(np.abs(g))), (msg, name, err)


def _composed_step(inp, sd):
    """The port's composed step (no kernels, plain BatchNorm) in one
    process from the weights ``sd``: its loss, the weights after it and
    its gradients."""
    cfg = TorchConfig.from_dict(_step_cfg().to_dict()).override(model__use_pallas=False)
    model = build_unet(cfg.model, device="cpu")
    model.load_state_dict(sd)
    state = create_train_state(cfg, model=model, device="cpu")
    met = make_train_step(model, "dice")(state, torch.from_numpy(inp["step x"]),
                                         torch.from_numpy(inp["step m"]))
    return (float(met["loss"]), {k: v.numpy() for k, v in model.state_dict().items()},
            {n: p.grad.numpy() for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Both spawned jobs started, the JAX references computed meanwhile,
    then the jobs joined: ``(port outputs by world, JAX chains by world,
    (JAX step's metrics, its weights after the step, the JAX gradient),
    (fit in one process, the one-process composed step))``."""
    tmp = tmp_path_factory.mktemp("spatial")
    inp = _inputs()
    tmodel = build_unet(TorchConfig.from_dict(_step_cfg().to_dict()).model, device="cpu")
    sd = numpy_weights(tmodel, 7)
    inp.update({f"model {k}": v.numpy() for k, v in sd.items()})
    np.savez(tmp / "inputs.npz", **inp)
    (tmp / "config.json").write_text(TorchConfig.from_dict(_step_cfg().to_dict()).to_json())
    (tmp / "fit_config.json").write_text(_fit_cfg(tmp).to_json())
    procs = {world: _spawn(world, tmp) for world in STEP_MESHES}
    jax_chains = {world: _jax_chains(inp, world) for world in STEP_MESHES}
    jax_step = _jax_step(inp, sd)
    fx, fm = inp["fit x"], inp["fit m"]
    one = loop.fit(_fit_cfg(tmp / "one"), _Memory(fx[:8], fm[:8]), _Memory(fx[8:], fm[8:]),
                   device="cpu", verbose=False).history
    one_bce = loop.fit(_fit_cfg(tmp / "one_bce").override(train__loss="bce",
                                                          model__use_pallas=False),
                       _Memory(fx[:8], fm[:8]), _Memory(fx[8:], fm[8:]), device="cpu",
                       verbose=False).history
    composed = _composed_step(inp, sd)
    port = {world: _join(p, tmp, world) for world, p in procs.items()}
    return port, jax_chains, jax_step, (one, composed, one_bce)


def _check_chain(out, want, tag, flat_len, extra=()):
    np.testing.assert_allclose(out[f"{tag} val"], float(want["val"]), rtol=1e-5)
    for name in extra:
        np.testing.assert_allclose(out[f"{tag} {name}"], np.asarray(want[name]), **FWD_TOL,
                                   err_msg=name)
    for i, (mean, var) in enumerate(want["stats"]):
        np.testing.assert_allclose(out[f"{tag} m{i}"][0], np.asarray(mean), **MOMENT_TOL)
        np.testing.assert_allclose(out[f"{tag} m{i}"][1], np.asarray(var), **MOMENT_TOL)
    np.testing.assert_allclose(out[f"{tag} dx"], np.asarray(want["dx"]), **GRAD_TOL)
    for i in range(flat_len):
        np.testing.assert_allclose(out[f"{tag} d{i}"].reshape(np.shape(want["dp"][i])),
                                   np.asarray(want["dp"][i]), **GRAD_TOL, err_msg=f"param {i}")


@pytest.mark.parametrize("world", sorted(STEP_MESHES))
def test_sharded_chain_matches_jax(sharded, world):
    port, jax_chains, _, _ = sharded
    _check_chain(port[world], jax_chains[world]["chain"], "chain", 8, ("z",))


@pytest.mark.parametrize("world", sorted(STEP_MESHES))
def test_sharded_pool_chain_matches_jax(sharded, world):
    port, jax_chains, _, _ = sharded
    _check_chain(port[world], jax_chains[world]["pool"], "pool", 8, ("z", "pooled"))


@pytest.mark.parametrize("world", sorted(STEP_MESHES))
def test_sharded_head_chain_matches_jax(sharded, world):
    port, jax_chains, _, _ = sharded
    _check_chain(port[world], jax_chains[world]["head"], "head", 10)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
def test_sharded_train_step_matches_jax(sharded, mesh):
    """The step's gradients (summed over the ranks, divided by the data
    degree) within GRAD_REL of max|g| of the JAX unsharded gradient; its
    loss and metrics, and the weights and statistics after it, as the JAX
    step's."""
    port, _, (jmet, jsd, jgrads), _ = sharded
    out = port[mesh[0] * mesh[1]]
    tag = f"step {mesh[0]}x{mesh[1]}"
    _close_grads({n: out[f"{tag} grad {n}"] for n in jgrads}, jgrads, tag)
    for key in ("loss", "dice"):
        np.testing.assert_allclose(out[f"{tag} {key}"], jmet[key], rtol=2e-5, err_msg=key)
    np.testing.assert_allclose(out[f"{tag} cm_thresh"], jmet["cm_thresh"], atol=0.5)
    for key, want in jsd.items():
        got = out[f"{tag} sd {key}"]
        if key.endswith((".mean", ".var")):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=4.5e-3, err_msg=key)


def test_fit_trains_on_two_row_shards(sharded):
    """``fit`` over two ranks, its config asking for 2 row shards: the
    epochs' train and validation losses are the one-process run's (1e-4
    relative), and rank 0 wrote the checkpoints."""
    port, _, _, (one, _, _) = sharded
    out = port[2]
    np.testing.assert_allclose(out["fit loss"], one["loss"], rtol=1e-4)
    np.testing.assert_allclose(out["fit val_loss"], one["val_loss"], rtol=1e-4)
    assert {"best", "last", "meta.json", "config.json"} <= set(out["fit files"].tolist())


def test_composed_data_parallel_step_matches_unsharded(sharded):
    """The composed path (``use_pallas`` off) on a (2, 1) mesh: the
    BatchNorm moments all-reduced over the group with their cotangents,
    the gradients summed and halved; the gradients within GRAD_REL of
    max|g| of the one-process composed step's and of the JAX unsharded
    gradient; loss and weights after the step as the one-process step's
    (loss 2e-5 relative; weights within 4.5e-3, Adam's first step;
    statistics 1e-4)."""
    port, _, (_, _, jgrads), (_, (loss, sd, grads), _) = sharded
    out = port[2]
    got = {n: out[f"composed grad {n}"] for n in grads}
    _close_grads(got, grads, "composed (2, 1) against one process")
    _close_grads(got, jgrads, "composed (2, 1) against JAX")
    np.testing.assert_allclose(out["composed loss"], loss, rtol=2e-5)
    for key, want in sd.items():
        tol = dict(rtol=1e-4, atol=1e-4) if key.endswith((".mean", ".var")) else \
            dict(rtol=0, atol=4.5e-3)
        np.testing.assert_allclose(out[f"composed sd {key}"], want, err_msg=key, **tol)


def test_fit_trains_on_two_row_shards_with_bce(sharded):
    """``fit`` over two ranks, its config asking for 2 row shards, with
    ``use_pallas`` and the bce loss (no sums form): it prints the JAX
    package's warning, drops ``use_pallas`` and trains the composed modules
    on the row shards; the epochs' train and validation losses are those of
    the composed path's ``fit`` in one process (1e-4 relative)."""
    port, _, _, (_, _, one_bce) = sharded
    out = port[2]
    assert "trains on the composed row-sharded path" in str(out["fit bce printed"])
    np.testing.assert_allclose(out["fit bce loss"], one_bce["loss"], rtol=1e-4)
    np.testing.assert_allclose(out["fit bce val_loss"], one_bce["val_loss"], rtol=1e-4)
