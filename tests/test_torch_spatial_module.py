"""The port's row-sharded module path against the JAX package's GSPMD step.

Where the fused chains cannot train a configuration on row shards, the JAX
package jits the composed model over batch- and row-sharded inputs and
GSPMD inserts the halo exchanges; the port's composed modules exchange them
by hand (``parallel/halo.halo_exchange_grad``), and a loss without a sums
form reads the gathered probabilities (``Mesh.gather_rows``).

* ``halo_exchange_grad`` on 2 and 4 row shards (spawned gloo ranks): the
  padded rows are the whole image's neighbours, and the gradient of a
  'ROWS_PADDED' 3x3 conv over the shards is autograd's through the
  unsharded 'SAME' conv.
* Under gloo in spawned processes (one job of 2 ranks on a (1, 2) mesh and
  one of 4 on a (2, 2) mesh, the JAX numbers computed in the parent while
  they run), filters (8, 16), fp32, batch 4, dropout 0 (JAX's composed
  dropout is ``jax.random``, not the port's hash): one train step of

  - full convs with bce (32 px),
  - separable blocks with dice, ``use_pallas=False`` (32 px),
  - separable blocks with bce and ``use_pallas=True``, which ``fit``'s
    path selection drops to the composed path (32 px),
  - separable blocks with dice at 36 px, whose 18-row shards do not survive
    two pools (each data row's images gathered and run whole),

  each held to ``make_train_step(model_xla, loss, mesh=None)`` on inputs
  placed with ``batch_sharding(create_mesh(2, 2), spatial=True)`` under
  JAX's own bars for its GSPMD step (``tests/test_spatial_train.py``): loss
  and dice rtol 2e-5, confusion matrices within 0.5, the raw gradients
  (a jit of ``value_and_grad`` on the same sharded inputs) and the
  BatchNorm statistics atol/rtol 1e-4; and the row-sharded eval forward
  (``parallel/halo.spatial_sharded_forward``) against JAX's at atol 1e-5.
  ``make_train_step`` also takes the ``use_pallas`` models as they are:
  bce through the chains' halo links and the gathered probabilities, the
  36 px model through the chains on the gathered images, and a model
  without BatchNorm, whose blocks run K8 (whole images only), on the
  gathered images (the chains' bars: gradients within 3e-4 of max|g|);
  ``spatial_sharded_forward`` runs them on the gathered images (K8).
* A ``use_pallas`` block raises on a row shard; a forward takes whole
  images unless its caller passes the row group.
* ``_model_config`` prints the JAX package's warning and drops
  ``use_pallas`` where the row-sharded chains cannot train a configuration.

About 75 s alone on the CPU, most of it compiling the JAX references while
the ranks run.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import numpy_weights
from unet_image_segmentation_tpu.config import Config
from unet_image_segmentation_tpu.models.unet import build_unet as build_unet_jax
from unet_image_segmentation_tpu.ops import losses as jlosses
from unet_image_segmentation_tpu.parallel.halo import (
    spatial_sharded_forward as jax_spatial_forward,
)
from unet_image_segmentation_tpu.parallel.mesh import batch_sharding
from unet_image_segmentation_tpu.parallel.mesh import create_mesh as jax_create_mesh
from unet_image_segmentation_tpu.train.state import create_train_state as create_state_jax
from unet_image_segmentation_tpu.train.steps import _prep_masks
from unet_image_segmentation_tpu.train.steps import make_train_step as make_train_step_jax
from unet_image_segmentation_tpu_torch.config import Config as TorchConfig
from unet_image_segmentation_tpu_torch.models.layers import ConvBlock
from unet_image_segmentation_tpu_torch.models.unet import UNet, build_unet
from unet_image_segmentation_tpu_torch.parallel.mesh import Mesh
from unet_image_segmentation_tpu_torch.train import loop
from unet_image_segmentation_tpu_torch.weights import flax_from_state_dict, state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 240
BATCH, FILTERS = 4, (8, 16)
MESHES = {2: (1, 2), 4: (2, 2)}   # ranks -> (data, spatial)
# name -> (image side, config overrides); the last two run make_train_step
# on the use_pallas models themselves (DIRECT), the others on fit's choice
CASES = {
    "full bce": (32, dict(model__conv_type="full", train__loss="bce")),
    "separable dice": (32, dict(train__loss="dice")),
    "separable bce use_pallas": (32, dict(train__loss="bce", model__use_pallas=True)),
    "separable dice 36 px": (36, dict(train__loss="dice")),
}
DIRECT = {
    "chains bce": (32, dict(train__loss="bce", model__use_pallas=True)),
    "chains dice 36 px": (36, dict(train__loss="dice", model__use_pallas=True)),
    "K8 blocks no BN": (32, dict(train__loss="dice", model__use_pallas=True,
                                 model__use_batch_norm=False)),
}
STEP_TOL = dict(rtol=2e-5)                  # loss, dice (JAX's GSPMD step's bars)
RAW_TOL = dict(rtol=1e-4, atol=1e-4)        # raw gradients, BatchNorm statistics
FWD_ATOL = 1e-5                             # eval probabilities (tests/test_parallel.py)
CHAIN_GRAD_REL = 3e-4                       # the chains' gradients, of max|g|


def _cfg(hw, over):
    cfg = Config().override(model__image_height=hw, model__image_width=hw,
                            model__filters=FILTERS, model__dropout_rate=0.0,
                            model__use_pallas=False, model__compute_dtype="float32",
                            train__batch_size=BATCH)
    return cfg.override(**over)


# --------------------------------------------------------------------------
# fit's path selection on a row-sharded mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("over,drops", [
    ({"train__loss": "bce"}, True),
    ({"model__image_height": 36, "model__image_width": 36}, True),
    ({"model__conv_type": "full"}, True),
    ({"model__use_pallas": False}, False),
    ({}, False),
])
def test_model_config_drops_to_the_composed_row_path(over, drops):
    """On 2 row shards, a configuration the fused chains cannot train
    (bce, 36 px at depth 2, full convs) prints the JAX package's warning and
    trains on the composed modules (``use_pallas`` dropped); one they can,
    or one without ``use_pallas``, is left as it is, silently."""
    cfg = TorchConfig().override(model__image_height=32, model__image_width=32,
                                 model__filters=FILTERS, model__use_pallas=True,
                                 train__batch_size=BATCH)
    cfg = cfg.override(**over) if over else cfg
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        mcfg = loop._model_config(cfg, Mesh(1, 2))
    assert mcfg.use_pallas is (cfg.model.use_pallas and not drops)
    if drops:
        assert "trains on the composed row-sharded path" in printed.getvalue()
        assert "GSPMD-XLA path" in printed.getvalue()
    else:
        assert printed.getvalue() == ""


def test_model_config_raises_where_rows_do_not_split():
    """The image height must split over the spatial degree (as in JAX)."""
    cfg = TorchConfig().override(model__image_height=33, model__image_width=32,
                                 model__filters=FILTERS, train__batch_size=BATCH)
    with pytest.raises(ValueError, match="not divisible by spatial degree"):
        loop._model_config(cfg, Mesh(1, 2))


# --------------------------------------------------------------------------
# spawned ranks
# --------------------------------------------------------------------------

_CHILD = r'''
import contextlib
import io
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from unet_image_segmentation_tpu_torch.config import Config
from unet_image_segmentation_tpu_torch.models.unet import build_unet
from unet_image_segmentation_tpu_torch.ops import conv as conv_ops
from unet_image_segmentation_tpu_torch.parallel import distributed, halo, mesh as tmesh
from unet_image_segmentation_tpu_torch.parallel.reduce import all_sum
from unet_image_segmentation_tpu_torch.train.loop import _model_config
from unet_image_segmentation_tpu_torch.train.state import create_train_state
from unet_image_segmentation_tpu_torch.train.steps import make_train_step

rank, world, tmp = int(sys.argv[1]), {world}, {tmp!r}
torch.set_num_threads(1)
distributed.initialize("file://" + tmp + "/store{world}", num_processes=world, process_id=rank,
                       device="cpu")
inp = dict(np.load(tmp + "/inputs.npz"))
out = {{}}

# the differentiable halo over every rank as row shards of one image
rows = tmesh.create_mesh(data=1, spatial=world)
x_loc = rows.shard(torch.from_numpy(inp["halo x"])).requires_grad_()
padded = halo.halo_exchange_grad(x_loc, rows.spatial_group, 1)
y = conv_ops.conv2d(padded, torch.from_numpy(inp["halo k"]), padding="ROWS_PADDED")
(y * torch.from_numpy(inp["halo g"])[:, rows.row_slice(inp["halo g"].shape[1])]).sum().backward()
out["halo padded"] = rows.gather(padded[:, 1:-1].detach())
out["halo edges"] = torch.stack([padded[:, 0], padded[:, -1]], 1).detach()
out["halo y"] = rows.gather(y.detach())
out["halo dx"] = rows.gather(x_loc.grad)

mesh = tmesh.create_mesh(*{mesh!r})
cases = {cases!r}
for name, (kind, cfg_json) in cases.items():
    cfg = Config.from_json(cfg_json)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        mcfg = _model_config(cfg, mesh) if kind == "fit" else cfg.model
    out[name + " printed"] = np.array(printed.getvalue())
    out[name + " use_pallas"] = np.array(mcfg.use_pallas)
    model = build_unet(mcfg, device="cpu")
    model.load_state_dict({{k[len(name) + 4:]: torch.from_numpy(v) for k, v in inp.items()
                           if k.startswith(name + " sd ")}})
    model.set_groups(mesh.group, mesh.spatial_group)
    x, m = torch.from_numpy(inp[name + " x"]), torch.from_numpy(inp[name + " m"])
    with torch.no_grad():   # the eval forward on the initial weights
        probs = halo.spatial_sharded_forward(model, mesh)(mesh.shard(x))
    out[name + " probs"] = mesh.gather(probs).numpy()
    state = create_train_state(cfg, model=model, device="cpu")
    met = make_train_step(model, cfg.train.loss, mesh)(state, mesh.shard(x), mesh.shard(m))
    out.update({{f"{{name}} {{k}}": v.numpy() for k, v in met.items()}})
    out.update({{f"{{name}} stat {{k}}": v.numpy() for k, v in model.state_dict().items()
                if k.endswith((".mean", ".var"))}})
    out.update({{f"{{name}} grad {{n}}": p.grad.numpy() for n, p in model.named_parameters()}})
if rank == 0:
    np.savez(tmp + "/out{world}.npz", **out)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print("RANK_OK", rank, flush=True)
'''


def _spawn(world, tmp, cases):
    code = _CHILD.format(root=ROOT, world=world, tmp=str(tmp), mesh=MESHES[world], cases=cases)
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


def _case_inputs(name, hw, over, seed):
    """The case's port config (JSON), seeded weights and batch."""
    tcfg = TorchConfig.from_dict(_cfg(hw, over).to_dict())
    model = build_unet(dataclasses.replace(tcfg.model, use_pallas=False), device="cpu")
    sd = numpy_weights(model, seed)
    rng = np.random.RandomState(seed + 1)
    inp = {f"{name} sd {k}": v.numpy() for k, v in sd.items()}
    inp[f"{name} x"] = rng.rand(BATCH, hw, hw, 3).astype(np.float32)
    inp[f"{name} m"] = (rng.rand(BATCH, hw, hw, 1) > 0.5).astype(np.float32)
    return tcfg.to_json(), sd, inp


def _jax_case(hw, over, sd, x, m):
    """The JAX package's GSPMD step on the global batch placed over a
    (2, 2) mesh, batch on 'data', rows on 'spatial': ``make_train_step(...,
    mesh=None)``'s metrics and BatchNorm statistics after the step, the raw
    gradients of a jit of ``value_and_grad`` on the same placed inputs, and
    ``spatial_sharded_forward``'s probabilities on the initial weights.

    In float64 (``jax.enable_x64``; the head's sigmoid stays fp32): JAX's
    fp32 CPU forward of the full-conv model lies about ten times further from
    the float64 values than the port's fp32 forward does (3.5e-5 against
    4e-6 at a BatchNorm output of magnitude 5.7), far enough to pick another
    winner in a 2x2 pool window whose two largest values are 1.7e-6 apart,
    which moves the upstream gradients by 1e-4 (the bar). The port, in
    fp32, is held to this reference under the same bars."""
    with jax.enable_x64(True):
        cfg = _cfg(hw, {**over, "model__compute_dtype": "float64"})
        model = build_unet_jax(dataclasses.replace(cfg.model, use_pallas=False))
        mesh = jax_create_mesh(data=2, spatial=2, devices=jax.devices()[:4])
        placed = batch_sharding(mesh, spatial=True)
        xs = jax.device_put(jnp.asarray(x, jnp.float64), placed)
        ms = jax.device_put(jnp.asarray(m, jnp.float64), placed)
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                           flax_from_state_dict(sd))
        state = create_state_jax(cfg, model=model)
        stats = variables.get("batch_stats", {})
        state = state.replace(params=variables["params"], batch_stats=stats,
                              opt_state=state.tx.init(variables["params"]))
        new, met = make_train_step_jax(model, cfg.train.loss, donate=False, mesh=None)(
            state, xs, ms)

        def loss(p):
            preds, _ = model.apply({"params": p, "batch_stats": stats}, xs,
                                   train=True, mutable=["batch_stats"])
            return jlosses.get_loss(cfg.train.loss)(_prep_masks(ms, 1), preds)

        grads = jax.jit(jax.grad(loss))(variables["params"])
        probs = jax_spatial_forward(model, variables, mesh)(xs)

        def by_name(tree):
            return {k: v.numpy() for k, v in state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, tree)).items()}

        return ({k: np.asarray(v) for k, v in met.items()},
                by_name({"params": new.params, "batch_stats": new.batch_stats}),
                by_name({"params": grads}), np.asarray(probs))


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """Both spawned jobs started, the JAX references computed meanwhile,
    then the jobs joined: ``(port outputs by world, halo inputs, JAX numbers
    by case)``."""
    tmp = tmp_path_factory.mktemp("rows")
    rng = np.random.RandomState(23)
    inp = {"halo x": rng.randn(2, 12, 10, 3).astype(np.float32),
           "halo k": (rng.randn(3, 3, 3, 5) * 0.3).astype(np.float32),
           "halo g": rng.randn(2, 12, 10, 5).astype(np.float32)}
    cases, ref, first = {}, {}, {}
    keys = {}   # the JAX reference's config -> (its seed, its first case)
    for name, (hw, over) in {**CASES, **DIRECT}.items():
        # JAX runs use_pallas off: cases that differ only there share inputs
        # and one reference
        key = (hw, tuple(sorted((k, v) for k, v in over.items() if k != "model__use_pallas")))
        seed, first[name] = keys.setdefault(key, (100 + len(keys), name))
        cfg_json, sd, case_inp = _case_inputs(name, hw, over, seed)
        cases[name] = ("fit" if name in CASES else "direct", cfg_json)
        inp.update(case_inp)
        if first[name] == name:
            ref[name] = (hw, over, sd)
    np.savez(tmp / "inputs.npz", **inp)
    procs = {world: _spawn(world, tmp, cases) for world in MESHES}
    jax_ref = {name: _jax_case(hw, over, sd, inp[f"{name} x"], inp[f"{name} m"])
               for name, (hw, over, sd) in ref.items()}
    port = {world: _join(p, tmp, world) for world, p in procs.items()}
    return port, inp, {name: jax_ref[f] for name, f in first.items()}


def _close(got, want, msg, **tol):
    np.testing.assert_allclose(got, want, err_msg=msg, **tol)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_halo_exchange_grad_matches_the_unsharded_conv(rows, world):
    """Each shard's padded rows are the whole image's rows, zeros at its
    edges; the 'ROWS_PADDED' conv over the shards is the 'SAME' conv, and
    its input cotangent, the halo rows' sent back to their owners, is
    autograd's through the unsharded conv."""
    port, inp, _ = rows
    out = port[world]
    x = torch.from_numpy(inp["halo x"]).requires_grad_()
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                   torch.from_numpy(inp["halo k"]).permute(3, 2, 0, 1),
                                   padding=1).permute(0, 2, 3, 1)
    (y * torch.from_numpy(inp["halo g"])).sum().backward()
    np.testing.assert_array_equal(out["halo padded"], inp["halo x"])
    np.testing.assert_array_equal(out["halo edges"][:, 0], 0.0)   # rank 0's top halo
    _close(out["halo y"], y.detach().numpy(), "conv", atol=1e-5, rtol=1e-5)
    _close(out["halo dx"], x.grad.numpy(), "dx", atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", sorted(MESHES))
def test_row_sharded_step_matches_the_jax_gspmd_step(rows, world, name):
    """One composed row-sharded step against JAX's GSPMD step: loss and
    dice rtol 2e-5, confusion matrices within 0.5, the raw gradients (summed
    over the mesh as the optimizer took them) and the BatchNorm statistics
    after the step atol/rtol 1e-4; ``use_pallas`` dropped by fit's path
    selection, with its warning, where it was set."""
    port, _, jax_out = rows
    out, (jmet, jsd, jgrads, _) = port[world], jax_out[name]
    hw, over = CASES[name]
    assert not bool(out[f"{name} use_pallas"])
    assert ("GSPMD-XLA path" in str(out[f"{name} printed"])) is bool(
        over.get("model__use_pallas"))
    for key in ("loss", "dice"):
        _close(out[f"{name} {key}"], jmet[key], key, **STEP_TOL)
    for key in ("cm_raw", "cm_thresh"):
        _close(out[f"{name} {key}"], jmet[key], key, rtol=0, atol=0.5)
    for n, g in jgrads.items():
        _close(out[f"{name} grad {n}"], g, n, **RAW_TOL)
    for k, v in jsd.items():
        if k.endswith((".mean", ".var")):
            _close(out[f"{name} stat {k}"], v, k, **RAW_TOL)


@pytest.mark.parametrize("name", list(CASES) + list(DIRECT))
@pytest.mark.parametrize("world", sorted(MESHES))
def test_row_sharded_eval_forward_matches_jax(rows, world, name):
    """``spatial_sharded_forward``'s probabilities, gathered, against JAX's
    GSPMD-partitioned forward at atol 1e-5 (the 36 px and ``use_pallas``
    models run their gathered images whole, the latter through K8)."""
    port, _, jax_out = rows
    np.testing.assert_allclose(port[world][f"{name} probs"], jax_out[name][3], atol=FWD_ATOL)


@pytest.mark.parametrize("name", list(DIRECT))
@pytest.mark.parametrize("world", sorted(MESHES))
def test_make_train_step_takes_use_pallas_models_on_rows(rows, world, name):
    """``make_train_step`` on the ``use_pallas`` models themselves: bce
    through the chains' halo links and the gathered probabilities, the
    36 px model through the chains on its gathered images, the model
    without BatchNorm through K8 on its gathered images. Loss and dice
    rtol 2e-5, confusion matrices within 0.5 of JAX's GSPMD step; each
    gradient tensor within 3e-4 of its max|g| (the chains' bar)."""
    port, _, jax_out = rows
    out, (jmet, _, jgrads, _) = port[world], jax_out[name]
    assert bool(out[f"{name} use_pallas"])
    for key in ("loss", "dice"):
        _close(out[f"{name} {key}"], jmet[key], key, **STEP_TOL)
    _close(out[f"{name} cm_thresh"], jmet["cm_thresh"], "cm_thresh", rtol=0, atol=0.5)
    for n, g in jgrads.items():
        err = float(np.max(np.abs(out[f"{name} grad {n}"] - g)))
        assert err <= CHAIN_GRAD_REL * float(np.max(np.abs(g))), (n, err)


# --------------------------------------------------------------------------
# which forwards take row shards
# --------------------------------------------------------------------------


@pytest.mark.parametrize("over,height,train,takes", [
    ({}, 16, False, True),
    ({}, 18, False, False),                                   # 18 rows: not through 2 pools
    ({"use_pallas": True}, 16, False, False),                 # eval: K8
    ({"use_pallas": True}, 16, True, True),                   # training: the halo chains
    ({"use_pallas": True, "use_batch_norm": False}, 16, True, False),   # K8 blocks
    ({"use_pallas": True, "conv_type": "full"}, 16, False, True),       # no kernel
])
def test_runs_on_row_shards(over, height, train, takes):
    """A forward takes row shards where every pool keeps them whole and no
    block runs K8 or K9; otherwise its callers gather the row's images."""
    model = UNet(filters=FILTERS, **over)
    assert model.runs_on_row_shards(height, train=train) is takes


@pytest.mark.parametrize("train", [False, True])
def test_a_use_pallas_block_raises_on_row_shards(train):
    """K8/K9 take whole images: a ``use_pallas`` block given a row group
    raises before anything crosses ranks, rather than run another path."""
    blk = ConvBlock(3, 8, use_pallas=True)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 8, 8, 3).astype(np.float32))
    with pytest.raises(ValueError, match="K8/K9 take whole images"):
        blk(x, train=train, spatial_group=object())


def test_forward_takes_whole_images_by_default():
    """The model's own spatial group (``set_groups``, as ``fit`` leaves it)
    does not make a plain ``model(x)`` a row shard: only a caller that
    passes the row group gets one."""
    model = UNet(filters=FILTERS, use_pallas=True)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 16, 16, 3).astype(np.float32))
    with torch.no_grad():
        want = model(x)
        model.set_groups(None, object())   # a group no forward may reach
        got = model(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
