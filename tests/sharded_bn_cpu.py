"""How far a row-sharded training step's BatchNorm running statistics part
from the unsharded step's, in the JAX package and in the port, on the CPU:
a diagnostic, not a test (pytest does not collect it).

Both packages start from the same weights (the JAX package's
``create_train_state``; the port gets them through ``weights.py``) and take
two fused training steps (``use_pallas``, BatchNorm, dropout 0, fp32, dice,
batch 4) on two seeded batches:

* the JAX package: its own (1, 2) mesh step (``make_train_step(mesh=)`` on a
  model built with ``bn_axis_name`` and ``spatial_axis_name``; its Pallas
  chains in interpret mode) against its unsharded fused step on one device
  and against its unsharded XLA step (``use_pallas=False``);
* the port: its (1, 2) mesh step over two gloo ranks (processes spawned
  here under a ``file://`` rendezvous) against its unsharded fused step in
  one process (the kernels' plain versions on the CPU).

For each pair it prints and writes, after step 1 and after step 2, the
worst BatchNorm statistic's ``max|sharded - unsharded| / max|unsharded|``
(the measure ``chip_smoke.py``'s ``hold_shard`` takes), the worst parameter
gap after step 1 in units of the learning rate, and the number of
parameter elements whose step-1 updates part by more than half the
learning rate (Adam's first step moves a weight by about +-lr whatever its
gradient's size, so a near-zero gradient's sign decides it).

Usage (from the repository root)::

    python tests/sharded_bn_cpu.py --workdir build/sharded_bn [--image-size 32 --filters 64,128]
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2

_RANK = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from unet_image_segmentation_tpu_torch.config import Config
from unet_image_segmentation_tpu_torch.models.unet import build_unet
from unet_image_segmentation_tpu_torch.parallel import distributed, mesh as tmesh
from unet_image_segmentation_tpu_torch.train.state import create_train_state
from unet_image_segmentation_tpu_torch.train.steps import make_train_step

rank, wd = int(sys.argv[1]), {wd!r}
torch.set_num_threads(2)
distributed.initialize("file://" + wd + "/store", num_processes=2, process_id=rank, device="cpu")
inp = dict(np.load(wd + "/inputs.npz"))
cfg = Config.from_json(open(wd + "/config.json").read())
smesh = tmesh.create_mesh(data=1, spatial=2)
model = build_unet(cfg.model, device="cpu")
model.set_groups(smesh.group, smesh.spatial_group)
model.load_state_dict({{k[6:]: torch.from_numpy(v) for k, v in inp.items()
                       if k.startswith("model ")}})
state = create_train_state(cfg, model=model, device="cpu")
step = make_train_step(model, "dice", smesh)
out = {{}}
for i in range({steps}):
    step(state, smesh.shard(torch.from_numpy(inp[f"x{{i}}"])),
         smesh.shard(torch.from_numpy(inp[f"m{{i}}"])))
    out.update({{f"step{{i + 1}} {{k}}": v.numpy().copy() for k, v in model.state_dict().items()}})
if rank == 0:
    np.savez(wd + "/port_sharded.npz", **out)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print("RANK_OK", rank, flush=True)
'''


def compare(got, want, lr, stat_keys, param_keys):
    """The worst statistic's relative gap after each step, and step 1's
    parameter gaps in units of ``lr``."""
    import numpy as np

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))

    out = {}
    for i in range(1, STEPS + 1):
        gaps = {k: rel(got[f"step{i} {k}"], want[f"step{i} {k}"]) for k in stat_keys}
        worst = max(gaps, key=gaps.get)
        out[f"stats_rel_step{i}"] = {"max": gaps[worst], "at": worst,
                                     "median": float(np.median(list(gaps.values())))}
    d = {k: np.abs(got[f"step1 {k}"] - want[f"step1 {k}"]) for k in param_keys}
    worst = max(d, key=lambda k: d[k].max())
    out["params_step1_max_in_lr"] = {"max": float(d[worst].max() / lr), "at": worst}
    out["params_step1_parted_by_half_lr"] = int(sum((v > 0.5 * lr).sum() for v in d.values()))
    out["params_step1_elements"] = int(sum(v.size for v in d.values()))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--filters", default="64,128")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, ROOT)
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from unet_image_segmentation_tpu.config import Config as JaxConfig
    from unet_image_segmentation_tpu.models.unet import build_unet as jax_build_unet
    from unet_image_segmentation_tpu.parallel.mesh import create_mesh
    from unet_image_segmentation_tpu.train.state import create_train_state as jax_state
    from unet_image_segmentation_tpu.train.steps import make_train_step as jax_step
    from unet_image_segmentation_tpu_torch.config import Config
    from unet_image_segmentation_tpu_torch.models.unet import build_unet
    from unet_image_segmentation_tpu_torch.train.state import create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step
    from unet_image_segmentation_tpu_torch.weights import state_dict_from_flax

    wd = os.path.abspath(args.workdir)   # the ranks' file:// rendezvous needs it
    os.makedirs(wd, exist_ok=True)
    hw, b = args.image_size, args.batch
    cfg = Config().override(model__image_height=hw, model__image_width=hw,
                            model__filters=[int(f) for f in args.filters.split(",")],
                            model__use_pallas=True, model__use_batch_norm=True,
                            model__dropout_rate=0.0, model__compute_dtype="float32",
                            train__batch_size=b, train__loss="dice")
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    rng = np.random.RandomState(args.seed)
    batches = [(rng.rand(b, hw, hw, 3).astype(np.float32),
                (rng.rand(b, hw, hw, 1) > 0.5).astype(np.float32)) for _ in range(STEPS)]

    def flat(params, stats):
        return {k: v.numpy() for k, v in state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, {"params": params, "batch_stats": stats})).items()}

    # ---- the JAX package: (1, 2) mesh, unsharded fused, unsharded XLA -----
    mesh = create_mesh(data=1, spatial=2, devices=jax.devices()[:2])
    models = {
        "jax_sharded": jax_build_unet(jcfg.model, bn_axis_name=("data", "spatial"),
                                      spatial_axis_name="spatial"),
        "jax_fused": jax_build_unet(jcfg.model),
        "jax_xla": jax_build_unet(dataclasses.replace(jcfg.model, use_pallas=False)),
    }
    runs, seconds = {}, {}
    init = None
    for name, model in models.items():
        t0 = time.perf_counter()
        state = jax_state(jcfg, model=model)
        if init is None:
            init = flat(state.params, state.batch_stats)
        step = jax_step(model, "dice", donate=False, mesh=mesh if name == "jax_sharded" else None)
        out = {}
        for i, (x, m) in enumerate(batches):
            state, _ = step(state, jnp.asarray(x), jnp.asarray(m))
            out.update({f"step{i + 1} {k}": v for k, v in
                        flat(state.params, state.batch_stats).items()})
        runs[name], seconds[name] = out, time.perf_counter() - t0
        print(f"{name}: {STEPS} steps in {seconds[name]:.1f} s", flush=True)

    # ---- the port: (1, 2) over two gloo ranks, and unsharded --------------
    with open(os.path.join(wd, "config.json"), "w") as f:
        f.write(cfg.to_json())
    np.savez(os.path.join(wd, "inputs.npz"), **{f"model {k}": v for k, v in init.items()},
             **{f"x{i}": x for i, (x, _) in enumerate(batches)},
             **{f"m{i}": m for i, (_, m) in enumerate(batches)})
    store = os.path.join(wd, "store")
    if os.path.exists(store):
        os.remove(store)
    t0 = time.perf_counter()
    code = _RANK.format(root=ROOT, wd=wd, steps=STEPS)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    model = build_unet(cfg.model, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    state = create_train_state(cfg, model=model, device="cpu")
    step = make_train_step(model, "dice")
    out = {}
    for i, (x, m) in enumerate(batches):
        step(state, torch.from_numpy(x), torch.from_numpy(m))
        out.update({f"step{i + 1} {k}": v.numpy().copy() for k, v in model.state_dict().items()})
    runs["port_fused"] = out
    for r, proc in enumerate(procs):
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0 or f"RANK_OK {r}" not in log:
            raise RuntimeError(f"rank {r} failed:\n{log[-3000:]}")
    runs["port_sharded"] = dict(np.load(os.path.join(wd, "port_sharded.npz")))
    seconds["port"] = time.perf_counter() - t0

    stat_keys = [k for k in init if k.endswith((".mean", ".var"))]
    param_keys = [k for k in init if k not in stat_keys]
    lr = cfg.train.learning_rate
    pairs = {
        "jax (1, 2) mesh vs jax unsharded fused": ("jax_sharded", "jax_fused"),
        "jax (1, 2) mesh vs jax unsharded xla": ("jax_sharded", "jax_xla"),
        "jax unsharded fused vs jax unsharded xla": ("jax_fused", "jax_xla"),
        "port (1, 2) mesh vs port unsharded fused": ("port_sharded", "port_fused"),
        "port unsharded fused vs jax unsharded xla": ("port_fused", "jax_xla"),
    }
    result = {"config": {"image_size": hw, "filters": cfg.model.filters, "batch": b,
                         "steps": STEPS, "lr": lr, "seed": args.seed},
              "seconds": seconds, "pairs": {}}
    for label, (a, ref) in pairs.items():
        result["pairs"][label] = c = compare(runs[a], runs[ref], lr, stat_keys, param_keys)
        print(f"{label}: stats after step 1 {c['stats_rel_step1']['max']:.2e} "
              f"({c['stats_rel_step1']['at']}), after step 2 {c['stats_rel_step2']['max']:.2e} "
              f"({c['stats_rel_step2']['at']}, median {c['stats_rel_step2']['median']:.1e}); "
              f"params after step 1 up to {c['params_step1_max_in_lr']['max']:.2f} lr, "
              f"{c['params_step1_parted_by_half_lr']} of {c['params_step1_elements']} "
              "elements parted by > lr/2", flush=True)
    with open(os.path.join(wd, "sharded_bn.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
