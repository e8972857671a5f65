"""The port imports torch and never jax or flax."""

import os
import pkgutil
import subprocess
import sys

import unet_image_segmentation_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = unet_image_segmentation_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_modules_import_no_jax():
    modules = _port_modules()
    for name in ("ops.fused_sepconv", "cli.inference", "ops.fused_train", "ops.hash_dropout",
                 "ops.losses", "ops.metrics", "ops.fused_head", "train.state", "train.steps",
                 "train.callbacks", "train.loop", "cli.train"):
        assert f"unet_image_segmentation_tpu_torch.{name}" in modules, name
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_imports_no_jax_cv2_or_h5py():
    """chip_smoke.py runs where only torch is installed."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    for banned in ("import jax", "import flax", "import cv2", "import h5py",
                   "unet_image_segmentation_tpu.", "from unet_image_segmentation_tpu "):
        assert banned not in src, banned
