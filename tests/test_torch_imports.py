"""The port imports torch and never jax, flax or the JAX package; its own
copies of the JAX package's framework-free modules behave like the
originals."""

import glob
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

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
                 "ops.losses", "ops.metrics", "ops.fused_head", "ops.fused_upconcat",
                 "train.state", "train.steps", "train.callbacks", "train.loop", "cli.train",
                 "config", "utils.image", "utils.keras_import", "utils.tb_writer",
                 "data.loader", "data.packed", "data.autopack", "ops.probes", "utils.profiling",
                 "troubleshoot.profile_summary", "troubleshoot.roofline",
                 "troubleshoot.step_attribution", "troubleshoot.link_floors",
                 "troubleshoot.check_install", "troubleshoot.check_gpu_benchmark",
                 "troubleshoot.pair_phases", "serving_quant", "evaluation", "cli.benchmark",
                 "ops.preprocess", "streaming", "parallel.mesh", "parallel.halo",
                 "parallel.distributed", "export.pt2", "export.tflite",
                 "export.tflite_metadata", "cli.export", "data.synthetic",
                 "troubleshoot.quality_gate_256", "troubleshoot.quality_gate_512mc",
                 "data.midv", "data.prepare", "troubleshoot.products",
                 "troubleshoot.dpw_digits", "troubleshoot.probe_sass",
                 "troubleshoot.upconcat_digits"):
        assert f"unet_image_segmentation_tpu_torch.{name}" in modules, name
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "banned = ('jax', 'jaxlib', 'flax', 'unet_image_segmentation_tpu', 'cv2', 'h5py',\n"
        "          'tensorflow')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
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
    """chip_smoke.py runs where only torch is installed: no jax, flax, cv2,
    h5py, tensorflow or flatbuffers, neither in its source nor pulled in by
    the export modules it drives."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    for banned in ("import jax", "import flax", "import cv2", "import h5py",
                   "import tensorflow", "import flatbuffers",
                   "unet_image_segmentation_tpu.", "from unet_image_segmentation_tpu "):
        assert banned not in src, banned
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from unet_image_segmentation_tpu_torch.export import pt2\n"
        "from unet_image_segmentation_tpu_torch.cli import export\n"
        "banned = ('tensorflow', 'flatbuffers', 'jax', 'cv2', 'h5py')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "*.json"))),
                         ids=os.path.basename)
def test_config_copy_reads_every_config_alike(path):
    from unet_image_segmentation_tpu.config import Config as JaxConfig
    from unet_image_segmentation_tpu_torch.config import Config

    with open(path) as f:
        text = f.read()
    mine, theirs = Config.from_json(text), JaxConfig.from_json(text)
    assert mine.to_dict() == theirs.to_dict()
    assert Config.from_dict(theirs.to_dict()).to_dict() == theirs.to_dict()
    over = dict(model__fused_head="off", train__batch_size=3, data__prefetch=2)
    assert mine.override(**over).to_dict() == theirs.override(**over).to_dict()


@pytest.mark.parametrize("mask_mode", ["binary", "class_id"])
def test_loader_copy_yields_the_same_batches(tmp_path, mask_mode):
    pytest.importorskip("cv2")
    from unet_image_segmentation_tpu.config import Config as JaxConfig
    from unet_image_segmentation_tpu.data import loader as jax_loader
    from unet_image_segmentation_tpu.data.synthetic import (
        write_synthetic_dataset,
        write_synthetic_multiclass_dataset,
    )
    from unet_image_segmentation_tpu_torch.config import Config
    from unet_image_segmentation_tpu_torch.data import loader

    write = write_synthetic_dataset if mask_mode == "binary" else \
        write_synthetic_multiclass_dataset
    root = write(str(tmp_path / "ds"), n_train=6, n_val=3, image_size=(24, 24))
    over = dict(data__root=root, data__mask_mode=mask_mode, model__image_height=16,
                model__image_width=16, train__seed=7)
    pairs = zip(loader.make_loaders(Config().override(**over)),
                jax_loader.make_loaders(JaxConfig().override(**over)))
    for mine, theirs in pairs:
        assert len(mine) == len(theirs)
        for epoch in (0, 1):
            got = list(mine.batches(2, epoch=epoch, num_workers=1))
            want = list(theirs.batches(2, epoch=epoch, num_workers=1))
            assert len(got) == len(want) > 0
            for (gi, gm), (wi, wm) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gm, wm)


def test_train_cli_copy_parses_like_the_jax_cli():
    from unet_image_segmentation_tpu.cli import train as jax_cli
    from unet_image_segmentation_tpu_torch.cli import train as cli

    flags = ["--epochs", "1", "--batch-size", "2", "--image-size", "32", "--data-root", "ds",
             "--model-out", "m", "--log-dir", "l", "--set", "model__filters=[8,16]", "--pallas",
             "--bf16", "--loss", "iou", "--mesh", "1,1", "--seed", "3"]
    args = cli.parse_args(flags + ["--device", "cpu"])
    assert args.device == "cpu" and cli.parse_args(flags).device == "cuda"
    mine = cli.config_from_args(args).to_dict()
    assert mine == jax_cli.config_from_args(jax_cli.parse_args(flags)).to_dict()
    assert tuple(mine["model"]["filters"]) == (8, 16) and mine["model"]["use_pallas"] is True


def test_synthetic_copy_is_the_original_source():
    """``data/synthetic.py`` is copied verbatim, its lazy cv2 imports with it."""
    mine, theirs = (os.path.join(ROOT, pkg, "data", "synthetic.py")
                    for pkg in ("unet_image_segmentation_tpu_torch", "unet_image_segmentation_tpu"))
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_midv_copy_is_the_original_source():
    """``data/midv.py`` is copied verbatim, its lazy cv2 and urllib imports with it."""
    mine, theirs = (os.path.join(ROOT, pkg, "data", "midv.py")
                    for pkg in ("unet_image_segmentation_tpu_torch", "unet_image_segmentation_tpu"))
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_prepare_copy_is_the_original_source_but_its_import():
    """``data/prepare.py`` is the original but line 24, which imports the
    port's ``midv`` in place of the JAX package's."""
    mine, theirs = (os.path.join(ROOT, pkg, "data", "prepare.py")
                    for pkg in ("unet_image_segmentation_tpu_torch", "unet_image_segmentation_tpu"))
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        a, b = f.read().split(b"\n"), g.read().split(b"\n")
    assert len(a) == len(b)
    assert [i for i, (x, y) in enumerate(zip(a, b)) if x != y] == [23]
    assert b[23] == b"from unet_image_segmentation_tpu.data.midv import quad_to_mask"
    assert a[23] == b"from unet_image_segmentation_tpu_torch.data.midv import quad_to_mask"


@pytest.mark.parametrize("out_size,in_size", [(1024, 1080), (1080, 1024), (1920, 1024),
                                              (64, 96), (5, 5)])
def test_resize_matrix_copy_equals_the_original(out_size, in_size):
    from unet_image_segmentation_tpu.ops.preprocess import _resize_matrix as theirs
    from unet_image_segmentation_tpu_torch.ops.preprocess import _resize_matrix as mine

    np.testing.assert_array_equal(mine(out_size, in_size), theirs(out_size, in_size))


@pytest.mark.parametrize("b,n", [(5, 8), (8, 8), (3, 2), (1, 4)])
def test_pad_batch_copy_equals_the_original(b, n):
    from unet_image_segmentation_tpu.parallel.mesh import pad_batch_to_devices as theirs
    from unet_image_segmentation_tpu_torch.parallel.mesh import pad_batch_to_devices as mine

    x = np.arange(b * 6, dtype=np.float32).reshape(b, 2, 3)
    (got, pad), (want, wpad) = mine(x, n), theirs(x, n)
    assert pad == wpad
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_classes,label_file,extra", [
    (1, "labels.txt", {}),
    (3, None, {}),
    (1, None, {"author": "someone", "license": "Apache-2.0", "version": "v7"}),
], ids=["binary", "3-class", "fields"])
def test_tflite_metadata_copy_writes_the_original_bytes(num_classes, label_file, extra):
    pytest.importorskip("flatbuffers")
    from unet_image_segmentation_tpu.export.tflite_metadata import (
        build_metadata_flatbuffer as theirs,
    )
    from unet_image_segmentation_tpu_torch.export.tflite_metadata import (
        build_metadata_flatbuffer as mine,
    )

    meta = {"name": "unet-image-segmentation-tpu", "version": "v1",
            "input": {"shape": [1, 64, 48, 3], "color_space": "RGB",
                      "normalization": {"mean": [0.0], "std": [255.0]}},
            "output": {"shape": [1, 64, 48, num_classes], "semantics": "probability mask",
                       "binarization_threshold": 0.4},
            "labels": ["a", "b"], **extra}
    assert mine(meta, label_file) == theirs(meta, label_file)
