"""The port's copies of the MIDV data tools (``data/midv.py``, ``data/prepare.py``)
against the JAX package's originals, on the local fixtures of
``tests/test_midv_tools.py`` (no download): extraction, the split, the
dataset build (from extracted folders and from a zip), the 16x augmentation
and both CLIs write byte-equal files and equal quads."""

import json
import os
import zipfile

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from test_midv_tools import _write_archive_dir  # noqa: E402

from unet_image_segmentation_tpu.data import midv as jax_midv  # noqa: E402
from unet_image_segmentation_tpu.data import prepare as jax_prepare  # noqa: E402
from unet_image_segmentation_tpu_torch.data import midv, prepare  # noqa: E402

PACKAGES = {"mine": (midv, prepare), "theirs": (jax_midv, jax_prepare)}


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_trees(a, b, n_files):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    assert len(ta) == n_files
    for rel in ta:
        assert ta[rel] == tb[rel], rel


def test_link_registry_and_constants_equal():
    assert midv.MIDV500_LINKS == jax_midv.MIDV500_LINKS and len(midv.MIDV500_LINKS) == 50
    assert midv.MIDV2019_EXTRA_LINKS == jax_midv.MIDV2019_EXTRA_LINKS
    assert midv.SPLIT_SEED == jax_midv.SPLIT_SEED == 230


@pytest.mark.parametrize("quad,shape", [
    ([[10, 10], [50, 12], [48, 40], [8, 38]], (64, 64)),
    ([[3, 5], [60, 2], [63, 70], [1, 66]], (72, 64)),
    ([], (16, 16)),
], ids=["quad", "edge", "empty"])
def test_quad_to_mask_equals(quad, shape):
    got, want = midv.quad_to_mask(quad, shape), jax_midv.quad_to_mask(quad, shape)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_process_pair_and_read_annotated_image_equal(tmp_path):
    root = _write_archive_dir(str(tmp_path), n=2, hw=64)
    for i in range(2):
        img = os.path.join(root, "images", "CA", f"f{i}.tif")
        js = os.path.join(root, "ground_truth", "CA", f"f{i}.json")
        for a, b in zip(midv.process_pair(img, js), jax_midv.process_pair(img, js)):
            np.testing.assert_array_equal(a, b)
        got, want = prepare.read_annotated_image(img, js), jax_prepare.read_annotated_image(img, js)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] and len(got[2]) == 4


def test_extraction_and_split_write_the_same_files(tmp_path):
    archive = _write_archive_dir(str(tmp_path / "arch"), n=10)
    for name, (m, _) in PACKAGES.items():
        temp = str(tmp_path / name / "temp")
        os.makedirs(os.path.join(temp, "image"))
        os.makedirs(os.path.join(temp, "mask"))
        assert m.extract_dataset_dir(archive, os.path.join(temp, "image"),
                                     os.path.join(temp, "mask"), 1) == 11
        m.train_validation_split(temp, str(tmp_path / name / "train"), seed=230)
    _assert_same_trees(str(tmp_path / "mine"), str(tmp_path / "theirs"), 20 + 20)
    counts = [len(os.listdir(tmp_path / "mine" / "train" / f"{s}_frames" / "image"))
              for s in ("train", "val", "test")]
    assert counts == [7, 2, 1]


@pytest.mark.parametrize("source", ["dirs", "zip"])
def test_build_dataset_writes_the_same_files(tmp_path, source):
    src = str(tmp_path / "downloads")
    _write_archive_dir(os.path.join(src, "01_alb_id"), n=6)
    _write_archive_dir(os.path.join(src, "02_aut_drvlic_new"), sub="TS", n=4)
    if source == "zip":
        # one archive left zipped: build_dataset unzips it beside itself
        z = os.path.join(src, "02_aut_drvlic_new")
        with zipfile.ZipFile(z + ".zip", "w") as zf:
            for d, _, files in os.walk(z):
                for f in files:
                    zf.write(os.path.join(d, f), os.path.relpath(os.path.join(d, f), src))
    for name, (m, _) in PACKAGES.items():
        here = str(tmp_path / f"src_{name}")
        _copy_tree(src, here, skip_unzipped=source == "zip")
        m.build_dataset(dataset_root=str(tmp_path / name), from_dir=here)
    # temp/{image,mask} (10 + 10) and train/ (10 frames + 10 masks)
    _assert_same_trees(str(tmp_path / "mine"), str(tmp_path / "theirs"), 40)


def _copy_tree(src, dst, skip_unzipped):
    import shutil

    def ignore(d, names):
        return ["02_aut_drvlic_new"] if skip_unzipped and os.path.samefile(d, src) else []

    shutil.copytree(src, dst, ignore=ignore)


def test_midv_cli_offline_writes_the_same_files(tmp_path):
    src = str(tmp_path / "downloads")
    _write_archive_dir(os.path.join(src, "01_alb_id"), n=5)
    for name, (m, _) in PACKAGES.items():
        assert m.main(["--dataset-root", str(tmp_path / name), "--from-dir", src]) == 0
    _assert_same_trees(str(tmp_path / "mine"), str(tmp_path / "theirs"), 20)


def test_augment_dataset_16x_writes_the_same_files(tmp_path):
    root = _write_archive_dir(str(tmp_path / "raw"), n=3)
    imgs = os.path.join(root, "images", "CA", "*.tif")
    anns = os.path.join(root, "ground_truth", "CA", "*.json")
    for name, (_, p) in PACKAGES.items():
        n = p.augment_dataset(imgs, anns, str(tmp_path / name / "images"),
                              str(tmp_path / name / "annotations"))
        assert n == 3 * 16
    _assert_same_trees(str(tmp_path / "mine"), str(tmp_path / "theirs"), 2 * 3 * 16)
    for j in range(4):
        with open(tmp_path / "mine" / "annotations" / "f1" / f"f1_1_{j}_0.json") as f:
            assert len(json.load(f)["quad"]) == 4


def test_prepare_cli_writes_the_same_files(tmp_path):
    root = _write_archive_dir(str(tmp_path / "raw"), n=2)
    for name, (_, p) in PACKAGES.items():
        assert p.main([
            "--import_files", os.path.join(root, "images", "CA", "*"),
            "--annotation_dir", os.path.join(root, "ground_truth", "CA", "*"),
            "--image_result_dir", str(tmp_path / name / "images"),
            "--annotation_result_dir", str(tmp_path / name / "annotations"),
        ]) == 0
    _assert_same_trees(str(tmp_path / "mine"), str(tmp_path / "theirs"), 2 * 2 * 16)


@pytest.mark.parametrize("rect", [(10, 20, 50, 44), (3, 3, 60, 30), (20, 5, 30, 58)])
def test_quad_from_mask_equals(rect):
    mask = np.zeros((64, 64), np.uint8)
    x0, y0, x1, y1 = rect
    cv2.rectangle(mask, (x0, y0), (x1, y1), 255, -1)
    for rot in (None, cv2.ROTATE_90_CLOCKWISE):
        mk = mask if rot is None else cv2.rotate(mask, rot)
        got, want = prepare.quad_from_mask(mk), jax_prepare.quad_from_mask(mk)
        assert got == want and len(got["quad"]) == 4
    empty = np.zeros((8, 8), np.uint8)
    assert prepare.quad_from_mask(empty) == jax_prepare.quad_from_mask(empty) == {"quad": []}
