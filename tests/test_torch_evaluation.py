"""The port's dataset evaluator and benchmark CLI against the JAX package's.

A seeded evaluation tree (``images/**/*.tif`` scenes of another size than
the model's, ``ground_truth/**/*.json`` quads, an image without ground
truth) and one set of numpy weights written as a reference-style Keras
``.h5``, which both packages' ``Predictor`` load. The port's ``evaluate``
and ``cli.benchmark.main`` against JAX ``evaluate``, float (module path)
and int8 (``--pallas --quant int8``; the port's plain K7 int8 on the CPU,
JAX's Pallas kernels in interpret mode): the same ids in the same order,
per-sample IoU and MeanIoU within 1e-3, the same low-score CSV.
"""

import csv
import json
import math
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("h5py")

from test_torch_inference import _write_keras_h5  # noqa: E402

from unet_image_segmentation_tpu.data.synthetic import render_sample  # noqa: E402
from unet_image_segmentation_tpu.evaluation import evaluate as jax_evaluate  # noqa: E402
from unet_image_segmentation_tpu.inference import Predictor as JaxPredictor  # noqa: E402
from unet_image_segmentation_tpu_torch.cli.benchmark import main as bench_main  # noqa: E402
from unet_image_segmentation_tpu_torch.config import ModelConfig  # noqa: E402
from unet_image_segmentation_tpu_torch.evaluation import (  # noqa: E402
    evaluate,
    evaluate_batches,
    find_pairs,
    rasterize_quad_mask,
)
from unet_image_segmentation_tpu_torch.inference import Predictor  # noqa: E402
from unet_image_segmentation_tpu_torch.models.unet import (  # noqa: E402
    build_unet,
    recalibrate_batch_norm,
)
from unet_image_segmentation_tpu_torch.weights import flax_from_state_dict  # noqa: E402

HW = 32
FILTERS = (16, 32)
BATCH = 2
TOL = 1e-3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(eval dir, model .h5): five scenes in two folders (a ragged last batch
    at batch 2), one image without ground truth."""
    root = tmp_path_factory.mktemp("evaltree")
    rng = np.random.RandomState(5)
    for i, sub in enumerate(["a", "a", "a", "b", "b", "c"]):
        img, _, quad = render_sample(rng, 48, 40)
        os.makedirs(root / "images" / sub, exist_ok=True)
        cv2.imwrite(str(root / "images" / sub / f"s{i}.tif"), img[..., ::-1])
        if sub != "c":
            os.makedirs(root / "ground_truth" / sub, exist_ok=True)
            with open(root / "ground_truth" / sub / f"s{i}.json", "w") as f:
                json.dump({"quad": np.asarray(quad).round().astype(int).tolist()}, f)
    cfg = ModelConfig(image_height=HW, image_width=HW, filters=FILTERS)
    net = build_unet(cfg, device="cpu")
    wrng = np.random.RandomState(6)
    sd = {}
    for key, value in net.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("kernel"):
            lim = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * math.prod(shape[:-2])))
            sd[key] = torch.from_numpy(wrng.uniform(-lim, lim, shape).astype(np.float32))
        else:
            sd[key] = value
    net.load_state_dict(sd)
    img, _, _ = render_sample(np.random.RandomState(0), HW, HW)
    recalibrate_batch_norm(net, torch.from_numpy(img[None, ..., ::-1] / np.float32(255.0)))
    h5 = str(root / "model.h5")
    _write_keras_h5(h5, flax_from_state_dict(net.state_dict()))
    return str(root), h5


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_evaluate_and_cli_match_jax(tree, tmp_path, capsys, quant):
    root, h5 = tree
    kw = dict(use_pallas=quant, quantize="int8" if quant else None)
    jres = jax_evaluate(JaxPredictor(h5, image_size=(HW, HW), **kw), root, iou_threshold=1.0,
                        batch_size=BATCH, low_score_log=str(tmp_path / "jax.csv"),
                        verbose=False)
    tres = evaluate(Predictor(h5, image_size=(HW, HW), device="cpu", **kw), root,
                    iou_threshold=1.0, batch_size=BATCH, low_score_log=str(tmp_path / "t.csv"),
                    verbose=False)
    assert [i for i, _ in tres.per_sample] == [i for i, _ in jres.per_sample] == [
        os.path.join(s, f"s{i}") for i, s in enumerate(["a", "a", "a", "b", "b"])]
    for (_, mine), (_, theirs) in zip(tres.per_sample, jres.per_sample):
        assert abs(mine - theirs) <= TOL
    assert abs(tres.mean_iou - jres.mean_iou) <= TOL
    assert tres.n_evaluated == 5 and 0.0 < tres.mean_iou < 1.0
    mine, theirs = _read_csv(tmp_path / "t.csv"), _read_csv(tmp_path / "jax.csv")
    assert mine[0] == theirs[0] == ["FileID", "MeanIoU_Score"]
    assert sorted(r[0] for r in mine[1:]) == sorted(r[0] for r in theirs[1:])
    assert len(mine) == 6   # every score is below 1.0

    flags = ["--pallas", "--quant", "int8"] if quant else []
    rc = bench_main([root, "--model", h5, "--image-size", str(HW), "--batch-size", str(BATCH),
                     "--iou_threshold", "1.0", "--low_score_log", str(tmp_path / "cli.csv"),
                     "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"Overall Mean IoU: {tres.mean_iou:.4f}" in out and "Evaluated 5 images" in out
    assert _read_csv(tmp_path / "cli.csv") == mine


def test_batched_core_pads_the_last_batch_with_its_last_image():
    """evaluate_batches on arrays: a short batch runs at the batch size,
    padded by repeating its last image, and only its own rows count."""
    seen = []

    class Recorder:
        image_size = (HW, HW)

        def predict(self, images):
            seen.append(images.copy())
            return images[..., :1]

    images = np.random.RandomState(7).rand(3, HW, HW, 3).astype(np.float32)
    masks = (images[..., 0] > 0.5).astype(np.uint8)
    res = evaluate_batches(Recorder(), [(["x", "y"], images[:2], masks[:2]),
                                        (["z"], images[2:], masks[2:])], batch_size=2)
    assert [s.shape[0] for s in seen] == [2, 2]
    np.testing.assert_array_equal(seen[1][1], images[2])
    assert [i for i, _ in res.per_sample] == ["x", "y", "z"]
    assert all(s == pytest.approx(1.0) for _, s in res.per_sample)   # preds are the masks
    assert res.mean_iou == pytest.approx(1.0) and res.low_iou == []


def test_rasterize_at_the_companion_size_and_the_fallback(tree, tmp_path):
    root, _ = tree
    pairs = find_pairs(root)
    assert len(pairs) == 5 and all(p["json"].endswith(".json") for p in pairs)
    mask = rasterize_quad_mask(pairs[0]["json"], (HW, HW))
    assert mask.shape == (HW, HW) and set(np.unique(mask)) <= {0, 1} and mask.any()
    alone = tmp_path / "ground_truth" / "q.json"
    os.makedirs(alone.parent)
    alone.write_text(json.dumps({"quad": [[0, 0], [1023, 0], [1023, 2047], [0, 2047]]}))
    half = rasterize_quad_mask(str(alone), (16, 16))   # no image: a 2048 x 2048 canvas
    assert half[:, :8].all() and not half[:, 8:].any()


@pytest.mark.parametrize(
    "extra,message",
    [
        (["--model", "/nonexistent/model"], "model checkpoint not found"),
        (["--pred_threshold", "1.5"], "pred_threshold must be in [0, 1]"),
        (["--iou_threshold", "-0.1"], "iou_threshold must be in [0, 1]"),
        (["--quant", "int8", "--device", "cpu"], "needs --pallas"),
        (["--pallas", "--device", "cpu"], "needs --device cuda"),
        ([], "no CUDA device"),
    ],
)
def test_cli_error_probes(tree, capsys, monkeypatch, extra, message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, h5 = tree
    assert bench_main([root, "--model", h5, *extra]) == 1
    assert message in capsys.readouterr().out


def test_cli_refuses_missing_dirs(tree, tmp_path, capsys):
    _, h5 = tree
    assert bench_main([str(tmp_path / "none"), "--model", h5]) == 1
    assert "input directory not found" in capsys.readouterr().out
    os.makedirs(tmp_path / "images")
    assert bench_main([str(tmp_path), "--model", h5]) == 1
    assert "ground_truth' not found" in capsys.readouterr().out
    os.makedirs(tmp_path / "ground_truth")
    assert bench_main([str(tmp_path), "--model", h5, "--device", "cpu"]) == 1
    assert "no image/JSON pairs" in capsys.readouterr().out
