"""Port Predictor / run_inference / CLI against the JAX package's.

One set of numpy-drawn weights (BatchNorm recalibrated on a scene) is
written as a reference-style Keras ``.h5``; the JAX and the port
``Predictor`` both load it. On a ``render_sample`` scene the masks agree on
>= 99.9% of pixels and the bbox crop is the same.
"""

import math
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

from unet_image_segmentation_tpu.data.synthetic import render_sample
from unet_image_segmentation_tpu.inference import Predictor as JaxPredictor
from unet_image_segmentation_tpu.inference import run_inference as jax_run_inference
from unet_image_segmentation_tpu_torch.cli.inference import main as infer_main
from unet_image_segmentation_tpu_torch.config import ModelConfig
from unet_image_segmentation_tpu_torch.inference import Predictor, run_inference
from unet_image_segmentation_tpu_torch.models.unet import build_unet, recalibrate_batch_norm
from unet_image_segmentation_tpu_torch.train.checkpoint import save_inference_variables
from unet_image_segmentation_tpu_torch.weights import flax_from_state_dict

HW = 32
MIN_AGREE = 0.999


def _write_keras_h5(path, variables):
    """Reference layout: model_weights/<layer>/<layer>/<weight>:0."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")

        def put(layer, weights):
            g = root.create_group(layer).create_group(layer)
            for name, arr in weights.items():
                g.create_dataset(f"{name}:0", data=arr)

        for name, p in params.items():
            if name == "output_mask" or name.endswith("_upsample"):
                put(name, p)
                continue
            for sub, w in p.items():
                if sub == "bn":
                    put(f"{name}_bn", {
                        "gamma": w["scale"], "beta": w["bias"],
                        "moving_mean": stats[name]["bn"]["mean"],
                        "moving_variance": stats[name]["bn"]["var"],
                    })
                else:
                    put(f"{name}_{sub}", w)


def _scene(tmp_path, seed=3, h=48, w=40):
    img, _, _ = render_sample(np.random.RandomState(seed), h, w)
    path = str(tmp_path / f"doc{seed}.png")
    cv2.imwrite(path, img[..., ::-1])  # render_sample is RGB; the CLI reads BGR
    return path


@pytest.fixture(scope="module", params=[1, 3], ids=["binary", "3class"])
def model_files(request, tmp_path_factory):
    """(h5 path, port checkpoint dir) holding the same weights."""
    num_classes = request.param
    d = tmp_path_factory.mktemp(f"torch_inf{num_classes}")
    cfg = ModelConfig(image_height=HW, image_width=HW, filters=(8, 16), num_classes=num_classes)
    model = build_unet(cfg, device="cpu")
    rng = np.random.RandomState(num_classes)
    sd = {}
    for key, value in model.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("kernel"):
            lim = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * math.prod(shape[:-2])))
            sd[key] = torch.from_numpy(rng.uniform(-lim, lim, shape).astype(np.float32))
        else:
            sd[key] = value
    model.load_state_dict(sd)
    img, _, _ = render_sample(np.random.RandomState(0), HW, HW)
    recalibrate_batch_norm(model, torch.from_numpy(img[None, ..., ::-1] / np.float32(255.0)))
    h5 = str(d / "model.h5")
    _write_keras_h5(h5, flax_from_state_dict(model.state_dict()))
    ckpt = str(d / "ckpt")
    save_inference_variables(ckpt, model.state_dict(),
                             {"num_classes": num_classes, "filters": [8, 16]})
    return h5, ckpt, num_classes


@pytest.mark.parametrize("use_pallas", [False, True], ids=["module", "serving"])
def test_run_inference_matches_jax(model_files, tmp_path, use_pallas):
    h5, _, num_classes = model_files
    img_path = _scene(tmp_path)
    jres = jax_run_inference(
        JaxPredictor(h5, image_size=(HW, HW)), img_path,
        output_mask=str(tmp_path / "jax_mask.png"),
        output_cropped=str(tmp_path / "jax_crop.png"),
        min_contour_area=20, verbose=False,
    )
    predictor = Predictor(h5, image_size=(HW, HW), use_pallas=use_pallas, device="cpu")
    assert predictor.num_classes == num_classes
    tres = run_inference(
        predictor, img_path,
        output_mask=str(tmp_path / "torch_mask.png"),
        output_cropped=str(tmp_path / "torch_crop.png"),
        min_contour_area=20, verbose=False,
    )
    jmask = cv2.imread(jres["mask_path"], cv2.IMREAD_GRAYSCALE)
    tmask = cv2.imread(tres["mask_path"], cv2.IMREAD_GRAYSCALE)
    assert jmask.shape == tmask.shape == (48, 40)
    assert (jmask == tmask).mean() >= MIN_AGREE
    assert 0.0 < tres["mask_area_frac"] < 1.0
    assert tres["bbox"] == jres["bbox"]
    assert tres["num_classes"] == jres["num_classes"] == num_classes


def test_port_checkpoint_and_h5_give_the_same_predictions(model_files):
    h5, ckpt, num_classes = model_files
    x = np.random.RandomState(4).rand(3, HW, HW, 3).astype(np.float32)
    a = Predictor(h5, image_size=(HW, HW), device="cpu").predict(x)
    b = Predictor(ckpt, image_size=(HW, HW), device="cpu").predict(x)
    assert a.shape == (3, HW, HW, num_classes)
    np.testing.assert_array_equal(a, b)


def test_predictor_bucketed_batch(model_files):
    """3 rows run in the bucket of 4; the rows equal an unpadded batch of 4."""
    _, ckpt, _ = model_files
    predictor = Predictor(ckpt, image_size=(HW, HW), use_pallas=True, device="cpu")
    x = np.random.RandomState(5).rand(3, HW, HW, 3).astype(np.float32)
    out3 = predictor.predict(x)
    out4 = predictor.predict(np.concatenate([x, x[:1]], axis=0))
    assert out3.shape[0] == 3
    np.testing.assert_allclose(out3, out4[:3], rtol=0, atol=1e-6)


def test_predictor_refuses_what_it_cannot_run(model_files, monkeypatch):
    _, ckpt, _ = model_files
    with pytest.raises(ValueError, match="needs use_pallas=True"):
        Predictor(ckpt, quantize="int8", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(ckpt, use_pallas=True, device="cuda")


@pytest.mark.parametrize("crop_mode", ["bbox", "warp"])
def test_cli_runs_on_cpu(model_files, tmp_path, crop_mode):
    h5, _, _ = model_files
    rc = infer_main([
        _scene(tmp_path, seed=6), "--model", h5, "--image-size", str(HW),
        "--output_mask", str(tmp_path / "m.png"),
        "--output_cropped", str(tmp_path / "c.png"),
        "--min_area", "20", "--device", "cpu", "--crop-mode", crop_mode,
    ])
    assert rc == 0
    assert os.path.exists(tmp_path / "m.png")


def test_cli_int8_runs_on_cpu(model_files, tmp_path):
    """--pallas --quant int8 on the CPU: the int8 graph on the kernels'
    plain versions."""
    h5, _, _ = model_files
    rc = infer_main([
        _scene(tmp_path, seed=8), "--model", h5, "--image-size", str(HW),
        "--output_mask", str(tmp_path / "m.png"), "--output_cropped", str(tmp_path / "c.png"),
        "--min_area", "20", "--device", "cpu", "--pallas", "--quant", "int8",
    ])
    assert rc == 0
    assert cv2.imread(str(tmp_path / "m.png"), cv2.IMREAD_GRAYSCALE).shape == (48, 40)


@pytest.mark.parametrize(
    "extra,message",
    [
        (["--model", "/nonexistent/model"], "model checkpoint not found"),
        (["--threshold", "1.5", "--device", "cpu"], "threshold must be in"),
        (["--pallas"], "no CUDA device"),
        (["--pallas", "--device", "cpu"], "needs --device cuda"),
        ([], "no CUDA device"),
        (["--quant", "int8", "--device", "cpu"], "needs --pallas"),
    ],
)
def test_cli_error_probes(model_files, tmp_path, capsys, monkeypatch, extra, message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h5, _, _ = model_files
    args = [_scene(tmp_path, seed=7), "--model", h5, "--image-size", str(HW)]
    rc = infer_main(args + extra)
    assert rc == 1
    assert message in capsys.readouterr().out
