"""The port's export layer against the JAX package's, on the CPU.

At 32 px with filters (8, 16), as ``tests/test_export.py``:

* K8's registered op ``unet::sepconv_block``: ``torch.library.opcheck``,
  its gradient (autograd through the plain version) and its fake shape;
* ``torch.export`` round trip (``export.pt2``): the loaded program against
  the port's eval forward within 1e-5 (the JAX round trip's bar) and
  against JAX ``export_stablehlo(platforms=["cpu"])`` -> ``load_stablehlo``
  on the same JAX-initialised weights within ``FWD_TOL`` (2e-5,
  ``test_torch_model.py``'s bar); ``metadata.json`` equal to JAX's but
  ``format`` and the version key, ``labels.txt`` the same;
* a ``use_pallas`` model (BatchNorm on and off) exports with one
  ``unet.sepconv_block`` node (K8's registered op) a ConvBlock, and its
  loaded graph matches the plain module within ``FWD_TOL``; a plain
  artifact loads and runs in a process that imports only ``torch``;
* ``export_pt2``/``load_pt2`` on the card raise without one, and the CLI's
  ``pt2`` exports a port checkpoint;
* TFLite (``export.tflite``, a ``tf.function`` of the port's forward in
  ``tf.nn`` ops): fp32 against the port's forward within 1e-4 at 1 and 3
  classes, separable and full convs, BatchNorm on and off; ``float16``
  within 1e-2; ``int8`` of the expected shape, finite, within
  ``INT8_GAP`` of fp32; the embedded metadata read back as JAX's
  ``.tflite``'s, and the metadata flatbuffer byte-equal to JAX's writer's;
  the CLI's ``tflite``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_model import FWD_TOL, numpy_weights
from unet_image_segmentation_tpu.config import ModelConfig
from unet_image_segmentation_tpu.models.unet import build_unet as build_unet_jax
from unet_image_segmentation_tpu.models.unet import init_unet
from unet_image_segmentation_tpu_torch.cli.export import main as export_main
from unet_image_segmentation_tpu_torch.export.pt2 import export_pt2, load_pt2
from unet_image_segmentation_tpu_torch.models.unet import UNet, recalibrate_batch_norm
from unet_image_segmentation_tpu_torch.train.checkpoint import save_inference_variables
from unet_image_segmentation_tpu_torch.weights import state_dict_from_flax

HW, FILTERS, BATCH = 32, (8, 16), 2
ROUND_TRIP_TOL = dict(rtol=0, atol=1e-5)   # tests/test_export.py's round trip
TFLITE_TOL = dict(rtol=0, atol=1e-4)
FLOAT16_TOL = dict(rtol=0, atol=1e-2)
# int8 TFLite against fp32 TFLite: the gap measured on these weights and
# this input (1 class, BatchNorm, TF 2.21) is 0.085 of a probability (fp32
# against the port 8.3e-7, float16 2.4e-3); the bar leaves room for another
# converter's rounding
INT8_GAP = 0.15
K8_NODE = "unet.sepconv_block.default"
BLOCKS = 4 * len(FILTERS) + 2               # two a stage each way, two in the bottleneck
CKPT_KWARGS = dict(num_classes=1, filters=list(FILTERS), dropout_rate=0.0,
                   use_batch_norm=True, conv_type="separable")


@pytest.fixture(scope="module")
def jax_model():
    cfg = ModelConfig(image_height=HW, image_width=HW, filters=FILTERS, dropout_rate=0.0)
    model = build_unet_jax(cfg)
    return model, init_unet(model, jax.random.PRNGKey(0), cfg.input_shape)


@pytest.fixture(scope="module")
def port_model(jax_model):
    """The port's U-Net with the JAX-initialised weights."""
    model = UNet(filters=FILTERS, dropout_rate=0.0)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                      jax_model[1])))
    return model


def _images(n=BATCH, seed=0):
    return np.random.RandomState(seed).rand(n, HW, HW, 3).astype(np.float32)


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _seeded(seed, x=None, **kw):
    """A port U-Net with numpy weights of ``seed``, its BatchNorm
    recalibrated on ``x`` (so the outputs are not a constant 0.5)."""
    model = UNet(filters=FILTERS, dropout_rate=0.0, **kw)
    model.load_state_dict(numpy_weights(model, seed))
    if model.use_batch_norm and x is not None:
        recalibrate_batch_norm(model, torch.from_numpy(x))
    return model


def _k8_nodes(program):
    return sum(str(node.target) == K8_NODE for node in program.graph.nodes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_k8_op_registrations(dtype, relu):
    """``unet::sepconv_block``: ``torch.library.opcheck`` (schema, autograd
    registration, fake tensor, AOT dispatch) on CPU tensors; the op's
    gradient is autograd through its plain version; the fake
    implementation's shape on meta tensors."""
    from unet_image_segmentation_tpu_torch.ops import fused_sepconv as tfs

    gen = torch.Generator().manual_seed(3)
    c, f = 5, 7
    args = [torch.rand(2, 6, 9, c, generator=gen).to(dtype),
            torch.rand(3, 3, c, generator=gen).to(dtype),
            torch.rand(c, f, generator=gen).to(dtype) - 0.5,
            torch.rand(f, generator=gen), torch.rand(f, generator=gen) - 0.5]
    args = [a.requires_grad_() for a in args]
    torch.library.opcheck(tfs.sepconv_block_op, (*args, relu))
    y = tfs.sepconv_block_op(*args, relu)
    g = torch.rand(y.shape, generator=gen).to(dtype)
    want = torch.autograd.grad(
        tfs.sepconv_block_reference(args[0], tfs.BlockWeights(*args[1:]), relu), args, g)
    for got, ref in zip(torch.autograd.grad(y, args, g), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    meta = [a.detach().to("meta") for a in args]
    assert tfs.sepconv_block_op(*meta, relu).shape == (2, 6, 9, f)


@pytest.fixture(scope="module")
def round_trip(jax_model, port_model, tmp_path_factory):
    """Both packages' artifacts of the same weights at batch 2, and both
    loaded programs' outputs on the same input."""
    from unet_image_segmentation_tpu.export.stablehlo import export_stablehlo, load_stablehlo

    root = tmp_path_factory.mktemp("round_trip")
    jdir, tdir = str(root / "jax"), str(root / "port")
    labels = ["background", "page"]
    export_stablehlo(*jax_model, jdir, batch_size=BATCH, image_size=(HW, HW), labels=labels,
                     platforms=["cpu"])
    export_pt2(port_model, tdir, batch_size=BATCH, image_size=(HW, HW), labels=labels,
               device="cpu")
    x = _images()
    jcall, jmeta = load_stablehlo(jdir)
    tcall, tmeta = load_pt2(tdir, device="cpu")
    return dict(x=x, jax=jcall(x), port=tcall(x), jmeta=jmeta, tmeta=tmeta, jdir=jdir,
                tdir=tdir)


def test_pt2_round_trip_matches_the_port_and_jax(round_trip, port_model):
    r = round_trip
    assert os.path.exists(os.path.join(r["tdir"], "model.pt2"))
    assert r["port"].shape == (BATCH, HW, HW, 1)
    np.testing.assert_allclose(r["port"], _forward(port_model, r["x"]), **ROUND_TRIP_TOL)
    np.testing.assert_allclose(r["port"], r["jax"], **FWD_TOL)


def test_pt2_metadata_and_labels_are_jax(round_trip):
    r = round_trip
    jmeta, tmeta = dict(r["jmeta"]), dict(r["tmeta"])
    assert jmeta.pop("format") == "jax.export/stablehlo" and "jax_version" in jmeta
    assert tmeta.pop("format") == "torch.export"
    assert tmeta.pop("torch_version") == torch.__version__
    jmeta.pop("jax_version")
    assert tmeta == jmeta
    with open(os.path.join(r["tdir"], "metadata.json")) as f:
        assert json.load(f) == r["tmeta"]
    with open(os.path.join(r["tdir"], "labels.txt")) as a, \
            open(os.path.join(r["jdir"], "labels.txt")) as b:
        assert a.read() == b.read() == "background\npage\n"


@pytest.mark.parametrize("use_batch_norm", [True, False], ids=["bn", "no_bn"])
def test_pallas_export_holds_k8_op_nodes(tmp_path, use_batch_norm):
    """One ``unet.sepconv_block`` node a ConvBlock in the saved graph; the
    loaded graph within ``FWD_TOL`` of the plain module on the same
    weights."""
    x = _images(seed=3)
    plain = _seeded(5, x, use_batch_norm=use_batch_norm)
    fused = UNet(filters=FILTERS, dropout_rate=0.0, use_batch_norm=use_batch_norm,
                 use_pallas=True)
    fused.load_state_dict(plain.state_dict())
    export_pt2(fused, str(tmp_path), batch_size=BATCH, image_size=(HW, HW), device="cpu")
    program = torch.export.load(str(tmp_path / "model.pt2"))
    assert _k8_nodes(program) == BLOCKS
    call, _ = load_pt2(str(tmp_path), device="cpu")
    got = call(x)
    np.testing.assert_allclose(got, _forward(plain, x), **FWD_TOL)
    assert float(np.std(got)) > 1e-3


def test_plain_artifact_loads_with_torch_alone(tmp_path):
    x = _images(seed=4)
    model = _seeded(6, x)
    export_pt2(model, str(tmp_path), batch_size=BATCH, image_size=(HW, HW), device="cpu")
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "want.npy", _forward(model, x))
    code = (
        "import sys, numpy as np, torch\n"
        f"d = {str(tmp_path)!r}\n"
        "program = torch.export.load(d + '/model.pt2')\n"
        "y = program.module()(torch.from_numpy(np.load(d + '/x.npy'))).detach().numpy()\n"
        "np.testing.assert_allclose(y, np.load(d + '/want.npy'), rtol=0, atol=1e-5)\n"
        "bad = sorted(m for m in sys.modules if m.startswith('unet_image_segmentation'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_pt2_on_the_card_raises_without_one(tmp_path, monkeypatch, port_model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_pt2(port_model, str(tmp_path), image_size=(HW, HW))
    assert not os.path.exists(tmp_path / "model.pt2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_pt2(str(tmp_path))


def test_load_pt2_refuses_another_device(round_trip):
    with pytest.raises(ValueError, match="export it on the device"):
        load_pt2(round_trip["tdir"], device="meta")


def _checkpoint(tmp_path, model):
    ckpt = str(tmp_path / "ckpt")
    save_inference_variables(ckpt, model.state_dict(), model_kwargs=CKPT_KWARGS)
    return ckpt


def test_cli_pt2_exports_a_port_checkpoint(tmp_path, port_model, capsys):
    ckpt = _checkpoint(tmp_path, port_model)
    labels = tmp_path / "labels.txt"
    labels.write_text("bg\ndoc\n")
    out = str(tmp_path / "out")
    rc = export_main(["pt2", ckpt, out, "--image-size", str(HW), "--labels", str(labels),
                      "--device", "cpu"])
    assert rc == 0, capsys.readouterr().out
    call, meta = load_pt2(out, device="cpu")
    x = _images(1, seed=8)
    np.testing.assert_allclose(call(x), _forward(port_model, x), **ROUND_TRIP_TOL)
    assert meta["labels"] == ["bg", "doc"] and meta["input"]["shape"] == [1, HW, HW, 3]


def test_cli_pt2_errors(tmp_path, port_model, monkeypatch, capsys):
    """A missing checkpoint, and ``--device cuda`` (the default) without a card."""
    assert export_main(["pt2", str(tmp_path / "missing"), str(tmp_path / "o")]) == 1
    assert "checkpoint not found" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert export_main(["pt2", _checkpoint(tmp_path, port_model), str(tmp_path / "o")]) == 1
    assert "no CUDA device" in capsys.readouterr().out


def _tflite(path, x):
    import tensorflow as tf

    interp = tf.lite.Interpreter(model_path=path)
    interp.allocate_tensors()
    interp.set_tensor(interp.get_input_details()[0]["index"], x)
    interp.invoke()
    return interp.get_tensor(interp.get_output_details()[0]["index"])


@pytest.mark.parametrize("use_batch_norm", [True, False], ids=["bn", "no_bn"])
@pytest.mark.parametrize("conv_type", ["separable", "full"])
@pytest.mark.parametrize("num_classes", [1, 3])
def test_tflite_fp32_matches_the_port(tmp_path, num_classes, conv_type, use_batch_norm):
    pytest.importorskip("tensorflow")
    from unet_image_segmentation_tpu_torch.export.tflite import convert_to_tflite

    x = _images(seed=9)
    model = _seeded(11, x, num_classes=num_classes, conv_type=conv_type,
                    use_batch_norm=use_batch_norm)
    out = convert_to_tflite(model, str(tmp_path / "m.tflite"), batch_size=BATCH,
                            image_size=(HW, HW))
    got, want = _tflite(out, x), _forward(model, x)
    assert got.shape == (BATCH, HW, HW, num_classes)
    np.testing.assert_allclose(got, want, **TFLITE_TOL)
    assert float(np.std(want)) > 1e-3


@pytest.fixture(scope="module")
def quantized(tmp_path_factory):
    """fp32, float16 and int8 conversions of one BatchNorm model, with the
    port's forward on the same input."""
    pytest.importorskip("tensorflow")
    from unet_image_segmentation_tpu_torch.export.tflite import convert_to_tflite

    root = tmp_path_factory.mktemp("quantized")
    x = _images(1, seed=12)
    model = _seeded(13, _images(8, seed=14))
    outs = {}
    for name, kw in (("fp32", {}), ("float16", dict(float16=True)),
                     ("int8", dict(int8=True, representative_images=list(_images(8, 14))))):
        outs[name] = _tflite(convert_to_tflite(model, str(root / f"{name}.tflite"),
                                               image_size=(HW, HW), **kw), x)
    return outs, _forward(model, x)


def test_tflite_float16_within_its_bar(quantized):
    outs, want = quantized
    np.testing.assert_allclose(outs["float16"], want, **FLOAT16_TOL)


def test_tflite_int8_shape_finite_and_gap(quantized):
    outs, want = quantized
    got = outs["int8"]
    assert got.shape == (1, HW, HW, 1) and np.isfinite(got).all()
    gap = float(np.abs(got - outs["fp32"]).max())
    assert gap <= INT8_GAP, gap
    np.testing.assert_allclose(outs["fp32"], want, **TFLITE_TOL)


def test_tflite_metadata_matches_jax(tmp_path, jax_model, port_model):
    """The port's ``.tflite`` reads back as JAX's for the same labels (the
    metadata buffer and the label zip), and the flatbuffer writer's bytes
    are JAX's for the same dict."""
    pytest.importorskip("tensorflow")
    import zipfile

    from unet_image_segmentation_tpu.export import tflite_metadata as jmd
    from unet_image_segmentation_tpu.export.tflite import convert_to_tflite as jax_convert
    from unet_image_segmentation_tpu_torch.export import tflite_metadata as tmd
    from unet_image_segmentation_tpu_torch.export.tflite import convert_to_tflite

    labels = ["background", "receipt"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jpath = jax_convert(*jax_model, str(tmp_path / "jax" / "m.tflite"), image_size=(HW, HW),
                        labels=labels)
    tpath = convert_to_tflite(port_model, str(tmp_path / "port" / "m.tflite"),
                              image_size=(HW, HW), labels=labels)
    assert tmd.read_metadata(tpath) == jmd.read_metadata(jpath)
    assert tmd.read_metadata(tpath)["associated_files"] == ["labels.txt"]
    with zipfile.ZipFile(tpath) as a, zipfile.ZipFile(jpath) as b:
        assert a.read("labels.txt") == b.read("labels.txt") == b"background\nreceipt\n"
    with open(tmp_path / "port" / "m_metadata.json") as a, \
            open(tmp_path / "jax" / "m_metadata.json") as b:
        meta = json.load(a)
        assert meta == json.load(b)
    assert tmd.build_metadata_flatbuffer(meta, "labels.txt") == \
        jmd.build_metadata_flatbuffer(meta, "labels.txt")
    x = _images(1, seed=15)
    np.testing.assert_allclose(_tflite(tpath, x), _forward(port_model, x), **TFLITE_TOL)


def test_cli_tflite_runs(tmp_path, port_model, capsys):
    pytest.importorskip("tensorflow")
    cv2 = pytest.importorskip("cv2")
    from unet_image_segmentation_tpu_torch.export.tflite_metadata import read_metadata

    ckpt = _checkpoint(tmp_path, port_model)
    out = str(tmp_path / "m.tflite")
    assert export_main(["tflite", ckpt, out, "--image-size", str(HW)]) == 0
    x = _images(1, seed=16)
    np.testing.assert_allclose(_tflite(out, x), _forward(port_model, x), **TFLITE_TOL)
    assert read_metadata(out)["name"] == "unet-image-segmentation-tpu"
    reps = tmp_path / "reps"
    reps.mkdir()
    for i, img in enumerate(_images(3, seed=17)):
        cv2.imwrite(str(reps / f"r{i}.png"), (img * 255).astype(np.uint8))
    out8 = str(tmp_path / "m8.tflite")
    assert export_main(["tflite", ckpt, out8, "--image-size", str(HW), "--int8",
                        "--rep-images", str(reps)]) == 0
    y = _tflite(out8, x)
    assert y.shape == (1, HW, HW, 1) and np.isfinite(y).all()
    assert "TFLite model written" in capsys.readouterr().out
