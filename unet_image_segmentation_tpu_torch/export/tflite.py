"""Optional TFLite bridge (mobile deployment parity).

Counterpart of ``unet_image_segmentation_tpu/export/tflite.py``. The
reference exports ``.h5 -> .tflite`` with optional default optimization
and fp16 weights (``convert_to_tflite.py:124-140``) and packs flatbuffer
metadata (``add_tflite_metadata.py``). The JAX package converts through
``jax2tf``; here the port's eval forward is written out in ``tf.nn`` ops
over the module's weights, held as numpy constants, and converted from
that ``tf.function``:

* ConvBlock: depthwise 3x3 then pointwise 1x1 (``separable``) or a full
  3x3 conv (``full``), 'same' padding, the conv bias without BatchNorm;
  Keras BatchNorm (epsilon 1e-3, running statistics) as a folded affine;
  ReLU;
* 2x2 stride-2 max pool; the 2x2 stride-2 transpose-up (the Keras
  ``Conv2DTranspose`` kernel ``(2, 2, F, C)`` as it is); the channel
  concat ``[up | skip]``;
* the 1x1 head and a sigmoid (one class) or a softmax over the classes.

The graph computes in float32 whatever the module's compute dtype, as a
float TFLite interpreter does. TensorFlow is imported only inside the
functions that need it (an optional dependency; the serving-native path is
:mod:`.pt2`).

Metadata: the descriptive fields are written as ``metadata.json`` next to
the ``.tflite`` AND embedded in-file as a hand-assembled metadata
flatbuffer + appended label-file zip (:mod:`.tflite_metadata`), as the
JAX package does.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from unet_image_segmentation_tpu_torch.models.layers import BatchNorm


def tf_available() -> bool:
    try:
        import tensorflow  # noqa: F401

        return True
    except Exception:
        return False


def _tf_forward(model):
    """``images -> probabilities``: the eval forward of ``model`` (the
    port's ``UNet``) in TensorFlow ops, its weights numpy constants."""
    import tensorflow as tf

    sd = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    separable = model.conv_type == "separable"

    def conv_block(x, name):
        if separable:
            y = tf.nn.depthwise_conv2d(x, sd[f"{name}.sepconv.depthwise_kernel"],
                                       [1, 1, 1, 1], "SAME")
            y = tf.nn.conv2d(y, sd[f"{name}.sepconv.pointwise_kernel"], 1, "VALID")
            bias = sd.get(f"{name}.sepconv.bias")
        else:
            y = tf.nn.conv2d(x, sd[f"{name}.conv.kernel"], 1, "SAME")
            bias = sd.get(f"{name}.conv.bias")
        if bias is not None:
            y = tf.nn.bias_add(y, bias)
        if model.use_batch_norm:
            scale = sd[f"{name}.bn.scale"] / np.sqrt(sd[f"{name}.bn.var"] + BatchNorm.eps)
            y = y * scale + (sd[f"{name}.bn.bias"] - sd[f"{name}.bn.mean"] * scale)
        return tf.nn.relu(y)

    def pair(x, prefix):
        return conv_block(conv_block(x, f"{prefix}_block1"), f"{prefix}_block2")

    def forward(images):
        depth = len(model.filters)
        x, skips = images, []
        for stage in range(1, depth + 1):
            x = pair(x, f"enc{stage}")
            skips.append(x)
            x = tf.nn.max_pool2d(x, 2, 2, "VALID")
        x = pair(x, "bneck")
        for stage in range(depth, 0, -1):
            kernel = sd[f"dec{stage}_upsample.kernel"]
            b, h, w = x.shape[0], x.shape[1], x.shape[2]
            up = tf.nn.conv2d_transpose(x, kernel, [b, 2 * h, 2 * w, kernel.shape[2]], 2,
                                        "SAME")
            up = tf.nn.bias_add(up, sd[f"dec{stage}_upsample.bias"])
            x = pair(tf.concat([up, skips[stage - 1]], axis=-1), f"dec{stage}")
        logits = tf.nn.bias_add(tf.nn.conv2d(x, sd["output_mask.kernel"], 1, "VALID"),
                                sd["output_mask.bias"])
        return tf.sigmoid(logits) if model.num_classes == 1 else tf.nn.softmax(logits, axis=-1)

    return forward


def convert_to_tflite(
    model,
    output_path: str,
    batch_size: int = 1,
    image_size: Tuple[int, int] = (256, 256),
    channels: int = 3,
    optimize: bool = False,
    float16: bool = False,
    int8: bool = False,
    representative_images=None,
    labels: Optional[Sequence[str]] = None,
) -> str:
    """Convert the forward pass to a .tflite flatbuffer.

    ``optimize`` maps to ``tf.lite.Optimize.DEFAULT`` and ``float16`` to
    fp16 weight storage, mirroring the reference flags
    (``convert_to_tflite.py:128-140``). ``int8`` performs full integer
    quantization with a representative dataset;
    ``representative_images`` is an iterable of (H, W, C) float32 [0,1]
    arrays (a handful of training frames), defaulting to random frames
    when omitted.
    """
    if not tf_available():
        raise RuntimeError(
            "TensorFlow is not available; use export.pt2 for the "
            "TF-free serving artifact."
        )
    import tensorflow as tf

    h, w = image_size
    tf_fn = tf.function(
        _tf_forward(model),
        input_signature=[
            tf.TensorSpec([batch_size, h, w, channels], tf.float32, name="input_image")
        ],
        autograph=False,
    )
    converter = tf.lite.TFLiteConverter.from_concrete_functions(
        [tf_fn.get_concrete_function()]
    )
    converter.target_spec.supported_ops = [
        tf.lite.OpsSet.TFLITE_BUILTINS,
        tf.lite.OpsSet.SELECT_TF_OPS,
    ]
    if optimize:
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
    if float16:
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
        converter.target_spec.supported_types = [tf.float16]
    if int8:
        converter.optimizations = [tf.lite.Optimize.DEFAULT]

        def rep_gen():
            if representative_images is not None:
                for img in representative_images:
                    yield [img[None].astype("float32")]
            else:
                rng = np.random.RandomState(0)
                for _ in range(8):
                    yield [rng.rand(1, h, w, channels).astype("float32")]

        converter.representative_dataset = rep_gen
        # keep float I/O (the pipeline feeds [0,1] floats); weights+math int8
        converter.target_spec.supported_ops = [
            tf.lite.OpsSet.TFLITE_BUILTINS_INT8,
            tf.lite.OpsSet.TFLITE_BUILTINS,
            tf.lite.OpsSet.SELECT_TF_OPS,
        ]
    blob = converter.convert()
    out_dir = os.path.dirname(os.path.abspath(output_path))
    os.makedirs(out_dir, exist_ok=True)
    with open(output_path, "wb") as f:
        f.write(blob)

    _write_metadata_sidecar(
        output_path, model, batch_size, image_size, channels, labels
    )
    return output_path


def _write_metadata_sidecar(
    tflite_path: str,
    model,
    batch_size: int,
    image_size: Tuple[int, int],
    channels: int,
    labels: Optional[Sequence[str]],
) -> None:
    from unet_image_segmentation_tpu_torch.export.pt2 import DEFAULT_LABELS

    labels = list(labels or DEFAULT_LABELS)
    h, w = image_size
    num_classes = getattr(model, "num_classes", 1)
    meta = {
        "name": "unet-image-segmentation-tpu",
        "version": "v1",
        "input": {
            "shape": [batch_size, h, w, channels],
            "color_space": "RGB",
            "normalization": {"mean": [0.0], "std": [255.0]},
        },
        "output": {
            "shape": [batch_size, h, w, num_classes],
            "semantics": "probability mask",
            "binarization_threshold": 0.5,
        },
        "labels": labels,
    }
    sidecar = os.path.splitext(tflite_path)[0] + "_metadata.json"
    with open(sidecar, "w") as f:
        json.dump(meta, f, indent=2)
    labels_path = os.path.join(os.path.dirname(tflite_path) or ".", "labels.txt")
    with open(labels_path, "w") as f:
        f.write("\n".join(labels) + "\n")
    # In-file flatbuffer metadata, hand-assembled — no tflite_support
    # needed (reference add_tflite_metadata.py:203-317 parity; see
    # export.tflite_metadata for the schema-layout notes).
    from unet_image_segmentation_tpu_torch.export.tflite_metadata import (
        build_metadata_flatbuffer,
        embed_metadata,
    )

    blob = build_metadata_flatbuffer(meta, os.path.basename(labels_path))
    embed_metadata(tflite_path, blob, [labels_path])
