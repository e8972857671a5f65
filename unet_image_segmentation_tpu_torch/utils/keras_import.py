"""Import reference-trained Keras checkpoints into Flax-layout variables.

The port's own copy of the ``.h5`` reader of
``unet_image_segmentation_tpu/utils/keras_import.py``. It returns the
nested ``{"params": ..., "batch_stats": ...}`` tree of numpy arrays that
:func:`unet_image_segmentation_tpu_torch.weights.state_dict_from_flax`
turns into a ``state_dict``; ``h5py`` is imported only when a file is read.

The reference serializes full models to ``.h5`` via ``ModelCheckpoint``
(reference ``scripts/train.py:273-280``) and reloads them with
``load_model(..., custom_objects={dice_loss, dice_coef}, compile=False)``
(``scripts/inference.py:218-227``).  Here the equivalent contract is: read
the weight arrays straight out of the HDF5 file (no TensorFlow needed) and
place them into the Flax U-Net's variable tree.  Because our param shapes
deliberately mirror Keras layouts (see :mod:`..models.layers`), no kernel
transposition is required.

Layer-name mapping (the reference names its layers deterministically,
``model/u_net.py:14-112``):

====================  =============================================
Keras layer           Flax variable path
====================  =============================================
``{blk}_sepconv``     ``params/{blk}/sepconv/{depthwise,pointwise}_kernel[,bias]``
``{blk}_conv``        ``params/{blk}/conv/kernel[,bias]``
``{blk}_bn``          ``params/{blk}/bn/{scale,bias}`` +
                      ``batch_stats/{blk}/bn/{mean,var}``
``dec{s}_upsample``   ``params/dec{s}_upsample/{kernel,bias}``
``output_mask``       ``params/output_mask/{kernel,bias}``
====================  =============================================
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np

_BN_MAP = {
    "gamma": ("params", "scale"),
    "beta": ("params", "bias"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}

_SUFFIXES = ("_sepconv", "_conv", "_bn")


def _strip_tail(name: str) -> str:
    """'enc1_block1_sepconv/depthwise_kernel:0' weight names -> leaf name."""
    leaf = name.rsplit("/", 1)[-1]
    return leaf.split(":", 1)[0]


def _place(
    params: Dict[str, Any],
    batch_stats: Dict[str, Any],
    layer_name: str,
    weights: Dict[str, np.ndarray],
) -> None:
    """Route one Keras layer's weights into the Flax trees."""
    for suffix in _SUFFIXES:
        if layer_name.endswith(suffix):
            block = layer_name[: -len(suffix)]
            sub = suffix[1:]  # sepconv | conv | bn
            if sub == "bn":
                for keras_name, (tree, flax_name) in _BN_MAP.items():
                    if keras_name not in weights:
                        raise KeyError(f"{layer_name}: missing {keras_name}")
                    dst = params if tree == "params" else batch_stats
                    dst.setdefault(block, {}).setdefault("bn", {})[flax_name] = weights[
                        keras_name
                    ]
            else:
                params.setdefault(block, {})[sub] = dict(weights)
            return
    if re.fullmatch(r"dec\d+_upsample", layer_name) or layer_name == "output_mask":
        params[layer_name] = dict(weights)
        return
    if weights:
        raise KeyError(f"Unrecognized weighted layer {layer_name!r}")


def variables_from_keras_weights(
    layer_weights: Dict[str, Dict[str, np.ndarray]],
) -> Dict[str, Any]:
    """Build the Flax variable dict from {layer_name: {weight_name: array}}."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for layer_name, weights in layer_weights.items():
        if weights:
            _place(params, batch_stats, layer_name, weights)
    out: Dict[str, Any] = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def _collect_h5_datasets(group: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    import h5py

    out: Dict[str, np.ndarray] = {}
    for key, item in group.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(item, h5py.Dataset):
            out[path] = np.asarray(item)
        else:
            out.update(_collect_h5_datasets(item, path))
    return out


def variables_from_h5(path: str) -> Dict[str, Any]:
    """Read a Keras ``.h5`` full-model file without TensorFlow.

    Handles the legacy TF2 layout ``model_weights/<layer>/.../<weight>:0``
    and Keras-3 variations (``_layer_checkpoint_dependencies``, ``vars``).
    """
    import h5py

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        datasets = _collect_h5_datasets(root)

    layer_weights: Dict[str, Dict[str, np.ndarray]] = {}
    for full, arr in datasets.items():
        parts = [p for p in full.split("/") if p not in ("vars",)]
        if not parts:
            continue
        layer = parts[0]
        if layer in ("top_level_model_weights", "optimizer_weights"):
            continue
        leaf = _strip_tail(parts[-1])
        # Keras 3 sometimes stores weights as vars/0, vars/1 ...; recover
        # canonical names by position using the layer kind.
        if leaf.isdigit():
            leaf = _positional_weight_name(layer, int(leaf), arr)
        layer_weights.setdefault(layer, {})[leaf] = arr
    return variables_from_keras_weights(layer_weights)


def _positional_weight_name(layer: str, idx: int, arr: np.ndarray) -> str:
    if layer.endswith("_bn"):
        return ["gamma", "beta", "moving_mean", "moving_variance"][idx]
    if layer.endswith("_sepconv"):
        return ["depthwise_kernel", "pointwise_kernel", "bias"][idx]
    if layer.endswith("_conv") or layer.endswith("_upsample") or layer == "output_mask":
        return ["kernel", "bias"][idx]
    raise KeyError(f"Cannot infer weight name for {layer}[{idx}] shape {arr.shape}")


def load_keras_h5(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load an .h5 checkpoint -> (variables, inferred model kwargs).

    Infers ``num_classes``/``filters``/``use_batch_norm``/``conv_type`` from
    the weight shapes so callers can build a matching :class:`..models.UNet`.
    """
    variables = variables_from_h5(path)
    params = variables["params"]
    head = params["output_mask"]["kernel"]
    num_classes = int(head.shape[-1])
    filters = []
    stage = 1
    while f"enc{stage}_block1" in params:
        block = params[f"enc{stage}_block1"]
        conv = block.get("sepconv") or block.get("conv")
        key = "pointwise_kernel" if "pointwise_kernel" in conv else "kernel"
        filters.append(int(conv[key].shape[-1]))
        stage += 1
    conv_type = "separable" if "sepconv" in params["enc1_block1"] else "full"
    use_batch_norm = "bn" in params["enc1_block1"]
    kwargs = dict(
        num_classes=num_classes,
        filters=tuple(filters),
        use_batch_norm=use_batch_norm,
        conv_type=conv_type,
    )
    return variables, kwargs
