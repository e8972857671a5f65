"""Checkpoints of the port, after ``unet_image_segmentation_tpu/train/checkpoint.py``.

Layout under a training run's ``model_out`` directory:

* ``best/``: the inference checkpoint of the best epoch, ``model.pt``
  (``torch.save`` of the ``state_dict``) and ``model.json`` (the model
  kwargs); :class:`..inference.Predictor` loads it;
* ``last/state.pt``: the full state for resume (weights and BatchNorm
  statistics, AdamW state, step, dropout-seed generator);
* ``meta.json``: epoch, monitor, callback bookkeeping, learning rate, config.

A reference Keras ``.h5`` loads through :func:`..utils.keras_import.load_keras_h5`
and the :mod:`..weights` bridge. Orbax directories
written by the JAX package are not read here: convert them with the bridge
from a JAX environment.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from unet_image_segmentation_tpu_torch.weights import state_dict_from_flax

WEIGHTS_FILE = "model.pt"
KWARGS_FILE = "model.json"
STATE_FILE = "state.pt"
META_FILE = "meta.json"


def save_inference_variables(
    path: str,
    state_dict: Dict[str, torch.Tensor],
    model_kwargs: Optional[Dict[str, Any]] = None,
) -> None:
    """Write ``path/model.pt`` and ``path/model.json``."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(path, WEIGHTS_FILE))
    with open(os.path.join(path, KWARGS_FILE), "w") as f:
        json.dump(model_kwargs or {}, f, indent=2)


def load_inference_variables(
    path: str,
) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]]]:
    """Load ``(state_dict, model kwargs)`` from a port checkpoint directory
    (or its parent holding ``best/``) or a Keras ``.h5``/``.keras`` file."""
    path = os.path.abspath(path)
    if path.endswith((".h5", ".keras")):
        from unet_image_segmentation_tpu_torch.utils.keras_import import load_keras_h5

        variables, kwargs = load_keras_h5(path)
        return state_dict_from_flax(variables), kwargs
    if os.path.isdir(os.path.join(path, "best")):
        path = os.path.join(path, "best")
    weights = os.path.join(path, WEIGHTS_FILE)
    if not os.path.exists(weights):
        raise FileNotFoundError(
            f"{path} holds no {WEIGHTS_FILE}. If it is an Orbax checkpoint of "
            "the JAX package, convert it from a JAX environment: restore it "
            "there, pass the variables through "
            "unet_image_segmentation_tpu_torch.weights.state_dict_from_flax and "
            "write the result with save_inference_variables."
        )
    state_dict = torch.load(weights, map_location="cpu", weights_only=True)
    kwargs = None
    kw_path = os.path.join(path, KWARGS_FILE)
    if os.path.exists(kw_path):
        with open(kw_path) as f:
            kwargs = json.load(f)
        if "filters" in kwargs:
            kwargs["filters"] = tuple(kwargs["filters"])
    return state_dict, kwargs


def to_host(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Detached CPU copies of a ``state_dict``."""
    return {k: v.detach().cpu().clone() for k, v in state_dict.items()}


def save_state(path: str, state, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``path/state.pt`` (and ``meta.json`` beside ``path`` if given)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(
        {
            "step": int(state.step),
            "model": to_host(state.model.state_dict()),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
        },
        os.path.join(path, STATE_FILE),
    )
    if meta is not None:
        write_meta(os.path.dirname(path), meta)


def restore_state(path: str, state):
    """Load ``path/state.pt`` into ``state`` (same model shapes); returns it."""
    ckpt = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.generator.set_state(ckpt["generator"])
    state.step = int(ckpt["step"])
    return state


def write_meta(model_out: str, meta: Dict[str, Any]) -> None:
    os.makedirs(model_out, exist_ok=True)
    with open(os.path.join(model_out, META_FILE), "w") as f:
        json.dump(meta, f, indent=2, default=float)


def read_meta(model_out: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(os.path.abspath(model_out), META_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)
