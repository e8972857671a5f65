"""Bridge between the JAX package's Flax variable tree and a torch ``state_dict``.

The port's modules hold their parameters in the JAX package's Keras
layouts under the same names (``utils/keras_import.py`` mapping), so the
bridge only renames:

====================================================  ==================================
Flax path                                             state_dict key
====================================================  ==================================
``params/{blk}/sepconv/{depthwise,pointwise}_kernel``  ``{blk}.sepconv.{...}_kernel``
``params/{blk}/conv/{kernel,bias}``                    ``{blk}.conv.{kernel,bias}``
``params/{blk}/bn/{scale,bias}``                       ``{blk}.bn.{scale,bias}``
``batch_stats/{blk}/bn/{mean,var}``                    ``{blk}.bn.{mean,var}`` (buffers)
``params/dec{s}_upsample/{kernel,bias}``               ``dec{s}_upsample.{kernel,bias}``
``params/output_mask/{kernel,bias}``                   ``output_mask.{kernel,bias}``
====================================================  ==================================

Arrays are copied unchanged (same dtype, same values), so a round trip is
exact. The Flax side is numpy (or anything ``np.asarray`` accepts); no JAX
is imported here.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_STATS = ("mean", "var")


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` -> ``{dotted key: tensor}``."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            sd[".".join(path)] = torch.from_numpy(np.array(value, copy=True))
    return sd


def flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`state_dict_from_flax`: nested numpy trees."""
    out: Dict[str, Any] = {}
    for key, tensor in sd.items():
        path = key.split(".")
        is_stat = len(path) >= 2 and path[-2] == "bn" and path[-1] in _STATS
        node = out.setdefault("batch_stats" if is_stat else "params", {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = tensor.detach().cpu().numpy().copy()
    return out
