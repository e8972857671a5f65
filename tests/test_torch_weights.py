"""The Flax <-> torch weight bridge and the port checkpoint format."""

import jax
import numpy as np
import pytest
import torch

from unet_image_segmentation_tpu.config import ModelConfig
from unet_image_segmentation_tpu.models.unet import build_unet as build_unet_jax
from unet_image_segmentation_tpu.models.unet import init_unet
from unet_image_segmentation_tpu_torch.config import ModelConfig as TorchModelConfig
from unet_image_segmentation_tpu_torch.models.unet import build_unet
from unet_image_segmentation_tpu_torch.train.checkpoint import (
    load_inference_variables,
    save_inference_variables,
)
from unet_image_segmentation_tpu_torch.weights import (
    flax_from_state_dict,
    state_dict_from_flax,
)

CASES = [
    dict(filters=(8, 16)),
    dict(filters=(8, 16), num_classes=3),
    dict(filters=(8, 16), conv_type="full"),
    dict(filters=(8, 16), use_batch_norm=False),
]


def _flax_variables(kw):
    """A Flax variable tree with the structure and shapes of ``init_unet``
    (traced with eval_shape) and values drawn from a numpy seed."""
    cfg = ModelConfig(image_height=16, image_width=16, dropout_rate=0.0, **kw)
    model = build_unet_jax(cfg)
    shapes = jax.eval_shape(lambda: init_unet(model, jax.random.PRNGKey(0), cfg.input_shape))
    rng = np.random.RandomState(0)
    return cfg, jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes
    )


def _flat(tree):
    return {
        jax.tree_util.keystr(p): v
        for p, v in jax.tree_util.tree_leaves_with_path(tree)
    }


@pytest.mark.parametrize("kw", CASES)
def test_bridge_round_trip_is_exact(kw):
    _, variables = _flax_variables(kw)
    back = flax_from_state_dict(state_dict_from_flax(variables))
    a, b = _flat(variables), _flat(back)
    assert a.keys() == b.keys()
    for key, arr in a.items():
        assert b[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(b[key], arr, err_msg=key)


@pytest.mark.parametrize("kw", CASES)
def test_bridge_keys_match_port_module(kw):
    """The bridged state_dict loads strictly into the port's UNet, and a
    fresh port init has the same keys and shapes as a fresh Flax init."""
    _, variables = _flax_variables(kw)
    sd = state_dict_from_flax(variables)
    cfg = TorchModelConfig(image_height=16, image_width=16, dropout_rate=0.0, **kw)
    model = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    own = model.state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in sd.items()
    }
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_port_checkpoint_round_trip(tmp_path):
    cfg, variables = _flax_variables(dict(filters=(8, 16)))
    sd = state_dict_from_flax(variables)
    save_inference_variables(str(tmp_path / "ckpt"), sd, {"filters": [8, 16], "num_classes": 1})
    loaded, kwargs = load_inference_variables(str(tmp_path / "ckpt"))
    assert kwargs == {"filters": (8, 16), "num_classes": 1}
    assert loaded.keys() == sd.keys()
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k


def test_non_port_directory_points_at_the_bridge(tmp_path):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(FileNotFoundError, match="state_dict_from_flax"):
        load_inference_variables(str(tmp_path / "orbax"))


def test_glorot_init_bounds_and_seed():
    cfg = TorchModelConfig(filters=(8, 16))
    a = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    b = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    dw = a["enc2_block1.sepconv.depthwise_kernel"]  # (3,3,8,1): fans 72, 9
    limit = np.sqrt(6.0 / (72 + 9))
    assert dw.abs().max() <= limit and dw.abs().max() > 0.5 * limit
