"""Train state: the model (with its BatchNorm statistics), AdamW with a
mutable learning rate, the step count and the dropout-seed generator.

Port of ``unet_image_segmentation_tpu/train/state.py``. The JAX package
trains with ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-7, decay on every
parameter), whose update is ``p - lr*(m_hat/(sqrt(v_hat)+eps) + wd*p)``;
``torch.optim.AdamW`` with the same settings computes the same update
(``p*(1 - lr*wd) - lr*m_hat/(sqrt(v_hat)+eps)``), up to rounding.
:func:`load_optax_adam_state` carries an optax ``ScaleByAdamState`` over,
so a JAX run can continue here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from unet_image_segmentation_tpu_torch.config import Config
from unet_image_segmentation_tpu_torch.models.unet import UNet, build_unet, resolve_device
from unet_image_segmentation_tpu_torch.weights import state_dict_from_flax


class TrainState:
    """What a training run carries from step to step.

    ``generator`` draws each step's int32 dropout-site seeds (the JAX
    package folds the step into a PRNG key instead; the two streams
    differ, and parity tests hand both packages the same seeds).
    """

    def __init__(self, model: UNet, optimizer: torch.optim.Optimizer,
                 generator: torch.Generator, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.step = step

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def set_learning_rate(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)


def make_optimizer(model: torch.nn.Module, learning_rate: float,
                   weight_decay: float) -> torch.optim.AdamW:
    """AdamW with Keras-default betas and epsilon, decaying every parameter."""
    return torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-7,
        weight_decay=weight_decay,
    )


def create_train_state(
    cfg: Config,
    model: Optional[UNet] = None,
    device: Union[str, torch.device] = "cuda",
) -> TrainState:
    """Seeded weights (``train.seed``), AdamW, and the dropout-seed generator,
    on ``device`` (the card unless the caller asks for another device); a
    given ``model`` is moved there."""
    device = resolve_device(device)
    if model is None:
        model = build_unet(cfg.model, device=device,
                           generator=torch.Generator().manual_seed(cfg.train.seed))
    else:
        model.to(device)
    optimizer = make_optimizer(model, cfg.train.learning_rate, cfg.train.weight_decay)
    return TrainState(model, optimizer, torch.Generator().manual_seed(cfg.train.seed))


def load_optax_adam_state(state: TrainState, count: int, mu: Dict[str, Any],
                          nu: Dict[str, Any]) -> None:
    """Set AdamW's moments from an optax ``ScaleByAdamState(count, mu, nu)``.

    ``mu`` and ``nu`` are the Flax parameter trees of the first and second
    moments (numpy, or anything ``np.asarray`` takes); ``count`` is the
    number of updates taken.
    """
    params = dict(state.model.named_parameters())
    mus = state_dict_from_flax({"params": mu})
    nus = state_dict_from_flax({"params": nu})
    if set(mus) != set(params) or set(nus) != set(params):
        raise ValueError("the optax moments do not match the model's parameters")
    for name, p in params.items():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": mus[name].to(device=p.device, dtype=p.dtype).reshape(p.shape),
            "exp_avg_sq": nus[name].to(device=p.device, dtype=p.dtype).reshape(p.shape),
        }
