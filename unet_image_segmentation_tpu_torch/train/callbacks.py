"""Epoch-granularity training callbacks.

Port of ``unet_image_segmentation_tpu/train/callbacks.py``, the four Keras
callbacks the reference trains with:

* :class:`BestCheckpoint`: save-best-only on the monitored metric into
  ``best/`` (a port inference checkpoint), plus the rolling ``last/`` state
  for resume;
* :class:`EarlyStopping`: patience, optional restore of the best weights;
* :class:`ReduceLROnPlateau`: lowers the AdamW learning rate in place;
* :class:`TensorBoardLogger`: per-epoch scalars and weight histograms
  through the port's own pure-Python event writer, ``utils/tb_writer.py``.

All comparisons use strict improvement (Keras min_delta=0).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from unet_image_segmentation_tpu_torch.train import checkpoint as ckpt_lib


def _improved(score: float, best: float, mode: str) -> bool:
    return score > best if mode == "max" else score < best


def _init_best(mode: str) -> float:
    return -np.inf if mode == "max" else np.inf


class Callback:
    def on_epoch_end(self, epoch: int, logs: Dict[str, float], state) -> Any:
        return state

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        pass


class BestCheckpoint(Callback):
    def __init__(
        self,
        model_out: str,
        monitor: str = "val_mean_io_u",
        mode: str = "max",
        model_kwargs: Optional[dict] = None,
        save_last: bool = True,
        verbose: bool = True,
    ):
        self.model_out = os.path.abspath(model_out)
        self.monitor = monitor
        self.mode = mode
        self.best = _init_best(mode)
        self.best_epoch = -1
        self.model_kwargs = model_kwargs
        self.save_last = save_last
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs, state):
        score = logs.get(self.monitor)
        if score is not None and _improved(score, self.best, self.mode):
            if self.verbose:
                print(
                    f"Epoch {epoch + 1}: {self.monitor} improved {self.best:.5f} -> "
                    f"{score:.5f}; saving best to {self.model_out}/best"
                )
            self.best = float(score)
            self.best_epoch = epoch
            ckpt_lib.save_inference_variables(
                os.path.join(self.model_out, "best"), state.model.state_dict(), self.model_kwargs
            )
        if self.save_last:
            ckpt_lib.save_state(os.path.join(self.model_out, "last"), state)
        return state

    def state_dict(self):
        return {"best": self.best, "best_epoch": self.best_epoch}

    def load_state_dict(self, d):
        self.best = d.get("best", self.best)
        self.best_epoch = d.get("best_epoch", self.best_epoch)


class EarlyStopping(Callback):
    def __init__(
        self,
        monitor: str = "val_mean_io_u",
        mode: str = "max",
        patience: int = 10,
        restore_best_weights: bool = True,
        verbose: bool = True,
    ):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.restore_best_weights = restore_best_weights
        self.best = _init_best(mode)
        self.wait = 0
        self.stopped_epoch = -1
        self.should_stop = False
        self._best_weights = None  # host copy of the model's state_dict
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs, state):
        score = logs.get(self.monitor)
        if score is None:
            return state
        if _improved(score, self.best, self.mode):
            self.best = float(score)
            self.wait = 0
            if self.restore_best_weights:
                self._best_weights = ckpt_lib.to_host(state.model.state_dict())
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.should_stop = True
                self.stopped_epoch = epoch
                if self.verbose:
                    print(f"Epoch {epoch + 1}: early stopping "
                          f"(no {self.monitor} improvement in {self.patience} epochs)")
                if self.restore_best_weights and self._best_weights is not None:
                    if self.verbose:
                        print("Restoring model weights from the best epoch.")
                    state.model.load_state_dict(self._best_weights)
        return state

    def state_dict(self):
        return {"best": self.best, "wait": self.wait}

    def load_state_dict(self, d):
        self.best = d.get("best", self.best)
        self.wait = d.get("wait", self.wait)


class ReduceLROnPlateau(Callback):
    def __init__(
        self,
        monitor: str = "val_mean_io_u",
        mode: str = "max",
        factor: float = 0.2,
        patience: int = 3,
        min_lr: float = 1e-6,
        verbose: bool = True,
    ):
        self.monitor = monitor
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = _init_best(mode)
        self.wait = 0
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs, state):
        score = logs.get(self.monitor)
        if score is None:
            return state
        if _improved(score, self.best, self.mode):
            self.best = float(score)
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                old_lr = state.learning_rate
                new_lr = max(old_lr * self.factor, self.min_lr)
                if new_lr < old_lr:
                    if self.verbose:
                        print(f"Epoch {epoch + 1}: ReduceLROnPlateau lr {old_lr:.2e} -> "
                              f"{new_lr:.2e}")
                    state.set_learning_rate(new_lr)
                self.wait = 0
        logs["learning_rate"] = state.learning_rate
        return state

    def state_dict(self):
        return {"best": self.best, "wait": self.wait}

    def load_state_dict(self, d):
        self.best = d.get("best", self.best)
        self.wait = d.get("wait", self.wait)


class TensorBoardLogger(Callback):
    def __init__(self, log_dir: str, histogram_freq: int = 1):
        from unet_image_segmentation_tpu_torch.utils.tb_writer import SummaryWriter

        self.writer = SummaryWriter(log_dir)
        self.histogram_freq = histogram_freq

    def on_epoch_end(self, epoch, logs, state):
        self.writer.scalars(
            {k: v for k, v in logs.items() if np.isscalar(v) or np.ndim(v) == 0},
            step=epoch + 1,
            prefix="epoch_",
        )
        if self.histogram_freq and (epoch + 1) % self.histogram_freq == 0:
            for name, p in state.model.named_parameters():
                self.writer.histogram(name.replace(".", "/"), p.detach().float().cpu().numpy(),
                                      epoch + 1)
        self.writer.flush()
        return state


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def on_epoch_end(self, epoch, logs, state):
        for cb in self.callbacks:
            state = cb.on_epoch_end(epoch, logs, state)
        return state

    @property
    def should_stop(self) -> bool:
        return any(getattr(cb, "should_stop", False) for cb in self.callbacks)

    def state_dict(self):
        return {type(cb).__name__: cb.state_dict() for cb in self.callbacks}

    def load_state_dict(self, d):
        for cb in self.callbacks:
            if type(cb).__name__ in d:
                cb.load_state_dict(d[type(cb).__name__])
