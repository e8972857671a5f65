"""The training loop: the reference's ``model.fit``, on one device or on a
mesh of ranks.

Port of ``unet_image_segmentation_tpu/train/loop.py``. Per epoch:
prefetched host batches (:mod:`..data.loader`'s loaders and ``Prefetcher``,
:mod:`..data.autopack`) -> this rank's shard -> device -> train step ->
metric sums kept on the device and fetched once per epoch -> validation ->
callbacks (best checkpoint, early stop, LR plateau, TensorBoard) ->
``meta.json`` for ``--resume``. With ``train.profile_dir`` set, the first
``profile_steps`` steps of the first epoch run under a ``torch.profiler``
trace written there (:func:`..utils.profiling.trace`); the epoch then goes
on untraced.

The mesh comes from the config's ``mesh`` section over the process group's
ranks (:mod:`..parallel`; one process: (1, 1)), its spatial degree clamped
to the ranks present as the JAX ``fit`` clamps it to the devices. Every
rank loads the same global batch and takes its shard; the steps reduce
what crosses ranks (:mod:`.steps`), so every rank holds the same weights
and metrics, and only rank 0 writes checkpoints, logs and ``meta.json``
(and packs the dataset; the others read the same samples from the
directory). A row-sharded configuration that the fused chains cannot train
(the JAX package's GSPMD-XLA path) prints the JAX package's warning, drops
``use_pallas`` and trains on the composed modules' row-sharded step
(halo rows exchanged at every 3x3 conv, :mod:`.steps`); validation gathers
each data row's rows and evaluates the whole images, as GSPMD's numbers are.

Metric names mirror Keras logs: ``loss``, ``dice_coef``, ``mean_io_u``
(Keras int-cast semantics), ``mean_io_u_thresh`` (> 0.5), and ``val_*``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from unet_image_segmentation_tpu_torch.config import Config
from unet_image_segmentation_tpu_torch.data.loader import Prefetcher, make_loaders
from unet_image_segmentation_tpu_torch.models.unet import build_unet, resolve_device
from unet_image_segmentation_tpu_torch.ops.losses import sums_loss_supported
from unet_image_segmentation_tpu_torch.ops.metrics import mean_iou_from_cm, per_class_iou_from_cm
from unet_image_segmentation_tpu_torch.parallel.mesh import Mesh, create_mesh
from unet_image_segmentation_tpu_torch.train import checkpoint as ckpt_lib
from unet_image_segmentation_tpu_torch.train.callbacks import (
    BestCheckpoint,
    CallbackList,
    EarlyStopping,
    ReduceLROnPlateau,
    TensorBoardLogger,
)
from unet_image_segmentation_tpu_torch.train.state import TrainState, create_train_state
from unet_image_segmentation_tpu_torch.train.steps import make_eval_step, make_train_step
from unet_image_segmentation_tpu_torch.utils.profiling import StepTimer, trace


@dataclass
class FitResult:
    state: TrainState
    history: Dict[str, List[float]] = field(default_factory=dict)
    best_score: float = float("nan")
    best_epoch: int = -1
    stopped_epoch: int = -1
    epochs_run: int = 0


class _EpochMetrics:
    """Per-step metric sums kept on the device; one fetch in :meth:`result`."""

    def __init__(self) -> None:
        self._sums: Optional[Dict[str, torch.Tensor]] = None
        self.n = 0

    def update(self, metrics: Dict[str, torch.Tensor]) -> None:
        if self._sums is None:
            self._sums = {k: v.detach().clone() for k, v in metrics.items()}
        else:
            for k, v in metrics.items():
                self._sums[k] += v.detach()
        self.n += 1

    def result(self, prefix: str = "") -> Dict[str, float]:
        if self._sums is None:
            return {}
        sums = {k: v.cpu() for k, v in self._sums.items()}  # the epoch's sync point
        out = {prefix + k: float(v) / max(self.n, 1) for k, v in sums.items()
               if not k.startswith("cm_")}
        if "cm_raw" in sums:
            out[prefix + "mean_io_u"] = float(mean_iou_from_cm(sums["cm_raw"]))
        if "cm_thresh" in sums:
            cm = sums["cm_thresh"]
            out[prefix + "mean_io_u_thresh"] = float(mean_iou_from_cm(cm))
            if cm.shape[0] > 2:
                for i, v in enumerate(per_class_iou_from_cm(cm)):
                    out[prefix + f"iou_class_{i}"] = float(v)
        if prefix + "dice" in out:
            out[prefix + "dice_coef"] = out.pop(prefix + "dice")
        return out


def config_mesh(cfg: Config, verbose: bool = True) -> Mesh:
    """The mesh of the config's ``mesh`` section over the process group's
    ranks, its spatial degree clamped to the largest that divides them (the
    config's layouts are for several cards and must still run on one)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    spatial_req = spatial = cfg.mesh.spatial_axis
    while spatial > 1 and world % spatial:
        spatial -= 1
    if spatial != spatial_req and verbose:
        print(f"Note: mesh spatial={spatial_req} clamped to {spatial} ({world} rank(s) present).")
    return create_mesh(data=cfg.mesh.data_axis, spatial=spatial)


def _model_config(cfg: Config, mesh: Mesh):
    """The model config the run trains on ``mesh`` (JAX ``fit``'s path
    selection): ``use_pallas`` is dropped, with a warning, where the fused
    chains cannot train the configuration on it."""
    mcfg, tcfg = cfg.model, cfg.train
    n_data, n_spatial = mesh.shape["data"], mesh.shape["spatial"]
    if tcfg.batch_size % n_data:
        raise ValueError(f"batch_size {tcfg.batch_size} not divisible by data-parallel degree "
                         f"{n_data}")
    if mcfg.image_height % n_spatial:
        raise ValueError(f"image_height {mcfg.image_height} not divisible by spatial degree "
                         f"{n_spatial}")
    chain = mcfg.conv_type == "separable" and mcfg.use_batch_norm
    if mcfg.use_pallas and n_spatial > 1:
        depth = len(mcfg.filters)
        if not (chain and sums_loss_supported(tcfg.loss, mcfg.num_classes)
                and mcfg.image_height % (n_spatial * 2 ** depth) == 0):
            print(
                "WARNING: the row-sharded fused train step needs conv_type='separable', "
                "use_batch_norm, a sums-form loss (dice family; + cce for a softmax head) and "
                f"image_height % {n_spatial * 2 ** depth} == 0; this configuration (conv_type="
                f"{mcfg.conv_type!r}, num_classes={mcfg.num_classes}, loss={tcfg.loss!r}, "
                f"H={mcfg.image_height}) trains on the composed row-sharded path (the JAX "
                "package's GSPMD-XLA path)."
            )
            return dataclasses.replace(mcfg, use_pallas=False)
    if mcfg.use_pallas and not chain:
        print(
            "WARNING: the fused training chains need conv_type='separable' and "
            f"use_batch_norm=True; this configuration (conv_type={mcfg.conv_type!r}, "
            f"use_batch_norm={mcfg.use_batch_norm}) trains on the composed path."
        )
        mcfg = dataclasses.replace(mcfg, use_pallas=False)
    return mcfg


def fit(
    cfg: Config,
    train_ds=None,
    val_ds=None,
    state: Optional[TrainState] = None,
    callbacks: Optional[List[Any]] = None,
    device: Union[str, torch.device] = "cuda",
    verbose: bool = True,
) -> FitResult:
    """Train for ``cfg.train.epochs`` on ``device``; the datasets default to
    the directory contract under ``cfg.data.root``; the mesh is
    :func:`config_mesh`'s. On a mesh every rank calls it alike."""
    device = resolve_device(device)
    tcfg = cfg.train
    mesh = config_mesh(cfg, verbose)
    lead = mesh.rank == 0
    verbose = verbose and lead
    mcfg = _model_config(cfg, mesh)
    if train_ds is None or val_ds is None:
        train_ds, val_ds = make_loaders(cfg)
    if cfg.data.auto_pack and lead:
        from unet_image_segmentation_tpu_torch.data.autopack import maybe_autopack

        train_ds = maybe_autopack(train_ds, pack_dir=cfg.data.pack_dir,
                                  fallback_dir=tcfg.model_out, verbose=verbose)
        val_ds = maybe_autopack(val_ds, pack_dir=cfg.data.pack_dir,
                                fallback_dir=tcfg.model_out, verbose=verbose)
    if state is None:
        model = build_unet(mcfg, device=device,
                           generator=torch.Generator().manual_seed(tcfg.seed))
        state = create_train_state(cfg, model=model, device=device)
    else:
        state.model.to(device)
    model = state.model
    model.set_groups(mesh.group, mesh.spatial_group)

    model_kwargs = dict(
        num_classes=cfg.model.num_classes,
        filters=list(cfg.model.filters),
        dropout_rate=cfg.model.dropout_rate,
        use_batch_norm=cfg.model.use_batch_norm,
        conv_type=cfg.model.conv_type,
        image_height=cfg.model.image_height,
        image_width=cfg.model.image_width,
        image_channels=cfg.model.image_channels,
    )
    if callbacks is None:
        # every rank sees the same logs and weights; only rank 0 writes
        callbacks = [
            EarlyStopping(monitor=tcfg.monitor, mode=tcfg.monitor_mode,
                          patience=tcfg.early_stop_patience,
                          restore_best_weights=tcfg.restore_best_weights, verbose=verbose),
            ReduceLROnPlateau(monitor=tcfg.monitor, mode=tcfg.monitor_mode,
                              factor=tcfg.reduce_lr_factor, patience=tcfg.reduce_lr_patience,
                              min_lr=tcfg.min_lr, verbose=verbose),
        ]
        if lead:
            callbacks = [
                BestCheckpoint(tcfg.model_out, monitor=tcfg.monitor, mode=tcfg.monitor_mode,
                               model_kwargs=model_kwargs, verbose=verbose),
                *callbacks,
                TensorBoardLogger(os.path.join(tcfg.log_dir, time.strftime("%Y%m%d_%H%M%S")),
                                  histogram_freq=tcfg.histogram_freq),
            ]
    cb_list = CallbackList(callbacks)

    start_epoch = 0
    if tcfg.resume:
        meta = ckpt_lib.read_meta(tcfg.model_out)
        last = os.path.join(os.path.abspath(tcfg.model_out), "last")
        if meta is not None and os.path.isdir(last):
            ckpt_lib.restore_state(last, state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            cb_list.load_state_dict(meta.get("callbacks", {}))
            if "learning_rate" in meta:
                state.set_learning_rate(float(meta["learning_rate"]))
            if verbose:
                print(f"Resumed from {last} at epoch {start_epoch}")

    train_step = make_train_step(model, tcfg.loss, mesh)
    eval_step = make_eval_step(model, tcfg.loss, mesh)

    def put(batch):
        """This rank's shard of a global batch, on the device."""
        return tuple(mesh.shard(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)))
                     .to(device) for x in batch)

    def run_steps(batches, acc, timer, limit=None) -> bool:
        """Train on ``batches`` until they end (False) or, with ``limit``,
        until ``limit`` steps have run (True: the rest is left in ``batches``)."""
        for n, (images, masks) in enumerate(batches, 1):
            images, masks = put((images, masks))
            acc.update(train_step(state, images, masks))
            timer.lap()
            if limit is not None and n >= limit:
                return True
        return False

    steps_per_epoch = max(1, len(train_ds) // tcfg.batch_size)
    val_steps = max(1, len(val_ds) // tcfg.batch_size)
    history: Dict[str, List[float]] = {}
    result = FitResult(state=state, history=history)

    # SIGTERM: finish the epoch with 'last' and meta.json on disk, then stop
    stop_requested = {"flag": False}
    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _request_stop(signum, frame):
            print(f"\nSignal {signum} received: finishing epoch, checkpointing to "
                  f"{tcfg.model_out}/last, then stopping.")
            stop_requested["flag"] = True

        old_handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM, _request_stop)

    out_dir = os.path.abspath(tcfg.model_out)
    if lead:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            f.write(cfg.to_json(indent=2))

    try:
        for epoch in range(start_epoch, tcfg.epochs):
            t0 = time.perf_counter()
            acc = _EpochMetrics()
            timer = StepTimer(device)
            batches = Prefetcher(
                train_ds.batches(tcfg.batch_size, epoch=epoch, steps=steps_per_epoch,
                                 num_workers=cfg.data.num_workers),
                depth=cfg.data.prefetch,
            )
            # profile_dir: trace the first profile_steps steps of the first
            # epoch run, then finish that epoch outside the trace
            profiling = tcfg.profile_dir is not None and epoch == start_epoch
            with trace(tcfg.profile_dir, device) if profiling else contextlib.nullcontext():
                cut = run_steps(batches, acc, timer, tcfg.profile_steps if profiling else None)
            if cut:
                run_steps(batches, acc, timer)
            logs = acc.result()
            logs.update({f"step_{k}": v for k, v in timer.summary().items()})

            vacc = _EpochMetrics()
            vbatches = Prefetcher(
                val_ds.batches(tcfg.batch_size, epoch=0, steps=val_steps,
                               num_workers=cfg.data.num_workers),
                depth=cfg.data.prefetch,
            )
            for images, masks in vbatches:
                images, masks = put((images, masks))
                vacc.update(eval_step(state, images, masks))
            logs.update(vacc.result(prefix="val_"))
            logs["epoch_time_sec"] = time.perf_counter() - t0

            state = cb_list.on_epoch_end(epoch, logs, state)
            for k, v in logs.items():
                history.setdefault(k, []).append(float(v))
            if verbose:
                msg = " - ".join(
                    f"{k}: {v:.4f}" for k, v in logs.items()
                    if k in ("loss", "dice_coef", "mean_io_u", "val_loss", "val_dice_coef",
                             "val_mean_io_u", "val_mean_io_u_thresh")
                )
                print(f"Epoch {epoch + 1}/{tcfg.epochs} [{logs['epoch_time_sec']:.1f}s] {msg}")

            if lead:
                ckpt_lib.write_meta(out_dir, {
                    "epoch": epoch,
                    "monitor": tcfg.monitor,
                    "mode": tcfg.monitor_mode,
                    "callbacks": cb_list.state_dict(),
                    "learning_rate": state.learning_rate,
                    "config": cfg.to_dict(),
                })
            result.epochs_run = epoch + 1
            if cb_list.should_stop or stop_requested["flag"]:
                result.stopped_epoch = epoch
                break
    finally:
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
    for cb in cb_list.callbacks:
        if isinstance(cb, BestCheckpoint):
            result.best_score = cb.best
            result.best_epoch = cb.best_epoch
        if isinstance(cb, EarlyStopping) and cb.stopped_epoch >= 0:
            result.stopped_epoch = cb.stopped_epoch
    result.state = state
    return result
