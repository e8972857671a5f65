"""The binary 256 px trained-quality gate of the port, on the card.

Port of ``unet_image_segmentation_tpu/troubleshoot/quality_gate_256.py``
with its protocol unchanged: 256 px ``style='hard'`` synthetic scenes
(clutter, occlusion, perspective; ``data/synthetic.py``), 64 train and 128
val, batch 2, 24 epochs = 768 steps (768 BatchNorm running-statistic
updates at momentum 0.99), BatchNorm on, dropout 0, no flips, the product
path (``use_pallas=True``: the fused training chains K1-K6 each step, K8 in
every validation and predict forward), fp32, seeds (2301, 7, 23, 42). The
thresholded IoU of the 128 val images, predicted from ``fit``'s final
state, is held to the JAX package's recorded ``QUALITY_256.json``: the
gate passes when the port's mean over the seeds is at least the JAX mean
minus 0.005 (the project's 0.5% MeanIoU gate).

The card's machine has no cv2, which draws the scenes, so the stages are
split by machine:

* ``data`` (where cv2 is): renders the scenes with the port's copy of
  ``data/synthetic.py`` at the data seed 230, packs each split through
  :class:`..data.loader.DirectoryDataset` (``shuffle=False``) and
  :func:`..data.packed.pack_directory_dataset` into
  ``<workdir>/packs/{train,val}.upk``, and writes ``<workdir>/stamp.json``:
  the protocol it ran, the style, cv2's version, the record counts and each
  pack's SHA-256. The hard packs of the gate's protocol must have the
  digests of :data:`SCENE_SHA256`, those of the JAX package's own data
  path (held by the tests).
* ``torch`` (on the card; ``--device cpu`` only for tests): refuses packs
  whose protocol, digests or scenes differ from the stamp and from
  :data:`SCENE_SHA256`, then for each seed runs ``fit`` on
  :class:`..data.packed.PackedDataset`\\ s of the packs (their shuffle and
  seed those ``make_loaders`` gives the directory datasets, so the batches
  are the JAX run's), predicts the val images in batches of 8 through
  ``make_predict_fn`` and scores them (and, as a diagnostic beside that
  score, the same weights with their BatchNorm statistics recalibrated on
  the train images); writes
  ``<workdir>/torch_results.json`` (``--composed``: the same protocol with
  ``use_pallas=False``, ``torch_results_composed.json``). TF32 is off.
  ``--extra-seeds N`` runs N more seeds (:func:`extra_seeds`) after the
  protocol's, into ``torch_results_extra.json`` (the composed leg's
  ``torch_results_extra_composed.json``): the spread of the final epoch's
  IoU, which the four seeds of the gate cannot resolve. They never enter
  the gate's results. ``--composed --products tf32|bf16x1`` runs the
  composed leg at another product precision (:mod:`.products`: TF32, or one
  bf16 pass a product as XLA computes fp32 on a TPU) into files of its own
  (:func:`results_name`); a diagnostic, never the gate's.
* ``report`` (anywhere): ``QUALITY_256_TORCH.json`` beside the JAX
  record, its setup copied from the stamp and the results; with extra
  seeds also ``QUALITY_256_TORCH_SEEDS.json``, every seed's final and
  recalibrated IoU and its BatchNorm diagnostics.
* ``products`` (anywhere): ``QUALITY_256_TORCH_PRODUCTS.json``, each leg's
  spread over its seeds (the kernel leg's from
  ``QUALITY_256_TORCH_SEEDS.json``, the composed legs' at each product
  precision from the workdir) and the verdict of :func:`products_verdict`.

The 3-class gate (``quality_gate_512mc.py``) runs on the same stages with a
:class:`Protocol` of class-id masks and ``cce`` and its own :class:`Scoring`.

There is no TF stage: the TF reference checkout is not part of this
repository and the card has no TF.

Usage::

    python -m unet_image_segmentation_tpu_torch.troubleshoot.quality_gate_256 \\
        --workdir build/q256 --stage data               # where cv2 is
    python -m ... --workdir build/q256 --stage torch [--composed]  # on the card
    python -m ... --workdir build/q256 --stage torch --extra-seeds 12  # and 12 more
    python -m ... --workdir build/q256 --stage report   # QUALITY_256_TORCH.json
    python -m ... --workdir build/q256 --stage torch --composed --products bf16x1 \\
        --extra-seeds 12                                # a diagnostic leg on the card
    python -m ... --workdir build/q256 --stage products  # QUALITY_256_TORCH_PRODUCTS.json
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

HW = 256
BATCH = 2  # the reference default (scripts/train.py:72)
N_TRAIN, N_VAL = 64, 128
STEPS_PER_EPOCH = N_TRAIN // BATCH  # 32
EPOCHS = 24  # 24 * 32 = 768 BN updates
SEEDS = (2301, 7, 23, 42)
DATA_SEED = 230          # write_synthetic_dataset's default, as the JAX gate ran it
PREDICT_BATCH = 8
GATE = 0.005             # 0.5% MeanIoU (reference scripts/benchmark.py:277-279)

# The packs of the gate's protocol with style 'hard', as the data stage and
# the JAX package's write_synthetic_dataset + pack_directory_dataset write them.
SCENE_SHA256 = {
    "train": "08dec93b8a44a8c75ed1ecae2ce0c2a2b24892e033ab49569b7c082f08dd6ca0",
    "val": "ec90cb674e4f7f71b94ace812a47dfdf17d70b4f1d619d061c9df89978e7e0cc",
}

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REFERENCE = os.path.join(ROOT, "QUALITY_256.json")
SPLITS = ("train", "val")
STAMP = "stamp.json"
RESULTS = {False: "torch_results.json", True: "torch_results_composed.json"}
RESULTS_EXTRA = "torch_results_extra.json"
GATE_REPORT = os.path.join(ROOT, "QUALITY_256_TORCH.json")
SEEDS_REPORT = os.path.join(ROOT, "QUALITY_256_TORCH_SEEDS.json")
DROP, DROP_AFTER = 0.05, 10   # a late drop: val MeanIoU falls by > 0.05 after epoch 10


@dataclasses.dataclass(frozen=True)
class Protocol:
    """What a gate run trains and scores; the stamp records it."""

    image_size: int = HW
    batch: int = BATCH
    n_train: int = N_TRAIN
    n_val: int = N_VAL
    epochs: int = EPOCHS
    seeds: Tuple[int, ...] = SEEDS
    data_seed: int = DATA_SEED
    num_classes: int = 1
    mask_mode: str = "binary"
    loss: str = "dice"   # the default config's: the binary gate sets no loss

    def to_dict(self) -> dict:
        """The stamp's record; a binary protocol's leaves out the three
        fields it shares with the default config, as the binary gate's stamp
        always has."""
        d = {**dataclasses.asdict(self), "seeds": list(self.seeds)}
        if (self.num_classes, self.mask_mode, self.loss) == (1, "binary", "dice"):
            for k in ("num_classes", "mask_mode", "loss"):
                del d[k]
        return d


GATE_PROTOCOL = Protocol()


def extra_seeds(n: int) -> Tuple[int, ...]:
    """The seeds of ``--extra-seeds n``: 101..100+n, none a protocol seed."""
    return tuple(range(101, 101 + n))


def results_name(composed: bool, products: str = "fp32", extra: bool = False) -> str:
    """The results file of a leg: :data:`RESULTS` (``extra``:
    :data:`RESULTS_EXTRA`, the composed leg's with ``_composed``) at fp32,
    ``torch_results[_extra]_composed_<products>.json`` at another precision."""
    if products != "fp32":
        return f"torch_results{'_extra' if extra else ''}_composed_{products}.json"
    if not extra:
        return RESULTS[composed]
    return "torch_results_extra_composed.json" if composed else RESULTS_EXTRA


def _thresholded_iou(y_true: np.ndarray, y_prob: np.ndarray, thr: float = 0.5) -> float:
    p = (y_prob > thr).astype(np.float32)
    t = (y_true > 0.5).astype(np.float32)
    inter = (p * t).sum()
    union = p.sum() + t.sum() - inter
    return float((inter + 1e-7) / (union + 1e-7))


@dataclasses.dataclass(frozen=True)
class Scoring:
    """How a seed's final weights are scored: the predict batch, what is kept
    of each predicted batch (``post``), and the scores of the kept
    predictions against the masks; ``key`` names the headline score."""

    predict_batch: int
    score: Callable[[np.ndarray, np.ndarray], Dict[str, object]]
    key: str
    post: Optional[Callable[[np.ndarray], np.ndarray]] = None


BINARY_SCORING = Scoring(PREDICT_BATCH, lambda y, p: {"val_iou": _thresholded_iou(y, p)},
                         "val_iou")


def late_drops(values, size: float = DROP, after: int = DROP_AFTER) -> int:
    """Epoch-to-epoch falls of more than ``size`` into an epoch past ``after``."""
    return sum(1 for i in range(max(after, 1), len(values)) if values[i - 1] - values[i] > size)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def pack_path(workdir: str, split: str) -> str:
    return os.path.join(workdir, "packs", f"{split}.upk")


def write_stamp(workdir: str, protocol: Protocol, style: str,
                cv2_version: Optional[str]) -> dict:
    """``<workdir>/stamp.json`` for the packs under ``<workdir>/packs``."""
    from unet_image_segmentation_tpu_torch.data.packed import PackedDataset

    records = {}
    for split in SPLITS:
        ds = PackedDataset(pack_path(workdir, split), shuffle=False, force_numpy=True)
        records[split] = [int(ds.n), int(ds.h), int(ds.w), int(ds.img_c), int(ds.mask_c)]
    stamp = {
        "protocol": protocol.to_dict(),
        "style": style,
        "cv2": cv2_version,
        "records": records,   # n, h, w, image channels, mask channels
        "sha256": {split: sha256_file(pack_path(workdir, split)) for split in SPLITS},
    }
    with open(os.path.join(workdir, STAMP), "w") as f:
        json.dump(stamp, f, indent=2)
    return stamp


def stage_data(workdir: str, style: str = "hard", protocol: Protocol = GATE_PROTOCOL,
               pinned: Optional[Dict[str, str]] = None) -> dict:
    """Render, pack and stamp the scenes (needs cv2): binary masks with
    ``write_synthetic_dataset``, class-id masks with
    ``write_synthetic_multiclass_dataset``."""
    import cv2

    from unet_image_segmentation_tpu_torch.data import synthetic
    from unet_image_segmentation_tpu_torch.data.loader import DirectoryDataset
    from unet_image_segmentation_tpu_torch.data.packed import pack_directory_dataset

    root = os.path.join(workdir, "ds")
    hw = protocol.image_size
    kw = dict(n_train=protocol.n_train, n_val=protocol.n_val, image_size=(hw, hw),
              seed=protocol.data_seed, style=style)
    if protocol.mask_mode == "class_id":
        synthetic.write_synthetic_multiclass_dataset(root, num_classes=protocol.num_classes, **kw)
    else:
        synthetic.write_synthetic_dataset(root, **kw)
    os.makedirs(os.path.join(workdir, "packs"), exist_ok=True)
    for split in SPLITS:
        ds = DirectoryDataset(
            frames_dir=os.path.join(root, f"{split}_frames", "image"),
            masks_dir=os.path.join(root, f"{split}_masks", "image"),
            image_size=(hw, hw),
            shuffle=False,
            mask_mode=protocol.mask_mode,
        )
        pack_directory_dataset(ds, pack_path(workdir, split))
    stamp = write_stamp(workdir, protocol, style, cv2.__version__)
    _check_scenes(stamp, _pinned(protocol, pinned), style)
    print(f"synthetic {hw}px {style} scenes ({protocol.n_train} train / {protocol.n_val} val, "
          f"{protocol.mask_mode} masks, cv2 {cv2.__version__}) packed under "
          f"{os.path.join(workdir, 'packs')}: {json.dumps(stamp['sha256'])}")
    return stamp


def _pinned(protocol: Protocol, pinned: Optional[Dict[str, str]]) -> Optional[Dict[str, str]]:
    """The digests a protocol's hard scenes must have: ``pinned``, else
    :data:`SCENE_SHA256` for the binary gate's protocol, else none."""
    if pinned is not None:
        return pinned
    return SCENE_SHA256 if protocol == GATE_PROTOCOL else None


def _check_scenes(stamp: dict, pinned: Optional[Dict[str, str]], style: str) -> None:
    if style != "hard" or pinned is None:
        return
    for split in SPLITS:
        if stamp["sha256"][split] != pinned[split]:
            raise ValueError(
                f"the {split} pack's SHA-256 {stamp['sha256'][split]} is not the gate's scenes' "
                f"{pinned[split]} (cv2 {stamp.get('cv2')}): the scenes differ from the "
                "JAX gate's data")


def check_inputs(workdir: str, protocol: Protocol = GATE_PROTOCOL,
                 pinned: Optional[Dict[str, str]] = None) -> dict:
    """The stamp, once its protocol, the packs' digests and (for a gate's
    hard scenes) the pinned digests (``pinned``, or :data:`SCENE_SHA256`
    for the binary gate) all agree; raises ``ValueError`` otherwise."""
    path = os.path.join(workdir, STAMP)
    if not os.path.exists(path):
        raise ValueError(f"no {STAMP} under {workdir}: run the data stage first")
    with open(path) as f:
        stamp = json.load(f)
    if stamp.get("protocol") != protocol.to_dict():
        raise ValueError(f"the stamp's protocol {stamp.get('protocol')} is not this run's "
                         f"{protocol.to_dict()}")
    want = {"train": protocol.n_train, "val": protocol.n_val}
    for split in SPLITS:
        n, h, w = stamp["records"][split][:3]
        if (n, h, w) != (want[split], protocol.image_size, protocol.image_size):
            raise ValueError(f"the stamp's {split} records {stamp['records'][split]} do not fit "
                             f"the protocol {protocol.to_dict()}")
        got = sha256_file(pack_path(workdir, split))
        if got != stamp["sha256"][split]:
            raise ValueError(f"{pack_path(workdir, split)}: SHA-256 {got} is not the stamp's "
                             f"{stamp['sha256'][split]}")
    _check_scenes(stamp, _pinned(protocol, pinned), stamp.get("style"))
    return stamp


def gate_config(protocol: Protocol, seed: int, out_dir: str, use_pallas: bool = True,
                overrides: Optional[dict] = None):
    """The JAX gate's overrides of the default config (its ``stage_jax``)."""
    from unet_image_segmentation_tpu_torch.config import Config

    hw = protocol.image_size
    return Config().override(
        model__image_height=hw, model__image_width=hw,
        model__num_classes=protocol.num_classes, data__mask_mode=protocol.mask_mode,
        train__loss=protocol.loss,
        model__use_batch_norm=True, model__dropout_rate=0.0,
        model__use_pallas=use_pallas,
        data__num_workers=4, data__horizontal_flip=False,
        train__epochs=protocol.epochs, train__batch_size=protocol.batch, train__seed=seed,
        train__model_out=os.path.join(out_dir, f"model{seed}"),
        train__log_dir=os.path.join(out_dir, f"logs{seed}"),
        train__early_stop_patience=1000,
        train__reduce_lr_patience=1000,  # bare-Keras run: no LR schedule
        **(overrides or {}),
    )


def gate_datasets(workdir: str, cfg):
    """(train, val) :class:`..data.packed.PackedDataset`\\ s of the packs with
    the flips, shuffles and seed ``make_loaders(cfg)`` gives the directory
    datasets."""
    from unet_image_segmentation_tpu_torch.data.packed import PackedDataset

    d = cfg.data
    train = PackedDataset(pack_path(workdir, "train"), horizontal_flip=d.horizontal_flip,
                          shuffle=d.shuffle_train, seed=cfg.train.seed)
    val = PackedDataset(pack_path(workdir, "val"), horizontal_flip=False,
                        shuffle=d.shuffle_val, seed=cfg.train.seed)
    return train, val


def split_arrays(workdir: str, split: str) -> Tuple[np.ndarray, np.ndarray]:
    """Every record of a split in file order: (images, masks) as the loaders give them."""
    from unet_image_segmentation_tpu_torch.data.packed import PackedDataset

    ds = PackedDataset(pack_path(workdir, split), shuffle=False)
    return next(ds.batches(len(ds)))


def _predict(model, images: np.ndarray, device, scoring: Scoring = BINARY_SCORING
             ) -> Tuple[np.ndarray, Dict[str, int]]:
    """The predictions of ``images`` in batches of ``scoring.predict_batch``
    through ``make_predict_fn`` (each kept through ``scoring.post``), and the
    launches of the first batch."""
    import torch

    from unet_image_segmentation_tpu_torch.train.steps import make_predict_fn

    predict = make_predict_fn(model)
    out = []
    n = scoring.predict_batch
    for i in range(0, len(images), n):
        if i == 0:
            _reset_counts()
        p = predict(torch.from_numpy(images[i:i + n]).to(device)).float().cpu().numpy()
        out.append(scoring.post(p) if scoring.post else p)
        if i == 0:
            first = _counts()
    return np.concatenate(out), first


def recalibrated(model, cfg, workdir: str, device, xva: np.ndarray, yva: np.ndarray,
                 scoring: Scoring = BINARY_SCORING) -> Tuple[Dict[str, object], Dict[str, float]]:
    """A diagnostic beside the gate's score: the scores of the same weights
    with every BatchNorm's running statistics replaced by the moments of
    its input over the train images (``recalibrate_batch_norm``, composed
    path), which tells stale running statistics apart from the weights; and
    for each BatchNorm the channel mean of ``log(running var / recalibrated
    var)``."""
    import torch

    from unet_image_segmentation_tpu_torch.models.layers import BatchNorm
    from unet_image_segmentation_tpu_torch.models.unet import build_unet, recalibrate_batch_norm

    twin = build_unet(dataclasses.replace(cfg.model, use_pallas=False), device=device)
    twin.load_state_dict(model.state_dict())
    bns = {name: m for name, m in twin.named_modules() if isinstance(m, BatchNorm)}
    running = {name: bn.var.clone() for name, bn in bns.items()}
    xtr, _ = split_arrays(workdir, "train")
    with torch.no_grad():
        recalibrate_batch_norm(twin, torch.from_numpy(xtr).to(device))
    log_var = {name: float(torch.log(running[name].clamp_min(1e-12) / bn.var.clamp_min(1e-12))
                           .mean()) for name, bn in bns.items()}
    scores = scoring.score(yva, _predict(twin, xva, device, scoring)[0])
    return scores, log_var


def _counts() -> Dict[str, int]:
    from unet_image_segmentation_tpu_torch.ops import (
        fused_head,
        fused_sepconv,
        fused_train,
        fused_upconcat,
    )

    return {**fused_train.LAUNCHES, **fused_upconcat.LAUNCHES, **fused_head.LAUNCHES,
            "sepconv_block": fused_sepconv.LAUNCHES["sepconv_block"]}


def _reset_counts() -> None:
    from unet_image_segmentation_tpu_torch.ops import (
        fused_head,
        fused_sepconv,
        fused_train,
        fused_upconcat,
    )

    for mod in (fused_train, fused_upconcat, fused_head, fused_sepconv):
        mod.reset_launch_counts()


def run_seed(cfg, workdir: str, device, xva: np.ndarray, yva: np.ndarray, state=None,
             verbose: bool = True, scoring: Scoring = BINARY_SCORING) -> dict:
    """One seed: ``fit`` on the packs, then the scores of its final state,
    beside those of the same weights with recalibrated BatchNorm statistics
    (``stale_gap``: recalibrated minus final headline score).

    Launches: each kernel's count over the fit's train steps (K1-K6, K11)
    and validation forwards (K8), divided by their number, then K8's over
    the first predict batch."""
    import torch

    from unet_image_segmentation_tpu_torch.models.unet import resolve_device
    from unet_image_segmentation_tpu_torch.train.loop import fit

    device = resolve_device(device)
    train_ds, val_ds = gate_datasets(workdir, cfg)
    _reset_counts()
    t0 = time.perf_counter()
    result = fit(cfg, train_ds, val_ds, state=state, device=device, verbose=verbose)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_fit = time.perf_counter() - t0
    fit_counts = _counts()
    steps = int(result.state.step)
    val_forwards = result.epochs_run * max(1, len(val_ds) // cfg.train.batch_size)
    preds, predict_counts = _predict(result.state.model, xva, device, scoring)
    seconds = time.perf_counter() - t0
    scores = scoring.score(yva, preds)
    recal, log_var = recalibrated(result.state.model, cfg, workdir, device, xva, yva, scoring)
    per_step = {k: v / max(steps, 1) for k, v in fit_counts.items() if k != "sepconv_block"}
    history = result.history
    return {
        **scores,
        **{f"{k}_bn_recalibrated": v for k, v in recal.items()},
        "stale_gap": recal[scoring.key] - scores[scoring.key],
        "bn_log_var_ratio": log_var,
        "late_drops": late_drops(history.get("val_mean_io_u_thresh", [])),
        "val_mean_io_u_per_epoch": history.get("val_mean_io_u", []),
        "val_mean_io_u_thresh_per_epoch": history.get("val_mean_io_u_thresh", []),
        "loss_per_epoch": result.history.get("loss", []),
        "epoch_seconds": result.history.get("epoch_time_sec", []),
        "step_mean_ms_per_epoch": result.history.get("step_mean_ms", []),
        "best_epoch": int(result.best_epoch),
        "epochs": int(result.epochs_run),
        "steps": steps,
        "seconds": seconds,
        "fit_seconds": t_fit,
        "launches_per_step": per_step,
        "launches_per_val_forward": fit_counts["sepconv_block"] / max(val_forwards, 1),
        "launches_first_predict": {"sepconv_block": predict_counts["sepconv_block"]},
        "native_loader": bool(train_ds.native and val_ds.native),
    }


def stage_torch(workdir: str, device="cuda", composed: bool = False,
                protocol: Protocol = GATE_PROTOCOL, overrides: Optional[dict] = None,
                verbose: bool = True, extra: int = 0, scoring: Scoring = BINARY_SCORING,
                pinned: Optional[Dict[str, str]] = None, seeds: Optional[Tuple[int, ...]] = None,
                out_name: Optional[str] = None, products: str = "fp32") -> dict:
    """Every seed of the protocol (or ``seeds``) through ``fit`` on the
    device; writes the results to ``out_name`` (default
    :func:`results_name` of the leg) and returns them. ``extra`` > 0 then
    runs :func:`extra_seeds` into the leg's extra file. ``products`` other
    than ``fp32`` (:mod:`.products`) runs only with ``composed``."""
    import torch

    from unet_image_segmentation_tpu_torch.models.unet import resolve_device
    from unet_image_segmentation_tpu_torch.troubleshoot.products import product_precision

    if products != "fp32" and not composed:
        raise ValueError(f"--products {products} runs on the composed leg only (--composed): "
                         "the kernels' fp32 bodies have no reduced-precision mode")
    device = resolve_device(device)
    stamp = check_inputs(workdir, protocol, pinned)
    card = None
    if device.type == "cuda":
        from unet_image_segmentation_tpu_torch.troubleshoot.roofline import card as smi_card

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = smi_card()
    xva, yva = split_arrays(workdir, "val")
    leg = "composed" if composed else "kernels"
    results = None
    runs = [(seeds or protocol.seeds, out_name or results_name(composed, products))]
    if extra:
        runs.append((extra_seeds(extra), results_name(composed, products, extra=True)))
    precision = {"fp32": ", fp32, TF32 off", "tf32": ", fp32 with TF32 products",
                 "bf16x1": ", fp32 with one bf16 pass a product (operands rounded to bf16, "
                           "the depthwise fp32)"}[products]
    tag = leg if products == "fp32" else f"{leg} {products}"
    for run_seeds, name in runs:
        res = {
            "leg": leg,
            "path": ("use_pallas=False (composed PyTorch ops)" if composed else
                     "use_pallas=True (fused training chains K1-K6, K8 forwards)") + precision,
            "products": products,
            "protocol": stamp["protocol"],
            "style": stamp["style"],
            "sha256": stamp["sha256"],
            "overrides": overrides or {},
            "device": str(device),
            "card": card,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "seeds": {},
        }
        for seed in run_seeds:
            cfg = gate_config(protocol, seed, os.path.join(workdir, leg),
                              use_pallas=not composed, overrides=overrides)
            res["fused_head"] = cfg.model.fused_head
            with product_precision(products):
                rec = run_seed(cfg, workdir, device, xva, yva, verbose=verbose, scoring=scoring)
            res["seeds"][str(seed)] = rec
            key = scoring.key
            print(f"torch {tag} seed {seed}: {key} {rec[key]:.4f} (BatchNorm statistics "
                  f"recalibrated on the train images: {rec[key + '_bn_recalibrated']:.4f}; "
                  f"stale gap {rec['stale_gap']:+.4f}, {rec['late_drops']} late drops), best "
                  f"epoch {rec['best_epoch']}, {rec['steps']} steps in {rec['seconds']:.1f} s, "
                  f"launches a step {rec['launches_per_step']}, K8 a val forward "
                  f"{rec['launches_per_val_forward']}, native loader {rec['native_loader']}"
                  + (f" [{card}]" if card else ""), flush=True)
            with open(os.path.join(workdir, name), "w") as f:
                json.dump(res, f, indent=2)
        results = results or res
    return results


def _leg_summary(res: dict, reference: dict) -> dict:
    seeds = [s for s in reference["setup"]["seeds"] if str(s) in res["seeds"]]
    jax_iou = dict(zip(reference["setup"]["seeds"], reference["val_iou_jax_per_seed"]))
    ious = [res["seeds"][str(s)]["val_iou"] for s in seeds]
    deltas = [v - jax_iou[s] for v, s in zip(ious, seeds)]
    delta_std = float(np.std(deltas, ddof=1)) if len(deltas) > 1 else None
    mean = float(np.mean(ious))
    return {
        "path": res["path"],
        "seeds": seeds,
        "val_iou_torch_per_seed": ious,
        "val_iou_torch_mean": mean,
        "val_iou_bn_recalibrated_per_seed": [res["seeds"][str(s)]["val_iou_bn_recalibrated"]
                                             for s in seeds],
        "stale_gap_per_seed": [res["seeds"][str(s)].get("stale_gap") for s in seeds],
        "late_drops_per_seed": [res["seeds"][str(s)].get("late_drops") for s in seeds],
        "torch_seed_spread": max(ious) - min(ious),
        "delta": mean - reference["val_iou_jax_mean"],
        "delta_per_seed": deltas,
        "delta_std": delta_std,
        "delta_sem": delta_std / float(np.sqrt(len(deltas))) if delta_std is not None else None,
        "within_gate": bool(mean >= reference["val_iou_jax_mean"] - GATE),
        "val_mean_io_u_per_epoch": {str(s): res["seeds"][str(s)]["val_mean_io_u_per_epoch"]
                                    for s in seeds},
        "best_epoch": {str(s): res["seeds"][str(s)]["best_epoch"] for s in seeds},
        "steps": {str(s): res["seeds"][str(s)]["steps"] for s in seeds},
        "seconds": {str(s): res["seeds"][str(s)]["seconds"] for s in seeds},
        "launches_per_step": res["seeds"][str(seeds[0])]["launches_per_step"],
        "launches_per_val_forward": res["seeds"][str(seeds[0])]["launches_per_val_forward"],
        "launches_first_predict": res["seeds"][str(seeds[0])]["launches_first_predict"],
        "native_loader": all(res["seeds"][str(s)]["native_loader"] for s in seeds),
    }


def stage_report(workdir: str, out: str, reference_path: str = REFERENCE) -> dict:
    """``out`` from the stamp, the results and the JAX record (read only)."""
    with open(os.path.join(workdir, STAMP)) as f:
        stamp = json.load(f)
    with open(reference_path) as f:
        reference = json.load(f)
    legs = {}
    for composed, name in RESULTS.items():
        path = os.path.join(workdir, name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            res = json.load(f)
        if res["sha256"] != stamp["sha256"] or res["protocol"] != stamp["protocol"]:
            raise ValueError(f"{name} was run on other packs or another protocol than "
                             f"{STAMP} records")
        legs[composed] = res
    if False not in legs:
        raise ValueError(f"no {RESULTS[False]} under {workdir}: run the torch stage first")
    kernels = legs[False]
    proto = stamp["protocol"]
    setup = {
        "image_size": proto["image_size"], "epochs": proto["epochs"], "batch": proto["batch"],
        "n_train": proto["n_train"], "n_val": proto["n_val"], "bn": True, "dropout": 0.0,
        "bn_updates": proto["epochs"] * (proto["n_train"] // proto["batch"]),
        "seeds": [int(s) for s in kernels["seeds"]],
        "protocol_seeds": proto["seeds"],
        "data_seed": proto["data_seed"],
        "scene_style": stamp["style"],
        "cv2": stamp["cv2"],
        "records": stamp["records"],
        "sha256": stamp["sha256"],
        "overrides": kernels["overrides"],
        "torch_path": kernels["path"],
        "device": kernels["device"],
        "card": kernels["card"],
        "torch": kernels["torch"],
        "cuda": kernels["cuda"],
        "jax_record": os.path.basename(reference_path),
        "jax_path": reference["setup"]["jax_path"],
        "gate": reference["setup"]["gate"] + ": within_gate = port mean >= JAX mean - "
                f"{GATE}",
        "tf_leg": "not run: the TF reference checkout is not in this repository and the card "
                  "has no TF; the JAX record's TF numbers are not compared",
    }
    summary = _leg_summary(kernels, reference)
    artifact = {
        "setup": setup,
        "val_iou_jax_per_seed": [dict(zip(reference["setup"]["seeds"],
                                          reference["val_iou_jax_per_seed"]))[s]
                                 for s in summary["seeds"]],
        "val_iou_jax_mean": reference["val_iou_jax_mean"],
        "jax_seed_spread": reference["jax_seed_spread"],
        **summary,
    }
    if True in legs:
        artifact["composed"] = _leg_summary(legs[True], reference)
    else:
        artifact["composed"] = {"not_run": f"no {RESULTS[True]} under the workdir"}
    with open(out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact, indent=2))
    extra = os.path.join(workdir, RESULTS_EXTRA)
    if os.path.exists(extra):
        with open(extra) as f:
            res = json.load(f)
        if res["sha256"] != stamp["sha256"] or res["protocol"] != stamp["protocol"]:
            raise ValueError(f"{RESULTS_EXTRA} was run on other packs or another protocol than "
                             f"{STAMP} records")
        seeds_report(kernels, res, reference, os.path.splitext(out)[0] + "_SEEDS.json")
    return artifact


def _mean_sem(values) -> dict:
    v = np.asarray(values, np.float64)
    std = float(np.std(v, ddof=1)) if len(v) > 1 else None
    return {"mean": float(v.mean()), "std": std,
            "sem": std / float(np.sqrt(len(v))) if std is not None else None}


def seeds_report(gate: dict, extra: dict, reference: dict, out: str) -> dict:
    """Every seed of the gate's results and of the extra seeds' (one leg):
    final and recalibrated IoU, the stale gap, late drops and each
    BatchNorm's log variance ratio, with their means over the seeds. Not a
    gate: the gate's fields stay in the gate's artifact."""
    runs = {**gate["seeds"], **extra["seeds"]}
    seeds = [int(s) for s in runs]
    per = {k: [runs[str(s)][k] for s in seeds]
           for k in ("val_iou", "val_iou_bn_recalibrated", "stale_gap", "late_drops")}
    names = list(runs[str(seeds[0])]["bn_log_var_ratio"])
    ratios = np.array([[runs[str(s)]["bn_log_var_ratio"][n] for n in names] for s in seeds])
    art = {
        "what": "the binary 256 px gate's protocol, kernels leg, on the gate's seeds and "
                f"{len(extra['seeds'])} more: the spread of the final weights' val IoU and how "
                "far the running BatchNorm statistics lag (a diagnostic; the gate is "
                "QUALITY_256_TORCH.json)",
        "leg": gate["leg"], "path": gate["path"], "card": gate["card"], "torch": gate["torch"],
        "cuda": gate["cuda"], "protocol": gate["protocol"], "sha256": gate["sha256"],
        "seeds": seeds,
        **{f"{k}_per_seed": v for k, v in per.items()},
        **{k: _mean_sem(v) for k, v in per.items()},
        "seeds_within_jax_mean_minus_gate": int(sum(
            v >= reference["val_iou_jax_mean"] - GATE for v in per["val_iou"])),
        "val_iou_jax_mean": reference["val_iou_jax_mean"],
        "drop": {"size": DROP, "after_epoch": DROP_AFTER},
        "bn_log_var_ratio_mean_over_seeds": dict(zip(names, ratios.mean(0).tolist())),
        "bn_log_var_ratio_mean": _mean_sem(ratios.mean(1)),
        "best_epoch_per_seed": [runs[str(s)]["best_epoch"] for s in seeds],
        "seconds_per_seed": [runs[str(s)]["seconds"] for s in seeds],
    }
    with open(out, "w") as f:
        json.dump(art, f, indent=2)
    print(f"{len(seeds)} seeds: val IoU {art['val_iou']}, recalibrated "
          f"{art['val_iou_bn_recalibrated']}, stale gap {art['stale_gap']} -> {out}")
    return art


REPRODUCES = 0.05   # a leg reproduces the records' 4 of 4 good endings when p^4 >= this


def _leg_spread(per: Dict[str, list], bar: float) -> dict:
    """One leg over its seeds, from per-seed lists: the final and
    recalibrated IoU, the stale gap, late drops and seconds, with their
    means; the share of seeds at ``bar``, ``p``, and whether ``p**4`` reaches
    :data:`REPRODUCES`."""
    n_at = int(sum(v >= bar for v in per["val_iou"]))
    share = n_at / len(per["val_iou"])
    return {
        **{f"{k}_per_seed": v for k, v in per.items()},
        **{k: _mean_sem(v) for k, v in per.items()},
        "seeds_at_bar": n_at,
        "share_at_bar": share,
        "share_at_bar_pow4": share ** 4,
        "reproduces_records": bool(share ** 4 >= REPRODUCES),
    }


def products_verdict(reproduces: Dict[str, bool]) -> str:
    """The rule, written before the legs ran: which leg reproduces the
    records' endings tells where the gap comes from."""
    reduced = [leg for leg in ("composed_bf16x1", "composed_tf32") if reproduces.get(leg)]
    if reproduces.get("composed_fp32") and not reproduces.get("kernels"):
        return ("kernels at fault: the composed fp32 leg reproduces the records' endings and "
                "the kernel leg does not")
    if reduced and not reproduces.get("composed_fp32"):
        return (f"reference property: {' and '.join(reduced)} reproduce the records' endings "
                "and composed fp32 does not; the records' 4 of 4 follow the TPU's product "
                "precision, and the port's gates stay fp32")
    if not any(reproduces.values()):
        return "open: no leg reproduces the records' endings"
    return "other: " + ", ".join(f"{k} {'reproduces' if v else 'does not'}"
                                 for k, v in reproduces.items())


def _seed_lists(runs: Dict[str, dict]) -> Dict[str, list]:
    keys = ("val_iou", "val_iou_bn_recalibrated", "stale_gap", "late_drops", "seconds")
    return {k: [rec[k] for rec in runs.values()] for k in keys}


def leg_runs(workdir: str, composed: bool, products: str, stamp: dict) -> Optional[dict]:
    """A leg's protocol and extra seeds from the workdir (None when neither
    file is there): ``{"seeds": {seed: record}, "card": ..., ...}``."""
    out = None
    for extra in (False, True):
        path = os.path.join(workdir, results_name(composed, products, extra))
        if not os.path.exists(path):
            continue
        with open(path) as f:
            res = json.load(f)
        if res["sha256"] != stamp["sha256"] or res["protocol"] != stamp["protocol"]:
            raise ValueError(f"{path} was run on other packs or another protocol than "
                             f"{STAMP} records")
        if out is None:
            out = {**res, "seeds": {}}
        out["seeds"].update(res["seeds"])
    return out


def products_report(workdir: str, out: str, reference_path: str = REFERENCE,
                    seeds_path: str = SEEDS_REPORT) -> dict:
    """``out``: the kernel leg's seeds (``seeds_path``) beside the composed
    legs at each product precision found in the workdir, each leg's share of
    seeds at the bar and :func:`products_verdict`. With the kernel leg's
    ``torch_results.json`` in the workdir, also whether its protocol seeds
    reproduce the gate's bits (:data:`GATE_REPORT`)."""
    from unet_image_segmentation_tpu_torch.troubleshoot.products import PRODUCTS

    with open(os.path.join(workdir, STAMP)) as f:
        stamp = json.load(f)
    with open(reference_path) as f:
        reference = json.load(f)
    with open(seeds_path) as f:
        kernels = json.load(f)
    bar = reference["val_iou_jax_mean"] - GATE
    per = {k: kernels[f"{k}_per_seed"] for k in
           ("val_iou", "val_iou_bn_recalibrated", "stale_gap", "late_drops", "seconds")}
    legs = {"kernels": {"path": kernels["path"], "card": kernels["card"], "source":
                        os.path.basename(seeds_path), "seeds": kernels["seeds"],
                        **_leg_spread(per, bar)}}
    for products in PRODUCTS:
        runs = leg_runs(workdir, True, products, stamp)
        if runs is None:
            continue
        legs[f"composed_{products}"] = {"path": runs["path"], "card": runs["card"],
                                        "seeds": [int(s) for s in runs["seeds"]],
                                        **_leg_spread(_seed_lists(runs["seeds"]), bar)}
    art = {
        "what": "the binary 256 px gate's protocol over 16 seeds a leg: the kernel leg and the "
                "composed leg at each product precision (fp32; TF32; bf16x1, one bf16 pass a "
                "product as XLA computes fp32 on a TPU). A diagnostic, not a gate: "
                "QUALITY_256_TORCH.json holds the gate",
        "protocol": stamp["protocol"], "sha256": stamp["sha256"],
        "bar": bar, "val_iou_jax_mean": reference["val_iou_jax_mean"],
        "val_iou_jax_per_seed": reference["val_iou_jax_per_seed"],
        "rule": f"a leg reproduces the records' endings when its share p of seeds at the bar "
                f"has p^4 >= {REPRODUCES} (8 or more of 16)",
        "legs": legs,
        "verdict": products_verdict({k: v["reproduces_records"] for k, v in legs.items()}),
    }
    fresh = leg_runs(workdir, False, "fp32", stamp)
    if fresh is not None:
        with open(GATE_REPORT) as f:
            gate = json.load(f)
        want = dict(zip(gate["seeds"], gate["val_iou_torch_per_seed"]))
        got = {int(s): r["val_iou"] for s, r in fresh["seeds"].items() if int(s) in want}
        art["kernel_protocol_seeds"] = {
            "card": fresh["card"], "val_iou": got,
            "same_bits_as_gate": all(got[s] == want[s] for s in got) and len(got) == len(want),
        }
    with open(out, "w") as f:
        json.dump(art, f, indent=2)
    for name, leg in legs.items():
        print(f"{name}: val IoU {leg['val_iou']}, {leg['seeds_at_bar']} of "
              f"{len(leg['seeds'])} at {bar:.4f} (p^4 {leg['share_at_bar_pow4']:.4g}), "
              f"recalibrated {leg['val_iou_bn_recalibrated']['mean']:.4f}")
    print(f"verdict: {art['verdict']} -> {out}")
    return art


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--stage", required=True,
                   choices=["data", "torch", "report", "all", "products"])
    p.add_argument(
        "--style", default="hard", choices=["easy", "hard"],
        help="scene difficulty of the data stage; 'hard' is the gate's (both stacks land "
        "well below IoU 1.0 so the 0.5%% gate can discriminate)",
    )
    p.add_argument("--out", default=GATE_REPORT)
    p.add_argument("--device", default="cuda",
                   help="the torch stage's device (the card; 'cpu' only for tests)")
    p.add_argument("--composed", action="store_true",
                   help="the torch stage with use_pallas=False, into its own results file")
    p.add_argument("--extra-seeds", type=int, default=0, metavar="N",
                   help=f"the torch stage then runs N more seeds into {RESULTS_EXTRA} (the "
                   "final IoU's spread; never the gate's results)")
    p.add_argument("--products", default="fp32", choices=["fp32", "tf32", "bf16x1"],
                   help="the composed leg's product precision: fp32 (the gate's), tf32, or "
                   "bf16x1 (one bf16 pass a product, as XLA computes fp32 on a TPU); a "
                   "diagnostic into files of its own, with --composed only")
    args = p.parse_args(argv)
    if args.products != "fp32" and not args.composed:
        p.error(f"--products {args.products} runs on the composed leg only: add --composed")
    os.makedirs(args.workdir, exist_ok=True)
    stages = ["data", "torch", "report"] if args.stage == "all" else [args.stage]
    for stage in stages:
        if stage == "data":
            stage_data(args.workdir, style=args.style)
        elif stage == "torch":
            stage_torch(args.workdir, device=args.device, composed=args.composed,
                        extra=args.extra_seeds, products=args.products)
        elif stage == "products":
            products_report(args.workdir, os.path.join(ROOT, "QUALITY_256_TORCH_PRODUCTS.json"))
        else:
            stage_report(args.workdir, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
