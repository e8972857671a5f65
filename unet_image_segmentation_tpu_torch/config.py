"""Typed configuration system.

The port's own copy of ``unet_image_segmentation_tpu/config.py``: the same
dataclasses, defaults, ``from_dict``/``override`` rules and JSON format, so
every file under ``configs/`` loads into either package unchanged. Some
fields (``mesh``, ``rng_impl``, ``dropout_impl``) steer
parts of the JAX package the port does not run; they are kept so the two
packages read the same files.

The reference scatters its configuration across per-script argparse flags and
module-level constants (reference ``scripts/train.py:71-90``,
``scripts/inference.py:49-56``, ``scripts/benchmark.py:55-56``).  Here every
workload shares one typed :class:`Config` tree so the 256/512/1024 and
binary/multi-class variants are *data*, not code edits.

Defaults mirror the reference exactly:

* image size 256x256x3 (``train.py:84-88``), binary head (``train.py:90``)
* AdamW lr 2e-3, weight-decay 1e-4 (``train.py:73-74``), epochs 30, batch 2
* global seed 2301 (``train.py:77``), dataset-split seed 230
  (``download_dataset_midv.py:34``)
* monitor ``val_mean_io_u`` / mode max (``train.py:264-265``); early-stop
  patience 10, ReduceLROnPlateau factor 0.2 / patience 3 / min-lr 1e-6
  (``train.py:282-297``)
* inference threshold 0.5 + min contour area 100 (``inference.py:83-96``)
* benchmark IoU acceptance 0.9 / pred threshold 0.5 (``benchmark.py:76-86``)
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass
class ModelConfig:
    """U-Net architecture knobs (reference ``model/u_net.py:28-52``)."""

    image_height: int = 256
    image_width: int = 256
    image_channels: int = 3
    num_classes: int = 1
    filters: Tuple[int, ...] = (64, 128, 256, 512)
    dropout_rate: float = 0.2
    use_batch_norm: bool = True
    # 'separable' = SeparableConv2D blocks (reference default);
    # 'full' = plain Conv2D blocks (BASELINE.json configs[2] variant).
    conv_type: str = "separable"
    # Compute dtype for activations. Params are always float32.
    # float32 is the parity mode.
    compute_dtype: str = "float32"
    # Use the Pallas fused sepconv+BN+ReLU kernel where available.
    use_pallas: bool = False
    # Training dropout mask generator: 'rng' = stateful threefry PRNG
    # (flax nn.Dropout, reference-style); 'hash' = stateless position-hash
    # (ops/hash_dropout.py) — fused into the Pallas training chains and
    # bit-reproducible across the Pallas/XLA paths; 'auto' = 'hash'
    # whenever the fused chains are active, else 'rng'.  Same per-element
    # Bernoulli(rate) distribution either way (reference model/u_net.py:75-99).
    dropout_impl: str = "auto"
    # Fused segmentation-head kernel policy (ops/fused_head.py): 'auto'
    # engages it for the sigmoid head only (num_classes == 1); the softmax
    # head keeps the composed sums unless 'all' is set.  'off' disables
    # the kernel for the sigmoid head too (A/B lever).  Loss/metric values
    # are path-independent either way.
    fused_head: str = "auto"

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        return (self.image_height, self.image_width, self.image_channels)


@dataclass
class DataConfig:
    """Dataset directory contract (reference ``scripts/train.py:79-82``)."""

    root: str = "dataset/train"
    train_frames: str = "train_frames/image"
    train_masks: str = "train_masks/image"
    val_frames: str = "val_frames/image"
    val_masks: str = "val_masks/image"
    # Paired augmentation: horizontal flip only, like the reference
    # (``train.py:169-175``). Images bilinear-resized, masks nearest
    # (``train.py:187-206``).
    horizontal_flip: bool = True
    rescale: float = 1.0 / 255.0
    # 'binary' = /255 float masks (reference); 'class_id' = integer labels
    # for the multi-class configs (BASELINE configs[3]).
    mask_mode: str = "binary"
    shuffle_train: bool = True
    shuffle_val: bool = False
    num_workers: int = 8
    prefetch: int = 4
    # Auto-pack the directory dataset on first epoch (data/autopack.py):
    # decode once, then serve every later epoch from the mmap'd packed
    # reader instead of re-decoding (the reference's
    # ImageDataGenerator re-decodes every epoch, train.py:182-206).
    # The cache lands in <data root>/.unet_tpu_pack/ (or pack_dir /
    # <model_out>/.unet_tpu_pack/ when the dataset dir is read-only) and
    # is keyed on a content signature, so dataset edits re-pack.
    auto_pack: bool = True
    pack_dir: Optional[str] = None


@dataclass
class TrainConfig:
    epochs: int = 30
    batch_size: int = 2
    learning_rate: float = 2e-3
    weight_decay: float = 1e-4
    seed: int = 2301
    loss: str = "dice"  # dice | iou | jaccard | bce
    model_out: str = "./models/model"  # orbax checkpoint directory
    monitor: str = "val_mean_io_u"
    monitor_mode: str = "max"
    early_stop_patience: int = 10
    restore_best_weights: bool = True
    reduce_lr_factor: float = 0.2
    reduce_lr_patience: int = 3
    min_lr: float = 1e-6
    log_dir: str = "./logs"
    histogram_freq: int = 1
    # New capability vs the reference: resume mid-run from a checkpoint.
    resume: bool = False
    # Steps between async checkpoint keep-alives; 0 = per-epoch only.
    checkpoint_every_steps: int = 0
    # When set, trace the first profile_steps train steps of the first epoch
    # into this directory (the port: a torch.profiler Chrome trace; the JAX
    # package: a jax.profiler trace), then finish the epoch untraced.
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    # JAX PRNG implementation for the JAX package's dropout masks ('rbg',
    # 'threefry2x32' or None). The port's dropout is the position hash and
    # does not read it; it is kept so both packages read the same files.
    rng_impl: Optional[str] = "rbg"


@dataclass
class InferConfig:
    threshold: float = 0.5
    min_contour_area: float = 100.0
    output_mask: str = "./outputs_test/output_mask.png"
    output_cropped: str = "./outputs_test/output_cropped.png"
    # 'bbox' = reference scripts/inference.py crop; 'warp' = the
    # provided-but-unwired utils/image.py quad perspective warp.
    crop_mode: str = "bbox"


@dataclass
class EvalConfig:
    iou_threshold: float = 0.9
    pred_threshold: float = 0.5
    batch_size: int = 8  # the reference evaluates batch=1; we batch.
    default_gt_size: Tuple[int, int] = (2048, 2048)  # benchmark.py:131-133
    image_glob: str = "*.tif"
    low_score_log: Optional[str] = None


@dataclass
class MeshConfig:
    """Device-mesh layout.

    ``data`` shards the batch (DP gradients all-reduce over ICI);
    ``spatial`` shards image rows for halo-exchange high-res configs.
    Axis size -1 means "all remaining devices".
    """

    data_axis: int = -1
    spatial_axis: int = 1
    axis_names: Tuple[str, str] = ("data", "spatial")


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ---- serialization ----
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(tp, sub):
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(f"Unknown config key {tp.__name__}.{k}")
                ft = fields[k].type
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
                del ft
            return tp(**kwargs)

        sections = {
            "model": ModelConfig,
            "data": DataConfig,
            "train": TrainConfig,
            "infer": InferConfig,
            "eval": EvalConfig,
            "mesh": MeshConfig,
        }
        kwargs = {}
        for name, tp in sections.items():
            if name in d:
                kwargs[name] = build(tp, d[name])
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def override(self, **dotted: Any) -> "Config":
        """Return a new Config with ``section__key=value`` overrides.

        e.g. ``cfg.override(train__batch_size=32, model__num_classes=3)``.
        """
        d = self.to_dict()
        for key, value in dotted.items():
            section, _, leaf = key.partition("__")
            if not leaf or section not in d:
                raise KeyError(f"Bad override {key!r}")
            if leaf not in d[section]:
                raise KeyError(f"Unknown config key {section}.{leaf}")
            d[section][leaf] = value
        return Config.from_dict(d)


# Dataset-preparation seed, distinct from the training seed
# (reference download_dataset_midv.py:34 uses 230 for the 70/20/10 split).
SPLIT_SEED = 230
