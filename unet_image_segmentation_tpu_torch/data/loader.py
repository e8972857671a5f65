"""Host-parallel data pipeline.

Replaces the reference's synchronous Keras ``ImageDataGenerator`` path
(reference ``scripts/train.py:169-220``) with a thread-pool decode +
prefetch queue feeding the device.  Behavioural contract preserved:

* directory layout ``dataset/train/{train,val}_{frames,masks}/image/``
  (``train.py:79-82``); image/mask pairing is positional over the sorted
  file listing with a shared shuffle seed, exactly like the two
  ``flow_from_directory`` streams sharing ``seed=SEED``
  (``train.py:187-206``);
* images decoded RGB + bilinear-resized, masks grayscale +
  nearest-resized (``interpolation=`` args, ``train.py:191,197``);
* rescale 1/255 (``train.py:169-178``);
* paired random horizontal flip on the training stream only
  (``train.py:171``), driven by one seeded PRNG so image and mask flip
  together;
* validation unshuffled (``train.py:201-206``).

The hot path (decode/resize) runs in a thread pool — cv2 releases the GIL
inside imdecode/resize — and finished batches land in a bounded queue so
the accelerator never waits on the host at steady state (SURVEY.md §3.1
flags the reference's generator as the known bottleneck).

The port's own copy of ``unet_image_segmentation_tpu/data/loader.py``:
batch order, flips and normalisation are the same, byte for byte.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")


def _cv2():
    import cv2

    return cv2


def list_images(directory: str) -> List[str]:
    files = [
        os.path.join(directory, f)
        for f in sorted(os.listdir(directory))
        if f.lower().endswith(IMG_EXTENSIONS)
    ]
    return files


def load_image_rgb(path: str, size: Tuple[int, int]) -> np.ndarray:
    """Decode to RGB float32 [0,1], bilinear resize to (H, W)."""
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read image {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    h, w = size
    if img.shape[:2] != (h, w):
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    return img.astype(np.float32) / 255.0


def load_mask_gray(
    path: str, size: Tuple[int, int], mask_mode: str = "binary"
) -> np.ndarray:
    """Decode grayscale mask, nearest resize, shape (H, W, 1).

    mask_mode 'binary' rescales by 1/255 to [0,1] (reference semantics);
    'class_id' keeps raw integer class labels (multi-class configs).
    """
    cv2 = _cv2()
    m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if m is None:
        raise IOError(f"cannot read mask {path}")
    h, w = size
    if m.shape[:2] != (h, w):
        m = cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)
    m = m.astype(np.float32)
    if mask_mode == "binary":
        m = m / 255.0
    return m[..., None]


@dataclass
class DirectoryDataset:
    """Paired frames/masks directory dataset."""

    frames_dir: str
    masks_dir: str
    image_size: Tuple[int, int] = (256, 256)
    horizontal_flip: bool = False
    shuffle: bool = True
    seed: int = 2301
    mask_mode: str = "binary"  # 'binary' | 'class_id'

    def __post_init__(self) -> None:
        self.frame_files = list_images(self.frames_dir)
        self.mask_files = list_images(self.masks_dir)
        if len(self.frame_files) != len(self.mask_files):
            raise ValueError(
                f"frame/mask count mismatch: {len(self.frame_files)} vs "
                f"{len(self.mask_files)}"
            )
        if not self.frame_files:
            raise ValueError(f"no images found under {self.frames_dir}")

    def __len__(self) -> int:
        return len(self.frame_files)

    def load_sample(
        self, idx: int, flip: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        img = load_image_rgb(self.frame_files[idx], self.image_size)
        mask = load_mask_gray(self.mask_files[idx], self.image_size, self.mask_mode)
        if flip:
            img = img[:, ::-1].copy()
            mask = mask[:, ::-1].copy()
        return img, mask

    def epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            rng.shuffle(idx)
        return idx

    def batches(
        self,
        batch_size: int,
        epoch: int = 0,
        steps: Optional[int] = None,
        num_workers: int = 8,
        drop_remainder: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images, masks) numpy batches for one epoch."""
        order = self.epoch_order(epoch)
        flip_rng = np.random.RandomState(self.seed * 7919 + epoch)
        flips = (
            flip_rng.rand(len(order)) < 0.5
            if self.horizontal_flip
            else np.zeros(len(order), bool)
        )
        n_batches = len(order) // batch_size if drop_remainder else -(-len(order) // batch_size)
        n_batches = max(1, n_batches)
        if steps is not None:
            n_batches = min(n_batches, steps)

        def make_batch(b: int) -> Tuple[np.ndarray, np.ndarray]:
            sel = order[b * batch_size : (b + 1) * batch_size]
            if len(sel) < batch_size:  # wrap around (steady shapes for jit)
                sel = np.concatenate([sel, order[: batch_size - len(sel)]])
            samples = [self.load_sample(int(i), bool(flips[int(i)])) for i in sel]
            imgs = np.stack([s[0] for s in samples])
            masks = np.stack([s[1] for s in samples])
            return imgs, masks

        # A pool wider than the host loses (GIL + future churn with no
        # parallel decode to buy).  cv2 only releases the GIL per-call,
        # so extra threads beyond the core count are pure overhead.
        num_workers = min(num_workers, os.cpu_count() or 1)
        if num_workers <= 1:
            for b in range(n_batches):
                yield make_batch(b)
            return
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            window = min(n_batches, max(2, num_workers // 2))
            futures = [pool.submit(make_batch, b) for b in range(window)]
            nxt = window
            for _ in range(n_batches):
                out = futures.pop(0).result()
                if nxt < n_batches:
                    futures.append(pool.submit(make_batch, nxt))
                    nxt += 1
                yield out


class Prefetcher:
    """Bounded-queue prefetcher decoupling host decode from device step."""

    _END = object()

    def __init__(self, iterator: Iterator, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def run() -> None:
            try:
                for item in iterator:
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                self._err = e
            finally:
                self._q.put(self._END)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def make_loaders(cfg) -> Tuple[DirectoryDataset, DirectoryDataset]:
    """Build (train, val) datasets from a :class:`..config.Config`."""
    d = cfg.data
    size = (cfg.model.image_height, cfg.model.image_width)
    train = DirectoryDataset(
        frames_dir=os.path.join(d.root, d.train_frames),
        masks_dir=os.path.join(d.root, d.train_masks),
        image_size=size,
        horizontal_flip=d.horizontal_flip,
        shuffle=d.shuffle_train,
        seed=cfg.train.seed,
        mask_mode=d.mask_mode,
    )
    val = DirectoryDataset(
        frames_dir=os.path.join(d.root, d.val_frames),
        masks_dir=os.path.join(d.root, d.val_masks),
        image_size=size,
        horizontal_flip=False,
        shuffle=d.shuffle_val,
        seed=cfg.train.seed,
        mask_mode=d.mask_mode,
    )
    return train, val
