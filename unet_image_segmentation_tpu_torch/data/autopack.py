"""Auto-packing: the reference directory contract at packed-reader speed.

The reference trains straight off an image directory through Keras
``ImageDataGenerator`` (reference ``scripts/train.py:182-206``) — decode +
resize every image every epoch.  cv2 decode is CPU-bound, so on a small
host a directory decode path cannot feed a fused train step; the packed
reader (``data/packed.py`` + the C++ library) serves from a memory map.

:class:`AutoPackDataset` closes that gap with a *pack-through first
epoch*:

* epoch 0 decodes each sample ONCE (exactly the work one directory epoch
  already pays), yields normal float batches to the trainer, and spills
  the uint8 records straight into a memory-mapped ``.upk`` staging file —
  no extra RAM, no extra decode pass;
* when the first full iteration completes, any tail samples a
  ``drop_remainder`` pass skipped are decoded, the staging file is
  atomically renamed into place with a signature sidecar, and
* every later epoch is served by :class:`~.packed.PackedDataset`
  (C++ mmap + thread pool when built, numpy otherwise).

Batches are **bit-identical** to :class:`~.loader.DirectoryDataset` in
every phase: the uint8 round-trip is exact (the directory loader itself
decodes uint8 and scales by 1/255), and shuffle/flip streams share the
same seeded formulas (pinned in ``tests/test_autopack.py``).

The cache key is a content signature over the paired file listing
(names, sizes, mtimes) + image size + mask mode, so edits to the dataset
invalidate the pack.  The pack lands next to the dataset
(``<root>/.unet_tpu_pack/``) when writable, else under a fallback
directory (``fit`` passes its ``model_out``).

``fit`` engages this wrapper by default (``DataConfig.auto_pack``); the
reference workflow — point ``--data-root`` at the ``train.py:79-82``
directory layout — gets the fast path without user action.

The port's own copy of ``unet_image_segmentation_tpu/data/autopack.py``;
its pack files are the JAX package's format, so either package reads the
other's cache.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from unet_image_segmentation_tpu_torch.data import packed as packed_mod
from unet_image_segmentation_tpu_torch.data.loader import DirectoryDataset

PACK_SUFFIX = ".upk"
SIG_VERSION = 1


def dataset_signature(ds: DirectoryDataset) -> str:
    """Content signature of the paired directory dataset.

    Names + sizes + integer mtimes of every frame/mask file, plus the
    decode-relevant knobs (target size, mask mode).  Any change re-packs.
    """
    items = []
    for path in list(ds.frame_files) + list(ds.mask_files):
        st = os.stat(path)
        items.append([os.path.basename(path), st.st_size, int(st.st_mtime)])
    payload = json.dumps(
        {
            "v": SIG_VERSION,
            "files": items,
            "image_size": list(ds.image_size),
            "mask_mode": ds.mask_mode,
        },
        sort_keys=True,
    )
    return hashlib.sha1(payload.encode()).hexdigest()


def _writable_dir(path: str) -> bool:
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, f".probe_{os.getpid()}")
        with open(probe, "w"):
            pass
        os.remove(probe)
        return True
    except OSError:
        return False


def resolve_pack_path(
    ds: DirectoryDataset,
    signature: str,
    pack_dir: Optional[str] = None,
    fallback_dir: Optional[str] = None,
) -> Optional[str]:
    """Pick the cache location: explicit > next-to-dataset > fallback."""
    frames = os.path.abspath(ds.frames_dir)
    # dataset root two levels up from <root>/<role>_frames/image
    root = os.path.dirname(os.path.dirname(frames))
    role = os.path.basename(os.path.dirname(frames)) or "dataset"
    h, w = ds.image_size
    name = f"{role}_{h}x{w}_{signature[:12]}{PACK_SUFFIX}"
    candidates = []
    if pack_dir:
        candidates.append(pack_dir)
    candidates.append(os.path.join(root, ".unet_tpu_pack"))
    if fallback_dir:
        candidates.append(os.path.join(fallback_dir, ".unet_tpu_pack"))
    for base in candidates:
        if _writable_dir(base):
            return os.path.join(base, name)
    return None


class AutoPackDataset:
    """Directory-contract dataset that packs itself on first use.

    Drop-in for :class:`~.loader.DirectoryDataset` in ``train.loop.fit``
    (same ``__len__`` / ``image_size`` / ``batches`` surface, bit-identical
    batches).
    """

    def __init__(
        self,
        ds: DirectoryDataset,
        pack_dir: Optional[str] = None,
        fallback_dir: Optional[str] = None,
        num_threads: int = 8,
        verbose: bool = True,
    ):
        self.ds = ds
        self.num_threads = num_threads
        self.verbose = verbose
        self.signature = dataset_signature(ds)
        self.pack_path = resolve_pack_path(
            ds, self.signature, pack_dir=pack_dir, fallback_dir=fallback_dir
        )
        self._packed: Optional[packed_mod.PackedDataset] = None
        self._lock = threading.Lock()
        if self.pack_path and os.path.exists(self.pack_path):
            if self._sidecar_valid():
                self._open_packed()
            elif self.verbose:
                print(
                    f"autopack: stale cache {self.pack_path} "
                    "(dataset changed); re-packing on next epoch"
                )

    # --- DirectoryDataset surface -------------------------------------
    def __len__(self) -> int:
        return len(self.ds)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self.ds.image_size

    @property
    def mask_mode(self) -> str:
        return self.ds.mask_mode

    @property
    def packed_active(self) -> bool:
        return self._packed is not None

    def close(self) -> None:
        if self._packed is not None:
            self._packed.close()
            self._packed = None

    # --- cache bookkeeping ---------------------------------------------
    def _sidecar_path(self) -> str:
        return self.pack_path + ".json"

    def _sidecar_valid(self) -> bool:
        try:
            with open(self._sidecar_path()) as f:
                meta = json.load(f)
            return meta.get("signature") == self.signature
        except (OSError, ValueError):
            return False

    def _open_packed(self) -> None:
        self._packed = packed_mod.PackedDataset(
            self.pack_path,
            horizontal_flip=self.ds.horizontal_flip,
            shuffle=self.ds.shuffle,
            seed=self.ds.seed,
            num_threads=self.num_threads,
        )
        if self.verbose:
            print(
                f"autopack: serving {len(self.ds)} samples from "
                f"{self.pack_path} "
                f"(native={packed_mod.native_available()})"
            )

    # --- batches ---------------------------------------------------------
    def batches(
        self,
        batch_size: int,
        epoch: int = 0,
        steps: Optional[int] = None,
        num_workers: int = 8,
        drop_remainder: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self._packed is None and self.pack_path is None:
            # nowhere writable: plain directory iteration
            yield from self.ds.batches(
                batch_size,
                epoch=epoch,
                steps=steps,
                num_workers=num_workers,
                drop_remainder=drop_remainder,
            )
            return
        if self._packed is None:
            yield from self._pack_through(
                batch_size,
                epoch=epoch,
                steps=steps,
                num_workers=num_workers,
                drop_remainder=drop_remainder,
            )
            return
        yield from self._packed.batches(
            batch_size,
            epoch=epoch,
            steps=steps,
            drop_remainder=drop_remainder,
        )

    # --- pack-through first epoch ----------------------------------------
    def _pack_through(
        self,
        batch_size: int,
        epoch: int,
        steps: Optional[int],
        num_workers: int,
        drop_remainder: bool,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        ds = self.ds
        n = len(ds)
        h, w = ds.image_size
        mask_is_class_id = ds.mask_mode == "class_id"
        img0, mask0 = ds.load_sample(0)
        img_c, mask_c = img0.shape[-1], mask0.shape[-1]
        img_px = h * w * img_c
        record = img_px + h * w * mask_c
        mask_div = 1.0 if mask_is_class_id else 255.0

        tmp_path = f"{self.pack_path}.tmp.{os.getpid()}"
        header = struct.pack(
            packed_mod._HEADER_FMT,
            packed_mod._MAGIC,
            1,
            n,
            h,
            w,
            img_c,
            mask_c,
            int(mask_is_class_id),
        )
        header += b"\0" * (packed_mod._HEADER_SIZE - len(header))
        with open(tmp_path, "wb") as f:
            f.write(header)
            f.truncate(packed_mod._HEADER_SIZE + n * record)
        mm = np.memmap(
            tmp_path,
            dtype=np.uint8,
            mode="r+",
            offset=packed_mod._HEADER_SIZE,
            shape=(n, record),
        )
        done = np.zeros(n, bool)

        def to_u8(img: np.ndarray, mask: np.ndarray):
            iu8 = np.round(img * 255.0).astype(np.uint8)
            mu8 = (
                mask.astype(np.uint8)
                if mask_is_class_id
                else np.round(mask * 255.0).astype(np.uint8)
            )
            return iu8, mu8

        def fetch(idx: int) -> Tuple[np.ndarray, np.ndarray]:
            """uint8 (image, mask) for idx; decode-and-store on first touch.

            The lock only guards the claim — cv2 decode runs outside it.
            A wrap-around duplicate may decode twice; both writes carry
            identical bytes, so the record stays consistent.
            """
            with self._lock:
                have = bool(done[idx])
            if have:
                rec = mm[idx]
                return (
                    rec[:img_px].reshape(h, w, img_c),
                    rec[img_px:].reshape(h, w, mask_c),
                )
            iu8, mu8 = to_u8(*ds.load_sample(idx, flip=False))
            mm[idx, :img_px] = iu8.reshape(-1)
            mm[idx, img_px:] = mu8.reshape(-1)
            with self._lock:
                done[idx] = True
            return iu8, mu8

        order = ds.epoch_order(epoch)
        flip_rng = np.random.RandomState(ds.seed * 7919 + epoch)
        flips = (
            flip_rng.rand(n) < 0.5
            if ds.horizontal_flip
            else np.zeros(n, bool)
        )
        n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
        n_batches = max(1, n_batches)
        truncated = steps is not None and steps < n_batches
        if steps is not None:
            n_batches = min(n_batches, steps)

        def make_batch(b: int) -> Tuple[np.ndarray, np.ndarray]:
            sel = order[b * batch_size : (b + 1) * batch_size]
            if len(sel) < batch_size:
                sel = np.concatenate([sel, order[: batch_size - len(sel)]])
            imgs = np.empty((batch_size, h, w, img_c), np.float32)
            masks = np.empty((batch_size, h, w, mask_c), np.float32)
            for j, idx in enumerate(sel):
                idx = int(idx)
                iu8, mu8 = fetch(idx)
                if flips[idx]:
                    iu8, mu8 = iu8[:, ::-1], mu8[:, ::-1]
                imgs[j] = iu8.astype(np.float32) / 255.0
                masks[j] = mu8.astype(np.float32) / mask_div
            return imgs, masks

        workers = max(1, min(num_workers, os.cpu_count() or 1))
        try:
            if workers <= 1:
                for b in range(n_batches):
                    yield make_batch(b)
            else:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    window = min(n_batches, max(2, workers // 2))
                    futures = [
                        pool.submit(make_batch, b) for b in range(window)
                    ]
                    nxt = window
                    for _ in range(n_batches):
                        out = futures.pop(0).result()
                        if nxt < n_batches:
                            futures.append(pool.submit(make_batch, nxt))
                            nxt += 1
                        yield out
        except GeneratorExit:
            # consumer abandoned the epoch: drop the staging file, re-try
            # pack-through next epoch
            del mm
            try:
                os.remove(tmp_path)
            except OSError:
                pass
            raise

        if truncated:
            # partial epoch (profiling / steps=): not enough coverage to
            # finalize cheaply — drop staging, pack on a later full epoch
            del mm
            try:
                os.remove(tmp_path)
            except OSError:
                pass
            return

        # full iteration completed: decode any dropped-tail stragglers and
        # promote the staging file to the cache, atomically
        for idx in np.nonzero(~done)[0]:
            fetch(int(idx))
        mm.flush()
        del mm
        os.replace(tmp_path, self.pack_path)
        with open(self._sidecar_path(), "w") as f:
            json.dump(
                {"signature": self.signature, "n": n, "h": h, "w": w},
                f,
            )
        if self.verbose:
            print(f"autopack: wrote {self.pack_path} ({n} samples)")
        self._open_packed()


def maybe_autopack(
    ds,
    enabled: bool = True,
    pack_dir: Optional[str] = None,
    fallback_dir: Optional[str] = None,
    num_threads: int = 8,
    verbose: bool = True,
):
    """Wrap a DirectoryDataset in AutoPackDataset when enabled; pass
    anything else (PackedDataset, test doubles) through unchanged."""
    if not enabled or not isinstance(ds, DirectoryDataset):
        return ds
    try:
        return AutoPackDataset(
            ds,
            pack_dir=pack_dir,
            fallback_dir=fallback_dir,
            num_threads=num_threads,
            verbose=verbose,
        )
    except OSError as e:
        if verbose:
            print(f"autopack: disabled ({e})")
        return ds
