"""Packed-dataset format + native loader bindings.

The port's own copy of ``unet_image_segmentation_tpu/data/packed.py``:
the ``.upk`` format, its writers :func:`write_pack` and
:func:`pack_directory_dataset` (numpy and ``struct`` only; their files are
byte for byte the JAX package's), and :class:`PackedDataset`, which serves
batches from a memory-mapped file of fixed-size uint8 records through the
C++ library in the repository's ``native/packed_dataset.cpp`` (mmap +
thread-pool gather/normalize/flip, no GIL), built with its ``Makefile`` on
first use, or through a bit-identical NumPy fallback when the library
cannot be built. :mod:`.autopack` writes packs on a first epoch.

Usage::

    pack_directory_dataset(dir_ds, "train.upk")         # one-time
    ds = PackedDataset("train.upk", horizontal_flip=True, seed=2301)
    for images, masks in ds.batches(batch_size=32, epoch=e): ...

``PackedDataset.batches`` matches :class:`.loader.DirectoryDataset`'s
iteration contract (seeded shuffle per epoch, paired flips, fixed batch
shapes), so it drops into ``train.loop.fit`` unchanged.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

_MAGIC = 0x314B5055  # 'UPK1'
_HEADER_SIZE = 64
_HEADER_FMT = "<IIQIIIII"  # magic, version, n, h, w, img_c, mask_c, class_id

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpacked_dataset.so")

_lib = None
_lib_tried = False


_ABI_VERSION = 2  # must match pd_abi_version() in packed_dataset.cpp


def _dlopen_checked() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        if int(lib.pd_abi_version()) != _ABI_VERSION:
            return None
    except (OSError, AttributeError):
        return None
    return lib


def _load_native() -> Optional[ctypes.CDLL]:
    """dlopen the loader, (re)building it with g++ when missing or when the
    on-disk .so predates the current ABI (pd_abi_version check)."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    lib = _dlopen_checked() if os.path.exists(_LIB_PATH) else None
    if lib is None:
        src = os.path.join(_NATIVE_DIR, "packed_dataset.cpp")
        if os.path.exists(src):
            try:
                subprocess.run(
                    ["make", "-B", "-C", _NATIVE_DIR],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except Exception:
                return None
        lib = _dlopen_checked()
    if lib is None:
        return None
    lib.pd_open.restype = ctypes.c_void_p
    lib.pd_open.argtypes = [ctypes.c_char_p]
    lib.pd_info.restype = None
    lib.pd_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.pd_fill_batch.restype = ctypes.c_int
    lib.pd_fill_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_float,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.pd_close.restype = None
    lib.pd_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_native() is not None


def write_pack(
    path: str,
    images_u8: np.ndarray,  # (N, H, W, C) uint8
    masks_u8: np.ndarray,   # (N, H, W, MC) uint8
    mask_is_class_id: bool = False,
) -> str:
    n, h, w, c = images_u8.shape
    mc = masks_u8.shape[-1]
    assert masks_u8.shape[:3] == (n, h, w), (images_u8.shape, masks_u8.shape)
    assert images_u8.dtype == np.uint8 and masks_u8.dtype == np.uint8
    header = struct.pack(
        _HEADER_FMT, _MAGIC, 1, n, h, w, c, mc, int(mask_is_class_id)
    )
    header += b"\0" * (_HEADER_SIZE - len(header))
    with open(path, "wb") as f:
        f.write(header)
        for i in range(n):
            f.write(images_u8[i].tobytes())
            f.write(masks_u8[i].tobytes())
    return path


def pack_directory_dataset(directory_ds, path: str) -> str:
    """Pack a :class:`.loader.DirectoryDataset` (decode+resize once)."""
    mask_is_class_id = directory_ds.mask_mode == "class_id"
    imgs, masks = [], []
    for i in range(len(directory_ds)):
        img, mask = directory_ds.load_sample(i)
        imgs.append(np.round(img * 255.0).astype(np.uint8))
        if mask_is_class_id:
            masks.append(mask.astype(np.uint8))
        else:
            masks.append(np.round(mask * 255.0).astype(np.uint8))
    return write_pack(
        path, np.stack(imgs), np.stack(masks), mask_is_class_id
    )


class PackedDataset:
    """Batch server over a pack file (native threads, numpy fallback)."""

    def __init__(
        self,
        path: str,
        horizontal_flip: bool = False,
        shuffle: bool = True,
        seed: int = 2301,
        num_threads: int = 8,
        force_numpy: bool = False,
    ):
        self.path = path
        self.horizontal_flip = horizontal_flip
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads

        self._lib = None if force_numpy else _load_native()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.pd_open(path.encode())
            if not self._handle:
                self._lib = None
        if self._handle:
            info = (ctypes.c_int64 * 6)()
            self._lib.pd_info(self._handle, info)
            self.n, self.h, self.w, self.img_c, self.mask_c, cid = (
                int(info[0]), int(info[1]), int(info[2]),
                int(info[3]), int(info[4]), int(info[5]),
            )
            self.mask_is_class_id = bool(cid)
            self._mm = None
        else:  # numpy fallback: mmap through numpy
            with open(path, "rb") as f:
                hdr = struct.unpack(_HEADER_FMT, f.read(struct.calcsize(_HEADER_FMT)))
            if hdr[0] != _MAGIC or hdr[1] != 1:
                raise ValueError(f"{path} is not a v1 pack file")
            _, _, self.n, self.h, self.w, self.img_c, self.mask_c, cid = hdr
            self.mask_is_class_id = bool(cid)
            record = self.h * self.w * (self.img_c + self.mask_c)
            self._mm = np.memmap(
                path, dtype=np.uint8, mode="r", offset=_HEADER_SIZE,
                shape=(self.n, record),
            )
        # normalization DIVISORS (exact float division, bit-identical to
        # the directory loader's `u8.astype(float32) / 255.0`)
        self.mask_div = 1.0 if self.mask_is_class_id else 255.0

    def __len__(self) -> int:
        return int(self.n)

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.h, self.w)

    @property
    def native(self) -> bool:
        """Whether the C++ library serves the batches (else the numpy path)."""
        return bool(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.pd_close(self._handle)
            self._handle = None

    def __del__(self):  # best effort
        try:
            self.close()
        except Exception:
            pass

    def _fill(self, indices: np.ndarray, flips: np.ndarray):
        b = len(indices)
        imgs = np.empty((b, self.h, self.w, self.img_c), np.float32)
        masks = np.empty((b, self.h, self.w, self.mask_c), np.float32)
        if self._handle:
            rc = self._lib.pd_fill_batch(
                self._handle,
                indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                b,
                flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_float(255.0),
                ctypes.c_float(self.mask_div),
                imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                masks.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.num_threads,
            )
            if rc != 0:
                raise RuntimeError("pd_fill_batch failed (bad index?)")
            return imgs, masks
        # numpy fallback (identical math)
        img_px = self.h * self.w * self.img_c
        for j, (idx, flip) in enumerate(zip(indices, flips)):
            rec = self._mm[int(idx)]
            img = rec[:img_px].reshape(self.h, self.w, self.img_c)
            msk = rec[img_px:].reshape(self.h, self.w, self.mask_c)
            if flip:
                img = img[:, ::-1]
                msk = msk[:, ::-1]
            imgs[j] = img.astype(np.float32) / 255.0
            masks[j] = msk.astype(np.float32) / self.mask_div
        return imgs, masks

    def epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n, dtype=np.int64)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            rng.shuffle(idx)
        return idx

    def batches(
        self,
        batch_size: int,
        epoch: int = 0,
        steps: Optional[int] = None,
        num_workers: int = 0,  # kept for DirectoryDataset API compat
        drop_remainder: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        del num_workers  # the native pool is self-contained
        order = self.epoch_order(epoch)
        flip_rng = np.random.RandomState(self.seed * 7919 + epoch)
        flips_all = (
            (flip_rng.rand(self.n) < 0.5).astype(np.uint8)
            if self.horizontal_flip
            else np.zeros(self.n, np.uint8)
        )
        n_batches = self.n // batch_size if drop_remainder else -(-self.n // batch_size)
        n_batches = max(1, n_batches)
        if steps is not None:
            n_batches = min(n_batches, steps)
        for b in range(n_batches):
            sel = order[b * batch_size : (b + 1) * batch_size]
            if len(sel) < batch_size:
                sel = np.concatenate([sel, order[: batch_size - len(sel)]])
            yield self._fill(
                np.ascontiguousarray(sel), np.ascontiguousarray(flips_all[sel])
            )
