"""MIDV-500 / MIDV-2019 dataset acquisition and preparation.

Rebuilds the reference's dataset pipeline (``scripts/download_dataset_midv.py``
+ ``scripts/midv_links.py``, SURVEY.md §3.5) as library functions + CLI:

1. download the 50 MIDV-500 (+3 MIDV-2019 extra) zips from the public
   smartengines FTP mirror (URL registry below is public dataset metadata),
2. unzip under ``dataset/data/``,
3. per (tif, json) pair: rasterize the ``"quad"`` polygon to a binary mask
   (``approxPolyDP(eps=10)`` then filled ``drawContours``), downsample image
   and mask by 2x, binarize, and write numbered ``image{N}.png`` pairs into
   ``dataset/temp/{image,mask}/`` (reference ``download_dataset_midv.py:42-72``,
   ``:136-140``),
4. 70/20/10 train/val/test split with seed 230, shuffled by filename
   (``download_dataset_midv.py:144-204``) into the training directory
   contract ``dataset/train/{split}_{frames,masks}/image/``.

Downloads use urllib (stdlib FTP support) instead of the reference's
``wget`` dependency, run in a small thread pool, and are skipped when the
archive/directory already exists.  In zero-egress environments, point
``--from-dir`` at pre-downloaded zips or extracted folders.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import zipfile
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Iterable, List, Optional, Tuple

import numpy as np

# Public MIDV-500 archive names (dataset metadata; see the MIDV-500 paper,
# Arlazarov et al. 2019). Mirrors reference scripts/midv_links.py:4-61.
_FTP_BASE = "ftp://smartengines.com/midv-500/dataset/"
_FTP_EXTRA_BASE = "ftp://smartengines.com/midv-500/extra/midv-2019/dataset/"

MIDV500_NAMES: List[str] = [
    "01_alb_id", "02_aut_drvlic_new", "03_aut_id_old", "04_aut_id",
    "05_aze_passport", "06_bra_passport", "07_chl_id", "08_chn_homereturn",
    "09_chn_id", "10_cze_id", "11_cze_passport", "12_deu_drvlic_new",
    "13_deu_drvlic_old", "14_deu_id_new", "15_deu_id_old",
    "16_deu_passport_new", "17_deu_passport_old", "18_dza_passport",
    "19_esp_drvlic", "20_esp_id_new", "21_esp_id_old", "22_est_id",
    "23_fin_drvlic", "24_fin_id", "25_grc_passport", "26_hrv_drvlic",
    "27_hrv_passport", "28_hun_passport", "29_irn_drvlic", "30_ita_drvlic",
    "31_jpn_drvlic", "32_lva_passport", "33_mac_id", "34_mda_passport",
    "35_nor_drvlic", "36_pol_drvlic", "37_prt_id", "38_rou_drvlic",
    "39_rus_internalpassport", "40_srb_id", "41_srb_passport", "42_svk_id",
    "43_tur_id", "44_ukr_id", "45_ukr_passport", "46_ury_passport",
    "47_usa_bordercrossing", "48_usa_passportcard", "49_usa_ssn82",
    "50_xpo_id",
]
MIDV2019_EXTRA_NAMES: List[str] = ["04_aut_id", "14_deu_id_new", "15_deu_id_old"]

MIDV500_LINKS = [_FTP_BASE + n + ".zip" for n in MIDV500_NAMES]
MIDV2019_EXTRA_LINKS = [_FTP_EXTRA_BASE + n + ".zip" for n in MIDV2019_EXTRA_NAMES]

SPLIT_SEED = 230  # reference download_dataset_midv.py:34
DOWNSAMPLE = 2


def quad_to_mask(
    quad: Iterable, shape: Tuple[int, int], approx_eps: float = 10.0
) -> np.ndarray:
    """Rasterize a quad polygon to a filled uint8 {0,255} mask.

    Applies ``approxPolyDP(eps=10)`` first, like the reference mask builder
    (``download_dataset_midv.py:52-67``).
    """
    import cv2

    mask = np.zeros(shape, np.uint8)
    quad = list(quad or [])
    if quad:
        pts = np.asarray(quad, np.int32).reshape(-1, 1, 2)
        poly = cv2.approxPolyDP(pts, approx_eps, True)
        cv2.drawContours(mask, [poly], -1, color=255, thickness=cv2.FILLED)
    return mask


def process_pair(
    img_path: str, json_path: str
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(tif, json) -> 2x-downsampled (image BGR, binary mask) or None."""
    import cv2

    image = cv2.imread(img_path)
    if image is None:
        return None
    with open(json_path) as f:
        quad = json.load(f).get("quad", [])
    mask = quad_to_mask(quad, image.shape[:2])
    h, w = image.shape[:2]
    image = cv2.resize(image, (w // DOWNSAMPLE, h // DOWNSAMPLE))
    mask = cv2.resize(mask, (w // DOWNSAMPLE, h // DOWNSAMPLE))
    mask = cv2.threshold(mask, 0, 255, cv2.THRESH_BINARY)[1]
    return image, mask


def download_archive(url: str, dest: str, timeout: int = 600) -> str:
    """Fetch one archive via stdlib urllib (supports ftp://)."""
    import urllib.request

    if os.path.isfile(dest):
        return dest
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".part"
    print(f"Downloading {url}")
    with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
        shutil.copyfileobj(r, f)
    os.replace(tmp, dest)
    return dest


def extract_dataset_dir(
    directory: str, temp_image: str, temp_mask: str, start_idx: int
) -> int:
    """Walk one extracted archive dir; write numbered png pairs; next idx."""
    import cv2

    img_root = os.path.join(directory, "images")
    gt_root = os.path.join(directory, "ground_truth")
    if not (os.path.isdir(img_root) and os.path.isdir(gt_root)):
        print(f"Warning: {directory} lacks images/ or ground_truth/; skipping")
        return start_idx
    idx = start_idx
    for img_sub, gt_sub in zip(sorted(os.listdir(img_root)), sorted(os.listdir(gt_root))):
        imgs = sorted(glob(os.path.join(img_root, img_sub, "*.tif")))
        jsons = sorted(glob(os.path.join(gt_root, gt_sub, "*.json")))
        for img_path, json_path in zip(imgs, jsons):
            out = process_pair(img_path, json_path)
            if out is None:
                continue
            image, mask = out
            cv2.imwrite(os.path.join(temp_image, f"image{idx}.png"), image)
            cv2.imwrite(os.path.join(temp_mask, f"image{idx}.png"), mask)
            idx += 1
    return idx


def _numeric_key(name: str) -> int:
    m = re.findall(r"\d+", name)
    return int(m[0]) if m else 0


def train_validation_split(
    temp_path: str,
    out_path: str,
    seed: int = SPLIT_SEED,
    fractions: Tuple[float, float] = (0.7, 0.9),
) -> None:
    """70/20/10 split by shuffled filename (reference :144-204 semantics)."""
    import random

    temp_image = os.path.join(temp_path, "image")
    temp_mask = os.path.join(temp_path, "mask")
    if os.path.exists(out_path):
        shutil.rmtree(out_path, ignore_errors=True)
    for folder in (
        "train_frames/image", "train_masks/image",
        "val_frames/image", "val_masks/image",
        "test_frames/image", "test_masks/image",
    ):
        os.makedirs(os.path.join(out_path, folder), exist_ok=True)

    frames = sorted(os.listdir(temp_image), key=_numeric_key)
    rng = random.Random(seed)
    rng.shuffle(frames)
    n = len(frames)
    cut1, cut2 = int(fractions[0] * n), int(fractions[1] * n)
    assignments = {
        "train": frames[:cut1],
        "val": frames[cut1:cut2],
        "test": frames[cut2:],
    }
    for split, names in assignments.items():
        for name in names:
            shutil.copyfile(
                os.path.join(temp_image, name),
                os.path.join(out_path, f"{split}_frames/image", name),
            )
            shutil.copyfile(
                os.path.join(temp_mask, name),
                os.path.join(out_path, f"{split}_masks/image", name),
            )
    print(
        f"Split {n} pairs -> train {len(assignments['train'])} / "
        f"val {len(assignments['val'])} / test {len(assignments['test'])}"
    )


def build_dataset(
    dataset_root: str = "dataset",
    include_2019: bool = True,
    from_dir: Optional[str] = None,
    download_workers: int = 4,
) -> None:
    """Full pipeline: download (or reuse) -> rasterize -> split."""
    data_path = os.path.join(dataset_root, "data")
    temp_path = os.path.join(dataset_root, "temp")
    train_path = os.path.join(dataset_root, "train")
    if os.path.exists(temp_path):
        shutil.rmtree(temp_path, ignore_errors=True)
    temp_image = os.path.join(temp_path, "image")
    temp_mask = os.path.join(temp_path, "mask")
    os.makedirs(temp_image, exist_ok=True)
    os.makedirs(temp_mask, exist_ok=True)

    if from_dir:
        dirs = sorted(
            d for d in glob(os.path.join(from_dir, "*")) if os.path.isdir(d)
        )
        zips = sorted(glob(os.path.join(from_dir, "*.zip")))
    else:
        links = list(MIDV500_LINKS) + (MIDV2019_EXTRA_LINKS if include_2019 else [])
        os.makedirs(data_path, exist_ok=True)
        with ThreadPoolExecutor(max_workers=download_workers) as pool:
            zips = list(
                pool.map(
                    lambda url: download_archive(
                        url, os.path.join(data_path, url.rsplit("/", 1)[1])
                    ),
                    links,
                )
            )
        dirs = []

    for zp in zips:
        target = zp[:-4]
        if not os.path.isdir(target):
            print(f"Unzipping {zp}")
            with zipfile.ZipFile(zp) as zf:
                zf.extractall(os.path.dirname(zp))
        dirs.append(target)

    idx = 1
    for directory in dirs:
        print(f"Preparing {directory}")
        idx = extract_dataset_dir(directory, temp_image, temp_mask, idx)
    print(f"Extracted {idx - 1} image/mask pairs")
    train_validation_split(temp_path, train_path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Download + prepare MIDV-500/2019 into the training layout."
    )
    p.add_argument("--dataset-root", default="dataset")
    p.add_argument("--no-2019", action="store_true",
                   help="Skip the 3 MIDV-2019 extra archives.")
    p.add_argument("--from-dir", default=None,
                   help="Use pre-downloaded zips/extracted dirs (offline mode).")
    p.add_argument("--download-workers", type=int, default=4)
    args = p.parse_args(argv)
    try:
        build_dataset(
            dataset_root=args.dataset_root,
            include_2019=not args.no_2019,
            from_dir=args.from_dir,
            download_workers=args.download_workers,
        )
    except Exception as e:
        print(f"Dataset build failed: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
