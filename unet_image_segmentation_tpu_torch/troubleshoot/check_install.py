"""Install smoke test of the port (reference ``check_tf_install.py``).

Port of ``unet_image_segmentation_tpu/troubleshoot/check_install.py``.
Checks, in order: torch, CUDA and driver versions and the card's name and
power limit; the CUDA kernels build; a tiny U-Net (32 px, filters (8, 16))
answers an eval forward with the kernels on (shape, outputs in [0, 1]);
one ``use_pallas`` train step gives finite gradients on every parameter.
On ``--device cpu`` the kernels' plain versions run and nothing is built.
Exit code 0 = healthy, 1 = broken; no card and no ``--device cpu`` is
broken, never a silent CPU run.

Usage: python -m unet_image_segmentation_tpu_torch.troubleshoot.check_install [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

HW = 32
FILTERS = (8, 16)


def check_device(device: torch.device) -> bool:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if device.type != "cuda":
        print(f"device {device}: the kernels' plain versions run")
        return True
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available (pass --device cpu for a CPU check)")
        return False
    from unet_image_segmentation_tpu_torch.ops.kernels import build
    from unet_image_segmentation_tpu_torch.troubleshoot.roofline import card, nvidia_smi

    print(f"driver {nvidia_smi('driver_version')}; card {card()}; "
          f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    build.load_library()
    print(f"kernels built and loaded from {build.library_path()} in "
          f"{time.perf_counter() - t0:.1f} s")
    return True


def check_model(device: torch.device) -> bool:
    from unet_image_segmentation_tpu_torch.config import Config
    from unet_image_segmentation_tpu_torch.train.state import create_train_state
    from unet_image_segmentation_tpu_torch.train.steps import make_train_step

    print(f"Building a tiny U-Net (filters {FILTERS}, {HW} px, use_pallas) on {device} ...")
    cfg = Config().override(model__image_height=HW, model__image_width=HW,
                            model__filters=FILTERS, model__use_pallas=True,
                            train__batch_size=2)
    state = create_train_state(cfg, device=device)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(2, HW, HW, 3).astype(np.float32)).to(device)
    m = torch.from_numpy((rng.rand(2, HW, HW, 1) > 0.5).astype(np.float32)).to(device)
    with torch.no_grad():
        y = state.model(x).float().cpu().numpy()
    if y.shape != (2, HW, HW, 1):
        print(f"FAIL: unexpected output shape {y.shape}")
        return False
    if not (np.isfinite(y).all() and (y >= 0.0).all() and (y <= 1.0).all()):
        print("FAIL: sigmoid output not finite or out of [0, 1]")
        return False
    print(f"Forward OK: shape {y.shape}, range [{y.min():.3f}, {y.max():.3f}]")

    loss = float(make_train_step(state.model, cfg.train.loss)(state, x, m)["loss"])
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    bad = [n for n, g in grads.items() if g is None or not torch.isfinite(g).all()]
    if bad or not np.isfinite(loss):
        print(f"FAIL: loss {loss}; missing or non-finite gradients: {bad}")
        return False
    n_params = sum(g.numel() for g in grads.values())
    print(f"Train step OK: loss {loss:.4f}, {len(grads)} tensors ({n_params} parameters) "
          "with finite gradients")
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    ok = check_device(device) and check_model(device)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
